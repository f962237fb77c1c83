"""Multi-process utilities: process-group bring-up, per-process data
sharding, collectives and global stats.

Port of noise_flow_tpu.parallel.distributed on ``torch.distributed``. JAX
runs P processes x D local devices as one global mesh; the port runs one
rank per device, so a JAX mesh of N devices is N ranks here. Two launch
modes bring the ranks up:

- coordinator mode (JAX multi-host): ``initialize_distributed(address,
  num_processes, process_id)``, one rank a process. ``process_count`` and
  ``process_index`` are then JAX's ``jax.process_count`` and
  ``jax.process_index``: each process loads its ``host_shard`` of the data
  and feeds its own batches;
- one launch of N ranks (JAX's single-process mesh): ``spawn_ranks``
  starts them and ``init_rank`` joins each to the group (``cli.train
  --mesh N``). There is one process in JAX's sense: every rank sees the
  whole data and keeps its slice of each batch (``mesh.shard_batch``), and
  ``process_count`` stays 1.

The process group's backend is gloo on the CPU and nccl on the card
(``default_backend``). Gloo reduces and broadcasts CUDA tensors but gathers
only host tensors, so ``all_gather_samples`` stages CUDA tensors through
host memory under gloo.

BatchNorm over the global batch takes its moments' sums through
``all_reduce_sum``, whose backward is the all-reduce of the cotangents
(``ops.nn.batch_moments``, given ``mesh.Mesh.psum()``).
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# JAX's process count and index: set only in coordinator mode
_PROCESS = {"count": 1, "index": 0}
# all-reduces issued by this process and, with timing on, their seconds
collective_stats = {"calls": 0, "seconds": 0.0, "timing": False}


def default_backend(device) -> str:
    """nccl for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: str = "gloo") -> None:
    """Bring up the process group of coordinator mode over TCP at
    ``coordinator_address`` (host:port of process 0); no-op when
    single-process or already up."""
    if coordinator_address is None or dist.is_initialized():
        return
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator_address needs --num_processes and --process_id")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id)
    _PROCESS.update(count=num_processes, index=process_id)


def init_rank(rank: int, world_size: int, address: str, backend: str = "gloo") -> None:
    """Join rank ``rank`` of a one-launch group of ``world_size`` ranks at
    ``address`` (host:port); the process count stays 1."""
    dist.init_process_group(backend, init_method=f"tcp://{address}",
                            world_size=world_size, rank=rank)


def shutdown() -> None:
    """Leave the process group, if any, and forget coordinator mode."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _PROCESS.update(count=1, index=0)


def world_size() -> int:
    """Ranks of the default process group (1 without one)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def free_port() -> int:
    """A TCP port free on localhost for a group's rendezvous."""
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank_: int, world: int, address: Optional[str], backend: str,
                device: str, fn, args, out_dir: str):
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank_)
    if address is not None:
        init_rank(rank_, world, address, backend)
    try:
        torch.save(fn(rank_, dev, *args), os.path.join(out_dir, f"rank{rank_}.pt"))
    finally:
        shutdown()


def spawn_ranks(n: int, fn, args=(), device="cpu", backend: Optional[str] = None,
                timeout: Optional[float] = None, group: bool = True) -> List:
    """Run ``fn(rank, device, *args)`` in n new processes and return what
    each returned, in rank order. With ``group`` the processes are the ranks
    of one process group (rendezvous on a free localhost port; ``backend``:
    the device's ``default_backend``); without, ``fn`` brings up its own
    (coordinator mode). ``device``: cuda:r for rank r where it is "cuda",
    the named card for every rank where it names one ("cuda:0"), else the
    CPU. A rank that fails ends the others and raises here; ranks still
    running after ``timeout`` seconds are killed and TimeoutError is raised.
    ``fn`` must be importable (a module-level function)."""
    import torch.multiprocessing as mp

    backend = backend or default_backend(device)
    address = f"localhost:{free_port()}" if group else None
    with tempfile.TemporaryDirectory() as out_dir:
        ctx = mp.spawn(_rank_entry, args=(n, address, backend, str(device), fn, tuple(args),
                                          out_dir), nprocs=n, join=False)
        deadline = None if timeout is None else time.time() + timeout
        while not ctx.join(timeout=1):
            if deadline is not None and time.time() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"ranks still running after {timeout} s")
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


def process_count() -> int:
    return _PROCESS["count"]


def process_index() -> int:
    return _PROCESS["index"]


def host_shard(items: Sequence, process_index: Optional[int] = None,
               process_count: Optional[int] = None) -> List:
    """Deterministic round-robin shard of a work list for this process.

    Every process must pass the identical ``items`` ordering (e.g. the
    sorted SIDD filename tuples); the shard is then disjoint and exhaustive
    across processes."""
    pi = _PROCESS["index"] if process_index is None else process_index
    pc = _PROCESS["count"] if process_count is None else process_count
    return list(items)[pi::pc]


def _to_tensor(x, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(x), device=device)
    if dtype is not None:
        return t.to(dtype)
    return t.float() if t.is_floating_point() else t


def global_batch(mesh, local_batch: Dict, dtype=None) -> Dict:
    """The rank's part of a global batch: ``local_batch`` (this process's
    shard along the leading dim) on the rank's device. Floating arrays
    become float32, or ``dtype`` when given."""
    return {k: _to_tensor(v, mesh.device, dtype) for k, v in local_batch.items()}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def _world(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """In-place sum over the group's ranks."""
    collective_stats["calls"] += 1
    if not collective_stats["timing"]:
        dist.all_reduce(t, group=group)
        return t
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    collective_stats["seconds"] += time.perf_counter() - t0
    return t


class _AllReduceSum(torch.autograd.Function):
    """Sum over ranks; the cotangent of every rank's input is the sum of
    the cotangents of every rank's output."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_(x.detach().clone().contiguous(), group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_(g.detach().clone().contiguous(), ctx.group), None


def all_reduce_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``x`` over the group's ranks (identity on one
    rank or with no process group)."""
    if _world(group) == 1:
        return x
    return _AllReduceSum.apply(x, group)


def global_mean(x, group=None) -> torch.Tensor:
    """Mean of ``x`` over every rank's elements, for equal shards: the mean
    over ranks of the local means (JAX's ``psum(mean) / psum(1)``)."""
    return all_reduce_sum(torch.mean(x), group) / _world(group)


def all_reduce_flat_(tensors: Sequence[torch.Tensor], group=None, mean: bool = False) -> None:
    """Sum (or average) each tensor over the ranks in place, in one
    collective over their concatenation. Not differentiable."""
    if _world(group) == 1 or not tensors:
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    _all_reduce_(flat, group)
    if mean:
        flat /= _world(group)
    off = 0
    with torch.no_grad():
        for t in tensors:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def all_gather_samples(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's rows of ``x`` (equal shapes), concatenated in rank
    order along dim 0, on every rank."""
    world = _world(group)
    if world == 1:
        return x
    # gloo gathers host tensors only: a CUDA tensor goes through host memory
    stage = x.is_cuda and dist.get_backend(group) == "gloo"
    src = x.detach().cpu() if stage else x.detach().contiguous()
    parts = [torch.empty_like(src) for _ in range(world)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts).to(x.device)


def all_gather_host(arr: np.ndarray, group=None) -> np.ndarray:
    """[P, ...]: every rank's copy of the host array ``arr``, in rank order
    (through the rank's card where the backend is nccl)."""
    if _world(group) == 1:
        return np.asarray(arr)[None]
    t = torch.as_tensor(np.ascontiguousarray(arr))
    if dist.get_backend(group) == "nccl":
        t = t.cuda()
    parts = [torch.empty_like(t) for _ in range(_world(group))]
    dist.all_gather(parts, t, group=group)
    return torch.stack(parts).cpu().numpy()


def barrier(group=None) -> None:
    if _world(group) > 1:
        dist.barrier(group=group)


def broadcast_(tensors: Sequence[torch.Tensor], src: int = 0, group=None) -> None:
    """Overwrite each tensor with rank ``src``'s copy, in place."""
    if _world(group) == 1:
        return
    for t in tensors:
        with torch.no_grad():
            buf = t.detach().contiguous()
            dist.broadcast(buf, src, group=group)
            if buf.data_ptr() != t.data_ptr():
                t.copy_(buf)


# ---------------------------------------------------------------------------
# global stats
# ---------------------------------------------------------------------------

def global_scalar_stats(x: np.ndarray, y: np.ndarray) -> Dict[str, float]:
    """Cross-process twin of data.stats.calc_pat_stats: each process computes
    Welford pieces (n, mean, m2) over its local noise/clean patch shard; the
    pieces are cast to float32 and gathered, as JAX gathers them, and merged
    pairwise-stably. Single process: calc_pat_stats itself."""
    from noise_flow_tpu_torch.data.stats import calc_pat_stats

    if process_count() == 1:
        return calc_pat_stats(x, y)
    local = []
    for arr in (x, y):
        a = arr.astype(np.float64)
        local += [float(a.size), float(a.mean()), float(a.var() * a.size)]
    gathered = all_gather_host(np.asarray(local, np.float32))  # [P, 6]
    out: Dict[str, float] = {}
    for qi, prefix in enumerate(("sc_in", "sc_gt")):
        shards = [{"n": row[3 * qi], "mean": row[3 * qi + 1], "m2": row[3 * qi + 2]}
                  for row in gathered]
        merged = merge_welford_shards(shards)
        mean = float(merged["mean"])
        vr = float(merged["m2"] / max(merged["n"], 1.0))
        out[f"{prefix}_mean"] = mean
        out[f"{prefix}_vr"] = vr
        out[f"{prefix}_sd"] = out[f"{prefix}_std"] = float(np.sqrt(vr))
    return out


def global_baselines(nll_gauss: float, nll_sdn: float) -> tuple:
    """Average the per-process baseline NLLs (each process computed them over
    its own test shard), through float32 as JAX gathers them."""
    if process_count() == 1:
        return nll_gauss, nll_sdn
    g = all_gather_host(np.asarray([nll_gauss, nll_sdn], np.float32))
    return float(g[:, 0].mean()), float(g[:, 1].mean())


def merge_welford_shards(shards: List[Dict]) -> Dict:
    """Merge per-process Welford stats {'n','mean','m2'} pairwise-stably."""
    from noise_flow_tpu_torch.data.stats import welford_merge

    while len(shards) > 1:
        nxt = []
        for i in range(0, len(shards) - 1, 2):
            a, b = shards[i], shards[i + 1]
            n, m, m2 = welford_merge(a["n"], a["mean"], a["m2"], b["n"], b["mean"], b["m2"])
            nxt.append({"n": n, "mean": m, "m2": m2})
        if len(shards) % 2:
            nxt.append(shards[-1])
        shards = nxt
    return shards[0]
