"""K train or eval steps captured as one CUDA graph and replayed.

The counterpart, for a rank on the card, of the JAX trainer's jitted
``lax.scan`` of K steps (``train_scan``, ``train_scan_idx``,
``eval_scan_idx``): the K steps of a group are captured once as one
``torch.cuda.CUDAGraph``, and each full group of K is one replay. Under a
mesh each rank captures its own K steps with every all-reduce they issue
(the BatchNorm sums forward and backward, the flat all-reduce of gradients,
metrics and BN state): the nccl collectives are recorded into the graph
(``parallel.distributed._all_reduce_``), and a replay runs them. A graph
reads and writes the memory it was captured on, so every input of a step
lives in a static buffer (``feed``) that is filled before each replay:

- the staged path: a ``[K, B]`` long index buffer; each step gathers its
  batch from the staged set with ``index_select`` inside the graph;
- the host-batch path: one ``[K, B, ...]`` buffer a field.

Each step's NLL and sd_z land in static ``[K]`` outputs. The captured steps
update the weights, the BatchNorm buffers (``NoiseFlow.apply_state`` copies
into them) and the optimizer's state (a capturable Adam keeps its step count
on the card) in place, so each replay starts where the last one ended. A
tensor rebound after capture (a reloaded optimizer, a restaged set) is not
seen: its owner drops the graph and captures a new one.

PyTorch needs eager steps before a capture (cuBLAS and cuDNN set up lazily,
the optimizer makes its slots, the kernels' libraries load). Those steps run
on a side stream and change the weights, the BN state and the optimizer's
state: all of it is copied before them and restored in place after, so the
first replay starts from the state an eager run would have. A slot that the
optimizer made during them is zeroed, which is the state it is made in.

Under a mesh the warm-up's collectives are real ones: they also bring up
the nccl communicator, which must exist before a capture. Every rank then
waits at a barrier of the group, captures the same sequence of collectives
(its steps are the same code on the same shapes), and the ranks tell each
other whether their capture succeeded, so that a capture that fails on one
rank raises on every rank instead of leaving the others to wait in a
replay's collectives.

The kernels of ``ops.fused_train`` count the launches they record at capture
in ``fused_sample.captured_counts``, the collectives count theirs in
``distributed.captured_collectives``; each replay adds them to
``launch_counts`` and ``collective_stats``. Kernel scratch that a step frees
comes back from the graph's private pool to a later allocation of the same
capture; that is safe for the same reason it is eagerly: one stream orders
the launch that reads a buffer before the one that reuses it.

A capture that fails raises, with its cause: nothing falls back to eager
steps.
"""

from __future__ import annotations

import collections
from typing import Callable, Dict, Optional

import torch

from noise_flow_tpu_torch.ops import fused_sample as fs
from noise_flow_tpu_torch.parallel import distributed as pd

# eager steps before a capture (PyTorch's documented warm-up)
WARMUP_STEPS = 3


def _snapshot(flow, optimizer):
    """Copies of the flow's parameters and buffers and of the optimizer's
    tensor slots; restore them with ``_restore``."""
    with torch.no_grad():
        tensors = list(flow.parameters()) + list(flow.buffers())
        saved = [t.detach().clone() for t in tensors]
        slots = {} if optimizer is None else {
            p: {k: v.clone() for k, v in st.items() if torch.is_tensor(v)}
            for p, st in optimizer.state.items()}
    return tensors, saved, slots


@torch.no_grad()
def _restore(snapshot, optimizer) -> None:
    tensors, saved, slots = snapshot
    for t, s in zip(tensors, saved):
        t.copy_(s)
    if optimizer is None:
        return
    for p, st in optimizer.state.items():
        old = slots.get(p)
        for k, v in st.items():
            if torch.is_tensor(v):
                v.copy_(old[k]) if old is not None else v.zero_()


class StepGraph:
    """K steps as one CUDA graph.

    ``step(batch) -> (nll, sd_z)`` is one train or eval step, 0-d tensors;
    ``feed`` maps names to the static input buffers, already holding the
    first group's inputs; ``batch_at(feed, j)`` is step j's batch, read from
    them. ``flow`` and ``optimizer`` (None for eval steps) own the state that
    the warm-up changes and that is restored before capture. ``mesh``: the
    ``parallel.mesh.Mesh`` whose collectives the steps issue (nccl), or None.
    """

    def __init__(self, step: Callable, feed: Dict[str, torch.Tensor],
                 batch_at: Callable, k: int, flow, optimizer=None, mesh=None):
        self.k = k
        self.feed = feed
        dev = flow.device
        self.nll = torch.zeros((k,), device=dev)
        self.sd_z = torch.zeros((k,), device=dev)
        snap = _snapshot(flow, optimizer)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                step(batch_at(feed, 0))
        torch.cuda.current_stream(dev).wait_stream(side)
        _restore(snap, optimizer)
        if optimizer is not None:
            optimizer.zero_grad(set_to_none=True)
        ranks = mesh is not None and mesh.size > 1
        if ranks:
            torch.cuda.synchronize(dev)
            pd.barrier(mesh.group)
        fs.captured_counts.clear()
        pd.captured_collectives["calls"] = 0
        self.graph = torch.cuda.CUDAGraph()
        error = None
        try:
            with torch.cuda.graph(self.graph):
                for j in range(k):
                    nll, sd_z = step(batch_at(feed, j))
                    self.nll[j].copy_(nll)
                    self.sd_z[j].copy_(sd_z)
        except Exception as e:  # every rank learns of it below
            error = e
        finally:
            # the kernels' launches and the collectives recorded in the
            # graph, counted at each replay
            self.launches = collections.Counter(fs.captured_counts)
            self.collectives = pd.captured_collectives["calls"]
            fs.captured_counts.clear()
            pd.captured_collectives["calls"] = 0
        failed = error is not None
        if ranks:
            flag = torch.full((1,), float(failed), device=dev)
            failed = float(pd._all_reduce_(flag, mesh.group)) > 0
        if failed:
            cause = error if error is not None else "the capture failed on another rank"
            raise RuntimeError(f"CUDA graph capture of {k} steps failed: {cause}") from error

    def replay(self, feed: Optional[Dict[str, torch.Tensor]] = None):
        """Copy ``feed`` into the static inputs, run the K steps; returns
        (nll [K], sd_z [K]), copies of the static outputs."""
        for name, v in (feed or {}).items():
            self.feed[name].copy_(v)
        self.graph.replay()
        fs.launch_counts.update(self.launches)
        pd.collective_stats["calls"] += self.collectives
        return self.nll.clone(), self.sd_z.clone()
