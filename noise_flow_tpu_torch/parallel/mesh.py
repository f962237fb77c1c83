"""Data-parallel mesh: one rank a device.

Port of noise_flow_tpu.parallel.mesh. JAX's 1-D ``data`` mesh of N devices
is N ranks of a ``torch.distributed`` process group here, each holding a
full copy of the parameters on its own device; batches are split along the
leading dim, one contiguous slice a rank, and the trainers reduce what JAX's
collectives reduce (gradients, metrics, BatchNorm moments).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from noise_flow_tpu_torch.parallel import distributed as pd
from noise_flow_tpu_torch.utils.device import resolve_device


@dataclass
class Mesh:
    """``size`` ranks; this process is rank ``rank`` of ``group`` (None: the
    default group, or no group on one rank) and computes on ``device``.
    ``process_local``: each rank is fed its own process's batches
    (coordinator mode), not slices of one global batch."""

    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None
    process_local: bool = False

    def psum(self):
        """The differentiable sum over the ranks that train-mode BatchNorm
        takes its global moments with (``flow.loss(..., psum=)``,
        ``DnCNN(..., psum=)``); None on one rank."""
        if self.size == 1:
            return None
        return functools.partial(pd.all_reduce_sum, group=self.group)


def make_mesh(n_data: Optional[int] = None, device="cuda") -> Mesh:
    """The mesh over every rank of the default process group (one rank when
    there is none), computing on ``device``: the card unless the caller asks
    for the CPU; without a card ``"cuda"`` raises (``resolve_device``).
    ``n_data`` (None: all) must be that world size, as JAX's ``make_mesh``
    cannot take more devices than it sees."""
    world = pd.world_size()
    n = world if n_data is None else n_data
    if n != world:
        raise ValueError(f"a mesh of {n} ranks needs a process group of {n}; this one "
                         f"has {world}")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    return Mesh(n, pd.rank(), dev, None, process_local=pd.process_count() > 1)


def mesh_ranks(n: int, device: str) -> int:
    """Ranks of ``--mesh n``: every rank of a process group already up, else
    n, where 0 means every visible card (1 on the CPU). Raises where n
    exceeds the visible cards, as JAX's make_mesh cannot build that mesh."""
    world = pd.world_size()
    if world > 1:
        if n and n != world:
            raise ValueError(f"--mesh {n} in a process group of {world} ranks")
        return world
    if torch.device(device).type != "cuda":
        return n or 1
    visible = torch.cuda.device_count()
    if n > visible:
        raise ValueError(f"--mesh {n} needs {n} cards; {visible} visible")
    return n or max(visible, 1)


def as_mesh(mesh, device) -> Mesh:
    """A Mesh from what the trainers accept: a Mesh, None (every rank of
    the default group) or 1."""
    if isinstance(mesh, Mesh):
        return mesh
    if mesh is None:
        return make_mesh(None, device)
    if mesh == 1:
        return Mesh(1, 0, torch.device(device))
    raise TypeError(f"mesh must be a Mesh, None or 1, not {mesh!r}")


def shard_batch(mesh: Mesh, batch: Dict, dtype=None) -> Dict:
    """This rank's contiguous slice ``[r B/N, (r+1) B/N)`` of a host batch,
    on its device (JAX's ``shard_batch`` puts exactly that on device r).
    The batch must divide by the mesh size, as JAX's sharding requires."""
    out = {}
    for k, v in batch.items():
        a = np.asarray(v)
        if mesh.size > 1 and a.ndim:
            b = a.shape[0]
            if b % mesh.size:
                raise ValueError(f"batch of {b} ({k}) does not divide over {mesh.size} ranks")
            a = a[mesh.rank * b // mesh.size:(mesh.rank + 1) * b // mesh.size]
        out[k] = pd._to_tensor(a, mesh.device, dtype)
    return out


def shard_batch_stacked(mesh: Mesh, batches, dtype=None) -> Dict:
    """This rank's [K, B/N, ...] stack of K host batches (a list of dicts):
    the slice ``[r B/N, (r+1) B/N)`` of each, as ``shard_batch`` slices it,
    stacked along a new leading dim (JAX's ``shard_batch_stacked``: dim 0
    the scan axis, dim 1 over the mesh). Each batch is sliced before the
    stack, so a rank copies only its rows."""
    out = {}
    for k in batches[0]:
        b = np.shape(batches[0][k])[0]
        if b % mesh.size:
            raise ValueError(f"batch of {b} ({k}) does not divide over {mesh.size} ranks")
        lo, hi = mesh.rank * b // mesh.size, (mesh.rank + 1) * b // mesh.size
        out[k] = pd._to_tensor(np.stack([np.asarray(mb[k])[lo:hi] for mb in batches]),
                               mesh.device, dtype)
    return out


def replicate(mesh: Mesh, module: torch.nn.Module, optimizer=None) -> None:
    """Give every rank rank 0's parameters, buffers and optimizer slots
    (JAX replicates params, state and opt_state over the mesh)."""
    if mesh.size == 1:
        return
    tensors = list(module.parameters()) + list(module.buffers())
    if optimizer is not None:
        for p in module.parameters():
            st = optimizer.state.get(p, {})
            # the slots, not Adam's step count: a host scalar, equal on every
            # rank that loaded the same checkpoint
            tensors += [st[k] for k in sorted(st) if k != "step" and torch.is_tensor(st[k])]
    pd.broadcast_(tensors, 0, mesh.group)
