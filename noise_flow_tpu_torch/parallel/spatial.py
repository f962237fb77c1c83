"""A frame sharded by height over ranks, with an explicit halo exchange.

Port of the mesh path of JAX's ``NoiseFlowWrapper.sample_noise_frame_spatial``
(noise_flow_tpu/wrapper.py:162-212). There the frame's height is sharded
over the mesh and XLA partitions every 3x3 conv, inserting the halo
exchanges itself. Here each rank of a ``parallel.mesh.Mesh`` holds a
contiguous block of the frame's rows, and the exchange is explicit:

- ``halo_exchange`` gives a shard the row above and the row below it,
  zeros past the frame's top and bottom (SAME padding);
- ``RowHalo`` is that exchange as the ``halo`` argument that
  ``NoiseFlow.forward`` passes down to every spatial conv (``ops.nn``), and
  it says whether the shard holds the frame's first and last row, where
  the zero-conv's edge indicator is 1;
- train-mode BatchNorm (the wrapper's ``bn_batch_stats``) takes its moments
  over the whole frame through the mesh's ``psum``.

The rows are exchanged with an all-reduce: each rank writes its edge rows
into its own slot of a zeroed buffer and the sum over the ranks gives every
rank every slot, bit for bit (x + 0 is x). Gloo sums CUDA tensors, and nccl
does too, so the same code runs on ranks sharing one card over gloo and on
one card a rank over nccl. Nothing here is differentiable: it samples.

A multi-level flow squeezes the rows at every level, so a level runs
sharded only where its rows still split into equal shards of a height the
squeeze can halve; the deeper levels, whose rows do not, run whole on every
rank (XLA reshards them instead), and the first sharded level slices its
rows from their output.
"""

from __future__ import annotations

import torch

from noise_flow_tpu_torch.parallel import distributed as pd


def shard_rows(height: int, mesh) -> slice:
    """This rank's rows of ``height`` rows split in ``mesh.size`` equal blocks."""
    if height % mesh.size:
        raise ValueError(f"{height} rows do not split over {mesh.size} ranks")
    h = height // mesh.size
    return slice(mesh.rank * h, (mesh.rank + 1) * h)


def halo_exchange(x: torch.Tensor, mesh, rows: int = 1) -> torch.Tensor:
    """[B, h, W, C] shard -> [B, h + 2 rows, W, C]: the ``rows`` rows of the
    shard above, the shard, the ``rows`` rows of the shard below. The first
    rank gets zeros above and the last zeros below (the frame's SAME
    padding). One all-reduce over the ranks' edge rows."""
    if x.shape[1] < rows:
        raise ValueError(f"a shard of {x.shape[1]} rows cannot lend {rows}")
    zeros = x.new_zeros((x.shape[0], rows) + tuple(x.shape[2:]))
    if mesh.size == 1:
        return torch.cat([zeros, x, zeros], 1)
    edges = torch.cat([x[:, :rows], x[:, -rows:]], 1)
    slots = x.new_zeros((mesh.size,) + tuple(edges.shape))
    slots[mesh.rank] = edges
    pd._all_reduce_(slots, mesh.group)
    above = slots[mesh.rank - 1, :, rows:] if mesh.rank > 0 else zeros
    below = slots[mesh.rank + 1, :, :rows] if mesh.rank < mesh.size - 1 else zeros
    return torch.cat([above, x, below], 1)


class RowHalo:
    """The ``halo`` of this rank's shard (``ops.nn``): ``halo(x, rows)`` is
    ``halo_exchange(x, mesh, rows)``; ``top`` and ``bottom`` are true where
    the shard holds the frame's first and last row."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.top = mesh.rank == 0
        self.bottom = mesh.rank == mesh.size - 1

    def __call__(self, x: torch.Tensor, rows: int = 1) -> torch.Tensor:
        return halo_exchange(x, self.mesh, rows)


def sharded_levels(flow, n: int) -> int:
    """How many levels, from level 0 up, run sharded over n ranks: level li
    does where the rows entering it (the frame's height over f^li) split
    into n equal shards whose height the squeeze by f divides."""
    h, f = flow.x_shape[0], flow.cfg.squeeze_factor
    k = 0
    while k < flow.n_levels and h % (n * f) == 0:
        k, h = k + 1, h // f
    return k


def sample_frame_sharded(flow, cond, z, mesh, temp: float = 1.0, train: bool = True,
                         split_eps=None, halo=None, psum=None):
    """This rank's rows of the noise that ``flow`` (built at the frame's
    shape, batch 1) maps the latent ``z`` to, the frame's height sharded
    over ``mesh``.

    Every rank passes the whole frame: ``cond`` (its clean image), ``z``
    (times ``temp`` already, as ``NoiseFlow.forward`` takes it) and, for a
    multi-level flow, ``split_eps`` (``flow.draw_latents``); each keeps its
    rows. ``halo`` and ``psum`` default to ``RowHalo(mesh)`` and
    ``mesh.psum()`` (none on one rank, the plain ``forward``); a caller
    passes others to plant a fault. Returns [1, H / n, W, C]."""
    n = mesh.size
    c = cond if flow._is_cond else {"clean": None}
    if n == 1:
        return flow.forward(z, c, train, split_eps, temp, psum=psum, halo=halo)
    halo = RowHalo(mesh) if halo is None else halo
    psum = mesh.psum() if psum is None else psum
    levels, k = flow.n_levels, sharded_levels(flow, n)
    x = z
    if k < levels:   # the deep levels whose rows do not shard: whole on every rank
        x = flow.forward(x, c, train, split_eps, temp, levels=range(levels - 1, k - 1, -1))
        if k == 0:
            return x[:, shard_rows(x.shape[1], mesh)]
    x = x[:, shard_rows(x.shape[1], mesh)]
    c = dict(c)
    if c.get("clean") is not None:
        c["clean"] = c["clean"][:, shard_rows(c["clean"].shape[1], mesh)]
    eps = None if split_eps is None else [
        e[:, shard_rows(e.shape[1], mesh)] if e is not None and li < k else None
        for li, e in enumerate(split_eps)]
    return flow.forward(x, c, train, eps, temp, psum=psum, halo=halo,
                        levels=range(k - 1, -1, -1))


def gather_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    """The whole frame [B, H, W, C] on every rank from each rank's rows."""
    if mesh.size == 1:
        return x
    rows = pd.all_gather_samples(x.transpose(0, 1).contiguous(), mesh.group)
    return rows.transpose(0, 1)

