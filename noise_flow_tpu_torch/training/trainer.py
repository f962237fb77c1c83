"""Training/eval/sampling orchestration.

Port of noise_flow_tpu.training.trainer (ref:train_noise_flow.py:30-541).
One eager train step a batch: the loss, one ``backward``, one optimizer
step, then the BatchNorm running statistics that the loss returned are
written into the flow's buffers, as the JAX trainer threads its state from
step to step. The loss is, as in JAX: with ``cfg.use_pallas`` the fused
one-shot kernel (``FusedTrainStep``), or the segment path
(``FusedFlow.loss(train=True)``: segment kernels, autograd between them)
when ``cfg.pallas_oneshot`` is False or the arch has more scale layers than
the one-shot step takes; else plain autograd of ``NoiseFlow.loss``.

Epoch schedule, TSV logs (train/test/sample.txt columns), best-model tracking,
and the NLL_G/NLL_SDN baseline columns match the reference
(ref:train_noise_flow.py:334-348,384-535) and the JAX package.

Data parallelism (``mesh``, ``parallel.mesh.Mesh``): each rank holds the
flow and trains on its slice of the global batch. On the plain path the
BatchNorm moments span the global batch (``flow.loss(..., psum=)``), as
JAX's auto-partitioned ``flow.loss``; on the fused paths each rank runs its own
kernel on its shard at ``pick_block(local batch)``, as JAX's ``shard_map``
runs one Pallas call a device. Then the gradients, the NLL, sd_z and (fused)
the new BN state are averaged over the ranks, as JAX's ``pmean``. Only rank
0 writes logs and checkpoints.

K steps a dispatch (``steps_per_call``, JAX's jitted ``lax.scan`` of K
steps): ``train_epoch(steps_per_call=K)`` and, with ``cfg.steps_per_call =
K``, the staged train and eval epochs run the batches in groups of K, with
JAX's rules: only full groups of K; a ragged tail, or a change of batch
shape, runs single steps; a non-trainable flow (condSDN) runs its staged
epoch as eval steps. On the card each full group is one replay of a CUDA
graph of K steps (``training.step_graph``), captured once for each (train or
eval, feed, K, local batch) and kept; the tail runs as eager steps. That
holds for one rank and for a mesh whose group is nccl: each rank's graph
holds its K steps with their all-reduces, as XLA puts the gradient
all-reduce inside JAX's scan (staging is single-rank, as JAX's; a mesh
feeds host batches). A mesh on gloo (ranks that share one card) cannot
capture its collectives, which go through the host, and runs a group as K
eager steps, as the CPU does: the same arithmetic.

Spans (``utils.profiling``), which a profiler's trace ties to the device's
operations: a train epoch is ``nf.epoch``; its permutation
``nf.epoch.order``, each graph replay ``nf.epoch.replay``, each eager step
``nf.epoch.eager`` and the closing synchronisation ``nf.epoch.sync`` are
phases of ``self.timers`` (the status line), as are a staged eval's
``nf.eval.replay`` and ``nf.eval.eager`` and a graph's first capture
``nf.capture``; a train step's ``nf.step.gather``, ``nf.step.forward``,
``nf.step.backward``, ``nf.step.optimizer`` and ``nf.step.state``. A
captured step's spans run once, at capture: a replay runs no Python, so the
step's phases show in eager steps only.
"""

from __future__ import annotations

import logging
import os
import signal
import threading
import time
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from noise_flow_tpu_torch.ops.fused_train import FusedFlow, FusedTrainStep, pick_block
from noise_flow_tpu_torch.parallel import distributed as pd
from noise_flow_tpu_torch.parallel.mesh import (
    as_mesh,
    replicate,
    shard_batch,
    shard_batch_stacked,
)
from noise_flow_tpu_torch.training.step_graph import StepGraph
from noise_flow_tpu_torch.utils.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    save_checkpoint,
)
from noise_flow_tpu_torch.utils.logger import ResultLogger
from noise_flow_tpu_torch.utils.metrics import calc_kldiv_mb, kldiv_batch
from noise_flow_tpu_torch.utils.profiling import PhaseTimers, annotate

_KEEP = ("_x", "_y", "nlf0", "nlf1", "iso", "cam")
# S6 at ISO 100 (ref:train_noise_flow.py:158-159)
_NLF_S6_100 = 0.000479


class _NullLogger:
    def log(self, row):
        pass

    def close(self):
        pass


def _timed_iter(it, timers, name: str):
    """Yield from `it`, charging the time spent inside the iterator (host
    input: decode/patch/batch assembly) to timers[name]."""
    it = iter(it)
    while True:
        with timers.phase(name):
            try:
                mb = next(it)
            except StopIteration:
                return
        yield mb


def make_optimizer(cfg, params):
    """Adam beta1=.9 beta2=.999 eps=1e-8, or SGD momentum .9
    (ref:train_noise_flow.py:187-198). The arithmetic is optax's; optax's
    ``flatten`` wrapper (one fused vector) has no counterpart here. For
    parameters on the card Adam is ``capturable``: its step count lives on
    the device, so that a CUDA graph can step it; SGD keeps no count."""
    params = list(params)
    if cfg.optim == "adam":
        on_card = any(p.device.type == "cuda" for p in params)
        return torch.optim.Adam(params, lr=cfg.lr, betas=(0.9, 0.999), eps=1e-8,
                                capturable=on_card)
    if cfg.optim == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr, momentum=0.9)
    raise ValueError(f"unknown optimizer {cfg.optim!r}")


def batch_to_cond(mb: Dict) -> Dict:
    return {
        "clean": mb["_y"],
        "nlf0": mb["nlf0"], "nlf1": mb["nlf1"],
        "iso": mb["iso"], "cam": mb["cam"],
    }


class Trainer:
    """Trains a ``NoiseFlow`` from its current weights on its device.

    ``mesh``: a ``parallel.mesh.Mesh`` whose device is the flow's; None for
    every rank of the default process group (one rank without one), or 1.
    Every rank is given rank 0's weights.
    """

    def __init__(self, flow, cfg, mesh=None):
        self.flow = flow
        self.cfg = cfg
        self.device = flow.device
        self.mesh = as_mesh(mesh, self.device)
        # the plain path's BatchNorm sums over the ranks (None: local moments)
        self.bn_psum = self.mesh.psum()
        self.optimizer = make_optimizer(cfg, [p for _, p in flow.named_parameters()])
        replicate(self.mesh, flow, self.optimizer)
        self.timers = PhaseTimers()  # the loop's phases: spans, and host time
        # condSDN is a non-trainable baseline: evaluate only, never step
        # (ref:train_noise_flow.py:189).
        self.trainable = cfg.sidd_cond != "condSDN"
        self._fused_cache: Dict[int, FusedFlow] = {}
        self._step_cache: Dict[int, FusedTrainStep] = {}
        # CUDA graphs of K steps, by (train, feed, K, batch)
        self._graphs: Dict[tuple, StepGraph] = {}
        # the last train epoch's (nll, sd_z), one a step, on the device
        self.epoch_steps = None
        self.use_fused = False
        self.use_oneshot = False
        if getattr(cfg, "use_pallas", False):
            try:
                FusedFlow(flow, bt=8)  # envelope check only
                self.use_fused = True
            except ValueError as e:
                logging.getLogger(__name__).warning(
                    "use_pallas requested but arch outside the fused "
                    "envelope (%s); falling back to the plain path", e)
            if self.use_fused:
                # the one-shot step; outside its envelope (more than
                # MAX_SCALE scale layers) the segment path trains instead
                try:
                    FusedTrainStep(flow, bt=8)
                    self.use_oneshot = getattr(cfg, "pallas_oneshot", True)
                except ValueError:
                    pass
        # the fused kernels' precision, as JAX's trainer takes it
        self.mm_dtype = getattr(cfg, "pallas_train_dtype", "bfloat16")

    # ------------------------------------------------------------ kernels
    def _fused_for_batch(self, b: int) -> FusedFlow:
        bt = pick_block(b)
        if bt not in self._fused_cache:
            self._fused_cache[bt] = FusedFlow(self.flow, bt=bt, mm_dtype=self.mm_dtype)
        return self._fused_cache[bt]

    def _step_for_batch(self, b: int) -> FusedTrainStep:
        bt = pick_block(b, target=64, stretch=8)
        if bt not in self._step_cache:
            self._step_cache[bt] = FusedTrainStep(self.flow, bt=bt, mm_dtype=self.mm_dtype)
        return self._step_cache[bt]

    # -------------------------------------------------------------- steps
    def _put(self, mb: Dict) -> Dict:
        """Host batch -> float32 tensors on the flow's device: under a mesh,
        this rank's slice of the global batch, or in coordinator mode the
        process's own batch whole."""
        keep = {k: mb[k] for k in _KEEP}
        if self.mesh.size > 1 and not self.mesh.process_local:
            return shard_batch(self.mesh, keep, torch.float32)
        return pd.global_batch(self.mesh, keep, torch.float32)

    def _put_stacked(self, buf) -> Dict:
        """A full group's host batches -> one [K, B, ...] float32 tensor a
        field on the flow's device: under a mesh, this rank's slice of dim 1
        (JAX's ``shard_batch_stacked``), or in coordinator mode the
        process's own batches whole (JAX's ``global_batch_stacked``)."""
        if self.mesh.size > 1 and not self.mesh.process_local:
            return shard_batch_stacked(self.mesh, [{f: mb[f] for f in _KEEP} for mb in buf],
                                       torch.float32)
        stacked = {f: np.stack([np.asarray(mb[f], np.float32) for mb in buf]) for f in _KEEP}
        return pd.global_batch(self.mesh, stacked, torch.float32)

    def _mean_over_ranks(self, tensors):
        """Average each tensor over the mesh's ranks in place, in one
        all-reduce (JAX's pmean)."""
        if self.mesh.size > 1:
            pd.all_reduce_flat_(tensors, self.mesh.group, mean=True)

    def train_step(self, batch: Dict):
        """One optimizer step on a device batch (this rank's shard under a
        mesh); returns (nll, sd_z) as 0-d tensors on the device, over the
        global batch."""
        flow = self.flow
        with annotate("nf.step.forward"):
            if self.use_oneshot:
                fs = self._step_for_batch(batch["_x"].shape[0])
                nll, sd_z, new_state = fs.loss(batch["_x"], batch_to_cond(batch))
            elif self.use_fused:
                ff = self._fused_for_batch(batch["_x"].shape[0])
                nll, sd_z, new_state = ff.loss(batch["_x"], batch_to_cond(batch), train=True)
            else:
                # under a mesh, BN moments over every rank's rows, differentiably:
                # the local NLLs' gradients then average to the global NLL's
                nll, sd_z, new_state = flow.loss(batch["_x"], batch_to_cond(batch), train=True,
                                                 psum=self.bn_psum)
        with annotate("nf.step.backward"):
            self.optimizer.zero_grad(set_to_none=True)
            nll.backward()
        nll, sd_z = nll.detach(), sd_z.detach()
        if self.mesh.size > 1:
            metrics = torch.stack([nll, sd_z])
            grads = [p.grad for p in flow.parameters() if p.grad is not None]
            # the plain path's new state came from global moments, equal on
            # every rank; the fused paths' from each rank's own groups
            state = list(new_state.values()) if self.use_fused else []
            self._mean_over_ranks(grads + [metrics] + state)
            nll, sd_z = metrics[0], metrics[1]
        with annotate("nf.step.optimizer"):
            self.optimizer.step()
        with annotate("nf.step.state"):
            flow.apply_state(new_state)
        return nll, sd_z

    @torch.no_grad()
    def eval_step(self, batch: Dict):
        """(nll, sd_z) of a device batch, over the global batch."""
        if self.use_fused:
            ff = self._fused_for_batch(batch["_x"].shape[0])
            nll, sd_z, _ = ff.loss(batch["_x"], batch_to_cond(batch), train=False)
        else:
            nll, sd_z, _ = self.flow.loss(batch["_x"], batch_to_cond(batch), train=False)
        if self.mesh.size > 1:
            metrics = torch.stack([nll, sd_z])
            self._mean_over_ranks([metrics])
            nll, sd_z = metrics[0], metrics[1]
        return nll, sd_z

    @torch.no_grad()
    def sample_kld_step(self, batch: Dict, temp: float, sc_sd: float,
                        generator: Optional[torch.Generator] = None):
        """Sample, NLL round trip and per-patch marginal KLDs on the device;
        only scalars come back. The Gaussian and camera-NLF comparison noise
        is drawn from ``generator`` after the flow's sample."""
        cond = batch_to_cond(batch)
        y = batch["_y"]
        x = self.flow.sample(cond, temp, batch=y.shape[0], train=False, generator=generator)
        nll, sd_z, _ = self.flow.loss(x, cond, train=False)
        shp = (-1,) + (1,) * (y.ndim - 1)
        ng = sc_sd * torch.randn(y.shape, generator=generator, device=y.device)
        nlf_sd = torch.sqrt(batch["nlf0"].reshape(shp) * y + batch["nlf1"].reshape(shp))
        nl = nlf_sd * torch.randn(y.shape, generator=generator, device=y.device)
        sums, cnt = kldiv_batch(ng, nl, x, batch["_x"])
        if self.mesh.size > 1:
            # the KLD sums and counts over the global batch, as JAX's jit
            # over global arrays; the NLL and sd_z its mean
            v = torch.cat([torch.stack([nll, sd_z]) / self.mesh.size, sums,
                           sums.new_tensor([float(cnt)])])
            pd.all_reduce_flat_([v], self.mesh.group)
            nll, sd_z, sums, cnt = v[0], v[1], v[2:6], float(v[6])
        return nll, sd_z, sums, cnt

    def _step_or_eval(self, batch):
        if self.trainable:
            return self.train_step(batch)
        return self.eval_step(batch)

    # ------------------------------------------------------ K-step groups
    @property
    def graphs_on(self) -> bool:
        """Whether a full group of K steps runs as a CUDA graph replay: on
        the card, for one rank or a mesh whose group is nccl. The rule, not
        a fallback: a gloo group's collectives cannot be captured, so a mesh
        on gloo runs a group as K eager steps, and a capture that fails
        raises."""
        if self.device.type != "cuda":
            return False
        return self.mesh.size == 1 or pd.backend(self.mesh.group) == "nccl"

    def _graph(self, key, step, feed, batch_at, train: bool) -> StepGraph:
        """The graph for key (feed, train, K, B), captured at its first use
        with a copy of ``feed`` as its static inputs."""
        g = self._graphs.get(key)
        if g is None:
            with self.timers.phase("capture"):
                g = self._graphs[key] = StepGraph(
                    step, {n: v.clone() for n, v in feed.items()}, batch_at, key[2], self.flow,
                    self.optimizer if train else None, self.mesh)
        return g

    def _staged_steps(self, split: str, order, k: int, train: bool):
        """Steps over the staged ``split``, the rows of ``order`` [nsteps, B]
        being each step's indices, train steps (``_step_or_eval``) or eval
        steps: full groups of k as graph replays where ``graphs_on``, every
        other step eager (a group of k eager steps is k single steps), timed
        as the phases ``epoch.*`` (train) or ``eval.*``.
        Returns (nll, sd_z), one a step."""
        data = getattr(self, f"_staged_{split}")
        step = self._step_or_eval if train else self.eval_step
        phase = "epoch" if train else "eval"
        nsteps, b = order.shape
        full = nsteps - nsteps % k if k > 1 and self.graphs_on else 0
        losses, sdzs = [], []
        for s in range(0, full, k):
            g = self._graph(("staged_" + split, train, k, b), step, {"idx": order[s:s + k]},
                            lambda f, j: self._gather_staged(data, f["idx"][j]), train)
            with self.timers.phase(phase + ".replay"):
                nll, sd_z = g.replay({"idx": order[s:s + k]})
            losses.append(nll)
            sdzs.append(sd_z)
        for s in range(full, nsteps):
            with self.timers.phase(phase + ".eager"):
                nll, sd_z = step(self._gather_staged(data, order[s]))
            losses.append(nll.reshape(1))
            sdzs.append(sd_z.reshape(1))
        return torch.cat(losses), torch.cat(sdzs)

    # ------------------------------------------------------------- epochs
    def train_epoch(self, batches: Iterable[Dict], steps_per_call: Optional[int] = None):
        """One pass over host batches. ``steps_per_call`` (default
        ``cfg.steps_per_call``) K > 1 groups a trainable flow's steps by K
        (``_train_epoch_scan``); else one step a batch."""
        k = steps_per_call if steps_per_call is not None else self._steps_per_call()
        if k > 1 and self.trainable:
            return self._train_epoch_scan(batches, k)
        with annotate("nf.epoch"):
            losses, sdzs = [], []
            for mb in _timed_iter(batches, self.timers, "input"):
                with self.timers.phase("epoch.eager"):
                    nll, sd_z = self._step_or_eval(self._put(mb))
                losses.append(nll)
                sdzs.append(sd_z)
            self.epoch_steps = (torch.stack(losses), torch.stack(sdzs))
            with self.timers.phase("epoch.sync"):
                return (float(self.epoch_steps[0].mean()), float(self.epoch_steps[1].mean()))

    def _train_epoch_scan(self, batches: Iterable[Dict], k: int):
        """The epoch in groups of k host batches (JAX's ``_train_epoch_scan``):
        full groups only; a ragged tail or a batch-shape change runs single
        steps. A full group is fed as one [k, B, ...] tensor a field
        (``_put_stacked``; B the rank's) and runs as a graph replay over a
        static copy of it where ``graphs_on``, else as k eager steps on its
        rows."""
        losses, sdzs = [], []

        def at(feed, j):
            return {n: v[j] for n, v in feed.items()}

        def flush(buf):
            if len(buf) == k:
                with self.timers.phase("input"):
                    feed = self._put_stacked(buf)
                if self.graphs_on:
                    g = self._graph(("host", True, k, feed["_x"].shape[1]), self.train_step,
                                    feed, at, True)
                    with self.timers.phase("epoch.replay"):
                        nll, sd_z = g.replay(feed)
                else:
                    outs = []
                    for j in range(k):
                        with self.timers.phase("epoch.eager"):
                            outs.append(self.train_step(at(feed, j)))
                    nll, sd_z = (torch.stack(v) for v in zip(*outs))
                losses.append(nll)
                sdzs.append(sd_z)
                return
            for mb in buf:
                with self.timers.phase("epoch.eager"):
                    nll, sd_z = self.train_step(self._put(mb))
                losses.append(nll.reshape(1))
                sdzs.append(sd_z.reshape(1))

        with annotate("nf.epoch"):
            buf = []
            for mb in _timed_iter(batches, self.timers, "input"):
                if buf and np.shape(mb["_x"]) != np.shape(buf[0]["_x"]):
                    flush(buf)
                    buf = []
                buf.append(mb)
                if len(buf) == k:
                    flush(buf)
                    buf = []
            if buf:
                flush(buf)
            self.epoch_steps = (torch.cat(losses), torch.cat(sdzs))
            with self.timers.phase("epoch.sync"):
                return float(self.epoch_steps[0].mean()), float(self.epoch_steps[1].mean())

    def eval_epoch(self, batches: Iterable[Dict]):
        out = [self.eval_step(self._put(mb)) for mb in batches]
        return (float(torch.stack([o[0] for o in out]).mean()),
                float(torch.stack([o[1] for o in out]).mean()))

    def _fix_cam_iso(self, mb: Dict) -> Dict:
        """Sample with cam=S6, iso=100; the reference feeds nlf0 == nlf1 ==
        its NLF table's first entry (ref:train_noise_flow.py:158-159)."""
        shape = (mb["_x"].shape[0],)
        return {**mb, **{k: torch.full(shape, v, device=self.device) for k, v in
                         (("iso", 100.0), ("cam", 2.0), ("nlf0", _NLF_S6_100),
                          ("nlf1", _NLF_S6_100))}}

    def _host_kld(self, db: Dict, temp: float, generator, sc_sd: float, vis_dir):
        """Sample on the device, NLL there, KLDs in numpy (owns the .mat dump).
        Under a mesh the KLDs are over this rank's rows only (JAX's host path
        is shard-local per process), and only rank 0 writes the dump."""
        if self.mesh.rank:
            vis_dir = None
        with torch.no_grad():
            x = self.flow.sample(batch_to_cond(db), temp, batch=db["_y"].shape[0],
                                 train=False, generator=generator)
        nll, sd_z = self.eval_step({**db, "_x": x})
        with self.timers.phase("sample_host"):
            mb = {k: v.cpu().numpy() for k, v in db.items()}
            kld = calc_kldiv_mb(mb, x.cpu().numpy(), sc_sd, vis_dir=vis_dir)
        return nll, sd_z, kld, len(range(0, x.shape[0], 5))

    def sample_epoch(self, batches: Iterable[Dict], temp: float,
                     generator: Optional[torch.Generator] = None, sc_sd: float = 1.0,
                     fix_cam_iso: bool = True, compute_kld: bool = True,
                     vis_dir: Optional[str] = None, on_device_kld: bool = True):
        """Per-epoch sampling diagnostics (ref:train_noise_flow.py:139-184):
        sample with (optionally) fixed cam=S6 iso=100, push samples back
        through the inverse for their NLL, and compute marginal KLDs. With
        vis_dir the first batch takes the numpy path and dumps the per-patch
        .mat artifact set there (ref:sidd_utils.py:995-1058)."""
        losses, sdzs = [], []
        kld_sum, kld_cnt = np.zeros(4), 0.0
        for bi, mb in enumerate(batches):
            db = self._put(mb)
            if fix_cam_iso:
                db = self._fix_cam_iso(db)
            use_dev = compute_kld and on_device_kld and not (vis_dir is not None and bi == 0)
            with self.timers.phase("sample"):
                if use_dev:
                    nll, sd_z, sums, cnt = self.sample_kld_step(db, temp, sc_sd, generator)
                    kld_sum += sums.cpu().numpy()
                    kld_cnt += cnt
                elif compute_kld:
                    nll, sd_z, kld, n_pat = self._host_kld(
                        db, temp, generator, sc_sd, vis_dir if bi == 0 else None)
                    kld_sum += kld * n_pat
                    kld_cnt += n_pat
                else:
                    with torch.no_grad():
                        x = self.flow.sample(batch_to_cond(db), temp, train=False,
                                             generator=generator)
                    nll, sd_z = self.eval_step({**db, "_x": x})
            losses.append(nll)
            sdzs.append(sd_z)
        kld = kld_sum / kld_cnt if kld_cnt else np.zeros(4)
        return (float(torch.stack(losses).mean()), float(torch.stack(sdzs).mean()), kld)

    # ------------------------------------------------ device-resident data
    _staged_train = None
    _staged_test = None
    # number of test batches the per-epoch sampling phase runs over when
    # sampling from the staged set (0 = the full staged split)
    sample_batches_cap = 0

    def stage_dataset(self, batches: Iterable[Dict], split: str = "train",
                      max_patches: int = 0) -> int:
        """Stream one pass of `batches` and stage the whole set on the card
        as one tensor per field; epochs then gather their batches there with
        ``index_select``. max_patches > 0 truncates the stream. Returns the
        staged patch count. Single rank only, as JAX's (under a mesh each rank
        is fed its shard instead)."""
        if self.mesh.size > 1:
            raise ValueError("device-resident staging is single-rank; under a mesh each "
                             "rank is fed its shard of every batch")
        cols = {k: [] for k in _KEEP}
        n = 0
        for mb in batches:
            for k in _KEEP:
                cols[k].append(np.asarray(mb[k], np.float32))
            n += len(cols["_x"][-1])
            if max_patches and n >= max_patches:
                break
        if not cols["_x"]:
            raise ValueError("stage_dataset: empty batch stream")
        host = {k: np.concatenate(v) for k, v in cols.items()}
        if max_patches:
            host = {k: v[:max_patches] for k, v in host.items()}
        setattr(self, f"_staged_{split}",
                {k: torch.as_tensor(v, device=self.device) for k, v in host.items()})
        self._graphs.clear()   # captured on the set this replaces
        return int(host["_x"].shape[0])

    def _gather_staged(self, data: Dict, idx) -> Dict:
        with annotate("nf.step.gather"):
            idx = torch.as_tensor(idx, dtype=torch.long, device=self.device)
            return {k: v.index_select(0, idx) for k, v in data.items()}

    def _steps_per_call(self) -> int:
        return max(int(getattr(self.cfg, "steps_per_call", 1)), 1)

    def _train_epoch_staged(self, shuffle_seed: int):
        """One epoch over the staged train set in a permutation drawn from
        ``shuffle_seed``, in groups of ``cfg.steps_per_call`` (JAX's
        ``_train_epoch_staged``); a non-trainable flow takes eval steps."""
        data = self._staged_train
        n = int(data["_x"].shape[0])
        b = self.cfg.n_batch_train
        nsteps = n // b
        if nsteps == 0:
            raise ValueError(
                f"staged train set has {n} patches < n_batch_train={b}; "
                "stage more patches or lower the batch size")
        with annotate("nf.epoch"):
            with self.timers.phase("epoch.order"):
                order = np.random.default_rng(shuffle_seed).permutation(n)[:nsteps * b]
                order = torch.as_tensor(order.reshape(nsteps, b), device=self.device)
            nlls, sdzs = self._staged_steps("train", order, self._steps_per_call(),
                                            self.trainable)
            self.epoch_steps = (nlls, sdzs)
            with self.timers.phase("epoch.sync"):
                return float(nlls.mean()), float(sdzs.mean())

    def _staged_test_steps(self, max_batches: int = 0):
        """[nsteps, n_batch_test]: the staged test set's batches in order
        (the first ``max_batches`` when it is set)."""
        n = int(self._staged_test["_x"].shape[0])
        b = self.cfg.n_batch_test
        nsteps = n // b
        if nsteps == 0:
            raise ValueError(
                f"staged test set has {n} patches < n_batch_test={b}; "
                "stage more patches or lower the batch size")
        if max_batches:
            nsteps = min(nsteps, max_batches)
        return torch.arange(nsteps * b, device=self.device).reshape(nsteps, b)

    def _eval_epoch_staged(self):
        """The whole staged test set, in groups of ``cfg.steps_per_call``."""
        nlls, sdzs = self._staged_steps("test", self._staged_test_steps(),
                                        self._steps_per_call(), train=False)
        return float(nlls.mean()), float(sdzs.mean())

    def _sample_epoch_staged(self, temp: float, generator=None, sc_sd: float = 1.0,
                             fix_cam_iso: bool = True, vis_dir: Optional[str] = None,
                             max_batches: int = 0):
        """sample_epoch over the staged test set: batches gather on the card
        and the KLD sums stay there until one copy at the end. The first
        batch takes the numpy path when vis_dir is set (the .mat dump)."""
        losses, sdzs = [], []
        kld_sum = torch.zeros((4,), device=self.device)
        kld_cnt = 0
        host_sum, host_cnt = np.zeros(4), 0
        for s, idx in enumerate(self._staged_test_steps(max_batches)):
            batch = self._gather_staged(self._staged_test, idx)
            if fix_cam_iso:
                batch = self._fix_cam_iso(batch)
            if vis_dir is not None and s == 0:
                nll, sd_z, kld, n_pat = self._host_kld(batch, temp, generator, sc_sd, vis_dir)
                host_sum += kld * n_pat
                host_cnt += n_pat
            else:
                with self.timers.phase("sample"):
                    nll, sd_z, sums, cnt = self.sample_kld_step(batch, temp, sc_sd, generator)
                kld_sum = kld_sum + sums
                kld_cnt += cnt
            losses.append(nll)
            sdzs.append(sd_z)
        with self.timers.phase("sync"):
            tot_cnt = kld_cnt + host_cnt
            kld = ((kld_sum.cpu().numpy() + host_sum) / tot_cnt if tot_cnt else np.zeros(4))
            return (float(torch.stack(losses).mean()), float(torch.stack(sdzs).mean()), kld)

    # ----------------------------------------------------------- main loop
    def fit(self, train_batches_fn, test_batches_fn, logdir: str,
            epochs: Optional[int] = None, nll_gauss: float = 0.0,
            nll_sdn: float = 0.0, sc_sd: float = 1.0,
            do_sampling: bool = True, verbose: bool = True,
            sample_batches_fn=None):
        """Full epoch loop with the reference's test gating
        (ref:train_noise_flow.py:384-535). *_batches_fn are callables
        returning fresh batch iterators per epoch; sample_batches_fn
        (default: test_batches_fn) feeds the per-epoch sampling diagnostics
        only."""
        cfg = self.cfg
        epochs = epochs or cfg.epochs
        # under a mesh only rank 0 writes logs and checkpoints; the metrics
        # are global, so every rank agrees on the best model
        is_chief = self.mesh.rank == 0
        os.makedirs(logdir, exist_ok=True)
        ckpt_dir = os.path.join(logdir, "ckpt")

        def mk_logger(name, columns):
            if not is_chief:
                return _NullLogger()
            return ResultLogger(os.path.join(logdir, name), columns, cfg.continue_training)

        cols = ["epoch", "NLL", "NLL_G", "NLL_SDN", "sdz"]
        train_logger = mk_logger("train.txt", cols + ["train_time"])
        test_logger = mk_logger("test.txt", cols + ["msg"])
        sample_logger = mk_logger(
            "sample.txt", cols + ["sample_time", "KLD_G", "KLD_NLF", "KLD_NF", "KLD_R"])

        start_epoch = 1
        if cfg.continue_training:
            last = latest_checkpoint(ckpt_dir)
            if last:
                start_epoch = load_checkpoint(last, self.flow, self.optimizer) + 1
                self._graphs.clear()   # the optimizer's slots are new tensors

        best_nll = np.inf
        # each rank draws its own samples
        generator = torch.Generator(device=self.device).manual_seed(
            cfg.seed + 1 + (self.mesh.rank << 32))
        train_time = 0.0
        history = {"train": [], "test": [], "sample": []}

        # Ctrl-C: finish the current epoch, save a resumable checkpoint,
        # close the TSV logs, and exit cleanly (ref:train_noise_flow.py:545-548)
        interrupted = {"flag": False}
        prev_handler = None
        in_main_thread = threading.current_thread() is threading.main_thread()
        if in_main_thread:
            def _on_sigint(signum, frame):
                interrupted["flag"] = True
                print("SIGINT: finishing epoch, saving checkpoint...", flush=True)
            prev_handler = signal.signal(signal.SIGINT, _on_sigint)

        def save(tag, epoch):
            if is_chief:
                save_checkpoint(ckpt_dir, tag, self.flow, epoch, self.optimizer)

        try:
            for epoch in range(start_epoch, epochs + 1):
                do_test = (epoch < 10 or (epoch < 100 and epoch % 10 == 0)
                           or epoch % cfg.epochs_full_valid == 0)
                is_best = 0
                if do_test:
                    if self._staged_test is not None:
                        ts_nll, ts_sdz = self._eval_epoch_staged()
                    else:
                        ts_nll, ts_sdz = self.eval_epoch(test_batches_fn())
                    history["test"].append(ts_nll)
                    save(epoch, epoch)
                    if ts_nll < best_nll:
                        best_nll = ts_nll
                        save("best", epoch)
                        is_best = 1
                    test_logger.log({"epoch": epoch, "NLL": ts_nll, "NLL_G": nll_gauss,
                                     "NLL_SDN": nll_sdn, "sdz": ts_sdz, "msg": is_best})

                if do_sampling and do_test:
                    t0 = time.time()
                    # per-epoch sample visualization artifacts
                    # (ref:train_noise_flow.py:176-177)
                    vis_dir = os.path.join(logdir, "samples_epoch_%04d" % epoch,
                                           "samples_%.1f" % cfg.temp)
                    if self._staged_test is not None:
                        sm_nll, sm_sdz, kld = self._sample_epoch_staged(
                            cfg.temp, generator, sc_sd, vis_dir=vis_dir,
                            max_batches=self.sample_batches_cap)
                    else:
                        sm_nll, sm_sdz, kld = self.sample_epoch(
                            (sample_batches_fn or test_batches_fn)(), cfg.temp,
                            generator, sc_sd, vis_dir=vis_dir)
                    history["sample"].append(sm_nll)
                    sample_logger.log({
                        "epoch": epoch, "NLL": sm_nll, "NLL_G": nll_gauss,
                        "NLL_SDN": nll_sdn, "sdz": sm_sdz, "sample_time": time.time() - t0,
                        "KLD_G": kld[0], "KLD_NLF": kld[1], "KLD_NF": kld[2], "KLD_R": kld[3]})

                t0 = time.time()
                self.timers.reset()
                if self._staged_train is not None:
                    tr_nll, tr_sdz = self._train_epoch_staged(cfg.seed + epoch)
                else:
                    tr_nll, tr_sdz = self.train_epoch(train_batches_fn())
                train_time += time.time() - t0
                history["train"].append(tr_nll)
                train_logger.log({"epoch": epoch, "NLL": tr_nll, "NLL_G": nll_gauss,
                                  "NLL_SDN": nll_sdn, "sdz": tr_sdz,
                                  "train_time": int(train_time)})
                if verbose and do_test:
                    print(f"E={epoch} tL={tr_nll:9.1f} sL={history['test'][-1]:9.1f} "
                          f"SDr={tr_sdz:.2f} B={is_best} [{self.timers.line()}]", flush=True)
                if is_chief and self.timers.totals:
                    # the last epoch's input-vs-step attribution
                    with open(os.path.join(logdir, "phase_timers.txt"), "w") as f:
                        f.write(f"epoch {epoch}: {self.timers.line()}\n")
                if interrupted["flag"]:
                    save(epoch, epoch)
                    break
        finally:
            if in_main_thread:
                signal.signal(signal.SIGINT, prev_handler)
            for lg in (train_logger, test_logger, sample_logger):
                lg.close()
        return history
