"""Attribution probes of the train kernels' template on the card.

The Hopper counterparts of the TPU diagnostics in ``experiments/`` that
probed the one-shot and segment train kernels (``SITES``: the 12
``pl.pallas_call`` sites, each with the question it asked). Their kernels
are in ``csrc/train_probe.cu`` and, for the template's designs and
ablations, ``csrc/train_variants.cuh``; this module launches them, holds
every variant that has a plain version against it, and times every
variant at the flagship shapes: the published model
``experiments/sidd/prod_exact_150``, B = 138, BN groups of 69 and 138,
float32 and bfloat16.

On the card, from the root of a checkout::

    python -m noise_flow_tpu_torch.probes.train_template [--out FILE]

prints one line per variant and, with ``--out``, writes the table as JSON.
``--frame`` also times the fused sampler's batch-BN frame with the whole
batch as one BN group (the wrapper's ``bt = b``). Every run first times the
running-statistics eval forward's redesign against its parent's design
(``csrc/segment_probe.cu``, which also holds the redesign with planted
faults) at ``EVAL_BATCHES`` in both precisions (``eval_times``); ``--eval``
runs that alone.

Each wrapper takes CUDA tensors and launches its kernel. On CPU tensors it
runs the plain version of the function its full variant computes; the
ablated variants break the numerics on purpose and have none, so they raise
there.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, NamedTuple, Optional

import torch

from noise_flow_tpu_torch.ops import fused_sample as fs
from noise_flow_tpu_torch.ops import fused_train as ft

ROOT = Path(__file__).resolve().parents[2]
MODEL = ROOT / "experiments" / "sidd" / "prod_exact_150"
SOURCE = "noise_flow_tpu_torch/csrc/train_probe.cu"
VARIANT_SOURCE = "noise_flow_tpu_torch/csrc/train_variants.cuh"
B = 138
BTS = (69, 138)
DTYPES = ("float32", "bfloat16")
# the designs of the template (train_kernel.cuh): the parent's, the redesign
PARENT, PROD = "parent", "redesign"
DESIGNS = (PARENT, PROD)
REPS = 20                     # launches a timed call of the small probes
# the ablations (train_kernel.cuh, enum Ablation) of each segment kernel
BWD_ABLATIONS = {"full": 0, "no_wgrad": 1, "bn_diag": 2, "no_epilogue": 3, "forward_only": 4}
FWD_ABLATIONS = {"full": 0, "no_epilogue": 3, "no_bn_stats": 5}
BN_VARIANTS = ("production", "no_reduction", "group_barrier", "merged")
F32_ONLY_BN = ("no_reduction", "merged")   # no group sums to round / no second pass
WGRAD_VARIANTS = ("warp", "mma")
LAUNCH_VARIANTS = ("coop", "plain", "operands", "outputs")
FLOOR_VARIANTS = ("noop", "bounds", "syncs", "residuals")
N_BN = 8                      # chained normalisations of the bn probe
SYNC_COUNTS = (25, 49)        # grid.sync() of a segment backward and of a step (parent)
PEAK_FP32_FLOPS, PEAK_BF16_FLOPS, PEAK_HBM_BYTES = 67e12, 989e12, 3.35e12
SLEEP_CYCLES_PER_MS = 2_000_000   # the H100's SM clock is at most 1.98 GHz
# the planted faults of the redesigned eval forward in the probe library
# (csrc/segment_probe.cu; their codes are the E_FAULT_* bits of
# csrc/segment_kernel.cuh): the barrier before conv3 left out (conv3 reads
# the other warps' rows in a race), the running variances staged in place of
# 1/sqrt(var + eps)
SEG_FAULTS = {"nosync": 1, "moments": 2}
# the eval forward's timed batches: one patch (the latency path), the SMs'
# count and one over it, the flagship's eval batch, two CTAs an SM and one
# over it, and a large batch
EVAL_BATCHES = (1, 132, 133, 138, 264, 265, 4096)


class Site(NamedTuple):
    """One pl.pallas_call of experiments/ and its Hopper counterpart."""
    name: str          # the probe's name in the kernels line
    file: str          # under experiments/
    line: int          # the line of the pl.pallas_call
    function: str      # the TPU kernel or probe it launches
    question: str
    counterpart: str
    counters: tuple    # its wrappers' keys in fused_sample.launch_counts


SITES = (
    Site("probe_attrib_forward", "train_attrib.py", 281, "_fwd_kernel_variant",
         "where the segment forward's time goes",
         "train_kernel<SEG_FWD> (the ghost-BN segment forward): full, no BN moments "
         "(the TPU's bn_stats=False; stats_in too, whose moments come from memory), no "
         "elementwise epilogue (elem=False, ldj_on=False); both designs",
         ("train_probe_segment_train_forward",)),
    Site("probe_attrib_backward", "train_attrib.py", 311, "_bwd_kernel_variant",
         "where the segment backward's time goes",
         "train_kernel<SEG_BWD>: full, no weight gradients, BN backward diagonal, "
         "no elementwise epilogues, forward only; both designs",
         ("train_probe_segment_backward",)),
    Site("probe_bn_moments", "bn_wgrad_probe.py", 128, "bn_kernel",
         "cost of the ghost-BN moment reduction",
         "8 chained ghost-BN normalisations across CTAs: production, no reduction, "
         "group-scoped barrier, merged (sum, M2)", ("train_probe_bn_chain",)),
    Site("probe_wgrad", "bn_wgrad_probe.py", 144, "wgrad_kernel",
         "cost of the weight-gradient contraction",
         "production wgrad (taps over warps, butterfly) against bf16 mma.sync over "
         "pixels, 3x3x4->4 and 4->4", ("train_probe_wgrad",)),
    Site("probe_launch_coop", "b138_launch_probe.py", 76, "copy_kernel",
         "launch cost of a minimal kernel in the step's context",
         "empty cooperative launch with the StepArgs block at the step's grid",
         ("train_probe_coop",)),
    Site("probe_launch_plain", "b138_launch_probe.py", 99, "copy_kernel (grid over 138)",
         "marginal cost of the grid",
         "the same kernel, plain launch", ("train_probe_plain",)),
    Site("probe_launch_operands", "b138_launch_probe.py", 129, "heavy_operand_kernel",
         "launch cost with the step's operand set",
         "cooperative launch reading the step's whole operand set and copying x",
         ("train_probe_operands",)),
    Site("probe_launch_outputs", "b138_launch_probe.py", 156, "heavy_output_kernel",
         "launch cost with the step's output set",
         "cooperative launch writing the step's whole output set", ("train_probe_outputs",)),
    Site("probe_floor_noop", "b138_floor_discriminate.py", 75, "k_noop",
         "the floor of a no-op call",
         "no-op cooperative kernel at the step's grid", ("train_probe_noop",)),
    Site("probe_floor_bounds", "b138_floor_discriminate.py", 91, "k_smem (SMEM operands)",
         "cost of the call's resource declarations",
         "+ __launch_bounds__(256, 2) and the step's 32 KB of static shared memory",
         ("train_probe_bounds",)),
    Site("probe_floor_syncs", "b138_floor_discriminate.py", 105,
         "k_noop with sequential-grid compiler params",
         "cost of the call's sequential semantics",
         "+ 25 and 49 grid.sync(): cost per barrier", ("train_probe_syncs",)),
    Site("probe_floor_body", "b138_floor_discriminate.py", 141, "k_big (bigbody, hugebody)",
         "cost of a large body",
         "+ the parent design's residual scratch (117 MB at B = 138) written and read "
         "back; the full body: the step kernel in each design",
         ("train_probe_residuals", "train_probe_step")),
)


def pallas_call_lines(root: Path = ROOT, sites=SITES) -> Dict[Site, bool]:
    """Whether each site's line in experiments/ holds a ``pl.pallas_call``
    (read as text; nothing of JAX is imported)."""
    out = {}
    for s in sites:
        lines = (root / "experiments" / s.file).read_text().splitlines()
        out[s] = s.line <= len(lines) and "pl.pallas_call" in lines[s.line - 1]
    return out


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def _lib():
    from noise_flow_tpu_torch.ops._build import load_library
    return load_library("train_probe")


def _vlib(design: str, mm_dtype):
    """The template's library of ``design`` (PARENT or PROD) and precision."""
    from noise_flow_tpu_torch.ops._build import load_library
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}: one of {DESIGNS}")
    precision = "bf16" if fs.is_bf16(mm_dtype) else "f32"
    return load_library(f"train_variants_{'parent' if design == PARENT else 'prod'}_{precision}")


def _launch(name: str, entry, dev, *args) -> None:
    """Call a probe entry with args, then the current stream of dev and the
    launch count it sets; count its launches under ``name``; raise if the
    launch failed."""
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = entry(*args, torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launched))
    fs.launch_counts[name] += launched.value
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _cuda_only(name, *ts):
    if any(t.device.type != "cuda" for t in ts):
        raise ValueError(f"{name} variants other than the full one run on CUDA tensors only")


def train_step(design, x, clean, sa, sb, rec, offs, mixes, ops_code, bt, mm_dtype="float32"):
    """``fused_train.fused_train_step`` in ``design`` (PARENT or PROD)."""
    if x.device.type == "cpu":
        return ft.train_step_reference(x, clean, sa, sb, rec, offs, mixes, ops_code, bt, mm_dtype)
    b, ns, nc, nm = x.shape[0], sa.shape[1], rec.shape[0], mixes.shape[0]
    ft._check_segment(x, rec, offs, mixes, [], bt)
    lib = _vlib(design, mm_dtype)
    f4, f1, wpart = ft._scratch(lib, ft._STEP, b, bt, nc, nm, len(ops_code), x.device)
    empty = functools.partial(torch.empty, dtype=torch.float32, device=x.device)
    out = {"rows": empty((b, 3)), "gsa": torch.zeros_like(sa), "gsb": torch.zeros_like(sb),
           "grad_w": empty((nc * fs.REC + nm * 16,)), "grad_offs": empty((nc, 32, 32, 4)),
           "bnmom": empty((nc, 4, 4))}
    _launch("train_probe_step", lib.nf_variant_train_step, x.device, x.data_ptr(),
            clean.data_ptr(), sa.data_ptr(), sb.data_ptr(), rec.data_ptr(), offs.data_ptr(),
            mixes.data_ptr(), f4.data_ptr(), f1.data_ptr(), wpart.data_ptr(),
            out["rows"].data_ptr(), out["gsa"].data_ptr(), out["gsb"].data_ptr(),
            out["grad_w"].data_ptr(), out["grad_offs"].data_ptr(), out["bnmom"].data_ptr(), b,
            bt, ns, nc, nm, 1.0 / b, -1.0 / b, ft._ops_array(ops_code), len(ops_code))
    gw = out.pop("grad_w")
    out["grad_rec"] = gw[:nc * fs.REC].view(nc, fs.REC)
    out["grad_mixes"] = gw[nc * fs.REC:].view(nm, 4, 4)
    return out


def segment_backward(design, ablation, x, rec, offs, mixes, ops_code, bt, gz, gldj,
                     mm_dtype="float32"):
    """``fused_train.fused_segment_backward`` in ``design`` with an ablation
    (a key of ``BWD_ABLATIONS``)."""
    abl = BWD_ABLATIONS[ablation]
    if x.device.type == "cpu" and ablation == "full":
        return ft.segment_backward_reference(x, rec, offs, mixes, ops_code, bt, gz, gldj,
                                             mm_dtype)
    _cuda_only("segment_backward", x)
    b, nc, nm = ft._check_segment(x, rec, offs, mixes, ops_code, bt)
    lib = _vlib(design, mm_dtype)
    f4, f1, wpart = ft._scratch(lib, ft._SEG_BWD, b, bt, nc, nm, len(ops_code), x.device)
    gx = torch.empty_like(x)
    grad_w = torch.empty((nc * fs.REC + nm * 16,), dtype=torch.float32, device=x.device)
    goffs = torch.empty((nc, 32, 32, 4), dtype=torch.float32, device=x.device)
    _launch("train_probe_segment_backward", lib.nf_variant_segment_backward, x.device, abl,
            x.data_ptr(), gz.data_ptr(), gldj.data_ptr(), rec.data_ptr(), offs.data_ptr(),
            mixes.data_ptr(), f4.data_ptr(), f1.data_ptr(), wpart.data_ptr(), gx.data_ptr(),
            grad_w.data_ptr(), goffs.data_ptr(), b, bt, nc, nm, ft._ops_array(ops_code),
            len(ops_code))
    return gx, grad_w[:nc * fs.REC].view(nc, fs.REC), goffs, grad_w[nc * fs.REC:].view(nm, 4, 4)


def segment_train_forward(design, ablation, x, rec, offs, mixes, ops_code, bt,
                          mm_dtype="float32"):
    """``fused_train.fused_segment_train_forward`` in ``design`` with an
    ablation (a key of ``FWD_ABLATIONS``): (z, ldj [B], bnmom [nc, 4, 4])."""
    abl = FWD_ABLATIONS[ablation]
    if x.device.type == "cpu" and ablation == "full":
        return ft.segment_train_forward_reference(x, rec, offs, mixes, ops_code, bt, mm_dtype)
    _cuda_only("segment_train_forward", x)
    b, nc, nm = ft._check_segment(x, rec, offs, mixes, ops_code, bt)
    lib = _vlib(design, mm_dtype)
    f4, f1, _ = ft._scratch(lib, ft._SEG_FWD, b, bt, nc, nm, len(ops_code), x.device)
    z = torch.empty_like(x)
    rows = torch.empty((b, 3), dtype=torch.float32, device=x.device)
    bnmom = torch.empty((nc, 4, 4), dtype=torch.float32, device=x.device)
    _launch("train_probe_segment_train_forward", lib.nf_variant_segment_train_forward, x.device,
            abl, x.data_ptr(), z.data_ptr(), rows.data_ptr(), bnmom.data_ptr(), rec.data_ptr(),
            offs.data_ptr(), mixes.data_ptr(), f4.data_ptr(), f1.data_ptr(), b, bt, nc, nm,
            ft._ops_array(ops_code), len(ops_code))
    return z, rows[:, 0], bnmom


# ---------------------------------------------------------------------------
# the running-statistics eval forward's probe library (csrc/segment_probe.cu)
# ---------------------------------------------------------------------------

def _seg_lib():
    from noise_flow_tpu_torch.ops._build import load_library
    return load_library("segment_probe")


def segment_forward_parent(x, rec, offs, mixes, ops_code, mm_dtype="float32", bnrun=None):
    """``fused_train.fused_segment_forward`` in the parent's design (one CTA
    a patch, the record read in device memory at every tap, three barriers a
    coupling): (z, ldj [B]). CPU tensors: its plain version."""
    if x.device.type == "cpu":
        return ft.segment_forward_reference(x, rec, offs, mixes, ops_code, mm_dtype, bnrun)
    if x.device.type != "cuda":
        raise ValueError(f"segment_forward_parent runs on CUDA or CPU tensors, got {x.device}")
    b, nc, nm = ft._check_eval(x, rec, offs, mixes, ops_code, bnrun)
    z = torch.empty_like(x)
    ldj = torch.empty((b,), dtype=torch.float32, device=x.device)
    _launch("segment_probe_parent", _seg_lib().nf_segment_forward_parent, x.device,
            x.data_ptr(), z.data_ptr(), ldj.data_ptr(), rec.data_ptr(), offs.data_ptr(),
            mixes.data_ptr(), None if bnrun is None else bnrun.data_ptr(), b, nc, nm,
            ft._ops_array(ops_code), len(ops_code), int(fs.is_bf16(mm_dtype)))
    return z, ldj


def segment_forward_fault(fault, x, rec, offs, mixes, ops_code, mm_dtype="float32", bnrun=None):
    """The redesigned running-statistics forward with a ``SEG_FAULTS``
    fault planted: (z, ldj [B]). It breaks the function on purpose, so it
    has no plain version (CUDA only)."""
    _cuda_only("segment_forward_fault", x)
    b, nc, nm = ft._check_eval(x, rec, offs, mixes, ops_code, bnrun)
    z = torch.empty_like(x)
    ldj = torch.empty((b,), dtype=torch.float32, device=x.device)
    _launch("segment_probe_fault", _seg_lib().nf_segment_fault, x.device, SEG_FAULTS[fault],
            x.data_ptr(), z.data_ptr(), ldj.data_ptr(), rec.data_ptr(), offs.data_ptr(),
            mixes.data_ptr(), None if bnrun is None else bnrun.data_ptr(), b, nc, nm,
            ft._ops_array(ops_code), len(ops_code), int(fs.is_bf16(mm_dtype)))
    return z, ldj


def segment_parent_occupancy(mm_dtype="float32") -> int:
    """CTAs an SM of the parent's eval forward kernel (the occupancy API)."""
    n = ctypes.c_int(0)
    err = _seg_lib().nf_segment_parent_occupancy(int(fs.is_bf16(mm_dtype)), ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"nf_segment_parent_occupancy failed: CUDA error {err}")
    return n.value


def bn_chain_reference(x, bt: int, n: int = N_BN, mm_dtype="float32"):
    """n chained ghost-BN normalisations (two-pass biased moments of each
    group of bt patches, as the train kernels); bfloat16 rounds each lane's
    group sums as their moments do."""
    for _ in range(n):
        x = ft._BF16GhostBN.apply(x, bt)[0] if fs.is_bf16(mm_dtype) else ft._ghost_bn(x, bt)[0]
    return x


def bn_chain(variant, x, bt: int, n: int = N_BN, mm_dtype="float32", reps: int = 1):
    """``bn_chain_reference`` by a ``BN_VARIANTS`` reduction, in place on a
    copy of x [B, 32, 32, 4] (``reps`` launches: the chain again on its own
    output). "no_reduction" normalises each patch by its own moments (its
    plain version is bt = 1); it and "merged" run in float32 whatever
    ``mm_dtype`` says (``F32_ONLY_BN``)."""
    v = BN_VARIANTS.index(variant)
    if variant in F32_ONLY_BN:
        mm_dtype = "float32"
    if x.device.type == "cpu":
        return bn_chain_reference(x, 1 if variant == "no_reduction" else bt, n, mm_dtype)
    b = x.shape[0]
    out = x.clone()
    part = torch.empty((2, b, 256), dtype=torch.float32, device=x.device)
    gbar = torch.empty((b // bt,), dtype=torch.int32, device=x.device)
    _launch("train_probe_bn_chain", _lib().nf_probe_bn_chain, x.device, v, reps,
            out.data_ptr(), part.data_ptr(), gbar.data_ptr(), b, bt, n,
            int(fs.is_bf16(mm_dtype)))
    return out


def wgrad_reference(ntaps: int, a, g):
    """out [B, ntaps * 16]: sum over the pixels of a's tap-shifted channels
    (zero outside the patch) times g's, both rounded to bfloat16, in float32."""
    a, g = fs.bf16_round(a), fs.bf16_round(g)
    if ntaps == 1:
        return torch.einsum("bhwi,bhwo->bio", a, g).reshape(a.shape[0], 16)
    ap = torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1))
    taps = [torch.einsum("bhwi,bhwo->bio", ap[:, dh:dh + 32, dw:dw + 32], g)
            for dh in range(3) for dw in range(3)]
    return torch.stack(taps, 1).reshape(a.shape[0], 144)


def wgrad_matmul_operands(ntaps: int, a, g):
    """The operands with which one ``torch.matmul`` computes
    ``wgrad_reference`` (its output reshaped to [B, ntaps * 16]): a's
    tap-shifted channels [B, ntaps * 4, 1024] by g's [B, 1024, 4], both
    rounded to bfloat16, laid out as the matmul takes them (as the JAX
    probe's ``mm(x.reshape(R, L).T, g)`` takes its operand's transpose)."""
    a, g = fs.bf16_round(a), fs.bf16_round(g)
    b = a.shape[0]
    if ntaps == 1:
        taps = a[:, None]
    else:
        ap = torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1))
        taps = torch.stack([ap[:, dh:dh + 32, dw:dw + 32]
                            for dh in range(3) for dw in range(3)], 1)
    return (taps.permute(0, 1, 4, 2, 3).reshape(b, ntaps * 4, 1024).contiguous(),
            g.reshape(b, 1024, 4))


def wgrad(variant, ntaps: int, a, g, reps: int = 1):
    """``wgrad_reference`` by a ``WGRAD_VARIANTS`` layout, one CTA a patch
    (``reps`` launches back to back)."""
    if a.device.type == "cpu":
        return wgrad_reference(ntaps, a, g)
    out = torch.empty((a.shape[0], ntaps * 16), dtype=torch.float32, device=a.device)
    _launch("train_probe_wgrad", _lib().nf_probe_wgrad, a.device,
            WGRAD_VARIANTS.index(variant), ntaps, reps, a.data_ptr(), g.data_ptr(),
            out.data_ptr(), a.shape[0])
    return out


def launch(variant, n, x, clean, sa, sb, rec, offs, mixes, ops_code, bt, scratch_f4,
           reps: int = 1) -> None:
    """A launch probe (``LAUNCH_VARIANTS``) or floor probe
    (``FLOOR_VARIANTS``) with the step's parameter block, ``reps`` times
    back to back; n is the barrier count of "syncs" and the residual tiles
    of "residuals" (of scratch_f4, which also takes "operands"' copy of x).
    The probes compute nothing to hold against a plain version."""
    _cuda_only("launch", x)
    v = (LAUNCH_VARIANTS.index(variant) if variant in LAUNCH_VARIANTS
         else 4 + FLOOR_VARIANTS.index(variant))
    b, ns, nc, nm = x.shape[0], sa.shape[1], rec.shape[0], mixes.shape[0]
    e = functools.partial(torch.empty, dtype=torch.float32, device=x.device)
    outs = (e((b, 3)), e((b, ns)), e((b, ns)), e((nc * fs.REC + nm * 16,)), e((nc, 32, 32, 4)),
            e((nc, 4, 4)))
    _launch(f"train_probe_{variant}", _lib().nf_probe_launch, x.device, v, n, reps, x.data_ptr(),
            clean.data_ptr(), sa.data_ptr(), sb.data_ptr(), rec.data_ptr(), offs.data_ptr(),
            mixes.data_ptr(), scratch_f4.data_ptr(), scratch_f4.data_ptr(), scratch_f4.data_ptr(),
            *(t.data_ptr() for t in outs), b, bt, ns, nc, nm, ft._ops_array(ops_code),
            len(ops_code))


# ---------------------------------------------------------------------------
# the attribution at the flagship shapes
# ---------------------------------------------------------------------------

def time_ms(fn, iters: int = 20) -> float:
    """Mean device ms a call over iters back-to-back calls: CUDA events
    around them, after 3 warm-up calls, with the card held busy
    (``torch.cuda._sleep``) for twice the host's time to issue them, so that
    the events time the card's work and not the host's launches."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(SLEEP_CYCLES_PER_MS * (2 * iters * host_ms + 1)))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternated_ms(fns: Dict[str, Callable], rounds: int = 3, iters: int = 5) -> Dict[str, float]:
    """The median over ``rounds`` of each fn's ``time_ms``, the fns timed in
    turns (in order, then in reverse, and so on), so that a drift of the
    card's clocks falls on all of them."""
    ms: Dict[str, list] = {k: [] for k in fns}
    order = list(fns)
    for r in range(rounds):
        for k in (order if r % 2 == 0 else order[::-1]):
            ms[k].append(time_ms(fns[k], iters))
    return {k: statistics.median(v) for k, v in ms.items()}


def _bound(flops, nbytes, bf16=False):
    t_ops = flops / (PEAK_BF16_FLOPS if bf16 else PEAK_FP32_FLOPS)
    t_bytes = nbytes / PEAK_HBM_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def _pairs(got, ref):
    """(output, plain output) tensor pairs of nested tuples, lists or dicts."""
    if isinstance(ref, torch.Tensor):
        return [(got, ref)]
    if isinstance(ref, dict):
        return [(got[k], ref[k]) for k in ref]
    return [p for g, r in zip(got, ref) for p in _pairs(g, r)]


def _errors(got, ref):
    """(largest normwise distance, largest max abs) over the outputs."""
    pairs = _pairs(got, ref)
    return (max(float((k - p).norm() / p.norm().clamp_min(1e-30)) for k, p in pairs),
            max(float((k - p).abs().max()) for k, p in pairs))


def flagship_flow(device="cuda"):
    """The published model (``MODEL``) with its checkpoint's weights."""
    from noise_flow_tpu_torch.config import load_hps
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    flow = NoiseFlow((32, 32, 4), load_hps(str(MODEL / "hps.txt")), device=device)
    load_checkpoint(str(MODEL / "ckpt" / "model.ckpt-best.npz"), flow)
    return flow


def flagship_inputs(seed: int = 11):
    """The flagship flow on the card and its fixed inputs: the one-shot
    step's (x, clean, sa, sb, rec, offs, mixes, ops_code) at B = 138, bt 69,
    in float32 and bfloat16 (the fold differs only in BN's moments), and the
    two segments' (rec, offs, mixes, ops_code) with seeded z, gz, gldj."""
    flow = flagship_flow()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    clean = 0.01 + 0.89 * torch.rand((B, 32, 32, 4), generator=gen, device="cuda")
    x = torch.randn((B, 32, 32, 4), generator=gen, device="cuda") * torch.sqrt(5e-4 * clean + 2e-6)
    grid = ((100.0, 0.0), (400.0, 1.0), (800.0, 2.0), (1600.0, 3.0), (3200.0, 4.0))
    cond = {"clean": clean.contiguous(),
            "iso": torch.tensor([grid[i % 5][0] for i in range(B)], device="cuda"),
            "cam": torch.tensor([grid[(i // 5) % 5][1] for i in range(B)], device="cuda"),
            "nlf0": torch.full((B,), 5e-4, device="cuda"),
            "nlf1": torch.full((B,), 2e-6, device="cuda")}
    step = ft.FusedTrainStep(flow, bt=BTS[0])
    with torch.no_grad():
        rec, offs, mixes, _ = step.fold()
        sa, sb, _ = step._prep(cond, B)
        ff = ft.FusedFlow(flow, bt=B)
        segs = [(*ff.fold_segment(lo, hi, fold_bn=False)[:3], ft._ops_code(seg.ops))
                for kind, seg, lo, hi in (it for it in ff.plan if it[0] == "segment")]
    z = torch.randn((B, 32, 32, 4), generator=gen, device="cuda")
    gz = torch.randn((B, 32, 32, 4), generator=gen, device="cuda") / B
    gldj = (-1.0 + 0.5 * torch.randn((B,), generator=gen, device="cuda")) / B
    return {"step": (x.contiguous(), cond["clean"], sa, sb, rec, offs, mixes, step.ops_code),
            "segments": segs, "z": z, "gz": gz, "gldj": gldj}


def _segment_work(segs, kind: str):
    """(FLOPs, bytes) of both segments' backward (kind "backward") or
    ghost-BN forward ("forward"), as chip_smoke.py counts them."""
    flops = nbytes = 0.0
    for rec, offs, mixes, _ in segs:
        n_c, n_m = rec.shape[0], mixes.shape[0]
        mac = n_c * (9 * 2 * 4 + 4 * 4 + 9 * 4 * 4) + n_m * 16
        weights = rec.numel() + offs.numel() + mixes.numel()
        if kind == "backward":
            flops += 3 * 2.0 * mac * 1024 * B
            nbytes += 4.0 * (3 * B * 4096 + B + 2 * weights)
        else:
            flops += 2.0 * mac * 1024 * B
            nbytes += 4.0 * (2 * B * 4096 + B + weights + n_c * 16)
    return flops, nbytes


Check = Callable[[str, str, object, object], bool]


def attribution(iters: int = 20, log=print, designs=DESIGNS,
                check: Optional[Check] = None) -> Dict[str, dict]:
    """Every probe at the flagship shapes, the template's in each of
    ``designs``. Returns site name -> entry for the kernels line (the
    first design's full variant's or the first variant's time as ``ms``, every
    variant under ``variants``, ``launches`` left for the caller to count
    from ``counters`` on a main path), with the plain versions' times.

    Every variant that has a plain version is compared with it on the same
    inputs: its normwise and max abs distances are recorded and, with
    ``check``, ``check(kind, mm_dtype, got, plain)`` says whether it agrees,
    recorded as ``agrees``. kind and what got and plain are: "train_step",
    the dicts of ``train_step``; "segment_train_forward" and
    "segment_backward", lists of each segment's output tuple; "bn_chain"
    and "wgrad", one tensor."""
    inp = flagship_inputs()
    segs, zin, gz, gldj = inp["segments"], inp["z"], inp["gz"], inp["gldj"]
    res: Dict[str, dict] = {}

    def entry(site, ms, plain_ms, bound, err, variants, **extra):
        s = next(s for s in SITES if s.name == site)
        res[site] = {"name": site, "route": "cuda",
                     "source": VARIANT_SOURCE if site.startswith("probe_attrib") else SOURCE,
                     "replaces": f"experiments/{s.file}:{s.line}", "launches": None,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "library_ms": None, "question": s.question,
                     "counterpart": s.counterpart, "counters": list(s.counters),
                     "variants": variants, **extra}

    def held(row, kind, dt, got, ref):
        """Record got's distances to the plain ref in row, and check's verdict."""
        row["normwise_vs_plain"], row["max_abs_vs_plain"] = _errors(got, ref)
        if check is not None:
            row["agrees"] = bool(check(kind, dt, got, ref))
        return row

    # -- the segment kernels' ablations: both segments of one train step ---
    for kind, ablations, fn, ref_fn, work in (
            ("segment_train_forward", FWD_ABLATIONS, segment_train_forward,
             ft.segment_train_forward_reference, "forward"),
            ("segment_backward", BWD_ABLATIONS, segment_backward,
             ft.segment_backward_reference, "backward")):
        variants = {}
        extra = (gz, gldj) if kind == "segment_backward" else ()
        for dt in DTYPES:
            for bt in BTS:
                def plain():
                    return [ref_fn(zin, *sg, bt, *extra, dt) for sg in segs]
                refs = plain()
                plain_ms = time_ms(plain, 3)
                for design in designs:
                    for abl in ablations:
                        def run():
                            return [fn(design, abl, zin, *sg, bt, *extra, dt) for sg in segs]
                        outs = run()
                        torch.cuda.synchronize()
                        row = {"ms": time_ms(run, iters), "plain_ms": plain_ms}
                        if abl == "full":   # only the full variant has a plain version
                            held(row, kind, dt, outs, refs)
                        variants[f"{design},{abl},{dt},bt={bt}"] = row
                        log(f"probe {kind} {design} {abl:>12} {dt} bt={bt}: {row['ms']:.4f} ms" +
                            (f", normwise vs plain {row['normwise_vs_plain']:.3e}"
                             if abl == "full" else ""))
        full = [v for k, v in variants.items() if ",full," in k]
        k0 = f"{designs[0]},full,float32,bt={BTS[0]}"
        entry("probe_attrib_forward" if work == "forward" else "probe_attrib_backward",
              variants[k0]["ms"], variants[k0]["plain_ms"], _bound(*_segment_work(segs, work)),
              max(v["max_abs_vs_plain"] for v in full), variants)

    # -- the ghost-BN moment reduction ------------------------------------
    variants = {}
    for dt in DTYPES:
        for bt in BTS:
            p_ms = time_ms(lambda: bn_chain_reference(zin, bt, N_BN, dt), 5)
            for v in BN_VARIANTS:
                if v in F32_ONLY_BN and fs.is_bf16(dt):
                    continue
                ref = bn_chain_reference(zin, 1 if v == "no_reduction" else bt, N_BN,
                                         "float32" if v in F32_ONLY_BN else dt)
                k = bn_chain(v, zin, bt, N_BN, dt)
                torch.cuda.synchronize()
                ms = time_ms(lambda: bn_chain(v, zin, bt, N_BN, dt, REPS), iters) / REPS
                row = held({"ms": ms, "plain_ms": p_ms}, "bn_chain", dt, k, ref)
                variants[f"{v},{dt},bt={bt}"] = row
                log(f"probe bn chain {v:>14} {dt} bt={bt}: {ms:.4f} ms, max abs vs plain "
                    f"{row['max_abs_vs_plain']:.3e}")
    k0 = f"production,float32,bt={BTS[0]}"
    entry("probe_bn_moments", variants[k0]["ms"], variants[k0]["plain_ms"],
          _bound(N_BN * 4 * B * 4096 * 2.0, 2 * 4.0 * B * 4096),
          max(v["max_abs_vs_plain"] for v in variants.values()), variants)

    # -- the weight-gradient contraction ----------------------------------
    variants = {}
    g = torch.Generator(device="cuda").manual_seed(5)
    a_in = torch.randn((B, 32, 32, 4), generator=g, device="cuda")
    g_in = torch.randn((B, 32, 32, 4), generator=g, device="cuda") / B
    library_ms = {}
    for ntaps in (9, 1):
        p = wgrad_reference(ntaps, a_in, g_in)
        p_ms = time_ms(lambda: wgrad_reference(ntaps, a_in, g_in), 5)
        # the library call: one float32 torch.matmul of the operands laid out
        lhs, rhs = wgrad_matmul_operands(ntaps, a_in, g_in)
        library_ms[ntaps] = time_ms(lambda: torch.matmul(lhs, rhs), iters)
        lib_err = _errors(torch.matmul(lhs, rhs).reshape(p.shape), p)
        log(f"probe wgrad library taps={ntaps}: {library_ms[ntaps]:.4f} ms (one torch.matmul), "
            f"normwise vs plain {lib_err[0]:.3e}")
        for v in WGRAD_VARIANTS:
            k = wgrad(v, ntaps, a_in, g_in)
            torch.cuda.synchronize()
            ms = time_ms(lambda: wgrad(v, ntaps, a_in, g_in, REPS), iters) / REPS
            row = held({"ms": ms, "plain_ms": p_ms, "library_ms": library_ms[ntaps]},
                       "wgrad", "bfloat16", k, p)
            variants[f"{v},taps={ntaps}"] = row
            log(f"probe wgrad {v:>5} taps={ntaps}: {ms:.4f} ms, normwise vs plain "
                f"{row['normwise_vs_plain']:.3e}")
    entry("probe_wgrad", variants["warp,taps=9"]["ms"], variants["warp,taps=9"]["plain_ms"],
          _bound(2.0 * B * 1024 * 144, 4.0 * (2 * B * 4096 + B * 144), True),
          max(v["max_abs_vs_plain"] for v in variants.values()), variants,
          library_ms=library_ms[9])

    # -- launch and floor probes with the step's parameter block ----------
    # (no plain version: plain_ms and max_abs_err are null; one_op_ms is the
    # least a PyTorch call costs, one small add_)
    x, clean, sa, sb, rec, offs, mixes, ops_code = inp["step"]
    sizes = (ctypes.c_longlong * 3)()
    _vlib(PARENT, "float32").nf_train_scratch(ft._STEP, B, BTS[0], rec.shape[0],
                                              mixes.shape[0], len(ops_code), sizes)
    scratch = torch.empty(sizes[0], dtype=torch.float32, device="cuda")
    n_tiles = sizes[0] // (B * 4096)
    args = (x, clean, sa, sb, rec, offs, mixes, ops_code, BTS[0], scratch)
    in_bytes = 4.0 * (2 * B * 4096 + 2 * B * sa.shape[1] + rec.numel() + offs.numel()
                      + mixes.numel())
    out_bytes = 4.0 * (B * 3 + 2 * B * sa.shape[1] + rec.numel() + mixes.numel()
                       + offs.numel() + rec.shape[0] * 16)
    tiny = torch.zeros(1, device="cuda")
    one_op_ms = time_ms(lambda: tiny.add_(0.0), iters)
    plans = {
        "probe_launch_coop": [("coop", 0, 0.0)],
        "probe_launch_plain": [("plain", 0, 0.0)],
        "probe_launch_operands": [("operands", 0, in_bytes + 4.0 * B * 4096)],
        "probe_launch_outputs": [("outputs", 0, out_bytes)],
        "probe_floor_noop": [("noop", 0, 0.0)],
        "probe_floor_bounds": [("bounds", 0, 0.0)],
        "probe_floor_syncs": [("syncs", n, 0.0) for n in SYNC_COUNTS],
        "probe_floor_body": [("residuals", n_tiles, 2 * 4.0 * n_tiles * B * 4096)],
    }
    for site, runs in plans.items():
        variants = {}
        for v, n, nbytes in runs:
            launch(v, n, *args)
            torch.cuda.synchronize()
            ms = time_ms(lambda: launch(v, n, *args, reps=REPS), iters) / REPS
            variants[f"{v},n={n}"] = {"ms": ms, "bound_ms": nbytes / PEAK_HBM_BYTES * 1e3}
            log(f"probe {v:>10} n={n}: {ms:.4f} ms")
        first = variants[next(iter(variants))]
        entry(site, first["ms"], None, (first["bound_ms"], "bytes"), None, variants,
              one_op_ms=one_op_ms)
    if len(SYNC_COUNTS) == 2:
        (n0, n1), v = SYNC_COUNTS, res["probe_floor_syncs"]["variants"]
        per = (v[f"syncs,n={n1}"]["ms"] - v[f"syncs,n={n0}"]["ms"]) / (n1 - n0)
        res["probe_floor_syncs"]["ms_per_sync"] = per
        log(f"probe grid.sync: {per * 1e3:.3f} us a barrier")

    # -- the full body: the one-shot step in each design ------------------
    body = res["probe_floor_body"]["variants"]
    for dt in DTYPES:
        for bt in BTS:
            ref = ft.train_step_reference(x, clean, sa, sb, rec, offs, mixes, ops_code, bt, dt)
            for design in designs:
                got = train_step(design, x, clean, sa, sb, rec, offs, mixes, ops_code, bt, dt)
                torch.cuda.synchronize()
                ms = time_ms(lambda: train_step(design, x, clean, sa, sb, rec, offs, mixes,
                                                ops_code, bt, dt), iters)
                row = held({"ms": ms}, "train_step", dt, got, ref)
                body[f"step {design},{dt},bt={bt}"] = row
                log(f"probe step {design:>8} {dt} bt={bt}: {ms:.4f} ms; normwise vs plain "
                    f"{row['normwise_vs_plain']:.2e}")
    return res


def eval_segments(flow, mm_dtype):
    """Both flagship segments as ``FusedFlow.inverse(train=False)`` hands
    them to the eval kernel: (rec, offs, mixes, ops_code, bnrun), the records
    with BN folded in and bnrun None in float32, unfolded with the running
    moments in bfloat16."""
    ff = ft.FusedFlow(flow, mm_dtype=mm_dtype)
    bf16 = fs.is_bf16(mm_dtype)
    out = []
    with torch.no_grad():
        for _, seg, lo, hi in (it for it in ff.plan if it[0] == "segment"):
            rec, offs, mixes, _ = ff.fold_segment(lo, hi, fold_bn=not bf16)
            out.append((rec, offs, mixes, ft._ops_code(seg.ops),
                        ff.running_moments(lo, hi) if bf16 else None))
    return out


EvalCheck = Callable[[str, tuple, tuple], bool]


def _max_rel(k, p) -> float:
    return float(((k - p).abs() / p.abs().clamp_min(1e-30)).max())


def eval_chain(segs, fn, z, mm_dtype):
    """One eval call of the running-statistics forward: ``fn`` (the wrapper,
    the parent's, a fault's or the plain version) on each of ``segs`` (as
    ``eval_segments`` gives them) in turn, the first's z into the second:
    (z, summed ldj)."""
    ldj = 0.0
    for sg in segs:
        z, lj = fn(z, *sg[:4], mm_dtype, sg[4])
        ldj = ldj + lj
    return z, ldj


def eval_times(batches=EVAL_BATCHES, rounds: int = 5, log=print,
               check: Optional[EvalCheck] = None) -> Dict[str, dict]:
    """The running-statistics eval forward of both flagship segments (one
    eval call of ``Trainer(use_pallas=True)``: the first segment's z into
    the second) at each batch and precision, the parent's design and the
    redesign timed in turns (``alternated_ms``, device times), with the
    CTAs an SM of each and the redesign's outputs against the parent's (z
    and ldj bit for bit, else the largest distance) and the plain version's
    (z max abs and normwise, ldj relative), with ``check(precision, (z,
    ldj), plain (z, ldj))``'s verdict, and the redesign's launches in one
    call. Returns "{precision},b={b}" -> row."""
    flow = flagship_flow()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for dt in DTYPES:
        segs = eval_segments(flow, dt)
        per_sm = {PARENT: segment_parent_occupancy(dt), PROD: ft.segment_occupancy("cuda", dt)}
        for b in batches:
            z = torch.randn((b, 32, 32, 4), generator=torch.Generator(device="cuda").manual_seed(b),
                            device="cuda")
            fns = {PARENT: functools.partial(eval_chain, segs, segment_forward_parent, z, dt),
                   PROD: functools.partial(eval_chain, segs, ft.fused_segment_forward, z, dt)}
            ms = alternated_ms(fns, rounds, 20 if b <= 512 else 5)
            zp, lp = fns[PARENT]()
            before = fs.launch_counts["fused_segment_forward"]
            zk, lk = fns[PROD]()
            launches = fs.launch_counts["fused_segment_forward"] - before
            zr, lr = eval_chain(segs, ft.segment_forward_reference, z, dt)
            torch.cuda.synchronize()
            row = {"ms": ms[PROD], "parent_ms": ms[PARENT], "parent_over_redesign":
                   ms[PARENT] / ms[PROD], "per_sm": per_sm, "sms": sms,
                   "waves": {k: -(-b // (n * sms)) for k, n in per_sm.items()},
                   "z_bits_as_parent": bool(torch.equal(zk, zp)),
                   "ldj_bits_as_parent": bool(torch.equal(lk, lp)),
                   "z_max_abs_vs_parent": float((zk - zp).abs().max()),
                   "ldj_max_rel_vs_parent": _max_rel(lk, lp),
                   "z_max_abs_vs_plain": float((zk - zr).abs().max()),
                   "z_normwise_vs_plain": float((zk - zr).norm() / zr.norm()),
                   "ldj_max_rel_vs_plain": _max_rel(lk, lr),
                   "launches_a_call": launches, "segments": len(segs)}
            if check is not None:
                row["agrees_with_plain"] = bool(check(dt, (zk, lk), (zr, lr)))
            out[f"{dt},b={b}"] = row
            log(f"eval forward {dt} b={b}: redesign {row['ms']:.4f} ms ({launches} launches), "
                f"parent {row['parent_ms']:.4f} ms ({row['parent_over_redesign']:.3f}x); CTAs an "
                f"SM {per_sm}, waves {row['waves']}; z as parent {row['z_bits_as_parent']}, ldj "
                f"as parent {row['ldj_bits_as_parent']}; vs plain z "
                f"{row['z_max_abs_vs_plain']:.2e} abs {row['z_normwise_vs_plain']:.2e} normwise, "
                f"ldj {row['ldj_max_rel_vs_plain']:.2e} rel"
                + (f", {'agrees' if row['agrees_with_plain'] else 'DISAGREES'}"
                   if check is not None else ""))
    return out


def frame_times(rounds: int = 3, iters: int = 5, log=print) -> Dict[str, dict]:
    """The fused sampler's batch-BN chain at a 1500x2000 frame (b = 2961)
    and at b = 4096, with the whole batch as one BN group (the wrapper's bt =
    b) and in bn_block groups, timed in turns (``alternated_ms``): kernel
    ms, and the kernel against its plain version (max abs)."""
    from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper

    nf = NoiseFlowWrapper(str(MODEL), device="cuda")
    prog = nf._program
    out = {}
    for b in (2961, 4096):
        g = torch.Generator(device="cuda").manual_seed(b)
        clean = (0.01 + 0.89 * torch.rand((b, 32, 32, 4), generator=g, device="cuda")).contiguous()
        cond = {"clean": clean, "iso": torch.full((b,), 800.0, device="cuda"),
                "cam": torch.full((b,), 2.0, device="cuda"),
                "nlf0": torch.zeros(b, device="cuda"), "nlf1": torch.zeros(b, device="cuda")}
        sa, sb = prog.scale_ab(cond, b)
        x = (0.6 * torch.randn((b, 32, 32, 4), generator=g, device="cuda")).contiguous()
        bts = (b, fs.bn_block(b))
        ms = alternated_ms({bt: functools.partial(fs.fused_sample_chain, prog, x, clean, sa, sb,
                                                  bt) for bt in bts}, rounds, iters)
        for bt in bts:
            k = fs.fused_sample_chain(prog, x, clean, sa, sb, bt)
            p = fs.sample_chain_reference(prog, x, clean, sa, sb, bt)
            e = float((k - p).abs().max())
            out[f"b={b},bt={bt}"] = {"ms": ms[bt], "max_abs_vs_plain": e}
            log(f"sampler batch BN b={b} bt={bt}: kernel {ms[bt]:.4f} ms (median of {rounds}, "
                f"in turns), max abs vs plain {e:.3e}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", help="write the table as JSON here")
    p.add_argument("--frame", action="store_true", help="also time the sampler's frame at bt = b")
    p.add_argument("--eval", action="store_true",
                   help="time the eval forward's redesign against its parent only")
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--designs", default=",".join(DESIGNS),
                   help="the template's designs to probe (parent, redesign)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("train_template: needs a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from noise_flow_tpu_torch.ops import _build
    _build.build_all(["fused_train", "segment_probe"] if args.eval else
                     ["fused_sample", "fused_train", "train_probe", "segment_probe",
                      *_build.VARIANT_LIBRARIES])
    for name in _build.build_logs:
        for k in _build.kernel_resources(name):
            print(f"ptxas[{name}] {k['kernel']}: {k.get('registers')} registers, spill "
                  f"{k['spill_stores']} B stores / {k['spill_loads']} B loads")
    table = {"device": smi, "eval": eval_times()}
    if not args.eval:
        table["probes"] = attribution(args.iters, designs=tuple(args.designs.split(",")))
    if args.frame:
        table["frame"] = frame_times()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(table, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
