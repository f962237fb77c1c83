"""Attribution probes of the fused sampler on the card.

The Hopper counterparts of the three TPU diagnostics in ``experiments/`` that
probed the sampling kernel (``SITES``: their ``pl.pallas_call`` lines, each
with the question it asked):

- ``kernel_probe.py`` (where the time goes): the sampler's template
  ``sample_kernel<BF, ABL, DESIGN, PPT>`` (``csrc/sample_kernel.cuh``) with
  an ablation (``ABLATIONS``: tanh and exp made polynomial, every 3x3 tap
  reading the centre pixel, couplings skipped), two patches a CTA
  (interleave), or 2 and 8 pixels a thread (the TPU's block size);
- ``kernel_sweep.py`` (fold variants): concat-K as im2col in registers, two
  interleaved patches, bfloat16 weights rounded once into shared memory,
  and their combinations (``DESIGN_BITS``);
- ``mxu_bound_probe.py`` (products or latency?): a chain of 56 dependent
  [2048, 128] x [128, 128] products a CTA in float32 FMAs and in bfloat16
  ``mma.sync`` (``csrc/sample_probe.cu``), the same chain at the sampler's
  4 channels, and the dense rate factor k and sampler ratio R that read it.

The sampler's production design (batch BN in one cooperative launch with
merged moments, ``coop_kernel``; bfloat16 weights rounded once) is not
among them: the template's "full" variant is the parent's design (batch BN
stage by stage, 40 launches a call), kept to attribute and to time
against.

Every variant runs at two shapes of the flagship ``experiments/sidd/
prod_exact_150``: (R) running BN with in-kernel RNG at b = 8192, the TPU
probes' own shape and ``make_sampler``'s; (W) batch BN on a given eps at b
= bt = 138, the wrapper's request (40 launches a call in the parent's
design).

On the card, from the root of a checkout::

    python -m noise_flow_tpu_torch.probes.sampler [--out FILE]

prints one line per variant and, with ``--out``, writes the table as JSON.

Each wrapper takes CUDA tensors and launches its kernel; on CPU tensors it
runs the variant's plain version. Every variant has one: the ablations
compute a function of their own, and the designs compute the sampler's.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import os
import subprocess
import sys
from typing import Callable, Dict, Optional

import torch

from noise_flow_tpu_torch.ops import fused_sample as fs
from noise_flow_tpu_torch.ops.nn import conv2d_nhwc
from noise_flow_tpu_torch.probes import train_template as tt
from noise_flow_tpu_torch.probes.train_template import Site

VARIANT_SOURCE = "noise_flow_tpu_torch/csrc/sample_variants.cuh"
CHAIN_SOURCE = "noise_flow_tpu_torch/csrc/sample_probe.cu"
DTYPES = ("float32", "bfloat16")
R_B, W_B = 8192, 138           # (R): running BN, RNG; (W): batch BN, eps, bt = b
TEMP, SEED = 0.6, 0
# the ablations (sample_kernel.cuh, enum Ablation) and design bits (DESIGN_*)
ABLATIONS = {"full": 0, "notrans": 1, "noshift": 2, "nocoupnn": 3}
DESIGN_BITS = {"interleave": 1, "concat_k": 2, "precast": 4}
NOTRANS_SLOPE = 0.9            # kernel_probe.py:49-50: tanh u -> 0.9 u
# name -> (ablation, design bits, pixels a thread): every variant the
# probe library instantiates (sample_variants.cuh)
VARIANTS = {
    "full": ("full", (), 4),
    "ppt2": ("full", (), 2),
    "ppt8": ("full", (), 8),
    "notrans": ("notrans", (), 4),
    "noshift": ("noshift", (), 4),
    "nocoupnn": ("nocoupnn", (), 4),
    "interleave": ("full", ("interleave",), 4),
    "concat_k": ("full", ("concat_k",), 4),
    "concat_k_interleave": ("full", ("concat_k", "interleave"), 4),
    "precast": ("full", ("precast",), 4),
    "concat_k_interleave_precast": ("full", ("concat_k", "interleave", "precast"), 4),
}
BF16_ONLY = ("precast", "concat_k_interleave_precast")   # a no-op in float32
# kernel_probe.py's variants (:166) and block sizes (:167) at both shapes;
# the pixels a thread only in running BN, where they give FULL's bits
ABLATION_RUNS = {"R": ("full", "notrans", "noshift", "nocoupnn", "interleave", "ppt2", "ppt8"),
                 "W": ("full", "notrans", "noshift", "nocoupnn", "interleave")}
# kernel_sweep.py's variants (:257-264) at (R): v2-streams2 is interleave
FOLD_RUNS = ("full", "concat_k", "interleave", "concat_k_interleave", "precast",
             "concat_k_interleave_precast")
# variants whose arithmetic is FULL's, bit for bit, in running BN (and,
# but for the pixels a thread, in batch BN); concat-K's sums run in
# another order and are bit-equal to plain concat-K
SAME_BITS = {"interleave": "full", "precast": "full", "ppt2": "full", "ppt8": "full",
             "concat_k_interleave": "concat_k", "concat_k_interleave_precast": "concat_k"}
N_MM, CHAIN_K = 56, 128       # mxu_bound_probe.py:62-63: 56 [bt * 32, 128] x [128, 128]
PX_VARIANTS = {"f32": 0, "bf16_fma": 1, "bf16_mma": 2}
DENSE_N = 4096
# device times: medians of ROUNDS rounds of tt.alternated_ms in turns, each
# round the mean of ITERS calls (CHAIN_ITERS for the literal chain, 5-15 ms
# a call)
ROUNDS, ITERS, CHAIN_ITERS = 5, 5, 3
# Tolerances of the variants against their plain versions on the same
# inputs, where TOL (float32) and BF16_SAMPLE_RTOL (bfloat16) of the
# production sampler do not hold (observed on an H100 80GB HBM3 at 700 W
# with chip_smoke.py, b = 512 running and 138 batch). notrans's update
# (x - t) * (1 - 0.9 rescale t) does not saturate as tanh does, so where its
# factor nears zero a float32 rounding of t moves an output by many ulps
# (1.1e-4 abs where values reach 131; normwise 5.0e-7 in float32, 2.3e-4 in
# bfloat16): it is held normwise. The product chains, normwise: the literal
# chain equals the plain one in float32 (0). In bfloat16 two chains that
# round the same products, with their float32 sums in another order,
# diverge as they go: a rounding flipped by the order moves the next
# product's inputs, which flips more, until the distance nears that of a
# chain that does not round its intermediates at all (the kernel against
# the plain chain at 262,144 rows: 4.7e-4 after 8 products, 5.3e-3 after
# 56; no re-rounding: 4.4e-3 and 1.35e-2). So the bfloat16 chain is held
# over its first CHAIN_PREFIX products at CHAIN_PREFIX_RTOL, which a chain
# without re-rounding fails, and over all 56 at CHAIN_RTOL, which a chain
# with a product skipped (1.42) fails. At the sampler's 4 channels 0
# (FMAs) and 9.8e-5 (mma.sync).
NOTRANS_RTOL = {"float32": 5e-6, "bfloat16": 2e-3}
CHAIN_PREFIX = 8
CHAIN_PREFIX_RTOL = {"float32": 1e-5, "bfloat16": 1.5e-3}
CHAIN_RTOL = {"float32": 1e-5, "bfloat16": 2e-2}
PX_CHAIN_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}

SITES = (
    Site("probe_sampler_ablations", "kernel_probe.py", 129, "make_kernel",
         "where the sampler's time goes",
         "sample_kernel<BF, ABL, DESIGN, PPT>: full, notrans (tanh/exp polynomial), noshift "
         "(every tap the centre pixel), nocoupnn (mixes and scales only), interleave (two "
         "patches a CTA), 2/4/8 pixels a thread (the TPU's bt); (R) and (W), f32 and bf16",
         ("sample_probe_ablation",)),
    Site("probe_sampler_folds", "kernel_sweep.py", 171, "make_variant_kernel",
         "which fold of the coupling runs fastest",
         "concat-K as im2col in registers ([18, 4] and [45, 4] dots), two interleaved "
         "patches, bf16 weights rounded once into shared memory, their combinations; the "
         "production kernel through make_sampler as v2 shipped; (R), bf16 first",
         ("sample_probe_fold",)),
    Site("probe_mm_chain", "mxu_bound_probe.py", 85, "pallas_mm_chain_rate",
         "is the sampler bound by its products or by its latency",
         "56 dependent [2048, 128] x [128, 128] products a CTA: f32 CUDA-core FMAs against "
         "bf16 mma.sync; the same chain at the sampler's 4 channels (f32 FMA, bf16 FMA, bf16 "
         "mma.sync); torch.matmul at 4096^2 for k; the production sampler f32/bf16 for R",
         ("sample_probe_mm_chain",)),
)


def pallas_call_lines(root=tt.ROOT):
    """Whether each site's line in experiments/ holds a ``pl.pallas_call``
    (read as text; nothing of JAX is imported)."""
    return tt.pallas_call_lines(root, SITES)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _check_variant(variant: str, mm_dtype) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown sampler variant {variant!r}: one of {tuple(VARIANTS)}")
    if variant in BF16_ONLY and not fs.is_bf16(mm_dtype):
        raise ValueError(f"{variant} is a bfloat16 variant (a no-op in float32)")


@torch.no_grad()
def ablated_chain_reference(program, x, clean, sa, sb, bt: Optional[int] = None,
                            mm_dtype="float32", ablation: str = "full",
                            slope: float = NOTRANS_SLOPE):
    """``fs.sample_chain_reference`` with an ablation (``ABLATIONS``):
    "notrans" takes tanh u -> slope u and exp u -> 1 + u in the coupling
    update (``kernel_probe.py:49-53``); "noshift" makes every 3x3 tap of
    conv1 and of the zero-conv read the centre pixel, with no indicator taps
    (``:45-48``, the shift dropped in both directions); "nocoupnn" skips the
    couplings (``:82-83``)."""
    if ablation == "full":
        return fs.sample_chain_reference(program, x, clean, sa, sb, bt, mm_dtype)
    if ablation not in ABLATIONS:
        raise ValueError(f"unknown ablation {ablation!r}: one of {tuple(ABLATIONS)}")
    batch_bn = program.bn_mode == "batch"
    bt = bt or x.shape[0]
    rnd = fs.bf16_round if fs.is_bf16(mm_dtype) else (lambda t: t)
    field = fs._field
    for kind, idx in program.ops:
        if kind == fs.OP_MIX:
            x = rnd(x) @ rnd(program.mixes[idx])
        elif kind == fs.OP_SCALE:
            a = sa[:, idx].reshape(-1, 1, 1, 1)
            b = sb[:, idx].reshape(-1, 1, 1, 1)
            x = x * torch.sqrt(a * clean + b)
        elif ablation != "nocoupnn":
            rec = program.coup[idx]
            w1, w3 = rnd(field(rec, "w1")), rnd(field(rec, "w3"))
            if ablation == "noshift":
                h = field(rec, "b1") + sum(rnd(x[..., :2]) @ w1[i, j]
                                           for i in range(3) for j in range(3))
            else:
                h = conv2d_nhwc(rnd(x[..., :2]), w1) + field(rec, "b1")
            h = torch.relu(fs._group_bn(h, bt) if batch_bn else h)
            h = rnd(h) @ rnd(field(rec, "w2")) + field(rec, "b2")
            h = torch.relu(fs._group_bn(h, bt) if batch_bn else h)
            if ablation == "noshift":
                t = field(rec, "bz") + sum(rnd(h) @ w3[i, j] for i in range(3) for j in range(3))
            else:
                t = fs._zero_conv(h, rec, rnd)
            if ablation == "notrans":
                ls = field(rec, "rescale") * (t[..., 2:] * slope)
                upd = (x[..., 2:] - t[..., :2]) * (1.0 - ls)
            else:
                ls = field(rec, "rescale") * torch.tanh(t[..., 2:])
                upd = (x[..., 2:] - t[..., :2]) * torch.exp(-ls)
            x = torch.cat([x[..., :2], upd], -1)
    return x


def variant_reference(program, variant: str, x, clean, sa, sb, bt: Optional[int] = None,
                      mm_dtype="float32"):
    """The plain version of a variant (``VARIANTS``): its ablation's chain;
    the designs compute the sampler's function, ``fs.sample_chain_reference``."""
    _check_variant(variant, mm_dtype)
    return ablated_chain_reference(program, x, clean, sa, sb, bt, mm_dtype, VARIANTS[variant][0])


def _round(x, bf: bool):
    return fs.bf16_round(x) if bf else x


@torch.no_grad()
def mm_chain_reference(x, w, mm_dtype="float32"):
    """The chain x @ w[0] @ w[1] ... of ``mxu_bound_probe.py:76-81``: each
    product takes both operands as ``mm_dtype`` (rounded to bfloat16, exact
    products) and sums in float32; x [..., K], w [n, K, K]. Float32 products
    run with TF32 off (the caller's setting on the card)."""
    bf = fs.is_bf16(mm_dtype)
    for m in range(w.shape[0]):
        x = _round(x, bf) @ _round(w[m], bf)
    return x


@torch.no_grad()
def chain_without_rerounding(x, w):
    """A wrong bfloat16 chain, for planted faults: ``mm_chain_reference``
    with x rounded once, before the first product, and the products' float32
    results never rounded again (not ``x.astype(dt)`` at every step)."""
    x = fs.bf16_round(x)
    for m in range(w.shape[0]):
        x = x @ fs.bf16_round(w[m])
    return x


def chain_inputs(generator):
    """The literal chain's checked inputs at its timed shape (b = R_B
    patches of 32 rows): x [R_B * 32, 128] ~ N(0, 1) and w [N_MM, 128, 128]
    ~ N(0, 1/128), so the chain neither vanishes nor explodes; on the
    generator's device."""
    dev = generator.device
    x = torch.randn((R_B * 32, CHAIN_K), generator=generator, device=dev)
    w = torch.randn((N_MM, CHAIN_K, CHAIN_K), generator=generator, device=dev) / CHAIN_K ** 0.5
    return x, w


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def sample_variant(program, variant: str, x, clean, sa, sb, bt: Optional[int] = None,
                   mm_dtype="float32", seed=None, temp: float = 1.0):
    """``fs.fused_sample_chain`` (x = eps * temp) or, with ``seed`` (x None),
    ``fs.fused_sample_chain_rng`` as a variant of ``VARIANTS``. CUDA tensors
    launch the probe library's kernel; CPU tensors run the variant's plain
    version (on ``rng_normals_reference(seed) * temp`` with a seed)."""
    _check_variant(variant, mm_dtype)
    b = clean.shape[0]
    bt = fs._default_bt(program, b, bt)
    if fs._device_kind(clean) == "cpu":
        if seed is not None:
            x = fs.rng_normals_reference(seed, b) * temp
        return variant_reference(program, variant, x, clean, sa, sb, bt, mm_dtype)
    from noise_flow_tpu_torch.ops._build import load_library

    abl, designs, ppt = VARIANTS[variant]
    design = sum(DESIGN_BITS[d] for d in designs)
    ns = sa.shape[1]
    if seed is None:
        fs._check("x", x, (b, fs.H, fs.W, fs.C))
    for name, t, shape in (("clean", clean, (b, fs.H, fs.W, fs.C)), ("sa", sa, (b, ns)),
                           ("sb", sb, (b, ns)), ("mixes", program.mixes, program.mixes.shape),
                           ("coup", program.coup, program.coup.shape)):
        fs._check(name, t, shape)
    lib = load_library("sample_variants_" + ("bf16" if fs.is_bf16(mm_dtype) else "f32"))
    out = torch.empty_like(clean)
    part = torch.empty((2, b, 4), dtype=torch.float32, device=clean.device)
    mom = torch.empty((-(-b // bt), 12), dtype=torch.float32, device=clean.device)
    ops = (ctypes.c_int * len(program.ops_code))(*program.ops_code)
    folds = DESIGN_BITS["concat_k"] | DESIGN_BITS["precast"]   # kernel_sweep.py's designs
    counter = "sample_probe_fold" if design & folds else "sample_probe_ablation"
    tt._launch(counter, lib.nf_sample_variant, clean.device, ABLATIONS[abl], design, ppt,
             x.data_ptr() if seed is None else None, out.data_ptr(), clean.data_ptr(),
             sa.data_ptr(), sb.data_ptr(), program.mixes.data_ptr(), program.coup.data_ptr(),
             part.data_ptr(), mom.data_ptr(), b, ns, bt, int(program.bn_mode == "batch"), ops,
             len(program.ops_code), int(seed is not None),
             0 if seed is None else fs.rng_seed(seed), float(temp))
    return out


def _chain_check(name, x, w, k):
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"{name} takes float32 tensors")
    if x.shape[-1] != k or tuple(w.shape[1:]) != (k, k) or w.shape[0] < 1:
        raise ValueError(f"{name}: x [..., {k}] and w [n >= 1, {k}, {k}], got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.device != w.device or not x.is_contiguous() or not w.is_contiguous():
        raise ValueError(f"{name}: contiguous inputs on one device")


def mm_chain(x, w, mm_dtype="float32"):
    """``mm_chain_reference`` at the literal shape, x [rows, 128] (rows a
    multiple of 128; a CTA takes 2048 rows), w [n, 128, 128]: float32 FMAs
    or bfloat16 ``mma.sync`` on the card."""
    _chain_check("mm_chain", x, w, CHAIN_K)
    if fs._device_kind(x) == "cpu":
        return mm_chain_reference(x, w, mm_dtype)
    rows = x.numel() // CHAIN_K
    if rows % 128:
        raise ValueError(f"mm_chain takes a multiple of 128 rows, got {rows}")
    from noise_flow_tpu_torch.ops._build import load_library

    out = torch.empty_like(x)
    tt._launch("sample_probe_mm_chain", load_library("sample_probe").nf_mm_chain, x.device,
             int(fs.is_bf16(mm_dtype)), x.data_ptr(), w.data_ptr(), out.data_ptr(), rows,
             w.shape[0])
    return out


def px_chain(variant: str, x, w):
    """``mm_chain_reference`` at the sampler's shape, x [B, 32, 32, 4] (one
    patch a CTA), w [n, 4, 4], by ``PX_VARIANTS``: "f32" (float32 FMAs),
    "bf16_fma" (FMAs on rounded operands), "bf16_mma" (``mma.sync``, K
    padded to 16)."""
    if variant not in PX_VARIANTS:
        raise ValueError(f"unknown chain variant {variant!r}: one of {tuple(PX_VARIANTS)}")
    _chain_check("px_chain", x, w, 4)
    dt = "float32" if variant == "f32" else "bfloat16"
    if fs._device_kind(x) == "cpu":
        return mm_chain_reference(x, w, dt)
    from noise_flow_tpu_torch.ops._build import load_library

    if tuple(x.shape[1:]) != (fs.H, fs.W, fs.C):
        raise ValueError(f"px_chain takes x [B, 32, 32, 4], got {tuple(x.shape)}")
    out = torch.empty_like(x)
    tt._launch("sample_probe_mm_chain", load_library("sample_probe").nf_px_chain, x.device,
             PX_VARIANTS[variant], x.data_ptr(), w.data_ptr(), out.data_ptr(), x.shape[0],
             w.shape[0])
    return out


# ---------------------------------------------------------------------------
# the attribution at the flagship shapes
# ---------------------------------------------------------------------------

def chain_work(program, b: int, rng: bool = False, couplings: bool = True):
    """(FLOPs, bytes) the sampling chain needs for b patches: multiply-adds
    of the convolutions (with ``couplings``) and mixes at 2 FLOPs each; eps
    (not in the RNG mode) and clean read once, the noise written once, sa/sb
    and the weights read once. The RNG mode's Philox and Box-Muller are left
    out: both modes are bound by the chain's FMAs alone, by one rule."""
    n_c = sum(1 for k, _ in program.ops if k == fs.OP_COUPLING)
    n_mix = sum(1 for k, _ in program.ops if k == fs.OP_MIX)
    mac_per_px = (n_c * (9 * 2 * 4 + 4 * 4 + 9 * 4 * 4) if couplings else 0) + n_mix * 16
    flops = 2.0 * mac_per_px * fs.H * fs.W * b
    nbytes = 4.0 * ((2 if rng else 3) * b * fs.H * fs.W * fs.C + 2 * b * max(program.n_scale, 1)
                    + program.coup.numel() + program.mixes.numel())
    return flops, nbytes


def flagship_flow(device="cuda"):
    """The flagship flow ``experiments/sidd/prod_exact_150``."""
    from noise_flow_tpu_torch.config import load_hps
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    flow = NoiseFlow((32, 32, 4), load_hps(str(tt.MODEL / "hps.txt")), device=device)
    load_checkpoint(str(tt.MODEL / "ckpt" / "model.ckpt-best.npz"), flow)
    return flow


def flagship_programs(device="cuda", flow=None):
    """The flagship flow's sampling programs, running and batch BN."""
    flow = flow if flow is not None else flagship_flow(device)
    return {m: fs.build_sample_program(flow, bn_mode=m) for m in ("running", "batch")}


def shape_inputs(programs, shape: str, device="cuda"):
    """The inputs of a shape: (R) the TPU probes' conditioning
    (``kernel_probe.py:153-159``: clean uniform(0.01, 0.9), nlf0 4.79e-4,
    nlf1 2e-6, iso 100, cam 2) at b = 8192, running BN, drawn in the kernel
    from SEED; (W) clean and (iso, cam) on the ISO grid at b = bt = 138,
    batch BN, a seeded eps * TEMP."""
    b = R_B if shape == "R" else W_B
    prog = programs["running" if shape == "R" else "batch"]
    g = torch.Generator(device=device).manual_seed(b)
    clean = (0.01 + 0.89 * torch.rand((b, 32, 32, 4), generator=g, device=device)).contiguous()
    if shape == "R":
        cond = {"clean": clean, "nlf0": torch.full((b,), 0.000479, device=device),
                "nlf1": torch.full((b,), 2e-6, device=device),
                "iso": torch.full((b,), 100.0, device=device),
                "cam": torch.full((b,), 2.0, device=device)}
    else:
        grid = ((100.0, 0.0), (400.0, 1.0), (800.0, 2.0), (1600.0, 3.0), (3200.0, 4.0))
        cond = {"clean": clean,
                "iso": torch.tensor([grid[i % 5][0] for i in range(b)], device=device),
                "cam": torch.tensor([grid[(i // 5) % 5][1] for i in range(b)], device=device),
                "nlf0": torch.zeros(b, device=device), "nlf1": torch.zeros(b, device=device)}
    sa, sb = prog.scale_ab(cond, b)
    x = None
    if shape == "W":
        x = (torch.randn((b, 32, 32, 4), generator=g, device=device) * TEMP).contiguous()
    return {"program": prog, "b": b, "bt": b, "x": x, "clean": clean, "sa": sa, "sb": sb,
            "seed": SEED if shape == "R" else None, "cond": cond}


def run_variant(inp, variant: str, mm_dtype, kernel: bool = True):
    """A variant on a shape's inputs: the probe kernel, or its plain version
    (``kernel=False``; on ``rng_normals_reference(SEED) * TEMP`` at (R))."""
    prog, x, seed = inp["program"], inp["x"], inp["seed"]
    if kernel:
        return sample_variant(prog, variant, x, inp["clean"], inp["sa"], inp["sb"], inp["bt"],
                              mm_dtype, seed=seed, temp=TEMP)
    if seed is not None:
        x = fs.rng_normals_reference(seed, inp["b"], device=inp["clean"].device) * TEMP
    return variant_reference(prog, variant, x, inp["clean"], inp["sa"], inp["sb"], inp["bt"],
                             mm_dtype)


def run_production(inp, mm_dtype):
    """The production sampler (``fused_sample.cu``) on a shape's inputs: at
    (R) the call ``make_sampler``'s closure makes."""
    if inp["seed"] is not None:
        return fs.fused_sample_chain_rng(inp["program"], inp["seed"], TEMP, inp["clean"],
                                         inp["sa"], inp["sb"], inp["bt"], mm_dtype)
    return fs.fused_sample_chain(inp["program"], inp["x"], inp["clean"], inp["sa"], inp["sb"],
                                 inp["bt"], mm_dtype)


def _variant_bound(inp, variant, dt):
    flops, nbytes = chain_work(inp["program"], inp["b"], rng=inp["seed"] is not None,
                               couplings=variant != "nocoupnn")
    return tt._bound(flops, nbytes, fs.is_bf16(dt))


Check = Callable[[str, str, object, object], bool]


def attribution(check: Optional[Check] = None) -> Dict[str, dict]:
    """Every variant of the three sites at the flagship shapes, in both
    precisions. Returns site name -> entry for the kernels line (``ms`` the
    headline variant's: FULL at (R) in bf16, concat-K at (R) in bf16, the
    literal chain in bf16; every variant under ``variants``; ``launches``
    left for the caller to count from ``counters`` on a main path); the
    chain's entry also carries ``calibration``: k, R, the matmul share and
    the rates.

    Times are device times: medians of ``ROUNDS`` rounds of
    ``tt.alternated_ms`` over the variants of one shape and precision, taken
    in turns. Each variant is held against its plain version on the same
    inputs: the normwise and max abs distances are recorded and, with
    ``check``, ``check(kind, mm_dtype, got, plain)`` says whether it agrees
    (kind "sample" for a chain of the sampler, "sample_notrans" for the
    notrans ablation's, "mm_chain" and "px_chain" for the product chains),
    recorded as ``agrees``; the literal chain is held over its first
    ``CHAIN_PREFIX`` products too (kind "mm_chain_prefix"). Variants of FULL's (or concat-K's) arithmetic
    record ``bit_equal`` to that kernel's output. FULL (the parent's design)
    records ``bit_equal_to_production`` in running BN, where production has
    its arithmetic, and in batch BN, where production merges its moments in
    another order, ``normwise_vs_production``."""
    programs = flagship_programs()
    res: Dict[str, dict] = {}

    def entry(site, ms, plain_ms, bound, err, variants, library_ms=None, **extra):
        s = next(s for s in SITES if s.name == site)
        res[site] = {"name": site, "route": "cuda",
                     "source": CHAIN_SOURCE if site == "probe_mm_chain" else VARIANT_SOURCE,
                     "replaces": f"experiments/{s.file}:{s.line}", "launches": None,
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
                     "bound_by": bound[1], "library_ms": library_ms, "question": s.question,
                     "counterpart": s.counterpart, "counters": list(s.counters),
                     "variants": variants, **extra}

    def held(row, kind, dt, got, ref):
        row["normwise_vs_plain"], row["max_abs_vs_plain"] = tt._errors(got, ref)
        if check is not None:
            row["agrees"] = bool(check(kind, dt, got, ref))
        return row

    # -- sites 1 and 2: the sampler's template ----------------------------
    rows: Dict[str, dict] = {}
    for shape in ("R", "W"):
        inp = shape_inputs(programs, shape)
        for dt in DTYPES:
            names = list(dict.fromkeys(ABLATION_RUNS[shape] + (FOLD_RUNS if shape == "R" else ())))
            names = [n for n in names if fs.is_bf16(dt) or n not in BF16_ONLY]
            outs = {n: run_variant(inp, n, dt) for n in names}
            plains = {VARIANTS[n][0]: run_variant(inp, n, dt, kernel=False) for n in names}
            prod = run_production(inp, dt)
            torch.cuda.synchronize()
            plain_ms = tt.time_ms(lambda: run_variant(inp, "full", dt, kernel=False), 2)
            ms = tt.alternated_ms({n: functools.partial(run_variant, inp, n, dt) for n in names},
                                  ROUNDS, ITERS)
            for n in names:
                before = sum(fs.launch_counts.values())
                run_variant(inp, n, dt)
                bound = _variant_bound(inp, n, dt)
                row = held({"ms": ms[n], "plain_ms": plain_ms, "bound_ms": bound[0],
                            "bound_by": bound[1],
                            "launches_a_call": sum(fs.launch_counts.values()) - before},
                           "sample_notrans" if n == "notrans" else "sample", dt, outs[n],
                           plains[VARIANTS[n][0]])
                if n in SAME_BITS and (shape == "R" or n not in ("ppt2", "ppt8")):
                    row["bit_equal"] = bool(torch.equal(outs[n], outs[SAME_BITS[n]]))
                if n == "full" and shape == "R":
                    row["bit_equal_to_production"] = bool(torch.equal(outs[n], prod))
                elif n == "full":
                    row["normwise_vs_production"] = tt._errors(outs[n], prod)[0]
                rows[f"{n},{dt},{shape}"] = row
                print(f"probe sampler {n:>27} {dt} ({shape}): {row['ms']:.4f} ms "
                      f"({row['launches_a_call']} launches), {row['ms'] / ms['full']:.3f} of "
                      f"full; bound {bound[0]:.4f} ({bound[1]}); normwise vs plain "
                      f"{row['normwise_vs_plain']:.2e}"
                      + (f"; bits as {SAME_BITS[n]}: {row['bit_equal']}"
                         if "bit_equal" in row else "")
                      + (f"; bits as production: {row['bit_equal_to_production']}"
                         if "bit_equal_to_production" in row else "")
                      + (f"; normwise vs production {row['normwise_vs_production']:.2e}"
                         if "normwise_vs_production" in row else ""))
    for site, runs, head in (("probe_sampler_ablations", ABLATION_RUNS, "full,bfloat16,R"),
                             ("probe_sampler_folds", {"R": FOLD_RUNS}, "concat_k,bfloat16,R")):
        variants = {k: v for k, v in rows.items()
                    if k.split(",")[0] in runs.get(k.split(",")[2], ())}
        h = variants[head]
        entry(site, h["ms"], h["plain_ms"], (h["bound_ms"], h["bound_by"]),
              max(v["max_abs_vs_plain"] for v in variants.values()), variants)

    # -- site 3: the product chains, k and R ------------------------------
    g = torch.Generator(device="cuda").manual_seed(7)
    # timed on mxu_bound_probe.py's constant inputs (:83-84), held to the
    # plain chain on seeded normal ones of the same shape
    x_lit = torch.full((R_B * 32, CHAIN_K), 0.01, device="cuda")
    w_lit = torch.full((N_MM, CHAIN_K, CHAIN_K), 0.008, device="cuda")
    x_chk, w_chk = chain_inputs(g)
    x_px = torch.randn((R_B, 32, 32, 4), generator=g, device="cuda")
    w_px = random_rotations(N_MM, 4, g)
    variants = {}
    ms = tt.alternated_ms({**{("chain", dt): functools.partial(mm_chain, x_lit, w_lit, dt)
                              for dt in DTYPES},
                           **{("torch", dt): functools.partial(_torch_chain, x_lit, w_lit, dt)
                              for dt in DTYPES}}, ROUNDS, CHAIN_ITERS)
    for dt in DTYPES:
        got, ref = mm_chain(x_chk, w_chk, dt), mm_chain_reference(x_chk, w_chk, dt)
        plain_ms = tt.time_ms(functools.partial(mm_chain_reference, x_lit, w_lit, dt), 2)
        flops = 2.0 * R_B * 32 * CHAIN_K * CHAIN_K * N_MM
        bound = tt._bound(flops, 2 * 4.0 * x_lit.numel() + 4.0 * w_lit.numel(), fs.is_bf16(dt))
        row = held({"ms": ms[("chain", dt)], "plain_ms": plain_ms,
                    "library_ms": ms[("torch", dt)], "bound_ms": bound[0],
                    "bound_by": bound[1], "tflops": flops / ms[("chain", dt)] / 1e9,
                    "patches_per_s": R_B / ms[("chain", dt)] * 1e3},
                   "mm_chain", dt, got, ref)
        pre = w_chk[:CHAIN_PREFIX].contiguous()
        got, ref = mm_chain(x_chk, pre, dt), mm_chain_reference(x_chk, pre, dt)
        row["prefix_normwise_vs_plain"] = tt._errors(got, ref)[0]
        if check is not None:
            row["agrees"] = row["agrees"] and bool(check("mm_chain_prefix", dt, got, ref))
        variants[f"literal,{dt}"] = row
        print(f"probe mm chain literal {dt}: {row['ms']:.4f} ms ({row['tflops']:.1f} TFLOP/s), "
              f"torch.matmul chain {row['library_ms']:.4f} ms, bound {bound[0]:.4f} ms; "
              f"normwise vs plain {row['normwise_vs_plain']:.2e} ({CHAIN_PREFIX} products: "
              f"{row['prefix_normwise_vs_plain']:.2e})")
    px_ms = tt.alternated_ms({v: functools.partial(px_chain, v, x_px, w_px) for v in PX_VARIANTS},
                             ROUNDS, ITERS)
    for v in PX_VARIANTS:
        dt = "float32" if v == "f32" else "bfloat16"
        got, ref = px_chain(v, x_px, w_px), mm_chain_reference(x_px, w_px, dt)
        flops = 2.0 * R_B * 1024 * 16 * N_MM
        bound = tt._bound(flops, 2 * 4.0 * x_px.numel() + 4.0 * w_px.numel(), dt == "bfloat16")
        row = held({"ms": px_ms[v], "plain_ms": tt.time_ms(
                        functools.partial(mm_chain_reference, x_px, w_px, dt), 2),
                    "bound_ms": bound[0], "bound_by": bound[1],
                    "tflops_useful": flops / px_ms[v] / 1e9}, "px_chain", dt, got, ref)
        variants[f"sampler_shape,{v}"] = row
        print(f"probe px chain {v}: {row['ms']:.4f} ms ({row['tflops_useful']:.2f} useful "
              f"TFLOP/s), bound {bound[0]:.4f} ms; normwise vs plain "
              f"{row['normwise_vs_plain']:.2e}")

    # calibration: the dense rate factor k (torch.matmul 4096^2) and the
    # production sampler's float32/bfloat16 ratio R at (R), in turns
    a = torch.randn((DENSE_N, DENSE_N), generator=g, device="cuda")
    bm = torch.randn((DENSE_N, DENSE_N), generator=g, device="cuda")
    ab, bb = a.to(torch.bfloat16), bm.to(torch.bfloat16)
    inp_r = shape_inputs(programs, "R")
    shipped = {dt: fs.make_sampler(inp_r["program"], inp_r["cond"], TEMP, 64, dt)
               for dt in DTYPES}    # kernel_sweep.py:243-255, "v2 shipped"
    cal = tt.alternated_ms({"dense_float32": lambda: a @ bm, "dense_bfloat16": lambda: ab @ bb,
                            "sampler_float32": lambda: shipped["float32"](SEED),
                            "sampler_bfloat16": lambda: shipped["bfloat16"](SEED)},
                           ROUNDS, ITERS)
    dense = {dt: 2.0 * DENSE_N ** 3 / cal[f"dense_{dt}"] / 1e9 for dt in DTYPES}
    k = dense["bfloat16"] / dense["float32"]
    r = cal["sampler_float32"] / cal["sampler_bfloat16"]
    k_chain = variants["literal,float32"]["ms"] / variants["literal,bfloat16"]["ms"]
    calibration = {
        "dense_tflops": dense, "k": k, "k_chain": k_chain,
        "k_sampler_shape": variants["sampler_shape,f32"]["ms"]
        / variants["sampler_shape,bf16_mma"]["ms"],
        "sampler_ms": {dt: cal[f"sampler_{dt}"] for dt in DTYPES}, "R": r,
        "matmul_share": (r - 1) / (k - 1) if k > 1 else None,
        "matmul_share_chain_k": (r - 1) / (k_chain - 1) if k_chain > 1 else None,
        "sampler_over_chain_rate": variants["literal,bfloat16"]["ms"] / cal["sampler_bfloat16"],
    }
    print(f"probe calibration: dense {dense['float32']:.1f} / {dense['bfloat16']:.1f} TFLOP/s "
          f"(f32 / bf16), k = {k:.2f}, chain k = {k_chain:.2f}; sampler (R) f32 "
          f"{cal['sampler_float32']:.4f} ms, bf16 {cal['sampler_bfloat16']:.4f} ms, R = "
          f"{r:.3f}; matmul share (R-1)/(k-1) = {calibration['matmul_share']}; sampler bf16 "
          f"rate / chain bf16 rate = {calibration['sampler_over_chain_rate']:.3f}")
    h = variants["literal,bfloat16"]
    entry("probe_mm_chain", h["ms"], h["plain_ms"], (h["bound_ms"], h["bound_by"]),
          max(v["max_abs_vs_plain"] for v in variants.values()), variants,
          library_ms=h["library_ms"], calibration=calibration)
    return res


def random_rotations(n: int, k: int, generator):
    """n random orthogonal k x k matrices (QR of normals) on the generator's
    device: a chain of them keeps its norm, so it neither vanishes nor
    explodes at the sampler's 4 channels, where N(0, 1/k) products shrink."""
    q, r = torch.linalg.qr(torch.randn((n, k, k), generator=generator,
                                       device=generator.device).cpu())
    return (q * torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))[:, None, :]).to(
        generator.device).contiguous()


def _torch_chain(x, w, mm_dtype):
    """The literal chain as 56 torch.matmul calls, in the chain's precision
    (bfloat16 tensors, or float32 with TF32 off): the library yardstick."""
    if fs.is_bf16(mm_dtype):
        x, w = x.to(torch.bfloat16), w.to(torch.bfloat16)
    for m in range(w.shape[0]):
        x = x @ w[m]
    return x


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", help="write the table as JSON here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sampler probes: need a CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    from noise_flow_tpu_torch.ops import _build
    _build.build_all(["fused_sample", "sample_probe", *_build.SAMPLE_VARIANT_LIBRARIES])
    for name in _build.build_logs:
        for k in _build.kernel_resources(name):
            print(f"ptxas[{name}] {k['kernel']}: {k.get('registers')} registers, spill "
                  f"{k['spill_stores']} B stores / {k['spill_loads']} B loads")
    table = {"device": smi, "probes": attribution()}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(table, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
