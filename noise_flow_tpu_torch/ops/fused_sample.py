"""Fused sampler: the whole sampling chain, latent -> noise, in one kernel.

Port of noise_flow_tpu.ops.pallas_sample. The published flow (arch
``sdn5|unc x4|gain4|unc x4``) is ten small bijectors over 32x32x4 patches;
the kernel (``csrc/fused_sample.cu``) runs the chain with each patch held on
chip, reading eps and clean once and writing the noise once. Every call is
one launch: in batch-BN mode one cooperative launch whose BN stages end in
grid-wide barriers (``sample_plan`` says where it runs).

The program build folds a ``NoiseFlow`` into what the kernel takes:

- ``ops``: the chain in sampling order (specs reversed), each op one of
  mix (a 4x4 channel matrix: ``A_inv`` of an invertible 1x1 conv, or the
  channel reverse), scale (``x *= sqrt(a*clean + b)`` with per-example
  ``(a, b)``), or coupling.
- ``mixes`` ``[n_mix, 4, 4]``: ``y[co] = sum_ci x[ci] * A[ci, co]``.
- ``coup`` ``[n_coupling, REC]``: one record of float32 per coupling, laid out
  as in ``_REC_LAYOUT``. Conv weights stay HWIO. The zero-conv's
  ``exp(3*logs)`` factor is folded into its weights and bias, and its
  edge-indicator input channel is kept apart (``wind``): it is 1 exactly
  where a 3x3 tap falls outside the patch. With ``bn_mode='running'`` the
  BatchNorm statistics fold into ``w1/b1`` and ``w2/b2``; with
  ``bn_mode='batch'`` they stay out and the kernel normalises with moments
  of the group of ``bt`` patches the example belongs to (the reference
  wrapper's is_training=True quirk, ref:NoiseFlowWrapper.py:86).

Scale layers reduce to per-example ``(a, b)``, found by running each layer's
own forward at clean = 0 and clean = 1 (``SampleProgram.scale_ab``).

The chain input is eps * temp, read from device memory, or, in the in-kernel
RNG mode (the JAX kernel's ``use_prng``), drawn inside the kernel from a seed:
Philox-4x32-10 bits through JAX's ``_box_muller``. ``rng_normals_reference``
is that draw in plain PyTorch; the counter and key it assigns are written
down once, at the top of ``csrc/fused_sample.cu``.

``mm_dtype`` picks the precision of the chain's products, as the JAX
kernel's: ``float32``, or ``bfloat16``, where each product of a mix or a
convolution rounds both its operands to bfloat16 (nearest even) and sums
the exact products in float32 (JAX's ``jnp.dot(a.astype(bf16),
b.astype(bf16), preferred_element_type=f32)``). Everything else stays
float32: biases, the offsets of the zero-conv's indicator channel, the
batch-BN moments (JAX's ``mm32``), the scale layers and the coupling update.
In running-BN mode the rounded weights are the BN-folded ones.

``sample_chain_reference`` is the plain PyTorch version of the kernel's
function. ``fused_sample_chain`` (eps) and ``fused_sample_chain_rng`` (seed)
launch the kernel for CUDA tensors and take the plain version only for CPU
tensors.
"""

from __future__ import annotations

import collections
import ctypes
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from noise_flow_tpu_torch.models.layers import SCALE_KINDS
from noise_flow_tpu_torch.ops.nn import (
    BN_EPS,
    LOGSCALE_FACTOR,
    _edge_pad_with_indicator,
    conv2d_nhwc,
)
from noise_flow_tpu_torch.utils.profiling import annotate

H, W, C = 32, 32, 4
OP_MIX, OP_SCALE, OP_COUPLING = 0, 1, 2
MAX_OPS = 64    # the kernel's op table (csrc/fused_sample.cu: MAX_OPS)
MAX_BN_BLOCK = 256
COOP_PART = 8   # floats a patch in each partials buffer (csrc/sample_kernel.cuh: CPART)

# name -> (offset, shape) inside one coupling record; must match the
# OFF_* constants of csrc/fused_sample.cu. Offsets are multiples of 4 floats
# so the kernel reads weights as float4.
_REC_LAYOUT = {
    "w1": (0, (3, 3, 2, 4)),      # conv 3x3, channels {0,1} -> hidden
    "b1": (72, (4,)),
    "w2": (76, (4, 4)),           # conv 1x1, hidden -> hidden
    "b2": (92, (4,)),
    "w3": (96, (3, 3, 4, 4)),     # zero-conv 3x3 (scaled): out {0,1} shift, {2,3} log-scale
    "wind": (240, (3, 3, 4)),     # zero-conv weights of the indicator channel (scaled)
    "bz": (276, (4,)),            # zero-conv bias (scaled)
    "rescale": (280, (1,)),
}
REC = 288

# Launches of each kernel, counted where the wrapper launches it.
launch_counts: Dict[str, int] = collections.Counter()
# Launches recorded into a CUDA graph while a stream captures one: they run
# only when the graph is replayed, and the graph's owner
# (``training.step_graph``) adds them to launch_counts at each replay.
captured_counts: Dict[str, int] = collections.Counter()


def count_launches(name: str, n: int) -> None:
    """Add n launches of kernel ``name`` on the current CUDA device: to
    launch_counts, or to captured_counts while its current stream
    captures a graph."""
    counts = captured_counts if torch.cuda.is_current_stream_capturing() else launch_counts
    counts[name] += n


# the precisions of the kernels' products, by the names JAX's kernels use
_MM_DTYPES = {"float32": False, "bfloat16": True, torch.float32: False, torch.bfloat16: True}


def is_bf16(mm_dtype) -> bool:
    """True for the bfloat16 mode, False for float32; raise for any other
    ``mm_dtype`` (a string or a torch dtype)."""
    try:
        return _MM_DTYPES[mm_dtype]
    except (KeyError, TypeError):
        raise ValueError(f"mm_dtype must be float32 or bfloat16, got {mm_dtype!r}") from None


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (nearest even) and back to float32: an operand
    of a product in the bfloat16 mode."""
    return t.to(torch.bfloat16).to(torch.float32)


def _field(rec: torch.Tensor, name: str) -> torch.Tensor:
    off, shape = _REC_LAYOUT[name]
    return rec[..., off:off + math.prod(shape)].reshape(rec.shape[:-1] + shape)


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float32)


def _coupling_record(layer, fold_bn: bool) -> np.ndarray:
    """One coupling layer's NN -> its kernel record."""
    p, s = layer.nn, layer.nn
    width = p.l1_w.shape[-1]
    if width > C:
        raise ValueError(f"fused sampler supports coupling width <= {C}, "
                         f"got {width}")
    if p.l1_w.shape[2] != C // 2 or p.last.w.shape[-1] != C:
        raise ValueError("fused sampler supports 4-channel couplings only")
    w1, b1 = _np(p.l1_w), _np(p.l1_b).reshape(-1)
    w2, b2 = _np(p.l2_w)[0, 0], _np(p.l2_b).reshape(-1)
    if fold_bn:
        # the float32 operations of JAX's _bn_fold, so that the folded
        # weights, which the bfloat16 mode rounds, are the same floats
        s1 = (1.0 / np.sqrt(_np(s.bn1.var) + BN_EPS)).astype(np.float32)
        s2 = (1.0 / np.sqrt(_np(s.bn2.var) + BN_EPS)).astype(np.float32)
        w1, b1 = w1 * s1, (b1 - _np(s.bn1.mean)) * s1
        w2, b2 = w2 * s2, (b2 - _np(s.bn2.mean)) * s2
    zs = np.exp(_np(p.last.logs).reshape(-1) * LOGSCALE_FACTOR)   # [4]
    wz = _np(p.last.w)                                             # [3,3,width+1,4]
    fields = {
        "w1": np.pad(w1, ((0, 0), (0, 0), (0, 0), (0, C - width))),
        "b1": np.pad(b1, (0, C - width)),
        "w2": np.pad(w2, ((0, C - width), (0, C - width))),
        "b2": np.pad(b2, (0, C - width)),
        "w3": np.pad(wz[:, :, :width, :] * zs, ((0, 0), (0, 0), (0, C - width), (0, 0))),
        "wind": wz[:, :, width, :] * zs,
        "bz": _np(p.last.b).reshape(-1) * zs,
        "rescale": _np(layer.rescale).reshape(1),
    }
    rec = np.zeros((REC,), np.float32)
    for name, v in fields.items():
        off, shape = _REC_LAYOUT[name]
        rec[off:off + v.size] = np.asarray(v, np.float32).reshape(-1)
    return rec


class SampleProgram:
    """Folded kernel inputs of one flow: op list + stacked weight tensors."""

    def __init__(self, ops, mixes, couplings, scale_layers, shared, bn_mode,
                 device):
        self.ops: List[Tuple[int, int]] = ops
        self.bn_mode = bn_mode
        self.scale_layers = scale_layers
        self.shared = shared
        self.n_scale = len(scale_layers)
        self.mixes = torch.as_tensor(
            np.stack(mixes) if mixes else np.zeros((1, C, C), np.float32),
            device=device).contiguous()
        self.coup = torch.as_tensor(
            np.stack(couplings) if couplings else np.zeros((1, REC), np.float32),
            device=device).contiguous()
        self.ops_code = [kind << 8 | idx for kind, idx in ops]
        self.device = torch.device(device)

    @torch.no_grad()
    def scale_ab(self, cond, batch: int):
        """Per-example (a, b) for each scale layer: scale = sqrt(a*clean + b).

        Evaluated through the layer's own forward at clean={0,1}
        (x=1 => y=scale), so every conditional formula is reused, not
        re-derived. Returns [B, n_scale] a and b ([B, 1] zeros if none)."""
        dev = self.device
        if not self.scale_layers:
            z = torch.zeros((batch, 1), dtype=torch.float32, device=dev)
            return z, z
        ones = torch.ones((batch, 1, 1, 1), dtype=torch.float32, device=dev)
        a_cols, b_cols = [], []
        for layer in self.scale_layers:
            s0, _ = layer.forward(ones, dict(cond, clean=torch.zeros_like(ones)),
                                  False, self.shared)
            s1, _ = layer.forward(ones, dict(cond, clean=ones), False, self.shared)
            b = (s0 * s0).expand(batch, 1, 1, 1).reshape(batch, -1)[:, :1]
            a = (s1 * s1).expand(batch, 1, 1, 1).reshape(batch, -1)[:, :1] - b
            a_cols.append(a)
            b_cols.append(b)
        return (torch.cat(a_cols, 1).contiguous(),
                torch.cat(b_cols, 1).contiguous())


FOLDED_KINDS = ("conv1x1", "perm_reverse", "coupling") + tuple(SCALE_KINDS)


def in_envelope(flow) -> bool:
    """Whether the fused sampler covers the flow's family: one level, no
    squeeze, the conv coupling template and only the kinds it folds. A flow
    in the family may still be refused for its patch shape or its length
    (``build_sample_program`` raises); one outside it has no fused path."""
    return (flow.n_levels == 1 and flow.cfg.squeeze_factor == 1
            and getattr(flow.cfg, "coupling_nn", "conv") != "dense"
            and all(spec.kind in FOLDED_KINDS for spec in flow.specs))


@torch.no_grad()
def build_sample_program(flow, bn_mode: str = "running") -> SampleProgram:
    """Fold a NoiseFlow's weights into a fused sampling program.

    bn_mode='batch' computes coupling-NN BN from the moments of each group of
    patches (the reference wrapper's is_training=True quirk); 'running' folds
    the inference statistics into the weights.
    """
    if bn_mode not in ("running", "batch"):
        raise ValueError(f"bn_mode must be 'running' or 'batch', got {bn_mode!r}")
    if not in_envelope(flow):
        raise ValueError("fused sampling supports single-level unsqueezed flows "
                         f"of the conv coupling template and the kinds {FOLDED_KINDS}")
    if tuple(flow.x_shape) != (H, W, C):
        raise ValueError(f"fused sampling requires x_shape {(H, W, C)}, "
                         f"got {flow.x_shape}")
    ops, mixes, couplings, scales = [], [], [], []
    for spec, layer in zip(reversed(flow.specs), reversed(list(flow.layers))):
        if spec.kind == "conv1x1":
            mixes.append(_np(layer.built()["A_inv"]))
            ops.append((OP_MIX, len(mixes) - 1))
        elif spec.kind == "perm_reverse":
            mixes.append(np.eye(C, dtype=np.float32)[::-1].copy())
            ops.append((OP_MIX, len(mixes) - 1))
        elif spec.kind == "coupling":
            couplings.append(_coupling_record(layer, fold_bn=bn_mode == "running"))
            ops.append((OP_COUPLING, len(couplings) - 1))
        else:
            scales.append(layer)
            ops.append((OP_SCALE, len(scales) - 1))
    if len(ops) > MAX_OPS or max(len(mixes), len(couplings), len(scales)) > 255:
        raise ValueError(f"fused sampler takes at most {MAX_OPS} ops")
    return SampleProgram(ops, mixes, couplings, scales, flow.shared_view(),
                         bn_mode, flow.device)


def bn_block(b: int) -> int:
    """Patches per BatchNorm group in batch mode: the whole batch up to
    ``MAX_BN_BLOCK``, else its largest divisor <= ``MAX_BN_BLOCK``
    (the JAX wrapper's rule, wrapper.py:116-122)."""
    if b <= MAX_BN_BLOCK:
        return b
    return next(d for d in range(MAX_BN_BLOCK, 0, -1) if b % d == 0)


# ---------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------

_MASK32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
SEED_MOD = 2 ** 31 - 1


def rng_seed(seed) -> int:
    """An int seed as the kernel takes it: ``int(seed) % (2**31 - 1)``, as
    JAX's ``make_sampler`` and ``pallas_sample`` reduce it."""
    return int(seed) % SEED_MOD


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of a * m, for an int64 tensor ``a`` of 32-bit
    values and a 32-bit constant ``m``, in 16-bit halves of ``m`` so that no
    product leaves int64."""
    t_lo = a * (m & 0xFFFF)
    t_hi = a * (m >> 16)
    return (t_hi + (t_lo >> 16)) >> 16, (((t_hi & 0xFFFF) << 16) + t_lo) & _MASK32


def philox4x32_10(counter, key):
    """Philox-4x32-10 on int64 tensors holding 32-bit words: counter
    [..., 4], key [..., 2] (broadcast) -> [..., 4], as the kernel's
    ``philox4x32_10``."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = key.unbind(-1)
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
    return torch.stack([c0, c1, c2, c3], -1)


def box_muller(bits1, bits2):
    """JAX's ``_box_muller``: 32-bit words (int64 tensors) [..., S, L] ->
    float32 normals [..., 2S, L], the cos half in rows [0, S) and the sin
    half in rows [S, 2S)."""
    u1 = (bits1 >> 8).to(torch.float32) * 2.0 ** -24 + 2.0 ** -25
    u2 = (bits2 >> 8).to(torch.float32) * 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = (2.0 * math.pi) * u2
    return torch.cat([r * torch.cos(th), r * torch.sin(th)], dim=-2)


def rng_normals_reference(seed, b: int, device="cpu"):
    """The normals [b,32,32,4] that the kernel's RNG mode draws for ``seed``
    (before the temperature): a pure function of (seed, patch, row, channel),
    with the counter and key of ``csrc/fused_sample.cu`` (key (seed, 0),
    counter (32 h + w, patch, j, 0)). Box-Muller pairs row h with row h + 16
    at the same (w, c), as JAX's kernel pairs the rows of its [32, W*C]
    tile."""
    i64 = dict(dtype=torch.int64, device=device)
    n_hw = (H // 2) * W
    shape = (b, n_hw, 2)
    counter = torch.stack([
        torch.arange(n_hw, **i64)[None, :, None].expand(shape),
        torch.arange(b, **i64)[:, None, None].expand(shape),
        torch.arange(2, **i64)[None, None, :].expand(shape),
        torch.zeros(shape, **i64)], -1)
    bits = philox4x32_10(counter, torch.tensor([rng_seed(seed), 0], **i64))
    tile = (b, H // 2, W * C)   # lane w * C + c of row h, as the JAX tile
    out = box_muller(bits[:, :, 0].reshape(tile), bits[:, :, 1].reshape(tile))
    return out.reshape(b, H, W, C)


def _group_bn(h, bt: int):
    """Normalise with two-pass biased moments of each group of ``bt``
    consecutive patches (the last group may be smaller); no padding enters."""
    out = []
    for g in torch.split(h, bt, dim=0):
        m = g.mean(dim=(0, 1, 2))
        v = ((g - m) ** 2).mean(dim=(0, 1, 2))
        out.append((g - m) * torch.rsqrt(v + BN_EPS))
    return torch.cat(out, 0)


def merged_group_moments(h, bt: int):
    """The batch-BN moments as the kernel's production design merges them
    (``coop_kernel``): each patch's sum and M2 (squared deviations from its
    own mean), merged over each group of ``bt`` consecutive patches in patch
    order, M2 = sum_p M2_p + NPIX * (mean_p - mean)^2. h [B, 32, 32, C] ->
    (mean, biased variance), each [n_groups, C]. The same moments as
    ``_group_bn``'s two passes, in another order of float32 sums."""
    npix = h.shape[1] * h.shape[2]
    sums = h.sum(dim=(1, 2))                                       # [B, C]
    m2 = ((h - (sums / npix)[:, None, None]) ** 2).sum(dim=(1, 2))
    means, vars_ = [], []
    for s, q in zip(torch.split(sums, bt), torch.split(m2, bt)):
        n = s.shape[0] * npix
        mean = s.sum(0) / n
        means.append(mean)
        vars_.append((q.sum(0) + npix * ((s / npix - mean) ** 2).sum(0)) / n)
    return torch.stack(means), torch.stack(vars_)


def _zero_conv(h, rec, rnd):
    """The coupling's zero-conv of the hidden map h: taps inside the patch
    are a product of rnd(h) and rnd(w3); taps outside add the indicator
    channel's weights, and the bias, in float32."""
    wz = torch.cat([rnd(_field(rec, "w3")), _field(rec, "wind")[:, :, None]], 2)
    return conv2d_nhwc(_edge_pad_with_indicator(rnd(h)), wz, "VALID") + _field(rec, "bz")


@torch.no_grad()
def sample_chain_reference(program: SampleProgram, x, clean, sa, sb,
                           bt: Optional[int] = None, mm_dtype="float32"):
    """Plain version of the kernel: x [B,32,32,4] (eps * temp), clean
    [B,32,32,4], sa/sb [B, n_scale] -> noise [B,32,32,4]. ``mm_dtype`` as in
    the module docstring: in bfloat16 both operands of every product are
    rounded, and nothing else."""
    batch_bn = program.bn_mode == "batch"
    bt = bt or x.shape[0]
    rnd = bf16_round if is_bf16(mm_dtype) else (lambda t: t)
    for kind, idx in program.ops:
        if kind == OP_MIX:
            x = rnd(x) @ rnd(program.mixes[idx])
        elif kind == OP_SCALE:
            a = sa[:, idx].reshape(-1, 1, 1, 1)
            b = sb[:, idx].reshape(-1, 1, 1, 1)
            x = x * torch.sqrt(a * clean + b)
        else:
            rec = program.coup[idx]
            h = conv2d_nhwc(rnd(x[..., :2]), rnd(_field(rec, "w1"))) + _field(rec, "b1")
            h = torch.relu(_group_bn(h, bt) if batch_bn else h)
            h = rnd(h) @ rnd(_field(rec, "w2")) + _field(rec, "b2")
            h = torch.relu(_group_bn(h, bt) if batch_bn else h)
            t = _zero_conv(h, rec, rnd)
            ls = _field(rec, "rescale") * torch.tanh(t[..., 2:])
            x = torch.cat([x[..., :2], (x[..., 2:] - t[..., :2]) * torch.exp(-ls)], -1)
    return x


# ---------------------------------------------------------------------------
# kernel wrapper
# ---------------------------------------------------------------------------

def _check(name, t, shape):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def _launch_kernel(program: SampleProgram, x, clean, sa, sb, bt: int,
                   seed: Optional[int] = None, temp: float = 1.0, bf16: bool = False):
    """Launch the chain on x (eps * temp), or with ``seed`` (x None) on
    normals(seed) * temp drawn in the kernel; ``bf16`` picks the kernel's
    bfloat16 mode."""
    from noise_flow_tpu_torch.ops._build import load_library

    b = clean.shape[0]
    ns = sa.shape[1]
    if seed is None:
        _check("x", x, (b, H, W, C))
    _check("clean", clean, (b, H, W, C))
    _check("sa", sa, (b, ns))
    _check("sb", sb, (b, ns))
    _check("mixes", program.mixes, program.mixes.shape)
    _check("coup", program.coup, program.coup.shape)
    devices = {clean.device, sa.device, sb.device, program.mixes.device}
    if len(devices | ({x.device} if seed is None else set())) != 1:
        raise ValueError("fused_sample inputs and program lie on different devices")
    if ns < max(program.n_scale, 1) or not 1 <= bt or b < 1:
        raise ValueError(f"bad sizes: batch {b}, bt {bt}, n_scale {ns}")
    lib = load_library("fused_sample")
    out = torch.empty_like(clean)
    part = torch.empty((2, b, COOP_PART), dtype=torch.float32, device=clean.device)
    mom = torch.empty((-(-b // bt), 12), dtype=torch.float32, device=clean.device)
    ops = (ctypes.c_int * len(program.ops_code))(*program.ops_code)
    launched = ctypes.c_int(0)
    with torch.cuda.device(clean.device):
        stream = torch.cuda.current_stream(clean.device).cuda_stream
        err = lib.nf_fused_sample(
            x.data_ptr() if seed is None else None, out.data_ptr(), clean.data_ptr(),
            sa.data_ptr(), sb.data_ptr(), program.mixes.data_ptr(), program.coup.data_ptr(),
            part.data_ptr(), mom.data_ptr(), b, ns, bt,
            int(program.bn_mode == "batch"), ops, len(program.ops_code),
            int(seed is not None), 0 if seed is None else seed, float(temp), int(bf16),
            stream, ctypes.byref(launched))
        # one per kernel launch, as the C entry reports them: one a call in
        # either BN mode (batch BN is one cooperative launch)
        count_launches("fused_sample", launched.value)
        if seed is not None:
            count_launches("fused_sample_rng", launched.value)
        if bf16:
            count_launches("fused_sample_bf16", launched.value)
    if err != 0:
        raise RuntimeError(f"fused_sample kernel launch failed: CUDA error {err}")
    return out


def sample_plan(b: int, mm_dtype="float32", device="cuda") -> Dict[str, int]:
    """Where the kernel runs a batch-BN call of ``b`` patches on the card
    (``nf_sample_plan``, from the occupancy API): ``grid`` CTAs, ``per_sm``
    of them an SM, ``resident`` 1 if each CTA holds one patch for the whole
    chain (b <= the CTAs the card holds at once), 0 if each CTA walks
    patches ``blockIdx.x + k * gridDim.x``."""
    from noise_flow_tpu_torch.ops._build import load_library

    device = torch.device(device)
    if device.type != "cuda" or b < 1:
        raise ValueError(f"sample_plan takes b >= 1 on a CUDA device, got {b} on {device}")
    vals = [ctypes.c_int(0) for _ in range(3)]
    with torch.cuda.device(device):
        err = load_library("fused_sample").nf_sample_plan(int(is_bf16(mm_dtype)), b,
                                                          *map(ctypes.byref, vals))
    if err != 0:
        raise RuntimeError(f"nf_sample_plan failed: CUDA error {err}")
    return dict(zip(("grid", "per_sm", "resident"), (v.value for v in vals)))


def _default_bt(program: SampleProgram, b: int, bt: Optional[int]) -> int:
    return bt or (bn_block(b) if program.bn_mode == "batch" else b)


def _device_kind(t) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_sample runs on CUDA or CPU tensors, got {t.device}")
    return t.device.type


def fused_sample_chain(program: SampleProgram, x, clean, sa, sb,
                       bt: Optional[int] = None, mm_dtype="float32"):
    """Run the sampling chain on x = eps * temp.

    CUDA tensors go through the kernel (or raise); CPU tensors through
    ``sample_chain_reference``. ``bt`` is the BatchNorm group size in batch
    mode (default ``bn_block(B)``) and is ignored in running mode.
    ``mm_dtype``: float32 or bfloat16 (the kernel's bfloat16 mode)."""
    bt = _default_bt(program, x.shape[0], bt)
    bf16 = is_bf16(mm_dtype)
    if _device_kind(x) == "cpu":
        return sample_chain_reference(program, x, clean, sa, sb, bt, mm_dtype)
    return _launch_kernel(program, x, clean, sa, sb, bt, bf16=bf16)


def fused_sample_chain_rng(program: SampleProgram, seed, temp: float, clean, sa, sb,
                           bt: Optional[int] = None, mm_dtype="float32"):
    """Run the sampling chain on normals(seed) * temp, drawn in the kernel
    (the JAX kernel's in-kernel RNG mode): no eps tensor exists on the card.
    CPU tensors go through ``sample_chain_reference`` on
    ``rng_normals_reference(seed, B) * temp``. ``bt`` and ``mm_dtype`` as in
    ``fused_sample_chain``."""
    b = clean.shape[0]
    bt = _default_bt(program, b, bt)
    bf16 = is_bf16(mm_dtype)
    if _device_kind(clean) == "cpu":
        x = rng_normals_reference(seed, b) * temp
        return sample_chain_reference(program, x, clean, sa, sb, bt, mm_dtype)
    return _launch_kernel(program, None, clean, sa, sb, bt, seed=rng_seed(seed), temp=temp,
                          bf16=bf16)


def rng_normals(seed, b: int, device, temp: float = 1.0):
    """normals(seed) * temp [b,32,32,4], drawn by the kernel's own
    ``draw_normals`` on a CUDA device (one launch of ``nf_rng_normals``), or
    by ``rng_normals_reference`` on the CPU."""
    device = torch.device(device)
    if device.type == "cpu":
        return rng_normals_reference(seed, b) * temp
    if device.type != "cuda" or b < 1:
        raise ValueError(f"rng_normals takes b >= 1 on CUDA or the CPU, got {b} on {device}")
    from noise_flow_tpu_torch.ops._build import load_library

    out = torch.empty((b, H, W, C), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        err = load_library("fused_sample").nf_rng_normals(
            out.data_ptr(), b, rng_seed(seed), float(temp),
            torch.cuda.current_stream(device).cuda_stream)
    launch_counts["rng_normals"] += 1
    if err != 0:
        raise RuntimeError(f"rng_normals kernel launch failed: CUDA error {err}")
    return out


@torch.no_grad()
def fused_sample(program: SampleProgram, cond, temp: float = 1.0, eps=None,
                 generator: Optional[torch.Generator] = None,
                 bt: Optional[int] = None, seed=None, mm_dtype="float32"):
    """Sample noise for cond {'clean':[B,32,32,4], 'nlf0','nlf1','iso','cam'}.

    eps (optional): standard normals [B,32,32,4] for parity tests, else drawn
    from ``generator`` on the program's device. With ``seed`` (an int; the
    counterpart of ``pallas_sample(..., in_kernel_rng=True)``) the normals
    are drawn in the kernel instead and no eps tensor is made. ``bt`` and
    ``mm_dtype`` (float32, ``pallas_sample``'s default, or bfloat16) as in
    ``fused_sample_chain``. Returns [B,32,32,4]."""
    dev = program.device
    clean = torch.as_tensor(cond["clean"], dtype=torch.float32, device=dev).contiguous()
    b = clean.shape[0]
    sa, sb = program.scale_ab(cond, b)
    if seed is not None:
        if eps is not None:
            raise ValueError("fused_sample takes eps or seed, not both")
        return fused_sample_chain_rng(program, seed, temp, clean, sa, sb, bt, mm_dtype)
    if eps is None:
        eps = torch.randn((b, H, W, C), generator=generator, device=dev)
    x = (torch.as_tensor(eps, dtype=torch.float32, device=dev) * temp).contiguous()
    return fused_sample_chain(program, x, clean, sa, sb, bt, mm_dtype)


def precompute_scale_ab(program: SampleProgram, cond, batch: Optional[int] = None):
    """The per-example scale coefficients (sa, sb) of ``cond``: they depend
    on (nlf0, nlf1, iso, cam), not on clean, so a sampling loop with fixed
    conditioning computes them once (JAX's ``precompute_scale_ab``)."""
    return program.scale_ab(cond, batch or cond["clean"].shape[0])


def make_sampler(program: SampleProgram, cond, temp: float = 1.0, bt: int = 64,
                 mm_dtype=torch.bfloat16, tile_out: bool = True):
    """The leanest per-call sampling closure for FIXED conditioning (JAX's
    ``make_sampler``): scale coefficients computed once, normals drawn in the
    kernel from an int seed, one launch a call in running-BN mode. Returns
    ``sample(seed) -> noise``, [B, 32, 32*4] (a view of the NHWC result) with
    ``tile_out``, else [B, 32, 32, 4]. ``bt`` is the BatchNorm group in batch
    mode and must divide B, as JAX requires. ``mm_dtype`` is the kernel's
    precision, bfloat16 by default, as JAX's."""
    is_bf16(mm_dtype)
    dev = program.device
    clean = torch.as_tensor(cond["clean"], dtype=torch.float32, device=dev).contiguous()
    batch = clean.shape[0]
    if batch % bt:
        raise ValueError(f"batch {batch} must be a multiple of bt {bt}")
    with torch.no_grad():
        sa, sb = precompute_scale_ab(program, cond, batch)

    def sample(seed):
        with annotate("nf.sample.call"):
            out = fused_sample_chain_rng(program, seed, temp, clean, sa, sb, bt, mm_dtype)
            return out.view(batch, H, W * C) if tile_out else out

    return sample
