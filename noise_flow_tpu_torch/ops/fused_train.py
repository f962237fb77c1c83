"""Fused training step and fused eval forward: the NLL direction in kernels.

Port of noise_flow_tpu.ops.pallas_train. The kernels of
``csrc/fused_train.cu`` serve the trainer's ``use_pallas=True`` path:

- ``FusedTrainStep`` (one-shot train step): the mean-NLL forward of the
  whole chain in inverse order and, in the same launch, its backward with the
  analytic seeds ``d(mean nll)/dz = z/B`` and ``d(mean nll)/d ldj_i = -1/B``.
  BatchNorm uses the moments of each group of ``bt`` consecutive patches
  (ghost BN; ``bt = B`` is exact batch BN), as the JAX kernel does.
- ``FusedFlow``: each ``[mix, coupling]*`` segment through a kernel, the
  scale layers in PyTorch. Eval (``train=False``) runs the
  running-statistics forward kernel. Train (the segment path) runs each
  segment through ``SegmentFn``: the ghost-BN forward kernel, and a backward
  kernel that recomputes that forward and takes any cotangents ``(gz,
  gldj)``; plain autograd carries them through the scale layers between.

The fold turns the flow's parameters into what the kernels take, in
differentiable PyTorch so that autograd carries the kernel's gradients back
to the parameters:

- ``rec`` ``[n_coupling, REC]``: one record per coupling, laid out as
  ``fused_sample._REC_LAYOUT`` (HWIO conv weights; the zero-conv's weights
  already scaled by ``exp(3*logs)``). The step kernel reads w1, b1, w2, b2,
  w3 and rescale; the running-mode records have BatchNorm folded into
  w1/b1 and w2/b2.
- ``offs`` ``[n_coupling, 32, 32, 4]``: the zero-conv's input-independent
  part, its edge-indicator taps plus bias, times ``exp(3*logs)``. The kernel
  returns ``d offs``; autograd takes it to ``w[..., width, :]``, ``b`` and
  ``logs``.
- ``mixes`` ``[n_mix, 4, 4]``: ``A`` of each invertible 1x1 conv (the
  training direction), or the channel reverse; their log-det is
  ``sum(log_s) * H * W``.

Scale layers (sdn*, gain*) reduce to per-example ``(a, b)`` with
``x / sqrt(a * clean + b)``, taken through each layer's own ``forward`` at
clean = 0 and 1; their log-dets through the layer's own ``inverse`` on a
dummy input. Both stay in differentiable PyTorch.

``mm_dtype`` is the precision of the kernels' products, by JAX's names:
``"float32"``, or ``"bfloat16"`` (the trainer's default
``pallas_train_dtype``), where every product that JAX's kernels compute as a
matmul ``mm(a, b)`` rounds both operands to bfloat16 (nearest even) and
sums the exact products in float32. Forward: the chain state at a mix and
at conv1, relu(n1) at conv2, relu(n2) at conv3, and the weights. Backward:
each data gradient ``mm(g, w.T)`` rounds g and w, each weight gradient
``mm(a.T, g)`` rounds a and g; the elementwise uses of the same values stay
float32. The ghost-BN moments are an ``mm`` there too: the sum of each lane
(one column and channel) over the group's rows is rounded to bfloat16
before the 32 lanes of a channel are added, in both forward moments and in
the two means of the BN backward. Autograd through ``.to(torch.bfloat16)``
would round the results of the backward's products instead of their
operands, so the bfloat16 plain versions are built from autograd Functions
whose backward rounds where JAX's does. The running-statistics eval forward
in bfloat16 takes the records without BN folded in and the running moments
(``bnrun``), as JAX's kernel with ``ghost_bn=False``.

``train_step_reference``, ``segment_forward_reference``,
``segment_train_forward_reference`` and ``segment_backward_reference`` are
the plain PyTorch versions of the kernels. ``fused_train_step``,
``fused_segment_forward``, ``fused_segment_train_forward`` and
``fused_segment_backward`` launch the kernels for CUDA tensors and take the
plain versions only for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from noise_flow_tpu_torch.models.layers import SCALE_KINDS
from noise_flow_tpu_torch.ops.conv1x1 import tri_index
from noise_flow_tpu_torch.ops.fused_sample import (
    MAX_OPS,
    OP_COUPLING,
    OP_MIX,
    OP_SCALE,
    REC,
    _REC_LAYOUT,
    _check,
    _field,
    bf16_round,
    count_launches,
    is_bf16,
    launch_counts,  # noqa: F401  (read as fused_train.launch_counts)
)
from noise_flow_tpu_torch.ops.nn import BN_DECAY, BN_EPS, LOGSCALE_FACTOR, conv2d_nhwc
from noise_flow_tpu_torch.utils.device import device_constant
from noise_flow_tpu_torch.utils.profiling import annotate

H, W, C = 32, 32, 4
SUPPORTED_KINDS = {"coupling", "conv1x1", "perm_reverse"}
_CODE = {"mix": OP_MIX, "scale": OP_SCALE, "coup": OP_COUPLING}
# what one launch of the train kernel computes (Mode in csrc/fused_train.cu)
_STEP, _SEG_FWD, _SEG_BWD = 0, 1, 2


class Segment(NamedTuple):
    """A fused [mix?, coupling]* run. ops: (("mix", i) | ("coup", i), ...)."""
    ops: Tuple[Tuple[str, int], ...]
    nm: int
    nc: int


def pick_block(b: int, target: int = 128, stretch: int = 0) -> int:
    """Largest divisor of the batch <= target, the kernels' BatchNorm group
    (JAX ``training.trainer._pick_block``). ``b <= target`` keeps ghost BN
    equal to exact batch BN. ``stretch > 0`` also considers divisors in
    ``(target, target + stretch]`` and takes one that needs fewer groups:
    the trainer's one-shot step uses ``pick_block(b, 64, 8)``, 69 at b = 138."""
    if b <= target:
        return b
    bt = b
    for cand in range(target, 0, -1):
        if b % cand == 0:
            bt = cand
            break
    for cand in range(target + stretch, target, -1):
        if b % cand == 0 and b // cand < b // bt:
            return cand
    return bt


def check_envelope(flow) -> None:
    """Raise ValueError for a flow outside the fused kernels' envelope (the
    JAX checks, pallas_train.py:867-878)."""
    cfg = flow.cfg
    if cfg.n_levels != 1 or cfg.squeeze_factor != 1:
        raise ValueError("fused path supports single-level unsqueezed flows")
    if tuple(flow.x_shape) != (H, W, C):
        raise ValueError(f"fused path requires x_shape {(H, W, C)}")
    if getattr(cfg, "coupling_nn", "conv") == "dense":
        raise ValueError("fused path supports only the conv coupling template")
    if cfg.width > C:
        raise ValueError(f"fused path supports coupling width <= {C}")
    kinds = {s.kind for s in flow.specs} - set(SCALE_KINDS)
    if not kinds <= SUPPORTED_KINDS:
        raise ValueError(f"unsupported layer kinds {kinds - SUPPORTED_KINDS}")


# ---------------------------------------------------------------------------
# differentiable fold
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=4)
def _ind_taps_np(h: int, w: int) -> np.ndarray:
    """[9, h, w]: where each 3x3 tap of a VALID conv over the edge-padded
    input reads the indicator channel (1 on the padded border)."""
    ind = np.pad(np.zeros((h, w), np.float32), 1, constant_values=1.0)
    return np.stack([ind[di:di + h, dj:dj + w] for di in range(3) for dj in range(3)])


def _pad_last(t, n: int, value: float = 0.0):
    return F.pad(t, (0, n - t.shape[-1]), value=value)


def fold_couplings(layers, fold_bn: bool = False):
    """Coupling layers -> (rec [nc, REC], offs [nc, 32, 32, 4]), in
    differentiable PyTorch. With ``fold_bn`` the running BatchNorm statistics
    fold into w1/b1 and w2/b2 (the eval kernel's records)."""
    nc = len(layers)
    p = [l.nn for l in layers]
    width = p[0].l1_w.shape[-1]
    dev = p[0].l1_w.device
    w1 = torch.stack([q.l1_w for q in p])                        # [nc,3,3,2,wd]
    b1 = torch.stack([q.l1_b.reshape(-1) for q in p])            # [nc,wd]
    w2 = torch.stack([q.l2_w[0, 0] for q in p])                  # [nc,wd,wd]
    b2 = torch.stack([q.l2_b.reshape(-1) for q in p])
    if fold_bn:
        s1 = torch.rsqrt(torch.stack([q.bn1.var for q in p]) + BN_EPS)
        s2 = torch.rsqrt(torch.stack([q.bn2.var for q in p]) + BN_EPS)
        w1 = w1 * s1[:, None, None, None, :]
        b1 = (b1 - torch.stack([q.bn1.mean for q in p])) * s1
        w2 = w2 * s2[:, None, :]
        b2 = (b2 - torch.stack([q.bn2.mean for q in p])) * s2
    zs = torch.exp(torch.stack([q.last.logs.reshape(-1) for q in p]) * LOGSCALE_FACTOR)
    wz = torch.stack([q.last.w for q in p])                      # [nc,3,3,wd+1,4]
    w3 = wz[:, :, :, :width, :] * zs[:, None, None, None, :]
    wind = wz[:, :, :, width, :] * zs[:, None, None, :]          # [nc,3,3,4]
    bz = torch.stack([q.last.b.reshape(-1) for q in p]) * zs     # [nc,4]
    taps = device_constant(("ind_taps", H, W), dev, lambda: _ind_taps_np(H, W))
    offs = torch.einsum("thw,nto->nhwo", taps, wind.reshape(nc, 9, C)) + bz[:, None, None, :]
    rescale = torch.stack([l.rescale.reshape(1) for l in layers])  # [nc,1]
    w3 = F.pad(w3, (0, 0, 0, C - width))
    rec = torch.cat([
        _pad_last(w1, C).reshape(nc, 72), _pad_last(b1, C),
        _pad_last(F.pad(w2, (0, 0, 0, C - width)), C).reshape(nc, 16), _pad_last(b2, C),
        w3.reshape(nc, 144), wind.reshape(nc, 36), bz, rescale,
        torch.zeros((nc, REC - 281), dtype=rescale.dtype, device=dev)], 1)
    return rec.contiguous(), offs.contiguous()


def fold_mixes(specs, layers, device):
    """Mix layers -> (mixes [nm, 4, 4] (``A``), summed log-det * H * W)."""
    eye = torch.eye(C, dtype=torch.float32, device=device)
    if not specs:
        return eye[None], torch.zeros((), device=device)
    if all(s.kind == "conv1x1" for s in specs) and all(l.decomp == "LU" for l in layers):
        # one stacked build: A = P L U, log|det| = sum(log_s)
        il, jl = tri_index(C, False, device)
        iu, ju = tri_index(C, True, device)
        nm = len(layers)
        log_s = torch.stack([l.mat.log_s for l in layers])
        lm = torch.zeros((nm, C, C), device=device)
        um = torch.zeros((nm, C, C), device=device)
        lm[:, il, jl] = torch.stack([l.mat.l_vec for l in layers])
        um[:, iu, ju] = torch.stack([l.mat.u_vec for l in layers])
        sign_s = torch.stack([l.frozen.sign_s for l in layers])
        a = torch.stack([l.frozen.p for l in layers]) @ (
            (lm + eye) @ (um + torch.diag_embed(sign_s * torch.exp(log_s))))
        return a.contiguous(), torch.sum(log_s) * (H * W)
    mats, logdet = [], torch.zeros((), device=device)
    for s, l in zip(specs, layers):
        if s.kind == "perm_reverse":
            mats.append(torch.flip(eye, dims=(0,)))
        else:
            m = l.built()
            mats.append(m["A"])
            logdet = logdet + m["log_abs_det"] * (H * W)
    return torch.stack(mats).contiguous(), logdet


def _ops_code(ops) -> List[int]:
    return [_CODE[kind] << 8 | idx for kind, idx in ops]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------

def _ghost_bn(h, bt: int):
    """Normalise with two-pass biased moments of each group of bt patches;
    returns (normalised, group means and variances averaged over groups)."""
    b = h.shape[0]
    g = h.reshape(b // bt, bt, H * W, h.shape[-1])
    m = g.mean(dim=(1, 2), keepdim=True)
    v = ((g - m) ** 2).mean(dim=(1, 2), keepdim=True)
    n = ((g - m) * torch.rsqrt(v + BN_EPS)).reshape(h.shape)
    return n, m.mean(dim=(0, 1, 2)).detach(), v.mean(dim=(0, 1, 2)).detach()


def _bf16_cmean(v, bt: int):
    """JAX's bfloat16 ``cmean`` over each group of bt patches: the sum of
    each lane (column, channel) over the group's rows, rounded to bfloat16,
    then the W lanes of a channel summed in float32, times 1/n ->
    [B / bt, 1, 1, 1, C] (v grouped as [B / bt, bt, H, W, C])."""
    lanes = bf16_round(v.sum(dim=(1, 2)))
    return (lanes.sum(dim=1) * (1.0 / (bt * H * W)))[:, None, None, None, :]


class _BF16GhostBN(torch.autograd.Function):
    """Ghost BN in the bfloat16 mode: the moments by ``_bf16_cmean``; the
    backward is JAX's ``bn_bwd``, inv_s * (gn - cmean(gn) - n * cmean(gn *
    n)), with the same cmean. apply(h, bt) -> (n, mean, var), the moments
    averaged over groups and not differentiable."""

    @staticmethod
    def forward(ctx, h, bt):
        g = h.reshape(h.shape[0] // bt, bt, H, W, h.shape[-1])
        m = _bf16_cmean(g, bt)
        d = g - m
        v = _bf16_cmean(d * d, bt)
        inv = torch.rsqrt(v + BN_EPS)
        n = d * inv
        ctx.save_for_backward(n, inv)
        ctx.bt = bt
        mean, var = m.mean(dim=(0, 1, 2, 3)), v.mean(dim=(0, 1, 2, 3))
        ctx.mark_non_differentiable(mean, var)
        return n.reshape(h.shape), mean, var

    @staticmethod
    def backward(ctx, gn, _gm, _gv):
        n, inv = ctx.saved_tensors
        g = gn.reshape(n.shape)
        gh = inv * (g - _bf16_cmean(g, ctx.bt) - n * _bf16_cmean(g * n, ctx.bt))
        return gh.reshape(gn.shape), None


class _BF16MM(torch.autograd.Function):
    """a @ b (b [4, 4]: a mix or conv2) as JAX's bfloat16 ``mm``: a and b
    rounded; backward g @ b.T with g and b rounded, a.T @ g with a and g."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = bf16_round(a), bf16_round(b)
        ctx.save_for_backward(ar, br)
        return ar @ br

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = bf16_round(g)
        return gr @ br.T, ar.reshape(-1, ar.shape[-1]).T @ gr.reshape(-1, gr.shape[-1])


class _BF16Conv(torch.autograd.Function):
    """conv2d_nhwc(x, w) (3x3, SAME) as JAX's bfloat16 band matmuls: x and
    w rounded; backward the data and weight gradients of the same conv from
    the rounded cotangent, on the rounded x and w."""

    @staticmethod
    def forward(ctx, x, w):
        xr, wr = bf16_round(x), bf16_round(w)
        ctx.save_for_backward(xr, wr)
        return conv2d_nhwc(xr, wr)

    @staticmethod
    def backward(ctx, g):
        xr, wr = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            return torch.autograd.grad(conv2d_nhwc(xr, wr), (xr, wr), bf16_round(g))


def _ops(mm_dtype):
    """(conv, mm, ghost_bn) of the plain versions in mm_dtype."""
    if is_bf16(mm_dtype):
        return _BF16Conv.apply, _BF16MM.apply, _BF16GhostBN.apply
    return conv2d_nhwc, torch.matmul, _ghost_bn


def _coupling_train(x, r, off, bt: int, ops):
    conv, mm, bn = ops
    h = conv(x[..., :2], _field(r, "w1")) + _field(r, "b1")
    n1, m1, v1 = bn(h, bt)
    h = mm(torch.relu(n1), _field(r, "w2")) + _field(r, "b2")
    n2, m2, v2 = bn(h, bt)
    t = conv(torch.relu(n2), _field(r, "w3")) + off
    ls = _field(r, "rescale") * torch.tanh(t[..., 2:])
    x = torch.cat([x[..., :2], x[..., 2:] * torch.exp(ls) + t[..., :2]], -1)
    return x, ls.sum(dim=(1, 2, 3)), torch.stack([m1, v1, m2, v2])


def train_step_reference(x, clean, sa, sb, rec, offs, mixes, ops_code,
                         bt: int, mm_dtype="float32") -> Dict[str, torch.Tensor]:
    """Plain version of the step kernel: the same ghost-BN chain in plain
    ops, differentiated by ``torch.autograd.grad`` of
    ``mean(-(ldj + logp(z)))``. Returns the kernel's outputs: ``rows``
    [B, 3] (ldj, sum z, sum z^2), ``bnmom`` [nc, 4, 4] (m1, v1, m2, v2
    averaged over groups), and the gradients ``grad_rec``, ``grad_offs``,
    ``grad_mixes``, ``gsa``, ``gsb`` (the b1/b2 entries are autograd's
    near-zeros, where the kernel gives exact zeros). ``mm_dtype`` as in the
    module docstring."""
    b = x.shape[0]
    ops = _ops(mm_dtype)
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (rec, offs, mixes, sa, sb)]
        rec_, offs_, mix_, sa_, sb_ = leaves
        z = x
        ldj = x.new_zeros((b,))
        moms = []
        for code in ops_code:
            kind, idx = code >> 8, code & 255
            if kind == OP_MIX:
                z = ops[1](z, mix_[idx])
            elif kind == OP_SCALE:
                z = z / torch.sqrt(sa_[:, idx].reshape(-1, 1, 1, 1) * clean
                                   + sb_[:, idx].reshape(-1, 1, 1, 1))
            else:
                z, l, mom = _coupling_train(z, rec_[idx], offs_[idx], bt, ops)
                ldj = ldj + l
                moms.append(mom)
        zs = z.sum(dim=(1, 2, 3))
        z2 = (z * z).sum(dim=(1, 2, 3))
        logp = -0.5 * (H * W * C * math.log(2.0 * math.pi) + z2)
        knll = torch.mean(-(ldj + logp))
        grads = torch.autograd.grad(knll, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves)]
    bnmom = torch.stack(moms) if moms else x.new_zeros((rec.shape[0], 4, C))
    return {"rows": torch.stack([ldj, zs, z2], 1).detach(), "bnmom": bnmom,
            "grad_rec": grads[0], "grad_offs": grads[1], "grad_mixes": grads[2],
            "gsa": grads[3], "gsb": grads[4]}


@torch.no_grad()
def segment_forward_reference(x, rec, offs, mixes, ops_code, mm_dtype="float32", bnrun=None):
    """Plain version of the segment kernel: running-statistics forward of
    one segment -> (z, ldj [B]), with BN folded into ``rec`` (``bnrun``
    None), or from records without it and ``bnrun`` [nc, 4, 4], the running
    mean1, var1, mean2, var2 of each coupling, applied after each conv (the
    bfloat16 mode's form, as JAX's)."""
    conv, mm, _ = _ops(mm_dtype)

    def bn(h, idx, j):
        if bnrun is None:
            return h
        return (h - bnrun[idx, j]) * torch.rsqrt(bnrun[idx, j + 1] + BN_EPS)
    z = x
    ldj = x.new_zeros((x.shape[0],))
    for code in ops_code:
        kind, idx = code >> 8, code & 255
        if kind == OP_MIX:
            z = mm(z, mixes[idx])
            continue
        r = rec[idx]
        h = torch.relu(bn(conv(z[..., :2], _field(r, "w1")) + _field(r, "b1"), idx, 0))
        h = torch.relu(bn(mm(h, _field(r, "w2")) + _field(r, "b2"), idx, 2))
        t = conv(h, _field(r, "w3")) + offs[idx]
        ls = _field(r, "rescale") * torch.tanh(t[..., 2:])
        z = torch.cat([z[..., :2], z[..., 2:] * torch.exp(ls) + t[..., :2]], -1)
        ldj = ldj + ls.sum(dim=(1, 2, 3))
    return z, ldj


def _segment_train_chain(x, rec, offs, mixes, ops_code, bt: int, mm_dtype):
    ops = _ops(mm_dtype)
    z = x
    ldj = x.new_zeros((x.shape[0],))
    moms = []
    for code in ops_code:
        kind, idx = code >> 8, code & 255
        if kind == OP_MIX:
            z = ops[1](z, mixes[idx])
        else:
            z, l, mom = _coupling_train(z, rec[idx], offs[idx], bt, ops)
            ldj = ldj + l
            moms.append(mom)
    bnmom = torch.stack(moms) if moms else x.new_zeros((rec.shape[0], 4, C))
    return z, ldj, bnmom


@torch.no_grad()
def segment_train_forward_reference(x, rec, offs, mixes, ops_code, bt: int,
                                    mm_dtype="float32"):
    """Plain version of the ghost-BN segment kernel: one segment's forward
    with BN over groups of bt patches, from un-folded records -> (z, ldj [B],
    bnmom [nc, 4, 4]: m1, v1, m2, v2 of each coupling averaged over groups)."""
    return _segment_train_chain(x, rec, offs, mixes, ops_code, bt, mm_dtype)


def segment_backward_reference(x, rec, offs, mixes, ops_code, bt: int, gz, gldj,
                               mm_dtype="float32"):
    """Plain version of the segment backward kernel: ``torch.autograd.grad``
    of the ghost-BN forward against the cotangents gz [B,32,32,4] and gldj
    [B] -> (gx, grad_rec, grad_offs, grad_mixes). The b1/b2 entries of
    grad_rec are autograd's near-zeros, where the kernel gives exact zeros.
    In bfloat16 the backward rounds where JAX's does (module docstring)."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, rec, offs, mixes)]
        z, ldj, _ = _segment_train_chain(*leaves, ops_code, bt, mm_dtype)
        grads = torch.autograd.grad((z, ldj), leaves, (gz, gldj), allow_unused=True)
    return tuple(torch.zeros_like(t) if g is None else g for g, t in zip(grads, leaves))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _same_device(*ts):
    if len({t.device for t in ts}) != 1:
        raise ValueError("fused_train inputs lie on different devices")


def _scratch(lib, mode: int, b: int, bt: int, nc: int, nm: int, n_ops: int, dev):
    """The train kernel's scratch for one launch in ``mode``: (float4
    scratch, partial sums and moments, per-patch weight gradients), sized by
    the library's ``nf_train_scratch``. The kernel writes every entry it
    reads: nothing is zeroed."""
    sizes = (ctypes.c_longlong * 3)()
    if lib.nf_train_scratch(mode, b, bt, nc, nm, n_ops, sizes):
        raise ValueError(f"bad sizes: batch {b}, bt {bt}")
    return tuple(torch.empty(n, dtype=torch.float32, device=dev) for n in sizes)


def _ops_array(ops_code):
    return (ctypes.c_int * max(len(ops_code), 1))(*ops_code)


def _launch(name: str, entry, dev, bf16: bool, *args) -> None:
    """Call the C entry ``entry`` with ``args`` and the mode, then the
    current stream of ``dev`` and the launch count it sets; count its
    launches as ``name`` (and ``name + "_bf16"`` in the bfloat16 mode) with
    ``count_launches``: under stream capture they are recorded into the
    graph, and count at each replay. Raise if the launch failed."""
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = entry(*args, int(bf16), torch.cuda.current_stream(dev).cuda_stream,
                    ctypes.byref(launched))
        count_launches(name, launched.value)
        if bf16:
            count_launches(name + "_bf16", launched.value)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")


def _check_segment(x, rec, offs, mixes, ops_code, bt=None):
    b, nc, nm = x.shape[0], rec.shape[0], mixes.shape[0]
    _check("x", x, (b, H, W, C))
    _check("rec", rec, (nc, REC))
    _check("offs", offs, (nc, H, W, C))
    _check("mixes", mixes, (nm, C, C))
    _same_device(x, rec, offs, mixes)
    if len(ops_code) > MAX_OPS or any(c >> 8 == OP_SCALE for c in ops_code):
        raise ValueError("a segment holds at most 64 mix and coupling ops")
    if bt is not None and (not 1 <= bt <= b or b % bt):
        raise ValueError(f"bad sizes: batch {b}, bt {bt}")
    return b, nc, nm


def _launch_step(x, clean, sa, sb, rec, offs, mixes, ops_code, bt, ldj_seed, bf16):
    from noise_flow_tpu_torch.ops._build import load_library

    b, ns, nc, nm = x.shape[0], sa.shape[1], rec.shape[0], mixes.shape[0]
    _check("x", x, (b, H, W, C))
    _check("clean", clean, (b, H, W, C))
    _check("sa", sa, (b, ns))
    _check("sb", sb, (b, ns))
    _check("rec", rec, (nc, REC))
    _check("offs", offs, (nc, H, W, C))
    _check("mixes", mixes, (nm, C, C))
    _same_device(x, clean, sa, sb, rec, offs, mixes)
    if not 1 <= bt <= b or b % bt or len(ops_code) > MAX_OPS:
        raise ValueError(f"bad sizes: batch {b}, bt {bt}, {len(ops_code)} ops")
    lib = load_library("fused_train")
    scratch_f4, scratch_f, wpart = _scratch(lib, _STEP, b, bt, nc, nm, len(ops_code), x.device)
    empty = functools.partial(torch.empty, dtype=torch.float32, device=x.device)
    zeros = functools.partial(torch.zeros, dtype=torch.float32, device=x.device)
    out = {"rows": empty((b, 3)), "gsa": zeros((b, ns)), "gsb": zeros((b, ns)),
           "grad_w": empty((nc * REC + nm * C * C,)), "grad_offs": empty((nc, H, W, C)),
           "bnmom": empty((nc, 4, C))}
    _launch("fused_train_step", lib.nf_train_step, x.device, bf16,
            x.data_ptr(), clean.data_ptr(), sa.data_ptr(), sb.data_ptr(),
            rec.data_ptr(), offs.data_ptr(), mixes.data_ptr(), scratch_f4.data_ptr(),
            scratch_f.data_ptr(), wpart.data_ptr(), out["rows"].data_ptr(),
            out["gsa"].data_ptr(), out["gsb"].data_ptr(), out["grad_w"].data_ptr(),
            out["grad_offs"].data_ptr(), out["bnmom"].data_ptr(), b, bt, ns, nc, nm,
            1.0 / b, -1.0 / b if ldj_seed is None else ldj_seed, _ops_array(ops_code),
            len(ops_code))
    gw = out.pop("grad_w")
    out["grad_rec"] = gw[:nc * REC].view(nc, REC)
    out["grad_mixes"] = gw[nc * REC:].view(nm, C, C)
    return out


def fused_train_step(x, clean, sa, sb, rec, offs, mixes, ops_code, bt: int,
                     ldj_seed=None, mm_dtype="float32") -> Dict[str, torch.Tensor]:
    """One mean-NLL forward and backward over x [B,32,32,4] with BN groups of
    bt, in ``mm_dtype``. CUDA tensors go through the step kernel (or raise);
    CPU tensors through ``train_step_reference``. Returns the outputs
    described there. ``ldj_seed`` replaces the ldj seed -1/B (kernel only; to
    plant a fault)."""
    bf16 = is_bf16(mm_dtype)
    if x.device.type == "cpu" and ldj_seed is None:
        return train_step_reference(x, clean, sa, sb, rec, offs, mixes, ops_code, bt, mm_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_train_step runs on CUDA or CPU tensors (ldj_seed: CUDA "
                         f"only), got {x.device}")
    return _launch_step(x, clean, sa, sb, rec, offs, mixes, ops_code, bt, ldj_seed, bf16)


def segment_occupancy(device="cuda", mm_dtype="float32") -> int:
    """CTAs an SM of the running-statistics forward kernel on a CUDA device
    (``nf_segment_occupancy``, the occupancy API): a batch of up to that
    many times the SMs patches runs in one wave."""
    from noise_flow_tpu_torch.ops._build import load_library

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"segment_occupancy reads a CUDA device, got {device}")
    n = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = load_library("fused_train").nf_segment_occupancy(int(is_bf16(mm_dtype)),
                                                               ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"nf_segment_occupancy failed: CUDA error {err}")
    return n.value


def _check_eval(x, rec, offs, mixes, ops_code, bnrun):
    b, nc, nm = _check_segment(x, rec, offs, mixes, ops_code)
    if bnrun is not None:
        _check("bnrun", bnrun, (nc, 4, C))
        _same_device(x, bnrun)
    if nm > MAX_OPS:
        raise ValueError(f"a segment holds at most {MAX_OPS} mixes, got {nm}")
    return b, nc, nm


def _launch_segment(x, rec, offs, mixes, ops_code, bf16, bnrun):
    from noise_flow_tpu_torch.ops._build import load_library

    b, nc, nm = _check_eval(x, rec, offs, mixes, ops_code, bnrun)
    lib = load_library("fused_train")
    z = torch.empty_like(x)
    ldj = torch.empty((b,), dtype=torch.float32, device=x.device)
    _launch("fused_segment_forward", lib.nf_segment_forward, x.device, bf16,
            x.data_ptr(), z.data_ptr(), ldj.data_ptr(), rec.data_ptr(), offs.data_ptr(),
            mixes.data_ptr(), None if bnrun is None else bnrun.data_ptr(), b, nc, nm,
            _ops_array(ops_code), len(ops_code))
    return z, ldj


def fused_segment_forward(x, rec, offs, mixes, ops_code, mm_dtype="float32", bnrun=None):
    """Running-statistics forward of one segment: x [B,32,32,4] -> (z, ldj),
    ``rec`` and ``bnrun`` as in ``segment_forward_reference``. CUDA tensors
    go through the kernel (or raise), one launch; CPU tensors through
    ``segment_forward_reference``."""
    bf16 = is_bf16(mm_dtype)
    if x.device.type == "cpu":
        return segment_forward_reference(x, rec, offs, mixes, ops_code, mm_dtype, bnrun)
    if x.device.type != "cuda":
        raise ValueError(f"fused_segment_forward runs on CUDA or CPU tensors, got {x.device}")
    return _launch_segment(x, rec, offs, mixes, ops_code, bf16, bnrun)


def fused_segment_train_forward(x, rec, offs, mixes, ops_code, bt: int, mm_dtype="float32"):
    """Ghost-BN forward of one segment: x [B,32,32,4] -> (z, ldj [B], bnmom
    [nc, 4, 4]), BN over groups of bt, in ``mm_dtype``. CUDA tensors go
    through the kernel (or raise); CPU tensors through
    ``segment_train_forward_reference``."""
    bf16 = is_bf16(mm_dtype)
    if x.device.type == "cpu":
        return segment_train_forward_reference(x, rec, offs, mixes, ops_code, bt, mm_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_segment_train_forward runs on CUDA or CPU tensors, "
                         f"got {x.device}")
    from noise_flow_tpu_torch.ops._build import load_library

    b, nc, nm = _check_segment(x, rec, offs, mixes, ops_code, bt)
    lib = load_library("fused_train")
    scratch_f4, scratch_f, _ = _scratch(lib, _SEG_FWD, b, bt, nc, nm, len(ops_code), x.device)
    z = torch.empty_like(x)
    rows = torch.empty((b, 3), dtype=torch.float32, device=x.device)
    bnmom = torch.empty((nc, 4, C), dtype=torch.float32, device=x.device)
    _launch("fused_segment_train_forward", lib.nf_segment_train_forward, x.device, bf16,
            x.data_ptr(), z.data_ptr(), rows.data_ptr(), bnmom.data_ptr(), rec.data_ptr(),
            offs.data_ptr(), mixes.data_ptr(), scratch_f4.data_ptr(), scratch_f.data_ptr(),
            b, bt, nc, nm, _ops_array(ops_code), len(ops_code))
    return z, rows[:, 0], bnmom


def fused_segment_backward(x, rec, offs, mixes, ops_code, bt: int, gz, gldj,
                           mm_dtype="float32"):
    """Backward of ``fused_segment_train_forward`` from the cotangents gz
    [B,32,32,4] and gldj [B] -> (gx, grad_rec, grad_offs, grad_mixes); the
    kernel recomputes the forward. CUDA tensors go through the kernel (or
    raise; b1/b2 of grad_rec exactly zero); CPU tensors through
    ``segment_backward_reference``."""
    bf16 = is_bf16(mm_dtype)
    if x.device.type == "cpu":
        return segment_backward_reference(x, rec, offs, mixes, ops_code, bt, gz, gldj,
                                          mm_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"fused_segment_backward runs on CUDA or CPU tensors, got {x.device}")
    from noise_flow_tpu_torch.ops._build import load_library

    b, nc, nm = _check_segment(x, rec, offs, mixes, ops_code, bt)
    _check("gz", gz, (b, H, W, C))
    _check("gldj", gldj, (b,))
    _same_device(x, gz, gldj)
    lib = load_library("fused_train")
    scratch_f4, scratch_f, wpart = _scratch(lib, _SEG_BWD, b, bt, nc, nm, len(ops_code),
                                            x.device)
    gx = torch.empty_like(x)
    grad_w = torch.empty((nc * REC + nm * C * C,), dtype=torch.float32, device=x.device)
    goffs = torch.empty((nc, H, W, C), dtype=torch.float32, device=x.device)
    _launch("fused_segment_backward", lib.nf_segment_backward, x.device, bf16,
            x.data_ptr(), gz.data_ptr(), gldj.data_ptr(), rec.data_ptr(), offs.data_ptr(),
            mixes.data_ptr(), scratch_f4.data_ptr(), scratch_f.data_ptr(), wpart.data_ptr(),
            gx.data_ptr(), grad_w.data_ptr(), goffs.data_ptr(), b, bt, nc, nm,
            _ops_array(ops_code), len(ops_code))
    return gx, grad_w[:nc * REC].view(nc, REC), goffs, grad_w[nc * REC:].view(nm, C, C)


# the segment path's (forward, backward): the kernels, or their plain versions
SEGMENT_KERNELS = (fused_segment_train_forward, fused_segment_backward)
SEGMENT_PLAIN = (segment_train_forward_reference, segment_backward_reference)


# ---------------------------------------------------------------------------
# the segment path
# ---------------------------------------------------------------------------

def _zero_bn_biases(grad_rec) -> None:
    """Write exact zeros into the b1/b2 entries of a records' gradient, in
    place: the conv biases that feed a BatchNorm, whose mean BN removes, as
    JAX's one-shot and segment paths give them (its ``b1s``/``b2s``
    cotangents are zeros). The kernels already write zeros there; the plain
    versions leave autograd's near-zeros, which Adam would turn into
    lr-sized steps of the biases and so shift the running means."""
    for name in ("b1", "b2"):
        off, shape = _REC_LAYOUT[name]
        grad_rec[:, off:off + shape[0]] = 0.0


class SegmentFn(torch.autograd.Function):
    """One segment of the segment path as an autograd function, the
    counterpart of the JAX ``make_segment_fn`` custom_vjp.

    apply(x, rec, offs, mixes, ops_code, bt, fns, mm_dtype="float32") -> (z,
    ldj [B], bnmom [nc, 4, 4]), bnmom not differentiable. ``fns`` is
    (forward, backward):
    ``SEGMENT_KERNELS``, or ``SEGMENT_PLAIN`` to run the plain versions on any
    device. Only the inputs are saved; the backward recomputes the forward
    and takes any cotangents (gz, gldj); a cotangent that autograd does not
    supply arrives as zeros (materialised grads). The b1/b2 entries of the
    records' gradient are exact zeros, as in JAX (BN removes the mean)."""

    @staticmethod
    def forward(ctx, x, rec, offs, mixes, ops_code, bt, fns, mm_dtype="float32"):
        z, ldj, bnmom = fns[0](x, rec, offs, mixes, ops_code, bt, mm_dtype=mm_dtype)
        ctx.save_for_backward(x, rec, offs, mixes)
        ctx.ops_code, ctx.bt, ctx.bwd, ctx.mm_dtype = ops_code, bt, fns[1], mm_dtype
        ctx.mark_non_differentiable(bnmom)
        return z, ldj, bnmom

    @staticmethod
    def backward(ctx, gz, gldj, _g_bn):
        x, rec, offs, mixes = ctx.saved_tensors
        gx, grad_rec, grad_offs, grad_mixes = ctx.bwd(
            x, rec, offs, mixes, ctx.ops_code, ctx.bt, gz.contiguous(), gldj.contiguous(),
            mm_dtype=ctx.mm_dtype)
        _zero_bn_biases(grad_rec)
        return gx, grad_rec, grad_offs, grad_mixes, None, None, None, None


# ---------------------------------------------------------------------------
# the one-shot train step
# ---------------------------------------------------------------------------

class FusedNLL(torch.autograd.Function):
    """The step kernel as an autograd function, valid ONLY for the mean-NLL
    loss: forward launches the kernel, which also computes every gradient
    from the analytic seeds ``g = z/B`` and ``g_ldj = -1/B``; backward
    returns those gradients times ``grad_output`` (the PyTorch form of the
    one-shot trick). Any other use of z or ldj would need the segment path's
    backward kernel.

    apply(rec, offs, mixes, sa, sb, x, clean, ops_code, bt, step_fn, mm_dtype)
    -> (mean(-(ldj + logp(z))), sd_z, bnmom); the last two are not
    differentiable. ``step_fn`` is ``fused_train_step``, or
    ``train_step_reference`` to run the plain version on any device (the
    on-card comparison does)."""

    @staticmethod
    def forward(ctx, rec, offs, mixes, sa, sb, x, clean, ops_code, bt, step_fn, mm_dtype):
        out = step_fn(x, clean, sa, sb, rec, offs, mixes, ops_code, bt, mm_dtype=mm_dtype)
        _zero_bn_biases(out["grad_rec"])
        ctx.save_for_backward(out["grad_rec"], out["grad_offs"], out["grad_mixes"],
                              out["gsa"], out["gsb"])
        ldj, zs, z2 = out["rows"].unbind(1)
        n = H * W * C
        logp = -0.5 * (n * math.log(2.0 * math.pi) + z2)
        knll = torch.mean(-(ldj + logp))
        var_z = z2 / n - (zs / n) ** 2
        sd_z = torch.mean(torch.sqrt(torch.clamp(var_z, min=0.0)))
        bnmom = out["bnmom"]
        ctx.mark_non_differentiable(sd_z, bnmom)
        return knll, sd_z, bnmom

    @staticmethod
    def backward(ctx, g, _g_sd, _g_bn):
        return tuple(t * g for t in ctx.saved_tensors) + (None,) * 6


def _bn_state(flow, coup_idx, bnmom):
    """New running statistics of the couplings at spec indices coup_idx from
    their group moments averaged over groups, keyed as the flow's buffers."""
    new = {}
    wd = flow.cfg.width
    for ci, i in enumerate(coup_idx):
        nn_ = flow.layers[i].nn
        for j, (bn, k) in enumerate((("bn1", "mean"), ("bn1", "var"),
                                     ("bn2", "mean"), ("bn2", "var"))):
            old = getattr(getattr(nn_, bn), k)
            new[f"layers.{i}.nn.{bn}.{k}"] = (old - BN_DECAY * (old - bnmom[ci, j, :wd])).detach()
    return new


class _Fused:
    """Envelope check and plan shared by FusedTrainStep and FusedFlow."""

    def __init__(self, flow, bt: int, mm_dtype: str):
        check_envelope(flow)
        is_bf16(mm_dtype)
        self.flow = flow
        self.bt = bt
        self.mm_dtype = mm_dtype

    def _cond4(self, cond, batch: int):
        dev = self.flow.device
        out = {}
        for k in ("nlf0", "nlf1", "iso", "cam"):
            if cond.get(k) is not None:
                out[k] = torch.as_tensor(cond[k], dtype=torch.float32, device=dev).reshape(-1)
        if cond.get("clean") is not None:
            out["clean"] = torch.as_tensor(cond["clean"], dtype=torch.float32,
                                           device=dev).reshape(batch, H, W, C)
        return out


class FusedTrainStep(_Fused):
    """One-kernel loss and gradients over a NoiseFlow (ghost BN).

    ``loss(x, cond)`` -> (nll, sd_z, new_state), nll differentiable with
    respect to the flow's parameters through ``FusedNLL`` and the fold;
    ``loss_and_grad(x, cond)`` -> (nll, sd_z, new_state, grads) with grads
    keyed as ``named_parameters``. ``new_state`` is keyed as the flow's
    ``state_dict`` buffers. Semantics match ``jax.value_and_grad`` of the
    JAX ``FusedFlow.loss`` in train mode, as the JAX ``FusedTrainStep``.
    Envelope: single-level 32x32x4 flows of couplings, 1x1 mixes and at most
    ``MAX_SCALE`` scale layers. ``mm_dtype``: "float32" or "bfloat16"."""

    MAX_SCALE = 4

    def __init__(self, flow, bt: int = 64, mm_dtype: str = "float32"):
        super().__init__(flow, bt, mm_dtype)
        ops, self.scale_idx, self.mix_idx, self.coup_idx = [], [], [], []
        for i, s in enumerate(flow.specs):
            if s.kind in SCALE_KINDS:
                ops.append(("scale", len(self.scale_idx)))
                self.scale_idx.append(i)
            elif s.kind == "coupling":
                ops.append(("coup", len(self.coup_idx)))
                self.coup_idx.append(i)
            else:
                ops.append(("mix", len(self.mix_idx)))
                self.mix_idx.append(i)
        if len(self.scale_idx) > self.MAX_SCALE:
            raise ValueError(f"the one-shot step takes at most {self.MAX_SCALE} scale "
                             f"layers; more train through the segment path (FusedFlow)")
        if not self.coup_idx:
            raise ValueError("fused path needs at least one coupling")
        self.ops = tuple(ops)
        self.ops_code = _ops_code(ops)
        self.ns_pad = max(len(self.scale_idx), 1)

    def fold(self):
        """(rec, offs, mixes, mix_logdet), differentiable."""
        flow = self.flow
        rec, offs = fold_couplings([flow.layers[i] for i in self.coup_idx])
        mixes, mix_logdet = fold_mixes([flow.specs[i] for i in self.mix_idx],
                                       [flow.layers[i] for i in self.mix_idx], flow.device)
        return rec, offs, mixes, mix_logdet

    def _prep(self, cond, batch: int):
        """Per-example (a, b) [B, ns_pad] of the scale layers and their
        summed log-dets [B], differentiable."""
        flow, dev = self.flow, self.flow.device
        shared = flow.shared_view()
        cond4 = self._cond4(cond, batch)
        cond01 = {k: torch.cat([v, v]) if v.numel() == batch else v
                  for k, v in cond4.items() if k != "clean"}
        cond01["clean"] = torch.cat([torch.zeros((batch, 1, 1, 1), device=dev),
                                     torch.ones((batch, 1, 1, 1), device=dev)])
        ones2 = torch.ones((2 * batch, 1, 1, 1), device=dev)
        dummy = torch.ones((batch, H, W, C), device=dev)
        sa_cols, sb_cols = [], []
        ildj = torch.zeros((batch,), device=dev)
        for i in self.scale_idx:
            layer = flow.layers[i]
            s01, _ = layer.forward(ones2, cond01, False, shared)
            s01 = (s01 * s01).expand(2 * batch, 1, 1, 1).reshape(2 * batch, -1)[:, :1]
            b = s01[:batch]
            sa_cols.append(s01[batch:] - b)
            sb_cols.append(b)
            ildj = ildj + layer.inverse(dummy, cond4, True, shared)[1]
        pad = self.ns_pad - len(sa_cols)
        sa = torch.cat(sa_cols + [torch.zeros((batch, 1), device=dev)] * pad, 1)
        sb = torch.cat(sb_cols + [torch.ones((batch, 1), device=dev)] * pad, 1)
        return sa.contiguous(), sb.contiguous(), ildj

    def loss(self, x, cond, step_fn=fused_train_step):
        """(nll, sd_z, new_state); ``step_fn`` as in ``FusedNLL``."""
        batch = x.shape[0]
        if batch % self.bt:
            raise ValueError(f"batch {batch} not a multiple of bt {self.bt}")
        x = x.reshape(batch, H, W, C).float().contiguous()
        clean = cond.get("clean")
        clean = (torch.zeros_like(x) if clean is None
                 else torch.as_tensor(clean, dtype=torch.float32, device=x.device)
                 .reshape(batch, H, W, C).contiguous())
        with annotate("nf.step.fold"):
            rec, offs, mixes, mix_logdet = self.fold()
        with annotate("nf.step.prep"):
            sa, sb, ildj = self._prep(cond, batch)
        with annotate("nf.step.kernel"):
            knll, sd_z, bnmom = FusedNLL.apply(rec, offs, mixes, sa, sb, x, clean,
                                               self.ops_code, self.bt, step_fn, self.mm_dtype)
        nll = knll - mix_logdet - torch.mean(ildj)
        return nll, sd_z, _bn_state(self.flow, self.coup_idx, bnmom)

    def loss_and_grad(self, x, cond, step_fn=fused_train_step):
        """(nll, sd_z, new_state, grads) for the mean-NLL objective."""
        params = dict(self.flow.named_parameters())
        nll, sd_z, new_state = self.loss(x, cond, step_fn)
        grads = torch.autograd.grad(nll, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        return nll.detach(), sd_z, new_state, grads


class FusedFlow(_Fused):
    """Fused path over a NoiseFlow: ``loss(x, cond, train)`` mirrors
    ``NoiseFlow.loss`` with each [mix, coupling]* segment through a kernel
    and the scale layers in PyTorch. ``train=False`` (eval) runs the
    running-statistics forward kernel: in float32 with the running
    statistics folded into the records, in bfloat16 with them applied after
    each conv (``running_moments``). ``train=True`` is the segment path, as
    the JAX ``FusedFlow``: each segment through ``SegmentFn`` with BN over
    groups of ``bt`` patches, differentiable with respect to the flow's
    parameters; the state it returns holds the new running statistics.
    ``mm_dtype``: "float32" or "bfloat16"."""

    def __init__(self, flow, bt: int = 64, mm_dtype: str = "float32"):
        super().__init__(flow, bt, mm_dtype)
        self.plan: List = []  # ("scale", spec_idx) | ("segment", Segment, lo, hi)
        specs = flow.specs
        i = 0
        while i < len(specs):
            if specs[i].kind in SCALE_KINDS:
                self.plan.append(("scale", i))
                i += 1
                continue
            lo, ops, nm, nc = i, [], 0, 0
            while i < len(specs) and specs[i].kind not in SCALE_KINDS:
                if specs[i].kind == "coupling":
                    ops.append(("coup", nc))
                    nc += 1
                else:
                    ops.append(("mix", nm))
                    nm += 1
                i += 1
            self.plan.append(("segment", Segment(tuple(ops), nm, nc), lo, i))

    def fold_segment(self, lo: int, hi: int, fold_bn: bool):
        """(rec, offs, mixes, mix_logdet) of the segment of specs [lo, hi),
        differentiable; with ``fold_bn`` the eval kernel's records."""
        flow = self.flow
        idx = range(lo, hi)
        coups = [flow.layers[i] for i in idx if flow.specs[i].kind == "coupling"]
        mix_i = [i for i in idx if flow.specs[i].kind != "coupling"]
        dev = flow.device
        if coups:
            rec, offs = fold_couplings(coups, fold_bn=fold_bn)
        else:
            rec = torch.zeros((1, REC), device=dev)
            offs = torch.zeros((1, H, W, C), device=dev)
        mixes, mix_logdet = fold_mixes([flow.specs[i] for i in mix_i],
                                       [flow.layers[i] for i in mix_i], dev)
        return rec, offs, mixes, mix_logdet

    def running_moments(self, lo: int, hi: int):
        """[nc, 4, 4]: the running mean1, var1, mean2, var2 of each coupling
        of the segment of specs [lo, hi) (the eval kernel's ``bnrun``; dead
        channels of a narrower coupling have mean 0 and variance 1, as
        JAX's ``bnrun``)."""
        flow = self.flow
        rows = [torch.stack([_pad_last(q.bn1.mean, C), _pad_last(q.bn1.var, C, 1.0),
                             _pad_last(q.bn2.mean, C), _pad_last(q.bn2.var, C, 1.0)])
                for q in (flow.layers[i].nn for i in range(lo, hi)
                          if flow.specs[i].kind == "coupling")]
        if not rows:   # kept on the device: a captured eval step copies nothing
            return device_constant("bnrun_none", flow.device,
                                   lambda: np.array([[[0.0] * C, [1.0] * C] * 2], np.float32))
        return torch.stack(rows).contiguous()

    def inverse(self, x, cond, train: bool, seg_fns=SEGMENT_KERNELS):
        """data -> latent: (z, objective [B], state). Eval: no gradients,
        and the state is the couplings' running statistics, unchanged. Train:
        ``seg_fns`` as ``fns`` of ``SegmentFn``; the state is the new running
        statistics (``old - BN_DECAY * (old - group moments)``)."""
        flow = self.flow
        batch = x.shape[0]
        if train and batch % self.bt:
            raise ValueError(f"batch {batch} not a multiple of bt {self.bt}")
        shared = flow.shared_view()
        cond4 = self._cond4(cond, batch)
        state = {}
        with torch.set_grad_enabled(train and torch.is_grad_enabled()):
            z = x.reshape(batch, H, W, C).float()
            obj = z.new_zeros((batch,))
            for item in self.plan:
                if item[0] == "scale":
                    z, ildj = flow.layers[item[1]].inverse(z, cond4, train, shared)
                    obj = obj + ildj
                    continue
                _, seg, lo, hi = item
                bf16 = is_bf16(self.mm_dtype)
                rec, offs, mixes, mix_logdet = self.fold_segment(
                    lo, hi, fold_bn=not (train or bf16))
                code = _ops_code(seg.ops)
                if train:
                    z, ldj, bnmom = SegmentFn.apply(z.contiguous(), rec, offs, mixes, code,
                                                    self.bt, seg_fns, self.mm_dtype)
                    state.update(_bn_state(flow, [i for i in range(lo, hi)
                                                  if flow.specs[i].kind == "coupling"], bnmom))
                else:
                    bnrun = self.running_moments(lo, hi) if bf16 else None
                    z, ldj = fused_segment_forward(z.contiguous(), rec, offs, mixes, code,
                                                   self.mm_dtype, bnrun)
                obj = obj + ldj + mix_logdet
        if not train:
            state = {k: v for k, v in flow.state_dict().items() if ".bn" in k}
        return z, obj, state

    def loss(self, x, cond, train: bool = False, seg_fns=SEGMENT_KERNELS):
        """(mean NLL, sd_z, state), as ``NoiseFlow.loss``; the NLL is
        differentiable in train mode."""
        c = cond if self.flow._is_cond else {"clean": None}
        z, obj, state = self.inverse(x, c, train, seg_fns)
        n = H * W * C
        logp = -0.5 * (n * math.log(2.0 * math.pi) + torch.sum(z * z, dim=(1, 2, 3)))
        nll = -(obj + logp)
        with torch.no_grad():
            var_z = torch.var(z.reshape(z.shape[0], -1), dim=1, unbiased=False)
            sd_z = torch.mean(torch.sqrt(var_z))
        return torch.mean(nll), sd_z, state
