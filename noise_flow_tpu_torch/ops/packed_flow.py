"""Packed (lane-major) NLL path: the flow's data -> latent pass as 128-lane
matrix products.

Port of noise_flow_tpu.ops.packed_flow. A 32x32x4 patch is packed as
[32, 128] (lane = w * 4 + c); every conv of the coupling network becomes a
product with a banded [128, 128] matrix built from its weights
(``band_from_conv``, linear in them), so autograd gives the backward pass
through the bands to the conv weights, as ``jax.grad`` does in JAX. The
products are plain ``torch.matmul`` (JAX runs them outside any Pallas
kernel too). The path is the packed layout's reference semantics; the
port's fused train kernel (``ops.fused_train``) folds the weights itself and
does not use it.

Semantics are those of ``models.layers`` (coupling: ref:borealisflows/
layers.py:251-375; 1x1 conv: ref:layers.py:74-145; the scale family:
ref:noise_flow_layers/*.py). The scale-only conditional layers run as they
are on a [B, 1, 32, 128] view of the packed tensor (the same elements, the
same reductions).

Envelope (JAX's): single-level unsqueezed flows over (32, 32, 4) patches
with the conv coupling template, width <= 4, and layer kinds in
``SUPPORTED_KINDS``; ``PackedFlow`` raises ``ValueError`` for anything
else, and the caller takes the NHWC path.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from noise_flow_tpu_torch.ops.gaussian import diag_gaussian_logp
from noise_flow_tpu_torch.ops.nn import BN_DECAY, BN_EPS, LOGSCALE_FACTOR, conv_zeros_apply

H = 32
C = 4
W = 32
L = W * C  # 128 lanes

# the scale-only kinds of the fused sampler's envelope (JAX
# ops/pallas_sample.py:55-59)
SUPPORTED_SCALE_KINDS = (
    "sdn", "sdn1", "sdn2", "sdn3", "sdn4", "sdn5", "sdn6",
    "gain", "gain1", "gain2", "gain3", "gain4", "fitSDN", "fitSDN2",
    "condSDN",
)
SUPPORTED_KINDS = frozenset({"coupling", "conv1x1", "perm_reverse"} | set(SUPPORTED_SCALE_KINDS))

# lane permutation of a channel reverse (tfb.Permute) in packed coords
_PERM_REV_IDX = np.arange(L).reshape(W, C)[:, ::-1].reshape(L).copy()
# W-tap selector for band_from_conv: S[dw, wi, wo] = 1 iff input col wi feeds
# output col wo under kernel tap dw (SAME padding), i.e. wi = wo + dw - 1
_TAP_SEL = {kw: np.stack([np.eye(W, k=(kw - 1) // 2 - dw) for dw in range(kw)]).astype(np.float32)
            for kw in (1, 3)}


def pack(x):
    """[B, H, W, C] -> [B, H, W*C] (a reshape; lane = w*C + c), numpy or torch."""
    return x.reshape(x.shape[0], H, L)


def _shift_h(x, dh: int):
    """x: [B, 32, 128]; row r of the result is x[r + dh], zero past the edge
    (JAX ops/pallas_sample.py:348)."""
    if dh == 0:
        return x
    z = torch.zeros_like(x[:, :1])
    if dh == -1:
        return torch.cat([z, x[:, :-1]], dim=1)
    return torch.cat([x[:, 1:], z], dim=1)


def _lane(v, width: int):
    """Per-channel vector [width] -> lane vector [L] (zero-padded to C)."""
    return F.pad(v.reshape(-1), (0, C - width)).repeat(W)


def band_from_conv(w: torch.Tensor) -> torch.Tensor:
    """w: [kh, kw, cin, cout] (cin, cout <= C) -> [kh, L, L] band matrices such
    that ``sum_dh shift_h(x, dh - 1) @ band[dh]`` is the SAME conv in packed
    layout: out[dh, wi*C+ci, wo*C+co] = sum_dw S[dw, wi, wo] w[dh, dw, ci, co].
    Linear in w, so gradients flow back to the conv weights."""
    kh, kw, cin, cout = w.shape
    wp = F.pad(w, (0, C - cout, 0, C - cin))
    sel = torch.as_tensor(_TAP_SEL[kw], device=w.device, dtype=w.dtype)
    return torch.einsum("kab,hkio->haibo", sel, wp).reshape(kh, L, L)


def _bn_packed(h, mean, var, train: bool, width: int):
    """BatchNorm over packed activations; the channel moments of ops.nn
    (biased, over (B, H, W)); the running update s - decay (s - m)."""
    if train:
        m_c = h.mean(dim=(0, 1)).reshape(W, C).mean(0)
        m_lane = m_c.repeat(W)
        v_c = ((h - m_lane) ** 2).mean(dim=(0, 1)).reshape(W, C).mean(0)
        new = {"mean": mean - BN_DECAY * (mean - m_c[:width]),
               "var": var - BN_DECAY * (var - v_c[:width])}
        v_lane = v_c.repeat(W)
    else:
        new = {"mean": mean, "var": var}
        m_lane = _lane(mean, width)
        # var padded with 1.0 so that dead lanes normalise 0 -> 0
        v_lane = F.pad(var, (0, C - width), value=1.0).repeat(W)
    return (h - m_lane) * torch.rsqrt(v_lane + BN_EPS), new


@contextlib.contextmanager
def _tf32(allow: bool):
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = allow
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class _Matmul(torch.autograd.Function):
    """a @ b with TF32 allowed or not in both directions."""

    @staticmethod
    def forward(ctx, a, b, tf32: bool):
        ctx.save_for_backward(a, b)
        ctx.tf32 = tf32
        with _tf32(tf32):
            return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with _tf32(ctx.tf32):
            return g @ b.T, a.T @ g, None


class PackedFlow:
    """Packed NLL path over a port ``NoiseFlow`` (the training direction),
    with the flow's own parameters and BatchNorm buffers.

    ``precision``: ``"highest"`` takes every product in float32 with TF32
    off (JAX's ``Precision.HIGHEST``); anything else is JAX's
    ``Precision.DEFAULT``, which on the card means TF32 products (operands
    rounded to 10-bit mantissas, float32 accumulation) in the forward and
    the backward pass. The CPU has no TF32: both are float32 there.

    Raises ValueError when the flow's arch or shape is outside the envelope.
    """

    def __init__(self, flow, precision: str = "highest"):
        cfg = flow.cfg
        if flow.n_levels != 1 or cfg.squeeze_factor != 1:
            raise ValueError("packed path supports single-level unsqueezed flows")
        if tuple(flow.x_shape) != (H, W, C):
            raise ValueError(f"packed path requires x_shape {(H, W, C)}")
        if getattr(cfg, "coupling_nn", "conv") == "dense":
            raise ValueError("packed path supports only the conv coupling template")
        if cfg.width > C:
            raise ValueError(f"packed path supports coupling width <= {C}")
        kinds = {s.kind for s in flow.specs}
        if not kinds <= SUPPORTED_KINDS:
            raise ValueError(f"unsupported layer kinds {kinds - SUPPORTED_KINDS}")
        self.flow = flow
        self.cfg = cfg
        self.specs = flow.specs
        self.width = cfg.width
        self.tf32 = precision != "highest"
        self._keep = torch.as_tensor((np.arange(L) % C) < (C // 2))  # uncoupled {0, 1}
        self._perm = torch.as_tensor(_PERM_REV_IDX)

    # ------------------------------------------------------------- helpers
    def _mm(self, a, b):
        return _Matmul.apply(a, b, self.tf32)

    def _conv3_packed(self, x, bands, bias_lane):
        """SAME 3x3 conv as 3 banded products; x [B,H,L] -> [B,H,L]."""
        b = x.shape[0]
        h = self._mm(x.reshape(b * H, L), bands[1])
        h = h + self._mm(_shift_h(x, -1).reshape(b * H, L), bands[0])
        h = h + self._mm(_shift_h(x, 1).reshape(b * H, L), bands[2])
        return h.reshape(b, H, L) + bias_lane

    def _coupling_inverse(self, layer, y, train: bool):
        """data -> latent on packed tiles, as the coupling layer's inverse:
        x1 = y1 exp(ls) + shift, ildj = sum of ls over the coupled lanes."""
        width, nn = self.width, layer.nn
        h = self._conv3_packed(y, band_from_conv(nn.l1_w), _lane(nn.l1_b, width))
        h, bn1 = _bn_packed(h, nn.bn1.mean, nn.bn1.var, train, width)
        h = torch.relu(h)
        b = y.shape[0]
        h = (self._mm(h.reshape(b * H, L), band_from_conv(nn.l2_w)[0]).reshape(b, H, L)
             + _lane(nn.l2_b, width))
        h, bn2 = _bn_packed(h, nn.bn2.mean, nn.bn2.var, train, width)
        h = torch.relu(h)
        # zero-conv: an x-dependent band (logs-scaled) and an x-independent
        # edge/bias offset map (conv_zeros on zeros, indicator channel included)
        last = nn.last
        logs_scale = torch.exp(last.logs.reshape(-1) * LOGSCALE_FACTOR)
        t = self._conv3_packed(h, band_from_conv(last.w[:, :, :width, :] * logs_scale), 0.0)
        off = conv_zeros_apply(last, y.new_zeros((1, H, W, width)))
        t = t + off.reshape(1, H, L)
        # lanes {0,1} of a pixel: the shift of channels {2,3}; lanes {2,3}:
        # their log-scale (n_out = [shift(2), log_scale(2)])
        ls = layer.rescale * torch.tanh(t)
        shift = torch.roll(t, 2, dims=-1)  # the shift moved to the coupled lanes
        keep = self._keep.to(y.device)
        x = torch.where(keep, y, y * torch.exp(ls) + shift)
        ildj = torch.sum(torch.where(keep, torch.zeros_like(ls), ls), dim=(1, 2))
        new = {f"nn.{bn}.{k}": v.detach() for bn, st in (("bn1", bn1), ("bn2", bn2))
               for k, v in st.items()}
        return x, ildj, new

    def _conv1x1_inverse(self, layer, y):
        m = layer.built()
        big = torch.kron(torch.eye(W, dtype=y.dtype, device=y.device), m["A"])
        b = y.shape[0]
        x = self._mm(y.reshape(b * H, L), big).reshape(b, H, L)
        return x, (m["log_abs_det"] * (H * W)).expand(b)

    # -------------------------------------------------------------- public
    def inverse(self, xp, cond, train: bool):
        """xp: packed [B, H, 128]; cond['clean'] packed likewise. Returns
        (z, objective[B], new_state), as ``NoiseFlow.inverse`` on NHWC; the
        new state holds the couplings' BatchNorm statistics, keyed as the
        flow's ``state_dict`` buffers."""
        shared = self.flow.shared_view()
        z = xp
        obj = xp.new_zeros((xp.shape[0],))
        new_state: Dict[str, torch.Tensor] = {}
        cond4 = dict(cond)
        if cond.get("clean") is not None:
            cond4["clean"] = cond["clean"][:, None]  # [B,1,H,L]: rank 4 for the layers
        for i, (s, layer) in enumerate(zip(self.specs, self.flow.layers)):
            if s.kind == "coupling":
                z, ildj, new = self._coupling_inverse(layer, z, train)
                new_state.update({f"layers.{i}.{k}": v for k, v in new.items()})
            elif s.kind == "conv1x1":
                z, ildj = self._conv1x1_inverse(layer, z)
            elif s.kind == "perm_reverse":
                z, ildj = z[..., self._perm.to(z.device)], 0.0
            else:  # a scale-only conditional layer on a [B,1,H,L] view
                z4, ildj = layer.inverse(z[:, None], cond4, train, shared)
                z = z4[:, 0]
            obj = obj + ildj
        return z, obj, new_state

    def loss(self, xp, cond, train: bool):
        """(mean NLL [nats/patch], sd_z, new_state): the packed twin of
        ``NoiseFlow.loss`` (ref:borealisflows/noise_flow_model.py:458-484)."""
        c = cond if self.flow._is_cond else {"clean": None}
        z, obj, new_state = self.inverse(xp, c, train)
        nll = -(obj + diag_gaussian_logp(z))
        var_z = torch.var(z.reshape(z.shape[0], -1), dim=1, unbiased=False)
        return torch.mean(nll), torch.mean(torch.sqrt(var_z)), new_state

    def nll_per_sample(self, xp, cond, train: bool = False):
        c = cond if self.flow._is_cond else {"clean": None}
        z, obj, _ = self.inverse(xp, c, train)
        return -(obj + diag_gaussian_logp(z))
