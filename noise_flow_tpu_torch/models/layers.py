"""Bijector layers as ``nn.Module``s.

Port of noise_flow_tpu.models.layers (ref:borealisflows/layers.py and
ref:borealisflows/noise_flow_layers/*.py). Every layer holds its parameters
and state in the JAX package's tree layout (HWIO conv weights, the same key
names), so a parameter's ``state_dict`` key is its JAX key path with the
level index dropped. Each layer has

    inverse(y, cond, train, shared) -> (x, ildj[B])   data -> latent
    forward(x, cond, train, shared) -> (y, fldj[B])   latent -> data

``cond`` is a dict {'clean':[B,H,W,C], 'nlf0','nlf1','iso','cam': [B]}.
``shared`` is the flow's shared view {'sdn_gain': ParamTree, 'c_i': float}.
With ``train=True`` BatchNorm normalises with batch moments. A layer with
BatchNorm (the coupling) changes none of its buffers: given a dict
``state_out`` it puts its new running statistics there, keyed as its
``state_dict`` buffers (``nn.bn1.mean``, ...), ``s - 0.1 * (s - batch_stat)``
in train mode and the current values otherwise, as the JAX layers return
their new state.

Faithfulness quirks preserved (they change NLL numbers):
- gain/gain1/gain2/gain3 log-dets carry NO pixel-count factor
  (ref:noise_flow_layers/AffineCouplingGain.py:86,96), while sdn-family
  layers reduce over (H,W,C).
- gain4 DOES include the pixel factor (ref:AffineCouplingGainEx4.py:92,97).
- gain2 takes the well-formed per-example scalar ldj of its gain siblings
  (the reference's is ill-formed, ref:AffineCouplingGainEx2.py:87).
- sdn4/5/6 and gain4 share trainables through the 'sdn_gain' group.
- every conditional layer owns a (mostly unused) ``rescale`` trainable
  initialized to 1e-4 (ref:AffineCouplingSdnEx5.py:44-46).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np
import torch
from torch import nn

from noise_flow_tpu_torch.models import cond_params as cp
from noise_flow_tpu_torch.ops.conv1x1 import (
    matrix_param_build,
    matrix_param_init,
    orthogonal_init,
)
from noise_flow_tpu_torch.ops.nn import conv2d_nhwc, coupling_nn_apply, coupling_nn_init

# Layer kinds of the JAX package that this port does not run yet.
_NOT_PORTED = ("condY", "condYG", "condXY", "condXYG", "batch_norm", "leaky_relu")
_NOT_PORTED_ITEM = "ROADMAP.md queue 1, 'Remaining layer kinds'"


class ParamTree(nn.Module):
    """Nested parameters (trainable) and buffers (state), keyed as in the JAX
    trees. Nested dicts become child ``ParamTree``s; ``t["k"]`` is ``t.k``."""

    def __init__(self, params: Optional[Dict] = None,
                 state: Optional[Dict] = None):
        super().__init__()
        params, state = params or {}, state or {}
        for k in list(params) + [k for k in state if k not in params]:
            pv, sv = params.get(k), state.get(k)
            if isinstance(pv, dict) or isinstance(sv, dict):
                self.add_module(k, ParamTree(pv, sv))
            elif k in params:
                self.register_parameter(k, nn.Parameter(_f32(pv)))
            else:
                self.register_buffer(k, _f32(sv))

    def __getitem__(self, k):
        return getattr(self, k)

    def __contains__(self, k):
        return k in self._parameters or k in self._buffers or k in self._modules


def _f32(v) -> torch.Tensor:
    return torch.as_tensor(np.asarray(v, np.float32))


def _bb(x):
    return x.reshape(-1, 1, 1, 1)


def _sum_hwc(t):
    return torch.sum(t, dim=(1, 2, 3))


class Layer(ParamTree):
    kind = ""

    def inverse(self, y, cond, train: bool, shared, state_out=None):
        raise NotImplementedError

    def forward(self, x, cond, train: bool, shared):
        raise NotImplementedError


# ---------------------------------------------------------------------------
# permutation: channel reverse (tfb.Permute, ref:noise_flow_model.py:82-84)
# ---------------------------------------------------------------------------

class PermReverse(Layer):
    kind = "perm_reverse"

    def inverse(self, y, cond, train, shared, state_out=None):
        return torch.flip(y, dims=(-1,)), y.new_zeros((y.shape[0],))

    def forward(self, x, cond, train, shared):
        return torch.flip(x, dims=(-1,)), x.new_zeros((x.shape[0],))


# ---------------------------------------------------------------------------
# invertible 1x1 conv (ref:borealisflows/layers.py:74-145)
# ---------------------------------------------------------------------------

class Conv1x1(Layer):
    kind = "conv1x1"

    def __init__(self, x_shape, cfg, rng: np.random.Generator):
        mp = matrix_param_init(cfg.decomp, orthogonal_init(rng, x_shape[-1]))
        super().__init__({"mat": mp["trainable"]}, {"frozen": mp["frozen"]})
        self.decomp = cfg.decomp

    def built(self):
        return matrix_param_build(self.decomp, {"trainable": self.mat,
                                                "frozen": self.frozen})

    def _mix(self, x, key, sign):
        m = self.built()
        y = conv2d_nhwc(x, m[key].reshape(1, 1, *m[key].shape))
        ldj = sign * m["log_abs_det"] * (x.shape[1] * x.shape[2])
        return y, ldj.expand(x.shape[0])

    def inverse(self, y, cond, train, shared, state_out=None):
        return self._mix(y, "A", 1.0)

    def forward(self, x, cond, train, shared):
        return self._mix(x, "A_inv", -1.0)


# ---------------------------------------------------------------------------
# unconditional affine coupling (ref:borealisflows/layers.py:251-375)
# ---------------------------------------------------------------------------

class Coupling(Layer):
    kind = "coupling"

    def __init__(self, x_shape, cfg, rng: np.random.Generator):
        c = x_shape[-1]
        nn_p, nn_s = coupling_nn_init(rng, c // 2, cfg.width, 2 * (c - c // 2))
        super().__init__({"nn": nn_p, "rescale": np.float32(1e-4)},
                         {"nn": nn_s})

    def net(self, x0, train, state_out=None):
        shift, log_scale, new = coupling_nn_apply(self.nn, self.nn, x0, train)
        if state_out is not None:
            for bn, st in new.items():
                for k, v in st.items():
                    state_out[f"nn.{bn}.{k}"] = v.detach()
        return shift, self.rescale * torch.tanh(log_scale)

    def inverse(self, y, cond, train, shared, state_out=None):
        c = y.shape[-1]
        y0, y1 = y[..., : c // 2], y[..., c // 2:]
        shift, ls = self.net(y0, train, state_out)
        return torch.cat([y0, y1 * torch.exp(ls) + shift], -1), _sum_hwc(ls)

    def forward(self, x, cond, train, shared):
        c = x.shape[-1]
        x0, x1 = x[..., : c // 2], x[..., c // 2:]
        shift, ls = self.net(x0, train)
        return torch.cat([x0, (x1 - shift) * torch.exp(-ls)], -1), -_sum_hwc(ls)


# ---------------------------------------------------------------------------
# scale-only conditional layers (sdn*, gain*, fitSDN, condSDN)
#
# inverse: x = y / scale, ildj = -sum log scale
# forward: y = x * scale, fldj = +sum log scale
# (ref:AffineCouplingSdnEx5.py:50-132 and siblings)
# ---------------------------------------------------------------------------

def _broadcast_cond(v, b, device):
    """Reference feeds length-1 vectors for iso/cam/nlf; broadcast to [B]."""
    v = torch.as_tensor(v, dtype=torch.float32, device=device).reshape(-1)
    return v.expand(b)


def _iso(cond, y):
    return _broadcast_cond(cond["iso"], y.shape[0], y.device)


def _cam(cond, y):
    return _broadcast_cond(cond["cam"], y.shape[0], y.device)


def _fit_sdn_scale(betas):
    def scale(p, sh, cond, y):
        beta1, beta2 = betas(p, _iso(cond, y))
        return torch.sqrt(_bb(beta1) * cond["clean"] + _bb(beta2))
    return scale


def _cam_sdn_scale(p, sh, cond, y):
    b = y.shape[0]
    return torch.sqrt(cond["clean"] * _bb(_broadcast_cond(cond["nlf0"], b, y.device))
                      + _bb(_broadcast_cond(cond["nlf1"], b, y.device)))


# kind -> (scale_fn(params, shared, cond, y), init_fn(cfg), ldj_mode)
# ldj_mode 'full': reduce log(scale broadcast to y) over (H,W,C);
#          'scalar': per-example log(scale), NO pixel factor.
SCALE_KINDS: Dict[str, tuple] = {
    "sdn": (lambda p, sh, cond, y: cp.sdn_scale(p, cond["clean"]),
            lambda cfg: cp.sdn_init(), "full"),
    "sdn1": (lambda p, sh, cond, y: cp.sdn1_scale(p, cond["clean"], _iso(cond, y)),
             lambda cfg: cp.sdn1_init(), "full"),
    "sdn2": (lambda p, sh, cond, y: cp.sdn2_scale(p, cond["clean"], _iso(cond, y)),
             lambda cfg: cp.sdn2_init(cfg.gain_init), "full"),
    "sdn3": (lambda p, sh, cond, y: cp.sdn3_scale(p, cond["clean"], _iso(cond, y)),
             lambda cfg: cp.sdn3_init(cfg.gain_init), "full"),
    "sdn4": (lambda p, sh, cond, y: cp.sdn4_scale(
        sh["sdn_gain"], cond["clean"], _iso(cond, y), sh["c_i"]),
        lambda cfg: {}, "full"),
    "sdn5": (lambda p, sh, cond, y: cp.sdn5_scale(
        sh["sdn_gain"], cond["clean"], _iso(cond, y), _cam(cond, y), sh["c_i"]),
        lambda cfg: {}, "full"),
    "sdn6": (lambda p, sh, cond, y: cp.sdn6_scale(
        sh["sdn_gain"], cond["clean"], _iso(cond, y), _cam(cond, y), sh["c_i"]),
        lambda cfg: {}, "full"),
    "gain": (lambda p, sh, cond, y: cp.gain_scale(p, _iso(cond, y)),
             lambda cfg: cp.gain_init(), "scalar"),
    "gain1": (lambda p, sh, cond, y: cp.gain1_scale(p, _iso(cond, y)),
              lambda cfg: cp.gain1_init(), "scalar"),
    "gain2": (lambda p, sh, cond, y: cp.gain2_scale(p, _iso(cond, y)),
              lambda cfg: cp.gain2_init(cfg.gain_init), "scalar"),
    "gain3": (lambda p, sh, cond, y: cp.gain3_scale(p, _iso(cond, y)),
              lambda cfg: cp.gain3_init(), "scalar"),
    # gain4: scalar scale but FULL pixel-count ldj via the reference's
    # broadcast trick (ref:AffineCouplingGainEx4.py:84-97).
    "gain4": (lambda p, sh, cond, y: cp.gain4_scale(sh["sdn_gain"]),
              lambda cfg: {}, "full"),
    "fitSDN": (_fit_sdn_scale(cp.sdn_iso3_betas),
               lambda cfg: cp.sdn_iso3_init(), "full"),
    "fitSDN2": (_fit_sdn_scale(cp.sdn_iso2_betas),
                lambda cfg: cp.sdn_iso2_init(), "full"),
    # condSDN: non-trainable camera-NLF baseline (ref:AffineCouplingCamSdn.py:43-124)
    "condSDN": (_cam_sdn_scale, lambda cfg: {}, "full"),
}


class ScaleLayer(Layer):
    def __init__(self, kind: str, cfg):
        scale_fn, init_fn, ldj_mode = SCALE_KINDS[kind]
        super().__init__({**init_fn(cfg), "rescale": np.float32(1e-4)})
        self.kind = kind
        self._scale_fn: Callable = scale_fn
        self.ldj_mode = ldj_mode

    def _ldj(self, scale, y):
        if self.ldj_mode == "full":
            return _sum_hwc(torch.log(scale.expand(y.shape)))
        # 'scalar': scale is [B] or [1]; broadcast per example only
        return torch.log(scale).reshape(-1).expand(y.shape[0])

    def _mul(self, y, scale, sign):
        if scale.ndim != 4:
            scale = _bb(scale.reshape(-1).expand(y.shape[0]))
        return y * scale if sign > 0 else y / scale

    def inverse(self, y, cond, train, shared, state_out=None):
        scale = self._scale_fn(self, shared, cond, y)
        return self._mul(y, scale, -1), -self._ldj(scale, y)

    def forward(self, x, cond, train, shared):
        scale = self._scale_fn(self, shared, cond, x)
        return self._mul(x, scale, 1), self._ldj(scale, x)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

def make_layer(kind: str, x_shape, cfg, rng: np.random.Generator) -> Layer:
    """Build the layer module of one spec, initialised from ``rng``."""
    if kind == "perm_reverse":
        return PermReverse()
    if kind == "conv1x1":
        return Conv1x1(x_shape, cfg, rng)
    if kind == "coupling":
        if getattr(cfg, "coupling_nn", "conv") == "dense":
            raise NotImplementedError(
                "the dense coupling template (coupling_nn='dense') is not "
                f"ported yet: {_NOT_PORTED_ITEM}")
        return Coupling(x_shape, cfg, rng)
    if kind in SCALE_KINDS:
        return ScaleLayer(kind, cfg)
    if kind in _NOT_PORTED:
        raise NotImplementedError(
            f"layer kind {kind!r} is not ported yet: {_NOT_PORTED_ITEM}")
    raise ValueError(f"unknown layer kind {kind!r}")


SHARED_SDN_GAIN_KINDS = ("sdn4", "sdn5", "sdn6", "gain4")
