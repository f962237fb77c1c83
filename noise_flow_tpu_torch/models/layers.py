"""Bijector layers as ``nn.Module``s.

Port of noise_flow_tpu.models.layers (ref:borealisflows/layers.py and
ref:borealisflows/noise_flow_layers/*.py). Every layer holds its parameters
and state in the JAX package's tree layout (HWIO conv weights, the same key
names), so a parameter's ``state_dict`` key is its JAX key path with the
level index dropped. Each layer has

    inverse(y, cond, train, shared) -> (x, ildj[B])   data -> latent
    forward(x, cond, train, shared) -> (y, fldj[B])   latent -> data

``cond`` is a dict {'clean':[B,H,W,C], 'nlf0','nlf1','iso','cam': [B]}.
``shared`` is the flow's shared view {'sdn_gain': ParamTree, 'c_i': float,
'psum': the sum over data-parallel ranks or None}. With ``train=True``
BatchNorm normalises with batch moments, over every rank's rows where
``shared['psum']`` is set (``ops.nn.batch_moments``). A layer with
BatchNorm (the couplings, condY/condYG/condXY/condXYG and the ``batch_norm``
bijector) changes none of its buffers: given a dict ``state_out`` it puts
its new running statistics there, keyed as its ``state_dict`` buffers
(``nn.bn1.mean``, ``nn.bn0.var``, ``bn.mean``, ...),
``s - 0.1 * (s - batch_stat)`` in train mode and the current values
otherwise, as the JAX layers return their new state.

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
- condYG and condXYG condition their ISO-affine convs on the batch's first
  ISO, ``iso[0]`` (ref:borealisflows/layers.py:633).
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
from noise_flow_tpu_torch.ops.nn import (
    BN_DECAY,
    batch_moments,
    batch_norm_init,
    conv2d_nhwc,
    coupling_mlp_apply,
    coupling_mlp_init,
    coupling_nn_apply,
    coupling_nn_init,
    coupling_nn_iso_apply,
    coupling_nn_iso_init,
)


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
# affine couplings: the unconditional one (ref:borealisflows/layers.py:251-375)
# with the conv or the dense template, and the ones driven by the clean image
# (condY / condXY families, ref:noise_flow_model.py:275-279)
# ---------------------------------------------------------------------------

class _AffineCoupling(Layer):
    """x = y * exp(ls) + shift on the coupled channels (all of them, or the
    second half), where the network reads ``_net_input`` and
    ``ls = rescale * tanh(log_scale)``; the ldj reduces over (H, W, C)."""

    halves = True

    def __init__(self, nn_p, nn_s):
        super().__init__({"nn": nn_p, "rescale": np.float32(1e-4)}, {"nn": nn_s})

    def _net_input(self, y0, cond):
        return y0

    def _apply_nn(self, inp, cond, train, psum):
        return coupling_nn_apply(self.nn, self.nn, inp, train, psum)

    def net(self, y0, cond, train, psum=None, state_out=None):
        shift, log_scale, new = self._apply_nn(self._net_input(y0, cond), cond, train, psum)
        if state_out is not None:
            for bn, st in new.items():
                for k, v in st.items():
                    state_out[f"nn.{bn}.{k}"] = v.detach()
        return shift, self.rescale * torch.tanh(log_scale)

    def _split(self, y):
        if not self.halves:
            return y[..., :0], y
        c = y.shape[-1]
        return y[..., : c // 2], y[..., c // 2:]

    def inverse(self, y, cond, train, shared, state_out=None):
        y0, y1 = self._split(y)
        shift, ls = self.net(y0, cond, train, shared.get("psum"), state_out)
        return torch.cat([y0, y1 * torch.exp(ls) + shift], -1), _sum_hwc(ls)

    def forward(self, x, cond, train, shared):
        x0, x1 = self._split(x)
        shift, ls = self.net(x0, cond, train, shared.get("psum"))
        return torch.cat([x0, (x1 - shift) * torch.exp(-ls)], -1), -_sum_hwc(ls)


class Coupling(_AffineCoupling):
    kind = "coupling"

    def __init__(self, x_shape, cfg, rng: np.random.Generator):
        c = x_shape[-1]
        super().__init__(*coupling_nn_init(rng, c // 2, cfg.width, 2 * (c - c // 2)))


class DenseCoupling(_AffineCoupling):
    """The coupling with the dense-MLP template
    (ref:borealisflows/layers.py:404-449, real_nvp_default_template), chosen
    by ``cfg.coupling_nn == 'dense'``."""

    kind = "coupling"

    def __init__(self, x_shape, cfg, rng: np.random.Generator):
        h, w, c = x_shape
        super().__init__(*coupling_mlp_init(rng, (h, w, c // 2), tuple(cfg.hidden_layers)))

    def _apply_nn(self, inp, cond, train, psum):
        return coupling_mlp_apply(self.nn, self.nn, inp, train, psum)


def _iso0(cond, y):
    """The batch's first ISO (ref:borealisflows/layers.py:633)."""
    return torch.as_tensor(cond["iso"], dtype=torch.float32, device=y.device).reshape(-1)[0]


class CondY(_AffineCoupling):
    """The whole tensor, shifted and scaled by a network of the clean image
    (C in, 2C out)."""

    kind = "condY"
    halves = False

    _init = staticmethod(coupling_nn_init)

    def __init__(self, x_shape, cfg, rng: np.random.Generator):
        c = x_shape[-1]
        super().__init__(*self._init(rng, c, cfg.width, 2 * c))

    def _net_input(self, y0, cond):
        return cond["clean"]


class CondYG(CondY):
    """condY with the ISO-affine conv template."""

    kind = "condYG"
    _init = staticmethod(coupling_nn_iso_init)

    def _apply_nn(self, inp, cond, train, psum):
        return coupling_nn_iso_apply(self.nn, self.nn, inp, _iso0(cond, inp), train, psum)


class CondXY(_AffineCoupling):
    """The second half, shifted and scaled by a network of
    ``concat(first half, clean)`` (C/2 + C in)."""

    kind = "condXY"

    _init = staticmethod(coupling_nn_init)

    def __init__(self, x_shape, cfg, rng: np.random.Generator):
        c = x_shape[-1]
        super().__init__(*self._init(rng, c // 2 + c, cfg.width, 2 * (c - c // 2)))

    def _net_input(self, y0, cond):
        return torch.cat([y0, cond["clean"]], -1)


class CondXYG(CondXY):
    """condXY with the ISO-affine conv template."""

    kind = "condXYG"
    _init = staticmethod(coupling_nn_iso_init)

    def _apply_nn(self, inp, cond, train, psum):
        return coupling_nn_iso_apply(self.nn, self.nn, inp, _iso0(cond, inp), train, psum)


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
# BatchNorm bijector + LeakyReLU bijector (ref:borealisflows/layers.py:149-247
# and 26-71; the arch DSL builds neither)
# ---------------------------------------------------------------------------

class BatchNormBijector(Layer):
    """x = (y - m) / sqrt(v + 1e-4) with batch moments in train mode and the
    running ones otherwise; ildj = sum_c -0.5 log(v + 1e-4) * H * W for
    every example. ``forward`` always uses the running moments."""

    kind = "batch_norm"
    eps = 1e-4

    def __init__(self, x_shape):
        super().__init__({}, {"bn": batch_norm_init(x_shape[-1])})

    def _ldj(self, v, y):
        ildj = torch.sum(-0.5 * torch.log(v + self.eps)) * (y.shape[1] * y.shape[2])
        return ildj.expand(y.shape[0])

    def inverse(self, y, cond, train, shared, state_out=None):
        mean, var = self.bn.mean, self.bn.var
        if train:
            m, v = batch_moments(y, (0, 1, 2), shared.get("psum"))
            new = {"mean": mean - BN_DECAY * (mean - m), "var": var - BN_DECAY * (var - v)}
        else:
            m, v = mean, var
            new = {"mean": mean, "var": var}
        if state_out is not None:
            state_out.update({f"bn.{k}": t.detach() for k, t in new.items()})
        return (y - m) * torch.rsqrt(v + self.eps), self._ldj(v, y)

    def forward(self, x, cond, train, shared):
        v = self.bn.var
        return x * torch.sqrt(v + self.eps) + self.bn.mean, -self._ldj(v, x)


class LeakyReLU(Layer):
    """Slope ``|alpha|`` on the negative side; the ldj sums log|slope| over
    (H, W, C)."""

    kind = "leaky_relu"

    def __init__(self):
        super().__init__({"alpha": np.float32(1.0)})

    def inverse(self, y, cond, train, shared, state_out=None):
        alpha = torch.abs(self.alpha)
        pos = y >= 0
        j = torch.where(pos, torch.ones_like(y), alpha * torch.ones_like(y))
        return torch.where(pos, y, alpha * y), _sum_hwc(torch.log(torch.abs(j)))

    def forward(self, x, cond, train, shared):
        alpha = torch.abs(self.alpha)
        pos = x >= 0
        j = torch.where(pos, torch.ones_like(x), torch.ones_like(x) / alpha)
        return torch.where(pos, x, x / alpha), _sum_hwc(torch.log(torch.abs(j)))


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_COND_COUPLINGS = {"condY": CondY, "condYG": CondYG, "condXY": CondXY, "condXYG": CondXYG}


def make_layer(kind: str, x_shape, cfg, rng: np.random.Generator) -> Layer:
    """Build the layer module of one spec, initialised from ``rng``."""
    if kind == "perm_reverse":
        return PermReverse()
    if kind == "conv1x1":
        return Conv1x1(x_shape, cfg, rng)
    if kind == "coupling":
        if getattr(cfg, "coupling_nn", "conv") == "dense":
            return DenseCoupling(x_shape, cfg, rng)
        return Coupling(x_shape, cfg, rng)
    if kind in SCALE_KINDS:
        return ScaleLayer(kind, cfg)
    if kind in _COND_COUPLINGS:
        return _COND_COUPLINGS[kind](x_shape, cfg, rng)
    if kind == "batch_norm":
        return BatchNormBijector(x_shape)
    if kind == "leaky_relu":
        return LeakyReLU()
    raise ValueError(f"unknown layer kind {kind!r}")


SHARED_SDN_GAIN_KINDS = ("sdn4", "sdn5", "sdn6", "gain4")
# kinds that read cond["clean"] elementwise against the latent
CLEAN_KINDS = ("sdn", "sdn1", "sdn2", "sdn3", "sdn4", "sdn5", "sdn6", "fitSDN",
               "fitSDN2", "condSDN") + tuple(_COND_COUPLINGS)
