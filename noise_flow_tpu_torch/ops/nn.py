"""Coupling-network primitives (PyTorch, NHWC activations, HWIO weights).

Port of noise_flow_tpu.ops.nn (ref:borealisflows/layers.py:452-689). The
functions take parameter mappings (a dict of tensors, or a ``ParamTree``
module, which supports ``p["name"]``) so the same weights that JAX holds as
pytrees go through them unchanged. BatchNorm running statistics are
functional state: ``batch_norm_apply`` returns the updated statistics and
changes nothing in place. Under data parallelism the caller passes ``psum``,
a differentiable sum over the ranks that share the batch; the train-mode
moments then span every rank's rows.

A frame sharded by height over ranks (``parallel.spatial``) passes ``halo``
down to every spatial conv: a callable that returns a shard with the row
above and the row below it (zeros past the frame's top and bottom), with
the attributes ``top`` and ``bottom`` true where the shard holds the frame's
first or last row. A conv then pads only its width, and the zero-conv's
edge indicator marks a padded row only at the frame's true top and bottom.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-4
BN_DECAY = 0.1
LOGSCALE_FACTOR = 3.0  # Glow zero-conv trick (ref:borealisflows/layers.py:671-673)


def conv2d_nhwc(x, w, padding: str = "SAME", halo=None):
    """Plain 2D conv, NHWC activations, HWIO weights, stride 1. With
    ``halo`` (and a SAME conv taller than one row) the rows past the shard
    come from the neighbouring shards and only the width is zero-padded."""
    pad = padding.lower()
    if halo is not None and w.shape[0] > 1 and padding == "SAME":
        x, pad = halo(x, w.shape[0] // 2), (0, w.shape[1] // 2)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=pad)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# BatchNorm (functional; ref:borealisflows/layers.py:378-401)
# ---------------------------------------------------------------------------

def batch_norm_init(c: int) -> Dict[str, np.ndarray]:
    return {"mean": np.zeros((c,), np.float32), "var": np.ones((c,), np.float32)}


Psum = Optional[Callable[[torch.Tensor], torch.Tensor]]


def batch_moments(x, dims, psum: Psum = None):
    """Biased mean and variance of ``x`` over ``dims``, two-pass: the mean
    first, then the mean of the squared deviations from it. With ``psum``
    (a differentiable sum over the ranks, ``parallel.mesh.Mesh.psum()``)
    both sums and the element count span every rank's rows, and the
    gradients flow through both sums. The count is a device fill, not a
    copy from the host, so that a CUDA graph can capture it."""
    if psum is None:
        m = x.mean(dim=dims)
        return m, ((x - m) ** 2).mean(dim=dims)
    sums = x.sum(dim=dims)
    count = torch.full((1,), float(math.prod(x.shape[d] for d in dims)), dtype=x.dtype,
                       device=x.device)
    s = psum(torch.cat([sums.reshape(-1), count]))
    m = (s[:-1] / s[-1]).reshape(sums.shape)
    return m, psum(((x - m) ** 2).sum(dim=dims)) / s[-1].detach()


def batch_norm_apply(x, state, train: bool, psum: Psum = None):
    """Normalize; in train mode use batch moments and return updated running
    stats ``s - decay * (s - batch_stat)``.

    The variance is biased and two-pass (mean first, then the mean of the
    squared deviations) over all non-channel axes, and over every rank's
    rows with ``psum`` (``batch_moments``); eps is ``BN_EPS``.
    """
    axes = tuple(range(x.ndim - 1))
    if train:
        m, v = batch_moments(x, axes, psum)
        new_state = {
            "mean": state["mean"] - BN_DECAY * (state["mean"] - m),
            "var": state["var"] - BN_DECAY * (state["var"] - v),
        }
        x_hat = (x - m) * torch.rsqrt(v + BN_EPS)
    else:
        new_state = {"mean": state["mean"], "var": state["var"]}
        x_hat = (x - state["mean"]) * torch.rsqrt(state["var"] + BN_EPS)
    return x_hat, new_state


# ---------------------------------------------------------------------------
# Glow edge padding + zero-init conv (ref:borealisflows/layers.py:555-583,651-674)
# ---------------------------------------------------------------------------

def _edge_pad_with_indicator(x, halo=None):
    """Pad 1px of zeros spatially and append an indicator channel that is 1 on
    the padded border, 0 inside (ref:borealisflows/layers.py:555-583). With
    ``halo`` the rows above and below are the neighbouring shards' (zeros
    past the frame), and the indicator is 1 on them only where they lie
    past the frame's top or bottom."""
    b, h, w, _ = x.shape
    if halo is None:
        xp = F.pad(x, (0, 0, 1, 1, 1, 1))
        top = bottom = True
    else:
        xp = F.pad(halo(x, 1), (0, 0, 1, 1))
        top, bottom = bool(halo.top), bool(halo.bottom)
    ind = torch.zeros((h + 2, w + 2), dtype=x.dtype, device=x.device)
    ind[:, 0] = ind[:, -1] = 1.0
    if top:
        ind[0] = 1.0
    if bottom:
        ind[-1] = 1.0
    ind = ind[None, :, :, None].expand(b, h + 2, w + 2, 1)
    return torch.cat([xp, ind], dim=-1)


def conv_zeros_init(c_in: int, c_out: int, filter_size: int = 3,
                    edge_bias: bool = True) -> Dict[str, np.ndarray]:
    k_in = c_in + 1 if (edge_bias and filter_size > 1) else c_in
    return {
        "w": np.zeros((filter_size, filter_size, k_in, c_out), np.float32),
        "b": np.zeros((1, 1, 1, c_out), np.float32),
        "logs": np.zeros((1, c_out), np.float32),
    }


def conv_zeros_apply(p, x, edge_bias: bool = True, halo=None):
    fs = p["w"].shape[0]
    if edge_bias and fs > 1:
        y = conv2d_nhwc(_edge_pad_with_indicator(x, halo), p["w"], padding="VALID")
    else:
        y = conv2d_nhwc(x, p["w"], padding="SAME", halo=halo)
    y = y + p["b"]
    return y * torch.exp(p["logs"] * LOGSCALE_FACTOR).reshape(1, 1, 1, -1)


# ---------------------------------------------------------------------------
# real_nvp_conv_template (ref:borealisflows/layers.py:452-498)
# conv3x3(width) -> BN -> relu -> conv1x1(width) -> BN -> relu -> zero-conv3x3
# ---------------------------------------------------------------------------

def coupling_nn_init(rng: np.random.Generator, c_in: int, width: int,
                     n_out: int):
    """n_out = 2 * (coupled channels) for shift+log_scale.

    Init std for hidden convs is ``width/512*0.05`` (ref:borealisflows/layers.py:599).
    """
    std = width / 512.0 * 0.05
    params = {
        "l1_w": (std * rng.standard_normal((3, 3, c_in, width))).astype(np.float32),
        "l1_b": np.zeros((1, 1, 1, width), np.float32),
        "l2_w": (std * rng.standard_normal((1, 1, width, width))).astype(np.float32),
        "l2_b": np.zeros((1, 1, 1, width), np.float32),
        "last": conv_zeros_init(width, n_out, 3, edge_bias=True),
    }
    state = {"bn1": batch_norm_init(width), "bn2": batch_norm_init(width)}
    return params, state


def coupling_nn_apply(p, s, x, train: bool, psum: Psum = None, halo=None):
    """Returns (shift, log_scale, new_state)."""
    h = conv2d_nhwc(x, p["l1_w"], halo=halo) + p["l1_b"]
    h, bn1 = batch_norm_apply(h, s["bn1"], train, psum)
    h = torch.relu(h)
    h = conv2d_nhwc(h, p["l2_w"]) + p["l2_b"]
    h, bn2 = batch_norm_apply(h, s["bn2"], train, psum)
    h = torch.relu(h)
    h = conv_zeros_apply(p["last"], h, halo=halo)
    shift, log_scale = torch.chunk(h, 2, dim=-1)
    return shift, log_scale, {"bn1": bn1, "bn2": bn2}


# ---------------------------------------------------------------------------
# real_nvp_default_template (ref:borealisflows/layers.py:404-449)
# dense MLP over the flattened input half: [dense -> BN -> relu]* ->
# zero-init dense -> reshape -> split(shift, log_scale)
# ---------------------------------------------------------------------------

def coupling_mlp_init(rng: np.random.Generator, half_shape, hidden_layers):
    """Dense-MLP coupling template. half_shape = (H, W, C//2)."""
    i0, i1, ic = half_shape
    in_units = i0 * i1 * ic
    out_units = 2 * in_units
    params: Dict[str, np.ndarray] = {}
    state: Dict[str, Dict[str, np.ndarray]] = {}
    prev = in_units
    for i, units in enumerate(hidden_layers):
        # TF dense default init: glorot uniform (ref:layers.py:424)
        lim = (6.0 / (prev + units)) ** 0.5
        params[f"d{i}_w"] = rng.uniform(-lim, lim, (prev, units)).astype(np.float32)
        params[f"d{i}_b"] = np.zeros((units,), np.float32)
        state[f"bn{i}"] = batch_norm_init(units)
        prev = units
    # zero-init last dense => identity coupling at init (ref:layers.py:432-440)
    params["last_w"] = np.zeros((prev, out_units), np.float32)
    params["last_b"] = np.zeros((out_units,), np.float32)
    return params, state


def coupling_mlp_apply(p, s, x, train: bool, psum: Psum = None):
    """Returns (shift, log_scale, new_state); x: [B, H, W, C//2]."""
    b, i0, i1, ic = x.shape
    h = x.reshape(b, i0 * i1 * ic)
    new_state = {}
    i = 0
    while f"d{i}_w" in p:
        h = h @ p[f"d{i}_w"] + p[f"d{i}_b"]
        h, new_state[f"bn{i}"] = batch_norm_apply(h, s[f"bn{i}"], train, psum)
        h = torch.relu(h)
        i += 1
    h = h @ p["last_w"] + p["last_b"]
    shift, log_scale = torch.chunk(h.reshape(b, i0, i1, 2 * ic), 2, dim=-1)
    return shift, log_scale, new_state


# ---------------------------------------------------------------------------
# real_nvp_conv_template_iso (ref:borealisflows/layers.py:501-547,616-648)
# conv weights/biases are affine in ISO: w = B1*iso + B2, bias = C1*iso + C2.
# ---------------------------------------------------------------------------

def coupling_nn_iso_init(rng: np.random.Generator, c_in: int, width: int,
                         n_out: int):
    std = 0.05  # ref:borealisflows/layers.py:627 (init_sd fixed at 0.05)

    def normal(*shape):
        return (std * rng.standard_normal(shape)).astype(np.float32)

    params = {
        "l1_B1": normal(3, 3, c_in, width), "l1_B2": normal(3, 3, c_in, width),
        "l1_C1": normal(1, 1, 1, width), "l1_C2": normal(1, 1, 1, width),
        "l2_B1": normal(1, 1, width, width), "l2_B2": normal(1, 1, width, width),
        "l2_C1": normal(1, 1, 1, width), "l2_C2": normal(1, 1, 1, width),
        "last": conv_zeros_init(width, n_out, 3, edge_bias=True),
    }
    state = {"bn1": batch_norm_init(width), "bn2": batch_norm_init(width)}
    return params, state


def coupling_nn_iso_apply(p, s, x, iso_scalar, train: bool, psum: Psum = None,
                          halo=None):
    """iso_scalar: one ISO for the whole batch. The reference indexes
    ``iso[0]`` (ref:borealisflows/layers.py:633): the iso-weighted convs are
    conditioned per minibatch, on its first example.
    Returns (shift, log_scale, new_state)."""
    w1 = p["l1_B1"] * iso_scalar + p["l1_B2"]
    h = conv2d_nhwc(x, w1, halo=halo) + (p["l1_C1"] * iso_scalar + p["l1_C2"])
    h, bn1 = batch_norm_apply(h, s["bn1"], train, psum)
    h = torch.relu(h)
    w2 = p["l2_B1"] * iso_scalar + p["l2_B2"]
    h = conv2d_nhwc(h, w2) + (p["l2_C1"] * iso_scalar + p["l2_C2"])
    h, bn2 = batch_norm_apply(h, s["bn2"], train, psum)
    h = torch.relu(h)
    h = conv_zeros_apply(p["last"], h, halo=halo)
    shift, log_scale = torch.chunk(h, 2, dim=-1)
    return shift, log_scale, {"bn1": bn1, "bn2": bn2}
