"""Conditioning-parameter models for the signal/gain bijector families.

Port of noise_flow_tpu.models.cond_params (ref:borealisflows/noise_flow_layers/
cond_utils.py). Every formula is a batched table gather over equality masks,
so conditioning is per example, and it reduces to the reference when the
batch shares one (iso, cam).

Fallback semantics preserved:
- cond-ladder formulas (sdn1/2/3, gain2/3) fall back to the ISO-800 parameter
  for unseen ISOs (ref:cond_utils.py:81-82 et al.).
- one-hot formulas (sdn4/5/6, gain4 family) reduce to 0 for unseen values
  (empty tf.where match), i.e. exp(0)=1 factors (ref:cond_utils.py:188-191).

``*_init`` functions return dicts of numpy arrays; ``*_scale`` functions take
(params, cond pieces) as tensors and return the elementwise scale.
Shapes: ``yy`` is [B,H,W,C]; ``iso`` / ``cam`` are [B] floats.
"""

from __future__ import annotations

import numpy as np
import torch

from noise_flow_tpu_torch.utils.device import device_constant

ISO_VALS = (100.0, 400.0, 800.0, 1600.0, 3200.0)
CAM_VALS = (0.0, 1.0, 2.0, 3.0, 4.0)  # IP GP S6 N6 G4


def _b(x):
    """[B] -> [B,1,1,1] for broadcasting against image tensors."""
    return x.reshape(-1, 1, 1, 1)


def _onehot(v, vals):
    table = device_constant(("onehot", vals), v.device, lambda: np.asarray(vals, np.float32))
    return (v[:, None] == table[None, :]).to(torch.float32)


def _iso_onehot(iso):
    """[B,5] equality mask; all-zero row for unseen ISO (tf.where semantics)."""
    return _onehot(iso, ISO_VALS)


def _cam_onehot(cam):
    return _onehot(cam, CAM_VALS)


def _iso_gather_fallback800(table, iso):
    """Per-ISO scalar via the tf.cond ladder semantics: unseen ISO -> ISO-800
    entry (index 2). Returns [B]."""
    onehot = _iso_onehot(iso)
    hit = torch.sum(onehot, dim=1)
    val = torch.sum(onehot * table[None, :], dim=1)
    return torch.where(hit > 0, val, table[2])


def _full(n, v):
    return np.full((n,), v, np.float32)


# ---------------------------------------------------------------------------
# sdn family (signal-dependent scale)
# ---------------------------------------------------------------------------

def sdn_init():
    # sigmoid(-3)->~0, sigmoid(3)->~1 (ref:cond_utils.py:41-47)
    return {"b1": _full(1, -3.0), "b2": _full(1, 3.0)}


def sdn_scale(p, yy):
    return torch.sqrt(torch.sigmoid(p["b1"]) * yy + torch.sigmoid(p["b2"]))


def sdn1_init():
    # c=1e-2, init 0 (ref:cond_utils.py:55-68)
    return {"r_gain": _full(5, 0.0), "b1": _full(1, -3.0), "b2": _full(1, 3.0)}


def sdn1_scale(p, yy, iso):
    c = 1e-2
    rg = _iso_gather_fallback800(p["r_gain"], iso)
    r_gain = torch.exp(c * rg) * iso  # [B]
    b1 = torch.sigmoid(p["b1"])
    b2 = torch.sigmoid(p["b2"])
    return torch.sqrt(b1 * yy / _b(r_gain) + b2)


def sdn2_init(gain_init: float):
    c = 1e-1
    return {"gain": _full(5, gain_init / c), "b1": _full(1, -3.0),
            "b2": _full(1, 3.0)}


def sdn2_scale(p, yy, iso):
    c = 1e-1
    g = _iso_gather_fallback800(p["gain"], iso)
    gain = _b(torch.exp(c * g) * iso)
    b1 = torch.sigmoid(p["b1"])
    b2 = torch.sigmoid(p["b2"])
    return torch.sqrt(gain * (b1 * yy / gain + b2))


def sdn3_init(gain_init: float):
    return sdn2_init(gain_init)


def sdn3_scale(p, yy, iso):
    c = 1e-1
    g = _iso_gather_fallback800(p["gain"], iso)
    gain = _b(torch.exp(c * g) * iso)
    b1 = torch.sigmoid(p["b1"])
    b2 = torch.sigmoid(p["b2"])
    return gain * torch.sqrt(b1 * yy / gain + b2)


# --- shared 'sdn_gain' parameter group (ref:cond_utils.py:181,207,244,437) ---
# sdn4/5/6 and gain4 share variables through TF scope 'sdn_gain' with
# AUTO_REUSE; here that is one explicit shared group.

def sdn_gain_shared_init(gain_init: float, param_inits=None, npcam: int = 3):
    """param_inits = (c_i, beta1_i, beta2_i, gain_params_i[5], cam_params_i[npcam,5])
    (ref:train_noise_flow.py:201-214)."""
    if param_inits is None:
        c_i = 1.0
        beta1_i = -5.0 / c_i
        beta2_i = 0.0
        gain_params_i = np.full((5,), -5.0 / c_i)
        cam_params_i = np.full((npcam, 5), 1.0)
    else:
        (c_i, beta1_i, beta2_i, gain_params_i, cam_params_i) = param_inits
        cam_params_i = np.asarray(cam_params_i, np.float32)
    return {
        "gain_val": _full(1, 1.0),
        "gain_params": np.asarray(gain_params_i, np.float32).reshape(5),
        "beta1": _full(1, float(beta1_i)),
        "beta2": _full(1, float(beta2_i)),
        "cam_params": np.asarray(cam_params_i, np.float32),
    }, float(c_i)


def sdn4_scale(shared, yy, iso, c: float = 1.0):
    """(ref:cond_utils.py:178-202); unseen ISO -> g=0 -> gain=iso."""
    g = torch.sum(_iso_onehot(iso) * shared["gain_params"][None, :], dim=1)
    gain = _b(torch.exp(c * g) * iso)
    beta1 = torch.exp(c * shared["beta1"])
    beta2 = torch.exp(c * shared["beta2"])
    return torch.sqrt(beta1 * yy / gain + beta2)


def _cam_select(shared, cam, c: float):
    """exp(c * cam_params[:, cam]) per example -> [B, npcam]; unseen cam -> 1."""
    sel = torch.einsum("bk,pk->bp", _cam_onehot(cam), shared["cam_params"])
    return torch.exp(c * sel)


def sdn5_scale(shared, yy, iso, cam, c: float = 1.0):
    """Published model's signal layer (ref:cond_utils.py:205-239)."""
    one_cam = _cam_select(shared, cam, c)  # [B,3]
    g = torch.sum(_iso_onehot(iso) * shared["gain_params"][None, :], dim=1)
    gain = _b(torch.exp(c * g * one_cam[:, 2]) * iso)
    beta1 = _b(torch.exp(c * shared["beta1"] * one_cam[:, 0]))
    beta2 = _b(torch.exp(c * shared["beta2"] * one_cam[:, 1]))
    return torch.sqrt(beta1 * yy / gain + beta2)


def sdn6_scale(shared, yy, iso, cam, c: float = 1.0):
    """(ref:cond_utils.py:242-276): single cam param modulates gain only."""
    one_cam = _cam_select(shared, cam, c)  # [B,1]
    g = torch.sum(_iso_onehot(iso) * shared["gain_params"][None, :], dim=1)
    gain = _b(torch.exp(c * g * one_cam[:, 0]) * iso)
    beta1 = torch.exp(c * shared["beta1"])
    beta2 = torch.exp(c * shared["beta2"])
    return torch.sqrt(beta1 * yy / gain + beta2)


# ---------------------------------------------------------------------------
# gain family (scalar-per-example scale)
# ---------------------------------------------------------------------------

def gain_init():
    return {"g1": _full(1, -3.0), "g2": _full(1, 3.0)}


def gain_scale(p, iso):
    """scale = sigmoid(g1)*iso + sigmoid(g2) -> [B] (ref:cond_utils.py:319-330)."""
    return torch.sigmoid(p["g1"]) * iso + torch.sigmoid(p["g2"])


def gain1_init():
    c = 1e-5
    return {"g1": _full(1, -5.0 / c), "g2": _full(1, 0.0 / c)}


def gain1_scale(p, iso):
    c = 1e-5
    return torch.exp(c * p["g1"]) * iso + torch.exp(c * p["g2"])


def gain2_init(gain_init_val: float):
    c = 1e-1
    return {"gain": _full(5, gain_init_val / c)}


def gain2_scale(p, iso):
    c = 1e-1
    g = _iso_gather_fallback800(p["gain"], iso)
    return torch.exp(c * g) * iso


def gain3_init():
    c = 1e-5
    return {"gain": _full(5, -5.0 / c)}


def gain3_scale(p, iso):
    c = 1e-5
    return torch.exp(c * _iso_gather_fallback800(p["gain"], iso))


def gain4_scale(shared):
    """scale = shared trainable scalar 'gain_val' (ref:cond_utils.py:432-440)."""
    return shared["gain_val"]


# ---------------------------------------------------------------------------
# iso-polynomial SDN fits (fitSDN / append_sdn layers)
# ---------------------------------------------------------------------------

def sdn_iso3_init():
    # all params init -6 (ref:cond_utils.py:11-24)
    return {k: _full(1, -6.0) for k in ("p1", "p2", "p3", "q1", "q2", "q3", "q4")}


def sdn_iso3_betas(p, iso):
    """beta1 quadratic / beta2 cubic in iso, exp-params -> ([B],[B])."""
    beta1 = torch.exp(p["p1"]) * iso ** 2 + torch.exp(p["p2"]) * iso + torch.exp(p["p3"])
    beta2 = (torch.exp(p["q1"]) * iso ** 3 + torch.exp(p["q2"]) * iso ** 2
             + torch.exp(p["q3"]) * iso + torch.exp(p["q4"]))
    return beta1, beta2


def sdn_iso2_init():
    return {k: _full(1, -6.0) for k in ("p2", "p3", "q2", "q3", "q4")}


def sdn_iso2_betas(p, iso):
    """beta1 linear / beta2 quadratic in iso (ref:cond_utils.py:27-38)."""
    beta1 = torch.exp(p["p2"]) * iso + torch.exp(p["p3"])
    beta2 = torch.exp(p["q2"]) * iso ** 2 + torch.exp(p["q3"]) * iso + torch.exp(p["q4"])
    return beta1, beta2
