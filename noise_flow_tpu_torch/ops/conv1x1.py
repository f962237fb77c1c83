"""Invertible 1x1 convolution matrix parameterizations.

Port of noise_flow_tpu.ops.conv1x1 (ref:borealisflows/matrix_param.py:23-204):

- ``NONE``: store A directly; inverse + slogdet computed on the fly.
- ``LU``: P·L·U with strict-triangular vectorized storage; logdet is
  sum(log_s); inverse via two triangular solves.
- ``LU2``: LU with full-matrix storage.

The strict triangles are filled in ``_tri_indices`` order (numpy's
``triu_indices``/``tril_indices``), the order the checkpoints were written
in. Initialisation runs in numpy and returns numpy arrays; ``matrix_param_build``
runs in torch, float32.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import scipy.linalg
import torch

from noise_flow_tpu_torch.utils.device import device_constant


def _tri_indices(c: int, upper: bool):
    if upper:
        return np.triu_indices(c, k=1)
    return np.tril_indices(c, k=-1)


def strict_tri_to_vec(m: np.ndarray, upper: bool) -> np.ndarray:
    i, j = _tri_indices(m.shape[0], upper)
    return np.asarray(m)[i, j]


def tri_index(c: int, upper: bool, device):
    """``_tri_indices`` as a pair of index tensors kept on ``device``."""
    ij = device_constant(("tri", c, upper), device, lambda: np.stack(_tri_indices(c, upper)))
    return ij[0], ij[1]


def vec_to_strict_tri(v: torch.Tensor, c: int, upper: bool) -> torch.Tensor:
    idx = tri_index(c, upper, v.device)
    return torch.zeros((c, c), dtype=v.dtype, device=v.device).index_put(idx, v)


def orthogonal_init(rng_np: np.random.Generator, c: int) -> np.ndarray:
    """QR-orthogonal init (ref:borealisflows/layers.py:95)."""
    return scipy.linalg.qr(rng_np.standard_normal((c, c)))[0].astype(np.float32)


def matrix_param_init(decomp: str, init_a: np.ndarray) -> Dict[str, Dict[str, np.ndarray]]:
    """Returns {'trainable': {...}, 'frozen': {...}} groups of numpy arrays."""
    c = init_a.shape[0]
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    if decomp == "NONE" or c <= 1:
        return {"trainable": {"A": f32(init_a)}, "frozen": {}}
    p, l, u = scipy.linalg.lu(init_a)
    s = np.diag(u)
    frozen = {"p": f32(p), "sign_s": f32(np.sign(s))}
    log_s = f32(np.log(np.abs(s)))
    u_strict = np.triu(u, k=1)
    if decomp == "LU":
        return {"trainable": {"log_s": log_s,
                              "l_vec": f32(strict_tri_to_vec(l, upper=False)),
                              "u_vec": f32(strict_tri_to_vec(u_strict, upper=True))},
                "frozen": frozen}
    if decomp == "LU2":
        # full-matrix storage variant (ref:matrix_param.py:143-188)
        return {"trainable": {"log_s": log_s, "l": f32(np.tril(l, k=-1)),
                              "u": f32(u_strict)},
                "frozen": frozen}
    raise ValueError(f"unknown decomp {decomp!r}")


def matrix_param_build(decomp: str, params) -> Dict[str, torch.Tensor]:
    """Builds {'A', 'A_inv', 'log_abs_det'} from the parameter group.

    A maps data->latent (applied in ``inverse``); A_inv is used when sampling
    (ref:borealisflows/layers.py:108-130).
    """
    t, f = params["trainable"], params["frozen"]
    if decomp == "NONE" or "A" in t:
        a = t["A"]
        _, log_abs_det = torch.linalg.slogdet(a)
        return {"A": a, "A_inv": torch.linalg.inv(a), "log_abs_det": log_abs_det}

    log_s = t["log_s"]
    c = log_s.shape[0]
    eye = torch.eye(c, dtype=log_s.dtype, device=log_s.device)
    diag = torch.diag(f["sign_s"] * torch.exp(log_s))
    if decomp == "LU":
        l = vec_to_strict_tri(t["l_vec"], c, upper=False) + eye
        u = vec_to_strict_tri(t["u_vec"], c, upper=True) + diag
    else:  # LU2
        mask_l = torch.tril(torch.ones_like(eye), diagonal=-1)
        l = t["l"] * mask_l + eye
        u = t["u"] * mask_l.T + diag
    p = f["p"]
    a = p @ (l @ u)
    # A_inv = U^-1 L^-1 P^T via triangular solves (ref:matrix_param.py:133-136)
    li_p = torch.linalg.solve_triangular(l, p.T, upper=False)
    a_inv = torch.linalg.solve_triangular(u, li_p, upper=True)
    return {"A": a, "A_inv": a_inv, "log_abs_det": torch.sum(log_s)}
