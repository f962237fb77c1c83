"""Importer for the reference's TensorFlow checkpoint.

Port of noise_flow_tpu.utils.tf_import. The reference trains with TF1's
``tf.train.Saver`` and ships its best model at
``models/NoiseFlow/ckpt/model.ckpt.best`` (restored by
ref:borealisflows/NoiseFlowWrapper.py:43,77). This module maps every
variable of such a checkpoint onto a port ``NoiseFlow``'s ``state_dict``.

Name scheme in the checkpoint (ref:borealisflows/noise_flow_model.py:79-234
scopes):

    level{L}/bijector{i}/rescaling_scale0                      (every layer)
    level{L}/bijector{i}/Conv2d_1x1_{i}/L_vec_matpar_lu_conv2d_1x1_{i}_0
                                        U_vec_..., log_S_..., sign_S_..., P_...
    model/real_nvp_conv_template[_{k}]/l_1/{W,b} l_2/{W,b}
                                       l_last/{W,b,logs}
                                       bn_nvp_conv_{1,2}/{mean,var}
    model/sdn_gain/{beta1,beta2,cam_params,gain_params,gain_val}

The LU strict-triangular vectors are in TFP ``fill_triangular`` order
(ref:borealisflows/matrix_param.py:31-97), not the row-major order of the
port's ``ops.conv1x1``; they are converted here.

Reading a checkpoint (``read_tf_checkpoint``) needs TensorFlow, imported
only there; without it that raises ``ImportError``. The mapping
(``reference_names``, ``import_reference_variables`` and its inverse
``export_reference_variables``) is numpy and torch only, and
``convert_reference_model`` writes the npz checkpoint that both packages
read without TensorFlow.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from noise_flow_tpu_torch.ops.conv1x1 import strict_tri_to_vec

# ---------------------------------------------------------------------------
# TFP fill_triangular ordering (ref:matrix_param.py:31-56 via
# tfp.math.fill_triangular): an n(n+1)/2 vector -> an [n, n] triangle
# ---------------------------------------------------------------------------


def fill_triangular_np(vec: np.ndarray, upper: bool) -> np.ndarray:
    m = vec.shape[-1]
    n = int((np.sqrt(8 * m + 1) - 1) / 2)
    if n * (n + 1) // 2 != m:
        raise ValueError(f"vector length {m} is not triangular")
    if upper:
        xs = np.concatenate([vec, vec[n:][::-1]])
    else:
        xs = np.concatenate([vec[n:], vec[::-1]])
    x = xs.reshape(n, n)
    return np.triu(x) if upper else np.tril(x)


def tfp_vec_to_strict_tri(vec: np.ndarray, c: int, upper: bool) -> np.ndarray:
    """TFP-ordered strict-triangular vector -> the [c, c] strict triangle
    (ref:matrix_param.py:31-56, ``_vec2stricttri``)."""
    tri = fill_triangular_np(np.asarray(vec), upper)  # [c-1, c-1], diagonal included
    out = np.zeros((c, c), np.float32)
    if upper:
        out[:-1, 1:] = tri
    else:
        out[1:, :-1] = tri
    return out


def strict_tri_to_tfp_vec(mat: np.ndarray, upper: bool) -> np.ndarray:
    """Inverse of ``tfp_vec_to_strict_tri``."""
    trimmed = mat[:-1, 1:] if upper else mat[1:, :-1]
    n = mat.shape[0] - 1
    m = n * (n + 1) // 2
    idx = fill_triangular_np(np.arange(1, m + 1, dtype=np.float64), upper)
    vec = np.zeros((m,), mat.dtype)
    for i in range(n):
        for j in range(n):
            k = int(idx[i, j])
            if k > 0:
                vec[k - 1] = trimmed[i, j]
    return vec


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def read_tf_checkpoint(prefix: str) -> Dict[str, np.ndarray]:
    """Every variable of a TF checkpoint prefix, in a dict (optimizer slots
    left out)."""
    try:
        import tensorflow as tf  # only to decode the TensorBundle
    except ImportError as e:
        raise ImportError(
            f"reading the TF checkpoint {prefix} needs tensorflow, which is not "
            "installed here; convert the model where it is (convert_reference_model) "
            "and load the npz checkpoint") from e
    reader = tf.train.load_checkpoint(prefix)
    out = {}
    for name in reader.get_variable_to_shape_map():
        if "/Adam" in name or "_power" in name:
            continue
        out[name] = np.asarray(reader.get_tensor(name))
    return out


def has_tf_checkpoint(ckpt_dir: str) -> bool:
    return os.path.exists(os.path.join(ckpt_dir, "model.ckpt.best.index"))


# ---------------------------------------------------------------------------
# mapping onto the NoiseFlow state_dict
# ---------------------------------------------------------------------------

_COUPLING = (("l1_w", "l_1/W"), ("l1_b", "l_1/b"), ("l2_w", "l_2/W"), ("l2_b", "l_2/b"),
             ("last.w", "l_last/W"), ("last.b", "l_last/b"), ("last.logs", "l_last/logs"),
             ("bn1.mean", "bn_nvp_conv_1/mean"), ("bn1.var", "bn_nvp_conv_1/var"),
             ("bn2.mean", "bn_nvp_conv_2/mean"), ("bn2.var", "bn_nvp_conv_2/var"))
_SDN_GAIN = ("gain_val", "gain_params", "beta1", "beta2", "cam_params")


def reference_names(flow) -> List[Tuple[str, str, Optional[bool]]]:
    """(state_dict key, reference variable, ``upper``) for every variable
    of ``flow`` (built from the matching hps: the arch DSL, decomp LU or
    NONE) that the reference's checkpoint holds. ``upper`` is None where
    the values are the same in both, else the LU strict triangle the
    vector fills (False: L, True: U; TFP order in the checkpoint, the
    port's row-major order in the state dict). The split priors of a
    multi-level flow have no reference names, as in JAX. Raises for a
    layer kind the mapping does not know."""
    names = []
    template_idx = 0  # tf.make_template instances are numbered in creation order
    for li in range(flow.n_levels):
        prefix, layers = flow._level_layers(li)
        for si, (spec, layer) in enumerate(zip(flow.specs, layers)):
            # the bijector index is the arch token's, the last part of the
            # layer's reference name (sdn_0, Conv2d_1x1_1, unc_1, ...)
            tok = spec.name.rsplit("_", 1)[-1]
            scope = f"level{li}/bijector{tok}"
            key = f"{prefix}.{si}"
            if spec.kind == "conv1x1":
                inner = f"{scope}/Conv2d_1x1_{tok}"
                tag = f"matpar_lu_conv2d_1x1_{tok}_0"
                mat = sorted(layer.mat._parameters)
                if "l_vec" in mat:
                    names += [(f"{key}.mat.l_vec", f"{inner}/L_vec_{tag}", False),
                              (f"{key}.mat.u_vec", f"{inner}/U_vec_{tag}", True),
                              (f"{key}.mat.log_s", f"{inner}/log_S_{tag}", None),
                              (f"{key}.frozen.p", f"{inner}/P_{tag}", None),
                              (f"{key}.frozen.sign_s", f"{inner}/sign_S_{tag}", None)]
                elif "A" in mat:
                    names.append((f"{key}.mat.A",
                                  f"{inner}/A_matpar_none_conv2d_1x1_{tok}_0", None))
                else:
                    raise ValueError(
                        f"unsupported conv1x1 parameterization for import: {mat}")
            elif spec.kind == "coupling":
                suffix = "" if template_idx == 0 else f"_{template_idx}"
                template_idx += 1
                t = f"model/real_nvp_conv_template{suffix}"
                names += [(f"{key}.nn.{ours}", f"{t}/{theirs}", None)
                          for ours, theirs in _COUPLING]
                names.append((f"{key}.rescale", f"{scope}/rescaling_scale0", None))
            elif spec.kind in ("sdn4", "sdn5", "sdn6", "gain4"):
                # their trainables live in the shared 'sdn_gain' group below
                names.append((f"{key}.rescale", f"{scope}/rescaling_scale0", None))
            elif spec.kind != "perm_reverse":
                raise NotImplementedError(
                    f"TF import not implemented for layer kind {spec.kind!r} "
                    f"(shipped checkpoint uses only the arch-DSL published "
                    f"model; extend the mapping for legacy archs)")
    if flow.shared is not None:
        names += [(f"shared.sdn_gain.{n}", f"model/sdn_gain/{n}", None) for n in _SDN_GAIN]
    return names


def _tri_size(m: int) -> int:
    """c of a strict [c, c] triangle of m elements."""
    return int(round((1 + np.sqrt(1 + 8 * m)) / 2))


def import_reference_variables(tf_vars: Dict[str, np.ndarray], flow) -> Dict[str, torch.Tensor]:
    """Map the reference's variables (``read_tf_checkpoint``) onto ``flow``
    (``reference_names``) and load them; returns the state dict loaded.
    The split priors of a multi-level flow keep their values, as in JAX.
    Raises where a variable the flow needs is missing, where one is left
    unconsumed, and for a layer kind the mapping does not know."""
    names = reference_names(flow)
    sd = {k: v.detach().clone() for k, v in flow.state_dict().items()}
    for key, name, upper in names:
        if name not in tf_vars:
            raise KeyError(f"checkpoint missing variable {name!r}")
        arr = np.asarray(tf_vars[name]).astype(np.float32)
        if upper is not None:
            full = tfp_vec_to_strict_tri(arr, _tri_size(arr.size), upper)
            arr = strict_tri_to_vec(full, upper)
        want = sd[key]
        if arr.size != want.numel():
            raise ValueError(f"{key}: checkpoint holds {arr.shape}, the flow {tuple(want.shape)}")
        sd[key] = torch.as_tensor(arr.reshape(want.shape), device=want.device)
    leftovers = sorted(set(tf_vars) - {name for _, name, _ in names})
    if leftovers:
        raise ValueError(f"unmapped checkpoint variables: {leftovers[:10]} "
                         f"(+{max(0, len(leftovers) - 10)} more)")
    flow.load_state_dict(sd)
    return sd


def export_reference_variables(flow) -> Dict[str, np.ndarray]:
    """The reference's variables of ``flow`` under its names, in the
    flow's shapes: ``import_reference_variables`` inverted, for a
    synthetic reference checkpoint and a round trip."""
    sd = {k: v.detach().cpu().numpy().astype(np.float32) for k, v in flow.state_dict().items()}
    out = {}
    for key, name, upper in reference_names(flow):
        arr = sd[key]
        if upper is not None:
            c = _tri_size(arr.size)
            full = np.zeros((c, c), np.float32)
            full[np.triu_indices(c, 1) if upper else np.tril_indices(c, -1)] = arr
            arr = strict_tri_to_tfp_vec(full, upper)
        out[name] = arr
    return out


def import_reference_checkpoint(ckpt_prefix: str, flow) -> Dict[str, torch.Tensor]:
    """Read a reference TF checkpoint and load it into ``flow``
    (``import_reference_variables``)."""
    return import_reference_variables(read_tf_checkpoint(ckpt_prefix), flow)


def convert_reference_model(model_dir: str, out_dir: str) -> str:
    """TF -> npz conversion of a reference model directory: reads
    ``{model_dir}/hps.txt`` and ``{model_dir}/ckpt/model.ckpt.best``, writes
    ``{out_dir}/hps.txt`` and ``{out_dir}/ckpt/model.ckpt-best.npz`` (the
    npz format both packages read); returns the npz's path."""
    from noise_flow_tpu_torch.config import load_hps
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.utils.checkpoint import save_checkpoint

    cfg = load_hps(os.path.join(model_dir, "hps.txt"))
    ph = cfg.patch_height
    flow = NoiseFlow((ph, ph, cfg.n_channels), cfg, device="cpu")
    import_reference_checkpoint(os.path.join(model_dir, "ckpt", "model.ckpt.best"), flow)
    os.makedirs(out_dir, exist_ok=True)
    shutil.copy(os.path.join(model_dir, "hps.txt"), os.path.join(out_dir, "hps.txt"))
    return save_checkpoint(os.path.join(out_dir, "ckpt"), "best", flow, epoch=0)
