"""DnCNN training data: tile clean (and optionally noisy) SIDD images into
training patches, filtered by the cam_iso_nlf table.

A copy of noise_flow_tpu.data.dncnn_data, which imports no JAX, on the
port's own data modules.

Re-design of ref:sidd/data_loader.py:105-298. The reference spawned one
thread per image and concatenated in a queue; here tiling is one vectorized
gather per image (same stride-64 32x32 grid).
"""

from __future__ import annotations

import glob
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from noise_flow_tpu_torch.data.patches import extract_patches
from noise_flow_tpu_torch.data.sidd import load_cam_iso_nlf, pack_raw

PATCH_SIZE = 32
STRIDE = 64


def cam_iso_from_path(fp: str) -> str:
    """'.../NNNN_SSS_CC_IIIII_.../...MAT' -> 'CC_IIIII'
    (ref:data_loader.py:109 slices fp[-41:-33])."""
    parts = os.path.normpath(fp).split(os.sep)
    for part in reversed(parts):
        if len(part) == 30 and part[4] == "_":
            return part[9:17]
    return fp[-41:-33]


def tile_image(img: np.ndarray, patch_size: int = PATCH_SIZE,
               stride: int = STRIDE) -> np.ndarray:
    """[1,H,W,C] -> [N,patch,patch,C] grid tiling (ref:data_loader.py:124-141)."""
    _, h, w, _ = img.shape
    ii, jj = np.meshgrid(np.arange(0, h - patch_size + 1, stride),
                         np.arange(0, w - patch_size + 1, stride),
                         indexing="ij")
    return extract_patches(img, ii.reshape(-1), jj.reshape(-1),
                           patch_size, patch_size)


def _load_packed(fp: str) -> np.ndarray:
    from noise_flow_tpu_torch.data.sidd import _read_mat_array
    img = pack_raw(_read_mat_array(fp))[None].astype(np.float32)
    return np.clip(np.nan_to_num(img), 0.0, 1.0)


def load_dncnn_data(
    data_dir: str,
    cam_iso_nlf_path: Optional[str] = None,
    max_images: int = 0,
    with_noisy: bool = False,
    batch_size: int = 128,
    instance_ids: Optional[List[int]] = None,
) -> Tuple[np.ndarray, List[str], Optional[np.ndarray]]:
    """-> (clean_patches[N,32,32,4], cam_iso_info[N], noisy_patches|None)
    (ref:data_loader.py:178-298). Trailing remainder is dropped so every batch
    is full (matters for BN, ref:train_dncnn_noiseflow.py:182-185).

    instance_ids restricts to those scene instances (e.g.
    sidd.TRAIN_INSTANCE_IDS, so a denoiser never trains on the scenes its
    validation blocks come from)."""
    file_list = sorted(glob.glob(os.path.join(data_dir, "**", "*GT_RAW_010.MAT"),
                                 recursive=True))
    if instance_ids is not None:
        keep = {f"{i:04d}" for i in instance_ids}
        file_list = [f for f in file_list
                     if os.path.basename(f)[:4] in keep]
    if max_images:
        file_list = file_list[:max_images]
    if cam_iso_nlf_path:
        table = load_cam_iso_nlf(cam_iso_nlf_path)
        file_list = [f for f in file_list if cam_iso_from_path(f) in table]
    xs, noisy_xs, info = [], [], []
    for f in file_list:
        patches = tile_image(_load_packed(f))
        xs.append(patches)
        info.extend([cam_iso_from_path(f)] * len(patches))
        if with_noisy:
            noisy_xs.append(tile_image(_load_packed(
                f.replace("GT_RAW", "NOISY_RAW"))))
    if not xs:
        raise FileNotFoundError(f"no GT_RAW_010.MAT under {data_dir!r}")
    data = np.concatenate(xs)
    noisy = np.concatenate(noisy_xs) if with_noisy else None
    # drop the FIRST remainder patches like the reference (np.delete on
    # range(discard_n), ref:data_loader.py:163-166)
    discard = len(data) - (len(data) // batch_size) * batch_size
    if discard:
        data = data[discard:]
        info = info[discard:]
        if noisy is not None:
            noisy = noisy[discard:]
    return data, info, noisy


def synthetic_dncnn_data(n_images: int = 4, h: int = 256, w: int = 256,
                         seed: int = 0, batch_size: int = 128,
                         isos: Optional[List[int]] = None):
    """Synthetic stand-in with real heteroscedastic noise (tests/smoke)."""
    from noise_flow_tpu_torch.data.synthetic import make_synthetic_samples
    samples = make_synthetic_samples(n_images=n_images, h=h, w=w, seed=seed,
                                     isos=isos or [100, 800, 1600, 3200])
    xs, noisy_xs, info = [], [], []
    for s in samples:
        p = tile_image(s["clean"])
        xs.append(p)
        noisy_xs.append(tile_image(s["clean"] + s["noise"]))
        info.extend([f"S6_{int(s['iso']):05d}"] * len(p))
    data = np.concatenate(xs)
    noisy = np.concatenate(noisy_xs)
    discard = len(data) - (len(data) // batch_size) * batch_size
    if discard:
        data, noisy, info = data[discard:], noisy[discard:], info[discard:]
    return data, info, noisy
