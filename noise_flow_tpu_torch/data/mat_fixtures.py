"""Genuine SIDD-format .MAT fixture writer.

A copy of noise_flow_tpu.data.mat_fixtures, which imports no JAX; the port
keeps its own. Every numpy expression, seed and cast is the same, so both
writers emit bit-equal arrays for the same arguments.

Emits scene directories in the exact SIDD_Medium_Raw on-disk layout —
`NNNN_SSS_CC_IIIII_NNNNN_NNNN_B/` dirs holding NOISY/GT/VARIANCE/METADATA
.MAT files — with the images as real MATLAB v7.3 (HDF5, written via h5py,
the format of every SIDD_Medium image, read ref:sidd/sidd_utils.py:233-239)
or legacy v5 (scipy.io.savemat, the scipy fallback path), and the metadata
as the v5 struct whose NLF sits at ``metadata.UnknownTags[7,0][2][0][0:2]``
(ref:sidd/sidd_utils.py:718-729).

This makes the L1 layer testable against the actual file format (not numpy
stand-ins) and generates SIDD-shaped datasets at any scale for
production-shaped runs when the real 20 GB corpus is unreachable.
Noise is drawn from the camera NLF (var = beta1*gt + beta2 in the raw
domain), so the written noisy/GT pairs carry the same signal-dependence the
flow models.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from noise_flow_tpu_torch.data.sidd import CAM_IDS, unpack_raw  # noqa: F401

# the two image-count bands SIDD_Medium uses (ref dirs hold image pairs
# indexed 000.. or 010..; the reference enumerates [first_im_idx, last_im_idx))
DEFAULT_IMAGE_IDX = 0


def scene_dirname(inst_id: int, scene: str, cam: str, iso: int,
                  shutter: int = 60, temp: int = 3200,
                  brightness: str = "L") -> str:
    """SIDD scene-instance directory name, 30 chars
    (parsed at fixed offsets, ref:sidd_utils.py:255-262: cam at [9:11],
    iso at [12:17])."""
    name = (f"{inst_id:04d}_{scene}_{cam}_{iso:05d}_{shutter:05d}_"
            f"{temp:04d}_{brightness}")
    assert len(name) == 30, name
    return name


def make_gt_bayer(h: int, w: int, seed: int = 0,
                  lo: float = 0.02, hi: float = 0.85) -> np.ndarray:
    """Smooth synthetic scene in the raw Bayer domain: low-frequency random
    field upsampled to (h, w), range [lo, hi] — gives the NLF's
    signal-dependence a full intensity sweep per image."""
    rng = np.random.default_rng(seed)
    coarse = rng.uniform(0.0, 1.0, (max(h // 32, 2), max(w // 32, 2)))
    # bilinear upsample to full res
    yy = np.linspace(0, coarse.shape[0] - 1, h)
    xx = np.linspace(0, coarse.shape[1] - 1, w)
    y0 = np.floor(yy).astype(int)
    x0 = np.floor(xx).astype(int)
    y1 = np.minimum(y0 + 1, coarse.shape[0] - 1)
    x1 = np.minimum(x0 + 1, coarse.shape[1] - 1)
    fy = (yy - y0)[:, None]
    fx = (xx - x0)[None, :]
    img = (coarse[np.ix_(y0, x0)] * (1 - fy) * (1 - fx)
           + coarse[np.ix_(y1, x0)] * fy * (1 - fx)
           + coarse[np.ix_(y0, x1)] * (1 - fy) * fx
           + coarse[np.ix_(y1, x1)] * fy * fx)
    return (lo + (hi - lo) * img).astype(np.float32)


def _save_mat_v73(path: str, arr: np.ndarray, var_name: str = "x") -> None:
    """MATLAB v7.3 = HDF5: one dataset named like the MATLAB variable
    (h5py reads SIDD's real files the same way, ref:sidd_utils.py:233-236)."""
    import h5py
    with h5py.File(path, "w") as f:
        f.create_dataset(var_name, data=arr)


def _save_mat_v5(path: str, arr: np.ndarray, var_name: str = "x") -> None:
    from scipy.io import savemat
    savemat(path, {var_name: arr})


def save_metadata_mat(path: str, nlf0: float, nlf1: float, iso: int,
                      n_tags: int = 10) -> None:
    """v5 metadata struct with the NLF where the reference reads it:
    ``metadata.UnknownTags[7,0][2][0][0:2]`` (ref:sidd_utils.py:718-729).
    Field order (ID, Type, Value) makes index [2] the Value."""
    from scipy.io import savemat
    ut = np.zeros((n_tags, 1), dtype=[("ID", "O"), ("Type", "O"),
                                      ("Value", "O")])
    for i in range(n_tags):
        ut[i, 0] = (np.array([[float(i)]]), np.array([[2.0]]),
                    np.array([[0.0]]))
    # row 7: the noise-level-function tag; extra trailing entries mirror the
    # real files (only [0:2] is consumed)
    ut[7, 0] = (np.array([[7.0]]), np.array([[2.0]]),
                np.array([[float(nlf0), float(nlf1), 0.0, 0.0]]))
    meta = {"UnknownTags": ut, "ISOSpeedRatings": np.array([[float(iso)]])}
    savemat(path, {"metadata": meta})


def write_sidd_scene(
    sidd_path: str,
    inst_id: int,
    cam: str = "S6",
    iso: int = 100,
    scene: str = "001",
    h: int = 256,
    w: int = 256,
    beta1: Optional[float] = None,
    beta2: Optional[float] = None,
    seed: int = 0,
    n_images: int = 1,
    first_idx: int = DEFAULT_IMAGE_IDX,
    mat_version: str = "v7.3",
) -> str:
    """Write one SIDD_Medium-layout scene instance; returns the scene dir.

    (h, w) are raw Bayer dims (packed 4-channel images come out (h/2, w/2, 4)
    through pack_raw). beta1/beta2 default to a mid-range NLF for the cam.
    """
    assert cam in CAM_IDS, cam
    assert h % 2 == 0 and w % 2 == 0
    if beta1 is None:
        beta1 = 0.0005 * (iso / 100.0)
    if beta2 is None:
        beta2 = 2e-6 * max(iso / 100.0, 1.0)
    sdir = scene_dirname(inst_id, scene, cam, iso)
    full = os.path.join(sidd_path, sdir)
    os.makedirs(full, exist_ok=True)
    save = _save_mat_v73 if mat_version == "v7.3" else _save_mat_v5
    rng = np.random.default_rng(seed)
    for i in range(first_idx, first_idx + n_images):
        gt = make_gt_bayer(h, w, seed=seed * 1000 + i)
        var = (beta1 * gt + beta2).astype(np.float32)
        noisy = np.clip(gt + rng.standard_normal(gt.shape).astype(np.float32)
                        * np.sqrt(var), 0.0, 1.0).astype(np.float32)
        pid = f"{inst_id:04d}"
        save(os.path.join(full, f"{pid}_NOISY_RAW_{i:03d}.MAT"), noisy)
        save(os.path.join(full, f"{pid}_GT_RAW_{i:03d}.MAT"), gt)
        save(os.path.join(full, f"{pid}_VARIANCE_RAW_{i:03d}.MAT"), var)
        save_metadata_mat(
            os.path.join(full, f"{pid}_METADATA_RAW_{i:03d}.MAT"),
            beta1, beta2, iso)
    return full


def write_sidd_dataset(
    sidd_path: str,
    instance_ids: Sequence[int],
    cam: str = "S6",
    iso: int = 100,
    h: int = 256,
    w: int = 256,
    n_images: int = 1,
    first_idx: int = DEFAULT_IMAGE_IDX,
    nlf: Optional[Tuple[float, float]] = None,
    mat_version: str = "v7.3",
) -> List[str]:
    """Write a whole SIDD-layout dataset (one scene per instance id).

    Put ids from data.sidd.TRAIN_INSTANCE_IDS / TEST_INSTANCE_IDS in to make
    the hardcoded split enumeration find them. The path should contain
    'SIDD_Medium' so sidd_filename_tuples uses the flat-medium file layout."""
    b1, b2 = nlf if nlf else (None, None)
    return [
        write_sidd_scene(sidd_path, i, cam=cam, iso=iso, h=h, w=w,
                         beta1=b1, beta2=b2, seed=i, n_images=n_images,
                         first_idx=first_idx, mat_version=mat_version)
        for i in instance_ids
    ]
