"""Patch sampling and minibatch assembly.

A copy of noise_flow_tpu.data.patches, which imports no JAX; the port keeps its own.

Re-design of ref:sidd/PatchSampler.py + sidd/MiniBatchSampler.py +
sidd/sidd_utils.py:286-327,830-858. The reference used a 4-stage thread/queue
pipeline; the steady-state hot path here is vectorized numpy over preprocessed
full images (and optionally the C++ loader in noise_flow_tpu_torch.data.native).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


def sample_indices_uniform(h: int, w: int, ph: int, pw: int,
                           n_pat_per_im: Optional[int] = None,
                           shuf: bool = False,
                           rng: Optional[np.random.Generator] = None):
    """Non-overlapping grid tiling (ref:sidd_utils.py:830-846)."""
    ii, jj = np.meshgrid(np.arange(0, h - ph + 1, ph),
                         np.arange(0, w - pw + 1, pw), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    if n_pat_per_im is not None:
        ii, jj = ii[:n_pat_per_im], jj[:n_pat_per_im]
    if shuf:
        rng = rng or np.random.default_rng()
        perm = rng.permutation(len(ii))
        ii, jj = ii[perm], jj[perm]
    return ii, jj, len(ii)


def sample_indices_random(h: int, w: int, ph: int, pw: int, n_p: int,
                          rng: Optional[np.random.Generator] = None):
    """(ref:sidd_utils.py:849-858)"""
    rng = rng or np.random.default_rng()
    ii = rng.integers(0, h - ph + 1, size=n_p)
    jj = rng.integers(0, w - pw + 1, size=n_p)
    return ii, jj


def extract_patches(image: np.ndarray, ii, jj, ph: int, pw: int) -> np.ndarray:
    """Gather [N,ph,pw,C] patches from [1,H,W,C] (vectorized)."""
    img = image[0]
    # build index grids once; fancy-indexing gathers all patches in one shot
    di = np.arange(ph)
    dj = np.arange(pw)
    rows = np.asarray(ii)[:, None, None] + di[None, :, None]
    cols = np.asarray(jj)[:, None, None] + dj[None, None, :]
    return img[rows, cols, :]


def sample_image_patches(sample: Dict, patch_size: int,
                         n_patches_per_image: int, sampling: str = "uniform",
                         rng: Optional[np.random.Generator] = None,
                         shuffle_patches: bool = False):
    """One loaded image dict -> patch arrays.

    Uniform mode keeps the reference's centering: if fewer patches are
    requested than the grid provides, take the middle run
    (ref:sidd_utils.py:305-307). With shuffle_patches the full grid is
    permuted BEFORE the centered slice, exactly like the reference's
    ``sample_indices_uniform(shuf=True)`` (ref:sidd_utils.py:830-846; the
    published run used shuffle_patches=True, models/NoiseFlow/hps.txt).
    """
    h, w = sample["noise"].shape[1:3]
    ph = pw = patch_size
    if sampling == "uniform":
        ii, jj, max_p = sample_indices_uniform(h, w, ph, pw,
                                               shuf=shuffle_patches, rng=rng)
        n = min(n_patches_per_image, max_p)
        offset = int((max_p - n) / 2)
        ii, jj = ii[offset:offset + n], jj[offset:offset + n]
    else:
        ii, jj = sample_indices_random(h, w, ph, pw, n_patches_per_image, rng)
    noise = extract_patches(sample["noise"], ii, jj, ph, pw)
    clean = extract_patches(sample["clean"], ii, jj, ph, pw)
    return noise.astype(np.float32), clean.astype(np.float32)


class PatchDataset:
    """All patches of a split, memory-resident, with per-patch conditioning.

    Produces the minibatch dict schema of ref:sidd/MiniBatchSampler.py:66-69:
    ``{_x, _y, nlf0, nlf1, iso, cam, pid}``, but with PER-PATCH conditioning
    vectors (the reference carried a single scalar per batch, taken from its
    last patch — MiniBatchSampler.py:60-64; set ``batch_scalar_cond=True`` for
    that compat behavior).
    """

    def __init__(self, samples: List[Dict], patch_size: int,
                 n_patches_per_image: int, sampling: str = "uniform",
                 seed: int = 0, shuffle_patches: bool = False):
        xs, ys, nlf0, nlf1, iso, cam = [], [], [], [], [], []
        rng = np.random.default_rng(seed)
        for s in samples:
            n, c = sample_image_patches(s, patch_size, n_patches_per_image,
                                        sampling, rng,
                                        shuffle_patches=shuffle_patches)
            xs.append(n)
            ys.append(c)
            k = n.shape[0]
            nlf0.append(np.full((k,), s["nlf0"], np.float32))
            nlf1.append(np.full((k,), s["nlf1"], np.float32))
            iso.append(np.full((k,), s["iso"], np.float32))
            cam.append(np.full((k,), s["cam"], np.float32))
        self.x = np.concatenate(xs) if xs else np.zeros((0, patch_size, patch_size, 4), np.float32)
        self.y = np.concatenate(ys) if ys else np.zeros_like(self.x)
        self.nlf0 = np.concatenate(nlf0) if nlf0 else np.zeros((0,), np.float32)
        self.nlf1 = np.concatenate(nlf1) if nlf1 else np.zeros((0,), np.float32)
        self.iso = np.concatenate(iso) if iso else np.zeros((0,), np.float32)
        self.cam = np.concatenate(cam) if cam else np.zeros((0,), np.float32)
        self.pid = np.arange(self.x.shape[0])

    def __len__(self):
        return self.x.shape[0]

    def batches(self, batch_size: int, shuffle: bool = False, seed: int = 0,
                drop_remainder: bool = False,
                batch_scalar_cond: bool = False) -> Iterator[Dict]:
        """Yield minibatch dicts. With batch_scalar_cond, conditioning scalars
        are the LAST patch's, broadcast — exact reference parity
        (ref:MiniBatchSampler.py:60-64)."""
        n = len(self)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        stop = n - (n % batch_size) if drop_remainder else n
        for s in range(0, stop, batch_size):
            idx = order[s:s + batch_size]
            mb = {
                "_x": self.x[idx], "_y": self.y[idx], "pid": self.pid[idx],
                "nlf0": self.nlf0[idx], "nlf1": self.nlf1[idx],
                "iso": self.iso[idx], "cam": self.cam[idx],
            }
            if batch_scalar_cond:
                for k in ("nlf0", "nlf1", "iso", "cam"):
                    mb[k] = np.full_like(mb[k], mb[k][-1])
            yield mb
