"""Preprocessed dataset cache: SIDD .MAT -> packed .npy pairs.

A copy of noise_flow_tpu.data.cache, which imports no JAX; the port keeps its own.

SIDD_Medium_Raw is ~20 GB of MATLAB v7.3 files; h5py decode + Bayer packing
dominates input time if done per epoch (the reference re-reads .MAT every
epoch through its ImageLoader threads, ref:sidd/ImageLoader.py:36-78). This
module materializes a one-time cache of float32 .npy arrays:

    <cache_dir>/<scene>_<idx>_noise.npy   [H/2, W/2, 4] (noisy - clean)
    <cache_dir>/<scene>_<idx>_clean.npy   [H/2, W/2, 4]
    <cache_dir>/index.json                per-image conditioning metadata

The C++ native loader (noise_flow_tpu_torch.data.native) and the Python pipeline
both read this cache; .npy is mmap-friendly and trivially parseable from C.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from noise_flow_tpu_torch.data.sidd import load_image_tuple, sidd_filename_tuples

INDEX_NAME = "index.json"


def build_cache(sidd_path: str, cache_dir: str, train_or_test: str = "train",
                first_im_idx: int = 10, last_im_idx: int = 12,
                cam: Optional[str] = None, iso: Optional[int] = None,
                verbose: bool = False) -> str:
    """Decode the split once and write the npy cache. Returns the index path."""
    os.makedirs(cache_dir, exist_ok=True)
    tuples, _ = sidd_filename_tuples(sidd_path, train_or_test,
                                     first_im_idx, last_im_idx, cam, iso)
    index: List[Dict] = []
    for i, tup in enumerate(tuples):
        s = load_image_tuple(tup)
        stem = f"{s['fn']}_{i:03d}"
        np.save(os.path.join(cache_dir, stem + "_noise.npy"),
                s["noise"][0].astype(np.float32))
        np.save(os.path.join(cache_dir, stem + "_clean.npy"),
                s["clean"][0].astype(np.float32))
        index.append({
            "stem": stem, "nlf0": s["nlf0"], "nlf1": s["nlf1"],
            "iso": s["iso"], "cam": s["cam"], "fn": s["fn"],
            "shape": list(s["noise"].shape[1:]),
        })
        if verbose:
            print(f"cache {i + 1}/{len(tuples)}: {stem}", flush=True)
    path = os.path.join(cache_dir, INDEX_NAME)
    with open(path, "w") as f:
        json.dump(index, f)
    return path


def write_cache_from_samples(samples: List[Dict], cache_dir: str) -> str:
    """Cache arbitrary sample dicts (e.g. synthetic fixtures) — test helper."""
    os.makedirs(cache_dir, exist_ok=True)
    index = []
    for i, s in enumerate(samples):
        stem = f"{s['fn']}_{i:03d}"
        np.save(os.path.join(cache_dir, stem + "_noise.npy"),
                s["noise"][0].astype(np.float32))
        np.save(os.path.join(cache_dir, stem + "_clean.npy"),
                s["clean"][0].astype(np.float32))
        index.append({
            "stem": stem, "nlf0": float(s["nlf0"]), "nlf1": float(s["nlf1"]),
            "iso": float(s["iso"]), "cam": float(s["cam"]), "fn": s["fn"],
            "shape": list(s["noise"].shape[1:]),
        })
    path = os.path.join(cache_dir, INDEX_NAME)
    with open(path, "w") as f:
        json.dump(index, f)
    return path


def read_index(cache_dir: str) -> List[Dict]:
    with open(os.path.join(cache_dir, INDEX_NAME)) as f:
        return json.load(f)


def load_cached_samples(cache_dir: str) -> List[Dict]:
    """Cache -> sample dicts in the data.sidd schema (Python fallback path)."""
    out = []
    for e in read_index(cache_dir):
        noise = np.load(os.path.join(cache_dir, e["stem"] + "_noise.npy"))
        clean = np.load(os.path.join(cache_dir, e["stem"] + "_clean.npy"))
        out.append({
            "noise": noise[None], "clean": clean[None],
            "nlf0": e["nlf0"], "nlf1": e["nlf1"],
            "iso": e["iso"], "cam": e["cam"], "fn": e["fn"],
        })
    return out
