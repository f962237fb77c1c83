"""ctypes bindings for the native C++ patch-loading pipeline.

A copy of noise_flow_tpu.data.native, which imports no JAX; the port keeps its own.

The reference fed the device from 4 stages of Python threads sharing the GIL
(ref:sidd/ImageLoader.py, PatchSampler.py, MiniBatchSampler.py). The native
loader (native/patch_loader.cc) runs the same stages as real C++ threads over
the preprocessed npy cache (data/cache.py): image decode, patch extraction,
and minibatch assembly all happen off the Python thread, so the host keeps
the card fed while Python only copies each batch to it.

Build on demand with `ensure_built()` (g++, no deps); `NativePatchLoader`
falls back to a clear error when no compiler is available — the pure-Python
`PatchDataset` path remains the portable default.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, Iterator, List, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libnfloader.so")

_lib = None


def ensure_built(force: bool = False) -> str:
    """Compile native/libnfloader.so if missing. Returns the library path."""
    src = os.path.join(NATIVE_DIR, "patch_loader.cc")
    if force or not os.path.exists(LIB_PATH) or (
            os.path.getmtime(LIB_PATH) < os.path.getmtime(src)):
        # build beside it and rename: a process that loads the library
        # meanwhile never sees a half-written file
        tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
        subprocess.run(
            ["g++", "-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall",
             "-shared", src, "-o", tmp],
            check=True, capture_output=True, text=True)
        os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load_lib():
    global _lib
    if _lib is None:
        path = ensure_built()
        lib = ctypes.CDLL(path)
        lib.nf_loader_create.restype = ctypes.c_void_p
        lib.nf_loader_create.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint, ctypes.c_int,
        ]
        lib.nf_loader_next.restype = ctypes.c_int
        lib.nf_loader_next.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_float)] * 6
        lib.nf_loader_reset.argtypes = [ctypes.c_void_p, ctypes.c_uint]
        lib.nf_loader_error.restype = ctypes.c_char_p
        lib.nf_loader_error.argtypes = [ctypes.c_void_p]
        lib.nf_loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativePatchLoader:
    """Streaming minibatches from a npy cache via the C++ pipeline.

    Yields the reference minibatch dict schema {_x, _y, nlf0, nlf1, iso, cam}
    (ref:sidd/MiniBatchSampler.py:66-69) with per-patch conditioning.
    """

    def __init__(self, cache_dir: str, patch_size: int, batch_size: int,
                 n_patches_per_image: int = 2898, n_threads: int = 8,
                 shuffle: bool = True, seed: int = 0,
                 sampling: str = "uniform"):
        from noise_flow_tpu_torch.data.cache import read_index

        if batch_size > 4096:
            raise ValueError("batch_size must be <= native ring capacity 4096")
        lib = _load_lib()
        index = read_index(cache_dir)
        if not index:
            raise FileNotFoundError(f"empty cache index in {cache_dir}")
        noise_paths = [os.path.join(cache_dir, e["stem"] + "_noise.npy").encode()
                       for e in index]
        clean_paths = [os.path.join(cache_dir, e["stem"] + "_clean.npy").encode()
                       for e in index]
        n = len(index)
        arr = lambda vals: (ctypes.c_float * n)(*[float(v) for v in vals])
        cp = lambda paths: (ctypes.c_char_p * n)(*paths)
        self._lib = lib
        self._h = lib.nf_loader_create(
            cp(noise_paths), cp(clean_paths),
            arr(e["nlf0"] for e in index), arr(e["nlf1"] for e in index),
            arr(e["iso"] for e in index), arr(e["cam"] for e in index),
            n, patch_size, n_patches_per_image, batch_size, n_threads,
            1 if shuffle else 0, seed, 1 if sampling == "random" else 0)
        self.patch_size = patch_size
        self.batch_size = batch_size
        self._epoch_seed = seed

    def __iter__(self) -> Iterator[Dict]:
        b, ph = self.batch_size, self.patch_size
        while True:
            x = np.empty((b, ph, ph, 4), np.float32)
            y = np.empty((b, ph, ph, 4), np.float32)
            nlf0 = np.empty((b,), np.float32)
            nlf1 = np.empty((b,), np.float32)
            iso = np.empty((b,), np.float32)
            cam = np.empty((b,), np.float32)
            ptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
            rc = self._lib.nf_loader_next(
                self._h, ptr(x), ptr(y), ptr(nlf0), ptr(nlf1), ptr(iso),
                ptr(cam))
            if rc == 1:
                return
            if rc == 2:
                raise RuntimeError(
                    "native loader: "
                    + self._lib.nf_loader_error(self._h).decode())
            yield {"_x": x, "_y": y, "nlf0": nlf0, "nlf1": nlf1,
                   "iso": iso, "cam": cam}

    def epoch(self, seed: Optional[int] = None) -> "NativePatchLoader":
        """Re-arm the pipeline for a fresh epoch (new shuffle order)."""
        self._epoch_seed = self._epoch_seed + 1 if seed is None else seed
        self._lib.nf_loader_reset(self._h, self._epoch_seed)
        return self

    def __del__(self):
        try:
            if getattr(self, "_h", None):
                self._lib.nf_loader_destroy(self._h)
                self._h = None
        except Exception:
            pass
