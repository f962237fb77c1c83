"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/kernels/lib<name>-<hash>.so`` at the root of the checkout (listed in
``.gitignore``), with ``-gencode arch=compute_90a,code=sm_90a``. The hash
covers the source, the headers of ``csrc/`` and the flags, so an edited
source or header is rebuilt. ``train_probe`` and the four
``train_variants_<design>_<precision>`` are the probe library of
``probes/train_template.py``: the attribution probes, and the train
kernels' template in the parent's design and the production one with its
ablations, one library a design and precision so that they build in
parallel; ``segment_probe`` the running-statistics eval forward's parent
design and its redesign with planted faults;
``sample_variants_<precision>`` those of ``probes/sampler.py``:
the sampler's template in the parent's design with its ablations and
designs; ``adam`` the optimizer's step (``ops/adam.py``). The build runs at
first use; ``build_all`` starts one nvcc per source, all at once.
Nothing is built or imported when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, List, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
# ctypes signature of each kernel's C entry point: name -> (argtypes, restype)
SIGNATURES = {
    "fused_sample": {
        "nf_fused_sample": ([_P] * 9 + [_I] * 4 + [ctypes.POINTER(_I), _I, _I, ctypes.c_uint,
                             ctypes.c_float, _I, _P, ctypes.POINTER(_I)], _I),
        "nf_rng_normals": ([_P, _I, ctypes.c_uint, ctypes.c_float, _P], _I),
        "nf_sample_plan": ([_I, _I] + [ctypes.POINTER(_I)] * 3, _I),
    },
    "fused_train": {
        "nf_train_step": ([_P] * 16 + [_I] * 5 + [ctypes.c_float] * 2 + [ctypes.POINTER(_I),
                          _I, _I, _P, ctypes.POINTER(_I)], _I),
        "nf_train_scratch": ([_I] * 6 + [ctypes.POINTER(ctypes.c_longlong)], _I),
        "nf_segment_forward": ([_P] * 7 + [_I] * 3 + [ctypes.POINTER(_I), _I, _I, _P,
                               ctypes.POINTER(_I)], _I),
        "nf_segment_occupancy": ([_I, ctypes.POINTER(_I)], _I),
        "nf_segment_train_forward": ([_P] * 9 + [_I] * 4 + [ctypes.POINTER(_I), _I, _I, _P,
                                     ctypes.POINTER(_I)], _I),
        "nf_segment_backward": ([_P] * 12 + [_I] * 4 + [ctypes.POINTER(_I), _I, _I, _P,
                                ctypes.POINTER(_I)], _I),
    },
    "train_probe": {
        "nf_probe_bn_chain": ([_I] * 2 + [_P] * 3 + [_I] * 4 + [_P, ctypes.POINTER(_I)], _I),
        "nf_probe_wgrad": ([_I] * 3 + [_P] * 3 + [_I, _P, ctypes.POINTER(_I)], _I),
        "nf_probe_launch": ([_I] * 3 + [_P] * 16 + [_I] * 5 + [ctypes.POINTER(_I), _I, _P,
                            ctypes.POINTER(_I)], _I),
    },
}
_PP = ctypes.POINTER(_P)
SIGNATURES["adam"] = {
    "nf_adam_step": ([_PP] * 5 + [ctypes.POINTER(_I), _I] + [ctypes.c_float] * 6
                     + [_P, ctypes.POINTER(_I)], _I),
    "nf_adam_limits": ([ctypes.POINTER(_I)] * 2, _I),
}
SIGNATURES["segment_probe"] = {
    "nf_segment_forward_parent": SIGNATURES["fused_train"]["nf_segment_forward"],
    "nf_segment_fault": ([_I] + SIGNATURES["fused_train"]["nf_segment_forward"][0], _I),
    "nf_segment_parent_occupancy": ([_I, ctypes.POINTER(_I)], _I),
}
_CHAIN = ([_I] + [_P] * 3 + [_I] * 2 + [_P, ctypes.POINTER(_I)], _I)
SIGNATURES["sample_probe"] = {
    "nf_mm_chain": ([_I, _I] + [_P] * 4 + [_I] * 2 + [_P, ctypes.POINTER(_I)], _I),
    "nf_chain_precast": ([_P, _P, _I, _P, ctypes.POINTER(_I)], _I),
    "nf_px_chain": _CHAIN,
}
SAMPLE_VARIANT_LIBRARIES = ("sample_variants_f32", "sample_variants_bf16")
for _name in SAMPLE_VARIANT_LIBRARIES:
    SIGNATURES[_name] = {
        "nf_sample_variant": ([_I] * 3 + [_P] * 9 + [_I] * 4 + [ctypes.POINTER(_I), _I, _I,
                              ctypes.c_uint, ctypes.c_float, _P, ctypes.POINTER(_I)], _I),
    }
VARIANT_LIBRARIES = tuple(f"train_variants_{design}_{precision}"
                          for design in ("parent", "prod") for precision in ("f32", "bf16"))
for _name in VARIANT_LIBRARIES:
    SIGNATURES[_name] = {
        "nf_train_scratch": ([_I] * 6 + [ctypes.POINTER(ctypes.c_longlong)], _I),
        "nf_variant_train_step": ([_P] * 16 + [_I] * 5 + [ctypes.c_float] * 2
                                  + [ctypes.POINTER(_I), _I, _P, ctypes.POINTER(_I)], _I),
        "nf_variant_segment_backward": ([_I] + [_P] * 12 + [_I] * 4
                                        + [ctypes.POINTER(_I), _I, _P, ctypes.POINTER(_I)], _I),
        "nf_variant_segment_train_forward": ([_I] + [_P] * 9 + [_I] * 4
                                             + [ctypes.POINTER(_I), _I, _P,
                                                ctypes.POINTER(_I)], _I),
    }

_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _target(name: str) -> Tuple[Path, Path]:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = tuple(SIGNATURES)) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, one nvcc process per
    source, all started together. Returns name -> shared library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {n: _target(n) for n in names}
    procs = {}
    for name, (src, so) in targets.items():
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
        else:
            os.replace(tmp, targets[name][1])
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: so for n, (_, so) in targets.items()}


def kernel_resources(name: str) -> List[Dict[str, object]]:
    """Each kernel of library ``name`` as ``-Xptxas -v`` reported it in this
    process's build (``build_logs``): its mangled name, registers, spill
    stores and loads (bytes) and static shared memory (bytes)."""
    out, cur = [], None
    for line in build_logs.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"kernel": m.group(1), "spill_stores": 0, "spill_loads": 0}
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["smem"] = int(sm.group(1)) if sm else 0
    return out


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built if needed."""
    if name not in _libs:
        so = build_all([name])[name]
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return _libs[name]
