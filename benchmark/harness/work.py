"""The work of one train step and of one sampler call, counted from shapes,
and the H100's peaks: the yardstick of the roofline and MFU metrics.

A frozen copy of the port's own arithmetic (``probes/train_template.py``
``_bound`` and ``_segment_work``, ``probes/sampler.py`` ``chain_work``). It
counts the useful multiply-adds of the published chain, whatever kernel or
library computes it, so that a later change of a kernel cannot raise a share
by counting more work:

- a coupling (conv template of width ``w`` over 4 channels) does, a pixel,
  ``9 * 2 * w`` (3x3 conv of the two coupled channels), ``w * w`` (1x1 conv)
  and ``9 * w * 4`` (the zero-conv) multiply-adds; an invertible 1x1 conv
  (a mix) does 16;
- the sampling direction runs the chain once: 2 FLOPs a multiply-add;
- a train step runs it forward and backward, the backward twice the forward
  (data and weight gradients): 6 FLOPs a multiply-add.

Bytes count each input read once and each output written once: the patches
(noise, clean; the sampler's in-kernel normals read nothing), the
per-example scale coefficients, the folded weights.
"""

from __future__ import annotations

from typing import Dict, Tuple

# NVIDIA H100 SXM data sheet, dense rates at the 700 W limit: float32 outside
# the tensor cores, HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12

H = W = 32
C = 4
REC = 288          # floats of a folded coupling record (ops/fused_sample.py REC)


def chain_counts(arch: str) -> Dict[str, int]:
    """Couplings, mixes and scale layers of an arch string whose ``unc``
    token is an invertible 1x1 conv and an affine coupling."""
    toks = arch.split("|")
    n_unc = sum(t == "unc" for t in toks)
    return {"couplings": n_unc, "mixes": n_unc, "scales": len(toks) - n_unc}


def macs_per_pixel(arch: str, width: int) -> int:
    n = chain_counts(arch)
    per_coupling = 9 * (C // 2) * width + width * width + 9 * width * C
    return n["couplings"] * per_coupling + n["mixes"] * C * C


def train_step_work(arch: str, width: int, batch: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one train step of ``batch`` patches."""
    n = chain_counts(arch)
    flops = 6.0 * macs_per_pixel(arch, width) * H * W * batch
    weights = n["couplings"] * (REC + H * W * C) + n["mixes"] * C * C
    nbytes = 4.0 * (3 * batch * H * W * C + batch + 2 * weights)
    return flops, nbytes


def sample_call_work(arch: str, width: int, batch: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of one sampler call of ``batch`` patches whose normals
    are drawn in the kernel (clean read, noise written)."""
    n = chain_counts(arch)
    flops = 2.0 * macs_per_pixel(arch, width) * H * W * batch
    nbytes = 4.0 * (2 * batch * H * W * C + 2 * batch * max(n["scales"], 1)
                    + n["couplings"] * REC + n["mixes"] * C * C)
    return flops, nbytes


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the FLOPs over the
    float32 peak and the bytes over the HBM bandwidth, in seconds."""
    return max(flops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES)
