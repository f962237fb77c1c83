"""Patch statistics and analytic NLL baselines.

A copy of noise_flow_tpu.data.stats, which imports no JAX; the port keeps its own.

Re-design of ref:sidd/PatchStatsCalculator.py. The reference ran threaded
Welford accumulation over one epoch of minibatches (ref:PatchStatsCalculator.py:
190-242,343-402); here stats are a single vectorized pass (optionally sharded
per host and merged pairwise — the merge is stable).

Baselines (ref:PatchStatsCalculator.py:92-123):
  Gaussian:   nll = sum over patch of 0.5*(log 2pi + log vr_g + x^2/vr_g)
  Camera NLF: vr = y*nlf0 + nlf1 per pixel, same formula.
Both reported as the mean per-patch NLL over the test set (nats/patch).
"""

from __future__ import annotations

from typing import Dict, Iterable, Tuple

import numpy as np


def welford_merge(n_a, mean_a, m2_a, n_b, mean_b, m2_b):
    """Chan et al. pairwise merge — stable across host shards
    (ref:PatchStatsCalculator.py:376-402 did a weighted merge)."""
    n = n_a + n_b
    if n == 0:
        return 0, 0.0, 0.0
    delta = mean_b - mean_a
    mean = mean_a + delta * (n_b / n)
    m2 = m2_a + m2_b + delta * delta * (n_a * n_b / n)
    return n, mean, m2


def calc_pat_stats(x: np.ndarray, y: np.ndarray) -> Dict[str, float]:
    """Scalar stats over all noise (x) and clean (y) patch pixels
    (ref:PatchStatsCalculator.py:298-321)."""
    x64 = x.astype(np.float64)
    y64 = y.astype(np.float64)
    stats = {
        "sc_in_mean": float(x64.mean()),
        "sc_in_vr": float(x64.var()),
        "sc_gt_mean": float(y64.mean()),
        "sc_gt_vr": float(y64.var()),
    }
    stats["sc_in_sd"] = float(np.sqrt(stats["sc_in_vr"]))
    stats["sc_gt_sd"] = float(np.sqrt(stats["sc_gt_vr"]))
    stats["sc_in_std"] = stats["sc_in_sd"]
    stats["sc_gt_std"] = stats["sc_gt_sd"]
    return stats


def calc_baselines(batches: Iterable[Dict], sc_in_vr: float) -> Tuple[float, float]:
    """Mean per-patch Gaussian and camera-NLF NLLs over test minibatches
    (ref:PatchStatsCalculator.py:92-123). Batch dicts carry per-patch or
    per-batch nlf0/nlf1 — both broadcast."""
    nll_gauss_all = []
    nll_sdn_all = []
    for mb in batches:
        x = mb["_x"].astype(np.float64)
        y = mb["_y"].astype(np.float64)
        nlf0 = np.asarray(mb["nlf0"], np.float64).reshape(-1, 1, 1, 1)
        nlf1 = np.asarray(mb["nlf1"], np.float64).reshape(-1, 1, 1, 1)
        vr = y * nlf0 + nlf1
        nll_g = 0.5 * (np.log(2 * np.pi) + np.log(sc_in_vr) + x ** 2 / sc_in_vr)
        nll_gauss_all.append(np.sum(nll_g, axis=(1, 2, 3)))
        nll_s = 0.5 * (np.log(2 * np.pi) + np.log(vr) + x ** 2 / vr)
        nll_sdn_all.append(np.sum(nll_s, axis=(1, 2, 3)))
    # reference averages per-minibatch means (equal weight per batch,
    # ref:PatchStatsCalculator.py:117-120)
    nll_gauss = float(np.mean([np.mean(b) for b in nll_gauss_all]))
    nll_sdn = float(np.mean([np.mean(b) for b in nll_sdn_all]))
    return nll_gauss, nll_sdn


def bpd(nll: float, n_bins: float, n_dims: int) -> float:
    """nats/patch -> bits/dim with quantization offset (ref:sidd_utils.py:879-881)."""
    return (nll / n_dims + np.log(n_bins)) / np.log(2.0)
