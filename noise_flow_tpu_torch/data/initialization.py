"""Two-pass data initialization: datasets + stats + analytic baselines.

Re-design of ref:sidd/Initialization.py:17-92 (the reference's pass 1 spun up
the full thread pipeline to compute stats/baselines, tore it down, and rebuilt
it for training). Here pass 1 is a vectorized scan over the materialized
splits, and results are cached as .npy next to the logdir exactly like the
reference's PatchStatsCalculator cache (ref:PatchStatsCalculator.py:125-187).

A copy of noise_flow_tpu.data.initialization over the port's PatchDataset,
calc_pat_stats and calc_baselines, with the same pat_stats.npy cache.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from noise_flow_tpu_torch.data.patches import PatchDataset
from noise_flow_tpu_torch.data.stats import calc_baselines, calc_pat_stats


def divide_parts(n: int, n_parts: int) -> List[int]:
    """Split n items into n_parts near-equal counts (ref:sidd_utils.py:1359-1366)."""
    base = n // n_parts
    parts = [base] * n_parts
    for i in range(n - base * n_parts):
        parts[i] += 1
    return parts


def initialize_data_stats_baselines(
    train_samples: List[Dict],
    test_samples: List[Dict],
    patch_size: int,
    n_patches_per_image: int,
    batch_size: int,
    logdir: Optional[str] = None,
    sampling: str = "uniform",
    seed: int = 0,
) -> Tuple[PatchDataset, PatchDataset, Dict, float, float]:
    """-> (train_ds, test_ds, pat_stats, nll_gauss, nll_sdn).

    When `logdir` is given, stats/baselines are cached as
    `<logdir>/pat_stats.npy` and reloaded on rerun (reference semantics:
    compute once, reuse across restarts)."""
    tr = PatchDataset(train_samples, patch_size, n_patches_per_image,
                      sampling=sampling, seed=seed)
    ts = PatchDataset(test_samples, patch_size, n_patches_per_image,
                      sampling=sampling, seed=seed)

    cache = os.path.join(logdir, "pat_stats.npy") if logdir else None
    if cache and os.path.exists(cache):
        blob = np.load(cache, allow_pickle=True).item()
        return tr, ts, blob["stats"], blob["nll_gauss"], blob["nll_sdn"]

    stats = calc_pat_stats(tr.x, tr.y)
    nll_gauss, nll_sdn = calc_baselines(
        ts.batches(min(batch_size, len(ts)), drop_remainder=True),
        stats["sc_in_vr"])
    if cache:
        os.makedirs(logdir, exist_ok=True)
        np.save(cache, {"stats": stats, "nll_gauss": nll_gauss,  # type: ignore[arg-type]
                        "nll_sdn": nll_sdn})
    return tr, ts, stats, nll_gauss, nll_sdn
