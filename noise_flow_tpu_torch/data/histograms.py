"""Dataset intensity histograms (diagnostics).

A copy of noise_flow_tpu.data.histograms, which imports no JAX; the port keeps its own.

Re-design of ref:sidd/HistogramCalculator.py:15-149: accumulate 100-bin
histograms of noisy/clean intensities and noise values over a split, cache as
.npy, and render comparison figures. One vectorized pass per image instead of
the reference's queue-consumer loop.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, Optional, Tuple

import numpy as np

N_BINS = 100


def empty_hists() -> Dict:
    bw = 1.0 / N_BINS
    return {
        "noisy": np.zeros(N_BINS), "clean": np.zeros(N_BINS),
        "noise": np.zeros(N_BINS),
        "bin_edges": np.arange(0, 1 + bw, bw),
        "bin_edges_noise": np.arange(-0.5, 0.5 + bw, bw),
        "bin_width": bw, "n_pix": 0,
    }


def accumulate_hists(hists: Dict, sample: Dict) -> Dict:
    """sample: {'noise': [1,H,W,C], 'clean': [1,H,W,C]} (data.sidd schema)."""
    noise = sample["noise"]
    clean = sample["clean"]
    noisy = clean + noise
    hists["noisy"] += np.histogram(noisy, hists["bin_edges"])[0]
    hists["clean"] += np.histogram(clean, hists["bin_edges"])[0]
    hists["noise"] += np.histogram(noise, hists["bin_edges_noise"])[0]
    hists["n_pix"] += int(np.prod(noisy.shape))
    return hists


def calc_hists(samples: Iterable[Dict]) -> Dict:
    hists = empty_hists()
    for s in samples:
        accumulate_hists(hists, s)
    return hists


def merge_hists(a: Dict, b: Dict) -> Dict:
    """Pairwise merge (for per-host shards; counts are additive)."""
    out = dict(a)
    for k in ("noisy", "clean", "noise"):
        out[k] = a[k] + b[k]
    out["n_pix"] = a["n_pix"] + b["n_pix"]
    return out


def save_hists(logdir: str, tr: Dict, ts: Dict) -> None:
    np.save(os.path.join(logdir, "tr_hists.npy"), tr)  # type: ignore[arg-type]
    np.save(os.path.join(logdir, "ts_hists.npy"), ts)  # type: ignore[arg-type]


def load_hists(logdir: str) -> Tuple[Dict, Dict]:
    tr = np.load(os.path.join(logdir, "tr_hists.npy"), allow_pickle=True).item()
    ts = np.load(os.path.join(logdir, "ts_hists.npy"), allow_pickle=True).item()
    return tr, ts


def plot_hists(tr: Dict, ts: Dict, logdir: str) -> None:
    """Train/test comparison bars for noisy/clean/noise
    (ref:HistogramCalculator.py:96-149)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for key, edges_key in (("noisy", "bin_edges"), ("clean", "bin_edges"),
                           ("noise", "bin_edges_noise")):
        fig = plt.figure()
        x = tr[edges_key][:-1] + 0.5 * tr["bin_width"]
        plt.bar(x, tr[key], alpha=0.5, width=tr["bin_width"],
                label="Training subset")
        plt.bar(x, ts[key], alpha=0.5, width=tr["bin_width"],
                label="Testing subset")
        plt.legend()
        plt.title(f"{key} intensity histogram")
        fig.savefig(os.path.join(logdir, f"hist_{key}.png"),
                    bbox_inches="tight")
        plt.close(fig)
