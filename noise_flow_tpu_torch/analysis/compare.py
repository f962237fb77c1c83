"""Multi-experiment comparison figures (paper-figure equivalents).

Generic re-design of the reference's hardcoded figure scripts
(ref:plotting/plot.py — per-model NLL comparison panels;
ref:plotting/plot_2.py — single-model NLL + KLD + param-evolution panels;
ref:plotting/broken_ax.py — two-segment broken-y-axis NLL curves). The
reference hardcoded its experiment folder names and axis limits into 800
lines of dicts; here the same figures are functions over any list of run
directories that carry the standard train.txt / test.txt / sample.txt TSVs
(the schema both frameworks write).

A copy of noise_flow_tpu.analysis.compare, which imports no JAX: it reads
the port's TSVs as it reads JAX's.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# tab10 palette cycled twice, matching ref:plotting/broken_ax.py:21-28
COLORS = ["#1f77b4", "#ff7f0e", "#2ca02c", "#d62728", "#9467bd",
          "#8c564b", "#e377c2", "#7f7f7f", "#bcbd22", "#17becf"] * 2


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def read_run(run_dir: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Read the TSV logs of one experiment dir (ref:plot.py:25-28)."""
    out = {}
    for name in ("train", "test", "sample"):
        p = os.path.join(run_dir, f"{name}.txt")
        if not os.path.exists(p):
            continue
        with open(p) as f:
            header = f.readline().strip().split("\t")
            rows = [ln.strip().split("\t") for ln in f if ln.strip()]
        cols = {h: np.asarray([_f(r[i]) for r in rows if len(r) == len(header)])
                for i, h in enumerate(header)}
        out[name] = cols
    return out


def _f(s):
    try:
        return float(s)
    except ValueError:
        return np.nan


def _smooth(y: np.ndarray, k: int) -> np.ndarray:
    if k <= 1 or len(y) < k:
        return y
    kern = np.ones(k) / k
    return np.convolve(y, kern, mode="same")


def compare_nll(run_dirs: Sequence[str], legends: Optional[Sequence[str]],
                out_path: str, split: str = "test", smooth: int = 1,
                yscale: Optional[str] = "symlog",
                show_baselines: bool = True) -> str:
    """NLL-vs-epoch curves for several runs on one figure
    (the panel family of ref:plotting/plot.py:35-99)."""
    plt = _plt()
    legends = legends or [os.path.basename(d.rstrip("/")) for d in run_dirs]
    fig = plt.figure(figsize=(7.4, 5.2))
    drew_base = False
    for c, (d, leg) in enumerate(zip(run_dirs, legends)):
        run = read_run(d)
        if split not in run:
            continue
        t = run[split]
        plt.plot(t["epoch"], _smooth(t["NLL"], smooth),
                 color=COLORS[c % len(COLORS)], label=leg)
        if show_baselines and not drew_base and "NLL_G" in t:
            plt.axhline(np.nanmedian(t["NLL_G"]), ls="--", c="gray",
                        label="Gaussian")
            plt.axhline(np.nanmedian(t["NLL_SDN"]), ls=":", c="gray",
                        label="Camera NLF")
            drew_base = True
    plt.xlabel("Epoch")
    plt.ylabel("NLL")
    if yscale:
        plt.yscale(yscale)
    plt.legend(loc="best", fontsize=8)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def compare_nll_broken(run_dirs: Sequence[str],
                       legends: Optional[Sequence[str]], out_path: str,
                       ylims_top: Tuple[float, float],
                       ylims_bottom: Tuple[float, float],
                       split: str = "test", rows_top: int = 3,
                       rows_total: int = 4) -> str:
    """Broken-y-axis NLL comparison (ref:plotting/broken_ax.py:20-150):
    outliers (early epochs) on the top segment, converged detail below."""
    plt = _plt()
    from matplotlib import gridspec  # noqa: F401 (parity with reference)

    legends = legends or [os.path.basename(d.rstrip("/")) for d in run_dirs]
    fig = plt.figure(figsize=(7.4, 7.8))
    ax = plt.subplot2grid((rows_total, 1), (0, 0), rowspan=rows_top)
    ax2 = plt.subplot2grid((rows_total, 1), (rows_top, 0),
                           rowspan=rows_total - rows_top)
    for c, (d, leg) in enumerate(zip(run_dirs, legends)):
        run = read_run(d)
        if split not in run:
            continue
        t = run[split]
        for a in (ax, ax2):
            a.plot(t["epoch"], t["NLL"], color=COLORS[c % len(COLORS)],
                   label=leg)
    # the cut-out: top segment shows ylims_top, bottom shows ylims_bottom
    ax.set_ylim(*ylims_top)
    ax2.set_ylim(*ylims_bottom)
    ax.spines["bottom"].set_visible(False)
    ax2.spines["top"].set_visible(False)
    ax.tick_params(labelbottom=False, bottom=False)
    # diagonal cut markers (ref:broken_ax.py:95-104)
    kw = dict(transform=ax.transAxes, color="k", clip_on=False)
    dd = 0.012
    ax.plot((-dd, +dd), (-dd, +dd), **kw)
    ax.plot((1 - dd, 1 + dd), (-dd, +dd), **kw)
    kw = dict(transform=ax2.transAxes, color="k", clip_on=False)
    ax2.plot((-dd, +dd), (1 - dd, 1 + dd), **kw)
    ax2.plot((1 - dd, 1 + dd), (1 - dd, 1 + dd), **kw)
    ax2.set_xlabel("Epoch")
    ax2.set_ylabel("NLL")
    ax.legend(loc="upper center", fontsize=8, ncol=3)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def model_summary_panel(run_dir: str, out_path: str) -> str:
    """One-model panel: NLL curves + KLD curves + sd_z, the per-model figure
    set of ref:plotting/plot_2.py (which stitched plot_nll/plot_kld/
    plot_sdn_params per run)."""
    plt = _plt()
    run = read_run(run_dir)
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6))
    if "train" in run:
        axes[0].plot(run["train"]["epoch"], run["train"]["NLL"],
                     label="train", color=COLORS[0])
    if "test" in run:
        axes[0].plot(run["test"]["epoch"], run["test"]["NLL"],
                     label="test", color=COLORS[1])
        axes[0].axhline(np.nanmedian(run["test"]["NLL_G"]), ls="--",
                        c="gray", label="Gaussian")
        axes[0].axhline(np.nanmedian(run["test"]["NLL_SDN"]), ls=":",
                        c="gray", label="Camera NLF")
    axes[0].set_xlabel("Epoch")
    axes[0].set_ylabel("NLL")
    axes[0].legend(fontsize=7)
    if "sample" in run and "KLD_NF" in run["sample"]:
        s = run["sample"]
        for i, (k, leg) in enumerate((("KLD_G", "Gaussian"),
                                      ("KLD_NLF", "Camera NLF"),
                                      ("KLD_NF", "NoiseFlow"))):
            axes[1].plot(s["epoch"], s[k], label=leg, color=COLORS[i])
        axes[1].set_yscale("log")
        axes[1].set_xlabel("Epoch")
        axes[1].set_ylabel("marginal KLD")
        axes[1].legend(fontsize=7)
    if "test" in run and "sdz" in run["test"]:
        axes[2].plot(run["test"]["epoch"], run["test"]["sdz"],
                     color=COLORS[0])
        axes[2].axhline(1.0, ls="--", c="gray")
        axes[2].set_xlabel("Epoch")
        axes[2].set_ylabel("sd(z)")
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("runs", nargs="+", help="experiment dirs to compare")
    p.add_argument("--legends", type=str, default=None,
                   help="comma-separated legend names")
    p.add_argument("--out", type=str, default="compare_nll.png")
    p.add_argument("--split", type=str, default="test")
    p.add_argument("--broken", type=str, default=None,
                   help="broken-axis ylims 'top_lo,top_hi,bot_lo,bot_hi'")
    args = p.parse_args(argv)
    legends = args.legends.split(",") if args.legends else None
    if args.broken:
        a, b, c, d = [float(v) for v in args.broken.split(",")]
        return 0 if compare_nll_broken(args.runs, legends, args.out,
                                       (a, b), (c, d),
                                       split=args.split) else 1
    compare_nll(args.runs, legends, args.out, split=args.split)
    if len(args.runs) == 1:
        model_summary_panel(args.runs[0],
                            args.out.replace(".png", "_panel.png"))
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
