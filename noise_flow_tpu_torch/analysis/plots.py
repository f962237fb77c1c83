"""Figures over experiment logs.

Re-design of ref:plotting/plot_nll.py, plot_kld.py, plot_kldiv_vs_temp.py,
plot_sdn_params.py, plot_gain_params.py. All consume this framework's outputs
(same TSV schema as the reference) and save .png; no interactive display.

Port of noise_flow_tpu.analysis.plots: the figures read the port's TSVs and
npz checkpoints (the JAX format); ``kld_vs_temp_sweep`` drives the port's
``Trainer.sample_epoch`` with a ``torch.Generator`` where JAX splits a key.
"""

from __future__ import annotations

import glob
import os
import re
from typing import Dict, List, Optional, Sequence

import numpy as np


def _read_tsv(path: str) -> Dict[str, np.ndarray]:
    with open(path) as f:
        header = f.readline().rstrip("\n").split("\t")
        rows = [ln.rstrip("\n").split("\t") for ln in f if ln.strip()]
    cols = {h: [] for h in header}
    for r in rows:
        for h, v in zip(header, r):
            try:
                cols[h].append(float(v))
            except ValueError:
                cols[h].append(np.nan)
    return {h: np.asarray(v) for h, v in cols.items()}


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_nll(logdirs: Sequence[str], labels: Optional[Sequence[str]] = None,
             out_path: str = "nll.png", per_dim: bool = False,
             n_dims: int = 4096) -> str:
    """Test-NLL curves with the Gaussian/NLF baselines as horizontal lines
    (ref:plotting/plot_nll.py:25-75)."""
    plt = _plt()
    fig = plt.figure(figsize=(7, 5))
    labels = labels or [os.path.basename(d.rstrip("/")) for d in logdirs]
    div = n_dims if per_dim else 1.0
    drew_baseline = False
    for d, lb in zip(logdirs, labels):
        t = _read_tsv(os.path.join(d, "test.txt"))
        plt.plot(t["epoch"], t["NLL"] / div, label=lb)
        if not drew_baseline and "NLL_G" in t and len(t["NLL_G"]):
            plt.axhline(t["NLL_G"][-1] / div, ls="--", c="gray",
                        label="Gaussian baseline")
            plt.axhline(t["NLL_SDN"][-1] / div, ls=":", c="gray",
                        label="Camera-NLF baseline")
            drew_baseline = True
    plt.xlabel("epoch")
    plt.ylabel("NLL (nats/dim)" if per_dim else "NLL (nats/patch)")
    plt.legend()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def plot_kld(logdirs: Sequence[str], labels: Optional[Sequence[str]] = None,
             out_path: str = "kld.png") -> str:
    """Marginal-KLD curves from sample.txt (ref:plotting/plot_kld.py:16-60):
    KLD_NF per run, plus the Gaussian/NLF model KLDs as reference lines."""
    plt = _plt()
    fig = plt.figure(figsize=(7, 5))
    labels = labels or [os.path.basename(d.rstrip("/")) for d in logdirs]
    drew = False
    for d, lb in zip(logdirs, labels):
        t = _read_tsv(os.path.join(d, "sample.txt"))
        plt.plot(t["epoch"], t["KLD_NF"], label=f"{lb} (NF)")
        if not drew and len(t["KLD_G"]):
            plt.axhline(np.nanmedian(t["KLD_G"]), ls="--", c="gray",
                        label="Gaussian")
            plt.axhline(np.nanmedian(t["KLD_NLF"]), ls=":", c="gray",
                        label="Camera NLF")
            drew = True
    plt.xlabel("epoch")
    plt.ylabel("marginal KL divergence")
    plt.yscale("log")
    plt.legend()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def kld_vs_temp_sweep(trainer, batches_fn, temps: Sequence[float], generator,
                      sc_sd: float) -> np.ndarray:
    """KLD of flow samples vs real noise across sampling temperatures
    (the experiment behind ref:plotting/plot_kldiv_vs_temp.py).
    ``generator`` (a ``torch.Generator`` on the trainer's device) draws the
    latents of every temperature in turn.
    Returns [len(temps), 4] KLD rows (G, NLF, NF, R)."""
    rows = []
    for t in temps:
        _, _, kld = trainer.sample_epoch(batches_fn(), float(t), generator,
                                         sc_sd=sc_sd, fix_cam_iso=False)
        rows.append(kld)
    return np.stack(rows)


def plot_kld_vs_temp(temps: Sequence[float], klds: np.ndarray,
                     out_path: str = "kld_vs_temp.png") -> str:
    plt = _plt()
    fig = plt.figure(figsize=(6, 4))
    plt.plot(temps, klds[:, 2], "o-", label="NoiseFlow")
    plt.axhline(np.nanmedian(klds[:, 0]), ls="--", c="gray", label="Gaussian")
    plt.axhline(np.nanmedian(klds[:, 1]), ls=":", c="gray", label="Camera NLF")
    best = temps[int(np.argmin(klds[:, 2]))]
    plt.axvline(best, c="C1", alpha=0.5, label=f"best temp={best:g}")
    plt.xlabel("sampling temperature")
    plt.ylabel("marginal KLD (NF vs real)")
    plt.legend()
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def _load_ckpt_series(ckpt_dir: str, key_patterns: Sequence[str]):
    """Scan model.ckpt-<epoch>.npz files and extract matching param leaves.
    The port's checkpoints also hold the optimizer's slots, keyed
    ``opt|torch/<parameter name>/...``; those are skipped."""
    series: Dict[str, List] = {}
    epochs = []
    paths = []
    for p in glob.glob(os.path.join(ckpt_dir, "model.ckpt-*.npz")):
        m = re.search(r"model\.ckpt-(\d+)\.npz$", p)
        if m:
            paths.append((int(m.group(1)), p))
    for ep, p in sorted(paths):
        with np.load(p) as z:
            epochs.append(ep)
            for k in z.files:
                if not k.startswith("opt|") and any(re.search(pat, k) for pat in key_patterns):
                    series.setdefault(k, []).append(np.asarray(z[k]).ravel())
    return np.asarray(epochs), {k: np.stack(v) for k, v in series.items()}


def plot_param_evolution(ckpt_dir: str, out_path: str = "params.png",
                         key_patterns: Sequence[str] = (r"sdn_gain",)) -> str:
    """Evolution of the sdn/gain conditioning parameters across epoch
    checkpoints (ref:plotting/plot_sdn_params.py, plot_gain_params.py)."""
    plt = _plt()
    epochs, series = _load_ckpt_series(ckpt_dir, key_patterns)
    fig = plt.figure(figsize=(7, 5))
    for k, v in series.items():
        short = k.split("|")[-1].replace("shared/", "")
        for j in range(v.shape[1]):
            lbl = short if v.shape[1] == 1 else f"{short}[{j}]"
            plt.plot(epochs, v[:, j], label=lbl)
    plt.xlabel("epoch")
    plt.ylabel("parameter value")
    if series:
        plt.legend(fontsize=7, ncol=2)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path


def load_cam_iso_nlf_all(path: str = "cam_iso_nlf_all.txt"):
    """Parse the full per-camera NLF table (ref:plotting/plot_gain_params.py:
    load_cam_iso_nlf over cam_iso_nlf_all.txt). Returns
    {cam_id: [(iso, beta1), ...]} sorted by iso."""
    prof: Dict[str, list] = {}
    with open(path) as f:
        header = f.readline()
        assert header.startswith("cam_iso")
        for ln in f:
            ln = ln.strip()
            if not ln:
                continue
            cam_iso, b1, _b2 = ln.split(",")
            prof.setdefault(cam_iso[:2], []).append(
                (float(cam_iso[3:]), float(b1)))
    return {k: sorted(set(v)) for k, v in prof.items()}


def plot_gain_vs_nlf(ckpt_dir: str, out_path: str = "gain_vs_nlf.png",
                     nlf_all_path: str = "cam_iso_nlf_all.txt",
                     c_gain: float = 1.0) -> str:
    """Learned per-ISO gain curve vs the cameras' NLF beta1 profiles
    (ref:plotting/plot_gain_params.py — the figure that checks whether the
    learned gain ~ exp(gain_params[iso])*iso tracks the real per-camera
    noise-level slopes). Left panel: gain_params evolution over epochs;
    right panel: final learned gain per ISO against each camera's NLF beta1
    (both normalized to their ISO-100 value, the scale-free comparison).
    c_gain must match the shared sdn_gain group's c (1.0 for sdn4/5/6,
    ref:cond_utils.py:184)."""
    plt = _plt()
    epochs, series = _load_ckpt_series(ckpt_dir, (r"gain_params",))
    fig, axes = plt.subplots(1, 2, figsize=(11, 4.5))
    iso_vals = np.array([100.0, 400.0, 800.0, 1600.0, 3200.0])
    gp_series = None
    for k, v in series.items():
        if v.shape[1] != 5:
            continue
        gp_series = v
        for j, iso in enumerate(iso_vals):
            axes[0].plot(epochs, v[:, j], label=f"gain_params[{int(iso)}]")
    axes[0].set_xlabel("epoch")
    axes[0].set_ylabel("gain_params value")
    axes[0].legend(fontsize=7)
    if gp_series is not None:
        gain = np.exp(c_gain * gp_series[-1]) * iso_vals
        axes[1].plot(iso_vals, gain / gain[0], "ko-", lw=2,
                     label="learned gain (norm.)")
    try:
        for cam, prof in load_cam_iso_nlf_all(nlf_all_path).items():
            isos = np.array([p[0] for p in prof])
            b1 = np.array([p[1] for p in prof])
            axes[1].plot(isos, b1 / b1[0], "--", alpha=0.7,
                         label=f"{cam} NLF beta1 (norm.)")
    except FileNotFoundError:
        pass
    axes[1].set_xlabel("ISO")
    axes[1].set_ylabel("relative to ISO 100")
    axes[1].set_xscale("log")
    axes[1].legend(fontsize=7)
    fig.savefig(out_path, bbox_inches="tight")
    plt.close(fig)
    return out_path
