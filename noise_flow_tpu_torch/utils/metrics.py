"""Histogram / KL-divergence evaluation metrics.

Re-design of ref:sidd/sidd_utils.py:995-1058 (per-patch marginal KLD of
{Gaussian, camera-NLF, NoiseFlow, real} noise) and 1202-1274 (KL family).
The histogram/KLD math is vectorized numpy, copied from the numpy half of
noise_flow_tpu.utils.metrics. ``kldiv_batch`` and ``marginal_kld`` are the
on-device PyTorch counterparts of ``kldiv_batch_jax`` and
``marginal_kld_jax``: the same bin edges, the same clipping into the outer
bins, counts by ``torch.searchsorted`` and ``bincount``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from noise_flow_tpu_torch.data.sidd import unpack_raw


def get_histogram(data, bin_edges=None, left_edge=0.0, right_edge=1.0,
                  n_bins=1000):
    """Density histogram (counts / n) (ref:sidd_utils.py:1266-1274)."""
    if bin_edges is None:
        bw = (right_edge - left_edge) / n_bins
        bin_edges = np.arange(left_edge, right_edge + bw, bw)
    bin_centers = bin_edges[:-1] + np.diff(bin_edges) / 2.0
    n = np.prod(np.shape(data))
    hist, _ = np.histogram(data, bin_edges)
    return hist / n, bin_centers


def kl_div_forward(p, q):
    """(ref:sidd_utils.py:1202-1209)"""
    idx = ~(np.isnan(p) | np.isinf(p) | np.isnan(q) | np.isinf(q))
    p, q = p[idx], q[idx]
    idx = (p > 0) & (q > 0)
    p, q = p[idx], q[idx]
    return np.sum(p * np.log(p / q))


def kl_div_inverse(p, q):
    return kl_div_forward(q, p)


def kl_div_sym(p, q):
    return 0.5 * (kl_div_forward(p, q) + kl_div_inverse(p, q))


def kl_div_3(p, q):
    f = kl_div_forward(p, q)
    i = kl_div_inverse(p, q)
    return f, i, 0.5 * (f + i)


def kl_div_3_data(p_data, q_data, bin_edges=None, left_edge=0.0,
                  right_edge=1.0, n_bins=1000):
    """(ref:sidd_utils.py:1247-1263)"""
    if bin_edges is None:
        bw = (right_edge - left_edge) / n_bins
        bin_edges = np.arange(left_edge, right_edge + bw, bw)
    p, _ = get_histogram(p_data, bin_edges)
    q, _ = get_histogram(q_data, bin_edges)
    idx = (p > 0) & (q > 0)
    p, q = p[idx], q[idx]
    logp, logq = np.log(p), np.log(q)
    kl_fwd = np.sum(p * (logp - logq))
    kl_inv = np.sum(q * (logq - logp))
    return kl_fwd, kl_inv, 0.5 * (kl_fwd + kl_inv)


# Noise-model comparison bins (ref:sidd_utils.py:1044-1045)
_NOISE_BW = 0.2 / 64
NOISE_BIN_EDGES = np.concatenate(
    ([-1000.0], np.arange(-0.1, 0.1 + 1e-9, _NOISE_BW), [1000.0]))


def kldiv_patch(mb: Dict, x_samples: np.ndarray, i: int, sc_sd: float,
                rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Marginal KLD of one patch for the 4 noise models vs real noise
    (ref:sidd_utils.py:1015-1058). Returns [KLD_G, KLD_NLF, KLD_NF, KLD_R]."""
    rng = rng or np.random.default_rng(0)
    y = unpack_raw(mb["_y"][i])
    nlf0 = float(np.asarray(mb["nlf0"]).reshape(-1)[min(i, np.asarray(mb["nlf0"]).size - 1)])
    nlf1 = float(np.asarray(mb["nlf1"]).reshape(-1)[min(i, np.asarray(mb["nlf1"]).size - 1)])
    nlf_sd = np.sqrt(nlf0 * y + nlf1)
    ng = rng.normal(0, sc_sd, y.shape)            # Gaussian model
    ns = unpack_raw(x_samples[i])                 # NoiseFlow sample
    nl = nlf_sd * rng.normal(0, 1, y.shape)       # camera NLF model
    n = unpack_raw(mb["_x"][i])                   # real
    pats = (ng, nl, ns, n)
    hists = [get_histogram(p, bin_edges=NOISE_BIN_EDGES)[0] for p in pats]
    return np.asarray([kl_div_forward(hists[-1], h) for h in hists])


def kldiv_patch_set(i: int, mb: Dict, x_samples: np.ndarray, sc_sd: float,
                    subdir: Optional[str] = None, save_mat: bool = False,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Per-patch KLD of the 4 noise models + optional .mat visualization dump
    (ref:sidd_utils.py:1015-1058).

    With save_mat, writes the reference's artifact set into `subdir`: clean
    patch `y`, the four noise patches `ng/nl/ns/n` (Gaussian, camera-NLF,
    NoiseFlow, real), the clipped noisy composites `xg/xl/xs/x`, and the
    per-model KLD scalars `kl_ng/kl_nl/kl_ns` — each as `<tag>_<pid>.mat`
    with the array under key 'x', exactly the layout the reference's offline
    analysis consumed."""
    rng = rng or np.random.default_rng(0)
    klds = kldiv_patch(mb, x_samples, i, sc_sd, rng)
    if save_mat and subdir is not None:
        import os

        from scipy.io import savemat

        os.makedirs(subdir, exist_ok=True)
        y = unpack_raw(mb["_y"][i])
        nlf0 = float(np.asarray(mb["nlf0"]).reshape(-1)[0])
        nlf1 = float(np.asarray(mb["nlf1"]).reshape(-1)[0])
        vis_rng = np.random.default_rng(0)
        ng = vis_rng.normal(0, sc_sd, y.shape)
        nl = np.sqrt(nlf0 * y + nlf1) * vis_rng.normal(0, 1, y.shape)
        ns = unpack_raw(x_samples[i])
        n = unpack_raw(mb["_x"][i])
        pid = int(np.asarray(mb.get("pid", np.arange(len(mb["_x"]))))[i])
        arrs = {"y": y, "ng": ng, "nl": nl, "ns": ns, "n": n,
                "xg": np.clip(y + ng, 0.0, 1.0),
                "xl": np.clip(y + nl, 0.0, 1.0),
                "xs": np.clip(y + ns, 0.0, 1.0),
                "x": np.clip(y + n, 0.0, 1.0),
                "kl_ng": klds[0], "kl_nl": klds[1], "kl_ns": klds[2]}
        for tag, arr in arrs.items():
            savemat(os.path.join(subdir, "%s_%04d.mat" % (tag, pid)),
                    {"x": arr})
    return klds


def save_vis_mb(mb: Dict, out_dir: str) -> None:
    """Dump one minibatch for offline visualization
    (ref:sidd_utils.py:985-992: vis_mb.npy + vis_mb.txt)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    np.save(os.path.join(out_dir, "vis_mb.npy"),
            {k: np.asarray(v) for k, v in mb.items()
             if k not in ("metadata",)}, allow_pickle=True)
    with open(os.path.join(out_dir, "vis_mb.txt"), "w") as f:
        f.write("fn=%s" % mb.get("fn", ""))


def calc_kldiv_mb(mb: Dict, x_samples: np.ndarray, sc_sd: float,
                  step: int = 5, seed: int = 0,
                  vis_dir: Optional[str] = None) -> np.ndarray:
    """Average marginal KLD over every `step`-th patch of a minibatch
    (ref:sidd_utils.py:995-1012). With vis_dir, also writes the per-patch
    .mat artifact set under `vis_dir/<scene>/` like the reference."""
    rng = np.random.default_rng(seed)
    subdir = None
    if vis_dir is not None:
        import os

        subdir = os.path.join(vis_dir, str(mb.get("fn", "mb")).split("|")[0])
    klds = np.zeros(4)
    cnt = 0
    for i in range(0, mb["_x"].shape[0], step):
        klds += kldiv_patch_set(i, mb, x_samples, sc_sd, subdir,
                                save_mat=vis_dir is not None, rng=rng)
        cnt += 1
    return klds / max(cnt, 1)


def _hist_rows(vals, edges, right: bool):
    """Density histograms of each row of vals [P, N] over edges: values are
    clipped into the outer bins (not dropped as np.histogram does)."""
    nb = edges.shape[0] - 1
    idx = torch.clamp(torch.searchsorted(edges, vals.contiguous(), right=right) - 1, 0, nb - 1)
    rows = vals.shape[0]
    idx = idx + nb * torch.arange(rows, device=vals.device)[:, None]
    counts = torch.bincount(idx.reshape(-1), minlength=rows * nb).reshape(rows, nb)
    return counts.to(torch.float32) / vals.shape[1]


def _kl_rows(p, q):
    """Forward KLD of each row, over the bins where both are positive."""
    mask = (p > 0) & (q > 0)
    ratio = torch.where(mask, p / torch.where(q > 0, q, torch.ones_like(q)), torch.ones_like(p))
    return torch.sum(torch.where(mask, p * torch.log(ratio), torch.zeros_like(p)), dim=-1)


def kldiv_batch(ng, nl, ns, n, step: int = 5):
    """On-device twin of ``calc_kldiv_mb``'s KLD math: per-patch marginal KLD
    of the four noise stacks (Gaussian, camera-NLF, NoiseFlow sample, real)
    against the real noise, over every ``step``-th patch, with the reference
    bin edges (ref:sidd_utils.py:995-1058,1266-1274). Returns (sum_klds[4],
    n_patches): sums, so batches accumulate like the reference's mean of
    per-patch KLDs."""
    edges = torch.as_tensor(NOISE_BIN_EDGES, dtype=torch.float32, device=n.device)
    sel = slice(None, None, step)
    rows = n[sel].shape[0]
    hn = _hist_rows(n[sel].reshape(rows, -1), edges, right=True)
    klds = torch.stack([_kl_rows(hn, _hist_rows(t[sel].reshape(rows, -1), edges, right=True))
                        for t in (ng, nl, ns)] + [_kl_rows(hn, hn)], dim=1)
    return torch.sum(klds, dim=0), rows


def marginal_kld(real, synth, left=-0.1, right=0.1, n_bins=64):
    """On-device forward KLD between two noise tensors' marginals
    (``marginal_kld_jax``)."""
    edges = torch.linspace(left, right, n_bins + 1, device=real.device)
    p = _hist_rows(real.reshape(1, -1), edges, right=False)
    q = _hist_rows(synth.reshape(1, -1), edges, right=False)
    return _kl_rows(p, q)[0]
