"""Per-(cam, ISO) parity grid against the reference's PUBLISHED checkpoint.

The strongest paper-facing parity evidence available without the SIDD
dataset (VERDICT r3 item 2): for every row of the reference's camera-NLF
table (ref:cam_iso_nlf.txt:1-16 — the table its DnCNN pipeline samples
from, ref:train_dncnn_noiseflow.py:181-189), sample noise from the imported
published weights at that (cam, ISO) and compare against the camera's own
noise-level function:

- sampled noise std vs the NLF prediction sqrt(beta1*clean + beta2),
- marginal KLD (the reference's histogram KLD, ref:sidd_utils.py:1247-1263,
  same bin edges as calc_kldiv_mb, ref:sidd_utils.py:1044-1045) between
  NF-sampled noise and NLF-generated Gaussian noise,
- the same KLD between two independent NLF draws — the sampling-noise floor
  that calibrates how small "matching" can possibly read.

Conditioning mirrors the reference's in-training sampling protocol:
nlf0 == nlf1 == beta1 fed alongside (iso, cam)
(ref:train_noise_flow.py:158-159) — the published sdn5/gain4 arch reads only
(iso, cam); temp 1.0 so distributional parity is not temperature-flattered.

Port of noise_flow_tpu.analysis.ref_parity through the port's
``NoiseFlowWrapper``, which always samples through the fused sampler (its
CUDA kernel on the card, its plain version on the CPU), with the batch-BN
moments over each whole batch. JAX's ``use_pallas`` switch has no
counterpart; ``device`` (default ``cuda``) takes its place. The reference's
TF model directory is not in the tree: run it on an in-repo npz model, e.g.
``--model_dir experiments/sidd/prod_exact_150``.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from noise_flow_tpu_torch.data.sidd import CAM_IDS, load_cam_iso_nlf
from noise_flow_tpu_torch.utils.metrics import NOISE_BIN_EDGES, kl_div_3_data

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# clean-signal levels spanning the SIDD intensity range the flow was trained
# on; the NLF's signal dependence is what sdn5 must reproduce per cell
CLEAN_LEVELS = (0.05, 0.10, 0.30)


def grid_cell(wrapper, cam_iso: str, beta1: float, beta2: float,
              batch: int = 256, temp: float = 1.0,
              seed: int = 0) -> Dict[str, float]:
    """One (cam, ISO) cell: sample and compare vs the NLF."""
    cam_s, iso_s = cam_iso.split("_")
    iso = float(int(iso_s))
    cam = float(CAM_IDS.index(cam_s))
    ph = wrapper.cfg.patch_height
    nch = wrapper.cfg.n_channels
    rng = np.random.default_rng(seed)

    nf_chunks, nlf_chunks, nlf2_chunks = [], [], []
    pred_vars = []
    for lvl in CLEAN_LEVELS:
        clean = np.full((batch, ph, ph, nch), lvl, np.float32)
        noise = wrapper.sample_noise_nf(clean, beta1, beta1, iso=iso,
                                        cam=cam, temp=temp)
        nf_chunks.append(np.asarray(noise).ravel())
        sd = np.sqrt(beta1 * lvl + beta2)
        pred_vars.append(sd * sd)
        nlf_chunks.append(rng.standard_normal(noise.size) * sd)
        nlf2_chunks.append(rng.standard_normal(noise.size) * sd)

    nf = np.concatenate(nf_chunks)
    nlf = np.concatenate(nlf_chunks)
    nlf2 = np.concatenate(nlf2_chunks)
    pred_std = float(np.sqrt(np.mean(pred_vars)))

    _, _, kld_nf = kl_div_3_data(nlf, nf, bin_edges=NOISE_BIN_EDGES)
    _, _, kld_floor = kl_div_3_data(nlf, nlf2, bin_edges=NOISE_BIN_EDGES)
    return {
        "cam_iso": cam_iso, "beta1": beta1, "beta2": beta2,
        "pred_std": pred_std,
        "nf_std": float(np.std(nf)),
        "nf_mean": float(np.mean(nf)),
        "std_ratio": float(np.std(nf) / pred_std),
        "kld_nf_vs_nlf": float(kld_nf),
        "kld_floor": float(kld_floor),
        "n_values": int(nf.size),
    }


def run_grid(model_dir: str, out_dir: Optional[str] = None,
             nlf_table_path: Optional[str] = None, batch: int = 256,
             temp: float = 1.0, device="cuda",
             verbose: bool = True) -> List[Dict[str, float]]:
    """Full grid over the reference NLF table; optionally write the artifact
    (grid.tsv + summary) under out_dir."""
    from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper

    if nlf_table_path is None:
        nlf_table_path = os.path.join(REPO, "cam_iso_nlf.txt")
    table = load_cam_iso_nlf(nlf_table_path)
    wrapper = NoiseFlowWrapper(model_dir, sampling_temperature=temp, device=device)
    rows = []
    for i, (cam_iso, (b1, b2)) in enumerate(sorted(table.items())):
        row = grid_cell(wrapper, cam_iso, b1, b2, batch=batch, temp=temp,
                        seed=1000 + i)
        rows.append(row)
        if verbose:
            print(f"{cam_iso}: pred_std={row['pred_std']:.5f} "
                  f"nf_std={row['nf_std']:.5f} ratio={row['std_ratio']:.3f} "
                  f"KLD={row['kld_nf_vs_nlf']:.4f} "
                  f"(floor {row['kld_floor']:.4f})", flush=True)
    if out_dir:
        write_grid_artifact(rows, out_dir, model_dir, batch, temp)
    return rows


def write_grid_artifact(rows: List[Dict], out_dir: str, model_dir: str,
                        batch: int, temp: float) -> None:
    os.makedirs(out_dir, exist_ok=True)
    cols = ["cam_iso", "beta1", "beta2", "pred_std", "nf_std", "nf_mean",
            "std_ratio", "kld_nf_vs_nlf", "kld_floor", "n_values"]
    with open(os.path.join(out_dir, "grid.tsv"), "w") as f:
        f.write("\t".join(cols) + "\n")
        for r in rows:
            f.write("\t".join(
                str(r[c]) if isinstance(r[c], (str, int))
                else f"{r[c]:.6g}" for c in cols) + "\n")
    ratios = np.asarray([r["std_ratio"] for r in rows])
    klds = np.asarray([r["kld_nf_vs_nlf"] for r in rows])
    with open(os.path.join(out_dir, "summary.txt"), "w") as f:
        f.write(f"model_dir\t{model_dir}\n")
        f.write(f"cells\t{len(rows)}\nbatch_per_level\t{batch}\n")
        f.write(f"clean_levels\t{CLEAN_LEVELS}\ntemp\t{temp}\n")
        f.write(f"std_ratio_mean\t{ratios.mean():.4f}\n")
        f.write(f"std_ratio_min\t{ratios.min():.4f}\n")
        f.write(f"std_ratio_max\t{ratios.max():.4f}\n")
        f.write(f"kld_mean\t{klds.mean():.5f}\n")
        f.write(f"kld_max\t{klds.max():.5f}\n")


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model_dir", default=os.path.join(
        REPO, "experiments", "sidd", "prod_exact_150"))
    p.add_argument("--out_dir", default="ref_parity_torch")
    p.add_argument("--nlf_table", default=None)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--temp", type=float, default=1.0)
    p.add_argument("--device", default="cuda",
                   help="torch device to sample on (cuda, cuda:N or cpu)")
    a = p.parse_args(argv)
    run_grid(a.model_dir, a.out_dir, a.nlf_table, a.batch, a.temp, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
