"""DnCNN downstream comparison: the paper's four-source ordering.

Port of experiments/dncnn/run_comparison.py (ref:train_dncnn_noiseflow.py:
176-240, ref:test_dncnn_noiseflow.py:204-215), which imports the JAX
package. One DnCNN denoiser is trained for each noise source

  gauss   blind Gaussian, sigma ~ U[0.24, 11.5]/255 (ref:33-36)
  camnlf  per-(cam, ISO) heteroscedastic NLF from cam_iso_nlf.txt
  nf      a converged Noise Flow, sampled at every step by the fused
          sampler's in-kernel RNG mode (50% Gaussian-sigma augmentation,
          ref:150-163)
  real    the dataset's real noisy/clean pairs

on the TRAIN-split scene instances of a SIDD-format corpus
(``cli.make_sidd_scale``), and each is scored by PSNR and SSIM on
validation blocks built from the TEST-split scenes in the real SIDD
validation format (ValidationNoisyBlocksRaw.mat / ValidationGtBlocksRaw.mat,
[40, n_blk, 256, 256] Bayer), read through ``cli.test_dncnn`` with its
20-image ISO exclusion. The paper's core downstream claim: DnCNN-NF beats
DnCNN-Gauss.

Three more arguments than the JAX script: ``--device`` (default ``cuda``;
``--device cpu`` runs the plain PyTorch path, the sampler's plain version
included), and ``--seed`` and ``--dtype``, the arguments of every source's
``DnCNNTrainer`` (the DnCNN's initial weights, and its convolutions in
float32 or bfloat16; defaults 0 and float32, the JAX script's trainer
defaults). ``results.json`` carries the JAX script's keys, ``seed`` and
``dtype``, per source also the sampler's launches, the steps and the fit's
seconds, and ``device``, the card's name and power limit as ``nvidia-smi``
reads them.

Run on the card (the corpus first, about 30 GB):
    python -m noise_flow_tpu_torch.cli.make_sidd_scale
    python -m noise_flow_tpu_torch.cli.dncnn_comparison \\
        --out chiprun_out/dncnn_comparison
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from noise_flow_tpu_torch.cli.test_dncnn import evaluate_model, load_validation_blocks
from noise_flow_tpu_torch.data.dncnn_data import load_dncnn_data
from noise_flow_tpu_torch.data.sidd import (
    CAM_IDS,
    TRAIN_INSTANCE_IDS,
    load_cam_iso_nlf,
    load_image_tuple,
    sidd_filename_tuples,
    unpack_raw,
)
from noise_flow_tpu_torch.ops import fused_sample as fs
from noise_flow_tpu_torch.training.dncnn_trainer import DnCNNTrainer
from noise_flow_tpu_torch.utils.device import resolve_device
from noise_flow_tpu_torch.utils.image_metrics import mean_psnr_blocks, mean_ssim_blocks

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CAM_ISO_NLF = os.path.join(REPO, "cam_iso_nlf.txt")
SOURCES = ("gauss", "camnlf", "nf", "real")


def build_validation_blocks(data_root: str, out_dir: str, n_im: int = 40,
                            n_blk: int = 8, size: int = 256) -> tuple:
    """TEST-split scenes -> real-format validation block .mat files.

    [n_im, n_blk, size, size] Bayer like the SIDD Validation set
    (ref:test_dncnn_noiseflow.py:49-82), the same draws as the JAX script's,
    so one corpus gives the same files; ``load_validation_blocks`` then
    applies its 20-image ISO exclusion. Files already in ``out_dir`` are
    kept."""
    from scipy.io import savemat

    noisy_p = os.path.join(out_dir, "ValidationNoisyBlocksRaw.mat")
    gt_p = os.path.join(out_dir, "ValidationGtBlocksRaw.mat")
    if os.path.exists(noisy_p) and os.path.exists(gt_p):
        return noisy_p, gt_p
    tuples, _ = sidd_filename_tuples(data_root, "test", 10, 12)
    if len(tuples) < n_im:
        raise FileNotFoundError(f"need {n_im} test images under {data_root!r}, "
                                f"got {len(tuples)}")
    rng = np.random.default_rng(11)
    noisy_blocks = np.zeros((n_im, n_blk, size, size), np.float32)
    gt_blocks = np.zeros((n_im, n_blk, size, size), np.float32)
    for i in range(n_im):
        d = load_image_tuple(tuples[i])
        clean_b = unpack_raw(d["clean"][0])     # full Bayer frame
        noisy_b = unpack_raw((d["clean"] + d["noise"])[0])
        h, w = clean_b.shape
        for b in range(n_blk):
            # even offsets keep the Bayer phase (a block starts on an R site)
            y = 2 * int(rng.integers(0, (h - size) // 2))
            x = 2 * int(rng.integers(0, (w - size) // 2))
            gt_blocks[i, b] = clean_b[y:y + size, x:x + size]
            noisy_blocks[i, b] = noisy_b[y:y + size, x:x + size]
    os.makedirs(out_dir, exist_ok=True)
    savemat(noisy_p, {"ValidationNoisyBlocksRaw": noisy_blocks})
    savemat(gt_p, {"ValidationGtBlocksRaw": gt_blocks})
    return noisy_p, gt_p


def comparison_rows(cam_iso_nlf: str = CAM_ISO_NLF) -> List[tuple]:
    """(cam, iso, b1, b2) rows over the table's sorted items, as the JAX
    script builds them (``cli.train_dncnn`` takes the file's order)."""
    table = load_cam_iso_nlf(cam_iso_nlf)
    return [(CAM_IDS.index(k.split("_")[0]), float(int(k.split("_")[1])), b1, b2)
            for k, (b1, b2) in sorted(table.items())]


def device_name(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def make_trainer(src: str, rows: List[tuple], device, flow=None, **kw) -> DnCNNTrainer:
    """The trainer of one source at the JAX script's settings (lr 1e-3, and the
    DnCNN's defaults unless ``kw`` sets them); ``flow``, the frozen Noise
    Flow of 'nf'."""
    return DnCNNTrainer(noise_source=src, cam_iso_rows=rows,
                        noise_flow=flow if src == "nf" else None, lr=1e-3, device=device,
                        **kw)


def run_source(trainer: DnCNNTrainer, clean: np.ndarray, noisy: Optional[np.ndarray],
               noisy_mat: np.ndarray, ref_mat: np.ndarray, save_dir: str,
               epochs: int, batch: int, t0: Optional[float] = None) -> Dict:
    """Fit one trainer for ``epochs`` (one checkpoint, at the end) and score
    it on the blocks. ``t0``: the clock at which its ``train_s`` starts (the
    JAX script's starts before the trainer is built; default now)."""
    t0 = time.time() if t0 is None else t0
    before = fs.launch_counts["fused_sample_rng"]
    t_fit = time.time()
    trainer.fit(clean, save_dir, epochs=epochs, batch_size=batch,
                noisy=noisy if trainer.noise_source == "real" else None,
                save_every=epochs, verbose=False)
    fit_s = time.time() - t_fit
    launches = fs.launch_counts["fused_sample_rng"] - before
    psnr, _, ssim, _ = evaluate_model(trainer, noisy_mat, ref_mat)
    return {"psnr": float(psnr), "ssim": float(ssim), "train_s": round(time.time() - t0, 1),
            "fit_s": fit_s, "steps": epochs * (len(clean) // batch),
            "sampler_launches": int(launches)}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--data_root",
                   default=os.path.join(REPO, "data", "SIDD_Medium_Raw_synth", "Data"))
    p.add_argument("--flow_dir",
                   default=os.path.join(REPO, "experiments", "sidd", "prod_synth_scale"))
    p.add_argument("--val_dir", default=os.path.join(REPO, "data", "sidd_valblocks"))
    p.add_argument("--out", default=os.path.join(REPO, "chiprun_out", "dncnn_comparison"))
    p.add_argument("--epochs", type=int, default=45)
    p.add_argument("--batch", type=int, default=128)
    p.add_argument("--max_images", type=int, default=0)
    p.add_argument("--sources", default=",".join(SOURCES))
    p.add_argument("--seed", type=int, default=0, help="DnCNNTrainer(seed=)")
    p.add_argument("--dtype", choices=("float32", "bfloat16"), default="float32",
                   help="DnCNNTrainer(dtype=): the DnCNN's convolutions")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = resolve_device(a.device)   # raises where no card is present
    sources = a.sources.split(",")
    if set(sources) - set(SOURCES):
        raise SystemExit(f"--sources takes {SOURCES}, got {sources}")

    os.makedirs(a.out, exist_ok=True)
    build_validation_blocks(a.data_root, a.val_dir)
    noisy_mat, ref_mat = load_validation_blocks(a.val_dir)
    print(f"validation blocks: {noisy_mat.shape} (after ISO exclusion)", flush=True)
    base_psnr, _ = mean_psnr_blocks(ref_mat, noisy_mat)
    base_ssim = mean_ssim_blocks(ref_mat, noisy_mat)
    rows = comparison_rows()

    print("loading DnCNN training patches (train instances only)...", flush=True)
    clean, _, noisy = load_dncnn_data(
        a.data_root, cam_iso_nlf_path=CAM_ISO_NLF, with_noisy=True, batch_size=a.batch,
        max_images=a.max_images, instance_ids=TRAIN_INSTANCE_IDS)
    print(f"train patches: {clean.shape}", flush=True)

    flow = None
    if "nf" in sources:
        from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper
        flow = NoiseFlowWrapper(a.flow_dir, sampling_temperature=1.0, device=device).flow

    results = {}
    for src in sources:
        t0 = time.time()
        results[src] = run_source(make_trainer(src, rows, device, flow, seed=a.seed,
                                               dtype=a.dtype), clean, noisy,
                                  noisy_mat, ref_mat, os.path.join(a.out, f"DnCNN_{src}"),
                                  a.epochs, a.batch, t0=t0)
        r = results[src]
        print(f"{src}: PSNR={r['psnr']:.2f} dB SSIM={r['ssim']:.4f} ({r['train_s']}s; "
              f"{r['fit_s'] / max(r['steps'], 1) * 1e3:.3f} ms a step over {r['steps']} "
              f"steps, {r['sampler_launches']} sampler launches)", flush=True)

    results["noisy_input"] = {"psnr": float(base_psnr), "ssim": float(base_ssim)}
    with open(os.path.join(a.out, "results.json"), "w") as f:
        json.dump({"epochs": a.epochs, "batch": a.batch, "seed": a.seed, "dtype": a.dtype,
                   "n_train_patches": int(len(clean)),
                   "val_blocks": list(noisy_mat.shape),
                   "device": device_name(device),
                   "results": results}, f, indent=1)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
