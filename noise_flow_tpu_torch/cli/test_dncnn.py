"""DnCNN evaluation CLI: PSNR/SSIM on SIDD validation raw blocks.

Port of noise_flow_tpu.cli.test_dncnn (ref:test_dncnn_noiseflow.py:25-235)
with one more argument, ``--device`` (default ``cuda``). Blocks come from
``ValidationNoisyBlocksRaw.mat`` / ``ValidationGtBlocksRaw.mat`` ([n_im,
n_blk, 256, 256] Bayer, downloaded separately: the files must exist under
--set_dir, or pass --synthetic for a self-check). The reference's 20
non-{100..3200}-ISO images are excluded by index
(ref:test_dncnn_noiseflow.py:145-147). Each image's packed blocks are
denoised in one call.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time
from typing import List, Optional

import numpy as np

from noise_flow_tpu_torch.data.sidd import pack_raw, unpack_raw
from noise_flow_tpu_torch.training.dncnn_trainer import DnCNNTrainer
from noise_flow_tpu_torch.utils.image_metrics import mean_psnr_blocks, mean_ssim_blocks

# validation images whose ISO is outside {100..3200} (ref:145-147)
EXCLUDED_ISO_IMAGES = [1, 3, 5, 7, 10, 11, 13, 14, 15, 18, 19, 20, 23, 24, 25,
                       28, 31, 33, 35, 38]


def load_validation_blocks(set_dir: str):
    from scipy.io import loadmat
    noisy_p = os.path.join(set_dir, "ValidationNoisyBlocksRaw.mat")
    ref_p = os.path.join(set_dir, "ValidationGtBlocksRaw.mat")
    if not (os.path.exists(noisy_p) and os.path.exists(ref_p)):
        raise FileNotFoundError(
            f"validation blocks not found under {set_dir!r}; download "
            "ValidationNoisyBlocksRaw.mat / ValidationGtBlocksRaw.mat from "
            "the SIDD site or pass --synthetic")
    noisy = loadmat(noisy_p)["ValidationNoisyBlocksRaw"]
    ref = loadmat(ref_p)["ValidationGtBlocksRaw"]
    noisy = np.delete(noisy, EXCLUDED_ISO_IMAGES, axis=0)
    ref = np.delete(ref, EXCLUDED_ISO_IMAGES, axis=0)
    return noisy, ref


def synthetic_validation_blocks(n_im: int = 2, n_blk: int = 4,
                                size: int = 64, seed: int = 7):
    from noise_flow_tpu_torch.data.synthetic import make_synthetic_samples
    samples = make_synthetic_samples(n_images=n_im * n_blk, h=size, w=size,
                                     isos=[100, 800], seed=seed)
    ref = np.stack([unpack_raw(s["clean"][0]) for s in samples])
    noisy = np.stack([unpack_raw((s["clean"] + s["noise"])[0])
                      for s in samples])
    return (noisy.reshape(n_im, n_blk, 2 * size, 2 * size),
            ref.reshape(n_im, n_blk, 2 * size, 2 * size))


def evaluate_model(trainer: DnCNNTrainer, noisy_mat: np.ndarray,
                   ref_mat: np.ndarray):
    """Denoise every Bayer block -> (mean_psnr, psnrs, mean_ssim, res_mat)."""
    n_im, n_blk = noisy_mat.shape[:2]
    res_mat = np.zeros_like(ref_mat, dtype=np.float64)
    for i in range(n_im):
        packed = np.stack([pack_raw(noisy_mat[i, b]) for b in range(n_blk)])
        den = trainer.denoise(packed.astype(np.float32))
        for b in range(n_blk):
            res_mat[i, b] = unpack_raw(np.asarray(den[b]))
    mean_psnr, psnrs = mean_psnr_blocks(ref_mat, res_mat)
    mean_ssim = mean_ssim_blocks(ref_mat, res_mat)
    return mean_psnr, psnrs, mean_ssim, res_mat


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser("test_dncnn")
    p.add_argument("--set_dir", default="data", type=str)
    p.add_argument("--model_name", type=str, required=True)
    p.add_argument("--model_dir", type=str, default="")
    p.add_argument("--result_dir", default="results", type=str)
    p.add_argument("--epoch", type=int, default=0,
                   help="checkpoint epoch (0 = latest)")
    p.add_argument("--depth", type=int, default=9)
    p.add_argument("--filters", type=int, default=32)
    p.add_argument("--save_result", action="store_true")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    t0 = time.time()

    model_dir = args.model_dir or os.path.join("models", args.model_name)
    trainer = DnCNNTrainer(depth=args.depth, filters=args.filters, device=args.device)
    epoch = trainer.load(model_dir, args.epoch or None)
    logging.info("loaded %s @ epoch %d", model_dir, epoch)

    if args.synthetic:
        noisy_mat, ref_mat = synthetic_validation_blocks()
    else:
        noisy_mat, ref_mat = load_validation_blocks(args.set_dir)
    logging.info("validation blocks: %s", noisy_mat.shape)

    mean_psnr, psnrs, mean_ssim, res_mat = evaluate_model(
        trainer, noisy_mat, ref_mat)

    out_dir = os.path.join(args.result_dir, args.model_name, "SIDD")
    os.makedirs(out_dir, exist_ok=True)
    np.savetxt(os.path.join(out_dir, "psnr.txt"), [mean_psnr])
    np.savetxt(os.path.join(out_dir, "ssim.txt"), [mean_ssim])
    from scipy.io import savemat
    savemat(os.path.join(out_dir, "psnrs.mat"), {"psnrs": psnrs})
    if args.save_result:
        savemat(os.path.join(args.result_dir, args.model_name, "results.mat"),
                {"results": res_mat})
    with open(os.path.join(out_dir, "epc_psnr.txt"), "w") as f:
        f.write("epoch,psnr\n")
        f.write(f"{epoch},{mean_psnr}\n")

    print(f"Dataset: SIDD \t PSNR = {mean_psnr:2.2f}dB SSIM = {mean_ssim:.4f}")
    print(f"total time = {time.time() - t0:.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
