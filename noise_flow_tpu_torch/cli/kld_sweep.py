"""KLD-vs-temperature sweep over a trained model, per (camera, ISO).

Port of noise_flow_tpu.cli.kld_sweep (the experiment behind
ref:plotting/plot_kldiv_vs_temp.py) with one more flag, ``--device``
(default ``cuda``). For every (cam, iso) group of the test split and every
temperature, noise is drawn by the fused sampler (``ops.fused_sample``: its
CUDA kernel on the card, its plain PyTorch version on the CPU) in batch-BN
mode over the whole batch, as JAX's ``flow.sample(train=True)``; the
marginal KLD of {Gaussian, camera-NLF, NoiseFlow} vs real noise comes from
the reference's histogram estimator (``calc_kldiv_mb``,
ref:sidd_utils.py:995-1058). KLD_G and KLD_NLF depend on the data and the
estimator's own numpy seed only, so they equal JAX's on the same corpus.

Run:
    python -m noise_flow_tpu_torch.cli.kld_sweep \
        --model_dir experiments/sidd/prod_exact_150 \
        --sidd_path data/SIDD_Medium_Raw_synth/Data \
        --temps 0.2,0.4,0.5,0.6,0.7,0.8,1.0 --logdir kld_sweep_torch
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
from typing import Dict, List, Optional

import numpy as np
import torch

from noise_flow_tpu_torch.data.patches import PatchDataset
from noise_flow_tpu_torch.data.stats import calc_pat_stats
from noise_flow_tpu_torch.ops.fused_sample import build_sample_program, fused_sample
from noise_flow_tpu_torch.utils.metrics import calc_kldiv_mb

COLUMNS = ("cam", "iso", "temp", "KLD_G", "KLD_NLF", "KLD_NF", "KLD_R")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model_dir", type=str, required=True,
                   help="trained model dir (hps.txt + npz ckpt)")
    p.add_argument("--sidd_path", type=str, default=None)
    p.add_argument("--synthetic_data", type=int, default=0, metavar="N")
    p.add_argument("--temps", type=str, default="0.1,0.2,0.3,0.4,0.5,0.6,0.7,0.8,0.9,1.0")
    p.add_argument("--cam", type=str, default=None)
    p.add_argument("--iso", type=int, default=None)
    p.add_argument("--n_batch", type=int, default=138)
    p.add_argument("--n_patches_per_image", type=int, default=128)
    p.add_argument("--max_batches_per_group", type=int, default=4)
    p.add_argument("--logdir", type=str, default="./kld_sweep_torch")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to sample on (cuda, cuda:N or cpu)")
    return p.parse_args(argv)


def load_patches(args, cfg) -> PatchDataset:
    """The test split (or synthetic fixtures) as the JAX sweep reads it."""
    if args.synthetic_data:
        from noise_flow_tpu_torch.data.synthetic import make_synthetic_samples
        samples = make_synthetic_samples(
            n_images=args.synthetic_data, h=4 * cfg.patch_height,
            w=4 * cfg.patch_height, iso=args.iso or 100, seed=9)
    else:
        from noise_flow_tpu_torch.data.sidd import load_image_tuple, sidd_filename_tuples
        tuples, _ = sidd_filename_tuples(
            args.sidd_path or cfg.sidd_path, "test",
            cfg.start_ts_im_idx, cfg.end_ts_im_idx,
            cam=args.cam, iso=args.iso)
        if not tuples:
            raise FileNotFoundError("no SIDD test instances found; pass "
                                    "--sidd_path or --synthetic_data N")
        samples = [load_image_tuple(t) for t in tuples]
    return PatchDataset(samples, cfg.patch_height, args.n_patches_per_image)


def group_batches(ds: PatchDataset, cam_v: float, iso_v: float, n_batch: int,
                  max_batches: int) -> List[np.ndarray]:
    """Index sets of one (cam, iso) group's batches: at most ``max_batches``
    of ``n_batch``, one short batch if the group is smaller than a batch."""
    idx = np.where((ds.cam == cam_v) & (ds.iso == iso_v))[0]
    nb = min(max(len(idx) // n_batch, 1), max_batches)
    sels = [idx[bi * n_batch:(bi + 1) * n_batch] for bi in range(nb)]
    return [s for s in sels if len(s)]


def minibatch(ds: PatchDataset, sel: np.ndarray) -> Dict[str, np.ndarray]:
    return {"_x": ds.x[sel], "_y": ds.y[sel], "pid": ds.pid[sel],
            "nlf0": ds.nlf0[sel], "nlf1": ds.nlf1[sel],
            "iso": ds.iso[sel], "cam": ds.cam[sel]}


def sample_minibatch(program, mb: Dict[str, np.ndarray], temp: float, device,
                     generator: Optional[torch.Generator] = None, eps=None) -> np.ndarray:
    """NF noise for one minibatch, per-patch conditioning, one fused-sampler
    call with the batch-BN moments over the whole batch (bt = b). ``eps``
    (standard normals) replaces the draw from ``generator``."""
    cond = {k: torch.as_tensor(mb[src], dtype=torch.float32, device=device)
            for k, src in (("clean", "_y"), ("nlf0", "nlf0"), ("nlf1", "nlf1"),
                           ("iso", "iso"), ("cam", "cam"))}
    b = cond["clean"].shape[0]
    out = fused_sample(program, cond, temp=temp, eps=eps, generator=generator, bt=b)
    return out.cpu().numpy()


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    temps = [float(t) for t in args.temps.split(",")]

    from noise_flow_tpu_torch.utils.device import resolve_device
    from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper

    device = resolve_device(args.device)
    nf = NoiseFlowWrapper(args.model_dir, sampling_temperature=temps[0], device=device)
    program = build_sample_program(nf.flow, bn_mode="batch" if nf.bn_batch_stats else "running")
    ds = load_patches(args, nf.cfg)
    stats = calc_pat_stats(ds.x, ds.y)
    logging.info("sweep: %d patches, %d temps, device %s", len(ds), len(temps), device)

    keys = sorted({(float(c), float(i)) for c, i in zip(ds.cam, ds.iso)})
    os.makedirs(args.logdir, exist_ok=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    out_rows = []
    for cam_v, iso_v in keys:
        sels = group_batches(ds, cam_v, iso_v, args.n_batch, args.max_batches_per_group)
        for t in temps:
            klds = []
            for sel in sels:
                mb = minibatch(ds, sel)
                xs = sample_minibatch(program, mb, t, device, generator=gen)
                klds.append(calc_kldiv_mb(mb, xs, stats["sc_in_sd"]))
            kld = np.mean(np.stack(klds), axis=0)
            out_rows.append((cam_v, iso_v, t, *kld))
            logging.info("cam=%g iso=%g temp=%.2f  KLD_G=%.4f KLD_NLF=%.4f "
                         "KLD_NF=%.4f", cam_v, iso_v, t, kld[0], kld[1], kld[2])

    tsv = os.path.join(args.logdir, "kld_vs_temp.txt")
    with open(tsv, "w") as f:
        f.write("\t".join(COLUMNS) + "\n")
        for row in out_rows:
            f.write("\t".join(f"{v:g}" for v in row) + "\n")
    logging.info("wrote %s", tsv)

    # one plot per (cam, iso)
    try:
        from noise_flow_tpu_torch.analysis.plots import plot_kld_vs_temp
        for cam_v, iso_v in keys:
            rows = np.asarray([r[2:] for r in out_rows if r[0] == cam_v and r[1] == iso_v])
            plot_kld_vs_temp(rows[:, 0], rows[:, 1:], os.path.join(
                args.logdir, f"kld_vs_temp_cam{cam_v:g}_iso{iso_v:g}.png"))
    except Exception as e:  # matplotlib optional in minimal envs
        logging.warning("plotting skipped: %s", e)
    return 0


if __name__ == "__main__":
    sys.exit(main())
