"""Training CLI.

Port of noise_flow_tpu.cli.train (ref:train_noise_flow.py:217-541): the same
flags plus ``--device`` and ``--init_checkpoint``, the same artifacts
(hps.txt / model_vars.txt dumps, TSV logs train/test/sample.txt, per-epoch
console line, baseline NLL columns, best-model checkpoints). Single
process, one card.

Run (the published config on the card, fused kernels):
    python -m noise_flow_tpu_torch.cli.train \
        --arch "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc" --width 4 \
        --lr 1e-4 --n_batch_train 138 --patch_height 32 --use_pallas \
        --n_patches_per_image 2898 --epochs 2000 --logdir exp/nf
Smoke run without SIDD, on the CPU:
    python -m noise_flow_tpu_torch.cli.train --synthetic_data 2 --epochs 2 \
        --patch_height 32 --n_batch_train 8 --device cpu --logdir /tmp/nf
"""

from __future__ import annotations

import itertools
import logging
import os
import sys
import time
from typing import List, Optional

import numpy as np

from noise_flow_tpu_torch.cli.args import parse_config
from noise_flow_tpu_torch.config import save_hps
from noise_flow_tpu_torch.data.patches import PatchDataset
from noise_flow_tpu_torch.data.sidd import load_image_tuple, sidd_filename_tuples
from noise_flow_tpu_torch.data.stats import calc_baselines, calc_pat_stats
from noise_flow_tpu_torch.data.synthetic import make_synthetic_samples
from noise_flow_tpu_torch.training.trainer import MESH_ITEM, Trainer
from noise_flow_tpu_torch.utils.logger import add_trace_level


def load_split(args, cfg, train_or_test: str):
    """SIDD images (or synthetic fixtures) -> PatchDataset. With --cache_dir
    the decoded .MAT images are kept as npy (data/cache.py) and re-read from
    there on later runs."""
    if args.synthetic_data:
        seed = 0 if train_or_test == "train" else 9
        samples = make_synthetic_samples(
            n_images=args.synthetic_data, h=4 * cfg.patch_height,
            w=4 * cfg.patch_height, iso=args.iso or 100, seed=seed)
    else:
        from noise_flow_tpu_torch.data.bootstrap import check_download_sidd
        check_download_sidd(cfg.sidd_path, allow_download=args.download_sidd)
        first = cfg.start_tr_im_idx if train_or_test == "train" else cfg.start_ts_im_idx
        last = cfg.end_tr_im_idx if train_or_test == "train" else cfg.end_ts_im_idx
        max_inst = args.n_tr_inst if train_or_test == "train" else args.n_ts_inst
        cache_dir = os.path.join(args.cache_dir, train_or_test) if args.cache_dir else None
        if cache_dir and os.path.exists(os.path.join(cache_dir, "index.json")):
            from noise_flow_tpu_torch.data.cache import load_cached_samples
            samples = load_cached_samples(cache_dir)
            logging.info("%s split: %d images from cache %s",
                         train_or_test, len(samples), cache_dir)
        else:
            tuples, n_inst = sidd_filename_tuples(
                cfg.sidd_path, train_or_test, first, last,
                cam=args.camera, iso=args.iso, max_instances=max_inst)
            if not tuples:
                raise FileNotFoundError(
                    f"no SIDD scene instances under {cfg.sidd_path!r} "
                    f"(need SIDD_Medium_Raw; or pass --synthetic_data N)")
            logging.info("%s split: %d instances, %d image tuples",
                         train_or_test, n_inst, len(tuples))
            samples = [load_image_tuple(t) for t in tuples]
            if cache_dir:
                from noise_flow_tpu_torch.data.cache import write_cache_from_samples
                write_cache_from_samples(samples, cache_dir)
                logging.info("wrote npy cache to %s", cache_dir)
    return PatchDataset(samples, cfg.patch_height, cfg.n_patches_per_image,
                        sampling=cfg.patch_sampling, seed=cfg.seed,
                        shuffle_patches=args.shuffle_patches)


def main(argv: Optional[List[str]] = None) -> int:
    args, cfg = parse_config(argv)
    if args.coordinator_address:
        raise NotImplementedError(f"multi-process training is not ported yet: {MESH_ITEM}")
    if args.mesh > 1:
        raise NotImplementedError(f"training on {args.mesh} cards is not ported yet: {MESH_ITEM}")
    add_trace_level()
    logging.basicConfig(level=logging.INFO)
    t_start = time.time()

    # the card is asked for first: no data work on a machine without one
    from noise_flow_tpu_torch.utils.device import resolve_device
    device = resolve_device(args.device)

    # data + stats + analytic baselines (ref:train_noise_flow.py:264-280)
    tr = load_split(args, cfg, "train")
    ts = load_split(args, cfg, "test")
    logging.info("train patches: %d, test patches: %d", len(tr), len(ts))
    stats = calc_pat_stats(tr.x, tr.y)
    # clamp the baseline batch to the split size: a tiny smoke split would
    # otherwise yield no batch under drop_remainder
    nll_gauss, nll_sdn = calc_baselines(
        ts.batches(min(cfg.n_batch_test, len(ts)), drop_remainder=True), stats["sc_in_vr"])
    logging.info("baselines: NLL_G=%.3f NLL_SDN=%.3f", nll_gauss, nll_sdn)

    # --calc_*_only early exits (ref:Initialization.py:31-75 modes)
    if args.calc_pat_stats_and_baselines_only:
        os.makedirs(cfg.logdir, exist_ok=True)
        np.save(os.path.join(cfg.logdir, "pat_stats.npy"),
                {**stats, "nll_gauss": nll_gauss, "nll_sdn": nll_sdn}, allow_pickle=True)
        logging.info("stats+baselines written to %s/pat_stats.npy; exiting", cfg.logdir)
        return 0
    if args.calc_hists_only:
        from noise_flow_tpu_torch.data.histograms import calc_hists, plot_hists, save_hists
        hx = calc_hists([{"noise": tr.x, "clean": tr.y}])
        hy = calc_hists([{"noise": ts.x, "clean": ts.y}])
        os.makedirs(cfg.logdir, exist_ok=True)
        save_hists(cfg.logdir, hx, hy)
        plot_hists(hx, hy, cfg.logdir)
        logging.info("histograms written to %s; exiting", cfg.logdir)
        return 0

    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.utils.checkpoint import _format_path, _key_to_path, load_checkpoint

    flow = NoiseFlow(cfg.x_shape, cfg, device=device, seed=cfg.seed)
    if args.init_checkpoint:
        load_checkpoint(args.init_checkpoint, flow)
        logging.info("initial weights from %s", args.init_checkpoint)
    trainer = Trainer(flow, cfg)
    n_params = flow.num_params()
    logging.info("model: %s | %d params | device %s", cfg.arch, n_params, device)

    # config + variable dumps (ref:train_noise_flow.py:305-312)
    os.makedirs(cfg.logdir, exist_ok=True)
    save_hps(os.path.join(cfg.logdir, "hps.txt"), cfg, flow.get_layer_names(), n_params,
             extra={"synthetic_data": args.synthetic_data,
                    "native_loader": bool(args.native_loader),
                    "cache_dir": args.cache_dir or "", "num_processes": 1,
                    "device": str(device)})
    with open(os.path.join(cfg.logdir, "model_vars.txt"), "w") as f:
        for name, p in flow.named_parameters():
            f.write(f"{_format_path(_key_to_path(name))}\t{tuple(p.shape)}\n")

    # clamp batch sizes to split sizes (small synthetic smoke runs would
    # otherwise drop every batch under drop_remainder)
    bs_tr = min(cfg.n_batch_train, len(tr))
    bs_ts = min(cfg.n_batch_test, len(ts))
    bsc = not cfg.per_example_cond  # reference-compat conditioning

    def scalarize(it):
        for mb in it:
            if bsc:
                mb = dict(mb)
                for k in ("nlf0", "nlf1", "iso", "cam"):
                    mb[k] = np.full_like(mb[k], mb[k][-1])
            yield mb

    if args.native_loader:
        # C++ threaded pipeline over the npy cache (data/native.py)
        if not args.cache_dir:
            raise SystemExit("--native_loader requires --cache_dir")
        from noise_flow_tpu_torch.data.native import NativePatchLoader
        tr_loader = NativePatchLoader(
            os.path.join(args.cache_dir, "train"), cfg.patch_height, bs_tr,
            cfg.n_patches_per_image, shuffle=True, seed=cfg.seed, sampling=cfg.patch_sampling)
        ts_loader = NativePatchLoader(
            os.path.join(args.cache_dir, "test"), cfg.patch_height, bs_ts,
            cfg.n_patches_per_image, shuffle=False, seed=cfg.seed, sampling=cfg.patch_sampling)
        train_fn = lambda: scalarize(tr_loader.epoch())  # noqa: E731
        test_fn = lambda: scalarize(ts_loader.epoch(cfg.seed))  # noqa: E731
    else:
        train_fn = lambda: tr.batches(bs_tr, shuffle=True, seed=cfg.seed,  # noqa: E731
                                      drop_remainder=True, batch_scalar_cond=bsc)
        test_fn = lambda: ts.batches(bs_ts, drop_remainder=True,  # noqa: E731
                                     batch_scalar_cond=bsc)

    sample_fn = None
    if args.n_sample_batches:
        sample_fn = lambda: itertools.islice(test_fn(), args.n_sample_batches)  # noqa: E731

    if args.device_resident_data:
        if bsc:
            raise SystemExit("--device_resident_data needs per-example "
                             "conditioning (drop --batch_scalar_cond)")
        t0 = time.time()
        n_tr = trainer.stage_dataset(train_fn(), "train")
        n_ts = trainer.stage_dataset(test_fn(), "test", max_patches=args.staged_test_patches)
        logging.info("staged %d train + %d test patches on %s (%.1fs)",
                     n_tr, n_ts, device, time.time() - t0)
        trainer.sample_batches_cap = args.n_sample_batches

    trainer.fit(train_fn, test_fn, cfg.logdir, epochs=cfg.epochs, nll_gauss=nll_gauss,
                nll_sdn=nll_sdn, sc_sd=stats["sc_in_sd"], do_sampling=args.do_sample,
                verbose=True, sample_batches_fn=sample_fn)

    total = time.time() - t_start
    with open(os.path.join(cfg.logdir, "total_time.txt"), "w") as f:
        f.write(f"{total:.1f}\n")  # (ref:train_noise_flow.py:539-540)
    logging.info("done in %.1fs", total)
    return 0


if __name__ == "__main__":
    sys.exit(main())
