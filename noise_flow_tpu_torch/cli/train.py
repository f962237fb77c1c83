"""Training CLI.

Port of noise_flow_tpu.cli.train (ref:train_noise_flow.py:217-541): the same
flags plus ``--device``, ``--init_checkpoint`` and ``--dist_backend``, the
same artifacts (hps.txt / model_vars.txt dumps, TSV logs
train/test/sample.txt, per-epoch console line, baseline NLL columns,
best-model checkpoints, the ``pat_stats_baselines.npz`` stats cache under
``--cache_dir``, keyed by JAX's fingerprint, so that either package reads
the other's).

Data-parallel training, one rank a device, in JAX's two modes:
- ``--mesh N`` (0: every visible card; 1 on the CPU) starts N ranks itself,
  on cuda:0..N-1 (or N CPU processes with ``--device cpu``). Every rank reads
  the whole data, iterates the same batches of ``--n_batch_train`` and
  trains on its contiguous slice of each; the stats are computed over the
  whole data, as in JAX's single process.
- ``--coordinator_address host:port --num_processes P --process_id i``
  (JAX multi-host): one rank a process, on ``--device`` (``cuda`` alone
  picks card ``i`` mod the visible cards). Each process loads its
  ``host_shard`` of the SIDD image tuples (synthetic data is not sharded,
  as in JAX), feeds batches of ``n_batch_train // P``, runs the fewest
  steps any process has, and merges the stats over processes.
The process group's backend is nccl on the card and gloo on the CPU;
``--dist_backend gloo`` puts ranks that share one card on gloo (nccl refuses
two ranks on one card). Only rank 0 writes logs, checkpoints and the cache.
``--steps_per_call K`` holds in both modes: on nccl each rank's full group
of K is one CUDA graph replay with its all-reduces inside, on gloo K eager
steps (``Trainer.graphs_on``).

The published multi-process recipe (jobs/job_noise_flow.sh ``multihost``:
global batch 276 over 2 processes), on one host with two cards:
    python -m noise_flow_tpu_torch.cli.train --n_batch_train 276 \
        --coordinator_address localhost:29500 --num_processes 2 \
        --process_id $I ...        # I = 0 and 1, one process each

Run (the published config on the card, fused kernels):
    python -m noise_flow_tpu_torch.cli.train \
        --arch "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc" --width 4 \
        --lr 1e-4 --n_batch_train 138 --patch_height 32 --use_pallas \
        --n_patches_per_image 2898 --epochs 2000 --logdir exp/nf
A run longer than one sitting: ``--stop_after SECONDS`` stops it as Ctrl-C
does (the epoch in progress finishes, then a checkpoint is saved), and the
same command with ``--continue_training`` resumes from that checkpoint.
The loading is split into its parts (decode of each split, stats and
baselines, staging): printed, and written to ``loading.json`` in the logdir
with the patch sets' content signatures.

Smoke run without SIDD, on the CPU:
    python -m noise_flow_tpu_torch.cli.train --synthetic_data 2 --epochs 2 \
        --patch_height 32 --n_batch_train 8 --device cpu --logdir /tmp/nf
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import signal
import sys
import threading
import time
from typing import List, Optional

import numpy as np

from noise_flow_tpu_torch.cli.args import parse_config
from noise_flow_tpu_torch.config import save_hps
from noise_flow_tpu_torch.data.patches import PatchDataset
from noise_flow_tpu_torch.data.sidd import load_image_tuple, sidd_filename_tuples
from noise_flow_tpu_torch.data.stats import calc_baselines
from noise_flow_tpu_torch.data.synthetic import make_synthetic_samples
from noise_flow_tpu_torch.parallel import distributed as pd
from noise_flow_tpu_torch.parallel.mesh import mesh_ranks
from noise_flow_tpu_torch.training.trainer import Trainer
from noise_flow_tpu_torch.utils.logger import add_trace_level


def load_split(args, cfg, train_or_test: str, shard=None):
    """SIDD images (or synthetic fixtures) -> PatchDataset. With --cache_dir
    the decoded .MAT images are kept as npy (data/cache.py) and re-read from
    there on later runs. Of the SIDD image tuples, this process's
    ``host_shard`` only: ``shard`` = (process index, process count), by
    default coordinator mode's."""
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
            pi, pc = shard or (pd.process_index(), pd.process_count())
            if pc > 1:
                # per-process file shard: every process enumerates the
                # identical global list and takes a disjoint slice
                tuples = pd.host_shard(tuples, pi, pc)
            logging.info("%s split: %d instances, %d image tuples (process %d)",
                         train_or_test, n_inst, len(tuples), pi)
            samples = [load_image_tuple(t) for t in tuples]
            if cache_dir:
                from noise_flow_tpu_torch.data.cache import write_cache_from_samples
                write_cache_from_samples(samples, cache_dir)
                logging.info("wrote npy cache to %s", cache_dir)
    return PatchDataset(samples, cfg.patch_height, cfg.n_patches_per_image,
                        sampling=cfg.patch_sampling, seed=cfg.seed,
                        shuffle_patches=args.shuffle_patches)


def content_sig(arr):
    """Strided sample moments across the whole patch set: cheap, and a
    same-size regeneration with different content changes it (JAX's)."""
    sub = np.asarray(arr[::max(1, len(arr) // 64)]).reshape(-1)
    sub = sub[::max(1, sub.size // 65536)]
    return (round(float(sub.mean()), 9), round(float(sub.std()), 9))


def stats_fingerprint(args, cfg, tr, ts) -> str:
    """The stats cache's key: the patch-extraction config and the data, in
    the repr JAX's cli.train writes, so that a cache of either package is
    valid for the other."""
    return repr((len(tr), len(ts), cfg.patch_height, cfg.n_patches_per_image,
                 cfg.patch_sampling, min(cfg.n_batch_test, len(ts)), cfg.camera, cfg.iso,
                 args.shuffle_patches, cfg.seed, content_sig(tr.x), content_sig(ts.x)))


def stats_and_baselines(args, cfg, tr, ts):
    """(stats, nll_gauss, nll_sdn): patch stats and analytic baselines
    (ref:train_noise_flow.py:264-280), merged over processes in coordinator
    mode. With --cache_dir they are cached in pat_stats_baselines.npz beside
    the decoded data, keyed by ``stats_fingerprint``: a changed extraction
    config or regenerated data recomputes. Rank 0's fingerprint decides for
    every rank (the cached stats are global); rank 0 writes the cache while
    the others wait."""
    stats_cache = (os.path.join(args.cache_dir, "pat_stats_baselines.npz")
                   if args.cache_dir else None)
    fingerprint = stats_fingerprint(args, cfg, tr, ts)
    hit = False
    if stats_cache and os.path.exists(stats_cache):
        z = np.load(stats_cache)
        hit = "fingerprint" in z.files and str(z["fingerprint"]) == fingerprint
        if not hit:
            logging.info("stats cache %s fingerprint mismatch (extraction config "
                         "changed): recomputing", stats_cache)
    if pd.world_size() > 1 and stats_cache:
        hit = bool(pd.all_gather_host(np.asarray([int(hit)], np.int32))[0, 0])
    if hit:
        z = np.load(stats_cache)
        stats = {k: float(z[k]) for k in z.files
                 if k not in ("nll_gauss", "nll_sdn", "fingerprint")}
        logging.info("stats+baselines from %s", stats_cache)
        return stats, float(z["nll_gauss"]), float(z["nll_sdn"])
    stats = pd.global_scalar_stats(tr.x, tr.y)
    # clamp the baseline batch to the split size: a tiny smoke split would
    # otherwise yield no batch under drop_remainder
    nll_gauss, nll_sdn = calc_baselines(
        ts.batches(min(cfg.n_batch_test, len(ts)), drop_remainder=True), stats["sc_in_vr"])
    nll_gauss, nll_sdn = pd.global_baselines(nll_gauss, nll_sdn)
    if stats_cache:
        if pd.rank() == 0:
            np.savez(stats_cache, nll_gauss=nll_gauss, nll_sdn=nll_sdn,
                     fingerprint=fingerprint, **stats)
        pd.barrier()
    return stats, nll_gauss, nll_sdn


class StopTimer:
    """Raise SIGINT in this process at ``deadline`` (``time.time()``), once
    ``Trainer.fit``'s Ctrl-C handler is installed: fit then finishes the
    epoch, saves a checkpoint and returns. While the timer lives, SIGINT that
    lands outside fit is taken by a handler that only notes it, so that no
    KeyboardInterrupt escapes around fit. ``close()`` stops the timer and
    puts the previous handler back. Main thread only."""

    def __init__(self, deadline: float):
        self.deadline = deadline
        self._done = threading.Event()
        self._prev = signal.signal(signal.SIGINT, self._outside)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _outside(self, signum, frame):
        logging.info("SIGINT outside the epoch loop: ignored")

    def _run(self):
        if self._done.wait(max(self.deadline - time.time(), 0.0)):
            return
        while signal.getsignal(signal.SIGINT) == self._outside:
            if self._done.wait(0.2):
                return
        logging.info("--stop_after: the deadline passed; stopping after this epoch")
        os.kill(os.getpid(), signal.SIGINT)

    def close(self):
        self._done.set()
        self._thread.join()
        signal.signal(signal.SIGINT, self._prev)


def main(argv: Optional[List[str]] = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    args, cfg = parse_config(argv)
    add_trace_level()
    logging.basicConfig(level=logging.INFO)
    if args.stop_after is not None and (args.coordinator_address
                                        or mesh_ranks(args.mesh, args.device) > 1):
        raise SystemExit("--stop_after stops one rank; it takes no --mesh or coordinator")
    if args.coordinator_address:
        if args.num_processes is None or args.process_id is None:
            raise ValueError("--coordinator_address needs --num_processes and --process_id")
        device = args.device
        if device == "cuda":
            import torch

            device = f"cuda:{args.process_id % max(torch.cuda.device_count(), 1)}"
        pd.initialize_distributed(args.coordinator_address, args.num_processes,
                                  args.process_id,
                                  args.dist_backend or pd.default_backend(device))
        try:
            return _train(args, cfg, device)
        finally:
            pd.shutdown()
    n = mesh_ranks(args.mesh, args.device)
    if n > 1 and pd.world_size() == 1:
        pd.spawn_ranks(n, _rank_main, (argv,), args.device, args.dist_backend)
        return 0
    return _train(args, cfg, args.device)


def _rank_main(rank, device, argv):
    """One rank of ``--mesh N``: the run on ``device`` in the group."""
    args, cfg = parse_config(argv)
    logging.basicConfig(level=logging.INFO)
    _train(args, cfg, str(device))


def _train(args, cfg, device_name: str) -> int:
    t_start = time.time()
    # the card is asked for first: no data work on a machine without one
    from noise_flow_tpu_torch.utils.device import resolve_device
    device = resolve_device(device_name)
    if device.type == "cuda" and device.index is not None:
        # nccl's collectives (the stats below) run on the current card
        import torch

        torch.cuda.set_device(device)
    chief = pd.rank() == 0

    # data + stats + analytic baselines (ref:train_noise_flow.py:264-280)
    loading = {}
    t0 = time.time()
    tr = load_split(args, cfg, "train")
    loading["decode_train_s"] = time.time() - t0
    t0 = time.time()
    ts = load_split(args, cfg, "test")
    loading["decode_test_s"] = time.time() - t0
    logging.info("train patches: %d, test patches: %d", len(tr), len(ts))
    t0 = time.time()
    stats, nll_gauss, nll_sdn = stats_and_baselines(args, cfg, tr, ts)
    loading["stats_baselines_s"] = time.time() - t0
    logging.info("baselines: NLL_G=%.3f NLL_SDN=%.3f", nll_gauss, nll_sdn)

    # --calc_*_only early exits (ref:Initialization.py:31-75 modes)
    if args.calc_pat_stats_and_baselines_only:
        if chief:
            os.makedirs(cfg.logdir, exist_ok=True)
            np.save(os.path.join(cfg.logdir, "pat_stats.npy"),
                    {**stats, "nll_gauss": nll_gauss, "nll_sdn": nll_sdn}, allow_pickle=True)
            logging.info("stats+baselines written to %s/pat_stats.npy; exiting", cfg.logdir)
        return 0
    if args.calc_hists_only:
        if chief:
            from noise_flow_tpu_torch.data.histograms import calc_hists, plot_hists, save_hists
            hx = calc_hists([{"noise": tr.x, "clean": tr.y}])
            hy = calc_hists([{"noise": ts.x, "clean": ts.y}])
            os.makedirs(cfg.logdir, exist_ok=True)
            save_hists(cfg.logdir, hx, hy)
            plot_hists(hx, hy, cfg.logdir)
            logging.info("histograms written to %s; exiting", cfg.logdir)
        return 0

    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.parallel.mesh import make_mesh
    from noise_flow_tpu_torch.utils.checkpoint import _format_path, _key_to_path, load_checkpoint

    flow = NoiseFlow(cfg.x_shape, cfg, device=device, seed=cfg.seed)
    if args.init_checkpoint:
        load_checkpoint(args.init_checkpoint, flow)
        logging.info("initial weights from %s", args.init_checkpoint)
    mesh = make_mesh(None, device)
    trainer = Trainer(flow, cfg, mesh)
    n_params = flow.num_params()
    logging.info("model: %s | %d params | device %s | rank %d of %d", cfg.arch, n_params,
                 device, mesh.rank, mesh.size)

    # config + variable dumps (ref:train_noise_flow.py:305-312)
    if chief:
        os.makedirs(cfg.logdir, exist_ok=True)
        save_hps(os.path.join(cfg.logdir, "hps.txt"), cfg, flow.get_layer_names(), n_params,
                 extra={"synthetic_data": args.synthetic_data,
                        "native_loader": bool(args.native_loader),
                        "cache_dir": args.cache_dir or "",
                        "num_processes": pd.process_count(), "device": str(device)})
        with open(os.path.join(cfg.logdir, "model_vars.txt"), "w") as f:
            for name, p in flow.named_parameters():
                f.write(f"{_format_path(_key_to_path(name))}\t{tuple(p.shape)}\n")

    # clamp batch sizes to split sizes (small synthetic smoke runs would
    # otherwise drop every batch under drop_remainder). In coordinator mode
    # the batch size is global: each process feeds its share, and every
    # process runs the fewest steps an epoch that any process has.
    pc = pd.process_count()
    bs_tr = min(max(cfg.n_batch_train // pc, 1), len(tr))
    bs_ts = min(max(cfg.n_batch_test // pc, 1), len(ts))
    steps_tr = steps_ts = None
    if pc > 1:
        counts = pd.all_gather_host(np.asarray([len(tr) // bs_tr, len(ts) // bs_ts], np.int64))
        steps_tr, steps_ts = int(counts[:, 0].min()), int(counts[:, 1].min())
    bsc = not cfg.per_example_cond  # reference-compat conditioning

    def limit(it, n):
        return it if n is None else itertools.islice(it, n)

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
        train_fn = lambda: limit(scalarize(tr_loader.epoch()), steps_tr)  # noqa: E731
        test_fn = lambda: limit(scalarize(ts_loader.epoch(cfg.seed)), steps_ts)  # noqa: E731
    else:
        train_fn = lambda: limit(tr.batches(  # noqa: E731
            bs_tr, shuffle=True, seed=cfg.seed, drop_remainder=True,
            batch_scalar_cond=bsc), steps_tr)
        test_fn = lambda: limit(ts.batches(  # noqa: E731
            bs_ts, drop_remainder=True, batch_scalar_cond=bsc), steps_ts)

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
        loading["stage_s"] = time.time() - t0
        logging.info("staged %d train + %d test patches on %s (%.1fs)",
                     n_tr, n_ts, device, loading["stage_s"])
        trainer.sample_batches_cap = args.n_sample_batches
    loading["to_fit_s"] = time.time() - t_start
    loading.update(train_patches=len(tr), test_patches=len(ts),
                   content_sig_train=content_sig(tr.x), content_sig_test=content_sig(ts.x))
    logging.info("loading: %s", " ".join(f"{k}={v:.1f}" for k, v in loading.items()
                                         if k.endswith("_s")))
    if chief:
        with open(os.path.join(cfg.logdir, "loading.json"), "w") as f:
            json.dump(loading, f, indent=1)

    stop = StopTimer(t_start + args.stop_after) if args.stop_after is not None else None
    try:
        trainer.fit(train_fn, test_fn, cfg.logdir, epochs=cfg.epochs, nll_gauss=nll_gauss,
                    nll_sdn=nll_sdn, sc_sd=stats["sc_in_sd"], do_sampling=args.do_sample,
                    verbose=True, sample_batches_fn=sample_fn)
    finally:
        if stop is not None:
            stop.close()

    total = time.time() - t_start
    if chief:
        with open(os.path.join(cfg.logdir, "total_time.txt"), "w") as f:
            f.write(f"{total:.1f}\n")  # (ref:train_noise_flow.py:539-540)
    logging.info("done in %.1fs", total)
    return 0


if __name__ == "__main__":
    sys.exit(main())
