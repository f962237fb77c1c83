"""The flagship run of the port, end to end, held to the JAX run's records.

Steps (``--steps``, in this order):

- ``generate``: the SIDD-scale corpus through ``cli.make_sidd_scale``
  (v7.3 .MAT where h5py is installed, else v5);
- ``oracle``: the ``condsdn-baseline`` recipe (jobs/job_noise_flow.sh; the
  non-trainable camera-NLF flow that generated the corpus) through
  ``cli.train`` at experiments/sidd/condsdn_scale's settings, starting from
  that run's checkpoint (``--init_checkpoint``), staged data as its run,
  without its npy cache and native loader (``probes.oracle`` reads the
  rest of the gap to its rows);
- ``train``: the ``--recipe`` (``RECIPES``) to ``--epochs`` through
  ``cli.train``: ``prod-exact`` (the default; jobs/job_noise_flow.sh
  prod-exact: exact batch BN on the plain path, b 138, K = 32 graph
  replays, staged data, held to experiments/sidd/prod_exact_150), or the
  kernel path of jobs/job_noise_flow.sh prod-synth-scale (the one-shot
  train kernel with ghost BN over blocks of 69, the running-BN eval kernel,
  K = 32 graph replays of both, staged data): ``ghost`` and ``ghost-f32``
  at 60 epochs in bfloat16 and float32, held to experiments/sidd/bn_delta/
  ghost and ghost_f32 (``GHOST_GATES``), and ``prod-synth-scale`` at 150,
  held to experiments/sidd/prod_synth_scale (``PSS_GATES``). Each runs
  without its recipe's npy cache and native loader (they change the staged
  order of the patches, not the patches): the .MAT corpus and its cache
  are ~50 GB written, more than a card machine of 45 GiB takes in one run
  (chip_smoke.py drives both at a cut of scale). Resumable over calls:
  ``--stop_after S`` stops it S seconds after this process started (the
  epoch in progress finishes, then a checkpoint is saved), and the next
  call, given the same ``--logdir`` (or a copy of it as ``--resume_from``),
  passes ``--continue_training``. Each call is listed in the logdir's
  ``calls.json`` (its epochs, seconds, loading split and the corpus's
  content signature). After each call the checkpoint of the lowest test
  row so far is kept in ``<logdir>/best_of_run`` (``fit`` starts its best
  afresh at every resume, so its own ``model.ckpt-best.npz`` is the best
  of one call only), and the sample phases' .mat dumps
  (``samples_epoch_*``, about 7 MB a test epoch) are removed, so that the
  logdir stays small enough to carry between calls;
- ``sweep``: ``cli.kld_sweep`` over the test split at the recorded
  temperatures, through the fused sampler, on the port's own best model
  (best_of_run, seed 0) and, for prod-exact, on
  experiments/sidd/prod_exact_150 (seed 0 and ``--sweep_seeds``);
- ``grid``: ``analysis.ref_parity`` at b = 1024 on the port's best model
  and, for prod-exact, on prod_exact_150;
- ``frame``: ``NoiseFlowWrapper.sample_noise_frame_spatial`` on a packed
  1500x2000 frame, timed;
- ``dncnn``: the DnCNN four-source comparison (``cli.dncnn_comparison``)
  at the recorded run's setup on the corpus: validation blocks from the
  test scenes, one DnCNN a noise source for 45 epochs on the train scenes;
- ``report``: the outputs of the steps that ran beside the JAX runs'
  records: the recipe's train.txt, test.txt, sample.txt (NLL, sd_z and the
  KLD columns) and kld_sweep/kld_vs_temp.txt, each epoch's train NLL gap,
  the recipe's gates (the exit code is 1 when one fails), and
  experiments/dncnn/comparison/results.json, as one JSON file (the
  oracle's rows beside condsdn_scale's go there in their own step).

Run on the card (about 30 GB of .MAT under --work):
    python -m noise_flow_tpu_torch.cli.flagship --work data/flagship \
        --report chiprun_out/flagship.json
the 150 epochs over calls of at most an hour, the logdir kept where the
next call finds it (a copy of the last call's as --resume_from):
    python -m noise_flow_tpu_torch.cli.flagship --steps generate,train,report \
        --epochs 150 --stop_after 3000 --logdir chiprun_out/flagship150 \
        [--resume_from data/flagship150] --report chiprun_out/flagship150.json
and, in the call that reaches epoch 150, --steps generate,train,sweep,grid,report.
the kernel-path recipes the same way, each in its own logdir
(<work>/ghost, ghost_f32, prod_synth_scale) and report:
    python -m noise_flow_tpu_torch.cli.flagship --recipe ghost \
        --steps generate,train,report --report chiprun_out/ghost.json
    python -m noise_flow_tpu_torch.cli.flagship --recipe prod-synth-scale \
        --steps train,sweep,grid,report --stop_after 3000 \
        --logdir chiprun_out/pss [--resume_from data/pss] --report chiprun_out/pss.json
or only the DnCNN comparison on a new corpus:
    python -m noise_flow_tpu_torch.cli.flagship --steps generate,dncnn,report \
        --report chiprun_out/dncnn.json
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import shutil
import sys
import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
JAX_RUN = os.path.join(REPO, "experiments", "sidd", "prod_exact_150")
SWEEP_TEMPS = "0.2,0.4,0.5,0.6,0.7,0.8,1.0"
FRAME_HW = (1500, 2000)
# jobs/job_noise_flow.sh prod-exact, less --epochs, the paths and the cache;
# use_pallas off. On the card each group of 32 staged steps is one CUDA
# graph replay (training.step_graph)
PROD_EXACT = ["--arch", "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc", "--width", "4",
              "--lr", "1e-4", "--n_batch_train", "138", "--patch_height", "32",
              "--shuffle_patches", "--n_patches_per_image", "2898",
              "--epochs_full_valid", "10", "--temp", "0.6", "--do_sample",
              "--steps_per_call", "32", "--device_resident_data"]
JAX_ORACLE = os.path.join(REPO, "experiments", "sidd", "condsdn_scale")
# jobs/job_noise_flow.sh condsdn-baseline at condsdn_scale/hps.txt's settings,
# less the paths, the cache and the native loader; staged data, as its run.
# Its NLL_G and NLL_SDN columns are prod_exact_150's to the last digit, so it
# ran with --shuffle_patches; but those columns come from the Python loader,
# while its rows come from the native loader, which takes the centred run of
# the unshuffled grid (native/patch_loader.cc). The rows' patches are the
# Python loader's without --shuffle_patches, which this run takes. The flow
# never trains, so its NLL is that of its 1x1 conv's initial weights, which
# JAX drew with its own RNG: the run starts from the recorded checkpoint.
CONDSDN = ["--arch", "", "--sidd_cond", "condSDN", "--depth", "1", "--lr", "1e-4",
           "--n_batch_train", "138", "--patch_height", "32", "--n_patches_per_image", "2898",
           "--epochs", "2", "--epochs_full_valid", "1", "--temp", "1.0", "--seed", "0",
           "--device_resident_data",
           "--init_checkpoint", os.path.join(JAX_ORACLE, "ckpt", "model.ckpt-best.npz")]
JAX_DNCNN = os.path.join(REPO, "experiments", "dncnn", "comparison", "results.json")
STEPS = ("generate", "oracle", "train", "sweep", "grid", "frame", "dncnn", "report")
BN_DELTA = os.path.join(REPO, "experiments", "sidd", "bn_delta")
JAX_PSS = os.path.join(REPO, "experiments", "sidd", "prod_synth_scale")
# jobs/job_noise_flow.sh prod-synth-scale, less --epochs, the paths, the cache
# and the native loader: the one-shot kernel (ghost BN over JAX's block,
# pick_block(138, 64, 8) = 69), K = 32 graph replays, staged data, the sample
# phase over 24 test batches; bn_delta/ghost and bn_delta/ghost_f32 are the
# same flags at 60 epochs in bfloat16 and float32 (their hps.txt)
KERNEL_PATH = ["--arch", "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc", "--width", "4",
               "--lr", "1e-4", "--n_batch_train", "138", "--patch_height", "32",
               "--shuffle_patches", "--n_patches_per_image", "2898",
               "--epochs_full_valid", "10", "--temp", "0.6", "--do_sample",
               "--n_sample_batches", "24", "--use_pallas", "--steps_per_call", "32",
               "--device_resident_data"]


class Recipe(NamedTuple):
    """A train step's flags (``cli.train``, less --epochs and the paths),
    the JAX run whose records it is held to, its default --epochs and its
    default logdir under --work."""
    flags: List[str]
    record: str
    epochs: int
    logdir: str


RECIPES = {
    "prod-exact": Recipe(PROD_EXACT, JAX_RUN, 10, "prefix"),
    "ghost": Recipe(KERNEL_PATH + ["--pallas_train_dtype", "bfloat16"],
                    os.path.join(BN_DELTA, "ghost"), 60, "ghost"),
    "ghost-f32": Recipe(KERNEL_PATH + ["--pallas_train_dtype", "float32"],
                        os.path.join(BN_DELTA, "ghost_f32"), 60, "ghost_f32"),
    "prod-synth-scale": Recipe(KERNEL_PATH + ["--pallas_train_dtype", "bfloat16"], JAX_PSS,
                               150, "prod_synth_scale"),
}
# the gates of the kernel-path recipes at the record's last epoch: |port -
# record| of the train and test NLL, nats, for bn_delta's runs (JAX's own
# bfloat16 and float32 runs part by 15.6 and 25.4, one semantics,
# bn_delta/README.md), and how far above JAX's exact-BN train row both must
# read (the ghost-BN gap); prod_synth_scale's record trained at a block of
# 46, the port at JAX's current 69, so its rows stand beside the record
# ungated, and it is held to NF below Gauss at temp 1.0 in every sweep cell
# and to the last test sd_z
GHOST_GATES = {"train_nll": 20.0, "test_nll": 30.0, "above_exact": 100.0}
JAX_EXACT = os.path.join(BN_DELTA, "exact")
PSS_GATES = {"sdz": 0.05, "cells_nf_below_g_at_temp1": 15}
SAMPLE_COLS = ("NLL", "sdz", "KLD_G", "KLD_NLF", "KLD_NF")
ORDER_NOTE = ("cli.train runs without the recipe's npy cache and native loader: the staged "
              "order of the patches differs from the JAX run's, the patches do not")


def read_tsv(path: str) -> List[Dict[str, str]]:
    with open(path) as f:
        head = f.readline().rstrip("\n").split("\t")
        return [dict(zip(head, ln.rstrip("\n").split("\t"))) for ln in f if ln.strip()]


def _du_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def compare_rows(port_tsv: str, jax_tsv: str, cols=("NLL", "sdz")) -> List[Dict]:
    """The port's per-epoch rows beside the JAX run's at the same epochs."""
    jax = {r["epoch"]: r for r in read_tsv(jax_tsv)}
    out = []
    for r in read_tsv(port_tsv):
        row = {"epoch": int(r["epoch"])}
        for c in cols:
            row[c] = float(r[c])
            if r["epoch"] in jax:
                row[f"jax_{c}"] = float(jax[r["epoch"]][c])
        out.append(row)
    return out


def compare_sweep(port_tsv: str, jax_tsv: str) -> Dict:
    """KLD_G and KLD_NLF as printed against the recorded sweep, and the
    best-temperature KLD_NF of each (cam, iso) cell against its KLD_G."""
    key = lambda r: (r["cam"], r["iso"], r["temp"])  # noqa: E731
    jax = {key(r): r for r in read_tsv(jax_tsv)}
    rows = read_tsv(port_tsv)
    diff = [key(r) for r in rows if key(r) not in jax
            or any(r[c] != jax[key(r)][c] for c in ("KLD_G", "KLD_NLF"))]
    cells = {}
    for r in rows:
        cells.setdefault((r["cam"], r["iso"]), []).append(r)
    best = {f"cam{c}_iso{i}": min(((float(r["KLD_NF"]), float(r["temp"]), float(r["KLD_G"]))
                                   for r in rs)) for (c, i), rs in cells.items()}
    jcells = {}
    for r in jax.values():
        jcells.setdefault((r["cam"], r["iso"]), []).append(float(r["KLD_NF"]))

    def below_at_temp1(rs):
        return sum(float(r["KLD_NF"]) < float(r["KLD_G"]) for r in rs if float(r["temp"]) == 1.0)
    return {
        "rows": len(rows), "recorded_rows": len(jax),
        "g_nlf_rows_differing": [list(k) for k in diff],
        "best": {c: {"kld_nf": v[0], "temp": v[1], "kld_g": v[2]} for c, v in best.items()},
        "cells_nf_below_g": sum(v[0] < v[2] for v in best.values()),
        "cells": len(best),
        "mean_best_kld_nf": float(np.mean([v[0] for v in best.values()])),
        "recorded_mean_best_kld_nf": float(np.mean([min(v) for v in jcells.values()])),
        "mean_kld_g": float(np.mean([v[2] for v in best.values()])),
        "cells_nf_below_g_at_temp1": below_at_temp1(rows),
        "recorded_cells_nf_below_g_at_temp1": below_at_temp1(jax.values()),
    }


BEST_DIR = "best_of_run"


def keep_best(logdir: str) -> Optional[Dict]:
    """Keep aside the checkpoint of the lowest test row of the run so far:
    ``<logdir>/best_of_run/{hps.txt, ckpt/model.ckpt-best.npz, best.json}``,
    a model directory that ``NoiseFlowWrapper`` loads. ``fit`` restarts its
    best at every resume (as JAX's), so ``ckpt/model.ckpt-best.npz`` is the
    lowest test row since the last resume; it replaces the kept one only if
    its row is lower (the first of equal rows stays, as an uninterrupted
    run's strict ``<`` keeps it). Call it after every call's ``train``,
    before the next call's ``fit`` overwrites that file. Returns the kept
    record ({"epoch", "nll"}) or None."""
    aside = os.path.join(logdir, BEST_DIR)
    rec_path = os.path.join(aside, "best.json")
    kept = None
    if os.path.exists(rec_path):
        with open(rec_path) as f:
            kept = json.load(f)
    ckpt = os.path.join(logdir, "ckpt", "model.ckpt-best.npz")
    if not os.path.exists(ckpt):
        return kept
    with np.load(ckpt) as z:
        epoch = int(z["__epoch__"])
    rows = {int(r["epoch"]): float(r["NLL"]) for r in read_tsv(os.path.join(logdir, "test.txt"))}
    if kept is not None and not rows[epoch] < kept["nll"]:
        return kept
    os.makedirs(os.path.join(aside, "ckpt"), exist_ok=True)
    if os.path.exists(os.path.join(logdir, "hps.txt")):     # cli.train's, not fit's
        shutil.copyfile(os.path.join(logdir, "hps.txt"), os.path.join(aside, "hps.txt"))
    shutil.copyfile(ckpt, os.path.join(aside, "ckpt", "model.ckpt-best.npz"))
    kept = {"epoch": epoch, "nll": rows[epoch]}
    with open(rec_path, "w") as f:
        json.dump(kept, f)
    return kept


def summed_train_time(train_tsv: str, starts: List[int]) -> int:
    """``train.txt``'s cumulative ``train_time`` restarts at each resume:
    the sum over the calls (``starts``: each call's first epoch) of each
    call's last value."""
    rows = [(int(r["epoch"]), int(r["train_time"])) for r in read_tsv(train_tsv)]
    bounds = sorted(starts)[1:]
    last = {}
    for epoch, t in rows:
        last[sum(epoch >= b for b in bounds)] = t
    return sum(last.values())


def train_gap(train_rows: List[Dict]) -> Dict:
    """Each epoch's port-minus-record train NLL, and the largest in size."""
    by_epoch = {r["epoch"]: r["NLL"] - r["jax_NLL"] for r in train_rows if "jax_NLL" in r}
    worst = max(by_epoch, key=lambda e: abs(by_epoch[e]), default=None)
    return {"by_epoch": by_epoch, "max_abs": None if worst is None else abs(by_epoch[worst]),
            "epoch_of_max": worst}


def recipe_gates(name: str, report: Dict) -> Optional[Dict]:
    """The gates of a kernel-path recipe (``GHOST_GATES``, ``PSS_GATES``)
    over its report, each {"value", "limit", "ok"}; {"reached": False} until
    the run reaches the record's last epoch; None for prod-exact."""
    if name == "prod-exact":
        return None
    record = RECIPES[name].record
    last = int(read_tsv(os.path.join(record, "train.txt"))[-1]["epoch"])
    rows = {r: {x["epoch"]: x for x in report[f"{r}_rows"]} for r in ("train", "test")}
    if last not in rows["train"] or last not in rows["test"]:
        return {"reached": False, "record_epoch": last,
                "epoch": max(rows["train"], default=0)}

    def gate(value, limit, ok):
        return {"value": value, "limit": limit, "ok": bool(ok)}
    out = {"reached": True, "epoch": last}
    if name in ("ghost", "ghost-f32"):
        for r in ("train", "test"):
            d = rows[r][last]["NLL"] - rows[r][last]["jax_NLL"]
            out[f"{r}_nll"] = gate(d, GHOST_GATES[f"{r}_nll"], abs(d) <= GHOST_GATES[f"{r}_nll"])
        exact = {int(x["epoch"]): float(x["NLL"])
                 for x in read_tsv(os.path.join(JAX_EXACT, "train.txt"))}[last]
        d = rows["train"][last]["NLL"] - exact
        out["above_exact"] = gate(d, GHOST_GATES["above_exact"], d > GHOST_GATES["above_exact"])
        return out
    sdz = rows["test"][last]["sdz"]
    out["sdz"] = gate(sdz - 1.0, PSS_GATES["sdz"], abs(sdz - 1.0) <= PSS_GATES["sdz"])
    sweep = report.get("sweeps", {}).get("port_best_seed0")
    if sweep is not None:
        n = sweep["cells_nf_below_g_at_temp1"]
        out["cells_nf_below_g_at_temp1"] = gate(n, PSS_GATES["cells_nf_below_g_at_temp1"],
                                                n >= PSS_GATES["cells_nf_below_g_at_temp1"])
    return out


def compare_dncnn(port_json: str, jax_json: str) -> Dict:
    """The port's comparison beside the recorded one: each source's PSNR
    and SSIM, the record's and the differences, the setups, and the
    paper's claim (NF above Gauss) on each side."""
    with open(port_json) as f:
        port = json.load(f)
    with open(jax_json) as f:
        jax = json.load(f)
    rows = {}
    for src, p in port["results"].items():
        row = dict(p)
        if src in jax["results"]:
            for m in ("psnr", "ssim"):
                row[f"jax_{m}"] = jax["results"][src][m]
                row[f"{m}_minus_jax"] = p[m] - jax["results"][src][m]
        rows[src] = row

    def nf_above_gauss(res):
        if not {"nf", "gauss"} <= set(res):
            return None
        return {m: res["nf"][m] > res["gauss"][m] for m in ("psnr", "ssim")}
    keys = ("epochs", "batch", "n_train_patches", "val_blocks")
    setup = {k: port[k] for k in keys}
    # the port's DnCNNTrainer arguments (the JAX script's trainer defaults)
    setup.update(seed=port.get("seed", 0), dtype=port.get("dtype", "float32"))
    return {"setup": setup, "jax_setup": {k: jax[k] for k in keys},
            "device": port.get("device"), "rows": rows,
            "nf_above_gauss": nf_above_gauss(port["results"]),
            "jax_nf_above_gauss": nf_above_gauss(jax["results"])}


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--work", default=os.path.join(REPO, "data", "flagship"))
    p.add_argument("--recipe", default="prod-exact", choices=sorted(RECIPES),
                   help="the train step's recipe and the JAX run its report holds it to")
    p.add_argument("--epochs", type=int, default=None,
                   help="the train step's epochs (default: the recipe's: prod-exact 10, "
                        "ghost and ghost-f32 60, prod-synth-scale 150)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--sweep_seeds", default="1,2,3")
    p.add_argument("--steps", default=",".join(STEPS))
    p.add_argument("--report", default=None, help="JSON report (default <work>/flagship.json)")
    p.add_argument("--logdir", default=None, help="the train step's logdir "
                   "(default <work>/prefix for prod-exact, else <work>/<recipe>); a resumed "
                   "run keeps it across calls")
    p.add_argument("--resume_from", default=None,
                   help="a copy of an earlier call's logdir, copied to --logdir "
                        "when that holds no checkpoint yet")
    p.add_argument("--stop_after", type=float, default=None, metavar="SECONDS",
                   help="the train step stops itself SECONDS after this process "
                        "started (cli.train --stop_after)")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    t_start = time.time()
    steps = a.steps.split(",")
    if set(steps) - set(STEPS):
        raise SystemExit(f"--steps takes {STEPS}, got {steps}")
    recipe = RECIPES[a.recipe]
    exact = a.recipe == "prod-exact"
    epochs = a.epochs or recipe.epochs
    corpus = os.path.join(a.work, "SIDD_Medium_Raw_synth", "Data")
    prefix = a.logdir or os.path.join(a.work, recipe.logdir)
    best_dir = os.path.join(prefix, BEST_DIR)
    # the kernel-path recipes' sweeps and grids run on the port's model only
    tag = "" if exact else "_" + recipe.logdir
    sweeps = os.path.join(a.work, "kld_sweep" + tag)
    dncnn_out = os.path.join(a.work, "dncnn")
    report_path = a.report or os.path.join(
        a.work, "flagship.json" if exact else f"flagship_{recipe.logdir}.json")
    report = (json.load(open(report_path)) if os.path.exists(report_path) else {})
    os.makedirs(a.work, exist_ok=True)

    def timed(name, fn):
        t0 = time.time()
        fn()
        report.setdefault("seconds", {})[name] = time.time() - t0
        print(f"[flagship] {name}: {report['seconds'][name]:.1f} s", flush=True)
        with open(report_path, "w") as f:
            json.dump(report, f, indent=1)

    def counted(name, entry, argv):
        """Run ``entry(argv)``; the fused sampler's launches in it go to the
        report."""
        from noise_flow_tpu_torch.ops import fused_sample as fs
        before = dict(fs.launch_counts)
        if entry(argv):
            raise RuntimeError(f"{name} failed")
        report.setdefault("sampler_launches", {})[name] = {
            k: v - before.get(k, 0) for k, v in fs.launch_counts.items()
            if v != before.get(k, 0)}

    if "generate" in steps:
        from noise_flow_tpu_torch.cli import make_sidd_scale
        version = make_sidd_scale.available_mat_version()

        def generate():
            make_sidd_scale.main(["--root", corpus, "--mat_version", version])
            report["corpus"] = {"mat_version": version, "bytes": _du_bytes(corpus),
                                "scenes": len(os.listdir(corpus)),
                                "disk_free_bytes": shutil.disk_usage(a.work).free}
        timed("generate", generate)

    if "oracle" in steps:
        from noise_flow_tpu_torch.cli import train as cli_train
        oracle = os.path.join(a.work, "oracle")

        def run_oracle():
            shutil.rmtree(oracle, ignore_errors=True)
            if cli_train.main(CONDSDN + ["--sidd_path", corpus, "--logdir", oracle,
                                         "--device", a.device]):
                raise RuntimeError("cli.train failed")
            report["oracle_rows"] = {
                r: compare_rows(os.path.join(oracle, f"{r}.txt"),
                                os.path.join(JAX_ORACLE, f"{r}.txt"),
                                cols=("NLL", "NLL_G", "NLL_SDN", "sdz"))
                for r in ("train", "test")}
        timed("oracle", run_oracle)
        print(json.dumps(report["oracle_rows"]), flush=True)

    if "train" in steps:
        from noise_flow_tpu_torch.cli import train as cli_train
        from noise_flow_tpu_torch.cli.dncnn_comparison import device_name
        from noise_flow_tpu_torch.ops import fused_sample as fs
        from noise_flow_tpu_torch.utils.checkpoint import latest_checkpoint
        from noise_flow_tpu_torch.utils.device import resolve_device

        def train():
            ckpt_dir = os.path.join(prefix, "ckpt")
            if a.resume_from and not latest_checkpoint(ckpt_dir):
                shutil.copytree(a.resume_from, prefix, dirs_exist_ok=True)
            keep_best(prefix)     # before fit's resume overwrites model.ckpt-best
            last = latest_checkpoint(ckpt_dir)
            argv = recipe.flags + ["--epochs", str(epochs), "--seed", str(a.seed),
                                 "--sidd_path", corpus, "--logdir", prefix,
                                 "--device", a.device]
            if last:
                argv.append("--continue_training")
            if a.stop_after is not None:
                argv += ["--stop_after", str(max(a.stop_after - (time.time() - t_start), 0.0))]
            calls_path = os.path.join(prefix, "calls.json")
            calls = []
            if os.path.exists(calls_path):
                with open(calls_path) as f:
                    calls = json.load(f)
            start = 1
            if last:
                with np.load(last) as z:
                    start = int(z["__epoch__"]) + 1
            t0 = time.time()
            before = dict(fs.launch_counts)
            if cli_train.main(argv):
                raise RuntimeError("cli.train failed")
            # the train and eval kernels' launches in this call, warm-ups included
            launches = {k: v - before.get(k, 0) for k, v in fs.launch_counts.items()
                        if v != before.get(k, 0)}
            rows = read_tsv(os.path.join(prefix, "train.txt"))
            with open(os.path.join(prefix, "loading.json")) as f:
                loading = json.load(f)
            calls.append({"recipe": a.recipe, "start_epoch": start,
                          "end_epoch": int(rows[-1]["epoch"]),
                          "seconds": time.time() - t0, "loading": loading,
                          "launches": launches,
                          "device": device_name(resolve_device(a.device))})
            with open(calls_path, "w") as f:
                json.dump(calls, f, indent=1)
            best = keep_best(prefix)
            for d in os.listdir(prefix):
                if d.startswith("samples_epoch_"):
                    shutil.rmtree(os.path.join(prefix, d))
            split = {k: round(v, 1) for k, v in loading.items() if k.endswith("_s")}
            print(f"[flagship] train ({a.recipe}): epochs {start}-{calls[-1]['end_epoch']} "
                  f"of {epochs}, "
                  f"loading {split}, best so far {best}", flush=True)
        timed("train", train)

    if "sweep" in steps:
        from noise_flow_tpu_torch.cli import kld_sweep
        runs = [(f"jax_seed{s}", JAX_RUN, s) for s in [0] + [
            int(s) for s in a.sweep_seeds.split(",") if s]] if exact else []
        if os.path.isdir(best_dir):
            runs.append(("port_best_seed0", best_dir, 0))
        for name, model, seed in runs:
            argv = ["--model_dir", model, "--sidd_path", corpus, "--temps", SWEEP_TEMPS,
                    "--seed", str(seed), "--logdir", os.path.join(sweeps, name),
                    "--device", a.device]
            timed(f"sweep_{name}", lambda n=name, v=argv: counted(n, kld_sweep.main, v))

    if "grid" in steps:
        from noise_flow_tpu_torch.analysis import ref_parity
        grids = ([("grid", JAX_RUN, "ref_parity")] if exact else []) + (
            [("grid_port_best", best_dir, "ref_parity_port" + tag)]
            if os.path.isdir(best_dir) else [])
        for name, model, out in grids:
            argv = ["--model_dir", model, "--batch", "1024", "--device", a.device,
                    "--out_dir", os.path.join(a.work, out)]
            timed(name, lambda n=name, v=argv: counted(n, ref_parity.main, v))

    if "frame" in steps:
        from noise_flow_tpu_torch.data.synthetic import make_synthetic_samples
        from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper

        def frame():
            nf = NoiseFlowWrapper(JAX_RUN, device=a.device)
            clean = make_synthetic_samples(1, *FRAME_HW, iso=800, seed=1)[0]["clean"][0]
            nf.sample_noise_frame_spatial(clean, 0.0, 0.0, 800.0, 2.0)
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                noise = nf.sample_noise_frame_spatial(clean, 0.0, 0.0, 800.0, 2.0)
                times.append((time.perf_counter() - t0) * 1e3)
            if noise.shape != clean.shape or not np.isfinite(noise).all():
                raise RuntimeError(f"bad frame noise {noise.shape}")
            report["frame_spatial"] = {"hw": list(FRAME_HW), "ms_host_clock": times,
                                       "noise_sd": float(noise.std())}
        timed("frame", frame)

    if "dncnn" in steps:
        from noise_flow_tpu_torch.cli import dncnn_comparison
        timed("dncnn", lambda: dncnn_comparison.main([
            "--data_root", corpus, "--val_dir", os.path.join(a.work, "sidd_valblocks"),
            "--out", dncnn_out, "--device", a.device]))

    if "report" in steps:
        def summarize():
            """Each part whose step's outputs are under --work."""
            if os.path.exists(os.path.join(prefix, "train.txt")):
                report["recipe"] = {"name": a.recipe, "record": os.path.relpath(
                    recipe.record, REPO), "flags": recipe.flags, "note": ORDER_NOTE}
                report["train_rows"] = compare_rows(os.path.join(prefix, "train.txt"),
                                                    os.path.join(recipe.record, "train.txt"))
                report["test_rows"] = compare_rows(os.path.join(prefix, "test.txt"),
                                                   os.path.join(recipe.record, "test.txt"))
                if os.path.exists(os.path.join(prefix, "sample.txt")):
                    report["sample_rows"] = compare_rows(
                        os.path.join(prefix, "sample.txt"),
                        os.path.join(recipe.record, "sample.txt"), cols=SAMPLE_COLS)
                with open(os.path.join(prefix, "phase_timers.txt")) as f:
                    report["phase_timers"] = f.read().strip()
                last = {r: report[f"{r}_rows"][-1] for r in ("train", "test")}
                report["epoch_gap"] = {
                    r: {"epoch": v["epoch"],
                        "nll_minus_jax": v["NLL"] - v.get("jax_NLL", math.nan),
                        "sdz": v["sdz"]} for r, v in last.items()}
                report["epochs_as_jax"] = {
                    r: [x["epoch"] for x in report[f"{r}_rows"]] == [
                        int(x["epoch"]) for x in read_tsv(os.path.join(recipe.record,
                                                                       f"{r}.txt"))
                        if int(x["epoch"]) <= last[r]["epoch"]] for r in ("train", "test")}
                calls_path = os.path.join(prefix, "calls.json")
                if os.path.exists(calls_path):
                    with open(calls_path) as f:
                        calls = json.load(f)
                    report["calls"] = calls
                    report["train_launches"] = dict(sum(
                        (collections.Counter(c.get("launches", {})) for c in calls),
                        collections.Counter()))
                    report["train_time_s"] = summed_train_time(
                        os.path.join(prefix, "train.txt"), [c["start_epoch"] for c in calls])
                    sigs = {json.dumps([c["loading"]["content_sig_train"],
                                        c["loading"]["content_sig_test"]]) for c in calls}
                    report["content_sig_equal"] = len(sigs) == 1
                best_rec = os.path.join(best_dir, "best.json")
                if os.path.exists(best_rec):
                    with open(best_rec) as f:
                        best = json.load(f)
                    jax_best = min(read_tsv(os.path.join(recipe.record, "test.txt")),
                                   key=lambda r: float(r["NLL"]))
                    report["best_gap"] = dict(best, jax_epoch=int(jax_best["epoch"]),
                                              jax_nll=float(jax_best["NLL"]),
                                              nll_minus_jax=best["nll"] - float(jax_best["NLL"]))
            if os.path.isdir(sweeps):
                recorded = os.path.join(recipe.record, "kld_sweep", "kld_vs_temp.txt")
                report["sweeps"] = {n: compare_sweep(os.path.join(sweeps, n, "kld_vs_temp.txt"),
                                                     recorded)
                                    for n in sorted(os.listdir(sweeps))}
                jax_runs = [s for n, s in report["sweeps"].items() if n.startswith("jax_")]
                if jax_runs:
                    report["sweep_seed_spread"] = {
                        "mean_best_kld_nf": [s["mean_best_kld_nf"] for s in jax_runs],
                        "sd": float(np.std([s["mean_best_kld_nf"] for s in jax_runs]))}
            grids = [("grid_summary", "ref_parity")] if exact else []
            for key, out in grids + [("grid_summary_port_best", "ref_parity_port" + tag)]:
                grid = os.path.join(a.work, out, "summary.txt")
                if os.path.exists(grid):
                    with open(grid) as f:
                        report[key] = dict(ln.rstrip("\n").split("\t", 1) for ln in f)
            if os.path.exists(os.path.join(dncnn_out, "results.json")):
                report["dncnn"] = compare_dncnn(os.path.join(dncnn_out, "results.json"),
                                                JAX_DNCNN)
            if "train_rows" in report:
                report["train_gap"] = train_gap(report["train_rows"])
                report["gates"] = recipe_gates(a.recipe, report)
        timed("report", summarize)
        print(json.dumps({k: report[k] for k in ("epoch_gap", "best_gap", "train_time_s",
                                                 "sweep_seed_spread", "dncnn", "gates")
                          if k in report}))
        failed = [k for k, v in (report.get("gates") or {}).items()
                  if isinstance(v, dict) and not v["ok"]]
        if failed:
            print(f"[flagship] {a.recipe}: gates failed: {failed}", flush=True)
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
