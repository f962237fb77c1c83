"""The camera-NLF oracle's NLL read the two ways its recorded run differs
from ``cli.flagship --steps oracle``.

The oracle is experiments/sidd/condsdn_scale (the ``condsdn-baseline``
recipe: a 1x1 conv, then the camera-NLF layer, never trained). Its rows
came from a TPU run that

- computed the 1x1 conv at JAX's default precision: the matrix ``P @ (L @
  U)`` and the conv with bfloat16 operands and float32 sums
  (``tpu_mix_matrix``, ``oracle_nll``); the port computes both in float32;
- staged its test patches from the native loader (native/patch_loader.cc:
  8 threads push the patches of the images they hold in the order they
  come), the first ``--staged_test_patches`` of that stream, where the
  port's run stages the Python loader's first ones.

This probe evaluates the oracle over the rows' patches in both precisions,
and over the native loader's staged test patches (through an npy cache of
the test split it writes, ``--cache_dir``) in both, several times, with how
many of those patches the Python loader's staged set holds and how many
distinct (nlf0, nlf1, iso, cam) they carry. A diagnostic: no entry point
imports it.

On the card, after ``cli.flagship --steps generate``::

    python -m noise_flow_tpu_torch.probes.oracle --corpus data/flagship/sidd \\
        --cache_dir data/oracle_cache --out data/oracle_probe.json
"""

from __future__ import annotations

import argparse
import hashlib
import itertools
import json
import os
import shutil
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

CKPT = ("ckpt", "model.ckpt-best.npz")
KEYS = ("_x", "_y", "nlf0", "nlf1", "iso", "cam")


def load_oracle(device):
    """condsdn_scale's flow with its recorded weights."""
    from noise_flow_tpu_torch.cli.flagship import JAX_ORACLE
    from noise_flow_tpu_torch.config import load_hps
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = load_hps(os.path.join(JAX_ORACLE, "hps.txt"))
    flow = NoiseFlow(cfg.x_shape, cfg, device=device)
    load_checkpoint(os.path.join(JAX_ORACLE, *CKPT), flow)
    if [s.kind for s in flow.specs] != ["conv1x1", "condSDN"]:
        raise ValueError(f"not the oracle's layers: {flow.specs}")
    return flow


@torch.no_grad()
def tpu_mix_matrix(mix) -> torch.Tensor:
    """The 1x1 conv's matrix as JAX builds it on a TPU at its default
    precision: ``P @ (L @ U)`` (noise_flow_tpu/ops/conv1x1.py, LU) with
    ``L @ U``'s operands rounded to bfloat16 and float32 sums."""
    from noise_flow_tpu_torch.ops.conv1x1 import vec_to_strict_tri

    bf = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    t, f = mix.mat, mix.frozen
    c = t.log_s.shape[0]
    eye = torch.eye(c, device=t.log_s.device)
    lower = vec_to_strict_tri(t.l_vec, c, upper=False) + eye
    upper = vec_to_strict_tri(t.u_vec, c, upper=True) + torch.diag(f.sign_s * torch.exp(t.log_s))
    return f.p @ bf(bf(lower) @ bf(upper))


@torch.no_grad()
def oracle_nll(flow, batch: Dict, tpu_precision: bool):
    """Mean NLL and mean sd_z of the oracle over one device batch: in
    float32 ``flow.loss``; with ``tpu_precision`` the conv as the recorded
    run's TPU computed it (its matrix from ``tpu_mix_matrix``, x rounded to
    bfloat16, float32 sums; the log-det ``sum(log_s)``, as there), then the
    camera-NLF layer in float32."""
    from noise_flow_tpu_torch.ops.gaussian import diag_gaussian_logp
    from noise_flow_tpu_torch.ops.nn import conv2d_nhwc
    from noise_flow_tpu_torch.training.trainer import batch_to_cond

    x, cond = batch["_x"], batch_to_cond(batch)
    if not tpu_precision:
        nll, sd, _ = flow.loss(x, cond, False)
        return float(nll), float(sd)
    mix, cam_sdn = flow.layers
    a = tpu_mix_matrix(mix)
    z = conv2d_nhwc(x.to(torch.bfloat16).float(), a.reshape(1, 1, *a.shape))
    ldj = mix.mat.log_s.sum() * (x.shape[1] * x.shape[2])
    z, ldj2 = cam_sdn.inverse(z, cond, False, flow.shared_view())
    nll = -(ldj + ldj2 + diag_gaussian_logp(z))
    sd = torch.sqrt(torch.var(z.reshape(len(z), -1), dim=1, unbiased=False))
    return float(nll.mean()), float(sd.mean())


def evaluate(flow, batches: Iterable[Dict], device) -> np.ndarray:
    """[n_batches, 4]: float32 NLL, sd_z, then TPU-precision NLL, sd_z."""
    rows = []
    for mb in batches:
        t = {k: torch.as_tensor(np.asarray(mb[k]), dtype=torch.float32, device=device)
             for k in KEYS}
        rows.append(oracle_nll(flow, t, False) + oracle_nll(flow, t, True))
    return np.asarray(rows, np.float64)


def summary(rows: np.ndarray) -> Dict:
    m = rows.mean(0)
    return {"float32": {"NLL": m[0], "sdz": m[1]},
            "tpu_precision": {"NLL": m[2], "sdz": m[3]}, "batches": len(rows)}


def patch_digests(batches: Iterable[Dict]) -> List[bytes]:
    return [hashlib.blake2b(np.ascontiguousarray(x).tobytes(), digest_size=16).digest()
            for mb in batches for x in mb["_x"]]


def main(argv: Optional[List[str]] = None) -> int:
    from noise_flow_tpu_torch.cli import flagship
    from noise_flow_tpu_torch.cli import train as cli_train
    from noise_flow_tpu_torch.cli.args import parse_config
    from noise_flow_tpu_torch.data.native import NativePatchLoader
    from noise_flow_tpu_torch.utils.device import resolve_device

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--corpus", required=True, help="the SIDD-scale corpus (--sidd_path)")
    p.add_argument("--cache_dir", required=True,
                   help="where the test split's npy cache is written (removed after)")
    p.add_argument("--out", default="")
    p.add_argument("--device", default="cuda")
    p.add_argument("--n_batch", type=int, default=138)
    p.add_argument("--staged_test_patches", type=int, default=55200)
    p.add_argument("--native_runs", type=int, default=3)
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    args, cfg = parse_config(flagship.CONDSDN + [
        "--sidd_path", a.corpus,
        "--n_batch_train", str(a.n_batch), "--n_batch_test", str(a.n_batch),
        "--staged_test_patches", str(a.staged_test_patches), "--device", a.device])
    flow = load_oracle(device)
    b, staged = a.n_batch, a.staged_test_patches // a.n_batch
    out: Dict = {"seconds": {}}
    t0 = time.time()
    train = cli_train.load_split(args, cfg, "train")
    out["train"] = summary(evaluate(flow, train.batches(b, drop_remainder=True), device))
    del train
    out["seconds"]["train"] = time.time() - t0
    # the test split decoded once: the Python loader's patches, and the npy
    # cache the native loader reads
    t0 = time.time()
    args.cache_dir = a.cache_dir
    shutil.rmtree(a.cache_dir, ignore_errors=True)
    test = cli_train.load_split(args, cfg, "test")
    rows = evaluate(flow, test.batches(b, drop_remainder=True), device)
    out["test_staged"], out["test_all"] = summary(rows[:staged]), summary(rows)
    python_set = set(patch_digests(itertools.islice(test.batches(b, drop_remainder=True),
                                                    staged)))
    del test
    out["seconds"]["test_python"] = time.time() - t0
    t0 = time.time()
    out["native_staged"] = []
    loader = NativePatchLoader(os.path.join(a.cache_dir, "test"), cfg.patch_height, b,
                               cfg.n_patches_per_image, shuffle=False, seed=cfg.seed,
                               sampling=cfg.patch_sampling)
    for _ in range(a.native_runs):
        # as cli.train stages the native test stream: the first patches of
        # the epoch that loader.epoch(cfg.seed) arms
        mbs = list(itertools.islice(loader.epoch(cfg.seed), staged))
        run = summary(evaluate(flow, mbs, device))
        digests = patch_digests(mbs)
        run["shared_with_python"] = sum(d in python_set for d in digests)
        run["conditions"] = len({(float(n0), float(n1), float(i), float(c)) for mb in mbs
                             for n0, n1, i, c in zip(mb["nlf0"], mb["nlf1"], mb["iso"],
                                                     mb["cam"])})
        out["native_staged"].append(run)
    del loader
    shutil.rmtree(a.cache_dir, ignore_errors=True)
    out["seconds"]["test_native"] = time.time() - t0
    text = json.dumps(out)
    print(text, flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
