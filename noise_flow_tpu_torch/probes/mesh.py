"""Data-parallel training across cards, against one rank.

    python -m noise_flow_tpu_torch.probes.mesh --ranks 4 --out mesh.json
    python -m noise_flow_tpu_torch.probes.mesh --agreement --ranks 2 \
        --device cuda:0 --backend gloo --out agreement.json

On N cards (``--device cuda``, nccl) or N CPU processes (``--device cpu``,
gloo), for the plain exact-BN path and the one-shot kernel path (float32):
``cli.train --mesh N`` and ``cli.train --mesh 1`` on the same synthetic
split at a global batch of 276 (the ``multihost`` recipe's; ``--global_batch``),
from the flagship's weights, with the stats cache under one ``--cache_dir``
(the N-rank run writes it, the one-rank run reads it): the train and test
rows and the last checkpoint's weights side by side. Then each path's step
time on every rank (host clock around ``train_step`` on the same global
batch, 10 steps after 3) and the time of its all-reduces, beside one rank's
step at 276; and ``cli.train_dncnn --mesh N`` (DnCNN_NF, batch 128; not with
``--no_dncnn``): its losses. Prints the report as one JSON line and writes it
to ``--out``.

``--steps_per_call K`` (K > 1) runs every ``cli.train`` with K steps a
dispatch, on enough images for 2 full groups and a 6-step tail an epoch, and
adds ``cli.train --mesh N`` at K = 1 on the same split: each path's
``graph_vs_eager`` (the N-rank run under graphs against the same N ranks
eager: whether the last checkpoint is the same bits, its first tensor that
is not, the rows and the weights' agreement). Each rank's and one rank's
times then add a graph of K steps (where ``Trainer.graphs_on``: on the card,
one rank or nccl; null elsewhere): ``graph_step_ms`` (host clock over replays
of the same batch), and from a ``torch.profiler`` trace of one replay the
device time a step and, the NCCL kernels grouped, the all-reduces a step and
their device ms a step (null where the trace shows no device activity).

    python -m noise_flow_tpu_torch.probes.mesh --ranks 4 --steps_per_call 32 \
        --no_dncnn --out mesh_graphs.json

``--agreement`` measures instead what the comparisons of N ranks against
one rank read, and how far they move from run to run: the plain path's
gradients of one step, repeated from the same weights on the same batch on
one rank (which leaves differ between repeats, and by how much); then
``--repeats`` times 2 steps on N ranks and on one: the first step's
gradients (``grads_agreement``), the weights after (``weights_agreement``:
over every element, and over those whose gradient is above a floor), the
weight elements outside the tolerance with their gradients, and each side
against its first repeat; and the same comparisons for the planted fault
(each rank's own BatchNorm moments). ``--deterministic cudnn`` runs all of
it with cuDNN's deterministic algorithms, ``all`` under
``torch.use_deterministic_algorithms`` as well (``set_deterministic``).

``--gloo-cuda`` asks which of gloo's collectives take CUDA tensors, on
``--ranks`` ranks sharing ``--device`` (``cuda:0``): all-reduce and
all-gather of a small tensor, checked for their values (a rank that fails
fails the probe), then send and recv from rank 0 to rank 1 in ranks of
their own (a rank may die of it: its error is the answer).

    python -m noise_flow_tpu_torch.probes.mesh --gloo-cuda --ranks 2 --device cuda:0
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
MODEL = os.path.join(REPO, "experiments", "sidd", "prod_exact_150")
INIT = os.path.join(MODEL, "ckpt", "model.ckpt-best.npz")
GLOBAL_B = 276
IMAGES = 36          # synthetic 128x128 images a split: 576 patches, 2 steps an epoch
EPOCHS = 3
TIME_STEPS = 10
SPAWN_S = 600        # the longest a spawn of ranks may run
# N ranks against one rank on the same global batches: the weights after the
# steps |d| <= atol + rtol |p|, less the biases that feed a BatchNorm and the
# BN running means that carry them (their true gradient is zero, so each
# side's rounding becomes lr-sized Adam steps)
SKIP = ("l1_b", "l2_b", "bn1.mean", "bn2.mean")
PARAM_TOL = (2e-5, 1e-4)


def weights_agreement(got, ref, grads=None, floor: float = 0.0):
    """(max |d| / (atol + rtol |p|), max |d|, the leaf of that ratio) over
    the compared leaves of two state dicts; the ratio is at most 1 where
    they agree within PARAM_TOL. Given the reference's gradients of each
    step (``grads``, a list of dicts), the elements whose gradient in some
    step is below ``floor`` times that step's largest |g| are left out."""
    atol, rtol = PARAM_TOL
    ratio, worst, key = 0.0, 0.0, None
    for k, v in ref.items():
        if k.endswith(SKIP):
            continue
        d = (got[k].float() - v.float()).abs()
        if grads and k in grads[0]:
            for g in grads:
                top = max(float(x.abs().max()) for x in g.values())
                d = d * (g[k].abs() >= floor * top).reshape(d.shape)
        worst = max(worst, float(d.max()))
        r = float((d / (atol + rtol * v.float().abs())).max())
        if r > ratio:
            ratio, key = r, k
    return ratio, worst, key


# gradients of one step on the same weights: |d| <= rtol |g| + f max|g|, the
# largest |g| over every leaf (JAX's tests/test_distributed.py:57-60)
GRAD_TOL = (1e-4, 1e-5)


def grads_agreement(got, ref):
    """(max |d| / (rtol |g| + f max|g|), max |d|, the leaf of that ratio)
    over every gradient leaf; at most 1 where they agree within GRAD_TOL."""
    rtol, f = GRAD_TOL
    scale = f * max(float(g.abs().max()) for g in ref.values())
    ratio, worst, key = 0.0, 0.0, None
    for k, g in ref.items():
        d = (got[k] - g).abs()
        worst = max(worst, float(d.max()))
        r = float((d / (rtol * g.abs() + scale)).max())
        if r > ratio:
            ratio, key = r, k
    return ratio, worst, key


DETERMINISM = ("off", "cudnn", "all")


def set_deterministic(mode: str) -> None:
    """"cudnn": cuDNN picks deterministic algorithms only; "all": so does
    every op (``torch.use_deterministic_algorithms``, which raises at an op
    that has none; cuBLAS then needs CUBLAS_WORKSPACE_CONFIG set before the
    process first uses it); "off": neither."""
    import torch

    torch.use_deterministic_algorithms(mode == "all")
    torch.backends.cudnn.deterministic = mode != "off"


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def trainer(use_pallas, mesh):
    """A Trainer of the flagship flow from INIT on ``mesh``."""
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.training.trainer import Trainer
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = default_config(use_pallas=use_pallas, pallas_train_dtype="float32")
    flow = NoiseFlow(cfg.x_shape, cfg, device=mesh.device, seed=cfg.seed)
    load_checkpoint(INIT, flow)
    return Trainer(flow, cfg, mesh)


GRAPH_REPLAYS = 3     # replays timed a rank, after one


def replay_profile(fn, k: int):
    """One call of ``fn`` (a replay of K steps) under torch.profiler: the
    device ms a step over every device event, and the NCCL kernels' count
    and device ms a step; None where the trace shows no device activity."""
    import torch
    from torch.autograd import DeviceType

    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not ev:
        return None
    nccl = [e for e in ev if "nccl" in e.name.lower()]
    return {"device_ms": sum(e.device_time for e in ev) / 1e3 / k,
            "allreduces": len(nccl) / k,
            "allreduce_device_ms": sum(e.device_time for e in nccl) / 1e3 / k,
            "nccl_kernels": sorted({e.name for e in nccl})}


def graph_times(tr, batch, k: int) -> dict:
    """A graph of K train steps on ``batch`` (the trainer's host-batch
    feed): host ms a step over GRAPH_REPLAYS replays after one, and one
    replay's profile; every field None where the trainer runs no graphs."""
    from noise_flow_tpu_torch.parallel import distributed as pd

    out = {"graph_step_ms": None, "replay_device_ms": None, "replay_allreduces": None,
           "replay_allreduce_device_ms": None, "nccl_kernels": None}
    if k < 2 or not tr.graphs_on:
        return out
    tr.train_epoch(iter([batch] * k), steps_per_call=k)     # captures, replays once
    (g,) = tr._graphs.values()
    feed = tr._put_stacked([batch] * k)
    _sync(tr.device)
    pd.barrier(tr.mesh.group)
    t0 = time.perf_counter()
    for _ in range(GRAPH_REPLAYS):
        g.replay(feed)
    _sync(tr.device)
    out["graph_step_ms"] = (time.perf_counter() - t0) / (GRAPH_REPLAYS * k) * 1e3
    pd.barrier(tr.mesh.group)
    prof = replay_profile(lambda: g.replay(feed), k)
    if prof is not None:
        out.update(replay_device_ms=prof["device_ms"], replay_allreduces=prof["allreduces"],
                   replay_allreduce_device_ms=prof["allreduce_device_ms"],
                   nccl_kernels=prof["nccl_kernels"])
    return out


def step_times(mesh, batch, k: int = 1) -> dict:
    """Each path's step ms (host clock) on this rank and its all-reduce ms
    and count a step; with k > 1 also ``graph_times``."""
    from noise_flow_tpu_torch.parallel import distributed as pd

    out = {}
    for use_pallas in (False, True):
        tr = trainer(use_pallas, mesh)
        b = tr._put(batch)
        for _ in range(3):
            tr.train_step(b)
        _sync(mesh.device)
        pd.barrier()
        t0 = time.perf_counter()
        for _ in range(TIME_STEPS):
            tr.train_step(b)
        _sync(mesh.device)
        ms = (time.perf_counter() - t0) / TIME_STEPS * 1e3
        pd.collective_stats.update(calls=0, seconds=0.0, timing=True)
        for _ in range(TIME_STEPS):
            tr.train_step(b)
        stats = dict(pd.collective_stats)
        pd.collective_stats["timing"] = False
        out["oneshot" if use_pallas else "plain"] = {
            "step_ms": ms, "allreduce_ms": stats["seconds"] / TIME_STEPS * 1e3,
            "allreduces": stats["calls"] / TIME_STEPS}
        if k > 1:
            out["oneshot" if use_pallas else "plain"].update(graph_times(tr, batch, k))
    return out


def _time_rank(rank, device, batch, k=1):
    """A rank of the timing spawn: its step times."""
    from noise_flow_tpu_torch.parallel.mesh import make_mesh

    return step_times(make_mesh(None, device), batch, k)


def _rows(logdir, name):
    with open(os.path.join(logdir, name)) as f:
        lines = [ln.split("\t") for ln in f.read().splitlines()]
    col = lines[0].index("NLL")
    return [float(r[col]) for r in lines[1:]]


def _checkpoint_state(path):
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    flow = NoiseFlow((32, 32, 4), default_config(), device="cpu")
    load_checkpoint(path, flow)
    return flow.state_dict()


def _global_batches(args_list, n):
    """The first n global batches of cli.train's train stream for these flags."""
    from noise_flow_tpu_torch.cli import train as cli_train
    from noise_flow_tpu_torch.cli.args import parse_config

    args, cfg = parse_config(args_list)
    tr = cli_train.load_split(args, cfg, "train")
    it = tr.batches(cfg.n_batch_train, shuffle=True, seed=cfg.seed, drop_remainder=True,
                    batch_scalar_cond=not cfg.per_example_cond)
    return [next(it) for _ in range(n)]


def plain_steps(rank, device, batches, deterministic, local_bn=False):
    """The plain path's steps from INIT on this rank (every rank of the
    default group, or one rank without one): the train NLLs, each step's
    gradients (after the ranks' mean) and the state after. ``local_bn``:
    the planted fault, each rank's own BatchNorm moments."""
    from noise_flow_tpu_torch.parallel.mesh import make_mesh

    set_deterministic(deterministic)
    tr = trainer(False, make_mesh(None, device))
    if local_bn:
        tr.bn_psum = None
    nlls, grads = [], []
    for b in batches:
        nlls.append(float(tr.train_step(tr._put(b))[0]))
        grads.append({k: p.grad.cpu().clone() for k, p in tr.flow.named_parameters()
                      if p.grad is not None})
    return {"nlls": nlls, "grads": grads,
            "state": {k: v.cpu() for k, v in tr.flow.state_dict().items()}}


def _outside(got, ref, n=8):
    """The weight elements outside PARAM_TOL (less SKIP): their count, and
    the n largest, each with its step gradients on both sides as fractions
    of the reference step's largest |g|."""
    atol, rtol = PARAM_TOL
    rows = []
    for k, v in ref["state"].items():
        if k.endswith(SKIP):
            continue
        r = ((got["state"][k] - v).abs() / (atol + rtol * v.abs())).reshape(-1)
        for i in (r > 1.0).nonzero().reshape(-1).tolist():
            g = [[float(side["grads"][s][k].reshape(-1)[i]) / max(
                float(x.abs().max()) for x in ref["grads"][s].values()) for s in
                range(len(ref["grads"]))] for side in (ref, got)] if k in ref["grads"][0] \
                else None
            rows.append([float(r[i]), k, i, float(v.reshape(-1)[i]), g])
    rows.sort(key=lambda row: -row[0])
    return {"count": len(rows), "largest": rows[:n]}


def _grad_drift(device, batch, repeats):
    """One rank's plain-path gradients of one step from INIT, repeated: per
    leaf that moved, the largest |d| from the first repeat and that leaf's
    largest |g|."""
    from noise_flow_tpu_torch.parallel.mesh import Mesh

    grads = []
    for _ in range(repeats):
        tr = trainer(False, Mesh(1, 0, device))
        tr.train_step(tr._put(batch))
        grads.append({k: p.grad.cpu().clone() for k, p in tr.flow.named_parameters()
                      if p.grad is not None})
    moved = {}
    for g in grads[1:]:
        for k, v in g.items():
            d = float((v - grads[0][k]).abs().max())
            if d > 0:
                moved[k] = [max(d, moved.get(k, [0.0])[0]), float(grads[0][k].abs().max())]
    return {"leaves": len(grads[0]), "moved": moved}


def agreement(ranks: int, device, backend, repeats: int, deterministic: str,
              work: str) -> dict:
    """See the module docstring (``--agreement``)."""
    from noise_flow_tpu_torch.parallel import distributed as pd

    common = ["--synthetic_data", str(IMAGES), "--patch_height", "32", "--n_batch_train",
              str(GLOBAL_B), "--device", str(device), "--logdir", work]
    batches = _global_batches(common, 2)
    set_deterministic(deterministic)
    out = {"grad_drift": _grad_drift(device, batches[0], repeats), "repeats": []}

    def spawn(local_bn):
        return pd.spawn_ranks(ranks, plain_steps, (batches, deterministic, local_bn), device,
                              backend, timeout=SPAWN_S)

    def compare(got, one):
        return {"grads_step1": grads_agreement(got["grads"][0], one["grads"][0]),
                "weights": weights_agreement(got["state"], one["state"]),
                "weights_floor": {f: weights_agreement(got["state"], one["state"],
                                                       one["grads"], f)
                                  for f in (1e-5, 1e-4, 1e-3)},
                "outside": _outside(got, one)}
    first = None
    for _ in range(repeats):
        one = plain_steps(0, device, batches, deterministic)
        many = spawn(False)
        first = first or (one, many[0])
        out["repeats"].append({
            "ranks_vs_one": compare(many[0], one),
            "one_vs_first": weights_agreement(one["state"], first[0]["state"]),
            "ranks_vs_first": weights_agreement(many[0]["state"], first[1]["state"]),
            "nlls_one": one["nlls"], "nlls_ranks": many[0]["nlls"],
            "ranks_bit_equal": all(all(bool((m["state"][k] == v).all())
                                       for k, v in many[0]["state"].items()) for m in many)})
    out["fault_vs_one"] = compare(spawn(True)[0], one)
    set_deterministic("off")
    return out


def _gloo_collectives(rank, device):
    """All-reduce and all-gather of a small CUDA tensor: their values."""
    import torch
    import torch.distributed as dist

    n = dist.get_world_size()
    t = torch.full((4,), float(rank + 1), device=device)
    s = t.clone()
    dist.all_reduce(s)
    parts = [torch.empty_like(t) for _ in range(n)]
    dist.all_gather(parts, t)
    return {"all_reduce": s.tolist(), "all_gather": [p.tolist() for p in parts],
            "ok": float(s[0]) == n * (n + 1) / 2 and
            [float(p[0]) for p in parts] == [float(r + 1) for r in range(n)]}


def _gloo_send_recv(rank, device):
    """Rank 0 sends a small CUDA tensor to rank 1."""
    import torch
    import torch.distributed as dist

    t = torch.full((4,), float(rank + 1), device=device)
    if rank == 0:
        dist.send(t, 1)
        return "sent"
    if rank == 1:
        dist.recv(t, 0)
        return "ok" if float(t[0]) == 1.0 else f"wrong {t.tolist()}"
    return "idle"


def gloo_cuda(ranks: int, device) -> dict:
    """See the module docstring (``--gloo-cuda``)."""
    from noise_flow_tpu_torch.parallel import distributed as pd

    out = {"collectives": pd.spawn_ranks(ranks, _gloo_collectives, (), device, "gloo",
                                         timeout=120)}
    if not all(r["ok"] for r in out["collectives"]):
        raise AssertionError(f"gloo collectives on CUDA tensors: {out['collectives']}")
    try:
        out["send_recv"] = pd.spawn_ranks(ranks, _gloo_send_recv, (), device, "gloo",
                                          timeout=120)
    except Exception as e:  # noqa: BLE001 - a rank that died is the answer
        out["send_recv"] = f"{type(e).__name__}: {str(e).strip().splitlines()[-1]}"[:300]
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser("probes.mesh")
    p.add_argument("--ranks", type=int, default=4)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--work", type=str, default=os.path.join(REPO, "build", "mesh_probe"))
    p.add_argument("--out", type=str, default="")
    p.add_argument("--agreement", action="store_true")
    p.add_argument("--gloo-cuda", dest="gloo_cuda", action="store_true")
    p.add_argument("--backend", type=str, default=None, choices=("gloo", "nccl"))
    p.add_argument("--repeats", type=int, default=3)
    p.add_argument("--deterministic", type=str, default="off", choices=DETERMINISM)
    p.add_argument("--steps_per_call", type=int, default=1)
    p.add_argument("--global_batch", type=int, default=GLOBAL_B)
    p.add_argument("--epochs", type=int, default=EPOCHS)
    p.add_argument("--no_dncnn", action="store_true")
    a = p.parse_args(argv)
    if a.deterministic == "all":
        # before the first cuBLAS call of this process and of the ranks
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

    from noise_flow_tpu_torch.cli import train as cli_train
    from noise_flow_tpu_torch.cli import train_dncnn
    from noise_flow_tpu_torch.parallel import distributed as pd
    from noise_flow_tpu_torch.parallel.mesh import Mesh
    from noise_flow_tpu_torch.utils.device import resolve_device

    device = resolve_device(a.device)
    report = {"ranks": a.ranks, "device": a.device, "global_batch": a.global_batch}
    report["backend"] = a.backend or pd.default_backend(device)
    if device.type == "cuda":
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    shutil.rmtree(a.work, ignore_errors=True)
    os.makedirs(a.work)
    if a.gloo_cuda:
        report["backend"] = "gloo"
        report["gloo_cuda"] = gloo_cuda(a.ranks, device)
        return _report(report, a)
    if a.agreement:
        report["deterministic"] = a.deterministic
        try:
            report["agreement"] = agreement(a.ranks, device, a.backend, a.repeats,
                                            a.deterministic, a.work)
        except RuntimeError as e:   # "all": the op with no deterministic algorithm
            report["error"] = str(e)[:2000]
        return _report(report, a)
    k, gb = a.steps_per_call, a.global_batch
    # K > 1: 2 full groups and a 6-step tail an epoch (16 patches an image)
    images = IMAGES if k < 2 else -(-(2 * k + 6) * gb // 16)
    common = ["--synthetic_data", str(images), "--patch_height", "32", "--n_batch_train",
              str(gb), "--n_batch_test", str(gb), "--epochs", str(a.epochs),
              "--init_checkpoint", INIT, "--steps_per_call", str(k),
              "--device", a.device, "--pallas_train_dtype", "float32"]
    report["steps_per_call"], report["images"] = k, images
    ckpt = f"ckpt/model.ckpt-{a.epochs}.npz"
    for name, flags in (("plain", []), ("oneshot", ["--use_pallas"])):
        runs = {}
        cache = os.path.join(a.work, f"cache_{name}")
        os.makedirs(cache)
        # (ranks, K): N ranks and one rank at K, and N ranks eager where K > 1
        for n, kk in [(a.ranks, k), (1, k)] + ([(a.ranks, 1)] if k > 1 else []):
            logdir = os.path.join(a.work, f"{name}_{n}_{kk}")
            t0 = time.time()
            cli_train.main(common + flags + ["--mesh", str(n), "--cache_dir", cache,
                                             "--steps_per_call", str(kk), "--logdir", logdir])
            runs[f"{n}_{kk}"] = {"seconds": time.time() - t0,
                                 "train": _rows(logdir, "train.txt"),
                                 "test": _rows(logdir, "test.txt")}

        def state(n, kk):
            return _checkpoint_state(os.path.join(a.work, f"{name}_{n}_{kk}", ckpt))

        def rel(x, y):
            return {s: max(abs(u - v) / abs(v) for u, v in zip(runs[x][s], runs[y][s]))
                    for s in ("train", "test")}
        ratio, _, key = weights_agreement(state(a.ranks, k), state(1, k))
        report[name] = {"runs": runs, "max_rel": rel(f"{a.ranks}_{k}", f"1_{k}"),
                        "weights_ratio": ratio, "weights_worst": key}
        if k > 1:
            graph, eager = state(a.ranks, k), state(a.ranks, 1)
            differ = [n for n, v in eager.items() if not bool((graph[n] == v).all())]
            g_ratio, _, g_key = weights_agreement(graph, eager)
            report[name]["graph_vs_eager"] = {
                "same_bits": not differ, "first_differing": differ[0] if differ else None,
                "differing": len(differ), "max_rel": rel(f"{a.ranks}_{k}", f"{a.ranks}_1"),
                "weights_ratio": g_ratio, "weights_worst": g_key}

    batch = _global_batches(common, 1)[0]
    report["times"] = pd.spawn_ranks(a.ranks, _time_rank, (batch, k), a.device, a.backend,
                                     timeout=SPAWN_S)
    report["one_rank"] = step_times(Mesh(1, 0, device), batch, k)
    if a.no_dncnn:
        return _report(report, a)

    save = os.path.join(a.work, "dncnn")
    t0 = time.time()
    train_dncnn.main(["--model", "DnCNN_NF", "--noise_flow_path", MODEL, "--device", a.device,
                      "--synthetic_data", "80", "--max_epoch", "2", "--save_dir", save,
                      "--mesh", str(a.ranks),
                      "--cam_iso_nlf", os.path.join(REPO, "cam_iso_nlf.txt")])
    with open(os.path.join(save, "log.csv")) as f:
        report["dncnn"] = {"seconds": time.time() - t0,
                           "losses": [float(r.split(",")[1]) for r in f.read().splitlines()]}
    return _report(report, a)


def _report(report, a) -> int:
    line = json.dumps(report)
    print(line)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            f.write(line + "\n")
    shutil.rmtree(a.work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
