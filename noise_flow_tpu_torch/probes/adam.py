"""Probes of the flow trainer's optimizer step on the card.

Two parts, each on the benchmark's flow (``CONFIGS``: the published
S-Ax4-G-Ax4-CAM, 95 parameter tensors, 2,433 floats) and its checkpoint:

- ``time``: device ms a step of each optimizer (``OPTIMIZERS``: torch's
  capturable multi-tensor Adam, which the trainer stepped before
  ``ops.adam``; torch's fused capturable Adam, a control; the kernel),
  eager (the card held busy while the host issues,
  ``train_template.time_ms``) and as a replayed CUDA graph of ``GRAPH_K``
  steps, its kernel launches a step and the host's ms to issue an eager
  step; in turns;
- ``epochs``: the trainer of each train cell (``ghost``, ``exact``) on a
  staged split of ``--epoch_steps`` random batches of 138, once with
  torch's capturable Adam and once with ``make_optimizer``'s: untraced
  epochs in turns, then one traced epoch of each, whose kernels are
  attributed to the optimizer by where they were launched (inside
  ``nf.step.optimizer`` in the eager steps) and, in the graph replays, which
  run no Python, by name (``OPT_KERNELS``, a lower bound there).

``chip_smoke.py`` phase 60 holds the kernel against torch's Adam. On the
card, from the root of a checkout::

    python -m noise_flow_tpu_torch.probes.adam --out chiprun_out/adam_probe.json

prints one line a result and writes them all with ``--out``.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import re
import statistics
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Callable, Dict, List

import torch

from noise_flow_tpu_torch.ops import adam as ad
from noise_flow_tpu_torch.ops import fused_sample as fs

ROOT = Path(__file__).resolve().parents[2]
CONFIGS = {"ghost": ROOT / "benchmark" / "configs" / "noiseflow-sax4gax4-ghost-f32.json",
           "exact": ROOT / "benchmark" / "configs" / "noiseflow-sax4gax4-exact-f32.json"}
GRAPH_K = 32
# the optimizers' kernels by name: torch's multi-tensor and fused Adam, and
# csrc/adam.cu
OPT_KERNELS = re.compile(r"multi_tensor_apply|fused_adam|FusedAdam|adam_kernel")
# (cam, iso, beta1, beta2) rows of cam_iso_nlf.txt for the random split
ROWS = ((2.0, 100.0, 4.79e-4, 2e-6), (0.0, 800.0, 7.23e-4, 3e-6), (4.0, 800.0, 3.356e-3, 6.3e-5))
BYTES_A_ELEMENT = 7 * 4     # p, g, m, v read; p, m, v written


def load_config(name: str) -> Dict:
    with open(CONFIGS[name]) as f:
        return json.load(f)


def cell_flow(name: str, device):
    """The cell's flow: its configuration's settings and checkpoint."""
    from noise_flow_tpu_torch.config import Config, default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    config = load_config(name)
    fields = {f.name for f in dataclasses.fields(Config)}
    hps = {k: (tuple(v) if isinstance(v, list) else v) for k, v in config.items() if k in fields}
    flow = NoiseFlow(tuple(config["x_shape"]), default_config(**hps), device=device)
    load_checkpoint(str(ROOT / config["weights"]), flow)
    return flow


def torch_adam(params, lr: float, **kw):
    """torch's Adam as the trainer built it before ``ops.adam``."""
    return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, capturable=True, **kw)


OPTIMIZERS: Dict[str, Callable] = {
    "torch_foreach_capturable": lambda ps, lr: torch_adam(ps, lr, foreach=True),
    "torch_fused_capturable": lambda ps, lr: torch_adam(ps, lr, fused=True),
    "kernel": lambda ps, lr: ad.Adam(ps, lr=lr, capturable=True),
}


def _copy(flow):
    return [p.detach().clone().requires_grad_(True) for p in flow.parameters()]


def _grads(params, gen):
    """Seeded gradients, each tensor at its own scale (1e-4 to 10)."""
    for p in params:
        scale = 10.0 ** (-4 + 5 * torch.rand((), generator=gen, device=p.device))
        p.grad = torch.randn(p.shape, generator=gen, device=p.device) * scale


def ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance between two float32 tensors' values in units in
    the last place (the bits as integers, made monotone across zero): the
    measure of ``chip_smoke.py`` phase 60."""
    def key(t):
        i = t.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((key(a) - key(b)).abs().max()) if a.numel() else 0


def rel_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b| / |b|."""
    return float(((a - b).abs() / b.abs().clamp_min(1e-30)).max()) if a.numel() else 0.0


def _launches_a_step(step, n: int = 10) -> float:
    """Kernels a step over n steps, by the profiler's device events (the
    annotations of the optimizer's own ``record_function`` left out)."""
    def run():
        for _ in range(n):
            step()
    return sum(1 for e in _traced(run) if _is_kernel(e)) / n


def _is_kernel(e) -> bool:
    return (str(e.device_type()).split(".")[-1] == "CUDA" and not e.is_user_annotation()
            and not e.name().startswith(("Memcpy", "Memset")))


def time_optimizers(device, rounds: int = 3) -> Dict:
    """Each optimizer's step on the flow's tensors: device ms eager and
    under a graph, launches and the host's ms to issue an eager step."""
    from noise_flow_tpu_torch.probes.train_template import time_ms

    flow = cell_flow("ghost", device)
    lr = load_config("ghost")["lr"]
    gen = torch.Generator(device=device).manual_seed(7)
    opts, graphs = {}, {}
    for name, make in OPTIMIZERS.items():
        ps = _copy(flow)
        _grads(ps, gen)
        opt = make(ps, lr)
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(3):
                opt.step()
        torch.cuda.current_stream(device).wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(GRAPH_K):
                opt.step()
        opts[name], graphs[name] = opt, g
    ms = {k: {"eager": [], "graph": [], "host": []} for k in opts}
    order = list(opts)
    for r in range(rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            opt, g = opts[name], graphs[name]
            ms[name]["eager"].append(time_ms(opt.step, 50))
            ms[name]["graph"].append(time_ms(g.replay, 5) / GRAPH_K)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(50):
                opt.step()
            ms[name]["host"].append((time.perf_counter() - t0) * 1e3 / 50)
            torch.cuda.synchronize()
    n_elem = sum(p.numel() for p in flow.parameters())
    out = {"tensors": len(list(flow.parameters())), "elements": n_elem,
           "bound_ms_bytes": n_elem * BYTES_A_ELEMENT / 3.35e12 * 1e3}
    for name in order:
        row = {k: statistics.median(v) for k, v in ms[name].items()}
        row["launches_a_step"] = _launches_a_step(opts[name].step)
        row["rounds"] = ms[name]
        out[name] = row
        print(f"time {name}: eager {row['eager']:.4f} ms, graph {row['graph']:.4f} ms a step, "
              f"{row['launches_a_step']:.1f} launches, host {row['host']:.4f} ms", flush=True)
    out["limits"] = dict(zip(("tensors_a_launch", "param_bytes"), ad.limits()))
    print(f"time limits: {out['limits']}", flush=True)
    return out


def random_split(n: int, device, seed: int) -> Dict[str, torch.Tensor]:
    """n random patches of the cells' shapes as the trainer stages them:
    clean uniform in [0.02, 0.98], noise N(0, beta1 clean + beta2) of one of
    ``ROWS`` a patch."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = torch.tensor(ROWS, device=device)[torch.randint(len(ROWS), (n,), generator=gen,
                                                            device=device)]
    out = {"cam": rows[:, 0].contiguous(), "iso": rows[:, 1].contiguous(),
           "nlf0": rows[:, 2].contiguous(), "nlf1": rows[:, 3].contiguous()}
    out["_y"] = 0.02 + 0.96 * torch.rand((n, 32, 32, 4), generator=gen, device=device)
    sd = torch.sqrt(out["nlf0"][:, None, None, None] * out["_y"]
                    + out["nlf1"][:, None, None, None])
    out["_x"] = torch.randn((n, 32, 32, 4), generator=gen, device=device) * sd
    return out


def _traced(fn) -> List:
    """Run fn under the profiler (CPU and CUDA); its raw events."""
    from torch.autograd import profiler as P

    acts = {P.ProfilerActivity.CPU, P.ProfilerActivity.CUDA}
    config = P.ProfilerConfig(P.ProfilerState.KINETO, False, False, False, False, False,
                              P._ExperimentalConfig())
    torch.cuda.synchronize()
    P._prepare_profiler(config, acts)
    P._enable_profiler(config, acts)
    try:
        fn()
        torch.cuda.synchronize()
    finally:
        result = P._disable_profiler()
    return result.events()


def attribute(events, steps: int) -> Dict:
    """The optimizer's kernels in a traced epoch: in the eager steps, those
    whose launch (the runtime call of the same correlation id) lies inside
    an ``nf.step.optimizer`` span; in the graph replays, by name. Seconds
    and launches, a step of the epoch and a step of each part."""
    spans, launch_at, kernels = [], {}, []
    replays = []
    for e in events:
        name = e.name()
        if str(e.device_type()).split(".")[-1] == "CUDA":
            if _is_kernel(e):
                kernels.append((e.correlation_id(), e.start_ns(), e.duration_ns(), name))
        elif e.is_user_annotation():
            if name == "nf.step.optimizer":
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name == "nf.epoch.replay":
                replays.append(1)
        elif name.startswith("cu"):
            # the earliest runtime call of the id (PyTorch's ops carry ids
            # of another counter, which may collide)
            prev = launch_at.get(e.correlation_id())
            if prev is None or e.start_ns() < prev[0]:
                launch_at[e.correlation_id()] = (e.start_ns(), name)
    spans.sort()
    starts = [s for s, _ in spans]

    def in_span(t: int) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and spans[i][1] >= t

    eager = {"n": 0, "s": 0.0}
    graph = {"n": 0, "s": 0.0}
    names: Dict[str, int] = defaultdict(int)
    eager_names: Dict[str, int] = defaultdict(int)
    by_name = {"n": 0, "s": 0.0}
    for corr, _, dur, name in kernels:
        launch = launch_at.get(corr)
        in_graph = launch is not None and launch[1] == "cudaGraphLaunch"
        if OPT_KERNELS.search(name):
            by_name["n"] += 1
            by_name["s"] += dur * 1e-9
            names[name[:80]] += 1
        if launch is not None and not in_graph and in_span(launch[0]):
            eager["n"] += 1
            eager["s"] += dur * 1e-9
            eager_names[name[:60]] += 1
        elif in_graph and OPT_KERNELS.search(name):
            graph["n"] += 1
            graph["s"] += dur * 1e-9
    eager_steps = len(spans)
    graph_steps = steps - eager_steps
    return {
        "steps": steps, "eager_steps": eager_steps, "replays": len(replays),
        "kernels_a_step": len(kernels) / steps,
        "busy_kernels_s": sum(k[2] for k in kernels) * 1e-9,
        "opt_eager_launches_a_step": eager["n"] / max(eager_steps, 1),
        "opt_eager_ms_a_step": eager["s"] * 1e3 / max(eager_steps, 1),
        "opt_graph_launches_a_step": graph["n"] / max(graph_steps, 1),
        "opt_graph_ms_a_step": graph["s"] * 1e3 / max(graph_steps, 1),
        "opt_by_name_launches_a_step": by_name["n"] / steps,
        "opt_by_name_ms_a_step": by_name["s"] * 1e3 / steps,
        "opt_kernel_names": dict(names),
        "opt_eager_kernel_names": dict(eager_names),
    }


def epochs(device, epoch_steps: int, rounds: int = 3, seed: int = 23) -> Dict:
    """Per train cell: torch's capturable Adam against make_optimizer's,
    untraced epochs in turns, then one traced epoch each."""
    from noise_flow_tpu_torch.training.trainer import Trainer

    out = {}
    for cell in CONFIGS:
        trainers = {}
        data = None
        for kind in ("torch", "kernel"):
            flow = cell_flow(cell, device)
            tr = Trainer(flow, flow.cfg)
            if kind == "torch":
                tr.optimizer = torch_adam([p for _, p in flow.named_parameters()], flow.cfg.lr)
            b = flow.cfg.n_batch_train
            if data is None:
                data = random_split(epoch_steps * b, device, seed)
            tr._staged_train = data
            t0 = time.perf_counter()
            tr._train_epoch_staged(seed)          # captures the graph
            trainers[kind] = (tr, time.perf_counter() - t0)
        wall = {k: [] for k in trainers}
        for r in range(rounds):
            for kind in (("torch", "kernel") if r % 2 == 0 else ("kernel", "torch")):
                tr = trainers[kind][0]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr._train_epoch_staged(seed + 1 + r)
                wall[kind].append(time.perf_counter() - t0)
        cell_out = {}
        for kind, (tr, first) in trainers.items():
            before = fs.launch_counts["adam_step"]
            events = _traced(lambda: tr._train_epoch_staged(seed + 100))
            row = attribute(events, int(tr.epoch_steps[0].numel()))
            row["adam_step_launches"] = fs.launch_counts["adam_step"] - before
            row["untraced_epoch_s"] = wall[kind]
            row["patches_per_s"] = [row["steps"] * tr.cfg.n_batch_train / w for w in wall[kind]]
            row["first_epoch_s"] = first
            cell_out[kind] = row
            print(f"epochs {cell} {kind}: {json.dumps(row)}", flush=True)
        out[cell] = cell_out
        del trainers, data
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--parts", default="time,epochs")
    ap.add_argument("--epoch_steps", type=int, default=400)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("probes.adam: no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    res = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
           "cuda": torch.version.cuda}
    from noise_flow_tpu_torch.ops import _build
    _build.build_all(["adam"])
    res["ptxas"] = _build.kernel_resources("adam")
    print(f"ptxas[adam] {json.dumps(res['ptxas'])}", flush=True)
    parts = args.parts.split(",")
    if "time" in parts:
        res["time"] = time_optimizers(device)
    if "epochs" in parts:
        res["epochs"] = epochs(device, args.epoch_steps)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
