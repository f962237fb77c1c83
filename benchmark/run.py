"""Benchmark of noise_flow_tpu_torch on NVIDIA cards: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (an entry of ``workloads`` in
``BENCHMARK.json``) names a configuration and a traffic mix; the mix's
``kind`` names the module that runs it, ``harness/<kind>.py``
(``harness.spec.driver``; ``train``, ``sample``), which provides ``run(ctx)``,
its planted faults (``FAULTS``, ``CALIBRATED``), the readings its limits are
set from (``readings``) and a CPU test's size (``shrink``), and is given a
``Context``: the cell's configuration and mix, the run's arguments and
device, and the hooks below (``harness/spec.py`` says what each returns). A
new traffic kind is a new module there, with its mixes, configurations,
limits and reference as new files.

Set-up builds the program and its inputs from the seed, warms up every shape
the cell uses and drives the program's first steps; the window then
measures for about ``--seconds`` (``--trace 1``: a traced window, and the
per-layer metrics instead of the end-to-end ones). Once the window has
closed, the device's peak memory is read, the program's state is freed, and
the plain reference (``reference/``) decides ``correct``. The last line of
standard output is the result, a JSON object; the numbers compared, each
beside its limit, are the last lines of standard error and the last key of
the result.

Exits 2 without a result when no CUDA card is present (or fewer than the
cell's chips), and 3 when a module of JAX or of the JAX package is loaded
once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# caches of the program's kernels, at fixed paths inside the checkout
CACHE = ROOT / "build" / "bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "noise_flow_tpu")


def _prepare_environment() -> None:
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    for p in (str(ROOT), str(BENCH)):
        if p not in sys.path:
            sys.path.insert(0, p)


def forbidden_modules():
    """Top-level names of loaded modules that belong to JAX or to the JAX
    package, compared whole (``noise_flow_tpu_torch`` is neither)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


class Context:
    """What a driver is given: the cell's files, the run's arguments and
    device, and the hooks that mark the window's start, read the peak
    memory and free the program's state. ``config`` has ``weights_path``
    where the configuration names a checkpoint (``weights``); a driver
    whose weights come from the seed reads what it needs from ``config``."""

    def __init__(self, cell, args, device):
        import torch

        self.workload = cell["workload"]
        self.config = dict(cell["config"])
        if "weights" in self.config:
            self.config["weights_path"] = str(ROOT / self.config["weights"])
        self.traffic = cell["traffic"]
        self.seed, self.seconds, self.trace = args.seed, args.seconds, bool(args.trace)
        self.device = torch.device(device)
        self.setup_s = None
        # a fault planted under the timed path (tests, calibration): given
        # the trainer, or each sampler closure, which it returns
        self.plant = None

    def mark(self, what: str) -> None:
        """A set-up phase's end, on standard error (seconds since start)."""
        print(f"setup {what} at {time.perf_counter() - T_START:.3f} s", file=sys.stderr)

    def window_started(self) -> None:
        self.setup_s = time.perf_counter() - T_START
        self.mark("window start")

    def memory_peak(self) -> int:
        import torch

        if self.device.type != "cuda":
            return 0
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        import gc

        import torch

        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def run_cell(name: str, args, device=None, adjust=None):
    """One run of cell ``name``; returns the result's dict. ``device`` None
    asks for the cell's CUDA cards (and raises SystemExit(2) without them);
    tests pass ``"cpu"``, and ``adjust``, a function that is given the
    cell's dict (configuration, traffic, limits) and the ``Context`` before
    the run and may change them."""
    import torch

    from harness import check, spec, work
    from harness.trace import idle_share

    cell = spec.cell(name)
    kind = spec.driver(cell["traffic"]["kind"])
    chips = int(cell["workload"]["chips"])
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"needs {chips} CUDA card(s); torch.cuda.is_available() = "
                  f"{torch.cuda.is_available()}", file=sys.stderr)
            raise SystemExit(2)
        device = "cuda:0"
    torch.backends.cuda.matmul.allow_tf32 = bool(cell["config"]["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell["config"]["tf32"])
    ctx = Context(cell, args, device)
    ctx.mark("imports")
    if adjust is not None:
        adjust(cell, ctx)
    out = kind.run(ctx)

    correct, checks = check.verdict(out["numbers"], cell["limits"]["limits"])
    dev = ctx.device
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": chips, "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": correct, "attempted": out["attempted"], "failed": out["failed"]}
    metrics = {}
    if not ctx.trace:
        values = dict(out["measured"], setup_s=ctx.setup_s)
        for m in cell["end_to_end"]:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        tr = out["trace"]
        run = _Run(tr, out["trace_counts"], ctx.config, work, idle_share)
        for m in cell["per_layer"]:
            v = spec.reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        print(f"trace: {sum(int(v[0]) for v in tr.ops.values())} device ops, read in "
              f"{tr.read_s:.1f} s (profiler {tr.read_parts[0]:.1f} s, harness "
              f"{tr.read_parts[1]:.1f} s)", file=sys.stderr)
        result["breakdown"] = tr.breakdown()
    result.update(metrics=metrics, device=device_info)
    result["checks"] = checks
    return result


class _Run:
    """What a per-layer metric's reader reads: ``trace`` (``harness.trace.
    Trace``), ``counts`` (steps or calls in the traced window, batch),
    ``config``, ``work`` (``harness.work``) and ``idle_share(trace)``."""

    def __init__(self, trace, counts, config, work, idle_share):
        self.trace, self.counts, self.config, self.work = trace, counts, config, work
        self.idle_share = idle_share


def main(argv=None) -> int:
    _prepare_environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import json

    result = run_cell(args.workload, args)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
