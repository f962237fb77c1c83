"""The harness finds a cell's files by name, and imports neither JAX nor the
JAX package.

Discovery: a configuration, a traffic mix, a cell's limits, a per-layer
metric and a traffic kind added as new files (and as entries of
``BENCHMARK.json``) are found by the harness, a new kind runs through
``run.run_cell`` and ``calibrate.run_readings``, and no file that was there
changes. Imports: no module that
``benchmark/run.py`` or the reference loads has the top-level name ``jax``,
``jaxlib``, ``flax`` or ``noise_flow_tpu`` (compared whole:
``noise_flow_tpu_torch`` is the program), and the reference imports nothing
of the program."""

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from harness import spec

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "noise_flow_tpu"}


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def _copy(tmp_path):
    """A copy of ``benchmark/`` and ``BENCHMARK.json`` under ``tmp_path``, and
    the digests of the copy's files."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    return tmp_path / "benchmark", _digests(tmp_path / "benchmark")


def test_new_files_are_found_by_name(tmp_path):
    b, before = _copy(tmp_path)
    cfg = json.loads((b / "configs" / "noiseflow-sax4gax4-exact-f32.json").read_text())
    (b / "configs" / "new-config.json").write_text(json.dumps(dict(cfg, name="new-config")))
    traffic = json.loads((b / "workloads" / "sample.b8192.json").read_text())
    (b / "workloads" / "sample.b138.json").write_text(json.dumps(dict(traffic, batch=138)))
    (b / "limits" / "new.sample.b138.json").write_text(json.dumps({"limits": {"sample_gap": 1}}))
    (b / "metrics" / "new_metric.py").write_text("def read(run):\n    return 42.0\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "new-config", "source": "x",
                             "file": "benchmark/configs/new-config.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "new.sample.b138", "config": "new-config",
                               "traffic": "sample.b138", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if m["name"] == "sample_patches_per_s":
            m["workloads"].append("new.sample.b138")
    bench["per_layer"].append({"name": "new_metric", "unit": "%", "better": "higher",
                               "source": "device_trace", "layer": "device",
                               "moves": "sample_patches_per_s",
                               "workloads": ["new.sample.b138"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("new.sample.b138", tmp_path)
    assert cell["config"]["name"] == "new-config"
    assert cell["traffic"]["batch"] == 138
    assert cell["limits"] == {"limits": {"sample_gap": 1}}
    assert [m["name"] for m in cell["end_to_end"]] == ["sample_patches_per_s", "setup_s"]
    assert [m["name"] for m in cell["per_layer"]] == ["new_metric"]
    assert spec.reader("new_metric", tmp_path)(None) == 42.0
    after = _digests(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before


# a traffic kind added as new files: a seeded vector scaled on the CPU, its
# reference the same product in NumPy, one fault that alters an answer
TOYKIND = '''"""Traffic kind ``toykind``: a seeded vector scaled, call after call."""

import time

import torch


def _answer_altered(program):
    def altered(x):
        out = program(x)
        out[0] += 1.0
        return out
    return altered


FAULTS = {"answer_altered": _answer_altered}
CALIBRATED = ("answer_altered",)


def run(ctx):
    gen = torch.Generator().manual_seed(int(ctx.seed))
    x = torch.randn(ctx.traffic["n"], generator=gen, dtype=torch.float64)
    program = lambda v: v * ctx.config["scale"]
    if ctx.plant is not None:
        program = ctx.plant(program)
    ctx.window_started()
    calls, t0 = 0, time.perf_counter()
    while calls == 0 or time.perf_counter() - t0 < ctx.seconds:
        out = program(x)
        calls += 1
    window = time.perf_counter() - t0
    peak = ctx.memory_peak()
    ctx.free()
    reference = x.numpy() * ctx.config["scale"]
    gap = float(abs(out.numpy() - reference).max())
    return {"attempted": calls, "failed": 0, "memory_peak_bytes": peak,
            "numbers": {"toy_gap": gap}, "measured": {"toy_calls_per_s": calls / window},
            "trace": None, "trace_counts": {"calls": calls}}


def readings(ctx, seeds, control_seeds, fault_seeds, names):
    out = {"program": {}, "control": {}, "faults": {}}
    for seed in seeds:
        ctx.seed, ctx.plant = seed, None
        out["program"][seed] = run(ctx)["numbers"]
    for seed in fault_seeds:
        for name in names:
            ctx.seed, ctx.plant = seed, FAULTS[name]
            out["faults"].setdefault(name, {})[seed] = run(ctx)["numbers"]
    ctx.plant = None
    return out


def shrink(ctx):
    ctx.traffic["n"] = 64
'''

TOY_RUN = """
import argparse, json, sys
sys.path[:0] = [%r, %r]
import calibrate, run
from harness import check, spec

kind = spec.driver("toykind")
args = argparse.Namespace(seed=2 ** 31 + 91, seconds=0.2, trace=0)


def small(plant):
    def adjust(cell, ctx):
        kind.shrink(ctx)
        ctx.plant = plant
    return adjust


good = run.run_cell("toy.cell", args, device="cpu", adjust=small(None))
bad = run.run_cell("toy.cell", args, device="cpu", adjust=small(kind.FAULTS["answer_altered"]))
cal = calibrate.run_readings("toy.cell", "11,12", fault_seeds="11", seconds=0.1, device="cpu")
limits = spec.cell("toy.cell")["limits"]["limits"]
print(json.dumps({"good": good, "bad": bad, "kind_file": kind.__file__,
                  "program": [check.verdict(n, limits)[0] for n in cal["program"].values()],
                  "fault": [check.verdict(n, limits)[0]
                            for n in cal["faults"]["answer_altered"].values()]}))
"""


def test_a_new_traffic_kind_runs_as_new_files(tmp_path):
    b, before = _copy(tmp_path)
    (b / "harness" / "toykind.py").write_text(TOYKIND)
    (b / "configs" / "toy-config.json").write_text(json.dumps(
        {"name": "toy-config", "tf32": False, "scale": 3.0}))
    (b / "workloads" / "toy.mix.json").write_text(json.dumps({"kind": "toykind", "n": 4096}))
    (b / "limits" / "toy.cell.json").write_text(json.dumps({"limits": {"toy_gap": 0}}))
    (b / "metrics" / "toy_calls.py").write_text(
        "def read(run):\n    return run.counts.get(\"calls\") or None\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "toy-config", "source": "x",
                             "file": "benchmark/configs/toy-config.json", "reduced": [],
                             "why": "x"})
    bench["workloads"].append({"name": "toy.cell", "config": "toy-config", "traffic": "toy.mix",
                               "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "toy_calls_per_s", "unit": "calls/s",
                                "better": "higher", "bound": 0.05, "source": "host_clock",
                                "workloads": ["toy.cell"]})
    bench["per_layer"].append({"name": "toy_calls", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "toy_calls_per_s", "workloads": ["toy.cell"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = TOY_RUN % (str(tmp_path), str(b))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert Path(res["kind_file"]) == b / "harness" / "toykind.py"
    good, bad = res["good"], res["bad"]
    for r in (good, bad):
        assert list(r)[:3] == ["correct", "attempted", "failed"] and list(r)[-1] == "checks"
        assert set(r["metrics"]) == {"toy_calls_per_s", "setup_s"}
        assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
        assert r["attempted"] > 0 and r["failed"] == 0
    assert good["correct"] is True and good["checks"] == {"toy_gap": {"value": 0.0, "limit": 0}}
    assert bad["correct"] is False and bad["checks"]["toy_gap"]["value"] == 1.0
    assert res["program"] == [True, True] and res["fault"] == [False]
    after = _digests(b)
    assert {k: v for k, v in after.items() if k in before} == before


@pytest.mark.parametrize("kind", ["check", "faults", "spec", "no_such_kind", "_private", "a.b"])
def test_driver_refuses_what_is_no_kind(kind):
    with pytest.raises(ValueError, match="traffic kind"):
        spec.driver(kind)


def test_every_cell_finds_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        kind = spec.driver(cell["traffic"]["kind"])
        assert callable(kind.run) and callable(kind.readings) and callable(kind.shrink)
        assert kind.CALIBRATED and all(callable(kind.FAULTS[f]) for f in kind.CALIBRATED)
        assert cell["limits"]["limits"]
        assert any(m["name"] == "setup_s" for m in cell["end_to_end"])
        assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        for m in cell["per_layer"]:
            assert callable(spec.reader(m["name"]))


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_source_imports_jax_and_the_reference_nothing_of_the_program():
    for path in BENCH.rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)
        if "reference" in path.parts:
            assert "noise_flow_tpu_torch" not in tops, path


def test_loaded_modules_hold_no_jax():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "import run, calibrate\n"
        "from harness import check, faults, spec, synth, trace, work\n"
        "[spec.driver(spec.cell(w['name'])['traffic']['kind'])"
        " for w in spec.benchmark()['workloads']]\n"
        "import reference.flow, reference.philox\n"
        "import noise_flow_tpu_torch.training.trainer, noise_flow_tpu_torch.ops.fused_sample\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
        "print(run.forbidden_modules())\n") % (str(ROOT), str(BENCH))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    tops, found = (eval(line) for line in out.stdout.strip().splitlines()[-2:])
    assert not set(tops) & FORBIDDEN
    assert found == []


def test_reference_modules_load_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "import reference.flow, reference.philox\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n") % str(BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=BENCH, timeout=300)
    assert out.returncode == 0, out.stderr
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not tops & (FORBIDDEN | {"noise_flow_tpu_torch"})
