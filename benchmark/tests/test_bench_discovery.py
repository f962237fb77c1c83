"""The harness finds a cell's files by name, and imports neither JAX nor the
JAX package.

Discovery: a configuration, a traffic mix, a cell's limits and a per-layer
metric added as new files (and as entries of ``BENCHMARK.json``) are found
by the harness, and no file that was there changes. Imports: no module that
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

from harness import spec

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "noise_flow_tpu"}


def _digests(root: Path):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_files_are_found_by_name(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _digests(tmp_path / "benchmark")
    b = tmp_path / "benchmark"
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


def test_every_cell_finds_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cell = spec.cell(w["name"])
        assert cell["traffic"]["kind"] in ("train", "sample")
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
        "from harness import check, faults, sample, spec, synth, trace, train, work\n"
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
