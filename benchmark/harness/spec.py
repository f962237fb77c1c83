"""What a run measures, found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each is a file of its own: the configuration's file is the ``file`` of its
entry in ``configs``; the traffic mix is ``benchmark/workloads/<traffic>.json``;
the cell's correctness limits are ``benchmark/limits/<cell>.json``; a
per-layer metric is read by ``benchmark/metrics/<metric>.py``; the mix's
``kind`` is run by the traffic kind's module ``benchmark/harness/<kind>.py``
(``driver``). A later change adds a cell, a mix, a configuration, a metric or
a traffic kind by adding such files and entries, and edits none that are
here.

A traffic kind's module provides:

- ``run(ctx) -> dict``: one run. Set-up builds the program and its inputs
  from ``ctx.seed`` and calls ``ctx.window_started()`` when the window opens;
  once the window has closed it reads ``ctx.memory_peak()``, frees the
  program's state (``ctx.free()``) and compares the program's outputs with
  the plain reference. It returns ``attempted``, ``failed``,
  ``memory_peak_bytes``, ``numbers`` (the compared numbers, by the names of
  the cell's limits), ``measured`` (the end-to-end values, by metric name;
  ``setup_s`` is the harness's), ``trace`` (the ``harness.trace.Trace`` of a
  traced run, else None) and ``trace_counts`` (what the per-layer readers
  count the traced work by).
- ``FAULTS``: {name: plant}, each fault that the kind's cells can have,
  planted under the timed path through ``ctx.plant``; ``run`` hands the
  plant what it breaks (the trainer, each sampler closure, ...).
- ``CALIBRATED``: the names in ``FAULTS`` whose readings set a limit.
- ``readings(ctx, seeds, control_seeds, fault_seeds, names) -> dict``: the
  readings that the cell's limits are set from (``calibrate.py``):
  {"program": {seed: numbers}, "control": {seed: numbers}, "faults": {name:
  {seed: numbers}}}.
- ``shrink(ctx)``: cuts ``ctx.traffic`` and ``ctx.config`` to a size that a
  test on the CPU holds (``tests/``); the limits stay the cell's.

``ctx`` (``run.Context``) gives ``workload``, ``config`` (the configuration's
file, with ``weights_path`` when it names ``weights``), ``traffic`` (the
mix's file), ``seed``, ``seconds``, ``trace``, ``device`` and ``plant``.
Every configuration states ``tf32`` (whether the harness lets cuBLAS and
cuDNN take TF32 products); the rest of it is its kind's to read.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[2]
HARNESS = Path(__file__).resolve().parent
# the harness's own modules, which no traffic kind may name
OWN = ("check", "spec", "trace", "synth", "work", "program", "faults")
KIND_API = ("run", "FAULTS", "CALIBRATED", "readings", "shrink")


def load_json(path: Path):
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell(name: str, root: Path = ROOT) -> Dict:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports: {workload, config, traffic, limits, end_to_end,
    per_layer}."""
    spec = benchmark(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = load_json(root / configs[w["config"]]["file"])
    traffic = load_json(root / "benchmark" / "workloads" / f"{w['traffic']}.json")
    limits = load_json(root / "benchmark" / "limits" / f"{name}.json")
    e2e = [m for m in spec["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return {"workload": w, "config": config, "traffic": traffic, "limits": limits,
            "end_to_end": e2e, "per_layer": per_layer}


def reader(metric: str, root: Path = ROOT):
    """The ``read(run)`` function of ``benchmark/metrics/<metric>.py``."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    mod_name = "bench_metric_" + "".join(ch if ch.isalnum() else "_" for ch in metric)
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def driver(kind: str):
    """The module of traffic kind ``kind``: ``benchmark/harness/<kind>.py``,
    with the names of ``KIND_API``."""
    if not kind.isidentifier() or kind.startswith("_") or kind in OWN:
        raise ValueError(f"traffic kind {kind!r} is not a kind's name: a kind is a Python "
                         f"identifier, not starting with '_', and none of {OWN}")
    if not (HARNESS / f"{kind}.py").is_file():
        raise ValueError(f"no module for traffic kind {kind!r}: expected {HARNESS / kind}.py")
    mod = importlib.import_module(f".{kind}", __package__)
    missing = [a for a in KIND_API if not hasattr(mod, a)]
    if missing:
        raise ValueError(f"traffic kind module {mod.__file__} lacks {missing}")
    unknown = set(mod.CALIBRATED) - set(mod.FAULTS)
    if unknown:
        raise ValueError(f"traffic kind {kind!r} calibrates faults it does not have: {unknown}")
    return mod
