"""What a run measures, found by name from ``BENCHMARK.json``.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
Each is a file of its own: the configuration's file is the ``file`` of its
entry in ``configs``; the traffic mix is ``benchmark/workloads/<traffic>.json``;
the cell's correctness limits are ``benchmark/limits/<cell>.json``; a
per-layer metric is read by ``benchmark/metrics/<metric>.py``. A later change
adds a cell, a mix, a configuration or a metric by adding such files and
entries, and edits none that are here.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parents[2]


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
