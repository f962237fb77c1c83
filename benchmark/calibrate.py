"""Readings that a cell's correctness limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \
        --control-seeds 11,12,13 --fault-seeds 11,12,13 [--seconds 3] [--out file.json]

For each seed of ``--seeds``, the program's compared numbers (sound runs:
the lower readings); for each of ``--control-seeds``, the same numbers of
the precision control, the reference computed in float32 with TF32 products
put in the program's place (the upper readings); for each of
``--fault-seeds``, the numbers of the program with each planted fault that
sets a limit (the kind's ``CALIBRATED``). The readings are the cell's
traffic kind's (``harness/<kind>.py``, ``readings``): training cells take
set-up's first steps and its first epoch (no window); sampling cells a
window of ``--seconds``. One process, one JSON document of readings on
standard output (and in ``--out``).
"""

from __future__ import annotations

import argparse
import json
import sys

import run as bench


def run_readings(workload: str, seeds: str, control_seeds: str = "", fault_seeds: str = "",
                 fault_names: str = "", seconds: float = 3.0, device: str = "cuda:0"):
    """The readings of one cell: {program, control, faults: {name: ...}},
    each by seed (comma-separated lists of seeds)."""
    from harness import spec

    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    cell = spec.cell(workload)
    ctx = bench.Context(cell, argparse.Namespace(seed=0, seconds=seconds, trace=0), device)
    kind = spec.driver(cell["traffic"]["kind"])
    names = fault_names.split(",") if fault_names else list(kind.CALIBRATED)
    res = kind.readings(ctx, ints(seeds), ints(control_seeds), ints(fault_seeds), names)
    res["workload"] = workload
    return res


def main(argv=None) -> int:
    bench._prepare_environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="", help="comma-separated fault names (default: the kind's CALIBRATED)")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    res = run_readings(args.workload, args.seeds, args.control_seeds, args.fault_seeds,
                       args.faults, args.seconds, args.device)
    text = json.dumps(res, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
