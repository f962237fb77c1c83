"""Readings that a cell's correctness limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,... \
        --control-seeds 11,12,13 --fault-seeds 11,12,13 [--seconds 3] [--out file.json]

For each seed of ``--seeds``, the program's compared numbers (sound runs:
the lower readings); for each of ``--control-seeds``, the same numbers of
the precision control, the reference computed in float32 with TF32 products
put in the program's place (the upper readings); for each of
``--fault-seeds``, the numbers of the program with each planted fault of
``harness/faults.py`` that sets a limit (``faults.CALIBRATED``). Training
cells take set-up's first steps and its first epoch (no window); sampling
cells a window of ``--seconds``. One process, one
JSON document of readings on standard output (and in ``--out``).
"""

from __future__ import annotations

import argparse
import json
import sys

import run as bench


def _with_leaves(prog, ref, short):
    """The compared numbers, with every step's and leaf's gap beside them;
    ``short``: the checked epoch's steps short of the split's full batches."""
    from harness import check

    detail = {}
    numbers = check.train_numbers(prog, ref, detail)
    return dict(numbers, steps_short=short, detail=detail)


def _short(s) -> int:
    return abs(s["steps_per_epoch"] - s["first_epoch"][1])


def _train(ctx, seeds, control_seeds, fault_seeds, kinds):
    import torch

    from harness import check, faults
    from harness import train as train_kind
    from reference.flow import tf32_round

    out = {"program": {}, "control": {}, "faults": {}}
    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        ctx.seed, ctx.plant = seed, None
        s = train_kind.prepare(ctx)
        del s["trainer"]
        ctx.free()
        ref = check.reference_run(ctx.config, s["rows"], s["nsteps"], s["marks"], ctx.device)
        if seed in seeds:
            out["program"][seed] = _with_leaves(s["prog"], ref, _short(s))
        if seed in control_seeds:
            ctl = check.reference_run(ctx.config, s["rows"], s["nsteps"], s["marks"], ctx.device,
                                      dtype=torch.float32, products=tf32_round)
            # the reference in the program's place takes every batch
            out["control"][seed] = _with_leaves(ctl, ref, 0)
        if seed in fault_seeds:
            for name in kinds:
                ctx.plant = faults.TRAIN[name]
                f = train_kind.prepare(ctx)
                del f["trainer"]
                ctx.free()
                out["faults"].setdefault(name, {})[seed] = _with_leaves(f["prog"], ref, _short(f))
            ctx.plant = None
        print(json.dumps({"seed": seed, **{k: v.get(seed) for k, v in out.items()
                                           if k != "faults"}}), file=sys.stderr, flush=True)
    return out


def _sample(ctx, seeds, control_seeds, fault_seeds, kinds):
    import torch

    from harness import check, faults
    from harness import sample as sample_kind
    from reference.flow import RefFlow, tf32_round

    out = {"program": {}, "control": {}, "faults": {}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        ctx.seed, ctx.plant = seed, None
        r = sample_kind.run(ctx)
        if seed in seeds:
            out["program"][seed] = dict(r["numbers"], calls=r["attempted"])
        if seed in control_seeds:
            ref = RefFlow(ctx.config["weights_path"], ctx.config["arch"], ctx.config["width"],
                          torch.float32, ctx.device, tf32_round)
            ctl = [(cs, ci, check.reference_noise(ref, cs, r["conds"][ci], ctx.traffic["temp"]))
                   for cs, ci, _ in r["answers"]]
            out["control"][seed] = {"sample_gap": check.sample_gap(
                ctx.config, ctl, r["conds"], ctx.traffic["temp"], ctx.device)}
        del r
        ctx.free()
        print(json.dumps({"seed": seed, "program": out["program"].get(seed),
                          "control": out["control"].get(seed)}), file=sys.stderr, flush=True)
    for seed in fault_seeds:
        for name in kinds:
            ctx.seed, ctx.plant = seed, faults.SAMPLE[name]
            r = sample_kind.run(ctx)
            out["faults"].setdefault(name, {})[seed] = r["numbers"]
            del r
            ctx.free()
    ctx.plant = None
    return out


def run_readings(workload: str, seeds: str, control_seeds: str = "", fault_seeds: str = "",
                 fault_names: str = "", seconds: float = 3.0, device: str = "cuda:0"):
    """The readings of one cell: {program, control, faults: {name: ...}},
    each by seed (comma-separated lists of seeds)."""
    from harness import faults, spec

    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    cell = spec.cell(workload)
    ctx = bench.Context(cell, argparse.Namespace(seed=0, seconds=seconds, trace=0), device)
    kind = cell["traffic"]["kind"]
    names = fault_names.split(",") if fault_names else list(faults.CALIBRATED[kind])
    fn = _train if kind == "train" else _sample
    res = fn(ctx, ints(seeds), ints(control_seeds), ints(fault_seeds), names)
    res["workload"] = workload
    return res


def main(argv=None) -> int:
    bench._prepare_environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--faults", default="", help="comma-separated fault names (default: faults.CALIBRATED)")
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
