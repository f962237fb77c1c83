"""Traffic kind ``sample``: noise drawn by ``make_sampler`` closures, one a
row of the traffic's noise-level table, each over its own clean patches.

Set-up folds the configuration's flow into one sampling program
(``build_sample_program``, running BatchNorm) and makes one sampler a row:
``batch`` clean patches made on the card from the seed, the row's camera,
ISO and NLF for all of them (``make_sampler`` computes their scale
coefficients once). Each sampler is called once to load the kernel.

The window calls the samplers in turn, each call with a new seed, closed
loop with at most ``in_flight`` calls on the card: the host waits on the
event of call i - in_flight before it issues call i. Each call's noise is
summed on the card into a running checksum, so that no call's work can be
skipped. Of each sampler's calls in the window one is kept, drawn from the
seed uniformly over that sampler's calls as they come (a reservoir of one
a sampler), so that every closure's conditioning is compared with the
reference in every run, once the window has closed. Its rate is every patch of every
call over the window. A traced run traces ``trace_seconds`` of the loop.
"""

from __future__ import annotations

import collections
import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from harness import check, faults, program, synth
from harness.trace import Trace, span
from reference.flow import RefFlow, tf32_round

SEED_MOD = 2 ** 31 - 1
FAULTS = faults.SAMPLE
CALIBRATED = ("state_unchanged", "half_batch", "answer_altered")


def call_seed(seed: int, i: int) -> int:
    """The seed of call i: distinct for every call of a run."""
    return (int(seed) + 1_000_003 * (i + 1)) % SEED_MOD


def run(ctx) -> Dict:
    from noise_flow_tpu_torch.ops.fused_sample import build_sample_program, make_sampler

    config, traffic, dev = ctx.config, ctx.traffic, ctx.device
    sampling = build_sample_program(program.flow(config, dev), bn_mode="running")
    ctx.mark("program built")
    b, temp = traffic["batch"], traffic["temp"]
    dtype = getattr(torch, config["sample_dtype"])
    gen = torch.Generator(device=dev).manual_seed(int(ctx.seed))
    with span("bench.stage"):
        conds = [synth.make_cond(b, row, traffic["clean"], gen, dev)
                 for row in synth.parse_rows(traffic["nlf_rows"])]
    samplers = [make_sampler(sampling, cond, temp=temp, bt=config["sample_bt"], mm_dtype=dtype,
                             tile_out=False) for cond in conds]
    if ctx.plant is not None:
        samplers = [ctx.plant(s) for s in samplers]
    for s in samplers:
        s(0)
    ctx.mark("samplers made and called")
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    in_flight = traffic["in_flight"]
    pick = np.random.default_rng([ctx.seed, 1])
    kept = [None] * len(samplers)    # a sampler's (call seed, sampler, noise)
    checksum = torch.zeros((), dtype=torch.float64, device=dev)
    pending = collections.deque()
    calls = 0
    ctx.window_started()

    def loop(seconds: float):
        nonlocal calls
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds or calls < len(samplers):
            if cuda and len(pending) == in_flight:
                pending.popleft().synchronize()
            i, r = calls, calls % len(samplers)
            with span("bench.sample_call"):
                noise = samplers[r](call_seed(ctx.seed, i))
            checksum.add_(noise.sum())
            if int(pick.integers(0, i // len(samplers) + 1)) == 0:
                kept[r] = (call_seed(ctx.seed, i), r, noise)
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
            calls += 1
        if cuda:
            torch.cuda.synchronize(dev)
        return time.perf_counter() - t0

    tr = None
    if ctx.trace:
        with Trace(dev) as tr:
            loop(traffic["trace_seconds"])
        window = tr.window_s
    else:
        window = loop(ctx.seconds)
    total = float(checksum)
    peak = ctx.memory_peak()
    del samplers, sampling
    ctx.free()
    t = time.perf_counter()
    gap = check.sample_gap(config, kept, conds, temp, dev)
    numbers = {"sample_gap": gap if total == total else float("nan")}
    print(f"reference {time.perf_counter() - t:.1f} s", file=sys.stderr)
    return {"attempted": calls, "failed": 0, "memory_peak_bytes": peak, "numbers": numbers,
            "measured": {"sample_patches_per_s": calls * b / window},
            "trace": tr, "trace_counts": {"calls": calls, "batch": b},
            "answers": kept, "conds": conds}


def readings(ctx, seeds, control_seeds, fault_seeds, names) -> Dict:
    """The limits' readings (``calibrate.py``), each from a window of
    ``ctx.seconds``: the program's, the control's (the reference in float32
    with TF32 products, in the program's place, for the program's kept
    answers) and each planted fault's of ``names``, by seed."""
    out = {"program": {}, "control": {}, "faults": {}}
    for seed in sorted(set(seeds) | set(control_seeds)):
        ctx.seed, ctx.plant = seed, None
        r = run(ctx)
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
        for name in names:
            ctx.seed, ctx.plant = seed, FAULTS[name]
            r = run(ctx)
            out["faults"].setdefault(name, {})[seed] = r["numbers"]
            del r
            ctx.free()
    ctx.plant = None
    return out


def shrink(ctx) -> None:
    """A CPU test's size: 64 patches a call."""
    ctx.traffic["batch"] = 64
