"""Traffic kind ``train``: the flow trained on a staged split, epoch after
epoch, through the port's ``Trainer``.

Set-up builds one ``Trainer`` (the flow from the configuration's checkpoint,
Adam, the fused or plain step that the configuration names), stages the
split on the card (``synth.make_split``), and drives that same trainer
through its first steps on rows that all differ. First with
``_staged_steps``, the call an epoch makes: ``check.eager_steps`` single
steps (the eager path an epoch's tail takes), then ``check.graph_groups``
groups of K steps (the first captures the CUDA graph that every epoch
replays). Their losses, the first gradient (Adam's first moment after one
step, over 1 - beta1), and the parameters and BatchNorm running statistics
after each part are kept for the reference. Then a whole epoch through the
window's entry, ``Trainer._train_epoch_staged``: the losses of its first
``check.epoch_groups`` groups of K steps, as the program returned them
(``Trainer.epoch_steps``), are kept too; the reference continues from its
own state over the same epoch's permutation, which it draws again itself.

The window runs whole epochs of the same call (a new permutation of the
split each, K steps a graph replay, the ragged tail eager, one
synchronisation at its end), until the time left is under half an epoch.
Its steps are counted from what the program returned, each epoch's
``epoch_steps``; an epoch that takes other than every full batch of the
split counts in ``steps_short``, an exact comparison. Its rate is every
patch of every completed step over the window. A traced run traces one
epoch. Set-up ends with whole epochs for ``warmup_seconds`` (the checked
epoch among them): on the H100 the first ~15 s of epochs after set-up run
up to 15% slower than the rest (``PERF.md``).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Dict

import numpy as np
import torch

from harness import check, faults, program, synth
from harness.trace import Trace, span
from reference.flow import epoch_order, tf32_round

FIELDS = ("_x", "_y", "nlf0", "nlf1", "iso", "cam")
FAULTS = faults.TRAIN
# the faults whose readings set a limit; the others read 1 by the measure
# (a state left unchanged) or are caught by an exact count (the tail)
CALIBRATED = ("half_batch", "loss_altered")


def _trainer(config: Dict, device):
    from noise_flow_tpu_torch.training.trainer import Trainer

    model = program.flow(config, device)
    return Trainer(model, model.cfg)


def shuffle_seed(seed: int, epoch: int) -> int:
    """The permutation seed of a run's epoch ``epoch`` (1, 2, ...)."""
    return int(seed) * 4096 + epoch


def _snap(tree) -> Dict[str, torch.Tensor]:
    return {n: t.detach().double().cpu().clone() for n, t in tree.items()}


def _first_steps(trainer, order, eager: int, groups: int, k: int, beta1: float) -> Dict:
    named = dict(trainer.flow.named_parameters())
    bn = {n: t for n, t in trainer.flow.named_buffers() if ".bn" in n}
    out = {"p0": _snap(named), "bn0": _snap(bn), "losses": []}
    for s in range(eager):
        with span("bench.first_steps.eager"):
            nll, _ = trainer._staged_steps("train", order[s:s + 1], k, True)
        out["losses"] += nll.double().cpu().tolist()
        if s == 0:
            state = trainer.optimizer.state
            out["grad1"] = {n: (state[p]["exp_avg"].double().cpu() / (1 - beta1)
                                if p in state else torch.zeros(p.shape, dtype=torch.float64))
                            for n, p in named.items()}
    out["p_eager"], out["bn_eager"] = _snap(named), _snap(bn)
    for gi in range(groups):
        s = eager + gi * k
        with span("bench.first_steps.graph"):
            nll, _ = trainer._staged_steps("train", order[s:s + k], k, True)
        out["losses"] += nll.double().cpu().tolist()
    out["p_end"], out["bn_end"] = _snap(named), _snap(bn)
    out["setup_steps"] = len(out["losses"])
    return out


def prepare(ctx) -> Dict:
    """Set-up up to the warm-up's second epoch: the trainer with the split
    staged, its first steps taken (``ctx.plant``, when set, is given the
    trainer first), its first epoch run, and what the reference needs of
    them."""
    config, traffic, dev = ctx.config, ctx.traffic, ctx.device
    trainer = _trainer(config, dev)
    ctx.mark("program built")
    if ctx.plant is not None:
        ctx.plant(trainer)
    b, k = trainer.cfg.n_batch_train, max(int(trainer.cfg.steps_per_call), 1)
    rows = synth.parse_rows(traffic["nlf_rows"])
    with span("bench.stage"):
        data = synth.make_split(traffic["patches"], rows, traffic["clean"], ctx.seed, dev)
    trainer._staged_train = data
    ctx.mark("split staged")
    n = traffic["patches"]
    chk = traffic["check"]
    eager, groups = chk["eager_steps"], chk["graph_groups"]
    nsteps = eager + groups * k
    perm = np.random.default_rng([ctx.seed, 0]).permutation(n)[:nsteps * b]
    order = torch.as_tensor(perm.reshape(nsteps, b), device=dev)
    prog = _first_steps(trainer, order, eager, groups, k, config["adam_betas"][0])
    ctx.mark("first steps taken, graph captured")
    t0 = time.perf_counter()
    with span("bench.train_epoch"):
        trainer._train_epoch_staged(shuffle_seed(ctx.seed, 1))
    first_epoch_s = time.perf_counter() - t0
    m = chk["epoch_groups"] * k
    prog["losses"] += trainer.epoch_steps[0][:m].double().cpu().tolist()
    ctx.mark("first epoch")
    # the epoch's rows, by the permutation as the reference draws it
    epoch = torch.as_tensor(epoch_order(shuffle_seed(ctx.seed, 1), n, b)[:m], device=dev)
    idx = torch.cat([order.reshape(-1), epoch.reshape(-1)])
    check_rows = {f: data[f].index_select(0, idx).cpu() for f in FIELDS}
    return {"trainer": trainer, "prog": prog, "rows": check_rows, "nsteps": nsteps + m,
            "marks": {"eager": eager, "end": nsteps}, "batch": b, "steps_per_epoch": n // b,
            "first_epoch": (first_epoch_s, int(trainer.epoch_steps[0].numel()))}


def run(ctx) -> Dict:
    dev = ctx.device
    s = prepare(ctx)
    trainer, b, per_epoch = s["trainer"], s["batch"], s["steps_per_epoch"]
    epochs, last_s = 1, s["first_epoch"][0]
    short = abs(per_epoch - s["first_epoch"][1])

    def epoch() -> int:
        nonlocal epochs, short
        epochs += 1
        with span("bench.train_epoch"):
            trainer._train_epoch_staged(shuffle_seed(ctx.seed, epochs))
        taken = int(trainer.epoch_steps[0].numel())
        short += abs(per_epoch - taken)
        return taken

    t0 = time.perf_counter() - last_s
    while time.perf_counter() - t0 < ctx.traffic["warmup_seconds"]:
        te = time.perf_counter()
        epoch()
        last_s = time.perf_counter() - te
    ctx.window_started()
    steps, tr = 0, None
    if ctx.trace:
        with Trace(dev) as tr:
            steps = epoch()
        window = tr.window_s
        print(f"traced epoch {window:.4f} s; the last untraced one {last_s:.4f} s",
              file=sys.stderr)
    else:
        t0 = time.perf_counter()
        while True:
            te = time.perf_counter()
            steps += epoch()
            now = time.perf_counter()
            print(f"epoch {epochs} {now - te:.4f} s", file=sys.stderr)
            if ctx.seconds - (now - t0) < (now - te) / 2:
                break
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        window = time.perf_counter() - t0
    peak = ctx.memory_peak()
    del trainer, s["trainer"]
    ctx.free()

    t = time.perf_counter()
    ref = check.reference_run(ctx.config, s["rows"], s["nsteps"], s["marks"], dev)
    numbers = dict(check.train_numbers(s["prog"], ref), steps_short=short)
    print(f"reference {time.perf_counter() - t:.1f} s", file=sys.stderr)
    return {"attempted": steps, "failed": 0, "memory_peak_bytes": peak, "numbers": numbers,
            "measured": {"train_patches_per_s": steps * b / window},
            "trace": tr, "trace_counts": {"steps": steps, "batch": b}}


def _with_leaves(prog, ref, short):
    """The compared numbers, with every step's and leaf's gap beside them;
    ``short``: the checked epoch's steps short of the split's full batches."""
    detail = {}
    numbers = check.train_numbers(prog, ref, detail)
    return dict(numbers, steps_short=short, detail=detail)


def _short(s) -> int:
    return abs(s["steps_per_epoch"] - s["first_epoch"][1])


def readings(ctx, seeds, control_seeds, fault_seeds, names) -> Dict:
    """The limits' readings (``calibrate.py``) from set-up's first steps and
    its first epoch, with no window: the program's, the control's (the
    reference in float32 with TF32 products, in the program's place) and
    each planted fault's of ``names``, by seed."""
    out = {"program": {}, "control": {}, "faults": {}}
    for seed in sorted(set(seeds) | set(control_seeds) | set(fault_seeds)):
        ctx.seed, ctx.plant = seed, None
        s = prepare(ctx)
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
            for name in names:
                ctx.plant = FAULTS[name]
                f = prepare(ctx)
                del f["trainer"]
                ctx.free()
                out["faults"].setdefault(name, {})[seed] = _with_leaves(f["prog"], ref, _short(f))
            ctx.plant = None
        print(json.dumps({"seed": seed, **{k: v.get(seed) for k, v in out.items()
                                           if k != "faults"}}), file=sys.stderr, flush=True)
    return out


def shrink(ctx) -> None:
    """A CPU test's size: 7 batches (3 groups of 2 steps and a tail), no
    warm-up."""
    ctx.traffic["patches"] = 7 * ctx.config["n_batch_train"]
    ctx.traffic["warmup_seconds"] = 0.0
    ctx.config["steps_per_call"] = 2
