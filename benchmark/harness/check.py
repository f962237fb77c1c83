"""The comparison that decides ``correct``: the program's outputs against
the plain reference (``benchmark/reference``), number by number, each held
to its limit (``benchmark/limits/<cell>.json``).

Training: the reference follows the steps the program took in set-up, on
the same rows, from the same checkpoint, with its own BatchNorm and Adam,
and then the first steps of the program's first epoch, over the epoch's
permutation drawn again by the reference. Compared: each step's loss
(relative gap; the worst step counts), of set-up's steps and of the
epoch's apart; the norm of the first gradient as the optimizer got it; the
norm of the parameters' change, and of the BatchNorm running statistics'
change, after the eager steps and after the graph replays. A norm is
compared leaf by leaf, as the gap between the program's norm and the
reference's over the larger of the reference's norm of that leaf and of the
median leaf: for the gradient the worst leaf counts, for a change the median
leaf (the worst leaf's change swings from seed to seed with the rounding of
a few components that Adam scales up, and so does the variance they feed,
``PERF.md``). The change leaves out the leaves whose first gradient in the
reference is under a thousandth of the median leaf's: a bias in front of a
BatchNorm, whose gradient is nought but for rounding, moves under Adam by
rounding alone, and so does that BatchNorm's running mean.

Sampling: each sampled answer against the reference's noise for the same
call seed and the same clean patches and conditioning: the largest absolute
gap over the largest absolute reference value.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional

import torch

from reference.flow import Adam, RefFlow, bn_input_bias
from reference.philox import normals

COND_KEYS = ("clean", "nlf0", "nlf1", "iso", "cam")
EXCLUDE_BELOW = 1e-3     # of the median leaf's first gradient


def _norms(tree: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in tree.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's |‖prog leaf‖ − ‖ref leaf‖| / max(‖ref leaf‖, median ‖ref
    leaf‖), over the leaves of ``ref``."""
    pn, rn = _norms({k: prog[k] for k in ref}), _norms(ref)
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-300) for k in rn}


def reference_run(config: Dict, rows: Dict[str, torch.Tensor], nsteps: int,
                  marks: Dict[str, int], device, dtype=torch.float64, products=None) -> Dict:
    """The reference (or, with ``dtype`` float32 and ``products``, the
    precision control) through ``nsteps`` train steps on ``rows`` (the
    steps' batches one after another): each step's loss, the first
    gradient, and the parameters (``p_<mark>``) and BatchNorm running
    statistics (``bn_<mark>``) before the first step (mark ``0``) and after
    each mark's number of steps. ``setup_steps`` is the ``end`` mark."""
    ref = RefFlow(config["weights_path"], config["arch"], config["width"], dtype, device,
                  products)
    adam = Adam(ref.params, config["lr"], tuple(config["adam_betas"]), config["adam_eps"])
    names = sorted(ref.params)
    snap = lambda tree: {k: v.detach().double().cpu().clone() for k, v in tree.items()}  # noqa: E731
    bn = lambda: {k: v for k, v in ref.state.items() if ".bn" in k}  # noqa: E731
    b = config["n_batch_train"]
    out = {"p0": snap(ref.params), "bn0": snap(bn()), "losses": [], "setup_steps": marks["end"]}
    for s in range(nsteps):
        batch = {k: v[s * b:(s + 1) * b].to(device) for k, v in rows.items()}
        cond = {k: batch[k if k != "clean" else "_y"] for k in COND_KEYS}
        loss, _, new_state = ref.nll(batch["_x"], cond, config["bn"], config["bn_block"])
        grads = torch.autograd.grad(loss, [ref.params[k] for k in names], allow_unused=True)
        grads = {k: torch.zeros_like(ref.params[k]) if g is None else g
                 for k, g in zip(names, grads)}
        adam.step(grads)
        ref.state.update(new_state)
        out["losses"].append(float(loss.detach()))
        if s == 0:
            out["grad1"] = {k: g.detach().double().cpu() for k, g in grads.items()}
        for mark, at in marks.items():
            if s == at - 1:
                out[f"p_{mark}"], out[f"bn_{mark}"] = snap(ref.params), snap(bn())
    return out


def train_numbers(prog: Dict, ref: Dict, detail: Optional[Dict] = None) -> Dict[str, float]:
    """The compared numbers of a training cell from the program's and the
    reference's (or the control's) readings of the same steps: the worst
    step's loss gap in set-up's steps and in the epoch's, the worst leaf's
    first-gradient gap, and the median leaf's change gap of the parameters
    and of the BatchNorm statistics after the eager steps and after the
    graph groups. ``detail``, when given, receives every step's and
    every leaf's gap."""
    g1 = _norms(ref["grad1"])
    floor = EXCLUDE_BELOW * statistics.median(g1.values())
    moving = [k for k, v in g1.items() if v >= floor]
    delta = lambda r, key, base, keys: {k: r[key][k] - r[base][k] for k in keys}  # noqa: E731
    losses = [abs(p - r) / max(abs(r), 1.0) for p, r in zip(prog["losses"], ref["losses"])]
    if len(prog["losses"]) != len(ref["losses"]):
        losses.append(float("inf"))
    n = ref["setup_steps"]
    # a running mean follows its BN's input bias, which moves by rounding
    # alone where that bias is left out (``bn_input_bias``); variances do not
    bn = [k for k in sorted(ref["bn0"]) if k.endswith(".var") or bn_input_bias(k) in moving]
    gaps = {"grad": leaf_gaps(prog["grad1"], ref["grad1"]),
            "change": leaf_gaps(delta(prog, "p_eager", "p0", moving),
                                delta(ref, "p_eager", "p0", moving)),
            "change_graph": leaf_gaps(delta(prog, "p_end", "p0", moving),
                                      delta(ref, "p_end", "p0", moving)),
            "bn_eager": leaf_gaps(delta(prog, "bn_eager", "bn0", bn),
                                  delta(ref, "bn_eager", "bn0", bn)),
            "bn_end": leaf_gaps(delta(prog, "bn_end", "bn0", bn), delta(ref, "bn_end", "bn0", bn))}
    if detail is not None:
        detail.update(gaps, losses=losses)
    return {"loss_gap": max(losses[:n]), "loss_gap_epoch": max(losses[n:], default=float("inf")),
            "grad_gap": max(gaps["grad"].values()),
            "change_gap": statistics.median(gaps["change"].values()),
            "change_gap_graph": statistics.median(gaps["change_graph"].values()),
            "bn_state_gap": statistics.median(gaps["bn_eager"].values()),
            "bn_state_gap_graph": statistics.median(gaps["bn_end"].values())}


@torch.no_grad()
def reference_noise(ref: RefFlow, call_seed: int, cond, temp: float, block: int = 2048):
    """The reference's noise for one sampler call: its normals worked out
    again from the call's seed, times the temperature, through the flow, in
    blocks of ``block`` patches."""
    b = cond["clean"].shape[0]
    z = normals(call_seed, b, ref.device).to(ref.dtype) * temp
    return torch.cat([ref.sample(z[s:s + block],
                                 {k: v[s:s + block].to(ref.device) for k, v in cond.items()})
                      for s in range(0, b, block)])


@torch.no_grad()
def sample_gap(config: Dict, answers, conds, temp: float, device) -> Optional[float]:
    """The largest gap over the answers [(call seed, cond index, noise)]:
    max |noise − reference| / max |reference|, the reference in float64."""
    if not answers:
        return None
    ref = RefFlow(config["weights_path"], config["arch"], config["width"], torch.float64,
                  device)
    worst = 0.0
    for call_seed, ci, noise in answers:
        r = reference_noise(ref, call_seed, conds[ci], temp)
        got = noise.to(device).reshape(r.shape).to(torch.float64)
        worst = max(worst, float((got - r).abs().max()) / float(r.abs().max()))
    return worst


def verdict(numbers: Dict[str, Optional[float]], limits: Dict[str, float]):
    """(correct, checks): every number with a limit at or under it; a number
    that is missing, or not finite, fails."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name)
        good = v is not None and v == v and v <= limit
        ok = ok and good
        checks[name] = {"value": v, "limit": limit}
    return ok, checks
