"""The program's spans (``utils/profiling.py``) on the CPU: a train epoch
under a profiler started the benchmark harness's way (its low-level entry
points, under which ``torch.autograd.profiler._is_profiler_enabled`` stays
False) nests ``nf.epoch`` ⊃ ``nf.epoch.eager`` ⊃ the step's phases; with no
profiler ``annotate`` calls nothing of the dispatcher; the status line's
counts are the spans'; the eager and replay spans count the epoch's steps
(graph replays stood in for by their steps run eagerly, as the CPU has no
graphs); a staged eval's steps span ``nf.eval.*``, outside every
``nf.epoch*``; one ``nf.sample.call`` span a ``make_sampler`` call."""

import collections

import numpy as np
import pytest
import torch
from torch.autograd import profiler as P

from noise_flow_tpu_torch.config import default_config
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.ops import fused_sample as fs
from noise_flow_tpu_torch.training import trainer as trainer_mod
from noise_flow_tpu_torch.training.step_graph import StepGraph
from noise_flow_tpu_torch.training.trainer import Trainer
from noise_flow_tpu_torch.utils.profiling import annotate

torch.set_num_threads(1)

ARCH = "sdn5|unc|gain4|unc"
B, STEPS, K = 8, 5, 2
STEP_PHASES = ("nf.step.gather", "nf.step.forward", "nf.step.backward", "nf.step.optimizer",
               "nf.step.state")


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0.01, 0.9, (b, 32, 32, 4)).astype(np.float32)
    x = (rng.standard_normal((b, 32, 32, 4)) * np.sqrt(0.0005 * clean + 2e-6)).astype(np.float32)
    return {"_x": x, "_y": clean, "nlf0": np.full((b,), 0.0005, np.float32),
            "nlf1": np.full((b,), 2e-6, np.float32),
            "iso": rng.choice([100, 400, 800, 1600, 3200], b).astype(np.float32),
            "cam": rng.choice([0, 1, 2, 3, 4], b).astype(np.float32)}


def _cond(b):
    mb = _batch(b, 9)
    cond = {k: torch.as_tensor(mb[k]) for k in ("iso", "cam", "nlf0", "nlf1")}
    cond["clean"] = torch.as_tensor(mb["_y"])
    return cond


def _trainer(use_pallas: bool) -> Trainer:
    torch.manual_seed(0)
    cfg = default_config(arch=ARCH, patch_height=32, n_batch_train=B, n_batch_test=B,
                         steps_per_call=K, lr=1e-4, use_pallas=use_pallas,
                         pallas_train_dtype="float32")
    tr = Trainer(NoiseFlow((32, 32, 4), cfg, device="cpu"), cfg)
    assert tr.use_oneshot == use_pallas
    return tr


def _staged(tr: Trainer) -> None:
    batches = [_batch(B, s) for s in range(STEPS)]
    tr._staged_train = {k: torch.as_tensor(np.concatenate([mb[k] for mb in batches]))
                        for k in batches[0]}


def _spans(fn):
    """Run ``fn`` under the profiler started as ``benchmark/harness/trace.py``
    starts it; the ``nf.*`` spans recorded, by start: [(name, start_ns,
    end_ns)]."""
    acts = {P.ProfilerActivity.CPU}
    config = P.ProfilerConfig(P.ProfilerState.KINETO, False, False, False, False, False,
                              P._ExperimentalConfig())
    P._prepare_profiler(config, acts)
    P._enable_profiler(config, acts)
    try:
        assert not P._is_profiler_enabled           # the trap: the Python flag stays off
        fn()
    finally:
        events = P._disable_profiler().events()
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
                   if e.name().startswith("nf.")), key=lambda s: s[1])


def _inside(span, outer):
    return outer[1] <= span[1] and span[2] <= outer[2]


def _children(spans, outer, name):
    return [s for s in spans if s[0] == name and _inside(s, outer)]


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "oneshot"])
def test_epoch_spans_nest_as_the_loop_and_step_run(use_pallas):
    tr = _trainer(use_pallas)
    _staged(tr)
    spans = _spans(lambda: tr._train_epoch_staged(3))
    names = collections.Counter(s[0] for s in spans)
    (epoch,) = [s for s in spans if s[0] == "nf.epoch"]
    assert all(_inside(s, epoch) for s in spans)
    assert names["nf.epoch.order"] == names["nf.epoch.sync"] == 1
    eager = _children(spans, epoch, "nf.epoch.eager")
    assert len(eager) == STEPS == tr.epoch_steps[0].numel()      # no graphs on the CPU
    for step in eager:
        for phase in STEP_PHASES:
            assert len(_children(spans, step, phase)) == 1, phase
        (fwd,) = _children(spans, step, "nf.step.forward")
        inner = {"nf.step.fold", "nf.step.prep", "nf.step.kernel"}
        got = {s[0] for s in spans if s[0] in inner and _inside(s, fwd)}
        assert got == (inner if use_pallas else set())
    # the phases follow one another inside a step
    order = [s[0] for s in spans if _inside(s, eager[0]) and s[0] in STEP_PHASES]
    assert order == list(STEP_PHASES)


def test_annotate_calls_nothing_with_the_profiler_off(monkeypatch):
    calls = collections.Counter()
    enter = torch.ops.profiler._record_function_enter_new

    def counted(name, *args):
        calls[name.split(".")[0]] += 1      # PyTorch's optimizer opens spans of its own
        return enter(name, *args)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new", counted)
    tr = _trainer(True)
    _staged(tr)
    assert not torch._C._autograd._profiler_enabled()
    assert annotate("nf.a") is annotate("nf.b")                   # one shared null context
    with annotate("nf.test"):
        pass
    tr._train_epoch_staged(1)
    fs.make_sampler(fs.build_sample_program(tr.flow, bn_mode="running"), _cond(4), bt=4,
                    mm_dtype=torch.float32)(1)
    assert calls["nf"] == 0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with annotate("nf.test"):
            pass
    assert calls["nf"] == 1


def test_status_line_counts_the_spans():
    tr = _trainer(False)
    _staged(tr)
    spans = _spans(lambda: tr._train_epoch_staged(2))
    line = tr.timers.line()
    for phase in ("epoch.order", "epoch.eager", "epoch.sync"):
        assert f"{phase}=" in line
        mine = [s for s in spans if s[0] == "nf." + phase]
        assert tr.timers.counts[phase] == len(mine)
        # each host total holds its spans' intervals (the profiler's clock)
        assert sum(e - s for _, s, e in mine) * 1e-9 <= tr.timers.totals[phase] * 1.05 + 1e-4
    assert line.endswith(f"T={sum(tr.timers.totals.values()):.1f}s")


class _EagerGraph:
    """Stands in for a captured graph on the CPU: ``replay`` runs the K
    captured steps on the static feed, as the graph would."""

    def __init__(self, owner, step, batch_at):
        self.owner, self.step, self.batch_at = owner, step, batch_at

    def replay(self):
        g = self.owner
        for j in range(g.k):
            nll, sd_z = self.step(self.batch_at(g.feed, j))
            g.nll[j].copy_(nll)
            g.sd_z[j].copy_(sd_z)


def _cpu_step_graph(step, feed, batch_at, k, flow, optimizer=None, mesh=None):
    g = StepGraph.__new__(StepGraph)
    g.k, g.feed = k, feed
    g.nll, g.sd_z = torch.zeros((k,)), torch.zeros((k,))
    g.launches, g.collectives = collections.Counter(), 0
    g.graph = _EagerGraph(g, step, batch_at)
    return g


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "replays"])
@pytest.mark.parametrize("feed", ["staged", "host"])
def test_eager_and_replay_spans_count_the_epoch_steps(monkeypatch, feed, graphs):
    if graphs:
        monkeypatch.setattr(Trainer, "graphs_on", property(lambda self: True))
        monkeypatch.setattr(trainer_mod, "StepGraph", _cpu_step_graph)
    tr = _trainer(True)
    if feed == "staged":
        _staged(tr)
        spans = _spans(lambda: tr._train_epoch_staged(5))
    else:
        batches = [_batch(B, s) for s in range(STEPS)]
        spans = _spans(lambda: tr.train_epoch(iter(batches)))
    names = collections.Counter(s[0] for s in spans)
    replays = STEPS // K if graphs else 0
    assert names["nf.epoch.replay"] == replays
    assert names["nf.epoch.eager"] + K * names["nf.epoch.replay"] == tr.epoch_steps[0].numel()
    assert tr.epoch_steps[0].numel() == STEPS
    assert names["nf.step.optimizer"] == STEPS


@pytest.mark.parametrize("graphs", [False, True], ids=["eager", "replays"])
def test_staged_eval_spans_no_epoch_phase(monkeypatch, graphs):
    if graphs:
        monkeypatch.setattr(Trainer, "graphs_on", property(lambda self: True))
        monkeypatch.setattr(trainer_mod, "StepGraph", _cpu_step_graph)
    tr = _trainer(False)
    _staged(tr)
    tr._staged_test = tr._staged_train
    spans = _spans(tr._eval_epoch_staged)
    names = collections.Counter(s[0] for s in spans)
    assert not [n for n in names if n.startswith("nf.epoch")]
    assert names["nf.eval.replay"] == (STEPS // K if graphs else 0)
    assert names["nf.eval.eager"] + K * names["nf.eval.replay"] == STEPS
    assert names["nf.step.optimizer"] == names["nf.step.backward"] == 0
    assert tr.timers.counts["eval.eager"] == names["nf.eval.eager"]


def test_make_sampler_spans_each_call():
    torch.manual_seed(0)
    flow = NoiseFlow((32, 32, 4), default_config(arch=ARCH, patch_height=32), device="cpu")
    prog = fs.build_sample_program(flow, bn_mode="running")
    b = 4
    cond = _cond(b)
    out = []

    def run():
        sample = fs.make_sampler(prog, cond, temp=0.6, bt=b, mm_dtype=torch.float32)
        out.extend(sample(seed) for seed in (1, 2, 3))

    spans = _spans(run)
    names = collections.Counter(s[0] for s in spans)
    assert names == {"nf.sample.call": 3}
    assert len(out) == 3 and not torch.equal(out[0], out[1])
