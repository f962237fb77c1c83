"""Faults planted under the timed path of the ``train`` and ``sample``
kinds, to show that the comparison catches them (``tests/test_bench_faults.py``,
``calibrate.py``). Each is a function for ``Context.plant``: given the
trainer, it breaks it in place; given a sampler closure, it returns a broken
one. A kind's module names its faults (``FAULTS``) and those whose readings
set a limit (``CALIBRATED``).

Training:
- ``state_unchanged``: the optimizer's step does nothing;
- ``bn_state_frozen``: the BatchNorm running statistics are never written;
- ``tail_dropped``: an epoch leaves out its ragged tail of eager steps;
- ``half_batch``: each step gathers only the first half of its rows, the
  loss the mean over them;
- ``loss_altered``: each step's loss is returned off by one part in 10^4.

Sampling:
- ``state_unchanged``: every call returns the noise of one fixed seed;
- ``half_batch``: the second half of each call's patches is left at zero;
- ``answer_altered``: the first patch of each call comes back negated.
"""

from __future__ import annotations

import types


def _train_state_unchanged(trainer):
    trainer.optimizer.step = lambda *a, **k: None


def _train_bn_state_frozen(trainer):
    trainer.flow.apply_state = lambda new_state: None


def _train_tail_dropped(trainer):
    steps = trainer._staged_steps

    def dropped(split, order, k, train):
        full = order.shape[0] - order.shape[0] % k
        return steps(split, order[:full] if full else order, k, train)

    trainer._staged_steps = dropped


def _train_half_batch(trainer):
    gather = trainer._gather_staged

    def half(data, idx):
        return gather(data, idx[: idx.shape[0] // 2])

    trainer._gather_staged = half


def _train_loss_altered(trainer):
    step = trainer.train_step

    def altered(self, batch):
        nll, sd_z = step(batch)
        return nll * (1.0 + 1e-4), sd_z

    trainer.train_step = types.MethodType(altered, trainer)


def _sample_state_unchanged(sampler):
    return lambda seed: sampler(1)


def _sample_half_batch(sampler):
    def half(seed):
        out = sampler(seed)
        out[out.shape[0] // 2:] = 0.0
        return out
    return half


def _sample_answer_altered(sampler):
    def altered(seed):
        out = sampler(seed)
        out[0] = -out[0]
        return out
    return altered


TRAIN = {"state_unchanged": _train_state_unchanged, "bn_state_frozen": _train_bn_state_frozen,
         "tail_dropped": _train_tail_dropped, "half_batch": _train_half_batch,
         "loss_altered": _train_loss_altered}
SAMPLE = {"state_unchanged": _sample_state_unchanged, "half_batch": _sample_half_batch,
          "answer_altered": _sample_answer_altered}
