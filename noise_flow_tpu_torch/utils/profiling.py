"""Spans and phase timers.

Port of noise_flow_tpu.utils.profiling. The reference only had wall-clock
phase timers in the console line (ref:train_noise_flow.py:389,426,470,501-535
— `tr/ts/tsm/tv/T`). Here the program marks its phases with spans
(``annotate``): ``record_function`` ranges that PyTorch's profiler records
beside the device's operations, on the profiler's own clock, so that a trace
ties each device operation and each idle gap to the program's phase. With no
profiler recording a span costs one flag check. ``PhaseTimers`` sums the
training loop's phases on the host's clock for the status line; each phase
is a span too.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import torch

# what ``annotate`` returns while no profiler records: reusable, holds nothing
_NO_SPAN = contextlib.nullcontext()


def annotate(name: str):
    """A span named ``name`` in the profiler's trace: ``record_function(name)``
    while a profiler records, however it was started (the C flag, which the
    profiler's low-level entry points set too), else a shared null context
    that calls nothing."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


class PhaseTimers:
    """The training loop's named phases. Each ``phase(name)`` is the span
    ``nf.<name>`` in the profiler's trace, and its time on the host's clock
    is summed here into the reference's compact status line
    (`input=0.1s epoch.replay=3.2s ... T=3.6s`).

    The line measures the host: how long each phase took to launch its device
    work, which returns before the card has done it; ``epoch.sync`` (and
    ``sync``) is the host's wait for the card. The device's time in each
    phase is read from a trace of the spans."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            with annotate("nf." + name):
                yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def line(self) -> str:
        total = sum(self.totals.values())
        parts = [f"{k}={v:.1f}s" for k, v in self.totals.items()]
        return " ".join(parts + [f"T={total:.1f}s"])

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()
