"""Profiling & tracing.

Port of noise_flow_tpu.utils.profiling. The reference only had wall-clock
phase timers in the console line (ref:train_noise_flow.py:389,426,470,501-535
— `tr/ts/tsm/tv/T`). Here: the same phase timers as a reusable object, plus
device profiling through ``torch.profiler`` (Chrome-trace files).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


class PhaseTimers:
    """Accumulating named wall-clock timers; renders the reference's compact
    status line (`tr=12.3s ts=1.2s ...`)."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
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


@contextlib.contextmanager
def device_trace(logdir: Optional[str]):
    """``torch.profiler`` trace of the CPU and (where present) the CUDA
    device, written as ``<logdir>/trace.json`` (Chrome trace format);
    no-op when logdir is falsy."""
    if not logdir:
        yield
        return
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region inside a trace (shows up in the profiler timeline)."""
    import torch

    return torch.profiler.record_function(name)
