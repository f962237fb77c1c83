"""The card's trace over a window, and what the per-layer metrics read in it.

PyTorch's profiler (Kineto over CUPTI) records every device operation
(kernels, copies, fills) and every host operation; the harness marks its own
calls into the program with ``record_function`` spans (``bench.*``). The
profiler is driven through the functions that ``torch.profiler`` itself
calls, and its events are read straight from its result, without building
PyTorch's per-event summaries, so that an epoch's millions of kernels are
read in seconds.

From the events: each device operation's count and seconds by name; the
device's busy seconds (the union of its operations' intervals); the idle
gaps between them, each named by the innermost host event that covers the
gap's start (what the host was doing while the card waited). Gaps shorter
than ``SHORT_GAP_S`` are the launch gaps between back-to-back kernels and
are summed under one name.
"""

from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
SHORT_GAP_S = 10e-6
SHORT_GAP_NAME = "between back-to-back device ops (< 10 us)"
TOP = 10
_SCAN = 4096       # host events looked at, backwards, to name one gap


def _activity_of():
    """A function that gives an event's kind, as Kineto names it, from its
    device, its annotation flag and its name."""
    on_card = {}     # device type -> whether it is the card's

    def kind(e):
        dt = e.device_type()
        card = on_card.get(dt)
        if card is None:
            card = on_card[dt] = str(dt).split(".")[-1] == "CUDA"
        if not card:
            return "user_annotation" if e.is_user_annotation() else "cpu_op"
        if e.is_user_annotation():
            return "gpu_user_annotation"
        name = e.name()
        return ("gpu_memcpy" if name.startswith("Memcpy") else
                "gpu_memset" if name.startswith("Memset") else "kernel")
    return kind


class Trace:
    """``with Trace(device) as tr:`` profiles the block; afterwards
    ``window_s`` (host clock, synchronised at both ends), ``busy_s``,
    ``ops`` (name -> [count, seconds, activity]) and ``gaps`` (name -> seconds) hold
    what it recorded."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.window_s = 0.0
        self.busy_s = 0.0
        self.ops: Dict[str, List[float]] = {}
        self.gaps: Dict[str, float] = {}
        self.read_s = 0.0
        self.read_parts = (0.0, 0.0)   # the profiler's stop and events; the harness's pass

    def __enter__(self):
        from torch.autograd import profiler as P

        acts = {P.ProfilerActivity.CPU}
        if self.device.type == "cuda":
            acts.add(P.ProfilerActivity.CUDA)
        config = P.ProfilerConfig(P.ProfilerState.KINETO, False, False, False, False, False,
                                  P._ExperimentalConfig())
        self._sync()
        P._prepare_profiler(config, acts)
        P._enable_profiler(config, acts)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from torch.autograd import profiler as P

        self._sync()
        self.window_s = time.perf_counter() - self._t0
        t = time.perf_counter()
        result = P._disable_profiler()
        if exc[0] is None:
            events = result.events()
            t1 = time.perf_counter()
            self._read(events)
            self.read_parts = (t1 - t, time.perf_counter() - t1)
        self.read_s = time.perf_counter() - t
        return False

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _read(self, events) -> None:
        dev: List[Tuple[int, int]] = []
        host: List[Tuple[int, int, str]] = []
        ops: Dict[str, list] = defaultdict(lambda: [0, 0.0, ""])
        activity = _activity_of()
        for e in events:
            act = activity(e)
            if act in DEVICE_ACTIVITIES:
                s, d = e.start_ns(), e.duration_ns()
                dev.append((s, s + d))
                o = ops[e.name()]
                o[0] += 1
                o[1] += d * 1e-9
                o[2] = act
            elif act in ("cpu_op", "user_annotation"):
                s = e.start_ns()
                host.append((s, s + e.duration_ns(), e.name()))
        self.ops = dict(ops)
        if not dev:
            return
        dev.sort()
        host.sort()
        busy, gaps = 0, []
        cur_s, cur_e = dev[0]
        for s, e in dev[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        self.busy_s = busy * 1e-9
        starts = [h[0] for h in host]
        named: Dict[str, float] = defaultdict(float)
        for g0, g1 in gaps:
            dt = (g1 - g0) * 1e-9
            name = SHORT_GAP_NAME if dt < SHORT_GAP_S else self._host_at(host, starts, g0)
            named[name] += dt
        self.gaps = dict(named)

    @staticmethod
    def _host_at(host, starts, t: int) -> str:
        """The innermost host event running at time t (the one that started
        last among those that cover it)."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - _SCAN, -1), -1):
            if host[j][1] >= t:
                return host[j][2]
        return "host outside any recorded event"

    # ------------------------------------------------------------ readers
    def kernels(self, match) -> Tuple[int, float]:
        """(launches, seconds) of the device operations whose name ``match``
        (a compiled pattern) finds."""
        n, t = 0, 0.0
        for name, (c, s, _) in self.ops.items():
            if match.search(name):
                n, t = n + int(c), t + s
        return n, t

    def kernel_count(self) -> int:
        """Kernel launches on the device (copies and fills left out)."""
        return int(sum(c for c, _, act in self.ops.values() if act == "kernel"))

    def breakdown(self) -> Dict[str, list]:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[k, v[1]] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def span(name: str):
    """A harness span in the trace: the port's own ``annotate``."""
    from noise_flow_tpu_torch.utils.profiling import annotate

    return annotate(name)


def idle_share(tr: Optional[Trace]) -> Optional[float]:
    if tr is None or tr.window_s <= 0 or tr.busy_s <= 0:
        return None
    return 100.0 * max(tr.window_s - tr.busy_s, 0.0) / tr.window_s
