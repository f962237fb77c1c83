"""The trace reader (``harness/trace.py``) on a synthetic event list and on
a small real trace of the CPU."""

import re

import pytest
import torch

from harness.trace import SHORT_GAP_NAME, Trace, idle_share


class _Event:
    """A profiler event as PyTorch gives it: a name, a device, an annotation
    flag and its interval."""

    def __init__(self, name, activity, start, duration):
        self._n, self._a, self._s, self._d = name, activity, start, duration

    def name(self):
        return self._n

    def device_type(self):
        on_card = self._a in ("kernel", "gpu_memcpy", "gpu_memset", "gpu_user_annotation")
        return "DeviceType.CUDA" if on_card else "DeviceType.CPU"

    def is_user_annotation(self):
        return self._a in ("user_annotation", "gpu_user_annotation")

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d


EVENTS = [
    _Event("bench.train_epoch", "user_annotation", 0, 1_000_000),
    _Event("aten::index_select", "cpu_op", 100_000, 50_000),
    _Event("cudaStreamSynchronize", "cuda_runtime", 550_000, 250_000),
    _Event("void train_kernel<0, false, 3, 0>(StepArgs)", "kernel", 0, 200_000),
    _Event("gpu annotation", "gpu_user_annotation", 0, 1_000_000),
    _Event("elementwise", "kernel", 200_005, 100_000),
    _Event("Memcpy HtoD", "gpu_memcpy", 500_000, 100_000),
    _Event("void train_kernel<0, false, 3, 0>(StepArgs)", "kernel", 750_000, 50_000),
    _Event("elementwise", "kernel", 760_000, 10_000),
]


def test_busy_ops_and_named_gaps():
    tr = Trace("cpu")
    tr._read(EVENTS)
    assert tr.busy_s == pytest.approx((200_000 + 100_000 + 100_000 + 50_000) * 1e-9)
    assert tr.ops["elementwise"][:2] == [2, pytest.approx(110_000e-9)]
    assert tr.kernels(re.compile(r"train_kernel<\s*0\s*,")) == (2, pytest.approx(250_000e-9))
    assert tr.kernel_count() == 4
    # a 5 ns launch gap; 300,005 -> 500,000 while the host ran only the epoch
    # span; 600,000 -> 750,000 inside the synchronisation
    assert tr.gaps == {SHORT_GAP_NAME: pytest.approx(5e-9),
                       "bench.train_epoch": pytest.approx(199_995e-9),
                       "cudaStreamSynchronize": pytest.approx(150_000e-9)}
    assert tr.ops["Memcpy HtoD"][2] == "gpu_memcpy"
    b = tr.breakdown()
    assert b["device_ops"][0] == ["void train_kernel<0, false, 3, 0>(StepArgs)",
                                  pytest.approx(250_000e-9)]
    assert [g[0] for g in b["idle_gaps"]] == ["bench.train_epoch", "cudaStreamSynchronize",
                                              SHORT_GAP_NAME]
    tr.window_s = 1e-3
    assert idle_share(tr) == pytest.approx(55.0)


def test_real_cpu_trace_has_host_events_and_no_device_time():
    with Trace("cpu") as tr:
        with torch.profiler.record_function("bench.test"):
            a = torch.randn(64, 64)
            for _ in range(10):
                a = a @ a * 0.01
    assert tr.window_s > 0
    assert tr.busy_s == 0.0 and tr.ops == {}
    assert idle_share(tr) is None
