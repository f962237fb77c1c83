"""The whole train step's share of the card's float32 peak: the useful FLOPs
of every step in the traced window (``harness/work.py``) over the seconds
the device was busy in it, times 67 TFLOP/s. Busy seconds and not the
window: tracing slows the host's graph launches (``PERF.md``), and the idle
share is its own metric."""


def read(run):
    steps, busy = run.counts.get("steps", 0), run.trace.busy_s
    if not steps or busy <= 0:
        return None
    c = run.config
    flops, _ = run.work.train_step_work(c["arch"], c["width"], run.counts["batch"])
    return 100.0 * steps * flops / (busy * run.work.PEAK_FP32_FLOPS)
