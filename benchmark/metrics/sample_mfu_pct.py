"""The whole sampler call's share of the card's float32 peak: the useful
FLOPs of every call in the traced window (``harness/work.py``) over the
seconds the device was busy in it, times 67 TFLOP/s."""


def read(run):
    calls, busy = run.counts.get("calls", 0), run.trace.busy_s
    if not calls or busy <= 0:
        return None
    c = run.config
    flops, _ = run.work.sample_call_work(c["arch"], c["width"], run.counts["batch"])
    return 100.0 * calls * flops / (busy * run.work.PEAK_FP32_FLOPS)
