"""Device kernels a train step: every kernel launch in the traced window
(graph replays, the eager tail, the epoch's own copies left out) over the
train steps in it."""


def read(run):
    steps = run.counts.get("steps", 0)
    n = run.trace.kernel_count()
    if not steps or not n:
        return None
    return n / steps
