"""Share of the traced training window in which no operation ran on the
card: the window less the union of its device operations.

It carries the tracer's own cost: the profiler records every host
operation, and the epoch's eager tail and its boundary run slower under it.
On the H100 a traced epoch lasted 6-39% longer than the untraced epoch
before it (the run prints both on standard error), some 5-27 points of
this metric. Compare it between runs, not with zero."""


def read(run):
    return run.idle_share(run.trace)
