"""Share of the traced sampling window in which no operation ran on the
card: the window less the union of its device operations."""


def read(run):
    return run.idle_share(run.trace)
