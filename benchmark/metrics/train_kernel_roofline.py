"""Share of its roofline that the one-shot train kernel reaches
(``train_kernel<STEP>``, ``csrc/fused_train.cu``, Mode 0): the least time of
one train step's work (``harness/work.py``) over the kernel's mean device
time a launch, one launch a step. Nothing when the kernel did not run."""

import re

KERNEL = re.compile(r"train_kernel<\s*0\s*,")


def read(run):
    n, t = run.trace.kernels(KERNEL)
    if n == 0 or t <= 0:
        return None
    c = run.config
    flops, nbytes = run.work.train_step_work(c["arch"], c["width"], run.counts["batch"])
    return 100.0 * run.work.bound_s(flops, nbytes) * n / t
