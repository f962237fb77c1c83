"""Share of its roofline that the fused sampler kernel reaches
(``sample_kernel``, or ``coop_kernel`` in batch-BN mode, of
``csrc/fused_sample.cu``): the least time of one call's work
(``harness/work.py``, normals drawn in the kernel) over the kernel's mean
device time a launch, one launch a call. Nothing when it did not run."""

import re

KERNEL = re.compile(r"\b(sample_kernel|coop_kernel)<")


def read(run):
    n, t = run.trace.kernels(KERNEL)
    if n == 0 or t <= 0:
        return None
    c = run.config
    flops, nbytes = run.work.sample_call_work(c["arch"], c["width"], run.counts["batch"])
    return 100.0 * run.work.bound_s(flops, nbytes) * n / t
