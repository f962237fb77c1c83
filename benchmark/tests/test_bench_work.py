"""The frozen FLOP and byte counts (``harness/work.py``) against the port's
probes: the one-shot step's bound at b = 138 (blocks of 69) in float32 and
the sampler call's at 8,192 patches, as the probes state them (0.0251 ms,
0.4968 ms, ``PERF.md``) and as their own functions count them."""

import pytest

from harness import work

ARCH = "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc"


def test_train_step_bound_is_the_probes():
    flops, nbytes = work.train_step_work(ARCH, 4, 138)
    assert flops == pytest.approx(1.6823e9, rel=1e-4)
    assert round(work.bound_s(flops, nbytes) * 1e3, 4) == 0.0251
    assert flops / work.PEAK_FP32_FLOPS > nbytes / work.PEAK_HBM_BYTES


def test_sample_call_bound_is_the_probes():
    flops, nbytes = work.sample_call_work(ARCH, 4, 8192)
    assert round(work.bound_s(flops, nbytes) * 1e3, 4) == 0.4968
    assert flops / work.PEAK_FP32_FLOPS > nbytes / work.PEAK_HBM_BYTES


def test_counts_match_the_probes_functions(flagship):
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.ops import fused_train as ft
    from noise_flow_tpu_torch.ops.fused_sample import build_sample_program
    from noise_flow_tpu_torch.probes import sampler as sp
    from noise_flow_tpu_torch.probes import train_template as tt
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    flow = NoiseFlow((32, 32, 4), default_config(arch=ARCH), device="cpu")
    load_checkpoint(flagship["weights_path"], flow)
    program = build_sample_program(flow)
    assert work.sample_call_work(ARCH, 4, 8192) == sp.chain_work(program, 8192, rng=True)
    ff = ft.FusedFlow(flow, bt=138)
    segs = [(*ff.fold_segment(item[2], item[3], fold_bn=False)[:3], None)
            for item in ff.plan if item[0] == "segment"]
    assert work.train_step_work(ARCH, 4, 138)[0] == tt._segment_work(segs, "backward")[0]
    assert (work.PEAK_FP32_FLOPS, work.PEAK_HBM_BYTES) == (tt.PEAK_FP32_FLOPS, tt.PEAK_HBM_BYTES)
