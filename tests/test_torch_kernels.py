"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed. Every test here needs a CUDA card and the CUDA toolkit
(the kernels are built with nvcc at first use) and skips without a card. On
a machine with a card, from the root of the checkout:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

(``--noconftest`` because tests/conftest.py sets up JAX.)
"""

import os

import numpy as np
import pytest
import torch

from noise_flow_tpu_torch.config import load_hps
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.ops import fused_sample as fs
from noise_flow_tpu_torch.ops import fused_train as ft
from noise_flow_tpu_torch.probes import train_template as tt
from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint
from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "experiments", "sidd", "prod_exact_150")
# |kernel - plain| <= atol + rtol * |plain|: float32 sums in another order (in
# batch mode the moments too). The noise has an sd of 0.01-0.04; the kernel
# differs from its plain version by at most 1.5e-7 on the H100, so atol 1e-6
# passes it and fails a kernel that normalises with the wrong BN groups.
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(prog, b, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    clean = (0.01 + 0.89 * torch.rand((b, 32, 32, 4), generator=g)).to(device)
    cond = {"clean": clean,
            "iso": torch.tensor([100.0, 400.0, 800.0, 1600.0, 3200.0] * b)[:b].to(device),
            "cam": torch.tensor([0.0, 1.0, 2.0, 3.0, 4.0, 2.0] * b)[:b].to(device),
            "nlf0": torch.zeros(b, device=device), "nlf1": torch.zeros(b, device=device)}
    sa, sb = prog.scale_ab(cond, b)
    x = (0.6 * torch.randn((b, 32, 32, 4), generator=g)).to(device)
    return x, clean, sa, sb


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["running", "batch"])
@pytest.mark.parametrize("b", [1, 8, 300])
def test_fused_sample_kernel_matches_plain(cuda_device, mode, b):
    nf = NoiseFlowWrapper(MODEL, bn_batch_stats=mode == "batch", device=cuda_device)
    prog = nf._program
    x, clean, sa, sb = _inputs(prog, b, seed=b, device=cuda_device)
    bt = fs.bn_block(b)
    before = fs.launch_counts["fused_sample"]
    got = fs.fused_sample_chain(prog, x, clean, sa, sb, bt)
    # one launch in either BN mode: batch BN is one cooperative launch
    assert fs.launch_counts["fused_sample"] == before + 1
    ref = fs.sample_chain_reference(prog, x, clean, sa, sb, bt)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_fused_sample_kernel_tolerance_catches_wrong_groups(cuda_device):
    """A kernel run with BN groups of half the size fails TOL."""
    nf = NoiseFlowWrapper(MODEL, device=cuda_device)
    x, clean, sa, sb = _inputs(nf._program, 138, seed=5, device=cuda_device)
    wrong = fs.fused_sample_chain(nf._program, x, clean, sa, sb, 69)
    ref = fs.sample_chain_reference(nf._program, x, clean, sa, sb, 138)
    with pytest.raises(AssertionError):
        np.testing.assert_allclose(wrong.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_fused_sample_kernel_is_deterministic(cuda_device):
    nf = NoiseFlowWrapper(MODEL, device=cuda_device)
    x, clean, sa, sb = _inputs(nf._program, 300, seed=3, device=cuda_device)
    a = fs.fused_sample_chain(nf._program, x, clean, sa, sb, 150)
    b = fs.fused_sample_chain(nf._program, x, clean, sa, sb, 150)
    assert torch.equal(a, b)   # group moments reduced in a fixed order


@pytest.mark.cuda
def test_fused_sample_kernel_rejects_bad_inputs(cuda_device):
    nf = NoiseFlowWrapper(MODEL, device=cuda_device)
    x, clean, sa, sb = _inputs(nf._program, 4, seed=0, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        fs.fused_sample_chain(nf._program, x.transpose(1, 2), clean, sa, sb)
    with pytest.raises(ValueError, match="float32"):
        fs.fused_sample_chain(nf._program, x.double(), clean, sa, sb)
    with pytest.raises(ValueError, match="CUDA tensor"):
        fs.fused_sample_chain(nf._program, x, clean.cpu(), sa, sb)


@pytest.mark.cuda
def test_wrapper_launches_kernel_on_card(cuda_device):
    nf = NoiseFlowWrapper(MODEL, device=cuda_device)   # batch BN: one launch a call
    before = fs.launch_counts["fused_sample"]
    noise = nf.sample_noise_nf(np.full((16, 32, 32, 4), 0.3, np.float32), 0, 0, 800, 2)
    assert fs.launch_counts["fused_sample"] == before + 1
    assert noise.shape == (16, 32, 32, 4) and np.isfinite(noise).all()
    frame = nf.sample_noise_frame(np.full((100, 70, 4), 0.3, np.float32), 0, 0, 800, 2,
                                  batch=8)
    assert fs.launch_counts["fused_sample"] == before + 3   # 12 tiles in batches of 8
    assert frame.shape == (100, 70, 4) and np.isfinite(frame).all()


# ---------------------------------------------------------------------------
# the fused training kernels (csrc/fused_train.cu)
# ---------------------------------------------------------------------------

# Train step, kernel vs plain: the per-patch rows (ldj, sum z, sum z^2) and
# BN moments elementwise-tight, every gradient normwise (early couplings pass
# ReLU kinks where float32 rounding can flip a mask); see chip_smoke.py for
# the observed errors these are set from.
ROWS_RTOL, BN_ATOL, GRAD_RTOL = 5e-7, 4e-7, 2e-3


def _flagship(device):
    flow = NoiseFlow((32, 32, 4), load_hps(os.path.join(MODEL, "hps.txt")), device=device)
    load_checkpoint(os.path.join(MODEL, "ckpt", "model.ckpt-best.npz"), flow)
    return flow


def _step_inputs(flow, b, bt, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    clean = (0.01 + 0.89 * torch.rand((b, 32, 32, 4), generator=g)).to(device)
    x = (torch.randn((b, 32, 32, 4), generator=g).to(device)
         * torch.sqrt(5e-4 * clean + 2e-6)).contiguous()
    cond = {"clean": clean, "iso": torch.full((b,), 800.0, device=device),
            "cam": torch.full((b,), 2.0, device=device),
            "nlf0": torch.zeros(b, device=device), "nlf1": torch.zeros(b, device=device)}
    step = ft.FusedTrainStep(flow, bt=bt)
    with torch.no_grad():
        rec, offs, mixes, _ = step.fold()
        sa, sb, _ = step._prep(cond, b)
    return step, (x, clean, sa, sb, rec, offs, mixes, step.ops_code)


def _raw_close(k, p):
    def rel(key):
        return float((k[key] - p[key]).norm() / p[key].norm().clamp_min(1e-30))
    return (rel("rows") <= ROWS_RTOL
            and float((k["bnmom"] - p["bnmom"]).abs().max()) <= BN_ATOL
            and all(rel(key) <= GRAD_RTOL for key in
                    ("grad_rec", "grad_offs", "grad_mixes", "gsa", "gsb")))


@pytest.mark.cuda
@pytest.mark.parametrize("b,bt", [(8, 8), (138, 69), (138, 138), (300, 60)])
def test_train_step_kernel_matches_plain(cuda_device, b, bt):
    flow = _flagship(cuda_device)
    step, args = _step_inputs(flow, b, bt, seed=b + bt, device=cuda_device)
    before = ft.launch_counts["fused_train_step"]
    got = ft.fused_train_step(*args, bt)
    assert ft.launch_counts["fused_train_step"] == before + 1
    ref = ft.train_step_reference(*args, bt)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
    assert _raw_close(got, ref)
    # b1/b2: BN removes the mean, the kernel returns exact zeros
    for name in ("b1", "b2"):
        off, shape = fs._REC_LAYOUT[name]
        assert float(got["grad_rec"][:, off:off + shape[0]].abs().max()) == 0.0


@pytest.mark.cuda
def test_train_step_kernel_is_deterministic(cuda_device):
    flow = _flagship(cuda_device)
    _, args = _step_inputs(flow, 138, 69, seed=1, device=cuda_device)
    a = ft.fused_train_step(*args, 69)
    b = ft.fused_train_step(*args, 69)
    assert all(torch.equal(a[k], b[k]) for k in a)   # fixed-order reductions


@pytest.mark.cuda
def test_train_step_tolerance_catches_wrong_groups(cuda_device):
    """The kernel run with BN groups of a third of bt fails the comparison."""
    flow = _flagship(cuda_device)
    _, args = _step_inputs(flow, 138, 69, seed=2, device=cuda_device)
    assert not _raw_close(ft.fused_train_step(*args, 23), ft.train_step_reference(*args, 69))


@pytest.mark.cuda
def test_train_step_kernel_rejects_bad_inputs(cuda_device):
    flow = _flagship(cuda_device)
    _, (x, clean, sa, sb, rec, offs, mixes, ops) = _step_inputs(flow, 8, 8, seed=0,
                                                              device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        ft.fused_train_step(x.transpose(1, 2), clean, sa, sb, rec, offs, mixes, ops, 8)
    with pytest.raises(ValueError, match="float32"):
        ft.fused_train_step(x.double(), clean, sa, sb, rec, offs, mixes, ops, 8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        ft.fused_train_step(x, clean.cpu(), sa, sb, rec, offs, mixes, ops, 8)
    with pytest.raises(ValueError, match="bad sizes"):
        ft.fused_train_step(x, clean, sa, sb, rec, offs, mixes, ops, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", tt.EVAL_BATCHES)
def test_segment_forward_kernel_matches_plain(cuda_device, mm_dtype, b):
    """The running-BN eval forward on both flagship segments, one launch a
    segment: float32 with BN folded into the records (z elementwise, ldj
    relative), bf16 with the running moments (both normwise: a bf16
    rounding flips under another summation order)."""
    segs = tt.eval_segments(_flagship(cuda_device), mm_dtype)
    z = torch.randn((b, 32, 32, 4), generator=torch.Generator(device="cpu").manual_seed(b))
    z = z.to(cuda_device)
    for rec, offs, mixes, code, bnrun in segs:
        before = ft.launch_counts["fused_segment_forward"]
        zk, lk = ft.fused_segment_forward(z, rec, offs, mixes, code, mm_dtype, bnrun)
        assert ft.launch_counts["fused_segment_forward"] == before + 1
        zp, lp = ft.segment_forward_reference(z, rec, offs, mixes, code, mm_dtype, bnrun)
        torch.cuda.synchronize()
        assert torch.isfinite(zk).all() and torch.isfinite(lk).all()
        if mm_dtype == "float32":   # N(0, 1) input: see chip_smoke.py SEG_TOL, LDJ_RTOL
            np.testing.assert_allclose(zk.cpu().numpy(), zp.cpu().numpy(), atol=5e-5, rtol=1e-5)
            np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(), rtol=2e-6, atol=1e-3)
        else:   # chip_smoke.py BF16_Z_RTOL, BF16_LDJ_RTOL
            assert _nrel(zk, zp) <= BF16_Z_RTOL and _nrel(lk, lp) <= 1e-5
        assert torch.equal(zk, ft.fused_segment_forward(z, rec, offs, mixes, code, mm_dtype,
                                                        bnrun)[0])
        z = zk


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [1, 138, 265])
def test_segment_forward_is_the_parent_bit_for_bit(cuda_device, mm_dtype, b):
    """The redesign (records staged once, two barriers a coupling) gives
    the parent's design's z and ldj bit for bit (the probe library's
    segment_kernel_parent): each product reads the same values, every FMA
    runs in the same order."""
    segs = tt.eval_segments(_flagship(cuda_device), mm_dtype)
    z = torch.randn((b, 32, 32, 4), generator=torch.Generator(device="cpu").manual_seed(b + 5))
    z = z.to(cuda_device)
    for rec, offs, mixes, code, bnrun in segs:
        zk, lk = ft.fused_segment_forward(z, rec, offs, mixes, code, mm_dtype, bnrun)
        zp, lp = tt.segment_forward_parent(z, rec, offs, mixes, code, mm_dtype, bnrun)
        torch.cuda.synchronize()
        assert torch.equal(zk, zp) and torch.equal(lk, lp)
        z = zk


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_segment_forward_is_resident_at_the_eval_batch(cuda_device, mm_dtype):
    """__launch_bounds__(256, 2): two CTAs an SM, so the flagship's eval
    batch of 138 patches runs in one wave."""
    per_sm = ft.segment_occupancy(cuda_device, mm_dtype)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    assert per_sm >= 2 and per_sm * sms >= 138


@pytest.mark.cuda
def test_segment_forward_planted_faults_disagree(cuda_device):
    """The comparison with the plain version catches the redesign with its
    running variances staged in place of 1/sqrt(var + eps), and a bf16
    record whose weights are rounded toward zero."""
    segs = tt.eval_segments(_flagship(cuda_device), "bfloat16")
    z = torch.randn((138, 32, 32, 4), generator=torch.Generator(device="cpu").manual_seed(3))
    z = z.to(cuda_device)
    rec, offs, mixes, code, bnrun = segs[0]
    zp, _ = ft.segment_forward_reference(z, rec, offs, mixes, code, "bfloat16", bnrun)
    wrong, _ = tt.segment_forward_fault("moments", z, rec, offs, mixes, code, "bfloat16", bnrun)
    weights = torch.zeros(fs.REC, dtype=torch.bool, device=cuda_device)
    for field in ("w1", "w2", "w3"):
        off, shape = fs._REC_LAYOUT[field]
        weights[off:off + int(np.prod(shape))] = True
    trunc = torch.where(weights, (rec.view(torch.int32) & -65536).view(torch.float32), rec)
    zt, _ = ft.fused_segment_forward(z, trunc.contiguous(), offs, mixes, code, "bfloat16", bnrun)
    torch.cuda.synchronize()
    assert _nrel(wrong, zp) > BF16_Z_RTOL and _nrel(zt, zp) > BF16_Z_RTOL


@pytest.mark.cuda
def test_trainer_launches_train_kernels_on_card(cuda_device):
    """Trainer(use_pallas=True): one step kernel and one Adam kernel a train
    step, two eval kernels (one a segment) an eval step."""
    from noise_flow_tpu_torch.training.trainer import Trainer

    cfg = load_hps(os.path.join(MODEL, "hps.txt"))
    cfg.use_pallas, cfg.pallas_train_dtype = True, "float32"
    tr = Trainer(_flagship(cuda_device), cfg)
    rng = np.random.default_rng(0)
    mb = {"_x": (0.02 * rng.standard_normal((16, 32, 32, 4))).astype(np.float32),
          "_y": rng.uniform(0.01, 0.9, (16, 32, 32, 4)).astype(np.float32),
          "nlf0": np.full(16, 5e-4, np.float32), "nlf1": np.full(16, 2e-6, np.float32),
          "iso": np.full(16, 800.0, np.float32), "cam": np.full(16, 2.0, np.float32)}
    ft.launch_counts.clear()
    nll, _ = tr.train_epoch([mb, mb])
    ev, _ = tr.eval_epoch([mb])
    assert dict(ft.launch_counts) == {"fused_train_step": 2, "fused_segment_forward": 2,
                                      "adam_step": 2}
    assert np.isfinite(nll) and np.isfinite(ev)


# ---------------------------------------------------------------------------
# the segment path's kernels (csrc/fused_train.cu, train_kernel SEG_FWD and
# SEG_BWD): kernel vs plain on both flagship segments; z elementwise on N(0,
# 1) input, ldj relative, group moments absolute, gradients normwise (see
# chip_smoke.py for the observed errors these are set from)
# ---------------------------------------------------------------------------

SEG_Z_TOL, SEG_LDJ_RTOL, SEG_BN_RTOL = dict(atol=5e-5, rtol=1e-5), 2e-6, 5e-6
# the backward normwise: 6.5e-7 without a ReLU mask flip; one flip (float32
# rounding on either side of a kink) moved the b = 300 case by up to 9.2e-5;
# BN groups of bt/3 move it by 1.5e-3 or more
SEG_GRAD_RTOL = 5e-4


def _segments(flow, b, seed, device):
    """[(rec, offs, mixes, ops_code)] of the flagship's two segments (records
    without BN folded in), an N(0, 1) input and seeded cotangents (gz,
    gldj) at the scale of the mean NLL's."""
    ff = ft.FusedFlow(flow)
    with torch.no_grad():
        segs = [(*ff.fold_segment(lo, hi, fold_bn=False)[:3], ft._ops_code(seg.ops))
                for _, seg, lo, hi in (it for it in ff.plan if it[0] == "segment")]
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((b, 32, 32, 4), generator=g).to(device)
    gz = (torch.randn((b, 32, 32, 4), generator=g) / b).to(device)
    gldj = ((-1.0 + 0.5 * torch.randn((b,), generator=g)) / b).to(device)
    return segs, x, gz, gldj


def _rel(k, p):
    return float((k - p).norm() / p.norm().clamp_min(1e-30))


def _bwd_close(k, p):
    return all(_rel(a, b) <= SEG_GRAD_RTOL for a, b in zip(k, p))


@pytest.mark.cuda
@pytest.mark.parametrize("b,bt", [(16, 8), (138, 69), (138, 138), (300, 60)])
def test_segment_train_forward_kernel_matches_plain(cuda_device, b, bt):
    segs, x, _, _ = _segments(_flagship(cuda_device), b, seed=b + bt, device=cuda_device)
    for rec, offs, mixes, code in segs:
        before = ft.launch_counts["fused_segment_train_forward"]
        zk, lk, mk = ft.fused_segment_train_forward(x, rec, offs, mixes, code, bt)
        assert ft.launch_counts["fused_segment_train_forward"] == before + 1
        zp, lp, mp = ft.segment_train_forward_reference(x, rec, offs, mixes, code, bt)
        torch.cuda.synchronize()
        np.testing.assert_allclose(zk.cpu().numpy(), zp.cpu().numpy(), **SEG_Z_TOL)
        np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(), rtol=SEG_LDJ_RTOL)
        np.testing.assert_allclose(mk.cpu().numpy(), mp.cpu().numpy(), atol=BN_ATOL,
                                   rtol=SEG_BN_RTOL)
        x = zk


@pytest.mark.cuda
@pytest.mark.parametrize("b,bt", [(16, 8), (138, 69), (138, 138), (300, 60)])
def test_segment_backward_kernel_matches_plain(cuda_device, b, bt):
    segs, x, gz, gldj = _segments(_flagship(cuda_device), b, seed=b + bt, device=cuda_device)
    for rec, offs, mixes, code in segs:
        before = ft.launch_counts["fused_segment_backward"]
        got = ft.fused_segment_backward(x, rec, offs, mixes, code, bt, gz, gldj)
        assert ft.launch_counts["fused_segment_backward"] == before + 1
        ref = ft.segment_backward_reference(x, rec, offs, mixes, code, bt, gz, gldj)
        torch.cuda.synchronize()
        assert all(bool(torch.isfinite(t).all()) for t in got)
        assert _bwd_close(got, ref), [_rel(a, b) for a, b in zip(got, ref)]
        for name in ("b1", "b2"):
            off, shape = fs._REC_LAYOUT[name]
            assert float(got[1][:, off:off + shape[0]].abs().max()) == 0.0
        x = ft.segment_train_forward_reference(x, rec, offs, mixes, code, bt)[0]


@pytest.mark.cuda
def test_segment_kernels_are_deterministic(cuda_device):
    segs, x, gz, gldj = _segments(_flagship(cuda_device), 138, seed=4, device=cuda_device)
    rec, offs, mixes, code = segs[0]
    a = ft.fused_segment_train_forward(x, rec, offs, mixes, code, 69)
    b = ft.fused_segment_train_forward(x, rec, offs, mixes, code, 69)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    a = ft.fused_segment_backward(x, rec, offs, mixes, code, 69, gz, gldj)
    b = ft.fused_segment_backward(x, rec, offs, mixes, code, 69, gz, gldj)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
def test_segment_backward_tolerance_catches_planted_faults(cuda_device):
    """BN groups of bt/3, gldj zeroed, one coupling's gradients left out:
    each fails the comparison."""
    segs, x, gz, gldj = _segments(_flagship(cuda_device), 138, seed=5, device=cuda_device)
    rec, offs, mixes, code = segs[0]
    ref = ft.segment_backward_reference(x, rec, offs, mixes, code, 69, gz, gldj)
    left_out = [t.clone() for t in ft.fused_segment_backward(x, rec, offs, mixes, code, 69,
                                                             gz, gldj)]
    left_out[1][2] = 0.0
    left_out[2][2] = 0.0
    for wrong in (ft.fused_segment_backward(x, rec, offs, mixes, code, 23, gz, gldj),
                  ft.fused_segment_backward(x, rec, offs, mixes, code, 69, gz,
                                            torch.zeros_like(gldj)),
                  left_out):
        assert not _bwd_close(wrong, ref)


@pytest.mark.cuda
def test_segment_path_matches_oneshot_on_card(cuda_device):
    """Two independent kernels, one function: FusedFlow.loss(train=True)
    through the segment kernels against FusedTrainStep.loss through the step
    kernel, at the same bt."""
    flow = _flagship(cuda_device)
    _, (x, clean, *_rest) = _step_inputs(flow, 138, 69, seed=6, device=cuda_device)
    cond = {"clean": clean, "iso": torch.full((138,), 800.0, device=cuda_device),
            "cam": torch.full((138,), 2.0, device=cuda_device),
            "nlf0": torch.zeros(138, device=cuda_device),
            "nlf1": torch.zeros(138, device=cuda_device)}
    params = dict(flow.named_parameters())
    nll, sd, st = ft.FusedFlow(flow, bt=69).loss(x, cond, train=True)
    g = dict(zip(params, torch.autograd.grad(nll, list(params.values()), allow_unused=True)))
    nll = nll.detach()
    nll1, sd1, st1, g1 = ft.FusedTrainStep(flow, bt=69).loss_and_grad(x, cond)
    torch.cuda.synchronize()
    assert abs(float(nll) - float(nll1)) <= 1e-6 * abs(float(nll1))
    assert abs(float(sd) - float(sd1)) <= 1e-6 * abs(float(sd1))
    assert set(st) == set(st1)
    assert max(float((st[k] - st1[k]).abs().max()) for k in st) <= BN_ATOL * 0.1
    for k, v in g1.items():
        if k.endswith(("l1_b", "l2_b")):
            assert g[k] is None or float(g[k].abs().max()) == 0.0, k
        elif g[k] is None:
            assert float(v.abs().max()) == 0.0, k
        else:
            assert _rel(g[k], v) <= 1e-2, (k, _rel(g[k], v))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", [None, "sdn|gain|sdn1|gain1|sdn2|unc"])
def test_trainer_launches_segment_kernels_on_card(cuda_device, arch):
    """Trainer(use_pallas=True) on the segment path (pallas_oneshot=False, or
    more than four scale layers): one forward and one backward launch a
    segment a train step, no step kernel."""
    from noise_flow_tpu_torch.training.trainer import Trainer

    cfg = load_hps(os.path.join(MODEL, "hps.txt"))
    cfg.use_pallas, cfg.pallas_train_dtype = True, "float32"
    if arch is None:
        cfg.pallas_oneshot = False
        flow = _flagship(cuda_device)
    else:
        cfg.arch = arch
        flow = NoiseFlow((32, 32, 4), cfg, device=cuda_device)
    tr = Trainer(flow, cfg)
    assert tr.use_fused and not tr.use_oneshot
    n_seg = sum(1 for it in ft.FusedFlow(flow).plan if it[0] == "segment")
    rng = np.random.default_rng(0)
    mb = {"_x": (0.02 * rng.standard_normal((16, 32, 32, 4))).astype(np.float32),
          "_y": rng.uniform(0.01, 0.9, (16, 32, 32, 4)).astype(np.float32),
          "nlf0": np.full(16, 5e-4, np.float32), "nlf1": np.full(16, 2e-6, np.float32),
          "iso": np.full(16, 800.0, np.float32), "cam": np.full(16, 2.0, np.float32)}
    ft.launch_counts.clear()
    nll, _ = tr.train_epoch([mb, mb])
    assert dict(ft.launch_counts) == {"fused_segment_train_forward": 2 * n_seg,
                                      "fused_segment_backward": 2 * n_seg, "adam_step": 2}
    assert np.isfinite(nll)


# ---------------------------------------------------------------------------
# the sampler's in-kernel RNG mode (csrc/fused_sample.cu draw_normals): the
# normals the kernel draws against rng_normals_reference, run on the card;
# the chain from those normals against the plain chain within TOL
# ---------------------------------------------------------------------------

# the kernel's normals against the plain version's: logf, sqrtf, sincosf at
# full precision on both sides, |n| <= 5.9
RNG_ATOL = 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("b", [16, 128])
def test_rng_normals_kernel_matches_plain(cuda_device, b):
    before = fs.launch_counts["rng_normals"]
    got = fs.rng_normals(2024, b, cuda_device, temp=0.6)
    assert fs.launch_counts["rng_normals"] == before + 1
    ref = fs.rng_normals_reference(2024, b, device=cuda_device) * 0.6
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0, atol=RNG_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["running", "batch"])
@pytest.mark.parametrize("b", [16, 128])
def test_rng_mode_kernel_matches_plain(cuda_device, mode, b):
    nf = NoiseFlowWrapper(MODEL, bn_batch_stats=mode == "batch", device=cuda_device)
    prog = nf._program
    _, clean, sa, sb = _inputs(prog, b, seed=b, device=cuda_device)
    before = dict(fs.launch_counts)
    got = fs.fused_sample_chain_rng(prog, 99, 0.6, clean, sa, sb, b)
    assert fs.launch_counts["fused_sample_rng"] == before.get("fused_sample_rng", 0) + 1
    assert fs.launch_counts["fused_sample"] == before.get("fused_sample", 0) + 1
    x = fs.rng_normals_reference(99, b, device=cuda_device) * 0.6
    ref = fs.sample_chain_reference(prog, x, clean, sa, sb, b)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.cuda
def test_rng_mode_repeats_and_seeds_differ(cuda_device):
    nf = NoiseFlowWrapper(MODEL, device=cuda_device)
    _, clean, sa, sb = _inputs(nf._program, 64, seed=1, device=cuda_device)
    a = fs.fused_sample_chain_rng(nf._program, 5, 1.0, clean, sa, sb)
    assert torch.equal(a, fs.fused_sample_chain_rng(nf._program, 5, 1.0, clean, sa, sb))
    assert not torch.equal(a, fs.fused_sample_chain_rng(nf._program, 6, 1.0, clean, sa, sb))
    assert torch.equal(fs.rng_normals(5, 64, cuda_device), fs.rng_normals(5, 64, cuda_device))


@pytest.mark.cuda
def test_make_sampler_on_card(cuda_device):
    nf = NoiseFlowWrapper(MODEL, bn_batch_stats=False, device=cuda_device)
    _, clean, sa, sb = _inputs(nf._program, 128, seed=2, device=cuda_device)
    cond = {"clean": clean, "iso": torch.full((128,), 800.0, device=cuda_device),
            "cam": torch.full((128,), 2.0, device=cuda_device),
            "nlf0": torch.zeros(128, device=cuda_device),
            "nlf1": torch.zeros(128, device=cuda_device)}
    sampler = fs.make_sampler(nf._program, cond, temp=0.6, bt=64, mm_dtype=torch.float32)
    before = fs.launch_counts["fused_sample_rng"]
    tile = sampler(11)
    assert fs.launch_counts["fused_sample_rng"] == before + 1
    ref = fs.fused_sample(nf._program, cond, temp=0.6, seed=11)
    assert tuple(tile.shape) == (128, 32, 128)
    assert torch.equal(tile.reshape(128, 32, 32, 4), ref)


@pytest.mark.cuda
def test_dncnn_nf_noise_matches_plain(cuda_device):
    """One DnCNN_NF step's noise: the fused sampler's RNG mode, one
    cooperative launch, against the plain chain on the seed's normals."""
    from noise_flow_tpu_torch.training.dncnn_trainer import DnCNNTrainer

    nf = NoiseFlowWrapper(MODEL, device=cuda_device)
    t = DnCNNTrainer(depth=4, filters=8, noise_source="nf", noise_flow=nf.flow,
                     cam_iso_rows=[(3, 1600.0, 0.008211, 2e-6)], device=cuda_device)
    p = t._noise_params(np.random.default_rng(0))
    p["gauss"] = False
    clean = 0.01 + 0.89 * torch.rand((128, 32, 32, 4), generator=torch.Generator().manual_seed(3))
    clean = clean.to(cuda_device)
    before = fs.launch_counts["fused_sample_rng"]
    got = t._make_noise(clean, p, torch.Generator(device=cuda_device).manual_seed(0))
    assert fs.launch_counts["fused_sample_rng"] == before + 1
    cond = {"clean": clean, "iso": torch.full((128,), 1600.0, device=cuda_device),
            "cam": torch.full((128,), 3.0, device=cuda_device),
            "nlf0": torch.zeros(128, device=cuda_device),
            "nlf1": torch.zeros(128, device=cuda_device)}
    sa, sb = t.program.scale_ab(cond, 128)
    ref = fs.sample_chain_reference(
        t.program, fs.rng_normals_reference(p["seed"], 128, device=cuda_device), clean, sa, sb,
        128)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **TOL)


# ---------------------------------------------------------------------------
# the bfloat16 modes (make_sampler's default, the trainer's default
# pallas_train_dtype): each kernel against its plain bfloat16 version,
# normwise, since a value at a bfloat16 rounding boundary rounds either way
# under another float32 summation order; the float32 kernel on the same
# inputs must be further off than the tolerance (see chip_smoke.py BF16_*
# for the observed errors these are set from)
# ---------------------------------------------------------------------------

BF16_SAMPLE_RTOL, BF16_Z_RTOL, BF16_BWD_RTOL, BF16_BN_ATOL = 3e-4, 3e-4, 1.5e-3, 5e-5
BF16_STEP_RTOL = {"rows": 5e-5, "grad_rec": 4e-3, "grad_offs": 1.5e-2, "grad_mixes": 1e-3,
                  "gsa": 1e-3, "gsb": 1e-3}


def _nrel(k, p):
    return float((k - p).norm() / p.norm().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,b,rng", [("batch", 138, False), ("running", 128, True)])
def test_fused_sample_bf16_kernel_matches_plain(cuda_device, mode, b, rng):
    prog = fs.build_sample_program(_flagship(cuda_device), bn_mode=mode)
    x, clean, sa, sb = _inputs(prog, b, seed=b, device=cuda_device)
    before = fs.launch_counts["fused_sample_bf16"]
    if rng:
        got, f32 = (fs.fused_sample_chain_rng(prog, 5, 0.6, clean, sa, sb, b, m)
                    for m in ("bfloat16", "float32"))
        x = fs.rng_normals_reference(5, b, device=cuda_device) * 0.6
    else:
        got, f32 = (fs.fused_sample_chain(prog, x, clean, sa, sb, b, m)
                    for m in ("bfloat16", "float32"))
    assert fs.launch_counts["fused_sample_bf16"] == before + 1
    ref = fs.sample_chain_reference(prog, x, clean, sa, sb, b, "bfloat16")
    torch.cuda.synchronize()
    assert _nrel(got, ref) <= BF16_SAMPLE_RTOL < _nrel(f32, ref), (_nrel(got, ref), _nrel(f32, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("bt", [69, 138])
def test_train_step_bf16_kernel_matches_plain(cuda_device, bt):
    _, args = _step_inputs(_flagship(cuda_device), 138, bt, seed=bt, device=cuda_device)
    before = ft.launch_counts["fused_train_step_bf16"]
    got = ft.fused_train_step(*args, bt, mm_dtype="bfloat16")
    assert ft.launch_counts["fused_train_step_bf16"] == before + 1
    f32 = ft.fused_train_step(*args, bt)
    ref = ft.train_step_reference(*args, bt, mm_dtype="bfloat16")
    torch.cuda.synchronize()
    assert float((got["bnmom"] - ref["bnmom"]).abs().max()) <= BF16_BN_ATOL
    for key, tol in BF16_STEP_RTOL.items():
        e, e32 = _nrel(got[key], ref[key]), _nrel(f32[key], ref[key])
        assert e <= tol < e32, (key, e, e32)


@pytest.mark.cuda
def test_segment_kernels_bf16_match_plain(cuda_device):
    """The running-BN eval forward (unfolded records and the running moments),
    the ghost forward and the backward, bf16, on both flagship segments."""
    flow = _flagship(cuda_device)
    ff = ft.FusedFlow(flow)
    b, bt, bf = 138, 69, "bfloat16"
    segs, x, gz, gldj = _segments(flow, b, seed=7, device=cuda_device)
    spans = [(lo, hi) for _, _, lo, hi in (it for it in ff.plan if it[0] == "segment")]
    before = dict(ft.launch_counts)
    for (rec, offs, mixes, code), (lo, hi) in zip(segs, spans):
        bnrun = ff.running_moments(lo, hi)
        zk, zk32 = (ft.fused_segment_forward(x, rec, offs, mixes, code, m, bnrun)[0]
                    for m in (bf, "float32"))
        zp = ft.segment_forward_reference(x, rec, offs, mixes, code, bf, bnrun)[0]
        k, k32 = (ft.fused_segment_train_forward(x, rec, offs, mixes, code, bt, m)
                  for m in (bf, "float32"))
        p = ft.segment_train_forward_reference(x, rec, offs, mixes, code, bt, bf)
        gk, gk32 = (ft.fused_segment_backward(x, rec, offs, mixes, code, bt, gz, gldj, m)
                    for m in (bf, "float32"))
        gp = ft.segment_backward_reference(x, rec, offs, mixes, code, bt, gz, gldj, bf)
        torch.cuda.synchronize()
        assert _nrel(zk, zp) <= BF16_Z_RTOL < _nrel(zk32, zp)
        assert _nrel(k[0], p[0]) <= BF16_Z_RTOL < _nrel(k32[0], p[0])
        assert float((k[2] - p[2]).abs().max()) <= BF16_BN_ATOL
        for a, a32, r in zip(gk, gk32, gp):
            assert _nrel(a, r) <= BF16_BWD_RTOL < _nrel(a32, r), (_nrel(a, r), _nrel(a32, r))
        x = p[0]
    for name in ("fused_segment_forward", "fused_segment_train_forward", "fused_segment_backward"):
        assert ft.launch_counts[name + "_bf16"] == before.get(name + "_bf16", 0) + len(segs)


@pytest.mark.cuda
@pytest.mark.parametrize("oneshot", [True, False], ids=["oneshot", "segment"])
def test_trainer_launches_bf16_kernels_on_card(cuda_device, oneshot):
    """Trainer(use_pallas=True) at the default pallas_train_dtype (bfloat16):
    every train and eval launch in bf16 mode."""
    from noise_flow_tpu_torch.training.trainer import Trainer

    cfg = load_hps(os.path.join(MODEL, "hps.txt"))
    cfg.use_pallas, cfg.pallas_oneshot = True, oneshot
    assert cfg.pallas_train_dtype == "bfloat16"
    tr = Trainer(_flagship(cuda_device), cfg)
    rng = np.random.default_rng(0)
    mb = {"_x": (0.02 * rng.standard_normal((16, 32, 32, 4))).astype(np.float32),
          "_y": rng.uniform(0.01, 0.9, (16, 32, 32, 4)).astype(np.float32),
          "nlf0": np.full(16, 5e-4, np.float32), "nlf1": np.full(16, 2e-6, np.float32),
          "iso": np.full(16, 800.0, np.float32), "cam": np.full(16, 2.0, np.float32)}
    ft.launch_counts.clear()
    nll, _ = tr.train_epoch([mb, mb])
    ev, _ = tr.eval_epoch([mb])
    want = ({"fused_train_step": 2} if oneshot else
            {"fused_segment_train_forward": 4, "fused_segment_backward": 4})
    want["fused_segment_forward"] = 2
    want.update({f"{k}_bf16": v for k, v in want.items()})
    want["adam_step"] = 2
    assert dict(ft.launch_counts) == want
    assert np.isfinite(nll) and np.isfinite(ev)


# ---------------------------------------------------------------------------
# the train template's redesign (csrc/train_kernel.cuh, DESIGN_PROD): the
# step and the segment backward against their plain versions in both
# precisions at awkward shapes (one patch; a batch of 7 in one group; the
# trainer's groups of 69; 300 patches, more than the 264 CTAs that can be
# resident, in groups of 100), a rerun bit for bit, and the probe library's
# full variant (csrc/train_probe.cu) bit-equal to the production kernel
# ---------------------------------------------------------------------------

AWKWARD = [(1, 1), (7, 7), (138, 69), (300, 100)]


def _step_agrees(got, ref, mm_dtype):
    if mm_dtype == "float32":
        return _raw_close(got, ref)
    return (float((got["bnmom"] - ref["bnmom"]).abs().max()) <= BF16_BN_ATOL
            and all(_nrel(got[k], ref[k]) <= tol for k, tol in BF16_STEP_RTOL.items()))


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,bt", AWKWARD)
def test_train_step_redesign_matches_plain(cuda_device, mm_dtype, b, bt):
    _, args = _step_inputs(_flagship(cuda_device), b, bt, seed=3 * b + bt, device=cuda_device)
    got = ft.fused_train_step(*args, bt, mm_dtype=mm_dtype)
    ref = ft.train_step_reference(*args, bt, mm_dtype=mm_dtype)
    again = ft.fused_train_step(*args, bt, mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(v).all()) for v in got.values())
    assert _step_agrees(got, ref, mm_dtype), {k: _nrel(got[k], ref[k]) for k in ref}
    assert all(torch.equal(got[k], again[k]) for k in got)   # no float atomics
    for name in ("b1", "b2"):
        off, shape = fs._REC_LAYOUT[name]
        assert float(got["grad_rec"][:, off:off + shape[0]].abs().max()) == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,bt", AWKWARD)
def test_segment_backward_redesign_matches_plain(cuda_device, mm_dtype, b, bt):
    tol = SEG_GRAD_RTOL if mm_dtype == "float32" else BF16_BWD_RTOL
    segs, x, gz, gldj = _segments(_flagship(cuda_device), b, seed=5 * b + bt,
                                  device=cuda_device)
    for rec, offs, mixes, code in segs:
        got = ft.fused_segment_backward(x, rec, offs, mixes, code, bt, gz, gldj, mm_dtype)
        ref = ft.segment_backward_reference(x, rec, offs, mixes, code, bt, gz, gldj, mm_dtype)
        again = ft.fused_segment_backward(x, rec, offs, mixes, code, bt, gz, gldj, mm_dtype)
        torch.cuda.synchronize()
        assert all(_nrel(a, r) <= tol for a, r in zip(got, ref)), [
            _nrel(a, r) for a, r in zip(got, ref)]
        assert all(torch.equal(u, v) for u, v in zip(got, again))
        x = ft.segment_train_forward_reference(x, rec, offs, mixes, code, bt, mm_dtype)[0]


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_probe_full_variant_is_the_production_kernel(cuda_device, mm_dtype):
    """The probe library instantiates the production design's template with
    its ablation switch at full: bit for bit the production kernels (step,
    ghost forward, backward); its copy of the parent's design is held to the
    plain versions."""
    from noise_flow_tpu_torch.probes import train_template as tt

    flow = _flagship(cuda_device)
    _, args = _step_inputs(flow, 138, 69, seed=8, device=cuda_device)
    prod = ft.fused_train_step(*args, 69, mm_dtype=mm_dtype)
    probe = tt.train_step(tt.PROD, *args, 69, mm_dtype)
    parent = tt.train_step(tt.PARENT, *args, 69, mm_dtype)
    ref = ft.train_step_reference(*args, 69, mm_dtype=mm_dtype)
    torch.cuda.synchronize()
    assert all(torch.equal(prod[k], probe[k]) for k in prod)
    assert _step_agrees(parent, ref, mm_dtype)
    segs, x, gz, gldj = _segments(flow, 138, seed=9, device=cuda_device)
    for rec, offs, mixes, code in segs:
        a = ft.fused_segment_backward(x, rec, offs, mixes, code, 69, gz, gldj, mm_dtype)
        b = tt.segment_backward(tt.PROD, "full", x, rec, offs, mixes, code, 69, gz, gldj,
                                mm_dtype)
        assert all(torch.equal(u, v) for u, v in zip(a, b))
        a = ft.fused_segment_train_forward(x, rec, offs, mixes, code, 69, mm_dtype)
        b = tt.segment_train_forward(tt.PROD, "full", x, rec, offs, mixes, code, 69, mm_dtype)
        assert all(torch.equal(u, v) for u, v in zip(a, b))


# ---------------------------------------------------------------------------
# the probe library's other variants that have a plain version
# (probes/train_template.py): the parent design's ghost forward and
# backward; the chained ghost-BN reductions; the weight-gradient layouts.
# Observed on an H100: BN chains 1.4e-6 (float32) and 6.7e-6 (bfloat16)
# max abs, weight gradients 2.6e-7 normwise at most.
# ---------------------------------------------------------------------------

BN_CHAIN_ATOL = {"float32": 1e-5, "bfloat16": 5e-5}
WGRAD_RTOL = 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,bt", [(7, 7), (138, 69), (300, 100)])
def test_probe_parent_segment_kernels_match_plain(cuda_device, mm_dtype, b, bt):
    from noise_flow_tpu_torch.probes import train_template as tt

    segs, x, gz, gldj = _segments(_flagship(cuda_device), b, seed=b + 2 * bt, device=cuda_device)
    for rec, offs, mixes, code in segs:
        zk, lk, mk = tt.segment_train_forward(tt.PARENT, "full", x, rec, offs, mixes, code, bt,
                                              mm_dtype)
        zp, lp, mp = ft.segment_train_forward_reference(x, rec, offs, mixes, code, bt, mm_dtype)
        g = tt.segment_backward(tt.PARENT, "full", x, rec, offs, mixes, code, bt, gz, gldj,
                                mm_dtype)
        gp = ft.segment_backward_reference(x, rec, offs, mixes, code, bt, gz, gldj, mm_dtype)
        torch.cuda.synchronize()
        if mm_dtype == "float32":
            np.testing.assert_allclose(zk.cpu().numpy(), zp.cpu().numpy(), **SEG_Z_TOL)
            np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(), rtol=SEG_LDJ_RTOL)
            np.testing.assert_allclose(mk.cpu().numpy(), mp.cpu().numpy(), atol=BN_ATOL,
                                       rtol=SEG_BN_RTOL)
            assert _bwd_close(g, gp)
        else:
            assert _nrel(zk, zp) <= BF16_Z_RTOL
            assert float((mk - mp).abs().max()) <= BF16_BN_ATOL
            assert all(_nrel(a, r) <= BF16_BWD_RTOL for a, r in zip(g, gp))
        x = zp


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["production", "no_reduction", "group_barrier", "merged"])
def test_probe_bn_chain_matches_plain(cuda_device, variant, mm_dtype):
    """Each reduction against n chained two-pass ghost BNs (no_reduction
    against groups of one patch; it and merged run in float32), at the
    flagship's groups and at groups of 7; a chain in groups of a third must
    exceed the tolerance."""
    from noise_flow_tpu_torch.probes import train_template as tt

    x = torch.randn((138, 32, 32, 4), generator=torch.Generator().manual_seed(4)).to(cuda_device)
    dt = "float32" if variant in tt.F32_ONLY_BN else mm_dtype
    for b, bt in ((138, 69), (21, 7)):
        got = tt.bn_chain(variant, x[:b], bt, tt.N_BN, mm_dtype)
        ref = tt.bn_chain_reference(x[:b], 1 if variant == "no_reduction" else bt, tt.N_BN, dt)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        assert float((got - ref).abs().max()) <= BN_CHAIN_ATOL[dt], (b, bt)
    wrong = tt.bn_chain("production", x, 23, tt.N_BN, mm_dtype)
    ref = tt.bn_chain_reference(x, 69, tt.N_BN, mm_dtype)
    assert float((wrong - ref).abs().max()) > BN_CHAIN_ATOL[mm_dtype]


@pytest.mark.cuda
@pytest.mark.parametrize("ntaps", [9, 1])
@pytest.mark.parametrize("variant", ["warp", "mma"])
def test_probe_wgrad_matches_plain(cuda_device, variant, ntaps):
    from noise_flow_tpu_torch.probes import train_template as tt

    g = torch.Generator().manual_seed(6)
    a = torch.randn((138, 32, 32, 4), generator=g).to(cuda_device)
    go = (torch.randn((138, 32, 32, 4), generator=g) / 138).to(cuda_device)
    got = tt.wgrad(variant, ntaps, a, go)
    ref = tt.wgrad_reference(ntaps, a, go)
    again = tt.wgrad(variant, ntaps, a, go)
    torch.cuda.synchronize()
    assert _nrel(got, ref) <= WGRAD_RTOL
    assert torch.equal(got, again)
    assert _nrel(tt.wgrad(variant, ntaps, go, a), ref) > WGRAD_RTOL   # a and g swapped


# ---------------------------------------------------------------------------
# the sampler group's probe library (probes/sampler.py): the sampler's
# template with its ablations and designs, and the chains of dependent
# products. Tolerances: the module's NOTRANS_RTOL, CHAIN_RTOL and
# PX_CHAIN_RTOL (observed errors there).
# ---------------------------------------------------------------------------


def _sampler_inputs(device, b, mode, rng, seed):
    """The flagship's program in ``mode`` and a shape's inputs at b, bt = b:
    the chain input drawn in the kernel (rng) or a seeded eps * 0.6."""
    from noise_flow_tpu_torch.probes import sampler as sp

    nf = NoiseFlowWrapper(MODEL, bn_batch_stats=mode == "batch", device=device)
    x, clean, sa, sb = _inputs(nf._program, b, seed, device)
    return {"program": nf._program, "b": b, "bt": b, "x": None if rng else x, "clean": clean,
            "sa": sa, "sb": sb, "seed": sp.SEED + seed if rng else None}


@pytest.mark.cuda
@pytest.mark.parametrize("rng", [False, True])
@pytest.mark.parametrize("mode", ["running", "batch"])
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_sampler_probe_full_is_the_production_kernel(cuda_device, mm_dtype, mode, rng):
    """The probe library instantiates the sampler's template with ABL_FULL,
    DESIGN_PARENT and 4 pixels a thread (the parent's design): bit for bit
    the production kernel in running BN, and in batch BN, where production
    merges its moments in another order, within the sampler's tolerance of
    it, in both precisions and both input modes."""
    from noise_flow_tpu_torch.probes import sampler as sp

    for b in (1, 137):
        inp = _sampler_inputs(cuda_device, b, mode, rng, seed=b)
        got = sp.run_variant(inp, "full", mm_dtype)
        want = sp.run_production(inp, mm_dtype)
        torch.cuda.synchronize()
        if mode == "running":
            assert torch.equal(got, want), (b, float((got - want).abs().max()))
        else:
            _sample_close(want, got, mm_dtype)


def _resident_ctas(mm_dtype):
    """The CTAs of the production batch-BN kernel the card holds at once,
    from the occupancy API."""
    return fs.sample_plan(1, mm_dtype)["per_sm"] * \
        torch.cuda.get_device_properties(0).multi_processor_count


def _sample_close(got, ref, mm_dtype):
    assert bool(torch.isfinite(got).all())
    if mm_dtype == "bfloat16":
        assert _nrel(got, ref) <= BF16_SAMPLE_RTOL, _nrel(got, ref)
    else:
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_coop_sampler_matches_plain(cuda_device, mm_dtype):
    """The production batch-BN call (one cooperative launch) against the
    plain version at b = 1, at the residency edge (b = the resident CTAs,
    each holding one patch, and one more, which walks), at several BN
    groups with a short last one (b = 137, bt = 64) and at the frame (b =
    bt = 2961), in the eps and the RNG mode."""
    from noise_flow_tpu_torch.probes import sampler as sp

    rc = _resident_ctas(mm_dtype)
    for b, bt, rng in ((1, 1, False), (rc, rc, True), (rc + 1, rc + 1, False), (137, 64, True),
                       (2961, 2961, False)):
        inp = dict(_sampler_inputs(cuda_device, b, "batch", rng, seed=b), bt=bt)
        plan = fs.sample_plan(b, mm_dtype)
        assert plan["resident"] == (b <= rc) and plan["grid"] == min(b, rc), (b, plan)
        before = fs.launch_counts["fused_sample"]
        got = sp.run_production(inp, mm_dtype)
        assert fs.launch_counts["fused_sample"] == before + 1
        _sample_close(got, sp.run_variant(inp, "full", mm_dtype, kernel=False), mm_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("rng", [False, True])
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_coop_sampler_matches_the_parent(cuda_device, mm_dtype, rng):
    """The cooperative launch against the parent's stage-by-stage design,
    resident and walking, with one and several BN groups: within the
    sampler's tolerance (the merged moments sum in another order), one
    launch a call where the parent takes 40, and the same bits from run to
    run."""
    from noise_flow_tpu_torch.probes import sampler as sp

    rc = _resident_ctas(mm_dtype)
    for b, bt in ((1, 1), (137, 64), (138, 138), (rc + 1, rc + 1)):
        inp = dict(_sampler_inputs(cuda_device, b, "batch", rng, seed=b + 2), bt=bt)
        before = dict(fs.launch_counts)
        parent = sp.run_variant(inp, "full", mm_dtype)
        prod = sp.run_production(inp, mm_dtype)
        counts = {k: fs.launch_counts[k] - before.get(k, 0) for k in fs.launch_counts}
        assert counts["fused_sample"] == 1 and counts["sample_probe_ablation"] == 40, counts
        _sample_close(prod, parent, mm_dtype)
        assert torch.equal(sp.run_production(inp, mm_dtype), prod), b


# SHA-256 (first 16 hex digits) of the sampler's output on
# _sampler_inputs(b = 137, seed = 5), written by the kernel as it was before
# its template moved into csrc/sample_kernel.cuh (the git history's
# csrc/fused_sample.cu) on an H100 80GB HBM3; the template gave the same
# bytes in the same run. Production keeps them in running BN (bf16 with its
# weights rounded once); in batch BN the parent's design (the probe
# library's "full") keeps them, and production, whose merged moments sum in
# another order, has COOP_DIGESTS (taken on an H100 80GB HBM3).
SAMPLER_DIGESTS = {
    ("running", False, "float32"): "9b04316b4cdfa946",
    ("running", False, "bfloat16"): "541d595a9455df81",
    ("running", True, "float32"): "f78c8c8c8d02e648",
    ("running", True, "bfloat16"): "68f124f4d8c2fc96",
    ("batch", False, "float32"): "6f1d41a2feebfdee",
    ("batch", False, "bfloat16"): "2182996b7276ca3b",
    ("batch", True, "float32"): "c5c7281267a7ca07",
    ("batch", True, "bfloat16"): "12faf8d467eb6415",
}
COOP_DIGESTS = {
    (False, "float32"): "d529f6016600f2da",
    (False, "bfloat16"): "eec8969389da7bbb",
    (True, "float32"): "9a63b9b5c03d1166",
    (True, "bfloat16"): "1f9809f6df3071bc",
}


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_sampler_template_keeps_the_kernel_bits(cuda_device, mm_dtype):
    """The sampler's bits are pinned: in running BN the production kernel's
    output in both input modes has the digest the kernel wrote before its
    move into the template; in batch BN the parent's design (the probe
    library's stage-by-stage "full") still has it, and the production
    cooperative kernel has its own."""
    import hashlib

    from noise_flow_tpu_torch.probes import sampler as sp

    def digest(y):
        torch.cuda.synchronize()
        return hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
    for (mode, rng, dt), want in SAMPLER_DIGESTS.items():
        if dt != mm_dtype:
            continue
        inp = _sampler_inputs(cuda_device, 137, mode, rng, seed=5)
        if mode == "running":
            assert digest(sp.run_production(inp, dt)) == want, (mode, rng)
        else:
            assert digest(sp.run_variant(inp, "full", dt)) == want, (mode, rng)
            assert digest(sp.run_production(inp, dt)) == COOP_DIGESTS[(rng, dt)], (mode, rng)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["running", "batch"])
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["ppt2", "ppt8", "notrans", "noshift", "nocoupnn",
                                     "interleave", "concat_k", "concat_k_interleave", "precast",
                                     "concat_k_interleave_precast"])
def test_sampler_probe_variant_matches_plain(cuda_device, variant, mm_dtype, mode):
    """Each variant against its plain version at awkward batches (b = 1 and
    137: one patch, and an odd batch that leaves the interleaved designs'
    last CTA half empty); the variants of FULL's arithmetic bit for bit to
    the kernel they share it with (the pixels a thread only in running BN,
    where no block sum enters)."""
    from noise_flow_tpu_torch.probes import sampler as sp

    if variant in sp.BF16_ONLY and mm_dtype == "float32":
        with pytest.raises(ValueError, match="bfloat16"):
            sp.run_variant(_sampler_inputs(cuda_device, 1, mode, False, 1), variant, mm_dtype)
        return
    for b in (1, 137):
        inp = _sampler_inputs(cuda_device, b, mode, mode == "running", seed=b + 1)
        got = sp.run_variant(inp, variant, mm_dtype)
        ref = sp.run_variant(inp, variant, mm_dtype, kernel=False)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all())
        if variant == "notrans":
            assert _nrel(got, ref) <= sp.NOTRANS_RTOL[mm_dtype], (b, _nrel(got, ref))
        elif mm_dtype == "bfloat16":
            assert _nrel(got, ref) <= BF16_SAMPLE_RTOL, (b, _nrel(got, ref))
        else:
            np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), **TOL)
        same = sp.SAME_BITS.get(variant)
        if same and (mode == "running" or variant not in ("ppt2", "ppt8")):
            assert torch.equal(got, sp.run_variant(inp, same, mm_dtype)), b


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_sampler_probe_chains_match_plain(cuda_device, mm_dtype):
    """The chains of 56 dependent products against their plain version: the
    literal [rows, 128] x [128, 128] chain at its timed shape (R_B * 32 rows,
    128 CTAs), 4096 rows (two CTAs) and 384 (one CTA, not a multiple of
    2048), and over its first CHAIN_PREFIX products; the sampler-shape chain
    at b = 1 and 137 by FMAs and, in bfloat16, by mma.sync. One product
    skipped must fail the tolerance, and in bfloat16 a chain whose
    intermediates are not rounded again must fail the prefix's."""
    from noise_flow_tpu_torch.probes import sampler as sp

    g = torch.Generator(device="cuda").manual_seed(9)
    x_full, w = sp.chain_inputs(g)
    for rows in (x_full.shape[0], 4096, 384):
        x = x_full[:rows].contiguous()
        got, ref = sp.mm_chain(x, w, mm_dtype), sp.mm_chain_reference(x, w, mm_dtype)
        torch.cuda.synchronize()
        assert _nrel(got, ref) <= sp.CHAIN_RTOL[mm_dtype], (rows, _nrel(got, ref))
        assert _nrel(sp.mm_chain(x, w[1:].contiguous(), mm_dtype), ref) > sp.CHAIN_RTOL[mm_dtype]
        pre = w[:sp.CHAIN_PREFIX].contiguous()
        got, ref = sp.mm_chain(x, pre, mm_dtype), sp.mm_chain_reference(x, pre, mm_dtype)
        assert _nrel(got, ref) <= sp.CHAIN_PREFIX_RTOL[mm_dtype], (rows, _nrel(got, ref))
        if mm_dtype == "bfloat16":
            assert _nrel(sp.chain_without_rerounding(x, pre), ref) > sp.CHAIN_PREFIX_RTOL[mm_dtype]
    wp = sp.random_rotations(sp.N_MM, 4, g)
    variants = ["f32"] if mm_dtype == "float32" else ["bf16_fma", "bf16_mma"]
    for b in (1, 137):
        x = torch.randn((b, 32, 32, 4), generator=g, device="cuda")
        ref = sp.mm_chain_reference(x, wp, mm_dtype)
        for v in variants:
            got = sp.px_chain(v, x, wp)
            torch.cuda.synchronize()
            assert _nrel(got, ref) <= sp.PX_CHAIN_RTOL[mm_dtype], (b, v, _nrel(got, ref))


@pytest.mark.cuda
@pytest.mark.parametrize("design", ["redesign", "parent"])
@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_mm_chain_designs_match_plain(cuda_device, mm_dtype, design):
    """Both designs of the literal chain against mm_chain_reference at n_mm
    = 1, 8 and 56 products and at 128 rows (one tile), 133 x 128 (a ragged
    last wave of the redesign's persistent grid: 133 float32 tiles or 266
    bfloat16 ones over 132 SMs) and 262,144 (the timed shape), at the
    module's tolerances: CHAIN_PREFIX_RTOL up to CHAIN_PREFIX products,
    CHAIN_RTOL past them. The float32 redesign runs its FMAs in the parent's
    order: the same bits."""
    from noise_flow_tpu_torch.probes import sampler as sp

    g = torch.Generator(device="cuda").manual_seed(13)
    x_full, w = sp.chain_inputs(g)
    for rows in (128, 133 * 128, x_full.shape[0]):
        x = x_full[:rows].contiguous()
        for n in (1, sp.CHAIN_PREFIX, sp.N_MM):
            ww = w[:n].contiguous()
            got, ref = sp.mm_chain(x, ww, mm_dtype, design), sp.mm_chain_reference(x, ww, mm_dtype)
            torch.cuda.synchronize()
            tol = (sp.CHAIN_PREFIX_RTOL if n <= sp.CHAIN_PREFIX else sp.CHAIN_RTOL)[mm_dtype]
            assert bool(torch.isfinite(got).all()) and _nrel(got, ref) <= tol, (rows, n)
            if mm_dtype == "float32" and design == "redesign":
                assert torch.equal(got, sp.mm_chain(x, ww, mm_dtype, "parent")), (rows, n)


@pytest.mark.cuda
def test_mm_chain_precast_kernel_is_its_plain_version(cuda_device):
    """The redesigned bfloat16 chain's first launch (chain_precast) writes
    precast_reference's bits; a chain with one weight replaced by the one
    before it (a stale ring slot) fails CHAIN_RTOL."""
    from noise_flow_tpu_torch.probes import sampler as sp

    g = torch.Generator(device="cuda").manual_seed(14)
    x, w = sp.chain_inputs(g)
    assert torch.equal(sp.precast_weights(w), sp.precast_reference(w))
    stale = w.clone()
    stale[5] = w[4]
    x = x[:4096].contiguous()
    ref = sp.mm_chain_reference(x, w, "bfloat16")
    assert _nrel(sp.mm_chain(x, stale, "bfloat16"), ref) > sp.CHAIN_RTOL["bfloat16"]


@pytest.mark.cuda
@pytest.mark.parametrize("oneshot", [True, False])
def test_step_graph_replays_eager_steps(cuda_device, oneshot):
    """Trainer with steps_per_call 4 over 10 staged steps at b = 16 (2
    replays of a CUDA graph of 4 steps and a 2-step eager tail) gives the
    bits of 10 eager steps from the same weights: each step's NLL and sd_z,
    every weight and BN buffer, Adam's slots; the launch counts add each
    replay's kernels (and the 3 warm-up steps before the capture). One-shot
    step and segment path, float32."""
    from noise_flow_tpu_torch.training import step_graph
    from noise_flow_tpu_torch.training.trainer import Trainer

    b, steps = 16, 10
    g = torch.Generator(device="cpu").manual_seed(3)
    clean = 0.01 + 0.89 * torch.rand((steps * b, 32, 32, 4), generator=g)
    data = {"_x": torch.randn((steps * b, 32, 32, 4), generator=g) * torch.sqrt(5e-4 * clean),
            "_y": clean, "nlf0": torch.full((steps * b,), 5e-4),
            "nlf1": torch.full((steps * b,), 2e-6),
            "iso": torch.tensor([100.0, 400.0, 800.0, 1600.0, 3200.0] * (steps * b // 5)),
            "cam": torch.tensor([0.0, 1.0, 2.0, 3.0, 4.0] * (steps * b // 5))}
    order = torch.randperm(steps * b, generator=g).reshape(steps, b).to(cuda_device)
    runs = {}
    for k in (1, 4):
        cfg = load_hps(os.path.join(MODEL, "hps.txt"))
        cfg.use_pallas, cfg.pallas_oneshot, cfg.pallas_train_dtype = True, oneshot, "float32"
        flow = NoiseFlow((32, 32, 4), cfg, device=cuda_device)
        load_checkpoint(os.path.join(MODEL, "ckpt", "model.ckpt-best.npz"), flow)
        tr = Trainer(flow, cfg)
        tr.stage_dataset([{n: v.numpy() for n, v in data.items()}])
        fs.launch_counts.clear()
        nll, sd_z = tr._staged_steps("train", order, k, True)
        torch.cuda.synchronize()
        names = {p: n for n, p in flow.named_parameters()}
        state = dict(flow.state_dict(), **{f"{names[p]}/{s}": v for p, st in
                                          tr.optimizer.state.items() for s, v in st.items()})
        runs[k] = (nll, sd_z, state, dict(fs.launch_counts))
    for a, r in zip(runs[4][:2], runs[1][:2]):
        assert torch.equal(a, r)
    assert all(torch.equal(v, runs[1][2][n]) for n, v in runs[4][2].items())
    per_step = ({"fused_train_step": 1} if oneshot else
                {"fused_segment_train_forward": 2, "fused_segment_backward": 2})
    per_step["adam_step"] = 1
    for name, n in per_step.items():
        assert runs[1][3][name] == steps * n
        assert runs[4][3][name] == (steps + step_graph.WARMUP_STEPS) * n


# the flow trainer's Adam (csrc/adam.cu) against torch.optim.Adam's
# capturable path, whose arithmetic it computes op for op in float32 with
# torch's roundings: the same bits (chip_smoke.py phase 60 runs 200 steps,
# under graphs and across a checkpoint reload)
@pytest.mark.cuda
@pytest.mark.parametrize("n_tensors", [95, 300])
def test_adam_kernel_matches_torch_capturable_adam(cuda_device, n_tensors):
    from noise_flow_tpu_torch.ops import adam as ad
    from noise_flow_tpu_torch.probes import adam as pa

    g = torch.Generator(device=cuda_device).manual_seed(n_tensors)
    shapes = [(int(torch.randint(1, 200, (), generator=g, device=cuda_device)),)
              for _ in range(n_tensors)]
    base = [torch.randn(s, generator=g, device=cuda_device) for s in shapes]
    ours = [torch.nn.Parameter(t.clone()) for t in base]
    theirs = [torch.nn.Parameter(t.clone()) for t in base]
    opt = ad.Adam(ours, lr=1e-4, capturable=True)
    ref = pa.torch_adam(theirs, 1e-4)
    before = fs.launch_counts["adam_step"]
    steps = 20
    for _ in range(steps):
        for p, q in zip(ours, theirs):
            p.grad = torch.randn(p.shape, generator=g, device=cuda_device)
            q.grad = p.grad.clone()
        opt.step()
        ref.step()
    torch.cuda.synchronize()
    per_launch = ad.limits()[0]
    assert fs.launch_counts["adam_step"] - before == steps * len(ad.launch_plan(n_tensors,
                                                                                per_launch))
    for p, q in zip(ours, theirs):
        assert torch.equal(p, q)
        for slot in ad.SLOTS:
            assert torch.equal(opt.state[p][slot], ref.state[q][slot]), slot
