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
    # running BN: one launch; batch BN: five per coupling (8 couplings)
    assert fs.launch_counts["fused_sample"] == before + (40 if mode == "batch" else 1)
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
    nf = NoiseFlowWrapper(MODEL, device=cuda_device)   # batch BN: 40 launches a call
    before = fs.launch_counts["fused_sample"]
    noise = nf.sample_noise_nf(np.full((16, 32, 32, 4), 0.3, np.float32), 0, 0, 800, 2)
    assert fs.launch_counts["fused_sample"] == before + 40
    assert noise.shape == (16, 32, 32, 4) and np.isfinite(noise).all()
    frame = nf.sample_noise_frame(np.full((100, 70, 4), 0.3, np.float32), 0, 0, 800, 2,
                                  batch=8)
    assert fs.launch_counts["fused_sample"] == before + 3 * 40   # 12 tiles in batches of 8
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
@pytest.mark.parametrize("b", [1, 138])
def test_segment_forward_kernel_matches_plain(cuda_device, b):
    flow = _flagship(cuda_device)
    ff = ft.FusedFlow(flow)
    z = torch.randn((b, 32, 32, 4), generator=torch.Generator(device="cpu").manual_seed(b))
    z = z.to(cuda_device)
    for _, seg, lo, hi in (item for item in ff.plan if item[0] == "segment"):
        with torch.no_grad():
            coups = [flow.layers[i] for i in range(lo, hi) if flow.specs[i].kind == "coupling"]
            mi = [i for i in range(lo, hi) if flow.specs[i].kind != "coupling"]
            rec, offs = ft.fold_couplings(coups, fold_bn=True)
            mixes, _ = ft.fold_mixes([flow.specs[i] for i in mi], [flow.layers[i] for i in mi],
                                     cuda_device)
        code = ft._ops_code(seg.ops)
        before = ft.launch_counts["fused_segment_forward"]
        zk, lk = ft.fused_segment_forward(z, rec, offs, mixes, code)
        assert ft.launch_counts["fused_segment_forward"] == before + 1
        zp, lp = ft.segment_forward_reference(z, rec, offs, mixes, code)
        torch.cuda.synchronize()
        # N(0, 1) input: see chip_smoke.py SEG_TOL, LDJ_RTOL
        np.testing.assert_allclose(zk.cpu().numpy(), zp.cpu().numpy(), atol=5e-5, rtol=1e-5)
        np.testing.assert_allclose(lk.cpu().numpy(), lp.cpu().numpy(), rtol=2e-6, atol=1e-3)
        assert torch.equal(zk, ft.fused_segment_forward(z, rec, offs, mixes, code)[0])
        z = zk


@pytest.mark.cuda
def test_trainer_launches_train_kernels_on_card(cuda_device):
    """Trainer(use_pallas=True): one step kernel a train step, two eval
    kernels (one a segment) an eval step."""
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
    assert dict(ft.launch_counts) == {"fused_train_step": 2, "fused_segment_forward": 2}
    assert np.isfinite(nll) and np.isfinite(ev)
