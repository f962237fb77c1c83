"""The cooperative batch-BN sampler's Python side, on the CPU.

``coop_kernel`` (``csrc/sample_kernel.cuh``) runs the batch-BN chain in one
cooperative launch, each BN's moments merged from every patch's sum and M2.
``fused_sample.merged_group_moments`` is the plain version of that merge:
here it is held to the two passes of the plain chain and, in the whole
chain, to JAX's ``flow.forward(train=True)``. The kernel itself runs only
on the card (``tests/test_torch_kernels.py``).
"""

import os
import re

import numpy as np
import pytest
import torch

from noise_flow_tpu_torch.ops import _build
from noise_flow_tpu_torch.ops import fused_sample as fs
from noise_flow_tpu_torch.probes import sampler as sp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "experiments", "sidd", "prod_exact_150")
TOL = dict(rtol=1e-5, atol=1e-6)     # the sampler's float32 tolerance
BF16_SAMPLE_RTOL = 3e-4              # and its bfloat16 one, normwise


@pytest.fixture(scope="module")
def programs():
    torch.set_num_threads(2)
    return sp.flagship_programs(device="cpu")


@pytest.mark.parametrize("b", [138, 0])
def test_sample_plan_needs_a_card(b):
    with pytest.raises(ValueError, match="CUDA device"):
        fs.sample_plan(b, "float32", device="cpu")


def test_coop_kernel_is_the_production_batch_bn_entry():
    """The partials' stride is the kernel's CPART; nf_fused_sample sends
    batch BN in both precisions to launch_coop and running BN to the
    one-launch chain (bfloat16 with its weights rounded once); the plan
    has its ctypes signature; nothing is built on import."""
    text = (_build.CSRC / "sample_kernel.cuh").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", text))
    assert int(consts["CPART"]) == fs.COOP_PART
    entry = (_build.CSRC / "fused_sample.cu").read_text()
    body = entry[entry.index('extern "C" int nf_fused_sample('):]
    assert "if (batch_bn && bf16) return launch_coop<true>(" in body
    assert "if (batch_bn) return launch_coop<false>(" in body
    assert "launch_chain<true, ABL_FULL, DESIGN_PRECAST, PPT_PROD>" in body
    assert "nf_sample_plan" in _build.SIGNATURES["fused_sample"]
    assert not _build._libs


def _inputs(prog, b, seed):
    rng = np.random.default_rng(seed)
    clean = torch.as_tensor(rng.uniform(0.01, 0.9, (b, 32, 32, 4)).astype(np.float32))
    cond = {"clean": clean, "iso": torch.tensor([100.0, 400.0, 800.0, 1600.0, 3200.0] * b)[:b],
            "cam": torch.tensor([0.0, 1.0, 2.0, 3.0, 4.0] * b)[:b],
            "nlf0": torch.zeros(b), "nlf1": torch.zeros(b)}
    sa, sb = prog.scale_ab(cond, b)
    x = torch.as_tensor(0.6 * rng.standard_normal((b, 32, 32, 4)).astype(np.float32))
    return x, clean, sa, sb


def _merged_bn(h, bt):
    """_group_bn's normalisation with the kernel's merged moments."""
    mean, var = fs.merged_group_moments(h, bt)
    return torch.cat([(g - m) * torch.rsqrt(v + fs.BN_EPS)
                      for g, m, v in zip(torch.split(h, bt), mean, var)])


@pytest.mark.parametrize("bt", [24, 10, 7, 1])
def test_merged_moments_are_the_two_pass_moments(programs, bt):
    """The merged moments of the flagship's first conv1 output (b = 24, one
    group; groups of 10 and 7 with a short last one; groups of one patch)
    equal the two passes of _group_bn within float32 rounding, both
    measured against float64."""
    x, _, _, _ = _inputs(programs["batch"], 24, seed=5)
    rec = programs["batch"].coup[0]
    h = fs.conv2d_nhwc(x[..., :2], fs._field(rec, "w1")) + fs._field(rec, "b1")
    mean, var = fs.merged_group_moments(h, bt)
    for i, g in enumerate(torch.split(h.double(), bt)):
        m = g.mean(dim=(0, 1, 2))
        v = ((g - m) ** 2).mean(dim=(0, 1, 2))
        np.testing.assert_allclose(mean[i].numpy(), m.numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(var[i].numpy(), v.numpy(), rtol=1e-5, atol=0)
    assert mean.shape == var.shape == (-(-24 // bt), 4)


@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,bt", [(5, 5), (7, 3), (24, 10)])
def test_chain_with_merged_moments_matches_two_passes(programs, monkeypatch, b, bt, mm_dtype):
    """The whole plain chain with the kernel's merged moments in place of
    _group_bn's two passes stays within the sampler's tolerance of it
    (TOL in float32, BF16_SAMPLE_RTOL normwise in bfloat16), with one group
    and with several and a short last one: the order of the merged sums is
    all that moves the production kernel off the plain version."""
    prog = programs["batch"]
    x, clean, sa, sb = _inputs(prog, b, seed=b + bt)
    want = fs.sample_chain_reference(prog, x, clean, sa, sb, bt, mm_dtype)
    monkeypatch.setattr(fs, "_group_bn", _merged_bn)
    got = fs.sample_chain_reference(prog, x, clean, sa, sb, bt, mm_dtype)
    assert bool(torch.isfinite(got).all())
    if mm_dtype == "bfloat16":
        assert float((got - want).norm() / want.norm()) <= BF16_SAMPLE_RTOL
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.fixture(scope="module")
def jax_flow_noise():
    """JAX's flow.forward(params, state, eps * 0.6, cond, train=True) on the
    flagship checkpoint at b = 24 (one BN group, the whole batch), with its
    eps and conditioning."""
    import jax.numpy as jnp

    from noise_flow_tpu.wrapper import NoiseFlowWrapper as JaxWrapper

    b = 24
    rng = np.random.default_rng(8)
    clean = rng.uniform(0.01, 0.9, (b, 32, 32, 4)).astype(np.float32)
    eps = rng.standard_normal((b, 32, 32, 4)).astype(np.float32)
    jw = JaxWrapper(MODEL)
    full = (lambda v: jnp.full((b,), v, jnp.float32))
    ref = jw.flow.forward(jw.params, jw.state, jnp.asarray(eps * 0.6),
                          {"clean": jnp.asarray(clean), "iso": full(800.0), "cam": full(2.0),
                           "nlf0": full(0.0), "nlf1": full(0.0)}, train=True)
    return clean, eps, np.asarray(ref)


@pytest.mark.parametrize("bt,agrees", [(24, True), (12, False)])
def test_chain_with_merged_moments_matches_jax_flow(programs, jax_flow_noise, monkeypatch,
                                                    bt, agrees):
    """The sampler's plain chain with the kernel's merged moments in place of
    the two passes matches JAX's whole-batch flow.forward(train=True) within
    the sampler's tolerance (TOL: 1e-6 abs, 1e-5 rel); BN groups of half the
    batch do not."""
    clean, eps, ref = jax_flow_noise
    b = clean.shape[0]
    prog = programs["batch"]
    cond = {"clean": torch.as_tensor(clean), "iso": torch.full((b,), 800.0),
            "cam": torch.full((b,), 2.0), "nlf0": torch.zeros(b), "nlf1": torch.zeros(b)}
    sa, sb = prog.scale_ab(cond, b)
    monkeypatch.setattr(fs, "_group_bn", _merged_bn)
    got = fs.sample_chain_reference(prog, torch.as_tensor(eps) * 0.6, cond["clean"], sa, sb,
                                    bt).numpy()
    err = float(np.abs(got - ref).max())
    within = bool(np.all(np.abs(got - ref) <= 1e-6 + 1e-5 * np.abs(ref)))
    assert within == agrees, f"bt={bt}: max abs {err:.3e} against JAX"
