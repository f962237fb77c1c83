"""The running-BN eval forward (ops/fused_train.py ``fused_segment_forward``,
csrc/segment_kernel.cuh) on the CPU, where its wrapper runs the plain
version: ``FusedFlow(train=False)`` on the flagship checkpoint at the eval
batch against JAX's ``flow.loss(train=False)`` (the XLA path), the running
moments' form (the bfloat16 mode's) against the folded one in float32, the
probe library's wrappers, and the kernel sources' declarations that the
design rests on (two CTAs an SM, production without planted faults)."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_flow_tpu.config import load_hps as jax_load_hps
from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
from noise_flow_tpu.utils import checkpoint as jax_ckpt
from noise_flow_tpu_torch.ops import _build
from noise_flow_tpu_torch.ops import fused_train as ft
from noise_flow_tpu_torch.probes import train_template as tt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "experiments", "sidd", "prod_exact_150")
BEST = os.path.join(MODEL, "ckpt", "model.ckpt-best.npz")


@pytest.fixture(scope="module")
def flagship():
    """(jax flow, params, state, port flow) holding the in-repo checkpoint."""
    jflow = JaxFlow((32, 32, 4), jax_load_hps(os.path.join(MODEL, "hps.txt")))
    p0, s0 = jflow.init(jax.random.PRNGKey(0))
    params, state, _, _ = jax_ckpt.load_checkpoint(BEST, p0, s0, None)
    return jflow, params, state, tt.flagship_flow("cpu")


def _batch(b, seed):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0.01, 0.9, (b, 32, 32, 4)).astype(np.float32)
    x = (rng.standard_normal((b, 32, 32, 4)) * np.sqrt(5e-4 * clean + 2e-6)).astype(np.float32)
    cond = {"clean": clean, "nlf0": np.zeros(b, np.float32), "nlf1": np.zeros(b, np.float32),
            "iso": rng.choice([100, 400, 800, 1600, 3200], b).astype(np.float32),
            "cam": rng.choice([0, 1, 2, 3, 4], b).astype(np.float32)}
    return x, cond


# FusedFlow(train=False) in float32 (the eval kernel's plain version, BN
# folded into the records) against JAX's plain flow, jitted (BN after each
# conv, XLA convolutions): float32 sums in other orders. Observed on this
# CPU at b = 138: z within 3.4e-6 abs (entries up to 5.9), each patch's
# objective within 6.2e-7 relative, the mean NLL within 1.9e-7 and sd_z
# within 9.8e-8 relative. Each tolerance is about 10x that.
@pytest.mark.parametrize("b", [1, 138])
def test_fused_eval_matches_jax_flow_loss(flagship, b):
    jflow, params, state, flow = flagship
    x, cond = _batch(b, seed=b)
    jcond = {k: jnp.asarray(v) for k, v in cond.items()}
    z_r, obj_r, _ = jax.jit(lambda p, s, x_, c: jflow.inverse(p, s, x_, c, False))(
        params, state, jnp.asarray(x), jcond)
    nll_r, sd_r, _ = jax.jit(lambda p, s, x_, c: jflow.loss(p, s, x_, c, False))(
        params, state, jnp.asarray(x), jcond)
    ff = ft.FusedFlow(flow)
    tcond = {k: torch.as_tensor(v) for k, v in cond.items()}
    z, obj, _ = ff.inverse(torch.as_tensor(x), tcond, train=False)
    nll, sd, _ = ff.loss(torch.as_tensor(x), tcond)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_r), rtol=0, atol=3e-5)
    np.testing.assert_allclose(obj.numpy(), np.asarray(obj_r), rtol=6e-6)
    np.testing.assert_allclose(float(nll), float(nll_r), rtol=2e-6)
    np.testing.assert_allclose(float(sd), float(sd_r), rtol=1e-6)


@pytest.mark.parametrize("seg", [0, 1])
def test_running_moments_form_is_the_folded_form(flagship, seg):
    """The eval kernel's two forms of one function, in float32: records
    without BN and the running moments applied after each conv (the bf16
    mode's form, whose 1/sqrt(var + eps) the kernel stages once a coupling)
    against BN folded into the records; float32 rounding apart (observed
    3.8e-6 abs in z and 6.6e-8 relative in ldj on N(0, 1) input; about 10x
    that allowed)."""
    flow = flagship[3]
    folded = tt.eval_segments(flow, "float32")[seg]
    running = tt.eval_segments(flow, "bfloat16")[seg]
    assert folded[4] is None and running[4].shape == (folded[0].shape[0], 4, 4)
    z = torch.randn((6, 32, 32, 4), generator=torch.Generator().manual_seed(seg))
    zf, lf = ft.fused_segment_forward(z, *folded[:4], "float32", None)
    zr, lr = ft.fused_segment_forward(z, *running[:4], "float32", running[4])
    np.testing.assert_allclose(zr.numpy(), zf.numpy(), rtol=0, atol=4e-5)
    np.testing.assert_allclose(lr.numpy(), lf.numpy(), rtol=1e-6)


@pytest.mark.parametrize("mm_dtype", ["float32", "bfloat16"])
def test_parent_wrapper_runs_the_plain_version_on_cpu(flagship, mm_dtype):
    """The probe library's parent design and the production wrapper take the
    same plain version for CPU tensors; a fault has none and refuses them."""
    flow = flagship[3]
    z = torch.randn((3, 32, 32, 4), generator=torch.Generator().manual_seed(7))
    for sg in tt.eval_segments(flow, mm_dtype):
        got = tt.segment_forward_parent(z, *sg[:4], mm_dtype, sg[4])
        ref = ft.segment_forward_reference(z, *sg[:4], mm_dtype, sg[4])
        assert all(torch.equal(a, r) for a, r in zip(got, ref))
        assert all(torch.equal(a, r) for a, r in
                   zip(ft.fused_segment_forward(z, *sg[:4], mm_dtype, sg[4]), ref))
        with pytest.raises(ValueError, match="CUDA"):
            tt.segment_forward_fault("moments", z, *sg[:4], mm_dtype, sg[4])
    with pytest.raises(ValueError, match="CUDA device"):
        ft.segment_occupancy("cpu")


def test_eval_chain_runs_each_segment_in_turn(flagship):
    """eval_chain: the second segment takes the first's z, the ldj add up."""
    segs = tt.eval_segments(flagship[3], "float32")
    z = torch.randn((2, 32, 32, 4), generator=torch.Generator().manual_seed(1))
    z1, l1 = ft.segment_forward_reference(z, *segs[0][:4], "float32", None)
    z2, l2 = ft.segment_forward_reference(z1, *segs[1][:4], "float32", None)
    zc, lc = tt.eval_chain(segs, ft.segment_forward_reference, z, "float32")
    assert torch.equal(zc, z2) and torch.equal(lc, l1 + l2)


def _source(name):
    with open(_build.CSRC / name) as fh:
        return fh.read()


def test_eval_kernel_holds_two_ctas_an_sm():
    """segment_kernel is declared __launch_bounds__(256, 2): at most 128
    registers, so the eval batch of 138 patches is one wave on 132 SMs."""
    src = _source("segment_kernel.cuh")
    assert re.search(r"__launch_bounds__\(THREADS, 2\)\s*\nsegment_kernel\(", src)
    assert "constexpr int THREADS = 256;" in _source("train_common.cuh")


def test_production_eval_entry_launches_the_production_design_only():
    """fused_train.cu launches segment_kernel in E_PROD alone; the planted
    faults are the probe library's."""
    prod, probe = _source("fused_train.cu"), _source("segment_probe.cu")
    assert set(re.findall(r"launch_segment<\w+, (\w+)>", prod)) == {"E_PROD"}
    assert "E_FAULT" not in prod
    assert set(re.findall(r"launch_segment<BF, (\w+)>", probe)) == {
        "E_FAULT_NOSYNC", "E_FAULT_MOMENTS"}


def test_fault_codes_are_the_kernel_template_bits():
    """SEG_FAULTS' codes are the E_FAULT_* bits of segment_kernel.cuh, and
    the probe library's entries are registered with ctypes."""
    bits = dict(re.findall(r"constexpr int (E_FAULT_\w+) = (\d+);", _source("segment_kernel.cuh")))
    assert tt.SEG_FAULTS == {"nosync": int(bits["E_FAULT_NOSYNC"]),
                             "moments": int(bits["E_FAULT_MOMENTS"])}
    probe = _source("segment_probe.cu")
    for entry in _build.SIGNATURES["segment_probe"]:
        assert f'extern "C" int {entry}(' in probe
    assert 'extern "C" int nf_segment_occupancy(' in _source("fused_train.cu")
