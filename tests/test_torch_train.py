"""noise_flow_tpu_torch's fused training path (ops/fused_train.py) against the
JAX package's (ops/pallas_train.py, its Pallas kernels in interpret mode), on
the CPU, where the port's wrappers run the kernels' plain PyTorch versions:
the one-shot loss and gradients, the fused eval loss, the exact-BN autograd
loss and gradients, and the BatchNorm state that ``loss(train=True)``
returns. Inputs are made from numpy seeds and fed to both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_flow_tpu.config import default_config as jax_default_config
from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
from noise_flow_tpu.ops.packed_flow import pack
from noise_flow_tpu.ops.pallas_train import FusedFlow as JaxFusedFlow
from noise_flow_tpu.ops.pallas_train import FusedTrainStep as JaxFusedTrainStep
from noise_flow_tpu_torch.config import default_config
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.ops import fused_train as ft
from noise_flow_tpu_torch.utils.checkpoint import from_numpy_tree

torch.set_num_threads(1)

ARCH = "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc"  # the published model


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _flows(arch=ARCH):
    """(jax flow, params, state, port flow) holding the same perturbed
    weights (built like tests/test_fused_train.py::_flow)."""
    cfg = jax_default_config(arch=arch, patch_height=32)
    jflow = JaxFlow((32, 32, 4), cfg)
    params, state = jflow.init(jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda x: x + 0.03 * jax.random.normal(jax.random.PRNGKey(1), x.shape), params)
    state = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jnp.abs(jax.random.normal(jax.random.PRNGKey(2), x.shape)), state)
    params, state = _np_tree(params), _np_tree(state)
    flow = NoiseFlow((32, 32, 4), default_config(arch=arch, patch_height=32), device="cpu")
    flow.load_state_dict(from_numpy_tree(params, state))
    return jflow, params, state, flow


@pytest.fixture(scope="module")
def flagship():
    return _flows()


def _batch(b, seed=0):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0.01, 0.9, (b, 32, 32, 4)).astype(np.float32)
    x = (rng.standard_normal((b, 32, 32, 4)) * np.sqrt(0.0005 * clean + 2e-6)).astype(np.float32)
    cond = {"clean": clean, "nlf0": np.full((b,), 0.0005, np.float32),
            "nlf1": np.full((b,), 2e-6, np.float32),
            "iso": rng.choice([100, 400, 800, 1600, 3200], b).astype(np.float32),
            "cam": np.full((b,), 2.0, np.float32)}
    return x, cond


def _jax_cond(cond, packed=False):
    out = {k: jnp.asarray(v) for k, v in cond.items()}
    if packed:
        out["clean"] = pack(cond["clean"])
    return out


def _torch_cond(cond):
    return {k: torch.as_tensor(v) for k, v in cond.items()}


def _assert_grads(got, ref, rtol, atol_scale, bias_rel):
    """got: port name -> tensor; ref: the same keys, numpy. Conv biases that
    feed a BatchNorm have zero true gradient, and autograd gives rounding
    noise there: both sides are held to bias_rel times the largest gradient
    of any leaf."""
    assert set(got) == set(ref)
    top = max(float(np.max(np.abs(a))) for a in ref.values())
    for k, a in ref.items():
        g = got[k].detach().numpy()
        if k.endswith(("l1_b", "l2_b")):
            assert np.max(np.abs(g)) <= bias_rel * top, k
            assert np.max(np.abs(a)) <= bias_rel * top, k
            continue
        scale = max(float(np.max(np.abs(a))), 1e-8)
        np.testing.assert_allclose(g, a, rtol=rtol, atol=atol_scale * scale, err_msg=k)


# One-shot step, port (plain version on the CPU) vs JAX (interpret mode):
# float32 sums in other orders (banded 128-lane matmuls there, convolutions
# here). Observed: loss within 2e-7 relative, BN state within 3e-8, gradients
# within 2e-5 of each leaf's largest value.
@pytest.mark.parametrize("bt", [8, 16])
def test_oneshot_step_matches_jax(flagship, bt):
    jflow, params, state, flow = flagship
    x, cond = _batch(16, seed=bt)
    js = JaxFusedTrainStep(jflow, bt=bt, mm_dtype=jnp.float32)
    nll_r, sd_r, st_r, g_r = js.loss_and_grad(params, state, pack(x), _jax_cond(cond, True))
    step = ft.FusedTrainStep(flow, bt=bt)
    nll, sd, st, g = step.loss_and_grad(torch.as_tensor(x), _torch_cond(cond))
    np.testing.assert_allclose(float(nll), float(nll_r), rtol=2e-6)
    np.testing.assert_allclose(float(sd), float(sd_r), rtol=2e-6)
    ref_state = from_numpy_tree({}, _np_tree(st_r))
    assert set(st) == {k for k in ref_state if ".bn" in k}
    for k, v in st.items():
        np.testing.assert_allclose(v.numpy(), ref_state[k].numpy(), atol=3e-7, err_msg=k)
    ref = {k: v.numpy() for k, v in from_numpy_tree(_np_tree(g_r), {}).items()}
    _assert_grads(g, ref, rtol=2e-4, atol_scale=2e-4, bias_rel=1e-4)


def test_fused_eval_loss_matches_jax(flagship):
    jflow, params, state, flow = flagship
    x, cond = _batch(16, seed=3)
    jf = JaxFusedFlow(jflow, bt=16, mm_dtype=jnp.float32)
    nll_r, sd_r, _ = jf.loss(params, state, pack(x), _jax_cond(cond, True), train=False)
    nll, sd, st = ft.FusedFlow(flow, bt=16).loss(torch.as_tensor(x), _torch_cond(cond))
    np.testing.assert_allclose(float(nll), float(nll_r), rtol=2e-6)
    np.testing.assert_allclose(float(sd), float(sd_r), rtol=2e-6)
    assert all(torch.equal(v, dict(flow.named_buffers())[k]) for k, v in st.items())


def test_exact_bn_autograd_matches_jax(flagship):
    """The use_pallas=False train objective: plain autograd of the port's
    NoiseFlow.loss(train=True) against jax.value_and_grad of JAX flow.loss."""
    jflow, params, state, flow = flagship
    x, cond = _batch(8, seed=4)

    def loss_fn(p):
        nll, sd, st = jflow.loss(p, state, jnp.asarray(x), _jax_cond(cond), train=True)
        return nll, (sd, st)

    (nll_r, (sd_r, _)), g_r = jax.value_and_grad(loss_fn, has_aux=True)(params)
    params_t = dict(flow.named_parameters())
    nll, sd, _ = flow.loss(torch.as_tensor(x), _torch_cond(cond), train=True)
    g = torch.autograd.grad(nll, list(params_t.values()), allow_unused=True)
    got = {k: torch.zeros_like(p) if gg is None else gg for (k, p), gg in zip(params_t.items(), g)}
    np.testing.assert_allclose(float(nll.detach()), float(nll_r), rtol=2e-6)
    np.testing.assert_allclose(float(sd.detach()), float(sd_r), rtol=2e-6)
    ref = {k: v.numpy() for k, v in from_numpy_tree(_np_tree(g_r), {}).items()}
    _assert_grads(got, ref, rtol=2e-4, atol_scale=2e-4, bias_rel=1e-4)


def test_train_mode_bn_state_matches_jax(flagship):
    """NoiseFlow.loss(train=True) returns the updated running statistics
    s - 0.1 * (s - batch_stat), keyed as the buffers, as JAX's flow.loss
    returns them, and leaves the buffers as they were."""
    jflow, params, state, flow = flagship
    x, cond = _batch(8, seed=5)
    before = {k: v.clone() for k, v in flow.named_buffers()}
    _, _, st_r = jflow.loss(params, state, jnp.asarray(x), _jax_cond(cond), train=True)
    with torch.no_grad():
        _, _, st = flow.loss(torch.as_tensor(x), _torch_cond(cond), train=True)
    ref = from_numpy_tree({}, _np_tree(st_r))
    bn_keys = {k for k in ref if ".bn" in k}
    assert set(st) == bn_keys and len(bn_keys) == 8 * 4
    for k in bn_keys:
        np.testing.assert_allclose(st[k].numpy(), ref[k].numpy(), atol=1e-6, err_msg=k)
        assert not torch.equal(st[k], before[k]), k
    assert all(torch.equal(v, before[k]) for k, v in flow.named_buffers())
    flow.apply_state(st)
    try:
        assert all(torch.equal(dict(flow.named_buffers())[k], st[k]) for k in st)
    finally:
        flow.apply_state(before)


def test_step_reference_gradients_match_autograd_of_the_chain():
    """The plain step version's gradients are those of NoiseFlow.loss: at
    bt = B through the fold they equal plain autograd of the flow (a port-only
    check at a small width, with perm_reverse mixes and a scalar-ldj gain)."""
    flow = NoiseFlow((32, 32, 4), default_config(arch="sdn|unc|gain|unc", width=3,
                                                  flow_permutation=0), device="cpu", seed=3)
    with torch.no_grad():
        for p in flow.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=torch.Generator().manual_seed(7)))
    x, cond = _batch(4, seed=6)
    xt, ct = torch.as_tensor(x), _torch_cond(cond)
    nll, sd, st, g = ft.FusedTrainStep(flow, bt=4).loss_and_grad(xt, ct)
    params = dict(flow.named_parameters())
    nll_r, sd_r, st_r = flow.loss(xt, ct, train=True)
    g_r = torch.autograd.grad(nll_r, list(params.values()), allow_unused=True)
    ref = {k: (torch.zeros_like(p) if gg is None else gg).numpy()
           for (k, p), gg in zip(params.items(), g_r)}
    np.testing.assert_allclose(float(nll), float(nll_r.detach()), rtol=1e-6)
    np.testing.assert_allclose(float(sd), float(sd_r.detach()), rtol=1e-5)
    for k in st_r:
        np.testing.assert_allclose(st[k].numpy(), st_r[k].numpy(), atol=1e-7, err_msg=k)
    _assert_grads(g, ref, rtol=1e-4, atol_scale=1e-4, bias_rel=1e-4)


def test_segment_reference_matches_flow_inverse():
    """FusedFlow.inverse(train=False) (the eval kernel's plain version on
    the CPU) gives the flow's own inverse and log-det."""
    _, _, _, flow = _flows("sdn5|unc|unc|gain4|unc")
    x, cond = _batch(4, seed=8)
    z, obj, _ = ft.FusedFlow(flow).inverse(torch.as_tensor(x), _torch_cond(cond), train=False)
    with torch.no_grad():
        z_r, obj_r = flow.inverse(torch.as_tensor(x), _torch_cond(cond), train=False)
    np.testing.assert_allclose(z.numpy(), z_r.numpy(), rtol=1e-5, atol=1e-5)
    # obj sums log-dets of order 1e3 that cancel: float32 leaves about 1e-4
    np.testing.assert_allclose(obj.numpy(), obj_r.numpy(), rtol=1e-6, atol=5e-4)


def test_envelope_and_unported_modes_raise():
    """Outside the one-shot step's envelope (more than MAX_SCALE scale
    layers) it raises ValueError, as JAX's does, and the segment path runs
    the flow; the bf16 mode is taken, an unknown dtype and flows outside the
    fused envelope raise."""
    flow = NoiseFlow((32, 32, 4), default_config(arch="sdn|gain|sdn1|gain1|sdn2|unc"),
                     device="cpu")
    with pytest.raises(ValueError, match="segment path"):
        ft.FusedTrainStep(flow)
    x, cond = _batch(2, seed=9)
    z, obj, st = ft.FusedFlow(flow, bt=2).inverse(torch.as_tensor(x), _torch_cond(cond),
                                                  train=True)
    assert bool(torch.isfinite(z).all()) and bool(torch.isfinite(obj).all()) and len(st) == 4
    with pytest.raises(ValueError, match="multiple of bt"):
        ft.FusedFlow(flow, bt=4).inverse(torch.as_tensor(x), _torch_cond(cond), train=True)
    assert ft.FusedFlow(flow, mm_dtype="bfloat16").mm_dtype == "bfloat16"
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ft.FusedFlow(flow, mm_dtype="float16")
    small = NoiseFlow((16, 16, 4), default_config(arch="unc", patch_height=16), device="cpu")
    with pytest.raises(ValueError, match="x_shape"):
        ft.FusedFlow(small)
    step = ft.FusedTrainStep(NoiseFlow((32, 32, 4), default_config(arch="unc|unc"),
                                       device="cpu"), bt=4)
    with pytest.raises(ValueError, match="multiple of bt"):
        step.loss(torch.zeros(6, 32, 32, 4), {"clean": None})


@pytest.mark.parametrize("b,target,stretch,want", [
    (138, 64, 8, 69), (128, 64, 8, 64), (64, 64, 8, 64), (2048, 64, 8, 64),
    (138, 64, 0, 46), (138, 128, 0, 69), (16, 64, 8, 16), (128, 128, 0, 128),
])
def test_pick_block_matches_jax(b, target, stretch, want):
    from noise_flow_tpu.training.trainer import _pick_block

    assert ft.pick_block(b, target, stretch) == _pick_block(b, target, stretch) == want
