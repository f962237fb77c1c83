"""noise_flow_tpu_torch.ops.packed_flow against the port's NHWC path and JAX's
PackedFlow, on the CPU: loss, sd_z and new BatchNorm state, gradients by
autograd, the channel-reverse arch, per-sample NLLs and the envelope's
rejections, case for case as tests/test_packed.py holds JAX's, at its
tolerances. Weights: JAX's init moved as tests/test_packed.py moves it,
loaded into the port through the checkpoint trees."""

import numpy as np
import pytest
import torch

from noise_flow_tpu_torch.config import default_config
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.ops.packed_flow import SUPPORTED_KINDS, PackedFlow, band_from_conv, pack
from noise_flow_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

ARCHS = [
    "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc",  # published model
    "unc|unc",                                     # unconditional
    "sdn|unc|gain|unc",                            # quirky gain ldj (scalar)
]
# tests/test_packed.py's tolerances
NLL_TOL = dict(rtol=2e-5, atol=2e-3)
SDZ_TOL = dict(rtol=1e-4, atol=1e-5)
STATE_TOL = dict(rtol=1e-5, atol=1e-6)
_CACHE = {}


def _flows(arch=ARCHS[0], **kw):
    """(JAX flow, params, state, port flow): JAX's init at PRNGKey(0) moved
    by 0.03 N(0, 1) (params) and 0.05 |N(0, 1)| (state), as
    tests/test_packed.py's _flow."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _CACHE:
        import jax
        import jax.numpy as jnp
        from noise_flow_tpu.config import default_config as jax_default_config
        from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow

        jflow = JaxFlow((32, 32, 4), jax_default_config(arch=arch, patch_height=32, **kw))
        params, state = jflow.init(jax.random.PRNGKey(0))
        params = jax.tree_util.tree_map(
            lambda x: x + 0.03 * jax.random.normal(jax.random.PRNGKey(1), x.shape), params)
        state = jax.tree_util.tree_map(
            lambda x: x + 0.05 * jnp.abs(jax.random.normal(jax.random.PRNGKey(2), x.shape)),
            state)
        flow = NoiseFlow((32, 32, 4), default_config(arch=arch, patch_height=32, **kw),
                         device="cpu")
        flow.load_state_dict(ckpt.from_numpy_tree(params, state))
        _CACHE[key] = (jflow, params, state, flow)
    return _CACHE[key]


def _batch(b, seed=0):
    """tests/test_packed.py's _batch, as numpy."""
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0.01, 0.9, (b, 32, 32, 4)).astype(np.float32)
    x = (rng.standard_normal((b, 32, 32, 4)) * np.sqrt(0.0005 * clean + 2e-6)).astype(np.float32)
    cond = {"clean": clean, "nlf0": np.full((b,), 0.0005, np.float32),
            "nlf1": np.full((b,), 2e-6, np.float32),
            "iso": rng.choice([100, 400, 800, 1600, 3200], b).astype(np.float32),
            "cam": np.full((b,), 2.0, np.float32)}
    return x, cond


def _t(cond, packed=False):
    out = {k: torch.as_tensor(v) for k, v in cond.items()}
    if packed:
        out["clean"] = pack(out["clean"])
    return out


def _jax_cond(cond, packed=False):
    import jax.numpy as jnp

    out = {k: jnp.asarray(v) for k, v in cond.items()}
    if packed:
        out["clean"] = jnp.asarray(pack(cond["clean"]))
    return out


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("train", [True, False])
def test_packed_loss_matches_nhwc_and_jax(arch, train):
    """Loss, sd_z and the new BatchNorm state against the port's
    NoiseFlow.loss on NHWC and against JAX's PackedFlow on the same
    weights and batch."""
    from noise_flow_tpu.ops.packed_flow import PackedFlow as JaxPacked

    jflow, params, state, flow = _flows(arch)
    x, cond = _batch(8)
    with torch.no_grad():
        nll_ref, sdz_ref, st_ref = flow.loss(torch.as_tensor(x), _t(cond), train=train)
        nll_p, sdz_p, st_p = PackedFlow(flow).loss(pack(torch.as_tensor(x)), _t(cond, True),
                                                    train=train)
    nll_j, sdz_j, _ = JaxPacked(jflow).loss(params, state, pack(x), _jax_cond(cond, True),
                                            train=train)
    for ref in (float(nll_ref), float(nll_j)):
        np.testing.assert_allclose(float(nll_p), ref, **NLL_TOL)
    for ref in (float(sdz_ref), float(sdz_j)):
        np.testing.assert_allclose(float(sdz_p), ref, **SDZ_TOL)
    assert set(st_p) == set(st_ref) and st_p
    for k, v in st_ref.items():
        np.testing.assert_allclose(st_p[k].numpy(), v.numpy(), **STATE_TOL)


def test_packed_grads_match_nhwc():
    """Autograd through the bands against autograd of NoiseFlow.loss, leaf
    by leaf, at tests/test_packed.py's tolerances."""
    _, _, _, flow = _flows(ARCHS[0])
    x, cond = _batch(8)

    def grads(fn):
        flow.zero_grad()
        fn().backward()
        # the scale layers' rescale trainables take no part (None on both)
        return {k: p.grad.clone() for k, p in flow.named_parameters() if p.grad is not None}
    g_ref = grads(lambda: flow.loss(torch.as_tensor(x), _t(cond), True)[0])
    g_p = grads(lambda: PackedFlow(flow).loss(pack(torch.as_tensor(x)), _t(cond, True), True)[0])
    flow.zero_grad()
    assert set(g_ref) == set(g_p) and len(g_ref) > 40
    for k, a in g_ref.items():
        a, b = a.numpy(), g_p[k].numpy()
        # conv-bias grads are 0 in exact arithmetic (the bias feeds BN, which
        # subtracts the mean); both paths return float32 reduction noise there
        if max(np.max(np.abs(a)), np.max(np.abs(b))) < 2e-3:
            continue
        tol = max(5e-3 * float(np.max(np.abs(a))), 5e-4)
        np.testing.assert_allclose(b, a, rtol=5e-3, atol=tol, err_msg=k)


def test_packed_perm_reverse_arch():
    _, _, _, flow = _flows(ARCHS[0], flow_permutation=0)
    x, cond = _batch(4)
    with torch.no_grad():
        nll_ref, _, _ = flow.loss(torch.as_tensor(x), _t(cond), train=False)
        nll_p, _, _ = PackedFlow(flow).loss(pack(torch.as_tensor(x)), _t(cond, True), train=False)
    np.testing.assert_allclose(float(nll_p), float(nll_ref), **NLL_TOL)


def test_packed_nll_per_sample():
    _, _, _, flow = _flows("sdn5|unc|gain4|unc")
    x, cond = _batch(6)
    with torch.no_grad():
        ref = flow.nll_per_sample(torch.as_tensor(x), _t(cond)).numpy()
        got = PackedFlow(flow).nll_per_sample(pack(torch.as_tensor(x)), _t(cond, True)).numpy()
    np.testing.assert_allclose(got, ref, **NLL_TOL)


def test_packed_rejects_unsupported():
    """JAX's envelope and messages."""
    cfg = default_config(arch="", sidd_cond="condY", depth=1, patch_height=32)
    with pytest.raises(ValueError, match="unsupported layer kinds"):
        PackedFlow(NoiseFlow((32, 32, 4), cfg, device="cpu"))
    cfg16 = default_config(arch="unc", patch_height=16)
    with pytest.raises(ValueError, match="x_shape"):
        PackedFlow(NoiseFlow((16, 16, 4), cfg16, device="cpu"))
    for kw, msg in ((dict(n_levels=2, squeeze_factor=2), "single-level"),
                    (dict(coupling_nn="dense"), "conv coupling template"),
                    (dict(width=8), "width <= 4")):
        cfg = default_config(arch="unc|unc", patch_height=32, **kw)
        with pytest.raises(ValueError, match=msg):
            PackedFlow(NoiseFlow((32, 32, 4), cfg, device="cpu"))
    from noise_flow_tpu.ops.packed_flow import SUPPORTED_KINDS as JAX_KINDS
    assert SUPPORTED_KINDS == JAX_KINDS


@pytest.mark.parametrize("kh,kw", [(3, 3), (1, 1)])
def test_band_from_conv_matches_jax(kh, kw):
    """The bands of a conv with fewer channels than lanes hold, bit for
    bit, JAX's band_from_conv."""
    import jax.numpy as jnp
    from noise_flow_tpu.ops.packed_flow import band_from_conv as jax_band

    w = np.random.default_rng(4).standard_normal((kh, kw, 2, 3)).astype(np.float32)
    np.testing.assert_array_equal(band_from_conv(torch.as_tensor(w)).numpy(),
                                  np.asarray(jax_band(jnp.asarray(w))))


def test_precision_default_is_float32_on_the_cpu():
    """``precision="default"`` (TF32 products on the card) is float32 on the
    CPU, which has no TF32: the same bits as "highest", loss and gradients;
    and it leaves the global TF32 setting as it found it."""
    _, _, _, flow = _flows(ARCHS[0])
    x, cond = _batch(4)
    before = torch.backends.cuda.matmul.allow_tf32
    out = {}
    for precision in ("highest", "default"):
        flow.zero_grad()
        loss = PackedFlow(flow, precision).loss(pack(torch.as_tensor(x)), _t(cond, True), True)[0]
        loss.backward()
        out[precision] = (float(loss.detach()), [p.grad.clone() for p in flow.parameters()
                                        if p.grad is not None])
    flow.zero_grad()
    assert out["highest"][0] == out["default"][0]
    assert all(torch.equal(a, b) for a, b in zip(out["highest"][1], out["default"][1]))
    assert torch.backends.cuda.matmul.allow_tf32 == before
