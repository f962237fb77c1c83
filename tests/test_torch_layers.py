"""noise_flow_tpu_torch.models.layers and cond_params against the JAX
package: every layer kind (tests/test_bijectors.py::ALL_KINDS) and the
coupling with the dense template, on the same weights and inputs, in
forward, inverse and log-det, and the train-mode BatchNorm state of every
layer with BatchNorm."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_flow_tpu.config import default_config as jax_default_config
from noise_flow_tpu.models import cond_params as jcp
from noise_flow_tpu.models.layers import get_layer_def
from noise_flow_tpu_torch.config import default_config
from noise_flow_tpu_torch.models import cond_params as cp
from noise_flow_tpu_torch.models.layers import SCALE_KINDS, make_layer
from noise_flow_tpu_torch.utils.checkpoint import from_numpy_tree

torch.set_num_threads(1)

SHAPE = (8, 8, 4)
PORTED = ["perm_reverse", "conv1x1", "coupling"] + list(SCALE_KINDS) + [
    "condY", "condYG", "condXY", "condXYG", "batch_norm", "leaky_relu"]
DENSE = "coupling:dense"     # the coupling with the dense-MLP template
CASES = PORTED + [DENSE]
BN_KINDS = ["coupling", "condY", "condYG", "condXY", "condXYG", "batch_norm", DENSE]


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _perturb(tree, seed, scale):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(treedef, [
        np.asarray(x, np.float32) + scale * rng.standard_normal(np.shape(x)).astype(np.float32)
        for x in leaves])


def _inputs(b=4, seed=0):
    rng = np.random.default_rng(seed)
    y = (0.05 * rng.standard_normal((b,) + SHAPE)).astype(np.float32)
    base = {
        "clean": rng.uniform(0.01, 0.9, (b,) + SHAPE).astype(np.float32),
        # grid ISOs, an ISO off the grid (fallback formulas) and a camera
        # off the grid (one-hot formulas reduce to 0)
        "iso": np.array([100, 800, 200, 3200], np.float32)[:b],
        "cam": np.array([0, 2, 4, 7], np.float32)[:b],
        "nlf0": np.full(b, 5e-4, np.float32), "nlf1": np.full(b, 2e-6, np.float32),
    }
    return y, base


def _cfgs(case):
    """(kind, JAX config, port config) of a case."""
    kw = dict(arch="", flow_permutation=1, decomp="LU")
    if case == DENSE:
        kw.update(coupling_nn="dense", hidden_layers=(16, 8))
    return case.split(":")[0], jax_default_config(**kw), default_config(**kw)


def _pair(case, seed=0):
    """The JAX layer def with perturbed params, state and shared group, and
    the port's layer holding the same values."""
    kind, jcfg, cfg = _cfgs(case)
    ldef = get_layer_def(kind, jcfg)
    p, s = ldef.init(jax.random.PRNGKey(seed), SHAPE, jcfg)
    p = _perturb(p, seed + 1, 0.05)
    s = _perturb(s, seed + 2, 0.0) if case not in BN_KINDS else jax.tree_util.tree_map(
        lambda a: np.abs(_perturb(a, seed + 2, 0.3)) + (0.5 if a.shape else 0.0), s)
    shared, c_i = jcp.sdn_gain_shared_init(jcfg.gain_init, None,
                                           1 if kind == "sdn6" else 3)
    shared = _perturb(shared, seed + 3, 0.1)
    layer = make_layer(kind, SHAPE, cfg, np.random.default_rng(seed))
    layer.load_state_dict(from_numpy_tree(_np_tree(p), _np_tree(s)))
    tshared = {"sdn_gain": {k: torch.as_tensor(v) for k, v in shared.items()},
               "c_i": c_i}
    jshared = {"sdn_gain": {k: jnp.asarray(v) for k, v in shared.items()}, "c_i": c_i}
    return ldef, p, s, jshared, layer, tshared


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", CASES)
def test_layer_matches_jax(kind, train):
    ldef, p, s, jshared, layer, tshared = _pair(kind)
    y, base = _inputs()
    jc = {k: jnp.asarray(v) for k, v in base.items()}
    tc = {k: torch.as_tensor(v) for k, v in base.items()}
    x_ref, ildj_ref, _ = ldef.inverse(p, jshared, s, jnp.asarray(y), jc, train)
    y_ref, fldj_ref, _ = ldef.forward(p, jshared, s, jnp.asarray(y), jc, train)
    with torch.no_grad():
        x, ildj = layer.inverse(torch.as_tensor(y), tc, train, tshared)
        y2, fldj = layer.forward(torch.as_tensor(y), tc, train, tshared)
        back, _ = layer.forward(x, tc, train, tshared)
    # the ISO-affine convs take weights times iso[0] = 100: shifts reach ~70,
    # and float32 sums in another order (and the round trip's subtraction of
    # the shift) differ by ulps of that size
    scale = np.abs(np.asarray(x_ref)).max() if kind in ("condYG", "condXYG") else 1.0
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(y2.numpy(), np.asarray(y_ref), rtol=1e-4, atol=1e-6 * scale)
    np.testing.assert_allclose(ildj.numpy(), np.asarray(ildj_ref), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(fldj.numpy(), np.asarray(fldj_ref), rtol=1e-5, atol=1e-3)
    assert ildj.shape == (4,) and fldj.shape == (4,)
    # batch BN sees other moments on the way back; the BN bijector's forward
    # always takes the running ones
    if not (train and kind in ("coupling", "batch_norm")):
        np.testing.assert_allclose(back.numpy(), y, rtol=1e-4, atol=1e-6 * scale)


@pytest.mark.parametrize("kind", CASES)
def test_layer_init_shapes_match_jax(kind):
    kind_, jcfg, cfg = _cfgs(kind)
    p, s = get_layer_def(kind_, jcfg).init(jax.random.PRNGKey(0), SHAPE, jcfg)
    layer = make_layer(kind_, SHAPE, cfg, np.random.default_rng(0))
    ref = {k: tuple(v.shape) for k, v in from_numpy_tree(_np_tree(p), _np_tree(s)).items()}
    assert {k: tuple(v.shape) for k, v in layer.state_dict().items()} == ref


@pytest.mark.parametrize("kind", BN_KINDS)
def test_train_mode_bn_state_matches_jax(kind):
    """inverse(train=True) puts into ``state_out`` the new running statistics
    that the JAX layer returns as its new state, keyed as the layer's
    buffers, and changes no buffer."""
    ldef, p, s, jshared, layer, tshared = _pair(kind)
    y, base = _inputs()
    _, _, new_ref = ldef.inverse(p, jshared, s, jnp.asarray(y),
                                 {k: jnp.asarray(v) for k, v in base.items()}, True)
    before = {k: v.clone() for k, v in layer.named_buffers()}
    out = {}
    with torch.no_grad():
        layer.inverse(torch.as_tensor(y), {k: torch.as_tensor(v) for k, v in base.items()},
                      True, tshared, out)
    ref = from_numpy_tree({}, _np_tree(new_ref))
    assert set(out) == set(ref) == set(before) and len(out) >= 2
    for k, v in out.items():
        np.testing.assert_allclose(v.numpy(), ref[k].numpy(), rtol=1e-5, atol=1e-6, err_msg=k)
        assert not torch.equal(v, before[k]), k
    assert all(torch.equal(v, before[k]) for k, v in layer.named_buffers())


def test_iso_gather_fallback800():
    table = np.array([1.0, 2.0, 3.0, 4.0, 5.0], np.float32)
    iso = np.array([100, 400, 800, 1600, 3200, 200, 0], np.float32)
    got = cp._iso_gather_fallback800(torch.as_tensor(table), torch.as_tensor(iso))
    ref = jcp._iso_gather_fallback800(jnp.asarray(table), jnp.asarray(iso))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.numpy().tolist() == [1, 2, 3, 4, 5, 3, 3]


@pytest.mark.parametrize("npcam", [1, 3])
def test_sdn_gain_shared_init(npcam):
    inits = (2.0, -4.0, 0.5, np.linspace(-1, 1, 5), np.full((npcam, 5), 0.7))
    for arg in (None, inits):
        got, c = cp.sdn_gain_shared_init(1.5, arg, npcam)
        ref, c_ref = jcp.sdn_gain_shared_init(1.5, arg, npcam)
        assert c == c_ref and set(got) == set(ref)
        for k in got:
            np.testing.assert_array_equal(got[k], np.asarray(ref[k]))
