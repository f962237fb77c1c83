"""noise_flow_tpu_torch.models.flow and utils.checkpoint against the JAX
package: the flagship checkpoint loaded into both, per-sample NLL and
sampling from a shared latent, in both BatchNorm modes."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_flow_tpu.config import load_hps as jax_load_hps
from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
from noise_flow_tpu.utils import checkpoint as jax_ckpt
from noise_flow_tpu_torch.config import default_config, load_hps
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "experiments", "sidd", "prod_exact_150")
BEST = os.path.join(MODEL, "ckpt", "model.ckpt-best.npz")
GRID_ISO = np.array([100, 400, 800, 1600, 3200, 100, 800, 3200], np.float32)
GRID_CAM = np.array([0, 1, 2, 3, 4, 2, 0, 4], np.float32)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def flagship():
    """(jax flow, params, state, port flow) holding the in-repo checkpoint."""
    cfg = jax_load_hps(os.path.join(MODEL, "hps.txt"))
    jflow = JaxFlow((32, 32, 4), cfg)
    p0, s0 = jflow.init(jax.random.PRNGKey(0))
    params, state, _, _ = jax_ckpt.load_checkpoint(BEST, p0, s0, None)
    flow = NoiseFlow((32, 32, 4), load_hps(os.path.join(MODEL, "hps.txt")),
                     device="cpu")
    ckpt.load_checkpoint(BEST, flow)
    return jflow, params, state, flow


def _batch(b, seed, sd=0.02):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0.01, 0.9, (b, 32, 32, 4)).astype(np.float32)
    noise = (sd * rng.standard_normal((b, 32, 32, 4))).astype(np.float32)
    return clean, noise, GRID_ISO[:b], GRID_CAM[:b]


def _conds(clean, iso, cam):
    b = clean.shape[0]
    base = {"clean": clean, "iso": iso, "cam": cam,
            "nlf0": np.zeros(b, np.float32), "nlf1": np.zeros(b, np.float32)}
    return ({k: jnp.asarray(v) for k, v in base.items()},
            {k: torch.as_tensor(v) for k, v in base.items()})


def test_flagship_structure(flagship):
    jflow, params, _, flow = flagship
    assert flow.num_params() == jflow.num_params(params) == 2433
    assert flow.get_layer_names() == jflow.get_layer_names()
    assert [s.kind for s in flow.specs] == [s.kind for s in jflow.level_specs[0]]


@pytest.mark.parametrize("train", [False, True])
def test_flagship_nll_matches(flagship, train):
    jflow, params, state, flow = flagship
    clean, noise, iso, cam = _batch(8, seed=1)
    jc, tc = _conds(clean, iso, cam)
    ref = np.asarray(jflow.nll_per_sample(params, state, jnp.asarray(noise),
                                          jc, train=train))
    with torch.no_grad():
        got = flow.nll_per_sample(torch.as_tensor(noise), tc, train=train).numpy()
    # float32 sums over 4,096 elements per patch
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=5e-2)


@pytest.mark.parametrize("train", [False, True])
def test_flagship_inverse_and_loss_match(flagship, train):
    jflow, params, state, flow = flagship
    clean, noise, iso, cam = _batch(8, seed=2)
    jc, tc = _conds(clean, iso, cam)
    z_ref, obj_ref, _ = jflow.inverse(params, state, jnp.asarray(noise), jc, train)
    loss_ref, sdz_ref, _ = jflow.loss(params, state, jnp.asarray(noise), jc, train)
    with torch.no_grad():
        z, obj = flow.inverse(torch.as_tensor(noise), tc, train)
        loss, sdz, _ = flow.loss(torch.as_tensor(noise), tc, train)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(obj.numpy(), np.asarray(obj_ref), rtol=1e-5, atol=5e-2)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5, atol=5e-2)
    np.testing.assert_allclose(float(sdz), float(sdz_ref), rtol=1e-4)


@pytest.mark.parametrize("train", [False, True])
def test_flagship_forward_from_shared_eps(flagship, train):
    jflow, params, state, flow = flagship
    clean, _, iso, cam = _batch(8, seed=3)
    jc, tc = _conds(clean, iso, cam)
    eps = np.random.default_rng(4).standard_normal((8, 32, 32, 4)).astype(np.float32)
    ref = np.asarray(jflow.forward(params, state, jnp.asarray(eps) * 0.6, jc, train))
    with torch.no_grad():
        got = flow.forward(torch.as_tensor(eps) * 0.6, tc, train).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_sample_round_trip(flagship):
    """sample() then inverse() gives back the latent, scaled by temp."""
    _, _, _, flow = flagship
    clean, _, iso, cam = _batch(4, seed=5)
    _, tc = _conds(clean, iso, cam)
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        x = flow.sample(tc, temp=0.6, train=False, generator=g)
        z, _ = flow.inverse(x, tc, train=False)
    g = torch.Generator().manual_seed(0)
    eps = torch.randn((4, 32, 32, 4), generator=g) * 0.6
    np.testing.assert_allclose(z.numpy(), eps.numpy(), rtol=1e-4, atol=1e-5)


def test_small_random_flow_matches():
    """A randomized sdn5|unc|gain4|unc flow, weights carried over with
    from_numpy_tree: NLL and forward match."""
    from noise_flow_tpu.config import default_config as jax_default_config

    jcfg = jax_default_config(arch="sdn5|unc|gain4|unc", patch_height=16)
    jflow = JaxFlow((16, 16, 4), jcfg)
    params, state = jflow.init(jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(
        lambda x: x + 0.05 * jax.random.normal(jax.random.PRNGKey(4), x.shape), params)
    state = jax.tree_util.tree_map(
        lambda x: x + 0.1 * jnp.abs(jax.random.normal(jax.random.PRNGKey(5), x.shape)),
        state)
    flow = NoiseFlow((16, 16, 4), default_config(arch="sdn5|unc|gain4|unc",
                                                 patch_height=16), device="cpu")
    flow.load_state_dict(ckpt.from_numpy_tree(_np_tree(params), _np_tree(state)))
    rng = np.random.default_rng(6)
    clean = rng.uniform(0.01, 0.9, (4, 16, 16, 4)).astype(np.float32)
    noise = (0.03 * rng.standard_normal((4, 16, 16, 4))).astype(np.float32)
    jc, tc = _conds(clean, GRID_ISO[:4], GRID_CAM[:4])
    for train in (False, True):
        ref = np.asarray(jflow.nll_per_sample(params, state, jnp.asarray(noise), jc, train))
        with torch.no_grad():
            got = flow.nll_per_sample(torch.as_tensor(noise), tc, train).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-2)
        ref = np.asarray(jflow.forward(params, state, jnp.asarray(noise), jc, train))
        with torch.no_grad():
            got = flow.forward(torch.as_tensor(noise), tc, train).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_from_numpy_tree_equals_checkpoint_load(flagship):
    _, params, state, flow = flagship
    sd = ckpt.from_numpy_tree(_np_tree(params), _np_tree(state))
    own = flow.state_dict()
    assert set(sd) == set(own)
    for k, v in sd.items():
        np.testing.assert_array_equal(v.numpy(), own[k].numpy(), err_msg=k)
    assert "layers.2.nn.l1_w" in sd and "shared.sdn_gain.cam_params" in sd


def test_checkpoint_written_by_port_loads_in_jax(flagship, tmp_path):
    jflow, params, state, flow = flagship
    path = ckpt.save_checkpoint(str(tmp_path), "best", flow, epoch=7)
    p0, s0 = jflow.init(jax.random.PRNGKey(1))
    p1, s1, _, epoch = jax_ckpt.load_checkpoint(path, p0, s0, None)
    assert epoch == 7
    for a, b in zip(jax.tree_util.tree_leaves((p1, s1)),
                    jax.tree_util.tree_leaves((params, state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert ckpt.latest_checkpoint(str(tmp_path)) is None   # only "best"
    ckpt.save_checkpoint(str(tmp_path), 3, flow)
    assert ckpt.latest_checkpoint(str(tmp_path)).endswith("model.ckpt-3.npz")


def test_checkpoint_shape_mismatch_raises(tmp_path):
    cfg = load_hps(os.path.join(MODEL, "hps.txt"))
    cfg.width = 8
    flow = NoiseFlow((32, 32, 4), cfg, device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        ckpt.load_checkpoint(BEST, flow)


@pytest.mark.parametrize("overrides", [
    {"arch": "sdn5|unc|gain4|unc"},
    {"arch": "", "sidd_cond": "condSDN", "depth": 1},
    {"arch": "", "sidd_cond": "condXY", "depth": 2},
])
def test_clean_conditioned_multi_level_flows_raise_in_both(overrides):
    """A reference limitation kept: above level 0 the twice-squeezed clean
    image no longer matches the latent, so JAX fails on the first NLL of a
    2-level flow whose layers read it, and the port refuses to build one."""
    from noise_flow_tpu.config import default_config as jax_default_config

    kw = dict(overrides, patch_height=16, n_levels=2, squeeze_factor=2)
    jflow = JaxFlow((16, 16, 4), jax_default_config(**kw))
    params, state = jflow.init(jax.random.PRNGKey(0))
    clean, noise, iso, cam = _batch(3, seed=7)
    jc, _ = _conds(clean[:, :16, :16], iso, cam)
    with pytest.raises((TypeError, ValueError)):
        jflow.nll_per_sample(params, state, jnp.asarray(noise[:, :16, :16]), jc)
    with pytest.raises(ValueError, match="clean image"):
        NoiseFlow((16, 16, 4), default_config(**kw), device="cpu")
