"""Every flow the JAX package builds, in noise_flow_tpu_torch, against the
JAX package on the CPU: the legacy revnet specs (empty ``arch``), the
camera-NLF oracle experiments/sidd/condsdn_scale, 2-level flows with their
split priors and checkpoints, gradients of the new layer kinds and
templates, the fused envelopes that exclude them, and ``cli.train`` on each
new recipe. Inputs are made from numpy seeds and fed to both packages."""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_flow_tpu.config import default_config as jax_default_config
from noise_flow_tpu.config import load_hps as jax_load_hps
from noise_flow_tpu.config import save_hps as jax_save_hps
from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
from noise_flow_tpu.ops import pallas_sample as jps
from noise_flow_tpu.ops import pallas_train as jpt
from noise_flow_tpu.utils import checkpoint as jax_ckpt
from noise_flow_tpu.wrapper import NoiseFlowWrapper as JaxWrapper
from noise_flow_tpu_torch.config import default_config, load_hps, save_hps
from noise_flow_tpu_torch.models.flow import LayerSpec, NoiseFlow
from noise_flow_tpu_torch.models.layers import make_layer
from noise_flow_tpu_torch.ops import fused_sample as fs
from noise_flow_tpu_torch.ops import fused_train as ft
from noise_flow_tpu_torch.training.trainer import Trainer
from noise_flow_tpu_torch.utils import checkpoint as ckpt
from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONDSDN = os.path.join(ROOT, "experiments", "sidd", "condsdn_scale")
GRID_ISO = np.array([100, 400, 800, 1600, 3200, 100, 800, 3200], np.float32)
GRID_CAM = np.array([0, 1, 2, 3, 4, 2, 0, 4], np.float32)
SIDD_CONDS = ["condY", "condYG", "condXY", "condXYG", "condSDN", "fitSDN", "mix"]
REVNET_FLAGS = [{}, {"append_sdn2": True}, {"append_sdn_first": True}, {"append_cY": True},
                {"append_sdn": True},
                {"append_sdn2": True, "append_sdn_first": True, "append_cY": True,
                 "append_sdn": True}]
LEVEL_ARCHS = ["unc|unc", "gain|unc"]
TWO_LEVELS = dict(n_levels=2, squeeze_factor=2, patch_height=16)
S16 = (16, 16, 4)


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _batch(b, seed, hw=16):
    """Clean patches, camera-NLF noise at grid ISOs, and both packages'
    conditioning dicts."""
    rng = np.random.default_rng(seed)
    iso, cam = GRID_ISO[:b], GRID_CAM[:b]
    nlf0 = (2e-4 * iso / 100).astype(np.float32)
    nlf1 = (1e-6 * iso / 100).astype(np.float32)
    clean = rng.uniform(0.01, 0.9, (b, hw, hw, 4)).astype(np.float32)
    sd = np.sqrt(clean * nlf0[:, None, None, None] + nlf1[:, None, None, None])
    noise = (sd * rng.standard_normal(clean.shape)).astype(np.float32)
    base = {"clean": clean, "iso": iso, "cam": cam, "nlf0": nlf0, "nlf1": nlf1}
    return (noise, {k: jnp.asarray(v) for k, v in base.items()},
            {k: torch.as_tensor(v) for k, v in base.items()})


def _perturbed(jflow, seed, scale=0.05):
    """JAX params and state from init, moved off it: every weight (the
    zero-init convs and split priors too) plus noise, running variances kept
    positive. The split priors' conv weights move by scale / 50: in the
    sampling direction a gain layer multiplies the latent by up to 150 before
    the prior reads it, and weights of 0.05 there give log-sds past 50, whose
    exp leaves float32's useful range in both packages."""
    params, state = jflow.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)

    def move(path, x):
        s = scale / 50 if str(path[0]) == "['splits']" and str(path[-1]) == "['w']" else scale
        return np.asarray(x, np.float32) + s * rng.standard_normal(np.shape(x)).astype(np.float32)
    params = jax.tree_util.tree_map_with_path(move, params)

    def bn(path, x):
        x = np.asarray(x, np.float32)
        name = str(path[-1])
        if "mean" in name:
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        if "var" in name:
            return x + 0.3 * np.abs(rng.standard_normal(x.shape)).astype(np.float32)
        return x
    state = jax.tree_util.tree_map_with_path(bn, state)
    return _np_tree(params), _np_tree(state)


def _pair(shape, **kw):
    """(JAX flow, params, state, port flow) holding the same weights."""
    jflow = JaxFlow(shape, jax_default_config(**kw))
    params, state = _perturbed(jflow, seed=3)
    flow = NoiseFlow(shape, default_config(**kw), device="cpu")
    flow.load_state_dict(ckpt.from_numpy_tree(params, state))
    return jflow, params, state, flow


# --------------------------------------------------------------- specs

@pytest.mark.parametrize("flags", REVNET_FLAGS, ids=lambda f: "+".join(f) or "plain")
@pytest.mark.parametrize("sidd_cond", SIDD_CONDS)
def test_revnet_specs_match_jax(sidd_cond, flags):
    """An empty arch builds the legacy revnet layer list: the same kinds and
    names as JAX's _revnet_specs for every sidd_cond and append flag."""
    kw = dict(arch="", sidd_cond=sidd_cond, depth=2, patch_height=16, **flags)
    jflow = JaxFlow(S16, jax_default_config(**kw))
    flow = NoiseFlow(S16, default_config(**kw), device="cpu")
    assert [tuple(s) for s in flow.specs] == [tuple(s) for s in jflow.level_specs[0]]
    assert flow.get_layer_names() == jflow.get_layer_names()
    assert flow._is_cond == jflow._is_cond
    assert len(flow.layers) == len(flow.specs) == 4 + sum(flags.values())


# ------------------------------------------------------ condsdn_scale

@pytest.fixture(scope="module")
def condsdn():
    """The camera-NLF oracle's checkpoint in both packages."""
    cfg = jax_load_hps(os.path.join(CONDSDN, "hps.txt"))
    jflow = JaxFlow((32, 32, 4), cfg)
    p0, s0 = jflow.init(jax.random.PRNGKey(0))
    params, state, _, _ = jax_ckpt.load_checkpoint(
        os.path.join(CONDSDN, "ckpt", "model.ckpt-best.npz"), p0, s0, None)
    flow = NoiseFlow((32, 32, 4), load_hps(os.path.join(CONDSDN, "hps.txt")), device="cpu")
    ckpt.load_checkpoint(os.path.join(CONDSDN, "ckpt", "model.ckpt-best.npz"), flow)
    return jflow, params, state, flow


def test_condsdn_scale_nll_matches_jax(condsdn):
    jflow, params, state, flow = condsdn
    assert flow.get_layer_names() == jflow.get_layer_names() == ["Conv2d_1x1_0", "ac_cSDN_0"]
    noise, jc, tc = _batch(8, seed=11, hw=32)
    ref = np.asarray(jflow.nll_per_sample(params, state, jnp.asarray(noise), jc))
    z_ref, _, _ = jflow.inverse(params, state, jnp.asarray(noise), jc, False)
    with torch.no_grad():
        got = flow.nll_per_sample(torch.as_tensor(noise), tc).numpy()
        z, _ = flow.inverse(torch.as_tensor(noise), tc, False)
    # the flow tolerances of tests/test_torch_flow.py
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=5e-2)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), rtol=1e-4, atol=1e-4)


def test_condsdn_scale_wrapper_samples(condsdn):
    """Both packages' wrappers load the oracle; the port's samples through
    the fused sampler (a 1x1 conv and condSDN, a single-level 32x32x4 flow,
    are inside its envelope), and its samples taken back through the flow
    give the temperature-scaled latent."""
    jflow, params, state, _ = condsdn
    nf = NoiseFlowWrapper(CONDSDN, sampling_temperature=0.6, device="cpu")
    jnf = JaxWrapper(CONDSDN, sampling_temperature=0.6)
    assert nf.epoch == jnf.epoch
    ref = ckpt.from_numpy_tree(_np_tree(jnf.params), _np_tree(jnf.state))
    for k, v in nf.flow.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)
    assert fs.in_envelope(nf.flow) and nf._program is not None
    _, _, tc = _batch(8, seed=12, hw=32)
    noise = nf.sample_noise_nf(tc["clean"].numpy(), 4e-4, 2e-6, 800, 2)
    assert noise.shape == (8, 32, 32, 4) and np.isfinite(noise).all()
    full = {k: torch.full((8,), v) for k, v in
            (("nlf0", 4e-4), ("nlf1", 2e-6), ("iso", 800.0), ("cam", 2.0))}
    with torch.no_grad():
        z, _ = nf.flow.inverse(torch.as_tensor(noise), {"clean": tc["clean"], **full}, False)
    assert abs(float(z.std()) - 0.6) < 0.02


def test_oracle_run_starts_from_condsdn_scale(tmp_path):
    """cli.flagship's oracle step: cli.train --init_checkpoint starts the
    condsdn-baseline recipe from condsdn_scale's weights and runs epochs 1
    and 2 from them with its own logs; the flow never trains."""
    from noise_flow_tpu_torch.cli import flagship
    from noise_flow_tpu_torch.cli import train as cli_train

    argv = flagship.CONDSDN + ["--synthetic_data", "2", "--n_batch_train", "8",
                               "--n_batch_test", "8", "--device", "cpu",
                               "--logdir", str(tmp_path)]
    assert cli_train.main(argv) == 0
    rows = flagship.read_tsv(str(tmp_path / "train.txt"))
    assert [r["epoch"] for r in rows] == ["1", "2"] and rows[0]["NLL"] == rows[1]["NLL"]
    assert [r["epoch"] for r in flagship.read_tsv(str(tmp_path / "test.txt"))] == ["1", "2"]
    ref = np.load(os.path.join(CONDSDN, "ckpt", "model.ckpt-best.npz"))
    with np.load(tmp_path / "ckpt" / "model.ckpt-2.npz") as got:
        for k in ref.files:
            if k.startswith(("params|", "state|")):
                np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_oracle_probe_at_a_cut_of_scale(tmp_path):
    """probes.oracle over a generated SIDD-scale corpus cut to 1 train and
    2 test scenes of 128x256: its float32 staged-test NLL is the test row
    of the oracle's cli.train run over the same patches; the TPU-precision
    conv moves the matrix by bfloat16 roundings only; the native loader's
    staged runs read the same number of batches from the npy cache."""
    from noise_flow_tpu_torch.cli import flagship, make_sidd_scale
    from noise_flow_tpu_torch.cli import train as cli_train
    from noise_flow_tpu_torch.probes import oracle

    root = str(tmp_path / "SIDD_Medium_Raw" / "Data")
    assert make_sidd_scale.main(["--root", root, "--n_train", "1", "--n_test", "2",
                                 "--height", "128", "--width", "256",
                                 "--mat_version", "v5"]) == 0
    small = ["--n_batch_train", "8", "--n_batch_test", "8", "--staged_test_patches", "16"]
    assert cli_train.main(flagship.CONDSDN + small + [
        "--sidd_path", root, "--device", "cpu", "--logdir", str(tmp_path / "run")]) == 0
    out = tmp_path / "probe.json"
    assert oracle.main(["--corpus", root, "--cache_dir", str(tmp_path / "cache"),
                        "--device", "cpu", "--n_batch", "8", "--staged_test_patches", "16",
                        "--native_runs", "2", "--out", str(out)]) == 0
    got = json.loads(out.read_text())
    row = flagship.read_tsv(str(tmp_path / "run" / "test.txt"))[0]
    assert got["test_staged"]["batches"] == 2 and got["test_all"]["batches"] == 4
    np.testing.assert_allclose(got["test_staged"]["float32"]["NLL"], float(row["NLL"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["test_staged"]["float32"]["sdz"], float(row["sdz"]),
                               rtol=1e-5)
    for split in ("train", "test_staged", "test_all"):
        f32, tpu = got[split]["float32"], got[split]["tpu_precision"]
        assert 0 < abs(tpu["NLL"] - f32["NLL"]) < 1e-3 * abs(f32["NLL"])
        assert abs(tpu["sdz"] - f32["sdz"]) < 0.01
    assert len(got["native_staged"]) == 2
    for run in got["native_staged"]:
        assert run["batches"] == 2 and 0 <= run["shared_with_python"] <= 16
        assert np.isfinite(run["float32"]["NLL"]) and run["conditions"] >= 1
    assert not (tmp_path / "cache").exists()
    flow = oracle.load_oracle("cpu")
    a, a_tpu = flow.layers[0].built()["A"].detach(), oracle.tpu_mix_matrix(flow.layers[0])
    assert 0 < float((a_tpu - a).abs().max()) <= 2 ** -7 * float(a.abs().max())


# ---------------------------------------------------- 2-level flows

@pytest.fixture(scope="module", params=LEVEL_ARCHS)
def two_level(request):
    return _pair(S16, arch=request.param, **TWO_LEVELS)


def test_two_level_state_dict_names(two_level):
    jflow, params, state, flow = two_level
    names = set(flow.state_dict())
    assert names == set(ckpt.from_numpy_tree(params, state))
    assert {"splits.0.w", "splits.0.b", "splits.0.logs"} <= names
    assert any(k.startswith("levels.1.") for k in names)
    assert flow.level_shapes == [(8, 8, 16), (4, 4, 32)] == [tuple(s) for s in jflow.level_shapes]
    assert flow.get_layer_names() == jflow.get_layer_names()
    assert flow.num_params() == jflow.num_params(params)


@pytest.mark.parametrize("train", [False, True])
def test_two_level_nll_and_z_match_jax(two_level, train):
    jflow, params, state, flow = two_level
    noise, jc, tc = _batch(4, seed=13)
    c = jc if jflow._is_cond else {"clean": None}
    z_ref, obj_ref, _ = jflow.inverse(params, state, jnp.asarray(noise), c, train)
    nll_ref = np.asarray(jflow.nll_per_sample(params, state, jnp.asarray(noise), jc, train))
    loss_ref, sdz_ref, st_ref = jflow.loss(params, state, jnp.asarray(noise), jc, train)
    with torch.no_grad():
        z, obj = flow.inverse(torch.as_tensor(noise), tc if flow._is_cond else {"clean": None},
                              train)
        nll = flow.nll_per_sample(torch.as_tensor(noise), tc, train).numpy()
        loss, sdz, st = flow.loss(torch.as_tensor(noise), tc, train)
    assert z.shape == (4, 4, 4, 32)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(obj.numpy(), np.asarray(obj_ref), rtol=1e-5, atol=5e-2)
    np.testing.assert_allclose(nll, nll_ref, rtol=1e-5, atol=5e-2)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=1e-5, atol=5e-2)
    np.testing.assert_allclose(float(sdz), float(sdz_ref), rtol=1e-4)
    ref = ckpt.from_numpy_tree({}, _np_tree(st_ref))
    bn = {k for k in ref if ".bn" in k}
    assert set(st) == bn and any(k.startswith("levels.1.") for k in bn)
    for k in bn:
        np.testing.assert_allclose(st[k].numpy(), ref[k].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("train", [False, True])
def test_two_level_forward_from_jax_draws_equals_jax_sample(two_level, train):
    """JAX's sample splits its key once for the top latent and once a split
    prior; fed those draws, the port's forward gives JAX's sample."""
    jflow, params, state, flow = two_level
    _, jc, tc = _batch(4, seed=14)
    temp, rng = 0.6, jax.random.PRNGKey(5)
    ref = np.asarray(jflow.sample(params, state, rng, jc, temp=temp, train=train))
    rng, k = jax.random.split(rng)
    z = np.array(jax.random.normal(k, (4,) + tuple(jflow.level_shapes[-1]))) * temp
    rng, k = jax.random.split(rng)
    eps = np.array(jax.random.normal(k, (4, 8, 8, 8)))
    c = tc if flow._is_cond else {"clean": None}
    with torch.no_grad():
        got = flow.forward(torch.as_tensor(z), c, train, split_eps=[torch.as_tensor(eps)],
                           temp=temp).numpy()
    assert got.shape == (4, 16, 16, 4)
    # gain multiplies each level's latent by up to 70 at ISO 1600: couplings
    # then subtract shifts of up to 1e4 in float32, which leaves a few ulps
    # of the largest value in a small one
    atol = 1e-4 + 2 * np.finfo(np.float32).eps * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol)


def test_two_level_sample_round_trip(two_level):
    """sample() draws the top latent and the split's eps from the caller's
    generator; inverse() gives back the top latent."""
    _, _, _, flow = two_level
    _, _, tc = _batch(4, seed=15)
    with torch.no_grad():
        x = flow.sample(tc, temp=0.6, train=False, generator=torch.Generator().manual_seed(0))
        z, _ = flow.inverse(x, tc if flow._is_cond else {"clean": None}, train=False)
    top = torch.randn((4, 4, 4, 32), generator=torch.Generator().manual_seed(0)) * 0.6
    np.testing.assert_allclose(z.numpy(), top.numpy(), rtol=1e-4, atol=1e-4)


def test_two_level_npz_round_trip(two_level, tmp_path):
    """A JAX npz of a 2-level flow loads into the port, and the port's own
    checkpoint of it loads back into JAX with the same leaves; both
    wrappers load the model directory."""
    jflow, params, state, _ = two_level
    path = jax_ckpt.save_checkpoint(str(tmp_path / "ckpt"), "best", params, state, epoch=4)
    flow = NoiseFlow(S16, default_config(arch=jflow.cfg.arch, **TWO_LEVELS), device="cpu",
                     seed=9)
    assert ckpt.load_checkpoint(path, flow) == 4
    ref = ckpt.from_numpy_tree(params, state)
    for k, v in flow.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), ref[k].numpy(), err_msg=k)
    back = ckpt.save_checkpoint(str(tmp_path / "port"), "best", flow, epoch=5)
    p0, s0 = jflow.init(jax.random.PRNGKey(1))
    p1, s1, _, epoch = jax_ckpt.load_checkpoint(back, p0, s0, None)
    assert epoch == 5
    a, ta = jax.tree_util.tree_flatten((p1, s1))
    b, tb = jax.tree_util.tree_flatten((params, state))
    assert ta == tb
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    jax_save_hps(str(tmp_path / "hps.txt"), jflow.cfg, jflow.get_layer_names(),
                 jflow.num_params(params))
    nf = NoiseFlowWrapper(str(tmp_path), device="cpu")
    JaxWrapper(str(tmp_path))
    _, _, tc = _batch(3, seed=16)
    noise = nf.sample_noise_nf(tc["clean"].numpy(), 0.0, 0.0, 800, 2)
    assert not fs.in_envelope(nf.flow) and nf._program is None
    assert noise.shape == (3, 16, 16, 4) and np.isfinite(noise).all()


# flows inside the fused sampler's envelope that it still refuses
REFUSED_IN_ENVELOPE = {
    "over_max_ops": (dict(arch="|".join(["unc"] * (fs.MAX_OPS // 2 + 1))), "at most"),
    "x_shape": (dict(arch="unc|unc", patch_height=16), "x_shape"),
}


@pytest.mark.parametrize("case", list(REFUSED_IN_ENVELOPE))
def test_wrapper_raises_for_a_flow_the_sampler_refuses_in_its_envelope(case, tmp_path):
    """Only a flow outside the envelope samples through flow.sample: a flow
    of the sampler's family that it refuses (more than MAX_OPS layers, or
    another patch shape) makes the wrapper raise."""
    overrides, refusal = REFUSED_IN_ENVELOPE[case]
    cfg = default_config(**overrides)
    ph = cfg.patch_height
    flow = NoiseFlow((ph, ph, 4), cfg, device="cpu")
    assert fs.in_envelope(flow)
    ckpt.save_checkpoint(str(tmp_path / "ckpt"), "best", flow, epoch=1)
    save_hps(str(tmp_path / "hps.txt"), cfg, flow.get_layer_names(), flow.num_params())
    with pytest.raises(ValueError, match=refusal):
        NoiseFlowWrapper(str(tmp_path), device="cpu")


# ------------------------------------------------------------ gradients

def _assert_grads(got, ref, rtol, atol_scale, bias_rel):
    """tests/test_torch_train.py's gradient check. Biases that feed a
    BatchNorm (the conv templates' l1_b and l2_b, the ISO template's C1 and
    C2, the dense template's hidden d{i}_b) have zero true gradient, and
    autograd gives rounding noise there: both sides are held to bias_rel
    times the largest gradient of any leaf."""
    assert set(got) == set(ref)
    top = max(float(np.max(np.abs(a))) for a in ref.values())
    for k, a in ref.items():
        g = got[k].detach().numpy()
        if re.search(r"\.(l1_b|l2_b|l[12]_C[12]|d\d+_b)$", k):
            assert np.max(np.abs(g)) <= bias_rel * top, k
            assert np.max(np.abs(a)) <= bias_rel * top, k
            continue
        scale = max(float(np.max(np.abs(a))), 1e-8)
        np.testing.assert_allclose(g, a, rtol=rtol, atol=atol_scale * scale, err_msg=k)


GRAD_CASES = {
    "revnet_condXY": dict(arch="", sidd_cond="condXY", depth=2),
    "revnet_condYG": dict(arch="", sidd_cond="condYG", depth=1, append_sdn=True),
    "dense": dict(arch="unc|unc", coupling_nn="dense", hidden_layers=(16, 8)),
    "two_level": dict(arch="unc|unc", n_levels=2, squeeze_factor=2),
}


@pytest.mark.parametrize("case", list(GRAD_CASES))
def test_loss_and_grads_match_jax(case):
    """The plain train objective: autograd of the port's loss(train=True)
    against jax.value_and_grad of JAX's, with the tolerances of
    tests/test_torch_train.py."""
    jflow, params, state, flow = _pair(S16, patch_height=16, **GRAD_CASES[case])
    noise, jc, tc = _batch(4, seed=17)

    def loss_fn(p):
        nll, sd, _ = jflow.loss(p, state, jnp.asarray(noise), jc, train=True)
        return nll, sd

    (nll_r, sd_r), g_r = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    named = dict(flow.named_parameters())
    nll, sd, _ = flow.loss(torch.as_tensor(noise), tc, train=True)
    g = torch.autograd.grad(nll, list(named.values()), allow_unused=True)
    got = {k: torch.zeros_like(p) if gg is None else gg for (k, p), gg in zip(named.items(), g)}
    np.testing.assert_allclose(float(nll.detach()), float(nll_r), rtol=2e-6)
    np.testing.assert_allclose(float(sd.detach()), float(sd_r), rtol=2e-6)
    ref = {k: v.numpy() for k, v in ckpt.from_numpy_tree(_np_tree(g_r), {}).items()}
    _assert_grads(got, ref, rtol=2e-4, atol_scale=2e-4, bias_rel=1e-4)


# ------------------------------------------------------- fused envelopes

ENVELOPE_CASES = {
    **{k: dict(arch="", sidd_cond=k, depth=1) for k in ("condY", "condYG", "condXY", "condXYG")},
    "dense": dict(arch="unc|unc", coupling_nn="dense"),
    "two_level": dict(arch="unc|unc", n_levels=2, squeeze_factor=2),
    # no configuration builds these two: their specs are put in by hand
    "batch_norm": dict(arch="unc|unc"),
    "leaky_relu": dict(arch="unc|unc"),
}


@pytest.mark.parametrize("case", list(ENVELOPE_CASES))
def test_fused_envelopes_raise(case):
    """The fused segment path, the one-shot step and the sample program
    raise ValueError outside their envelope, as JAX's do, and the trainer
    with use_pallas then trains on the plain path."""
    kw = dict(ENVELOPE_CASES[case], use_pallas=True)
    cfg = default_config(**kw)
    flow = NoiseFlow((32, 32, 4), cfg, device="cpu")
    if case in ("batch_norm", "leaky_relu"):
        flow.specs.append(LayerSpec(case, case))
        flow.layers.append(make_layer(case, (32, 32, 4), cfg, np.random.default_rng(0)))
    else:
        jflow = JaxFlow((32, 32, 4), jax_default_config(**kw))
        params, state = jflow.init(jax.random.PRNGKey(0))
        for build in (lambda: jpt.FusedFlow(jflow), lambda: jpt.FusedTrainStep(jflow),
                      lambda: jps.build_sample_program(jflow, params, state)):
            with pytest.raises(ValueError):
                build()
    assert not fs.in_envelope(flow)
    for build in (lambda: ft.FusedFlow(flow), lambda: ft.FusedTrainStep(flow),
                  lambda: fs.build_sample_program(flow, "batch"),
                  lambda: fs.build_sample_program(flow, "running")):
        with pytest.raises(ValueError):
            build()
    trainer = Trainer(flow, cfg)
    assert not trainer.use_fused and not trainer.use_oneshot


# ------------------------------------------------------------- cli.train

CLI_RECIPES = {
    # jobs/job_noise_flow.sh condsdn-baseline, a non-trainable flow
    "condsdn_baseline": ["--arch", "", "--sidd_cond", "condSDN", "--depth", "1"],
    "revnet_condXY": ["--arch", "", "--sidd_cond", "condXY", "--depth", "4"],
    "dense": ["--arch", "unc|unc", "--coupling_nn", "dense"],
    "two_level": ["--arch", "unc|unc|unc|unc", "--n_levels", "2", "--squeeze_factor", "2",
                  "--do_sample", "--use_pallas"],
}


@pytest.mark.parametrize("recipe", list(CLI_RECIPES))
def test_cli_train_runs_each_recipe(recipe, tmp_path):
    from noise_flow_tpu_torch.cli import train as cli_train

    argv = CLI_RECIPES[recipe] + [
        "--synthetic_data", "2", "--patch_height", "32", "--n_batch_train", "8",
        "--epochs", "2", "--device", "cpu", "--logdir", str(tmp_path)]
    assert cli_train.main(argv) == 0

    def rows(name):
        with open(tmp_path / name) as f:
            head = f.readline().rstrip("\n").split("\t")
            return [dict(zip(head, ln.rstrip("\n").split("\t"))) for ln in f if ln.strip()]
    train = [float(r["NLL"]) for r in rows("train.txt")]
    assert len(train) == 2 and np.isfinite(train).all()
    assert all(np.isfinite(float(r["NLL"])) for r in rows("test.txt"))
    if recipe == "condsdn_baseline":
        assert train[0] == train[1]        # the oracle never steps
    else:
        assert train[1] < train[0]
    sample = rows("sample.txt")
    assert len(sample) == (2 if recipe == "two_level" else 0)
    assert all(np.isfinite(float(r[c])) for r in sample for c in ("NLL", "KLD_NF"))
    hps = dict(ln.rstrip("\n").split(",", 1) for ln in open(tmp_path / "hps.txt") if "," in ln)
    assert hps["device"] == "cpu"
    assert os.path.exists(tmp_path / "ckpt" / "model.ckpt-best.npz")
