"""The port's DnCNN path against the JAX package.

``models/dncnn.py``, ``training/dncnn_trainer.py``, ``data/dncnn_data.py``,
``utils/image_metrics.py``, the DnCNN checkpoints and the two CLIs, held
against their JAX counterparts on the same numpy inputs and weights (carried
with ``from_numpy_tree``), at a small size: depth 4, 8 filters, b <= 16. The
Noise Flow source is held through a shared eps: the seed's normals
(``rng_normals_reference``) through JAX's ``NoiseFlow.forward`` with batch
statistics. Tolerances are stated beside each comparison with the error
observed here.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_flow_tpu.config import load_hps as jax_load_hps
from noise_flow_tpu.data import dncnn_data as jax_data
from noise_flow_tpu.models.dncnn import dncnn_apply, dncnn_init, dncnn_num_params
from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
from noise_flow_tpu.parallel.mesh import make_mesh
from noise_flow_tpu.training import dncnn_trainer as jax_tr
from noise_flow_tpu.utils import checkpoint as jax_ckpt
from noise_flow_tpu.utils import image_metrics as jax_metrics
from noise_flow_tpu_torch.config import load_hps
from noise_flow_tpu_torch.data import dncnn_data
from noise_flow_tpu_torch.models.dncnn import DnCNN
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.ops import fused_sample as fs
from noise_flow_tpu_torch.training import dncnn_trainer as tr
from noise_flow_tpu_torch.utils import checkpoint as ckpt
from noise_flow_tpu_torch.utils import image_metrics

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "experiments", "sidd", "prod_exact_150")
BEST = os.path.join(MODEL, "ckpt", "model.ckpt-best.npz")
DEPTH, FILTERS = 4, 8


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def weights():
    """JAX DnCNN trees with BN scale, bias and running statistics moved off
    their init values, and the port's DnCNN holding the same weights."""
    params, state = dncnn_init(jax.random.PRNGKey(0), DEPTH, FILTERS, 4)
    rng = np.random.default_rng(1)
    params, state = _np_tree(params), _np_tree(state)
    for i in range(DEPTH - 2):
        params["bn_scale"][i] = (1 + 0.2 * rng.standard_normal(FILTERS)).astype(np.float32)
        params["bn_bias"][i] = (0.1 * rng.standard_normal(FILTERS)).astype(np.float32)
        state["bn"][i] = {"mean": (0.1 * rng.standard_normal(FILTERS)).astype(np.float32),
                          "var": rng.uniform(0.5, 2.0, FILTERS).astype(np.float32)}
    model = DnCNN(DEPTH, FILTERS, 4, device="cpu")
    model.load_state_dict(ckpt.from_numpy_tree(params, state))
    return params, state, model


def _images(b, seed=3):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0.05, 0.9, (b, 32, 32, 4)).astype(np.float32)
    noisy = np.clip(clean + 0.05 * rng.standard_normal(clean.shape), 0, 1).astype(np.float32)
    return clean, noisy


def test_state_dict_keys_are_jax_key_paths(weights):
    params, state, model = weights
    assert set(ckpt.from_numpy_tree(params, state)) == set(model.state_dict())
    assert "convs.0" in model.state_dict() and "bn.1.var" in model.state_dict()
    assert tuple(model.convs[1].shape) == (3, 3, FILTERS, FILTERS)     # HWIO
    init = DnCNN(9, 32, 4, device="cpu", seed=5)
    w = init.convs[1].detach().numpy().reshape(-1, 32)
    np.testing.assert_allclose(w.T @ w, np.eye(32), atol=1e-5)       # orthogonal columns
    assert init.num_params() == dncnn_num_params(dncnn_init(jax.random.PRNGKey(0), 9, 32, 4)[0])


# Forward against dncnn_apply, float32 both sides: the convs sum up to 288
# products in another order (observed 5.7e-6 abs on the output in train
# mode, 1.2e-7 in eval mode; 1.3e-6 on the BN moments).
@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(weights, train):
    params, state, model = weights
    _, noisy = _images(8)
    ref, ref_state = dncnn_apply(params, state, jnp.asarray(noisy), train=train)
    with torch.no_grad():
        got, new_state = model(torch.as_tensor(noisy), train=train)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    for i, st in enumerate(ref_state["bn"]):
        for k in ("mean", "var"):
            np.testing.assert_allclose(new_state[f"bn.{i}.{k}"].numpy(), np.asarray(st[k]),
                                       rtol=1e-5, atol=1e-5)


def test_gradients_match_jax(weights):
    """d(sum sq error / 2)/d(params) of the port's float32 model against
    jax.grad of dncnn_apply in float64, normwise per leaf within 1e-5
    (observed 1.3e-6). The reference runs in float64 because JAX's own
    float32 gradient is the farther one: the BN scale and bias gradients
    are sums of 8k terms that cancel, and JAX float32 is 1.8e-5 off its
    float64 there, where the port is 1.3e-6 off."""
    params, state, model = weights
    clean, noisy = _images(8)

    with jax.enable_x64(True):
        def f64(tree):
            return jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), tree)
        state64 = f64(state)

        def loss_fn(p):
            out, _ = dncnn_apply(p, state64, jnp.asarray(noisy, jnp.float64), train=True)
            return jnp.sum(jnp.square(out - jnp.asarray(clean, jnp.float64))) / 2.0
        grads = jax.grad(loss_fn)(f64(params))
        ref = ckpt.from_numpy_tree(jax.tree_util.tree_map(np.asarray, grads), {})
    model.zero_grad()
    out, _ = model(torch.as_tensor(noisy), train=True)
    (torch.sum(torch.square(out - torch.as_tensor(clean))) / 2.0).backward()
    for name, p in model.named_parameters():
        assert _rel(p.grad.numpy(), ref[name].numpy()) <= 1e-5, name
    model.zero_grad()


def test_bf16_forward_matches_jax(weights):
    """compute_dtype bf16 on both sides: operands rounded to bf16 (8 bits),
    products summed in float32, the result rounded to bf16 and cast back; a
    conv that sums in another order moves a bf16 result by an ulp (2^-8
    relative), so held normwise within 2e-2 (observed 0 on this CPU, where
    both round the same), against 1e-5 in float32."""
    params, state, model = weights
    _, noisy = _images(8)
    bf = DnCNN(DEPTH, FILTERS, 4, device="cpu", compute_dtype=torch.bfloat16)
    bf.load_state_dict(model.state_dict())
    ref, _ = dncnn_apply(params, state, jnp.asarray(noisy), train=True,
                         compute_dtype=jnp.bfloat16)
    with torch.no_grad():
        got, _ = bf(torch.as_tensor(noisy), train=True)
    noise_ref = noisy - np.asarray(ref)
    assert _rel(noisy - got.numpy(), noise_ref) <= 2e-2


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

def _pair(source="real", **kw):
    """A JAX trainer and the port's trainer from the same initial weights."""
    jt = jax_tr.DnCNNTrainer(depth=DEPTH, filters=FILTERS, lr=1e-3, mesh=make_mesh(1),
                             noise_source=source, seed=0, **kw)
    pt = tr.DnCNNTrainer(depth=DEPTH, filters=FILTERS, lr=1e-3, noise_source=source,
                         device="cpu", **kw)
    pt.model.load_state_dict(ckpt.from_numpy_tree(_np_tree(jt.params), _np_tree(jt.state)))
    return jt, pt


# 3 Adam steps on the real noisy set (the noise is data, so both sides see
# the same inputs), one step an epoch so that each loss is compared: losses
# relative within 1e-5 (observed 1.8e-6), parameters and BN state normwise
# per leaf within 1e-5 (observed 6.4e-6, biases.first).
@pytest.mark.parametrize("device_resident", [True, False])
def test_trainer_trajectory_matches_jax(device_resident):
    clean, noisy = _images(16, seed=4)
    jt, pt = _pair("real")
    for step in range(3):
        lj = jt.train_epoch(clean, 16, jax.random.PRNGKey(step), noisy=noisy,
                            shuffle_seed=step, device_resident=device_resident)
        lp = pt.train_epoch(clean, 16, step, noisy=noisy, shuffle_seed=step,
                            device_resident=device_resident)
        assert abs(lp - lj) <= 1e-5 * abs(lj), (step, lp, lj)
    ref = ckpt.from_numpy_tree(_np_tree(jt.params), _np_tree(jt.state))
    got = pt.model.state_dict()
    assert set(ref) == set(got)
    for k, v in ref.items():
        assert _rel(got[k].numpy(), v.numpy()) <= 1e-5, k


@pytest.mark.parametrize("source", ["gauss", "sdn", "camnlf"])
def test_noise_sources_follow_their_formulas(source):
    """The noise is the formula's sigma (ref:train_dncnn_noiseflow.py via
    JAX dncnn_trainer.py:110-125), from the draws the port made, times the
    generator's normals; the draws lie in their ranges."""
    rows = [(2, 100.0, 0.000479, 2e-6), (3, 800.0, 0.003696, 2e-6)]
    t = tr.DnCNNTrainer(depth=DEPTH, filters=FILTERS, noise_source=source,
                        cam_iso_rows=rows, device="cpu")
    clean, _ = _images(4, seed=6)
    clean = torch.as_tensor(clean)
    rng = np.random.default_rng(3)
    for _ in range(3):
        p = t._noise_params(rng)
        gen = torch.Generator().manual_seed(11)
        normals = torch.randn(clean.shape, generator=torch.Generator().manual_seed(11))
        noise = t._make_noise(clean, p, gen)
        if source == "gauss":
            sig = torch.full_like(clean, p["sig"])
            assert tr.MIN_EST_SIGMA / 255 <= p["sig"] <= tr.MAX_EST_SIGMA / 255
        elif source == "sdn":
            sig = torch.sqrt(p["b1"] * clean + p["b2"])
            assert tr.MIN_CAM_NLF[0] <= p["b1"] <= tr.MAX_CAM_NLF[0]
            assert tr.MIN_CAM_NLF[1] <= p["b2"] <= tr.MAX_CAM_NLF[1]
        else:
            assert p["row"] in rows
            sig = torch.sqrt(p["row"][2] * clean + p["row"][3])
        np.testing.assert_allclose(noise.numpy(), (sig * normals).numpy(), rtol=1e-6, atol=0)
    # over many draws every row is chosen
    assert source != "camnlf" or {t._noise_params(rng)["row"] for _ in range(50)} == set(rows)


@pytest.fixture(scope="module")
def flagship():
    cfg = jax_load_hps(os.path.join(MODEL, "hps.txt"))
    jflow = JaxFlow((32, 32, 4), cfg)
    p0, s0 = jflow.init(jax.random.PRNGKey(0))
    params, state, _, _ = jax_ckpt.load_checkpoint(BEST, p0, s0, None)
    flow = NoiseFlow((32, 32, 4), load_hps(os.path.join(MODEL, "hps.txt")), device="cpu")
    ckpt.load_checkpoint(BEST, flow)
    return jflow, params, state, flow


def test_nf_source_matches_jax_flow_on_shared_eps(flagship):
    """The NF source's noise (the fused sampler's RNG mode, one BN group of
    the batch) against JAX's NoiseFlow forward with batch statistics on the
    seed's normals, which is what JAX's flow.sample(train=True) computes; b =
    16 on the flagship. Within 1e-4 (tests/test_torch_flow.py's tolerance
    for the forward; observed 3.1e-7 abs on noise of sd 0.055)."""
    jflow, params, state, flow = flagship
    rows = [(3, 1600.0, 0.008211, 2e-6)]
    t = tr.DnCNNTrainer(depth=DEPTH, filters=FILTERS, noise_source="nf", noise_flow=flow,
                        cam_iso_rows=rows, device="cpu")
    clean, _ = _images(16, seed=8)
    p = {"row": rows[0], "seed": 99, "sig": 0.01, "gauss": False}
    got = t._make_noise(torch.as_tensor(clean), p, torch.Generator().manual_seed(0))
    eps = fs.rng_normals_reference(99, 16).numpy()
    cond = {"clean": jnp.asarray(clean), "nlf0": jnp.zeros(16), "nlf1": jnp.zeros(16),
            "iso": jnp.full((16,), 1600.0), "cam": jnp.full((16,), 3.0)}
    ref = np.asarray(jflow.forward(params, state, jnp.asarray(eps), cond, True))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    # the coin's other face: the Gaussian augmentation, drawn as gauss is
    gen = torch.Generator().manual_seed(0)
    gauss = t._make_noise(torch.as_tensor(clean), dict(p, gauss=True), gen)
    normals = torch.randn(clean.shape, generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(gauss.numpy(), (0.01 * normals).numpy(), rtol=1e-6)
    draws = [t._noise_params(np.random.default_rng(s)) for s in range(40)]
    assert {d["gauss"] for d in draws} == {True, False}
    assert len({d["seed"] for d in draws}) == 40
    with pytest.raises(ValueError, match="noise_flow"):
        tr.DnCNNTrainer(depth=DEPTH, filters=FILTERS, noise_source="nf", device="cpu")


# ---------------------------------------------------------------------------
# data, metrics, checkpoints, schedule
# ---------------------------------------------------------------------------

def test_data_matches_jax():
    img = np.random.default_rng(0).uniform(size=(1, 200, 170, 4)).astype(np.float32)
    np.testing.assert_array_equal(dncnn_data.tile_image(img), jax_data.tile_image(img))
    got = dncnn_data.synthetic_dncnn_data(n_images=2, h=128, w=128, batch_size=16)
    ref = jax_data.synthetic_dncnn_data(n_images=2, h=128, w=128, batch_size=16)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[2], ref[2])
    assert got[1] == ref[1]
    fp = "/d/0001_001_S6_00100_00060_3200_L/0001_GT_RAW_010.MAT"
    assert dncnn_data.cam_iso_from_path(fp) == jax_data.cam_iso_from_path(fp) == "S6_00100"


def test_metrics_match_jax():
    rng = np.random.default_rng(2)
    a = rng.uniform(size=(2, 3, 64, 64))
    b = np.clip(a + 0.05 * rng.standard_normal(a.shape), 0, 1)
    assert image_metrics.psnr(a, b) == jax_metrics.psnr(a, b)
    assert image_metrics.ssim(a[0, 0], b[0, 0]) == jax_metrics.ssim(a[0, 0], b[0, 0])
    got, ref = image_metrics.mean_psnr_blocks(a, b), jax_metrics.mean_psnr_blocks(a, b)
    assert got[0] == ref[0] and np.array_equal(got[1], ref[1])
    assert image_metrics.mean_ssim_blocks(a, b) == jax_metrics.mean_ssim_blocks(a, b)


def test_lr_schedule_matches_jax():
    for epoch in (1, 30, 31, 60, 61):
        assert tr.lr_schedule(epoch, 1e-3) == jax_tr.lr_schedule(epoch, 1e-3)


def test_stage_key_detects_change():
    a = np.random.default_rng(0).uniform(size=(16, 8, 8)).astype(np.float32)
    assert tr._stage_key(a) == tr._stage_key(a.copy()) == jax_tr._stage_key(a)
    b = a.copy()
    b[0, 0, 0] += 1.0
    assert tr._stage_key(b) != tr._stage_key(a) and tr._stage_key(None) is None


def test_checkpoints_cross_load(tmp_path):
    """A checkpoint that JAX's fit writes loads into the port and denoises
    to JAX's output; one that the port's fit writes loads into JAX (the
    optimizer slots of the other layout are skipped with a warning, as each
    loader does). Eval-mode forward, float32: within 1e-5 (observed 9.5e-7)."""
    clean, noisy = _images(16, seed=9)
    jt, pt = _pair("real")
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jt.fit(clean, jdir, epochs=1, batch_size=16, noisy=noisy, verbose=False)
    pt.fit(clean, pdir, epochs=1, batch_size=16, noisy=noisy, verbose=False)
    assert sorted(os.listdir(pdir)) == sorted(os.listdir(jdir)) == ["log.csv",
                                                                  "model.ckpt-001.npz"]
    with open(os.path.join(pdir, "log.csv")) as f:
        assert f.read().startswith("1,")

    port_from_jax = tr.DnCNNTrainer(depth=DEPTH, filters=FILTERS, device="cpu")
    assert port_from_jax.load(jdir) == 1
    jax_from_port = jax_tr.DnCNNTrainer(depth=DEPTH, filters=FILTERS, mesh=make_mesh(1))
    assert jax_from_port.load(pdir) == 1
    _, test = _images(4, seed=10)
    np.testing.assert_allclose(port_from_jax.denoise(test), jt.denoise(test), rtol=0, atol=1e-5)
    np.testing.assert_allclose(jax_from_port.denoise(test), pt.denoise(test), rtol=0, atol=1e-5)
    # load(epoch) looks for model_{epoch:03d}.npz, which fit never writes, and
    # so loads the latest, as JAX does
    assert port_from_jax.load(jdir, epoch=7) == 1
    with pytest.raises(FileNotFoundError):
        port_from_jax.load(str(tmp_path / "none"))


# ---------------------------------------------------------------------------
# CLIs
# ---------------------------------------------------------------------------

def test_dncnn_cli_end_to_end_on_cpu(tmp_path):
    from noise_flow_tpu_torch.cli.test_dncnn import main as test_main
    from noise_flow_tpu_torch.cli.train_dncnn import main as train_main

    save_dir = str(tmp_path / "DnCNN_Gauss")
    rc = train_main(["--model", "DnCNN_Gauss", "--synthetic_data", "2",
                     "--max_epoch", "1", "--batch_size", "16", "--depth", "5",
                     "--filters", "8", "--save_dir", save_dir, "--device", "cpu",
                     "--cam_iso_nlf", os.path.join(ROOT, "cam_iso_nlf.txt")])
    assert rc == 0
    for name in ("log.csv", "model.ckpt-001.npz", "max_epc_psnr.txt"):
        assert os.path.exists(os.path.join(save_dir, name)), name
    result_dir = str(tmp_path / "results")
    rc = test_main(["--model_name", "DnCNN_Gauss", "--model_dir", save_dir,
                    "--result_dir", result_dir, "--depth", "5", "--filters", "8",
                    "--synthetic", "--device", "cpu"])
    assert rc == 0
    out = os.path.join(result_dir, "DnCNN_Gauss", "SIDD")
    for name in ("psnr.txt", "ssim.txt", "psnrs.mat", "epc_psnr.txt"):
        assert os.path.exists(os.path.join(out, name)), name
    assert np.isfinite(float(np.loadtxt(os.path.join(out, "psnr.txt"))))
    assert np.isfinite(float(np.loadtxt(os.path.join(out, "ssim.txt"))))


def test_dncnn_cli_refuses_a_mesh():
    from noise_flow_tpu_torch.cli.train_dncnn import main as train_main, noise_source_from_name

    with pytest.raises(ValueError, match="queue 1, item 8"):
        train_main(["--model", "DnCNN_Gauss", "--synthetic_data", "2", "--mesh", "2",
                    "--device", "cpu"])
    assert [noise_source_from_name(f"DnCNN_{t}") for t in ("NF", "Gauss", "SDN", "CamNLF",
                                                           "Real")] == \
        ["nf", "gauss", "sdn", "camnlf", "real"]
    with pytest.raises(ValueError):
        noise_source_from_name("DnCNN")
