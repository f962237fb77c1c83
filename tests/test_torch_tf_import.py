"""noise_flow_tpu_torch.utils.tf_import and the wrapper's TF-checkpoint fallback,
against the JAX package's importer, on the CPU.

The published TF checkpoint is not in the repo, so this file writes a
synthetic one: a seeded JAX init of the published arch at width 4 (the
flagship's hps.txt), moved off its init, loaded into a port flow,
exported under the reference's variable names by the port's
``export_reference_variables`` (the mapping inverted) and saved as a
TensorBundle with ``tf.raw_ops.SaveV2``. Both importers read it back.
Needs TensorFlow; skips without it.
"""

import os
import shutil

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from noise_flow_tpu_torch.config import load_hps  # noqa: E402
from noise_flow_tpu_torch.models.flow import NoiseFlow  # noqa: E402
from noise_flow_tpu_torch.utils import checkpoint as ckpt  # noqa: E402
from noise_flow_tpu_torch.utils import tf_import as ti  # noqa: E402

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HPS = os.path.join(REPO, "experiments", "sidd", "prod_exact_150", "hps.txt")
NLL_RTOL = 1e-5


def _save_bundle(prefix, tf_vars):
    names = sorted(tf_vars)
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names, shape_and_slices=[""] * len(names),
                      tensors=[tf.constant(tf_vars[n]) for n in names])


def _batch(b=16, seed=0):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0.02, 0.6, (b, 32, 32, 4)).astype(np.float32)
    x = (rng.standard_normal(clean.shape) * np.sqrt(0.000479 * clean + 2e-6)).astype(np.float32)
    cond = {"clean": clean, "nlf0": np.full(b, 0.000479, np.float32),
            "nlf1": np.full(b, 2e-6, np.float32), "iso": np.full(b, 100.0, np.float32),
            "cam": np.full(b, 2.0, np.float32)}
    return x, cond


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    """A reference model directory holding only hps.txt and the synthetic
    TF checkpoint; the JAX flow, its moved init and its export."""
    import jax
    from noise_flow_tpu.config import load_hps as jax_load_hps
    from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow

    jflow = JaxFlow((32, 32, 4), jax_load_hps(HPS))
    params, state = jflow.init(jax.random.PRNGKey(7))
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32) + 0.05 * rng.standard_normal(np.shape(x)).astype(
            np.float32), params)
    state = jax.tree_util.tree_map(lambda x: np.asarray(x, np.float32), state)
    for lyr in state["layers"][0]:
        for bn in lyr.get("nn", {}).values():
            bn["mean"] = bn["mean"] + 0.1 * rng.standard_normal(4).astype(np.float32)
            bn["var"] = bn["var"] + np.abs(rng.standard_normal(4)).astype(np.float32)
    model = tmp_path_factory.mktemp("reference") / "NoiseFlow"
    os.makedirs(model / "ckpt")
    shutil.copy(HPS, model / "hps.txt")
    flow = _port_flow()
    flow.load_state_dict(ckpt.from_numpy_tree(params, state))
    tf_vars = ti.export_reference_variables(flow)
    _save_bundle(str(model / "ckpt" / "model.ckpt.best"), tf_vars)
    return {"dir": str(model), "jflow": jflow, "params": params, "state": state,
            "tf_vars": tf_vars}


def _port_flow():
    return NoiseFlow((32, 32, 4), load_hps(HPS), device="cpu")


def test_fill_triangular_ordering_and_round_trip():
    """The documented TFP fill_triangular examples, the strict-triangle
    round trip, and the JAX package's functions on the same vectors."""
    from noise_flow_tpu.utils import tf_import as jti

    v = np.arange(1.0, 7.0)
    np.testing.assert_array_equal(ti.fill_triangular_np(v, upper=False),
                                  np.array([[4, 0, 0], [6, 5, 0], [3, 2, 1]], np.float64))
    np.testing.assert_array_equal(ti.fill_triangular_np(v, upper=True),
                                  np.array([[1, 2, 3], [0, 5, 6], [0, 0, 4]], np.float64))
    rng = np.random.default_rng(0)
    for upper in (False, True):
        full = ti.tfp_vec_to_strict_tri(v.astype(np.float32), 4, upper)
        assert full.shape == (4, 4)
        np.testing.assert_array_equal(np.diag(full), np.zeros(4))
        np.testing.assert_array_equal(ti.strict_tri_to_tfp_vec(full, upper), v.astype(np.float32))
        for c in (2, 4, 8):
            vec = rng.standard_normal(c * (c - 1) // 2).astype(np.float32)
            np.testing.assert_array_equal(ti.tfp_vec_to_strict_tri(vec, c, upper),
                                          jti.tfp_vec_to_strict_tri(vec, c, upper))
            full = ti.tfp_vec_to_strict_tri(vec, c, upper)
            np.testing.assert_array_equal(ti.strict_tri_to_tfp_vec(full, upper), vec)
    with pytest.raises(ValueError, match="not triangular"):
        ti.fill_triangular_np(np.arange(5.0), upper=True)


def test_both_importers_give_the_same_weights_and_nll(bundle):
    """The synthetic TensorBundle through JAX's import_reference_checkpoint
    and the port's: bit-equal arrays, equal to the weights exported, and
    the same NLL on one batch in both packages."""
    import jax
    import jax.numpy as jnp
    from noise_flow_tpu.utils import tf_import as jti

    prefix = os.path.join(bundle["dir"], "ckpt", "model.ckpt.best")
    jflow = bundle["jflow"]
    p0, s0 = jflow.init(jax.random.PRNGKey(0))
    jp, js = jti.import_reference_checkpoint(prefix, jflow, p0, s0)
    flow = _port_flow()
    sd = ti.import_reference_checkpoint(prefix, flow)
    want = ckpt.from_numpy_tree(jp, js)
    assert set(sd) == set(want) == set(flow.state_dict())
    for k, v in want.items():
        assert torch.equal(sd[k], v), k
        assert torch.equal(flow.state_dict()[k], v), k
    exported = ckpt.from_numpy_tree(bundle["params"], bundle["state"])
    for k, v in exported.items():
        assert torch.equal(sd[k], v), k
    x, cond = _batch()
    with torch.no_grad():
        tcond = {k: torch.as_tensor(v) for k, v in cond.items()}
        nll_t, _, _ = flow.loss(torch.as_tensor(x), tcond, train=False)
    nll_j, _, _ = jflow.loss(jp, js, jnp.asarray(x), {k: jnp.asarray(v) for k, v in cond.items()},
                             train=False)
    np.testing.assert_allclose(float(nll_t), float(nll_j), rtol=NLL_RTOL)


def test_missing_and_leftover_variables_raise(bundle):
    """JAX's messages: a variable the flow needs and the checkpoint lacks,
    a checkpoint variable nothing consumed, a kind the mapping does not
    know; nothing is loaded then."""
    tf_vars = dict(bundle["tf_vars"])
    flow = _port_flow()
    before = {k: v.clone() for k, v in flow.state_dict().items()}
    with pytest.raises(ValueError, match="unmapped checkpoint variables"):
        ti.import_reference_variables({**tf_vars, "model/extra/W": np.zeros(3, np.float32)}, flow)
    gone = "model/real_nvp_conv_template_3/l_2/W"
    with pytest.raises(KeyError, match="checkpoint missing variable"):
        ti.import_reference_variables({k: v for k, v in tf_vars.items() if k != gone}, flow)
    assert all(torch.equal(before[k], v) for k, v in flow.state_dict().items())
    cfg = load_hps(HPS)
    cfg.arch = "sdn|unc"
    with pytest.raises(NotImplementedError, match="layer kind 'sdn'"):
        ti.import_reference_variables(tf_vars, NoiseFlow((32, 32, 4), cfg.finalize(),
                                                         device="cpu"))


def test_wrapper_loads_a_tf_only_model_dir(bundle):
    """NoiseFlowWrapper falls back to the TF checkpoint where the model
    directory holds no npz, as JAX's wrapper does: the same weights as
    JAX's wrapper on that directory, and noise that samples."""
    from noise_flow_tpu.wrapper import NoiseFlowWrapper as JaxWrapper
    from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper

    nf = NoiseFlowWrapper(bundle["dir"], device="cpu")
    jw = JaxWrapper(bundle["dir"])
    assert nf.epoch == jw.epoch == 0
    for k, v in ckpt.from_numpy_tree(jw.params, jw.state).items():
        assert torch.equal(nf.flow.state_dict()[k], v), k
    noise = nf.sample_noise_nf(np.full((4, 32, 32, 4), 0.1, np.float32), 0.0, 0.0, 100.0, 2.0)
    assert noise.shape == (4, 32, 32, 4) and np.isfinite(noise).all()
    empty = os.path.join(os.path.dirname(bundle["dir"]), "empty")
    os.makedirs(os.path.join(empty, "ckpt"), exist_ok=True)
    shutil.copy(HPS, os.path.join(empty, "hps.txt"))
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        NoiseFlowWrapper(empty, device="cpu")


def test_convert_reference_model_npz_loads_in_both_packages(bundle, tmp_path):
    """convert_reference_model writes hps.txt and ckpt/model.ckpt-best.npz;
    the JAX package and the port load it to the imported weights, bit for
    bit."""
    import jax
    from noise_flow_tpu.utils import checkpoint as jax_ckpt

    out = str(tmp_path / "converted")
    path = ti.convert_reference_model(bundle["dir"], out)
    assert path == os.path.join(out, "ckpt", "model.ckpt-best.npz")
    assert open(os.path.join(out, "hps.txt")).read() == open(HPS).read()
    flow = _port_flow()
    assert ckpt.load_checkpoint(path, flow) == 0
    want = ckpt.from_numpy_tree(bundle["params"], bundle["state"])
    for k, v in want.items():
        assert torch.equal(flow.state_dict()[k], v), k
    p0, s0 = bundle["jflow"].init(jax.random.PRNGKey(0))
    jp, js, _, epoch = jax_ckpt.load_checkpoint(path, p0, s0, None)
    assert epoch == 0
    for k, v in ckpt.from_numpy_tree(jp, js).items():
        assert torch.equal(want[k], v), k


def test_reading_without_tensorflow_raises_import_error(monkeypatch, bundle):
    """Where tensorflow cannot be imported (the card's machine), reading a
    TF checkpoint raises ImportError that says so, and nothing falls back."""
    import builtins

    real = builtins.__import__

    def no_tf(name, *a, **k):
        if name == "tensorflow" or name.startswith("tensorflow."):
            raise ImportError("No module named 'tensorflow'")
        return real(name, *a, **k)
    monkeypatch.setattr(builtins, "__import__", no_tf)
    with pytest.raises(ImportError, match="needs tensorflow"):
        ti.read_tf_checkpoint(os.path.join(bundle["dir"], "ckpt", "model.ckpt.best"))
