"""noise_flow_tpu_torch's copied numpy modules (config, data, metrics) against
the JAX package's, and the port's guards: no JAX import anywhere in the port
or in chip_smoke.py, and no silent CPU fallback at the entry points."""

import ast
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from noise_flow_tpu import config as jconfig
from noise_flow_tpu.data import isp as jisp
from noise_flow_tpu.data import sidd as jsidd
from noise_flow_tpu.data import synthetic as jsyn
from noise_flow_tpu.utils import metrics as jmetrics
from noise_flow_tpu_torch import config
from noise_flow_tpu_torch.data import isp, sidd, synthetic
from noise_flow_tpu_torch.utils import metrics

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "noise_flow_tpu_torch")
MODEL = os.path.join(ROOT, "experiments", "sidd", "prod_exact_150")


def _fields(cfg):
    return dataclasses.asdict(cfg)


def test_load_hps_flagship_matches_jax():
    path = os.path.join(MODEL, "hps.txt")
    got, ref = config.load_hps(path), jconfig.load_hps(path)
    assert _fields(got) == _fields(ref)
    assert got.arch == "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc"
    assert got.arch_tokens() == ref.arch_tokens()


@pytest.mark.parametrize("overrides", [
    {}, {"arch": "sdn5|unc|gain4|unc", "width": 8}, {"arch": "sdn|gain|unc"},
    {"patch_height": 16, "flow_permutation": 0, "decomp": "NONE"},
])
def test_default_config_matches_jax(overrides):
    assert _fields(config.default_config(**overrides)) == \
        _fields(jconfig.default_config(**overrides))


def test_save_hps_round_trips_through_jax(tmp_path):
    cfg = config.default_config(arch="sdn5|unc|gain4|unc", width=8)
    path = str(tmp_path / "hps.txt")
    config.save_hps(path, cfg, ["sdn_0", "unc_1"], 123, extra={"note": "x"})
    assert _fields(jconfig.load_hps(path)) == _fields(cfg)
    assert _fields(config.load_hps(path)) == _fields(cfg)


def test_unknown_arch_token_raises():
    with pytest.raises(ValueError, match="unknown arch token"):
        config.default_config(arch="sdn5|bogus").arch_tokens()


# ---------------------------------------------------------------------------
# copied numpy data and metrics modules
# ---------------------------------------------------------------------------

def test_pack_unpack_raw_match_jax():
    raw = np.random.default_rng(0).uniform(0, 1, (12, 10)).astype(np.float32)
    packed = sidd.pack_raw(raw)
    np.testing.assert_array_equal(packed, jsidd.pack_raw(raw))
    np.testing.assert_array_equal(sidd.unpack_raw(packed), jsidd.unpack_raw(packed))
    np.testing.assert_array_equal(sidd.unpack_raw(packed), raw)
    name = "0001_001_S6_00100_00060_3200_L"
    assert sidd.parse_scene_dirname(name) == jsidd.parse_scene_dirname(name)


def test_synthetic_samples_match_jax():
    got = synthetic.make_synthetic_samples(2, 32, 48, isos=[100, 1600], seed=4)
    ref = jsyn.make_synthetic_samples(2, 32, 48, isos=[100, 1600], seed=4)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


def test_isp_render_matches_jax():
    rng = np.random.default_rng(1)
    bayer = rng.uniform(0, 1, (16, 16)).astype(np.float32)
    wb = np.array([[2.0, 1.0, 1.5]])
    cst = np.eye(3)
    got = isp.process_sidd_image(bayer, [[1, 2], [2, 3]], wb, cst)
    ref = jisp.process_sidd_image(bayer, [[1, 2], [2, 3]], wb, cst)
    np.testing.assert_array_equal(got, ref)


def test_kld_functions_match_jax():
    rng = np.random.default_rng(2)
    p_data = 0.5 + 0.1 * rng.standard_normal(5000)
    q_data = 0.5 + 0.12 * rng.standard_normal(5000)
    np.testing.assert_array_equal(metrics.kl_div_3_data(p_data, q_data),
                                  jmetrics.kl_div_3_data(p_data, q_data))
    p, _ = metrics.get_histogram(p_data, metrics.NOISE_BIN_EDGES)
    q, _ = jmetrics.get_histogram(q_data, jmetrics.NOISE_BIN_EDGES)
    for fn in ("kl_div_forward", "kl_div_inverse", "kl_div_sym", "kl_div_3"):
        np.testing.assert_array_equal(getattr(metrics, fn)(p, q),
                                      getattr(jmetrics, fn)(p, q), err_msg=fn)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def _imported_modules(path):
    """Top-level names of every module that the file imports, anywhere in it."""
    tree = ast.parse(open(path).read(), filename=path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
    return {n.split(".")[0] for n in names}


def _port_sources():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_port_and_chip_smoke_never_name_jax():
    files = list(_port_sources()) + [os.path.join(ROOT, "chip_smoke.py")]
    assert len(files) > 30
    for path in files:
        bad = _imported_modules(path) & {"jax", "jaxlib", "noise_flow_tpu"}
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_port_imports_without_jax():
    """Every module of the port imports in a process where jax and the JAX
    package cannot be imported."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['jaxlib'] = None\n"
        "sys.modules['noise_flow_tpu'] = None\n"
        "import noise_flow_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 32


def test_entry_points_default_to_the_card():
    """Called without ``device``, an entry point asks for CUDA and raises
    where there is none, rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    from noise_flow_tpu_torch.cli.sample import main
    from noise_flow_tpu_torch.cli.train import main as train_main
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper

    with pytest.raises(RuntimeError, match="cuda"):
        NoiseFlowWrapper(MODEL)
    with pytest.raises(RuntimeError, match="cuda"):
        NoiseFlow((32, 32, 4), config.default_config())
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--model_path", MODEL, "--synthetic", "--n_pat", "1"])
    with pytest.raises(RuntimeError, match="cuda"):
        train_main(["--synthetic_data", "1", "--epochs", "1", "--logdir", "unused"])


def test_train_kernels_never_fall_back_for_card_tensors():
    """The fused train wrappers take their plain versions only for CPU
    tensors; any other device goes to the kernel or raises."""
    from noise_flow_tpu_torch.ops import fused_train as ft

    x = torch.zeros((2, 32, 32, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ft.fused_train_step(x, x, x, x, x, x, x, [], 2)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ft.fused_segment_forward(x, x, x, x, [])


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
