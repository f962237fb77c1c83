"""The port's DnCNN four-source comparison (``cli/dncnn_comparison.py``)
against the JAX script ``experiments/dncnn/run_comparison.py``, imported
from its path as it is, on a corpus that the port's ``cli.make_sidd_scale``
writes at a small frame: 4 train and all 22 test scene instances, 256x512
Bayer, so that the test split holds the 44 image tuples that n_im = 40
needs. Blocks are 32x32. The DnCNN is the JAX script's (depth 9, 32 filters),
but where a trajectory is held to JAX's: there it is test_torch_dncnn.py's
(depth 4, 8 filters), since Adam's first steps (lr * g / |g|) carry a
float32 rounding in a near-zero gradient of the wide net into whole steps
of its weights.
"""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch
from scipy.io import loadmat

from noise_flow_tpu.cli import test_dncnn as jax_test_dncnn
from noise_flow_tpu.parallel.mesh import make_mesh
from noise_flow_tpu.training import dncnn_trainer as jax_tr
from noise_flow_tpu_torch.cli import dncnn_comparison as dc
from noise_flow_tpu_torch.cli import make_sidd_scale
from noise_flow_tpu_torch.cli.test_dncnn import load_validation_blocks
from noise_flow_tpu_torch.data.dncnn_data import load_dncnn_data
from noise_flow_tpu_torch.data.sidd import TRAIN_INSTANCE_IDS
from noise_flow_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE = 32
DEPTH, FILTERS = 4, 8      # test_torch_dncnn.py's, where its trajectory test holds
KEYS = ("ValidationNoisyBlocksRaw", "ValidationGtBlocksRaw")


def _jax_script():
    path = os.path.join(ROOT, "experiments", "dncnn", "run_comparison.py")
    spec = importlib.util.spec_from_file_location("run_comparison", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(data_root, val_dir): the corpus and the port's blocks of SIZE."""
    work = tmp_path_factory.mktemp("comparison")
    root = str(work / "SIDD_Medium_Raw_synth" / "Data")
    assert make_sidd_scale.main(["--root", root, "--n_train", "4", "--n_test", "22",
                                 "--height", "256", "--width", "512",
                                 "--mat_version", "v5"]) == 0
    val = str(work / "val_port")
    dc.build_validation_blocks(root, val, size=SIZE)
    return root, val


def test_validation_blocks_match_the_jax_script_bit_for_bit(corpus, tmp_path):
    root, val = corpus
    jax_val = str(tmp_path / "val_jax")
    _jax_script().build_validation_blocks(root, jax_val, size=SIZE)
    for name, key in zip(("ValidationNoisyBlocksRaw.mat", "ValidationGtBlocksRaw.mat"), KEYS):
        got, ref = (loadmat(os.path.join(d, name))[key] for d in (val, jax_val))
        assert got.shape == (40, 8, SIZE, SIZE) and got.dtype == np.float32
        np.testing.assert_array_equal(got, ref)
    noisy, gt = load_validation_blocks(val)
    assert noisy.shape == gt.shape == (20, 8, SIZE, SIZE)
    assert not np.array_equal(noisy, gt)


def test_rows_are_the_jax_scripts_in_order(corpus, tmp_path, monkeypatch):
    """The JAX script's main, stopped where it builds its first trainer,
    hands that trainer its rows: the port's are the same, in order (sorted
    table items; cli.train_dncnn keeps the file's order)."""
    root, val = corpus
    seen = {}

    class Stop(Exception):
        pass

    def trainer(**kw):
        seen.update(kw)
        raise Stop

    from noise_flow_tpu.utils import compilation_cache
    monkeypatch.setattr(compilation_cache, "enable_compilation_cache", lambda *a: "")
    monkeypatch.setattr(jax_tr, "DnCNNTrainer", trainer)
    with pytest.raises(Stop):
        _jax_script().main(["--data_root", root, "--val_dir", val, "--out", str(tmp_path),
                            "--sources", "gauss", "--batch", "8"])
    assert seen["noise_source"] == "gauss"
    assert dc.comparison_rows() == seen["cam_iso_rows"]
    assert len(seen["cam_iso_rows"]) == 15


# The real source through the port's make_trainer and run_source against
# JAX's DnCNNTrainer.fit and evaluate_model from the same initial weights:
# 1 epoch of 2 Adam steps at b = 16. test_trainer_trajectory_matches_jax
# holds the weights within 1e-5 normwise after such steps, so the denoised
# blocks agree within about 1e-5 of their norm (checked here at 1e-5), and
# PSNR, whose first-order change is 20 / ln 10 * |d res| / |res - ref|,
# within 20 / ln 10 * 1e-5 * |res| / |res - ref| dB; SSIM, a ratio of local
# moments of res, within 1e-4 (ten times the relative change, as both
# terms of each ratio move).
def test_real_source_matches_jax(corpus, tmp_path):
    root, val = corpus
    noisy_mat, ref_mat = load_validation_blocks(val)
    clean, _, noisy = load_dncnn_data(root, cam_iso_nlf_path=dc.CAM_ISO_NLF,
                                      with_noisy=True, batch_size=16,
                                      instance_ids=TRAIN_INSTANCE_IDS)
    assert clean.shape == (32, 32, 32, 4)
    rows = dc.comparison_rows()
    jt = jax_tr.DnCNNTrainer(noise_source="real", cam_iso_rows=rows, lr=1e-3,
                             mesh=make_mesh(1), depth=DEPTH, filters=FILTERS)
    pt = dc.make_trainer("real", rows, "cpu", depth=DEPTH, filters=FILTERS)
    params, state = (jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), t)
                     for t in (jt.params, jt.state))
    pt.model.load_state_dict(ckpt.from_numpy_tree(params, state))

    jt.fit(clean, str(tmp_path / "jax"), epochs=1, batch_size=16, noisy=noisy,
           save_every=1, verbose=False)
    j_psnr, _, j_ssim, j_res = jax_test_dncnn.evaluate_model(jt, noisy_mat, ref_mat)
    got = dc.run_source(pt, clean, noisy, noisy_mat, ref_mat, str(tmp_path / "port"),
                        epochs=1, batch=16)
    _, _, _, p_res = dc.evaluate_model(pt, noisy_mat, ref_mat)

    assert got["steps"] == 2 and got["sampler_launches"] == 0
    assert np.linalg.norm(p_res - j_res) <= 1e-5 * np.linalg.norm(j_res)
    psnr_tol = 20 / np.log(10) * 1e-5 * np.linalg.norm(j_res) / np.linalg.norm(j_res - ref_mat)
    assert abs(got["psnr"] - j_psnr) <= psnr_tol, (got["psnr"], j_psnr, psnr_tol)
    assert abs(got["ssim"] - j_ssim) <= 1e-4, (got["ssim"], j_ssim)
    assert sorted(os.listdir(str(tmp_path / "port"))) == sorted(os.listdir(str(tmp_path / "jax"))) \
        == ["log.csv", "model.ckpt-001.npz"]


def test_main_runs_every_source_on_the_cpu(corpus, tmp_path):
    """All four sources for one epoch, the NF source through the sampler's
    plain version; results.json carries the JAX script's keys, and
    cli.flagship's report puts it beside the record."""
    root, val = corpus
    out = str(tmp_path / "dncnn")     # where cli.flagship's dncnn step writes
    assert dc.main(["--device", "cpu", "--epochs", "1", "--max_images", "2", "--batch", "8",
                    "--data_root", root, "--val_dir", val, "--out", out]) == 0
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)
    assert {"epochs", "batch", "n_train_patches", "val_blocks", "results"} <= set(res)
    assert res["device"] == "cpu" and res["n_train_patches"] == 16
    assert res["val_blocks"] == [20, 8, SIZE, SIZE]
    assert set(res["results"]) == {"gauss", "camnlf", "nf", "real", "noisy_input"}
    for src in dc.SOURCES:
        r = res["results"][src]
        assert {"psnr", "ssim", "train_s"} <= set(r)
        assert np.isfinite(r["psnr"]) and np.isfinite(r["ssim"])
        assert r["steps"] == 2 and r["sampler_launches"] == 0   # no kernel on the CPU
        assert os.path.exists(os.path.join(out, f"DnCNN_{src}", "model.ckpt-001.npz"))
    noisy_mat, ref_mat = load_validation_blocks(val)
    mse = np.mean((noisy_mat.astype(np.float64) - ref_mat) ** 2, axis=(2, 3))
    assert res["results"]["noisy_input"]["psnr"] == pytest.approx(
        np.mean(10 * np.log10(1 / mse)), rel=1e-12)

    from noise_flow_tpu_torch.cli import flagship
    assert flagship.main(["--work", str(tmp_path), "--steps", "report", "--device", "cpu"]) == 0
    with open(str(tmp_path / "flagship.json")) as f:
        rep = json.load(f)["dncnn"]
    assert rep["setup"]["val_blocks"] == [20, 8, SIZE, SIZE] and rep["device"] == "cpu"
    assert rep["jax_setup"] == {"epochs": 45, "batch": 128, "n_train_patches": 54016,
                                "val_blocks": [20, 8, 256, 256]}
    assert rep["jax_nf_above_gauss"] == {"psnr": True, "ssim": True}
    nf = rep["rows"]["nf"]
    assert nf["psnr_minus_jax"] == nf["psnr"] - nf["jax_psnr"]
    assert "train_rows" not in json.load(open(str(tmp_path / "flagship.json")))


def test_main_without_a_card_raises(corpus, tmp_path, monkeypatch):
    """--device defaults to cuda: with no card present it raises before it
    reads anything, and never runs on the CPU."""
    root, val = corpus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        dc.main(["--epochs", "1", "--data_root", root, "--val_dir", val,
                 "--out", str(tmp_path / "out")])
    assert not os.path.exists(str(tmp_path / "out"))
