"""The port's flagship data layer against JAX's: the SIDD .MAT writer, the
SIDD-scale generator and the two-pass initialization.

Every array is compared bit for bit: both writers run the same numpy
expressions on the same seeds, and both readers decode the same files.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from noise_flow_tpu.data import initialization as jinit
from noise_flow_tpu.data import mat_fixtures as jmf
from noise_flow_tpu.data import sidd as jsidd
from noise_flow_tpu.data.synthetic import make_synthetic_samples
from noise_flow_tpu_torch.cli import make_sidd_scale as tgen
from noise_flow_tpu_torch.data import initialization as tinit
from noise_flow_tpu_torch.data import mat_fixtures as tmf
from noise_flow_tpu_torch.data import sidd as tsidd

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B1, B2 = 0.00123, 4.5e-6
KINDS = ("NOISY", "GT", "VARIANCE", "METADATA")


def _write(mf, root, version):
    return mf.write_sidd_scene(str(root), 4, cam="N6", iso=1600, h=128, w=128,
                               beta1=B1, beta2=B2, seed=7, n_images=2, first_idx=10,
                               mat_version=version)


def _tuples(sidd, root):
    return sidd.sidd_filename_tuples(str(root), "train", 10, 12)[0]


@pytest.fixture(scope="module", params=["v7.3", "v5"])
def two_writers(request, tmp_path_factory):
    """One scene from one seed written by each package, in one format."""
    tag = request.param.replace(".", "")
    jroot = tmp_path_factory.mktemp(f"SIDD_Medium_jax_{tag}") / "Data"
    troot = tmp_path_factory.mktemp(f"SIDD_Medium_torch_{tag}") / "Data"
    jdir, tdir = _write(jmf, jroot, request.param), _write(tmf, troot, request.param)
    return jroot, troot, jdir, tdir


def test_writer_layout_matches_jax(two_writers):
    jroot, troot, jdir, tdir = two_writers
    assert os.path.basename(jdir) == os.path.basename(tdir)
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    assert len(os.listdir(tdir)) == 2 * len(KINDS)


@pytest.mark.parametrize("kind", KINDS[:3])
def test_writer_arrays_bit_equal_across_readers(two_writers, kind):
    """Each image file decodes to the same bits: the port's reader on JAX's
    file, JAX's reader on the port's, and both on their own."""
    jroot, troot, _, _ = two_writers
    col = KINDS.index(kind)
    for jt, tt in zip(_tuples(jsidd, jroot), _tuples(tsidd, troot)):
        ref = jsidd._read_mat_array(jt[col])
        assert ref.dtype == np.float32 and ref.shape == (128, 128)
        for got in (tsidd._read_mat_array(jt[col]), jsidd._read_mat_array(tt[col]),
                    tsidd._read_mat_array(tt[col])):
            assert got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


def test_writer_metadata_nlf_equal(two_writers):
    jroot, troot, _, _ = two_writers
    for jt, tt in zip(_tuples(jsidd, jroot), _tuples(tsidd, troot)):
        nlf = jsidd.load_metadata_nlf(jt[3])
        assert nlf == pytest.approx((B1, B2), rel=1e-12)
        assert tsidd.load_metadata_nlf(jt[3]) == nlf
        assert jsidd.load_metadata_nlf(tt[3]) == nlf
        assert tsidd.load_metadata_nlf(tt[3]) == nlf


def test_image_tuples_equal_across_readers(two_writers):
    """load_image_tuple: the port on JAX's files equals JAX on the port's."""
    jroot, troot, _, _ = two_writers
    for jt, tt in zip(_tuples(jsidd, jroot), _tuples(tsidd, troot)):
        a, b = tsidd.load_image_tuple(jt), jsidd.load_image_tuple(tt)
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k
        assert a["noise"].shape == (1, 64, 64, 4) and a["iso"] == 1600.0


def _load_jax_generator():
    spec = importlib.util.spec_from_file_location(
        "jax_make_sidd_scale", os.path.join(ROOT, "experiments", "sidd", "make_sidd_scale.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scene_files(root):
    return {os.path.join(d, f) for d in os.listdir(root) for f in os.listdir(os.path.join(root, d))}


def test_generator_matches_jax(tmp_path):
    """The port's generator and JAX's script write the same scenes (ids,
    round-robin cells, seeds) with bit-equal arrays; a rerun skips them."""
    args = ["--n_train", "2", "--n_test", "1", "--height", "64", "--width", "96"]
    jroot = str(tmp_path / "jax" / "SIDD_Medium_Raw" / "Data")
    troot = str(tmp_path / "torch" / "SIDD_Medium_Raw" / "Data")
    assert _load_jax_generator().main(args + ["--root", jroot]) == 0
    assert tgen.main(args + ["--root", troot]) == 0
    files = _scene_files(troot)
    assert files == _scene_files(jroot)
    assert len(files) == 3 * 2 * len(KINDS)
    for f in sorted(files):
        if "METADATA" in f:
            assert (tsidd.load_metadata_nlf(os.path.join(troot, f))
                    == jsidd.load_metadata_nlf(os.path.join(jroot, f)))
        else:
            np.testing.assert_array_equal(tsidd._read_mat_array(os.path.join(troot, f)),
                                          jsidd._read_mat_array(os.path.join(jroot, f)))
    before = {f: os.path.getmtime(os.path.join(troot, f)) for f in files}
    assert tgen.main(args + ["--root", troot]) == 0
    assert before == {f: os.path.getmtime(os.path.join(troot, f)) for f in files}


def test_generator_v5_matches_v73(tmp_path):
    """--mat_version v5 writes the same arrays in MATLAB v5."""
    args = ["--n_train", "1", "--n_test", "0", "--height", "64", "--width", "96"]
    r5 = str(tmp_path / "v5" / "SIDD_Medium_Raw" / "Data")
    r73 = str(tmp_path / "v73" / "SIDD_Medium_Raw" / "Data")
    assert tgen.main(args + ["--root", r5, "--mat_version", "v5"]) == 0
    assert tgen.main(args + ["--root", r73]) == 0
    for f in sorted(_scene_files(r5)):
        if "METADATA" in f:
            continue
        with open(os.path.join(r5, f), "rb") as fh:
            assert not fh.read(8).startswith(b"\x89HDF")
        np.testing.assert_array_equal(tsidd._read_mat_array(os.path.join(r5, f)),
                                      tsidd._read_mat_array(os.path.join(r73, f)))


def test_generator_v73_without_h5py_names_the_flag(tmp_path, monkeypatch):
    """Without h5py, v7.3 raises naming --mat_version and writes nothing."""
    monkeypatch.setitem(__import__("sys").modules, "h5py", None)
    root = tmp_path / "SIDD_Medium_Raw" / "Data"
    with pytest.raises(SystemExit, match="--mat_version v5"):
        tgen.main(["--n_train", "1", "--n_test", "0", "--height", "64", "--width", "96",
                   "--root", str(root)])
    assert not root.exists()


@pytest.mark.parametrize("n,parts", [(10, 3), (8, 4), (23, 7), (2, 5)])
def test_divide_parts_matches_jax(n, parts):
    assert tinit.divide_parts(n, parts) == jinit.divide_parts(n, parts)
    assert sum(tinit.divide_parts(n, parts)) == n


def test_initialization_matches_jax_and_caches(tmp_path):
    """Stats and both baselines equal JAX's; the cache is written and a
    second call reads it (mutated to prove the load path)."""
    tr_s = make_synthetic_samples(3, 64, 64, iso=800, seed=0)
    ts_s = make_synthetic_samples(2, 64, 64, iso=800, seed=9)
    jtr, jts, jstats, jg, js = jinit.initialize_data_stats_baselines(tr_s, ts_s, 16, 16, 16)
    logdir = str(tmp_path)
    tr, ts, stats, g, s = tinit.initialize_data_stats_baselines(tr_s, ts_s, 16, 16, 16,
                                                                 logdir=logdir)
    assert (len(tr), len(ts)) == (len(jtr), len(jts)) == (48, 32)
    np.testing.assert_array_equal(tr.x, jtr.x)
    np.testing.assert_array_equal(ts.y, jts.y)
    assert stats == jstats
    assert (g, s) == (jg, js)
    assert s < g
    cache = os.path.join(logdir, "pat_stats.npy")
    blob = np.load(cache, allow_pickle=True).item()
    assert blob["stats"] == stats and blob["nll_sdn"] == s
    blob["nll_gauss"] = -12345.0
    np.save(cache, blob)
    _, _, stats2, g2, s2 = tinit.initialize_data_stats_baselines(tr_s, ts_s, 16, 16, 16,
                                                                 logdir=logdir)
    assert (g2, s2) == (-12345.0, s) and stats2 == stats
