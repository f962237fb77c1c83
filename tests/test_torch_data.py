"""noise_flow_tpu_torch's data layer and metrics against the JAX package's,
on the CPU: PatchDataset batches, patch statistics and baselines, the npy
cache and one epoch of the native loader, histograms, the torch KLDs against
kldiv_batch_jax / marginal_kld_jax and the numpy KLD copies, the logger and
the phase timers."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_flow_tpu.data import cache as jcache
from noise_flow_tpu.data import histograms as jhist
from noise_flow_tpu.data import stats as jstats
from noise_flow_tpu.data.patches import PatchDataset as JaxPatchDataset
from noise_flow_tpu.data.synthetic import make_synthetic_samples
from noise_flow_tpu.utils import metrics as jmetrics
from noise_flow_tpu_torch.data import bootstrap, cache, histograms, stats
from noise_flow_tpu_torch.data.patches import PatchDataset
from noise_flow_tpu_torch.utils import metrics
from noise_flow_tpu_torch.utils.logger import ResultLogger, add_trace_level
from noise_flow_tpu_torch.utils.profiling import PhaseTimers

torch.set_num_threads(1)

SAMPLES = make_synthetic_samples(n_images=3, h=64, w=64, isos=[100, 800, 3200], seed=0)


def _assert_batches_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]), err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(shuffle=False), dict(shuffle=True, seed=3, drop_remainder=True),
    dict(batch_scalar_cond=True),
])
def test_patch_dataset_batches_match_jax(kw):
    for sampling, shuf in (("uniform", False), ("uniform", True), ("random", False)):
        got = PatchDataset(SAMPLES, 16, 10, sampling=sampling, seed=2, shuffle_patches=shuf)
        ref = JaxPatchDataset(SAMPLES, 16, 10, sampling=sampling, seed=2, shuffle_patches=shuf)
        assert len(got) == len(ref)
        gb, rb = list(got.batches(7, **kw)), list(ref.batches(7, **kw))
        assert len(gb) == len(rb)
        for a, b in zip(gb, rb):
            _assert_batches_equal(a, b)


def test_stats_and_baselines_match_jax():
    ds = PatchDataset(SAMPLES, 16, 16)
    assert stats.calc_pat_stats(ds.x, ds.y) == jstats.calc_pat_stats(ds.x, ds.y)
    got = stats.calc_baselines(ds.batches(8), 1e-3)
    ref = jstats.calc_baselines(ds.batches(8), 1e-3)
    assert got == ref and np.isfinite(got).all()
    assert stats.welford_merge(3, 1.0, 2.0, 5, 2.0, 1.0) == jstats.welford_merge(3, 1.0, 2.0, 5, 2.0, 1.0)
    assert stats.bpd(-9000.0, 1024.0, 4096) == jstats.bpd(-9000.0, 1024.0, 4096)


def test_cache_round_trip_matches_jax(tmp_path):
    cache.write_cache_from_samples(SAMPLES, str(tmp_path / "port"))
    jcache.write_cache_from_samples(SAMPLES, str(tmp_path / "jax"))
    got = cache.load_cached_samples(str(tmp_path / "port"))
    ref = jcache.load_cached_samples(str(tmp_path / "jax"))
    assert cache.read_index(str(tmp_path / "port")) == jcache.read_index(str(tmp_path / "jax"))
    for a, b in zip(got, ref):
        _assert_batches_equal(a, b)


@pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ compiler")
def test_native_loader_epoch_matches_jax_and_python(tmp_path):
    """One unshuffled epoch of the port's binding of native/libnfloader.so
    gives the JAX binding's batches and the Python PatchDataset's patches."""
    from noise_flow_tpu.data.native import NativePatchLoader as JaxLoader
    from noise_flow_tpu_torch.data.native import NativePatchLoader, ensure_built

    d = str(tmp_path)
    cache.write_cache_from_samples(SAMPLES, d)
    ensure_built()
    kw = dict(patch_size=16, batch_size=16, n_patches_per_image=16, n_threads=1,
              shuffle=False, seed=0)
    got, ref = list(NativePatchLoader(d, **kw)), list(JaxLoader(d, **kw))
    assert len(got) == len(ref) == 3
    for a, b in zip(got, ref):
        _assert_batches_equal(a, b)
    ds = PatchDataset(cache.load_cached_samples(d), 16, 16)
    np.testing.assert_array_equal(np.concatenate([mb["_x"] for mb in got]), ds.x)


def test_histograms_match_jax(tmp_path):
    got, ref = histograms.calc_hists(SAMPLES), jhist.calc_hists(SAMPLES)
    for k in ("noisy", "clean", "noise", "bin_edges", "bin_edges_noise"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    merged = histograms.merge_hists(got, got)
    assert merged["n_pix"] == 2 * got["n_pix"]
    histograms.save_hists(str(tmp_path), got, got)
    tr, _ = jhist.load_hists(str(tmp_path))
    np.testing.assert_array_equal(tr["noise"], got["noise"])


def test_bootstrap_never_downloads_by_default(tmp_path):
    assert not bootstrap.sidd_present(str(tmp_path))
    with pytest.raises(FileNotFoundError, match="SIDD_Medium_Raw not found"):
        bootstrap.check_download_sidd(str(tmp_path / "Data"))
    with pytest.raises(FileNotFoundError, match="missing"):
        bootstrap.check_download_validation_blocks(str(tmp_path))


def _noise(seed, b=12):
    rng = np.random.default_rng(seed)
    return [(s * rng.standard_normal((b, 32, 32, 4))).astype(np.float32)
            for s in (0.02, 0.03, 0.025, 0.02)]


@pytest.mark.parametrize("step", [1, 5])
def test_kldiv_batch_matches_jax(step):
    arrs = _noise(step)
    arrs[2][0, 0, 0, 0] = 5.0        # outside the inner bins: clipped into the outer ones
    sums, cnt = metrics.kldiv_batch(*[torch.as_tensor(a) for a in arrs], step=step)
    ref_sums, ref_cnt = jmetrics.kldiv_batch_jax(*[jnp.asarray(a) for a in arrs], step=step)
    assert cnt == ref_cnt
    # float32 logs of the same counts
    np.testing.assert_allclose(sums.numpy(), np.asarray(ref_sums), rtol=1e-5, atol=1e-6)


def test_marginal_kld_matches_jax():
    a, b = _noise(7)[:2]
    got = float(metrics.marginal_kld(torch.as_tensor(a), torch.as_tensor(b)))
    ref = float(jmetrics.marginal_kld_jax(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


def test_numpy_kld_copies_match_jax(tmp_path):
    ds = PatchDataset(SAMPLES, 32, 8)
    mb = next(ds.batches(10))
    xs = _noise(3, b=10)[2] * 0.5
    np.testing.assert_array_equal(metrics.calc_kldiv_mb(mb, xs, 0.02),
                                  jmetrics.calc_kldiv_mb(mb, xs, 0.02))
    got = metrics.kldiv_patch_set(1, mb, xs, 0.02, str(tmp_path / "p"), save_mat=True)
    ref = jmetrics.kldiv_patch_set(1, mb, xs, 0.02, str(tmp_path / "j"), save_mat=True)
    np.testing.assert_array_equal(got, ref)
    assert sorted(os.listdir(tmp_path / "p")) == sorted(os.listdir(tmp_path / "j"))
    metrics.save_vis_mb(mb, str(tmp_path / "v"))
    assert os.path.exists(tmp_path / "v" / "vis_mb.npy")


def test_logger_and_timers(tmp_path):
    path = str(tmp_path / "log.txt")
    lg = ResultLogger(path, ["epoch", "NLL"])
    lg.log({"epoch": 1, "NLL": 2.5})
    lg.close()
    assert open(path).read() == "epoch\tNLL\n1\t2.5"
    add_trace_level()
    import logging
    assert logging.getLevelName(100) == "TRACE"
    t = PhaseTimers()
    with t.phase("step"):
        pass
    assert t.counts == {"step": 1} and t.line().startswith("step=")
    # a phase is the span nf.<name> while a profiler records
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with t.phase("step"):
            torch.ones(2).sum()
    assert "nf.step" in {e.name for e in prof.events()}
    assert t.counts == {"step": 2}
