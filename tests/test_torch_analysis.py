"""The port's analysis layer against JAX's: the KLD-vs-temperature sweep,
the reference-parity grid, the frame-size sampler, and the figures.

Sampling parity passes the latent explicitly (shared eps): the port's fused
sampler (its plain version on the CPU) and the frame-size flow against
JAX's ``flow.forward(train=True)`` on the in-repo flagship checkpoint.
Tolerances are the float32 floor (1e-5) or exact.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_flow_tpu.analysis import compare as jcompare
from noise_flow_tpu.analysis import plots as jplots
from noise_flow_tpu.analysis import ref_parity as jrp
from noise_flow_tpu.cli import kld_sweep as jkld
from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
from noise_flow_tpu.utils import graphics as jgraphics
from noise_flow_tpu.utils.metrics import calc_kldiv_mb as jax_calc_kldiv_mb
from noise_flow_tpu.wrapper import NoiseFlowWrapper as JaxWrapper
from noise_flow_tpu_torch.analysis import compare, plots, ref_parity
from noise_flow_tpu_torch.cli import kld_sweep, make_sidd_scale
from noise_flow_tpu_torch.data.stats import calc_pat_stats
from noise_flow_tpu_torch.ops.fused_sample import fused_sample
from noise_flow_tpu_torch.utils import graphics
from noise_flow_tpu_torch.utils.metrics import calc_kldiv_mb
from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "experiments", "sidd", "prod_exact_150")
ATOL = 1e-5
SWEEP = ["--temps", "0.5,1.0", "--n_batch", "8", "--n_patches_per_image", "8",
         "--max_batches_per_group", "1"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Two test scenes (ids 54, 55; the generator's first two cells), images
    010/011, 128x128 Bayer."""
    root = str(tmp_path_factory.mktemp("kld") / "SIDD_Medium_Raw" / "Data")
    assert make_sidd_scale.main(["--root", root, "--n_train", "0", "--n_test", "2",
                                 "--height", "128", "--width", "128"]) == 0
    return root


@pytest.fixture(scope="module")
def jw():
    return JaxWrapper(MODEL)


@pytest.fixture(scope="module")
def tw():
    return NoiseFlowWrapper(MODEL, device="cpu")


def _read_rows(path):
    lines = open(path).read().splitlines()
    return lines[0].split("\t"), [ln.split("\t") for ln in lines[1:]]


def test_kld_sweep_cli_matches_jax(corpus, tmp_path):
    """Same rows and keys as JAX's CLI; KLD_G, KLD_NLF and KLD_R equal as
    printed; KLD_NF (another RNG) finite."""
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "torch")
    assert jkld.main(["--model_dir", MODEL, "--sidd_path", corpus, "--logdir", jdir]
                     + SWEEP) == 0
    assert kld_sweep.main(["--model_dir", MODEL, "--sidd_path", corpus, "--logdir", tdir,
                           "--device", "cpu"] + SWEEP) == 0
    jhead, jrows = _read_rows(os.path.join(jdir, "kld_vs_temp.txt"))
    head, rows = _read_rows(os.path.join(tdir, "kld_vs_temp.txt"))
    assert head == jhead == list(kld_sweep.COLUMNS)
    assert len(rows) == len(jrows) == 4  # two (cam, iso) groups x two temps
    for r, jr in zip(rows, jrows):
        assert r[:5] + r[6:] == jr[:5] + jr[6:]
        assert np.isfinite(float(r[5])) and float(r[5]) >= 0
    assert sorted(f for f in os.listdir(tdir) if f.endswith(".png")) == sorted(
        f for f in os.listdir(jdir) if f.endswith(".png"))


def test_kld_sweep_nf_column_matches_jax_at_shared_eps(corpus, tw, jw):
    """One sweep batch: the port's sample (fused sampler, bt = b) and KLDs
    against JAX's calc_kldiv_mb on flow.forward(eps * t, train=True)."""
    args = kld_sweep.parse_args(["--model_dir", MODEL, "--sidd_path", corpus] + SWEEP)
    ds = kld_sweep.load_patches(args, tw.cfg)
    sc_sd = calc_pat_stats(ds.x, ds.y)["sc_in_sd"]
    cam_v, iso_v = float(ds.cam[0]), float(ds.iso[0])
    (sel,) = kld_sweep.group_batches(ds, cam_v, iso_v, 8, 1)
    mb = kld_sweep.minibatch(ds, sel)
    temp = 0.6
    eps = np.random.default_rng(0).standard_normal(mb["_y"].shape).astype(np.float32)
    got = kld_sweep.sample_minibatch(tw._program, mb, temp, "cpu", eps=torch.as_tensor(eps))
    cond = {k: jnp.asarray(mb[s]) for k, s in (("clean", "_y"), ("nlf0", "nlf0"),
                                               ("nlf1", "nlf1"), ("iso", "iso"),
                                               ("cam", "cam"))}
    ref = np.asarray(jw.flow.forward(jw.params, jw.state, jnp.asarray(eps * temp), cond,
                                     train=True))
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-5)
    kld, jkld_row = calc_kldiv_mb(mb, got, sc_sd), jax_calc_kldiv_mb(mb, ref, sc_sd)
    np.testing.assert_allclose(kld, jkld_row, atol=ATOL, rtol=0)
    assert kld[2] < kld[0]  # the flagship beats the Gaussian at t = 0.6


class _Double:
    """A wrapper double: each call samples one package's flow from the same
    numbered eps (numpy seed 100 + call)."""

    def __init__(self, cfg, sample):
        self.cfg, self.sample, self.calls = cfg, sample, 0

    def sample_noise_nf(self, clean, b1, b2, iso, cam, temp=None):
        eps = np.random.default_rng(100 + self.calls).standard_normal(
            clean.shape).astype(np.float32)
        self.calls += 1
        return self.sample(np.asarray(clean, np.float32), float(b1), float(b2),
                           float(iso), float(cam), float(temp), eps)


def test_grid_cell_matches_jax_at_shared_eps(tw, jw):
    def port(clean, b1, b2, iso, cam, temp, eps):
        b = clean.shape[0]
        cond = {"clean": torch.as_tensor(clean), "nlf0": torch.full((b,), b1),
                "nlf1": torch.full((b,), b2), "iso": torch.full((b,), iso),
                "cam": torch.full((b,), cam)}
        return fused_sample(tw._program, cond, temp=temp, eps=torch.as_tensor(eps),
                            bt=b).numpy()

    def jax_(clean, b1, b2, iso, cam, temp, eps):
        b = clean.shape[0]
        cond = {"clean": jnp.asarray(clean), "nlf0": jnp.full((b,), b1),
                "nlf1": jnp.full((b,), b2), "iso": jnp.full((b,), iso),
                "cam": jnp.full((b,), cam)}
        return np.asarray(jw.flow.forward(jw.params, jw.state, jnp.asarray(eps * temp), cond,
                                          train=True))

    args = ("S6_00800", 0.000479 * 8, 2e-6)
    row = ref_parity.grid_cell(_Double(tw.cfg, port), *args, batch=16, temp=1.0, seed=3)
    jrow = jrp.grid_cell(_Double(jw.cfg, jax_), *args, batch=16, temp=1.0, seed=3)
    assert row.keys() == jrow.keys()
    for k, v in row.items():
        if isinstance(v, (str, int)):
            assert v == jrow[k], k
        else:
            assert abs(v - jrow[k]) <= ATOL, (k, v, jrow[k])
    assert row["n_values"] == 3 * 16 * 32 * 32 * 4


def test_run_grid_cli_writes_the_artifact(tmp_path):
    out = str(tmp_path / "grid")
    assert ref_parity.main(["--batch", "4", "--device", "cpu", "--out_dir", out]) == 0
    head, rows = _read_rows(os.path.join(out, "grid.tsv"))
    assert head[0] == "cam_iso" and len(rows) == 15
    ratios = np.asarray([float(r[head.index("std_ratio")]) for r in rows])
    assert np.all((ratios > 0.5) & (ratios < 2.0))
    summary = open(os.path.join(out, "summary.txt")).read()
    assert "cells\t15" in summary and "batch_per_level\t4" in summary


@pytest.mark.parametrize("h,w", [(64, 96), (70, 100)])
def test_frame_spatial_matches_jax_frame_flow(tw, jw, h, w):
    """sample_noise_frame_spatial against JAX's frame-size flow.forward on
    the same latent (the wrapper's generator reseeded), train=True; 70x100
    is reflect-padded to 72x104 and cropped."""
    frame = np.random.default_rng(1).uniform(0.02, 0.8, (h, w, 4)).astype(np.float32)
    temp, seed = 0.6, 5
    tw._gen = torch.Generator().manual_seed(seed)
    got = tw.sample_noise_frame_spatial(frame, 0.0, 0.0, 800, 2, temp=temp)
    assert got.shape == (h, w, 4)
    hp, wp = h + (-h) % 8, w + (-w) % 8
    z = torch.randn((1, hp, wp, 4), generator=torch.Generator().manual_seed(seed)) * temp
    xp = np.pad(frame[None], ((0, 0), (0, hp - h), (0, wp - w), (0, 0)), mode="reflect")
    one = lambda v: jnp.full((1,), v, jnp.float32)  # noqa: E731
    cond = {"clean": jnp.asarray(xp), "nlf0": one(0.0), "nlf1": one(0.0),
            "iso": one(800.0), "cam": one(2.0)}
    ref = np.asarray(JaxFlow((hp, wp, 4), jw.cfg).forward(
        jw.params, jw.state, jnp.asarray(z.numpy()), cond, train=True))[0, :h, :w]
    np.testing.assert_allclose(got, ref, atol=ATOL, rtol=0)
    assert 0.0 < float(np.std(got)) < 1.0


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A tiny port training run: TSVs and npz checkpoints on the CPU."""
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.data.patches import PatchDataset
    from noise_flow_tpu_torch.data.synthetic import make_synthetic_samples
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.training.trainer import Trainer

    tr = PatchDataset(make_synthetic_samples(2, 64, 64, iso=800), 16, 16)
    cfg = default_config(arch="sdn5|unc|gain4|unc", patch_height=16, lr=1e-2,
                         n_batch_train=16, temp=1.0)
    trainer = Trainer(NoiseFlow((16, 16, 4), cfg, device="cpu"), cfg)
    logdir = str(tmp_path_factory.mktemp("port_run"))
    trainer.fit(lambda: tr.batches(16, drop_remainder=True),
                lambda: tr.batches(16, drop_remainder=True),
                logdir, epochs=3, nll_gauss=-100.0, nll_sdn=-120.0,
                do_sampling=True, verbose=False)
    return logdir, trainer, tr


def test_plots_from_port_run(port_run, tmp_path):
    logdir, trainer, tr = port_run
    ckpt = os.path.join(logdir, "ckpt")
    for p in (plots.plot_nll([logdir], out_path=str(tmp_path / "nll.png")),
              plots.plot_kld([logdir], out_path=str(tmp_path / "kld.png")),
              plots.plot_param_evolution(ckpt, out_path=str(tmp_path / "params.png")),
              plots.plot_gain_vs_nlf(ckpt, out_path=str(tmp_path / "gain.png"),
                                     nlf_all_path=os.path.join(ROOT, "cam_iso_nlf_all.txt"))):
        assert os.path.getsize(p) > 1000
    # the port's npz checkpoints read as JAX's plots read them
    epochs, series = plots._load_ckpt_series(ckpt, (r"sdn_gain", r"gain_params"))
    jepochs, jseries = jplots._load_ckpt_series(ckpt, (r"sdn_gain", r"gain_params"))
    np.testing.assert_array_equal(epochs, jepochs)
    # JAX's scan also takes the port's optimizer slots (opt|torch/...)
    assert series.keys() == {k for k in jseries if not k.startswith("opt|")}
    assert list(epochs) == [1, 2, 3] and series
    for k, v in series.items():
        np.testing.assert_array_equal(v, jseries[k])
    assert any(v.shape[1] == 5 for k, v in series.items() if "gain_params" in k)
    tsv = os.path.join(logdir, "sample.txt")
    for k, v in plots._read_tsv(tsv).items():
        np.testing.assert_array_equal(v, jplots._read_tsv(tsv)[k])
    assert plots.load_cam_iso_nlf_all(os.path.join(ROOT, "cam_iso_nlf_all.txt")) == \
        jplots.load_cam_iso_nlf_all(os.path.join(ROOT, "cam_iso_nlf_all.txt"))


def test_kld_vs_temp_sweep_with_torch_generator(port_run, tmp_path):
    """kld_vs_temp_sweep draws from an explicit torch.Generator: the same
    seed gives the same rows, another seed other rows (the on-device KLD
    draws the Gaussian and NLF noise from it too); KLD_R is 0."""
    _, trainer, tr = port_run
    sc_sd = calc_pat_stats(tr.x, tr.y)["sc_in_sd"]

    def sweep(seed):
        return plots.kld_vs_temp_sweep(trainer, lambda: tr.batches(16, drop_remainder=True),
                                       [0.5, 1.0], torch.Generator().manual_seed(seed), sc_sd)

    a, b, c = sweep(0), sweep(0), sweep(1)
    assert a.shape == (2, 4) and np.all(np.isfinite(a))
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a[:, :3], c[:, :3])
    np.testing.assert_array_equal(a[:, 3], 0.0)
    assert os.path.exists(plots.plot_kld_vs_temp([0.5, 1.0], a, str(tmp_path / "kvt.png")))


def test_graphics_raster_matches_jax(tmp_path):
    x = np.random.default_rng(0).uniform(0, 1, (10, 16, 16, 4)).astype(np.float32)
    for kw in ({}, {"rescale": True}, {"width": 3}):
        g = graphics.to_raster(x, **kw)
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, jgraphics.to_raster(x, **kw))
    assert graphics.to_raster(x).shape == (3 * 16, 4 * 16, 4)
    graphics.save_raster(x, str(tmp_path / "r.png"))
    graphics.save_image(x[0], str(tmp_path / "i.png"))
    assert (tmp_path / "r.png").exists() and (tmp_path / "i.png").exists()


def test_compare_figures_over_both_frameworks_runs(port_run, tmp_path):
    """read_run equals JAX's on a JAX run dir and on the port's; the figures
    render from both."""
    jrun = os.path.join(ROOT, "experiments", "sidd", "smoke")
    prun = port_run[0]
    for run in (jrun, prun):
        data, jdata = compare.read_run(run), jcompare.read_run(run)
        assert data.keys() == jdata.keys() and "test" in data
        for split in data:
            for k in data[split]:
                np.testing.assert_array_equal(data[split][k], jdata[split][k])
    for p in (compare.compare_nll([jrun, prun], ["jax", "torch"], str(tmp_path / "cmp.png")),
              compare.compare_nll_broken([jrun], None, str(tmp_path / "brk.png"),
                                         (0.0, 1500.0), (-3100.0, 0.0)),
              compare.model_summary_panel(prun, str(tmp_path / "panel.png"))):
        assert os.path.getsize(p) > 1000
    out = str(tmp_path / "main.png")
    assert compare.main([prun, "--out", out]) == 0
    assert os.path.exists(out) and os.path.exists(out.replace(".png", "_panel.png"))


def test_new_entry_points_default_to_the_card(tmp_path):
    """Without --device the sweep, the grid and the flagship run ask for
    CUDA and raise where there is none, rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is usable")
    from noise_flow_tpu_torch.cli import flagship

    with pytest.raises(RuntimeError, match="cuda"):
        kld_sweep.main(["--model_dir", MODEL, "--synthetic_data", "1",
                        "--logdir", str(tmp_path / "kld")])
    with pytest.raises(RuntimeError, match="cuda"):
        ref_parity.main(["--batch", "2", "--out_dir", str(tmp_path / "grid")])
    with pytest.raises(RuntimeError, match="cuda"):
        flagship.main(["--work", str(tmp_path / "flagship"), "--steps", "frame"])
    with pytest.raises(RuntimeError, match="cuda"):
        NoiseFlowWrapper(MODEL).sample_noise_frame_spatial(np.zeros((8, 8, 4)), 0, 0, 100, 2)


def test_flagship_report_reads_the_recorded_run():
    """The flagship run's report helpers on the JAX run's own records: the
    recorded sweep against itself matches in every row, NF beats G in 15/15
    cells at a mean best KLD_NF of 0.0126 (its README); the rows of epoch
    10 are the recorded ones."""
    from noise_flow_tpu_torch.cli import flagship

    rec = os.path.join(MODEL, "kld_sweep", "kld_vs_temp.txt")
    s = flagship.compare_sweep(rec, rec)
    assert (s["rows"], s["recorded_rows"], s["g_nlf_rows_differing"]) == (105, 105, [])
    assert (s["cells"], s["cells_nf_below_g"]) == (15, 15)
    assert s["mean_best_kld_nf"] == s["recorded_mean_best_kld_nf"]
    assert round(s["mean_best_kld_nf"], 4) == 0.0126
    for split, nll in (("train", -9495.8486328125), ("test", -8644.693359375)):
        tsv = os.path.join(MODEL, f"{split}.txt")
        rows = {r["epoch"]: r for r in flagship.compare_rows(tsv, tsv)}
        assert rows[10]["NLL"] == rows[10]["jax_NLL"] == nll
