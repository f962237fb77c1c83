"""A run that stops and resumes: ``Trainer.fit`` interrupted by SIGINT and
continued in a fresh trainer (``continue_training``), against an
uninterrupted run and against JAX's ``fit`` doing the same; ``cli.train
--stop_after``; the flagship's resumable ``train`` step and its helpers
(``keep_best``, ``summed_train_time``); and ``cli.dncnn_comparison``'s
``--seed`` and ``--dtype``. On the CPU, with the small arch and staged data
of ``tests/test_torch_trainer.py``, in groups of ``steps_per_call`` = 2.

SIGINT is raised only from inside ``fit``, after an epoch's training pass,
while fit's own handler is installed, so no handler-less SIGINT reaches the
test process."""

import json
import os
import signal

import numpy as np
import pytest
import torch
from scipy.io import savemat

from noise_flow_tpu.config import default_config as jax_default_config
from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
from noise_flow_tpu.parallel.mesh import make_mesh
from noise_flow_tpu.training.trainer import Trainer as JaxTrainer
from noise_flow_tpu_torch.cli import dncnn_comparison as dc
from noise_flow_tpu_torch.cli import flagship, make_sidd_scale
from noise_flow_tpu_torch.cli import train as cli_train
from noise_flow_tpu_torch.config import default_config
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.training.trainer import Trainer
from test_torch_trainer import _mb, _port_from_jax

torch.set_num_threads(1)

ARCH = "sdn5|unc|gain4|unc"
PATHS = {"plain": {}, "oneshot": {"use_pallas": True, "pallas_train_dtype": "float32"},
         "segment": {"use_pallas": True, "pallas_oneshot": False,
                     "pallas_train_dtype": "float32"},
         # the kernel-path recipes' default: the one-shot step and the eval
         # forward in bfloat16
         "oneshot_bf16": {"use_pallas": True, "pallas_train_dtype": "bfloat16"}}
# (lr, epochs, the epoch after which the run stops) where the test NLL is
# lowest at the stop and higher in every later epoch, so that the stop lands
# in the best test epoch and the resumed call's first test epoch is worse
# than the run's best: from the port's seed-0 weights and from JAX's initial
# weights alike, the NLL falls to epoch 3, rises at 4 and falls again at 5,
# still above epoch 3's
STOP = (0.1, 5, 3)


def _cfg(epochs, lr=1e-3, **kw):
    return default_config(arch=ARCH, lr=lr, n_batch_train=4, n_batch_test=4, epochs=epochs,
                          steps_per_call=2, **kw)


def _stage(tr):
    tr.stage_dataset(iter([_mb(4, s) for s in range(5)]), "train")   # 5 steps: 2 groups, a tail
    tr.stage_dataset(iter([_mb(4, 10), _mb(4, 11)]), "test")
    return tr


def _stop_after(tr, epoch, seed):
    """Make ``tr``'s fit raise SIGINT after ``epoch``'s training pass (the
    staged epoch's shuffle seed is cfg.seed + epoch)."""
    run = tr._train_epoch_staged

    def epoch_then_sigint(shuffle_seed):
        out = run(shuffle_seed)
        if shuffle_seed == seed + epoch:
            assert signal.getsignal(signal.SIGINT) is not signal.default_int_handler
            signal.raise_signal(signal.SIGINT)
        return out
    tr._train_epoch_staged = epoch_then_sigint
    return tr


def _state(tr):
    """Every parameter, BN buffer and Adam slot, by name."""
    out = {f"flow/{k}": v.clone() for k, v in tr.flow.state_dict().items()}
    names = {p: n for n, p in tr.flow.named_parameters()}
    for p, st in tr.optimizer.state.items():
        for slot, v in st.items():
            out[f"opt/{names[p]}/{slot}"] = torch.as_tensor(v).clone()
    return out


def _rows(logdir, name, cols=("epoch", "NLL")):
    return [tuple(r[c] for c in cols) for r in flagship.read_tsv(os.path.join(logdir, name))]


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _fresh(cfg, seed):
    """A new trainer from another seed: the resume must load everything."""
    return _stage(Trainer(NoiseFlow((32, 32, 4), cfg, device="cpu", seed=seed), cfg))


@pytest.mark.parametrize("path", sorted(PATHS))
def test_resumed_fit_equals_an_uninterrupted_one(path, tmp_path):
    """(a) 3 epochs straight against a fit stopped by SIGINT after epoch 1
    and resumed in a fresh Trainer and NoiseFlow: every parameter, BN buffer
    and Adam slot the same bits, the train.txt rows the same, and the test
    rows too (only the sample rows follow a reseeded generator)."""
    cfg = _cfg(3, **PATHS[path])
    whole = _fresh(cfg, 0)
    init = {k: v.clone() for k, v in whole.flow.state_dict().items()}
    whole.fit(None, None, str(tmp_path / "whole"), verbose=False)

    first = _stop_after(_fresh(cfg, 0), 1, cfg.seed)
    first.flow.load_state_dict(init)
    hist = first.fit(None, None, str(tmp_path / "split"), verbose=False)
    assert len(hist["train"]) == 1     # stopped after epoch 1
    cfg.continue_training = True
    resumed = _fresh(cfg, 5)
    hist = resumed.fit(None, None, str(tmp_path / "split"), verbose=False)
    assert len(hist["train"]) == 2     # epochs 2 and 3

    a, b = _state(whole), _state(resumed)
    assert set(a) == set(b) and any(k.startswith("opt/") for k in a)
    differ = [k for k in a if not torch.equal(a[k], b[k])]
    assert not differ, differ
    for name in ("train.txt", "test.txt"):
        assert _rows(tmp_path / "whole", name) == _rows(tmp_path / "split", name), name


def _stopped_run(make, logdir, stop_at, keep=False):
    """A run stopped after ``stop_at`` and resumed: ``make(continue)``
    builds each call's trainer. Returns the first call's best checkpoint and
    its overwritten model.ckpt-<stop_at>, as they stood after that call."""
    make(False).fit(None, None, logdir, do_sampling=False, verbose=False)
    ckpt = os.path.join(logdir, "ckpt")
    after_first = {n: _npz(os.path.join(ckpt, f"model.ckpt-{n}.npz")) for n in ("best", stop_at)}
    if keep:
        flagship.keep_best(logdir)
    make(True).fit(None, None, logdir, do_sampling=False, verbose=False)
    if keep:
        flagship.keep_best(logdir)
    return after_first


def _params(ck):
    return {k: v for k, v in ck.items() if k.startswith("params|")}


def test_jax_fit_resumes_as_the_ports(tmp_path):
    """(b) JAX's fit and the port's, from the same weights, stopped after
    epoch 3 (a test epoch) and resumed: the same epochs in train.txt and
    test.txt, the same checkpoint names and the same ``msg`` column. Both
    restart ``best_nll`` at the resume (epochs 4 and 5 are marked best
    though epoch 3's row is lower), and both overwrite ``model.ckpt-3`` at the stop
    with the weights after epoch 3's training pass, which are not those
    that test row 3 scored (``model.ckpt-best`` of the first call)."""
    lr, epochs, stop_at = STOP
    kw = dict(arch=ARCH, patch_height=32, lr=lr, n_batch_train=4, n_batch_test=4,
              epochs=epochs, steps_per_call=2)
    jcfg = jax_default_config(**kw)
    jtr0 = JaxTrainer(JaxFlow((32, 32, 4), jcfg), jcfg, mesh=make_mesh(1))
    init = _port_from_jax(jtr0, default_config(**kw)).state_dict()

    def jax_call(resume):
        cfg = jax_default_config(continue_training=resume, **kw)
        tr = JaxTrainer(JaxFlow((32, 32, 4), cfg), cfg, mesh=make_mesh(1))
        tr.params, tr.state = jtr0.params, jtr0.state
        tr.stage_dataset(iter([_mb(4, s) for s in range(5)]), "train")
        tr.stage_dataset(iter([_mb(4, 10), _mb(4, 11)]), "test")
        return tr if resume else _stop_after(tr, stop_at, cfg.seed)

    def port_call(resume):
        cfg = default_config(continue_training=resume, **kw)
        tr = _fresh(cfg, 3)
        tr.flow.load_state_dict(init)
        return tr if resume else _stop_after(tr, stop_at, cfg.seed)

    runs = {}
    for name, make in (("jax", jax_call), ("port", port_call)):
        logdir = str(tmp_path / name)
        first = _stopped_run(make, logdir, stop_at)
        best, stop = first["best"], first[stop_at]
        assert int(best["__epoch__"]) == int(stop["__epoch__"]) == stop_at, name
        assert _params(best).keys() == _params(stop).keys(), name
        assert any(not np.array_equal(v, stop[k]) for k, v in _params(best).items()), name
        runs[name] = {
            "train": [r[0] for r in _rows(logdir, "train.txt")],
            "test": _rows(logdir, "test.txt", ("epoch", "msg")),
            "ckpt": sorted(os.listdir(os.path.join(logdir, "ckpt"))),
            "best_epoch": int(_npz(os.path.join(logdir, "ckpt", "model.ckpt-best.npz"))
                              ["__epoch__"])}
    assert runs["port"] == runs["jax"]
    # an uninterrupted run marks epochs 4 and 5 "0": both are above epoch 3
    assert runs["port"]["test"] == [(str(e), "1") for e in range(1, 6)]
    assert runs["port"]["best_epoch"] == 5


def test_kept_best_is_the_uninterrupted_runs_best(tmp_path):
    """(c) The flagship's helpers over a run whose stop lands in its best
    test epoch: ``keep_best`` after each call keeps the checkpoint of the
    lowest test row, bit-equal to an uninterrupted run's
    ``model.ckpt-best.npz``, where the run's own best file (the resumed
    call's last improving test epoch) and its ``model.ckpt-3`` (overwritten
    at the stop after epoch 3) are not; and ``summed_train_time`` adds each
    call's last value."""
    lr, epochs, stop_at = STOP

    def make(resume):
        cfg = _cfg(epochs, lr=lr, continue_training=resume)
        tr = _fresh(cfg, 0)
        return tr if resume else _stop_after(tr, stop_at, cfg.seed)
    logdir = str(tmp_path / "split")
    _stopped_run(make, logdir, stop_at, keep=True)
    whole = _fresh(_cfg(epochs, lr=lr), 0)
    whole.fit(None, None, str(tmp_path / "whole"), do_sampling=False, verbose=False)

    ref = _npz(str(tmp_path / "whole" / "ckpt" / "model.ckpt-best.npz"))
    rows = {int(e): float(n) for e, n in _rows(tmp_path / "whole", "test.txt")}
    assert int(ref["__epoch__"]) == min(rows, key=rows.get) == stop_at
    kept = _npz(os.path.join(logdir, flagship.BEST_DIR, "ckpt", "model.ckpt-best.npz"))
    assert kept.keys() == ref.keys()
    assert all(np.array_equal(kept[k], ref[k]) for k in ref)
    assert json.load(open(os.path.join(logdir, flagship.BEST_DIR, "best.json"))) == {
        "epoch": stop_at, "nll": rows[stop_at]}
    own = _npz(os.path.join(logdir, "ckpt", "model.ckpt-best.npz"))
    stop = _npz(os.path.join(logdir, "ckpt", f"model.ckpt-{stop_at}.npz"))
    assert int(own["__epoch__"]) == epochs
    assert not all(np.array_equal(stop[k], ref[k]) for k in _params(ref))

    # train_time restarts at each call: each call's last value, summed
    tsv = tmp_path / "train.txt"
    for times, want in (((5, 9, 3, 8), 17), ((5, 9, 12, 20), 29)):
        tsv.write_text("epoch\ttrain_time\n" + "\n".join(
            f"{e}\t{t}" for e, t in enumerate(times, 1)))
        assert flagship.summed_train_time(str(tsv), [1, 3]) == want
        assert flagship.summed_train_time(str(tsv), [1]) == times[-1]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A SIDD-scale corpus at a small frame: 2 train and 2 test scenes of
    512x1024 Bayer (512 train and 512 test patches of 32x32)."""
    root = str(tmp_path_factory.mktemp("corpus") / "SIDD_Medium_Raw_synth" / "Data")
    assert make_sidd_scale.main(["--root", root, "--n_train", "2", "--n_test", "2",
                                 "--height", "512", "--width", "1024",
                                 "--mat_version", "v5"]) == 0
    return root


def test_flagship_train_step_resumes_over_calls(corpus, tmp_path, monkeypatch):
    """The flagship's ``train`` step over two calls at the recipe's widths
    (b = 138, K = 32) on the CPU: the first stops itself at once
    (``--stop_after 0``: epoch 1 finishes, then the checkpoint), the second
    is handed a copy of the logdir (``--resume_from``) and resumes to epoch
    3. ``calls.json`` lists both calls with the loading split and equal
    content signatures; the report sums train_time over them and keeps the
    lowest test row's checkpoint; the rows are those of one run."""
    work = tmp_path / "work"
    exact = flagship.RECIPES["prod-exact"]
    monkeypatch.setitem(flagship.RECIPES, "prod-exact", exact._replace(
        flags=exact.flags + ["--staged_test_patches", "138"]))
    common = ["--work", str(work), "--epochs", "3", "--device", "cpu", "--steps", "train,report"]
    os.makedirs(work / "SIDD_Medium_Raw_synth")
    os.symlink(corpus, work / "SIDD_Medium_Raw_synth" / "Data")
    first = str(tmp_path / "first")
    assert flagship.main(common + ["--logdir", first, "--stop_after", "0",
                                   "--report", str(tmp_path / "r1.json")]) == 0
    assert [r[0] for r in _rows(first, "train.txt")] == ["1"]
    second = str(tmp_path / "second")
    assert flagship.main(common + ["--logdir", second, "--resume_from", first,
                                   "--report", str(tmp_path / "r2.json")]) == 0
    rep = json.load(open(tmp_path / "r2.json"))
    assert [r["epoch"] for r in rep["train_rows"]] == [1, 2, 3]
    assert [(c["start_epoch"], c["end_epoch"]) for c in rep["calls"]] == [(1, 1), (2, 3)]
    for c in rep["calls"]:
        assert {"decode_train_s", "decode_test_s", "stats_baselines_s", "stage_s",
                "to_fit_s"} <= set(c["loading"]) and c["device"] == "cpu"
        assert c["loading"]["train_patches"] == 512
    assert rep["content_sig_equal"] is True
    times = [int(r["train_time"]) for r in flagship.read_tsv(os.path.join(second, "train.txt"))]
    assert rep["train_time_s"] == times[0] + times[-1]
    assert rep["epochs_as_jax"] == {"train": True, "test": True}
    rows = {int(e): float(n) for e, n in _rows(second, "test.txt")}
    best = min(rows, key=rows.get)
    assert rep["best_gap"]["epoch"] == best and rep["best_gap"]["nll"] == rows[best]
    assert rep["best_gap"]["jax_epoch"] == 50
    assert os.path.exists(os.path.join(second, flagship.BEST_DIR, "hps.txt"))
    assert not [d for d in os.listdir(second) if d.startswith("samples_epoch_")]

    # sweep and grid run on prod_exact_150 and on the kept best (entry
    # points stubbed here: tests/test_torch_analysis.py runs them)
    from noise_flow_tpu_torch.analysis import ref_parity
    from noise_flow_tpu_torch.cli import kld_sweep
    seen = []
    monkeypatch.setattr(kld_sweep, "main", lambda argv: seen.append(("sweep", argv)) or 0)
    monkeypatch.setattr(ref_parity, "main", lambda argv: seen.append(("grid", argv)) or 0)
    assert flagship.main(["--work", str(work), "--device", "cpu", "--steps", "sweep,grid",
                          "--logdir", second, "--sweep_seeds", "1",
                          "--report", str(tmp_path / "r3.json")]) == 0
    models = [(k, v[v.index("--model_dir") + 1]) for k, v in seen]
    best_dir = os.path.join(second, flagship.BEST_DIR)
    assert models == [("sweep", flagship.JAX_RUN)] * 2 + [("sweep", best_dir), (
        "grid", flagship.JAX_RUN), ("grid", best_dir)]
    assert set(json.load(open(tmp_path / "r3.json"))["sampler_launches"]) == {
        "jax_seed0", "jax_seed1", "port_best_seed0", "grid", "grid_port_best"}


@pytest.mark.parametrize("ranks", [["--mesh", "2"], [
    "--coordinator_address", "localhost:1", "--num_processes", "2", "--process_id", "0"]],
    ids=["mesh", "coordinator"])
def test_stop_after_refuses_more_than_one_rank(ranks):
    """--stop_after stops one rank's fit; with ranks it raises first."""
    with pytest.raises(SystemExit, match="stop_after"):
        cli_train.main(["--synthetic_data", "1", "--device", "cpu", "--stop_after", "5",
                        *ranks])


def _dncnn_rows(corpus, val, out, *extra):
    assert dc.main(["--device", "cpu", "--epochs", "1", "--max_images", "2", "--batch", "8",
                    "--sources", "gauss", "--data_root", corpus, "--val_dir", val,
                    "--out", out, *extra]) == 0
    with open(os.path.join(out, "results.json")) as f:
        return json.load(f)


def test_dncnn_comparison_seed_and_dtype_reach_the_trainer(corpus, tmp_path, monkeypatch):
    """(d) ``--seed`` and ``--dtype`` reach ``DnCNNTrainer``: one seed twice
    gives the same rows, another seed other rows; both are written to
    results.json and to the flagship's report; the defaults are 0 and
    float32 (the JAX script's trainer)."""
    val = str(tmp_path / "val")
    os.makedirs(val)
    rng = np.random.default_rng(3)
    gt = rng.uniform(0.05, 0.9, (40, 1, 32, 32)).astype(np.float32)
    savemat(os.path.join(val, "ValidationGtBlocksRaw.mat"), {"ValidationGtBlocksRaw": gt})
    savemat(os.path.join(val, "ValidationNoisyBlocksRaw.mat"), {
        "ValidationNoisyBlocksRaw": gt + rng.normal(0, 0.02, gt.shape).astype(np.float32)})
    made = []
    real = dc.DnCNNTrainer

    def spy(**kw):
        made.append({k: kw.get(k) for k in ("seed", "dtype")})
        return real(**kw)
    monkeypatch.setattr(dc, "DnCNNTrainer", spy)
    base = _dncnn_rows(corpus, val, str(tmp_path / "s0"))
    again = _dncnn_rows(corpus, val, str(tmp_path / "s0b"), "--seed", "0")
    other = _dncnn_rows(corpus, val, str(tmp_path / "s1"), "--seed", "1")
    bf16 = _dncnn_rows(corpus, val, str(tmp_path / "bf"), "--dtype", "bfloat16")
    assert made == [{"seed": 0, "dtype": "float32"}] * 2 + [
        {"seed": 1, "dtype": "float32"}, {"seed": 0, "dtype": "bfloat16"}]
    psnr = [r["results"]["gauss"]["psnr"] for r in (base, again, other, bf16)]
    assert psnr[0] == psnr[1] and psnr[2] != psnr[0] and psnr[3] != psnr[0]
    assert [(r["seed"], r["dtype"]) for r in (base, other, bf16)] == [
        (0, "float32"), (1, "float32"), (0, "bfloat16")]
    rep = flagship.compare_dncnn(os.path.join(str(tmp_path / "s1"), "results.json"),
                                 flagship.JAX_DNCNN)
    assert (rep["setup"]["seed"], rep["setup"]["dtype"]) == (1, "float32")
