"""The kernel-path training recipe (jobs/job_noise_flow.sh prod-synth-scale,
experiments/sidd/bn_delta/ghost): the one-shot step with ghost BN and the
running-BN eval forward, both at the JAX default ``pallas_train_dtype =
"bfloat16"``, K steps a dispatch, staged data; against the JAX trainer on
the CPU (its Pallas kernels in interpret mode, as its own tests run them),
at b = 8, one block, with the small arch of ``tests/test_torch_scan.py``.
Also: an eval after further train steps reads the updated BN buffers;
``make_mesh`` and ``spawn_ranks`` default to the card; and the flagship
CLI's ``--recipe`` table and report against the JAX runs' records.

Tolerances (bfloat16 against bfloat16). A product's operands round to
bfloat16; a value within one float32 ulp of a rounding boundary rounds
either way under another summation order, so the two sides part by whole
bfloat16 steps at a few elements, and Adam turns each part into an lr-sized
move (``tests/test_torch_bf16.py`` measures that floor). Each tolerance is
checked beside the float32 port against the same bfloat16 JAX, which it
must fail, so that it can tell the precisions apart.
"""

import json
import os

import numpy as np
import pytest
import torch

from noise_flow_tpu.config import default_config as jax_default_config
from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
from noise_flow_tpu.parallel.mesh import make_mesh as jax_make_mesh
from noise_flow_tpu.training.trainer import Trainer as JaxTrainer
from noise_flow_tpu.utils import checkpoint as jax_ckpt
from noise_flow_tpu_torch.cli import flagship, make_sidd_scale
from noise_flow_tpu_torch.cli.args import parse_config
from noise_flow_tpu_torch.config import default_config, load_hps
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.ops import fused_train as ft
from noise_flow_tpu_torch.parallel import distributed as pd
from noise_flow_tpu_torch.parallel.mesh import make_mesh
from noise_flow_tpu_torch.training.trainer import Trainer
from noise_flow_tpu_torch.utils import checkpoint as ckpt
from test_torch_trainer import _mb, _np_tree

torch.set_num_threads(1)

FLAGSHIP = "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc"
ARCH = "sdn5|unc|gain4|unc"
BEST = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "experiments",
                    "sidd", "prod_exact_150", "ckpt", "model.ckpt-best.npz")
BIASES = ("l1_b", "l2_b")   # feed a BatchNorm: zero true gradient


def _cfg(dtype, **kw):
    return dict(arch=ARCH, patch_height=32, lr=1e-4, use_pallas=True, pallas_train_dtype=dtype,
                n_batch_train=8, n_batch_test=8, steps_per_call=2, **kw)


def _init(tmp_path):
    """The small arch's weights cut from the flagship's trained ones
    (experiments/sidd/prod_exact_150): its layers 0-2 are the flagship's
    (sdn5, the first mix and coupling), its gain4 layer is the flagship's
    (9), its last mix and coupling the flagship's next (10, 11), with the
    shared parameters; so the couplings act and the eval forward normalises
    by trained running statistics. Returns (port state dict, a port
    checkpoint of it for the JAX trainer)."""
    big = NoiseFlow((32, 32, 4), default_config(arch=FLAGSHIP), device="cpu")
    ckpt.load_checkpoint(BEST, big)
    src = {"0": "0", "1": "1", "2": "2", "3": "9", "4": "10", "5": "11"}
    init = {}
    for k, v in big.state_dict().items():
        parts = k.split(".")
        if parts[0] == "shared":
            init[k] = v
        elif parts[1] in src.values():
            idx = next(i for i, j in src.items() if j == parts[1])
            init[".".join([parts[0], idx] + parts[2:])] = v
    flow = NoiseFlow((32, 32, 4), default_config(arch=ARCH), device="cpu")
    flow.load_state_dict(init)
    return init, ckpt.save_checkpoint(str(tmp_path / "init"), 0, flow, 0)


def _jax(tmp_path, **kw):
    """(JAX trainer, the weights of ``_init`` in the port's keys)."""
    jcfg = jax_default_config(**_cfg("bfloat16", **kw))
    assert jcfg.pallas_train_dtype == "bfloat16" and jcfg.pallas_oneshot
    jtr = JaxTrainer(JaxFlow((32, 32, 4), jcfg), jcfg, mesh=jax_make_mesh(1))
    init, path = _init(tmp_path)
    jtr.params, jtr.state, _, _ = jax_ckpt.load_checkpoint(path, jtr.params, jtr.state)
    assert all(torch.equal(v, init[k]) for k, v in _jax_state(jtr).items())
    return jtr, init


def _port(init, dtype, **kw):
    cfg = default_config(**_cfg(dtype, **kw))
    flow = NoiseFlow((32, 32, 4), cfg, device="cpu")
    flow.load_state_dict(init)
    tr = Trainer(flow, cfg)
    assert tr.use_oneshot and tr.mm_dtype == dtype
    return tr


def _jax_state(jtr):
    return ckpt.from_numpy_tree(_np_tree(jtr.params), _np_tree(jtr.state))


def _moves(got, ref, init):
    """The port's parameters against JAX's, normwise over all parameters
    (the BN-fed biases left out) relative to JAX's moves from ``init``; the
    BN running statistics, largest abs difference."""
    params = [k for k in ref if ".bn" not in k and not k.endswith(BIASES)]
    num = sum(float(((got[k] - ref[k]) ** 2).sum()) for k in params)
    den = sum(float(((ref[k] - init[k]) ** 2).sum()) for k in params)
    bn = max(float((got[k] - ref[k]).abs().max()) for k in ref if ".bn" in k)
    return float(np.sqrt(num / den)), bn


# bfloat16 port against bfloat16 JAX from the trained weights of ``_init`` at
# the recipe's lr (1e-4). Measured (the float32 port's in brackets): the NLL
# rows within 1.2e-4-8.5e-4 nats (0.015-0.040), sd_z within 1.1e-7 (1.3e-6-
# 1.3e-5), the parameters' moves normwise 2.8e-5-4.1e-4 (0.039-0.079), the BN
# running statistics within 5.5e-7 abs (2.0e-5-2.5e-5). One float32 ulp at the
# input moves JAX's own bfloat16 step by 7e-3-8e-3 nats at the flagship's
# width (tests/test_torch_bf16.py), where a flip lands; these runs saw fewer.
# Each tolerance sits several times above the bfloat16 distances and below
# the float32 ones; the float32 port must fail the NLL rows and the moves.
NLL_ATOL, SDZ_ATOL, MOVES_RTOL, BN_ATOL = 5e-3, 1e-6, 5e-3, 5e-6


def _held(out, rows, moves):
    """(the port passes every tolerance, the float32 port fails the NLL
    rows, and the moves) of one comparison: ``rows`` maps each precision to
    its (NLL, sd_z) distances, ``moves`` to (moves, BN)."""
    print(f"{out}: bfloat16 port {rows['bfloat16']}, {moves['bfloat16']}; float32 port "
          f"{rows['float32']}, {moves['float32']}")
    port = (all(n <= NLL_ATOL and z <= SDZ_ATOL for n, z in rows["bfloat16"])
            and moves["bfloat16"][0] <= MOVES_RTOL and moves["bfloat16"][1] <= BN_ATOL)
    return (port, any(n > NLL_ATOL for n, _ in rows["float32"]),
            moves["float32"][0] > MOVES_RTOL)


def test_train_epoch_bf16_matches_jax(tmp_path):
    """train_epoch(steps_per_call=2) over 4 batches (two groups) on the
    one-shot path in bfloat16, against JAX's scan epoch from the same
    weights: the epoch's NLL and sd_z, the weights and the BN state."""
    batches = [_mb(8, s) for s in range(4)]
    jtr, init = _jax(tmp_path)
    rows_j = jtr.train_epoch(iter(batches), steps_per_call=2)
    ref = _jax_state(jtr)
    rows, moves = {}, {}
    for dtype in ("bfloat16", "float32"):
        tr = _port(init, dtype)
        got = tr.train_epoch(iter(batches), steps_per_call=2)
        rows[dtype] = [(abs(got[0] - rows_j[0]), abs(got[1] - rows_j[1]))]
        moves[dtype] = _moves(tr.flow.state_dict(), ref, init)
        # the BN-fed conv biases get exact-zero gradients on both sides, so
        # Adam leaves them where they were (fault C: the port's plain step
        # moved them by lr a step)
        biases = [k for k in init if k.endswith(BIASES)]
        assert all(torch.equal(tr.flow.state_dict()[k], init[k]) for k in biases)
        assert all(torch.equal(ref[k], init[k]) for k in biases)
    assert _held("train_epoch", rows, moves) == (True, True, True)


def test_staged_fit_bf16_matches_jax(tmp_path):
    """A staged 2-epoch fit (4 train steps an epoch, two groups of 2; 2 test
    batches, one group) in bfloat16 against JAX's: the train.txt and
    test.txt rows (epoch 1's test row is the bfloat16 eval forward with the
    running statistics, ``bnrun``, on the initial weights; epoch 2's after 4
    steps, through the BN state they wrote) and the weights."""
    train = [_mb(8, s) for s in range(4)]
    test = [_mb(8, 10 + s) for s in range(2)]
    jtr, init = _jax(tmp_path, epochs=2)

    def fit(tr, logdir):
        tr.stage_dataset(iter(train), "train")
        tr.stage_dataset(iter(test), "test")
        tr.fit(None, None, str(logdir), do_sampling=False, verbose=False)
        return [(r, int(x["epoch"]), float(x["NLL"]), float(x["sdz"])) for r in ("train", "test")
                for x in flagship.read_tsv(os.path.join(logdir, f"{r}.txt"))]
    rows_j = fit(jtr, tmp_path / "jax")
    ref = _jax_state(jtr)
    rows, moves = {}, {}
    for dtype in ("bfloat16", "float32"):
        tr = _port(init, dtype, epochs=2)
        got = fit(tr, tmp_path / dtype)
        assert [r[:2] for r in got] == [r[:2] for r in rows_j] == [
            ("train", 1), ("train", 2), ("test", 1), ("test", 2)]
        rows[dtype] = [(abs(a[2] - b[2]), abs(a[3] - b[3])) for a, b in zip(got, rows_j)]
        moves[dtype] = _moves(tr.flow.state_dict(), ref, init)
    assert _held("staged fit", rows, moves) == (True, True, True)


def _staged_eval(tr):
    return tr._staged_steps("test", tr._staged_test_steps(), 2, False)


def test_eval_reads_the_updated_bn_buffers(tmp_path, monkeypatch):
    """The bfloat16 eval after further train steps reads the BN buffers
    those steps wrote (``apply_state`` copies into them; a captured eval
    graph replays the same reads): it equals the eval of a new trainer
    loaded with the state, and differs from the eval before the steps. A
    planted fault, running moments kept from the first eval (stale), must
    differ from that reference."""
    cfg = default_config(**dict(_cfg("bfloat16"), lr=1e-3))
    init, _ = _init(tmp_path)

    def trainer(state=init):
        tr = Trainer(NoiseFlow((32, 32, 4), cfg, device="cpu"), cfg)
        tr.flow.load_state_dict(state)
        tr.stage_dataset(iter([_mb(8, s) for s in range(4)]), "train")
        tr.stage_dataset(iter([_mb(8, 10 + s) for s in range(2)]), "test")
        return tr

    def train_then_eval(tr):
        before = _staged_eval(tr)
        tr._train_epoch_staged(3)
        return before, _staged_eval(tr), {k: v.clone() for k, v in tr.flow.state_dict().items()}

    before, after, state = train_then_eval(trainer())
    fresh = _staged_eval(trainer(state))
    assert all(torch.equal(a, b) for a, b in zip(after, fresh))
    assert not torch.equal(after[0], before[0])
    assert any(not torch.equal(state[k], trainer().flow.state_dict()[k])
               for k in state if ".bn" in k)

    kept = {}
    real = ft.FusedFlow.running_moments

    def stale(self, lo, hi):
        if (lo, hi) not in kept:
            kept[(lo, hi)] = real(self, lo, hi).clone()
        return kept[(lo, hi)]
    monkeypatch.setattr(ft.FusedFlow, "running_moments", stale)
    _, planted, _ = train_then_eval(trainer())
    assert kept and not torch.equal(planted[0], fresh[0])


def test_make_mesh_and_spawn_ranks_default_to_the_card(monkeypatch):
    """Without a device argument both take the card and, where none is
    present, raise before any process starts; ``"cpu"`` still runs."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make_mesh()
    with pytest.raises(RuntimeError, match="is_available"):
        pd.spawn_ranks(2, max)
    assert make_mesh(None, "cpu").device == torch.device("cpu")


# cfg fields that each recipe must take from its record's hps.txt
RECIPE_FIELDS = ("arch", "width", "lr", "n_batch_train", "n_batch_test", "patch_height",
                 "n_patches_per_image", "patch_sampling", "epochs_full_valid", "temp", "seed",
                 "optim", "use_pallas", "pallas_train_dtype", "pallas_oneshot",
                 "per_example_cond", "n_levels", "coupling_nn", "sidd_cond", "epochs")


@pytest.mark.parametrize("name", sorted(flagship.RECIPES))
def test_recipe_flags_are_the_records(name):
    """Each recipe's cli.train flags give the config its JAX run recorded in
    hps.txt, --epochs at the recipe's default; K is 32 on every path (the
    job script's; prod_synth_scale's run took 16, which groups the same
    steps)."""
    recipe = flagship.RECIPES[name]
    _, cfg = parse_config(recipe.flags + ["--epochs", str(recipe.epochs)])
    rec = load_hps(os.path.join(recipe.record, "hps.txt"))
    assert {f: getattr(cfg, f) for f in RECIPE_FIELDS if f != "epochs" or name != "prod-exact"} \
        == {f: getattr(rec, f) for f in RECIPE_FIELDS if f != "epochs" or name != "prod-exact"}
    assert cfg.steps_per_call == 32


def _fake_report(name, shift_train, shift_test, sdz=1.0, cells=15):
    """A report whose rows are the record's moved by the given nats."""
    record = flagship.RECIPES[name].record
    rep = {}
    for r, d in (("train", shift_train), ("test", shift_test)):
        rows = flagship.compare_rows(os.path.join(record, f"{r}.txt"),
                                     os.path.join(record, f"{r}.txt"))
        for x in rows:
            x["NLL"] += d
            x["sdz"] = sdz
        rep[f"{r}_rows"] = rows
    rep["sweeps"] = {"port_best_seed0": {"cells_nf_below_g_at_temp1": cells}}
    return rep


def test_recipe_gates():
    """The gates at the record's last epoch: within 20 / 30 nats of the
    bn_delta rows and more than 100 above the exact-BN row; the
    prod-synth-scale sd_z and sweep cells; nothing before the last epoch,
    and none for prod-exact."""
    def ok(name, *a, **k):
        return {g: v["ok"] for g, v in flagship.recipe_gates(name, _fake_report(name, *a, **k))
                .items() if isinstance(v, dict)}
    assert ok("ghost", 19.0, -29.0) == {"train_nll": True, "test_nll": True,
                                        "above_exact": True}
    assert ok("ghost-f32", -21.0, 31.0) == {"train_nll": False, "test_nll": False,
                                            "above_exact": True}
    # JAX's ghost run sits 131.05 nats above its exact run at epoch 60
    assert ok("ghost", -19.0, 0.0)["above_exact"] and not ok("ghost", -40.0, 0.0)["above_exact"]
    assert ok("prod-synth-scale", 0.0, 0.0, sdz=1.04) == {
        "sdz": True, "cells_nf_below_g_at_temp1": True}
    assert ok("prod-synth-scale", 0.0, 0.0, sdz=0.94, cells=14) == {
        "sdz": False, "cells_nf_below_g_at_temp1": False}
    rep = _fake_report("ghost", 0.0, 0.0)
    rep["train_rows"] = rep["train_rows"][:10]
    assert flagship.recipe_gates("ghost", rep)["reached"] is False
    assert flagship.recipe_gates("prod-exact", rep) is None


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A SIDD-scale corpus at a small frame: 2 train and 1 test scene of
    512x1024 Bayer (512 train and 256 test patches of 32x32)."""
    root = str(tmp_path_factory.mktemp("corpus") / "SIDD_Medium_Raw_synth" / "Data")
    assert make_sidd_scale.main(["--root", root, "--n_train", "2", "--n_test", "1",
                                 "--height", "512", "--width", "1024",
                                 "--mat_version", "v5"]) == 0
    return root


def test_flagship_ghost_recipe_reports_against_bn_delta(corpus, tmp_path, monkeypatch):
    """``cli.flagship --recipe ghost`` for one epoch on the CPU: cli.train
    with the recipe's flags (one-shot kernel path in bfloat16, K = 32), and a
    report that sets train.txt, test.txt and sample.txt (NLL, sd_z and the
    KLD columns) beside bn_delta/ghost's, with each epoch's train gap and the
    gates not yet reached."""
    ghost = flagship.RECIPES["ghost"]
    monkeypatch.setitem(flagship.RECIPES, "ghost", ghost._replace(
        flags=ghost.flags + ["--staged_test_patches", "138"]))
    work = tmp_path / "work"
    os.makedirs(work / "SIDD_Medium_Raw_synth")
    os.symlink(corpus, work / "SIDD_Medium_Raw_synth" / "Data")
    assert flagship.main(["--work", str(work), "--recipe", "ghost", "--epochs", "1",
                          "--device", "cpu", "--steps", "train,report"]) == 0
    rep = json.load(open(work / "flagship_ghost.json"))
    logdir = work / "ghost"
    hps = load_hps(str(logdir / "hps.txt"))
    assert (hps.use_pallas, hps.pallas_train_dtype, hps.steps_per_call) == (True, "bfloat16", 32)
    assert rep["recipe"]["record"] == os.path.join("experiments", "sidd", "bn_delta", "ghost")
    assert "native loader" in rep["recipe"]["note"]
    record = {r: flagship.read_tsv(os.path.join(ghost.record, f"{r}.txt"))[0]
              for r in ("train", "test", "sample")}
    for r, cols in (("train", ("NLL", "sdz")), ("test", ("NLL", "sdz")),
                    ("sample", flagship.SAMPLE_COLS)):
        (row,) = rep[f"{r}_rows"]
        assert row["epoch"] == 1
        for c in cols:
            assert row[f"jax_{c}"] == float(record[r][c]) and np.isfinite(row[c]), (r, c)
    assert rep["train_gap"]["epoch_of_max"] == 1
    assert rep["gates"] == {"reached": False, "record_epoch": 60, "epoch": 1}
    assert rep["calls"][0]["recipe"] == "ghost"
