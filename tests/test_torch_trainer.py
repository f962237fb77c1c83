"""noise_flow_tpu_torch.training.trainer, utils.checkpoint and cli.train
against the JAX package, on the CPU: a 3-step trajectory with use_pallas on
and off, Adam against optax, checkpoints read across the two packages, and
the train CLI's artifacts."""

import logging
import os

import jax
import numpy as np
import optax
import pytest
import torch

from noise_flow_tpu.config import default_config as jax_default_config
from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
from noise_flow_tpu.parallel.mesh import make_mesh
from noise_flow_tpu.training.trainer import Trainer as JaxTrainer
from noise_flow_tpu.utils import checkpoint as jax_ckpt
from noise_flow_tpu_torch.config import default_config
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.training.trainer import Trainer, make_optimizer
from noise_flow_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

ARCH = "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc"
FIVE_SCALE = "sdn|gain|sdn1|gain1|sdn2|unc"  # beyond the one-shot step's 4 scale layers


def _np_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


def _mb(b, seed):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0.01, 0.9, (b, 32, 32, 4)).astype(np.float32)
    x = (rng.standard_normal((b, 32, 32, 4)) * np.sqrt(0.0005 * clean + 2e-6)).astype(np.float32)
    return {"_x": x, "_y": clean, "nlf0": np.full((b,), 0.0005, np.float32),
            "nlf1": np.full((b,), 2e-6, np.float32),
            "iso": rng.choice([100, 400, 800, 1600, 3200], b).astype(np.float32),
            "cam": np.full((b,), 2.0, np.float32)}


def _port_from_jax(jtr, cfg):
    flow = NoiseFlow((32, 32, 4), cfg, device="cpu")
    flow.load_state_dict(ckpt.from_numpy_tree(_np_tree(jtr.params), _np_tree(jtr.state)))
    return flow


# 3 Adam steps at lr 1e-3 from the same weights on the same batches. Float32
# gradients agree to about 1e-5 of their scale; Adam normalises each step, so
# a parameter whose gradient is near zero can differ by up to lr a step.
# Observed: every parameter within 5e-5 of JAX's, after moves of up to
# 3e-3. Conv biases that feed a BatchNorm are left out: their true gradient
# is zero and, on the plain path, each side's rounding becomes lr-sized Adam
# steps (the fused path gives exact zeros on both sides); on the plain path
# the BN running means, which carry those biases, are left out too.
# The segment path ("segment": pallas_oneshot=False; "five_scale": an arch
# beyond the one-shot step's four scale layers) is held to the same bounds.
@pytest.mark.parametrize("use_pallas,oneshot,arch", [
    (False, True, ARCH), (True, True, ARCH), (True, False, ARCH), (True, True, FIVE_SCALE),
], ids=["False", "True", "segment", "five_scale"])
def test_trainer_trajectory_matches_jax(use_pallas, oneshot, arch):
    kw = dict(arch=arch, patch_height=32, lr=1e-3, use_pallas=use_pallas,
              pallas_oneshot=oneshot, pallas_train_dtype="float32")
    jtr = JaxTrainer(JaxFlow((32, 32, 4), jax_default_config(**kw)), jax_default_config(**kw),
                     mesh=make_mesh(1))
    cfg = default_config(**kw)
    tr = Trainer(_port_from_jax(jtr, cfg), cfg)
    assert tr.use_fused == jtr.use_fused == use_pallas
    assert tr.use_oneshot == jtr.use_oneshot == (use_pallas and oneshot and arch == ARCH)
    batches = [_mb(8, s) for s in range(3)]
    nll_j, sdz_j = jtr.train_epoch(iter(batches))
    nll_t, sdz_t = tr.train_epoch(iter(batches))
    np.testing.assert_allclose(nll_t, nll_j, rtol=1e-5)
    np.testing.assert_allclose(sdz_t, sdz_j, rtol=1e-5)
    ref = ckpt.from_numpy_tree(_np_tree(jtr.params), _np_tree(jtr.state))
    got = tr.flow.state_dict()
    skip = ("l1_b", "l2_b") + (() if use_pallas else ("bn1.mean", "bn2.mean"))
    for k, v in ref.items():
        if k.endswith(skip):
            continue
        # BN running statistics as well as parameters
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4, err_msg=k)
    ev_j = jtr.eval_epoch(iter(batches[:1]))
    ev_t = tr.eval_epoch(iter(batches[:1]))
    # the eval NLL and sd_z after the steps, through each side's own weights
    # (observed: NLL within 4e-7 relative, 3.1e-6 for the 5-scale arch, sd_z
    # within 8e-6 absolute)
    np.testing.assert_allclose(ev_t[0], ev_j[0], rtol=1e-5)
    np.testing.assert_allclose(ev_t[1], ev_j[1], atol=5e-5)


@pytest.mark.parametrize("optim", ["adam", "sgd"])
def test_optimizer_matches_optax(optim):
    """torch Adam / SGD-momentum against the JAX package's optimizer
    (optax.flatten(optax.adam)), 5 steps of the same gradients."""
    from noise_flow_tpu.training.trainer import make_optimizer as jax_make_optimizer

    cfg = default_config(optim=optim, lr=1e-2)
    rng = np.random.default_rng(0)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal((5,)).astype(np.float32)}
    grads = [{k: rng.standard_normal(v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(5)]
    jopt = jax_make_optimizer(jax_default_config(optim=optim, lr=1e-2))
    jp, js = dict(p0), None
    js = jopt.init(jp)
    for g in grads:
        upd, js = jopt.update(g, js, jp)
        jp = optax.apply_updates(jp, upd)
    tp = {k: torch.nn.Parameter(torch.as_tensor(v)) for k, v in p0.items()}
    topt = make_optimizer(cfg, list(tp.values()))
    for g in grads:
        for k, p in tp.items():
            p.grad = torch.as_tensor(g[k])
        topt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def _trained_port(tmp_path, steps=2):
    cfg = default_config(arch="sdn5|unc|gain4|unc", lr=1e-3)
    tr = Trainer(NoiseFlow((32, 32, 4), cfg, device="cpu"), cfg)
    tr.train_epoch(iter([_mb(4, s) for s in range(steps)]))
    return cfg, tr


def test_checkpoint_port_to_jax_and_back(tmp_path, caplog):
    """A port checkpoint with its optimizer slots: the port resumes all of
    it; the JAX package reads params and state and resumes without the
    slots (its warning); a JAX checkpoint loads into the port the same way."""
    cfg, tr = _trained_port(tmp_path)
    path = ckpt.save_checkpoint(str(tmp_path), 3, tr.flow, 3, tr.optimizer)
    back = NoiseFlow((32, 32, 4), cfg, device="cpu", seed=5)
    opt = make_optimizer(cfg, list(back.parameters()))
    assert ckpt.load_checkpoint(path, back, opt) == 3
    for k, v in tr.flow.state_dict().items():
        assert torch.equal(back.state_dict()[k], v), k
    for p, q in zip(tr.flow.parameters(), back.parameters()):
        for slot, v in tr.optimizer.state[p].items():
            assert torch.equal(opt.state[q][slot], v), slot

    jcfg = jax_default_config(arch="sdn5|unc|gain4|unc", lr=1e-3)
    jflow = JaxFlow((32, 32, 4), jcfg)
    p0, s0 = jflow.init(jax.random.PRNGKey(0))
    jtr = JaxTrainer(jflow, jcfg, mesh=make_mesh(1))
    with caplog.at_level(logging.WARNING):
        params, state, opt_state, ep = jax_ckpt.load_checkpoint(path, p0, s0, jtr.opt_state)
    assert ep == 3 and opt_state is None
    assert "optimizer state layout does not match" in caplog.text
    got = ckpt.from_numpy_tree(_np_tree(params), _np_tree(state))
    for k, v in tr.flow.state_dict().items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)

    caplog.clear()
    jpath = jax_ckpt.save_checkpoint(str(tmp_path / "j"), 7, params, state, jtr.opt_state, 7)
    back2 = NoiseFlow((32, 32, 4), cfg, device="cpu", seed=6)
    opt2 = make_optimizer(cfg, list(back2.parameters()))
    with caplog.at_level(logging.WARNING):
        assert ckpt.load_checkpoint(jpath, back2, opt2) == 7
    assert "optimizer state layout does not match" in caplog.text and not opt2.state
    for k, v in tr.flow.state_dict().items():
        assert torch.equal(back2.state_dict()[k], v), k


def test_fit_writes_logs_checkpoints_and_resumes(tmp_path):
    """Trainer.fit on staged data: the JAX column schemas, finite KLDs, the
    checkpoints, and continue_training picking up after the last epoch."""
    cfg = default_config(arch="sdn5|unc|gain4|unc", lr=1e-3, n_batch_train=4,
                         n_batch_test=4, epochs=2)
    tr = Trainer(NoiseFlow((32, 32, 4), cfg, device="cpu"), cfg)
    assert tr.stage_dataset(iter([_mb(4, 0), _mb(4, 1)]), "train") == 8
    assert tr.stage_dataset(iter([_mb(4, 2)]), "test") == 4
    hist = tr.fit(None, None, str(tmp_path), nll_gauss=1.0, nll_sdn=2.0, sc_sd=0.02,
                  verbose=False)
    assert len(hist["train"]) == 2 and np.isfinite(hist["train"]).all()
    cols = ["epoch", "NLL", "NLL_G", "NLL_SDN", "sdz"]
    for name, extra in (("train.txt", ["train_time"]), ("test.txt", ["msg"]),
                        ("sample.txt", ["sample_time", "KLD_G", "KLD_NLF", "KLD_NF", "KLD_R"])):
        rows = [r.split("\t") for r in open(tmp_path / name).read().splitlines()]
        assert rows[0] == cols + extra and len(rows) == 3, name
        assert np.isfinite(np.asarray(rows[1:], float)).all(), name
    assert {"model.ckpt-1.npz", "model.ckpt-2.npz", "model.ckpt-best.npz"} <= set(
        os.listdir(tmp_path / "ckpt"))
    cfg.continue_training, cfg.epochs = True, 3
    tr2 = Trainer(NoiseFlow((32, 32, 4), cfg, device="cpu", seed=4), cfg)
    tr2._staged_train, tr2._staged_test = tr._staged_train, tr._staged_test
    hist2 = tr2.fit(None, None, str(tmp_path), do_sampling=False, verbose=False)
    assert len(hist2["train"]) == 1          # epoch 3 only
    assert len(open(tmp_path / "train.txt").read().splitlines()) == 4


def test_trainer_refuses_what_is_not_ported():
    """A mesh of 2 ranks outside a process group of 2 raises, as JAX's
    make_mesh(2) without two devices; one rank is the default mesh.
    pallas_oneshot=False and an arch beyond the one-shot step's envelope
    train through the segment path, as the JAX trainer chooses, with its
    block pick_block(b) (128 at b = 128, where the one-shot step takes 64).
    (Meshes of 2 ranks: tests/test_torch_parallel.py.)"""
    from noise_flow_tpu_torch.parallel.mesh import make_mesh as port_make_mesh

    cfg = default_config(arch=ARCH)
    with pytest.raises(ValueError, match="a mesh of 2 ranks needs a process group of 2"):
        Trainer(NoiseFlow((32, 32, 4), cfg, device="cpu"), cfg, mesh=port_make_mesh(2))
    tr = Trainer(NoiseFlow((32, 32, 4), cfg, device="cpu"), cfg)
    assert (tr.mesh.size, tr.mesh.rank) == (1, 0)
    for kw in (dict(arch=ARCH, use_pallas=True, pallas_oneshot=False),
               dict(arch=FIVE_SCALE, use_pallas=True)):
        cfg = default_config(**kw)
        tr = Trainer(NoiseFlow((32, 32, 4), cfg, device="cpu"), cfg)
        jcfg = jax_default_config(**kw)
        jtr = JaxTrainer(JaxFlow((32, 32, 4), jcfg), jcfg, mesh=make_mesh(1))
        assert tr.use_fused and jtr.use_fused and not tr.use_oneshot and not jtr.use_oneshot
        assert tr._fused_for_batch(138).bt == 69 and tr._fused_for_batch(128).bt == 128


def test_trainer_outside_envelope_takes_the_plain_path(caplog):
    cfg = default_config(arch="sdn5|unc|gain4|unc", patch_height=16, use_pallas=True)
    with caplog.at_level(logging.WARNING):
        tr = Trainer(NoiseFlow((16, 16, 4), cfg, device="cpu"), cfg)
    assert not tr.use_fused and "outside the fused envelope" in caplog.text


def test_cli_train_writes_the_jax_schemas(tmp_path):
    from noise_flow_tpu_torch.cli.train import main

    logdir = str(tmp_path / "run")
    assert main(["--synthetic_data", "2", "--patch_height", "32", "--n_batch_train", "8",
                 "--epochs", "2", "--device", "cpu", "--logdir", logdir, "--do_sample"]) == 0
    heads = {n: open(os.path.join(logdir, n)).readline().split() for n in
             ("train.txt", "test.txt", "sample.txt")}
    assert heads == {
        "train.txt": ["epoch", "NLL", "NLL_G", "NLL_SDN", "sdz", "train_time"],
        "test.txt": ["epoch", "NLL", "NLL_G", "NLL_SDN", "sdz", "msg"],
        "sample.txt": ["epoch", "NLL", "NLL_G", "NLL_SDN", "sdz", "sample_time", "KLD_G",
                       "KLD_NLF", "KLD_NF", "KLD_R"]}
    rows = open(os.path.join(logdir, "sample.txt")).read().splitlines()[1:]
    assert len(rows) == 2 and np.isfinite(np.asarray([r.split() for r in rows], float)).all()
    for name in ("hps.txt", "model_vars.txt", "total_time.txt", "ckpt/model.ckpt-best.npz"):
        assert os.path.exists(os.path.join(logdir, name)), name
    # --mesh above the visible cards raises; coordinator mode runs (here a
    # group of one process)
    with pytest.raises(ValueError, match="--mesh 2 needs 2 cards"):
        main(["--mesh", "2", "--device", "cuda"])
    from noise_flow_tpu_torch.parallel.distributed import free_port

    port = free_port()
    coord = str(tmp_path / "coord")
    assert main(["--synthetic_data", "2", "--patch_height", "32", "--n_batch_train", "8",
                 "--epochs", "1", "--device", "cpu", "--logdir", coord,
                 "--coordinator_address", f"localhost:{port}", "--num_processes", "1",
                 "--process_id", "0"]) == 0
    assert len(open(os.path.join(coord, "train.txt")).read().splitlines()) == 2
