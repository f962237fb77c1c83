"""K steps a dispatch (``steps_per_call``) in noise_flow_tpu_torch's Trainer
against the JAX trainer's ``lax.scan`` epochs, on the CPU, where a group of
K is K eager steps: the host-batch epoch (``_train_epoch_scan``) with full
groups, a batch-shape change and a ragged tail, on the plain and the
one-shot path; the staged epoch against the streamed one in the same order
and against JAX's; the staged eval against JAX's ``_eval_epoch_staged``;
and a condSDN flow's staged epoch, which takes eval steps. The port starts
from the JAX trainer's weights, as ``tests/test_torch_trainer.py`` does.
Tolerances are those of ``test_trainer_trajectory_matches_jax``."""

import numpy as np
import pytest
import torch

from noise_flow_tpu.config import default_config as jax_default_config
from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
from noise_flow_tpu.parallel.mesh import make_mesh
from noise_flow_tpu.training.trainer import Trainer as JaxTrainer
from noise_flow_tpu_torch.config import default_config
from noise_flow_tpu_torch.training.trainer import Trainer
from noise_flow_tpu_torch.utils import checkpoint as ckpt
from test_torch_trainer import _mb, _np_tree, _port_from_jax

torch.set_num_threads(1)

ARCH = "sdn5|unc|gain4|unc"
_KEEP = ("_x", "_y", "nlf0", "nlf1", "iso", "cam")


def _pair(**kw):
    """(JAX trainer, port trainer) from the same weights, Adam at the
    flagship's learning rate. (At lr 1e-3 the six steps of one epoch below
    move a plain-path weight whose gradient is near zero by up to 1.2e-4
    from JAX's: Adam turns each side's rounding into lr-sized steps, as
    ``test_trainer_trajectory_matches_jax`` notes for its three.)"""
    kw = dict(dict(arch=ARCH, patch_height=32, lr=1e-4, pallas_train_dtype="float32"), **kw)
    jcfg = jax_default_config(**kw)
    jtr = JaxTrainer(JaxFlow((32, 32, 4), jcfg), jcfg, mesh=make_mesh(1))
    cfg = default_config(**kw)
    return jtr, Trainer(_port_from_jax(jtr, cfg), cfg)


def _assert_weights(tr, jtr, plain: bool):
    """The port's parameters and BN state against JAX's, leaving out what
    ``test_trainer_trajectory_matches_jax`` leaves out: the BN-fed conv
    biases and, on the plain path, the BN running means that carry them."""
    ref = ckpt.from_numpy_tree(_np_tree(jtr.params), _np_tree(jtr.state))
    got = tr.flow.state_dict()
    skip = ("l1_b", "l2_b") + (("bn1.mean", "bn2.mean") if plain else ())
    for k, v in ref.items():
        if not k.endswith(skip):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=1e-4,
                                       err_msg=k)


# groups of 2: steps (0, 1) a group; step 2 alone (the batch shape changes
# after it); (3, 4) a group; step 5 the ragged tail. The one-shot path takes
# the first three (a group and a ragged tail), one kernel block for JAX to
# compile.
@pytest.mark.parametrize("use_pallas,shapes", [(False, (8, 8, 8, 4, 4, 4)), (True, (8, 8, 8))],
                         ids=["plain", "oneshot"])
def test_train_epoch_scan_matches_jax(use_pallas, shapes):
    """train_epoch(steps_per_call=2) against JAX's over full groups, a
    batch-shape change and a ragged tail; and the port's K = 2 against its
    K = 1 from the same weights, to the bit (on the CPU a group is its
    steps)."""
    jtr, tr = _pair(use_pallas=use_pallas)
    _, tr1 = _pair(use_pallas=use_pallas)
    assert tr.use_oneshot == jtr.use_oneshot == use_pallas
    batches = [_mb(b, s) for s, b in enumerate(shapes)]
    nll_j, sdz_j = jtr.train_epoch(iter(batches), steps_per_call=2)
    nll_t, sdz_t = tr.train_epoch(iter(batches), steps_per_call=2)
    np.testing.assert_allclose(nll_t, nll_j, rtol=1e-5)
    np.testing.assert_allclose(sdz_t, sdz_j, rtol=1e-5)
    _assert_weights(tr, jtr, plain=not use_pallas)
    assert tr1.train_epoch(iter(batches), steps_per_call=1) == (nll_t, sdz_t)
    for k, v in tr1.flow.state_dict().items():
        assert torch.equal(v, tr.flow.state_dict()[k]), k


def test_staged_epoch_and_eval_match_streamed_and_jax():
    """The staged epoch (cfg.steps_per_call = 2, 5 steps: two groups and a
    tail) against JAX's on the same seed, which draws the same permutation,
    and against the port's streamed epoch over that order; then the staged
    eval (3 test batches: a group and a tail) against JAX's
    _eval_epoch_staged, which scans them all."""
    kw = dict(n_batch_train=8, n_batch_test=8, steps_per_call=2)
    jtr, tr = _pair(**kw)
    _, streamed = _pair(**kw)
    batches = [_mb(8, s) for s in range(5)]
    tests = [_mb(8, 10 + s) for s in range(3)]
    assert jtr.stage_dataset(iter(batches), "train") == tr.stage_dataset(iter(batches)) == 40
    jtr.stage_dataset(iter(tests), "test")
    tr.stage_dataset(iter(tests), "test")
    nll_j, sdz_j = jtr._train_epoch_staged(7)
    nll_t, sdz_t = tr._train_epoch_staged(7)
    np.testing.assert_allclose(nll_t, nll_j, rtol=1e-5)
    np.testing.assert_allclose(sdz_t, sdz_j, rtol=1e-5)
    _assert_weights(tr, jtr, plain=True)
    host = {k: np.concatenate([mb[k] for mb in batches]) for k in _KEEP}
    order = np.random.default_rng(7).permutation(40).reshape(5, 8)
    n_s = streamed.train_epoch(({k: v[row] for k, v in host.items()} for row in order))
    np.testing.assert_allclose(n_s, (nll_t, sdz_t), rtol=1e-6)
    for k, v in streamed.flow.state_dict().items():
        np.testing.assert_allclose(v.numpy(), tr.flow.state_dict()[k].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    ev_j = jtr._eval_epoch_staged()
    ev_t = tr._eval_epoch_staged()
    np.testing.assert_allclose(ev_t[0], ev_j[0], rtol=1e-5)
    np.testing.assert_allclose(ev_t[1], ev_j[1], atol=5e-5)
    np.testing.assert_allclose(ev_t, tr.eval_epoch(iter(tests)), rtol=1e-6)


def test_condsdn_staged_epoch_takes_eval_steps():
    """A condSDN flow never trains: its staged epoch (steps_per_call = 2)
    is eval steps over the permuted set, as JAX's _eval_scan_idx, and
    leaves every weight as it was."""
    jtr, tr = _pair(arch="", sidd_cond="condSDN", depth=1, n_batch_train=8, steps_per_call=2)
    assert not tr.trainable and not jtr.trainable
    before = {k: v.clone() for k, v in tr.flow.state_dict().items()}
    batches = [_mb(8, 20 + s) for s in range(3)]
    jtr.stage_dataset(iter(batches), "train")
    tr.stage_dataset(iter(batches), "train")
    nll_j, sdz_j = jtr._train_epoch_staged(3)
    nll_t, sdz_t = tr._train_epoch_staged(3)
    np.testing.assert_allclose(nll_t, nll_j, rtol=1e-5)
    np.testing.assert_allclose(sdz_t, sdz_j, rtol=1e-5)
    for k, v in tr.flow.state_dict().items():
        assert torch.equal(v, before[k]), k
