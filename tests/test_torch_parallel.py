"""noise_flow_tpu_torch.parallel and the trainers' mesh paths against the JAX
package, on the CPU: two gloo ranks in two processes of this file
(``python tests/test_torch_parallel.py WORKDIR RANK PORT``, coordinator
mode, each rank fed its own half of every global batch) against JAX's
``Trainer(..., make_mesh(2))`` in this process on the same global batches,
and against the port's own single rank; the stats helpers against JAX's
multi-process code; ``cli.train --mesh 2 --device cpu`` and the stats cache
against JAX's ``cli.train``.

Shapes are small: the arch ``sdn5|unc|gain4|unc`` (two couplings, two
scale layers) on 32x32x4 patches, global batches of 16 (138 for the
one-shot path's groups of 69), torch on one thread a process. The workers
run once for the module; each has its own time limit.
"""

import csv
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "sdn5|unc|gain4|unc"
BATCH, N_BATCHES, EPOCHS = 16, 3, 2
WORKER_TIMEOUT = 300          # seconds, each worker process
# JAX's own tolerances for its 2-process run (tests/test_multiprocess.py:82-83)
NLL_TOL = dict(rtol=5e-5, atol=0.05)
# gradients, as tests/test_distributed.py:57-60: rtol 1e-4, atol 1e-5 max|g|
GRAD_RTOL, GRAD_ATOL_SCALE = 1e-4, 1e-5
# parameters after the steps, as tests/test_torch_trainer.py holds the port's
# one-rank trajectory to JAX's (Adam at lr 1e-3). Left out: the biases that
# feed a BatchNorm, whose true gradient is zero (each side's rounding becomes
# lr-sized Adam steps), and the BN running means that carry them (0.1 lr a
# step); the fused paths zero those gradients in the port's kernel, JAX's
# leave a rounding. Observed here: parameters within 0.38 of the
# tolerance on the plain path, 0.14 on the fused paths; the planted fault
# 42 times it.
PARAM_TOL = dict(rtol=1e-4, atol=1e-4)
LR = 1e-3


def _mb(b, seed):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0.01, 0.9, (b, 32, 32, 4)).astype(np.float32)
    x = (rng.standard_normal((b, 32, 32, 4)) * np.sqrt(0.0005 * clean + 2e-6)).astype(np.float32)
    return {"_x": x, "_y": clean, "nlf0": np.full((b,), 0.0005, np.float32),
            "nlf1": np.full((b,), 2e-6, np.float32),
            "iso": rng.choice([100, 400, 800, 1600, 3200], b).astype(np.float32),
            "cam": np.full((b,), 2.0, np.float32)}


def _local(mb, rank, world):
    b = mb["_x"].shape[0]
    return {k: v[rank * b // world:(rank + 1) * b // world] for k, v in mb.items()}


def _batches(b=BATCH, n=N_BATCHES, seed0=0):
    return [_mb(b, seed0 + s) for s in range(n)]


# the scenarios: (name, config kwargs, global batch, batches, epochs)
FLOW_RUNS = (
    ("plain", dict(use_pallas=False), BATCH, N_BATCHES, EPOCHS),
    ("oneshot", dict(use_pallas=True, pallas_oneshot=True), BATCH, 2, 1),
    ("segment", dict(use_pallas=True, pallas_oneshot=False), BATCH, 2, 1),
    ("oneshot138", dict(use_pallas=True, pallas_oneshot=True), 138, 2, 1),
)


def _cfg_kw(kw):
    return dict(arch=ARCH, patch_height=32, lr=LR, pallas_train_dtype="float32", **kw)


def _flow_run(kw, state_dict, batches, epochs, mesh, feed, local_bn=False):
    """Train ``epochs`` epochs over ``batches`` (each fed through ``feed``)
    from ``state_dict``; the per-epoch train NLL, the eval (nll, sd_z) of the
    first batch, and the state after. ``local_bn``: the planted fault, each
    rank's own BatchNorm moments in place of the global ones."""
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.training.trainer import Trainer

    cfg = default_config(**_cfg_kw(kw))
    flow = NoiseFlow((32, 32, 4), cfg, device="cpu")
    flow.load_state_dict(state_dict)
    tr = Trainer(flow, cfg, mesh)
    if local_bn:
        tr.bn_psum = None
    nlls = [tr.train_epoch(iter([feed(b) for b in batches]))[0] for _ in range(epochs)]
    ev = tr.eval_epoch(iter([feed(batches[0])]))
    return {"nlls": np.asarray(nlls), "eval": np.asarray(ev),
            "state": {k: v.clone() for k, v in flow.state_dict().items()}}


def _grads(state_dict, batch, mesh, local_bn=False):
    """Every parameter's gradient of one plain-path step from state_dict on
    (this rank's part of) batch, after the trainer's reduction."""
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.training.trainer import Trainer

    cfg = default_config(**_cfg_kw({}))
    flow = NoiseFlow((32, 32, 4), cfg, device="cpu")
    flow.load_state_dict(state_dict)
    tr = Trainer(flow, cfg, mesh)
    if local_bn:
        tr.bn_psum = None
    tr.train_step(tr._put(batch))
    return {k: p.grad.clone() for k, p in flow.named_parameters() if p.grad is not None}


def _dncnn(source, mesh, clean, noisy, epochs, noise_flow=None):
    from noise_flow_tpu_torch.training.dncnn_trainer import DnCNNTrainer

    t = DnCNNTrainer(depth=4, filters=8, lr=1e-3, noise_source=source, noise_flow=noise_flow,
                     cam_iso_rows=[(2, 100.0, 0.000479, 2e-6), (3, 1600.0, 0.008211, 2e-6)],
                     device="cpu", mesh=mesh)
    noises = []
    make = t._make_noise
    t._make_noise = lambda *a: noises.append(make(*a)) or noises[-1]
    rng = np.random.default_rng(5)
    losses = [t.train_epoch(clean, 16, rng, noisy=noisy, shuffle_seed=e)
              for e in range(epochs)]
    return {"losses": np.asarray(losses), "noises": [n.numpy() for n in noises],
            "state": {k: v.clone() for k, v in t.model.state_dict().items()}}


def _dncnn_data(n=64, seed=3):
    rng = np.random.default_rng(seed)
    clean = rng.uniform(0.05, 0.9, (n, 32, 32, 4)).astype(np.float32)
    noisy = np.clip(clean + 0.05 * rng.standard_normal(clean.shape), 0, 1).astype(np.float32)
    return clean, noisy


def _flagship_flow():
    from noise_flow_tpu_torch.config import load_hps
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.utils import checkpoint as ckpt

    model = os.path.join(REPO, "experiments", "sidd", "prod_exact_150")
    flow = NoiseFlow((32, 32, 4), load_hps(os.path.join(model, "hps.txt")), device="cpu")
    ckpt.load_checkpoint(os.path.join(model, "ckpt", "model.ckpt-best.npz"), flow)
    return flow


def _stats_rows():
    rng = np.random.default_rng(99)
    return (rng.standard_normal((32, 8, 8, 4)).astype(np.float32) * 0.02,
            rng.uniform(0.01, 0.9, (32, 8, 8, 4)).astype(np.float32))


# ---------------------------------------------------------------------------
# the worker: one rank in coordinator mode
# ---------------------------------------------------------------------------

def _worker(workdir: str, rank: int, port: int) -> None:
    torch.set_num_threads(1)
    from noise_flow_tpu_torch.parallel import distributed as pd
    from noise_flow_tpu_torch.parallel.mesh import make_mesh

    world = 2
    pd.initialize_distributed(f"localhost:{port}", world, rank, "gloo")
    inp = torch.load(os.path.join(workdir, "in.pt"))
    mesh = make_mesh(None, "cpu")
    assert mesh.size == world and mesh.rank == rank and mesh.process_local
    out = {}

    def feed(mb):
        return _local(mb, rank, world)

    # the stats helpers
    x, y = _stats_rows()
    mine = pd.host_shard(list(range(32)))
    out["host_shard"] = np.asarray(mine)
    out["stats"] = pd.global_scalar_stats(x[mine], y[mine])
    out["baselines"] = np.asarray(pd.global_baselines(100.0 + rank, 200.0 + rank))
    # the collectives: mean, gather, and the all-reduce's cotangents
    out["global_mean"] = float(pd.global_mean(torch.arange(4.0) + 4 * rank))
    out["gathered"] = pd.all_gather_samples(torch.arange(6.0).reshape(3, 2) + 6 * rank)
    x = torch.ones(3, requires_grad=True)
    pd.all_reduce_sum(x * (rank + 1)).sum().backward()
    out["reduce_grad"] = x.grad

    for name, kw, b, n, epochs in FLOW_RUNS:
        out[name] = _flow_run(kw, inp["state"], _batches(b, n), epochs, mesh, feed)
    # the planted fault: each rank's own moments in place of the global ones
    out["plain_local_bn"] = _flow_run({}, inp["state"], _batches(), EPOCHS, mesh, feed,
                                      local_bn=True)
    out["grads_local_bn"] = _grads(inp["state"], feed(_mb(BATCH, 0)), mesh, local_bn=True)
    out["grads"] = _grads(inp["state"], feed(_mb(BATCH, 0)), mesh)

    # sampling diagnostics: the on-device KLD sums over the global batch
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.training.trainer import Trainer

    cfg = default_config(**_cfg_kw({}))
    flow = NoiseFlow((32, 32, 4), cfg, device="cpu")
    flow.load_state_dict(inp["state"])
    tr = Trainer(flow, cfg, mesh)
    gen = torch.Generator().manual_seed(7 + rank)
    out["sample"] = np.asarray(tr.sample_epoch(iter([feed(b) for b in _batches(n=2)]), 1.0,
                                               gen, sc_sd=0.02), dtype=object)
    try:
        tr.stage_dataset(iter([feed(_mb(BATCH, 0))]))
        out["stage_raised"] = False
    except ValueError:
        out["stage_raised"] = True

    clean, noisy = _dncnn_data()
    # the real source: the 2-rank steps at a global batch of 16
    out["dncnn_real"] = _dncnn("real", mesh, clean, noisy, 1)
    out["dncnn_nf"] = _dncnn("nf", mesh, clean, None, 3, noise_flow=_flagship_flow())
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    pd.shutdown()


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def jax_weights():
    """JAX's seeded initial weights with the coupling networks moved off
    init (plus 0.05 N(0, 1), so that the zero-init last convs pass gradients
    to the BatchNorms before them): (params, state) as numpy trees."""
    import jax

    from noise_flow_tpu.config import default_config as jax_default_config
    from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow

    cfg = jax_default_config(**_cfg_kw({}))
    params, state = JaxFlow((32, 32, 4), cfg).init(jax.random.PRNGKey(cfg.seed))
    rng = np.random.default_rng(11)

    def move(path, a):
        a = np.asarray(a, np.float32)
        if "nn" not in jax.tree_util.keystr(path):
            return a
        return (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(move, params), _np_tree(state)


@pytest.fixture(scope="module")
def jax_init(jax_weights):
    """The same weights as the port's state dict."""
    from noise_flow_tpu_torch.utils import checkpoint as ckpt

    return ckpt.from_numpy_tree(*jax_weights)


@pytest.fixture(scope="module")
def ranks(jax_init, tmp_path_factory):
    """Both ranks' results."""
    from noise_flow_tpu_torch.parallel.distributed import free_port

    workdir = str(tmp_path_factory.mktemp("ranks"))
    torch.save({"state": jax_init}, os.path.join(workdir, "in.pt"))
    port = free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), workdir, str(r),
                               str(port)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    for p in procs:
        try:
            _, err = p.communicate(timeout=WORKER_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"a rank ran past {WORKER_TIMEOUT} s")
        assert p.returncode == 0, f"rank failed:\n{err[-3000:]}"
    return [torch.load(os.path.join(workdir, f"out{r}.pt"), weights_only=False)
            for r in range(2)]


def _jax_run(weights, kw, batches, epochs):
    """JAX's trainer on a 2-device mesh from ``weights``."""
    from noise_flow_tpu.config import default_config as jax_default_config
    from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
    from noise_flow_tpu.parallel.mesh import make_mesh, replicate
    from noise_flow_tpu.training.trainer import Trainer as JaxTrainer
    from noise_flow_tpu_torch.utils import checkpoint as ckpt

    cfg = jax_default_config(**_cfg_kw(kw))
    jtr = JaxTrainer(JaxFlow((32, 32, 4), cfg), cfg, mesh=make_mesh(2))
    jtr.params = replicate(jtr.mesh, weights[0])
    jtr.state = replicate(jtr.mesh, weights[1])
    nlls = [jtr.train_epoch(iter(batches))[0] for _ in range(epochs)]
    ev = jtr.eval_epoch(iter(batches[:1]))
    return {"nlls": np.asarray(nlls), "eval": np.asarray(ev),
            "state": ckpt.from_numpy_tree(_np_tree(jtr.params), _np_tree(jtr.state))}


SKIP = ("l1_b", "l2_b", "bn1.mean", "bn2.mean")


def _assert_trajectory(got, ref, nll_tol=NLL_TOL, param_tol=PARAM_TOL):
    """The per-epoch NLLs, the eval NLL and sd_z and the state after."""
    np.testing.assert_allclose(got["nlls"], ref["nlls"], **nll_tol)
    np.testing.assert_allclose(got["eval"][0], ref["eval"][0], **nll_tol)
    # sd_z of the eval forward, which runs BN on the running statistics, so
    # that the Adam-moved biases above shift it (observed 2.6e-3 relative
    # between the one-shot path on 2 ranks and on 1)
    np.testing.assert_allclose(got["eval"][1], ref["eval"][1], rtol=5e-3)
    for k, v in ref["state"].items():
        if not k.endswith(SKIP):
            np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), err_msg=k,
                                       **param_tol)


def _assert_grads(got, ref):
    scale = max(float(g.abs().max()) for g in ref.values())
    assert set(got) == set(ref)
    for k, g in ref.items():
        np.testing.assert_allclose(got[k].numpy(), g.numpy(), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL_SCALE * scale, err_msg=k)


def test_ranks_agree(ranks):
    """Every metric is global and every step's update the same: both ranks
    end with the same weights, bit for bit."""
    r0, r1 = ranks
    for name, *_ in FLOW_RUNS:
        np.testing.assert_array_equal(r0[name]["nlls"], r1[name]["nlls"])
        np.testing.assert_array_equal(r0[name]["eval"], r1[name]["eval"])
        for k, v in r0[name]["state"].items():
            assert torch.equal(v, r1[name]["state"][k]), (name, k)
    for k, v in r0["dncnn_nf"]["state"].items():
        assert torch.equal(v, r1["dncnn_nf"]["state"][k]), k


def test_plain_path_matches_jax_mesh(ranks, jax_weights):
    """The plain path (BatchNorm over the global batch) on 2 ranks against
    JAX's make_mesh(2) trajectory on the same global batches: 2 epochs of 3
    steps, JAX's tolerances for its own 2-process run."""
    _assert_trajectory(ranks[0]["plain"], _jax_run(jax_weights, {}, _batches(), EPOCHS))


def test_local_moments_fail_the_plain_path_comparison(ranks, jax_weights, jax_init):
    """The planted fault: each rank's own BatchNorm moments in place of the
    global ones must fail both comparisons."""
    from noise_flow_tpu_torch.parallel.mesh import Mesh

    with pytest.raises(AssertionError):
        _assert_trajectory(ranks[0]["plain_local_bn"], _jax_run(jax_weights, {}, _batches(), EPOCHS))
    ref = _grads(jax_init, _mb(BATCH, 0), Mesh(1, 0, torch.device("cpu")))
    with pytest.raises(AssertionError):
        _assert_grads(ranks[0]["grads_local_bn"], ref)


def test_gradients_equal_one_rank_exact_bn(ranks, jax_init):
    """The 2-rank gradients (each rank's gradient of its rows' mean NLL
    through the global moments, averaged over the ranks) against one rank's
    exact-BN gradients of the global batch's mean NLL."""
    from noise_flow_tpu_torch.parallel.mesh import Mesh

    ref = _grads(jax_init, _mb(BATCH, 0), Mesh(1, 0, torch.device("cpu")))
    _assert_grads(ranks[0]["grads"], ref)
    _assert_grads(ranks[1]["grads"], ref)


def test_oneshot_path_matches_one_rank_at_138_and_jax_mesh(ranks, jax_weights, jax_init):
    """The one-shot fused path (the step kernel's plain version on the CPU):
    2 ranks of 69 against one rank at 138, whose two ghost groups of 69 are
    the ranks' (rtol 1e-5 on the NLLs: float32 sums in another order); and 2
    ranks of 8 against JAX's make_mesh(2) use_pallas trainer at 16 in
    interpret mode, 2 steps."""
    from noise_flow_tpu_torch.parallel.mesh import Mesh

    one = _flow_run(dict(use_pallas=True, pallas_oneshot=True), jax_init, _batches(138, 2), 1,
                    Mesh(1, 0, torch.device("cpu")), lambda mb: mb)
    _assert_trajectory(ranks[0]["oneshot138"], one,
                       nll_tol=dict(rtol=1e-5, atol=0), param_tol=PARAM_TOL)
    ref = _jax_run(jax_weights, dict(use_pallas=True, pallas_oneshot=True), _batches(BATCH, 2), 1)
    _assert_trajectory(ranks[0]["oneshot"], ref)


def test_segment_path_matches_jax_mesh(ranks, jax_weights):
    """The segment path (ghost BN per rank at pick_block(8) = 8) against
    JAX's make_mesh(2) run only: its block at a global 16 on one rank would
    be 16."""
    ref = _jax_run(jax_weights, dict(use_pallas=True, pallas_oneshot=False), _batches(BATCH, 2), 1)
    _assert_trajectory(ranks[0]["segment"], ref)


def test_sampling_and_staging_under_a_mesh(ranks):
    """sample_epoch's on-device KLDs: the sums and counts over the global
    batch give both ranks the same finite row; stage_dataset raises."""
    r0, r1 = ranks
    for k in range(3):
        np.testing.assert_array_equal(np.asarray(r0["sample"][k], np.float64),
                                      np.asarray(r1["sample"][k], np.float64))
    assert np.isfinite(np.asarray(r0["sample"][2], np.float64)).all()
    assert r0["stage_raised"] and r1["stage_raised"]


def test_dncnn_two_ranks(ranks):
    """DnCNN: 2 ranks equal one rank at the same global batch of 16, with the
    real source (no random draws; 4 steps) and with the nf source (12
    steps), whose noise is the same bits on every rank and on one rank: each
    rank draws the whole batch's noise (the flagship's sampler, the kernel's
    plain version at b = 16 with the batch's BatchNorm moments) and trains
    on its slice. The nf run's loss is finite and falls."""
    from noise_flow_tpu_torch.parallel.mesh import Mesh

    clean, noisy = _dncnn_data()
    one_rank = Mesh(1, 0, torch.device("cpu"))
    for source, one in (("real", _dncnn("real", one_rank, clean, noisy, 1)),
                        ("nf", _dncnn("nf", one_rank, clean, None, 3,
                                      noise_flow=_flagship_flow()))):
        for r in ranks:
            got = r[f"dncnn_{source}"]
            assert len(got["noises"]) == len(one["noises"])
            for a, b in zip(got["noises"], one["noises"]):
                np.testing.assert_array_equal(a, b)
            np.testing.assert_allclose(got["losses"], one["losses"], rtol=1e-5)
            for k, v in one["state"].items():
                np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(),
                                           rtol=1e-4, atol=1e-5, err_msg=(source, k))
    nf = ranks[0]["dncnn_nf"]["losses"]
    assert np.isfinite(nf).all() and nf[-1] < nf[0], nf


def test_collectives(ranks):
    """global_mean is the mean over every rank's elements; all_gather_samples
    concatenates the ranks' rows in rank order; the backward of all_reduce_sum
    is the all-reduce of the cotangents (each rank's input x (r + 1) summed:
    rank r's gradient 2 (r + 1))."""
    for r, out in enumerate(ranks):
        assert out["global_mean"] == 3.5
        np.testing.assert_array_equal(out["gathered"].numpy(),
                                      np.arange(12.0).reshape(6, 2))
        np.testing.assert_array_equal(out["reduce_grad"].numpy(), np.full(3, 2.0 * (r + 1)))


def test_stats_helpers_match_jax(ranks, monkeypatch):
    """global_scalar_stats, global_baselines, host_shard and
    merge_welford_shards give JAX's values: JAX's functions run here on the
    same float32 Welford pieces its process_allgather would return."""
    import jax
    from jax.experimental import multihost_utils

    from noise_flow_tpu.parallel import distributed as jd
    from noise_flow_tpu_torch.parallel import distributed as pd

    x, y = _stats_rows()
    shards = [jd.host_shard(list(range(32)), r, 2) for r in range(2)]
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["host_shard"], shards[r])
    pieces = []
    for s in shards:
        local = []
        for arr in (x[s], y[s]):
            a = arr.astype(np.float64)
            local += [float(a.size), float(a.mean()), float(a.var() * a.size)]
        pieces.append(np.asarray(local, np.float32))
    monkeypatch.setattr(jax, "process_count", lambda: 2)
    monkeypatch.setattr(multihost_utils, "process_allgather", lambda _: np.stack(pieces))
    ref = jd.global_scalar_stats(x[shards[0]], y[shards[0]])
    for r in range(2):
        assert ranks[r]["stats"] == ref
    monkeypatch.setattr(multihost_utils, "process_allgather",
                        lambda _: np.asarray([[100, 200], [101, 201]], np.float32))
    ref_b = jd.global_baselines(100.0, 200.0)
    for r in range(2):
        np.testing.assert_array_equal(ranks[r]["baselines"], ref_b)
    wshards = [{"n": np.float32(n), "mean": np.float32(m), "m2": np.float32(v)}
               for n, m, v in ((10, 0.5, 2.0), (20, -0.1, 3.5), (7, 0.2, 0.4))]
    assert pd.merge_welford_shards(list(wshards)) == jd.merge_welford_shards(list(wshards))


def _rank_sum(rank, device, x):
    from noise_flow_tpu_torch.parallel import distributed as pd

    t = torch.tensor([float(rank + x)])
    pd.all_reduce_flat_([t])
    return rank, str(device), float(t), pd.world_size()


def _rank_sleep(rank, device):
    time.sleep(WORKER_TIMEOUT)


def test_spawn_ranks_returns_each_rank_result_and_kills_at_the_timeout():
    """spawn_ranks: each rank's return value in rank order, the ranks of one
    group (or of none, for a function that brings up its own); ranks still
    running at the timeout are killed and TimeoutError raised."""
    from noise_flow_tpu_torch.parallel import distributed as pd

    assert pd.spawn_ranks(2, _rank_sum, (10,), "cpu", timeout=WORKER_TIMEOUT) == [
        (0, "cpu", 21.0, 2), (1, "cpu", 21.0, 2)]
    # no group: each rank alone, its all-reduce a no-op
    assert pd.spawn_ranks(2, _rank_sum, (10,), "cpu", timeout=WORKER_TIMEOUT,
                          group=False) == [(0, "cpu", 10.0, 1), (1, "cpu", 11.0, 1)]
    t0 = time.time()
    with pytest.raises(TimeoutError):
        pd.spawn_ranks(2, _rank_sleep, (), "cpu", timeout=2)
    assert time.time() - t0 < WORKER_TIMEOUT / 2


def test_parallel_imports_no_jax():
    """parallel/, the CLIs that start ranks and the multi-card probe load
    neither JAX nor the JAX package."""
    code = ("import sys\n"
            "import noise_flow_tpu_torch.parallel.distributed, noise_flow_tpu_torch.parallel.mesh\n"
            "import noise_flow_tpu_torch.cli.train, noise_flow_tpu_torch.cli.train_dncnn\n"
            "import noise_flow_tpu_torch.probes.mesh\n"
            "bad = [m for m in sys.modules if m in ('jax', 'noise_flow_tpu') "
            "or m.startswith(('jax.', 'noise_flow_tpu.'))]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    done = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=WORKER_TIMEOUT)
    assert done.returncode == 0, done.stderr[-2000:]


# ---------------------------------------------------------------------------
# cli.train --mesh 2 and the stats cache
# ---------------------------------------------------------------------------

CLI = ["--synthetic_data", "2", "--patch_height", "32", "--n_batch_test", "8"]


def test_cli_mesh_and_stats_cache(tmp_path, monkeypatch):
    """``cli.train --mesh 2 --device cpu`` (two ranks it starts itself, each
    on its slice of the same batches) against one rank of the same run:
    train and test rows within 1e-5; its stats cache equals, key by key and
    fingerprint included, the npz JAX's cli.train writes on the same split;
    the single-rank run reads it back without computing stats; a changed
    extraction argument recomputes."""
    from noise_flow_tpu.cli.train import main as jax_main
    from noise_flow_tpu_torch.cli import train as cli
    from noise_flow_tpu_torch.parallel import distributed as pd

    jdir, pdir = str(tmp_path / "jcache"), str(tmp_path / "pcache")
    os.makedirs(jdir)
    os.makedirs(pdir)
    assert jax_main(CLI + ["--cache_dir", jdir, "--calc_pat_stats_and_baselines_only",
                           "--logdir", str(tmp_path / "jax")]) == 0
    run = CLI + ["--n_batch_train", "8", "--epochs", "2", "--device", "cpu", "--cache_dir", pdir]
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    two = str(tmp_path / "two")
    done = subprocess.run([sys.executable, "-m", "noise_flow_tpu_torch.cli.train", *run,
                           "--mesh", "2", "--logdir", two], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=WORKER_TIMEOUT)
    assert done.returncode == 0, done.stderr[-3000:]
    j = np.load(os.path.join(jdir, "pat_stats_baselines.npz"))
    p = np.load(os.path.join(pdir, "pat_stats_baselines.npz"))
    assert sorted(j.files) == sorted(p.files)
    for k in j.files:
        np.testing.assert_array_equal(p[k], j[k], err_msg=k)

    def no_stats(*a):
        raise AssertionError("stats recomputed")
    with monkeypatch.context() as m:
        m.setattr(pd, "global_scalar_stats", no_stats)
        one = str(tmp_path / "one")
        assert cli.main(run + ["--logdir", one]) == 0
    for name in ("train.txt", "test.txt"):   # epoch, NLL, NLL_G, NLL_SDN, sdz
        a = np.loadtxt(os.path.join(two, name), skiprows=1)[:, :5]
        b = np.loadtxt(os.path.join(one, name), skiprows=1)[:, :5]
        np.testing.assert_allclose(a, b, rtol=1e-5, err_msg=name)
    with open(os.path.join(two, "hps.txt")) as f:
        hps = {r[0]: r[1] for r in csv.reader(f) if len(r) == 2}
    assert hps["mesh_shape"] == "(2,)" and hps["num_processes"] == "1"
    # a changed extraction argument: computed anew, a new fingerprint
    assert cli.main(run + ["--n_patches_per_image", "8", "--calc_pat_stats_and_baselines_only",
                           "--logdir", str(tmp_path / "re")]) == 0
    q = np.load(os.path.join(pdir, "pat_stats_baselines.npz"))
    assert str(q["fingerprint"]) != str(j["fingerprint"])


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
