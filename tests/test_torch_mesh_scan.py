"""K steps a dispatch under a mesh: noise_flow_tpu_torch's
``Trainer.train_epoch(steps_per_call=K)`` on 2 gloo ranks against the JAX
trainer's ``make_mesh(2)`` ``_train_epoch_scan`` on the same global host
batches, on the CPU, where a group of K is K eager steps (only an nccl group
on the card captures its collectives in a CUDA graph).

Two ranks (``parallel.distributed.spawn_ranks``, one process each) run every
scenario once for the module: K = 3 over 8 batches, 6 at a global 16 and 2
at a global 8 (two full groups, then a batch-shape change and a ragged tail
of 2), on the plain exact-BN path, the one-shot path and the segment path,
each fed both ways: ``--mesh``-style, every rank given the global batches
and keeping its slice of each group's [K, B, ...] stack (JAX's
``shard_batch_stacked``), and coordinator-style, every rank given its own
half of each batch (JAX's ``global_batch_stacked``). Also the eager
all-reduces a step at the flagship arch, and the planted fault: each rank
fed the whole global stack instead of its slice. The tolerances are
``tests/test_torch_parallel.py``'s, whose helpers this file shares.
"""

import numpy as np
import pytest
import torch

from test_torch_parallel import NLL_TOL, PARAM_TOL, SKIP, _cfg_kw, _local, _mb

RANKS, K = 2, 3
SHAPES = (16, 16, 16, 16, 16, 16, 8, 8)
WORKER_TIMEOUT = 240
PATHS = {"plain": dict(use_pallas=False),
         "oneshot": dict(use_pallas=True, pallas_oneshot=True),
         "segment": dict(use_pallas=True, pallas_oneshot=False)}
FLAGSHIP_ARCH = "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc"
# the eager all-reduces of one train step at the flagship arch: on the plain
# path 16 BatchNorms x (mean, variance) x (forward, backward) and the flat
# all-reduce of gradients and metrics; on the fused paths the flat all-reduce
# of gradients, metrics and BN state alone
ALLREDUCES_A_STEP = {"plain": 65, "oneshot": 1, "segment": 1}
# Adam at the flagship's learning rate, as tests/test_torch_scan.py takes it:
# at 1e-3 the 8 steps move a plain-path weight whose gradient is near zero by
# lr-sized steps from JAX's
LR = 1e-4


def _kw(path):
    return dict(_cfg_kw(PATHS[path]), lr=LR)


def _batches():
    return [_mb(b, 40 + s) for s, b in enumerate(SHAPES)]


def _epoch(path, state, batches, mesh, k=K, whole_stack=False):
    """One train_epoch from ``state`` over ``batches``: the epoch's mean NLL
    and sd_z, each step's, and the state after. ``whole_stack``: the planted
    fault, each rank fed every row of a group's stack."""
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.parallel import distributed as pd
    from noise_flow_tpu_torch.training.trainer import _KEEP, Trainer

    cfg = default_config(**_kw(path))
    flow = NoiseFlow((32, 32, 4), cfg, device="cpu")
    flow.load_state_dict(state)
    tr = Trainer(flow, cfg, mesh)
    if whole_stack:
        tr._put_stacked = lambda buf: pd.global_batch(
            mesh, {f: np.stack([mb[f] for mb in buf]) for f in _KEEP}, torch.float32)
    nll, sd_z = tr.train_epoch(iter(batches), steps_per_call=k)
    return {"nll": nll, "sd_z": sd_z, "steps": [t.clone() for t in tr.epoch_steps],
            "state": {n: v.clone() for n, v in flow.state_dict().items()}}


def _allreduces(path):
    """The eager all-reduces of one train step at the flagship arch (from its
    seed), this rank's half of a global batch of 16."""
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.parallel import distributed as pd
    from noise_flow_tpu_torch.parallel.mesh import make_mesh
    from noise_flow_tpu_torch.training.trainer import Trainer

    cfg = default_config(**dict(_kw(path), arch=FLAGSHIP_ARCH))
    tr = Trainer(NoiseFlow((32, 32, 4), cfg, device="cpu", seed=cfg.seed), cfg,
                 make_mesh(None, "cpu"))
    batch = tr._put(_mb(16, 7))
    before = pd.collective_stats["calls"]
    tr.train_step(batch)
    return pd.collective_stats["calls"] - before


def _rank(rank, device, state):
    """Every scenario on this rank of the 2-rank gloo group."""
    from noise_flow_tpu_torch.parallel.mesh import Mesh, make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(None, "cpu")
    assert mesh.size == RANKS and not mesh.process_local
    # coordinator mode's mesh: each rank fed its own process's batches
    own = Mesh(RANKS, rank, torch.device("cpu"), None, process_local=True)
    batches = _batches()
    mine = [_local(mb, rank, RANKS) for mb in batches]
    out = {}
    for name in PATHS:
        out[name, "mesh"] = _epoch(name, state, batches, mesh)
        out[name, "coordinator"] = _epoch(name, state, mine, own)
        out[name, "k1"] = _epoch(name, state, batches, mesh, k=1)
        out[name, "allreduces"] = _allreduces(name)
    out["fault"] = _epoch("oneshot", state, batches, mesh, whole_stack=True)
    return out


@pytest.fixture(scope="module")
def jax_weights():
    """JAX's seeded initial weights, the coupling networks moved off init as
    ``tests/test_torch_parallel.py`` moves them: (params, state) as numpy
    trees."""
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

    def np_tree(tree):
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    return jax.tree_util.tree_map_with_path(move, params), np_tree(state)


@pytest.fixture(scope="module")
def ranks(jax_weights):
    from noise_flow_tpu_torch.parallel import distributed as pd
    from noise_flow_tpu_torch.utils import checkpoint as ckpt

    return pd.spawn_ranks(RANKS, _rank, (ckpt.from_numpy_tree(*jax_weights),), "cpu",
                          timeout=WORKER_TIMEOUT)


_JAX = {}


def _jax_epoch(weights, name):
    """JAX's make_mesh(2) trainer, one scan epoch over the same global
    batches (memoised: every feed of a path is held to one run)."""
    if name in _JAX:
        return _JAX[name]
    import jax

    from noise_flow_tpu.config import default_config as jax_default_config
    from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
    from noise_flow_tpu.parallel.mesh import make_mesh, replicate
    from noise_flow_tpu.training.trainer import Trainer as JaxTrainer
    from noise_flow_tpu_torch.utils import checkpoint as ckpt

    def np_tree(tree):
        return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    cfg = jax_default_config(**_kw(name))
    jtr = JaxTrainer(JaxFlow((32, 32, 4), cfg), cfg, mesh=make_mesh(RANKS))
    jtr.params = replicate(jtr.mesh, weights[0])
    jtr.state = replicate(jtr.mesh, weights[1])
    nll, sd_z = jtr.train_epoch(iter(_batches()), steps_per_call=K)
    _JAX[name] = {"nll": nll, "sd_z": sd_z,
                  "state": ckpt.from_numpy_tree(np_tree(jtr.params), np_tree(jtr.state))}
    return _JAX[name]


def _assert_epoch(got, ref):
    np.testing.assert_allclose(got["nll"], ref["nll"], **NLL_TOL)
    np.testing.assert_allclose(got["sd_z"], ref["sd_z"], rtol=NLL_TOL["rtol"], atol=1e-4)
    for k, v in ref["state"].items():
        if not k.endswith(SKIP):
            np.testing.assert_allclose(got["state"][k].numpy(), v.numpy(), err_msg=k,
                                       **PARAM_TOL)


@pytest.mark.parametrize("feed", ["mesh", "coordinator"])
@pytest.mark.parametrize("path", list(PATHS))
def test_mesh_scan_epoch_matches_jax(ranks, jax_weights, path, feed):
    """The 2-rank K = 3 epoch against JAX's make_mesh(2) scan epoch: the
    epoch's NLL and sd_z and every weight and BN buffer after it."""
    got = ranks[0][path, feed]
    assert len(got["steps"][0]) == len(SHAPES)
    _assert_epoch(got, _jax_epoch(jax_weights, path))


@pytest.mark.parametrize("path", list(PATHS))
def test_groups_are_their_steps_in_both_feeds(ranks, path):
    """On the CPU a group of K is its K steps: the K = 3 epoch equals the
    K = 1 epoch, and the coordinator feed the --mesh feed, to the bit, on
    both ranks, which end with the same state."""
    for r in ranks:
        ref = r[path, "k1"]
        for feed in ("mesh", "coordinator"):
            got = r[path, feed]
            for a, b in zip(got["steps"], ref["steps"]):
                assert torch.equal(a, b), (path, feed)
            for k, v in ref["state"].items():
                assert torch.equal(got["state"][k], v), (path, feed, k)
            for k, v in ranks[0][path, feed]["state"].items():
                assert torch.equal(r[path, feed]["state"][k], v), (path, feed, k)


def test_eager_allreduces_a_step(ranks):
    """The all-reduces of one eager train step on 2 ranks at the flagship
    arch: 65 on the plain path (the BatchNorm sums forward and backward,
    then the flat all-reduce), 1 on each fused path."""
    for r in ranks:
        assert {p: r[p, "allreduces"] for p in PATHS} == ALLREDUCES_A_STEP


def test_whole_stack_fed_to_every_rank_fails(ranks, jax_weights):
    """The planted fault: each rank fed the whole global stack of a group
    (the one-shot step then takes ghost BN groups of the global batch, and
    every row twice) must fail the comparison with JAX."""
    with pytest.raises(AssertionError):
        _assert_epoch(ranks[0]["fault"], _jax_epoch(jax_weights, "oneshot"))


# ---------------------------------------------------------------------------
# what a capture needs, without a card: the count of the BatchNorm sums, the
# collectives' bookkeeping under a (stubbed) capture, the graphs' rule
# ---------------------------------------------------------------------------

def _moments_before(x, dims, psum):
    """batch_moments with psum as it was: the element count copied from a
    host list, which a CUDA graph cannot capture."""
    import math

    sums = x.sum(dim=dims)
    s = psum(torch.cat([sums.reshape(-1), x.new_tensor([float(math.prod(
        x.shape[d] for d in dims))])]))
    m = (s[:-1] / s[-1]).reshape(sums.shape)
    return m, psum(((x - m) ** 2).sum(dim=dims)) / s[-1].detach()


def test_batch_moments_count_is_a_device_fill(monkeypatch):
    """The psum path of ops.nn.batch_moments gives the bits it gave with the
    count copied from the host, moments and gradients (a sum over two equal
    ranks), and makes no tensor from a Python list."""
    from noise_flow_tpu_torch.ops import nn

    def psum(t):
        return t + t

    x0 = torch.as_tensor(np.random.default_rng(3).standard_normal((6, 8, 8, 4)),
                         dtype=torch.float32)
    outs = []
    for fn in (nn.batch_moments, _moments_before):
        x = x0.clone().requires_grad_(True)
        m, v = fn(x, (0, 1, 2), psum)
        (m.sum() * 3 + (v * v).sum()).backward()
        outs.append((m.detach(), v.detach(), x.grad))
    for a, b in zip(*outs):
        assert torch.equal(a, b)

    def from_host(*a, **k):
        raise AssertionError("a tensor made from host values")
    monkeypatch.setattr(torch.Tensor, "new_tensor", from_host)
    monkeypatch.setattr(torch, "tensor", from_host)
    monkeypatch.setattr(torch, "as_tensor", from_host)
    m, v = nn.batch_moments(x0, (0, 1, 2), psum)
    assert torch.equal(m, outs[0][0]) and torch.equal(v, outs[0][1])


def test_captured_collectives_count_at_each_replay(monkeypatch):
    """Under a capture (the flag stubbed, as no card is here) an all-reduce
    is issued into the graph and counted in captured_collectives, not in
    collective_stats; timing, which synchronizes the card, raises, and so
    does a gloo group; a StepGraph's replay adds its captured collectives
    and launches to the counts at each replay."""
    import collections

    from noise_flow_tpu_torch.ops import fused_sample as fs
    from noise_flow_tpu_torch.parallel import distributed as pd
    from noise_flow_tpu_torch.training.step_graph import StepGraph

    issued = []
    monkeypatch.setattr(pd, "_capturing", lambda t: True)
    monkeypatch.setattr(pd, "backend", lambda group=None: "nccl")
    monkeypatch.setattr(pd.dist, "all_reduce", lambda t, group=None: issued.append(t))
    monkeypatch.setitem(pd.collective_stats, "calls", 0)
    monkeypatch.setitem(pd.captured_collectives, "calls", 0)
    t = torch.ones(3)
    for _ in range(3):
        assert pd._all_reduce_(t, None) is t
    assert len(issued) == 3
    assert pd.captured_collectives["calls"] == 3 and pd.collective_stats["calls"] == 0
    monkeypatch.setitem(pd.collective_stats, "timing", True)
    with pytest.raises(RuntimeError, match="timing"):
        pd._all_reduce_(t, None)
    monkeypatch.setitem(pd.collective_stats, "timing", False)
    monkeypatch.setattr(pd, "backend", lambda group=None: "gloo")
    with pytest.raises(RuntimeError, match="nccl"):
        pd._all_reduce_(t, None)
    assert len(issued) == 3 and pd.captured_collectives["calls"] == 3

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1
    g = object.__new__(StepGraph)
    g.feed, g.graph, g.nll, g.sd_z = {}, Graph(), torch.zeros(4), torch.ones(4)
    g.launches, g.collectives = collections.Counter({"fused_train_step": 4}), 4 * 65
    monkeypatch.setattr(fs, "launch_counts", collections.Counter())
    for n in (1, 2):
        nll, sd_z = g.replay()
        assert pd.collective_stats["calls"] == n * 260
        assert fs.launch_counts == {"fused_train_step": 4 * n}
    assert Graph.replays == 2 and torch.equal(sd_z, torch.ones(4))


def test_graphs_on_rule(monkeypatch):
    """Graphs run on the card for one rank and for an nccl mesh; never on
    the CPU, and not for a gloo mesh (ranks sharing one card), whose
    collectives go through the host."""
    from noise_flow_tpu_torch.parallel import distributed as pd
    from noise_flow_tpu_torch.parallel.mesh import Mesh
    from noise_flow_tpu_torch.training.trainer import Trainer

    tr = object.__new__(Trainer)
    for dev, size, backend, on in (("cuda", 1, None, True), ("cuda", 2, "nccl", True),
                                   ("cuda", 4, "gloo", False), ("cpu", 1, None, False),
                                   ("cpu", 2, "gloo", False)):
        monkeypatch.setattr(pd, "backend", lambda group=None, b=backend: b)
        tr.device = torch.device(dev)
        tr.mesh = Mesh(size, 0, tr.device)
        assert tr.graphs_on is on, (dev, size, backend)
