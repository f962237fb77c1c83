"""The frame sharded by height over ranks (noise_flow_tpu_torch.parallel.spatial)
against one rank and against the JAX package, on the CPU.

Two gloo ranks (``parallel.distributed.spawn_ranks``, one process each)
run every scenario once for the module and return their rows; this process
holds them against the port's one-rank ``flow.forward`` on the same latent
and against JAX's frame-size ``flow.forward`` (or ``flow.sample`` from the
same key, for the 2-level flow). Shapes are small: a 64x64x4 frame for the
2-coupling arch ``sdn5|unc|gain4|unc``, a 2-level ``unc|unc`` flow at
64x64, a 4-level ``unc`` flow at 48x48 (its deepest level's 6 rows do
not split into even shards, so it runs whole on both ranks) and a legacy
``condXYG`` flow at 64x64 (the ISO-affine template and its convs on the
clean image, which take the halo too), weights moved
off their init so that every zero-conv (and its edge-indicator weights)
is live. Two planted faults must fail the same gate: the edge indicator
set on every shard's padded rows, as a naive "pad each shard" sets it, and
BatchNorm moments over each rank's own rows.
"""

import os

import numpy as np
import pytest
import torch

from noise_flow_tpu_torch.parallel import distributed as pd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(REPO, "experiments", "sidd", "prod_exact_150")
RANKS = 2
WORKER_TIMEOUT = 240
TEMP = 0.6
# the gate, elementwise and relative to the value and to the frame's spread:
# |2 ranks - reference| <= RTOL (|reference| + sd(reference)). Both sides sum
# the BatchNorm moments in another order (and JAX convolves with other
# kernels), so the noise moves by float32 roundings only. Observed here:
# 2 ranks against 1 within 7.9e-7 of it, against JAX within 5.3e-6 (the
# 4-level flow, whose sd is 2, before its JAX comparison was cut for
# time); the planted faults 4.2e-2 and 2.6e-1.
RTOL = 1e-5
FLOWS = {
    "single": (dict(arch="sdn5|unc|gain4|unc", patch_height=32), (64, 64, 4)),
    "two_level": (dict(arch="unc|unc", n_levels=2, squeeze_factor=2, patch_height=32),
                  (64, 64, 4)),
    "four_level": (dict(arch="unc", n_levels=4, squeeze_factor=2, patch_height=32),
                   (48, 48, 4)),
    "condXYG": (dict(arch="", sidd_cond="condXYG", depth=2, patch_height=32), (64, 64, 4)),
}
# (flow, train, planted fault)
SCENARIOS = (("single", True, None), ("single", False, None), ("single", True, "indicator"),
             ("single", False, "indicator"), ("single", True, "local_bn"),
             ("two_level", True, None), ("four_level", True, None), ("four_level", False, None),
             ("condXYG", True, None))
JAX_FLOWS = ("single", "two_level", "condXYG")   # the 4-level flow: 2 ranks against 1 only
WRAPPER_FRAME = (60, 70)   # padded to 64x72 for one rank and for two


def _outside(got, ref):
    return np.abs(got - ref) > RTOL * (np.abs(ref) + float(np.std(ref)))


def _gate(got, ref):
    return not _outside(got, ref).any()


def _cond(shape, seed):
    rng = np.random.default_rng(seed)
    return {"clean": rng.uniform(0.02, 0.8, (1,) + shape).astype(np.float32),
            "nlf0": np.zeros(1, np.float32), "nlf1": np.zeros(1, np.float32),
            "iso": np.full(1, 800.0, np.float32), "cam": np.full(1, 2.0, np.float32)}


class _PerShardIndicator:
    """The planted fault: the halo rows exchanged, but the edge indicator
    set on every shard's padded rows, as if each shard were a frame."""

    def __init__(self, halo):
        self.halo, self.top, self.bottom = halo, True, True

    def __call__(self, x, rows=1):
        return self.halo(x, rows)


def _rank_run(rank, device, spec):
    """Every scenario on this rank: its rows of each sample, the halo of a
    known tensor, and the wrapper's whole frame under a mesh of both ranks."""
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.parallel import spatial
    from noise_flow_tpu_torch.parallel.mesh import make_mesh
    from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper

    torch.set_num_threads(1)
    mesh = make_mesh(None, device)
    out = {"rank": mesh.rank, "rows": {}}
    t = torch.arange(2 * 8 * 3 * 2, dtype=torch.float32).reshape(2, 8, 3, 2)
    part = t[:, spatial.shard_rows(8, mesh)]
    out["halo"] = {r: spatial.halo_exchange(part, mesh, r).numpy() for r in (1, 2)}
    flows = {}
    for name, (kw, shape) in FLOWS.items():
        flow = NoiseFlow(shape, default_config(**kw), device=device)
        flow.load_state_dict({k: torch.as_tensor(v) for k, v in spec["weights"][name].items()})
        flows[name] = flow.eval()
    with torch.no_grad():
        for name, train, fault in SCENARIOS:
            lat = spec["latents"][name]
            cond = {k: torch.as_tensor(v) for k, v in spec["conds"][name].items()}
            eps = [None if e is None else torch.as_tensor(e) for e in lat["eps"]]
            halo = _PerShardIndicator(spatial.RowHalo(mesh)) if fault == "indicator" else None
            psum = (lambda s: s) if fault == "local_bn" else None
            x = spatial.sample_frame_sharded(flows[name], cond, torch.as_tensor(lat["z"]), mesh,
                                              TEMP, train, eps, halo=halo, psum=psum)
            out["rows"][(name, train, fault)] = x.numpy()
        nf = NoiseFlowWrapper(MODEL, device=device, seed=7)
        out["wrapper"] = nf.sample_noise_frame_spatial(spec["frame"], 0.0, 0.0, 800.0, 2.0,
                                                       mesh=mesh)
    return out


# ----------------------------------------------------------------- fixtures

def _moved(jflow, seed):
    """JAX params and state moved off init: every weight plus noise (the
    split priors' conv weights by a fiftieth of it, as
    tests/test_torch_model_family.py moves them), running variances
    positive."""
    import jax

    params, state = jflow.init(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed + 1)

    def move(path, x):
        s = 0.001 if str(path[0]) == "['splits']" and str(path[-1]) == "['w']" else 0.05
        return np.asarray(x, np.float32) + s * rng.standard_normal(np.shape(x)).astype(np.float32)

    def bn(path, x):
        x = np.asarray(x, np.float32)
        if "mean" in str(path[-1]):
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        if "var" in str(path[-1]):
            return x + 0.3 * np.abs(rng.standard_normal(x.shape)).astype(np.float32)
        return x
    return (jax.tree_util.tree_map_with_path(move, params),
            jax.tree_util.tree_map_with_path(bn, state))


@torch.no_grad()
def _move_port(flow, seed):
    """The port's init moved as ``_moved`` moves JAX's."""
    rng = np.random.default_rng(seed)
    for k, p in flow.named_parameters():
        s = 0.001 if k.startswith("splits.") and k.endswith(".w") else 0.05
        p += torch.as_tensor(s * rng.standard_normal(p.shape).astype(np.float32))
    for k, b in flow.named_buffers():
        if k.endswith(".mean"):
            b += torch.as_tensor(0.1 * rng.standard_normal(b.shape).astype(np.float32))
        elif k.endswith(".var"):
            b += torch.as_tensor(0.3 * np.abs(rng.standard_normal(b.shape)).astype(np.float32))


@pytest.fixture(scope="module")
def runs():
    """JAX's samples and the latents they came from; the two ranks' rows and
    the port's one-rank samples of every scenario."""
    import jax
    import jax.numpy as jnp
    from noise_flow_tpu.config import default_config as jax_default_config
    from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.parallel import spatial
    from noise_flow_tpu_torch.parallel.mesh import Mesh
    from noise_flow_tpu_torch.utils import checkpoint as ckpt

    torch.set_num_threads(1)
    spec = {"weights": {}, "latents": {}, "conds": {}}
    jax_out, port_flows = {}, {}
    for i, (name, (kw, shape)) in enumerate(FLOWS.items()):
        cond = _cond(shape, seed=10 + i)
        spec["conds"][name] = cond
        flow = NoiseFlow(shape, default_config(**kw), device="cpu", seed=3 + i)
        if name in JAX_FLOWS:
            jflow = JaxFlow(shape, jax_default_config(**kw))
            params, state = _moved(jflow, seed=3 + i)
            flow.load_state_dict(ckpt.from_numpy_tree(params, state))
            jcond = {k: jnp.asarray(v) for k, v in cond.items()}
            # JAX's draws: flow.sample splits its key for z, then forward
            # splits one key a split from the top level down
            key = jax.random.PRNGKey(20 + i)
            rng, k = jax.random.split(key)
            z = np.asarray(jax.random.normal(k, (1,) + tuple(jflow.level_shapes[-1]))) * TEMP
            eps = [None] * jflow.n_levels
            for li in reversed(range(jflow.n_levels - 1)):
                rng, k = jax.random.split(rng)
                h, w, c = jflow.level_shapes[li + 1]
                eps[li] = np.array(jax.random.normal(k, (1, 2 * h, 2 * w, c // 4)))
            for train in (True, False):
                if jflow.n_levels == 1:
                    got = jflow.forward(params, state, jnp.asarray(z, jnp.float32), jcond, train)
                else:
                    got = jflow.sample(params, state, key, jcond, temp=TEMP, batch=1, train=train)
                jax_out[(name, train)] = np.asarray(got)
        else:   # the port's own init moved alike, and its own draws
            _move_port(flow, seed=3 + i)
            z, eps = flow.draw_latents(TEMP, 1, torch.Generator().manual_seed(20 + i))
            z, eps = z.numpy(), [None if e is None else e.numpy() for e in eps]
        spec["weights"][name] = {k: v.numpy() for k, v in flow.state_dict().items()}
        spec["latents"][name] = {"z": np.asarray(z, np.float32), "eps": eps}
        port_flows[name] = flow.eval()
    frame = np.random.default_rng(5).uniform(0.02, 0.8, WRAPPER_FRAME + (4,)).astype(np.float32)
    spec["frame"] = frame
    ranks = pd.spawn_ranks(RANKS, _rank_run, (spec,), "cpu", timeout=WORKER_TIMEOUT)
    one = Mesh(1, 0, torch.device("cpu"))
    single = {}
    with torch.no_grad():
        for name, train in {(s[0], s[1]) for s in SCENARIOS}:
            lat, cond = spec["latents"][name], spec["conds"][name]
            single[(name, train)] = spatial.sample_frame_sharded(
                port_flows[name], {k: torch.as_tensor(v) for k, v in cond.items()},
                torch.as_tensor(lat["z"]), one, TEMP, train,
                [None if e is None else torch.as_tensor(e) for e in lat["eps"]]).numpy()
    return {"jax": jax_out, "ranks": sorted(ranks, key=lambda r: r["rank"]),
            "single": single, "spec": spec}


def _two_ranks(runs, key):
    return np.concatenate([r["rows"][key] for r in runs["ranks"]], axis=1)


# -------------------------------------------------------------------- tests

def test_halo_exchange_gives_each_shard_its_neighbours_rows(runs):
    """Each rank's shard of 4 rows with r rows of each neighbour, zeros past
    the frame: the full tensor zero-padded by r rows, cut at the shard."""
    t = np.arange(2 * 8 * 3 * 2, dtype=np.float32).reshape(2, 8, 3, 2)
    for r in (1, 2):
        padded = np.pad(t, ((0, 0), (r, r), (0, 0), (0, 0)))
        for rank, out in enumerate(runs["ranks"]):
            np.testing.assert_array_equal(out["halo"][r], padded[:, 4 * rank:4 * rank + 4 + 2 * r])


@pytest.mark.parametrize("name,train", [(s[0], s[1]) for s in SCENARIOS if s[2] is None])
def test_two_ranks_match_one_rank_and_jax(runs, name, train):
    """Both BN modes: the ranks' rows stacked equal one rank's frame and
    (but for the 4-level flow, whose one-rank path tests/test_torch_model_family.py
    holds to JAX) JAX's frame-size pass on the same latent, within the gate."""
    got = _two_ranks(runs, (name, train, None))
    one = runs["single"][(name, train)]
    assert got.shape == one.shape == (1,) + FLOWS[name][1]
    assert np.isfinite(got).all() and 0.0 < float(np.std(got))
    print(f"{name} train={train}: sd {float(np.std(got)):.4g}, 2 ranks vs 1 max abs "
          f"{float(np.max(np.abs(got - one))):.3g}")
    assert _gate(got, one), float(np.max(np.abs(got - one)))
    if name in JAX_FLOWS:
        ref = runs["jax"][(name, train)]
        assert _gate(got, ref), float(np.max(np.abs(got - ref)))
        assert _gate(one, ref), float(np.max(np.abs(one - ref)))


@pytest.mark.parametrize("fault,train", [("indicator", True), ("indicator", False),
                                         ("local_bn", True)])
def test_planted_faults_fail_the_gate(runs, fault, train):
    """The edge indicator on every shard's padded rows moves the rows at the
    seam most; BatchNorm over each rank's own rows moves the
    whole frame. Each fails the gate that the faithful ranks pass."""
    got = _two_ranks(runs, ("single", train, fault))
    one = runs["single"][("single", train)]
    assert not _gate(got, one)
    bad = np.any(_outside(got, one), axis=(0, 2, 3))
    if fault == "indicator":
        # the seam's rows, and their neighbours through the later couplings'
        # 3x3 convs (two each), carry the largest error; in eval mode no row
        # far from the seam moves (in train mode the moments carry it on)
        worst = np.max(np.abs(got - one), axis=(0, 2, 3))
        assert 26 <= int(np.argmax(worst)) < 38
        if not train:
            assert set(np.flatnonzero(bad)) <= set(range(26, 38)), np.flatnonzero(bad)
    else:
        assert bad.mean() > 0.5


def test_four_level_flow_runs_its_deepest_level_on_every_rank():
    """At 48 rows over 2 ranks levels 0-2 shard (48, 24, 12 rows entering)
    and level 3 (6 rows: shards of 3 that the squeeze cannot halve) runs
    whole on both; over one rank all four shard."""
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.parallel.spatial import sharded_levels

    kw, shape = FLOWS["four_level"]
    flow = NoiseFlow(shape, default_config(**kw), device="cpu")
    assert sharded_levels(flow, 2) == 3 and sharded_levels(flow, 1) == 4
    assert sharded_levels(flow, 16) == 0


def test_sample_draws_what_draw_latents_draws():
    """flow.sample of a 2-level flow is forward on draw_latents' draws from a
    generator seeded alike, bit for bit, and forward without split_eps
    raises, as JAX's forward without its rng does."""
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow

    kw, shape = FLOWS["two_level"]
    flow = NoiseFlow(shape, default_config(**kw), device="cpu", seed=3).eval()
    with torch.no_grad():
        got = flow.sample({"clean": None}, TEMP, batch=2, train=True,
                          generator=torch.Generator().manual_seed(9))
        z, eps = flow.draw_latents(TEMP, 2, torch.Generator().manual_seed(9))
        # level 0's latent [32, 32, 16] with half its channels
        assert eps[1] is None and eps[0].shape == (2, 32, 32, 8)
        torch.testing.assert_close(got, flow.forward(z, {"clean": None}, True, eps, TEMP),
                                   rtol=0, atol=0)
        with pytest.raises(ValueError, match="needs split_eps"):
            flow.forward(z, {"clean": None}, True, temp=TEMP)


def test_wrapper_mesh_of_two_draws_the_noise_of_one(runs):
    """NoiseFlowWrapper.sample_noise_frame_spatial on the flagship: each
    rank's wrapper seeded alike, under a mesh of both, returns the whole
    frame, equal on both ranks and to one rank's wrapper (mesh None) with
    that seed, within the gate; a 60-row frame pads to 64 either way."""
    from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper

    torch.set_num_threads(1)
    frame = runs["spec"]["frame"]
    one = NoiseFlowWrapper(MODEL, device="cpu", seed=7).sample_noise_frame_spatial(
        frame, 0.0, 0.0, 800.0, 2.0)
    a, b = (r["wrapper"] for r in runs["ranks"])
    assert a.shape == one.shape == WRAPPER_FRAME + (4,)
    np.testing.assert_array_equal(a, b)
    assert _gate(a, one), float(np.max(np.abs(a - one)))
    assert 0.0 < float(np.std(a)) < 1.0


def test_spatial_mesh_imports_no_jax():
    """parallel/spatial.py and the wrapper load neither JAX nor the JAX package."""
    import subprocess
    import sys

    code = ("import sys\n"
            "import noise_flow_tpu_torch.parallel.spatial, noise_flow_tpu_torch.wrapper\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or\n"
            "       m == 'noise_flow_tpu' or m.startswith('noise_flow_tpu.')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=REPO)
