"""The fused sampler's in-kernel RNG mode against the JAX package.

The JAX kernel draws its normals from the TPU's own generator
(``pallas_sample(in_kernel_rng=True)``, ``make_sampler``), which does not run
in interpret mode, so its bits have no CPU output to compare with. The port
draws them with a Philox-4x32-10 written into the kernel; here its plain
version (``rng_normals_reference``, what CPU tensors run) is held to
Random123's known answers, to JAX's ``_box_muller`` on the same bits, to the
statistics of N(0, 1), and, through the chain, to JAX's
``pallas_sample(eps=...)`` in interpret mode on the same normals. The kernel
itself is held against this plain version on the card
(tests/test_torch_kernels.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from noise_flow_tpu.config import load_hps as jax_load_hps
from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
from noise_flow_tpu.ops.pallas_sample import _box_muller
from noise_flow_tpu.ops.pallas_sample import build_sample_program as jax_build
from noise_flow_tpu.ops.pallas_sample import pallas_sample
from noise_flow_tpu.utils import checkpoint as jax_ckpt
from noise_flow_tpu_torch.config import load_hps
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.ops import fused_sample as fs
from noise_flow_tpu_torch.utils import checkpoint as ckpt

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "experiments", "sidd", "prod_exact_150")
BEST = os.path.join(MODEL, "ckpt", "model.ckpt-best.npz")


# Random123's published known-answer vectors for Philox-4x32-10:
# (counter c0..c3, key k0 k1) -> output
@pytest.mark.parametrize("counter,key,expect", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2, (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, expect):
    out = fs.philox4x32_10(torch.tensor(counter, dtype=torch.int64),
                           torch.tensor(key, dtype=torch.int64))
    assert out.tolist() == list(expect)
    # broadcast over a batch of counters under one key, as the sampler does
    many = fs.philox4x32_10(torch.tensor([counter] * 3, dtype=torch.int64),
                            torch.tensor(key, dtype=torch.int64))
    assert many.tolist() == [list(expect)] * 3


def test_box_muller_matches_jax():
    """The same uint32 bits through the port's box_muller and JAX's
    _box_muller: within 1e-6 (observed 2.4e-7, one float32 ulp of a value
    in [2, 4)), the cos half in rows [0, 16) and the sin half in [16, 32)."""
    rng = np.random.default_rng(0)
    b1, b2 = (rng.integers(0, 2 ** 32, (4, 16, 128), dtype=np.uint64).astype(np.uint32)
              for _ in range(2))
    ref = np.asarray(_box_muller(jnp.asarray(b1), jnp.asarray(b2)))
    got = fs.box_muller(torch.as_tensor(b1.astype(np.int64)),
                        torch.as_tensor(b2.astype(np.int64))).numpy()
    assert got.shape == ref.shape == (4, 32, 128)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    u1 = (b1 >> 8).astype(np.float64) * 2.0 ** -24 + 2.0 ** -25
    u2 = (b2 >> 8).astype(np.float64) * 2.0 ** -24
    r = np.sqrt(-2.0 * np.log(u1))
    # against float64: the float32 angle 2 pi u2 is off by up to half an ulp
    # of 6.28 (2.4e-7), times r up to 5.9 (observed 2.5e-6)
    np.testing.assert_allclose(got[:, :16], r * np.cos(2 * np.pi * u2), rtol=0, atol=5e-6)
    np.testing.assert_allclose(got[:, 16:], r * np.sin(2 * np.pi * u2), rtol=0, atol=5e-6)


def test_rng_normals_layout():
    """Row h and row h + 16 of a patch are one Box-Muller pair of the bits
    at counter (32 h + w, patch, j, 0) under key (seed, 0)."""
    seed, b = 77, 3
    n = fs.rng_normals_reference(seed, b).numpy()
    h, w, c, patch = 5, 17, 2, 2
    bits = [fs.philox4x32_10(torch.tensor([32 * h + w, patch, j, 0]),
                             torch.tensor([seed, 0]))[c].item() for j in (0, 1)]
    pair = fs.box_muller(torch.tensor([[bits[0]]]), torch.tensor([[bits[1]]])).numpy()
    assert n[patch, h, w, c] == pair[0, 0] and n[patch, h + 16, w, c] == pair[1, 0]


def test_rng_normals_statistics():
    """2^20 normals of one seed: mean, sd and a KS test against N(0, 1); two
    patches and two consecutive seeds uncorrelated."""
    seed = 2024
    n = fs.rng_normals_reference(seed, 256).numpy().astype(np.float64)
    flat = n.reshape(-1)
    assert flat.size == 2 ** 20
    assert abs(flat.mean()) < 5 / np.sqrt(flat.size)           # 5 sigma
    assert abs(flat.std() - 1.0) < 5 * np.sqrt(0.5 / flat.size)
    assert stats.kstest(flat, "norm").pvalue > 1e-3
    per_patch = n.reshape(256, -1)
    lim = 5 / np.sqrt(per_patch.shape[1])
    assert abs(np.corrcoef(per_patch[0], per_patch[1])[0, 1]) < lim
    nxt = fs.rng_normals_reference(seed + 1, 256).numpy().reshape(256, -1)
    assert abs(np.corrcoef(per_patch.reshape(-1), nxt.reshape(-1))[0, 1]) < 5 / np.sqrt(flat.size)
    # the cos and sin halves of a pair are uncorrelated too
    assert abs(np.corrcoef(n[:, :16].reshape(-1), n[:, 16:].reshape(-1))[0, 1]) < 5 / np.sqrt(2 ** 19)


def test_rng_seeds_and_batches_do_not_overlap():
    """Seed s + 1 reproduces no patch of seed s (the seed keys, the patch
    counts; JAX's guarantee of pallas_sample.py:432-435); a patch's draws do
    not depend on the batch size; seeds are taken modulo 2^31 - 1, as JAX."""
    a = fs.rng_normals_reference(41, 128).numpy().reshape(128, -1)
    b = fs.rng_normals_reference(42, 128).numpy().reshape(128, -1)
    firsts = {row[:8].tobytes() for row in a}
    assert len(firsts) == 128
    assert not firsts & {row[:8].tobytes() for row in b}
    np.testing.assert_array_equal(fs.rng_normals_reference(42, 16).numpy().reshape(16, -1),
                                  b[:16])
    np.testing.assert_array_equal(fs.rng_normals_reference(42 + fs.SEED_MOD, 2).numpy(),
                                  fs.rng_normals_reference(42, 2).numpy())
    assert fs.rng_seed(-1) == fs.SEED_MOD - 1


# ---------------------------------------------------------------------------
# the chain in RNG mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flagship():
    cfg = jax_load_hps(os.path.join(MODEL, "hps.txt"))
    jflow = JaxFlow((32, 32, 4), cfg)
    p0, s0 = jflow.init(jax.random.PRNGKey(0))
    params, state, _, _ = jax_ckpt.load_checkpoint(BEST, p0, s0, None)
    flow = NoiseFlow((32, 32, 4), load_hps(os.path.join(MODEL, "hps.txt")), device="cpu")
    ckpt.load_checkpoint(BEST, flow)
    return jflow, params, state, flow


def _cond(b, seed=5):
    rng = np.random.default_rng(seed)
    base = {"clean": rng.uniform(0.01, 0.9, (b, 32, 32, 4)).astype(np.float32),
            "iso": np.resize(np.float32([100, 400, 800, 1600, 3200]), b),
            "cam": np.resize(np.float32([0, 1, 2, 3, 4, 2]), b),
            "nlf0": np.zeros(b, np.float32), "nlf1": np.zeros(b, np.float32)}
    return ({k: jnp.asarray(v) for k, v in base.items()},
            {k: torch.as_tensor(v) for k, v in base.items()})


# (rtol, atol) of tests/test_torch_sample.py, its tolerance for the plain
# chain against the JAX kernel: float32 matmuls in another order; in batch
# mode the moments too, divided by sqrt(var + 1e-4). Observed here: 1.3e-7
# (running) and 1.9e-7 (batch) abs on noise of sd 0.027.
@pytest.mark.parametrize("mode,tol", [("running", (1e-4, 1e-4)), ("batch", (2e-3, 2e-4))])
def test_rng_chain_matches_pallas_on_shared_normals(flagship, mode, tol):
    jflow, params, state, flow = flagship
    b, seed, temp = 16, 1234, 0.6
    jc, tc = _cond(b)
    eps = fs.rng_normals_reference(seed, b).numpy()
    ref = pallas_sample(jax_build(jflow, params, state, bn_mode=mode), None, jc,
                        temp=temp, eps=eps, bt=b, interpret=True)
    prog = fs.build_sample_program(flow, bn_mode=mode)
    before = dict(fs.launch_counts)
    got = fs.fused_sample(prog, tc, temp=temp, seed=seed, bt=b)
    assert dict(fs.launch_counts) == before          # CPU: the plain version, no launch
    rtol, atol = tol
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=rtol, atol=atol)
    # the temperature is applied to the drawn normals: the same chain on eps
    same = fs.fused_sample(prog, tc, temp=temp, eps=torch.as_tensor(eps), bt=b)
    np.testing.assert_array_equal(got.numpy(), same.numpy())


def test_make_sampler_matches_fused_sample(flagship):
    _, _, _, flow = flagship
    prog = fs.build_sample_program(flow, bn_mode="running")
    b = 128
    _, tc = _cond(b, seed=9)
    sampler = fs.make_sampler(prog, tc, temp=0.6, bt=16, mm_dtype=torch.float32)
    tile = sampler(7)
    assert tuple(tile.shape) == (b, 32, 128)
    ref = fs.fused_sample(prog, tc, temp=0.6, seed=7)
    np.testing.assert_array_equal(tile.reshape(b, 32, 32, 4).numpy(), ref.numpy())
    nhwc = fs.make_sampler(prog, tc, temp=0.6, bt=128, mm_dtype=torch.float32,
                           tile_out=False)
    np.testing.assert_array_equal(nhwc(7).numpy(), ref.numpy())   # bt 16 or 128: the same
    assert not np.array_equal(nhwc(8).numpy(), ref.numpy())
    sa, sb = fs.precompute_scale_ab(prog, tc)
    np.testing.assert_array_equal(sa.numpy(), prog.scale_ab(tc, b)[0].numpy())


def test_make_sampler_checks(flagship, caplog):
    _, _, _, flow = flagship
    prog = fs.build_sample_program(flow, bn_mode="batch")
    _, tc = _cond(24)
    with pytest.raises(ValueError, match="multiple of bt"):
        fs.make_sampler(prog, tc, bt=16, mm_dtype=torch.float32)
    with caplog.at_level("WARNING"):
        got = fs.make_sampler(prog, tc, bt=8)(3)    # JAX's default: bf16, run as such
    assert not caplog.text
    bf16 = fs.fused_sample(prog, tc, seed=3, bt=8, mm_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got.reshape(24, 32, 32, 4).numpy(), bf16.numpy())
    assert not torch.equal(bf16, fs.fused_sample(prog, tc, seed=3, bt=8))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fs.make_sampler(prog, tc, bt=8, mm_dtype=torch.float16)
    with pytest.raises(ValueError, match="eps or seed"):
        fs.fused_sample(prog, tc, eps=torch.zeros(24, 32, 32, 4), seed=1)
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        fs.rng_normals(1, 2, "meta")
    np.testing.assert_array_equal(fs.rng_normals(3, 2, "cpu", temp=0.5).numpy(),
                                  (fs.rng_normals_reference(3, 2) * 0.5).numpy())
