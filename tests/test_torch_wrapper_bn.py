"""The wrapper's batch-stats BatchNorm covers the whole batch, as JAX's.

JAX's ``NoiseFlowWrapper`` at its default ``use_pallas=False`` samples
through ``flow.sample(train=True)``, whose BN moments are the whole batch's;
the rule of at most 256 patches a group (``fused_sample.bn_block``) belongs
only to its Pallas branch. The port's wrapper passes ``bt = b`` to the fused
sampler. At b = 300 ``bn_block`` gives groups of 150, which move the noise by
far more than the float32 floor, so both tests below tell the two apart.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noise_flow_tpu.wrapper import NoiseFlowWrapper as JaxWrapper
from noise_flow_tpu_torch.ops import fused_sample as fs
from noise_flow_tpu_torch.wrapper import NoiseFlowWrapper

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = os.path.join(ROOT, "experiments", "sidd", "prod_exact_150")
B = 300
ISO, CAM, TEMP = 800.0, 2.0, 0.6
# float32 sums of the whole batch's moments in another order: the plain
# chain against JAX reads about 2e-7 abs here; groups of 150 move the noise
# by about 1e-5 abs
ATOL, RTOL = 1e-6, 1e-5


def _clean(seed=0):
    return np.random.default_rng(seed).uniform(0.01, 0.9, (B, 32, 32, 4)).astype(np.float32)


def _cond(clean, lib):
    full = (lambda v: jnp.full((B,), v, jnp.float32)) if lib == "jax" else (
        lambda v: torch.full((B,), v))
    arr = jnp.asarray if lib == "jax" else torch.as_tensor
    return {"clean": arr(clean), "iso": full(ISO), "cam": full(CAM),
            "nlf0": full(0.0), "nlf1": full(0.0)}


def test_wrapper_batch_bn_covers_the_batch():
    """The wrapper at b = 300 (two bn_block groups) equals the port's own
    flow.sample(train=True) on the same seed: one group of 300."""
    nf = NoiseFlowWrapper(MODEL, seed=3, device="cpu")
    clean = _clean()
    got = nf.sample_noise_nf(clean, 0.0, 0.0, ISO, CAM)
    with torch.no_grad():
        ref = nf.flow.sample(_cond(clean, "torch"), temp=TEMP, batch=B, train=True,
                             generator=torch.Generator().manual_seed(3))
    np.testing.assert_allclose(got, ref.numpy(), rtol=RTOL, atol=ATOL)


@pytest.fixture(scope="module")
def jax_noise():
    """JAX's flow.forward(params, state, eps * 0.6, cond, train=True) on the
    flagship checkpoint, and the eps it started from."""
    jw = JaxWrapper(MODEL)
    eps = np.random.default_rng(0).standard_normal((B, 32, 32, 4)).astype(np.float32)
    ref = jw.flow.forward(jw.params, jw.state, jnp.asarray(eps * TEMP), _cond(_clean(), "jax"),
                          train=True)
    return eps, np.asarray(ref)


@pytest.mark.parametrize("bt,agrees", [(B, True), (fs.bn_block(B), False)])
def test_fused_sample_whole_batch_matches_jax_flow(jax_noise, bt, agrees):
    """fused_sample with bt = 300 matches JAX's whole-batch moments at the
    float32 floor; groups of 150 (bn_block) exceed that tolerance."""
    eps, ref = jax_noise
    nf = NoiseFlowWrapper(MODEL, device="cpu")
    got = fs.fused_sample(nf._program, _cond(_clean(), "torch"), temp=TEMP,
                          eps=torch.as_tensor(eps), bt=bt).numpy()
    err = float(np.abs(got - ref).max())
    print(f"bt={bt}: max abs {err:.3e} against JAX flow.forward(train=True)")
    within = bool(np.all(np.abs(got - ref) <= ATOL + RTOL * np.abs(ref)))
    assert within == agrees, f"bt={bt}: max abs {err:.3e}"
