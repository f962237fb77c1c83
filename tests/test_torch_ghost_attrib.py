"""The kernel-path recipe's step at its own shape against JAX's, on the
CPU: one one-shot loss-and-gradient step at b = 138 with ghost BN over two
blocks of 69 (``pick_block(138, 64, 8)``), the flagship arch, from the
weights where JAX's float32 ghost-BN run ended (experiments/sidd/bn_delta/
ghost_f32, epoch 60, on its ghost-BN plateau), in float32 and in bfloat16;
JAX's kernel in interpret mode, the port's plain version. It attributes the
gap between the port's runs of the recipe on the card and JAX's records
(ROADMAP, queue 3, fault D): the step's arithmetic agrees at the recipe's
shape, each precision with its own, and the other precision's port fails
the same tolerances.

Measured (the other precision's port in brackets): float32, the NLL within
0.014 nats (0.75), sd_z 6e-8 (2.2e-4), the new BN state 7.5e-9 abs (3.5e-5),
the gradients 5.8e-5 normwise over every leaf (5.8e-3); bfloat16, 0.065
nats (0.83), 1.1e-5 (2.1e-4), 7.1e-7 (3.5e-5), 4.8e-4 (5.8e-3): the
bfloat16 distances sit at the floor that ``tests/test_torch_bf16.py``
measures (JAX against itself with its input moved by one float32 ulp:
gradients 5.6e-4-5.8e-4).
"""

import os

import jax
import jax.numpy as jnp
import pytest
import torch
from test_torch_bf16 import _grad_dist
from test_torch_train import _batch, _jax_cond, _np_tree, _torch_cond

from noise_flow_tpu.config import default_config as jax_default_config
from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
from noise_flow_tpu.ops.packed_flow import pack
from noise_flow_tpu.ops.pallas_train import FusedTrainStep as JaxFusedTrainStep
from noise_flow_tpu.utils import checkpoint as jax_ckpt
from noise_flow_tpu_torch.config import default_config
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.ops import fused_train as ft
from noise_flow_tpu_torch.utils import checkpoint as ckpt
from noise_flow_tpu_torch.utils.checkpoint import from_numpy_tree

torch.set_num_threads(1)

ARCH = "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc"
PLATEAU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                       "experiments", "sidd", "bn_delta", "ghost_f32", "ckpt",
                       "model.ckpt-60.npz")
B, BT = 138, 69
# (NLL abs, sd_z abs, BN state abs, gradients normwise), by precision
TOL = {"float32": (0.1, 1e-6, 1e-7, 5e-4), "bfloat16": (0.3, 1e-4, 1e-5, 2e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_recipe_step_at_its_shape_matches_jax(dtype):
    jflow = JaxFlow((32, 32, 4), jax_default_config(arch=ARCH))
    params, state = jflow.init(jax.random.PRNGKey(0))
    params, state, _, _ = jax_ckpt.load_checkpoint(PLATEAU, params, state)
    flow = NoiseFlow((32, 32, 4), default_config(arch=ARCH), device="cpu")
    assert ckpt.load_checkpoint(PLATEAU, flow) == 60
    assert ft.pick_block(B, target=64, stretch=8) == BT
    x, cond = _batch(B, seed=3)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    nll_r, sd_r, st_r, g_r = JaxFusedTrainStep(jflow, bt=BT, mm_dtype=jdt).loss_and_grad(
        params, state, pack(x), _jax_cond(cond, True))
    ref = {k: v.numpy() for k, v in from_numpy_tree(_np_tree(g_r), {}).items()}
    ref_state = from_numpy_tree({}, _np_tree(st_r))

    def dist(mm_dtype):
        nll, sd, st, g = ft.FusedTrainStep(flow, bt=BT, mm_dtype=mm_dtype).loss_and_grad(
            torch.as_tensor(x), _torch_cond(cond))
        return (abs(float(nll) - float(nll_r)), abs(float(sd) - float(sd_r)),
                max(float((v - ref_state[k]).abs().max()) for k, v in st.items()),
                _grad_dist(g, ref)[0])
    other = "bfloat16" if dtype == "float32" else "float32"
    port, cross = dist(dtype), dist(other)
    print(f"{dtype} step at b={B}, bt={BT} from bn_delta/ghost_f32 epoch 60 (NLL, sd_z, BN, "
          f"grads): port {port}; {other} port {cross}")
    assert all(d <= t for d, t in zip(port, TOL[dtype]))
    assert all(d > t for d, t in zip(cross, TOL[dtype]))
