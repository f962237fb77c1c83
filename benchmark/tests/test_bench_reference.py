"""The benchmark's plain reference held to the port, on the CPU at small
sizes, with the flagship checkpoint: the NLL, its gradients and the new
BatchNorm state under exact and ghost BN, Adam's steps, the sampler's
normals and the sampling chain."""

import numpy as np
import pytest
import torch

from reference.flow import Adam, RefFlow, read_checkpoint, tf32_round
from reference.philox import normals

B = 12


def _port_flow(flagship):
    from noise_flow_tpu_torch.config import default_config
    from noise_flow_tpu_torch.models.flow import NoiseFlow
    from noise_flow_tpu_torch.utils.checkpoint import load_checkpoint

    cfg = default_config(arch=flagship["arch"], width=flagship["width"], lr=flagship["lr"],
                         n_batch_train=B)
    flow = NoiseFlow((32, 32, 4), cfg, device="cpu")
    load_checkpoint(flagship["weights_path"], flow)
    return flow


def _inputs(seed=0, b=B):
    g = torch.Generator().manual_seed(seed)
    clean = 0.02 + 0.9 * torch.rand((b, 32, 32, 4), generator=g)
    iso = torch.tensor([100.0, 400.0, 800.0, 1600.0, 3200.0] * 3)[:b]
    cam = torch.tensor([0.0, 1.0, 2.0, 3.0, 4.0, 2.0] * 2)[:b]
    cond = {"clean": clean, "iso": iso, "cam": cam, "nlf0": torch.full((b,), 1e-3),
            "nlf1": torch.full((b,), 2e-6)}
    x = torch.randn((b, 32, 32, 4), generator=g) * torch.sqrt(1e-3 * clean + 2e-6)
    return x, cond


def test_checkpoint_leaves_match_the_port(flagship):
    params, state = read_checkpoint(flagship["weights_path"])
    flow = _port_flow(flagship)
    assert set(params) == {k for k, _ in flow.named_parameters()}
    assert sum(v.size for v in params.values()) == flagship["parameters"] == flow.num_params()
    for k, v in flow.state_dict().items():
        src = params.get(k, state.get(k))
        np.testing.assert_array_equal(src, v.numpy())


@pytest.mark.parametrize("bn", ["exact", "ghost"])
def test_nll_gradients_and_state_match_the_port(flagship, bn):
    from noise_flow_tpu_torch.ops.fused_train import FusedTrainStep

    flow = _port_flow(flagship)
    x, cond = _inputs()
    if bn == "exact":
        nll, sd_z, state = flow.loss(x, cond, train=True)
        bt = B
    else:
        bt = 6
        nll, sd_z, state = FusedTrainStep(flow, bt=bt).loss(x, cond)
    nll.backward()
    ref = RefFlow(flagship["weights_path"], flagship["arch"], flagship["width"])
    rn, rs, rstate = ref.nll(x, cond, bn, bt)
    rn.backward()
    assert abs(float(nll.detach()) - float(rn.detach())) <= 1e-6 * abs(float(rn.detach()))
    assert abs(float(sd_z.detach()) - float(rs.detach())) <= 1e-5
    for k, v in state.items():
        torch.testing.assert_close(v.double(), rstate[k], rtol=1e-5, atol=1e-6)
    med = np.median([float(p.grad.norm()) for p in ref.params.values() if p.grad is not None])
    for k, p in flow.named_parameters():
        r = ref.params[k].grad
        if p.grad is None or r is None:
            assert (p.grad is None or float(p.grad.abs().max()) == 0.0) and (
                r is None or float(r.abs().max()) == 0.0), k
            continue
        # float32 sums of ~10^4 terms, with cancellation, against float64 ones
        assert float((p.grad.double() - r).norm()) <= 5e-3 * max(float(r.norm()), med), k


def test_adam_follows_torch_adam(flagship):
    ref = RefFlow(flagship["weights_path"], flagship["arch"], flagship["width"])
    ours = {k: v.detach().clone() for k, v in ref.params.items()}
    theirs = [v.detach().clone().requires_grad_(True) for v in ours.values()]
    opt = torch.optim.Adam(theirs, lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    adam = Adam(ours, 1e-4)
    g = torch.Generator().manual_seed(3)
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g, dtype=v.dtype) for k, v in ours.items()}
        for t, gr in zip(theirs, grads.values()):
            t.grad = gr.clone()
        opt.step()
        adam.step(grads)
    for a, b in zip(ours.values(), theirs):
        torch.testing.assert_close(a, b.detach(), rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 12345])
def test_normals_match_the_port(seed):
    from noise_flow_tpu_torch.ops.fused_sample import rng_normals_reference

    ref = normals(seed, 3)
    port = rng_normals_reference(seed, 3).double()
    assert ref.shape == (3, 32, 32, 4)
    assert float((ref - port).abs().max()) < 1e-5
    assert abs(float(ref.mean())) < 0.05 and abs(float(ref.std()) - 1.0) < 0.05


def test_sampling_chain_matches_the_port(flagship):
    from noise_flow_tpu_torch.ops.fused_sample import (
        build_sample_program,
        precompute_scale_ab,
        sample_chain_reference,
    )

    flow = _port_flow(flagship)
    _, cond = _inputs(1)
    z = normals(5, B)
    with torch.no_grad():
        prog = build_sample_program(flow)
        sa, sb = precompute_scale_ab(prog, cond)
        port = sample_chain_reference(prog, z.float(), cond["clean"], sa, sb)
    ref = RefFlow(flagship["weights_path"], flagship["arch"], flagship["width"]).sample(z, cond)
    assert float((port.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


def test_tf32_rounding():
    t = torch.tensor([1.0, 1.0 + 2.0 ** -11, 1.0 + 2.0 ** -12, -(1.0 + 3 * 2.0 ** -12), 0.0])
    r = tf32_round(t)
    assert r.tolist() == [1.0, 1.0 + 2.0 ** -10, 1.0, -(1.0 + 2.0 ** -10), 0.0]
    x = torch.randn(1000)
    assert float(((tf32_round(x) - x).abs() / x.abs()).max()) <= 2.0 ** -11
