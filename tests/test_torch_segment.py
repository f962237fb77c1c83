"""noise_flow_tpu_torch's segment training path (``FusedFlow`` in train mode,
``SegmentFn`` and the plain versions of its two kernels) against the JAX
package's (``make_segment_fn``, ``_seg_fwd_call(ghost_bn=True)``, its Pallas
kernels in interpret mode), on the CPU, where the port's wrappers run the
kernels' plain PyTorch versions. Inputs and cotangents are made from numpy
seeds and fed to both packages; weights go across with ``from_numpy_tree``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_train import _assert_grads, _batch, _flows, _jax_cond, _np_tree, _torch_cond

from noise_flow_tpu.ops.packed_flow import pack
from noise_flow_tpu.ops.pallas_train import FusedFlow as JaxFusedFlow
from noise_flow_tpu.ops.pallas_train import _fold_segment, _seg_fwd_call, make_segment_fn
from noise_flow_tpu_torch.ops import fused_train as ft
from noise_flow_tpu_torch.utils.checkpoint import from_numpy_tree

torch.set_num_threads(1)

FIVE_SCALE = "sdn|gain|sdn1|gain1|sdn2|unc"  # beyond the one-shot step's 4 scale layers


@pytest.fixture(scope="module")
def flagship():
    return _flows()


@pytest.fixture(scope="module")
def five_scale():
    return _flows(FIVE_SCALE)


def _segment_a(jflow, params, state, flow):
    """The flagship's first segment on both sides: the JAX (Segment, mats
    fold) and the port's (records without BN folded in, ops code)."""
    jff = JaxFusedFlow(jflow, bt=8, mm_dtype=jnp.float32)
    _, seg, lo, hi = next(it for it in jff.plan if it[0] == "segment")
    cfg = jflow.cfg
    specs, s_lvl = jflow.level_specs[0][lo:hi], state["layers"][0][lo:hi]

    def jfold(p_slice):
        return _fold_segment(seg, specs, p_slice, s_lvl, cfg, cfg.width)[0]

    return seg, lo, hi, jfold


def _seeded(b, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, 32, 32, 4)).astype(np.float32)
    gz = (rng.standard_normal((b, 32, 32, 4)) / b).astype(np.float32)
    gldj = ((-1.0 + 0.5 * rng.standard_normal(b)) / b).astype(np.float32)
    return x, gz, gldj


# Ghost-BN forward, port (plain version) vs JAX (interpret mode), segment A
# of the flagship at b = 16: float32 sums in other orders (128-lane banded
# matmuls there). Observed: z within 1.5e-6 abs on N(0, 1) input, ldj within
# 1.4e-7 relative, the group moments within 1.2e-8 abs.
@pytest.mark.parametrize("bt", [8, 16])
def test_segment_train_forward_matches_jax(flagship, bt):
    jflow, params, state, flow = flagship
    seg, lo, hi, jfold = _segment_a(jflow, params, state, flow)
    x, _, _ = _seeded(16, seed=bt)
    m = jfold(params["layers"][0][lo:hi])
    z_r, ldj_r, bn_r = _seg_fwd_call(seg.ops, bt, jnp.float32, True, True, pack(x),
                                     m["rescales"], m["mixes"], m["m1s"], m["b1s"], m["m2s"],
                                     m["b2s"], m["m3s"], m["offs"], m["bnrun"])
    rec, offs, mixes, _ = ft.FusedFlow(flow, bt=bt).fold_segment(lo, hi, fold_bn=False)
    z, ldj, bnmom = ft.fused_segment_train_forward(torch.as_tensor(x), rec.detach(),
                                                   offs.detach(), mixes.detach(),
                                                   ft._ops_code(seg.ops), bt)
    np.testing.assert_allclose(z.numpy(), np.asarray(z_r).reshape(16, 32, 32, 4), atol=1e-5)
    np.testing.assert_allclose(ldj.numpy(), np.asarray(ldj_r), rtol=1e-6)
    # bnacc holds each channel's moment in every lane of that channel
    np.testing.assert_allclose(bnmom.numpy(), np.asarray(bn_r)[:, :, :4], atol=1e-7)


# Backward from seeded cotangents that are not the NLL's analytic seeds:
# jax.vjp of make_segment_fn through the JAX fold against autograd of
# SegmentFn through the port's fold, so the 128-lane bands and the records
# meet at the parameters. Observed: gx within 2.9e-7 of its largest value,
# every parameter gradient within 3.7e-6 of its leaf's largest value; b1/b2
# exactly zero on both sides.
def test_segment_backward_matches_jax(flagship):
    jflow, params, state, flow = flagship
    seg, lo, hi, jfold = _segment_a(jflow, params, state, flow)
    bt, b = 8, 16
    x, gz, gldj = _seeded(b, seed=3)
    seg_fn = make_segment_fn(seg.ops, bt, "float32", True)

    def f(p_slice, xp):
        m = jfold(p_slice)
        z, ldj, _ = seg_fn(xp, m["rescales"], m["mixes"], m["m1s"], m["b1s"], m["m2s"],
                           m["b2s"], m["m3s"], m["offs"])
        return z, ldj

    _, vjp = jax.vjp(f, params["layers"][0][lo:hi], pack(x))
    gp_r, gx_r = vjp((pack(gz), jnp.asarray(gldj)))
    layers = [p if lo <= i < hi else jax.tree_util.tree_map(jnp.zeros_like, p)
              for i, p in enumerate(params["layers"][0])]
    for i, g in zip(range(lo, hi), gp_r):
        layers[i] = g
    ref = {k: v.numpy() for k, v in from_numpy_tree(_np_tree({"layers": [layers]}), {}).items()
           if any(k.startswith(f"layers.{i}.") for i in range(lo, hi))}

    seg_params = {k: p for k, p in flow.named_parameters() if k in ref}
    xt = torch.as_tensor(x).requires_grad_(True)
    rec, offs, mixes, _ = ft.FusedFlow(flow, bt=bt).fold_segment(lo, hi, fold_bn=False)
    z, ldj, _ = ft.SegmentFn.apply(xt, rec, offs, mixes, ft._ops_code(seg.ops), bt,
                                   ft.SEGMENT_KERNELS)
    grads = torch.autograd.grad((z, ldj), [xt] + list(seg_params.values()),
                                (torch.as_tensor(gz), torch.as_tensor(gldj)))
    got = dict(zip(seg_params, grads[1:]))
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(gx_r).reshape(b, 32, 32, 4),
                               rtol=2e-5, atol=3e-6 * float(np.abs(gx_r).max()))
    # bias_rel=0: the b1/b2 gradients are exact zeros on both sides
    _assert_grads(got, ref, rtol=2e-4, atol_scale=2e-5, bias_rel=0.0)


def _jax_fused_loss(jflow, params, state, x, cond, bt):
    jff = JaxFusedFlow(jflow, bt=bt, mm_dtype=jnp.float32)

    def loss_fn(p):
        nll, sd, st = jff.loss(p, state, pack(x), _jax_cond(cond, True), train=True)
        return nll, (sd, st)

    return jax.value_and_grad(loss_fn, has_aux=True)(params)


# FusedFlow.loss(train=True): the port's segment path (plain versions) vs
# jax.value_and_grad of the JAX FusedFlow in train mode (interpret mode), with
# _assert_grads' tolerances as the one-shot comparison of test_torch_train.
# Observed: loss within 2.5e-7 relative, sd_z equal, BN state within 4e-9,
# gradients within 4.2e-5 of each leaf's largest value, but for the flagship's
# scalar shared gain_val, a sum over b * 4096 terms, at 1.7e-4.
@pytest.mark.parametrize("which", ["flagship", "five_scale"])
def test_fused_flow_train_loss_matches_jax(which, request):
    jflow, params, state, flow = request.getfixturevalue(which)
    b, bt = 16, 8
    x, cond = _batch(b, seed=11)
    (nll_r, (sd_r, st_r)), g_r = _jax_fused_loss(jflow, params, state, x, cond, bt)
    pt = dict(flow.named_parameters())
    nll, sd, st = ft.FusedFlow(flow, bt=bt).loss(torch.as_tensor(x), _torch_cond(cond),
                                                 train=True)
    g = torch.autograd.grad(nll, list(pt.values()), allow_unused=True)
    got = {k: torch.zeros_like(p) if gg is None else gg for (k, p), gg in zip(pt.items(), g)}
    np.testing.assert_allclose(float(nll.detach()), float(nll_r), rtol=2e-6)
    np.testing.assert_allclose(float(sd), float(sd_r), rtol=2e-6)
    ref_state = from_numpy_tree({}, _np_tree(st_r))
    assert set(st) == {k for k in ref_state if ".bn" in k} and st
    for k, v in st.items():
        np.testing.assert_allclose(v.numpy(), ref_state[k].numpy(), atol=3e-7, err_msg=k)
    ref = {k: v.numpy() for k, v in from_numpy_tree(_np_tree(g_r), {}).items()}
    _assert_grads(got, ref, rtol=2e-4, atol_scale=2e-4, bias_rel=1e-4)


# The segment path and the one-shot path compute one function at the same
# bt: two plain versions of two kernels, port only. Observed: loss within
# 1.2e-7 relative, sd_z equal, BN state within 3.7e-9, gradients within
# 5.8e-7 normwise per leaf (l1_b/l2_b: exact zeros on the segment path,
# autograd's rounding on the one-shot plain version).
@pytest.mark.parametrize("b,bt", [(16, 8), (16, 16)])
def test_segment_path_matches_oneshot(flagship, b, bt):
    _, _, _, flow = flagship
    x, cond = _batch(b, seed=b + bt)
    xt, ct = torch.as_tensor(x), _torch_cond(cond)
    pt = dict(flow.named_parameters())
    nll, sd, st = ft.FusedFlow(flow, bt=bt).loss(xt, ct, train=True)
    g = torch.autograd.grad(nll, list(pt.values()), allow_unused=True)
    g = {k: torch.zeros_like(p) if gg is None else gg for (k, p), gg in zip(pt.items(), g)}
    nll1, sd1, st1, g1 = ft.FusedTrainStep(flow, bt=bt).loss_and_grad(xt, ct)
    np.testing.assert_allclose(float(nll.detach()), float(nll1), rtol=1e-6)
    np.testing.assert_allclose(float(sd), float(sd1), rtol=1e-6)
    assert set(st) == set(st1)
    for k in st:
        np.testing.assert_allclose(st[k].numpy(), st1[k].numpy(), atol=4e-8, err_msg=k)
    for k, v in g1.items():
        if k.endswith(("l1_b", "l2_b")):
            assert float(g[k].abs().max()) == 0.0, k
            continue
        assert float((g[k] - v).norm() / v.norm().clamp_min(1e-30)) <= 5e-6, k


def test_segment_fn_cotangents(flagship):
    """SegmentFn's backward on the CPU is segment_backward_reference with the
    b1/b2 entries zeroed, and a cotangent autograd does not supply (a loss of
    ldj alone) arrives as zeros."""
    jflow, params, state, flow = flagship
    seg, lo, hi, _ = _segment_a(jflow, params, state, flow)
    x, gz, gldj = _seeded(8, seed=5)
    with torch.no_grad():
        rec, offs, mixes, _ = ft.FusedFlow(flow).fold_segment(lo, hi, fold_bn=False)
    code = ft._ops_code(seg.ops)
    leaves = [t.clone().requires_grad_(True) for t in (torch.as_tensor(x), rec, offs, mixes)]
    _, ldj, bnmom = ft.SegmentFn.apply(*leaves, code, 8, ft.SEGMENT_KERNELS)
    assert not bnmom.requires_grad
    got = torch.autograd.grad(ldj, leaves, torch.as_tensor(gldj))
    ref = ft.segment_backward_reference(torch.as_tensor(x), rec, offs, mixes, code, 8,
                                        torch.zeros((8, 32, 32, 4)), torch.as_tensor(gldj))
    for name in ("b1", "b2"):
        off, _ = ft._REC_LAYOUT[name]
        assert float(got[1][:, off:off + 4].abs().max()) == 0.0
        ref[1][:, off:off + 4] = 0.0
    for a, r in zip(got, ref):
        torch.testing.assert_close(a, r, rtol=0, atol=0)
