"""The bfloat16 modes of the port's fused kernels against the JAX package's.

JAX's kernels run their products in bfloat16 where ``mm_dtype`` asks for
it (``make_sampler``'s default; the trainer's ``pallas_train_dtype``):
``mm(a, b)`` rounds both operands to bfloat16 and sums exact products in
float32. The port's plain versions round at the same places. Here, on the
CPU, the same numpy-seeded inputs go through the JAX functions (Pallas in
interpret mode, ``mm_dtype=jnp.bfloat16``) and through the port's plain
bfloat16 versions. Each comparison holds three things in one test, and
prints its distances:

- (a) the port's bfloat16 mode passes the tolerance;
- (b) the port's float32 mode, on the same inputs, fails it;
- (c) the port's plain version with one rounding point planted out (a
  monkeypatch here; the package has no such switch) fails it.

A tolerance cannot be tighter than the rounding flips themselves: a value
within one float32 ulp of a bfloat16 rounding boundary rounds either way
under another float32 summation order, and the flagship's ReLUs pass that
on. JAX against itself with its input moved by one float32 ulp (x * (1 +
2^-23)) measures that floor here: the one-shot step's gradients move by
5.6e-4 (bt 8) and 5.8e-4 (bt 16) normwise over all leaves, its NLL by
7e-3 and 8e-3 nats.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rng import BEST, MODEL
from test_torch_rng import _cond as _sample_cond
from test_torch_segment import _segment_a, _seeded
from test_torch_train import _batch, _flows, _jax_cond, _np_tree, _torch_cond

from noise_flow_tpu.config import default_config as jax_default_config
from noise_flow_tpu.config import load_hps as jax_load_hps
from noise_flow_tpu.models.flow import NoiseFlow as JaxFlow
from noise_flow_tpu.ops.packed_flow import pack
from noise_flow_tpu.ops.pallas_sample import build_sample_program as jax_build
from noise_flow_tpu.ops.pallas_sample import pallas_sample
from noise_flow_tpu.ops.pallas_train import FusedFlow as JaxFusedFlow
from noise_flow_tpu.ops.pallas_train import FusedTrainStep as JaxFusedTrainStep
from noise_flow_tpu.ops.pallas_train import _seg_fwd_call, make_segment_fn
from noise_flow_tpu.parallel.mesh import make_mesh
from noise_flow_tpu.training.trainer import Trainer as JaxTrainer
from noise_flow_tpu.utils import checkpoint as jax_ckpt
from noise_flow_tpu_torch.config import default_config, load_hps
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.ops import fused_sample as fs
from noise_flow_tpu_torch.ops import fused_train as ft
from noise_flow_tpu_torch.ops.nn import BN_EPS, conv2d_nhwc
from noise_flow_tpu_torch.training.trainer import Trainer
from noise_flow_tpu_torch.utils import checkpoint as ckpt
from noise_flow_tpu_torch.utils.checkpoint import from_numpy_tree

torch.set_num_threads(1)

ARCH = "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc"
BIASES = ("l1_b", "l2_b")   # feed a BatchNorm: zero true gradient, held elsewhere


@pytest.fixture(scope="module")
def flagship():
    return _flows()


@pytest.fixture(scope="module")
def trained():
    """The in-repo flagship checkpoint on both sides (the sampler's weights)."""
    cfg = jax_load_hps(f"{MODEL}/hps.txt")
    jflow = JaxFlow((32, 32, 4), cfg)
    p0, s0 = jflow.init(jax.random.PRNGKey(0))
    params, state, _, _ = jax_ckpt.load_checkpoint(BEST, p0, s0, None)
    flow = NoiseFlow((32, 32, 4), load_hps(f"{MODEL}/hps.txt"), device="cpu")
    ckpt.load_checkpoint(BEST, flow)
    return jflow, params, state, flow


def _rel(a, r):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(r)) / max(np.linalg.norm(r), 1e-30))


def _grad_dist(got, ref):
    """(normwise over all leaves, worst leaf normwise, its name); the conv
    biases before a BatchNorm are left out (zero true gradient)."""
    keys = [k for k in ref if not k.endswith(BIASES)]
    num = sum(float(np.sum((np.asarray(got[k]) - ref[k]) ** 2)) for k in keys)
    den = sum(float(np.sum(ref[k] ** 2)) for k in keys)
    per = {k: _rel(got[k], ref[k]) for k in keys}
    worst = max(per, key=per.get)
    return float(np.sqrt(num / den)), per[worst], worst


def _unrounded_cmean(v, bt):
    """Planted: the moments' lane sums left in float32 (item 2 of the
    contract: JAX rounds them)."""
    return (v.sum(dim=(1, 2, 3)) * (1.0 / (bt * 32 * 32)))[:, None, None, None, :]


def _cast_ops(mm_dtype):
    """Planted: autograd through the casts, which rounds the results of the
    backward's products where JAX rounds their operands, and differentiates
    the forward's moment rounding where JAX takes bn_bwd's own means."""
    def conv(x, w):
        return conv2d_nhwc(fs.bf16_round(x), fs.bf16_round(w))

    def mm(a, b):
        return fs.bf16_round(a) @ fs.bf16_round(b)

    def bn(h, bt):
        g = h.reshape(h.shape[0] // bt, bt, 32, 32, h.shape[-1])
        m = ft._bf16_cmean(g, bt)
        v = ft._bf16_cmean((g - m) ** 2, bt)
        n = ((g - m) * torch.rsqrt(v + BN_EPS)).reshape(h.shape)
        return n, m.mean(dim=(0, 1, 2, 3)).detach(), v.mean(dim=(0, 1, 2, 3)).detach()
    return conv, mm, bn


# ---------------------------------------------------------------------------
# the sampler
# ---------------------------------------------------------------------------

def test_folded_records_match_jax_band_entries(trained):
    """The running-BN program's folded weights, which the bfloat16 mode
    rounds, are JAX build_sample_program's band entries to the last bit:
    the fold takes _bn_fold's float32 operations, in numpy, on both sides.
    The mixes (A^-1 of the LU parameters, built by each package's own
    linear algebra) may differ in the last float32 bits; no entry of them
    may round to another bfloat16 value."""
    jflow, params, state, flow = trained
    jp = jax_build(jflow, params, state, bn_mode="running")
    prog = fs.build_sample_program(flow, bn_mode="running")
    C = 4
    m1a, m1b = np.asarray(jp.m1as), np.asarray(jp.m1bs)
    m2, m3 = np.asarray(jp.m2s), np.asarray(jp.m3s)
    b1, b2 = np.asarray(jp.b1s), np.asarray(jp.b2s)
    for i in range(prog.coup.shape[0]):
        rec = prog.coup[i].numpy()
        w1, w2 = rec[0:72].reshape(3, 3, 2, 4), rec[76:92].reshape(4, 4)
        w3 = rec[96:240].reshape(3, 3, 4, 4)
        for dw in range(3):              # output column 1 reads input column dw
            for ci in range(2):
                np.testing.assert_array_equal(m1a[i, dw * C + ci, C:2 * C], w1[1, dw, ci])
                np.testing.assert_array_equal(m1a[i, dw * C + 2 + ci, C:2 * C], w1[0, dw, ci])
                np.testing.assert_array_equal(m1b[i, dw * C + ci, C:2 * C], w1[2, dw, ci])
            for dh in range(3):
                for ci in range(C):
                    np.testing.assert_array_equal(m3[i, dh, dw * C + ci, C + 2:2 * C],
                                                  w3[dh, dw, ci, 0:2])   # shift
                    np.testing.assert_array_equal(m3[i, dh, dw * C + ci, C:C + 2],
                                                  w3[dh, dw, ci, 2:4])   # log-scale
        np.testing.assert_array_equal(m2[i, C:2 * C, C:2 * C], w2)
        np.testing.assert_array_equal(b1[i, :C], rec[72:76])
        np.testing.assert_array_equal(b2[i, :C], rec[92:96])
    jm = np.asarray(jp.mixes)[:, :C, :C]
    pm = prog.mixes.numpy()
    flips = int(np.sum(fs.bf16_round(torch.as_tensor(jm)).numpy()
                       != fs.bf16_round(torch.as_tensor(pm)).numpy()))
    print(f"mixes: max abs {np.abs(jm - pm).max():.3e}, bf16 flips {flips} of {jm.size}")
    np.testing.assert_allclose(pm, jm, rtol=1e-6, atol=1e-7)
    assert flips == 0


def _zero_conv_act_unrounded(h, rec, rnd):
    """Planted: the zero-conv's input (relu of the hidden map) not rounded."""
    wz = torch.cat([rnd(fs._field(rec, "w3")), fs._field(rec, "wind")[:, :, None]], 2)
    return conv2d_nhwc(fs._edge_pad_with_indicator(h), wz, "VALID") + fs._field(rec, "bz")


# The sampler on the flagship checkpoint, b = 16, temperature 0.6, from the
# normals of one seed: JAX pallas_sample(eps=those normals, bf16) against the
# port's eps mode on the same normals and its RNG mode on the seed (the same
# numbers, drawn by rng_normals_reference), normwise: a rounding flip in an
# early coupling moves a few values by up to 5e-2 of the noise's sd, so an
# elementwise bound would have to admit faults.
SAMPLE_RTOL = 3e-4


@pytest.mark.parametrize("mode", ["running", "batch"])
def test_sampler_bf16_matches_jax(trained, mode, monkeypatch):
    jflow, params, state, flow = trained
    b, seed, temp = 16, 99, 0.6
    jc, tc = _sample_cond(b)
    eps = fs.rng_normals_reference(seed, b).numpy()
    ref = np.asarray(pallas_sample(jax_build(jflow, params, state, bn_mode=mode), None, jc,
                                   temp=temp, eps=eps, bt=b, interpret=True,
                                   mm_dtype=jnp.bfloat16))
    prog = fs.build_sample_program(flow, bn_mode=mode)

    def dist(got):
        e = _rel(got.numpy(), ref)
        return e, e <= SAMPLE_RTOL

    def run(mm_dtype, **kw):
        return fs.fused_sample(prog, tc, temp=temp, bt=b, mm_dtype=mm_dtype, **kw)

    got_eps = dist(run("bfloat16", eps=torch.as_tensor(eps)))
    got_rng = dist(run(torch.bfloat16, seed=seed))
    f32 = dist(run("float32", seed=seed))
    monkeypatch.setattr(fs, "_zero_conv", _zero_conv_act_unrounded)
    planted = dist(run("bfloat16", seed=seed))
    print(f"sampler bn={mode}: normwise eps mode {got_eps[0]:.3e}, rng mode {got_rng[0]:.3e}; "
          f"float32 {f32[0]:.3e}; zero-conv input unrounded {planted[0]:.3e}")
    assert got_eps[1] and got_rng[1]
    assert not f32[1]
    assert not planted[1]


# ---------------------------------------------------------------------------
# the one-shot step
# ---------------------------------------------------------------------------

# The one-shot step at b = 16 with the perturbed flagship weights. Measured:
# port against JAX 3.4e-4 (bt 8) and 5.9e-4 (bt 16) normwise over all leaves,
# at JAX's one-ulp floor (above); the moments unrounded 1.2e-3 and 1.6e-3;
# float32 3.1e-3 and 3.3e-3. The NLL and the BN state tell float32 apart
# (0.46-0.51 nats, 6e-6) but not the moment fault (0.03 nats, 1e-6), which
# the gradients catch.
STEP_NLL_ATOL, STEP_SD_ATOL, STEP_BN_ATOL = 0.02, 5e-5, 2e-6
STEP_GRAD_RTOL, STEP_LEAF_RTOL = 9e-4, 1.2e-2


@pytest.mark.parametrize("bt", [8, 16])
def test_oneshot_step_bf16_matches_jax(flagship, bt, monkeypatch):
    jflow, params, state, flow = flagship
    x, cond = _batch(16, seed=bt)
    js = JaxFusedTrainStep(jflow, bt=bt, mm_dtype=jnp.bfloat16)
    nll_r, sd_r, st_r, g_r = js.loss_and_grad(params, state, pack(x), _jax_cond(cond, True))
    ref = {k: v.numpy() for k, v in from_numpy_tree(_np_tree(g_r), {}).items()}
    ref_state = from_numpy_tree({}, _np_tree(st_r))

    def dist(mm_dtype):
        nll, sd, st, g = ft.FusedTrainStep(flow, bt=bt, mm_dtype=mm_dtype).loss_and_grad(
            torch.as_tensor(x), _torch_cond(cond))
        d = {"nll": abs(float(nll) - float(nll_r)), "sd": abs(float(sd) - float(sd_r)),
             "bn": max(float((v - ref_state[k]).abs().max()) for k, v in st.items())}
        d["grad"], d["leaf"], worst = _grad_dist(g, ref)
        ok = (d["nll"] <= STEP_NLL_ATOL and d["sd"] <= STEP_SD_ATOL and d["bn"] <= STEP_BN_ATOL
              and d["grad"] <= STEP_GRAD_RTOL and d["leaf"] <= STEP_LEAF_RTOL)
        return ok, ", ".join(f"{k} {v:.3e}" for k, v in d.items()) + f" ({worst})"

    ok, port = dist("bfloat16")
    ok32, f32 = dist("float32")
    monkeypatch.setattr(ft, "_bf16_cmean", _unrounded_cmean)
    okp, planted = dist("bfloat16")
    print(f"one-shot bt={bt}: port {port}; float32 {f32}; moments unrounded {planted}")
    assert ok and not ok32 and not okp


# ---------------------------------------------------------------------------
# the eval forward and the segment kernels
# ---------------------------------------------------------------------------

# FusedFlow.inverse(train=False) at b = 16 (running BN) with the trained
# checkpoint: the perturbed initial weights leave every coupling ReLU off
# under running statistics, where no rounding of the NN shows. z normwise,
# the per-patch objective absolute (nats; sums of about 1e4 in float32).
# Measured: port 5.7e-8 and 0.021; float32 8.4e-3 and 0.16; BN folded into
# the weights before rounding 1.5e-3 and 0.15.
EVAL_Z_RTOL, EVAL_OBJ_ATOL = 1e-4, 0.05


def test_fused_eval_bf16_matches_jax(trained, monkeypatch):
    jflow, params, state, flow = trained
    x, cond = _batch(16, seed=3)
    jf = JaxFusedFlow(jflow, bt=16, mm_dtype=jnp.bfloat16)
    z_r, obj_r, _ = jf.inverse(params, state, pack(x), _jax_cond(cond, True), train=False)
    z_r, obj_r = np.asarray(z_r).reshape(16, 32, 32, 4), np.asarray(obj_r)

    def dist(mm_dtype):
        z, obj, _ = ft.FusedFlow(flow, bt=16, mm_dtype=mm_dtype).inverse(
            torch.as_tensor(x), _torch_cond(cond), train=False)
        return _rel(z.numpy(), z_r), float(np.abs(obj.numpy() - obj_r).max())

    def ok(d):
        return d[0] <= EVAL_Z_RTOL and d[1] <= EVAL_OBJ_ATOL

    port, f32 = dist("bfloat16"), dist("float32")
    fold = ft.FusedFlow.fold_segment
    monkeypatch.setattr(ft.FusedFlow, "fold_segment",
                        lambda self, lo, hi, fold_bn: fold(self, lo, hi, True))
    monkeypatch.setattr(ft.FusedFlow, "running_moments", lambda self, lo, hi: None)
    planted = dist("bfloat16")
    print(f"eval (z normwise, objective max abs): port {port}; float32 {f32}; BN folded {planted}")
    assert ok(port) and not ok(f32) and not ok(planted)


# The ghost-BN forward of the flagship's first segment at b = 16, bt 8:
# z normwise (N(0, 1) input), ldj relative, the group moments absolute; and
# the backward from seeded cotangents through both folds to the parameters,
# normwise over the segment's leaves and x. Measured: port z 3.0e-5, ldj
# 7.6e-6, moments 3e-8, gradients 3.3e-5; float32 4.4e-3, 1.2e-3, 1.4e-4,
# 3.7e-2; the autograd of the casts: gradients 4.1e-3.
SEG_Z_RTOL, SEG_LDJ_RTOL, SEG_BN_ATOL = 1e-4, 2e-5, 2e-5
SEG_GRAD_RTOL = 9e-4


def test_segment_bf16_matches_jax(flagship, monkeypatch):
    jflow, params, state, flow = flagship
    seg, lo, hi, jfold = _segment_a(jflow, params, state, flow)
    bt, b = 8, 16
    x, gz, gldj = _seeded(b, seed=3)
    m = jfold(params["layers"][0][lo:hi])
    z_r, ldj_r, bn_r = _seg_fwd_call(seg.ops, bt, jnp.bfloat16, True, True, pack(x),
                                     m["rescales"], m["mixes"], m["m1s"], m["b1s"], m["m2s"],
                                     m["b2s"], m["m3s"], m["offs"], m["bnrun"])
    z_r = np.asarray(z_r).reshape(b, 32, 32, 4)
    seg_fn = make_segment_fn(seg.ops, bt, "bfloat16", True)

    def f(p_slice, xp):
        mm = jfold(p_slice)
        z, ldj, _ = seg_fn(xp, mm["rescales"], mm["mixes"], mm["m1s"], mm["b1s"], mm["m2s"],
                           mm["b2s"], mm["m3s"], mm["offs"])
        return z, ldj

    _, vjp = jax.vjp(f, params["layers"][0][lo:hi], pack(x))
    gp_r, gx_r = vjp((pack(gz), jnp.asarray(gldj)))
    layers = [p if lo <= i < hi else jax.tree_util.tree_map(jnp.zeros_like, p)
              for i, p in enumerate(params["layers"][0])]
    for i, g in zip(range(lo, hi), gp_r):
        layers[i] = g
    ref = {k: v.numpy() for k, v in from_numpy_tree(_np_tree({"layers": [layers]}), {}).items()
           if any(k.startswith(f"layers.{i}.") for i in range(lo, hi))}
    ref["x"] = np.asarray(gx_r).reshape(b, 32, 32, 4)
    seg_params = {k: p for k, p in flow.named_parameters() if k in ref}
    code = ft._ops_code(seg.ops)

    def dist(mm_dtype):
        rec, offs, mixes, _ = ft.FusedFlow(flow, bt=bt).fold_segment(lo, hi, fold_bn=False)
        z, ldj, bnmom = ft.fused_segment_train_forward(
            torch.as_tensor(x), rec.detach(), offs.detach(), mixes.detach(), code, bt, mm_dtype)
        fwd = (_rel(z.numpy(), z_r),
               float(np.max(np.abs(ldj.numpy() - np.asarray(ldj_r)) / np.abs(ldj_r))),
               float(np.abs(bnmom.numpy() - np.asarray(bn_r)[:, :, :4]).max()))
        xt = torch.as_tensor(x).requires_grad_(True)
        zz, ll, _ = ft.SegmentFn.apply(xt, rec, offs, mixes, code, bt, ft.SEGMENT_KERNELS,
                                       mm_dtype)
        grads = torch.autograd.grad((zz, ll), [xt] + list(seg_params.values()),
                                    (torch.as_tensor(gz), torch.as_tensor(gldj)))
        got = dict(zip(seg_params, grads[1:]), x=grads[0])
        fwd_ok = fwd[0] <= SEG_Z_RTOL and fwd[1] <= SEG_LDJ_RTOL and fwd[2] <= SEG_BN_ATOL
        bwd = _grad_dist(got, ref)
        return fwd_ok, bwd[0] <= SEG_GRAD_RTOL, fwd, bwd

    port, f32 = dist("bfloat16"), dist("float32")
    monkeypatch.setattr(ft, "_ops", _cast_ops)
    planted = dist("bfloat16")
    print(f"segment (z normwise, ldj rel, moments abs; grads all, worst leaf): port {port[2:]}; "
          f"float32 {f32[2:]}; autograd of the casts {planted[2:]}")
    assert port[0] and port[1]
    assert not f32[0] and not f32[1]
    assert not planted[1]


# ---------------------------------------------------------------------------
# the trainer
# ---------------------------------------------------------------------------

# 3 Adam steps at lr 1e-3, b = 8, the default config (pallas_train_dtype
# bfloat16) on both sides, from the same initial weights on the same
# batches: the parameters against JAX's, normwise over all parameters (the
# conv biases before a BN left out) relative to JAX's moves; the BN running
# statistics absolute. Measured after each step: the port 6.6e-6, 6.0e-5,
# then 0.051 (one-shot) and 0.0035 (segment); the third step moves the conv1
# and conv2 weights for the first time (the zero-initialised zero-conv
# passes them no gradient before), and BN makes their gradients small
# residuals of cancelling terms, where rounding shows (the float32 port
# against float32 JAX reads 1.3e-3 on those leaves there, 1.8e-4 in all).
# The float32 port against bfloat16 JAX: 0.233. The BN state tells neither
# apart (7.5e-5 and 6.9e-5).
TRAJ_RTOL, TRAJ_BN_ATOL = 0.1, 3e-4


@pytest.mark.parametrize("oneshot", [True, False], ids=["oneshot", "segment"])
def test_trainer_bf16_trajectory_matches_jax(oneshot):
    kw = dict(arch=ARCH, patch_height=32, lr=1e-3, use_pallas=True, pallas_oneshot=oneshot)
    jcfg = jax_default_config(**kw)
    assert jcfg.pallas_train_dtype == "bfloat16"
    jtr = JaxTrainer(JaxFlow((32, 32, 4), jcfg), jcfg, mesh=make_mesh(1))
    init = ckpt.from_numpy_tree(_np_tree(jtr.params), _np_tree(jtr.state))
    batches = [_mb(8, s) for s in range(3)]
    jtr.train_epoch(iter(batches))
    ref = ckpt.from_numpy_tree(_np_tree(jtr.params), _np_tree(jtr.state))
    params = [k for k in ref if ".bn" not in k and not k.endswith(BIASES)]
    bn = [k for k in ref if ".bn" in k]

    def dist(dtype):
        cfg = default_config(**kw, pallas_train_dtype=dtype)
        flow = NoiseFlow((32, 32, 4), cfg, device="cpu")
        flow.load_state_dict(init)
        tr = Trainer(flow, cfg)
        assert tr.use_oneshot == oneshot
        tr.train_epoch(iter(batches))
        got = tr.flow.state_dict()
        num = sum(float(((got[k] - ref[k]) ** 2).sum()) for k in params)
        den = sum(float(((ref[k] - init[k]) ** 2).sum()) for k in params)
        per = {k: _rel(got[k] - init[k], ref[k] - init[k]) for k in params}
        worst = max(per, key=per.get)
        e_bn = max(float((got[k] - ref[k]).abs().max()) for k in bn)
        return float(np.sqrt(num / den)), e_bn, f"worst leaf {worst} {per[worst]:.3e}", tr

    port, f32 = dist("bfloat16"), dist("float32")
    print(f"trainer ({'one-shot' if oneshot else 'segment'}) (moves normwise, BN state abs): "
          f"port {port[:3]}; float32 {f32[:3]}")
    assert port[0] <= TRAJ_RTOL and port[1] <= TRAJ_BN_ATOL
    assert f32[0] > TRAJ_RTOL
    tr = port[3]
    used = tr._step_for_batch(8) if oneshot else tr._fused_for_batch(8)
    assert used.mm_dtype == "bfloat16" == tr._fused_for_batch(8).mm_dtype


def _mb(b, seed):
    x, cond = _batch(b, seed=100 + seed)
    return {"_x": x, "_y": cond["clean"], "nlf0": cond["nlf0"], "nlf1": cond["nlf1"],
            "iso": cond["iso"], "cam": cond["cam"]}
