"""noise_flow_tpu_torch.ops.adam on the CPU: the plain version against
torch.optim.Adam bit for bit on the flow's 95 tensors, the state layout
that checkpoints, the mesh and the graphs' warm-up read, checkpoints moved
between the two optimizers, the inputs it refuses, and the kernel's launch
plan against csrc/adam.cu. The kernel itself runs on the card only
(tests/test_torch_kernels.py, -k adam)."""

import re

import pytest
import torch

from noise_flow_tpu_torch.config import default_config
from noise_flow_tpu_torch.models.flow import NoiseFlow
from noise_flow_tpu_torch.ops import _build
from noise_flow_tpu_torch.ops import adam as ad
from noise_flow_tpu_torch.training.trainer import make_optimizer
from noise_flow_tpu_torch.utils import checkpoint as ckpt

ARCH = "sdn5|unc|unc|unc|unc|gain4|unc|unc|unc|unc"


def _flow(seed=0):
    return NoiseFlow((32, 32, 4), default_config(arch=ARCH, width=4), device="cpu", seed=seed)


def _params(flow):
    return [p.detach().clone().requires_grad_(True) for p in flow.parameters()]


def _step_both(a, b, opt_a, opt_b, steps, seed=0):
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for x, y in zip(a, b):
            g = torch.randn(x.shape, generator=gen) * 10.0 ** float(torch.randint(-4, 2, (),
                                                                                  generator=gen))
            x.grad, y.grad = g.clone(), g.clone()
        opt_a.step()
        opt_b.step()


def _same_state(opt_a, a, opt_b, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)
        assert list(opt_a.state[x]) == list(opt_b.state[y]) == list(ad.SLOTS)
        for slot in ad.SLOTS:
            assert torch.equal(opt_a.state[x][slot], opt_b.state[y][slot]), slot


def test_flow_has_95_tensors():
    ps = list(_flow().parameters())
    assert (len(ps), sum(p.numel() for p in ps)) == (95, 2433)


@pytest.mark.parametrize("foreach", [True, False])
def test_plain_version_matches_torch_adam_bitwise(foreach):
    """5 steps on the flow's 95 tensors: parameters and every slot the same
    bits as torch.optim.Adam, multi-tensor and single-tensor."""
    flow = _flow()
    a, b = _params(flow), _params(flow)
    ref = torch.optim.Adam(a, lr=1e-4, betas=(0.9, 0.999), eps=1e-8, foreach=foreach)
    ours = ad.Adam(b, lr=1e-4, betas=(0.9, 0.999), eps=1e-8)
    _step_both(a, b, ref, ours, 5)
    _same_state(ref, a, ours, b)
    assert float(ours.state[b[0]]["step"]) == 5.0


@pytest.mark.parametrize("optim, cls", [("adam", ad.Adam), ("sgd", torch.optim.SGD)])
def test_make_optimizer_class(optim, cls):
    opt = make_optimizer(default_config(optim=optim, lr=1e-3), list(_flow().parameters()))
    assert type(opt) is cls
    if optim == "adam":
        assert opt.defaults["capturable"] is False     # CPU parameters
        assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
    else:
        assert opt.defaults["momentum"] == 0.9


def test_state_layout_made_at_first_step():
    """torch's layout: nothing before the first step; then per parameter
    step (a float32 host scalar off the card), exp_avg, exp_avg_sq; a
    parameter without a gradient gets none."""
    ps = _params(_flow())
    opt = ad.Adam(ps, lr=1e-3)
    assert not opt.state
    for p in ps[1:]:
        p.grad = torch.ones_like(p)
    opt.step()
    assert ps[0] not in opt.state
    for p in ps[1:]:
        st = opt.state[p]
        assert list(st) == ["step", "exp_avg", "exp_avg_sq"]
        assert st["step"].dtype == torch.float32 and st["step"].dim() == 0
        assert st["step"].device.type == "cpu" and float(st["step"]) == 1.0
        assert st["exp_avg"].shape == p.shape and st["exp_avg_sq"].shape == p.shape
    assert "capturable" in opt.defaults
    assert all(k in opt.state_dict()["param_groups"][0] for k in ("lr", "betas", "eps"))


@pytest.mark.parametrize("direction", ["torch_to_kernel", "kernel_to_torch"])
def test_checkpoint_moves_between_torch_adam_and_ours(tmp_path, direction):
    """A checkpoint written with one optimizer resumes into the other with
    every slot's bits, and both then take the same steps."""
    make = {"torch": lambda ps: torch.optim.Adam(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8),
            "kernel": lambda ps: ad.Adam(ps, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)}
    src, dst = direction.split("_to_")
    flow = _flow(1)
    opt = make[src](list(flow.parameters()))
    twin = _flow(1)
    twin_opt = make[src](list(twin.parameters()))
    _step_both(list(flow.parameters()), list(twin.parameters()), opt, twin_opt, 3, seed=3)
    path = ckpt.save_checkpoint(str(tmp_path), 3, flow, 3, opt)
    back = _flow(2)
    back_opt = make[dst](list(back.parameters()))
    assert ckpt.load_checkpoint(path, back, back_opt) == 3
    for p, q in zip(flow.parameters(), back.parameters()):
        assert torch.equal(p, q)
        assert list(back_opt.state[q]) == list(opt.state[p])
        for slot, v in opt.state[p].items():
            assert torch.equal(back_opt.state[q][slot], v), slot
    _step_both(list(twin.parameters()), list(back.parameters()), twin_opt, back_opt, 2, seed=4)
    _same_state(twin_opt, list(twin.parameters()), back_opt, list(back.parameters()))


def _refused(case):
    """An optimizer and parameters whose step (or construction) must raise."""
    p = torch.nn.Parameter(torch.randn(3, 4))
    if case in ("amsgrad", "weight_decay", "maximize"):
        kw = {"amsgrad": {"amsgrad": True}, "weight_decay": {"weight_decay": 0.1},
              "maximize": {"maximize": True}}[case]
        return lambda: ad.Adam([p], lr=1e-3, **kw)
    opt = ad.Adam([p], lr=1e-3)
    p.grad = torch.randn(3, 4)
    if case == "mixed_devices":
        opt.step()
        opt.state[p]["exp_avg"] = torch.zeros(3, 4, device="meta")
    elif case == "non_contiguous":
        p.grad = torch.randn(4, 3).t()
    elif case == "float64":
        q = torch.nn.Parameter(torch.randn(3, 4, dtype=torch.float64))
        q.grad = torch.randn(3, 4, dtype=torch.float64)
        opt = ad.Adam([q], lr=1e-3)
    elif case == "step_float64":
        opt.step()
        opt.state[p]["step"] = torch.tensor(1.0, dtype=torch.float64)
    elif case == "capturable_on_cpu":
        opt = ad.Adam([p], lr=1e-3, capturable=True)
    elif case == "group_amsgrad":
        opt.param_groups[0]["amsgrad"] = True
    return opt.step


@pytest.mark.parametrize("case", ["amsgrad", "weight_decay", "maximize", "mixed_devices",
                                  "non_contiguous", "float64", "step_float64",
                                  "capturable_on_cpu", "group_amsgrad"])
def test_refuses(case):
    with pytest.raises(ValueError):
        _refused(case)()


@pytest.mark.parametrize("n, per_launch, plan", [
    (95, 128, [95]),             # the flow: one launch with CUDA >= 12.1
    (95, 92, [92, 3]),           # a 4 KB parameter limit: two
    (300, 128, [128, 128, 44]),  # more than one launch's worth
    (256, 128, [128, 128]),
    (0, 128, []),
])
def test_launch_plan(n, per_launch, plan):
    assert ad.launch_plan(n, per_launch) == plan
    assert sum(plan) == n and all(0 < k <= per_launch for k in plan)


def test_launch_limits_match_the_source():
    """MAX_TENSORS and the parameter bytes of csrc/adam.cu against the
    Python mirror, both within their launch-parameter limits."""
    src = (_build.CSRC / "adam.cu").read_text()
    big, small = (int(v) for v in re.findall(r"constexpr int MAX_TENSORS = (\d+);", src))
    assert {True: big, False: small} == ad.MAX_TENSORS
    assert "sizeof(AdamArgs) == 44 * MAX_TENSORS + 32" in src
    assert big % 2 == 0 and small % 2 == 0
    assert ad.param_bytes(big) <= 32764 and ad.param_bytes(small) <= 4096
    assert ad.param_bytes(small + 2) > 4096
    assert set(_build.SIGNATURES["adam"]) == {"nf_adam_step", "nf_adam_limits"}
