"""Adam as one hand-written CUDA launch a step (``csrc/adam.cu``).

``Adam`` is a ``torch.optim.Optimizer`` with ``torch.optim.Adam``'s state
layout, which the checkpoints (``utils.checkpoint``), the mesh's
``replicate``, ``StepGraph``'s warm-up snapshot and the benchmark read: per
parameter ``step``, ``exp_avg`` and ``exp_avg_sq``, made at its first
``step()`` (``step`` a float32 scalar on the parameter's device when
``capturable``, on the host otherwise), and ``defaults["capturable"]``.

For CUDA tensors ``step()`` launches the kernel, one launch for up to
``MAX_TENSORS`` tensors, or raises: nothing falls back. Its arithmetic is
torch's capturable multi-tensor Adam (``csrc/adam.cu`` lists it op by op),
the step count incremented and the bias corrections computed on the card,
so a CUDA graph can capture the step. The tensors' addresses are read at
every call and travel in the launch's parameters: an eager step sees a
slot that a reloaded checkpoint rebound; a graph captured before that does
not (its owner drops it, as ``StepGraph`` says). Launches count as
``adam_step`` in ``fused_sample.launch_counts`` (at each replay under a
graph).

For CPU tensors it takes ``adam_reference``, torch's Adam arithmetic
(non-capturable, the host step count), which the CPU tests hold against
``torch.optim.Adam`` bit for bit and against optax.

Weight decay, amsgrad and maximize are not implemented: asking for one
raises, as does a tensor that is not float32 or not contiguous, or a group
whose tensors lie on more than one device.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch

from noise_flow_tpu_torch.ops.fused_sample import count_launches

# tensors a launch (csrc/adam.cu: MAX_TENSORS), by whether the CUDA toolkit
# that built the kernel takes 32,764 bytes of launch parameters (12.1 and
# later, on sm_90) or 4,096
MAX_TENSORS = {True: 128, False: 92}
SLOTS = ("step", "exp_avg", "exp_avg_sq")


def param_bytes(tensors: int) -> int:
    """Bytes of one launch's parameters (``AdamArgs``) at an even number of
    ``tensors`` a launch: five pointers and a size a tensor, then the count
    and six floats, padded to the pointers' 8 bytes."""
    return 44 * tensors + 32


def launch_plan(n_tensors: int, per_launch: int) -> List[int]:
    """The tensors of each launch for a list of ``n_tensors``: as few
    launches as hold them, in order, each full but the last."""
    full, rest = divmod(n_tensors, per_launch)
    return [per_launch] * full + ([rest] if rest else [])


def limits():
    """(tensors a launch, bytes of a launch's parameters) of the built
    library."""
    from noise_flow_tpu_torch.ops._build import load_library

    tensors, nbytes = ctypes.c_int(0), ctypes.c_int(0)
    load_library("adam").nf_adam_limits(ctypes.byref(tensors), ctypes.byref(nbytes))
    return tensors.value, nbytes.value


def adam_reference(params: Sequence[torch.Tensor], grads, exp_avgs, exp_avg_sqs, steps, *,
                   lr: float, beta1: float, beta2: float, eps: float) -> None:
    """One Adam step in place, in plain PyTorch: torch.optim.Adam's
    single-tensor arithmetic with the step count on the host
    (``_single_tensor_adam``, capturable=False)."""
    for p, g, m, v, s in zip(params, grads, exp_avgs, exp_avg_sqs, steps):
        s += 1
        t = s.item()
        m.lerp_(g, 1 - beta1)
        v.mul_(beta2).addcmul_(g, g, value=1 - beta2)
        step_size = lr / (1 - beta1 ** t)
        denom = (v.sqrt() / (1 - beta2 ** t) ** 0.5).add_(eps)
        p.addcdiv_(m, denom, value=-step_size)


def adam_step_cuda(params: Sequence[torch.Tensor], grads, exp_avgs, exp_avg_sqs, steps, *,
                   lr: float, beta1: float, beta2: float, eps: float) -> int:
    """One Adam step in place on the card through ``csrc/adam.cu``; returns
    the kernel launches issued. The tensors are checked by the caller
    (``Adam.step``)."""
    from noise_flow_tpu_torch.ops._build import load_library

    n = len(params)
    if n == 0:
        return 0
    dev = params[0].device

    def ptrs(ts):
        return (ctypes.c_void_p * n)(*[t.data_ptr() for t in ts])

    sizes = (ctypes.c_int * n)(*[p.numel() for p in params])
    launched = ctypes.c_int(0)
    with torch.cuda.device(dev):
        err = load_library("adam").nf_adam_step(
            ptrs(params), ptrs(grads), ptrs(exp_avgs), ptrs(exp_avg_sqs), ptrs(steps), sizes,
            n, 1.0 / lr, beta1, beta2, 1 - beta1, 1 - beta2, eps,
            torch.cuda.current_stream(dev).cuda_stream, ctypes.byref(launched))
        count_launches("adam_step", launched.value)
    if err != 0:
        raise RuntimeError(f"adam_step kernel launch failed: CUDA error {err}")
    return launched.value


def _check_group(group) -> None:
    for name in ("weight_decay", "amsgrad", "maximize"):
        if group.get(name):
            raise ValueError(f"Adam: {name}={group[name]!r} is not implemented")


def _check_tensors(params, grads, slots, capturable: bool) -> None:
    devices = {t.device for t in params}
    devices |= {t.device for t in grads}
    devices |= {t.device for st in slots for k, t in st.items() if k != "step" or capturable}
    if len(devices) != 1:
        raise ValueError(f"Adam: the group's tensors lie on more than one device: "
                         f"{sorted(map(str, devices))}")
    (dev,) = devices
    if capturable != (dev.type == "cuda"):
        raise ValueError(f"Adam: capturable={capturable} for tensors on {dev}: the kernel "
                         "steps CUDA tensors with their step count on the card (capturable); "
                         "CPU tensors take the plain version with a host step count")
    for p, g, st in zip(params, grads, slots):
        for what, t in (("parameter", p), ("gradient", g), ("exp_avg", st["exp_avg"]),
                        ("exp_avg_sq", st["exp_avg_sq"])):
            if t.dtype != torch.float32 or t.layout != torch.strided:
                raise ValueError(f"Adam: a {what} of {t.dtype} ({t.layout}); only dense "
                                 "float32 tensors")
            if not t.is_contiguous():
                raise ValueError(f"Adam: a {what} that is not contiguous")
            if t.shape != p.shape:
                raise ValueError(f"Adam: a {what} of shape {tuple(t.shape)} for a parameter "
                                 f"of {tuple(p.shape)}")
        s = st["step"]
        if s.dtype != torch.float32 or s.numel() != 1:
            raise ValueError(f"Adam: a step count of {s.dtype} and {s.numel()} elements; "
                             "a float32 scalar")


class Adam(torch.optim.Optimizer):
    """Adam (Kingma and Ba) over float32 tensors, with torch.optim.Adam's
    arguments, defaults and state: one kernel launch a step for CUDA
    tensors (``capturable=True``: the step count on the card), the plain
    version for CPU tensors. ``weight_decay``, ``amsgrad`` and ``maximize``
    are accepted only at their defaults."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 0.0, amsgrad: bool = False, *, maximize: bool = False,
                 capturable: bool = False):
        if not 0.0 <= lr:
            raise ValueError(f"Invalid learning rate: {lr}")
        if not 0.0 <= eps:
            raise ValueError(f"Invalid epsilon value: {eps}")
        for i, b in enumerate(betas):
            if not 0.0 <= b < 1.0:
                raise ValueError(f"Invalid beta parameter at index {i}: {b}")
        defaults = dict(lr=lr, betas=tuple(betas), eps=eps, weight_decay=weight_decay,
                        amsgrad=amsgrad, maximize=maximize, capturable=capturable)
        _check_group(defaults)
        super().__init__(params, defaults)

    def _init_state(self, p, capturable: bool):
        state = self.state[p]
        if not state:
            state["step"] = (torch.zeros((), dtype=torch.float32, device=p.device) if capturable
                             else torch.tensor(0.0, dtype=torch.float32))
            state["exp_avg"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["exp_avg_sq"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return state

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            _check_group(group)
            capturable = group["capturable"]
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            grads = [p.grad for p in params]
            slots = [self._init_state(p, capturable) for p in params]
            _check_tensors(params, grads, slots, capturable)
            beta1, beta2 = group["betas"]
            args = ([st["exp_avg"] for st in slots], [st["exp_avg_sq"] for st in slots],
                    [st["step"] for st in slots])
            hyper = dict(lr=group["lr"], beta1=beta1, beta2=beta2, eps=group["eps"])
            if params[0].device.type == "cuda":
                adam_step_cuda(params, grads, *args, **hyper)
            else:
                adam_reference(params, grads, *args, **hyper)
        return loss
