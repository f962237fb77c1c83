"""Plain reference of the published Noise Flow (S-Ax4-G-Ax4-CAM) for the
benchmark's correctness check.

Written from the paper's equations and the published reference code
(Abdelhamed, Brubaker and Brown, "Noise Flow: Noise Modeling with
Conditional Normalizing Flows", ICCV 2019; ``borealisflows``), in plain
PyTorch, and importing nothing of the program under test. It reads the
checkpoint file itself (an ``.npz`` whose keys are
``params|['layers']/[0]/[2]/['nn']/['l1_w']``), names each leaf as the
program does (``layers.2.nn.l1_w``) so that the two can be compared leaf by
leaf, and computes in the dtype it is given (float64 for the reference).

The flow over [B, 32, 32, 4] raw-noise patches, in the NLL (data -> latent)
direction, layer by layer in arch order:

- ``sdn5``: x / s with s = sqrt(beta1 * clean / gain + beta2), where
  beta1 = exp(beta1_p * exp(cam_p[0, cam])), beta2 = exp(beta2_p *
  exp(cam_p[1, cam])), gain = exp(gain_p[iso] * exp(cam_p[2, cam])) * iso;
  log-det -sum log s over (H, W, C);
- ``gain4``: x / gain_val, log-det -H W C log gain_val;
- an invertible 1x1 conv (``Conv2d_1x1``): x @ A, A = P L U from its LU
  parameters, log-det H W sum(log_s);
- an affine coupling (``unc``): the first two channels pass; a network of
  them, conv3x3 (2 -> width) -> BatchNorm -> relu -> conv1x1 -> BatchNorm
  -> relu -> zero-conv3x3 over the zero-padded map with a border-indicator
  channel, scaled by exp(3 logs), gives shift and log-scale; the last two
  channels become x * exp(ls) + shift with ls = rescale * tanh(log-scale);
  log-det sum ls.

The NLL of a patch is -(sum of log-dets + log N(z; 0, I)), the loss its mean
over the batch. BatchNorm (eps 1e-4) normalises with the biased moments of
the whole batch (``exact``), of each group of ``bt`` consecutive patches
(``ghost``), or with the running statistics (``running``); train-mode BN's
new running statistics are s - 0.1 (s - batch moment), the group moments
averaged over the groups under ghost BN.

Sampling runs the layers in reverse order, each inverted, with running BN.

``products``: where the reference computes a convolution or a channel mix,
its operands go through ``products`` first, in the forward pass and in
both gradients of the backward pass. ``None`` leaves them as they are;
``tf32_round`` makes the precision control (float32 with TF32 products).
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

BN_EPS = 1e-4
BN_DECAY = 0.1
LOGSCALE_FACTOR = 3.0
ISO_VALS = (100.0, 400.0, 800.0, 1600.0, 3200.0)
CAM_VALS = (0.0, 1.0, 2.0, 3.0, 4.0)   # IP GP S6 N6 G4
H = W = 32
C = 4
_LOG_2PI = math.log(2.0 * math.pi)
_TOKEN = re.compile(r"\['([^']*)'\]|\[(\d+)\]")


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """A float32 tensor rounded to TF32 (10 mantissa bits, nearest with ties
    away from zero), as a tensor-core product takes its operands."""
    if t.dtype != torch.float32:
        raise ValueError(f"tf32_round takes float32, got {t.dtype}")
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def read_checkpoint(path) -> Tuple[Dict[str, np.ndarray], Dict[str, np.ndarray]]:
    """(params, state) of an npz checkpoint, keyed ``layers.2.nn.l1_w``,
    ``shared.sdn_gain.beta1``, ``layers.1.frozen.p``."""
    params, state = {}, {}
    with np.load(path) as z:
        for key in z.files:
            group, _, tree = key.partition("|")
            if group not in ("params", "state"):
                continue
            parts = [a if a else b for a, b in _TOKEN.findall(tree)]
            if parts[:2] == ["layers", "0"]:
                parts = ["layers"] + parts[2:]
            (params if group == "params" else state)[".".join(parts)] = np.asarray(z[key])
    return params, state


def arch_layers(arch: str) -> List[Tuple[str, int]]:
    """(kind, layer index) in arch order: ``unc`` is a 1x1 conv then a
    coupling."""
    out: List[Tuple[str, int]] = []
    for tok in arch.split("|"):
        if tok == "unc":
            out += [("conv1x1", len(out)), ("coupling", len(out) + 1)]
        elif tok in ("sdn5", "gain4"):
            out.append((tok, len(out)))
        else:
            raise ValueError(f"the reference has no layer {tok!r}")
    return out


class _Conv(torch.autograd.Function):
    """conv2d (NCHW) of operands passed through ``rnd``, in both passes."""

    @staticmethod
    def forward(ctx, x, w, pad, rnd):
        xr, wr = rnd(x), rnd(w)
        ctx.save_for_backward(xr, wr)
        ctx.pad, ctx.rnd = pad, rnd
        return F.conv2d(xr, wr, padding=pad)

    @staticmethod
    def backward(ctx, g):
        xr, wr = ctx.saved_tensors
        gr = ctx.rnd(g.contiguous())
        return (conv2d_input(xr.shape, wr, gr, padding=ctx.pad),
                conv2d_weight(xr, wr.shape, gr, padding=ctx.pad), None, None)


class _Mix(torch.autograd.Function):
    """x @ a of operands passed through ``rnd``, in both passes."""

    @staticmethod
    def forward(ctx, x, a, rnd):
        xr, ar = rnd(x), rnd(a)
        ctx.save_for_backward(xr, ar)
        ctx.rnd = rnd
        return xr @ ar

    @staticmethod
    def backward(ctx, g):
        xr, ar = ctx.saved_tensors
        gr = ctx.rnd(g.contiguous())
        return (gr @ ar.T, xr.reshape(-1, xr.shape[-1]).T @ gr.reshape(-1, gr.shape[-1]),
                None)


def _sum_hwc(t):
    return t.sum(dim=(1, 2, 3))


class RefFlow:
    """The flow of ``arch`` (coupling width ``width``) with the checkpoint's
    weights, as float leaves of ``dtype`` on ``device``. ``params`` maps each
    trainable leaf's name to a tensor that requires grad; ``state`` holds the
    BatchNorm running statistics and the frozen LU factors."""

    def __init__(self, ckpt_path, arch: str, width: int, dtype=torch.float64,
                 device="cpu", products: Optional[Callable] = None):
        self.layers = arch_layers(arch)
        self.width = width
        self.dtype = dtype
        self.device = torch.device(device)
        self.rnd = products
        p_np, s_np = read_checkpoint(ckpt_path)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)  # noqa: E731
        self.params = {k: as_t(v).requires_grad_(True) for k, v in p_np.items()}
        self.state = {k: as_t(v) for k, v in s_np.items()}

    # ---------------------------------------------------------- products
    def _conv(self, x, w, pad):
        """NHWC x, HWIO w, stride 1, zero padding ``pad``."""
        xn, wn = x.permute(0, 3, 1, 2).contiguous(), w.permute(3, 2, 0, 1).contiguous()
        y = F.conv2d(xn, wn, padding=pad) if self.rnd is None else _Conv.apply(
            xn, wn, pad, self.rnd)
        return y.permute(0, 2, 3, 1)

    def _mix(self, x, a):
        return x @ a if self.rnd is None else _Mix.apply(x, a, self.rnd)

    # ------------------------------------------------------------ layers
    def mix_matrix(self, i: int):
        """(A, sum log_s) of the 1x1 conv at layer i, from P, L, U."""
        p = self.params
        log_s = p[f"layers.{i}.mat.log_s"]
        eye = torch.eye(C, dtype=self.dtype, device=self.device)
        lower = torch.zeros((C, C), dtype=self.dtype, device=self.device)
        upper = torch.zeros((C, C), dtype=self.dtype, device=self.device)
        li, lj = np.tril_indices(C, k=-1)
        ui, uj = np.triu_indices(C, k=1)
        idx = lambda a: torch.as_tensor(a, device=self.device)  # noqa: E731
        lower = lower.index_put((idx(li), idx(lj)), p[f"layers.{i}.mat.l_vec"]) + eye
        upper = upper.index_put((idx(ui), idx(uj)), p[f"layers.{i}.mat.u_vec"])
        upper = upper + torch.diag(self.state[f"layers.{i}.frozen.sign_s"] * torch.exp(log_s))
        return self.state[f"layers.{i}.frozen.p"] @ lower @ upper, log_s.sum()

    def sdn5_scale(self, cond):
        """The sdn5 layer's per-pixel scale [B, H, W, C]."""
        g = self.params
        cam = (cond["cam"][:, None] == torch.as_tensor(CAM_VALS, device=self.device)).to(
            self.dtype)
        iso = (cond["iso"][:, None] == torch.as_tensor(ISO_VALS, device=self.device)).to(
            self.dtype)
        one_cam = torch.exp(cam @ g["shared.sdn_gain.cam_params"].T)            # [B, 3]
        gain = torch.exp((iso * g["shared.sdn_gain.gain_params"]).sum(1) * one_cam[:, 2])
        gain = gain * cond["iso"].to(self.dtype)
        beta1 = torch.exp(g["shared.sdn_gain.beta1"] * one_cam[:, 0])
        beta2 = torch.exp(g["shared.sdn_gain.beta2"] * one_cam[:, 1])
        bb = lambda v: v.reshape(-1, 1, 1, 1)  # noqa: E731
        return torch.sqrt(bb(beta1) * cond["clean"].to(self.dtype) / bb(gain) + bb(beta2))

    def _bn(self, h, key: str, bn: str, bt: int):
        """Normalised h and the new running statistics of BN ``key``."""
        mean, var = self.state[f"{key}.mean"], self.state[f"{key}.var"]
        if bn == "running":
            return (h - mean) * torch.rsqrt(var + BN_EPS), {}
        b = h.shape[0]
        group = b if bn == "exact" else bt
        if b % group:
            raise ValueError(f"batch {b} is not a multiple of the BN group {group}")
        g = h.reshape(b // group, group * H * W, h.shape[-1])
        m = g.mean(dim=1, keepdim=True)
        v = ((g - m) ** 2).mean(dim=1, keepdim=True)
        out = ((g - m) * torch.rsqrt(v + BN_EPS)).reshape(h.shape)
        bm, bv = m.detach().mean(dim=(0, 1)), v.detach().mean(dim=(0, 1))
        return out, {f"{key}.mean": mean - BN_DECAY * (mean - bm),
                     f"{key}.var": var - BN_DECAY * (var - bv)}

    def coupling_net(self, i: int, x0, bn: str, bt: int):
        """(shift, ls, new BN state) of the coupling at layer i."""
        p = {k[len(f"layers.{i}.nn."):]: v for k, v in self.params.items()
             if k.startswith(f"layers.{i}.nn.")}
        new = {}
        h = self._conv(x0, p["l1_w"], 1) + p["l1_b"]
        h, st = self._bn(h, f"layers.{i}.nn.bn1", bn, bt)
        new.update(st)
        h = self._mix(torch.relu(h), p["l2_w"][0, 0]) + p["l2_b"]
        h, st = self._bn(h, f"layers.{i}.nn.bn2", bn, bt)
        new.update(st)
        h = torch.relu(h)
        ind = torch.zeros((H + 2, W + 2), dtype=self.dtype, device=self.device)
        ind[0], ind[-1], ind[:, 0], ind[:, -1] = 1.0, 1.0, 1.0, 1.0
        hp = torch.cat([F.pad(h, (0, 0, 1, 1, 1, 1)),
                        ind[None, :, :, None].expand(h.shape[0], H + 2, W + 2, 1)], -1)
        t = self._conv(hp, p["last.w"], 0) + p["last.b"]
        t = t * torch.exp(p["last.logs"] * LOGSCALE_FACTOR).reshape(1, 1, 1, -1)
        ls = self.params[f"layers.{i}.rescale"] * torch.tanh(t[..., 2:])
        return t[..., :2], ls, new

    # -------------------------------------------------------------- flow
    def nll(self, x, cond, bn: str = "exact", bt: int = 0):
        """(mean NLL, sd_z, new BN state) of noise patches x [B, 32, 32, 4]
        under cond {clean, iso, cam} with train-mode BN ``bn`` (exact or
        ghost over groups of ``bt``)."""
        z = x.to(self.dtype)
        obj = z.new_zeros((z.shape[0],))
        new_state = {}
        for kind, i in self.layers:
            if kind == "sdn5":
                s = self.sdn5_scale(cond)
                z, obj = z / s, obj - _sum_hwc(torch.log(s))
            elif kind == "gain4":
                g = self.params["shared.sdn_gain.gain_val"]
                z, obj = z / g, obj - H * W * C * torch.log(g).sum()
            elif kind == "conv1x1":
                a, logdet = self.mix_matrix(i)
                z, obj = self._mix(z, a), obj + H * W * logdet
            else:
                shift, ls, st = self.coupling_net(i, z[..., :2], bn, bt)
                z = torch.cat([z[..., :2], z[..., 2:] * torch.exp(ls) + shift], -1)
                obj = obj + _sum_hwc(ls)
                new_state.update(st)
        logp = -0.5 * (_LOG_2PI + z * z).sum(dim=(1, 2, 3))
        nll = -(obj + logp)
        sd_z = torch.sqrt(z.reshape(z.shape[0], -1).var(dim=1, unbiased=False)).mean()
        return nll.mean(), sd_z, new_state

    @torch.no_grad()
    def sample(self, z, cond):
        """Noise [B, 32, 32, 4] from latents z (normals times the
        temperature), running BN: the layers reversed, each inverted."""
        x = z.to(self.dtype)
        for kind, i in reversed(self.layers):
            if kind == "sdn5":
                x = x * self.sdn5_scale(cond)
            elif kind == "gain4":
                x = x * self.params["shared.sdn_gain.gain_val"]
            elif kind == "conv1x1":
                a, _ = self.mix_matrix(i)
                x = self._mix(x, torch.linalg.inv(a))
            else:
                shift, ls, _ = self.coupling_net(i, x[..., :2], "running", 0)
                x = torch.cat([x[..., :2], (x[..., 2:] - shift) * torch.exp(-ls)], -1)
        return x


def bn_input_bias(key: str) -> str:
    """The leaf of the bias added just before the BatchNorm whose running
    statistic is ``key`` (``layers.2.nn.bn1.mean`` -> ``layers.2.nn.l1_b``)."""
    head, bn, _ = key.rsplit(".", 2)
    return f"{head}.l{bn[len('bn'):]}_b"


def epoch_order(shuffle_seed: int, n: int, batch: int) -> np.ndarray:
    """[n // batch, batch]: the rows of each step of a staged epoch, a
    permutation of the n patches drawn from ``shuffle_seed`` by NumPy's
    default generator, the remainder dropped (JAX's ``_train_epoch_staged``
    of the published trainer's port)."""
    steps = n // batch
    return np.random.default_rng(shuffle_seed).permutation(n)[:steps * batch].reshape(steps, batch)


class Adam:
    """Adam (Kingma and Ba) with bias correction, as the flow is trained:
    beta1 0.9, beta2 0.999, eps 1e-8."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.betas, self.eps = params, lr, betas, eps
        self.t = 0
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> None:
        b1, b2 = self.betas
        self.t += 1
        c1, c2 = 1 - b1 ** self.t, 1 - b2 ** self.t
        for k, p in self.params.items():
            g = grads[k]
            self.m[k] = b1 * self.m[k] + (1 - b1) * g
            self.v[k] = b2 * self.v[k] + (1 - b2) * g * g
            p -= self.lr * (self.m[k] / c1) / (torch.sqrt(self.v[k] / c2) + self.eps)
