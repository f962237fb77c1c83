"""DnCNN denoiser.

Port of noise_flow_tpu.models.dncnn (ref:train_dncnn_noiseflow.py:77-105):
depth-9, 32 filters, 4 input channels, conv3x3 with orthogonal init, interior
layers conv (no bias) + BatchNorm (momentum 0.0, eps 1e-4) + relu, a final
conv (no bias) predicting the noise, and the residual head
``output = input - noise``.

Parameters keep the JAX trees' layout and names, so ``state_dict`` keys are
the JAX key paths: ``convs.i`` (HWIO), ``biases.first``, ``bn_scale.i``,
``bn_bias.i``, and the buffers ``bn.i.mean`` / ``bn.i.var``. BatchNorm with
Keras momentum 0.0 means a train-mode forward REPLACES the running
statistics with the batch's biased moments; ``forward`` returns them and
changes no buffer (``apply_state`` writes them). The convolutions are plain
PyTorch convolutions, as the JAX model leaves them to XLA.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from noise_flow_tpu_torch.ops.nn import Psum, batch_moments, conv2d_nhwc
from noise_flow_tpu_torch.utils.device import resolve_device

BN_EPS = 1e-4


def _orthogonal_conv(rng: np.random.Generator, kh: int, kw: int, cin: int,
                     cout: int) -> np.ndarray:
    """Orthogonal init over the flattened (kh*kw*cin, cout) matrix (Keras
    'Orthogonal', ref:train_dncnn_noiseflow.py:81-82), as
    ``jax.nn.initializers.orthogonal``: Q of a normal matrix's QR with the
    signs of R's diagonal, from a numpy generator."""
    rows, cols = kh * kw * cin, cout
    a = rng.standard_normal((max(rows, cols), min(rows, cols)))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if rows < cols:
        q = q.T
    return q.reshape(kh, kw, cin, cout).astype(np.float32)


class _BNState(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))


def _param(a) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(np.asarray(a, np.float32)))


class DnCNN(nn.Module):
    """NHWC in, NHWC out. ``compute_dtype=torch.bfloat16`` runs the convs on
    bf16 operands with the result cast back to float32 (JAX's ``_conv``);
    BatchNorm, the residual head and the parameters stay float32."""

    def __init__(self, depth: int = 9, filters: int = 32, channels: int = 4,
                 use_bnorm: bool = True, seed: int = 0, device="cuda",
                 compute_dtype: Optional[torch.dtype] = None):
        super().__init__()
        dev = resolve_device(device)
        self.compute_dtype = compute_dtype
        rng = np.random.default_rng(seed)
        shapes = ([(channels, filters)] + [(filters, filters)] * (depth - 2)
                  + [(filters, channels)])
        self.convs = nn.ParameterList(
            [_param(_orthogonal_conv(rng, 3, 3, ci, co)) for ci, co in shapes])
        self.biases = nn.ParameterDict({"first": _param(np.zeros(filters))})
        n_bn = depth - 2 if use_bnorm else 0
        self.bn_scale = nn.ParameterList([_param(np.ones(filters)) for _ in range(n_bn)])
        self.bn_bias = nn.ParameterList([_param(np.zeros(filters)) for _ in range(n_bn)])
        self.bn = nn.ModuleList([_BNState(filters) for _ in range(n_bn)])
        self.to(dev)

    def _conv(self, x, w):
        if self.compute_dtype is None:
            return conv2d_nhwc(x, w)
        dt = self.compute_dtype
        return conv2d_nhwc(x.to(dt), w.to(dt)).to(torch.float32)

    def forward(self, x, train: bool,
                psum: Psum = None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Returns (denoised, new_state): in train mode the batch moments of
        each BN (over every rank's rows with ``psum``, the sum over the
        data-parallel ranks), keyed as the buffers (``bn.i.mean``,
        ``bn.i.var``); in eval mode the current buffers."""
        h = torch.relu(self._conv(x, self.convs[0]) + self.biases["first"])
        new_state = {}
        for i in range(len(self.convs) - 2):
            h = self._conv(h, self.convs[i + 1])
            if len(self.bn):
                if train:
                    m, v = batch_moments(h, (0, 1, 2), psum)
                else:
                    m, v = self.bn[i].mean, self.bn[i].var
                new_state[f"bn.{i}.mean"], new_state[f"bn.{i}.var"] = m, v
                h = (h - m) * torch.rsqrt(v + BN_EPS)
                h = h * self.bn_scale[i] + self.bn_bias[i]
            h = torch.relu(h)
        noise = self._conv(h, self.convs[-1])
        return x - noise, new_state

    @torch.no_grad()
    def apply_state(self, new_state: Dict[str, torch.Tensor]) -> None:
        bufs = dict(self.named_buffers())
        for k, v in new_state.items():
            bufs[k].copy_(v)

    def num_params(self) -> int:
        return int(sum(p.numel() for p in self.parameters()))
