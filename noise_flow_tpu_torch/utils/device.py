"""Device selection for the port's entry points, and constants kept on a
device."""

from __future__ import annotations

from typing import Dict

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if a CUDA device is asked for
    and none is present, rather than running on the CPU.

    On the card, float32 matmuls and cuDNN convolutions are pinned to full
    float32 (no TF32), matching the JAX reference's ``Precision.HIGHEST``.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


_constants: Dict[tuple, torch.Tensor] = {}


def device_constant(key, device, make) -> torch.Tensor:
    """``make()`` (an array) as a tensor on ``device``, made at the first
    call for ``(key, device)`` and kept. ``torch.tensor(values,
    device=...)`` copies from the host at every call, which a CUDA graph
    cannot capture; a kept constant is read in place. Never write to it."""
    dev = torch.device(device)
    t = _constants.get((key, dev))
    if t is None:
        t = _constants[(key, dev)] = torch.as_tensor(make(), device=dev)
    return t
