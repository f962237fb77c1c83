"""The sampler's standard normals, worked out again: Philox-4x32-10 bits
(Salmon et al., SC '11) through the Box-Muller transform, in plain PyTorch on
int64 tensors (CPU or card) and float64.

The stream, as the sampler states it: the key is (seed mod (2**31 - 1), 0);
the counter of pixel (h, w), h < 16, of patch p is (32 h + w, p, j, 0) for
j in {0, 1}; word c of the j = 0 draw is bits1 and of the j = 1 draw bits2
for channel c. u1 = (bits1 >> 8) 2**-24 + 2**-25, u2 = (bits2 >> 8) 2**-24,
r = sqrt(-2 log u1), th = 2 pi u2: row h takes r cos th, row h + 16 takes
r sin th.
"""

from __future__ import annotations

import math

import torch

SEED_MOD = 2 ** 31 - 1
_MASK = 0xFFFFFFFF
_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
H = W = 32
C = 4


def _mul32(a, m: int):
    """(high, low) 32-bit words of a * m for int64 tensors of 32-bit values:
    m is split into 16-bit halves so that no product leaves int64."""
    lo_part = a * (m & 0xFFFF)
    hi_part = a * (m >> 16)
    full_lo = (((hi_part & 0xFFFF) << 16) + lo_part) & _MASK
    full_hi = (hi_part + (lo_part >> 16)) >> 16
    return full_hi, full_lo


def philox(counter, key):
    """Philox-4x32-10: counter [..., 4], key [2] as int64 words -> [..., 4]."""
    c0, c1, c2, c3 = counter.unbind(-1)
    k0, k1 = int(key[0]), int(key[1])
    for _ in range(10):
        hi0, lo0 = _mul32(c0, _M0)
        hi1, lo1 = _mul32(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
    return torch.stack([c0, c1, c2, c3], -1)


def normals(seed: int, batch: int, device="cpu") -> torch.Tensor:
    """The standard normals [batch, 32, 32, 4] (float64) of ``seed``."""
    i64 = dict(dtype=torch.int64, device=device)
    h = torch.arange(H // 2, **i64)[:, None]
    w = torch.arange(W, **i64)[None, :]
    hw = (32 * h + w).reshape(1, -1)                                 # [1, 512]
    patch = torch.arange(batch, **i64)[:, None]                      # [B, 1]
    words = []
    for j in (0, 1):
        ctr = torch.stack(torch.broadcast_tensors(hw, patch, torch.full_like(hw, j),
                                                  torch.zeros_like(hw)), -1)
        words.append(philox(ctr, (int(seed) % SEED_MOD, 0)))        # [B, 512, 4]
    u1 = (words[0] >> 8).to(torch.float64) * 2.0 ** -24 + 2.0 ** -25
    u2 = (words[1] >> 8).to(torch.float64) * 2.0 ** -24
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = 2.0 * math.pi * u2
    top = (r * torch.cos(th)).reshape(batch, H // 2, W, C)
    bottom = (r * torch.sin(th)).reshape(batch, H // 2, W, C)
    return torch.cat([top, bottom], 1)
