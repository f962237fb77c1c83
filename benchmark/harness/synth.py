"""SIDD-shaped synthetic patches made on the card from a seed.

A frozen copy, in torch on the device, of the port's synthetic stand-in for
SIDD (``data/synthetic.py``): a piecewise-smooth clean image in [0.02,
0.98] with the channel gains (1, 0.8, 0.8, 0.6) of raw RGGB, and noise that
follows the heteroscedastic camera model n ~ N(0, beta1 * clean + beta2).
Each patch draws its own pattern (two spatial frequencies and a phase) and
its own camera and ISO, a row of the traffic's noise-level table (the
``cam_iso_nlf.txt`` of the published model: each row a camera, an ISO and
its NLF (beta1, beta2)). Every seed makes patches of the same sizes; only
their values change.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

H = W = 32
C = 4
CAMERAS = ("IP", "GP", "S6", "N6", "G4")   # the flow's camera index
CHANNEL_GAIN = (1.0, 0.8, 0.8, 0.6)
CHUNK = 32768                              # patches a generator call


def parse_rows(rows: Sequence[Sequence]) -> List[Dict[str, float]]:
    """Rows ``["S6_00100", beta1, beta2]`` -> {cam, iso, nlf0, nlf1}."""
    out = []
    for name, b1, b2 in rows:
        cam, iso = name.split("_")
        out.append({"cam": float(CAMERAS.index(cam)), "iso": float(int(iso)),
                    "nlf0": float(b1), "nlf1": float(b2)})
    return out


def _table(rows, key, device):
    return torch.tensor([r[key] for r in rows], dtype=torch.float32, device=device)


def clean_patches(n: int, gen: torch.Generator, device, clean_cfg: Dict) -> torch.Tensor:
    """n clean patches [n, 32, 32, 4]: 0.5 + 0.4 sin(2 pi (fx x + fy y) +
    phase) times each channel's gain, clipped to [lo, hi]."""
    lo, hi = clean_cfg["clip"]
    fmin, fmax = clean_cfg["freq"]
    f = fmin + (fmax - fmin) * torch.rand((n, 2, 1, 1), generator=gen, device=device)
    phase = 2 * math.pi * torch.rand((n, 1, 1), generator=gen, device=device)
    grid = torch.linspace(0.0, 1.0, H, device=device)
    arg = 2 * math.pi * (f[:, 0] * grid[None, None, :] + f[:, 1] * grid[None, :, None]) + phase
    base = 0.5 + 0.4 * torch.sin(arg)
    gain = torch.tensor(CHANNEL_GAIN, device=device)
    return torch.clamp(base[..., None] * gain, lo, hi)


def make_split(n: int, rows, clean_cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The staged train split as the trainer keeps it: ``_x`` the noise and
    ``_y`` the clean patches [n, 32, 32, 4], and each patch's ``nlf0``,
    ``nlf1``, ``iso`` and ``cam`` [n], float32 on ``device``, made in
    chunks of ``CHUNK`` patches."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    out = {k: torch.empty((n, H, W, C), device=device) for k in ("_x", "_y")}
    row = torch.randint(len(rows), (n,), generator=gen, device=device)
    for k in ("nlf0", "nlf1", "iso", "cam"):
        out[k] = _table(rows, k, device)[row]
    for s in range(0, n, CHUNK):
        e = min(n, s + CHUNK)
        clean = clean_patches(e - s, gen, device, clean_cfg)
        sd = torch.sqrt(out["nlf0"][s:e, None, None, None] * clean
                        + out["nlf1"][s:e, None, None, None])
        out["_y"][s:e] = clean
        out["_x"][s:e] = torch.randn(clean.shape, generator=gen, device=device) * sd
    return out


def make_cond(n: int, row: Dict[str, float], clean_cfg: Dict, gen: torch.Generator,
              device) -> Dict[str, torch.Tensor]:
    """A sampler's conditioning: n clean patches and one camera, ISO and NLF
    for all of them."""
    full = lambda v: torch.full((n,), v, dtype=torch.float32, device=device)  # noqa: E731
    return {"clean": clean_patches(n, gen, device, clean_cfg).contiguous(),
            "nlf0": full(row["nlf0"]), "nlf1": full(row["nlf1"]),
            "iso": full(row["iso"]), "cam": full(row["cam"])}
