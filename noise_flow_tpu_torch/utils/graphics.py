"""Raster/grid image dumps for qualitative inspection.

Re-design of ref:borealisflows/graphics.py:14-88: save a batch of patches as
one tiled raster image (optionally rescaled to full range), used for visual
sampling diagnostics.

A copy of noise_flow_tpu.utils.graphics, which imports no JAX.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np


def to_raster(x: np.ndarray, rescale: bool = False,
              width: Optional[int] = None) -> np.ndarray:
    """[B, H, W, C] -> one [rows*H, cols*W, C] tiled grid (uint8)."""
    x = np.asarray(x, np.float32)
    b, h, w, c = x.shape
    cols = width or int(math.ceil(math.sqrt(b)))
    rows = int(math.ceil(b / cols))
    pad = rows * cols - b
    if pad:
        x = np.concatenate([x, np.zeros((pad, h, w, c), x.dtype)])
    grid = x.reshape(rows, cols, h, w, c).transpose(0, 2, 1, 3, 4)
    grid = grid.reshape(rows * h, cols * w, c)
    if rescale:
        lo, hi = grid.min(), grid.max()
        grid = (grid - lo) / (hi - lo + 1e-12)
    return np.clip(grid * 255.0, 0, 255).astype(np.uint8)


def save_image(x: np.ndarray, path: str) -> None:
    """Save one [H, W, C] image in [0,1] (ref:graphics.py:14-19)."""
    from PIL import Image

    arr = np.clip(np.asarray(x, np.float32) * 255.0, 0, 255).astype(np.uint8)
    if arr.shape[-1] == 1:
        arr = arr[..., 0]
    elif arr.shape[-1] == 4:
        # packed raw: show the RGGB planes side by side
        arr = np.concatenate([arr[..., i] for i in range(4)], axis=1)
    Image.fromarray(arr).save(path)


def save_raster(x: np.ndarray, path: str, rescale: bool = False,
                width: Optional[int] = None) -> None:
    """Save a patch batch as a tiled grid (ref:graphics.py:22-31)."""
    grid = to_raster(x, rescale=rescale, width=width)
    save_image(grid.astype(np.float32) / 255.0, path)
