"""PSNR / SSIM image quality metrics.

A copy of noise_flow_tpu.utils.image_metrics, which imports no JAX; the
port keeps its own.

Re-implementation of the metrics used by ref:test_dncnn_noiseflow.py:49-82:
PSNR on [0,1] data (10*log10(1/mse)) and SSIM with gaussian weights,
sigma 1.5, no sample covariance (the skimage `compare_ssim(gaussian_weights=
True, use_sample_covariance=False)` configuration == Wang et al. 2004).
"""

from __future__ import annotations

import numpy as np


def psnr(ref: np.ndarray, test: np.ndarray, data_range: float = 1.0) -> float:
    """(ref:test_dncnn_noiseflow.py:49-53)"""
    mse = float(np.mean(np.square(ref.astype(np.float64) -
                                  test.astype(np.float64))))
    if mse == 0:
        return float("inf")
    return 10.0 * np.log10(data_range ** 2 / mse)


def _gaussian_window(sigma: float = 1.5, truncate: float = 3.5) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)  # skimage default -> 11x11 window
    x = np.arange(-radius, radius + 1)
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filt(img: np.ndarray, g: np.ndarray) -> np.ndarray:
    from scipy.ndimage import correlate1d
    out = correlate1d(img, g, axis=0, mode="reflect")
    return correlate1d(out, g, axis=1, mode="reflect")


def ssim(ref: np.ndarray, test: np.ndarray, data_range: float = 1.0,
         sigma: float = 1.5, k1: float = 0.01, k2: float = 0.03) -> float:
    """Mean SSIM over a 2-D image (gaussian weights, population covariance)."""
    x = ref.astype(np.float64)
    y = test.astype(np.float64)
    if x.ndim != 2:
        # average SSIM over trailing channels
        return float(np.mean([ssim(x[..., c], y[..., c], data_range, sigma,
                                   k1, k2) for c in range(x.shape[-1])]))
    g = _gaussian_window(sigma)
    mu_x = _filt(x, g)
    mu_y = _filt(y, g)
    mu_xx = _filt(x * x, g)
    mu_yy = _filt(y * y, g)
    mu_xy = _filt(x * y, g)
    # use_sample_covariance=False -> population normalization (cov_norm = 1)
    vx = mu_xx - mu_x * mu_x
    vy = mu_yy - mu_y * mu_y
    cxy = mu_xy - mu_x * mu_y
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    num = (2 * mu_x * mu_y + c1) * (2 * cxy + c2)
    den = (mu_x ** 2 + mu_y ** 2 + c1) * (vx + vy + c2)
    s = num / den
    # crop the filter radius like skimage (avoid edge effects)
    pad = (len(g) - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())


def mean_psnr_blocks(ref_mat: np.ndarray, res_mat: np.ndarray):
    """[n_im, n_blk, h, w] block matrices -> (mean, per-block array)
    (ref:test_dncnn_noiseflow.py:56-67)."""
    n_im, n_blk = ref_mat.shape[:2]
    psnrs = np.zeros((n_im, n_blk))
    for i in range(n_im):
        for b in range(n_blk):
            psnrs[i, b] = psnr(ref_mat[i, b], res_mat[i, b])
    return float(psnrs.mean()), psnrs


def mean_ssim_blocks(ref_mat: np.ndarray, res_mat: np.ndarray) -> float:
    """(ref:test_dncnn_noiseflow.py:70-82)"""
    n_im, n_blk = ref_mat.shape[:2]
    vals = [ssim(ref_mat[i, b], res_mat[i, b])
            for i in range(n_im) for b in range(n_blk)]
    return float(np.mean(vals))
