"""Percentile intensity normalization, host and device (port of
cellseg_tpu/pipeline/normalize.py).

Per channel: the 1st/99th percentile of the NONZERO pixels, then a linear
rescale of the whole channel into uint8 range with clipping, truncated
(not rounded) on the uint8 cast. All-zero channels stay zero; a
degenerate percentile range (<= 0.001) passes through unscaled.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..io.images import to_hwc3


def normalize_channel(img: np.ndarray, lower: float = 1,
                      upper: float = 99) -> np.ndarray:
    """Host single-channel percentile normalization -> uint8."""
    img = np.asarray(img)
    non_zero_vals = img[np.nonzero(img)]
    if non_zero_vals.size == 0:
        return img.astype(np.uint8)
    p_lo, p_hi = np.percentile(non_zero_vals, [lower, upper])
    if p_hi - p_lo > 0.001:
        clipped = np.clip(img.astype(np.float64), p_lo, p_hi)
        img_norm = (clipped - p_lo) / (p_hi - p_lo) * 255.0
    else:
        img_norm = img
    return img_norm.astype(np.uint8)


def normalize_image(img: np.ndarray, lower: float = 1,
                    upper: float = 99) -> np.ndarray:
    """Host whole-image normalization with the channel fixup (to_hwc3),
    skipping all-zero channels."""
    img = to_hwc3(img)
    out = np.zeros(img.shape, dtype=np.uint8)
    for i in range(3):
        ch = img[:, :, i]
        if np.count_nonzero(ch):
            out[:, :, i] = normalize_channel(ch, lower, upper)
    return out


def _percentile_from_hist(hist: torch.Tensor, n_nonzero: torch.Tensor,
                          q: float) -> torch.Tensor:
    """np.percentile(nonzero_vals, q) for integer data from its histogram.

    The k-th order statistic is the smallest value v with cumcount(v) > k;
    the rank q/100 * (n - 1) is split into an exact integer part and a
    float32 fraction, and the two neighbouring order statistics are
    interpolated in float32, as the JAX device path does."""
    fq = Fraction(q) / 100
    a, b = fq.numerator, fq.denominator
    cum = torch.cumsum(hist, 0)
    n1 = torch.clamp(n_nonzero - 1, min=0)
    lo_k = a * (n1 // b) + (a * (n1 % b)) // b
    frac = ((a * (n1 % b)) % b).to(torch.float32) / np.float32(b)

    def order_stat(k):
        return torch.argmax((cum >= k + 1).to(torch.int32)).to(torch.float32)

    lo_v = order_stat(lo_k)
    hi_v = torch.where(lo_k + 1 <= n1, order_stat(lo_k + 1), lo_v)
    return lo_v + frac * (hi_v - lo_v)


def _rescale(chf: torch.Tensor, p_lo: torch.Tensor, p_hi: torch.Tensor,
             n_nonzero: torch.Tensor) -> torch.Tensor:
    scaled = torch.minimum(torch.maximum(chf, p_lo), p_hi)
    scaled = (scaled - p_lo) / torch.clamp(p_hi - p_lo, min=1e-9) * 255.0
    # degenerate range: the host's astype(np.uint8) wraps mod 256
    passthrough = torch.remainder(torch.trunc(chf), 256.0)
    out = torch.where(p_hi - p_lo > 0.001,
                      torch.clamp(torch.floor(scaled), 0, 255), passthrough)
    return torch.where(n_nonzero > 0, out, torch.zeros_like(chf))


def _normalize_u8(ch: torch.Tensor, lower: float,
                  upper: float) -> torch.Tensor:
    """Exact order statistics from a 256-bin histogram of the channel."""
    n_nonzero = torch.count_nonzero(ch)
    hist = torch.bincount(ch.to(torch.int32), minlength=256)
    hist[0] = 0  # nonzero-only percentiles
    p_lo = _percentile_from_hist(hist, n_nonzero, lower)
    p_hi = _percentile_from_hist(hist, n_nonzero, upper)
    return _rescale(ch.to(torch.float32), p_lo, p_hi, n_nonzero)


def _normalize_sorted(ch: torch.Tensor, lower: float,
                      upper: float) -> torch.Tensor:
    """Any dtype: percentiles from a sort of the nonzero values (float32)."""
    chf = ch.to(torch.float32)
    n = chf.numel()
    n_nonzero = torch.count_nonzero(chf)
    s = torch.sort(torch.where(chf == 0, torch.inf, chf)).values

    def pct(q):
        pos = (q / 100.0) * (n_nonzero - 1).to(torch.float32)
        lo_idx = torch.clamp(torch.floor(pos).to(torch.int64), 0, n - 1)
        hi_idx = torch.clamp(lo_idx + 1, 0, n - 1)
        frac = pos - lo_idx.to(torch.float32)
        lo_v = s[lo_idx]
        hi_v = torch.where(hi_idx < n_nonzero, s[hi_idx], lo_v)
        return lo_v + frac * (hi_v - lo_v)

    return _rescale(chf, pct(lower), pct(upper), n_nonzero)


def normalize_image_torch(img: torch.Tensor, lower: float = 1.0,
                          upper: float = 99.0) -> torch.Tensor:
    """Device (H, W, C) percentile normalization -> uint8 (H, W, C).

    uint8 input takes its exact percentiles from a 256-bin bincount of
    the nonzero pixels; other dtypes sort. float32 arithmetic throughout,
    as cellseg_tpu's normalize_image_jax."""
    h, w, c = img.shape
    x = img.reshape(h * w, c)
    norm_one = _normalize_u8 if img.dtype == torch.uint8 else _normalize_sorted
    out = torch.stack([norm_one(x[:, i], lower, upper) for i in range(c)], 1)
    return out.reshape(h, w, c).to(torch.uint8)
