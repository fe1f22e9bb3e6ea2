"""Rational-rate audio resampling: the counterpart of ``fvd_tpu/ops/resample.py``.

The JAX package resamples with one dilated convolution: zero-stuff by L,
correlate with a Kaiser-windowed sinc of ``2 * 16 * max(L, M) + 1`` taps,
keep every M-th sample.  At 44.1 kHz -> 16 kHz (L = 160, M = 441, 14 113 taps)
nearly every product is with a stuffed zero.  Here the same function is a
polyphase sum: output ``m = r + q * L`` (phase ``r``) only meets the taps
``r``'s alignment selects, about ``taps / L`` = 89 of them.  One strided view
of the input (rows ``q``, a window of ``M + J`` samples) times a bank of the
L phase filters, each placed at its phase's offset in the window, gives all
outputs in one matrix product.  The taps are the JAX package's float32 taps;
only the summation order differs.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _kaiser_beta(atten_db: float) -> float:
    if atten_db > 50:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21:
        return 0.5842 * (atten_db - 21) ** 0.4 + 0.07886 * (atten_db - 21)
    return 0.0


@lru_cache(maxsize=32)
def _design_lowpass(L: int, M: int, half_width: int = 16, atten_db: float = 80.0) -> np.ndarray:
    """Kaiser-windowed sinc low-pass at cutoff min(1/L, 1/M), gain L."""
    cutoff = 1.0 / max(L, M)  # in units of the upsampled Nyquist
    taps = 2 * half_width * max(L, M) + 1
    n = np.arange(taps) - (taps - 1) / 2
    h = cutoff * np.sinc(cutoff * n)
    beta = _kaiser_beta(atten_db)
    h *= np.kaiser(taps, beta)
    h = h / h.sum() * L  # DC gain L compensates the zero-stuffing
    return h.astype(np.float32)


@lru_cache(maxsize=32)
def _phase_bank(L: int, M: int) -> Tuple[np.ndarray, int]:
    """``(bank [M + J, L], first)``: output ``r + q * L`` is
    ``x[first + q * M + t] @ bank[t, r]`` over ``t``, with ``x`` read as 0
    outside ``[0, n)``.

    The JAX conv gives ``y[m] = sum_i x[i] * g[i * L - m * M + pad]`` with
    ``g`` the flipped taps and ``pad = (taps - 1) // 2``; for phase ``r`` the
    first ``i`` with a tap is ``ceil((r * M - pad) / L)``."""
    h = _design_lowpass(L, M)
    g = h[::-1]
    taps = len(h)
    pad = (taps - 1) // 2
    J = -(-taps // L)
    start = [-((pad - r * M) // L) for r in range(L)]  # ceil((r*M - pad) / L)
    first = start[0]
    width = start[-1] - first + J
    bank = np.zeros((width, L), np.float32)
    for r in range(L):
        k0 = start[r] * L - r * M + pad
        t = g[k0::L]
        bank[start[r] - first: start[r] - first + len(t), r] = t
    return bank, first


def _polyphase(xs: torch.Tensor, L: int, M: int) -> torch.Tensor:
    """[B, n] float32 -> [B, ceil(n * L / M)]."""
    bank_np, first = _phase_bank(L, M)
    bank = torch.from_numpy(bank_np).to(xs.device)
    B, n = xs.shape
    out_len = -(-n * L // M)
    Q = -(-out_len // L)
    width = bank.shape[0]
    left = -first
    right = max(0, first + (Q - 1) * M + width - n)
    xp = F.pad(xs, (left, right))
    rows = xp.as_strided((B, Q, width), (xp.stride(0), M, 1))
    y = torch.matmul(rows, bank)  # [B, Q, L]: row q, phase r -> output q * L + r
    return y.reshape(B, Q * L)[:, :out_len]


def _rates(orig_sr: int, target_sr: int) -> Tuple[int, int]:
    g = math.gcd(orig_sr, target_sr)
    return target_sr // g, orig_sr // g


def resample(x, orig_sr: int, target_sr: int, device=None) -> torch.Tensor:
    """Resample a 1-D signal from ``orig_sr`` to ``target_sr``: a float32
    tensor of length ``ceil(len(x) * target_sr / orig_sr)`` on ``device``
    (default ``x``'s own, or the CPU for a numpy array)."""
    x = torch.as_tensor(x, dtype=torch.float32, device=device)
    if orig_sr == target_sr:
        return x
    return _polyphase(x[None], *_rates(orig_sr, target_sr))[0]


def resample_batch(xs, orig_sr: int, target_sr: int, device=None) -> torch.Tensor:
    """:func:`resample` over same-length signals ``xs [B, n]`` in one matrix
    product: the cross-video-coalesced A1 path."""
    xs = torch.as_tensor(xs, dtype=torch.float32, device=device)
    if orig_sr == target_sr:
        return xs
    return _polyphase(xs, *_rates(orig_sr, target_sr))
