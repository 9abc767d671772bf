"""Per-coefficient rate-distortion quantization (port of av1tpu/models/rdoq.py).

    keep  <=>  gain_j * (c^2 - (c - dq)^2)  >  lambda * bits(|lv|)

Elementwise and context-free: magnitudes >= _KEEP_ALWAYS are kept, and an
optional noise gate zeroes coefficients whose pixel-domain energy sits
inside the sensor-noise band.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_KEEP_ALWAYS = 8


@functools.cache
def coef_gains(n: int, tx_type: int = 0) -> np.ndarray:
    """Copy of av1tpu/models/rdoq.py:coef_gains (numpy): (m,) pixel-SSE
    gain of each coded coefficient = 1 / rownorm^2 of the forward matrix
    (m = min(n, 32)^2: TX_64X64 codes the top-left 32x32)."""
    from av1tpu_torch.ops.transforms import forward_matrix, fwd64

    if n == 64:
        fwd = np.asarray(fwd64(), np.float64)
    else:
        fwd = np.asarray(forward_matrix(n, n, tx_type), np.float64)
    return (1.0 / (fwd * fwd).sum(axis=1)).astype(np.float32)


def rd_zero(lv: torch.Tensor, coefs: torch.Tensor, dq_scale: torch.Tensor,
            lam: float, tab: torch.Tensor, gains: torch.Tensor,
            noise_gate: float | None = None) -> torch.Tensor:
    """Zero every level whose rate exceeds its distortion value.

    lv: (..., m) int32 deadzone levels; coefs: the float32 coefficients they
    were quantized from; dq_scale: (m,) float32 dequant per level unit;
    lam: pixel-domain lambda (a float32 value as a Python float); tab:
    (>= _KEEP_ALWAYS,) float32 expected bits per magnitude; gains: (m,)
    float32 from coef_gains.  Returns the pruned levels."""
    a = lv.abs()
    c = coefs.abs()
    t = c - a.to(torch.float32) * dq_scale
    save = gains * (c * c - t * t)
    bits = torch.zeros(a.shape, dtype=torch.float32, device=lv.device)
    for k in range(1, _KEEP_ALWAYS):
        bits = bits + torch.where(a == k, tab[k] - tab[0], 0.0)
    keep = (a >= _KEEP_ALWAYS) | (save > lam * bits) | (a == 0)
    if noise_gate is not None:
        above = (gains * c * c > noise_gate) | (a >= _KEEP_ALWAYS) | (a == 0)
        keep = keep & above
    return torch.where(keep, lv, 0)
