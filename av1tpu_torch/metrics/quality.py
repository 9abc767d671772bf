"""Full-reference quality metrics (port of av1tpu/metrics/quality.py).

- ``psnr``: peak signal-to-noise ratio.
- ``ssim``: SSIM with an 11x11 Gaussian window, sigma 1.5, K1=0.01 /
  K2=0.03 (shrunk to an odd window on planes smaller than 11).
- ``msssim``: 5-scale multi-scale SSIM with the standard exponents.
- ``vif_features``: per-scale visual information fidelity ratios over 4
  Gaussian pyramid scales.
- ``tpu_vmaf``: the reference's VMAF-architecture score in [0, 100] (4 VIF
  scales, an SSIM detail term and motion through a fixed logistic blend; a
  calibration of its own, not the libvmaf model).

Inputs are (H, W) or (T, H, W) luma planes of any integer or float dtype;
results are float32 tensors on the input's device.  The float expressions
follow the reference's compiled order: the separable filters sum their
taps (at most 17) as XLA:CPU's convolution does, bit for bit, and the
variances round once where XLA contracts a multiply-add.  The filters are
elementwise float32 sums, never a convolution or a matmul, so no TF32 path
of cuDNN or cuBLAS can touch the scores whatever torch.backends' global
flags say.
"""

from __future__ import annotations

import numpy as np
import torch


def _gaussian_kernel(size: int, sigma: float) -> np.ndarray:
    r = np.arange(size) - (size - 1) / 2.0
    k = np.exp(-(r ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def _fma(acc: torch.Tensor, x: torch.Tensor, y) -> torch.Tensor:
    """float32 acc + x * y rounded once, as a fused multiply-add: the
    product of two float32 values is exact in float64.  XLA:CPU contracts
    a + b * c into one where both land in one fused loop, and the
    variances below cancel most of their digits, so the port rounds where
    the reference's compiled graph rounds."""
    if isinstance(y, torch.Tensor):
        y = y.double()
    return (acc.double() + x.double() * y).float()


def _taps_sum(x: torch.Tensor, taps: list, dim: int) -> torch.Tensor:
    """'valid' 1-D correlation of x with taps along dim, in float32, summed
    in the order of the reference's compiled convolution on the CPU (an
    Eigen contraction over the taps): 8-tap blocks accumulated lane-wise
    with fused multiply-adds and reduced pairwise then by halves, then a
    4-tap block reduced pairwise, a 2-tap pair, a last tap.  Bit-exact
    with XLA:CPU for the window sizes used here (tests/test_torch_metrics.py)."""
    n = len(taps)
    length = x.shape[dim] - n + 1

    def sl(i):
        return x.narrow(dim, i, length)

    def term(i):
        return sl(i) * taps[i]

    tot, i = None, 0
    if n >= 8:
        lanes = [term(j) for j in range(8)]
        i = 8
        while i + 8 <= n:
            lanes = [_fma(lanes[j], sl(i + j), taps[i + j]) for j in range(8)]
            i += 8
        p = [lanes[j] + lanes[j + 1] for j in range(0, 8, 2)]
        tot = (p[0] + p[2]) + (p[1] + p[3])
    for width in (4, 2, 1):
        if n - i >= width:
            if width == 4:
                part = (term(i) + term(i + 1)) + (term(i + 2) + term(i + 3))
            elif width == 2:
                part = term(i) + term(i + 1)
            else:
                part = term(i)
            tot = part if tot is None else tot + part
            i += width
    return tot


def _sep_filter(img: torch.Tensor, k1d: np.ndarray) -> torch.Tensor:
    """Separable 2D filter, 'valid' region: the column pass, then the row
    pass.  img: (..., H, W) float32."""
    taps = [float(t) for t in k1d]
    return _taps_sum(_taps_sum(img, taps, img.dim() - 2), taps, img.dim() - 1)


def _as_f32_batch(x: torch.Tensor):
    x = x.to(torch.float32)
    if x.dim() == 2:
        return x[None], True
    return x, False


def psnr(ref: torch.Tensor, dis: torch.Tensor,
         peak: float = 255.0) -> torch.Tensor:
    """Mean PSNR over frames (float32 0-dim).  ref/dis: (H, W) or
    (T, H, W)."""
    r, _ = _as_f32_batch(ref)
    d, _ = _as_f32_batch(dis)
    e = r - d
    mse = (e * e).sum(dim=(-1, -2)) / (r.shape[-1] * r.shape[-2])
    mse = torch.clamp(mse, min=1e-10)
    v = 10.0 * torch.log10(peak * peak / mse)
    return v.sum() / v.numel()


def _ssim_window(r: torch.Tensor) -> np.ndarray:
    """11x11 Gaussian, shrunk (odd) when the plane is too small for a valid
    filter, so that the deep MS-SSIM scales of small frames stay defined."""
    lim = min(r.shape[-1], r.shape[-2])
    size = min(11, lim if lim % 2 else lim - 1)
    return _gaussian_kernel(size, 1.5)


def _ssim_map(r: torch.Tensor, d: torch.Tensor, peak: float = 255.0):
    c1 = (0.01 * peak) ** 2
    c2 = (0.03 * peak) ** 2
    k = _ssim_window(r)
    mu_r = _sep_filter(r, k)
    mu_d = _sep_filter(d, k)
    rr = _fma(_sep_filter(r * r, k), -mu_r, mu_r)
    dd = _fma(_sep_filter(d * d, k), -mu_d, mu_d)
    rd = _fma(_sep_filter(r * d, k), -mu_r, mu_d)
    lum = (_fma(torch.full_like(mu_r, c1), 2 * mu_r, mu_d)
           / (_fma(mu_d * mu_d, mu_r, mu_r) + c1))
    cs = (2 * rd + c2) / (rr + dd + c2)
    return lum * cs, cs


def ssim(ref: torch.Tensor, dis: torch.Tensor,
         peak: float = 255.0) -> torch.Tensor:
    r, _ = _as_f32_batch(ref)
    d, _ = _as_f32_batch(dis)
    m, _ = _ssim_map(r, d, peak)
    return m.mean()


def _downsample2(x: torch.Tensor) -> torch.Tensor:
    h, w = x.shape[-2] & ~1, x.shape[-1] & ~1
    x = x[..., :h, :w]
    return (x[..., 0::2, 0::2] + x[..., 0::2, 1::2] +
            x[..., 1::2, 0::2] + x[..., 1::2, 1::2]) * 0.25


_MSSSIM_W = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def msssim(ref: torch.Tensor, dis: torch.Tensor,
           peak: float = 255.0) -> torch.Tensor:
    r, _ = _as_f32_batch(ref)
    d, _ = _as_f32_batch(dis)
    vals = []
    for i in range(len(_MSSSIM_W)):
        m, cs = _ssim_map(r, d, peak)
        vals.append((m if i == len(_MSSSIM_W) - 1 else cs).mean())
        if i != len(_MSSSIM_W) - 1:
            r = _downsample2(r)
            d = _downsample2(d)
    out = torch.ones((), dtype=torch.float32, device=r.device)
    for v, w in zip(vals, _MSSSIM_W):
        out = out * torch.clamp(v, min=1e-6) ** w
    return out


# ---------------------------------------------------------------------------
# VIF (visual information fidelity), per scale: VMAF's backbone feature
# ---------------------------------------------------------------------------

_VIF_SIGMA_NSQ = 2.0


def _vif_scale(r: torch.Tensor, d: torch.Tensor, ksize: int, sigma: float):
    k = _gaussian_kernel(ksize, sigma)
    mu_r = _sep_filter(r, k)
    mu_d = _sep_filter(d, k)
    var_r = torch.clamp(_fma(_sep_filter(r * r, k), -mu_r, mu_r), min=0.0)
    var_d = torch.clamp(_fma(_sep_filter(d * d, k), -mu_d, mu_d), min=0.0)
    cov = _fma(_sep_filter(r * d, k), -mu_r, mu_d)
    g = cov / (var_r + 1e-10)
    sv = _fma(var_d, -g, cov)
    flat = var_r < 1e-10
    g = torch.where(flat, 0.0, g)
    sv = torch.where(flat, var_d, sv)
    g = torch.clamp(g, min=0.0)
    sv = torch.clamp(sv, min=1e-10)
    num = torch.log2(1.0 + g * g * var_r / (sv + _VIF_SIGMA_NSQ))
    den = torch.log2(1.0 + var_r / _VIF_SIGMA_NSQ)
    return num.sum(dim=(-1, -2)), den.sum(dim=(-1, -2))


def vif_features(ref: torch.Tensor, dis: torch.Tensor) -> torch.Tensor:
    """Per-scale VIF ratios, 4 Gaussian pyramid scales.  Returns (4,) or
    (T, 4) float32."""
    r, squeeze = _as_f32_batch(ref)
    d, _ = _as_f32_batch(dis)
    blur = _gaussian_kernel(3, 0.75)
    feats = []
    for scale in range(4):
        ksize = max(3, 17 - scale * 4)
        num, den = _vif_scale(r, d, ksize, ksize / 5.0)
        feats.append(num / torch.clamp(den, min=1e-10))
        if scale != 3:
            r = _downsample2(_sep_filter(r, blur))
            d = _downsample2(_sep_filter(d, blur))
    out = torch.stack(feats, dim=-1)
    return out[0] if squeeze else out


def _motion_feature(ref: torch.Tensor) -> torch.Tensor:
    """Mean abs difference between consecutive blurred frames (VMAF's
    'motion2' shape), 0 for the first.  ref: (T, H, W) float32 -> (T,)."""
    zero = torch.zeros((1,), dtype=torch.float32, device=ref.device)
    if ref.shape[0] == 1:
        return zero
    blurred = _sep_filter(ref, _gaussian_kernel(5, 4.0 / 3.0))
    diff = (blurred[1:] - blurred[:-1]).abs().mean(dim=(-1, -2))
    return torch.cat([zero, diff])


def tpu_vmaf(ref: torch.Tensor, dis: torch.Tensor) -> torch.Tensor:
    """VMAF-architecture quality score in [0, 100] (float32 0-dim; see the
    module docstring for the calibration caveat).  ref/dis: (T, H, W) or
    (H, W) luma."""
    r, _ = _as_f32_batch(ref)
    d, _ = _as_f32_batch(dis)
    vif = vif_features(r, d)                    # (T, 4)
    m, _ = _ssim_map(r, d)                      # detail-loss stand-in
    dlm = m.mean(dim=(-1, -2))                  # (T,)
    motion = _motion_feature(r)                 # (T,)
    # fixed blend: VIF scales weighted toward coarse scales, the detail
    # term dominant, motion as a masking bonus
    raw = (0.10 * vif[..., 0] + 0.15 * vif[..., 1] + 0.20 * vif[..., 2]
           + 0.25 * vif[..., 3] + 2.20 * dlm
           + 0.015 * torch.clamp(motion, max=20.0))
    score = 100.0 / (1.0 + torch.exp(-6.5 * (raw - 2.15)))
    return score.mean()
