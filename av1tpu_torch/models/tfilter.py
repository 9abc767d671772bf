"""Motion-compensated temporal filtering of GOP keyframes (port of
av1tpu/models/tfilter.py).

Each neighbour is warped onto the keyframe with the inter pipeline's motion
search and normative MC, then folded into a per-pixel weighted average
(weights exp(-(d/h)^2), h from the median matched-block SAD, behind a
per-block gate).  Encoder-side only: the decoder never sees it.  The
reference's lax.scan over the 7 neighbours is a Python loop here.
"""

from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.models.intra_v import from_blocks, unfuse
from av1tpu_torch.models.inter_v import _block_sad, _chroma_mc_pair, _search_mv


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median semantics: for an even count the two middle values are
    averaged (lo * 0.5 + hi * 0.5); torch.median would return the lower."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return s[(n - 1) // 2] * 0.5 + s[n // 2] * 0.5


def _tf_init(key_fused: torch.Tensor, height: int, width: int):
    ky, ku, kv = unfuse(key_fused, height, width)
    dev = key_fused.device
    ones = lambda h, w: torch.ones((h, w), dtype=torch.float32, device=dev)
    return [ky.to(torch.float32), ones(height, width),
            ku.to(torch.float32), ones(height // 2, width // 2),
            kv.to(torch.float32), ones(height // 2, width // 2)]


def _tf_neighbor(key_fused, neigh, acc, height: int, width: int,
                 bit_depth: int):
    """Warp one neighbour onto the keyframe and fold it into the running
    weighted average `acc` ([num_y, den_y, num_u, den_u, num_v, den_v],
    updated in place of the list).  Returns med, the median matched-block
    SAD (float32 0-dim tensor)."""
    pix_max = (1 << bit_depth) - 1
    ky, ku, kv = unfuse(key_fused, height, width)
    nyp, nup, nvp = unfuse(neigh, height, width)
    mv8, pred_y, _, _ = _search_mv(ky, nyp, np.float32(4.0), pix_max)
    pred_u, pred_v = _chroma_mc_pair(nup, nvp, mv8, pix_max)
    pred_yp, pred_up, pred_vp = (from_blocks(p)
                                 for p in (pred_y, pred_u, pred_v))

    sad = _block_sad((ky - pred_yp).abs(), 16).to(torch.float32)
    med = _median(sad)
    # relative gate (3x the median matched-block SAD) and an absolute cap
    gate = ((sad <= 3.0 * med + 1.0) & (sad <= 256.0 * 16.0)).to(
        torch.float32)
    h = torch.clamp(med / 256.0, 0.5, 8.0) * 2.0
    gate_y = gate.repeat_interleave(16, 0).repeat_interleave(16, 1)
    gate_c = gate.repeat_interleave(8, 0).repeat_interleave(8, 1)

    def fold(i, k, pred, g):
        d = (k - pred).to(torch.float32) / h
        w = g * torch.exp(-(d * d))
        acc[i] = acc[i] + w * pred
        acc[i + 1] = acc[i + 1] + w

    fold(0, ky, pred_yp, gate_y)
    fold(2, ku, pred_up, gate_c)
    fold(4, kv, pred_vp, gate_c)
    return med


def _tf_final(acc, med0, height: int, width: int, bit_depth: int, dtype):
    num_y, den_y, num_u, den_u, num_v, den_v = acc
    pix_max = (1 << bit_depth) - 1
    outs = [torch.clamp(torch.round(n / d), 0, pix_max)
            for n, d in ((num_y, den_y), (num_u, den_u), (num_v, den_v))]
    # per-frame noise estimate from the closest neighbour: for matched
    # blocks mean |d|/px = E|N(0, sigma*sqrt(2))| = 1.596 * sigma
    sigma1 = med0 / (256.0 * 1.596)
    mean_den = den_y.sum() / den_y.numel()
    sigma_tf = sigma1 / torch.sqrt(torch.clamp(mean_den, min=1.0))
    filt = torch.cat([o.reshape(-1) for o in outs]).to(dtype)
    return filt, sigma_tf, sigma1


def temporal_filter_key(key_fused: torch.Tensor, neigh_fused: torch.Tensor,
                        height: int, width: int, bit_depth: int = 8):
    """Filter one fused keyframe against (K, n_pix) fused neighbours.
    Returns (filtered fused frame in the source dtype, residual-noise sigma
    of the filtered frame, the unfiltered per-frame sigma), the sigmas as
    float32 0-dim tensors.  Callers pad the neighbour stack with copies of
    the key itself (an exact match that deepens the average)."""
    acc = _tf_init(key_fused, height, width)
    meds = [_tf_neighbor(key_fused, neigh_fused[j], acc, height, width,
                         bit_depth) for j in range(neigh_fused.shape[0])]
    return _tf_final(acc, meds[0], height, width, bit_depth,
                     key_fused.dtype)
