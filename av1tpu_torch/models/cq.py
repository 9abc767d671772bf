"""Target-quality probes (port of av1tpu/models/cq.py, PSNR only).

A probe intra-encodes a frame at a qindex and scores the luma recon; the
CQ search bisects qindex for the coarsest q meeting a target.
"""

from __future__ import annotations

from av1tpu_torch.metrics.quality import psnr
from av1tpu_torch.models.intra_v import encode_intra_v

METRICS = {"psnr": psnr}


def _metric(metric: str):
    if metric not in METRICS:
        raise NotImplementedError(
            f"metric {metric!r} is not ported yet (ROADMAP queue 1: "
            "tpu_vmaf/ssim/msssim/vif); use 'psnr'")
    return METRICS[metric]


def probe_quality(y, u, v, qindex: int, metric: str = "psnr",
                  bit_depth: int = 8, partitions: bool = False):
    """Encode at qindex and score the luma recon against the source
    (10-bit scored in the 8-bit range).  Returns a float32 0-dim tensor.
    partitions=True probes with the 64/32/16 partition pipeline (the
    quality preset), else the fast-preset intra without RDO."""
    fn = _metric(metric)
    if partitions:
        from av1tpu_torch.models.intra_part import encode_intra_part
        out = encode_intra_part(y, u, v, qindex, bit_depth=bit_depth)
    else:
        out = encode_intra_v(y, u, v, qindex, bit_depth=bit_depth)
    sh = bit_depth - 8
    return fn(y >> sh, out["recon_y"] >> sh)


def probe_quality_multi(frames, qindex: int, metric: str = "psnr",
                        bit_depth: int = 8,
                        partitions: bool = False) -> float:
    """Worst (minimum) probe score over sampled frames [(y, u, v), ...]."""
    return min(float(probe_quality(y, u, v, qindex, metric=metric,
                                   bit_depth=bit_depth,
                                   partitions=partitions))
               for (y, u, v) in frames)


def cq_search_multi(frames, target: float, metric: str = "psnr",
                    qmin: int = 8, qmax: int = 255, bit_depth: int = 8,
                    partitions: bool = False) -> tuple[int, float]:
    """Largest qindex whose worst sampled-frame score >= target (bisection;
    qmin if even qmin misses).  Returns (qindex, score)."""
    lo, hi = qmin, qmax
    best_q, best_score = qmin, None
    while lo <= hi:
        mid = (lo + hi) // 2
        score = probe_quality_multi(frames, mid, metric=metric,
                                    bit_depth=bit_depth,
                                    partitions=partitions)
        if score >= target:
            best_q, best_score = mid, score
            lo = mid + 1
        else:
            hi = mid - 1
    if best_score is None:
        best_score = probe_quality_multi(frames, qmin, metric=metric,
                                         bit_depth=bit_depth,
                                         partitions=partitions)
        best_q = qmin
    return best_q, best_score
