"""Target-quality probes (port of av1tpu/models/cq.py).

A probe intra-encodes a frame at a qindex and scores the luma recon; the
CQ search bisects qindex for the coarsest q meeting a target.
"""

from __future__ import annotations

from av1tpu_torch.metrics.quality import psnr, ssim, tpu_vmaf
from av1tpu_torch.models.intra_v import encode_intra_v

# "tpu_vmaf" is a VMAF-architecture score calibrated in this framework, not
# numerically interchangeable with libvmaf (metrics/quality.py)
METRICS = {"psnr": psnr, "ssim": ssim, "tpu_vmaf": tpu_vmaf}


def _metric(metric: str):
    if metric not in METRICS:
        raise ValueError(f"unknown metric {metric!r}; expected one of "
                         f"{sorted(METRICS)}")
    return METRICS[metric]


def _probe_recon(y, u, v, qindex: int, bit_depth: int, partitions: bool):
    """The probe's luma recon: partitions=True encodes with the 64/32/16
    partition pipeline (the quality preset), else the fast-preset intra
    without RDO."""
    if partitions:
        from av1tpu_torch.models.intra_part import encode_intra_part
        return encode_intra_part(y, u, v, qindex,
                                 bit_depth=bit_depth)["recon_y"]
    return encode_intra_v(y, u, v, qindex, bit_depth=bit_depth)["recon_y"]


def probe_quality(y, u, v, qindex: int, metric: str = "tpu_vmaf",
                  bit_depth: int = 8, partitions: bool = False):
    """Encode at qindex and score the luma recon against the source
    (10-bit scored in the 8-bit range).  Returns a float32 0-dim tensor."""
    fn = _metric(metric)
    sh = bit_depth - 8
    return fn(y >> sh, _probe_recon(y, u, v, qindex, bit_depth,
                                    partitions) >> sh)


def probe_scores_multi(frames, qindex: int, metrics, bit_depth: int = 8,
                       partitions: bool = False) -> dict:
    """{metric: worst (minimum) probe score over the sampled frames
    [(y, u, v), ...]} with each frame encoded once for all the metrics:
    the same numbers as one probe_quality_multi call per metric."""
    fns = {m: _metric(m) for m in metrics}
    sh = bit_depth - 8
    scores = {m: [] for m in metrics}
    for y, u, v in frames:
        rec = _probe_recon(y, u, v, qindex, bit_depth, partitions) >> sh
        for m, fn in fns.items():
            scores[m].append(float(fn(y >> sh, rec)))
    return {m: min(s) for m, s in scores.items()}


def probe_quality_multi(frames, qindex: int, metric: str = "tpu_vmaf",
                        bit_depth: int = 8,
                        partitions: bool = False) -> float:
    """Worst (minimum) probe score over sampled frames [(y, u, v), ...]."""
    return probe_scores_multi(frames, qindex, (metric,), bit_depth,
                              partitions)[metric]


def cq_search_multi(frames, target: float, metric: str = "tpu_vmaf",
                    qmin: int = 8, qmax: int = 255, log=None,
                    bit_depth: int = 8,
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
        if log:
            log(f"cq probe q={mid} {metric}={score:.3f}")
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


def cq_search(y, u, v, target: float, metric: str = "tpu_vmaf",
              qmin: int = 8, qmax: int = 255, log=None, bit_depth: int = 8,
              partitions: bool = False) -> tuple[int, float]:
    """Largest qindex whose score on one frame >= target (qmin if even
    qmin misses).  Returns (qindex, score)."""
    return cq_search_multi([(y, u, v)], target, metric=metric, qmin=qmin,
                           qmax=qmax, log=log, bit_depth=bit_depth,
                           partitions=partitions)
