"""Port parity for scene detection and the q probes: scene_scores to rtol
1e-6 with the same scene split, probe PSNR to 1e-4 dB, and the same CQ
search result as av1tpu."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.core.scenes import scene_scores as jax_scores
from av1tpu.models.cq import cq_search_multi as jax_cq
from av1tpu.models.cq import probe_quality as jax_probe
from av1tpu.utils.yuv import Clip, synthetic_clip
from av1tpu_torch.core.scenes import scene_scores, split_scenes
from av1tpu_torch.models.cq import cq_search_multi, probe_quality
from tests.test_inter_pipeline import moving_clip
from tests.test_torch_threads import single_torch_thread  # noqa: F401


def _cut_clip():
    a = moving_clip(128, 64, 6, seed=73, dy=1, dx=2)
    b = moving_clip(128, 64, 6, seed=99, dy=0, dx=3)
    return Clip(y=np.concatenate([a.y, 255 - b.y, a.y[:4]]),
                u=np.concatenate([a.u, b.u, a.u[:4]]),
                v=np.concatenate([a.v, b.v, a.v[:4]]))


@pytest.mark.parametrize("decimate", [1, 4])
def test_scene_scores_and_split_match_jax(decimate):
    y = _cut_clip().y[:, ::decimate, ::decimate]
    want = np.asarray(jax_scores(jnp.asarray(y)))
    got = scene_scores(torch.from_numpy(np.ascontiguousarray(y))).numpy()
    assert got.dtype == np.float32 and np.isinf(got[0])
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-6)
    for min_len in (1, 4):
        assert (split_scenes(got, min_len=min_len)
                == split_scenes(want, min_len=min_len))
    assert len(split_scenes(got, min_len=4)) == 3


def _planes(bit_depth, seed):
    c = synthetic_clip(128, 64, 1, bit_depth=bit_depth, seed=seed)
    return [p[0].astype(np.int32) for p in (c.y, c.u, c.v)]


@pytest.mark.parametrize("bit_depth,q", [(8, 30), (8, 150), (10, 90)])
def test_probe_psnr_matches_jax(bit_depth, q):
    p = _planes(bit_depth, 12)
    want = float(jax_probe(*(jnp.asarray(x) for x in p), q, metric="psnr",
                           bit_depth=bit_depth))
    got = probe_quality(*(torch.from_numpy(x) for x in p), q,
                        metric="psnr", bit_depth=bit_depth)
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-4


def test_cq_search_matches_jax():
    frames = [_planes(8, s) for s in (12, 13)]
    want = jax_cq([[jnp.asarray(x) for x in f] for f in frames], 40.0,
                  metric="psnr")
    got = cq_search_multi([[torch.from_numpy(x) for x in f]
                           for f in frames], 40.0, metric="psnr")
    assert got[0] == want[0]
    assert abs(got[1] - want[1]) <= 1e-4


def test_unported_metric_raises():
    """The reference's three probe metrics are ported; another name (the
    reference has no MS-SSIM probe) raises."""
    from av1tpu_torch.models.cq import METRICS

    assert sorted(METRICS) == ["psnr", "ssim", "tpu_vmaf"]
    p = [torch.from_numpy(x) for x in _planes(8, 12)]
    with pytest.raises(ValueError):
        probe_quality(*p, 60, metric="msssim")


def test_probe_scores_share_one_encode():
    """probe_scores_multi scores one probe encode per frame on several
    metrics: the same numbers as one probe_quality_multi call each, the
    worst frame's for each metric."""
    from av1tpu_torch.models.cq import probe_quality_multi, probe_scores_multi

    frames = [[torch.from_numpy(x) for x in _planes(8, s)] for s in (12, 13)]
    got = probe_scores_multi(frames, 90, ("tpu_vmaf", "ssim", "psnr"))
    for m, v in got.items():
        assert v == probe_quality_multi(frames, 90, metric=m), m
        assert v == min(float(probe_quality(*f, 90, metric=m))
                        for f in frames)
    assert 0.0 < got["tpu_vmaf"] <= 100.0 and 0.0 < got["ssim"] <= 1.0
