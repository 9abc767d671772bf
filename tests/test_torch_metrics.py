"""Port parity for the quality metrics: av1tpu_torch.metrics.quality against
av1tpu.metrics.quality on seeded numpy frames.  The separable filter sums
its taps in the order of the reference's compiled convolution, so it is held
bit for bit at every window size the metrics use; the scores are held within
the tolerances below.  The reference's metrics are small convolution graphs:
each shape compiles in a second or two."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.metrics import quality as ref
from av1tpu_torch.metrics import quality as port
from tests.test_torch_threads import single_torch_thread  # noqa: F401

# The filters are the reference's bits, but the final means and per-frame
# sums reduce in another order than XLA's, and log2/exp may differ in the
# last place.  tpu_vmaf is a logistic of the features that is up to 160
# times steeper than they are, hence its wider absolute bound on the 0-100
# scale.
TOL_SSIM = 1e-5          # SSIM and MS-SSIM, absolute
TOL_VIF_REL = 1e-4       # each VIF scale's ratio, relative
TOL_VMAF = 1e-3          # tpu_vmaf, absolute (0-100 scale)


def _pair(shape, seed, amp=12):
    """A uint8 source and a copy distorted by seeded noise of +-amp."""
    rng = np.random.RandomState(seed)
    r = rng.randint(0, 256, size=shape).astype(np.uint8)
    noise = rng.randint(-amp, amp + 1, size=shape)
    d = np.clip(r.astype(np.int32) + noise, 0, 255).astype(np.uint8)
    return r, d


# "identity" has the clip's shape, so that it reuses the reference's
# compiled metrics
CASES = {
    "clip": _pair((3, 64, 96), 1),               # T=3 frames, motion term
    "plane": _pair((64, 96), 2, amp=40),         # an (H, W) call
    "identity": (_pair((3, 64, 96), 3)[0],) * 2,
}


def _both(fn, r, d):
    want = np.asarray(getattr(ref, fn)(jnp.asarray(r), jnp.asarray(d)))
    got = getattr(port, fn)(torch.from_numpy(r), torch.from_numpy(d))
    assert got.dtype == torch.float32
    return want, got.numpy()


@pytest.mark.parametrize("n,sigma", [(1, 1.5), (3, 0.75), (5, 4.0 / 3.0),
                                     (7, 1.5), (9, 1.8), (11, 1.5),
                                     (13, 2.6), (17, 3.4)])
def test_sep_filter_bit_for_bit(n, sigma):
    """Every window the metrics use: SSIM's 11 (shrunk to 9, 7, ..., 1 on
    small planes), VIF's 17/13/9/5 and its 3-tap blur, the motion 5."""
    x = np.random.RandomState(n).rand(2, 37, 41).astype(np.float32) * 255
    k = ref._gaussian_kernel(n, sigma)
    assert np.array_equal(port._gaussian_kernel(n, sigma), k)
    want = np.asarray(ref._sep_filter(jnp.asarray(x), k))
    got = port._sep_filter(torch.from_numpy(x), k).numpy()
    assert got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("case", sorted(CASES))
def test_ssim_and_msssim_match_jax(case):
    r, d = CASES[case]
    for fn in ("ssim", "msssim"):
        want, got = _both(fn, r, d)
        assert abs(float(got) - float(want)) <= TOL_SSIM, fn
    if case == "identity":
        assert abs(float(got) - 1.0) <= TOL_SSIM


def test_small_frame_shrinks_the_window():
    """24x40: MS-SSIM's deep scales (6x10, 3x5, 1x2) filter with 5-, 3- and
    1-tap windows, and a 8x12 SSIM with a 7-tap one."""
    r, d = _pair((2, 24, 40), 4)
    assert len(port._ssim_window(torch.zeros(3, 5))) == 3
    assert len(port._ssim_window(torch.zeros(1, 2))) == 1
    want, got = _both("msssim", r, d)
    assert abs(float(got) - float(want)) <= TOL_SSIM
    want, got = _both("ssim", r[:, :8, :12], d[:, :8, :12])
    assert abs(float(got) - float(want)) <= TOL_SSIM


@pytest.mark.parametrize("case", sorted(CASES))
def test_vif_features_match_jax(case):
    r, d = CASES[case]
    want, got = _both("vif_features", r, d)
    assert got.shape == want.shape == r.shape[:-2] + (4,)
    np.testing.assert_allclose(got, want, rtol=TOL_VIF_REL, atol=0)


def test_motion_feature_matches_jax():
    r, _ = CASES["clip"]
    want = np.asarray(ref._motion_feature(jnp.asarray(r, jnp.float32)))
    got = port._motion_feature(torch.from_numpy(r).float()).numpy()
    assert got[0] == want[0] == 0.0 and got[1] > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert port._motion_feature(torch.zeros(1, 16, 16)).tolist() == [0.0]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tpu_vmaf_matches_jax(case):
    r, d = CASES[case]
    want, got = _both("tpu_vmaf", r, d)
    assert 0.0 <= float(got) <= 100.0
    assert abs(float(got) - float(want)) <= TOL_VMAF


def test_tpu_vmaf_in_the_steep_part_of_its_logistic():
    """A score near 16, where the logistic is steepest: feature errors are
    amplified most here."""
    from av1tpu_torch.utils.yuv import synthetic_clip

    r = synthetic_clip(96, 64, 3, seed=12).y
    rng = np.random.RandomState(12)
    d = np.clip(r.astype(np.int32) + rng.randint(-12, 13, r.shape), 0,
                255).astype(np.uint8)
    want, got = _both("tpu_vmaf", r, d)
    assert 5.0 < float(want) < 50.0
    assert abs(float(got) - float(want)) <= TOL_VMAF


def test_psnr_matches_jax():
    r, d = CASES["clip"]
    want, got = _both("psnr", r, d)
    assert abs(float(got) - float(want)) <= 1e-4
