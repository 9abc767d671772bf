"""The slice end to end: av1tpu_torch.cli.encode_clip (fast preset, on the
CPU) emits TUs byte-identical to av1tpu.cli.encode_clip(partitions=False,
metric="psnr", gop=True) on the two-scene clip of tests/test_cli_gop.py,
with the same stats keys and values.  Chunks of 4 make each 5-frame scene
one full inter chunk; chunks of 3 make it a full chunk and a 1-frame tail,
so the recon and the CDF chain handed from chunk to chunk are compared
too, as is the tail that the reference pads to a full chunk."""

import functools
import hashlib
import json

import numpy as np
import pytest

import av1tpu.coding
from av1tpu.cli import encode_clip as jax_encode_clip
from av1tpu.utils.yuv import Clip
from av1tpu_torch._build import packer_lib_path
from av1tpu_torch.cli import encode_clip, main
from tests.test_inter_pipeline import moving_clip
from tests.test_torch_threads import single_torch_thread  # noqa: F401

KW = dict(metric="psnr", partitions=False, scene_threshold=2.5, gop=True)


def _two_scene_clip():
    a = moving_clip(128, 64, 5, seed=73, dy=1, dx=2)
    b = moving_clip(128, 64, 5, seed=99, dy=0, dx=3)
    return Clip(y=np.concatenate([a.y, 255 - b.y]),
                u=np.concatenate([a.u, b.u]),
                v=np.concatenate([a.v, b.v]))


@pytest.fixture(scope="module", params=[4, 3], ids=["chunk4", "chunk3"])
def encodes(request):
    clip = _two_scene_clip()
    kw = dict(KW, chunk=request.param)
    # the reference's Packer() reads native/build/; hand it the port's
    # packer build instead (same source, native/coding/pack.cpp)
    packer = functools.partial(av1tpu.coding.Packer,
                               lib_path=packer_lib_path())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(av1tpu.coding, "Packer", packer)
        want = jax_encode_clip(clip, 120, **kw)
    got = encode_clip(clip, 120, device="cpu", **kw)
    return want, got


def test_tus_byte_identical(encodes):
    (ws, _), (gs, _) = encodes
    assert len(gs) == len(ws) == 10
    differing = [i for i, (a, b) in enumerate(zip(gs, ws)) if a != b]
    assert differing == []


def test_stats_match(encodes):
    (_, wst), (_, gst) = encodes
    assert set(gst) == set(wst)
    assert set(gst["stage_seconds"]) <= set(wst["stage_seconds"])
    for k in ("frames", "bytes", "width", "height", "qindex", "scenes",
              "keyframes", "psnr_y", "metric_score"):
        assert gst[k] == wst[k], k
    assert gst["scenes"] == 2


def _small_two_scene_clip():
    """Two 3-frame scenes at 64x64 (scenes at chunk 2)."""
    a = moving_clip(64, 64, 3, seed=73, dy=1, dx=2)
    return Clip(y=np.concatenate([a.y, 255 - a.y]),
                u=np.concatenate([a.u, a.u]), v=np.concatenate([a.v, a.v]))


@pytest.fixture(scope="module")
def psnr_run():
    return encode_clip(_small_two_scene_clip(), 120, device="cpu",
                       **dict(KW, chunk=2))


# The reference's scene batch with the fast preset (av1tpu.cli.encode_clip
# on the small two-scene clip, chunk 2, q 120, PSNR, workers=8 on the
# 8-device virtual CPU mesh, whose Packer was the port's build): SHA-256 of
# each TU.  Its keyframe is always the wavefront one, packed as the fast
# preset's kind "v" (av1tpu/cli.py:320, 341-343), so every TU differs from
# workers=1; a reference fault (ROADMAP queue 3), reproduced on purpose.
# Recorded once, because the batch's sharded compile takes minutes.
FAST_BATCH_SHA256 = [
    "811324354f22060d2a455d2a5b2802f7a83583bc5775ce58f4799f4dd7ac973d",
    "bcc865ac4733a7ba27f85d067b92a596e01856e176ffbe70932369267a3a416d",
    "09a85fc3ae103f9c80a4698ae5e73ca89a804b01df50a1fbf2b5e606b4407784",
    "4aa3101316ff06bf929be753fd31b146b5e7013f3a64cfc14fb4f6b06df25b60",
    "bcc865ac4733a7ba27f85d067b92a596e01856e176ffbe70932369267a3a416d",
    "f0c08c1504195071171730442b321ffc945506660f0d15beb53744446367b911",
]
FAST_BATCH_STATS = {"bytes": 238, "psnr_y": 41.434}


@pytest.mark.parametrize("kw", [dict(metric="ssim"), dict(gop=False),
                                dict(workers=2), dict(layers=2),
                                dict(metric="tpu_vmaf")])
def test_unported_branches_raise(kw, psnr_run, monkeypatch):
    """Every branch of the reference's encode_clip is ported: with the fast
    preset at a fixed q, another metric (filed under its own name), a
    worker count on one device or --layers 2 (which the reference applies
    with partitions only) emits the PSNR run's TUs, and gop=False codes
    every frame as a keyframe.  With two devices reported, workers=2 takes
    the scene batch wherever the reference does (GOP mode, more than one
    device and scene) and emits the reference batch's TUs, whatever the
    metric or `layers`; gop=False stays on the all-intra path."""
    import av1tpu_torch.cli as cli
    from av1tpu_torch.parallel import gop

    args = dict(KW, chunk=2, **kw)
    clip = _small_two_scene_clip()
    gs, gst = encode_clip(clip, 120, device="cpu", **args)
    metric = args["metric"]
    assert (metric if metric != "psnr" else "metric_score") in gst
    assert gst["scenes"] == 2
    if args["gop"]:
        assert gs == psnr_run[0]
    else:
        assert gst["keyframes"] == len(gs) == 6
    monkeypatch.setattr(cli, "_device_count", lambda dev: 2)
    # a hung worker fails the test instead of running into the suite's clock
    monkeypatch.setattr(gop, "ScenePool",
                        functools.partial(gop.ScenePool, timeout=300.0))
    many = dict(args, workers=2)
    bs, bst = encode_clip(clip, 120, device="cpu", **many)
    if args["gop"]:
        assert [hashlib.sha256(t).hexdigest() for t in bs] == \
            FAST_BATCH_SHA256
        assert {k: bst[k] for k in FAST_BATCH_STATS} == FAST_BATCH_STATS
        assert set(bst) == set(gst) and bst["scenes"] == 2
    else:
        assert bs == gs


def test_cli_encode_writes_ivf(tmp_path, capsys):
    from av1tpu.utils.yuv import synthetic_clip, write_y4m

    src = tmp_path / "in.y4m"
    out = tmp_path / "out.ivf"
    write_y4m(str(src), synthetic_clip(96, 64, 3, seed=4))
    assert main(["encode", "-i", str(src), "-o", str(out), "--preset",
                 "fast", "--metric", "psnr", "--qindex", "100", "--chunk",
                 "2", "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["frames"] == 3 and stats["output"] == str(out)
    data = out.read_bytes()
    assert data[:4] == b"DKIF" and len(data) > stats["bytes"]
