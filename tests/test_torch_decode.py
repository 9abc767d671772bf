"""The port's streams decode to the encoder's recon, pixel for pixel.

Each mode's IVF is decoded by the port's own av1_tool (libdav1d;
av1tpu_torch/_build.py builds it from native/tools/av1_tool.c), and every
decoded frame that has a recon is compared in all three planes, at the
coded (64-aligned) size the decoder outputs, with the recon the encoder
coded against.  The recon is caught by spies on the
port's functions while av1tpu_torch.cli.encode_clip runs on the CPU:

- a GOP keyframe and each inter frame: chip_smoke.ReconSpy, the spy of
  chip_smoke.py phase 13 (what models/cdef.cdef_fused returns, the
  keyframe recon after CDEF; the `ref` that inter_v.encode_gop_chunk_part,
  encode_gop_chunk or encode_gop_chunk_layered return at chunk=1, one
  frame per call);
- an all-intra frame: the recon planes of intra_part.encode_intra_part or
  intra_v.encode_intra_v, called by the all-intra chunk function (the
  probe calls them too, outside the chunk, and is not recorded).

Left out: the non-reference frames of --layers 2, whose recon no function
returns (the step returns the running reference, which they do not
refresh); and in the scene batch every frame but each scene's last, since
the workers run in other processes and return only the scene's last recon.

The daemon's input is a container, so one case codes what the CLI demuxes
from an mpeg4 mkv (av1_tool encode --codec mpeg4, as the daemon tests make
their fixture).

Modes that decode wrong because of a reference fault (ROADMAP queue 3,
items 1 and 2) are strict xfails naming it; the port's streams equal the
reference's there (tests/test_torch_slice*.py; for the mpeg4 clip, a
one-off reference run recorded in ROADMAP).  The bound stays 0 differing
pixels.  Port runs only: no reference function is called."""

import contextlib

import numpy as np
import pytest

import chip_smoke as cs
from av1tpu_torch import _build
from av1tpu_torch import cli
from av1tpu_torch.models import intra_part, intra_v
from av1tpu_torch.parallel import gop
from av1tpu_torch.spec.obu import write_ivf
from av1tpu_torch.utils.yuv import read_y4m, synthetic_clip, write_y4m
from tests.test_torch_threads import single_torch_thread  # noqa: F401

SUB_CHAIN = ("reference fault: the quality preset's sub_chain predicts each "
             "re-coded 8x8/4x4 sub-block with WAVE_MODES[pick] but signals "
             "WAVE_MODES[_TX_ORDER[pick]] (av1tpu/models/intra_wave.py:"
             "477-479)")
UNDECODABLE = ("reference fault: the quality preset's stream of this "
               "640x360 clip, demuxed from an mpeg4 mkv, is refused by "
               "libaom at the keyframe and by libdav1d at the first inter "
               "frame; the reference emits the same bytes (ROADMAP queue "
               "3, item 2); and " + SUB_CHAIN)
BATCH_KEY = ("reference fault: the fast preset's scene batch codes its "
             "keyframe with the wavefront pipeline but deblocks it at the "
             "fast preset's levels and packs it as kind 'v' "
             "(av1tpu/cli.py:320,325,341-343); and " + SUB_CHAIN)


class DecoderRefused(Exception):
    """libdav1d refused the stream."""


class PixelsDiffer(AssertionError):
    """A decoded frame differs from its recon."""


def _xfail(reason, raises=PixelsDiffer):
    """A strict xfail that only the named fault satisfies: the decoded
    pixels differ from the recon (or, for `raises=DecoderRefused`, the
    decoder refuses the stream); any other failure fails the test."""
    return pytest.mark.xfail(strict=True, reason=reason, raises=raises)


@pytest.fixture(scope="module")
def tool():
    if not _build.libav_available():
        pytest.skip("pkg-config finds no libavcodec, libavformat, libavutil")
    return _build.av1_tool_path()


def _decodes_to_recon(tool, streams, clip, recons: dict, tmp_path) -> None:
    """Write the IVF and decode it with libdav1d
    (chip_smoke.decoded_vs_recon).  Raises DecoderRefused where the decoder
    refuses it, and PixelsDiffer, with {frame: (differing y, u, v pixels)},
    where a frame of recons {frame: fused recon} differs."""
    ivf = str(tmp_path / "out.ivf")
    write_ivf(ivf, streams, clip.width, clip.height)
    dec, err, diffs = cs.decoded_vs_recon(tool, ivf, recons, str(tmp_path))
    if dec is None:
        raise DecoderRefused(err)
    assert dec["frames"] == clip.num_frames
    assert dec["bit_depth"] == clip.bit_depth
    differ = {i: d for i, d in diffs.items() if any(d)}
    if differ:
        raise PixelsDiffer(differ)


GOP_MODES = [
    pytest.param(dict(partitions=False), id="fast"),
    pytest.param(dict(partitions=True), id="quality",
                 marks=_xfail(SUB_CHAIN)),
    pytest.param(dict(partitions=True, layers=2), id="layers2",
                 marks=_xfail(SUB_CHAIN)),
    pytest.param(dict(partitions=False, bit_depth=10), id="fast_10bit"),
    pytest.param(dict(partitions=True, bit_depth=10), id="quality_10bit",
                 marks=_xfail(SUB_CHAIN)),
]


def _gop_encode(clip, **kw):
    """encode_clip at chunk 1: (TUs, {frame: fused recon}) for each
    keyframe and every inter frame that returns its recon."""
    with cs.ReconSpy() as spy:
        streams, _ = cli.encode_clip(clip, 72, chunk=1, metric="psnr",
                                     device="cpu", **kw)
    assert len(spy.frames) == clip.num_frames
    return streams, spy.recons()


@pytest.mark.parametrize("mode", GOP_MODES)
def test_gop_stream_decodes_to_recon(mode, tool, tmp_path):
    """One scene of 5 frames at chunk 1: the keyframe and each inter frame
    (the reference frames only with --layers 2)."""
    mode = dict(mode)
    clip = synthetic_clip(192, 128, 5, bit_depth=mode.pop("bit_depth", 8),
                          seed=8)
    streams, recons = _gop_encode(clip, **mode)
    assert len(recons) == (3 if mode.get("layers") == 2 else 5)
    _decodes_to_recon(tool, streams, clip, recons, tmp_path)


@pytest.mark.parametrize("partitions", [
    pytest.param(False, id="fast"),
    pytest.param(True, id="quality",
                 marks=_xfail(UNDECODABLE, raises=DecoderRefused))])
def test_mpeg4_source_decodes_to_recon(partitions, tool, tmp_path):
    """8 frames at 640x360 (the keyframe's temporal filter takes 7
    neighbours; the coded frame is 640x384), demuxed by the CLI's _to_y4m
    from an mpeg4 mkv of the synthetic clip: chip_smoke.py's daemon
    clip."""
    y4m, mkv = str(tmp_path / "src.y4m"), str(tmp_path / "src.mkv")
    write_y4m(y4m, synthetic_clip(640, 360, 8, seed=11))
    cs.av1_tool(tool, "encode", y4m, mkv, "--codec", "mpeg4")
    clip = read_y4m(cli._to_y4m(mkv, str(tmp_path)))
    streams, recons = _gop_encode(clip, partitions=partitions)
    _decodes_to_recon(tool, streams, clip, recons, tmp_path)


@pytest.mark.parametrize("partitions", [False, True],
                         ids=["fast", "quality"])
def test_all_intra_stream_decodes_to_recon(partitions, tool, tmp_path,
                                           monkeypatch):
    clip = synthetic_clip(192, 128, 2, seed=8)
    mod, chunk_name, inner_name = (
        (intra_part, "encode_intra_part_chunk", "encode_intra_part")
        if partitions else
        (intra_v, "encode_intra_v_chunk", "encode_intra_v"))
    chunk_fn, inner = getattr(mod, chunk_name), getattr(mod, inner_name)
    recons, inside = [], []

    def chunk_spy(*a, **k):
        inside.append(True)
        try:
            return chunk_fn(*a, **k)
        finally:
            inside.pop()

    def inner_spy(*a, **k):
        o = inner(*a, **k)
        if inside:
            recons.append(np.concatenate([o[p].numpy().ravel() for p in
                                          ("recon_y", "recon_u", "recon_v")]))
        return o

    monkeypatch.setattr(mod, chunk_name, chunk_spy)
    monkeypatch.setattr(mod, inner_name, inner_spy)
    streams, stats = cli.encode_clip(clip, 72, chunk=2, metric="psnr",
                                     partitions=partitions, gop=False,
                                     device="cpu")
    monkeypatch.undo()
    assert stats["keyframes"] == len(recons) == clip.num_frames
    _decodes_to_recon(tool, streams, clip, dict(enumerate(recons)),
                      tmp_path)


@pytest.fixture(scope="module")
def scene_pool():
    """Two CPU workers shared by the batch cases; a hung worker fails the
    test instead of running into the suite's clock."""
    with gop.ScenePool(gop.scene_devices(2, "cpu"), timeout=300.0) as pool:
        yield pool


@pytest.mark.parametrize("partitions", [
    pytest.param(False, id="fast", marks=_xfail(BATCH_KEY)),
    pytest.param(True, id="quality", marks=_xfail(SUB_CHAIN))])
def test_scene_batch_decodes_to_recon(partitions, tool, scene_pool,
                                      tmp_path, monkeypatch):
    """Two 2-frame scenes (the second inverted) on the batch path, two
    devices reported (as tests/test_torch_slice.py does): each scene's
    last frame against the recon its worker returns."""
    clip = synthetic_clip(128, 64, 4, seed=8)
    clip.y[2:] = 255 - clip.y[2:]
    results = []
    encode = gop.SceneBatchEncoder.encode

    def spy(enc, *a, **k):
        res = encode(enc, *a, **k)
        results.extend(res)
        return res

    monkeypatch.setattr(gop.SceneBatchEncoder, "encode", spy)
    monkeypatch.setattr(cli, "_device_count", lambda dev: 2)
    monkeypatch.setattr(gop, "ScenePool",
                        lambda devices: contextlib.nullcontext(scene_pool))
    streams, stats = cli.encode_clip(clip, 72, chunk=2, metric="psnr",
                                     partitions=partitions, workers=2,
                                     device="cpu")
    monkeypatch.undo()
    assert stats["scenes"] == len(results) == 2
    assert len({r["pid"] for r in results}) == 2
    recons = {1: results[0]["ref"], 3: results[1]["ref"]}
    _decodes_to_recon(tool, streams, clip, recons, tmp_path)
