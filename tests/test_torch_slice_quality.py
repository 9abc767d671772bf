"""The quality preset end to end: av1tpu_torch.cli.encode_clip(
partitions=True) on the CPU emits TUs byte-identical to
av1tpu.cli.encode_clip on the two-scene clip of tests/test_cli_gop.py, with
equal stats.

The reference runs at chunk 4 (each 5-frame scene is a keyframe and one full
chunk) and the port at chunk 4 and at chunk 3.  Chunking is transparent to
the stream: frame i depends on frames before it alone, whatever the chunk
bounds.  So the port's chunk-3 run (a full chunk and a 1-frame tail per
scene: the recon, the MV field and the CDF chain handed from chunk to chunk)
must emit the reference's TUs too.  The reference is not run at chunk 3
because it compiles its chunk graph a second time there (a carried MV field
is another input structure than none), two minutes of one worker alone and
far more inside the suite, which was cut at its time limit with it.

The reference's quality graphs are the suite's slowest compile, so the tests
below the slice hold the reference's jitted entry points (the probe, the
wavefront keyframe, the partitioned chunk) at the slice's own shapes and
static arguments: they reuse the executables that the slice compiled
instead of compiling them again in another file.  So do the other modes of
the command on the same clip: the 2-layer pyramid (the chunk scan takes
per-frame q, reference flags and MV scales as array inputs, so the
reference runs the slice's executable), the default metric at the slice's
fixed q, and the CQ search (the probe compiled with an int32 q).  The
all-intra run compiles the reference's partitioned chunk, the one whole-frame
compile the file adds.  The scene batch over two worker processes (the
CLI's --workers path on several devices) is held to the same TUs, with and
without the 2-layer pyramid, which the batch does not read."""

import functools
import json
import os
import re
import shlex

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import av1tpu.coding
from av1tpu.cli import encode_clip as jax_encode_clip
from av1tpu.models import cq as ref_cq
from av1tpu.models import inter_v as ref_inter
from av1tpu.models import intra_wave as ref_wave
from av1tpu.models.deblock_tpu import lf_levels
from av1tpu.models.intra_v import fuse_planes
from av1tpu.utils.yuv import Clip, synthetic_clip
from av1tpu_torch._build import packer_lib_path
from av1tpu_torch.cli import encode_clip, main
from av1tpu_torch.models import cq as port_cq
from av1tpu_torch.models import inter_v as port_inter
from av1tpu_torch.models import intra_wave as port_wave
from tests.test_inter_pipeline import moving_clip
from tests.test_torch_threads import single_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, Q = 64, 128, 120
KW = dict(metric="psnr", partitions=True, scene_threshold=2.5, gop=True,
          chunk=4)


def _two_scene_clip():
    a = moving_clip(W, H, 5, seed=73, dy=1, dx=2)
    b = moving_clip(W, H, 5, seed=99, dy=0, dx=3)
    return Clip(y=np.concatenate([a.y, 255 - b.y]),
                u=np.concatenate([a.u, b.u]),
                v=np.concatenate([a.v, b.v]))


def _jax_encode(clip, **kw):
    """av1tpu.cli.encode_clip with the port's packer build: the reference's
    Packer() reads native/build/, which the tests do not build (same
    source, native/coding/pack.cpp)."""
    packer = functools.partial(av1tpu.coding.Packer,
                               lib_path=packer_lib_path())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(av1tpu.coding, "Packer", packer)
        return jax_encode_clip(clip, Q, **dict(KW, **kw))


def _differing(gs, ws):
    assert len(gs) == len(ws)
    return [i for i, (a, b) in enumerate(zip(gs, ws)) if a != b]


# stats that differ between two runs of one encode only by the clock
_TIMED = ("encode_seconds", "encode_fps", "stage_seconds")


def _same_stats(gst, wst):
    assert set(gst) == set(wst)
    assert set(gst["stage_seconds"]) <= set(wst["stage_seconds"])
    for k in set(wst) - set(_TIMED):
        assert gst[k] == wst[k], k


@pytest.fixture(scope="module")
def encodes():
    clip = _two_scene_clip()
    want = _jax_encode(clip)
    got = encode_clip(clip, Q, device="cpu", **KW)
    return want, got


def test_quality_tus_byte_identical(encodes):
    (ws, _), (gs, _) = encodes
    assert len(gs) == len(ws) == 10
    assert _differing(gs, ws) == []


def test_quality_stats_match(encodes):
    (_, wst), (_, gst) = encodes
    assert set(gst) == set(wst)
    assert set(gst["stage_seconds"]) <= set(wst["stage_seconds"])
    for k in ("frames", "bytes", "width", "height", "qindex", "scenes",
              "keyframes", "psnr_y", "metric_score"):
        assert gst[k] == wst[k], k
    assert gst["scenes"] == 2


def test_quality_chunk3_handover_emits_the_same_tus(encodes):
    """A full chunk and a 1-frame tail per scene on the port's side: the
    recon, the MV field and the CDF chain cross a chunk bound."""
    (ws, _), _ = encodes
    gs, gst = encode_clip(_two_scene_clip(), Q, device="cpu",
                          **dict(KW, chunk=3))
    assert [i for i, (a, b) in enumerate(zip(gs, ws)) if a != b] == []
    assert len(gs) == len(ws) and gst["scenes"] == 2


@pytest.fixture(scope="module")
def layered(encodes):
    """--layers 2 on both sides (chunk 4): per scene the keyframe, then
    non-reference, reference, non-reference, reference."""
    kw = dict(layers=2, nr_q_delta=12)
    return (_jax_encode(_two_scene_clip(), **kw),
            encode_clip(_two_scene_clip(), Q, device="cpu", **dict(KW, **kw)))


def test_layered_tus_and_stats_match_jax(layered, encodes):
    (ws, wst), (gs, gst) = layered
    assert _differing(gs, ws) == []
    _same_stats(gst, wst)
    # the pyramid's frames differ from the single-layer stream's, the
    # keyframes do not
    one_layer = encodes[0][0]
    assert _differing(ws, one_layer) == [1, 2, 3, 4, 6, 7, 8, 9]


def test_layered_chunk3_handover_emits_the_same_tus(layered):
    """Chunks of 3 and a 1-frame tail: the parity, the recon, the MV field
    and the CDF chain cross a chunk bound."""
    (ws, _), _ = layered
    gs, gst = encode_clip(_two_scene_clip(), Q, device="cpu",
                          **dict(KW, chunk=3, layers=2))
    assert _differing(gs, ws) == [] and gst["scenes"] == 2


def test_default_metric_emits_the_psnr_runs_tus(encodes):
    """The CLI's default metric, tpu_vmaf, at a fixed q: the metric changes
    the stats alone, and the score is filed under its name.  The score is
    the reference metric of the port's probe recon (the probe encode is
    held bit for bit above)."""
    from av1tpu.metrics.quality import tpu_vmaf as ref_vmaf
    from av1tpu_torch.cli import _pad_plane

    (ws, wst), _ = encodes
    kw = {k: v for k, v in KW.items() if k != "metric"}
    gs, gst = encode_clip(_two_scene_clip(), Q, device="cpu", **kw)
    assert _differing(gs, ws) == []
    assert "tpu_vmaf" in gst and "metric_score" not in gst
    _same_stats({k: v for k, v in gst.items() if k != "tpu_vmaf"},
                {k: v for k, v in wst.items() if k != "metric_score"})
    clip = _two_scene_clip()
    per_scene = []
    for mid in (2, 7):      # each 5-frame scene probes its middle frame
        planes = [_pad_plane(p[mid].astype(np.int32), *s) for p, s in
                  ((clip.y, (H, W)), (clip.u, (H // 2, W // 2)),
                   (clip.v, (H // 2, W // 2)))]
        rec = port_cq._probe_recon(*[torch.from_numpy(p) for p in planes],
                                   Q, 8, True)
        per_scene.append(float(ref_vmaf(jnp.asarray(planes[0]),
                                        jnp.asarray(rec.numpy()))))
    assert 0.0 < gst["tpu_vmaf"] <= 100.0
    assert abs(gst["tpu_vmaf"] - sum(per_scene) / 2) <= 1e-3 + 5e-4


def test_cq_search_partitions_matches_jax(encodes):
    """cq_search_multi over the first scene's three sampled frames (the
    CLI's target_quality probe set), partitions=True, PSNR: the same q, and
    the score to 1e-4 dB."""
    from av1tpu_torch.cli import _pad_plane

    clip = _two_scene_clip()
    frames = [[_pad_plane(p[i].astype(np.int32), *s) for p, s in
               ((clip.y, (H, W)), (clip.u, (H // 2, W // 2)),
                (clip.v, (H // 2, W // 2)))] for i in (0, 2, 4)]
    want = ref_cq.cq_search_multi(
        [tuple(jnp.asarray(p) for p in f) for f in frames], 40.0,
        metric="psnr", bit_depth=8, partitions=True)
    got = port_cq.cq_search_multi(
        [tuple(torch.from_numpy(p) for p in f) for f in frames], 40.0,
        metric="psnr", bit_depth=8, partitions=True)
    assert got[0] == want[0] and Q < got[0] < 255
    assert abs(got[1] - want[1]) <= 1e-4


def test_all_intra_quality_tus_and_stats_match_jax(encodes):
    """gop=False with the quality preset: every frame a partitioned
    keyframe, a probe per scene (its PSNR is the stats' psnr_y)."""
    ws, wst = _jax_encode(_two_scene_clip(), gop=False)
    gs, gst = encode_clip(_two_scene_clip(), Q, device="cpu",
                          **dict(KW, gop=False))
    assert _differing(gs, ws) == []
    _same_stats(gst, wst)
    assert gst["keyframes"] == 10 and gst["scenes"] == 2


def test_quality_beats_fast_on_bytes(encodes):
    _, (_, gst) = encodes
    _, fast = encode_clip(_two_scene_clip(), Q, device="cpu",
                          **dict(KW, partitions=False))
    assert gst["bytes"] < fast["bytes"]


def test_cli_quality_preset_writes_ivf(tmp_path, capsys):
    from av1tpu.utils.yuv import write_y4m

    src = tmp_path / "in.y4m"
    out = tmp_path / "out.ivf"
    write_y4m(str(src), synthetic_clip(W, H, 3, seed=4))
    assert main(["encode", "-i", str(src), "-o", str(out), "--preset",
                 "quality", "--metric", "psnr", "--qindex", "100", "--chunk",
                 "2", "--device", "cpu"]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["frames"] == 3 and stats["output"] == str(out)
    data = out.read_bytes()
    assert data[:4] == b"DKIF" and len(data) > stats["bytes"]


def _daemon_argv(y4m, ivf, qindex=72, workers=4):
    """native/daemon/encoder.cpp's default command template with av1tpu
    replaced by av1tpu_torch, as the daemon expands it."""
    with open(os.path.join(REPO, "native", "daemon", "encoder.cpp")) as f:
        src = f.read()
    body = src[src.index("std::string default_encode_cmd()"):]
    tmpl = "".join(re.findall(r'"([^"]*)"', body[: body.index(";")]))
    cmd = (tmpl.replace("{input}", shlex.quote(y4m))
           .replace("{output}", shlex.quote(ivf))
           .replace("{qindex}", str(qindex))
           .replace("{workers}", str(workers)))
    argv = shlex.split(cmd)
    assert argv[:4] == ["python3", "-m", "av1tpu.cli", "encode"]
    return argv[3:]


def test_daemon_command_runs_with_the_reference_defaults(tmp_path, capsys):
    """The daemon's command: quality preset, chunk 4, tpu_vmaf, --workers 4
    on one device (the single-device path); progress lines, then the
    stats line with the score filed under tpu_vmaf."""
    from av1tpu.utils.yuv import write_y4m

    y4m, ivf = str(tmp_path / "in.y4m"), str(tmp_path / "out.ivf")
    write_y4m(y4m, synthetic_clip(96, 64, 3, seed=21))
    assert main(_daemon_argv(y4m, ivf) + ["--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    progress, stats = lines[:-1], lines[-1]
    assert [p["frames_encoded"] for p in progress] == [1, 3]
    assert progress[-1]["progress"] == 1.0
    assert stats["frames"] == 3 and stats["keyframes"] == 1
    assert 0.0 < stats["tpu_vmaf"] <= 100.0 and "metric_score" not in stats
    assert stats["psnr_y"] > 30.0 and stats["output"] == ivf
    with open(ivf, "rb") as f:
        assert f.read(4) == b"DKIF"


# ---- the scene batch (--workers over several devices) ----

# The reference's batch branch on this file's clip and arguments
# (av1tpu.cli.encode_clip with workers=8 on the 8-device virtual CPU mesh,
# run once: its sharded compile takes minutes): its TUs are the workers=1
# TUs of `encodes`, with and without layers=2 (the batch codes every inter
# frame as a reference frame), and its PSNR is each scene's last recon
# against its last source.
BATCH_PSNR_Y = 41.142
BATCH_STAGES = {"scene_detect", "probe", "tfilter"}


@pytest.fixture
def two_devices(monkeypatch):
    """The CLI sees two devices; its workers run on [cpu, cpu]."""
    import av1tpu_torch.cli as cli
    from av1tpu_torch.parallel import gop

    monkeypatch.setattr(cli, "_device_count", lambda dev: 2)
    # a hung worker fails the test instead of running into the suite's clock
    monkeypatch.setattr(gop, "ScenePool",
                        functools.partial(gop.ScenePool, timeout=300.0))


def test_scene_batch_tus_match_jax(encodes, two_devices):
    (ws, wst), _ = encodes
    gs, gst = encode_clip(_two_scene_clip(), Q, device="cpu", workers=2,
                          **KW)
    assert _differing(gs, ws) == []
    assert set(gst) == set(wst)
    for k in ("frames", "bytes", "width", "height", "qindex", "scenes",
              "keyframes", "metric_score"):
        assert gst[k] == wst[k], k
    assert gst["psnr_y"] == BATCH_PSNR_Y != wst["psnr_y"]
    # the parent's stages are the reference batch's; the workers' are
    # filed under the single-device path's names
    assert set(gst["stage_seconds"]) == BATCH_STAGES | {
        "key_device", "cdef", "inter_dispatch", "inter_fetch"}
    assert set(gst["stage_seconds"]) <= set(wst["stage_seconds"])


def test_scene_batch_ignores_layers_as_jax_does(encodes, layered,
                                                two_devices):
    """--layers 2 on the batch emits the single-layer stream, as the
    reference's batch does: its frames differ from the layered stream's
    where the pyramid's do."""
    (ws, _), _ = encodes
    (lws, _), _ = layered
    gs, gst = encode_clip(_two_scene_clip(), Q, device="cpu", workers=2,
                          layers=2, **KW)
    assert _differing(gs, ws) == []
    assert _differing(gs, lws) == [1, 2, 3, 4, 6, 7, 8, 9]
    assert gst["psnr_y"] == BATCH_PSNR_Y


# ---- the reference's jitted entry points at the slice's shapes ----

def _planes(seed, n=1):
    c = synthetic_clip(W, H, n, seed=seed)
    return [[p[k].astype(np.int32) for p in (c.y, c.u, c.v)]
            for k in range(n)]


@pytest.mark.parametrize("q", [40, 150])
def test_probe_quality_partitions_matches_jax(encodes, q):
    """models/cq.py:probe_quality(partitions=True), to 1e-4 dB (log10 and
    the mean's summation order)."""
    planes = _planes(seed=q)[0]
    want = float(ref_cq.probe_quality(*[jnp.asarray(p) for p in planes],
                                      jnp.int32(q), metric="psnr",
                                      bit_depth=8, partitions=True))
    tp = [torch.from_numpy(p) for p in planes]
    got = float(port_cq.probe_quality(*tp, q, metric="psnr", bit_depth=8,
                                      partitions=True))
    assert abs(got - want) <= 1e-4
    assert port_cq.probe_quality_multi([tuple(tp)], q, metric="psnr",
                                       bit_depth=8, partitions=True) == got


@pytest.mark.parametrize("q,gate", [(40, 22.5), (110, 0.0)])
def test_wave_key_recon_matches_jax(encodes, q, gate):
    """encode_intra_wave_key_recon as the CLI calls it (lam_scale 0.3, no
    deblock, the default transport capacity): compact buffer, its split
    (count, bitmap, values, modes, tx depths) and the fused recon."""
    fused = fuse_planes(*_planes(seed=q + 1)[0])
    kw = dict(cap=163840, lf=(0, 0, 0), lam_scale=0.3, noise_gate=gate)
    wbuf, wrec = ref_wave.encode_intra_wave_key_recon(
        jnp.asarray(fused), q, H, W, **kw)
    gbuf, grec = port_wave.encode_intra_wave_key_recon(
        torch.from_numpy(fused), q, H, W, **kw)
    assert gbuf.dtype == torch.int16 and grec.dtype == torch.int32
    assert np.array_equal(gbuf.numpy(), np.asarray(wbuf))
    assert np.array_equal(grec.numpy(), np.asarray(wrec))
    a = ref_wave.split_compact_wave(np.asarray(wbuf), H, W)
    b = port_wave.split_compact_wave(gbuf.numpy(), H, W)
    assert a[0] == b[0] > 0
    for x, z in zip(a[1:], b[1:]):
        assert np.array_equal(x, z)
    assert len(np.unique(b[3])) >= 2            # several modes
    if q <= 60:
        assert len(np.unique(b[4])) >= 2        # and tx depths


LF = lf_levels(Q)[0:1] + lf_levels(Q)[2:]       # the slice's inter levels
CDEF = (2, 1, 2, 1)
GATE = 6.25


@pytest.fixture(scope="module")
def chunk(encodes):
    """One 4-frame chunk as the CLI's first chunk of a scene (no carried MV
    field), with GOLDEN, deblock, CDEF and the noise gate."""
    f = _planes(seed=33, n=5)
    key = [np.clip((p // 2) * 2 + 1, 0, 255).astype(np.int32) for p in f[0]]
    ref0 = np.concatenate([p.ravel() for p in key]).astype(np.int32)
    frames = np.stack([fuse_planes(*f[k]) for k in range(1, 5)])
    wb, wref, wmv = ref_inter.encode_gop_chunk_part(
        jnp.asarray(frames), jnp.asarray(ref0), Q, H, W, cap=131072, lf=LF,
        cdef_s=jnp.asarray(np.asarray(CDEF, np.int32)),
        gld_fused=jnp.asarray(ref0), prev_mv=None, noise_gate=GATE)
    gb, gref, gmv = port_inter.encode_gop_chunk_part(
        torch.from_numpy(frames), torch.from_numpy(ref0), Q, H, W,
        cap=131072, lf=LF, cdef_s=CDEF, gld_fused=torch.from_numpy(ref0),
        prev_mv=None, noise_gate=GATE)
    return np.asarray(wb), np.asarray(wref), np.asarray(wmv), gb, gref, gmv


@pytest.mark.parametrize("k", range(4))
def test_gop_chunk_part_buffers_match_jax(chunk, k):
    """Whole buffers are equal: the port's compaction reproduces the
    reference's stable key sort, discarded tail included; so are the used
    prefix, its fetch and its split."""
    wb, _, _, gb, _, _ = chunk
    g = gb[k].numpy()
    assert g.dtype == np.int16 and g.shape == wb[k].shape
    lay = port_inter.inter_part_layout(H, W)
    assert lay == ref_inter.inter_part_layout(H, W)
    assert len(g) == lay["total"]
    need = port_inter.inter_part_prefix_len(g[:8], H, W)
    assert need == ref_inter.inter_part_prefix_len(wb[k][:8], H, W)
    assert np.array_equal(g[:need], wb[k][:need])      # the used prefix
    assert np.array_equal(g, wb[k])                    # and the tail
    a = ref_inter.split_compact_inter_part(wb[k], H, W)
    state = {}
    pre = port_inter.fetch_inter_part_prefix(gb[k], H, W, state)
    assert len(pre) == need and state["guess"] >= need
    b = port_inter.split_compact_inter_part(pre, H, W)
    assert a[0] == b[0] > 0
    for x, z in zip(a[1:], b[1:]):
        assert x.dtype == z.dtype and np.array_equal(x, z)
    # an undershooting guess refetches the tail
    pre2 = port_inter.fetch_inter_part_prefix(gb[k], H, W,
                                              {"guess": lay["fixed"] + 3})
    assert np.array_equal(pre2, pre)


def test_gop_chunk_part_carry_matches_jax(chunk):
    _, wref, wmv, _, gref, gmv = chunk
    assert gref.dtype == torch.int32 and gmv.dtype == torch.int32
    assert np.array_equal(gref.numpy(), wref)
    assert np.array_equal(gmv.numpy(), wmv)


def test_gop_chunk_part_case_is_exercised(chunk):
    splits = [ref_inter.split_compact_inter_part(chunk[0][k], H, W)
              for k in range(4)]
    assert any(s[6].any() for s in splits)          # GOLDEN blocks
    assert any(s[3].any() for s in splits)          # 8x8 splits
    assert any(not s[4].all() for s in splits)      # 32x32 merges
