#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (av1tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its seconds; any failure raises and the script
exits non-zero:

1. environment: torch version, the card's name and power limit, TF32 off;
2. build: the CUDA kernels (one nvcc per source, sm_90a), the C++ packer
   and, where pkg-config finds libavcodec, libavformat and libavutil,
   av1_tool and the daemon, from the sources in this checkout, side by
   side;
3. kernel vs plain: transform_quantize at the main path's shapes, held
   against its plain PyTorch version (levels may flip only at a rounding
   boundary, by 1; dq exact), both timed (time_tq): device time apart
   from the host, the single-call event pair, the host time per call, and
   the bound;
4. parity: the port's encode_clip on the card and on the CPU, on a small
   two-scene clip;
5. slice: the fast-preset GOP encode at 1920x1080 (one warm-up run, one
   timed run) with the kernel's launch counter read around the timed run
   (561 launches: three plane stacks of 187 steps);
6. quality parity: phase 4 again with the quality preset
   (partitions=True: partition probe, wavefront keyframe, partitioned
   inter step);
7. quality slice: the quality-preset GOP encode of the same 1920x1080 clip
   (one warm-up run, one timed run).  The kernel's launch counter is set
   to 0 before the timed run and read after it: 120 launches, one per
   16x16 column of the first block row of the one probed frame's luma
   plane (the probe's first-row chain is the kernel's function; every
   other residual coder of this path prunes with rd_zero, which reads the
   coefficients, and so has no kernel yet).  The wavefront keyframe's
   two kernels launch once per diagonal each (254 at 1088x1920).  Spies
   assert that the keyframe recon, the inter carry (recon and MV field)
   and GOLDEN live on the card, and the bytes must come out below the fast
   preset's.
7b. wave kernels vs plain, on phase 7's keyframe with the CLI's arguments
   (wave_vs_plain): (a) the plain keyframe on the card with the two
   kernels run at every diagonal from its carried state: recon identical
   wherever pick, tx depth and levels agree, levels within 1 where the
   decisions agree, at most 0.1% of the 8,160 lanes with another pick or
   tx depth (each printed with the plain costs of both choices); (b) the
   kernels' keyframe alone: PSNR-Y within 0.05 dB and nonzero levels
   within 1% of the plain one; (c) its time (events, and device time
   queued behind a sleep), each kernel per keyframe and per launch at the
   largest lane count, the plain versions' time there, and the bounds;
8. modes parity: phase 4 again (quality preset) in the command's other
   modes: the default metric, tpu_vmaf (its score within 1e-3, and once
   more under torch.backends.cudnn.flags(allow_tf32=True): the metric
   reads no global flag), the CQ search on tpu_vmaf (the same q), the
   2-layer pyramid, and the all-intra chunks of both presets;
9. the daemon's command at 1080p: native/daemon/encoder.cpp's template,
   `encode -i IN.y4m -o OUT.ivf --qindex 72 --workers 4` with every other
   option at its default (quality preset, chunk 4, tpu_vmaf), through
   av1tpu_torch.cli.main on a 16-frame y4m: progress lines, the stats line
   (tpu_vmaf in [0, 100], PSNR-Y >= 30 dB), 16 IVF frames, the keyframe
   recon and the inter carry on the card, 120 launches per scene (the
   probe's first-row luma chain).  Then the metric pass alone at 1088x1920
   (tpu_vmaf, SSIM, PSNR), timed and held against the CPU;
10. the same command with --layers 2: bytes at most 1.02 times phase 9's
   (the bound tests/test_layers.py holds the reference to), PSNR-Y >= 30,
   120 launches;
11. the same command with --all-intra --max-frames 4, each preset: the
   kernel launches equal the count derived from the code (fast: 187 per
   frame, the keyframe's U+V stack, plus the probe's 374; quality: 120 per
   frame plus the probe's 120);
12. scene batch: encode_clip(workers=2) on the batch path (parallel/gop.py,
   one worker process per device).  (a) On the two-scene clip (quality
   preset), its TUs must equal workers=1 on the card and the CPU run of
   phase 6.  With two or more GPUs the command's own routing deals the
   scenes to two GPUs; with one, the card is listed twice, so two worker
   processes share it.  (b) A two-scene 1920x1080 clip (a forced cut, 2
   frames per scene, q 72, quality preset), workers=1 against the batch
   on two workers, after a warm-up at the small size in the parent and in
   each worker: encode seconds, scenes per second, key_device, bytes
   (equal), peak memory per device and process; 120 transform_quantize
   launches per scene, all in the parent's probe, and 254 of each wave
   kernel per scene's keyframe, in the workers (in the parent at
   workers=1);
13. container and daemon.  (a) Where pkg-config finds libavcodec,
   libavformat and libavutil: the daemon's cycle, a 640x360 8-frame mpeg4
   mkv with a tone track in a library directory, `av1tpu-daemon --once`
   with deploy/config.torch.toml's template (the interpreter spelled as
   this one's; PYTHONPATH the checkout): the job's status and stage, the
   output's bytes, psnr_y and tpu_vmaf; the replaced file probed (AV1
   video, the tone) and decoded (8 frames).  Then, on every host, the same
   command in this process at --chunk 1 with ReconSpy on the keyframe
   recon after CDEF and each inter frame's, on that mkv (on the y4m of the
   same clip without libav): 40 launches per probed scene (the 640-wide
   first block row); with libav its 8 TUs must equal the replaced file's
   video (remuxed to IVF), and its libdav1d decode, frame count and
   decoded-vs-recon differing pixels are printed, not failed on: the
   quality preset keeps the reference's faults (ROADMAP queue 3: sub_chain's
   prediction, and streams of this clip the decoders refuse).  (b) The
   fast preset at 1920x1080, 8 frames, --chunk 1, IVF, with ReconSpy: 561
   launches per scene (at chunk 1 the scene detector's minimum scene length
   is 1, and this clip has 2 scenes); with libav the libdav1d decode must
   equal the card's recon in every pixel of every plane of the coded
   1920x1088 frame.  Each run leaves its IVF, its recon and its stats in
   $AV1TPU_SMOKE_OUT (a temporary directory when unset), where
   tools/card_decode_check.py decodes them on a host that has libav.

Every path's launches of the two wavefront kernels are asserted equal to
its wavefront keyframes times their diagonals (models/intra_wave.py:
wave_diagonals, from the schedule): one 1080p keyframe per scene in
phases 7, 9, 10 and 12 (b), the 128x64 clip's two scenes in the workers of
12 (a), the 640x360 clip's scenes at its coded 384x640 in 13 (a); none on
the fast and all-intra paths.  The scene batch's workers report their
counts with each scene.

The line before the last is the kernels' JSON record (launches summed over
the timed runs, with the count of each path beside it); the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX or av1tpu.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import io
import json
import os
import shlex
import subprocess
import sys
import tempfile
import time

import numpy as np

QINDEX = 72
CHUNK = 8
FRAMES = 48
CLI_FRAMES = 16        # the daemon-command phases' 1080p clip
INTRA_FRAMES = 4       # the all-intra phase's frames
CQ_TARGET = 90.0       # tpu_vmaf target of the CQ parity run
SHAPES = ((120, 256), (1, 256), (240, 64), (2, 64))
CONTAINER_W, CONTAINER_H = 640, 360   # phase 13 (a)'s mkv
CONTAINER_FRAMES = 8                   # frames of both phase 13 clips
DECODE_W, DECODE_H = 1920, 1080        # phase 13 (b)'s clip
REPO = os.path.dirname(os.path.abspath(__file__))


def _phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


def kernel_wrappers() -> tuple:
    """The hand kernels' wrappers, each with its launch counter."""
    from av1tpu_torch.kernels.intra_wave import wave_luma16, wave_sub_chroma
    from av1tpu_torch.kernels.transform_quant import transform_quantize

    return transform_quantize, wave_luma16, wave_sub_chroma


def zero_launches() -> None:
    for k in kernel_wrappers():
        k.launches = 0


def read_launches() -> dict:
    """{kernel name: launches since zero_launches}."""
    return {k.__name__: k.launches for k in kernel_wrappers()}


def add_launches(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in {*a, *b}}


def assert_wave(launches: dict, keyframes: int, h: int | None = None,
                w: int | None = None) -> None:
    """Each wavefront kernel launched once per diagonal of each of the
    path's `keyframes` wavefront keyframes coded at h x w (default: the
    padded 1080p frame; the count from the schedule,
    models/intra_wave.py:_diagonals)."""
    from av1tpu_torch.models.intra_wave import wave_diagonals

    want = keyframes * wave_diagonals(h or ROWS * 16, w or COLS * 16)
    got = (launches["wave_luma16"], launches["wave_sub_chroma"])
    assert got == (want, want), (got, want)


def moving_clip(w: int, h: int, n: int, seed: int, dy: int, dx: int):
    """Global pan: frame k is a window shifted k*(dy, dx) (the helper of
    tests/test_inter_pipeline.py, rebuilt here without JAX)."""
    from av1tpu_torch.utils.yuv import Clip, synthetic_clip

    big = synthetic_clip(w + 96, h + 96, 1, seed=seed)
    ys, us, vs = [], [], []
    for k in range(n):
        oy, ox = 48 - k * dy, 48 - k * dx
        ys.append(big.y[0][oy : oy + h, ox : ox + w].copy())
        us.append(big.u[0][oy // 2 : (oy + h) // 2,
                           ox // 2 : (ox + w) // 2].copy())
        vs.append(big.v[0][oy // 2 : (oy + h) // 2,
                           ox // 2 : (ox + w) // 2].copy())
    return Clip(y=np.stack(ys), u=np.stack(us), v=np.stack(vs))


def two_scene_clip():
    """The multi-scene clip of tests/test_cli_gop.py:77-86 (128x64, 10
    frames: a pan, then an inverted second pan)."""
    from av1tpu_torch.utils.yuv import Clip

    a = moving_clip(128, 64, 5, seed=73, dy=1, dx=2)
    b = moving_clip(128, 64, 5, seed=99, dy=0, dx=3)
    return Clip(y=np.concatenate([a.y, 255 - b.y]),
                u=np.concatenate([a.u, b.u]),
                v=np.concatenate([a.v, b.v]))


def _median_ms(torch, fn, n: int = 50) -> float:
    """Median device time of fn() over n runs, CUDA events per run."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12      # fp32 outside the tensor cores
PEAK_BYTES = 3.35e12         # HBM3
# a sleep kernel long enough (~50 ms at the boost clock) for the host to
# enqueue every timed batch below behind it
SLEEP_CYCLES = 100_000_000


def tq_bound_us(b: int, n2: int) -> tuple[float, str]:
    """Least time of transform_quantize at (B, N2) on the card: the fp32
    product's 2*B*N2^2 operations at the fp32 peak, or its bytes (resid,
    fwdt, step, q, cap read once; int16 levels and int32 dq written once)
    at the memory rate, whichever is larger."""
    flops = 2 * b * n2 * n2
    nbytes = 4 * b * n2 + 4 * n2 * n2 + 3 * 4 * n2 + (2 + 4) * b * n2
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e6,
            "operations" if t_ops >= t_bytes else "bytes")


def device_us(torch, fn, n: int, sleep_cycles: int = SLEEP_CYCLES) -> float:
    """Device time of one fn() in microseconds, apart from the host: CUDA
    events around n calls queued back to back behind a sleep kernel, so the
    device runs them without waiting for the host; L2 stays warm, as in
    the row loop that reuses one fwdt.  Raises if the host took longer to
    enqueue the calls than the sleep lasted (the queue would have run dry)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    s0, s1, e = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s0.record()
    torch.cuda._sleep(sleep_cycles)
    s1.record()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    enqueue_s = time.perf_counter() - t
    e.record()
    e.synchronize()
    if enqueue_s * 1e3 >= s0.elapsed_time(s1):
        raise RuntimeError("the host enqueued slower than the sleep kernel "
                           "ran: the device time would hold host gaps")
    return s1.elapsed_time(e) * 1e3 / n


def host_us(torch, fn, n: int = 1000) -> float:
    """Host time of one fn() in microseconds: perf_counter around n calls
    with no sync between them."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt * 1e6 / n


def time_tq(torch, kernel, plain, b: int, n2: int) -> dict:
    """Phase 3's numbers at one shape: device_us (200 queued launches),
    call_us (median of 50 event pairs around one call each, host gap
    included) and host_us (1000 calls) for the kernel; the same for the
    plain version unless it is None (30 queued calls: each launches about
    14 kernels, and the device's launch queue holds about a thousand); and
    the bound with the roofline share bound_us / device_us."""
    bound, by = tq_bound_us(b, n2)
    rec = {"b": b, "n2": n2,
           "device_us": device_us(torch, kernel, 200),
           "call_us": _median_ms(torch, kernel) * 1e3,
           "host_us": host_us(torch, kernel)}
    if plain is not None:
        rec.update(plain_device_us=device_us(torch, plain, 30),
                   plain_call_us=_median_ms(torch, plain) * 1e3,
                   plain_host_us=host_us(torch, plain))
    rec.update(bound_us=bound, bound_by=by, roofline=bound / rec["device_us"])
    return rec


def kernel_vs_plain(torch):
    """Phase 3: transform_quantize against its plain version at SHAPES, and
    timed (time_tq).  Returns the per-shape records."""
    from av1tpu_torch.kernels.transform_quant import (
        TQPlane, count_level_flips, transform_quantize, transform_quantize_ref,
    )
    from av1tpu_torch.models.intra_v import _plane_params
    from av1tpu_torch.state import tables

    dev = torch.device("cuda")
    rng = np.random.RandomState(2024)
    recs = []
    for b, n2 in SHAPES:
        n = int(round(n2 ** 0.5))
        tx = 0 if n == 16 else 1       # luma DCT_DCT, chroma ADST_DCT
        resid = torch.as_tensor(rng.randint(-255, 256, size=(b, n2)).astype(
            np.float32), device=dev)
        fwdt = tables(dev).fwdt(n, tx)
        step, q, cap = (t[None] for t in _plane_params(QINDEX, n, 8, dev))
        plane = TQPlane(fwdt, step, q, cap)
        lv, dq = transform_quantize(resid, plane)
        lv_ref, _ = transform_quantize_ref(resid, plane)
        torch.cuda.synchronize()
        flips = count_level_flips(lv, dq, lv_ref, resid, fwdt, step, q)
        rec = time_tq(torch, lambda: transform_quantize(resid, plane),
                      lambda: transform_quantize_ref(resid, plane), b, n2)
        rec.update(flips=flips,
                   max_abs_err=int((lv.int() - lv_ref.int()).abs().max()))
        print(f"transform_quantize B={b} N2={n2}: " + " ".join(
            f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in rec.items() if k not in ("b", "n2")), flush=True)
        recs.append(rec)
    return recs


def parity(torch, name: str, **kw):
    """Phases 4, 6 and 8: the port on the card against the port on the CPU
    on the two-scene clip, with encode_clip's arguments kw.  Returns the
    card's and the CPU's (streams, stats)."""
    from av1tpu_torch.cli import encode_clip

    clip = two_scene_clip()
    kw = dict(dict(chunk=4, metric="psnr", partitions=False,
                   scene_threshold=2.5, gop=True), **kw)
    s_gpu, st_gpu = encode_clip(clip, 120, device="cuda", **kw)
    s_cpu, st_cpu = encode_clip(clip, 120, device="cpu", **kw)
    same = sum(a == b for a, b in zip(s_gpu, s_cpu))
    key = kw["metric"] if kw["metric"] != "psnr" else "metric_score"
    print(f"{name}: tus gpu={len(s_gpu)} cpu={len(s_cpu)} identical={same} "
          f"bytes gpu={st_gpu['bytes']} cpu={st_cpu['bytes']} "
          f"psnr_y gpu={st_gpu['psnr_y']} cpu={st_cpu['psnr_y']} "
          f"{key} gpu={st_gpu[key]} cpu={st_cpu[key]} "
          f"qindex gpu={st_gpu['qindex']} cpu={st_cpu['qindex']}",
          flush=True)
    assert len(s_gpu) == len(s_cpu) == clip.num_frames
    assert st_gpu["scenes"] == st_cpu["scenes"]
    assert abs(st_gpu["psnr_y"] - st_cpu["psnr_y"]) <= 0.05
    assert abs(st_gpu["bytes"] - st_cpu["bytes"]) <= 0.01 * st_cpu["bytes"]
    if key == "tpu_vmaf":
        assert abs(st_gpu[key] - st_cpu[key]) <= 1e-3, key
    return (s_gpu, st_gpu), (s_cpu, st_cpu)


def modes_parity(torch) -> None:
    """Phase 8: the quality preset's other modes on the card against the
    CPU (parity), and the default metric once more under cuDNN's TF32."""
    from av1tpu_torch.cli import encode_clip

    q_kw = dict(metric="tpu_vmaf", partitions=True)
    (s_gpu, st_gpu), _ = parity(torch, "default metric parity", **q_kw)
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=True):
        s_tf, st_tf = encode_clip(two_scene_clip(), 120, device="cuda",
                                  chunk=4, **q_kw)
    print(f"default metric under cudnn allow_tf32: tpu_vmaf "
          f"{st_tf['tpu_vmaf']} (without {st_gpu['tpu_vmaf']}), identical "
          f"tus {sum(a == b for a, b in zip(s_tf, s_gpu))}", flush=True)
    assert abs(st_tf["tpu_vmaf"] - st_gpu["tpu_vmaf"]) <= 1e-3
    (_, st_gpu), (_, st_cpu) = parity(
        torch, "cq tpu_vmaf parity", target_quality=CQ_TARGET, **q_kw)
    assert st_gpu["qindex"] == st_cpu["qindex"]
    parity(torch, "layers 2 parity", partitions=True, layers=2)
    parity(torch, "all-intra quality parity", partitions=True, gop=False)
    parity(torch, "all-intra fast parity", partitions=False, gop=False)


def _timed_slice(torch, clip, name: str, partitions: bool):
    """One warm-up and one timed 1080p encode with the kernels' launch
    counts set to 0 just before the timed run and read just after.
    Returns (streams, stats, launches by kernel)."""
    from av1tpu_torch.cli import encode_clip

    kw = dict(chunk=CHUNK, metric="psnr", gop=True, partitions=partitions,
              device="cuda")
    t = time.perf_counter()
    encode_clip(clip, QINDEX, **kw)                      # warm-up
    torch.cuda.synchronize()
    print(f"{name} warm-up: {time.perf_counter() - t:.3f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    streams, stats = encode_clip(clip, QINDEX, **kw)
    torch.cuda.synchronize()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    print(f"{name} stats:", json.dumps(stats), flush=True)
    print(f"{name}: frames={clip.num_frames} fps={stats['encode_fps']} "
          f"bytes={stats['bytes']} psnr_y={stats['psnr_y']} "
          f"launches={launches} max_memory_allocated={peak}", flush=True)
    assert len(streams) == clip.num_frames
    assert all(len(s) > 0 for s in streams)
    assert stats["scenes"] == 1, stats["scenes"]
    assert stats["psnr_y"] >= 30.0, stats["psnr_y"]
    return streams, stats, launches


ROWS, COLS = 1088 // 16, 1920 // 16       # the padded 1080p block grid


def slice_1080p(torch, clip):
    """Phase 5.  Returns (the kernels' launches in the timed run, the
    stats): transform_quantize once per first-row column and per later
    block row, for the probe's luma, the probe's U and V together and the
    keyframe's U and V together (the keyframe's luma takes the RDO path,
    which has no kernel); no wavefront kernel."""
    import av1tpu_torch.models.inter_v as inter_v
    import av1tpu_torch.models.intra_v as intra_v

    # record where the keyframe recon and the inter carry live
    seen = {"key": set(), "carry": set()}
    key_fn, gop_fn = (intra_v.encode_intra_v_key_recon,
                      inter_v.encode_gop_chunk)

    def key_spy(*a, **k):
        buf, recon = key_fn(*a, **k)
        seen["key"].add(recon.device.type)
        return buf, recon

    def gop_spy(*a, **k):
        bufs, ref = gop_fn(*a, **k)
        seen["carry"].add(ref.device.type)
        return bufs, ref

    intra_v.encode_intra_v_key_recon = key_spy
    inter_v.encode_gop_chunk = gop_spy
    try:
        _, stats, launches = _timed_slice(torch, clip, "slice", False)
    finally:
        intra_v.encode_intra_v_key_recon = key_fn
        inter_v.encode_gop_chunk = gop_fn
    assert launches["transform_quantize"] == 3 * (COLS + ROWS - 1), launches
    assert_wave(launches, 0)            # the fast keyframe is intra_v's
    assert seen["key"] == {"cuda"} and seen["carry"] == {"cuda"}, seen
    return launches, stats


def quality_slice_1080p(torch, clip, fast_stats):
    """Phase 7.  Returns (the kernels' launches in the timed run, the
    arguments of its wavefront keyframe): transform_quantize once per
    16x16 column of the first block row of the probed frame's luma plane
    (one frame is probed per scene at a fixed q), each wavefront kernel
    once per diagonal of the scene's keyframe."""
    import av1tpu_torch.models.inter_v as inter_v
    import av1tpu_torch.models.intra_wave as intra_wave

    seen = {"key": set(), "carry": set(), "mv": set(), "golden": set()}
    key_fn, gop_fn = (intra_wave.encode_intra_wave_key_recon,
                      inter_v.encode_gop_chunk_part)

    key_args: list = []

    def key_spy(*a, **k):
        buf, recon = key_fn(*a, **k)
        seen["key"].add(recon.device.type)
        key_args.append((a, k))
        return buf, recon

    def gop_spy(*a, **k):
        seen["golden"].add(k["gld_fused"].device.type)
        bufs, ref, mv = gop_fn(*a, **k)
        seen["carry"].add(ref.device.type)
        seen["mv"].add(mv.device.type)
        return bufs, ref, mv

    intra_wave.encode_intra_wave_key_recon = key_spy
    inter_v.encode_gop_chunk_part = gop_spy
    try:
        _, stats, launches = _timed_slice(torch, clip, "quality slice", True)
    finally:
        intra_wave.encode_intra_wave_key_recon = key_fn
        inter_v.encode_gop_chunk_part = gop_fn
    assert launches["transform_quantize"] == COLS, launches
    assert_wave(launches, stats["scenes"])
    assert all(v == {"cuda"} for v in seen.values()), seen
    print(f"quality vs fast at {clip.num_frames} frames: bytes "
          f"{stats['bytes']} vs {fast_stats['bytes']}, psnr_y "
          f"{stats['psnr_y']} vs {fast_stats['psnr_y']}, fps "
          f"{stats['encode_fps']} vs {fast_stats['encode_fps']}", flush=True)
    assert stats["bytes"] < fast_stats["bytes"]
    return launches, key_args[-1]


def wave_bounds(n: int) -> dict:
    """Least time of one launch of each wavefront kernel on a diagonal of
    n valid lanes, {name: (us, "bytes" or "operations")}: the larger of
    the fp32 operations of the forward products at the fp32 peak (the
    integer inverse, quantize and rate work are not counted) and the bytes
    at the memory rate (every table the launch reads once, each lane's
    inputs read once and outputs written once).  The work is the same for
    any data: every candidate and sub-block is coded."""
    tables = 4 * (3 * 256 + 3 * 64 + 3 * 16 + 3 * 64)   # quantizer rows
    tables += 4 * (4 * 256 + 4 * 64 + 4 * 16 + 64)      # gains
    tables += 4 * (4 * 256 + 257 + 65 + 17 + 6) + 4 * (256 + 64 + 16)
    edges = 4 * (16 + 16 + 16 + 1)                      # above, ur, left
    lane = 8 + 8 + 3                                     # r, c, flags
    luma_ops = n * 13 * 2 * 256 * 256
    luma_bytes = (4 * 4 * 256 * 256 + tables
                  + n * (lane + 4 * 256 + edges)         # src, rec edges
                  + n * (8 + 2 * 256 + 4 * 256 + 4 + 8))  # outputs
    sub_ops = n * (4 * 2 * 64 * 64 + 16 * 2 * 16 * 16 + 2 * 2 * 64 * 64)
    sub_bytes = (4 * 4 * (64 * 64 + 16 * 16) + tables
                 + n * (lane + 4 * (256 + 2 * 64) + edges + 2 * 4 * 16)
                 + n * (8 + 2 * 256 + 4 * 256 + 4 + 8)   # wave_luma16's
                 + n * (4 * 256 + 2 * 256 + 2 * (4 * 64 + 2 * 64) + 2))
    out = {}
    for name, ops, nbytes in (("wave_luma16", luma_ops, luma_bytes),
                              ("wave_sub_chroma", sub_ops, sub_bytes)):
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e6,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


def wave_vs_plain(torch, key_args) -> dict:
    """Phase 7b: the wavefront kernels against their plain versions on the
    keyframe that phase 7's quality encode coded (the temporally filtered
    first frame of the 1080p clip, with the CLI's key q, lam_scale, noise
    gate and bit depth).  (a) The plain keyframe on the card, and at every
    diagonal the two kernels from its carried state (wave_compare):
    wherever pick, tx depth and levels agree the recon must be identical,
    where the decisions agree a level may differ by 1 only, and at most
    0.1% of the lanes may take another pick or tx depth (each printed with
    the plain version's costs of both choices).  (b) The kernels' keyframe
    alone (encode_intra_wave) against the plain one: PSNR-Y within 0.05 dB,
    nonzero levels within 1%.  (c) Times: the kernels' keyframe (CUDA
    events after a warm-up, and its device time queued behind a sleep),
    each kernel's device time per keyframe and per launch at the largest
    lane count, the plain versions' at that diagonal, and the bounds.
    Returns the kernels' records for the JSON line."""
    from av1tpu_torch.kernels.intra_wave import (
        wave_compare, wave_luma16, wave_luma16_plain, wave_sub_chroma,
        wave_sub_chroma_plain,
    )
    from av1tpu_torch.models.intra_v import unfuse
    from av1tpu_torch.models.intra_wave import (
        encode_intra_wave, wave_outputs, wave_setup,
    )

    (frame, q, h, w), kw = key_args[0][:4], key_args[1]
    lam_scale, gate, bd = kw["lam_scale"], kw["noise_gate"], kw["bit_depth"]
    y, u, v = unfuse(frame, h, w)
    print(f"wave keyframe: {w}x{h} q={q} lam_scale={lam_scale} "
          f"noise_gate={gate} bit_depth={bd}", flush=True)

    # (a) same input
    t = time.perf_counter()
    o = wave_compare(y, u, v, q, bd, lam_scale, gate,
                     sync=torch.cuda.synchronize)
    compare_s = time.perf_counter() - t
    flips = o["picks"] + o["txds"]
    for f in flips:
        print(f"wave decision differs: {json.dumps(f)}", flush=True)
    print(f"wave same-input: lanes={o['lanes']} pick_differs="
          f"{len(o['picks'])} txd_differs={len(o['txds'])} "
          f"level_only_lanes={o['level_lanes']} (max |diff| "
          f"{o['level_max_diff']}) recon_mismatch_lanes={o['recon_lanes']}; "
          f"plain keyframe {o['plain_seconds']:.3f} s of {compare_s:.3f} s",
          flush=True)
    assert o["recon_lanes"] == 0, o["recon_lanes"]
    assert o["level_max_diff"] <= 1, o["level_max_diff"]
    assert len(flips) <= o["lanes"] // 1000, len(flips)

    # (b) the kernels' keyframe alone (the first run warms up)
    encode_intra_wave(y, u, v, q, bd, lam_scale, gate)
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    k = encode_intra_wave(y, u, v, q, bd, lam_scale, gate)
    b.record()
    b.synchronize()
    key_ms = a.elapsed_time(b)
    p = o["plain"]

    def psnr(rec):
        e = (rec.double() - y.double()) ** 2
        return float(10 * torch.log10(((1 << bd) - 1) ** 2 / e.mean()))

    def nonzero(out):
        return sum(int((out[n] != 0).sum())
                   for n in ("levels_y", "levels_u", "levels_v"))

    modes_diff = int((k["modes"] != p["modes"]).sum())
    txd_diff = int((k["txd"] != p["txd"]).sum())
    pk, pp = psnr(k["recon_y"]), psnr(p["recon_y"])
    nk, npl = nonzero(k), nonzero(p)
    print(f"wave whole keyframe: modes differ {modes_diff}, txd differ "
          f"{txd_diff} of {k['modes'].numel()} blocks; psnr_y kernels {pk} "
          f"plain {pp}; nonzero levels kernels {nk} plain {npl}", flush=True)
    assert abs(pk - pp) <= 0.05, (pk, pp)
    assert abs(nk - npl) <= 0.01 * npl, (nk, npl)

    # (c) times
    tabs, (sy, su, sv), diags, grids = wave_setup(y, u, v, q, bd, lam_scale,
                                                  gate)
    bests = []
    for diag in diags:       # realistic carried state for the timings
        bests.append(wave_luma16(sy, grids[0], tabs, *diag))
        wave_sub_chroma(sy, su, sv, *grids, tabs, *diag, *bests[-1])
    assert all(torch.equal(x, z) for x, z in zip(
        wave_outputs(grids).values(), k.values()))

    def luma_all():
        for diag in diags:
            wave_luma16(sy, grids[0], tabs, *diag)

    def sub_all():       # rewrites each block with the same values
        for diag, best in zip(diags, bests):
            wave_sub_chroma(sy, su, sv, *grids, tabs, *diag, *best)

    def both_all():
        for diag in diags:
            best = wave_luma16(sy, grids[0], tabs, *diag)
            wave_sub_chroma(sy, su, sv, *grids, tabs, *diag, *best)

    big = max(range(len(diags)), key=lambda d: diags[d][6])
    dg, best = diags[big], bests[big]
    n = dg[6]
    key_dev = {name: device_us(torch, fn, 1, sleep_cycles=8 * SLEEP_CYCLES)
               / 1e3 for name, fn in (("wave_luma16", luma_all),
                                      ("wave_sub_chroma", sub_all),
                                      ("both", both_all))}
    per = {"wave_luma16": device_us(
               torch, lambda: wave_luma16(sy, grids[0], tabs, *dg), 100),
           "wave_sub_chroma": device_us(
               torch, lambda: wave_sub_chroma(sy, su, sv, *grids, tabs, *dg,
                                              *best), 100)}
    plain = {"wave_luma16": _median_ms(
                 torch, lambda: wave_luma16_plain(sy, grids[0], tabs, *dg),
                 n=5),
             "wave_sub_chroma": _median_ms(
                 torch, lambda: wave_sub_chroma_plain(
                     sy, su, sv, *grids, tabs, *dg, *best), n=5)}
    bounds = wave_bounds(n)
    key_bound = {name: sum(wave_bounds(d[6])[name][0] for d in diags) / 1e3
                 for name in bounds}
    print(f"wave keyframe time: {key_ms:.3f} ms with the host (events), "
          f"{key_dev['both']:.3f} ms of device queued behind a sleep "
          f"({len(diags)} diagonals, {2 * len(diags)} launches); plain "
          f"keyframe {o['plain_seconds'] * 1e3:.1f} ms; bound "
          f"{sum(key_bound.values()):.4f} ms", flush=True)
    recs = {}
    for name in ("wave_luma16", "wave_sub_chroma"):
        recs[name] = {
            "lanes": n, "device_us": per[name], "plain_ms": plain[name],
            "bound_us": bounds[name][0], "bound_by": bounds[name][1],
            "keyframe_device_ms": key_dev[name],
            "keyframe_bound_ms": key_bound[name],
            "keyframe_ms": key_ms, "plain_keyframe_ms":
                o["plain_seconds"] * 1e3,
            "decisions_differ": len(flips),
            "max_abs_err": o["level_max_diff"]}
        print(f"{name} at {n} lanes: device {per[name]:.3f} us per launch, "
              f"plain {plain[name]:.3f} ms per call, bound "
              f"{bounds[name][0]:.4f} us ({bounds[name][1]}, roofline "
              f"{bounds[name][0] / per[name]:.4f}); per keyframe device "
              f"{key_dev[name]:.3f} ms, bound {key_bound[name]:.4f} ms",
              flush=True)
    return recs


def run_cli(argv: list) -> tuple[list, dict]:
    """av1tpu_torch.cli.main(argv) with its standard output captured and
    echoed: (progress records, stats record)."""
    from av1tpu_torch.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    print(out.getvalue(), end="", flush=True)
    assert rc == 0, rc
    lines = [json.loads(x) for x in out.getvalue().splitlines()]
    return lines[:-1], lines[-1]


def ivf_frames(path: str) -> int:
    with open(path, "rb") as f:
        head = f.read(32)
    assert head[:4] == b"DKIF", head[:4]
    return int.from_bytes(head[24:28], "little")


def _daemon_argv(y4m: str, ivf: str, *extra) -> list:
    """native/daemon/encoder.cpp's default command after the module name:
    encode -i {input} -o {output} --qindex {qindex} --workers {workers}
    (the daemon's default workers = 4), then extra options."""
    return ["encode", "-i", y4m, "-o", ivf, "--qindex", str(QINDEX),
            "--workers", "4", *extra]


def daemon_1080p(torch, y4m: str, tmp: str):
    """Phase 9.  Returns (launches, stats)."""
    import av1tpu_torch.models.inter_v as inter_v
    import av1tpu_torch.models.intra_wave as intra_wave

    seen = {"key": set(), "carry": set(), "mv": set()}
    key_fn, gop_fn = (intra_wave.encode_intra_wave_key_recon,
                      inter_v.encode_gop_chunk_part)

    def key_spy(*a, **k):
        buf, recon = key_fn(*a, **k)
        seen["key"].add(recon.device.type)
        return buf, recon

    def gop_spy(*a, **k):
        bufs, ref, mv = gop_fn(*a, **k)
        seen["carry"].add(ref.device.type)
        seen["mv"].add(mv.device.type)
        return bufs, ref, mv

    ivf = os.path.join(tmp, "daemon.ivf")
    intra_wave.encode_intra_wave_key_recon = key_spy
    inter_v.encode_gop_chunk_part = gop_spy
    try:
        zero_launches()
        progress, stats = run_cli(_daemon_argv(y4m, ivf))
        torch.cuda.synchronize()
        launches = read_launches()
    finally:
        intra_wave.encode_intra_wave_key_recon = key_fn
        inter_v.encode_gop_chunk_part = gop_fn
    print(f"daemon command: frames={stats['frames']} "
          f"fps={stats['encode_fps']} bytes={stats['bytes']} "
          f"psnr_y={stats['psnr_y']} tpu_vmaf={stats['tpu_vmaf']} "
          f"launches={launches} progress_lines={len(progress)}", flush=True)
    assert progress and progress[-1]["frames_encoded"] == CLI_FRAMES
    assert progress[-1]["progress"] == 1.0
    assert 0.0 <= stats["tpu_vmaf"] <= 100.0 and "metric_score" not in stats
    assert stats["psnr_y"] >= 30.0, stats["psnr_y"]
    assert stats["frames"] == ivf_frames(ivf) == CLI_FRAMES
    assert launches["transform_quantize"] == COLS * stats["scenes"], launches
    assert_wave(launches, stats["scenes"])
    assert all(v == {"cuda"} for v in seen.values()), seen
    return launches, stats


def metric_pass(torch, clip) -> dict:
    """The metric pass alone on one padded 1080p luma plane and a noisy
    copy: tpu_vmaf (4 VIF scales, the SSIM map, motion), SSIM and PSNR,
    each timed on the card (median of 5 event pairs, after a warm-up) and
    held against the CPU.  Returns {metric: ms}."""
    from av1tpu_torch.cli import _pad_plane
    from av1tpu_torch.metrics import quality

    y = _pad_plane(clip.y[0].astype(np.int32), 1088, 1920)
    noise = np.random.RandomState(5).randint(-6, 7, size=y.shape)
    d = np.clip(y + noise, 0, 255).astype(np.int32)
    out = {}
    for name in ("tpu_vmaf", "ssim", "psnr"):
        fn = getattr(quality, name)
        ref_t, dis_t = (torch.from_numpy(a).cuda() for a in (y, d))
        gpu = float(fn(ref_t, dis_t))
        cpu = float(fn(torch.from_numpy(y), torch.from_numpy(d)))
        out[name] = _median_ms(torch, lambda: fn(ref_t, dis_t), n=5)
        print(f"metric pass {name} 1088x1920: {out[name]:.3f} ms on the "
              f"card, gpu={gpu} cpu={cpu}", flush=True)
        assert abs(gpu - cpu) <= (1e-3 if name == "tpu_vmaf" else 1e-5), name
    return out


def layered_1080p(torch, y4m: str, tmp: str, daemon_stats):
    """Phase 10.  Returns the launches."""
    ivf = os.path.join(tmp, "layered.ivf")
    zero_launches()
    _, stats = run_cli(_daemon_argv(y4m, ivf, "--layers", "2"))
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"layers 2: fps={stats['encode_fps']} bytes={stats['bytes']} "
          f"(1 layer {daemon_stats['bytes']}, ratio "
          f"{stats['bytes'] / daemon_stats['bytes']:.4f}) "
          f"psnr_y={stats['psnr_y']} (1 layer {daemon_stats['psnr_y']}) "
          f"launches={launches}", flush=True)
    assert stats["bytes"] <= 1.02 * daemon_stats["bytes"]
    assert stats["psnr_y"] >= 30.0, stats["psnr_y"]
    assert ivf_frames(ivf) == CLI_FRAMES
    assert launches["transform_quantize"] == COLS * stats["scenes"], launches
    assert_wave(launches, stats["scenes"])
    return launches


def all_intra_1080p(torch, y4m: str, tmp: str, preset: str):
    """Phase 11, one preset.  Returns the launches: per frame the fast
    keyframe's U+V stack (COLS + ROWS - 1 steps; its luma takes the RDO
    path, which has no kernel) or the quality frame's first-row luma
    chain (COLS), plus one probe encode per scene (fast: luma and the U+V
    stack, 2 * (COLS + ROWS - 1); quality: COLS), whose recon gives both
    the metric score and the PSNR.  No wavefront keyframe: the all-intra
    chunks are intra_v's and intra_part's."""
    ivf = os.path.join(tmp, f"intra_{preset}.ivf")
    zero_launches()
    _, stats = run_cli(_daemon_argv(y4m, ivf, "--all-intra", "--max-frames",
                                    str(INTRA_FRAMES), "--preset", preset))
    torch.cuda.synchronize()
    launches = read_launches()
    per_frame, probe = ((COLS + ROWS - 1, 2 * (COLS + ROWS - 1))
                        if preset == "fast" else (COLS, COLS))
    want = INTRA_FRAMES * per_frame + stats["scenes"] * probe
    print(f"all-intra {preset}: frames={stats['frames']} "
          f"fps={stats['encode_fps']} bytes={stats['bytes']} "
          f"psnr_y={stats['psnr_y']} tpu_vmaf={stats['tpu_vmaf']} "
          f"launches={launches} (derived {want})", flush=True)
    assert stats["keyframes"] == stats["frames"] == ivf_frames(ivf)
    assert stats["frames"] == INTRA_FRAMES
    assert launches["transform_quantize"] == want, (launches, want)
    assert_wave(launches, 0)
    return launches


BATCH_FRAMES = 2        # frames per scene of the batch's 1080p clip


def batch_clip(w: int, h: int, n: int):
    """Two scenes of n frames: the synthetic clip, its second half
    inverted (a forced cut)."""
    from av1tpu_torch.utils.yuv import synthetic_clip

    c = synthetic_clip(w, h, 2 * n, seed=11)
    c.y[n:] = 255 - c.y[n:]
    return c


class _BatchSpy:
    """Routes encode_clip's scene batch to `devices` (the card listed
    twice where there is one), optionally onto an open, warmed pool that it
    leaves open, and records where each scene ran."""

    def __init__(self, gop, cli, devices, pool=None):
        self.gop, self.cli, self.devices, self.pool = gop, cli, devices, pool
        self.results: list = []

    def __enter__(self):
        gop, cli = self.gop, self.cli
        self.saved = (cli._device_count, gop.scene_devices, gop.ScenePool,
                      gop.SceneBatchEncoder.encode)
        encode = self.saved[3]
        spy = self

        def record(enc, *a, **k):
            res = encode(enc, *a, **k)
            spy.results.extend(res)
            return res

        gop.SceneBatchEncoder.encode = record
        if len(set(self.devices)) < len(self.devices):
            cli._device_count = lambda dev: len(self.devices)
            gop.scene_devices = lambda n, dev: self.devices[:n]
        if self.pool is not None:
            gop.ScenePool = lambda devices: contextlib.nullcontext(self.pool)
        return self

    def __exit__(self, *exc):
        (self.cli._device_count, self.gop.scene_devices, self.gop.ScenePool,
         self.gop.SceneBatchEncoder.encode) = self.saved

    def launches(self) -> dict:
        """The hand kernels' launches the workers reported, summed."""
        out: dict = {}
        for r in self.results:
            out = add_launches(out, r["launches"])
        return out

    def where(self) -> dict:
        """{(device, pid): (scenes, peak bytes allocated)}."""
        out: dict = {}
        for r in self.results:
            key = (r["device"], r["pid"])
            n, peak = out.get(key, (0, 0))
            out[key] = (n + 1, max(peak, r["peak_bytes"] or 0))
        return out


def batch_devices(torch) -> tuple[list, str]:
    from av1tpu_torch.parallel.gop import scene_devices

    if torch.cuda.device_count() >= 2:
        return scene_devices(2, "cuda"), "two GPUs, the command's routing"
    return scene_devices(1, "cuda") * 2, "one GPU listed twice"


def batch_parity(torch, quality_runs) -> dict:
    """Phase 12 (a).  Returns the kernels' launches, the parent's and the
    workers' summed: the workers code each scene's wavefront keyframe."""
    import av1tpu_torch.cli as cli
    from av1tpu_torch.parallel import gop

    (s_gpu, _), (s_cpu, _) = quality_runs
    devices, case = batch_devices(torch)
    zero_launches()
    with _BatchSpy(gop, cli, devices) as spy:
        s_b, st_b = cli.encode_clip(two_scene_clip(), 120, device="cuda",
                                    workers=2, chunk=4, metric="psnr",
                                    partitions=True, scene_threshold=2.5,
                                    gop=True)
    torch.cuda.synchronize()
    parent = read_launches()
    launches = add_launches(parent, spy.launches())
    where = spy.where()
    print(f"batch parity ({case}): devices {[str(d) for d in devices]}, "
          f"scenes per (device, pid) "
          f"{ {f'{d}/{p}': v[0] for (d, p), v in where.items()} }, "
          f"tus {len(s_b)}, identical to workers=1 on the card "
          f"{sum(a == b for a, b in zip(s_b, s_gpu))}, to the CPU "
          f"{sum(a == b for a, b in zip(s_b, s_cpu))}, bytes {st_b['bytes']}, "
          f"launches parent {parent} workers {spy.launches()}", flush=True)
    assert len(spy.results) == st_b["scenes"] == 2 and len(where) == 2
    assert {d for d, _ in where} == {str(d) for d in devices}
    assert s_b == s_gpu == s_cpu
    assert_wave(parent, 0)
    assert_wave(launches, st_b["scenes"], 64, 128)
    return launches


def batch_1080p(torch) -> int:
    """Phase 12 (b).  Returns the kernels' launches in the timed batch,
    the parent's and the workers' summed."""
    import av1tpu_torch.cli as cli
    from av1tpu_torch.parallel import gop

    clip = batch_clip(1920, 1080, BATCH_FRAMES)
    kw = dict(chunk=BATCH_FRAMES, metric="psnr", partitions=True,
              scene_threshold=2.5, gop=True, device="cuda")
    devices, case = batch_devices(torch)
    runs = {}
    with gop.ScenePool(devices) as pool:
        small = batch_clip(128, 64, BATCH_FRAMES)
        with _BatchSpy(gop, cli, devices, pool) as spy:  # warm the workers
            cli.encode_clip(small, 120, workers=2, **kw)
        assert len(spy.where()) == 2
        cli.encode_clip(small, 120, **kw)                # and the parent
        torch.cuda.synchronize()
        for workers in (1, 2):
            torch.cuda.reset_peak_memory_stats()
            zero_launches()
            with _BatchSpy(gop, cli, devices, pool) as spy:
                streams, stats = cli.encode_clip(clip, QINDEX,
                                                 workers=workers, **kw)
            torch.cuda.synchronize()
            parent = read_launches()
            launches = add_launches(parent, spy.launches())
            peaks = {"parent": torch.cuda.max_memory_allocated()}
            peaks.update({f"{d}/{p}": v[1]
                          for (d, p), v in spy.where().items()})
            sec = stats["encode_seconds"]
            route = case if workers > 1 else "the single-device path"
            print(f"batch 1080p workers={workers} ({route}): encode {sec} s, "
                  f"{stats['scenes'] / sec:.4f} scenes/s, "
                  f"{stats['encode_fps']} fps, key_device "
                  f"{stats['stage_seconds']['key_device']} s (summed over "
                  f"scenes), bytes {stats['bytes']}, psnr_y "
                  f"{stats['psnr_y']}, launches parent {parent} workers "
                  f"{spy.launches()}, peak bytes allocated {peaks}",
                  flush=True)
            print(f"batch 1080p workers={workers} stats:", json.dumps(stats),
                  flush=True)
            assert stats["scenes"] == 2 and len(streams) == 2 * BATCH_FRAMES
            # the probes run in the parent, the keyframes in the workers
            assert parent["transform_quantize"] == COLS * stats["scenes"], (
                parent)
            assert launches["transform_quantize"] == COLS * stats["scenes"]
            assert_wave(launches, stats["scenes"])
            if workers > 1:
                assert_wave(parent, 0)
            assert len(spy.results) == (2 if workers > 1 else 0)
            runs[workers] = (streams, stats, launches)
    (s1, st1, _), (s2, st2, launches) = runs[1], runs[2]
    speedup = st1["encode_seconds"] / st2["encode_seconds"]
    print(f"batch 1080p: speed-up {speedup:.3f}x on {case}, identical TUs "
          f"{sum(a == b for a, b in zip(s1, s2))} of {len(s1)}", flush=True)
    assert st1["bytes"] == st2["bytes"] and s1 == s2
    return launches


class ReconSpy:
    """While a GOP encode runs at chunk 1, the recon of every frame in
    coding order, as numpy: a keyframe's after CDEF (models/cdef.cdef_fused),
    an inter frame's `ref` (inter_v.encode_gop_chunk_part, encode_gop_chunk
    for the fast preset, encode_gop_chunk_layered for --layers 2, whose
    non-reference frames return no recon of their own and record None)."""

    def __enter__(self):
        from av1tpu_torch.models import cdef, inter_v

        self.frames: list = []
        self.saved = [(m, n, getattr(m, n), pick) for m, n, pick in (
            (cdef, "cdef_fused", lambda o: o),
            (inter_v, "encode_gop_chunk", lambda o: o[1]),
            (inter_v, "encode_gop_chunk_part", lambda o: o[1]),
            (inter_v, "encode_gop_chunk_layered",
             lambda o: None if o[1][0] else o[2]))]
        for mod, name, fn, pick in self.saved:
            setattr(mod, name, self._spy(fn, pick))
        return self

    def _spy(self, fn, pick):
        def spy(*a, **k):
            out = fn(*a, **k)
            recon = pick(out)
            self.frames.append(None if recon is None
                               else recon.cpu().numpy())
            return out
        return spy

    def __exit__(self, *exc):
        for mod, name, fn, _ in self.saved:
            setattr(mod, name, fn)

    def recons(self) -> dict:
        """{frame: fused recon} of the frames that have one."""
        return {i: f for i, f in enumerate(self.frames) if f is not None}


def av1_tool(tool: str, *args) -> dict:
    """One av1_tool command; its last JSON line (probe: the whole output)."""
    r = subprocess.run([tool, *args], capture_output=True, text=True,
                       timeout=300)
    assert r.returncode == 0, (args, r.stderr[-2000:])
    out = r.stdout.strip()
    return json.loads(out if args[0] == "probe" else out.splitlines()[-1])


def decoded_vs_recon(tool: str, video: str, recons: dict, tmp: str):
    """Decode `video` with libdav1d and count the pixels of each plane that
    differ from the recon of each frame in recons {frame: fused [y | u | v]
    recon over the 64-aligned coded size, which the decoder outputs}.
    Returns (the decode's record, or None where the decoder refused the
    stream; its error; {frame: (y, u, v)}, empty without a decode)."""
    from av1tpu_torch.utils.yuv import read_y4m

    y4m = os.path.join(tmp, "decoded.y4m")
    r = subprocess.run([tool, "decode", video, y4m], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        return None, r.stderr.strip(), {}
    dec = read_y4m(y4m)
    os.remove(y4m)
    ny, nc = dec.height * dec.width, dec.height * dec.width // 4
    diffs = {}
    for i, f in recons.items():
        planes = (f[:ny], f[ny : ny + nc], f[ny + nc :])
        diffs[i] = tuple(int(np.count_nonzero(p != d.ravel()))
                         for p, d in zip(planes,
                                         (dec.y[i], dec.u[i], dec.v[i])))
    return json.loads(r.stdout.strip().splitlines()[-1]), "", diffs


def ivf_tus(path: str) -> list[bytes]:
    """The frame payloads of an IVF file."""
    with open(path, "rb") as f:
        data = f.read()
    off, out = int.from_bytes(data[6:8], "little"), []
    while off < len(data):
        n = int.from_bytes(data[off : off + 4], "little")
        out.append(data[off + 12 : off + 12 + n])
        off += 12 + n
    return out


def torch_config(tmp: str, library: str, encode_cmd: str) -> str:
    """deploy/config.torch.toml with its paths, gates and template
    overridden for this run (later keys win in the daemon's parser)."""
    with open(os.path.join(REPO, "deploy", "config.torch.toml")) as f:
        text = f.read()
    text += (f'\n[scan]\nlibrary_roots = ["{library}"]\n'
             "stability_wait_secs = 0\n"
             f'\n[paths]\njob_state_dir = "{tmp}/jobs"\n'
             f'temp_output_dir = "{tmp}/temp"\n'
             "\n[gates]\nmin_bytes = 1\n"
             f"\n[tpu]\nencode_cmd = {json.dumps(encode_cmd)}\n")
    cfg = os.path.join(tmp, "config.toml")
    with open(cfg, "w") as f:
        f.write(text)
    return cfg


def torch_template() -> str:
    """[tpu].encode_cmd of deploy/config.torch.toml."""
    with open(os.path.join(REPO, "deploy", "config.torch.toml")) as f:
        line = next(x for x in f if x.startswith("encode_cmd = "))
    return json.loads(line[len("encode_cmd = "):])


def torch_command(*extra) -> str:
    """The template with this interpreter for `python3` (the daemon's
    shell would find whichever is first on its PATH) and extra options."""
    cmd = torch_template().replace("python3", shlex.quote(sys.executable), 1)
    return " ".join([cmd, *extra])


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


def card_encode(torch, name: str, argv_to, out_dir: str,
                device: str) -> tuple[dict, int]:
    """The command argv_to(ivf) at --chunk 1 on `device`, with ReconSpy.
    Keeps in out_dir what a decode check needs: NAME.ivf, NAME_recon.npz
    (each frame's recon at the coded size, and its index) and NAME.json
    (the card, the launches, the stats).  Returns (stats, launches by
    kernel)."""
    ivf = os.path.join(out_dir, name + ".ivf")
    zero_launches()
    with ReconSpy() as spy:
        _, stats = run_cli([*argv_to(ivf), "--chunk", "1", "--device",
                            device])
    if device == "cuda":
        torch.cuda.synchronize()
    launches = read_launches()
    recons = spy.recons()
    recon = np.stack(list(recons.values()))
    np.savez_compressed(
        os.path.join(out_dir, name + "_recon.npz"),
        frames=np.array(list(recons)),
        recon=recon.astype(np.uint8 if recon.max() <= 255 else np.uint16))
    with open(os.path.join(out_dir, name + ".json"), "w") as f:
        json.dump({"card": card_name() if device == "cuda" else device,
                   "launches": launches, "stats": stats}, f)
    return stats, launches


def decode_check(tool: str, out_dir: str, name: str, tmp: str):
    """Decode card_encode's NAME.ivf with libdav1d against its recon and
    print one line.  Returns (the decode's record, or None where the
    decoder refused the stream; {frame: differing (y, u, v) pixels})."""
    with open(os.path.join(out_dir, name + ".json")) as f:
        rec = json.load(f)
    saved = np.load(os.path.join(out_dir, name + "_recon.npz"))
    recons = dict(zip(saved["frames"].tolist(),
                      saved["recon"].astype(np.int64)))
    dec, err, diffs = decoded_vs_recon(
        tool, os.path.join(out_dir, name + ".ivf"), recons, tmp)
    print(f"{name} decode check ({rec['card']}; bytes="
          f"{rec['stats']['bytes']}, launches={rec['launches']}): "
          + (f"decoded frames={dec['frames']}, differing pixels (y, u, v) "
             f"per frame {list(diffs.values())}, total "
             f"{sum(map(sum, diffs.values()))}"
             if dec else f"refused by the decoder: {err}"), flush=True)
    return dec, diffs


def container_daemon(torch, tmp: str, out_dir: str, tool, daemon,
                     device: str = "cuda",
                     size=(CONTAINER_W, CONTAINER_H, CONTAINER_FRAMES),
                     extra=()) -> int:
    """Phase 13 (a).  tool, daemon: the port's av1_tool and daemon, or
    None where the host has no libav: then the daemon's command runs on
    the y4m alone.  A rehearsal on the CPU passes device "cpu", a small
    size and options for the command.  Returns the launches of the
    in-process run, by kernel."""
    from av1tpu_torch.utils.yuv import synthetic_clip, write_y4m

    w, h, n = size
    src = os.path.join(tmp, "container.y4m")
    write_y4m(src, synthetic_clip(w, h, n, seed=11))
    opts = (*extra, *(("--device", device) if device != "cuda" else ()))
    if tool is not None:
        y4m, src = src, os.path.join(tmp, "source.mkv")
        av1_tool(tool, "encode", y4m, src, "--codec", "mpeg4", "--audio",
                 "tone")
        library = os.path.join(tmp, "library")
        os.makedirs(library)
        target = os.path.join(library, "Movie.2024.WEBRip.mkv")
        with open(src, "rb") as a, open(target, "wb") as b:
            b.write(a.read())
        cfg = torch_config(tmp, library, torch_command(*opts))
        t = time.perf_counter()
        r = subprocess.run([daemon, "--config", cfg, "--metrics-port", "0",
                            "--once"], capture_output=True, text=True,
                           cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                           timeout=600)
        cycle_s = time.perf_counter() - t
        print(r.stdout.strip(), flush=True)
        assert r.returncode == 0 and "completed=1 failed=0" in r.stdout, (
            r.stdout[-2000:] + r.stderr[-2000:])
        (job_file,) = [p for p in os.listdir(os.path.join(tmp, "jobs"))
                       if p.endswith(".json")]
        with open(os.path.join(tmp, "jobs", job_file)) as f:
            job = json.load(f)
        probe = av1_tool(tool, "probe", target)
        codecs = {s["type"]: s["codec"] for s in probe["streams"]}
        print(f"daemon cycle: {cycle_s:.3f} s, job status={job['status']} "
              f"stage={job['stage']} source_bytes={os.path.getsize(src)} "
              f"output_bytes={job['output_bytes']} psnr_y={job['psnr_y']} "
              f"tpu_vmaf={job['tpu_vmaf']}; replaced file: "
              f"{probe['format']} {codecs}", flush=True)
        assert (job["status"], job["stage"]) == ("success", "complete")
        assert job["output_bytes"] == os.path.getsize(target)
        assert job["psnr_y"] >= 30.0 and 0.0 <= job["tpu_vmaf"] <= 100.0
        assert probe["format"].startswith("matroska")
        assert codecs == {"video": "av1", "audio": "pcm_s16le"}
        assert av1_tool(tool, "decode", target)["frames"] == n

    # the same command in this process, at chunk 1, with the recon spied
    stats, launches = card_encode(
        torch, "daemon_command", lambda ivf: _daemon_argv(src, ivf, *extra),
        out_dir, device)
    print(f"daemon command on {device}, {w}x{h} {n} frames from "
          f"{os.path.basename(src)} at --chunk 1: bytes={stats['bytes']} "
          f"scenes={stats['scenes']} launches={launches}", flush=True)
    assert stats["frames"] == ivf_frames(
        os.path.join(out_dir, "daemon_command.ivf")) == n
    on_card = device == "cuda"
    assert launches["transform_quantize"] == (
        w // 16 * stats["scenes"] if on_card else 0), launches
    # the quality preset's keyframe, one per scene, at the coded size
    assert_wave(launches, stats["scenes"] if on_card else 0,
                (h + 63) & ~63, (w + 63) & ~63)
    if tool is not None:
        # the replaced file's video, remuxed to IVF, against this run's TUs
        remuxed = os.path.join(tmp, "replaced.ivf")
        av1_tool(tool, "mux", target, "none", remuxed)
        same = sum(a == b for a, b in zip(
            ivf_tus(remuxed),
            ivf_tus(os.path.join(out_dir, "daemon_command.ivf"))))
        print(f"TUs identical to the replaced file's: {same} of {n}",
              flush=True)
        assert same == n
        # printed, not failed on: the quality preset keeps the reference's
        # faults (ROADMAP queue 3 items 1 and 2)
        decode_check(tool, out_dir, "daemon_command", tmp)
    return launches


def container_1080p(torch, tmp: str, out_dir: str, tool,
                    device: str = "cuda",
                    size=(DECODE_W, DECODE_H, CONTAINER_FRAMES)) -> int:
    """Phase 13 (b).  tool: the port's av1_tool, or None where the host
    has no libav (then no decode).  A rehearsal on the CPU passes device
    "cpu" and a small size.  Returns the launches by kernel."""
    from av1tpu_torch.utils.yuv import synthetic_clip, write_y4m

    w, h, n = size
    y4m = os.path.join(tmp, "fast.y4m")
    write_y4m(y4m, synthetic_clip(w, h, n, seed=11))
    stats, launches = card_encode(
        torch, "fast_1080p", lambda ivf: [
            "encode", "-i", y4m, "-o", ivf, "--qindex", str(QINDEX),
            "--preset", "fast"], out_dir, device)
    print(f"fast preset on {device}, {w}x{h} {n} frames at --chunk 1: "
          f"bytes={stats['bytes']} psnr_y={stats['psnr_y']} "
          f"scenes={stats['scenes']} launches={launches}", flush=True)
    assert stats["frames"] == n
    # at chunk 1 the scene detector's minimum scene length is 1
    assert launches["transform_quantize"] == (
        3 * (COLS + ROWS - 1) * stats["scenes"] if device == "cuda" else 0), (
        launches)
    assert_wave(launches, 0)
    if tool is not None:
        dec, diffs = decode_check(tool, out_dir, "fast_1080p", tmp)
        assert dec is not None
        assert dec["frames"] == len(diffs) == n
        assert all(d == (0, 0, 0) for d in diffs.values()), diffs
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    t = time.perf_counter()
    print(card_name(), flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _phase("environment", t)

    t = time.perf_counter()
    from av1tpu_torch import _build
    libav = _build.libav_available()
    with concurrent.futures.ThreadPoolExecutor() as pool:
        builds = [pool.submit(f) for f in (
            _build.packer_lib_path,
            *((_build.av1_tool_path, _build.daemon_path) if libav else ()))]
        _, log = _build.build_cuda()
        print(log.strip(), flush=True)
        built = [f.result() for f in builds]
    tool, daemon = built[1:] if libav else (None, None)
    _phase("build", t)

    t = time.perf_counter()
    recs = kernel_vs_plain(torch)
    _phase("kernel_vs_plain", t)

    t = time.perf_counter()
    parity(torch, "parity")
    _phase("parity", t)

    from av1tpu_torch.utils.yuv import synthetic_clip, write_y4m
    clip = synthetic_clip(1920, 1080, FRAMES, seed=11)

    t = time.perf_counter()
    launches_fast, fast_stats = slice_1080p(torch, clip)
    _phase("slice_1080p", t)

    t = time.perf_counter()
    quality_runs = parity(torch, "quality parity", partitions=True)
    _phase("quality_parity", t)

    t = time.perf_counter()
    launches_quality, key_args = quality_slice_1080p(torch, clip, fast_stats)
    _phase("quality_slice_1080p", t)

    t = time.perf_counter()
    wave_recs = wave_vs_plain(torch, key_args)
    _phase("wave_vs_plain", t)

    t = time.perf_counter()
    modes_parity(torch)
    _phase("modes_parity", t)

    with tempfile.TemporaryDirectory() as tmp:
        y4m = os.path.join(tmp, "in.y4m")
        write_y4m(y4m, synthetic_clip(1920, 1080, CLI_FRAMES, seed=11))

        t = time.perf_counter()
        launches_daemon, daemon_stats = daemon_1080p(torch, y4m, tmp)
        metric_ms = metric_pass(torch, clip)
        _phase("daemon_1080p", t)

        t = time.perf_counter()
        launches_layered = layered_1080p(torch, y4m, tmp, daemon_stats)
        _phase("layered_1080p", t)

        t = time.perf_counter()
        launches_intra = {p: all_intra_1080p(torch, y4m, tmp, p)
                          for p in ("fast", "quality")}
        _phase("all_intra_1080p", t)

    t = time.perf_counter()
    launches_batch_parity = batch_parity(torch, quality_runs)
    launches_batch = batch_1080p(torch)
    _phase("scene_batch", t)

    by_path = {"fast": launches_fast, "quality": launches_quality,
               "daemon": launches_daemon, "layered": launches_layered,
               "all_intra_fast": launches_intra["fast"],
               "all_intra_quality": launches_intra["quality"],
               "batch_parity": launches_batch_parity,
               "batch": launches_batch}

    t = time.perf_counter()
    if not libav:
        print("container and daemon: pkg-config finds no libavcodec, "
              "libavformat, libavutil on this host: the mkv source, the "
              "daemon's cycle and the libdav1d decodes are skipped; the "
              "card's streams and recon are kept for "
              "tools/card_decode_check.py", flush=True)
    out = os.environ.get("AV1TPU_SMOKE_OUT")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.abspath(out) if out else tmp
        os.makedirs(out, exist_ok=True)
        by_path["container_daemon"] = container_daemon(torch, tmp, out, tool,
                                                       daemon)
        by_path["container_1080p"] = container_1080p(torch, tmp, out, tool)
    _phase("container", t)
    main_rec = recs[0]                   # (120, 256): a luma block row
    shape_key = [f"{r['b']}x{r['n2']}" for r in recs]

    def path_counts(name):
        return {p: c[name] for p, c in by_path.items()}

    wave = [{
        "name": name, "route": "cuda",
        "source": "av1tpu_torch/csrc/intra_wave.cu",
        "replaces": "av1tpu/models/intra_wave.py:383",
        "launches": sum(path_counts(name).values()),
        "launches_by_path": path_counts(name),
        "max_abs_err": r["max_abs_err"],
        "ms": r["device_us"] / 1e3, "plain_ms": r["plain_ms"],
        "bound_ms": r["bound_us"] / 1e3, "bound_by": r["bound_by"],
        # no PyTorch call computes the diagonal step
        "library_ms": None,
        **{k: r[k] for k in ("lanes", "keyframe_device_ms",
                             "keyframe_bound_ms", "keyframe_ms",
                             "plain_keyframe_ms", "decisions_differ")}}
        for name, r in wave_recs.items()]
    print(json.dumps({"kernels": [{
        "name": "transform_quantize", "route": "cuda",
        "source": "av1tpu_torch/csrc/transform_quant.cu",
        "replaces": "av1tpu/kernels/transform_quant.py:64",
        "launches": sum(path_counts("transform_quantize").values()),
        "launches_by_path": path_counts("transform_quantize"),
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["device_us"] / 1e3,
        "plain_ms": main_rec["plain_device_us"] / 1e3,
        "bound_ms": main_rec["bound_us"] / 1e3,
        "bound_by": main_rec["bound_by"], "library_ms": None,
        **{k: dict(zip(shape_key, (r[k] for r in recs)))
           for k in ("device_us", "call_us", "host_us", "bound_us")}},
        *wave], "metric_pass_ms": metric_ms}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
