#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (av1tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed with its seconds; any failure raises and the script
exits non-zero:

1. environment: torch version, the card's name and power limit, TF32 off;
2. build: the CUDA kernels (nvcc, sm_90a) and the C++ packer from the
   sources in this checkout;
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
   coefficients, and so has no kernel yet).  Spies assert that the
   keyframe recon, the inter carry (recon and MV field) and GOLDEN live on
   the card, and the bytes must come out below the fast preset's.
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
   (equal), peak memory per device and process; 120 launches per scene,
   all in the parent's probe (the workers' keyframe is the wavefront one).

The line before the last is the kernels' JSON record (launches summed over
the timed runs, with the count of each path beside it); the last line is
{"ok": true, "device": {...}}.  Imports nothing of JAX or av1tpu.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
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


def _phase(name: str, t0: float) -> None:
    print(f"phase {name}: {time.perf_counter() - t0:.3f} s", flush=True)


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


def device_us(torch, fn, n: int) -> float:
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
    torch.cuda._sleep(SLEEP_CYCLES)
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
    """One warm-up and one timed 1080p encode with the kernel's launch
    count set to 0 just before the timed run and read just after.  Returns
    (streams, stats, launches)."""
    from av1tpu_torch.cli import encode_clip
    from av1tpu_torch.kernels.transform_quant import transform_quantize

    kw = dict(chunk=CHUNK, metric="psnr", gop=True, partitions=partitions,
              device="cuda")
    t = time.perf_counter()
    encode_clip(clip, QINDEX, **kw)                      # warm-up
    torch.cuda.synchronize()
    print(f"{name} warm-up: {time.perf_counter() - t:.3f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    transform_quantize.launches = 0
    streams, stats = encode_clip(clip, QINDEX, **kw)
    torch.cuda.synchronize()
    launches = transform_quantize.launches
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
    """Phase 5.  Returns (the kernel's launch count in the timed run, the
    stats): one launch per first-row column and per later block row, for
    the probe's luma, the probe's U and V together and the keyframe's U
    and V together (the keyframe's luma takes the RDO path, which has no
    kernel)."""
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
    assert launches == 3 * (COLS + ROWS - 1), launches
    assert seen["key"] == {"cuda"} and seen["carry"] == {"cuda"}, seen
    return launches, stats


def quality_slice_1080p(torch, clip, fast_stats):
    """Phase 7.  Returns the kernel's launch count in the timed run: one
    launch per 16x16 column of the first block row of the probed frame's
    luma plane (one frame is probed per scene at a fixed q)."""
    import av1tpu_torch.models.inter_v as inter_v
    import av1tpu_torch.models.intra_wave as intra_wave

    seen = {"key": set(), "carry": set(), "mv": set(), "golden": set()}
    key_fn, gop_fn = (intra_wave.encode_intra_wave_key_recon,
                      inter_v.encode_gop_chunk_part)

    def key_spy(*a, **k):
        buf, recon = key_fn(*a, **k)
        seen["key"].add(recon.device.type)
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
    assert launches == COLS, launches
    assert all(v == {"cuda"} for v in seen.values()), seen
    print(f"quality vs fast at {clip.num_frames} frames: bytes "
          f"{stats['bytes']} vs {fast_stats['bytes']}, psnr_y "
          f"{stats['psnr_y']} vs {fast_stats['psnr_y']}, fps "
          f"{stats['encode_fps']} vs {fast_stats['encode_fps']}", flush=True)
    assert stats["bytes"] < fast_stats["bytes"]
    return launches


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
    from av1tpu_torch.kernels.transform_quant import transform_quantize

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
        transform_quantize.launches = 0
        progress, stats = run_cli(_daemon_argv(y4m, ivf))
        torch.cuda.synchronize()
        launches = transform_quantize.launches
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
    assert launches == COLS * stats["scenes"], launches
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
    from av1tpu_torch.kernels.transform_quant import transform_quantize

    ivf = os.path.join(tmp, "layered.ivf")
    transform_quantize.launches = 0
    _, stats = run_cli(_daemon_argv(y4m, ivf, "--layers", "2"))
    torch.cuda.synchronize()
    launches = transform_quantize.launches
    print(f"layers 2: fps={stats['encode_fps']} bytes={stats['bytes']} "
          f"(1 layer {daemon_stats['bytes']}, ratio "
          f"{stats['bytes'] / daemon_stats['bytes']:.4f}) "
          f"psnr_y={stats['psnr_y']} (1 layer {daemon_stats['psnr_y']}) "
          f"launches={launches}", flush=True)
    assert stats["bytes"] <= 1.02 * daemon_stats["bytes"]
    assert stats["psnr_y"] >= 30.0, stats["psnr_y"]
    assert ivf_frames(ivf) == CLI_FRAMES
    assert launches == COLS * stats["scenes"], launches
    return launches


def all_intra_1080p(torch, y4m: str, tmp: str, preset: str):
    """Phase 11, one preset.  Returns the launches: per frame the fast
    keyframe's U+V stack (COLS + ROWS - 1 steps; its luma takes the RDO
    path, which has no kernel) or the quality frame's first-row luma
    chain (COLS), plus one probe encode per scene (fast: luma and the U+V
    stack, 2 * (COLS + ROWS - 1); quality: COLS), whose recon gives both
    the metric score and the PSNR."""
    from av1tpu_torch.kernels.transform_quant import transform_quantize

    ivf = os.path.join(tmp, f"intra_{preset}.ivf")
    transform_quantize.launches = 0
    _, stats = run_cli(_daemon_argv(y4m, ivf, "--all-intra", "--max-frames",
                                    str(INTRA_FRAMES), "--preset", preset))
    torch.cuda.synchronize()
    launches = transform_quantize.launches
    per_frame, probe = ((COLS + ROWS - 1, 2 * (COLS + ROWS - 1))
                        if preset == "fast" else (COLS, COLS))
    want = INTRA_FRAMES * per_frame + stats["scenes"] * probe
    print(f"all-intra {preset}: frames={stats['frames']} "
          f"fps={stats['encode_fps']} bytes={stats['bytes']} "
          f"psnr_y={stats['psnr_y']} tpu_vmaf={stats['tpu_vmaf']} "
          f"launches={launches} (derived {want})", flush=True)
    assert stats["keyframes"] == stats["frames"] == ivf_frames(ivf)
    assert stats["frames"] == INTRA_FRAMES
    assert launches == want, (launches, want)
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


def batch_parity(torch, quality_runs) -> None:
    """Phase 12 (a)."""
    import av1tpu_torch.cli as cli
    from av1tpu_torch.parallel import gop

    (s_gpu, _), (s_cpu, _) = quality_runs
    devices, case = batch_devices(torch)
    with _BatchSpy(gop, cli, devices) as spy:
        s_b, st_b = cli.encode_clip(two_scene_clip(), 120, device="cuda",
                                    workers=2, chunk=4, metric="psnr",
                                    partitions=True, scene_threshold=2.5,
                                    gop=True)
    where = spy.where()
    print(f"batch parity ({case}): devices {[str(d) for d in devices]}, "
          f"scenes per (device, pid) "
          f"{ {f'{d}/{p}': v[0] for (d, p), v in where.items()} }, "
          f"tus {len(s_b)}, identical to workers=1 on the card "
          f"{sum(a == b for a, b in zip(s_b, s_gpu))}, to the CPU "
          f"{sum(a == b for a, b in zip(s_b, s_cpu))}, bytes {st_b['bytes']}",
          flush=True)
    assert len(spy.results) == st_b["scenes"] == 2 and len(where) == 2
    assert {d for d, _ in where} == {str(d) for d in devices}
    assert s_b == s_gpu == s_cpu


def batch_1080p(torch) -> int:
    """Phase 12 (b).  Returns the kernel's launches in the timed batch."""
    import av1tpu_torch.cli as cli
    from av1tpu_torch.kernels.transform_quant import transform_quantize
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
            transform_quantize.launches = 0
            with _BatchSpy(gop, cli, devices, pool) as spy:
                streams, stats = cli.encode_clip(clip, QINDEX,
                                                 workers=workers, **kw)
            torch.cuda.synchronize()
            launches = transform_quantize.launches
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
                  f"{stats['psnr_y']}, launches {launches}, peak bytes "
                  f"allocated {peaks}", flush=True)
            print(f"batch 1080p workers={workers} stats:", json.dumps(stats),
                  flush=True)
            assert stats["scenes"] == 2 and len(streams) == 2 * BATCH_FRAMES
            assert launches == COLS * stats["scenes"], launches
            assert len(spy.results) == (2 if workers > 1 else 0)
            runs[workers] = (streams, stats, launches)
    (s1, st1, _), (s2, st2, launches) = runs[1], runs[2]
    speedup = st1["encode_seconds"] / st2["encode_seconds"]
    print(f"batch 1080p: speed-up {speedup:.3f}x on {case}, identical TUs "
          f"{sum(a == b for a, b in zip(s1, s2))} of {len(s1)}", flush=True)
    assert st1["bytes"] == st2["bytes"] and s1 == s2
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1

    t = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _phase("environment", t)

    t = time.perf_counter()
    from av1tpu_torch._build import build_cuda, packer_lib_path
    _, log = build_cuda()
    print(log.strip(), flush=True)
    packer_lib_path()
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
    launches_quality = quality_slice_1080p(torch, clip, fast_stats)
    _phase("quality_slice_1080p", t)

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
    batch_parity(torch, quality_runs)
    launches_batch = batch_1080p(torch)
    _phase("scene_batch", t)

    by_path = {"fast": launches_fast, "quality": launches_quality,
               "daemon": launches_daemon, "layered": launches_layered,
               "all_intra_fast": launches_intra["fast"],
               "all_intra_quality": launches_intra["quality"],
               "batch": launches_batch}
    main_rec = recs[0]                   # (120, 256): a luma block row
    shape_key = [f"{r['b']}x{r['n2']}" for r in recs]
    print(json.dumps({"kernels": [{
        "name": "transform_quantize", "route": "cuda",
        "source": "av1tpu_torch/csrc/transform_quant.cu",
        "replaces": "av1tpu/kernels/transform_quant.py:64",
        "launches": sum(by_path.values()),
        "launches_by_path": by_path,
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["device_us"] / 1e3,
        "plain_ms": main_rec["plain_device_us"] / 1e3,
        "bound_ms": main_rec["bound_us"] / 1e3,
        "bound_by": main_rec["bound_by"], "library_ms": None,
        **{k: dict(zip(shape_key, (r[k] for r in recs)))
           for k in ("device_us", "call_us", "host_us", "bound_us")}}],
        "metric_pass_ms": metric_ms}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
