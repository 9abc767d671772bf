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

The line before the last is the kernels' JSON record (launches summed over
the two timed runs, with the count of each path beside it); the last line
is {"ok": true, "device": {...}}.  Imports nothing of JAX or av1tpu.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

QINDEX = 72
CHUNK = 8
FRAMES = 48
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


def parity(torch, partitions: bool = False):
    """Phases 4 and 6: the port on the card against the port on the CPU,
    fast preset or quality preset."""
    from av1tpu_torch.cli import encode_clip

    clip = two_scene_clip()
    kw = dict(chunk=4, metric="psnr", partitions=partitions,
              scene_threshold=2.5, gop=True)
    s_gpu, st_gpu = encode_clip(clip, 120, device="cuda", **kw)
    s_cpu, st_cpu = encode_clip(clip, 120, device="cpu", **kw)
    same = sum(a == b for a, b in zip(s_gpu, s_cpu))
    name = "quality parity" if partitions else "parity"
    print(f"{name}: tus gpu={len(s_gpu)} cpu={len(s_cpu)} identical={same} "
          f"bytes gpu={st_gpu['bytes']} cpu={st_cpu['bytes']} "
          f"psnr_y gpu={st_gpu['psnr_y']} cpu={st_cpu['psnr_y']}", flush=True)
    assert len(s_gpu) == len(s_cpu) == clip.num_frames
    assert st_gpu["scenes"] == st_cpu["scenes"]
    assert abs(st_gpu["psnr_y"] - st_cpu["psnr_y"]) <= 0.05
    assert abs(st_gpu["bytes"] - st_cpu["bytes"]) <= 0.01 * st_cpu["bytes"]


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
    parity(torch)
    _phase("parity", t)

    from av1tpu_torch.utils.yuv import synthetic_clip
    clip = synthetic_clip(1920, 1080, FRAMES, seed=11)

    t = time.perf_counter()
    launches_fast, fast_stats = slice_1080p(torch, clip)
    _phase("slice_1080p", t)

    t = time.perf_counter()
    parity(torch, partitions=True)
    _phase("quality_parity", t)

    t = time.perf_counter()
    launches_quality = quality_slice_1080p(torch, clip, fast_stats)
    _phase("quality_slice_1080p", t)

    main_rec = recs[0]                   # (120, 256): a luma block row
    shape_key = [f"{r['b']}x{r['n2']}" for r in recs]
    print(json.dumps({"kernels": [{
        "name": "transform_quantize", "route": "cuda",
        "source": "av1tpu_torch/csrc/transform_quant.cu",
        "replaces": "av1tpu/kernels/transform_quant.py:64",
        "launches": launches_fast + launches_quality,
        "launches_by_path": {"fast": launches_fast,
                             "quality": launches_quality},
        "max_abs_err": max(r["max_abs_err"] for r in recs),
        "ms": main_rec["device_us"] / 1e3,
        "plain_ms": main_rec["plain_device_us"] / 1e3,
        "bound_ms": main_rec["bound_us"] / 1e3,
        "bound_by": main_rec["bound_by"], "library_ms": None,
        **{k: dict(zip(shape_key, (r[k] for r in recs)))
           for k in ("device_us", "call_us", "host_us", "bound_us")}}]}),
        flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
