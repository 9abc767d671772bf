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
   (one warm-up run, one timed run).  The kernels' launch counters are
   set to 0 before the timed run and read after it: no transform_quantize
   launch (the probe's first-row chains are part_chain's), the probe's
   four kernels part_launches(1088, 1920) times for the one probed frame
   (1 part_chain, 134 part_pred, 134 part_code, 66 part_merge), and
   wave_key once for the wavefront keyframe.  The probe's arguments are
   caught for phase 7e.  Spies
   assert that the keyframe recon, the inter carry (recon and MV field)
   and GOLDEN live on the card, and the bytes must come out below the fast
   preset's.  Each cdef_filter launch of the run is timed on its own
   input, caught in the warm-up, and the live share and time of the
   keyframe's (its strength search and filter) and of the inter frames'
   are printed (cdef_path).
7b. wave_key vs plain, on phase 7's keyframe with the CLI's arguments
   (wave_vs_plain): (a) the plain keyframe on the card with wave_key run
   over each diagonal [d, d + 1) from its carried state: recon identical
   wherever pick, tx depth and levels agree, levels within 1 where the
   decisions agree, at most 0.1% of the 8,160 lanes with another pick or
   tx depth (each printed with the plain costs of both choices); then the
   whole keyframe in one launch against the plain one, block by block;
   (b) the kernel's keyframe through encode_intra_wave: PSNR-Y within
   0.05 dB and nonzero levels within 1% of the plain one; (c) its device
   time (one launch queued behind a sleep), its time with the host (an
   event pair), the mean time of a one-diagonal launch, the plain
   keyframe's time, and the bound (wave_key_bound);
7c. inter kernels vs plain, on phase 7's first inter frame with the CLI's
   arguments (inter_vs_plain): (a) the partition RDO with code_blocks and
   with its plain version on the card: differing levels and skip, split
   and merge decisions (at most 0.1% of the 8,160 blocks), recon identical
   in every block whose decisions and levels agree; (b) each of the frame's
   8 coder batches on identical inputs (levels, recon and SSE exact, rate
   and skip SSE within 1e-4) and cdef_filter on the step's CDEF input
   (every pixel equal); (c) the whole step both ways; (d) device time per
   launch of each batch (coder_times) and of the CDEF (cdef_times: the
   step's input, its share of live units, and the frame with no unit
   skipped at the strongest preset at 8 and 10 bits), the plain versions'
   time, the cuBLAS forward product's time, each batch's blocks without a
   level, the bounds (code_bounds; cdef_bounds: the larger of bytes and
   the live units' int32 operations, both printed) and the -Xptxas -v
   lines of cdef_kernel.  Where $AV1TPU_SMOKE_OUT is set, the 8 batches go
   to coder_inputs.pt there, for tools/search_compare.py --coder, and the
   CDEF input to cdef_inputs.pt, for --cdef;
7d. search and deblock kernels vs plain, on phase 7's first inter frame
   and its temporal filter's first neighbour (search_deblock_vs_plain):
   (a) the motion search (coarse_search, global_search, refine_subpel)
   and its plain versions on the card from the same inputs, without and
   with a temporal base and at the temporal filter's lambda: every output
   equal (mv8, mv_px, pred_y, p40, coarse, coarse2, shifts4, c0, g_full,
   sad_g), any differing block printed with both values; (b)
   deblock_planes through deblock_edges (one launch per plane, both
   directions) and through its plain version on the quality step's recon
   (edge gates and split16), the fast step's recon and a 10-bit frame:
   every pixel equal; (c) each wrapper's device time per call and per
   launch, per search and per frame (deblock per plane, deblock_times),
   the plain versions' time, and the bounds (search_bounds: the larger of
   bytes and int32 operations at the card's int32 rate, both printed;
   deblock_bounds: bytes, integer work not counted); coarse_search's
   three launches one by one (torch.profiler, kernel_us_by_name); the
   -Xptxas -v lines of deblock_kernel.  Where $AV1TPU_SMOKE_OUT is set,
   the inter frame's pair, lambda and peak go to search_inputs.pt there,
   for tools/search_compare.py --inputs, and the quality step's deblock
   planes, maps and levels to deblock_inputs.pt, for --deblock;
7e. probe kernels vs plain, on phase 7's probed frame at its q and on a
   10-bit frame made from it (probe_vs_plain): (a) every call of the four
   probe kernels (part_chain, part_pred, part_code, part_merge) beside its
   plain version on copies of the same inputs: differing decisions (modes,
   split, split64) printed with their costs, levels and pixels equal
   wherever a stage's decisions agree; (b) the whole probe both ways:
   every output grid, the count of differing decisions, levels and
   pixels (at most 0.1% of the decisions); (c) per kernel, the 8-bit
   frame's calls replayed: device time per probed frame (queued behind a
   sleep kernel), launches per frame, the plain version's time and the
   bound (part_bounds), part_chain's serial floor (chain_floor_us);
   part_chain per job on both frames (chain_times: all three planes, luma,
   U and V alone, the sha256 of each plane's levels and recon); part_code
   per launch kind (code_kinds: device time per launch and per frame,
   launches, columns, CTAs with work, each site's jobs alone, the columns
   per site whose chosen candidate has no level) and the -Xptxas -v lines
   of the four kernels (part_pred's and part_merge's calls back to back:
   each may start during the previous one's tail, PDL); (d) the probe's
   host time with the kernels and with the plain versions, and its device
   busy time with the kernels (torch.profiler: the probe's other
   operations overfill the launch queue, so it cannot wait behind a sleep
   kernel); (e) the floor of a launch (empty_launch_us: an empty kernel,
   without and with programmatic stream serialization), the probe's
   device sequence per frame (capture_probe_sequence, sequence_us: chain,
   preds, cuBLAS products, codes and merges replayed, its luma and its
   chroma part each behind a sleep kernel, events around each part only,
   summed, five times: the launch queue does not hold the whole frame;
   the replay's outputs
   equal the probe's, their sha256 and that of each luma merge's region
   costs printed) and part_pred's and part_merge's launch kinds
   (pred_merge_kinds).  Where $AV1TPU_SMOKE_OUT is set, the 8-bit frame's
   planes and q go to probe_inputs.pt there, for tools/search_compare.py
   --probe;
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
   recon and the inter carry on the card, the probe kernels' launches of
   one probed frame per scene and no transform_quantize launch.  Then the
   metric pass alone at 1088x1920
   (tpu_vmaf, SSIM, PSNR), timed and held against the CPU;
10. the same command with --layers 2: bytes at most 1.02 times phase 9's
   (the bound tests/test_layers.py holds the reference to), PSNR-Y >= 30,
   the launches of phase 9;
11. the same command with --all-intra --max-frames 4, each preset: the
   kernel launches equal the count derived from the code (fast: 187
   transform_quantize launches per frame, the keyframe's U+V stack, plus
   the probe's 374; quality: no transform_quantize launch, the probe
   kernels' launches of one frame per coded frame and per probe);
12. scene batch: encode_clip(workers=2) on the batch path (parallel/gop.py,
   one worker process per device).  (a) On the two-scene clip (quality
   preset), its TUs must equal workers=1 on the card and the CPU run of
   phase 6.  With two or more GPUs the command's own routing deals the
   scenes to two GPUs; with one, the card is listed twice, so two worker
   processes share it.  (b) A two-scene 1920x1080 clip (a forced cut, 2
   frames per scene, q 72, quality preset), workers=1 against the batch
   on two workers, after a warm-up at the small size in the parent and in
   each worker: encode seconds, scenes per second, key_device, bytes
   (equal), peak memory per device and process; the probe kernels'
   launches of one frame per scene, all in the parent's probe (no
   transform_quantize launch), and one wave_key launch per scene's
   keyframe, in the workers (in the parent at workers=1);
13. container and daemon.  (a) Where pkg-config finds libavcodec,
   libavformat and libavutil: the daemon's cycle, a 640x360 8-frame mpeg4
   mkv with a tone track in a library directory, `av1tpu-daemon --once`
   with deploy/config.torch.toml's template (the interpreter spelled as
   this one's; PYTHONPATH the checkout): the job's status and stage, the
   output's bytes, psnr_y and tpu_vmaf; the replaced file probed (AV1
   video, the tone) and decoded (8 frames).  Then, on every host, the same
   command in this process at --chunk 1 with ReconSpy on the keyframe
   recon after CDEF and each inter frame's, on that mkv (on the y4m of the
   same clip without libav): the probe kernels' launches of one 384x640
   frame per probed scene, no transform_quantize launch; with libav its 8
   TUs must equal the replaced file's
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

Every path's wave_key launches are asserted equal to its wavefront
keyframes, one launch each: one 1080p keyframe per scene in phases 7, 9,
10 and 12 (b), the 128x64 clip's two scenes in the workers of 12 (a), the
640x360 clip's scenes in 13 (a); none on the fast and all-intra paths.
Each cell's stream is printed as a sha256 (print_digest; phase 7's and
9's equal tools/time_encode.py's on the same checkout, for parent and
change in one call).  Those of code_blocks and cdef_filter are
asserted equal to what each path's scenes imply (coder_cdef_want, from
each scene's frames and chosen preset, spied by ScenePlan or reported by
the batch's workers): 8 code_blocks launches per quality inter frame, 3 per
fast one; per scene, one cdef_filter per nonzero preset of the keyframe's
strength search (7 of the 8) and, where the chosen preset is not all
zero, one for the keyframe and one per reference inter frame; none on the
all-intra paths.  Those of the motion search's three kernels and of
deblock_edges likewise (search_deblock_want): 3 + 3 + 2 launches per
search, one search per inter frame and one per temporal filter neighbour
(7 per scene of more than one frame, in the process that plans the
scenes: the scene batch's parent); one deblock_edges launch per plane
whose level is not 0, on the fast keyframe and every reference inter
frame; none on the all-intra paths.  Those of the probe's four kernels
equal models/intra_part.part_launches at the coded size times the path's
probed frames (one probe per scene, and on the all-intra quality path
every frame too; in the scene batch's parent), and transform_quantize
launches on no quality path.  The scene batch's workers report their
counts with each scene.  Phases 7 and 9 also hold bytes within 1%
and PSNR-Y within 0.05 dB of what these cells gave before the inter
step's kernels (362,224 B and 41.471 dB; 104,684 B; NVIDIA H100 80GB HBM3,
700.00 W; PERF.md).

The line before the last is the kernels' JSON record (launches summed over
the timed runs, with the count of each path beside it: transform_quantize,
wave_key, code_blocks, cdef_filter, coarse_search,
global_search, refine_subpel, deblock_edges, part_chain, part_pred,
part_code and part_merge); the last line
is {"ok": true, "device": {...}}.  Imports nothing of JAX or av1tpu.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import hashlib
import io
import json
import os
import re
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
    from av1tpu_torch.kernels import hand_kernels

    return hand_kernels()


def zero_launches() -> None:
    for k in kernel_wrappers():
        k.launches = 0


def read_launches() -> dict:
    """{kernel name: launches since zero_launches}."""
    return {k.__name__: k.launches for k in kernel_wrappers()}


def add_launches(a: dict, b: dict) -> dict:
    return {k: a.get(k, 0) + b.get(k, 0) for k in {*a, *b}}


def assert_wave(launches: dict, keyframes: int) -> None:
    """wave_key launched once for each of the path's `keyframes`
    wavefront keyframes, whatever their size."""
    assert launches["wave_key"] == keyframes, (launches["wave_key"],
                                               keyframes)


def print_digest(cell: str, stream) -> str:
    """Print and return the sha256 of a cell's stream: an IVF file's bytes
    (a path) or the concatenated temporal units (a list of bytes), so that
    two checkouts' streams can be held equal in one call
    (tools/time_encode.py prints the same digests)."""
    h = hashlib.sha256()
    if isinstance(stream, str):
        with open(stream, "rb") as f:
            h.update(f.read())
    else:
        for tu in stream:
            h.update(tu)
    print(f"{cell} stream sha256: {h.hexdigest()}", flush=True)
    return h.hexdigest()


PART_KERNELS = ("part_chain", "part_pred", "part_code", "part_merge")


def assert_part(launches: dict, frames: int, h: int | None = None,
                w: int | None = None) -> None:
    """Each probe kernel launched models/intra_part.part_launches(h, w)
    times for each of the path's `frames` probed frames (quality probes
    and all-intra quality frames) coded at h x w (default: the padded
    1080p frame)."""
    from av1tpu_torch.models.intra_part import part_launches

    per = part_launches(h or ROWS * 16, w or COLS * 16)
    got = {k: launches[k] for k in PART_KERNELS}
    want = {k: frames * per[k] for k in PART_KERNELS}
    assert got == want, (got, want)


# code_blocks launches per inter frame: the partitioned step codes luma and
# the U+V stack at the 16 grid, the 8x8 split, the 32 merge and the 64
# merge (models/inter_v.py:_inter_partition); the fast step codes Y, U and
# V apart (encode_inter_v)
CODER_SITES = {"quality": 8, "fast": 3}


def cdef_search_launches() -> int:
    """cdef_filter launches of one keyframe's strength search: one per
    preset that is not all zero (an all-zero preset passes through)."""
    from av1tpu_torch.models.cdef import CDEF_PRESETS

    return int(sum(bool(p.any()) for p in CDEF_PRESETS))


def coder_cdef_want(scenes, preset: str, layered: bool = False) -> dict:
    """The launches of code_blocks and cdef_filter that a GOP encode's
    scenes [(frames, chosen CDEF preset), ...] imply: every inter frame
    codes CODER_SITES[preset] batches; each scene's strength search filters
    once per nonzero preset, and where the chosen preset is not all zero,
    the keyframe and every reference inter frame are filtered once (a
    2-layer chunk's odd frames are no references)."""
    code = cdef = 0
    for n, chosen in scenes:
        code += CODER_SITES[preset] * (n - 1)
        refs = (n - 1) // 2 if layered else n - 1
        cdef += cdef_search_launches() + (1 + refs) * bool(np.any(chosen))
    return {"code_blocks": code, "cdef_filter": cdef}


def search_deblock_want(scenes, preset: str, layered: bool = False,
                        q: int = QINDEX, inter: bool = True) -> dict:
    """The launches of the motion search's three kernels and of
    deblock_edges that a GOP encode's scenes [(frames, chosen CDEF preset),
    ...] at q imply (the CLI's defaults: temporal filter on, the keyframe
    q boosted by KEY_Q_BOOST): one search per neighbour of each keyframe's
    temporal filter (7 per scene of more than one frame, in the process
    that plans the scenes) and, with inter, one per inter frame; each
    search launches COARSE_LAUNCHES + GLOBAL_LAUNCHES + REFINE_LAUNCHES
    kernels.  One deblock_edges launch (both directions) per plane whose
    level (models/deblock.py:lf_levels) is not 0, on the fast preset's
    keyframe (the wavefront keyframe signals its loop filter off) and on
    every reference inter frame.  The all-intra chunks run neither."""
    from av1tpu_torch.cli import KEY_Q_BOOST
    from av1tpu_torch.kernels import motion
    from av1tpu_torch.models.deblock import lf_levels

    def planes(qq):
        ly, _, lu, lv = lf_levels(qq)
        return sum(lvl > 0 for lvl in (ly, lu, lv))

    searches = filtered = 0
    for n, _ in scenes:
        searches += 7 * (n > 1)
        if not inter:
            continue
        searches += n - 1
        filtered += planes(q) * ((n - 1) // 2 if layered else n - 1)
        if preset == "fast":
            filtered += planes(max(q - KEY_Q_BOOST, 1) if n > 1 else q)
    return {"coarse_search": motion.COARSE_LAUNCHES * searches,
            "global_search": motion.GLOBAL_LAUNCHES * searches,
            "refine_subpel": motion.REFINE_LAUNCHES * searches,
            "deblock_edges": filtered}


def inter_want(scenes, preset: str, layered: bool = False,
               q: int = QINDEX) -> dict:
    """coder_cdef_want and search_deblock_want of a path that plans and
    codes its scenes in one process."""
    return {**coder_cdef_want(scenes, preset, layered),
            **search_deblock_want(scenes, preset, layered, q)}


def assert_coder_cdef(launches: dict, want: dict) -> None:
    got = {k: launches[k] for k in want}
    assert got == want, (got, want)


class ScenePlan:
    """While encodes run in this process, each scene's frame count (the
    segments of core/scenes.split_scenes) and its chosen CDEF preset
    (models/cdef.select_strengths), in order."""

    def __enter__(self):
        from av1tpu_torch.core import scenes
        from av1tpu_torch.models import cdef

        self.segments: list = []
        self.presets: list = []
        self.saved = ((scenes, "split_scenes", scenes.split_scenes,
                       self.segments.extend),
                      (cdef, "select_strengths", cdef.select_strengths,
                       self.presets.append))
        for mod, name, fn, keep in self.saved:
            setattr(mod, name, self._spy(fn, keep))
        return self

    @staticmethod
    def _spy(fn, keep):
        def spy(*a, **k):
            out = fn(*a, **k)
            keep(out)
            return out
        return spy

    def __exit__(self, *exc):
        for mod, name, fn, _ in self.saved:
            setattr(mod, name, fn)

    def scenes(self) -> list:
        """[(frames, chosen preset)] of the scenes coded in this process."""
        assert len(self.segments) == len(self.presets), (self.segments,
                                                         self.presets)
        return [(e - s, p) for (s, e), p in zip(self.segments, self.presets)]


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


def _timed_slice(torch, clip, name: str, partitions: bool,
                 after_warm_up=None):
    """One warm-up and one timed 1080p encode with the kernels' launch
    counts set to 0 just before the timed run and read just after;
    after_warm_up, where given, is called between the two.  Returns
    (streams, stats, launches by kernel)."""
    from av1tpu_torch.cli import encode_clip

    kw = dict(chunk=CHUNK, metric="psnr", gop=True, partitions=partitions,
              device="cuda")
    t = time.perf_counter()
    encode_clip(clip, QINDEX, **kw)                      # warm-up
    torch.cuda.synchronize()
    print(f"{name} warm-up: {time.perf_counter() - t:.3f} s", flush=True)
    if after_warm_up:
        after_warm_up()
    torch.cuda.reset_peak_memory_stats()
    zero_launches()
    with ScenePlan() as plan:
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
    print_digest(name, streams)
    assert stats["scenes"] == 1, stats["scenes"]
    assert stats["psnr_y"] >= 30.0, stats["psnr_y"]
    assert_coder_cdef(launches, inter_want(
        plan.scenes(), "quality" if partitions else "fast"))
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
    arguments of its wavefront keyframe, of its first inter chunk, of its
    first temporal filter and of its probe): no transform_quantize launch,
    the probe kernels' launches of one probed frame (one frame is probed
    per scene at a fixed q), each wavefront kernel once per diagonal of
    the scene's keyframe."""
    import av1tpu_torch.models.cdef as mcdef
    import av1tpu_torch.models.inter_v as inter_v
    import av1tpu_torch.models.intra_part as intra_part
    import av1tpu_torch.models.intra_wave as intra_wave
    import av1tpu_torch.models.tfilter as tfilter

    seen = {"key": set(), "carry": set(), "mv": set(), "golden": set()}
    key_fn, gop_fn, tf_fn = (intra_wave.encode_intra_wave_key_recon,
                             inter_v.encode_gop_chunk_part,
                             tfilter.temporal_filter_key)

    key_args: list = []
    gop_args: list = []
    tf_args: list = []
    probe_args: list = []
    cdef_inputs: list = []
    timed: list = []

    def cdef_spy(y, u, v, skip8, pri_y, sec_y, pri_uv, sec_uv, damping=3,
                 bit_depth=8):
        strengths = tuple(int(x) for x in (pri_y, sec_y, pri_uv, sec_uv))
        if any(strengths) and not timed:    # a warm-up launch, to the host
            cdef_inputs.append(([p.to(torch.int16).cpu() for p in (y, u, v)],
                                skip8.cpu(), strengths, damping, bit_depth))
        return cdef_fn(y, u, v, skip8, pri_y, sec_y, pri_uv, sec_uv,
                       damping, bit_depth)

    def probe_spy(*a, **k):
        if not probe_args:
            probe_args.append((a, k))
        return probe_fn(*a, **k)

    def tf_spy(*a, **k):
        if not tf_args:
            tf_args.append((a, k))
        return tf_fn(*a, **k)

    def key_spy(*a, **k):
        buf, recon = key_fn(*a, **k)
        seen["key"].add(recon.device.type)
        key_args.append((a, k))
        return buf, recon

    def gop_spy(*a, **k):
        if not gop_args:
            gop_args.append((a, k))
        seen["golden"].add(k["gld_fused"].device.type)
        bufs, ref, mv = gop_fn(*a, **k)
        seen["carry"].add(ref.device.type)
        seen["mv"].add(mv.device.type)
        return bufs, ref, mv

    probe_fn = intra_part.encode_intra_part
    cdef_fn = mcdef.cdef_planes
    intra_wave.encode_intra_wave_key_recon = key_spy
    inter_v.encode_gop_chunk_part = gop_spy
    tfilter.temporal_filter_key = tf_spy
    intra_part.encode_intra_part = probe_spy
    mcdef.cdef_planes = cdef_spy
    try:
        _, stats, launches = _timed_slice(torch, clip, "quality slice", True,
                                          lambda: timed.append(True))
    finally:
        intra_wave.encode_intra_wave_key_recon = key_fn
        inter_v.encode_gop_chunk_part = gop_fn
        tfilter.temporal_filter_key = tf_fn
        intra_part.encode_intra_part = probe_fn
        mcdef.cdef_planes = cdef_fn
    assert len(cdef_inputs) == launches["cdef_filter"], len(cdef_inputs)
    cdef_path(torch, cdef_inputs)
    assert launches["transform_quantize"] == 0, launches
    assert_part(launches, stats["scenes"])
    assert_wave(launches, stats["scenes"])
    assert all(v == {"cuda"} for v in seen.values()), seen
    print(f"quality vs fast at {clip.num_frames} frames: bytes "
          f"{stats['bytes']} vs {fast_stats['bytes']}, psnr_y "
          f"{stats['psnr_y']} vs {fast_stats['psnr_y']}, fps "
          f"{stats['encode_fps']} vs {fast_stats['encode_fps']}", flush=True)
    assert stats["bytes"] < fast_stats["bytes"]
    # this cell before the inter step's kernels (NVIDIA H100 80GB HBM3,
    # 700.00 W; PERF.md): they may flip a near-tie, not move the stream
    assert abs(stats["bytes"] - 362224) <= 0.01 * 362224, stats["bytes"]
    assert abs(stats["psnr_y"] - 41.471) <= 0.05, stats["psnr_y"]
    return launches, key_args[-1], gop_args[0], tf_args[0], probe_args[0]


def cdef_path(torch, calls) -> None:
    """Phase 7's cdef_filter launches, caught in its warm-up encode (which
    the timed one repeats launch for launch; calls: each one's planes,
    skip map, preset, damping and bit depth, in order), each timed on its
    own input (cdef_path_cases, cdef_times): the live share and the time
    of the keyframe's (its strength search, then its filter) and of the
    inter frames'.  With $AV1TPU_SMOKE_OUT they are saved as
    cdef_path_inputs.pt for tools/search_compare.py --cdef."""
    from av1tpu_torch.kernels import cdef as kcdef

    out = os.environ.get("AV1TPU_SMOKE_OUT")
    if out:
        os.makedirs(out, exist_ok=True)
        torch.save({"calls": calls}, os.path.join(out, "cdef_path_inputs.pt"))
    recs = cdef_times(torch, kcdef, cdef_path_cases(torch, calls),
                      plain=False)
    for line in cdef_path_summary(recs):
        print(f"cdef_filter on phase 7's {line['launches']} {line['part']} "
              f"launches: live units min {line['live_min']:.6f}, median "
              f"{line['live_median']:.6f}, max {line['live_max']:.6f}; "
              f"device {line['device_us']:.3f} us in all (a launch "
              f"{line['us_min']:.3f} to {line['us_max']:.3f}), bound "
              f"{line['bound_us']:.4f} us", flush=True)


def wave_key_bound(lanes: int) -> tuple[float, str]:
    """Least time of wave_key coding `lanes` lanes, in ms, and what bounds
    it: the larger of the fp32 operations of the forward products at the
    fp32 peak (per lane 13 candidate 256x256 products, 4 8x8 and 16 4x4
    sub-block products and 2 chroma 8x8 products; the integer inverse,
    quantize and rate work are not counted) and the bytes at the memory
    rate (every table read once per launch, each lane's schedule entry,
    source and neighbours' edges read once, its grids and ready flag
    written once).  The work is the same for any data: every candidate and
    sub-block is coded."""
    tables = 4 * 4 * (256 * 256 + 64 * 64 + 16 * 16)    # forward matrices
    tables += 4 * (3 * 256 + 3 * 64 + 3 * 16 + 3 * 64)   # quantizer rows
    tables += 4 * (4 * 256 + 4 * 64 + 4 * 16 + 64)      # gains
    tables += 4 * (4 * 256 + 257 + 65 + 17 + 6) + 4 * (256 + 64 + 16)
    edges = 4 * (16 + 16 + 16 + 1) + 2 * 4 * 16         # luma, chroma
    lane_in = 4 + 4 * (256 + 2 * 64) + edges
    lane_out = 4 * 256 + 2 * 256 + 2 * (4 * 64 + 2 * 64) + 2 + 4
    ops = lanes * (13 * 2 * 256 * 256 + 4 * 2 * 64 * 64 + 16 * 2 * 16 * 16
                   + 2 * 2 * 64 * 64)
    nbytes = tables + lanes * (lane_in + lane_out)
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def wave_vs_plain(torch, key_args) -> dict:
    """Phase 7b: wave_key against its plain version on the keyframe that
    phase 7's quality encode coded (the temporally filtered first frame
    of the 1080p clip, with the CLI's key q, lam_scale, noise gate and bit
    depth).  (a) The plain keyframe on the card, and at every diagonal d
    the kernel over [d, d + 1) from its carried state (wave_compare):
    wherever pick, tx depth and levels agree the recon must be identical,
    where the decisions agree a level may differ by 1 only, and at most
    0.1% of the lanes may take another pick or tx depth (each printed with
    the plain version's costs of both choices), and at most 0.1% differ in
    a level only; then the whole keyframe in one launch against the plain
    one, block by block, under the same limits (decisions and levels
    together at most 0.1%), and against the kernel's own chain of
    one-diagonal launches bit for bit (the one launch alone waits on the
    ready flags: a lost wait shows here).  (b) The kernel's keyframe through encode_intra_wave against
    the plain one: PSNR-Y within 0.05 dB, nonzero levels within 1%.  (c)
    Times: the keyframe's one launch on the device (queued behind a sleep)
    and with the host (encode_intra_wave, an event pair), the mean device
    time of a one-diagonal launch, the plain keyframe's time, and the
    bound (wave_key_bound).  Returns the kernel's record for the JSON
    line."""
    from av1tpu_torch._build import cuda_lib
    from av1tpu_torch.kernels.intra_wave import wave_compare, wave_key
    from av1tpu_torch.models.intra_v import unfuse
    from av1tpu_torch.models.intra_wave import (
        encode_intra_wave, wave_outputs, wave_setup,
    )

    (frame, q, h, w), kw = key_args[0][:4], key_args[1]
    lam_scale, gate, bd = kw["lam_scale"], kw["noise_gate"], kw["bit_depth"]
    y, u, v = unfuse(frame, h, w)
    print(f"wave keyframe: {w}x{h} q={q} lam_scale={lam_scale} "
          f"noise_gate={gate} bit_depth={bd}", flush=True)

    # (a) same input, per diagonal, then the whole keyframe
    t = time.perf_counter()
    o = wave_compare(y, u, v, q, bd, lam_scale, gate,
                     sync=torch.cuda.synchronize)
    compare_s = time.perf_counter() - t
    flips = o["picks"] + o["txds"]
    for f in flips:
        print(f"wave decision differs: {json.dumps(f)}", flush=True)
    whole = o["whole"]
    print(f"wave same-input: lanes={o['lanes']} pick_differs="
          f"{len(o['picks'])} txd_differs={len(o['txds'])} "
          f"level_only_lanes={o['level_lanes']} (max |diff| "
          f"{o['level_max_diff']}) recon_mismatch_lanes={o['recon_lanes']}; "
          f"whole keyframe in one launch vs plain, blocks differing: "
          f"{json.dumps(whole)}; vs the kernel's one-diagonal chain: "
          f"{json.dumps(o['chain'])}; plain keyframe "
          f"{o['plain_seconds']:.3f} s of {compare_s:.3f} s", flush=True)
    few = o["lanes"] // 1000
    assert o["recon_lanes"] == 0, o["recon_lanes"]
    assert o["level_max_diff"] <= 1, o["level_max_diff"]
    assert len(flips) <= few, len(flips)
    assert o["level_lanes"] <= few, o["level_lanes"]
    assert whole["recon"] == 0 and whole["level_max_diff"] <= 1, whole
    assert whole["modes"] + whole["txds"] + whole["levels"] <= few, whole
    assert not any(v for k, v in o["chain"].items() if k != "blocks"), (
        o["chain"])

    # (b) the kernel's keyframe through the encode's entry (the first run
    # warms up)
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
          f"{txd_diff} of {k['modes'].numel()} blocks; psnr_y kernel {pk} "
          f"plain {pp}; nonzero levels kernel {nk} plain {npl}", flush=True)
    assert abs(pk - pp) <= 0.05, (pk, pp)
    assert abs(nk - npl) <= 0.01 * npl, (nk, npl)

    # (c) times
    tabs, src, sched, grids = wave_setup(y, u, v, q, bd, lam_scale, gate)

    def key():
        wave_key(*src, *grids, tabs, sched, 0, sched.nd)

    def per_diagonal():
        for d in range(sched.nd):
            wave_key(*src, *grids, tabs, sched, d, d + 1)

    key()
    assert all(torch.equal(x, z) for x, z in zip(
        wave_outputs(grids).values(), k.values()))
    lanes = sched.starts[-1]
    key_dev = device_us(torch, key, 10) / 1e3
    diag_dev = device_us(torch, per_diagonal, 1,
                         sleep_cycles=8 * SLEEP_CYCLES) / 1e3 / sched.nd
    bound, by = wave_key_bound(lanes)
    plain_ms = o["plain_seconds"] * 1e3
    lib = cuda_lib()
    clusters, smem = lib.av1_wave_key_clusters(), lib.av1_wave_key_smem()
    print(f"wave_key keyframe ({lanes} lanes, {sched.nd} diagonals, 1 "
          f"launch of {clusters} clusters of 4 CTAs, {smem} B of shared "
          f"memory each): device {key_dev:.3f} ms queued behind a sleep, "
          f"{key_ms:.3f} ms with the host (events around "
          f"encode_intra_wave); one-diagonal launches {diag_dev * 1e3:.3f} "
          f"us each on average ({diag_dev * sched.nd:.3f} ms for the "
          f"{sched.nd}); plain keyframe {plain_ms:.1f} ms; bound "
          f"{bound:.4f} ms ({by}, roofline {bound / key_dev:.4f})",
          flush=True)
    return {"wave_key": {
        "lanes": lanes, "diagonals": sched.nd, "clusters": clusters,
        "cta_shared_bytes": smem, "ms": key_dev,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "keyframe_ms": key_ms, "per_diagonal_ms": diag_dev,
        "decisions_differ": len(flips), "whole_differs": whole,
        "whole_vs_chain": o["chain"],
        "max_abs_err": max(o["level_max_diff"], whole["level_max_diff"])}}


def code_bounds(b: int, n: int) -> tuple[float, str]:
    """Least time of one code_blocks launch on b blocks of n x n, in us:
    the larger of its float32 operations at the fp32 peak (per coded
    coefficient the quantize's divide and add, rd_zero's seven and the
    rate's add; the integer inverse, recon and SSEs are not counted) and
    its bytes at the memory rate (coefficients, source and prediction read
    once; levels, recon and three per-block floats written once; the
    plane's rows read once)."""
    nc = min(n, 32) ** 2
    ops = b * nc * 10
    nbytes = (4 * b * nc + 2 * 4 * b * n * n + 4 * b * nc + 4 * b * n * n
              + 3 * 4 * b + 4 * (7 * nc + 256 + 2 + nc + 1))
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e6,
            "operations" if t_ops >= t_bytes else "bytes")


def coder_key(src, plane) -> str:
    """A coder batch's name: n x n / dq_shift / blocks."""
    return f"{plane.n}x{plane.n}/{plane.dq_shift}/{src.shape[0]}"


def coder_times(torch, inter_code, sites, plain: bool = True) -> list:
    """One timing of code_blocks of the module inter_code (a checkout's
    kernels/inter_code.py) on each coder batch (coefs, src, pred, plane),
    in order: (device us per launch, device_us over 100 launches queued
    behind a sleep; the plain version's median event time in ms where
    plain, else None).  Phase 7c and tools/search_compare.py --coder time
    with it."""
    return [(device_us(torch, lambda: inter_code.code_blocks(
                coefs, src, pred, plane), 100),
             _median_ms(torch, lambda: inter_code.code_blocks_plain(
                 coefs, src, pred, plane), n=5) if plain else None)
            for coefs, src, pred, plane in sites]


CODER_PLANE_ARGS = ("n", "step", "q", "cap", "gains", "tab", "lam", "gate",
                    "dq_shift", "bit_depth", "skip", "rank", "eob")


def save_coder_inputs(torch, sites, path: str) -> None:
    """Phase 7c's coder batches to path: each batch's coefficients, source
    and prediction, and its CodePlane's arguments, on the CPU (lam as a
    Python float)."""
    def cpu(k, v):
        if isinstance(v, torch.Tensor):
            return v.cpu()
        return float(v) if k == "lam" else v

    torch.save([{"coefs": c.cpu(), "src": s.cpu(), "pred": p.cpu(),
                 "plane": {k: cpu(k, getattr(pl, k))
                           for k in CODER_PLANE_ARGS}}
                for c, s, p, pl in sites], path)


def load_coder_inputs(torch, inter_code, path: str, dev) -> list:
    """save_coder_inputs' batches on dev, each plane built by the module
    inter_code's CodePlane (a checkout's kernels/inter_code.py)."""
    sites = []
    for d in torch.load(path):
        kw = {k: (v.to(dev) if isinstance(v, torch.Tensor) else v)
              for k, v in d["plane"].items()}
        kw["lam"] = np.float32(kw["lam"])
        sites.append((d["coefs"].to(dev), d["src"].to(dev),
                      d["pred"].to(dev), inter_code.CodePlane(**kw)))
    return sites


def kernel_us_by_name(torch, fn, n: int = 20) -> dict:
    """fn() run n times after a warm-up under torch.profiler (CUDA
    activity): {device kernel name: mean device us per launch}, in the
    order the kernels first ran."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    tot, count = {}, {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            tot[e.name] = tot.get(e.name, 0.0) + (e.time_range.end
                                                  - e.time_range.start)
            count[e.name] = count.get(e.name, 0) + 1
    return {k: tot[k] / count[k] for k in tot}


def _short(kernel_name: str) -> str:
    """A device kernel's name without its namespace and parameters."""
    m = re.search(r"::(\w+)[<(]", kernel_name)
    return m.group(1) if m else kernel_name[:40]


# int32 operations of cdef_filter per live 8x8 unit (chip_smoke.search_ops'
# convention: an add, a multiply-add, a min, a max, a shift or a select is
# one operation).  The direction search: per pixel its value (a shift and
# a subtract) and eight partial sums, per bin of the 90 a square and a
# multiply-add into the cost, the argmax and the variance (16).  The
# filter, per pixel of a plane whose strengths are not zero: 12 taps of 11
# (the difference, constrain's abs, shift, subtract, clamp at 0, min and
# sign, the tap weight's multiply-add, the min, the max and its
# CDEF_VERY_LARGE select), then the rounding (3) and the clamp (2).
CDEF_SEARCH_OPS = 64 * (2 + 8) + 90 * 2 + 16
CDEF_PIXEL_OPS = 12 * 11 + 5


def cdef_ops(skip8, pri_y: int, sec_y: int, pri_uv: int, sec_uv: int) -> int:
    """The int32 operations one cdef_filter call needs on this skip map
    and preset: per unit that skip8 leaves on, the direction search where a
    primary strength is not zero, and the filter of its 64 luma pixels and
    2 x 16 chroma pixels where that plane's strengths are not zero."""
    live = int((~skip8).sum())
    per_unit = ((CDEF_SEARCH_OPS if pri_y or pri_uv else 0)
                + (64 * CDEF_PIXEL_OPS if pri_y or sec_y else 0)
                + (32 * CDEF_PIXEL_OPS if pri_uv or sec_uv else 0))
    return live * per_unit


def cdef_bounds(skip8, strengths) -> dict:
    """Least time of one cdef_filter launch, in us: the larger of its
    bytes at the memory rate (the three int32 planes read once and written
    once, the skip map and the 90 direction weights read once) and its
    int32 operations on this skip map (cdef_ops) at the card's int32 rate
    (int32_rate).  Returns bound_us, bound_by, bytes_us, ops_us and the
    share of live units."""
    h, w = 8 * skip8.shape[0], 8 * skip8.shape[1]
    nbytes = 2 * 4 * (h * w * 3 // 2) + (h // 8) * (w // 8) + 4 * 90
    t_bytes = nbytes / PEAK_BYTES * 1e6
    t_ops = cdef_ops(skip8, *strengths) / int32_rate()[0] * 1e6
    return {"bound_us": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "bytes_us": t_bytes, "ops_us": t_ops,
            "live_share": float((~skip8).float().mean())}


def cdef_cases(torch, cargs) -> list:
    """The inputs cdef_filter is timed on: phase 7c's (the CDEF input of
    the first inter frame with its skip map and preset), then that frame
    with no unit skipped at the strongest preset of the strength search,
    at 8 and 10 bits (the planes times 4 plus 2).  (label, args) each."""
    from av1tpu_torch.models.cdef import CDEF_PRESETS

    y, u, v, skip8 = cargs[:4]
    strongest = tuple(int(x) for x in CDEF_PRESETS[-1])
    dense = torch.zeros_like(skip8)
    ten = [p * 4 + 2 for p in (y, u, v)]
    return [("phase 7c", cargs),
            ("dense 8-bit", (y, u, v, dense, *strongest, 3, 8)),
            ("dense 10-bit", (*ten, dense, *strongest, 3, 10))]


def cdef_path_cases(torch, calls) -> list:
    """Phase 7's cdef_filter launches as cases on the card: the first
    cdef_search_launches() + 1 the keyframe's, the rest the inter
    frames'.  (label, args) each."""
    nkey = cdef_search_launches() + 1
    return [(f"{'keyframe' if i < nkey else 'inter'} {i} {tuple(pre)}",
             (*(p.cuda().to(torch.int32) for p in planes), skip8.cuda(), *pre,
              damping, bd))
            for i, (planes, skip8, pre, damping, bd) in enumerate(calls)]


def cdef_path_summary(recs) -> list:
    """cdef_times' records of cdef_path_cases, summed per part (keyframe,
    inter): launches, live share and device us per launch (min, median,
    max), device and bound us in all."""
    out = []
    for part in ("keyframe", "inter"):
        rs = [r for r in recs if r["case"].split()[0] == part]
        live = sorted(r["live_share"] for r in rs)
        us = sorted(r["device_us"] for r in rs)
        out.append({"part": part, "launches": len(rs), "live_min": live[0],
                    "live_median": live[len(live) // 2],
                    "live_max": live[-1], "us_min": us[0],
                    "us_median": us[len(us) // 2], "us_max": us[-1],
                    "device_us": sum(us),
                    "bound_us": sum(r["bound_us"] for r in rs)})
    return out


def cdef_times(torch, kcdef, cases, plain: bool = True) -> list:
    """Each case's cdef_filter time (device_us, 100 launches behind a sleep
    kernel), its bounds (cdef_bounds), the plain version's time (CUDA
    events) where asked, and a sha256 of the three output planes: one
    record per case.  Phase 7c and tools/search_compare.py --cdef time with
    it."""
    out = []
    for label, args in cases:
        got = kcdef.cdef_filter(*args)
        torch.cuda.synchronize()
        digest = hashlib.sha256(b"".join(
            p.cpu().numpy().tobytes() for p in got)).hexdigest()
        rec = {"case": label, "bit_depth": args[-1],
               "device_us": device_us(torch, lambda: kcdef.cdef_filter(*args),
                                      100),
               **cdef_bounds(args[3], args[4:8]), "sha256": digest}
        if plain:
            rec["plain_ms"] = _median_ms(
                torch, lambda: kcdef.cdef_filter_plain(*args), n=5)
        out.append(rec)
    return out


@contextlib.contextmanager
def plain_inter_kernels():
    """Within the block the inter step's code_blocks and cdef_filter run
    their plain versions (on the tensors' device, the card): the plain
    side of a kernel-versus-plain comparison."""
    from av1tpu_torch.kernels import cdef as kcdef
    from av1tpu_torch.kernels import inter_code
    from av1tpu_torch.models import inter_v

    saved = (inter_v.code_blocks, kcdef.cdef_filter)
    inter_v.code_blocks = inter_code.code_blocks_plain
    kcdef.cdef_filter = kcdef.cdef_filter_plain
    try:
        yield
    finally:
        inter_v.code_blocks, kcdef.cdef_filter = saved


def inter_vs_plain(torch, gop_args) -> dict:
    """Phase 7c: the inter step's two kernels against their plain versions
    on phase 7's first 1080p inter frame (its arguments caught by the GOP
    spy).  (a) encode_inter_part with code_blocks and with its plain
    version on the card from the same inputs: differing levels, and the
    skip (a block's levels all zero), split and merge decisions, at most
    0.1% of the blocks; the recon identical in every 16x16 block whose
    decisions and levels agree.  (b) Each of the frame's 8 coder batches,
    the kernel against the plain version on the same inputs: levels, recon
    and SSE exact, rate and skip SSE within 1e-4; and the step's CDEF
    input, cdef_filter against its plain version: every pixel equal.  (c)
    The whole step both ways: its buffer and recon.  (d) Times: each batch
    and the CDEF (device per launch queued behind a sleep, the plain
    version's event time, the cuBLAS product's device time), with the
    bounds.  Returns the two kernels' records for the JSON line."""
    from av1tpu_torch.kernels import cdef as kcdef
    from av1tpu_torch.kernels import inter_code
    from av1tpu_torch.models import cdef as mcdef
    from av1tpu_torch.models import inter_v
    from av1tpu_torch.models.intra_v import unfuse
    from av1tpu_torch.state import tables

    (frames, ref, q, h, w), kw = gop_args[0][:5], gop_args[1]
    bd, gate = kw["bit_depth"], kw["noise_gate"]
    lf3 = tuple(int(x) for x in kw["lf"]) if any(kw["lf"]) else None
    cdef_s = tuple(int(x) for x in kw["cdef_s"])
    prev_mv = (kw["prev_mv"] if kw["prev_mv"] is not None else
               torch.zeros((h // 16, w // 16, 2), dtype=torch.int32,
                           device=ref.device))
    y, u, v = unfuse(frames[0], h, w)
    planes = (y, u, v, *unfuse(ref, h, w))
    gld = dict(zip(("gld_y", "gld_u", "gld_v"),
                   unfuse(kw["gld_fused"], h, w)))
    print(f"inter frame: {w}x{h} q={q} lf={lf3} cdef={cdef_s} "
          f"noise_gate={gate} bit_depth={bd}", flush=True)

    # (a) the partition RDO, kernel vs plain, from the same inputs; the
    # kernel run also catches each coder batch's inputs
    sites = []
    coder = inter_v.code_blocks

    def catch(coefs, src, pred, plane):
        sites.append((coefs, src, pred, plane))
        return coder(coefs, src, pred, plane)

    inter_v.code_blocks = catch
    try:
        ko = inter_v.encode_inter_part(*planes, q, bit_depth=bd,
                                       prev_mv=prev_mv, noise_gate=gate,
                                       **gld)
    finally:
        inter_v.code_blocks = coder
    assert len(sites) == CODER_SITES["quality"], len(sites)
    with plain_inter_kernels():
        po = inter_v.encode_inter_part(*planes, q, bit_depth=bd,
                                       prev_mv=prev_mv, noise_gate=gate,
                                       **gld)
    torch.cuda.synchronize()
    assert torch.equal(ko["mv"], po["mv"]) and torch.equal(ko["ref16"],
                                                           po["ref16"])
    rows, cols = h // 16, w // 16
    level_diff = {k: int((ko[k] != po[k]).sum()) for k in (
        "lv16", "lu8", "lv8", "lv32", "lu16", "lv16c", "lv64", "lu32",
        "lv32c", "lv8y", "lu4", "lv4")}
    max_level = max(int((ko[k].int() - po[k].int()).abs().max())
                    for k in level_diff)

    def per16(a, f):
        """A per-f-grid map (r/f, c/f) at the 16 grid."""
        return a.repeat_interleave(f, 0).repeat_interleave(f, 1)

    agree = torch.ones((rows, cols), dtype=torch.bool, device=y.device)
    decisions = {}
    for name, f in (("split16", 1), ("split32", 2), ("split64", 4)):
        d = ko[name] != po[name]
        decisions[name] = int(d.sum())
        agree &= ~per16(d, f)
    skip_diff = 0
    for f, names in ((1, ("lv16", "lu8", "lv8")),
                     (2, ("lv32", "lu16", "lv16c")),
                     (4, ("lv64", "lu32", "lv32c"))):
        zk = torch.stack([(ko[n] == 0).flatten(2).all(2) for n in names]
                         ).all(0)
        zp = torch.stack([(po[n] == 0).flatten(2).all(2) for n in names]
                         ).all(0)
        skip_diff += int((zk != zp).sum())
        for n in names:
            agree &= ~per16((ko[n] != po[n]).flatten(2).any(2), f)
    for n, sub in (("lv8y", 2), ("lu4", 2), ("lv4", 2)):
        d = (ko[n] != po[n]).flatten(2).any(2)
        agree &= ~d.reshape(rows, sub, cols, sub).any(3).any(1)
    decisions["skip"] = skip_diff
    recon_mismatch = 0
    for n, b in (("recon_y", 16), ("recon_u", 8), ("recon_v", 8)):
        d = (ko[n] != po[n]).reshape(rows, b, cols, b).any(3).any(1)
        recon_mismatch += int((d & agree).sum())
    print(f"inter same-input: blocks={rows * cols} decisions differ "
          f"{decisions}, levels differ {level_diff} (max |diff| "
          f"{max_level}), blocks whose decisions and levels agree "
          f"{int(agree.sum())}, recon mismatches among them "
          f"{recon_mismatch}", flush=True)
    assert recon_mismatch == 0, recon_mismatch
    assert sum(decisions.values()) <= rows * cols // 1000, decisions

    # (b) each batch on identical inputs, and the step's CDEF input
    site_err = {"levels": 0, "rate_rel": 0.0, "dskip_rel": 0.0}
    for coefs, src, pred, plane in sites:
        got = inter_code.code_blocks(coefs, src, pred, plane)
        want = inter_code.code_blocks_plain(coefs, src, pred, plane)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got[:3], want[:3])), (
            plane.n, plane.dq_shift)
        for i, key in ((3, "rate_rel"), (4, "dskip_rel")):
            rel = float(((got[i] - want[i]).abs()
                         / want[i].abs().clamp(min=1.0)).max())
            assert rel <= 1e-4, (key, rel)
            site_err[key] = max(site_err[key], rel)
    caught = []
    cdef_fn = mcdef.cdef_planes

    def catch_cdef(*a):
        caught.append(a)
        return cdef_fn(*a)

    mcdef.cdef_planes = catch_cdef
    try:
        kbuf, kref, _ = inter_v._gop_step_part_body(
            frames[0], ref, q, h, w, 1 << 20, lf3, cdef_s, kw["gld_fused"],
            prev_mv, gate, bd)
    finally:
        mcdef.cdef_planes = cdef_fn
    cy, cu, cv, skip8 = (x.contiguous() for x in caught[0][:4])
    # an all-zero preset launches nothing: compare at the strongest then
    strengths = cdef_s if any(cdef_s) else tuple(
        int(x) for x in mcdef.CDEF_PRESETS[-1])
    cargs = (cy.to(torch.int32), cu.to(torch.int32), cv.to(torch.int32),
             skip8, *strengths, 3, bd)
    ck = kcdef.cdef_filter(*cargs)
    cp = kcdef.cdef_filter_plain(*cargs)
    torch.cuda.synchronize()
    cdef_err = max(int((a - b).abs().max()) for a, b in zip(ck, cp))
    cdef_px = sum(int((a != b).sum()) for a, b in zip(ck, cp))
    print(f"coder batches on identical inputs: {len(sites)} sites, levels, "
          f"recon and SSE equal, rate max rel err {site_err['rate_rel']:.3g}, "
          f"skip SSE {site_err['dskip_rel']:.3g}; cdef_filter vs plain on the "
          f"step's input: {cdef_px} pixels differ (max |diff| {cdef_err}), "
          f"skipped units {int(skip8.sum())} of {skip8.numel()}", flush=True)
    assert cdef_px == 0

    # (c) the whole step both ways
    with plain_inter_kernels():
        pbuf, pref, _ = inter_v._gop_step_part_body(
            frames[0], ref, q, h, w, 1 << 20, lf3, cdef_s, kw["gld_fused"],
            prev_mv, gate, bd)
    torch.cuda.synchronize()
    n = min(kbuf.numel(), pbuf.numel())
    print(f"inter step kernels vs plain: buffer elements differ "
          f"{int((kbuf[:n] != pbuf[:n]).sum())} of {n}, recon pixels "
          f"differ {int((kref != pref).sum())} of {kref.numel()}",
          flush=True)

    # (d) times, per launch and per frame
    out = os.environ.get("AV1TPU_SMOKE_OUT")
    if out:          # the batches tools/search_compare.py --coder times
        os.makedirs(out, exist_ok=True)
        save_coder_inputs(torch, sites, os.path.join(out, "coder_inputs.pt"))
    T = tables(y.device)
    recs = {"code_blocks": {"per_site": {}}, "cdef_filter": {}}
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "cublas_ms": 0.0}
    times = coder_times(torch, inter_code, sites)
    for (coefs, src, pred, plane), (dev_us, plain) in zip(sites, times):
        b, nn = src.shape[0], plane.n
        key = coder_key(src, plane)
        resid = (src - pred).reshape(b, -1).to(torch.float32)
        fwdt = T.fwd64t() if nn == 64 else T.fwdt(nn, 0)
        mm_us = device_us(torch, lambda: resid @ fwdt, 100)
        bound, by = code_bounds(b, nn)
        zero = int((inter_code.code_blocks(coefs, src, pred, plane)[0]
                    .flatten(1) == 0).all(1).sum())
        print(f"code_blocks {key}: device {dev_us:.3f} us, plain "
              f"{plain:.3f} ms, cuBLAS product {mm_us:.3f} us, bound "
              f"{bound:.4f} us ({by}, roofline {bound / dev_us:.4f}); "
              f"{zero} of {b} blocks without a level", flush=True)
        recs["code_blocks"]["per_site"][key] = {
            "device_us": dev_us, "plain_ms": plain, "cublas_us": mm_us,
            "bound_us": bound, "bound_by": by, "blocks_without_level": zero}
        tot["ms"] += dev_us / 1e3
        tot["plain_ms"] += plain
        tot["bound_ms"] += bound / 1e3
        tot["cublas_ms"] += mm_us / 1e3
    recs["code_blocks"].update(
        ms=tot["ms"], plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"],
        bound_by="bytes", cublas_ms=tot["cublas_ms"], max_abs_err=max_level,
        decisions_differ=decisions, rate_max_rel_err=site_err["rate_rel"],
        dskip_max_rel_err=site_err["dskip_rel"])
    if out:          # the CDEF input tools/search_compare.py --cdef times
        torch.save({"planes": [p.cpu() for p in cargs[:3]],
                    "skip8": cargs[3].cpu(), "strengths": list(cargs[4:8]),
                    "damping": cargs[8], "bit_depth": cargs[9]},
                   os.path.join(out, "cdef_inputs.pt"))
    cdef_recs = cdef_times(torch, kcdef, cdef_cases(torch, cargs))
    for r in cdef_recs:
        print(f"cdef_filter {w}x{h} {r['case']} ({r['bit_depth']}-bit): live "
              f"units {r['live_share']:.4f}, device {r['device_us']:.3f} us, "
              f"plain {r['plain_ms']:.3f} ms, bound {r['bound_us']:.4f} us "
              f"({r['bound_by']}: bytes {r['bytes_us']:.4f}, int32 "
              f"operations {r['ops_us']:.4f}; roofline "
              f"{r['bound_us'] / r['device_us']:.4f})", flush=True)
    main = cdef_recs[0]
    recs["cdef_filter"].update(
        ms=main["device_us"] / 1e3, plain_ms=main["plain_ms"],
        bound_ms=main["bound_us"] / 1e3, bound_by=main["bound_by"],
        live_share=main["live_share"], max_abs_err=cdef_err,
        pixels_differ=cdef_px,
        dense_us={r["case"]: r["device_us"] for r in cdef_recs[1:]})
    print(f"code_blocks per inter frame ({len(sites)} launches): device "
          f"{tot['ms']:.4f} ms, plain {tot['plain_ms']:.3f} ms, cuBLAS "
          f"products {tot['cublas_ms']:.4f} ms, bound {tot['bound_ms']:.5f} "
          f"ms", flush=True)
    for line in ptxas_report(BUILD_LOG, ("cdef_kernel",)):
        print(f"-Xptxas -v {line}", flush=True)
    return recs


INT32_LANES_PER_SM = 64     # Hopper: INT32 lanes per SM per clock


@functools.cache
def max_sm_mhz() -> float:
    """The SM's maximum clock in MHz (nvidia-smi clocks.max.sm)."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.split()[0])


@functools.cache
def int32_rate() -> tuple[float, str]:
    """The card's int32 rate in operations per second: 64 lanes per SM x
    the SMs x the SM's maximum clock (nvidia-smi clocks.max.sm), with the
    derivation as text."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = max_sm_mhz()
    rate = INT32_LANES_PER_SM * sms * mhz * 1e6
    return rate, (f"{INT32_LANES_PER_SM} INT32 lanes x {sms} SMs x {mhz:g} "
                  f"MHz (clocks.max.sm) = {rate / 1e12:.3f} T int32 ops/s")


def search_ops(h: int, w: int, nbases: int = 2) -> dict:
    """The int32 operations each motion-search wrapper's call needs on an
    h x w frame, whatever implements it: an add, a multiply-add and an
    abs-diff with its accumulate (one __sad, one VABSDIFF, at the INT32
    rate) are one operation each.  coarse_search: the 4x4 pools (an add
    per pixel of both planes) and 289 quarter-res candidates (an abs-diff
    per quarter-res pixel); global_search: 125 displacements, an abs-diff
    per pixel; refine_subpel: 25 full-pel candidates per base and 49
    quarter-pel ones (an abs-diff per pixel each) and, per 16x16 block,
    the sub-pel filters with their shared phases and 6 nonzero taps: three
    horizontal phases over the 22 rows x 17 columns the vertical taps
    read, and three vertical phases over 17 rows of the 16 columns of the
    identity phase and of the 17 of each other one."""
    px, nblk = h * w, (h // 16) * (w // 16)
    hor, ver = 3 * 22 * 17 * 6, 3 * (16 + 3 * 17) * 17 * 6
    return {"coarse_search": 2 * px + 289 * (px // 16),
            "global_search": 125 * px,
            "refine_subpel": (nbases * 25 + 49) * px + nblk * (hor + ver)}


def search_bounds(h: int, w: int, nbases: int = 2) -> dict:
    """Least time of each motion-search wrapper's call on an h x w frame,
    in us, and what bounds it: the larger of its bytes at the memory rate
    (each input read once, each output written once: the int32 luma
    planes, the bases, the global outputs, the MV fields and the 16x16
    predictions) and its int32 operations (search_ops) at the card's
    int32 rate (int32_rate).  Returns {name: (bound_us, by, bytes_us,
    ops_us)}."""
    nblk = (h // 16) * (w // 16)
    planes = 2 * 4 * h * w
    nbytes = {
        "coarse_search": planes + 2 * 8 * nblk + 32,
        "global_search": planes + 32 + 2 * 8 + 4 * nblk,
        "refine_subpel": (planes + nbases * 8 * nblk + 2 * 8 + 4 * nblk
                          + 4 * 8 * nblk + 4 * 256 * nblk)}
    rate = int32_rate()[0]
    out = {}
    for k, ops in search_ops(h, w, nbases).items():
        t_bytes, t_ops = nbytes[k] / PEAK_BYTES * 1e6, ops / rate * 1e6
        out[k] = (max(t_bytes, t_ops),
                  "operations" if t_ops >= t_bytes else "bytes", t_bytes,
                  t_ops)
    return out


def deblock_bounds(h: int, w: int, luma: bool, split: bool,
                   directions: int = 2) -> tuple[float, str]:
    """Least time of one deblock_edges launch on an h x w int32 plane, in
    us: its bytes at the memory rate (the plane read once and written
    once, each direction's edge map and the split map read once, one byte
    per edge or block of the block grid).  All of its work is integer,
    which no fp32 or tensor peak counts, so bytes bound it; the integer
    operations are not counted.  directions 1: a launch of one direction
    (an older checkout's kernel, timed by tools/search_compare.py
    --root)."""
    nb = 16 if luma else 8
    nblk = (h // nb) * (w // nb)
    nbytes = 2 * 4 * h * w + directions * nblk + (nblk if split else 0)
    return nbytes / PEAK_BYTES * 1e6, "bytes"


@contextlib.contextmanager
def plain_search_deblock():
    """Within the block _search_mv's three stages and deblock_planes'
    deblock_edges run their plain versions (on the tensors' device, the
    card): the plain side of phase 7d's comparisons."""
    from av1tpu_torch.kernels import deblock as kdeblock
    from av1tpu_torch.kernels import motion
    from av1tpu_torch.models import deblock as mdeblock
    from av1tpu_torch.models import inter_v

    names = ("coarse_search", "global_search", "refine_subpel")
    saved = [getattr(inter_v, n) for n in names] + [mdeblock.deblock_edges]
    for n in names:
        setattr(inter_v, n, getattr(motion, n + "_plain"))
    mdeblock.deblock_edges = kdeblock.deblock_plane_plain
    try:
        yield
    finally:
        for n, f in zip(names, saved):
            setattr(inter_v, n, f)
        mdeblock.deblock_edges = saved[-1]


def deblock_times(torch, kdeblock, planes, v_on, h_on, levels, bd: int,
                  split16, plain: bool = True) -> list:
    """One timing of deblock_edges of the module kdeblock (a checkout's
    kernels/deblock.py) on one frame's planes (y, u, v) with their levels:
    a dict per launch (plane, direction: "both", or "vertical" and
    "horizontal" for an older checkout's one-direction kernel, device us
    queued behind a sleep, the plain version's median event ms where
    plain, the bound).  Phase 7d and tools/search_compare.py --deblock
    time with it."""
    import inspect

    both = "h_on16" in inspect.signature(kdeblock.deblock_edges).parameters
    out = []
    for name, plane, lvl, luma in zip("yuv", planes, levels,
                                      (True, False, False)):
        if lvl <= 0:
            continue
        plane = plane.contiguous()
        if both:
            runs = [("both", (plane, v_on, h_on, lvl, 0, bd, luma, split16),
                     kdeblock.deblock_plane_plain if plain else None)]
        else:
            runs = [(d, (plane, on, lvl, 0, bd, luma, d == "vertical",
                         split16), kdeblock.deblock_edges_plain if plain
                     else None)
                    for d, on in (("vertical", v_on), ("horizontal", h_on))]
        for direction, args, slow in runs:
            dev_us = device_us(torch, lambda: kdeblock.deblock_edges(*args),
                               200)
            bound, by = deblock_bounds(*plane.shape, luma,
                                       split16 is not None,
                                       2 if both else 1)
            out.append(dict(
                plane=name, shape=list(plane.shape), direction=direction,
                device_us=dev_us, bound_us=bound, bound_by=by,
                plain_ms=(_median_ms(torch, lambda: slow(*args), n=5)
                          if slow is not None else None)))
    return out


def ptxas_report(log: str, names) -> list:
    """The -Xptxas -v lines of the kernels whose (mangled) names contain
    one of `names`: one line per kernel with its registers, stack frame,
    spill stores and loads and shared memory, from nvcc's build log."""
    out, cur = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            cur = m.group(1) if any(n in m.group(1) for n in names) else None
            if cur and "Compiling" in line:
                out.append([cur, []])
            continue
        if cur and out and out[-1][0] == cur and re.search(
                r"stack frame|spill|Used \d+ registers", line):
            out[-1][1].append(line.split(":", 1)[-1].strip()
                              if "ptxas" in line else line.strip())
    return [f"{k}: {'; '.join(v)}" for k, v in out]


BUILD_LOG = ""          # nvcc's output of this run's build (main)


def search_times(torch, motion, y, ref_y, lam, pm,
                 plain: bool = True) -> dict:
    """One timing of the three search wrappers of the module motion (a
    checkout's kernels/motion.py) on one pair at lambda lam: each call's
    device time in us (device_us, 100 calls queued behind a sleep), its
    plain version's median event time in ms where plain (else None), and
    the wrapper's launches per call.  The bases and global outputs are the
    kernels' own.  Phase 7d and tools/search_compare.py time with it."""
    c1, c2, s4 = motion.coarse_search(y, ref_y, lam)
    c0, g_full, sad_g = motion.global_search(y, ref_y, s4)
    calls = {
        "coarse_search": (lambda: motion.coarse_search(y, ref_y, lam),
                          lambda: motion.coarse_search_plain(y, ref_y, lam),
                          motion.COARSE_LAUNCHES),
        "global_search": (lambda: motion.global_search(y, ref_y, s4),
                          lambda: motion.global_search_plain(y, ref_y, s4),
                          motion.GLOBAL_LAUNCHES),
        "refine_subpel": (
            lambda: motion.refine_subpel(y, ref_y, (c1, c2), c0, g_full,
                                         sad_g, lam, pm),
            lambda: motion.refine_subpel_plain(y, ref_y, (c1, c2), c0,
                                               g_full, sad_g, lam, pm),
            motion.REFINE_LAUNCHES)}
    return {name: (device_us(torch, kern, 100),
                   _median_ms(torch, slow, n=5) if plain else None, n)
            for name, (kern, slow, n) in calls.items()}


SEARCH_PARTS = ("mv8", "mv_px", "pred_y", "p40", "coarse", "coarse2",
                "shifts4", "c0", "g_full", "sad_g")


def _search_diff(name: str, got: dict, want: dict) -> int:
    """Compare two _search_parts results; print every differing output
    with its first differing blocks, both sides' values.  Returns the
    number of differing elements."""
    bad = 0
    for k in SEARCH_PARTS:
        a, b = got[k], want[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        d = a != b
        n = int(d.sum())
        if n:
            bad += n
            idx = d.nonzero()[:4].tolist()
            print(f"  {name} {k}: {n} elements differ; first at "
                  f"{idx}: kernel {[a[tuple(i)].item() for i in idx]} plain "
                  f"{[b[tuple(i)].item() for i in idx]}", flush=True)
    return bad


def search_deblock_vs_plain(torch, gop_args, tf_args) -> dict:
    """Phase 7d: the motion search's three kernels and deblock_edges
    against their plain versions on the card, on phase 7's first 1080p
    inter frame and on its temporal filter's first neighbour.  (a) The
    search (_search_parts) both ways from the same inputs: every output
    equal (mv8, mv_px, pred_y, p40, coarse, coarse2, shifts4, c0, g_full,
    sad_g), for the inter frame without and with a temporal base (the MV
    field of the first search) and for the neighbour at the temporal
    filter's lambda.  (b) deblock_planes through deblock_edges and
    through its plain version, on the quality step's recon (its edge gates
    and split16), on the fast step's recon, and on a 10-bit frame made from
    the quality recon: every pixel of every plane equal.  (c) Times: each
    wrapper's device time per call and per launch (queued behind a sleep),
    per search and per frame, the plain versions' event time, and the
    bounds (search_bounds, deblock_bounds).  Returns the four kernels'
    records for the JSON line."""
    from av1tpu_torch.kernels import deblock as kdeblock
    from av1tpu_torch.kernels import motion
    from av1tpu_torch.models import deblock as mdeblock
    from av1tpu_torch.models import inter_v
    from av1tpu_torch.models.intra_v import unfuse

    (frames, ref, q, h, w), kw = gop_args[0][:5], gop_args[1]
    bd = kw["bit_depth"]
    pm = (1 << bd) - 1
    lf3 = tuple(int(x) for x in kw["lf"]) if any(kw["lf"]) else (12, 6, 6)
    prev_mv = (kw["prev_mv"] if kw["prev_mv"] is not None else
               torch.zeros((h // 16, w // 16, 2), dtype=torch.int32,
                           device=ref.device))
    cdef_s = tuple(int(x) for x in kw["cdef_s"])
    y, ref_y = unfuse(frames[0], h, w)[0], unfuse(ref, h, w)[0]
    lam = inter_v.inter_lambdas(q, bd, y.device)[0]
    (key, neigh, th, tw), tkw = tf_args[0][:4], tf_args[1]
    tbd = tkw.get("bit_depth", 8)
    ky, ny = unfuse(key, th, tw)[0], unfuse(neigh[0], th, tw)[0]
    print(f"search and deblock vs plain: inter frame {w}x{h} q={q} "
          f"lam={float(lam)} lf={lf3} bit_depth={bd}; temporal filter "
          f"neighbour {tw}x{th} lam=4.0", flush=True)
    out = os.environ.get("AV1TPU_SMOKE_OUT")
    if out:          # the pair tools/search_compare.py --inputs times
        os.makedirs(out, exist_ok=True)
        torch.save({"y": y.cpu(), "ref_y": ref_y.cpu(), "lam": float(lam),
                    "pm": pm}, os.path.join(out, "search_inputs.pt"))

    # (a) the search, kernel vs plain, from the same inputs
    first = inter_v._search_parts(y, ref_y, lam, pm)
    cases = {"inter": (y, ref_y, lam, pm, None),
             "inter+temporal": (y, ref_y, lam, pm, first["mv_px"]),
             "tfilter": (ky, ny, np.float32(4.0), (1 << tbd) - 1, None)}
    diff = {}
    for name, args in cases.items():
        got = inter_v._search_parts(*args)
        with plain_search_deblock():
            want = inter_v._search_parts(*args)
        torch.cuda.synchronize()
        diff[name] = _search_diff(name, got, want)
        print(f"search {name}: g_full {got['g_full'].tolist()} (plain "
              f"{want['g_full'].tolist()}), shifts4 {got['shifts4'].tolist()}"
              f", differing elements {diff[name]}", flush=True)
    assert not any(diff.values()), diff

    # (b) deblock_planes both ways, on each step's recon
    caught = []
    fn = mdeblock.deblock_planes

    def catch(*a, **k):
        caught.append((a, k))
        return fn(*a, **k)

    mdeblock.deblock_planes = catch
    try:
        inter_v._gop_step_part_body(
            frames[0], ref, q, h, w, 1 << 20, lf3, cdef_s, kw["gld_fused"],
            prev_mv, kw["noise_gate"], bd)
        inter_v._gop_step_body(frames[0], ref, q, h, w, 1 << 20, lf3, cdef_s,
                               bd)
    finally:
        mdeblock.deblock_planes = fn
    assert len(caught) == 2, len(caught)
    (qa, qk), (fa, fk) = caught
    ten = ([torch.clamp(p * 4 + 1, 0, 1023) for p in qa[:3]]
           + list(qa[3:9]) + [10], dict(qk))
    db_cases = {"quality": (list(qa), dict(qk)), "fast": (list(fa), dict(fk)),
                "10-bit": ten}
    db_px = {}
    for name, (a, k) in db_cases.items():
        got = mdeblock.deblock_planes(*a, **k)
        with plain_search_deblock():
            want = mdeblock.deblock_planes(*a, **k)
        torch.cuda.synchronize()
        db_px[name] = sum(int((g != wt).sum()) for g, wt in zip(got, want))
        changed = sum(int((g != p).sum()) for g, p in zip(got, a[:3]))
        print(f"deblock_planes {name} (levels {a[5:8]}, split16 "
              f"{k.get('split16') is not None}): {db_px[name]} pixels differ "
              f"from the plain version; {changed} pixels filtered", flush=True)
    assert not any(db_px.values()), db_px

    # (c) times, per call, per launch and per search or frame
    recs = {}
    bounds = search_bounds(h, w)
    print(f"int32 rate: {int32_rate()[1]}", flush=True)
    tot = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0}
    times = search_times(torch, motion, y, ref_y, lam, pm)
    for name, (dev_us, plain_ms, n) in times.items():
        bound, by, bytes_us, ops_us = bounds[name]
        recs[name] = dict(ms=dev_us / 1e3, plain_ms=plain_ms,
                          bound_ms=bound / 1e3, bound_by=by,
                          launch_us=dev_us / n, launches_per_search=n,
                          max_abs_err=0, outputs_differ=diff)
        for key, v in (("ms", dev_us / 1e3), ("plain_ms", plain_ms),
                       ("bound_ms", bound / 1e3)):
            tot[key] += v
        print(f"{name} {w}x{h}: device {dev_us:.3f} us per call ({n} "
              f"launches, {dev_us / n:.3f} us each), plain {plain_ms:.3f} "
              f"ms, bound {bound:.4f} us ({by}; bytes {bytes_us:.4f} us, "
              f"int32 operations {ops_us:.4f} us; roofline "
              f"{bound / dev_us:.5f})", flush=True)
    launch_us = kernel_us_by_name(
        torch, lambda: motion.coarse_search(y, ref_y, lam))
    recs["coarse_search"]["launch_us"] = {_short(k): v
                                          for k, v in launch_us.items()}
    print(f"coarse_search {w}x{h} per launch (torch.profiler, device us): "
          + ", ".join(f"{_short(k)} {v:.3f}" for k, v in launch_us.items()),
          flush=True)
    print(f"one search {w}x{h} ({motion.COARSE_LAUNCHES} + "
          f"{motion.GLOBAL_LAUNCHES} + {motion.REFINE_LAUNCHES} launches): "
          f"device {tot['ms']:.4f} ms, plain {tot['plain_ms']:.3f} ms, bound "
          f"{tot['bound_ms']:.5f} ms", flush=True)
    a, k = db_cases["quality"]
    s16 = k["split16"].to(torch.bool).contiguous()
    if out:          # the planes tools/search_compare.py --deblock times
        torch.save({"planes": [p.cpu() for p in a[:3]], "v_on": a[3].cpu(),
                    "h_on": a[4].cpu(), "levels": [int(x) for x in a[5:8]],
                    "bit_depth": bd, "split16": s16.cpu()},
                   os.path.join(out, "deblock_inputs.pt"))
    launch = deblock_times(torch, kdeblock, a[:3], a[3].contiguous(),
                           a[4].contiguous(), a[5:8], bd, s16)
    per_frame = {"ms": sum(r["device_us"] for r in launch) / 1e3,
                 "plain_ms": sum(r["plain_ms"] for r in launch),
                 "bound_ms": sum(r["bound_us"] for r in launch) / 1e3}
    for r in launch:
        print(f"deblock_edges {r['plane']} {r['shape'][1]}x{r['shape'][0]} "
              f"({r['direction']}): device {r['device_us']:.3f} us, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_us']:.4f} us "
              f"(bytes; integer work not counted; roofline "
              f"{r['bound_us'] / r['device_us']:.4f})", flush=True)
    print(f"deblock_planes per quality frame ({len(launch)} launches): "
          f"device {per_frame['ms']:.4f} ms, plain "
          f"{per_frame['plain_ms']:.3f} ms, bound "
          f"{per_frame['bound_ms']:.5f} ms", flush=True)
    for line in ptxas_report(BUILD_LOG, ("deblock_kernel",)):
        print(f"-Xptxas -v {line}", flush=True)
    recs["deblock_edges"] = dict(
        ms=launch[0]["device_us"] / 1e3, plain_ms=launch[0]["plain_ms"],
        bound_ms=launch[0]["bound_us"] / 1e3, bound_by="bytes",
        per_plane_us={r["plane"]: r["device_us"] for r in launch},
        frame_ms=per_frame["ms"], plain_frame_ms=per_frame["plain_ms"],
        bound_frame_ms=per_frame["bound_ms"], max_abs_err=0,
        pixels_differ=db_px)
    return recs


# av1tpu/models/intra_part.py: what each probe kernel replaces
PART_REPLACES = {"part_chain": "av1tpu/models/intra_part.py:167",
                 "part_pred": "av1tpu/models/intra_part.py:73",
                 "part_code": "av1tpu/models/intra_part.py:85",
                 "part_merge": "av1tpu/models/intra_part.py:189"}


@contextlib.contextmanager
def plain_part_kernels():
    """Within the block the probe's four wrappers run their plain versions
    (on the tensors' device, the card): the plain side of phase 7e."""
    from av1tpu_torch.kernels import intra_part as kpart
    from av1tpu_torch.models import intra_part

    saved = {n: getattr(intra_part, n) for n in PART_KERNELS}
    for n in PART_KERNELS:
        setattr(intra_part, n, getattr(kpart, n + "_plain"))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(intra_part, n, f)


def _clone_job(job):
    return job._replace(**{k: v.clone() for k, v in job._asdict().items()
                           if hasattr(v, "clone")})


# A value that two float32 sums of the same terms in other orders can
# reach, relative to the terms' magnitudes: the margin of a near-tie
TIE_REL = 1e-5


def _chain_check(torch, j, p) -> dict:
    """part_chain's outputs for one plane, column by column from the
    kernel's own carry, against float64: every level is the float64 level
    of its coefficient (quantize, rd_zero where the site has a table) or,
    where the coefficient lies within TIE_REL of its terms' magnitudes
    from a rounding or rd_zero boundary, the level on the boundary's other
    side, at most max(2, levels / 10,000) of those; the recon is exactly
    the carry plus the inverse of the dequantized levels.  Returns the
    levels and pixels differing from the plain version (after a boundary
    level the carries differ) and the boundary levels."""
    from av1tpu_torch.models.intra_v import quantize_with_offsets
    from av1tpu_torch.models.rdoq import rd_zero
    from av1tpu_torch.ops.transforms import inverse_transform

    s = j.site
    n, w = j.src.shape
    cols = w // n
    edge = torch.full((cols,), (1 << (s.bit_depth - 1)) - 1,
                      dtype=torch.int32, device=j.src.device)
    edge[1:] = j.rec[0, n - 1:w - 1:n]          # rec[0, c * n - 1]
    resid = (j.src.reshape(n, cols, n).transpose(0, 1).reshape(cols, n * n)
             - edge[:, None]).double()
    f = j.fwdt.double()
    c = resid @ f
    tol = TIE_REL * (resid.abs() @ f.abs())
    step, off = s.step.double(), s.off.double()

    def level(x):
        lv = quantize_with_offsets(x, step, s.cap, off)
        if s.tab is None:
            return lv
        return rd_zero(lv, x, step, float(s.lam), s.tab.double(),
                       s.gains.double())

    mid = level(c)
    got = j.lv.reshape(cols, n * n).int()
    ok = ((got == mid) | (got == level(c.sign() * (c.abs() - tol)
                                       .clamp_min(0)))
          | (got == level(c.sign() * (c.abs() + tol))))
    bad = (~ok).nonzero()
    assert not len(bad), ("part_chain: a level off every boundary",
                          n, bad[:4].tolist())
    boundary = int((got != mid).sum())
    assert boundary <= max(2, got.numel() // 10_000), (
        "part_chain: boundary levels", n, boundary)
    rec = torch.clamp(edge[:, None, None] + inverse_transform(
        (got * s.q).reshape(cols, n, n), n, n, s.tx), 0, s.pix_max)
    assert torch.equal(rec.transpose(0, 1).reshape(n, w), j.rec), (
        "part_chain: recon", n)
    return {"levels": int((j.lv != p.lv).sum()),
            "pixels": int((j.rec != p.rec).sum()),
            "max_abs_err": int((j.lv.int() - p.lv.int()).abs().max()),
            "boundary": boundary}


def _near_tie(a: float, b: float) -> bool:
    return abs(a - b) <= TIE_REL * max(1.0, abs(b))


def _merge_flips(torch, j, p) -> set:
    """The superblock columns of one luma part_merge job where its split
    or split64 grid differs from the plain version's.  Asserts each flip
    a near-tie of this job's decisions: the float64 sum of the small
    blocks' costs (of the regions' costs, by either side's, for split64)
    within TIE_REL of the larger block's cost; a split of the superblock
    row may also differ where its split64 flipped, and nothing else."""
    s, r = j.sb_row, 2 * j.sb_row + j.half
    flips = set()
    for row, col in (j.split64 != p.split64).nonzero().tolist():
        want = float(j.cost_b[col])
        assert row == s and j.do_big and any(_near_tie(float(
            reg[:, 2 * col:2 * col + 2].double().sum())
            + float(j.lam_split), want)
            for reg in (j.cost_region, p.cost_region)), (
            "part_merge: a split64 flip off a near-tie", row, col)
        flips.add(col)
    for row, col in (j.split != p.split).nonzero().tolist():
        if row // 2 == s and col // 2 in flips:
            continue            # the 64 merge cleared it on one side
        cs = j.cost_s[:, 2 * col:2 * col + 2].double()
        assert row == r and _near_tie(float(cs.sum()) + float(j.lam_split),
                                      float(j.cost_m[col])), (
            "part_merge: a split flip off a near-tie", row, col)
        flips.add(col // 2)
    return flips


def _mode_flips(torch, j, p, flip) -> list:
    """The columns of a part_code job whose mode differs from the plain
    version's.  Every candidate's cost in float64 from the coefficients
    (the quantize is elementwise float32, bit-equal on both sides): the
    two chosen candidates' costs within TIE_REL, and the kernel's levels
    and recon those of the candidate it names.  Returns the flips."""
    from av1tpu_torch.kernels.intra_part import MODE_BITS, MODE_VALS, _dq_shift
    from av1tpu_torch.models.intra_v import log2_rate, quantize_with_offsets
    from av1tpu_torch.models.rdoq import rd_zero
    from av1tpu_torch.ops.transforms import inverse_transform

    s = j.site
    n, cw, cols = s.n, s.cw, j.lv.shape[0]
    lv = quantize_with_offsets(j.coefs, s.step, s.cap, s.off)
    if s.tab is not None:
        lv = rd_zero(lv, j.coefs, s.step, float(s.lam), s.tab, s.gains)
    d = j.coefs.double() - lv.double() * s.step.double()
    bits = torch.tensor(MODE_BITS, dtype=torch.float64,
                        device=lv.device)[:, None]
    cost = ((d * d).sum(1).reshape(3, cols) * float(s.inv_ratio)
            + float(s.lam) * (log2_rate(lv, 1).double().reshape(3, cols)
                              + bits))
    lv = lv.reshape(3, cols, cw, cw)
    pred = j.pred.reshape(3, cols, n, n)
    out = []
    for c in flip.nonzero().flatten().tolist():
        mk, mp = (MODE_VALS.index(int(x.modes[c])) for x in (j, p))
        tie = (f"n{n} column {c}", MODE_VALS[mk], float(cost[mk, c]),
               MODE_VALS[mp], float(cost[mp, c]))
        assert _near_tie(tie[2], tie[4]), ("part_code: a mode flip off a "
                                           "near-tie", tie)
        assert torch.equal(j.lv[c].int(), lv[mk, c]), ("part_code: the "
                                                       "levels", tie)
        dq = (lv[mk, c] * s.q.reshape(cw, cw) if s.dq_shift == 0 else
              _dq_shift(lv[mk, c], s.q.reshape(cw, cw), s.dq_shift))
        want = torch.clamp(pred[mk, c] + inverse_transform(
            dq[None], n, n, s.tx)[0], 0, s.pix_max)
        assert torch.equal(j.rec[:, c * n:(c + 1) * n], want), (
            "part_code: the recon", tie)
        out.append(tie)
    return out


def _stage_diff(torch, name: str, jobs, plain_jobs) -> dict:
    """One wrapper call against its plain version on the same inputs.
    part_pred: resid and pred equal.  part_chain: _chain_check.
    part_code: a mode flip only at a near-tie of the chosen costs, the
    levels and recon of every other column equal.  part_merge: a split or
    split64 flip only at a near-tie (_merge_flips), levels and recon equal
    outside the flipped superblock columns.  Returns the counts: differing
    decisions, levels and pixels, part_chain's boundary levels, the
    largest level or pixel difference, the costs' largest relative
    difference where the decisions agree, and the flips to print."""
    rec = {"decisions": 0, "levels": 0, "pixels": 0, "max_abs_err": 0,
           "boundary": 0, "cost_rel": 0.0, "ties": []}
    for j, p in zip(jobs, plain_jobs):
        if name == "part_pred":
            assert torch.equal(j.resid, p.resid) and torch.equal(j.pred,
                                                                 p.pred)
            continue
        if name == "part_chain":
            d = _chain_check(torch, j, p)
            for k in ("levels", "pixels", "boundary"):
                rec[k] += d[k]
            rec["max_abs_err"] = max(rec["max_abs_err"], d["max_abs_err"])
            if d["boundary"]:
                rec["ties"].append((f"chain n{j.site.n}: boundary levels",
                                    d["boundary"]))
            continue
        if name == "part_code":
            cols = j.lv.shape[0]
            n = j.rec.shape[0]
            flip = ((j.modes != p.modes) if j.modes is not None else
                    torch.zeros(cols, dtype=torch.bool, device=j.lv.device))
            rec["decisions"] += int(flip.sum())
            keep = ~flip
            lv_d = (j.lv.int() - p.lv.int()).abs().flatten(1).amax(1)
            rc_d = (j.rec - p.rec).reshape(n, cols, n).abs().amax(
                dim=(0, 2))
            assert not bool((lv_d[keep] > 0).any()), (name, "levels")
            assert not bool((rc_d[keep] > 0).any()), (name, "recon")
            rec["levels"] += int((j.lv != p.lv).sum())
            rec["pixels"] += int((j.rec != p.rec).sum())
            rec["max_abs_err"] = max(rec["max_abs_err"], int(lv_d.max()),
                                     int(rc_d.max()))
            if j.cost is not None:
                rel = ((j.cost - p.cost).abs() / p.cost.abs().clamp_min(1))
                if bool(keep.any()):
                    rec["cost_rel"] = max(rec["cost_rel"],
                                          float(rel[keep].max()))
            if bool(flip.any()):
                rec["ties"] += _mode_flips(torch, j, p, flip)
            continue
        # part_merge: the split decisions of the half (and the 64's)
        for k in ("split", "split64"):
            rec["decisions"] += int((getattr(j, k) != getattr(p, k)).sum())
        flips = _merge_flips(torch, j, p) if j.cost_m is not None else set()
        nb = 4 * j.lv_s.shape[-1]
        for k, per_sb in (("lv_s", 4), ("lv_m", 2), ("lv_b", 1),
                          ("recon", nb)):
            diff = getattr(j, k) != getattr(p, k)
            rec["pixels" if k == "recon" else "levels"] += int(diff.sum())
            at = diff.reshape(diff.shape[0], -1, per_sb, *diff.shape[2:])
            at = at.any(dim=tuple(d for d in range(at.dim()) if d != 1))
            assert set(at.nonzero().flatten().tolist()) <= flips, (
                name, k, "differs outside a flipped superblock column")
        if j.cost_region is not None:
            r = j.cost_region[j.half]
            rel = (r - p.cost_region[j.half]).abs() / r.abs().clamp_min(1)
            rec["cost_rel"] = max(rec["cost_rel"], float(rel.max()))
        if flips:
            rec["ties"].append(("merge", j.sb_row, j.half, sorted(flips)))
    return rec


def part_bounds(calls: dict) -> dict:
    """Least time of each probe kernel over one probed frame's calls, in
    us: the larger of its float32 operations at the fp32 peak and its
    bytes at the memory rate (each input read once, each output written
    once).  part_chain: per column the product's 2 n^4 and the quantize's
    and rd_zero's 10 per coefficient; its bytes the first rows, the
    forward matrices, the levels and recon out.  part_pred: bytes (the
    row above, the source band, the residuals and predictions out; its
    arithmetic is integer).  part_code: 18 operations per coefficient of
    each candidate (quantize 2, rd_zero 8, distortion 4, rate 4); bytes
    the coefficients, the chosen prediction, the source at the 64, the
    levels, recon and per-column results out.  part_merge: bytes, what
    this frame's decisions need: the costs, the selection's recon and
    source and both rows of levels for the luma SSE and rate, the losers'
    levels zeroed, the winners' recon copied in.  Returns {name: (us,
    "bytes" or "operations")}."""
    out = {}
    for name, jobs_list in calls.items():
        ops = nbytes = 0
        for jobs in jobs_list:
            for j in jobs:
                if name == "part_chain":
                    n, w = j.src.shape
                    nn, cols = n * n, w // n
                    ops += cols * (2 * nn * nn + 10 * nn)
                    nbytes += (4 * n * w + 4 * nn * nn + 2 * cols * nn
                               + 4 * n * w)
                elif name == "part_pred":
                    n, w = j.src.shape
                    nbytes += 4 * w + 4 * n * w + 8 * j.resid.numel()
                elif name == "part_code":
                    n, w = j.src.shape
                    cols, nc = w // n, j.lv[0].numel()
                    ops += 18 * j.coefs.numel()
                    nbytes += (4 * j.coefs.numel() + 4 * n * w
                               + (4 * n * w if j.site.cost == 2 else 0)
                               + 2 * cols * nc + 4 * n * w + 5 * cols)
                else:
                    ns = j.lv_s.shape[-1]
                    nm, nb, w = 2 * ns, 4 * ns, j.recon.shape[1]
                    r = 2 * j.sb_row + j.half
                    won = int((~j.split[r]).sum())   # regions the mid won
                    # the losers' levels zeroed (a mid block or its four
                    # small ones: the same bytes), the winners' recon
                    nbytes += 2 * w * nm + 8 * nm * nm * won
                    if j.cost_m is not None:   # luma: SSE, rate, costs
                        nbytes += (8 * nm * w + 4 * nm * w
                                   + 4 * (2 * w // ns + 2 * w // nm))
                    if j.do_big:
                        s64 = j.split64[j.sb_row]
                        subs = int(s64.sum())
                        nbytes += 2 * 1024 * subs + (len(s64) - subs) * (
                            2 * 32 * ns * ns + 8 * nb * nb)
        t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES
        out[name] = (max(t_ops, t_bytes) * 1e6,
                     "operations" if t_ops >= t_bytes else "bytes")
    return out


FMA_LATENCY_CYCLES = 4     # a dependent fp32 FMA on Hopper


def chain_floor_us(jobs) -> float:
    """part_chain's serial floor on these jobs, in us: the longest plane's
    columns times its n*n dependent FMAs (each coefficient's sum keeps its
    order on one thread) at FMA_LATENCY_CYCLES each and the SM's maximum
    clock.  The quantize, the exchange and the inverse of each column come
    on top."""
    return max(j.src.shape[1] // j.site.n * j.site.n ** 2
               for j in jobs) * FMA_LATENCY_CYCLES / max_sm_mhz()


def capture_chain_jobs(torch, planes, q: int, bd: int) -> list:
    """The probe of one frame (models/intra_part.encode_intra_part of the
    checkout on sys.path) with its part_chain call caught: the jobs (luma,
    U, V), their sources copied."""
    from av1tpu_torch.models import intra_part

    calls, chain = [], intra_part.part_chain

    def catch(jobs):
        calls.append([j._replace(src=j.src.clone()) for j in jobs])
        return chain(jobs)

    intra_part.part_chain = catch
    try:
        intra_part.encode_intra_part(*planes, q, bit_depth=bd)
    finally:
        intra_part.part_chain = chain
    torch.cuda.synchronize()
    assert len(calls) == 1, len(calls)
    return calls[0]


def chain_times(torch, kpart, jobs, reps: int = 50) -> dict:
    """part_chain on one probed frame's jobs: the device us of the launch
    of all of them and of each job alone (y, u, v; device_us, queued
    behind a sleep kernel), and the sha256 of each job's levels and recon
    after a launch of all.  Phase 7e and tools/search_compare.py --chain
    time with it."""
    out = {"all": device_us(torch, lambda: kpart.part_chain(jobs), reps,
                            4 * SLEEP_CYCLES)}
    for name, j in zip("yuv", jobs):
        out[name] = device_us(torch, lambda: kpart.part_chain([j]), reps,
                              4 * SLEEP_CYCLES)
    fresh = [j._replace(lv=torch.zeros_like(j.lv), rec=torch.zeros_like(
        j.rec)) for j in jobs]
    kpart.part_chain(fresh)
    torch.cuda.synchronize()
    out["sha256"] = {name: hashlib.sha256(
        j.lv.cpu().numpy().tobytes() + j.rec.cpu().numpy().tobytes()
    ).hexdigest() for name, j in zip("yuv", fresh)}
    out["floor_us"] = chain_floor_us(jobs)
    return out


def site_label(site) -> str:
    """A probe site's short name: y16, y32, y64 (luma, with a cost) or
    c8, c16, c32 (chroma)."""
    return ("y" if site.cost else "c") + str(site.n)


def capture_code_calls(torch, planes, q: int, bd: int) -> list:
    """The probe of one frame (models/intra_part.encode_intra_part of the
    checkout on sys.path) with part_code's calls caught: each call's jobs,
    their inputs (coefs, pred, src) copied as the call saw them, in
    order."""
    from av1tpu_torch.models import intra_part

    calls, code = [], intra_part.part_code

    def catch(jobs):
        calls.append([j._replace(coefs=j.coefs.clone(), pred=j.pred.clone(),
                                 src=j.src.clone()) for j in jobs])
        return code(jobs)

    intra_part.part_code = catch
    try:
        intra_part.encode_intra_part(*planes, q, bit_depth=bd)
    finally:
        intra_part.part_code = code
    torch.cuda.synchronize()
    return calls


def code_kinds(torch, kpart, calls, reps: int = 5) -> list:
    """part_code's calls of one probed frame grouped by launch kind (the
    sites one launch codes, such as y16+y32+y64), each kind timed with
    device_us (its calls of the frame queued behind a sleep kernel):
    launches, device us per launch and per frame, the columns and the
    CTAs with work (kpart.code_ctas where the checkout has it, else an
    older checkout's one CTA per column), each site's jobs alone (us
    per launch), and per site the columns whose chosen candidate has no
    nonzero level (the kernel skips their inverse).  Phase 7e and
    tools/search_compare.py --probe time with it."""
    kinds: dict = {}
    for jobs in calls:
        key = "+".join(dict.fromkeys(site_label(j.site) for j in jobs))
        kinds.setdefault(key, []).append(jobs)
    ctas = getattr(kpart, "code_ctas",
                   lambda jobs: sum(j.lv.shape[0] for j in jobs))
    out = []
    for key, group in kinds.items():
        us = device_us(torch, lambda: [kpart.part_code(j) for j in group],
                       reps, 4 * SLEEP_CYCLES)
        rec = dict(kind=key, launches=len(group), device_us=us / len(group),
                   frame_us=us, columns=sum(j.lv.shape[0] for jobs in group
                                            for j in jobs),
                   ctas=sum(ctas(jobs) for jobs in group), alone_us={},
                   no_level={})
        for label in key.split("+"):
            sub = [[j for j in jobs if site_label(j.site) == label]
                   for jobs in group]
            rec["alone_us"][label] = device_us(
                torch, lambda: [kpart.part_code(j) for j in sub], reps,
                4 * SLEEP_CYCLES) / len(group)
            rec["no_level"][label] = [
                sum(int((j.lv.flatten(1) == 0).all(1).sum())
                    for jobs in sub for j in jobs),
                sum(j.lv.shape[0] for jobs in sub for j in jobs)]
        out.append(rec)
    return out


def capture_probe_sequence(torch, planes, q: int, bd: int):
    """The probe of one frame (models/intra_part.encode_intra_part of the
    checkout on sys.path) caught as its device sequence: part_chain's
    jobs; per stage part_pred's jobs, the forward products (residual,
    matrix, product) and part_code's jobs, as models/intra_part._stage
    runs them; each part_merge's jobs; in order.  Returns (the steps, the
    probe's outputs, the sha256 of each luma merge's region costs after
    it, in order)."""
    from av1tpu_torch.models import intra_part

    steps, costs = [], []
    saved = {n: getattr(intra_part, n)
             for n in ("_stage", "part_chain", "part_merge")}

    def stage(sites):
        preds = [p for p, _, _ in sites]
        intra_part.part_pred(preds)
        prods = [(p.resid, f, p.resid @ f) for p, f, _ in sites]
        codes = [c._replace(coefs=m[2]) for (_, _, c), m in zip(sites, prods)]
        intra_part.part_code(codes)
        steps.append(("stage", preds, prods, codes))

    def chain(jobs):
        saved["part_chain"](jobs)
        steps.append(("chain", list(jobs)))

    def merge(jobs):
        saved["part_merge"](jobs)
        steps.append(("merge", list(jobs)))
        costs.extend(j.cost_region[j.half].cpu().numpy().tobytes()
                     for j in jobs if j.cost_region is not None)

    intra_part._stage, intra_part.part_chain, intra_part.part_merge = (
        stage, chain, merge)
    try:
        out = intra_part.encode_intra_part(*planes, q, bit_depth=bd)
    finally:
        for n, f in saved.items():
            setattr(intra_part, n, f)
    torch.cuda.synchronize()
    return steps, out, hashlib.sha256(b"".join(costs)).hexdigest()


def replay_probe(torch, kpart, steps) -> None:
    """A caught probe sequence again on its own tensors: the probe's
    kernels (kpart's wrappers) and its forward products (cuBLAS, into the
    caught products), in order, and nothing else.  It rewrites every
    output of the probe as the probe wrote it."""
    for step in steps:
        if step[0] == "chain":
            kpart.part_chain(step[1])
        elif step[0] == "merge":
            kpart.part_merge(step[1])
        else:
            _, preds, prods, codes = step
            kpart.part_pred(preds)
            for r, f, c in prods:
                torch.matmul(r, f, out=c)
            kpart.part_code(codes)


def outputs_sha256(out: dict) -> str:
    """One sha256 of a probe's output grids, by name."""
    h = hashlib.sha256()
    for k in sorted(out):
        h.update(k.encode())
        h.update(out[k].cpu().numpy().tobytes())
    return h.hexdigest()


def sequence_parts(steps) -> list:
    """A caught probe sequence cut where chroma's first stage begins: about
    1,015 kernels a 1088x1920 frame (a cuBLAS product is often two), more
    than the launch queue holds behind a sleep kernel, and each part
    fewer.  Each part replays alone: chroma reads of luma only its split
    grids, which the luma part rewrites as they were."""
    cut = next(i for i, st in enumerate(steps) if st[0] == "stage"
               and pred_label(st[1][0]).startswith("c"))
    return [steps[:cut], steps[cut:]]


def sequence_us(torch, kpart, steps, runs: int = 5) -> list:
    """Device us of a caught probe sequence per frame, `runs` times: each
    part (sequence_parts) replayed behind its own sleep kernel, CUDA events
    around the part only (device_us), so that each launch may overlap its
    predecessor's tail as on the probe's path; the frame's time is the
    parts' sum (the one overlap across the cut is lost)."""
    parts = sequence_parts(steps)
    return [sum(device_us(torch, lambda p=p: replay_probe(torch, kpart, p),
                          1, 4 * SLEEP_CYCLES) for p in parts)
            for _ in range(runs)]


def pred_label(j) -> str:
    """A part_pred job's site: y16, y32, y64 or c8, c16, c32."""
    n = j.src.shape[0]
    return ("y" if j.av is not None or n == 64 else "c") + str(n)


def merge_label(jobs) -> str:
    """A part_merge launch's kind: luma (y) or chroma (uv), a half's
    merge or the superblock's second with the 64's (big)."""
    return (("y" if jobs[0].cost_m is not None else "uv")
            + ("-big" if jobs[0].do_big else "-half"))


def pred_merge_kinds(torch, kpart, steps, reps: int = 5) -> dict:
    """part_pred's and part_merge's calls of a caught probe sequence,
    grouped by launch kind (the sites of a part_pred launch, such as
    y16+y32+y64; a part_merge's plane and half), each kind's calls of the
    frame back to back behind a sleep kernel (device_us): launches, us a
    launch and per frame, CTAs (kpart's pred_ctas and merge_layout where
    the checkout has them, else the first version's grid).  Back to back a
    launch may start during the previous one's tail, so a launch's us is
    not its own alone.  It leaves the merged grids changed: replay the
    sequence after it.  Returns {kernel: [record per kind]}."""
    calls = {"part_pred": [s[1] for s in steps if s[0] == "stage"],
             "part_merge": [s[1] for s in steps if s[0] == "merge"]}
    label = {"part_pred": lambda jobs: "+".join(dict.fromkeys(
        pred_label(j) for j in jobs)), "part_merge": merge_label}

    def ctas(name, jobs):
        if name == "part_pred":
            if hasattr(kpart, "pred_ctas"):
                return kpart.pred_ctas(jobs)
            return len(jobs) * max((1 if j.av is None else 3)
                                   * j.src.shape[1] // j.src.shape[0]
                                   for j in jobs)
        if hasattr(kpart, "merge_layout"):
            lay = kpart.merge_layout(jobs)
            return lay.ctas * lay.rows
        return len(jobs) * max(j.recon.shape[1] // (4 * j.lv_s.shape[-1])
                               for j in jobs)

    out = {}
    for name, jobs_list in calls.items():
        fn = getattr(kpart, name)
        kinds: dict = {}
        for jobs in jobs_list:
            kinds.setdefault(label[name](jobs), []).append(jobs)
        out[name] = []
        for key, group in kinds.items():
            us = device_us(torch, lambda: [fn(j) for j in group], reps,
                           4 * SLEEP_CYCLES)
            out[name].append(dict(
                kind=key, launches=len(group), device_us=us / len(group),
                frame_us=us, ctas=sum(ctas(name, j) for j in group)))
    return out


def empty_launch_us(torch, count: int = 200) -> dict:
    """Device us a launch of a kernel that does nothing (one CTA of 32
    threads; av1_part_empty, `count` launches from one C call queued
    behind a sleep kernel): "plain" without a launch attribute, "pdl" with
    part_pred's (programmatic stream serialization; the kernel lets its
    dependent start, then waits, as the probe's kernels do)."""
    from av1tpu_torch._build import cuda_lib

    lib, out = cuda_lib(), {}
    for key, pdl in (("plain", 0), ("pdl", 1)):
        def run(pdl=pdl):
            err = lib.av1_part_empty(count, pdl,
                                     torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"av1_part_empty: cudaError {err}")
        out[key] = device_us(torch, run, 5, 4 * SLEEP_CYCLES) / count
    return out


def device_busy_ms(torch, fn) -> tuple[float, int, float]:
    """One fn() after a warm-up under torch.profiler (CUDA activity): the
    device's busy time in ms (the union of its kernels' intervals), the
    number of device kernels, and the ms of those whose name says gemm
    (cuBLAS).  For work that launches more kernels than the launch queue
    holds, which device_us cannot queue behind a sleep."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    gemm = sum(b - a for a, b, name in spans if "gemm" in name.lower())
    return busy / 1e3, len(spans), gemm / 1e3


def probe_vs_plain(torch, probe_args) -> dict:
    """Phase 7e: the probe's four kernels against their plain versions,
    on phase 7's probed frame at its q and on a 10-bit frame made from it
    (the planes times 4 plus 2, q 72).  (a) Every wrapper call of the
    kernels' probe beside its plain version on copies of the same inputs
    (_stage_diff): a decision may differ only at a near-tie, a chain level
    only at a boundary, and nothing else; each is printed.  (b) The whole
    probe both ways: every output grid equal to (a)'s run of the kernels,
    the count of differing decisions (modes16, modes32, split, split64),
    levels and pixels against the plain versions, all 0 where (a) found
    nothing.  Every cost within TIE_REL of the plain version's.  (c) Per
    kernel, the 8-bit frame's calls replayed: the device time per probed
    frame (queued behind a sleep kernel), the plain versions' time (CUDA
    events), the bound (part_bounds), the launches per frame; part_chain's
    serial floor, and its time per job on both frames (chain_times).
    (d) The probe's host time with the kernels and with the plain
    versions, and its device busy time with the kernels (device_busy_ms).
    (e) The empty-launch floor (empty_launch_us), the probe's device
    sequence per frame (sequence_us) and part_pred's and part_merge's
    launch kinds (pred_merge_kinds).  Returns the four kernels' records
    for the JSON line."""
    from av1tpu_torch.kernels import intra_part as kpart
    from av1tpu_torch.models import intra_part

    (y, u, v, q), kw = probe_args[0][:4], probe_args[1]
    bd = kw.get("bit_depth", 8)
    h, w = y.shape
    frames = [("8-bit", (y, u, v), q, bd),
              ("10-bit", tuple(p * 4 + 2 for p in (y, u, v)), 72, 10)]
    per_frame = intra_part.part_launches(h, w)
    recs = {n: {"decisions": 0, "levels": 0, "pixels": 0, "max_abs_err": 0,
                "boundary": 0, "cost_rel": 0.0} for n in PART_KERNELS}
    n_all = 0          # decisions of both frames
    timing_calls = None
    for label, planes, qq, b in frames:
        # (a) stage by stage
        calls = {n: [] for n in PART_KERNELS}
        flagged = []       # this frame's flips and boundary levels
        saved = {n: getattr(intra_part, n) for n in PART_KERNELS}

        def catch(name):
            kernel, plain = saved[name], getattr(kpart, name + "_plain")

            def run(jobs):
                copies = [_clone_job(j) for j in jobs]
                plain(copies)
                kernel(jobs)
                d = _stage_diff(torch, name, jobs, copies)
                for k in ("decisions", "levels", "pixels", "boundary"):
                    recs[name][k] += d[k]
                recs[name]["max_abs_err"] = max(recs[name]["max_abs_err"],
                                                d["max_abs_err"])
                recs[name]["cost_rel"] = max(recs[name]["cost_rel"],
                                             d["cost_rel"])
                for tie in d["ties"]:
                    print(f"probe {label} {name} differs at a near-tie: "
                          f"{tie}", flush=True)
                flagged.extend(d["ties"])
                calls[name].append(list(jobs))
            return run

        for n in PART_KERNELS:
            setattr(intra_part, n, catch(n))
        try:
            ka = intra_part.encode_intra_part(*planes, qq, bit_depth=b)
        finally:
            for n, f in saved.items():
                setattr(intra_part, n, f)
        torch.cuda.synchronize()
        assert {n: len(c) for n, c in calls.items()} == per_frame
        if timing_calls is None:
            timing_calls = calls

        # (b) the whole probe both ways
        zero_launches()
        ko = intra_part.encode_intra_part(*planes, qq, bit_depth=b)
        torch.cuda.synchronize()
        assert {n: k.launches for n, k in zip(
            PART_KERNELS, (kpart.part_chain, kpart.part_pred,
                           kpart.part_code, kpart.part_merge))} == per_frame
        with plain_part_kernels():
            po = intra_part.encode_intra_part(*planes, qq, bit_depth=b)
        torch.cuda.synchronize()
        assert set(ko) == set(po) == set(ka)
        for k in ko:
            assert ko[k].dtype == po[k].dtype and ko[k].shape == po[k].shape
            # the kernels are deterministic: (a) checked this probe's calls
            assert torch.equal(ko[k], ka[k]), (label, k)
        decisions = {k: int((ko[k] != po[k]).sum())
                     for k in ("modes16", "modes32", "split", "split64")}
        levels = sum(int((ko[k] != po[k]).sum()) for k in ko
                     if k.startswith("levels"))
        pixels = sum(int((ko[k] != po[k]).sum()) for k in ko
                     if k.startswith("recon"))
        n_dec = sum(ko[k].numel() for k in decisions)
        print(f"probe {label} {w}x{h} q={qq}: kernels vs plain, differing "
              f"decisions {decisions} of {n_dec}, levels {levels}, recon "
              f"pixels {pixels}; split {int(ko['split'].sum())} of "
              f"{ko['split'].numel()}, split64 {int(ko['split64'].sum())} "
              f"of {ko['split64'].numel()}", flush=True)
        # a difference of the whole probe comes from a flip or boundary
        # level of (a), each checked there
        if not flagged:
            assert sum(decisions.values()) == levels == pixels == 0, (
                label, decisions, levels, pixels)
        assert sum(decisions.values()) <= 0.001 * n_dec, decisions
        n_all += n_dec
    for n in PART_KERNELS:
        print(f"{n} stage by stage on both frames: {recs[n]}", flush=True)
        assert recs[n]["decisions"] <= 0.001 * n_all, (n, recs[n])
        assert recs[n]["cost_rel"] < TIE_REL, (n, recs[n])

    # (c) each kernel's time per probed frame, the 8-bit frame's calls
    wrappers = {"part_chain": kpart.part_chain, "part_pred": kpart.part_pred,
                "part_code": kpart.part_code, "part_merge": kpart.part_merge}
    bounds = part_bounds(timing_calls)
    reps = {"part_chain": 50, "part_pred": 5, "part_code": 5,
            "part_merge": 10}
    out = {}
    for n in PART_KERNELS:
        kernel, plain = wrappers[n], getattr(kpart, n + "_plain")
        jobs_list = timing_calls[n]
        dev = device_us(torch, lambda: [kernel(j) for j in jobs_list],
                        reps[n], 4 * SLEEP_CYCLES)
        plain_ms = _median_ms(torch, lambda: [plain(j) for j in jobs_list],
                              n=3)
        bound_us, by = bounds[n]
        extra = (f", serial floor {chain_floor_us(jobs_list[0]):.3f} us "
                 "(chain_floor_us)" if n == "part_chain" else "")
        if n in ("part_pred", "part_merge"):
            extra += ("; its calls back to back: each may start during the "
                      "previous one's tail (PDL)")
        print(f"{n} per probed {w}x{h} frame: {per_frame[n]} launches, "
              f"device {dev:.3f} us, plain {plain_ms:.3f} ms, bound "
              f"{bound_us:.4f} us ({by}{extra}, roofline "
              f"{bound_us / dev:.4f})", flush=True)
        out[n] = {"max_abs_err": recs[n]["max_abs_err"],
                  "ms": dev / 1e3, "plain_ms": plain_ms,
                  "bound_ms": bound_us / 1e3, "bound_by": by,
                  "launches_per_frame": per_frame[n],
                  "decisions_differ": recs[n]["decisions"]}

    # part_chain per job (8 and 10 bits) and part_code per launch kind, on
    # the frames' calls
    for label, planes, qq, b in frames:
        ct = chain_times(torch, kpart, capture_chain_jobs(torch, planes, qq,
                                                          b))
        print(f"part_chain {label} per job: all {ct['all']:.3f} us, luma "
              f"{ct['y']:.3f}, U {ct['u']:.3f}, V {ct['v']:.3f}; serial "
              f"floor {ct['floor_us']:.3f} us; sha256 {ct['sha256']}",
              flush=True)
        out["part_chain"].setdefault("per_job_us", {})[label] = {
            k: ct[k] for k in ("all", "y", "u", "v")}
    out_dir = os.environ.get("AV1TPU_SMOKE_OUT")
    if out_dir:      # the frame tools/search_compare.py --probe times
        os.makedirs(out_dir, exist_ok=True)
        from av1tpu_torch.ops.transforms import built_forward_matrices

        torch.save({"planes": [p.cpu() for p in (y, u, v)], "q": int(q),
                    "bit_depth": bd}, os.path.join(out_dir,
                                                   "probe_inputs.pt"))
        # this process's forward matrices, which --probe then adopts
        np.savez(os.path.join(out_dir, "probe_inputs_forward.npz"), **{
            k if k == "fwd64" else "_".join(map(str, k)): m
            for k, m in built_forward_matrices().items()})
    kinds = code_kinds(torch, kpart, capture_code_calls(torch, (y, u, v), q,
                                                        bd))
    for r in kinds:
        print(f"part_code {r['kind']}: {r['launches']} launches, device "
              f"{r['device_us']:.3f} us a launch ({r['frame_us']:.3f} us per "
              f"frame), {r['columns']} columns, {r['ctas']} CTAs with work; "
              f"alone {r['alone_us']}; columns without a level "
              f"{r['no_level']}", flush=True)
    out["part_code"]["per_kind_us"] = {r["kind"]: r["device_us"]
                                       for r in kinds}
    for line in ptxas_report(BUILD_LOG, (
            "part_code_kernel", "part_chain_kernel", "part_pred_kernel",
            "part_merge_kernel")):
        print(f"-Xptxas -v {line}", flush=True)

    # (e) the floor of a launch, the whole probe's device sequence per
    # frame and part_pred's and part_merge's launch kinds
    floor = empty_launch_us(torch)
    print(f"empty launch: {floor['plain']:.3f} us a launch, "
          f"{floor['pdl']:.3f} us with programmatic stream serialization "
          "(av1_part_empty, 200 launches behind a sleep kernel)", flush=True)
    steps, seq_out, costs_sha = capture_probe_sequence(torch, (y, u, v), q,
                                                       bd)
    want = outputs_sha256(seq_out)
    seq = sequence_us(torch, kpart, steps)
    kinds_pm = pred_merge_kinds(torch, kpart, steps)
    replay_probe(torch, kpart, steps)
    torch.cuda.synchronize()
    assert outputs_sha256(seq_out) == want, "the replay differs"
    print(f"probe sequence per {w}x{h} frame ({len(steps)} steps: chain, "
          f"pred, cuBLAS products, code, merge; events around its luma and "
          f"its chroma part, summed): "
          f"{[round(x, 3) for x in seq]} us, median {np.median(seq):.3f}; "
          f"outputs sha256 {want}, region costs sha256 {costs_sha}",
          flush=True)
    for name, recs_k in kinds_pm.items():
        for r in recs_k:
            print(f"{name} {r['kind']}: {r['launches']} launches, device "
                  f"{r['device_us']:.3f} us a launch back to back "
                  f"({r['frame_us']:.3f} us per frame), {r['ctas']} CTAs",
                  flush=True)
        out[name]["per_kind_us"] = {r["kind"]: r["device_us"]
                                    for r in recs_k}
    for n in PART_KERNELS:
        out[n].update(empty_launch_us=floor,
                      probe_sequence_us=float(np.median(seq)))

    # (d) the probe's host and device time, kernels and plain versions
    def probe():
        return intra_part.encode_intra_part(y, u, v, q, bit_depth=bd)

    def host_s(fn, n):
        ts = []
        for _ in range(n):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t)
        return float(np.median(ts))

    k_host = host_s(probe, 5)
    k_dev, k_kernels, k_gemm = device_busy_ms(torch, probe)
    with plain_part_kernels():
        p_host = host_s(probe, 1)
        a, b2 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        probe()
        b2.record()
        b2.synchronize()
        p_event = a.elapsed_time(b2)
    print(f"probe {w}x{h}: kernels host {k_host * 1e3:.3f} ms (median of "
          f"5, synchronized), device busy {k_dev:.3f} ms in {k_kernels} "
          f"device kernels ({k_gemm:.3f} ms of them the cuBLAS products; "
          f"torch.profiler); plain versions host {p_host * 1e3:.3f} ms, "
          f"events {p_event:.3f} ms", flush=True)
    for n in PART_KERNELS:
        out[n].update(probe_host_ms=k_host * 1e3, probe_device_ms=k_dev,
                      probe_device_kernels=k_kernels,
                      plain_probe_host_ms=p_host * 1e3)
    return out


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
        with ScenePlan() as plan:
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
    print_digest("daemon command", ivf)
    assert launches["transform_quantize"] == 0, launches
    assert_part(launches, stats["scenes"])
    assert_wave(launches, stats["scenes"])
    assert_coder_cdef(launches, inter_want(plan.scenes(), "quality"))
    assert all(v == {"cuda"} for v in seen.values()), seen
    # this cell before the inter step's kernels (NVIDIA H100 80GB HBM3,
    # 700.00 W; PERF.md)
    assert abs(stats["bytes"] - 104684) <= 0.01 * 104684, stats["bytes"]
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
    with ScenePlan() as plan:
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
    print_digest("layers 2", ivf)
    assert launches["transform_quantize"] == 0, launches
    assert_part(launches, stats["scenes"])
    assert_wave(launches, stats["scenes"])
    assert_coder_cdef(launches, inter_want(plan.scenes(), "quality",
                                           layered=True))
    return launches


def all_intra_1080p(torch, y4m: str, tmp: str, preset: str):
    """Phase 11, one preset.  Returns the launches: per frame the fast
    keyframe's U+V stack (COLS + ROWS - 1 transform_quantize steps; its
    luma takes the RDO path, which has no kernel) or the quality frame's
    probe kernels (part_launches), plus one probe encode per scene (fast:
    luma and the U+V stack, 2 * (COLS + ROWS - 1); quality: the probe
    kernels once more), whose recon gives both the metric score and the
    PSNR.  No wavefront keyframe: the all-intra chunks are intra_v's and
    intra_part's."""
    ivf = os.path.join(tmp, f"intra_{preset}.ivf")
    zero_launches()
    _, stats = run_cli(_daemon_argv(y4m, ivf, "--all-intra", "--max-frames",
                                    str(INTRA_FRAMES), "--preset", preset))
    torch.cuda.synchronize()
    launches = read_launches()
    per_frame, probe = ((COLS + ROWS - 1, 2 * (COLS + ROWS - 1))
                        if preset == "fast" else (0, 0))
    want = INTRA_FRAMES * per_frame + stats["scenes"] * probe
    print(f"all-intra {preset}: frames={stats['frames']} "
          f"fps={stats['encode_fps']} bytes={stats['bytes']} "
          f"psnr_y={stats['psnr_y']} tpu_vmaf={stats['tpu_vmaf']} "
          f"launches={launches} (derived {want})", flush=True)
    assert stats["keyframes"] == stats["frames"] == ivf_frames(ivf)
    assert stats["frames"] == INTRA_FRAMES
    print_digest(f"all-intra {preset}", ivf)
    assert launches["transform_quantize"] == want, (launches, want)
    assert_part(launches, 0 if preset == "fast" else
                INTRA_FRAMES + stats["scenes"])
    assert_wave(launches, 0)
    assert_coder_cdef(launches, inter_want([], preset))
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

    def scenes(self) -> list:
        """[(frames, chosen CDEF preset)] of the scenes the workers coded
        (coder_cdef_want's input)."""
        return [(len(r["inter_bufs"]) + 1, r["cdef_s"]) for r in self.results]

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
    assert_part(parent, st_b["scenes"], 64, 128)   # the parent's probes
    assert_wave(parent, 0)
    assert_wave(launches, st_b["scenes"])
    # the temporal filter runs in the parent, the inter frames in workers
    assert_coder_cdef(parent, {"code_blocks": 0, "cdef_filter": 0,
                               **search_deblock_want(spy.scenes(), "quality",
                                                     q=120, inter=False)})
    assert_coder_cdef(launches, inter_want(spy.scenes(), "quality", q=120))
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
            with _BatchSpy(gop, cli, devices, pool) as spy, \
                    ScenePlan() as plan:
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
            print_digest(f"batch 1080p workers={workers}", streams)
            # the probes run in the parent, the keyframes in the workers
            assert launches["transform_quantize"] == 0, launches
            assert_part(parent, stats["scenes"])
            assert_part(launches, stats["scenes"])
            assert_wave(launches, stats["scenes"])
            if workers > 1:
                assert_wave(parent, 0)
                assert_coder_cdef(parent, {
                    "code_blocks": 0, "cdef_filter": 0,
                    **search_deblock_want(spy.scenes(), "quality",
                                          inter=False)})
            assert_coder_cdef(launches, inter_want(
                spy.scenes() if workers > 1 else plan.scenes(), "quality"))
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
    kernel, [(frames, chosen CDEF preset)] per scene)."""
    ivf = os.path.join(out_dir, name + ".ivf")
    zero_launches()
    with ReconSpy() as spy, ScenePlan() as plan:
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
    return stats, launches, plan.scenes()


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
    stats, launches, scenes = card_encode(
        torch, "daemon_command", lambda ivf: _daemon_argv(src, ivf, *extra),
        out_dir, device)
    print(f"daemon command on {device}, {w}x{h} {n} frames from "
          f"{os.path.basename(src)} at --chunk 1: bytes={stats['bytes']} "
          f"scenes={stats['scenes']} launches={launches}", flush=True)
    assert stats["frames"] == ivf_frames(
        os.path.join(out_dir, "daemon_command.ivf")) == n
    print_digest(f"daemon command {w}x{h}",
                 os.path.join(out_dir, "daemon_command.ivf"))
    on_card = device == "cuda"
    assert launches["transform_quantize"] == 0, launches
    # the quality preset's probe and keyframe, one per scene, at the coded
    # size
    assert_part(launches, stats["scenes"] if on_card else 0,
                (h + 63) & ~63, (w + 63) & ~63)
    assert_wave(launches, stats["scenes"] if on_card else 0)
    assert_coder_cdef(launches, inter_want(
        scenes if on_card else [], "fast" if "fast" in extra else "quality"))
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
    stats, launches, scenes = card_encode(
        torch, "fast_1080p", lambda ivf: [
            "encode", "-i", y4m, "-o", ivf, "--qindex", str(QINDEX),
            "--preset", "fast"], out_dir, device)
    print(f"fast preset on {device}, {w}x{h} {n} frames at --chunk 1: "
          f"bytes={stats['bytes']} psnr_y={stats['psnr_y']} "
          f"scenes={stats['scenes']} launches={launches}", flush=True)
    assert stats["frames"] == n
    print_digest(f"fast preset {w}x{h}", os.path.join(out_dir,
                                                      "fast_1080p.ivf"))
    # at chunk 1 the scene detector's minimum scene length is 1
    assert launches["transform_quantize"] == (
        3 * (COLS + ROWS - 1) * stats["scenes"] if device == "cuda" else 0), (
        launches)
    assert_wave(launches, 0)
    assert_coder_cdef(launches, inter_want(
        scenes if device == "cuda" else [], "fast"))
    if tool is not None:
        dec, diffs = decode_check(tool, out_dir, "fast_1080p", tmp)
        assert dec is not None
        assert dec["frames"] == len(diffs) == n
        assert all(d == (0, 0, 0) for d in diffs.values()), diffs
    return launches


def main() -> int:
    global BUILD_LOG
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
        BUILD_LOG = log
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
    (launches_quality, key_args, gop_args, tf_args,
     probe_args) = quality_slice_1080p(torch, clip, fast_stats)
    _phase("quality_slice_1080p", t)

    t = time.perf_counter()
    wave_recs = wave_vs_plain(torch, key_args)
    _phase("wave_vs_plain", t)

    t = time.perf_counter()
    inter_recs = inter_vs_plain(torch, gop_args)
    _phase("inter_vs_plain", t)

    t = time.perf_counter()
    inter_recs.update(search_deblock_vs_plain(torch, gop_args, tf_args))
    del gop_args, tf_args
    _phase("search_deblock_vs_plain", t)

    t = time.perf_counter()
    part_recs = probe_vs_plain(torch, probe_args)
    del probe_args
    _phase("probe_vs_plain", t)

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
        # no PyTorch call computes the keyframe step
        "library_ms": None, **r}
        for name, r in wave_recs.items()]
    inter = [{
        "name": name, "route": "cuda", "source": source,
        "replaces": replaces,
        "launches": sum(path_counts(name).values()),
        "launches_by_path": path_counts(name),
        # no one PyTorch call computes any of these functions
        "library_ms": None, **inter_recs[name]}
        for name, source, replaces in (
            ("code_blocks", "av1tpu_torch/csrc/inter_code.cu",
             "av1tpu/models/inter_v.py:1022"),
            ("cdef_filter", "av1tpu_torch/csrc/cdef.cu",
             "av1tpu/models/cdef_tpu.py:173"),
            ("coarse_search", "av1tpu_torch/csrc/motion.cu",
             "av1tpu/models/inter_v.py:89"),
            ("global_search", "av1tpu_torch/csrc/motion.cu",
             "av1tpu/models/inter_v.py:287"),
            ("refine_subpel", "av1tpu_torch/csrc/motion.cu",
             "av1tpu/models/inter_v.py:252"),
            ("deblock_edges", "av1tpu_torch/csrc/deblock.cu",
             "av1tpu/models/deblock_tpu.py:394"))]
    part = [{
        "name": name, "route": "cuda",
        "source": "av1tpu_torch/csrc/intra_part.cu",
        "replaces": PART_REPLACES[name],
        "launches": sum(path_counts(name).values()),
        "launches_by_path": path_counts(name),
        # no one PyTorch call computes any of these functions
        "library_ms": None, **part_recs[name]}
        for name in PART_KERNELS]
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
        *wave, *inter, *part], "metric_pass_ms": metric_ms}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
