"""Command-line encoder on a GPU (port of av1tpu/cli.py): the encode
backend of the C++ daemon.

    python3 -m av1tpu_torch.cli encode -i INPUT -o OUTPUT.ivf \
        [--qindex N] [--workers W] [--chunk K] [--max-frames N] \
        [--metric tpu_vmaf|ssim|psnr] [--target-quality T] \
        [--preset quality|fast] [--layers 1|2] [--all-intra] [--device cuda]

The options, their defaults and the stats are the reference's, so the
daemon's command template (native/daemon/encoder.cpp) runs with av1tpu
replaced by av1tpu_torch.  `encode_clip` runs the paths of
av1tpu.cli.encode_clip: scene detection, the per-scene q probe (scored by
--metric), the temporal filter, the keyframe with its CDEF strength search,
then chunks of inter frames with deblock and CDEF (with --layers 2 every
other frame is a non-reference frame at a coarser q), or with --all-intra
every frame a keyframe; packed by the C++ entropy packer
(native/coding/pack.cpp, the one source shared with the JAX package).  The
quality preset (partitions=True) probes with the 64/32/16 partition intra,
codes the keyframe with the 13-mode wavefront pipeline and the inter frames
with the partitioned step (8x8 sub-block MVs, LAST/GOLDEN, 32/64 merges,
skip RDO); the fast preset (partitions=False) keeps the fixed 16x16 grid.
With --workers N on several GPUs the scenes run as a batch, one worker
process per GPU (parallel/gop.py), and the parent packs their buffers.
Non-y4m inputs and non-IVF outputs go through av1_tool
(native/tools/av1_tool.c), which _build.av1_tool_path() compiles into
av1tpu_torch/_build/ at the first such use (libav* via pkg-config).  Prints
progress lines and one JSON stats line.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from av1tpu_torch import _build
from av1tpu_torch.spec.bits import BitWriter
from av1tpu_torch.spec.encode_frame import (
    EncoderConfig, make_frame_header, make_frame_header_inter,
    make_sequence_header,
)
from av1tpu_torch.spec.headers import (
    write_frame_header_inter, write_frame_header_key, write_sequence_header,
)
from av1tpu_torch.spec.obu import (
    OBU_FRAME, OBU_SEQUENCE_HEADER, build_obu, temporal_delimiter, write_ivf,
)
from av1tpu_torch.utils.yuv import read_y4m

# keyframe quality boost (qindex steps below the scene q); --key-q-boost
KEY_Q_BOOST = 24


class _StageClock:
    """Accumulating per-stage wall-clock timers (stats["stage_seconds"])."""

    def __init__(self):
        self.acc: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] = (self.acc.get(name, 0.0)
                              + time.perf_counter() - t)


class _CapacityExceeded(RuntimeError):
    """Compact-transport value list overflowed; retry with a larger cap."""

    def __init__(self, count: int):
        super().__init__(f"compact capacity exceeded ({count} values)")
        self.count = count


def _pad_plane(a: np.ndarray, h: int, w: int) -> np.ndarray:
    out = np.zeros((h, w), np.int32)
    ah, aw = a.shape
    out[:ah, :aw] = a
    if aw < w:
        out[:ah, aw:] = out[:ah, aw - 1 : aw]
    if ah < h:
        out[ah:, :] = out[ah - 1 : ah, :]
    return out


def _cdef_cfg_kw(cdef):
    """EncoderConfig kwargs for a coded strength tuple (None = disabled)."""
    if cdef is None:
        return {}
    return {"enable_cdef": 1, "cdef_y_pri": cdef[0], "cdef_y_sec": cdef[1],
            "cdef_uv_pri": cdef[2], "cdef_uv_sec": cdef[3]}


def _wrap_tu(tile: bytes, coded_w: int, coded_h: int, render_w: int,
             render_h: int, qindex: int, bit_depth: int = 8,
             lf=(0, 0, 0, 0), cdf_save: bool = False,
             cdef=None, tx_select: bool = False) -> bytes:
    """A keyframe's temporal unit: delimiter, sequence header and the frame
    OBU (key frame header + tile)."""
    cfg = EncoderConfig(base_q_idx=qindex, bit_depth=bit_depth,
                        loop_filter_level=tuple(lf),
                        tx_mode_select=int(tx_select), **_cdef_cfg_kw(cdef))
    seq = make_sequence_header(coded_w, coded_h, cfg)
    fh = make_frame_header(seq, cfg)
    if cdf_save:  # decoder saves end-of-frame CDFs into the ref slots
        fh.disable_frame_end_update_cdf = 0
    fh.render_width, fh.render_height = render_w, render_h
    bw = BitWriter()
    write_frame_header_key(seq, fh, bw)
    bw.byte_align()
    return (temporal_delimiter()
            + build_obu(OBU_SEQUENCE_HEADER, write_sequence_header(seq))
            + build_obu(OBU_FRAME, bw.bytes() + tile))


def _wrap_tu_inter(tile: bytes, coded_w: int, coded_h: int, render_w: int,
                   render_h: int, qindex: int, bit_depth: int = 8,
                   lf=(0, 0, 0, 0), primary_ref: int | None = None,
                   cdf_save: bool = False, cdef=None,
                   golden: bool = False, refresh: bool = True) -> bytes:
    """An inter frame's temporal unit: delimiter and the frame OBU."""
    cfg = EncoderConfig(base_q_idx=qindex, bit_depth=bit_depth,
                        loop_filter_level=tuple(lf), **_cdef_cfg_kw(cdef))
    seq = make_sequence_header(coded_w, coded_h, cfg)
    # golden: GOLDEN maps to slot 1, which holds the scene keyframe (the
    # keyframe refreshes every slot; inter frames refresh only slot 0)
    fh = make_frame_header_inter(seq, cfg, golden=golden, refresh=refresh)
    if primary_ref is not None:  # CDFs carried from LAST's saved state
        fh.primary_ref_frame = primary_ref
    if cdf_save:
        fh.disable_frame_end_update_cdf = 0
    fh.render_width, fh.render_height = render_w, render_h
    bw = BitWriter()
    write_frame_header_inter(seq, fh, bw)
    bw.byte_align()
    return temporal_delimiter() + build_obu(OBU_FRAME, bw.bytes() + tile)


def _device_count(dev: torch.device) -> int:
    """Devices a scene batch could shard across: the GPUs for a CUDA
    device, 1 for the CPU."""
    return torch.cuda.device_count() if dev.type == "cuda" else 1


def encode_clip(clip, qindex: int, chunk: int = 4, progress=None,
                target_quality: float = 0.0, metric: str = "tpu_vmaf",
                partitions: bool = True, scene_threshold: float = 2.5,
                gop: bool = True, key_q_boost: int = KEY_Q_BOOST,
                key_lam_scale: float = 0.3, key_tf: bool = True,
                workers: int = 1, layers: int = 1, nr_q_delta: int = 12, *,
                device="cuda") -> tuple[list[bytes], dict]:
    """Encode a Clip into AV1 TUs.  Same signature, defaults and stats
    keys as av1tpu.cli.encode_clip, plus the device to run on.  gop=True
    codes one keyframe per scene and inter frames in between (layers=2
    with partitions: every other inter frame a non-reference frame at
    qindex + nr_q_delta); gop=False codes every frame as a keyframe.  With
    target_quality > 0 a per-scene CQ bisection picks the coarsest qindex
    whose probe scores the target on `metric`.  workers > 1 with gop,
    more than one device and more than one scene runs the reference's
    scene batch (parallel/gop.py): the scenes dealt to min(workers,
    devices) worker processes, one per GPU, each scene's keyframe the
    wavefront one and every inter frame a reference frame (`layers` is not
    read there, as in the reference).  Returns (per-frame OBU streams,
    stats)."""
    from av1tpu_torch.coding.packer import Packer
    from av1tpu_torch.core.scenes import scene_scores, split_scenes
    from av1tpu_torch.models.cdef import (
        cdef_fused, select_strengths, skip8_host,
    )
    from av1tpu_torch.models.cq import cq_search_multi, probe_scores_multi
    from av1tpu_torch.models.deblock import lf_levels
    from av1tpu_torch.models import inter_v, intra_part, intra_v, intra_wave
    from av1tpu_torch.models.inter_v import (
        fetch_inter_part_prefix, split_compact_inter,
        split_compact_inter_part,
    )
    from av1tpu_torch.models.intra_part import split_compact_part
    from av1tpu_torch.models.intra_v import fuse_planes, split_compact
    from av1tpu_torch.models.intra_wave import split_compact_wave
    from av1tpu_torch.models.tfilter import temporal_filter_key

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but CUDA is not "
                           "available")
    width, height = clip.width, clip.height
    bd = clip.bit_depth
    cw = (width + 63) & ~63
    ch = (height + 63) & ~63
    inter_cap = max(131072, (ch * cw) // 8)
    packer = Packer()
    clock = _StageClock()
    streams: list[bytes] = []
    t0 = time.perf_counter()
    n = clip.num_frames
    q_used: list[int] = []
    scores: list[float] = []
    psnrs: list = []
    # 10-bit sources ride as int32 (torch's uint16 support is thin)
    src_dtype = torch.uint8 if bd == 8 else torch.int32

    def upload(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            dev, dtype=src_dtype)

    if n > 1:
        with clock("scene_detect"):
            sc = scene_scores(upload(clip.y[:, ::4, ::4])).cpu().numpy()
        segments = split_scenes(sc, threshold=scene_threshold,
                                min_len=chunk, max_len=240)
    else:
        segments = [(0, n)]

    def padded(i):
        return (_pad_plane(clip.y[i].astype(np.int32), ch, cw),
                _pad_plane(clip.u[i].astype(np.int32), ch // 2, cw // 2),
                _pad_plane(clip.v[i].astype(np.int32), ch // 2, cw // 2))

    def _probe_frames(s0, e0, full: bool):
        mid = (s0 + e0 - 1) // 2
        idxs = sorted({s0, mid, e0 - 1}) if full else [mid]
        return [tuple(torch.from_numpy(p).to(dev) for p in padded(i))
                for i in idxs]

    def select_q(seg, probe_psnr=False):
        """The scene's q (fixed, or the CQ search's), its probe score on
        `metric` into `scores` and, with probe_psnr (all-intra, where no
        recon is measured), the probe's PSNR into `psnrs`.  One probe
        encode per frame serves every score at q."""
        with clock("probe"):
            frames = _probe_frames(*seg, full=target_quality > 0)
            got = {}
            if target_quality > 0:
                q, got[metric] = cq_search_multi(
                    frames, target_quality, metric=metric, bit_depth=bd,
                    partitions=partitions)
            else:
                q = qindex
            want = (metric, "psnr") if probe_psnr else (metric,)
            missing = [m for m in dict.fromkeys(want) if m not in got]
            if missing:
                got.update(probe_scores_multi(frames, q, missing,
                                              bit_depth=bd,
                                              partitions=partitions))
        scores.append(got[metric])
        if probe_psnr:
            psnrs.append(got["psnr"])
        return q

    ny_pad = ch * cw
    sh8 = bd - 8

    def _recon_psnr(ref_fused, src_fused):
        """Measured luma PSNR of an emitted frame (recon vs source, 8-bit
        range), as a device scalar."""
        r = (ref_fused[:ny_pad] >> sh8).to(torch.float32)
        s = (src_fused[:ny_pad].to(torch.int32) >> sh8).to(torch.float32)
        e = r - s
        mse = torch.clamp((e * e).sum() / ny_pad, min=1e-10)
        return 10.0 * torch.log10(255.0 * 255.0 / mse)

    def pack_key(buf, q, kind, lf, cdf_out=None, cdef=None):
        """One keyframe TU.  kind: "wave" (the quality preset's GOP
        keyframe), "part" (its all-intra frames) or "v" (the fast
        preset's).  cdf_out: the CDF carry blob the frame's end state is
        saved into (the inter chain loads it), None in all-intra."""
        if kind == "part":
            (count, bm, vals, m16, m32, sp,
             sp64) = split_compact_part(buf, ch, cw)
            if count > len(vals):
                raise _CapacityExceeded(count)
            tile = packer.pack_tile_part(bm, vals, m16, m32, sp, sp64,
                                         ch, cw, q, cdf_out=cdf_out)
        elif kind == "wave":
            count, bm, vals, modes, txd = split_compact_wave(buf, ch, cw)
            if count > len(vals):
                raise _CapacityExceeded(count)
            # the wavefront keyframe codes chroma DC_PRED (0), derives
            # each luma block's tx_type from its mode and signals a
            # per-block tx depth (TX_MODE_SELECT)
            tile = packer.pack_tile_compact(bm, vals, ch, cw, q, modes=modes,
                                            uv_mode=0, tx_from_mode=True,
                                            cdf_out=cdf_out, txd=txd)
        else:
            count, bm, vals, modes = split_compact(buf, ch, cw)
            if count > len(vals):
                raise _CapacityExceeded(count)
            tile = packer.pack_tile_compact(bm, vals, ch, cw, q, modes=modes,
                                            uv_mode=1, cdf_out=cdf_out)
        return _wrap_tu(tile, cw, ch, width, height, q, bd,
                        lf=(lf[0], lf[0], lf[1], lf[2]),
                        cdf_save=cdf_out is not None, cdef=cdef,
                        tx_select=kind == "wave")

    ncoef = ch * cw + 2 * (ch // 2) * (cw // 2)

    def pack_inter_tile(buf, q, cdfs_c, cdef_s, nonref: bool = False):
        """One inter TU.  nonref: a non-reference frame of the 2-layer
        pyramid, which refreshes no reference slot, leaves the CDF chain
        alone and signals its in-loop filters off (the device did not run
        them, so the decoder's output still equals the device recon)."""
        if partitions:
            (count, bm, vals, s16, s32, s64, ref16,
             mv) = split_compact_inter_part(buf, ch, cw)
            if count > len(vals):
                raise _CapacityExceeded(count)
            tile = packer.pack_tile_inter_part(
                bm, vals, s32, s64, mv, ch, cw, q, cdf_in=cdfs_c,
                cdf_out=None if nonref else cdfs_c, split16=s16,
                refs=ref16 if ref16.any() else None)
        else:
            count, bm, vals, mv = split_compact_inter(buf, ch, cw)
            if count > len(vals):
                raise _CapacityExceeded(count)
            tile = packer.pack_tile_inter(bm, vals, mv, ch, cw, q,
                                          cdf_in=cdfs_c, cdf_out=cdfs_c)
        ilf = (0, 0, 0, 0) if nonref else lf_levels(q)
        return _wrap_tu_inter(
            tile, cw, ch, width, height, q, bd,
            lf=(ilf[0], ilf[0], ilf[2], ilf[3]), primary_ref=0,
            cdf_save=not nonref,
            cdef=(0, 0, 0, 0) if nonref else tuple(int(x) for x in cdef_s),
            golden=partitions, refresh=not nonref)

    def scene_plan(s0, e0):
        """A GOP scene's q (probed), its keyframe's q, the keyframe's and
        the inter frames' loop-filter levels and the temporal filter's
        count of real neighbours."""
        q = select_q((s0, e0))
        q_used.append(q)
        # keyframe quality boost: the keyframe is every following frame's
        # (transitive) reference
        key_q = max(q - key_q_boost, 1) if e0 - s0 > 1 else q
        lyk, _, luk, lvk = lf_levels(key_q)
        ly_i, _, lu_i, lv_i = lf_levels(q)
        # wavefront keyframes signal TX_MODE_SELECT: sub-tx edges are
        # transform-block deblock edges the deblock pass does not model, so
        # their in-loop filter is off (CDEF still runs)
        key_lf = (0, 0, 0) if partitions else (lyk, luk, lvk)
        ntf = min(7, e0 - s0 - 1) if key_tf else 0
        return q, key_q, key_lf, (ly_i, lu_i, lv_i), ntf

    def key_filter(key_dev, neigh: np.ndarray):
        """The keyframe's temporal filter over its 7 neighbours (the key
        itself past the scene's end): (filtered key, the keyframe's and the
        inter frames' RDOQ noise floors).  The floors, read by the quality
        preset only: keyframe coefficients inside the (3 sigma)^2 band
        explain noise only; inter frames code raw sources, 1.5x the
        per-frame sigma.  Python floats from float32 scalars, as the
        reference makes them: a 1-ulp difference flips keep/zero at the
        gate boundary."""
        with clock("tfilter"):
            key_src, sig, sig1 = temporal_filter_key(
                key_dev, upload(neigh), ch, cw, bit_depth=bd)
            return key_src, float((3.0 * sig) ** 2), float((1.5 * sig1) ** 2)

    n_dev = _device_count(dev)
    if gop and workers > 1 and n_dev > 1 and len(segments) > 1:
        # several devices: the scene batch, one worker process per device
        # (the reference's av1an --workers axis).  Its keyframe is always
        # the wavefront one, and it codes every inter frame as a reference
        # frame whatever `layers` says, as the reference's batch does
        from av1tpu_torch.parallel import gop as scene_batch

        wdev = min(workers, n_dev)
        devices = scene_batch.scene_devices(wdev, dev)
        scenes = []
        for s0, e0 in segments:
            q, key_q, key_lf, inter_lf, ntf = scene_plan(s0, e0)
            frames = np.stack([fuse_planes(*padded(i), bit_depth=bd)
                               for i in range(s0, e0)])
            key_gate = inter_gate = 0.0
            if ntf > 0:
                filt, key_gate, inter_gate = key_filter(
                    upload(frames[0]),
                    np.stack([frames[1 + j] if j < ntf else frames[0]
                              for j in range(7)]))
                # the filtered key replaces the source, also as the CDEF
                # search's target (the reference's batch)
                frames[0] = filt.cpu().numpy()
            scenes.append({"frames": frames, "q": q, "key_q": key_q,
                           "key_lf": key_lf, "inter_lf": inter_lf,
                           "key_gate": key_gate, "inter_gate": inter_gate})
        key_kind = "wave" if partitions else "v"
        done_frames = 0
        with scene_batch.ScenePool(devices) as pool:
            for b0 in range(0, len(scenes), wdev):
                batch = scenes[b0 : b0 + wdev]
                enc = scene_batch.SceneBatchEncoder(batch, pool, ch, cw,
                                                    bit_depth=bd)
                key_cap, cap = 163840, inter_cap
                while True:
                    # the keyframe's CDEF skip map is key_skip8's, the
                    # single-device path's extractor
                    results = enc.encode(key_cap, cap, part=partitions,
                                         key_lam_scale=key_lam_scale)
                    try:
                        batch_tus = []
                        for sc, res in zip(batch, results):
                            cdfs = packer.new_cdf_blob()
                            tus = [pack_key(
                                res["key_buf"], sc["key_q"], key_kind,
                                sc["key_lf"], cdf_out=cdfs,
                                cdef=tuple(int(x) for x in res["cdef_s"]))]
                            for buf in res["inter_bufs"]:
                                tus.append(pack_inter_tile(
                                    buf, sc["q"], cdfs, res["cdef_s"]))
                            batch_tus.append(tus)
                        break
                    except _CapacityExceeded as e:  # the whole batch again
                        key_cap = min(max(key_cap * 2, e.count), ncoef)
                        cap = min(max(cap * 2, e.count), ncoef)
                for sc, res, tus in zip(batch, results, batch_tus):
                    streams.extend(tus)
                    # the scene's last recon against its last source
                    psnrs.append(_recon_psnr(
                        torch.from_numpy(res["ref"]),
                        torch.from_numpy(sc["frames"][-1].astype(np.int32))))
                    for k, v in res["seconds"].items():  # worker seconds
                        clock.acc[k] = clock.acc.get(k, 0.0) + v
                    done_frames += sc["frames"].shape[0]
                    if progress:
                        progress(done_frames, n)
    elif gop:
        for s0, e0 in segments:
            q, key_q, key_lf, inter_lf, ntf = scene_plan(s0, e0)
            fused0 = fuse_planes(*padded(s0), bit_depth=bd)
            key_kind = "wave" if partitions else "v"
            key_cap = 163840
            with clock("upload"):
                fused0_dev = upload(fused0)
            key_src = fused0_dev
            key_gate = inter_gate = 0.0
            if ntf > 0:
                key_src, key_gate, inter_gate = key_filter(
                    fused0_dev,
                    np.stack([fuse_planes(*padded(s0 + 1 + j), bit_depth=bd)
                              if j < ntf else fused0 for j in range(7)]))
            cdfs = packer.new_cdf_blob()
            while True:  # low-q keyframes can exceed the value capacity
                with clock("key_device"):
                    if partitions:
                        buf, ref = intra_wave.encode_intra_wave_key_recon(
                            key_src, key_q, ch, cw, cap=key_cap, lf=key_lf,
                            lam_scale=key_lam_scale, noise_gate=key_gate,
                            bit_depth=bd)
                    else:
                        buf, ref = intra_v.encode_intra_v_key_recon(
                            key_src, key_q, ch, cw, cap=key_cap, lf=key_lf,
                            bit_depth=bd)
                    buf_np = buf.cpu().numpy()
                # per-scene CDEF strength search on the keyframe
                with clock("cdef"):
                    _, key_bm, _, _ = split_compact(buf_np, ch, cw)
                    skip8 = torch.from_numpy(
                        skip8_host(key_bm, ch, cw)).to(dev)
                    cdef_s = select_strengths(ref, fused0_dev, skip8, ch, cw,
                                              bit_depth=bd)
                    ref = cdef_fused(ref, skip8, cdef_s, ch, cw,
                                     bit_depth=bd)
                try:
                    with clock("pack_key"):
                        streams.append(pack_key(
                            buf_np, key_q, key_kind, key_lf, cdf_out=cdfs,
                            cdef=tuple(int(x) for x in cdef_s)))
                    break
                except _CapacityExceeded as e:  # retry, doubled transport
                    key_cap = min(max(key_cap * 2, e.count), ncoef)
            with clock("psnr"):
                psnrs.append(_recon_psnr(ref, fused0_dev))
            if progress:
                progress(s0 + 1, n)
            cap = inter_cap
            bases = list(range(s0 + 1, e0, chunk))

            def prep(base):
                """Pad + fuse + upload one chunk.  Called for chunk N+1
                right after chunk N's dispatch, so the host prep overlaps
                chunk N's queued device work.  A tail chunk keeps its k <
                chunk frames: the reference's padding to a full chunk only
                keeps one compiled shape, and frame i's TU depends on
                frames 0..i alone."""
                k = min(chunk, e0 - base)
                with clock("host_prep"):
                    fused = np.stack([fuse_planes(*padded(base + i),
                                                  bit_depth=bd)
                                      for i in range(k)])
                with clock("upload"):
                    return k, upload(fused)

            # GOLDEN = the scene keyframe's filtered recon (ref slot 1),
            # device-resident and constant across the scene's inter chain
            gld = ref if partitions else None
            nxt = prep(bases[0]) if bases else None
            mv_carry = None  # temporal MV candidate chain (scene-local)
            fetch_state: dict = {}  # prefix-fetch size predictor
            layered = layers >= 2 and partitions
            q_nr = min(q + nr_q_delta, 255)
            for bi, base in enumerate(bases):
                k, fused_dev = nxt
                ref_in = ref
                mv_in = mv_carry
                pars = [0] * k
                first = True
                while True:
                    with clock("inter_dispatch"):
                        if layered:
                            (bufs, pars, ref,
                             mv_carry) = inter_v.encode_gop_chunk_layered(
                                fused_dev, ref_in, q, q_nr, ch, cw, cap=cap,
                                lf=inter_lf, cdef_s=cdef_s, gld_fused=gld,
                                prev_mv=mv_in, start_parity=(base - s0) % 2,
                                noise_gate=inter_gate, bit_depth=bd)
                        elif partitions:
                            bufs, ref, mv_carry = \
                                inter_v.encode_gop_chunk_part(
                                    fused_dev, ref_in, q, ch, cw, cap=cap,
                                    lf=inter_lf, cdef_s=cdef_s,
                                    gld_fused=gld, prev_mv=mv_in,
                                    noise_gate=inter_gate, bit_depth=bd)
                        else:
                            bufs, ref = inter_v.encode_gop_chunk(
                                fused_dev, ref_in, q, ch, cw, cap=cap,
                                lf=inter_lf, cdef_s=cdef_s, bit_depth=bd)
                    if first:  # prefetch chunk N+1 behind N's compute
                        nxt = (prep(bases[bi + 1])
                               if bi + 1 < len(bases) else None)
                        first = False
                    tus = []
                    # chunk-local CDF chain, committed when the chunk packs
                    cdfs_c = cdfs.copy()
                    try:
                        for i in range(k):
                            with clock("inter_fetch"):
                                if partitions:  # the used prefix only
                                    buf = fetch_inter_part_prefix(
                                        bufs[i], ch, cw, fetch_state)
                                else:
                                    buf = bufs[i].cpu().numpy()
                            with clock("inter_pack"):
                                nr = bool(pars[i])
                                tus.append(pack_inter_tile(
                                    buf, q_nr if nr else q, cdfs_c, cdef_s,
                                    nonref=nr))
                        break
                    except _CapacityExceeded as e:
                        cap = min(max(cap * 2, e.count), ncoef)
                cdfs[:] = cdfs_c
                streams.extend(tus)
                # ref holds the recon of the chunk's last reference frame
                last_ref = max((i for i in range(k) if not pars[i]),
                               default=None)
                if k == chunk and last_ref is not None:
                    with clock("psnr"):
                        psnrs.append(_recon_psnr(ref, fused_dev[last_ref]))
                if progress:
                    progress(base + k, n)
    else:
        plan: list[tuple[int, int, tuple | None]] = []  # (base, k, scene)
        for s0, e0 in segments:
            for base in range(s0, e0, chunk):
                plan.append((base, min(chunk, e0 - base),
                             (s0, e0) if base == s0 else None))
        chunk_fn = (intra_part.encode_intra_part_chunk if partitions
                    else intra_v.encode_intra_v_chunk)
        for base, k, scene_seg in plan:
            fused = np.stack([fuse_planes(*padded(base + i), bit_depth=bd)
                              for i in range(k)])
            if scene_seg or not q_used:
                q = select_q(scene_seg or (base, base + k), probe_psnr=True)
            q_used.append(q)
            fused_dev = upload(fused)
            cap = 163840
            while True:
                bufs = chunk_fn(fused_dev, q, ch, cw, cap=cap,
                                bit_depth=bd).cpu().numpy()
                try:
                    tus = [pack_key(bufs[i], q, "part" if partitions
                                    else "v", (0, 0, 0))
                           for i in range(k)]
                    break
                except _CapacityExceeded as e:
                    cap = min(max(cap * 2, e.count), ncoef)
            streams.extend(tus)
            if progress:
                progress(base + k, n)

    psnrs = [float(p) for p in psnrs]  # sync deferred stats scalars
    dt = time.perf_counter() - t0
    stats = {
        "frames": n,
        "bytes": sum(len(s) for s in streams),
        "encode_seconds": round(dt, 3),
        "encode_fps": round(n / dt, 3) if dt > 0 else 0.0,
        "width": width,
        "height": height,
        "qindex": round(sum(q_used) / len(q_used), 1),
        "scenes": len(segments),
        "keyframes": len(segments) if gop else n,
        "psnr_y": round(sum(psnrs) / len(psnrs), 3),
        metric if metric != "psnr" else "metric_score":
            round(sum(scores) / len(scores), 3),
        "stage_seconds": {k: round(v, 3)
                          for k, v in sorted(clock.acc.items())},
    }
    return streams, stats


def _to_y4m(path: str, tmpdir: str) -> str:
    """The input as a y4m file: itself, or its decode by av1_tool into
    tmpdir (a container or another codec)."""
    if path.lower().endswith(".y4m"):
        return path
    out = os.path.join(tmpdir, "source.y4m")
    r = subprocess.run([_build.av1_tool_path(), "decode", path, out,
                        "--codec", "auto"], capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError("source decode failed: " + r.stderr.strip())
    return out


def cmd_encode(args) -> int:
    from av1tpu_torch.utils.log import get_logger, profile_trace

    log = get_logger("cli")
    with tempfile.TemporaryDirectory(dir=args.temp or None) as tmpdir:
        clip = read_y4m(_to_y4m(args.input, tmpdir))
        log.info("encoding %s: %dx%d %d frames %d-bit", args.input,
                 clip.width, clip.height, clip.num_frames, clip.bit_depth)
        if args.max_frames and clip.num_frames > args.max_frames:
            clip.y = clip.y[: args.max_frames]
            clip.u = clip.u[: args.max_frames]
            clip.v = clip.v[: args.max_frames]
        # per-chunk progress lines: the daemon reads them for its progress,
        # FPS and ETA columns
        t_start = time.perf_counter()

        def _progress(done: int, total: int) -> None:
            dt = time.perf_counter() - t_start
            print(json.dumps({
                "progress": round(done / total, 4),
                "frames_encoded": done,
                "total_frames": total,
                "fps": round(done / dt, 2) if dt > 0 else 0.0,
            }), flush=True)

        with profile_trace("encode_clip"):
            streams, stats = encode_clip(
                clip, args.qindex, chunk=args.chunk, progress=_progress,
                target_quality=args.target_quality, metric=args.metric,
                partitions=args.preset == "quality",
                scene_threshold=args.scene_threshold,
                gop=not args.all_intra, key_q_boost=args.key_q_boost,
                key_lam_scale=args.key_lam_scale,
                key_tf=not args.no_key_tf, workers=args.workers,
                layers=args.layers, nr_q_delta=args.nr_q_delta,
                device=args.device)
        log.info("encoded %d frames in %.2fs (%.2f fps), %d scenes",
                 stats["frames"], stats["encode_seconds"],
                 stats["encode_fps"], stats["scenes"])
        if args.output.lower().endswith(".ivf"):
            write_ivf(args.output, streams, clip.width, clip.height)
        else:
            # container output: the new AV1 video muxed with every audio
            # and subtitle stream of the original
            ivf = os.path.join(tmpdir, "video.ivf")
            write_ivf(ivf, streams, clip.width, clip.height)
            src = "none" if args.input.lower().endswith(".y4m") else args.input
            r = subprocess.run([_build.av1_tool_path(), "mux", ivf, src,
                                args.output], capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError("mux failed: " + r.stderr.strip())
            mux_stats = json.loads(r.stdout.strip().splitlines()[-1])
            stats["audio_streams"] = mux_stats["audio_streams"]
            stats["subtitle_streams"] = mux_stats["subtitle_streams"]
            stats["bytes"] = os.path.getsize(args.output)
    stats["output"] = args.output
    print(json.dumps(stats))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="av1tpu_torch", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    enc = sub.add_parser("encode", help="encode a video to AV1 (IVF)")
    enc.add_argument("-i", "--input", required=True)
    enc.add_argument("-o", "--output", required=True)
    enc.add_argument("--qindex", type=int, default=72)
    enc.add_argument("--workers", type=int, default=1,
                     help="devices to run the scene batch on, one "
                          "worker process per GPU (clamped to the GPU "
                          "count)")
    enc.add_argument("--key-q-boost", type=int, default=KEY_Q_BOOST,
                     help="keyframe qindex boost below the scene q")
    enc.add_argument("--key-lam-scale", type=float, default=0.3,
                     help="keyframe RDO lambda multiplier (<1 biases the "
                          "scene-long reference toward quality)")
    enc.add_argument("--no-key-tf", action="store_true",
                     help="disable motion-compensated temporal filtering "
                          "of keyframes")
    enc.add_argument("--chunk", type=int, default=4,
                     help="frames per device chunk")
    enc.add_argument("--layers", type=int, choices=(1, 2), default=1,
                     help="temporal layers: 2 = alternate non-reference "
                          "frames (refresh_frame_flags=0) coded at "
                          "qindex + --nr-q-delta")
    enc.add_argument("--nr-q-delta", type=int, default=12,
                     help="qindex penalty of non-reference frames "
                          "(--layers 2)")
    enc.add_argument("--temp", default=None, help="temp directory")
    enc.add_argument("--max-frames", type=int, default=0)
    enc.add_argument("--target-quality", type=float, default=0.0,
                     help="per-scene CQ search: pick the qindex hitting "
                          "this score on --metric (0 = fixed --qindex)")
    enc.add_argument("--metric", choices=("tpu_vmaf", "ssim", "psnr"),
                     default="tpu_vmaf")
    enc.add_argument("--scene-threshold", type=float, default=2.5,
                     help="scene-cut score threshold")
    enc.add_argument("--all-intra", action="store_true",
                     help="every frame a keyframe (default: one keyframe "
                          "per scene + inter frames)")
    enc.add_argument("--preset", choices=("fast", "quality"),
                     default="quality",
                     help="fast: fixed 16x16 grid, V-family intra; "
                          "quality: 13-mode wavefront keyframe + "
                          "64/32/16/8 partition RDO")
    enc.add_argument("--device", default="cuda",
                     help="torch device to encode on (the tests pass cpu)")
    enc.set_defaults(fn=cmd_encode)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
