#!/usr/bin/env python3
"""Time the 1080p encode of one checkout of av1tpu_torch on a GPU.

    python3 tools/time_encode.py [--root DIR] [--runs N] [--preset P]
                                 [--cell slice|daemon|key|batch]

Imports av1tpu_torch from DIR (default: this checkout), encodes the clip
of chip_smoke.py's phases 5 and 7 (synthetic 1920x1080, 48 frames, seed 11,
q 72, chunk 8) with the fast or the quality preset (default fast) once to
warm up, then N times, and prints one JSON line per timed
run: fps, seconds, bytes, PSNR-Y, the stage seconds and the stream's
sha256 (chip_smoke.print_digest's).  With --cell daemon it runs phase 9's
command instead (the daemon's `encode -i IN.y4m -o OUT.ivf --qindex 72
--workers 4` through av1tpu_torch.cli.main on the 16-frame 1080p y4m),
and the digest is the IVF file's.  With --cell key it codes that clip's
first frame (padded to 1920x1088 as the encoder pads it) as the quality
preset's keyframe (`encode_intra_wave` at the key q of q 72, lam_scale
0.3) and prints per run the keyframe's device time queued behind a sleep
kernel (chip_smoke.device_us, so no host gap is counted; the kernels run
on a prepared keyframe state, models/intra_wave.py:wave_setup), its time
with the host (a CUDA event pair around the call), the hand kernels'
launches per keyframe and a sha256 of the eight output grids.  With
--cell batch it runs phase 12 b's batch (two 2-frame 1080p scenes,
quality preset, on two cards or one card listed twice, with one pool of
workers kept open) at workers=1 and workers=2 in turns, and prints per
run and worker count the seconds, the summed per-scene stage seconds,
the speed-up and the stream's sha256; the warm-up runs the same clip.
Nothing else runs
in the process, so two checkouts' runs differ only by their code.  To
compare two commits on one card, unpack the older one with `git archive`
into a directory that .gitignore lists and run this script on each, in
turns, within one command.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import importlib.util
import io
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose av1tpu_torch is timed")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--preset", choices=("fast", "quality"), default="fast")
    ap.add_argument("--cell", choices=("slice", "daemon", "key", "batch"),
                    default="slice")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from chip_smoke import CHUNK, CLI_FRAMES, FRAMES, QINDEX, _daemon_argv
    # the clip comes from this checkout's module, loaded on its own so that
    # the av1tpu_torch package is the one under --root
    spec = importlib.util.spec_from_file_location(
        "_yuv", os.path.join(HERE, "av1tpu_torch", "utils", "yuv.py"))
    yuv = sys.modules["_yuv"] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(yuv)
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    if not torch.cuda.is_available():
        print("time_encode: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from av1tpu_torch.cli import encode_clip

    if args.cell == "daemon":
        return daemon(args, torch, yuv, CLI_FRAMES, _daemon_argv)
    if args.cell == "key":
        return key(args, torch, yuv)
    if args.cell == "batch":
        return batch(args, torch)
    clip = yuv.synthetic_clip(1920, 1080, FRAMES, seed=11)
    kw = dict(chunk=CHUNK, metric="psnr", gop=True,
              partitions=args.preset == "quality", device="cuda")
    encode_clip(clip, QINDEX, **kw)
    torch.cuda.synchronize()
    for _ in range(args.runs):
        streams, st = encode_clip(clip, QINDEX, **kw)
        torch.cuda.synchronize()
        digest = hashlib.sha256()
        for tu in streams:
            digest.update(tu)
        print(json.dumps({"root": args.root, "preset": args.preset,
                          "fps": st["encode_fps"],
                          "seconds": st["encode_seconds"],
                          "bytes": st["bytes"], "psnr_y": st["psnr_y"],
                          "stage_seconds": st["stage_seconds"],
                          "sha256": digest.hexdigest()}),
              flush=True)
    return 0


def daemon(args, torch, yuv, frames: int, argv) -> int:
    """Phase 9's command, once to warm up and then args.runs times."""
    from av1tpu_torch.cli import main as cli_main

    with tempfile.TemporaryDirectory() as tmp:
        y4m, ivf = os.path.join(tmp, "in.y4m"), os.path.join(tmp, "out.ivf")
        yuv.write_y4m(y4m, yuv.synthetic_clip(1920, 1080, frames, seed=11))
        for run in range(args.runs + 1):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                assert cli_main(argv(y4m, ivf)) == 0
            torch.cuda.synchronize()
            if run == 0:
                continue
            st = json.loads(out.getvalue().splitlines()[-1])
            with open(ivf, "rb") as f:
                digest = hashlib.sha256(f.read()).hexdigest()
            print(json.dumps({"root": args.root, "cell": "daemon",
                              "fps": st["encode_fps"],
                              "seconds": st["encode_seconds"],
                              "bytes": st["bytes"], "psnr_y": st["psnr_y"],
                              "stage_seconds": st["stage_seconds"],
                              "sha256": digest}), flush=True)
    return 0


def key(args, torch, yuv) -> int:
    """The quality keyframe of the clip's first frame, once to warm up and
    then args.runs times."""
    import chip_smoke
    from av1tpu_torch import _build
    from av1tpu_torch.cli import KEY_Q_BOOST, _pad_plane
    from av1tpu_torch.kernels import hand_kernels
    from av1tpu_torch.kernels import intra_wave as kwave
    from av1tpu_torch.models.intra_wave import encode_intra_wave, wave_setup

    _build.build_cuda()
    clip = yuv.synthetic_clip(1920, 1080, 1, seed=11)
    dev = torch.device("cuda")
    y, u, v = (torch.from_numpy(_pad_plane(p[0], h, w)).to(dev)
               for p, h, w in ((clip.y, 1088, 1920), (clip.u, 544, 960),
                               (clip.v, 544, 960)))
    q = chip_smoke.QINDEX - KEY_Q_BOOST
    tabs, src, sched, grids = wave_setup(y, u, v, q, 8, 0.3, 0.0)
    if hasattr(kwave, "wave_key"):
        def kernels_only():
            kwave.wave_key(*src, *grids, tabs, sched, 0, sched.nd)
    else:       # a checkout with two kernels per diagonal; sched: their
        def kernels_only():                             # arguments
            for diag in sched:
                best = kwave.wave_luma16(src[0], grids[0], tabs, *diag)
                kwave.wave_sub_chroma(*src, *grids, tabs, *diag, *best)

    kernels = hand_kernels()
    before = {k.__name__: k.launches for k in kernels}
    out = encode_intra_wave(y, u, v, q, 8, 0.3, 0.0)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches - before[k.__name__] for k in kernels
                if k.launches != before[k.__name__]}
    digest = hashlib.sha256()
    for name in sorted(out):
        digest.update(name.encode())
        digest.update(out[name].cpu().numpy().tobytes())
    for _ in range(args.runs):
        dev_ms = chip_smoke.device_us(torch, kernels_only, 1, sleep_cycles=8
                                      * chip_smoke.SLEEP_CYCLES) / 1e3
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        encode_intra_wave(y, u, v, q, 8, 0.3, 0.0)
        b.record()
        b.synchronize()
        print(json.dumps({
            "root": args.root, "cell": "key", "card": chip_smoke.card_name(),
            "keyframe_device_ms": dev_ms, "keyframe_ms": a.elapsed_time(b),
            "launches": launches, "sha256": digest.hexdigest()}), flush=True)
    return 0


def batch(args, torch) -> int:
    """Phase 12 b's batch at workers=1 and 2, once to warm up and then
    args.runs times."""
    import av1tpu_torch.cli as cli
    import chip_smoke
    from av1tpu_torch.parallel import gop

    clip = chip_smoke.batch_clip(1920, 1080, chip_smoke.BATCH_FRAMES)
    kw = dict(chunk=chip_smoke.BATCH_FRAMES, metric="psnr", partitions=True,
              scene_threshold=2.5, gop=True, device="cuda")
    devices, case = chip_smoke.batch_devices(torch)
    with gop.ScenePool(devices) as pool, \
            chip_smoke._BatchSpy(gop, cli, devices, pool):
        for run in range(args.runs + 1):
            seconds = {}
            for workers in (1, 2):
                streams, st = cli.encode_clip(clip, chip_smoke.QINDEX,
                                              workers=workers, **kw)
                torch.cuda.synchronize()
                seconds[workers] = st["encode_seconds"]
                digest = hashlib.sha256()
                for tu in streams:
                    digest.update(tu)
                if run:
                    print(json.dumps({
                        "root": args.root, "cell": "batch", "case": case,
                        "card": chip_smoke.card_name(), "workers": workers,
                        "seconds": st["encode_seconds"],
                        "stage_seconds": st["stage_seconds"],
                        "bytes": st["bytes"], "sha256": digest.hexdigest()}),
                        flush=True)
            if run:
                print(json.dumps({"root": args.root, "cell": "batch",
                                  "speedup": seconds[1] / seconds[2]}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
