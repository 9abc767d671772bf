#!/usr/bin/env python3
"""Time the 1080p encode of one checkout of av1tpu_torch on a GPU.

    python3 tools/time_encode.py [--root DIR] [--runs N] [--preset P]

Imports av1tpu_torch from DIR (default: this checkout), encodes the clip
of chip_smoke.py's phases 5 and 7 (synthetic 1920x1080, 48 frames, seed 11,
q 72, chunk 8) with the fast or the quality preset (default fast) once to
warm up, then N times, and prints one JSON line per timed
run: fps, seconds, bytes, PSNR-Y and the stage seconds.  Nothing else runs
in the process, so two checkouts' runs differ only by their code.  To
compare two commits on one card, unpack the older one with `git archive`
into a directory that .gitignore lists and run this script on each, in
turns, within one command.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose av1tpu_torch is timed")
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--preset", choices=("fast", "quality"), default="fast")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    from chip_smoke import CHUNK, FRAMES, QINDEX
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

    clip = yuv.synthetic_clip(1920, 1080, FRAMES, seed=11)
    kw = dict(chunk=CHUNK, metric="psnr", gop=True,
              partitions=args.preset == "quality", device="cuda")
    encode_clip(clip, QINDEX, **kw)
    torch.cuda.synchronize()
    for _ in range(args.runs):
        _, st = encode_clip(clip, QINDEX, **kw)
        torch.cuda.synchronize()
        print(json.dumps({"root": args.root, "preset": args.preset,
                          "fps": st["encode_fps"],
                          "seconds": st["encode_seconds"],
                          "bytes": st["bytes"], "psnr_y": st["psnr_y"],
                          "stage_seconds": st["stage_seconds"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
