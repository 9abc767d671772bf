#!/usr/bin/env python3
"""Time the motion search's kernels of one checkout of av1tpu_torch on a GPU.

    python3 tools/search_compare.py --inputs FILE [--root DIR]

Imports av1tpu_torch from DIR (default: this checkout), builds its CUDA
kernels (printing motion.cu's -Xptxas -v lines) and times coarse_search,
global_search and refine_subpel on the pair that chip_smoke.py's phase 7d
saved to FILE (its first 1080p inter frame, the keyframe's recon, the
frame's lambda and peak value; written where $AV1TPU_SMOKE_OUT is set),
with phase 7d's own timing (chip_smoke.search_times).  Prints one JSON line per wrapper:
its device time per call, its launches per call and the bound of this
checkout's chip_smoke.search_bounds.  Whether the outputs equal the plain
versions' is phase 7d's check, not this script's.  To compare two commits
on one card, unpack the older one with `git archive` into a directory
that .gitignore lists and run this script on each, in turns, within one
command.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--inputs", required=True,
                    help="phase 7d's saved pair (chip_smoke.py)")
    ap.add_argument("--root", default=HERE,
                    help="checkout whose av1tpu_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("search_compare: CUDA is not available", file=sys.stderr)
        return 1
    from av1tpu_torch import _build
    from av1tpu_torch.kernels import motion

    log = _build.build_cuda()[1]
    print("\n".join(ln for ln in log.splitlines()
                    if "motion" in ln or "refine" in ln or "global" in ln
                    or "coarse" in ln or "subpel" in ln) or log.strip(),
          flush=True)
    d = torch.load(args.inputs)
    y, ref_y, lam = d["y"].cuda(), d["ref_y"].cuda(), np.float32(d["lam"])
    pm = int(d["pm"])
    h, w = y.shape
    bounds = chip_smoke.search_bounds(h, w)
    times = chip_smoke.search_times(torch, motion, y, ref_y, lam, pm,
                                    plain=False)
    for name, (dev_us, _, n) in times.items():
        bound, by, bytes_us, ops_us = bounds[name]
        print(json.dumps({
            "root": args.root, "kernel": name, "shape": [h, w],
            "device_us": dev_us, "launches": n, "bound_us": bound,
            "bound_by": by, "bytes_us": bytes_us, "ops_us": ops_us,
            "bound_share": bound / dev_us,
            "card": chip_smoke.card_name()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
