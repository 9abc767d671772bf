#!/usr/bin/env python3
"""Time the transform+quantize kernel of one checkout of av1tpu_torch on a GPU.

    python3 tools/tq_compare.py [--root DIR]

Imports av1tpu_torch from DIR (default: this checkout), builds its CUDA
kernels (printing the -Xptxas -v report), and at each shape of the main
path prints one JSON line: level flips against the plain version, then
the kernel's device_us, call_us and host_us, the bound and the roofline
share, as chip_smoke.py's phase 3 measures them (the plain version is
checked, not timed: an older checkout's may stall the stream).
To compare two commits on one card, unpack the older one with `git archive`
into a directory that .gitignore lists and run this script on each, in
turns, within one command.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QINDEX = 72


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=HERE,
                    help="checkout whose av1tpu_torch is timed")
    args = ap.parse_args()
    sys.path.insert(0, HERE)
    import chip_smoke
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("tq_compare: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    from av1tpu_torch import _build
    from av1tpu_torch.kernels import transform_quant as tq
    from av1tpu_torch.models.intra_v import _plane_params
    from av1tpu_torch.state import tables

    print(_build.build_cuda()[1].strip(), flush=True)
    dev = torch.device("cuda")
    rng = np.random.RandomState(2024)
    for b, n2 in chip_smoke.SHAPES:
        n = 16 if n2 == 256 else 8
        tx = 0 if n == 16 else 1
        resid = torch.as_tensor(rng.randint(-255, 256, size=(b, n2)).astype(
            np.float32), device=dev)
        fwdt = tables(dev).fwdt(n, tx)
        step, q, cap = (t[None] for t in _plane_params(QINDEX, n, 8, dev))
        # older checkouts' wrapper takes the constants on every call
        if hasattr(tq, "TQPlane"):
            plane = tq.TQPlane(fwdt, step, q, cap)
            args_ = (resid, plane)
        else:
            args_ = (resid, fwdt, step, q, cap)
        lv, dq = tq.transform_quantize(*args_)
        lv_ref, _ = tq.transform_quantize_ref(*args_)
        torch.cuda.synchronize()
        flips = tq.count_level_flips(lv, dq, lv_ref, resid, fwdt, step, q)
        rec = chip_smoke.time_tq(
            torch, lambda: tq.transform_quantize(*args_), None, b, n2)
        rec.update(root=args.root, flips=flips)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
