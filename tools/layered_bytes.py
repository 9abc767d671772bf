#!/usr/bin/env python3
"""Stream bytes of the 2-layer pyramid (--layers 2) against the single
layer, on one clip, with the quality preset at q 72, chunk 4, PSNR probe.

    python3 tools/layered_bytes.py WIDTH HEIGHT FRAMES synthetic|pan [DEVICE]

`synthetic` is synthetic_clip(seed=11) (gradients, a moving textured box,
sensor noise: chip_smoke.py's clip); `pan` is a global pan of one textured
frame, the content of tests/test_layers.py.  DEVICE defaults to cuda.
Prints one line per layer count: bytes, PSNR-Y and the per-frame sizes.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from chip_smoke import moving_clip  # noqa: E402
from av1tpu_torch.cli import encode_clip  # noqa: E402
from av1tpu_torch.utils.yuv import synthetic_clip  # noqa: E402


def main(argv) -> int:
    w, h, n, kind = int(argv[0]), int(argv[1]), int(argv[2]), argv[3]
    device = argv[4] if len(argv) > 4 else "cuda"
    clip = (synthetic_clip(w, h, n, seed=11) if kind == "synthetic"
            else moving_clip(w, h, n, seed=82, dy=0, dx=2))
    for layers in (1, 2):
        streams, stats = encode_clip(clip, 72, chunk=4, metric="psnr",
                                     layers=layers, device=device)
        print(f"{w}x{h} {n} frames {kind} layers={layers} "
              f"bytes={stats['bytes']} psnr_y={stats['psnr_y']} "
              f"sizes={[len(s) for s in streams]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
