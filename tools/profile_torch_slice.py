#!/usr/bin/env python3
"""Profile the PyTorch port's fast-preset 1080p encode on one NVIDIA GPU.

    python3 tools/profile_torch_slice.py

One warm-up encode of a 9-frame clip (the keyframe and one chunk of 8
inter frames), then one encode of the same clip under torch.profiler
(CPU and CUDA activity).  Prints the wall seconds of the profiled encode,
the device busy seconds (union of kernel intervals), the busy and idle
shares, the kernel count, and the top kernels by device time.  The profiler adds host overhead
to every launch, so the wall time here is not the encode's speed:
chip_smoke.py times the encode without it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAMES = 9


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_slice: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from av1tpu_torch.utils.yuv import synthetic_clip
    from av1tpu_torch.cli import encode_clip

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    clip = synthetic_clip(1920, 1080, FRAMES, seed=11)
    kw = dict(chunk=8, metric="psnr", gop=True, partitions=False,
              device="cuda")
    encode_clip(clip, 72, **kw)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        _, stats = encode_clip(clip, 72, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us((e.time_range.start, e.time_range.end)
                    for e in kernels) / 1e6
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0, 0.0])
        acc[0] += 1
        acc[1] += (e.time_range.end - e.time_range.start) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    print(json.dumps({
        "frames": FRAMES, "profiled_wall_s": wall,
        "device_busy_s": busy, "busy_share": busy / wall,
        "idle_share": 1 - busy / wall, "kernels": len(kernels),
        "stage_seconds_profiled": stats["stage_seconds"]}))
    for name, (count, secs) in top:
        print(f"{secs:10.6f} s {count:8d}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
