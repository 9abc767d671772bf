#!/usr/bin/env python3
"""Profile the PyTorch port's 1080p encode on one NVIDIA GPU.

    python3 tools/profile_torch_slice.py [--preset fast|quality]
                                         [--scope encode|inter]

One warm-up encode of a clip (the keyframe and one chunk of inter frames),
then one encode of the same clip under torch.profiler.  Scope `encode`
profiles the whole encode (CPU and CUDA activity; 9 frames); scope `inter`
profiles only the calls of the inter chunk (CUDA activity; 5 frames, so 4
inter frames) and also prints the kernels per inter frame.  The quality
preset takes scope `inter` only: its wavefront keyframe launches millions
of small kernels, more than the profiler can hold.  Prints the wall seconds
of the profiled part, the device busy seconds (union of kernel intervals),
the busy and idle shares, the kernel count (scope `inter`: also the
motion search's device seconds per inter frame, csrc/motion.cu's kernels
summed), the top kernels by device time, and then every hand kernel of
the port by device time.  The profiler adds host overhead to every
launch, so the wall time here is not the encode's speed: chip_smoke.py
times the encode without it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAMES = {"encode": 9, "inter": 5}
# the hand kernels of av1tpu_torch/csrc/ live in anonymous namespaces
HAND_PREFIX = "(anonymous namespace)::"
# csrc/motion.cu's kernels: one motion search
SEARCH_KERNELS = ("coarse_pool_kernel", "coarse_sad_kernel",
                  "coarse_select_kernel", "global_sweep_kernel",
                  "refine_kernel", "subpel_snap_kernel")


def _kernel_name(name: str) -> str:
    """A hand kernel's bare name: `(anonymous namespace)::f(args)` -> f."""
    return name[len(HAND_PREFIX):].split("(")[0] if name.startswith(
        HAND_PREFIX) else ""


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
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", choices=("fast", "quality"), default="fast")
    ap.add_argument("--scope", choices=("encode", "inter"), default=None)
    args = ap.parse_args()
    quality = args.preset == "quality"
    scope = args.scope or ("inter" if quality else "encode")
    if quality and scope != "inter":
        ap.error("the quality preset is profiled with --scope inter")

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_torch_slice: CUDA is not available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from av1tpu_torch.cli import encode_clip
    from av1tpu_torch.models import inter_v
    from av1tpu_torch.utils.yuv import synthetic_clip

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    frames = FRAMES[scope]
    clip = synthetic_clip(1920, 1080, frames, seed=11)
    kw = dict(chunk=8, metric="psnr", gop=True, partitions=quality,
              device="cuda")
    encode_clip(clip, 72, **kw)
    torch.cuda.synchronize()
    acts = [ProfilerActivity.CUDA]
    if scope == "encode":
        acts.append(ProfilerActivity.CPU)
    prof = profile(activities=acts)
    wall = 0.0

    @contextlib.contextmanager
    def profiled():
        nonlocal wall
        torch.cuda.synchronize()
        with prof:
            t = time.perf_counter()
            yield
            torch.cuda.synchronize()
            wall += time.perf_counter() - t

    if scope == "encode":
        with profiled():
            _, stats = encode_clip(clip, 72, **kw)
    else:
        name = "encode_gop_chunk_part" if quality else "encode_gop_chunk"
        chunk_fn = getattr(inter_v, name)

        def spy(*a, **k):
            with profiled():
                return chunk_fn(*a, **k)

        setattr(inter_v, name, spy)
        try:
            _, stats = encode_clip(clip, 72, **kw)
        finally:
            setattr(inter_v, name, chunk_fn)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _busy_us((e.time_range.start, e.time_range.end)
                    for e in kernels) / 1e6
    by_name: dict[str, list] = {}
    for e in kernels:
        acc = by_name.setdefault(e.name, [0, 0.0])
        acc[0] += 1
        acc[1] += (e.time_range.end - e.time_range.start) / 1e6
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    rec = {}
    if scope == "inter":
        rec["kernels_per_inter_frame"] = len(kernels) / (frames - 1)
        rec["search_s_per_inter_frame"] = sum(
            secs for name, (_, secs) in by_name.items()
            if _kernel_name(name) in SEARCH_KERNELS) / (frames - 1)
    print(json.dumps({
        "preset": args.preset, "scope": scope, **rec,
        "frames": frames, "profiled_wall_s": wall,
        "device_busy_s": busy, "busy_share": busy / wall,
        "idle_share": 1 - busy / wall, "kernels": len(kernels),
        "stage_seconds_profiled": stats["stage_seconds"]}))
    for name, (count, secs) in ranked[:15]:
        print(f"{secs:10.6f} s {count:8d}x  {name[:110]}")
    print("the port's hand kernels:")
    for name, (count, secs) in ranked:
        if name.startswith(HAND_PREFIX):
            print(f"{secs:10.6f} s {count:8d}x  {name[:110]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
