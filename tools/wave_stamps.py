#!/usr/bin/env python3
"""Where a wavefront keyframe lane's time goes, on a GPU.

    python3 tools/wave_stamps.py

`ncu` does not run on the card host, so this times the phases of
av1tpu_torch/csrc/intra_wave.cu's lanes from inside the kernel: it builds
the source with nvcc and -DWAVE_STAMPS into a temporary directory, which
turns the source's nine WAVE_STAMP marks into stores of a %globaltimer
stamp (the GPU's nanosecond clock, common to every SM), codes the first
frame of chip_smoke.py's 1080p clip as the quality keyframe (as
tools/time_encode.py --cell key does) through
kernels/intra_wave.py:wave_key with that build's entry point, and prints
per phase the mean, median and 90th percentile over the 8,160 lanes:

- wait: ticket taken to the neighbours' flags seen (rank 0);
- luma product: then to the end of the forward product (rank 1, four
  candidates);
- luma rest: then to rank 0's pieces starting (quantize, inverse, SSE,
  rate, the cluster's barrier, the argmin);
- 8x8 chain, 4x4 chain, 4x4 rates, chroma U: each piece from there to
  its end;
- tail: the last piece's end to the lane's published flag;

then the keyframe's span, the time between the publishing of
consecutive diagonals (early and middle ones), the wake-up latency (a
lane's flags seen after its last neighbour published), and the resident
clusters.  The stamps cost a few global stores per lane; the kernel is
otherwise the program's.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(HERE, "av1tpu_torch", "csrc", "intra_wave.cu")
PHASES = ("wait", "luma product", "luma rest", "8x8 chain", "4x4 chain",
          "4x4 rates", "chroma U", "tail")


def main() -> int:
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("wave_stamps: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke
    from av1tpu_torch import _build
    from av1tpu_torch.cli import KEY_Q_BOOST, _pad_plane
    from av1tpu_torch.kernels import intra_wave as kwave
    from av1tpu_torch.models.intra_wave import wave_setup
    from av1tpu_torch.utils.yuv import synthetic_clip

    with tempfile.TemporaryDirectory() as tmp:
        lib_path = os.path.join(tmp, "libwave_stamps.so")
        r = subprocess.run(
            [_build._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-DWAVE_STAMPS", "-Xcompiler", "-fPIC",
             "-shared", "-I", os.path.dirname(SRC), "-o", lib_path, SRC],
            capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + r.stderr[-4000:])
        lib = ctypes.CDLL(lib_path)
    real = _build.cuda_lib()
    lib.av1_wave_key.argtypes = real.av1_wave_key.argtypes
    lib.av1_wave_key.restype = ctypes.c_int
    lib.av1_wave_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.av1_wave_stamps.restype = ctypes.c_int
    lib.av1_wave_key_clusters.restype = ctypes.c_int

    clip = synthetic_clip(1920, 1080, 1, seed=11)
    dev = torch.device("cuda")
    y, u, v = (torch.from_numpy(_pad_plane(p[0], h, w)).to(dev)
               for p, h, w in ((clip.y, 1088, 1920), (clip.u, 544, 960),
                               (clip.v, 544, 960)))
    tabs, src, sched, grids = wave_setup(
        y, u, v, chip_smoke.QINDEX - KEY_Q_BOOST, 8, 0.3, 0.0)
    tabs._key = lib.av1_wave_key
    for _ in range(3):              # the last run's stamps are read
        kwave.wave_key(*src, *grids, tabs, sched, 0, sched.nd)
    torch.cuda.synchronize()
    n = sched.starts[-1]
    st = np.zeros((n, 9), np.uint64)
    if lib.av1_wave_stamps(st.ctypes.data, n) != 0:
        raise RuntimeError("reading the stamps failed")
    st = st.astype(np.int64)
    st -= st[:, 0].min()
    piece_end = np.maximum(st[:, 4:7].max(axis=1), st[:, 8])
    spans = (st[:, 1] - st[:, 0], st[:, 2] - st[:, 1], st[:, 3] - st[:, 2],
             st[:, 4] - st[:, 3], st[:, 5] - st[:, 3], st[:, 8] - st[:, 3],
             st[:, 6] - st[:, 3], st[:, 7] - piece_end)
    print(chip_smoke.card_name(), flush=True)
    print(f"{n} lanes, {sched.nd} diagonals, {lib.av1_wave_key_clusters()} "
          f"clusters resident; keyframe span {st[:, 7].max() / 1e6:.3f} ms")
    for name, x in zip(PHASES, spans):
        print(f"{name:13s} mean {x.mean() / 1e3:7.2f} us, median "
              f"{np.median(x) / 1e3:7.2f}, p90 "
              f"{np.percentile(x, 90) / 1e3:7.2f}")
    lane = st[:, 7] - st[:, 1]
    print(f"lane (flags seen to published) mean {lane.mean() / 1e3:.2f} us")
    pub = np.array([st[a:b, 7].max() for a, b in
                    zip(sched.starts[:-1], sched.starts[1:])])
    gaps = np.diff(pub) / 1e3
    mid = len(gaps) // 2
    print(f"between diagonals' last publish: first 10 mean "
          f"{gaps[:10].mean():.2f} us, middle 20 mean "
          f"{gaps[mid - 10:mid + 10].mean():.2f} us")
    lanes = sched.lanes.cpu().numpy()
    where = {(int(e) & 0xfff, (int(e) >> 12) & 0xfff): k
             for k, e in enumerate(lanes)}
    wake = []
    for k, (r_, c_) in enumerate(where):
        nb = [where[b] for b in ((r_, c_ - 1), (r_ - 1, c_), (r_ - 1, c_ + 1))
              if b in where]
        if nb:
            wake.append(st[k, 1] - max(st[j, 7] for j in nb))
    wake = np.array(wake) / 1e3
    print(f"wake-up after the last neighbour's publish: mean "
          f"{wake.mean():.2f} us, median {np.median(wake):.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
