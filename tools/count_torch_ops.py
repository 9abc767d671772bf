#!/usr/bin/env python3
"""Count the PyTorch operations that the port dispatches, on the CPU.

    python3 tools/count_torch_ops.py

An eager encode is bound by the host's cost per dispatched operation, so
the counts say where that time goes before any profile does.  The numbers
of operations per inter frame do not depend on the frame size (only the
tensors grow), so they are counted here on a 128x192 frame with torch's
dispatch mode (the wavefront keyframe's plain count grows with its
diagonals, the probe's with the frame's block rows and columns: both are
given for this size only):
every aten operation, split into those that only make a view (no device
work) and the rest (each launches at least one kernel on a GPU).

Each count is given twice: "plain", what the CPU runs (every hand kernel's
plain version, operation by operation), and "card", what the card runs,
where each call of a hand kernel's wrapper is one operation per launch
(the plain version then runs uncounted; the wrapper's output allocations
are not counted).  The inter frames' "card" counts are also split by the
port function that dispatched them (the innermost av1tpu_torch function on
the stack; a function's count excludes its callees').  A wrapper whose
call launches several kernels (the motion search's three) counts each
launch.  Prints one JSON line.  These are counts of what the program
does, not device measurements.
"""

from __future__ import annotations

import collections
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
PKG = os.path.join(REPO, "av1tpu_torch") + os.sep

VIEW_OPS = ("view", "reshape", "expand", "permute", "transpose", "slice",
            "select", "unsqueeze", "squeeze", "alias", "as_strided", "t.",
            "unbind", "split", "detach", "_unsafe_view", "unfold")

# (module, plain version the wrapper calls on the CPU, kernel name, kernel
# launches per call)
KERNEL_PLAINS = (
    ("av1tpu_torch.kernels.transform_quant", "transform_quantize_ref",
     "transform_quantize", 1),
    ("av1tpu_torch.kernels.intra_wave", "wave_key_plain", "wave_key", 1),
    ("av1tpu_torch.kernels.inter_code", "code_blocks_plain", "code_blocks",
     1),
    ("av1tpu_torch.kernels.cdef", "cdef_filter_plain", "cdef_filter", 1),
    ("av1tpu_torch.kernels.deblock", "deblock_plane_plain", "deblock_edges",
     1),
    ("av1tpu_torch.kernels.motion", "coarse_search_plain", "coarse_search",
     3),
    ("av1tpu_torch.kernels.motion", "global_search_plain", "global_search",
     3),
    ("av1tpu_torch.kernels.motion", "refine_subpel_plain", "refine_subpel",
     2),
    *(("av1tpu_torch.kernels.intra_part", f"part_{k}_plain", f"part_{k}", 1)
      for k in ("chain", "pred", "code", "merge")))


def _caller() -> str:
    """models/inter_v.py:_code_nn for the innermost port function on the
    stack."""
    f = sys._getframe(2)
    while f is not None:
        name = f.f_code.co_filename
        if name.startswith(PKG):
            return f"{name[len(PKG):]}:{f.f_code.co_name}"
        f = f.f_back
    return "(outside the port)"


def main() -> int:
    import importlib

    import numpy as np
    import torch
    from torch.utils._python_dispatch import (
        TorchDispatchMode, _disable_current_modes,
    )

    from av1tpu_torch.models import inter_v, intra_part, intra_wave
    from av1tpu_torch.models.intra_v import fuse_planes
    from av1tpu_torch.utils.yuv import synthetic_clip

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.views = self.work = 0
            self.by_fn = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.name().split("::")[-1]
            if any(name.startswith(v) for v in VIEW_OPS):
                self.views += 1
            else:
                self.work += 1
                self.by_fn[_caller()] += 1
            return func(*args, **(kwargs or {}))

    active: list = []

    def as_launch(fn, kernel, n):
        """fn run uncounted, counted as the kernel's n launches."""
        def launch(*a, **k):
            with _disable_current_modes():
                out = fn(*a, **k)
            c = active[-1]
            c.work += n
            c.by_fn[f"kernel {kernel}"] += n
            return out
        return launch

    def counted(fn, card: bool, split: bool = False):
        saved = []
        if card:
            for mod_name, plain, kernel, n in KERNEL_PLAINS:
                mod = importlib.import_module(mod_name)
                saved.append((mod, plain, getattr(mod, plain)))
                setattr(mod, plain, as_launch(getattr(mod, plain), kernel, n))
        try:
            with Count() as c:
                active.append(c)
                fn()
        finally:
            active.clear()
            for mod, plain, f in saved:
                setattr(mod, plain, f)
        out = {"work": c.work, "views": c.views}
        if split:
            out["by_function"] = dict(c.by_fn.most_common())
        return out

    h, w = 128, 192
    clip = synthetic_clip(w, h, 3, seed=11)
    planes = [[torch.from_numpy(p[k].astype(np.int32))
               for p in (clip.y, clip.u, clip.v)] for k in range(3)]
    fused = [torch.from_numpy(fuse_planes(*[p.numpy() for p in ps]))
             for ps in planes]
    ref = torch.cat([p.reshape(-1) for p in planes[0]])
    nd = 2 * (h // 16 - 1) + w // 16
    out = {"frame": [h, w], "diagonals": nd}

    def fast():
        inter_v._gop_step_body(fused[1], ref, 72, h, w, 1 << 20, (9, 4, 4),
                               (2, 1, 2, 1))

    def quality():
        inter_v._gop_step_part_body(
            fused[1], ref, 72, h, w, 1 << 20, (9, 4, 4), (2, 1, 2, 1),
            gld_fused=ref,
            prev_mv=torch.zeros((h // 16, w // 16, 2), dtype=torch.int32),
            noise_gate=4.0)

    for mode, card in (("plain", False), ("card", True)):
        key = counted(lambda: intra_wave.encode_intra_wave(
            *planes[0], 72, lam_scale=0.3), card)
        out[mode] = {
            "wave_keyframe": key,
            "probe_frame_128x192": counted(
                lambda: intra_part.encode_intra_part(*planes[0], 72), card,
                split=card),
            "inter_frame_fast": counted(fast, card, split=card),
            "inter_frame_quality": counted(quality, card, split=True)}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
