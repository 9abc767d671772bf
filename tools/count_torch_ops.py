#!/usr/bin/env python3
"""Count the PyTorch operations that the port dispatches, on the CPU.

    python3 tools/count_torch_ops.py

An eager encode is bound by the host's cost per dispatched operation, so
the counts say where that time goes before any profile does.  The numbers
of operations per wavefront diagonal and per inter frame do not depend on
the frame size (only the tensors grow), so they are counted here on a
128x192 frame with torch's dispatch mode (the probe's count does grow with
the frame's block rows and columns, and is given for this size only):
every aten operation, split into those that only make a view (no device
work) and the rest (each launches at least one kernel on a GPU).  Prints one JSON line.  These are counts of
what the program does, not device measurements.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

VIEW_OPS = ("view", "reshape", "expand", "permute", "transpose", "slice",
            "select", "unsqueeze", "squeeze", "alias", "as_strided", "t.",
            "unbind", "split", "detach", "_unsafe_view", "unfold")


def main() -> int:
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from av1tpu_torch.models import inter_v, intra_part, intra_wave
    from av1tpu_torch.models.intra_v import fuse_planes
    from av1tpu_torch.utils.yuv import synthetic_clip

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.views = self.work = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.name().split("::")[-1]
            if any(name.startswith(v) for v in VIEW_OPS):
                self.views += 1
            else:
                self.work += 1
            return func(*args, **(kwargs or {}))

    def counted(fn):
        with Count() as c:
            fn()
        return {"work": c.work, "views": c.views}

    h, w = 128, 192
    clip = synthetic_clip(w, h, 3, seed=11)
    planes = [[torch.from_numpy(p[k].astype(np.int32))
               for p in (clip.y, clip.u, clip.v)] for k in range(3)]
    fused = [torch.from_numpy(fuse_planes(*[p.numpy() for p in ps]))
             for ps in planes]
    ref = torch.cat([p.reshape(-1) for p in planes[0]])
    nd = 2 * (h // 16 - 1) + w // 16
    out = {"frame": [h, w], "diagonals": nd}
    key = counted(lambda: intra_wave.encode_intra_wave(*planes[0], 72,
                                                       lam_scale=0.3))
    out["wave_keyframe_per_diagonal"] = {k: round(v / nd) for k, v in
                                         key.items()}
    out["probe_frame_128x192"] = counted(lambda: intra_part.encode_intra_part(
        *planes[0], 72))
    out["inter_frame_fast"] = counted(lambda: inter_v._gop_step_body(
        fused[1], ref, 72, h, w, 1 << 20, (9, 4, 4), (2, 1, 2, 1)))
    out["inter_frame_quality"] = counted(
        lambda: inter_v._gop_step_part_body(
            fused[1], ref, 72, h, w, 1 << 20, (9, 4, 4), (2, 1, 2, 1),
            gld_fused=ref,
            prev_mv=torch.zeros((h // 16, w // 16, 2), dtype=torch.int32),
            noise_gate=4.0))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
