#!/usr/bin/env python3
"""Decode the streams that chip_smoke.py phase 13 kept, on a host that has
libav, against the recon they were coded with.

    AV1TPU_SMOKE_OUT=DIR python3 chip_smoke.py      # on the GPU host
    python3 tools/card_decode_check.py DIR          # where libav is

Phase 13 leaves NAME.ivf, NAME_recon.npz and NAME.json in DIR for each of
its runs (chip_smoke.card_encode); on a GPU host without libav it cannot
decode them itself.  For each run this prints chip_smoke.decode_check's
line: the pixels of each plane that differ from the recon, per frame, or
the decoder's refusal.  Exits non-zero where fast_1080p, whose decode
must equal its recon, does not.
"""

import glob
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from av1tpu_torch import _build  # noqa: E402


def main(argv) -> int:
    (out_dir,) = argv
    tool = _build.av1_tool_path()
    names = sorted(os.path.basename(p)[: -len("_recon.npz")] for p in
                   glob.glob(os.path.join(out_dir, "*_recon.npz")))
    assert names, f"no recon in {out_dir}"
    exact = True
    for name in names:
        with tempfile.TemporaryDirectory() as tmp:
            dec, diffs = cs.decode_check(tool, out_dir, name, tmp)
        if name == "fast_1080p":
            exact = (dec is not None and dec["frames"] == len(diffs)
                     and not any(map(any, diffs.values())))
    return 0 if exact else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
