"""Loader for the AV1 spec constant tables the port reads (copy of the
loaders of av1tpu/spec/tables.py, over copies of its .npz files in
av1tpu_torch/spec/tables/).

Shapes:
  quant:  dc_q_{8,10,12} / ac_q_{8,10,12}: (256,) dequant step per qindex
  coef:   coeff_base (4 qctx, 5 txsz, 2 plane, 42 ctx, 4 syms),
          coeff_br (4, 5, 2, 21 ctx, 4 syms), txb_skip (4, 5, 13 ctx, 2
          syms), eob_pt_{16..1024} (4, 2 plane, 2 ctx, N syms), and the
          other coefficient CDFs (inverted iCDF convention)
  modes:  kf_y_mode (5, 5, 13 syms) and the other mode CDFs
  subpel: regular / smooth / sharp / bilinear (16 positions x 8 taps), and
          regular_4, the 4-tap bank stored 8 wide
"""

from __future__ import annotations

import functools
import os

import numpy as np

_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tables")


@functools.cache
def _load(name: str) -> dict[str, np.ndarray]:
    with np.load(os.path.join(_DIR, name)) as z:
        return {k: z[k] for k in z.files}


def quant() -> dict[str, np.ndarray]:
    return _load("quant.npz")


def coef_cdfs() -> dict[str, np.ndarray]:
    return _load("coef_cdfs.npz")


def mode_cdfs() -> dict[str, np.ndarray]:
    return _load("mode_cdfs.npz")


def subpel_filters() -> dict[str, np.ndarray]:
    """Sub-pel interpolation filter banks (spec Subpel_Filters)."""
    return _load("subpel.npz")
