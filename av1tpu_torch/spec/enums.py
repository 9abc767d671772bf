"""AV1 enums and transform geometry the port reads (copy of the parts of
av1tpu/spec/enums.py it calls): block and transform size constants, the
coefficient CDF tx-size context, the default scan order and the intra
prediction modes."""

from __future__ import annotations

import functools
import os

import numpy as np

BLOCK_16X16 = 6

# intra prediction modes (spec y_mode values)
DC_PRED = 0
V_PRED = 1
H_PRED = 2
D45_PRED = 3
D135_PRED = 4
D113_PRED = 5
D157_PRED = 6
D203_PRED = 7
D67_PRED = 8
SMOOTH_PRED = 9
SMOOTH_V_PRED = 10
SMOOTH_H_PRED = 11
PAETH_PRED = 12

TX_4X4 = 0
TX_8X8 = 1
TX_16X16 = 2
TX_32X32 = 3
TX_64X64 = 4

TX_W = [4, 8, 16, 32, 64, 4, 8, 8, 16, 16, 32, 32, 64, 4, 16, 8, 32, 16, 64]
TX_H = [4, 8, 16, 32, 64, 8, 4, 16, 8, 32, 16, 64, 32, 16, 4, 32, 8, 64, 16]

# Tx_Size_Sqr / Tx_Size_Sqr_Up (spec tables)
TX_SIZE_SQR = [TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64,
               TX_4X4, TX_4X4, TX_8X8, TX_8X8, TX_16X16, TX_16X16,
               TX_32X32, TX_32X32, TX_4X4, TX_4X4, TX_8X8, TX_8X8,
               TX_16X16, TX_16X16]
TX_SIZE_SQR_UP = [TX_4X4, TX_8X8, TX_16X16, TX_32X32, TX_64X64,
                  TX_8X8, TX_8X8, TX_16X16, TX_16X16, TX_32X32, TX_32X32,
                  TX_64X64, TX_64X64, TX_16X16, TX_16X16, TX_32X32,
                  TX_32X32, TX_64X64, TX_64X64]


@functools.cache
def default_scan(tx_size: int) -> np.ndarray:
    """Scan positions of the default (2D) transform scan, limited to the
    coded area (32x32 at most), from the normative tables: positions are
    row * coded_width + col."""
    w = min(TX_W[tx_size], 32)
    h = min(TX_H[tx_size], 32)
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tables", "scans.npz")
    with np.load(path) as z:
        return z[f"{w}x{h}"]


def tx_size_ctx(tx_size: int) -> int:
    """txSzCtx used to index coefficient cdfs: (TxSizeSqr + TxSizeSqrUp+1)>>1"""
    return (TX_SIZE_SQR[tx_size] + TX_SIZE_SQR_UP[tx_size] + 1) >> 1
