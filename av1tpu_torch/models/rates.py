"""CDF-derived rate model on tensors (port of av1tpu/models/rates.py).

The numpy table functions (coef_rate_tables, txb_skip_bits,
kf_mode_bits, scan_rank, eob_bits_tables) are copies of the JAX package's,
over the port's own copy of the default CDFs (av1tpu_torch.spec.tables);
tests hold them equal.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from av1tpu_torch.spec import tables
from av1tpu_torch.spec.enums import default_scan, tx_size_ctx

_MAX_LEVEL = 256  # table length; larger magnitudes clamp to the last entry


def _sym_bits(icdf_row: np.ndarray, s: int) -> float:
    """Bits to code symbol s from one 32768-scaled inverse CDF row."""
    row = np.asarray(icdf_row, np.int64)
    prev = 32768 if s == 0 else int(row[s - 1])
    p = max(prev - int(row[s]), 1) / 32768.0
    return -float(np.log2(p))


def _avg_sym_bits(cdf_rows: np.ndarray, s: int) -> float:
    """Mean bits for symbol s over a (ctx, vals) stack of CDF rows."""
    rows = cdf_rows.reshape(-1, cdf_rows.shape[-1])
    return float(np.mean([_sym_bits(r, s) for r in rows]))


def _golomb_bits(v: int) -> int:
    """Exp-golomb length for v: 2*len(v+1)-1."""
    return 2 * int(v + 1).bit_length() - 1


@functools.cache
def coef_rate_tables(tx_ctx: int, ptype: int) -> np.ndarray:
    """(4, _MAX_LEVEL) float32: expected bits to code one coefficient of
    magnitude L (incl. sign) for each quality bucket.  tx_ctx: tx-size
    context (16x16 -> 2, 32x32 -> 3, 64x64 -> 4, 8x8 -> 1); ptype: 0
    luma, 1 chroma.  Symbol costs are read from the coeff_base/coeff_br
    activity class matching L, averaged over the AC position classes."""
    c = tables.coef_cdfs()
    out = np.zeros((4, _MAX_LEVEL), np.float32)
    for qctx in range(4):
        base = c["coeff_base"][qctx][tx_ctx][ptype]       # (42, vals)
        br = c["coeff_br"][qctx][min(tx_ctx, 3)][ptype]   # (21, vals)

        def base_bits(lv_cls: int, s: int) -> float:
            rows = np.stack([base[min(lv_cls, 4) + off]
                             for off in (1, 6, 21)])
            return _avg_sym_bits(rows, s)

        def br_bits(lv_cls: int, s: int) -> float:
            rows = np.stack([br[min(lv_cls, 6) + off] for off in (7, 14)])
            return _avg_sym_bits(rows, s)

        for lv in range(_MAX_LEVEL):
            if lv == 0:
                out[qctx, lv] = base_bits(0, 0)
                continue
            bits = base_bits(lv, min(lv, 3)) + 1.0  # base symbol + sign
            if lv > 2:
                rem = min(lv, 15) - 3
                for _ in range(4):  # base-range chain, 0..3 increments
                    inc = min(rem, 3)
                    bits += br_bits(lv, inc)
                    rem -= inc
                    if inc < 3:
                        break
            if lv > 14:
                bits += _golomb_bits(lv - 15)
            out[qctx, lv] = bits
    return out


@functools.cache
def txb_skip_bits(tx_ctx: int) -> np.ndarray:
    """(4, 2) float32: [qctx][all_zero] expected txb_skip bits (symbol 0 =
    coded block, symbol 1 = all-zero block), context-averaged."""
    c = tables.coef_cdfs()
    out = np.zeros((4, 2), np.float32)
    for qctx in range(4):
        rows = c["txb_skip"][qctx][tx_ctx]
        out[qctx, 0] = _avg_sym_bits(rows, 0)
        out[qctx, 1] = _avg_sym_bits(rows, 1)
    return out


@functools.cache
def kf_mode_bits() -> np.ndarray:
    """(13,) float32: expected kf_y_mode bits per intra mode enum value,
    averaged over the 5x5 neighbor-mode context grid."""
    m = tables.mode_cdfs()["kf_y_mode"]  # (5, 5, vals)
    rows = m.reshape(-1, m.shape[-1])
    return np.array(
        [float(np.mean([_sym_bits(r, s) for r in rows]))
         for s in range(13)], np.float32)


@functools.cache
def scan_rank(n: int) -> np.ndarray:
    """(n, n) int32 grid: each coefficient's position in the default scan
    (positions beyond the coded 32x32 area of larger transforms get a
    sentinel past the end so they never extend the eob)."""
    tx = {4: 0, 8: 1, 16: 2, 32: 3, 64: 4}[n]
    cw = min(n, 32)
    scan = default_scan(tx)  # scan index -> position (row * cw + col)
    g = np.full((n, n), cw * cw, np.int32)
    rows, cols = np.divmod(np.asarray(scan, np.int64), cw)
    g[rows, cols] = np.arange(len(scan), dtype=np.int32)
    return g


@functools.cache
def eob_bits_tables(area: int, ptype: int) -> np.ndarray:
    """(4, area + 1) float32: expected bits to code an end-of-block
    position (eob_pt symbol + extra/raw low bits; spec 5.11.38) indexed by
    eob (1-based; index 0 = all-zero block, charged 0 here because
    txb_skip covers it)."""
    c = tables.coef_cdfs()
    pt = c[f"eob_pt_{min(area, 1024)}"]  # (qctx, ptype, tx-type ctx, vals)
    out = np.zeros((4, area + 1), np.float32)
    for qctx in range(4):
        rows = pt[qctx][ptype].reshape(-1, pt.shape[-1])
        for e in range(1, area + 1):
            t = (e - 1).bit_length()  # eob_pt symbol (eob in (2^(t-1), 2^t])
            sym = min(t, rows.shape[1] - 1)
            bits = float(np.mean([_sym_bits(r, sym) for r in rows]))
            if t >= 2:  # one cdf-coded high bit + t-2 raw low bits
                bits += float(t - 1)
            out[qctx, e] = bits
    return out


def qctx_index(q: int) -> int:
    """Quality-bucket index of a qindex (spec init_coeff_cdfs thresholds)."""
    return int(q > 20) + int(q > 60) + int(q > 120)


class RateModel:
    """Device-side rate tables for one transform size / plane type.

    ``rm = RateModel(16, 0, device); bits = rm(levels, qctx)`` models the
    tile engine's coefficient coding: txb_skip symbol, eob position cost,
    per-coded-coefficient base/br/sign/golomb cost (zeros past the
    end-of-block are free)."""

    def __init__(self, n: int, ptype: int, device):
        tx = {4: 0, 8: 1, 16: 2, 32: 3, 64: 4}[n]
        cw = min(n, 32)
        f32 = torch.float32
        self.tabs = torch.as_tensor(coef_rate_tables(tx_size_ctx(tx), ptype),
                                    dtype=f32, device=device)
        self.skip = torch.as_tensor(txb_skip_bits(tx_size_ctx(tx)),
                                    dtype=f32, device=device)
        self.rank = torch.as_tensor(scan_rank(n)[:cw, :cw],
                                    dtype=torch.int32, device=device)
        self.eob = torch.as_tensor(eob_bits_tables(cw * cw, ptype),
                                   dtype=f32, device=device)

    def __call__(self, lv: torch.Tensor, qctx: int) -> torch.Tensor:
        """lv: (..., n, n) int levels -> (...,) float32 expected bits."""
        return coef_bits(lv, self.tabs[qctx], self.skip[qctx], self.rank,
                         self.eob[qctx])


def coef_bits(lv: torch.Tensor, tab: torch.Tensor, sk: torch.Tensor,
              rank: torch.Tensor, eob_bits: torch.Tensor) -> torch.Tensor:
    """RateModel's bits with one quality bucket's rows: tab (256,) per
    magnitude, sk (2,) txb_skip, rank (n, n) scan positions, eob_bits
    (n*n + 1,).  lv: (..., n, n) int levels -> (...,) float32.
    Magnitudes 0..15 read the table; larger ones use the closed form
    tab[15] - 1 + exp_golomb(a - 15), as the table rows were built."""
    a = lv.abs()
    nz = lv != 0
    eob = torch.where(nz, rank + 1, 0).amax(dim=(-2, -1))
    coded = rank < eob[..., None, None]
    small = torch.zeros(a.shape, dtype=torch.float32, device=lv.device)
    for k in range(16):
        small = small + torch.where(a == k, tab[k], 0.0)
    big = (tab[15] - 1.0
           + 2.0 * torch.floor(torch.log2(torch.clamp(
               a.to(torch.float32) - 14.0, min=2.0))) + 1.0)
    bits = torch.where(a > 15, big, small)
    coef = torch.where(coded, bits, 0.0).sum(dim=(-2, -1))
    return torch.where(eob == 0, sk[1], sk[0] + eob_bits[eob.long()] + coef)
