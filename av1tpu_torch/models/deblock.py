"""In-loop deblocking on int32 tensors (port of av1tpu/models/deblock_tpu.py).

Bit-exact vectorization of the spec engine's filter (av1tpu/spec/deblock.py):
block edges sit on 16-px luma / 8-px chroma multiples and the modified
region of an edge never overlaps the next edge, so each pass is a strided
slice -> vectorized filter -> stitch.  On the uniform grid every luma edge
takes the 14-tap path (with its 8/4-tap mask fallbacks) and every chroma
edge the 6-tap path; interior edges of 32/64 merges are gated per edge by
the split maps (`edge_gates_j`), and 16-blocks split into 8x8 sub-blocks
(`split16`) add interior 8/4-tap edges and cap their outer edges' filters.
"""

from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.kernels.deblock import deblock_edges


def _thresholds(lvl: int, sharpness: int):
    """Filter thresholds of a host-int level."""
    if sharpness > 0:
        shift = 2 if sharpness > 4 else 1
        limit = int(np.clip(lvl >> shift, 1, 9 - sharpness))
    else:
        limit = max(1, lvl)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4
    return limit, blimit, thresh


def lf_levels(qindex: int):
    """Copy of av1tpu/models/deblock_tpu.py:lf_levels (host ints)."""
    ly = int(np.clip(qindex // 4 - 6, 0, 63))
    lc = ly // 2
    return ly, ly, lc, lc


def edge_gates_j(split32, split64, rows: int, cols: int):
    """Edge gates from the merge split maps via block-id equality: an
    interior 16-boundary inside a merged 32/64 NONE block is not a
    tx/prediction edge.  Returns (v_on (rows, cols-1), h_on (rows-1,
    cols)) bool."""
    dev = split32.device

    from av1tpu_torch.models.intra_v import rep2d

    def ids(f, off):
        g = torch.arange((rows // f) * (cols // f), dtype=torch.int32,
                         device=dev).reshape(rows // f, cols // f)
        return rep2d(g, f) + off

    bid = ids(1, 0)
    bid = torch.where(rep2d(~split32.to(torch.bool), 2),
                      ids(2, rows * cols), bid)
    bid = torch.where(rep2d(~split64.to(torch.bool), 4),
                      ids(4, 2 * rows * cols), bid)
    return bid[:, 1:] != bid[:, :-1], bid[1:, :] != bid[:-1, :]


def _r2(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _narrow(p1, p0, q0, q1, thresh, bd):
    """The 4-tap filter's outputs (n_p1, n_p0, n_q0, n_q1)."""
    F = 1 << (bd - 8)
    mx = (1 << bd) - 1
    ab = torch.abs
    hev = (ab(p1 - p0) > thresh * F) | (ab(q1 - q0) > thresh * F)
    lo_c, hi_c = -128 * F, 128 * F - 1

    def clip(x):
        return torch.clamp(x, lo_c, hi_c)

    fil = torch.where(hev, clip(p1 - q1), 0)
    fil = clip(fil + 3 * (q0 - p0))
    f1 = clip(fil + 4) >> 3
    f2 = clip(fil + 3) >> 3
    n_q0 = torch.clamp(q0 - f1, 0, mx)
    n_p0 = torch.clamp(p0 + f2, 0, mx)
    f3 = _r2(f1, 1)
    n_q1 = torch.where(hev, q1, torch.clamp(q1 - f3, 0, mx))
    n_p1 = torch.where(hev, p1, torch.clamp(p1 + f3, 0, mx))
    return n_p1, n_p0, n_q0, n_q1


def _filter_luma8_lines(win, limit, blimit, thresh, bd):
    """win: (..., 8) [p3..p0, q0..q3] per line: the 8/4-tap chain for
    edges whose filter size is capped at 8 (both sides 8x8 tx: the
    interior edge of a split-16 block).  Returns (..., 6) [p2..q2]."""
    F = 1 << (bd - 8)
    p3, p2, p1, p0, q0, q1, q2, q3 = [win[..., k] for k in range(8)]
    ab = torch.abs
    fm = ((ab(p1 - p0) <= limit * F)
          & (ab(q1 - q0) <= limit * F)
          & (ab(p0 - q0) * 2 + (ab(p1 - q1) >> 1) <= blimit * F)
          & (ab(p2 - p1) <= limit * F)
          & (ab(q2 - q1) <= limit * F)
          & (ab(p3 - p2) <= limit * F)
          & (ab(q3 - q2) <= limit * F))
    n_p1, n_p0, n_q0, n_q1 = _narrow(p1, p0, q0, q1, thresh, bd)
    flat = ((ab(p1 - p0) <= F) & (ab(q1 - q0) <= F)
            & (ab(p2 - p0) <= F) & (ab(q2 - q0) <= F)
            & (ab(p3 - p0) <= F) & (ab(q3 - q0) <= F))
    m8 = fm & flat
    o3p = _r2(p3 * 3 + p2 * 2 + p1 + p0 + q0, 3)
    o2p = _r2(p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1, 3)
    o1p = _r2(p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2, 3)
    o1q = _r2(p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3, 3)
    o2q = _r2(p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2, 3)
    o3q = _r2(p0 + q0 + q1 + q2 * 2 + q3 * 3, 3)

    def pick(eight, narrow, orig):
        return torch.where(m8, eight, torch.where(fm, narrow, orig))

    return torch.stack([
        pick(o3p, p2, p2), pick(o2p, n_p1, p1), pick(o1p, n_p0, p0),
        pick(o1q, n_q0, q0), pick(o2q, n_q1, q1), pick(o3q, q2, q2),
    ], dim=-1)


def _filter_chroma4_lines(win, limit, blimit, thresh, bd):
    """win: (..., 4) [p1, p0, q0, q1]: the 4-tap chroma chain (both sides
    4x4 tx: the interior edge of a split block's chroma).  Returns (..., 4)
    modified [p1, p0, q0, q1]."""
    F = 1 << (bd - 8)
    p1, p0, q0, q1 = [win[..., k] for k in range(4)]
    ab = torch.abs
    fm = ((ab(p1 - p0) <= limit * F)
          & (ab(q1 - q0) <= limit * F)
          & (ab(p0 - q0) * 2 + (ab(p1 - q1) >> 1) <= blimit * F))
    new = _narrow(p1, p0, q0, q1, thresh, bd)
    return torch.stack([torch.where(fm, n, o)
                        for n, o in zip(new, (p1, p0, q0, q1))], dim=-1)


def _deblock_interior_v(plane, stride: int, off: int, taps: int, mod: int,
                        edge_on, filt):
    """Interior-edge vertical pass: one edge per stride-px block column at
    x = off + stride*j.  The modified region (+-mod) stays inside the
    block, so the stitch is a concatenate.  edge_on: (H, w//stride)
    per-line enables; filt(win (..., 2*taps)) -> (..., 2*mod)."""
    h, w = plane.shape
    ne = w // stride
    win = torch.stack([plane[:, off + k : off + k + (ne - 1) * stride + 1
                             : stride] for k in range(-taps, taps)], dim=-1)
    sel = torch.where(edge_on[..., None], filt(win),
                      win[..., taps - mod : taps + mod])
    blocks = plane.reshape(h, ne, stride)
    new = torch.cat([blocks[:, :, : off - mod], sel,
                     blocks[:, :, off + mod :]], dim=-1)
    return new.reshape(h, w)


def _filter_luma_lines(win, limit, blimit, thresh, bd, allow14=None):
    """win: (..., 14) int32 [p6..p0, q0..q6] per line.  Returns the 12
    modified samples [p5..p0, q0..q5] after the 14/8/4-tap chain.
    allow14: per-line bool; False caps the filter at 8 taps (filter size =
    min of the tx dims across the edge)."""
    F = 1 << (bd - 8)
    (p6, p5, p4, p3, p2, p1, p0, q0, q1, q2, q3, q4, q5, q6) = [
        win[..., k] for k in range(14)]
    ab = torch.abs
    fm = ((ab(p1 - p0) <= limit * F)
          & (ab(q1 - q0) <= limit * F)
          & (ab(p0 - q0) * 2 + (ab(p1 - q1) >> 1) <= blimit * F)
          & (ab(p2 - p1) <= limit * F)
          & (ab(q2 - q1) <= limit * F)
          & (ab(p3 - p2) <= limit * F)
          & (ab(q3 - q2) <= limit * F))
    n_p1, n_p0, n_q0, n_q1 = _narrow(p1, p0, q0, q1, thresh, bd)

    flat = ((ab(p1 - p0) <= F) & (ab(q1 - q0) <= F)
            & (ab(p2 - p0) <= F) & (ab(q2 - q0) <= F)
            & (ab(p3 - p0) <= F) & (ab(q3 - q0) <= F))
    m8 = fm & flat
    o3p = _r2(p3 * 3 + p2 * 2 + p1 + p0 + q0, 3)
    o2p = _r2(p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1, 3)
    o1p = _r2(p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2, 3)
    o1q = _r2(p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3, 3)
    o2q = _r2(p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2, 3)
    o3q = _r2(p0 + q0 + q1 + q2 * 2 + q3 * 3, 3)

    flat2 = ((ab(p4 - p0) <= F) & (ab(q4 - q0) <= F)
             & (ab(p5 - p0) <= F) & (ab(q5 - q0) <= F)
             & (ab(p6 - p0) <= F) & (ab(q6 - q0) <= F))
    m14 = m8 & flat2
    if allow14 is not None:
        m14 = m14 & allow14
    w5p = _r2(p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0, 4)
    w4p = _r2(p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1, 4)
    w3p = _r2(p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1
              + q2, 4)
    w2p = _r2(p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1
              + q2 + q3, 4)
    w1p = _r2(p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1
              + q2 + q3 + q4, 4)
    w0p = _r2(p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2
              + q3 + q4 + q5, 4)
    w0q = _r2(q6 + q5 + q4 + q3 + q2 + q1 * 2 + q0 * 2 + p0 * 2 + p1 + p2
              + p3 + p4 + p5, 4)
    w1q = _r2(q6 * 2 + q5 + q4 + q3 + q2 * 2 + q1 * 2 + q0 * 2 + p0 + p1
              + p2 + p3 + p4, 4)
    w2q = _r2(q6 * 3 + q5 + q4 + q3 * 2 + q2 * 2 + q1 * 2 + q0 + p0 + p1
              + p2 + p3, 4)
    w3q = _r2(q6 * 4 + q5 + q4 * 2 + q3 * 2 + q2 * 2 + q1 + q0 + p0 + p1
              + p2, 4)
    w4q = _r2(q6 * 5 + q5 * 2 + q4 * 2 + q3 * 2 + q2 + q1 + q0 + p0 + p1, 4)
    w5q = _r2(q6 * 7 + q5 * 2 + q4 * 2 + q3 + q2 + q1 + q0 + p0, 4)

    def pick(wide, eight, narrow, orig):
        mid = torch.where(m8, eight, torch.where(fm, narrow, orig))
        return torch.where(m14, wide, mid)

    return torch.stack([
        pick(w5p, p5, p5, p5), pick(w4p, p4, p4, p4), pick(w3p, p3, p3, p3),
        pick(w2p, o3p, p2, p2), pick(w1p, o2p, n_p1, p1),
        pick(w0p, o1p, n_p0, p0), pick(w0q, o1q, n_q0, q0),
        pick(w1q, o2q, n_q1, q1), pick(w2q, o3q, q2, q2),
        pick(w3q, q3, q3, q3), pick(w4q, q4, q4, q4), pick(w5q, q5, q5, q5),
    ], dim=-1)


def _filter_chroma_lines(win, limit, blimit, thresh, bd, allow6=None):
    """win: (..., 6) [p2..p0, q0..q2].  Returns (..., 4) [p1, p0, q0, q1]
    after the 6/4-tap chain.  allow6: per-line bool; False caps the filter
    at 4 taps (an adjacent 4x4 chroma tx), which also drops the p2/q2
    terms from the filter mask."""
    F = 1 << (bd - 8)
    p2, p1, p0, q0, q1, q2 = [win[..., k] for k in range(6)]
    ab = torch.abs
    fm = ((ab(p1 - p0) <= limit * F)
          & (ab(q1 - q0) <= limit * F)
          & (ab(p0 - q0) * 2 + (ab(p1 - q1) >> 1) <= blimit * F))
    fm6 = fm & (ab(p2 - p1) <= limit * F) & (ab(q2 - q1) <= limit * F)
    fm = fm6 if allow6 is None else torch.where(allow6, fm6, fm)
    n_p1, n_p0, n_q0, n_q1 = _narrow(p1, p0, q0, q1, thresh, bd)

    flat = ((ab(p1 - p0) <= F) & (ab(q1 - q0) <= F)
            & (ab(p2 - p0) <= F) & (ab(q2 - q0) <= F))
    m6 = fm & flat
    if allow6 is not None:
        m6 = m6 & allow6
    o_p1 = _r2(p2 * 3 + p1 * 2 + p0 * 2 + q0, 3)
    o_p0 = _r2(p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1, 3)
    o_q0 = _r2(p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2, 3)
    o_q1 = _r2(p0 + q0 * 2 + q1 * 2 + q2 * 3, 3)

    def pick(six, narrow, orig):
        return torch.where(m6, six, torch.where(fm, narrow, orig))

    return torch.stack([pick(o_p1, n_p1, p1), pick(o_p0, n_p0, p0),
                        pick(o_q0, n_q0, q0), pick(o_q1, n_q1, q1)], dim=-1)


def _deblock_plane_v(plane, nblk: int, edge_on, limit, blimit, thresh, bd,
                     luma: bool, allow14=None):
    """Vertical-edge pass.  plane: (H, W) int32; edges between nblk-px
    block columns; edge_on: (H, n_edges) bool per line.  allow14: optional
    per-line size cap (False = an adjacent 8x8/4x4 tx caps the filter at
    8 taps luma / 4 taps chroma)."""
    h, w = plane.shape
    ne = w // nblk - 1
    taps = 7 if luma else 3
    mod = taps - 1
    # windows (H, ne, 2*taps) around each edge
    win = torch.stack([plane[:, nblk + k : nblk + k + (ne - 1) * nblk + 1
                             : nblk] for k in range(-taps, taps)], dim=-1)
    filt = _filter_luma_lines if luma else _filter_chroma_lines
    out = filt(win, limit, blimit, thresh, bd, allow14)
    sel = torch.where(edge_on[..., None], out,
                      win[..., taps - mod : taps + mod])
    # stitch: modified columns are x-mod..x+mod-1 around each edge
    blocks = plane.reshape(h, w // nblk, nblk)
    heads = torch.cat([blocks[:, :1, :mod], sel[..., mod:]], dim=1)
    tails = torch.cat([sel[..., :mod], blocks[:, -1:, nblk - mod :]], dim=1)
    new = torch.cat([heads, blocks[:, :, mod : nblk - mod], tails], dim=-1)
    return new.reshape(h, w)


def deblock_planes(y, u, v, v_on16, h_on16, lvl_y: int, lvl_u: int,
                   lvl_v: int, sharpness: int = 0, bit_depth: int = 8,
                   split16=None):
    """Apply the loop filter to recon planes.  v_on16/h_on16: per-16-block
    boundary enables (rows, cols-1)/(rows-1, cols) bool; levels are host
    ints (a level of 0 leaves its plane unchanged).

    split16: optional (rows, cols) map of 16-blocks split into 8x8 TX
    sub-blocks.  Those blocks add interior tx edges at the 8-px (luma) /
    4-px (chroma) offsets, and cap the filter size of their outer edges at
    8 taps luma / 4 taps chroma (filter size = min tx dim across the
    edge).  Per plane all vertical edges come before all horizontal ones,
    and within a direction the interior passes run first: with the caps
    every edge's read/modify region is disjoint from the outer passes'
    regions, so this equals the sequential in-place edge walk.

    Each plane whose level is above 0 is one call of
    kernels/deblock.py:deblock_edges, both directions (on the card, one
    kernel launch)."""
    s = split16.to(torch.bool) if split16 is not None else None
    out = []
    for plane, lvl, luma in ((y, lvl_y, True), (u, lvl_u, False),
                             (v, lvl_v, False)):
        out.append(deblock_edges(plane, v_on16, h_on16, lvl, sharpness,
                                 bit_depth, luma, s) if lvl > 0 else plane)
    return tuple(out)
