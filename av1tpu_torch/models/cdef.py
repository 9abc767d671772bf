"""CDEF on int32 tensors (port of av1tpu/models/cdef_tpu.py, spec 7.15).

- Direction search: each 8x8 luma block's eight directional partial sums
  are one matrix product against a 0/1 (64, 90) assignment matrix (exact in
  float32: |partial| <= 1024; TF32 must stay off), costs in exact int32.
- Filtering: per direction the primary and secondary taps are whole-plane
  shifts of the padded pre-CDEF image, constrain() and the min/max clamp
  are elementwise, and the per-pixel result is selected by the block
  direction.  Strengths are host ints.

Both are the plain version of kernels/cdef.py:cdef_filter, the hand kernel
that `cdef_planes` calls for a frame and a preset.
"""

from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.models.intra_v import rep2d, to_blocks, unfuse
from av1tpu_torch.spec.cdef import CDEF_DIRECTIONS, DIV_TABLE
from av1tpu_torch.state import tables

CDEF_VERY_LARGE = 0x4000

# bin index per direction for pixel (i, j) of an 8x8 block (spec 7.15.2)
_BIN_FN = (
    lambda i, j: i + j,
    lambda i, j: i + j // 2,
    lambda i, j: i,
    lambda i, j: 3 + i - j // 2,
    lambda i, j: 7 + i - j,
    lambda i, j: 3 - i // 2 + j,
    lambda i, j: j,
    lambda i, j: i // 2 + j,
)
_NBINS = (15, 11, 8, 11, 15, 11, 8, 11)

# candidate frame-wide presets for the per-scene strength search
CDEF_PRESETS = np.array([
    (0, 0, 0, 0), (1, 0, 1, 0), (1, 1, 1, 1), (2, 1, 2, 1),
    (4, 1, 3, 1), (6, 2, 4, 1), (9, 2, 6, 2), (12, 3, 9, 3),
], np.int32)


def dir_tables():
    """(64, 90) float32 0/1 bin assignment and (90,) int32 cost weights
    (the matrix of av1tpu/models/cdef_tpu.py:49)."""
    total = sum(_NBINS)
    a = np.zeros((64, total), np.float32)
    w = np.zeros(total, np.int32)
    w_even = [DIV_TABLE[min(i, 14 - i) + 1] for i in range(15)]
    w_odd = ([DIV_TABLE[2 * j + 2] for j in range(3)] + [105] * 5
             + [DIV_TABLE[2 * j + 2] for j in (2, 1, 0)])
    w_axis = [105] * 8
    per_dir_w = {0: w_even, 4: w_even, 2: w_axis, 6: w_axis}
    off = 0
    for d in range(8):
        nb = _NBINS[d]
        for i in range(8):
            for j in range(8):
                a[i * 8 + j, off + _BIN_FN[d](i, j)] = 1.0
        w[off : off + nb] = per_dir_w.get(d, w_odd)
        off += nb
    return a, w


def cdef_dirs(y: torch.Tensor, coeff_shift: int):
    """Per-8x8-block (direction, variance) maps from the deblocked luma.
    y: (H, W) int; returns (dir (H/8, W/8) int32, var int32)."""
    h, w = y.shape
    nbr, nbc = h // 8, w // 8
    A, W = tables(y.device).cdef_dirs()
    img = (y.to(torch.int32) >> coeff_shift) - 128
    blocks = to_blocks(img, 8).reshape(nbr * nbc, 64)
    part = (blocks.to(torch.float32) @ A).to(torch.int32)
    cb = part * part * W[None, :]
    cols = []
    off = 0
    for d in range(8):
        cols.append(cb[:, off : off + _NBINS[d]].sum(dim=1, dtype=torch.int32))
        off += _NBINS[d]
    cost = torch.stack(cols, dim=-1)
    best = torch.argmax(cost, dim=-1)
    cbest = torch.gather(cost, 1, best[:, None])[:, 0]
    copp = torch.gather(cost, 1, (best ^ 4)[:, None])[:, 0]
    var = (cbest - copp) >> 10
    return (best.to(torch.int32).reshape(nbr, nbc), var.reshape(nbr, nbc))


def _floor_log2(x: torch.Tensor) -> torch.Tensor:
    """floor(log2(max(x, 1))) for int32 x, exactly (the reference's
    31 - clz)."""
    x = torch.clamp(x, min=1)
    out = torch.zeros_like(x)
    for k in range(1, 31):
        out = out + (x >= (1 << k)).to(torch.int32)
    return out


def _constrain(diff, threshold, damp_adj):
    """constrain() (spec 7.15.3) with the damping adjustment
    max(0, damping - floor_log2(threshold)) precomputed per threshold."""
    ad = diff.abs()
    m = torch.minimum(ad, torch.clamp(threshold - (ad >> damp_adj), min=0))
    return torch.where(diff < 0, -m, m) * (threshold > 0)


def _filter_plane(plane, dir_px, pri_px, pri_parity, sec: int, damping: int,
                  h: int, w: int):
    """One plane pass.  plane: (H, W) pre-CDEF samples; dir_px: per-pixel
    direction; pri_px: per-pixel effective primary strength; pri_parity:
    per-pixel tensor or host int (picks (4,2) vs (3,3) primary taps); sec:
    shifted secondary strength; damping: plane-adjusted damping."""
    px = plane.to(torch.int32)
    pad = torch.full((h + 4, w + 4), CDEF_VERY_LARGE, dtype=torch.int32,
                     device=px.device)
    pad[2 : 2 + h, 2 : 2 + w] = px
    pt = (4 - pri_parity, 2 + pri_parity)
    st = (2, 1)
    damp_pri = torch.clamp(damping - _floor_log2(pri_px), min=0)
    sec_t = torch.tensor(sec, dtype=torch.int32, device=px.device)
    damp_sec = torch.clamp(damping - _floor_log2(sec_t), min=0)

    def tap(dy, dx):
        return pad[2 + dy : 2 + dy + h, 2 + dx : 2 + dx + w]

    def minmax(mn, mx, p):
        mx = torch.maximum(mx, torch.where(p == CDEF_VERY_LARGE, -1, p))
        return torch.minimum(mn, p), mx

    sum_sel = torch.zeros_like(px)
    mn_sel = px
    mx_sel = px
    for d in range(8):
        summ = torch.zeros_like(px)
        mn = px
        mx = px
        for k in range(2):
            dy, dx = CDEF_DIRECTIONS[d][k]
            for s in (1, -1):
                p = tap(s * dy, s * dx)
                summ = summ + pt[k] * _constrain(p - px, pri_px, damp_pri)
                mn, mx = minmax(mn, mx, p)
            for off in (2, 6):
                dy2, dx2 = CDEF_DIRECTIONS[(d + off) & 7][k]
                for s in (1, -1):
                    p = tap(s * dy2, s * dx2)
                    summ = summ + st[k] * _constrain(p - px, sec_t, damp_sec)
                    mn, mx = minmax(mn, mx, p)
        m = dir_px == d
        sum_sel = torch.where(m, summ, sum_sel)
        mn_sel = torch.where(m, mn, mn_sel)
        mx_sel = torch.where(m, mx, mx_sel)
    out = px + ((8 + sum_sel - (sum_sel < 0).to(torch.int32)) >> 4)
    return torch.clamp(out, mn_sel, mx_sel)


def cdef_planes(y, u, v, skip8, pri_y: int, sec_y: int, pri_uv: int,
                sec_uv: int, damping: int = 3, bit_depth: int = 8):
    """Apply CDEF to deblocked recon planes (one frame-wide preset).
    skip8: (H/8, W/8) bool, True = unit unfiltered.  pri/sec are the CODED
    header values as host ints (sec 3 means 4); all-zero strengths pass
    the planes through, any other preset is one kernels/cdef.py:cdef_filter
    call."""
    from av1tpu_torch.kernels.cdef import cdef_filter

    pri_y, sec_y, pri_uv, sec_uv = (int(pri_y), int(sec_y), int(pri_uv),
                                    int(sec_uv))
    y32, u32, v32 = (p.to(torch.int32) for p in (y, u, v))
    if not (pri_y or sec_y or pri_uv or sec_uv):
        return y32, u32, v32
    return cdef_filter(y32.contiguous(), u32.contiguous(), v32.contiguous(),
                       skip8.contiguous(), pri_y, sec_y, pri_uv, sec_uv,
                       damping, bit_depth)


def skip16_from_levels(y16, u8, v8):
    """Coded-skip per 16x16 block from the level grids (the packer's
    skip = zy && zu && zv rule)."""
    zy = (y16 == 0).flatten(2).all(dim=2)
    zu = (u8 == 0).flatten(2).all(dim=2)
    zv = (v8 == 0).flatten(2).all(dim=2)
    return zy & zu & zv


def skip8_of(skip16):
    """Per-8x8-CDEF-unit skip: each 16-block's flag covers its 4 units."""
    return rep2d(skip16, 2)


def merge_skip16(skip16, split32, split64):
    """Effective per-16-slot skip under 32/64 NONE merges: a merged
    block's single coded skip covers every slot, and it is skip iff all
    its slots' levels are zero."""
    r16, c16 = skip16.shape
    g32 = skip16.reshape(r16 // 2, 2, c16 // 2, 2).all(dim=3).all(dim=1)
    s = torch.where(rep2d(~split32.to(torch.bool), 2), rep2d(g32, 2), skip16)
    g64 = skip16.reshape(r16 // 4, 4, c16 // 4, 4).all(dim=3).all(dim=1)
    return torch.where(rep2d(~split64.to(torch.bool), 4), rep2d(g64, 4), s)


def skip8_split(skip16, split16, y16, u8, v8):
    """Per-8x8-unit skip when 16-blocks may split into 8x8 sub-blocks:
    each sub-block carries its own coded skip flag (its quadrant of the
    union level slots is all-zero, the packer's rule), while unsplit
    blocks keep the block flag."""
    r16, c16 = skip16.shape

    def q(a, n):
        z = (a.reshape(r16, c16, 2, n, 2, n) == 0).all(dim=5).all(dim=3)
        return z.permute(0, 2, 1, 3).reshape(2 * r16, 2 * c16)

    s8sub = q(y16, 8) & q(u8, 4) & q(v8, 4)
    return torch.where(rep2d(split16.to(torch.bool), 2), s8sub,
                       skip8_of(skip16))


def skip8_host(bitmap: np.ndarray, height: int, width: int,
               split32=None, split64=None) -> np.ndarray:
    """Copy of av1tpu/models/cdef_tpu.py:skip8_host: host-side skip8 from
    a compact significance bitmap (the per-slot [y16 | u8 | v8] flat
    layout).  Split maps (partitioned layouts) apply the 32/64 merge
    rule."""
    r16, c16 = height // 16, width // 16
    nb = r16 * c16
    ncoef = nb * 256 + 2 * nb * 64
    sig = np.unpackbits(bitmap.view(np.uint8), bitorder="little")[:ncoef]
    ny = nb * 256
    y_nz = sig[:ny].reshape(nb, 256).any(axis=1)
    u_nz = sig[ny : ny + nb * 64].reshape(nb, 64).any(axis=1)
    v_nz = sig[ny + nb * 64 :].reshape(nb, 64).any(axis=1)
    s16 = (~(y_nz | u_nz | v_nz)).reshape(r16, c16)
    if split32 is not None:
        s16 = merge_skip16(torch.from_numpy(s16),
                           torch.from_numpy(np.asarray(split32)),
                           torch.from_numpy(np.asarray(split64))).numpy()
    return np.repeat(np.repeat(s16, 2, 0), 2, 1)


def cdef_fused(ref_fused, skip8, cdef_s, height: int, width: int,
               damping: int = 3, bit_depth: int = 8):
    """CDEF of a fused [y|u|v] recon.  cdef_s: 4 coded strengths."""
    y, u, v = unfuse(ref_fused, height, width)
    yy, uu, vv = cdef_planes(y, u, v, skip8, *[int(s) for s in cdef_s],
                             damping, bit_depth)
    return torch.cat([yy.reshape(-1), uu.reshape(-1), vv.reshape(-1)])


def cdef_sse_fused(ref_fused, src_fused, skip8, cdef_s, height: int,
                   width: int, damping: int = 3, bit_depth: int = 8):
    """Sum of squared error (float32) of the CDEF'd recon vs the source
    over all planes: the per-preset score of the strength search."""
    y, u, v = unfuse(ref_fused, height, width)
    sy, su, sv = unfuse(src_fused, height, width)
    yy, uu, vv = cdef_planes(y, u, v, skip8, *[int(s) for s in cdef_s],
                             damping, bit_depth)

    def e(a, b):
        d = (a - b).to(torch.float32)
        return (d * d).sum()

    return e(yy, sy) + e(uu, su) + e(vv, sv)


def select_strengths(ref_fused, src_fused, skip8, height: int, width: int,
                     bit_depth: int = 8) -> np.ndarray:
    """Frame-level CDEF strength search: the preset with least distortion
    vs the source (first minimum = weakest preset on ties)."""
    sses = torch.stack([cdef_sse_fused(ref_fused, src_fused, skip8, p,
                                       height, width, 3, bit_depth)
                        for p in CDEF_PRESETS])
    return CDEF_PRESETS[int(torch.argmin(sses))]
