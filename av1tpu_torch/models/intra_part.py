"""Intra pipeline with 64/32/16 partition RDO (port of
av1tpu/models/intra_part.py: the quality preset's q probe).

The frame is processed in 32-luma-pixel block rows; within each, both
16x16 candidates (two RDO'd 16-rows, V/D45/D67 per block) and a 32x32
candidate are coded, and each 32x32 region picks NONE vs SPLIT by
pixel-domain rate-distortion cost; a third level tries one 64x64 V_PRED
block per superblock.  Chroma block size follows the luma choice, so both
the 8x8 two-row and the 16x16 one-row chroma codings are computed and
selected by the split grid (and 32x32 where the 64 won).

The reference's scans over block rows are a loop of stages here, each one
call of the hand kernels of kernels/intra_part.py (on the CPU their plain
versions): `part_chain` codes the first block row's serial chains of all
three planes; then per stage `part_pred` builds every candidate from the
row above, a matmul per site takes the forward product (as the reference
leaves it to XLA), and `part_code` codes the candidates; `part_merge`
decides the splits of each 32-row (chroma 16-row) and, after a
superblock's second one, the 64.  The outputs are written straight into
the frame's grids, so the row above a stage is a row of the recon plane.
Per superblock row a plane runs four such stages and two merges; U and V
run in the same calls.

Scalar lambdas are float32 values computed on the host as the reference's
compiled graph computes them: XLA folds a chain of constant factors into
one float32 constant (`fold_consts`) and turns a division by a constant
into a product with its float32 reciprocal.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from av1tpu_torch.kernels.intra_part import (
    COST_COEF, COST_NONE, COST_PIXEL, ChainJob, CodeJob, MergeJob, PartSite,
    PredJob, part_chain, part_code, part_merge, part_pred,
)
from av1tpu_torch.models.intra_v import (
    LAM_PIX, _UR_MASK, _plane_params, ac_squared, fold_consts,
)
from av1tpu_torch.state import tables

f32 = np.float32

_RATIO = {16: 6.4, 32: 1.51, 64: 1.51}  # 64 shares the shift-(2,4) scaling
_SPLIT_OVERHEAD_BITS = 12.0  # extra signaling of 4 blocks vs 1


def _avail16_grid(rows: int, cols: int) -> np.ndarray:
    g = np.zeros((rows, cols), np.bool_)
    for r in range(1, rows):
        g[r] = _UR_MASK[r % 4][np.arange(cols) % 4]
    g[:, cols - 1] = False
    return g


def _avail32_grid(rows32: int, cols32: int) -> np.ndarray:
    # 32-blocks form 2x2 per SB; Z-order: only the SB's bottom-right 32
    # lacks above-right (plus the frame's last column / first row)
    m = np.array([[1, 1], [1, 0]], np.bool_)
    g = np.zeros((rows32, cols32), np.bool_)
    for r in range(1, rows32):
        g[r] = m[r % 2][np.arange(cols32) % 2]
    g[:, cols32 - 1] = False
    return g


def _avail64_grid(rows64: int, cols64: int) -> np.ndarray:
    # above-right of a 64 block = the next SB at the fully-decoded row above
    g = np.zeros((rows64, cols64), np.bool_)
    g[1:, : cols64 - 1] = True
    return g


class _Sites:
    """The probe's coding sites at one q and bit depth, each built at its
    first use (a site's rd_zero gains need its forward matrix), and the
    lambdas."""

    def __init__(self, qindex: int, bit_depth: int, device):
        from av1tpu_torch.models.rates import qctx_index

        self.T = tables(device)
        self.qindex, self.bit_depth, self.qctx = (qindex, bit_depth,
                                                  qctx_index(qindex))
        a2 = ac_squared(qindex, bit_depth, device)
        self.lam = f32(a2 * f32(LAM_PIX))
        self.lam_split = f32(a2 * fold_consts(LAM_PIX, _SPLIT_OVERHEAD_BITS))

    def _site(self, n: int, tx: int, nm: int, rows: int, shift: int,
              cost: int, rate=None) -> PartSite:
        """rows: the quantizer rows' size; rate: (rate table size, plane
        type, gains' tx type) for rd_zero, or None."""
        step, q, cap = _plane_params(self.qindex, rows, self.bit_depth,
                                     self.T.device)
        tab = gains = None
        if rate is not None:
            tab = self.T.rate_tabs(rate[0], rate[1])[self.qctx]
            gains = self.T.coef_gains(n, rate[2])
        return PartSite(
            n=n, tx=tx, nm=nm, step=step * (0.5 ** shift) if shift else step,
            q=q, cap=cap, tab=tab, gains=gains, lam=self.lam, dq_shift=shift,
            cost=cost, bit_depth=self.bit_depth,
            inv_ratio=(f32(1.0) / f32(_RATIO[n]) if cost == COST_COEF
                       else None))

    @functools.cached_property
    def y_chain(self) -> PartSite:      # luma's first 16-row: no rd_zero
        return self._site(16, 0, 1, 16, 0, COST_NONE)

    @functools.cached_property
    def y16(self) -> PartSite:
        return self._site(16, 0, 3, 16, 0, COST_COEF, (16, 0, 0))

    @functools.cached_property
    def y32(self) -> PartSite:
        return self._site(32, 0, 3, 32, 1, COST_COEF, (32, 0, 0))

    @functools.cached_property
    def y64(self) -> PartSite:
        # 1024 coded coefficients, dc at [0]: the 32x32-shaped quantizer
        # rows; effective step q/4 (TX_64X64 dequant shift 2)
        return self._site(64, 0, 1, 32, 2, COST_PIXEL, (64, 0, 0))

    @functools.cached_property
    def c8(self) -> PartSite:           # ADST_DCT (uv V_PRED); the chain's
        return self._site(8, 1, 1, 8, 0, COST_NONE, (8, 1, 1))

    @functools.cached_property
    def c16(self) -> PartSite:
        return self._site(16, 1, 1, 16, 0, COST_NONE, (16, 1, 1))

    @functools.cached_property
    def c32(self) -> PartSite:          # chroma 32: derived DCT, shift 1
        return self._site(32, 0, 1, 32, 1, COST_NONE, (32, 1, 0))


def _sites(qindex: int, bit_depth: int, device) -> _Sites:
    """The sites of (q, bit depth) on `device`, kept with its tables."""
    return tables(device).const(("part_sites", qindex, bit_depth),
                                lambda dev: _Sites(qindex, bit_depth, dev))


def _site_jobs(site: PartSite, fwdt, bottom, src, av, resid, pred, lv,
               rec, modes=None, cost=None):
    """One site of a stage: its PredJob, its forward matrix and its
    CodeJob, whose coefficients _stage fills in."""
    return (PredJob(bottom, src, av, resid, pred), fwdt,
            CodeJob(site, None, pred, src, lv, rec, modes, cost))


def _stage(sites) -> None:
    """The candidates of every site from the row above, their forward
    products, then their coding."""
    part_pred([p for p, _, _ in sites])
    part_code([c._replace(coefs=p.resid @ f) for p, f, c in sites])


def _halves(rows64: int):
    """(superblock row, half) of every 32-row (chroma 16-row) after frame
    row 0, whose first half is the chains' and its bottom 16-row's."""
    return [(s, h) for s in range(rows64) for h in (0, 1) if s or h]


def part_launches(height: int, width: int) -> dict:
    """Each probe kernel's launches per frame of height x width: one
    part_chain; per plane group (luma; U and V) a part_pred and a
    part_code per stage, a part_merge per 32-row (chroma 16-row) after
    frame row 0's first."""
    halves = len(_halves(height // 64))
    stages = 2 * (1 + 2 * halves)
    return {"part_chain": 1, "part_pred": stages, "part_code": stages,
            "part_merge": 2 * halves}


def _luma_rows(y, S: _Sites, g: dict) -> None:
    """Luma after the first 16-row: every stage and merge, into g."""
    h, w = y.shape
    dev = y.device
    T = tables(dev)
    c16, c32, c64 = w // 16, w // 32, w // 64
    av16, av32, av64 = T.const(("part_av", h, w), lambda d: tuple(
        torch.as_tensor(f(h // n, w // n), device=d) for f, n in (
            (_avail16_grid, 16), (_avail32_grid, 32), (_avail64_grid, 64))))

    def buf(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    res16, pred16 = buf((3 * c16, 256)), buf((3 * c16, 256), torch.int32)
    res32, pred32 = buf((3 * c32, 1024)), buf((3 * c32, 1024), torch.int32)
    res64, pred64 = buf((c64, 4096)), buf((c64, 4096), torch.int32)
    rec32, rec64 = buf((32, w), torch.int32), buf((64, w), torch.int32)
    cost16, cost32, cost64 = buf((2, c16)), buf((c32,)), buf((c64,))
    region = buf((2, c32))
    ry = g["recon_y"]

    def e16(r, k):     # the 16-row r, top (k 0) or bottom of its 32-row
        return _site_jobs(S.y16, T.fwdt(16, 0), ry[16 * r - 1],
                          y[16 * r:16 * r + 16], av16[r], res16, pred16,
                          g["levels_y16"][r], ry[16 * r:16 * r + 16],
                          g["modes16"][r], cost16[k])

    def e32(r):
        return _site_jobs(S.y32, T.fwdt(32, 0), ry[32 * r - 1],
                          y[32 * r:32 * r + 32], av32[r], res32, pred32,
                          g["levels_y32"][r], rec32, g["modes32"][r],
                          cost32)

    def e64(s):
        return _site_jobs(S.y64, T.fwd64t(), ry[64 * s - 1],
                          y[64 * s:64 * s + 64], None, res64, pred64,
                          g["levels_y64"][s], rec64, None, cost64)

    _stage([e16(1, 1)])
    for s, half in _halves(h // 64):
        r = 2 * s + half
        _stage([e16(2 * r, 0), e32(r)] + ([e64(s)] if half == 0 else []))
        _stage([e16(2 * r + 1, 1)])
        part_merge([MergeJob(
            g["levels_y16"], g["levels_y32"], g["levels_y64"], ry, rec32,
            rec64, g["split"], g["split64"], s, half, half == 1 and s > 0,
            src=y, cost_s=cost16, cost_m=cost32, cost_b=cost64,
            cost_region=region, lam=S.lam, lam_split=S.lam_split)])


def _chroma_rows(uv, S: _Sites, g: dict) -> None:
    """U and V (stacked) after the first 8-row, following luma's split
    and split64 grids in g: every stage and merge, both planes per call."""
    _, h, w = uv.shape
    dev = uv.device
    T = tables(dev)
    c8, c16, c32 = w // 8, w // 16, w // 32

    def buf(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=dev)

    res8, pred8 = buf((2, c8, 64)), buf((2, c8, 64), torch.int32)
    res16, pred16 = buf((2, c16, 256)), buf((2, c16, 256), torch.int32)
    res32, pred32 = buf((2, c32, 1024)), buf((2, c32, 1024), torch.int32)
    rec16, rec32 = buf((2, 16, w), torch.int32), buf((2, 32, w), torch.int32)
    rc, lv8, lv16, lv32 = (g[k] for k in ("recon_uv", "levels_uv8",
                                           "levels_uv16", "levels_uv32"))

    def e8(p, r):
        return _site_jobs(S.c8, T.fwdt(8, 1), rc[p, 8 * r - 1],
                          uv[p, 8 * r:8 * r + 8], None, res8[p], pred8[p],
                          lv8[p, r], rc[p, 8 * r:8 * r + 8])

    def e16(p, r):
        return _site_jobs(S.c16, T.fwdt(16, 1), rc[p, 16 * r - 1],
                          uv[p, 16 * r:16 * r + 16], None, res16[p],
                          pred16[p], lv16[p, r], rec16[p])

    def e32(p, s):
        return _site_jobs(S.c32, T.fwdt(32, 0), rc[p, 32 * s - 1],
                          uv[p, 32 * s:32 * s + 32], None, res32[p],
                          pred32[p], lv32[p, s], rec32[p])

    _stage([e8(p, 1) for p in (0, 1)])
    for s, half in _halves(h // 32):
        r = 2 * s + half
        _stage([e8(p, 2 * r) for p in (0, 1)]
               + [e16(p, r) for p in (0, 1)]
               + ([e32(p, s) for p in (0, 1)] if half == 0 else []))
        _stage([e8(p, 2 * r + 1) for p in (0, 1)])
        part_merge([MergeJob(lv8[p], lv16[p], lv32[p], rc[p], rec16[p],
                             rec32[p], g["split"], g["split64"], s, half,
                             half == 1 and s > 0) for p in (0, 1)])


def _merge_quads(small, big, n: int):
    """Scatter (r_big, c_big, 2n, 2n) winner blocks into the zeroed
    (r, c, n, n) grid as raster quadrants (slots are disjoint since the
    losing branch was zeroed)."""
    rb, cb = big.shape[0], big.shape[1]
    quads = (big.reshape(rb, cb, 2, n, 2, n).permute(0, 2, 1, 4, 3, 5)
             .reshape(rb * 2, cb * 2, n, n))
    return small + quads


def _embed64(y16, lv64):
    """Scatter each SB's 64-winner coded 32x32 as 2x2 quadrants into the
    SB's top-left 16-slots (the rest of the SB's slots are zero)."""
    rb, cb = lv64.shape[:2]
    quads = (lv64.reshape(rb, cb, 2, 16, 2, 16)
             .permute(0, 2, 1, 4, 3, 5))          # (rb, 2, cb, 2, 16, 16)
    emb = torch.zeros((rb, 4, cb, 4, 16, 16), dtype=lv64.dtype,
                      device=lv64.device)
    emb[:, :2, :, :2] = quads
    return y16 + emb.reshape(rb * 4, cb * 4, 16, 16)


def _merge_tiles4(small, big, n: int):
    """Scatter (rb, cb, 4n, 4n) winner blocks as a 4x4 grid of n x n tiles
    into the zeroed (rb*4, cb*4, n, n) slot grid."""
    rb, cb = big.shape[:2]
    tiles = (big.reshape(rb, cb, 4, n, 4, n).permute(0, 2, 1, 4, 3, 5)
             .reshape(rb * 4, cb * 4, n, n))
    return small + tiles


def encode_intra_part(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                      qindex: int, bit_depth: int = 8):
    """Full-frame intra encode with 64/32/16 partition RDO.  Dims must be
    64-multiples.  Returns level grids per size, modes, split maps and
    reconstructions."""
    y = y.to(torch.int32).contiguous()
    uv = torch.stack([u, v]).to(torch.int32)
    h, w = y.shape
    dev = y.device
    S = _sites(qindex, bit_depth, dev)
    T = tables(dev)

    def grid(shape, dtype=torch.int16, fill=0):
        return torch.full(shape, fill, dtype=dtype, device=dev)

    # frame row 0 forces SPLIT, and row 0 of the 32 and 64 grids (chroma
    # 16 and 32) stays zero, V_PRED and split
    g = {"levels_y16": grid((h // 16, w // 16, 16, 16)),
         "levels_y32": grid((h // 32, w // 32, 32, 32)),
         "levels_y64": grid((h // 64, w // 64, 32, 32)),
         "modes16": grid((h // 16, w // 16), torch.int8, 1),
         "modes32": grid((h // 32, w // 32), torch.int8, 1),
         "split": grid((h // 32, w // 32), torch.bool, True),
         "split64": grid((h // 64, w // 64), torch.bool, True),
         "levels_uv8": grid((2, h // 16, w // 16, 8, 8)),
         "levels_uv16": grid((2, h // 32, w // 32, 16, 16)),
         "levels_uv32": grid((2, h // 64, w // 64, 32, 32)),
         "recon_y": torch.empty((h, w), dtype=torch.int32, device=dev),
         "recon_uv": torch.empty((2, h // 2, w // 2), dtype=torch.int32,
                                 device=dev)}
    part_chain([ChainJob(S.y_chain, T.fwdt(16, 0), y[:16],
                         g["levels_y16"][0], g["recon_y"][:16])]
               + [ChainJob(S.c8, T.fwdt(8, 1), uv[p, :8],
                           g["levels_uv8"][p, 0], g["recon_uv"][p, :8])
                  for p in (0, 1)])
    _luma_rows(y, S, g)
    _chroma_rows(uv, S, g)
    out = {k: g[k] for k in ("levels_y16", "levels_y32", "levels_y64",
                             "modes16", "modes32", "split", "split64",
                             "recon_y")}
    for p, c in enumerate("uv"):
        out.update({f"levels_{c}8": g["levels_uv8"][p],
                    f"levels_{c}16": g["levels_uv16"][p],
                    f"levels_{c}32": g["levels_uv32"][p],
                    f"recon_{c}": g["recon_uv"][p]})
    return out


def _part_compact_and_recon(frame: torch.Tensor, qindex: int, height: int,
                            width: int, cap: int, lf=None,
                            bit_depth: int = 8):
    """encode_intra_part of a fused [y | u | v] source, in the compact
    transport of the union layout: the 32x32 (chroma 16x16) winners'
    levels scattered into the losing branch's zeroed 16x16 (8x8) slots as
    raster quadrants, the 64x64 winners into their superblock's top-left
    slots, so that the transport has the fast path's size plus the meta
    arrays.  Buffer: [count_lo, count_hi, bitmap, values (cap), modes16,
    modes32, split, split64].  lf: optional (ly, lu, lv) levels; the recon
    is then deblocked with the merged 32/64 interior edges gated off.
    Returns (int16 buffer, fused int32 recon)."""
    from av1tpu_torch.models.intra_v import compact_buffer, unfuse

    o = encode_intra_part(*unfuse(frame, height, width), qindex,
                          bit_depth=bit_depth)
    y16 = _embed64(_merge_quads(o["levels_y16"], o["levels_y32"], 16),
                   o["levels_y64"])
    u8 = _merge_tiles4(_merge_quads(o["levels_u8"], o["levels_u16"], 8),
                       o["levels_u32"], 8)
    v8 = _merge_tiles4(_merge_quads(o["levels_v8"], o["levels_v16"], 8),
                       o["levels_v32"], 8)
    flat = torch.cat([y16.reshape(-1), u8.reshape(-1), v8.reshape(-1)])
    buf = compact_buffer(flat, (o["modes16"], o["modes32"], o["split"],
                                o["split64"]), cap)
    rcy, rcu, rcv = o["recon_y"], o["recon_u"], o["recon_v"]
    if lf is not None and any(lf):
        from av1tpu_torch.models.deblock import deblock_planes, edge_gates_j
        v_on, h_on = edge_gates_j(o["split"], o["split64"], height // 16,
                                  width // 16)
        rcy, rcu, rcv = deblock_planes(rcy, rcu, rcv, v_on, h_on,
                                       lf[0], lf[1], lf[2], 0, bit_depth)
    recon = torch.cat([rcy.reshape(-1), rcu.reshape(-1),
                       rcv.reshape(-1)]).to(torch.int32)
    return buf, recon


def encode_intra_part_compact(frame: torch.Tensor, qindex: int, height: int,
                              width: int, cap: int = 163840,
                              bit_depth: int = 8) -> torch.Tensor:
    """The compact transport buffer of _part_compact_and_recon."""
    return _part_compact_and_recon(frame, qindex, height, width, cap,
                                   bit_depth=bit_depth)[0]


def encode_intra_key_recon(frame: torch.Tensor, qindex: int, height: int,
                           width: int, cap: int = 163840, lf=None,
                           bit_depth: int = 8):
    """Partitioned keyframe: compact transport + fused int32 recon,
    deblocked in-loop when lf gives (ly, lu, lv) levels."""
    return _part_compact_and_recon(frame, qindex, height, width, cap, lf=lf,
                                   bit_depth=bit_depth)


def encode_intra_part_chunk(frames: torch.Tensor, qindex: int, height: int,
                            width: int, cap: int = 163840,
                            bit_depth: int = 8) -> torch.Tensor:
    """All-intra chunk of the quality preset: (K, n_pixels) fused sources
    -> (K, compact_len) int16, one encode_intra_part_compact per frame."""
    return torch.stack([encode_intra_part_compact(f, qindex, height, width,
                                                  cap, bit_depth)
                        for f in frames])


def part_sizes(height: int, width: int):
    """Copy of av1tpu/models/intra_part.py:part_sizes: block counts at
    16/32/64 and the union layout's coefficient count."""
    r16, c16 = height // 16, width // 16
    r32, c32 = height // 32, width // 32
    r64, c64 = height // 64, width // 64
    ncoef = r16 * c16 * 256 + 2 * r16 * c16 * 64  # union layout
    return r16 * c16, r32 * c32, r64 * c64, ncoef


def split_compact_part(buf: np.ndarray, height: int, width: int):
    """Copy of av1tpu/models/intra_part.py:split_compact_part (host numpy):
    (count, bitmap u16, vals i16, modes16, modes32, split, split64)."""
    nb16, nb32, nb64, ncoef = part_sizes(height, width)
    nwords = ncoef // 16
    count = int(buf[0]) | (int(buf[1]) << 15)
    bitmap = buf[2 : 2 + nwords].view(np.uint16)
    tail = nb16 + 2 * nb32 + nb64
    vals = buf[2 + nwords : len(buf) - tail]
    meta = buf[len(buf) - tail :]
    return (count, bitmap, vals, meta[:nb16], meta[nb16 : nb16 + nb32],
            meta[nb16 + nb32 : nb16 + 2 * nb32], meta[nb16 + 2 * nb32 :])
