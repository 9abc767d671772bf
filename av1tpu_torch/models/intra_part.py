"""Intra pipeline with 64/32/16 partition RDO (port of
av1tpu/models/intra_part.py: the quality preset's q probe).

The frame is processed in 32-luma-pixel block rows; within each, both
16x16 candidates (two RDO'd 16-rows, V/D45/D67 per block) and a 32x32
candidate are coded, and each 32x32 region picks NONE vs SPLIT by
pixel-domain rate-distortion cost; a third level tries one 64x64 V_PRED
block per superblock.  Chroma block size follows the luma choice, so both
the 8x8 two-row and the 16x16 one-row chroma codings are computed and
selected by the split grid (and 32x32 where the 64 won).

The reference's scans over block rows are Python loops here that carry the
bottom pixel row on the device.  The first frame row's per-column chain of
the luma plane is the hand kernel's function (product, quantize, dequantize;
nothing reads the coefficients afterwards), so on CUDA it launches
kernels/transform_quant.py once per column.

Scalar lambdas are float32 values computed on the host as the reference's
compiled graph computes them: XLA folds a chain of constant factors into
one float32 constant (`fold_consts`) and turns a division by a constant
into a product with its float32 reciprocal.
"""

from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.kernels.transform_quant import TQPlane, transform_quantize
from av1tpu_torch.models.intra_v import (
    LAM_PIX, _RDO_MODES, _UR_MASK, _directional_pred, _plane_params,
    ac_squared, fold_consts, from_blocks, log2_rate, quantize_coefs,
    to_blocks,
)
from av1tpu_torch.models.rdoq import rd_zero
from av1tpu_torch.ops.transforms import inverse_transform
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


def _edges(bottom: torch.Tensor, av: torch.Tensor, n: int, cols: int):
    """(cols, 2n) above edges with above-right from a full-width bottom
    row carry, replicated where unavailable."""
    dev = bottom.device
    padded = torch.cat([bottom, bottom[-1:].expand(n)])
    win, k_lt_n = tables(dev).const(("edges", n, cols), lambda d: (
        torch.as_tensor(np.arange(cols)[:, None] * n
                        + np.arange(2 * n)[None, :], device=d),
        torch.arange(2 * n, device=d)[None, :] < n))
    ae = padded[win]
    repl = ae[:, n - 1][:, None]
    return torch.where(k_lt_n | av[:, None], ae, repl)


def _mode_rdo(blocks, ae, consts):
    """Shared V/D45/D67 RD selection for one row of n x n blocks.
    Returns (lv int32 (cols,n,n), pred (cols,n,n), modes int8, cost_pix)."""
    n, fwdt, step_eff, cap, lam_pix, tab, gains = consts
    dev = blocks.device
    cols = blocks.shape[0]
    pred_v = ae[:, None, :n].expand(cols, n, n)
    cands = [pred_v] + [_directional_pred(ae, dx, n) for _, dx in _RDO_MODES]
    nm = len(cands)
    preds = torch.cat(cands, dim=0)
    blocks_r = blocks.repeat(nm, 1, 1)
    resid = (blocks_r - preds).reshape(nm * cols, n * n).to(torch.float32)
    coefs = resid @ fwdt
    lv_all = quantize_coefs(coefs, step_eff, cap)
    if tab is not None:
        lv_all = rd_zero(lv_all, coefs, step_eff, lam_pix, tab, gains)
    d = coefs - lv_all * step_eff
    # the compiled reference multiplies by the float32 reciprocal
    dist = ((d * d).sum(dim=1)
            * float(f32(1.0) / f32(_RATIO[n]))).reshape(nm, -1)
    rate = log2_rate(lv_all, 1).reshape(nm, -1)
    mode_vals, mode_bits = tables(dev).const("part_modes", lambda dv: (
        torch.tensor([1] + [m for m, _ in _RDO_MODES], dtype=torch.int8,
                     device=dv),
        torch.tensor([0.0] + [4.0] * len(_RDO_MODES), dtype=torch.float32,
                     device=dv)[:, None]))
    rate = rate + mode_bits
    cost = dist + lam_pix * rate
    choice = torch.argmin(cost, dim=0)
    sel = choice[None, :, None, None].expand(1, cols, n, n)
    lv = torch.gather(lv_all.reshape(nm, cols, n, n), 0, sel)[0]
    pred = torch.gather(preds.reshape(nm, cols, n, n), 0, sel)[0]
    best = torch.gather(cost, 0, choice[None])[0]
    return lv, pred, mode_vals[choice], best


def _recon16(lv, pred, q, pix_max):
    r = inverse_transform(lv * q.reshape(16, 16), 16, 16, 0)
    return torch.clamp(pred + r, 0, pix_max)


def _dq_shift(lv, q, shift: int):
    """sign(lv) * ((|lv| * q) >> shift): the decoder's 32/64 dequant."""
    return torch.sign(lv) * ((lv.abs() * q) >> shift)


def _recon32(lv, pred, q, pix_max):
    r = inverse_transform(_dq_shift(lv, q.reshape(32, 32), 1), 32, 32, 0)
    return torch.clamp(pred + r, 0, pix_max)


def _as_small(rec, f: int, n: int):
    """(cols_big, f*n, f*n) blocks -> (f, cols_big*f, n, n): the big
    blocks' pixels as f rows of n x n blocks."""
    cb = rec.shape[0]
    return (rec.reshape(cb, f, n, f, n).permute(1, 0, 3, 2, 4)
            .reshape(f, cb * f, n, n))


def _encode_luma_part(src: torch.Tensor, qindex: int, bit_depth: int = 8):
    """Returns (lv16 (r16,c16,16,16) i16, lv32 (r32,c32,32,32) i16,
    modes16 i8, modes32 i8, split (r32,c32) bool, recon, lv64 (r64,c64,
    32,32) i16, split64 (r64,c64) bool)."""
    h, w = src.shape
    dev = src.device
    rows16, cols16 = h // 16, w // 16
    rows32, cols32 = h // 32, w // 32
    pix_max = (1 << bit_depth) - 1
    base = 1 << (bit_depth - 1)
    T = tables(dev)

    from av1tpu_torch.models.rates import qctx_index

    fwd16t, fwd32t = T.fwdt(16, 0), T.fwdt(32, 0)
    step16, q16, cap16 = _plane_params(qindex, 16, bit_depth, dev)
    step32, q32, cap32 = _plane_params(qindex, 32, bit_depth, dev)
    a2 = ac_squared(qindex, bit_depth, dev)
    lam_pix = float(f32(a2 * f32(LAM_PIX)))
    lam_split = float(f32(a2 * fold_consts(LAM_PIX, _SPLIT_OVERHEAD_BITS)))
    qctx = qctx_index(qindex)
    c16 = (16, fwd16t, step16, cap16, lam_pix, T.rate_tabs(16, 0)[qctx],
           T.coef_gains(16))
    c32 = (32, fwd32t, step32 * 0.5, cap32, lam_pix,   # dequant shift 1
           T.rate_tabs(32, 0)[qctx], T.coef_gains(32))

    src16 = to_blocks(src, 16)
    src32 = to_blocks(src, 32)
    av16 = torch.as_tensor(_avail16_grid(rows16, cols16), device=dev)
    av32 = torch.as_tensor(_avail32_grid(rows32, cols32), device=dev)

    def rdo16_row(bottom, blocks, av):
        ae = _edges(bottom, av, 16, cols16)
        lv, pred, modes, cost = _mode_rdo(blocks, ae, c16)
        return lv, _recon16(lv, pred, q16, pix_max), modes, cost

    # ---- frame row 0: forced SPLIT; top 16-row is the sequential chain,
    # one transform_quantize launch per column ----
    plane = TQPlane(fwd16t, step16[None], q16[None], cap16[None])
    edge = torch.full((1, 1), base - 1, dtype=torch.int32, device=dev)
    lv0, rec0 = [], []
    for c in range(cols16):
        resid = (src16[0, c] - edge).reshape(1, 256).to(torch.float32)
        lv, dq = transform_quantize(resid, plane)
        rec = torch.clamp(edge + inverse_transform(dq.reshape(16, 16), 16,
                                                   16, 0), 0, pix_max)
        edge = rec[:1, 15:]
        lv0.append(lv.reshape(16, 16))
        rec0.append(rec)
    lv_r0t, rec_r0t = torch.stack(lv0), torch.stack(rec0)
    lv_r0b, rec_r0b, modes_r0b, _ = rdo16_row(
        rec_r0t[:, 15, :].reshape(-1), src16[1], av16[1])
    row0 = {
        "lv16": torch.stack([lv_r0t, lv_r0b.to(torch.int16)]),
        "modes16": torch.stack([torch.full((cols16,), 1, dtype=torch.int8,
                                           device=dev), modes_r0b]),
        "rec": torch.stack([rec_r0t, rec_r0b]),
        "split": torch.ones((cols32,), dtype=torch.bool, device=dev),
        "lv32": torch.zeros((cols32, 32, 32), dtype=torch.int16, device=dev),
        "modes32": torch.full((cols32,), 1, dtype=torch.int8, device=dev),
    }

    def row32_step(bottom, xs):
        blocks16_t, blocks16_b, blocks32, av_t, av_b, av3 = xs
        lv_t, rec_t, modes_t, cost_t = rdo16_row(bottom, blocks16_t, av_t)
        lv_b, rec_b, modes_b, cost_b = rdo16_row(
            rec_t[:, 15, :].reshape(-1), blocks16_b, av_b)
        ae32 = _edges(bottom, av3, 32, cols32)
        lv32, pred32, modes32, cost32 = _mode_rdo(blocks32, ae32, c32)
        rec32 = _recon32(lv32, pred32, q32, pix_max)

        cost_16s = (cost_t.reshape(cols32, 2).sum(1)
                    + cost_b.reshape(cols32, 2).sum(1) + lam_split)
        split = cost_16s < cost32                       # (cols32,)

        # zero the losing branch's levels
        s4 = split.repeat_interleave(2)
        lv_t = torch.where(s4[:, None, None], lv_t, 0).to(torch.int16)
        lv_b = torch.where(s4[:, None, None], lv_b, 0).to(torch.int16)
        lv32 = torch.where(split[:, None, None], 0, lv32).to(torch.int16)

        # carry: bottom pixel row from the winning branch
        bot16 = rec_b[:, 15, :].reshape(cols32, 32)
        carry = torch.where(split[:, None], bot16, rec32[:, 31, :]).reshape(-1)
        rec16_pair = torch.stack([rec_t, rec_b])
        rec = torch.where(s4[None, :, None, None], rec16_pair,
                          _as_small(rec32, 2, 16))
        # exact pixel-domain cost of the SELECTED coding per region, so the
        # 64x64 comparison (whose distortion is also pixel-exact) is fair
        blocks_pair = torch.stack([blocks16_t, blocks16_b])
        e = rec - blocks_pair
        d_sel = (e * e).sum(dim=(0, 2, 3)).to(torch.float32)
        d_region = d_sel.reshape(cols32, 2).sum(1)
        lv16_pair = torch.stack([lv_t, lv_b])
        r16 = log2_rate(lv16_pair, (0, 2, 3)).reshape(cols32, 2).sum(1)
        r32 = log2_rate(lv32, (1, 2))
        cost_region = d_region + lam_pix * (r16 + r32)
        return carry, {"lv16": lv16_pair,
                       "modes16": torch.stack([modes_t, modes_b]),
                       "rec": rec, "split": split, "lv32": lv32,
                       "modes32": modes32, "cost": cost_region}

    # ---- third level: one 64x64 V_PRED candidate per superblock ----
    cols64 = cols32 // 2
    rows64 = rows32 // 2
    # 1024 coded coefficients, dc at [0]: reuse the 32x32-shaped quantizer
    # rows; effective step is q/4 (TX_64X64 dequant shift 2)
    step64 = step32 * 0.25
    tab64 = T.rate_tabs(64, 0)[qctx]
    src64 = to_blocks(src, 64)
    # above-right of a 64 block = the next SB at the fully-decoded row above
    av64_np = np.zeros((rows64, cols64), np.bool_)
    av64_np[1:, : cols64 - 1] = True
    av64 = torch.as_tensor(av64_np, device=dev)

    def sb_step(bottom, xs):
        xs_a, xs_b, blocks64, av6 = xs
        c1, o1 = row32_step(bottom, xs_a)
        c2, o2 = row32_step(c1, xs_b)

        ae64 = _edges(bottom, av6, 64, cols64)
        pred64 = ae64[:, None, :64].expand(cols64, 64, 64)
        resid = (blocks64 - pred64).reshape(cols64, 4096).to(torch.float32)
        coefs = resid @ T.fwd64t()                 # (cols64, 1024)
        lv64 = quantize_coefs(coefs, step64, cap32)
        lv64 = rd_zero(lv64, coefs, q32.to(torch.float32) * 0.25, lam_pix,
                       tab64, T.coef_gains(64))
        full = torch.zeros((cols64, 64, 64), dtype=torch.int32, device=dev)
        full[:, :32, :32] = _dq_shift(lv64, q32, 2).reshape(cols64, 32, 32)
        rec64 = torch.clamp(pred64 + inverse_transform(full, 64, 64, 0),
                            0, pix_max)
        # 64 distortion must be pixel-domain: the truncated high frequencies
        # are invisible in the coefficient domain
        e = rec64 - blocks64
        d64 = (e * e).sum(dim=(1, 2)).to(torch.float32)
        cost64 = d64 + lam_pix * log2_rate(lv64, 1)
        cost_sub = (o1["cost"].reshape(cols64, 2).sum(1)
                    + o2["cost"].reshape(cols64, 2).sum(1) + lam_split)
        split64 = cost_sub < cost64                # (cols64,) True = split

        lv64 = torch.where(split64[:, None], 0, lv64).to(torch.int16)
        # zero the sub-level grids where the 64 wins
        k2 = split64.repeat_interleave(2)          # per 32-region
        k4 = split64.repeat_interleave(4)          # per 16-col
        outs = []
        for o in (o1, o2):
            o = dict(o)
            o["lv16"] = torch.where(k4[None, :, None, None], o["lv16"], 0)
            o["lv32"] = torch.where(k2[:, None, None], o["lv32"], 0)
            o["split"] = o["split"] & k2
            outs.append(o)
        # carry + recon rows from the winner
        carry = torch.where(split64[:, None], c2.reshape(cols64, 64),
                            rec64[:, 63, :]).reshape(-1)
        rec_sub = torch.cat([outs[0]["rec"], outs[1]["rec"]], dim=0)
        rec = torch.where(k4[None, :, None, None], rec_sub,
                          _as_small(rec64, 4, 16))
        ys = {"lv16": torch.cat([outs[0]["lv16"], outs[1]["lv16"]]),
              "modes16": torch.cat([outs[0]["modes16"], outs[1]["modes16"]]),
              "rec": rec,
              "split": torch.stack([outs[0]["split"], outs[1]["split"]]),
              "lv32": torch.stack([outs[0]["lv32"], outs[1]["lv32"]]),
              "modes32": torch.stack([outs[0]["modes32"],
                                      outs[1]["modes32"]]),
              "lv64": lv64, "split64": split64}
        return carry, ys

    # SB row 0: frame row 0 forces splitting; no 64 candidate
    carry = rec_r0b[:, 15, :].reshape(-1)
    carry, o_r1 = row32_step(carry, (src16[2], src16[3], src32[1], av16[2],
                                     av16[3], av32[1]))
    sbs = [{"lv16": torch.cat([row0["lv16"], o_r1["lv16"]]),
            "modes16": torch.cat([row0["modes16"], o_r1["modes16"]]),
            "rec": torch.cat([row0["rec"], o_r1["rec"]]),
            "split": torch.stack([row0["split"], o_r1["split"]]),
            "lv32": torch.stack([row0["lv32"], o_r1["lv32"]]),
            "modes32": torch.stack([row0["modes32"], o_r1["modes32"]]),
            "lv64": torch.zeros((cols64, 1024), dtype=torch.int16,
                                device=dev),
            "split64": torch.ones((cols64,), dtype=torch.bool, device=dev)}]
    for s in range(1, rows64):
        r = 4 * s
        xs = ((src16[r], src16[r + 1], src32[2 * s], av16[r], av16[r + 1],
               av32[2 * s]),
              (src16[r + 2], src16[r + 3], src32[2 * s + 1], av16[r + 2],
               av16[r + 3], av32[2 * s + 1]),
              src64[s], av64[s])
        carry, ys = sb_step(carry, xs)
        sbs.append(ys)
    out = {k: torch.stack([sb[k] for sb in sbs]) for k in sbs[0]}

    lv16 = out["lv16"].reshape(rows16, cols16, 16, 16)
    recon = from_blocks(out["rec"].reshape(rows16, cols16, 16, 16))
    return (lv16, out["lv32"].reshape(rows32, cols32, 32, 32),
            out["modes16"].reshape(rows16, cols16),
            out["modes32"].reshape(rows32, cols32),
            out["split"].reshape(rows32, cols32), recon,
            out["lv64"].reshape(rows64, cols64, 32, 32), out["split64"])


def _encode_chroma_dual(src: torch.Tensor, split: torch.Tensor,
                        split64: torch.Tensor, qindex: int,
                        bit_depth: int = 8):
    """Chroma plane with size dictated by the luma partition grids: 8x8
    blocks where a 32-region split, a 16x16 ADST_DCT block where a 32 won,
    and a 32x32 DCT block where the 64 won.  Returns (lv8, lv16, recon,
    lv32)."""
    h, w = src.shape
    dev = src.device
    rows8, cols8 = h // 8, w // 8
    rows16c, cols16c = h // 16, w // 16  # == rows32, cols32 of luma
    pix_max = (1 << bit_depth) - 1
    base = 1 << (bit_depth - 1)
    T = tables(dev)

    from av1tpu_torch.models.rates import qctx_index

    fwd8t = T.fwdt(8, 1)     # ADST_DCT (uv V_PRED)
    fwd16t = T.fwdt(16, 1)
    step8, q8, cap8 = _plane_params(qindex, 8, bit_depth, dev)
    step16, q16, cap16 = _plane_params(qindex, 16, bit_depth, dev)
    qctx = qctx_index(qindex)
    lam_pix = float(f32(ac_squared(qindex, bit_depth, dev) * f32(LAM_PIX)))
    ctabs = {n: T.rate_tabs(n, 1)[qctx] for n in (8, 16, 32)}
    cgains = {(8, 1): T.coef_gains(8, 1), (16, 1): T.coef_gains(16, 1),
              (32, 0): T.coef_gains(32, 0)}

    src8 = to_blocks(src, 8)
    src16 = to_blocks(src, 16)

    def enc(blocks, pred, fwdt, step, q, cap, n, tt):
        b = blocks.shape[0]
        resid = (blocks - pred).reshape(b, n * n).to(torch.float32)
        coefs = resid @ fwdt
        lv = quantize_coefs(coefs, step, cap)
        lv = rd_zero(lv, coefs, q.to(torch.float32), lam_pix, ctabs[n],
                     cgains[(n, tt)])
        r = inverse_transform((lv * q).reshape(b, n, n), n, n, tt)
        return lv.reshape(b, n, n), torch.clamp(pred + r, 0, pix_max)

    def row8_v(bottom, blocks):
        pred = bottom.reshape(cols8, 1, 8).expand(cols8, 8, 8)
        return enc(blocks, pred, fwd8t, step8, q8, cap8, 8, 1)

    # frame row 0 (always split): sequential 8x8 chain (rd_zero reads the
    # coefficients, so this chain has no kernel)
    edge = torch.full((1, 1, 1), base - 1, dtype=torch.int32, device=dev)
    lv0, rec0 = [], []
    for c in range(cols8):
        lv, rec = enc(src8[0, c][None], edge.expand(1, 8, 8), fwd8t, step8,
                      q8, cap8, 8, 1)
        edge = rec[:, :1, 7:]
        lv0.append(lv[0])
        rec0.append(rec[0])
    lv8_0t, rec8_0t = torch.stack(lv0), torch.stack(rec0)
    lv8_0b, rec8_0b = row8_v(rec8_0t[:, 7, :], src8[1])
    row0 = {
        "lv8": torch.stack([lv8_0t, lv8_0b]).to(torch.int16),
        "lv16": torch.zeros((cols16c, 16, 16), dtype=torch.int16,
                            device=dev),
        "rec": torch.stack([rec8_0t, rec8_0b]),
    }

    def row16_step(bottom, xs):
        blocks8_t, blocks8_b, blocks16, sp = xs
        lv8_t, rec8_t = row8_v(bottom.reshape(cols8, 8), blocks8_t)
        lv8_b, rec8_b = row8_v(rec8_t[:, 7, :], blocks8_b)
        pred16 = bottom.reshape(cols16c, 1, 16).expand(cols16c, 16, 16)
        lv16, rec16 = enc(blocks16, pred16, fwd16t, step16, q16, cap16,
                          16, 1)
        s2 = sp.repeat_interleave(2)
        lv8_t = torch.where(s2[:, None, None], lv8_t, 0)
        lv8_b = torch.where(s2[:, None, None], lv8_b, 0)
        lv16 = torch.where(sp[:, None, None], 0, lv16)
        bot8 = rec8_b[:, 7, :].reshape(cols16c, 16)
        carry = torch.where(sp[:, None], bot8, rec16[:, 15, :]).reshape(-1)
        rec8_pair = torch.stack([rec8_t, rec8_b])
        rec = torch.where(s2[None, :, None, None], rec8_pair,
                          _as_small(rec16, 2, 8))
        return carry, {"lv8": torch.stack([lv8_t, lv8_b]).to(torch.int16),
                       "lv16": lv16.to(torch.int16), "rec": rec}

    # ---- third level: one 32x32 DCT chroma block where the luma chose 64
    cols32c = w // 32              # == cols64 of luma
    rows32c = h // 32              # == rows64
    fwd32t = T.fwdt(32, 0)         # chroma 32: derived DCT
    step32b, q32, cap32 = _plane_params(qindex, 32, bit_depth, dev)
    step32 = step32b * 0.5         # dequant shift 1
    src32 = to_blocks(src, 32)

    def chroma_sb_step(bottom, xs):
        xs_a, xs_b, blocks32, sp64 = xs
        c1, o1 = row16_step(bottom, xs_a)
        c2, o2 = row16_step(c1, xs_b)
        pred32 = bottom.reshape(cols32c, 1, 32).expand(cols32c, 32, 32)
        resid = (blocks32 - pred32).reshape(cols32c, 1024).to(torch.float32)
        coefs = resid @ fwd32t
        lv32 = quantize_coefs(coefs, step32, cap32)
        lv32 = rd_zero(lv32, coefs, q32.to(torch.float32) * 0.5, lam_pix,
                       ctabs[32], cgains[(32, 0)])
        dq = _dq_shift(lv32, q32, 1)
        rec32 = torch.clamp(
            pred32 + inverse_transform(dq.reshape(cols32c, 32, 32), 32, 32,
                                       0), 0, pix_max)
        k2 = sp64.repeat_interleave(2)   # per 16c-region
        k4 = sp64.repeat_interleave(4)   # per 8-col
        outs = []
        for o in (o1, o2):
            o = dict(o)
            o["lv8"] = torch.where(k4[None, :, None, None], o["lv8"], 0)
            o["lv16"] = torch.where(k2[:, None, None], o["lv16"], 0)
            outs.append(o)
        lv32 = torch.where(sp64[:, None], 0, lv32).to(torch.int16)
        carry = torch.where(sp64[:, None], c2.reshape(cols32c, 32),
                            rec32[:, 31, :]).reshape(-1)
        rec_sub = torch.cat([outs[0]["rec"], outs[1]["rec"]], dim=0)
        rec = torch.where(k4[None, :, None, None], rec_sub,
                          _as_small(rec32, 4, 8))
        return carry, {
            "lv8": torch.cat([outs[0]["lv8"], outs[1]["lv8"]]),
            "lv16": torch.stack([outs[0]["lv16"], outs[1]["lv16"]]),
            "rec": rec, "lv32": lv32}

    # SB row 0 (no 64): frame chroma row 0 special + one normal 16c-row
    carry = rec8_0b[:, 7, :].reshape(-1)
    carry, o_r1 = row16_step(carry, (src8[2], src8[3], src16[1], split[1]))
    sbs = [{"lv8": torch.cat([row0["lv8"], o_r1["lv8"]]),
            "lv16": torch.stack([row0["lv16"], o_r1["lv16"]]),
            "rec": torch.cat([row0["rec"], o_r1["rec"]]),
            "lv32": torch.zeros((cols32c, 1024), dtype=torch.int16,
                                device=dev)}]
    for s in range(1, rows32c):
        r = 4 * s
        xs = ((src8[r], src8[r + 1], src16[2 * s], split[2 * s]),
              (src8[r + 2], src8[r + 3], src16[2 * s + 1], split[2 * s + 1]),
              src32[s], split64[s])
        carry, ys = chroma_sb_step(carry, xs)
        sbs.append(ys)
    out = {k: torch.stack([sb[k] for sb in sbs]) for k in sbs[0]}

    lv8 = out["lv8"].reshape(rows8, cols8, 8, 8)
    recon = from_blocks(out["rec"].reshape(rows8, cols8, 8, 8))
    return (lv8, out["lv16"].reshape(rows16c, cols16c, 16, 16), recon,
            out["lv32"].reshape(rows32c, cols32c, 32, 32))


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
    (ly16, ly32, m16, m32, split, ry,
     ly64, split64) = _encode_luma_part(y, qindex, bit_depth)
    lu8, lu16, ru, lu32 = _encode_chroma_dual(u, split, split64, qindex,
                                              bit_depth)
    lv8, lv16c, rv, lv32c = _encode_chroma_dual(v, split, split64, qindex,
                                                bit_depth)
    return {"levels_y16": ly16, "levels_y32": ly32, "levels_y64": ly64,
            "modes16": m16, "modes32": m32,
            "split": split, "split64": split64,
            "levels_u8": lu8, "levels_u16": lu16, "levels_u32": lu32,
            "levels_v8": lv8, "levels_v16": lv16c, "levels_v32": lv32c,
            "recon_y": ry, "recon_u": ru, "recon_v": rv}


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
