"""Wavefront intra pipeline: full mode RDO on anti-diagonals (port of
av1tpu/models/intra_wave.py: the quality preset's keyframe).

The 16x16 block grid is processed along diagonals d = 2r + c: blocks on a
diagonal depend only on earlier diagonals, so each step codes a whole
diagonal batch with the 13 luma modes of WAVE_MODES, grouped by the
transform type the mode derives, then re-codes the winning mode at TX_8X8
and TX_4X4 with per-tx-block prediction and picks a tx depth per block.
Chroma is 8x8 DC_PRED (DCT_DCT).

The reference scans the diagonals with lax.scan; here it is a Python loop
that carries the eight state tensors (recon and level grids of the three
planes, modes, tx depths) on the device.  The schedule pads every diagonal
to the longest one; the padded lanes are computed and never written.

Every site quantizes and then prunes with rdoq.rd_zero, which reads the
coefficients, so this module launches no hand kernel: the sites are the
front half of the fused coder that is still to be written.
"""

from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.models.intra_v import (
    LAM_PIX, _plane_params, ac_squared, compact_values, fold_consts,
    from_blocks, quantize_coefs, sig_bitmap, to_blocks, unfuse,
)
from av1tpu_torch.models.rdoq import rd_zero
from av1tpu_torch.ops.transforms import inverse_transform
from av1tpu_torch.spec.enums import (
    D45_PRED, D67_PRED, D113_PRED, D135_PRED, D157_PRED, D203_PRED,
    DC_PRED, H_PRED, PAETH_PRED, SMOOTH_H_PRED, SMOOTH_PRED,
    SMOOTH_V_PRED, V_PRED,
)
from av1tpu_torch.spec.predict import (
    DR_INTRA_DERIVATIVE, MODE_ANGLE, SM_WEIGHTS,
)
from av1tpu_torch.state import tables

f32 = np.float32

WAVE_MODES = (DC_PRED, V_PRED, H_PRED, D45_PRED, D67_PRED, SMOOTH_PRED,
              SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED, D135_PRED,
              D113_PRED, D157_PRED, D203_PRED)

# luma residuals are coded with the mode's derived transform (spec
# Mode_To_Txfm).  Modes grouped by tx type so each group is one batched
# matmul; tx values are the spec enums (DCT_DCT=0, ADST_DCT=1, DCT_ADST=2,
# ADST_ADST=3).  The C++ packer derives the same mapping from the mode.
_TX_GROUPS = (
    (0, (0, 3)),            # DC, D45                  -> DCT_DCT
    (1, (1, 4, 6, 10)),     # V, D67, SMOOTH_V, D113   -> ADST_DCT
    (2, (2, 7, 11, 12)),    # H, SMOOTH_H, D157, D203  -> DCT_ADST
    (3, (5, 8, 9)),         # SMOOTH, PAETH, D135      -> ADST_ADST
)
_TX_ORDER = tuple(i for _, idxs in _TX_GROUPS for i in idxs)
_D203_POS = _TX_ORDER.index(12)  # cost row to mask where the decoder
# would read real below-left pixels (anti-causal for the wavefront)
# tx-depth symbol bits from the default tx_size cdf (category 1)
_TXD_BITS = (1.42, 0.87, 3.66)


def _r2(x, n):
    return (x + (1 << (n - 1))) >> n


def _ur_avail_grid(rows: int, cols: int) -> np.ndarray:
    """Above-right availability per 16-block (spec BlockDecoded model)."""
    m = np.array([[1, 1, 1, 1], [1, 0, 1, 0], [1, 1, 1, 0], [1, 0, 1, 0]],
                 np.bool_)
    g = np.zeros((rows, cols), np.bool_)
    for r in range(1, rows):
        g[r] = m[r % 4][np.arange(cols) % 4]
    g[:, cols - 1] = False
    return g


def _bl_avail_grid(rows: int, cols: int) -> np.ndarray:
    """Decoder-side below-left availability per 16-block (spec
    BlockDecoded in z-scan order).  A wavefront encoder can never produce
    those pixels in time (they lie on a LATER diagonal), so D203 is
    excluded from the RDO wherever the decoder would read them."""
    m = np.zeros((4, 4), np.bool_)
    m[:3, 0] = True
    m[0::2, 2] = True
    g = np.zeros((rows, cols), np.bool_)
    for r in range(rows - 1):      # frame-bottom row: no pixels below
        g[r] = m[r % 4][np.arange(cols) % 4]
    g[:, 0] = False                # frame col 0: have_left is false
    return g


def _diagonals(rows: int, cols: int):
    """Static wavefront schedule: (ndiag, L) r/c indices + validity.
    Diagonals follow d = 2r + c (the WPP slope), so above, left,
    above-left AND above-right contexts are complete before a block is
    coded.  A diagonal's valid lanes come first."""
    nd = 2 * (rows - 1) + cols
    sched = []
    for d in range(nd):
        sched.append([(r, d - 2 * r) for r in range(rows)
                      if 0 <= d - 2 * r < cols])
    L = max(len(b) for b in sched)
    r_i = np.zeros((nd, L), np.int32)
    c_i = np.zeros((nd, L), np.int32)
    valid = np.zeros((nd, L), np.bool_)
    for d, blocks in enumerate(sched):
        for k, (r, c) in enumerate(blocks):
            r_i[d, k] = r
            c_i[d, k] = c
            valid[d, k] = True
    return r_i, c_i, valid


def _pred_consts(n: int, dev):
    """Index and weight tensors of _predict_modes at size n, per device."""
    def build(d):
        def t(a, dt=torch.int64):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=d)

        c = {"w": t(SM_WEIGHTS[n], torch.int32)}
        ri = np.arange(n, dtype=np.int64)[:, None]
        ci = np.arange(n, dtype=np.int64)[None, :]
        max_base = 2 * n - 1
        for mode in (D45_PRED, D67_PRED, D203_PRED):
            if mode == D203_PRED:
                idx = (ci + 1) * DR_INTRA_DERIVATIVE[270 - MODE_ANGLE[mode]]
                pos = (idx >> 6) + ri
            else:
                idx = (ri + 1) * DR_INTRA_DERIVATIVE[MODE_ANGLE[mode]]
                pos = (idx >> 6) + ci
            b = np.minimum(pos, max_base)
            c[mode] = (t(b.ravel()), t(np.minimum(b + 1, max_base).ravel()),
                       t((idx >> 1) & 0x1F, torch.int32),
                       t(pos < max_base, torch.bool))
        for mode in (D113_PRED, D135_PRED, D157_PRED):
            ang = MODE_ANGLE[mode]
            dx = DR_INTRA_DERIVATIVE[180 - ang]
            dy = DR_INTRA_DERIVATIVE[ang - 90]
            xi = (ci << 6) - (ri + 1) * dx
            base_x = xi >> 6                       # >= -1 when above-hit
            bx = np.clip(base_x + 1, 0, 2 * n - 1)
            yi = (ri << 6) - (ci + 1) * dy
            by = np.clip((yi >> 6) + 1, 0, n)
            c[mode] = (t(bx.ravel()),
                       t(np.minimum(bx + 1, 2 * n - 1).ravel()),
                       t((xi >> 1) & 0x1F, torch.int32),
                       t(by.ravel()), t(np.minimum(by + 1, n).ravel()),
                       t((yi >> 1) & 0x1F, torch.int32),
                       t(base_x >= -1, torch.bool))
        return c
    return tables(dev).const(("wave_pred", n), build)


def _predict_modes(above32, left2n, corner, have_a, have_l, base: int,
                   n: int = 16):
    """Vectorized predictions for every WAVE_MODES entry.
    above32: (L, 2n); left2n: (L, 2n), the below-left half real where the
    decoder would see decoded pixels, else the caller replicates
    left[n-1]; corner: (L,); have_a/have_l: (L,) bool.  Returns
    (n_modes, L, n, n) int32."""
    L = above32.shape[0]
    K = _pred_consts(n, above32.device)
    above = above32[:, :n]
    left = left2n[:, :n]
    a_row = above[:, None, :]
    l_col = left[:, :, None]
    wy = K["w"][None, :, None]
    wx = K["w"][None, None, :]
    below = left[:, n - 1][:, None, None]
    right = above[:, n - 1][:, None, None]

    def interp(edge, b, b1, shift):
        g0 = edge[:, b].reshape(L, n, n)
        g1 = edge[:, b1].reshape(L, n, n)
        return _r2(g0 * (32 - shift) + g1 * shift, 5)

    preds = []
    for mode in WAVE_MODES:
        if mode == DC_PRED:
            lg = n.bit_length() - 1
            sa = above.sum(dim=1, dtype=torch.int32)
            sl = left.sum(dim=1, dtype=torch.int32)
            both = (sa + sl + n) >> (lg + 1)
            a_only = (sa + (n >> 1)) >> lg
            l_only = (sl + (n >> 1)) >> lg
            val = torch.where(have_a & have_l, both,
                              torch.where(have_a, a_only,
                                          torch.where(have_l, l_only, base)))
            p = val[:, None, None].expand(L, n, n)
        elif mode == V_PRED:
            p = a_row.expand(L, n, n)
        elif mode == H_PRED:
            p = l_col.expand(L, n, n)
        elif mode == PAETH_PRED:
            co = corner[:, None, None]
            b = a_row + l_col - co
            pa = (b - a_row).abs()
            pl = (b - l_col).abs()
            pc = (b - co).abs()
            p = torch.where((pa <= pl) & (pa <= pc), a_row.expand(L, n, n),
                            torch.where(pl <= pc, l_col.expand(L, n, n),
                                        co.expand(L, n, n)))
        elif mode == SMOOTH_PRED:
            p = _r2(wy * a_row + (256 - wy) * below
                    + wx * l_col + (256 - wx) * right, 9)
        elif mode == SMOOTH_V_PRED:
            p = _r2(wy * a_row + (256 - wy) * below, 8)
        elif mode == SMOOTH_H_PRED:
            p = _r2(wx * l_col + (256 - wx) * right, 8)
        elif mode in (D45_PRED, D67_PRED):
            b, b1, shift, inside = K[mode]
            p = torch.where(inside[None], interp(above32, b, b1, shift),
                            above32[:, 2 * n - 1][:, None, None])
        elif mode in (D113_PRED, D135_PRED, D157_PRED):
            # zone 2 (spec 7.11.2.4, 90 < angle < 180): each pixel's ray
            # lands on the above row (through the corner at index -1) or
            # the left column; both branches computed, static select
            bx, bx1, shift_x, by, by1, shift_y, hit_above = K[mode]
            above_c = torch.cat([corner[:, None], above32[:, : 2 * n - 1]],
                                dim=1)
            left_c = torch.cat([corner[:, None], left], dim=1)
            p = torch.where(hit_above[None],
                            interp(above_c, bx, bx1, shift_x),
                            interp(left_c, by, by1, shift_y))
        else:  # D203: zone 3 (left-only, the transpose of zone 1); reads
            # the left2n extension
            b, b1, shift, inside = K[mode]
            p = torch.where(inside[None], interp(left2n, b, b1, shift),
                            left2n[:, 2 * n - 1][:, None, None])
        preds.append(p.to(torch.int32))
    return torch.stack(preds)


def _edges_from_blocks(rec, r_i, c_i, have_a, have_l, ur_ok, base: int,
                       n: int):
    """Edge arrays for a diagonal batch from the carried block tensor
    rec (rows, cols, n, n).  Returns (above2n (L, 2n), left (L, n),
    corner (L,)), with the spec's availability substitutions."""
    cols = rec.shape[1]
    rm = torch.clamp(r_i - 1, min=0)
    cm = torch.clamp(c_i - 1, min=0)
    cp = torch.clamp(c_i + 1, max=cols - 1)
    above_raw = rec[rm, c_i, n - 1, :]             # (L, n)
    left_raw = rec[r_i, cm, :, n - 1]              # (L, n)
    ur_raw = rec[rm, cp, n - 1, :]                 # (L, n)
    corner_raw = rec[rm, cm, n - 1, n - 1]         # (L,)

    ha, hl = have_a[:, None], have_l[:, None]
    above = torch.where(ha, above_raw,
                        torch.where(hl, left_raw[:, 0:1], base - 1))
    left = torch.where(hl, left_raw,
                       torch.where(ha, above_raw[:, 0:1], base + 1))
    corner = torch.where(have_a & have_l, corner_raw,
                         torch.where(have_a, above[:, 0],
                                     torch.where(have_l, left[:, 0], base)))
    ur = torch.where((ur_ok & have_a)[:, None], ur_raw,
                     above[:, n - 1][:, None])
    return torch.cat([above, ur], dim=1), left, corner


def wave_lambdas(qindex: int, bit_depth: int, lam_scale: float, device):
    """(lam, lam * _TXD_BITS[0]) as float32 values: lam = ac^2 * 0.0234 *
    lam_scale with the constants folded as the compiled reference folds
    them."""
    a2 = ac_squared(qindex, bit_depth, device)
    return (f32(a2 * fold_consts(LAM_PIX, lam_scale)),
            f32(a2 * fold_consts(LAM_PIX, lam_scale, _TXD_BITS[0])))


def encode_intra_wave(y, u, v, qindex: int, bit_depth: int = 8,
                      lam_scale: float = 1.0, noise_gate: float = 0.0):
    """Full-frame wavefront intra encode.  Returns level grids, recon
    planes, per-block luma modes and tx depths (uv is DC_PRED everywhere).

    lam_scale: RDO lambda multiplier (a GOP keyframe is referenced by every
    following frame of the scene, so its distortion weighs more than its
    bits).  noise_gate: (3*sigma)^2 RDOQ noise floor, a Python float
    (0 = only exact zeros fall under it)."""
    from av1tpu_torch.models.rates import kf_mode_bits, qctx_index

    h, w = y.shape
    dev = y.device
    rows, cols = h // 16, w // 16
    base = 1 << (bit_depth - 1)
    pix_max = (1 << bit_depth) - 1
    T = tables(dev)
    tx_ids = [t for t, _ in _TX_GROUPS]

    fwd16t = {t: T.fwdt(16, t) for t in tx_ids}
    fwd8t = {t: T.fwdt(8, t) for t in tx_ids}
    fwd4t = {t: T.fwdt(4, t) for t in tx_ids}
    step16, q16, cap16 = _plane_params(qindex, 16, bit_depth, dev)
    step8, q8, cap8 = _plane_params(qindex, 8, bit_depth, dev)
    step4, q4, cap4 = _plane_params(qindex, 4, bit_depth, dev)
    lam_np, lam_txd0_np = wave_lambdas(qindex, bit_depth, lam_scale, dev)
    lam, lam_txd0 = float(lam_np), float(lam_txd0_np)
    gate = float(noise_gate)

    # mode candidates in _TX_ORDER (grouped by derived transform)
    mode_bits, mode_vals, grp_of_pos = T.const("wave_modes", lambda d: (
        torch.as_tensor(kf_mode_bits()[[WAVE_MODES[i] for i in _TX_ORDER]],
                        device=d),
        torch.tensor([WAVE_MODES[i] for i in _TX_ORDER], dtype=torch.int8,
                     device=d),
        torch.tensor([t for t, idxs in _TX_GROUPS for _ in idxs],
                     dtype=torch.int64, device=d)))
    grp_idx = [torch.tensor(idxs, device=dev) for _, idxs in _TX_GROUPS]
    qctx = qctx_index(qindex)
    rm16y, rm8y, rm4y = (T.rate_model(n, 0) for n in (16, 8, 4))
    tab8c = T.rate_tabs(8, 1)[qctx]
    g16t = {t: T.coef_gains(16, t) for t in tx_ids}
    g8 = T.coef_gains(8)
    g8s = torch.stack([T.coef_gains(8, t) for t in range(4)])
    g4s = torch.stack([T.coef_gains(4, t) for t in range(4)])

    src_y = to_blocks(y.to(torch.int32), 16)
    src_u = to_blocks(u.to(torch.int32), 8)
    src_v = to_blocks(v.to(torch.int32), 8)

    r_np, c_np, valid_np = _diagonals(rows, cols)
    n_valid = valid_np.sum(axis=1)
    r_all = torch.as_tensor(r_np, dtype=torch.int64, device=dev)
    c_all = torch.as_tensor(c_np, dtype=torch.int64, device=dev)
    valid_all = torch.as_tensor(valid_np, device=dev)
    ur_all = torch.as_tensor(_ur_avail_grid(rows, cols)[r_np, c_np]
                             & valid_np, device=dev)
    bl_all = torch.as_tensor(_bl_avail_grid(rows, cols)[r_np, c_np]
                             & valid_np, device=dev)

    def code_luma(src, pred, tx):
        """(..., 16, 16) blocks coded at TX_16X16 with transform type tx ->
        levels, recon, dist, rate from the rate model.  Near-threshold
        levels are RD-pruned against the frame lambda."""
        sh = src.shape[:-2]
        resid = (src - pred).reshape(-1, 256).to(torch.float32)
        coefs = resid @ fwd16t[tx]
        lv = quantize_coefs(coefs, step16, cap16)
        lv = rd_zero(lv, coefs, q16.to(torch.float32), lam,
                     rm16y.tabs[qctx], g16t[tx], noise_gate=gate)
        rec = torch.clamp(
            pred.reshape(-1, 16, 16)
            + inverse_transform((lv * q16).reshape(-1, 16, 16), 16, 16, tx),
            0, pix_max)
        e = rec - src.reshape(-1, 16, 16)
        dist = (e * e).sum(dim=(1, 2)).to(torch.float32)
        rate = rm16y(lv.reshape(-1, 16, 16), qctx)
        return (lv.reshape(sh + (16, 16)), rec.reshape(sh + (16, 16)),
                dist.reshape(sh), rate.reshape(sh))

    def clamped(lo: int, n: int, hi: int):
        """Device index row [lo, lo + n) clamped to hi (edge replication
        past a block's last decoded sample)."""
        return T.const(("wave_idx", lo, n, hi), lambda dv: torch.clamp(
            torch.arange(lo, lo + n, device=dv), max=hi))

    def code_chroma(src, pred):
        """8x8 DCT chroma blocks -> (levels, recon)."""
        resid = (src - pred).reshape(-1, 64).to(torch.float32)
        coefs = resid @ fwd8t[0]
        lv = quantize_coefs(coefs, step8, cap8)
        lv = rd_zero(lv, coefs, q8.to(torch.float32), lam, tab8c, g8,
                     noise_gate=gate)
        rec = torch.clamp(
            pred + inverse_transform((lv * q8).reshape(-1, 8, 8), 8, 8, 0),
            0, pix_max)
        return lv.reshape(-1, 8, 8), rec

    rec_y = torch.zeros((rows, cols, 16, 16), dtype=torch.int32, device=dev)
    rec_u = torch.zeros((rows, cols, 8, 8), dtype=torch.int32, device=dev)
    rec_v = torch.zeros((rows, cols, 8, 8), dtype=torch.int32, device=dev)
    lv_y = torch.zeros((rows, cols, 16, 16), dtype=torch.int16, device=dev)
    lv_u = torch.zeros((rows, cols, 8, 8), dtype=torch.int16, device=dev)
    lv_v = torch.zeros((rows, cols, 8, 8), dtype=torch.int16, device=dev)
    modes = torch.zeros((rows, cols), dtype=torch.int8, device=dev)
    txds = torch.zeros((rows, cols), dtype=torch.int8, device=dev)
    inf = float("inf")

    for d in range(r_np.shape[0]):
        r_i, c_i, valid, ur_ok = r_all[d], c_all[d], valid_all[d], ur_all[d]
        have_a = (r_i > 0) & valid
        have_l = (c_i > 0) & valid
        L_ = r_i.shape[0]

        # ---- luma: full-mode RDO at TX_16X16 ----
        above32, left, corner = _edges_from_blocks(
            rec_y, r_i, c_i, have_a, have_l, ur_ok, base, 16)
        left2n = torch.cat([left, left[:, 15:].expand(L_, 16)], dim=1)
        preds = _predict_modes(above32, left2n, corner, have_a, have_l,
                               base)                    # (M, L, 16, 16)
        src_b = src_y[r_i, c_i]                         # (L, 16, 16)
        # per-tx-group residual coding (preds reordered to _TX_ORDER so
        # the concatenated candidates line up with mode_vals/mode_bits)
        parts = []
        for (t, _), gi in zip(_TX_GROUPS, grp_idx):
            pg = preds[gi]
            parts.append(code_luma(src_b[None].expand(pg.shape), pg, t))
        lv, rec, dist, rate = (torch.cat([p[k] for p in parts], dim=0)
                               for k in range(4))
        cost = dist + lam * (rate + mode_bits[:, None])
        # D203 is anti-causal where the decoder has real below-left
        # pixels (see _bl_avail_grid): exclude it there
        cost[_D203_POS] += torch.where(bl_all[d], inf, 0.0)
        pick = torch.argmin(cost, dim=0)                # (L,)
        sel16 = pick[None, :, None, None].expand(1, L_, 16, 16)
        lv_b = torch.gather(lv, 0, sel16)[0]
        rec_b = torch.gather(rec, 0, sel16)[0]
        mode_b = mode_vals[pick]
        cost_b = cost.amin(dim=0) + lam_txd0
        grp_b = grp_of_pos[pick]                        # (L,) tx group
        grp_masks = [(grp_b == t) for t in tx_ids]
        mbits_b = mode_bits[pick]
        ones = torch.ones_like(have_a)

        def sub_chain(ns, fwds, stepq, qq, capn, rm, gstack):
            """Re-code every lane's winning mode at tx size ns with
            per-tx-block prediction (raster order inside the block, the
            decoder's coding order; edges come from already-reconstructed
            sub-blocks, with the spec's availability substitutions).  The
            prediction is row `pick` of _predict_modes' WAVE_MODES-ordered
            stack, as in the reference."""
            k = 16 // ns
            recb = torch.zeros((L_, 16, 16), dtype=torch.int32, device=dev)
            lvb = torch.zeros((L_, 16, 16), dtype=torch.int16, device=dev)
            distb = torch.zeros(L_, dtype=torch.float32, device=dev)
            rateb = torch.zeros(L_, dtype=torch.float32, device=dev)
            qf = qq.to(torch.float32)
            gain_l = gstack[grp_b]                      # (L, ns*ns)
            tcdf = rm.tabs[qctx]
            sel = pick[None, :, None, None].expand(1, L_, ns, ns)
            for si in range(k):
                for sj in range(k):
                    y0, x0 = si * ns, sj * ns
                    if si == 0:
                        a2 = above32[:, x0 : x0 + 2 * ns]
                        if sj > 0:  # frame-top row: decoder substitutes
                            # from the left neighbor's TOP pixel
                            a2 = torch.where(have_a[:, None], a2,
                                             recb[:, 0, x0 - 1][:, None])
                    else:
                        # above-right: real rec through col 15 (the sub
                        # above-right is already decoded in raster),
                        # clamp-replicated past the block edge
                        a2 = recb[:, y0 - 1, clamped(x0, 2 * ns, 15)]
                    if sj == 0:
                        l2 = left[:, clamped(y0, 2 * ns, 15)]
                        if si > 0:  # frame-left col substitution
                            l2 = torch.where(have_l[:, None], l2,
                                             recb[:, y0 - 1, 0][:, None])
                    else:
                        # below-left of an interior sub is never decoded
                        # yet: replicate
                        l2 = recb[:, clamped(y0, 2 * ns, y0 + ns - 1),
                                  x0 - 1]
                    if si == 0 and sj == 0:
                        co = corner
                    elif si == 0:
                        co = torch.where(have_a, above32[:, x0 - 1],
                                         recb[:, 0, x0 - 1])
                    elif sj == 0:
                        co = torch.where(have_l, left[:, y0 - 1],
                                         recb[:, y0 - 1, 0])
                    else:
                        co = recb[:, y0 - 1, x0 - 1]
                    ha = have_a if si == 0 else ones
                    hl = have_l if sj == 0 else ones
                    ps = _predict_modes(a2, l2, co, ha, hl, base, n=ns)
                    pred = torch.gather(ps, 0, sel)[0]
                    srcs = src_b[:, y0 : y0 + ns, x0 : x0 + ns]
                    resid = (srcs - pred).reshape(L_, ns * ns).to(
                        torch.float32)
                    coefs = torch.zeros_like(resid)
                    for t, m in zip(tx_ids, grp_masks):
                        coefs = coefs + torch.where(m[:, None],
                                                    resid @ fwds[t], 0.0)
                    lvq = quantize_coefs(coefs, stepq, capn)
                    lvq = rd_zero(lvq, coefs, qf, lam, tcdf, gain_l,
                                  noise_gate=gate)
                    dq = (lvq * qq).reshape(L_, ns, ns)
                    inv = torch.zeros((L_, ns, ns), dtype=torch.int32,
                                      device=dev)
                    for t, m in zip(tx_ids, grp_masks):
                        inv = inv + torch.where(
                            m[:, None, None],
                            inverse_transform(dq, ns, ns, t), 0)
                    recs = torch.clamp(pred + inv, 0, pix_max)
                    e = recs - srcs
                    distb = distb + (e * e).sum(dim=(1, 2)).to(torch.float32)
                    rateb = rateb + rm(lvq.reshape(L_, ns, ns), qctx)
                    recb[:, y0 : y0 + ns, x0 : x0 + ns] = recs
                    lvb[:, y0 : y0 + ns, x0 : x0 + ns] = lvq.reshape(
                        L_, ns, ns).to(torch.int16)
            return lvb, recb, distb, rateb

        lv8, rec8, dist8, rate8 = sub_chain(8, fwd8t, step8, q8, cap8,
                                            rm8y, g8s)
        lv4, rec4, dist4, rate4 = sub_chain(4, fwd4t, step4, q4, cap4,
                                            rm4y, g4s)
        cost8 = dist8 + lam * (rate8 + mbits_b + _TXD_BITS[1])
        cost4 = dist4 + lam * (rate4 + mbits_b + _TXD_BITS[2])
        txd_b = torch.where(cost8 < torch.minimum(cost_b, cost4), 1,
                            torch.where(cost4 < cost_b, 2, 0)).to(torch.int8)
        d1 = (txd_b == 1)[:, None, None]
        d2 = (txd_b == 2)[:, None, None]
        lv_b = torch.where(d1, lv8, torch.where(d2, lv4, lv_b.to(torch.int16)))
        rec_b = torch.where(d1, rec8, torch.where(d2, rec4, rec_b))

        # ---- chroma: DC only ----
        au, lu_e, _ = _edges_from_blocks(rec_u, r_i, c_i, have_a, have_l,
                                         ur_ok, base, 8)
        av, lv_e, _ = _edges_from_blocks(rec_v, r_i, c_i, have_a, have_l,
                                         ur_ok, base, 8)

        def dc8(above2n, left8):
            sa = above2n[:, :8].sum(dim=1, dtype=torch.int32)
            sl = left8.sum(dim=1, dtype=torch.int32)
            val = torch.where(have_a & have_l, (sa + sl + 8) >> 4,
                              torch.where(have_a, (sa + 4) >> 3,
                                          torch.where(have_l, (sl + 4) >> 3,
                                                      base)))
            return val[:, None, None].expand(val.shape[0], 8, 8)

        lvu_b, recu_b = code_chroma(src_u[r_i, c_i], dc8(au, lu_e))
        lvv_b, recv_b = code_chroma(src_v[r_i, c_i], dc8(av, lv_e))

        # the padded lanes carry duplicate (0, 0) indices: write the valid
        # lanes only (they come first in every diagonal)
        nv = int(n_valid[d])
        rv_, cv_ = r_i[:nv], c_i[:nv]
        rec_y[rv_, cv_] = rec_b[:nv]
        rec_u[rv_, cv_] = recu_b[:nv]
        rec_v[rv_, cv_] = recv_b[:nv]
        lv_y[rv_, cv_] = lv_b[:nv]
        lv_u[rv_, cv_] = lvu_b[:nv].to(torch.int16)
        lv_v[rv_, cv_] = lvv_b[:nv].to(torch.int16)
        modes[rv_, cv_] = mode_b[:nv]
        txds[rv_, cv_] = txd_b[:nv]

    return {"levels_y": lv_y, "levels_u": lv_u, "levels_v": lv_v,
            "modes": modes, "txd": txds,
            "recon_y": from_blocks(rec_y), "recon_u": from_blocks(rec_u),
            "recon_v": from_blocks(rec_v)}


def _wave_key_body(frame, qindex: int, height: int, width: int,
                   cap: int = 163840, lf3=None, lam_scale: float = 1.0,
                   noise_gate: float = 0.0, bit_depth: int = 8):
    """Wavefront keyframe for a GOP: compact transport [head | bitmap |
    vals (cap) | modes | txd] + fused int32 recon kept on the device as
    the inter chain's starting reference.  lf3: None or 3 loop-filter
    levels."""
    yy, uu, vv = unfuse(frame, height, width)
    o = encode_intra_wave(yy, uu, vv, qindex, bit_depth=bit_depth,
                          lam_scale=lam_scale, noise_gate=noise_gate)
    flat = torch.cat([o["levels_y"].reshape(-1), o["levels_u"].reshape(-1),
                      o["levels_v"].reshape(-1)])
    # the reference compacts with a key sort; its tail past the nonzero
    # values holds the zeros, so the cumsum-scatter gives the same buffer
    head, vals = compact_values(flat, min(cap, flat.shape[0]))
    buf = torch.cat([head, sig_bitmap(flat), vals,
                     o["modes"].reshape(-1).to(torch.int16),
                     o["txd"].reshape(-1).to(torch.int16)])
    rcy, rcu, rcv = o["recon_y"], o["recon_u"], o["recon_v"]
    if lf3 is not None:
        from av1tpu_torch.models.deblock import deblock_planes
        rows, cols = height // 16, width // 16
        dev = frame.device
        rcy, rcu, rcv = deblock_planes(
            rcy, rcu, rcv,
            torch.ones((rows, cols - 1), dtype=torch.bool, device=dev),
            torch.ones((rows - 1, cols), dtype=torch.bool, device=dev),
            lf3[0], lf3[1], lf3[2], 0, bit_depth)
    recon = torch.cat([rcy.reshape(-1), rcu.reshape(-1),
                       rcv.reshape(-1)]).to(torch.int32)
    return buf, recon


def split_compact_wave(buf: np.ndarray, height: int, width: int):
    """Copy of av1tpu/models/intra_wave.py:split_compact_wave (host
    numpy): the wavefront compact buffer [head | bitmap | vals | modes |
    txd] -> (count, bitmap uint16, values int16, modes int16, txd int16)."""
    count = int(buf[0]) | (int(buf[1]) << 15)
    nwords = (height * width + height * width // 2) // 16
    nblocks = (height // 16) * (width // 16)
    bitmap = buf[2 : 2 + nwords].view(np.uint16)
    vals = buf[2 + nwords : len(buf) - 2 * nblocks]
    modes = buf[len(buf) - 2 * nblocks : len(buf) - nblocks]
    txd = buf[len(buf) - nblocks :]
    return count, bitmap, vals, modes, txd


def encode_intra_wave_key_recon(frame, qindex: int, height: int, width: int,
                                cap: int = 163840, lf=None,
                                lam_scale: float = 1.0,
                                noise_gate: float = 0.0, bit_depth: int = 8):
    """The quality preset's keyframe: _wave_key_body with the loop-filter
    levels as a tuple of ints (None or all zero = no deblock).
    frame: fused [y | u | v] source (uint8, or int32 for 10-bit)."""
    lf3 = tuple(int(x) for x in lf) if (lf is not None and any(lf)) else None
    return _wave_key_body(frame, qindex, height, width, cap, lf3, lam_scale,
                          noise_gate, bit_depth)
