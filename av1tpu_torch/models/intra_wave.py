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
planes, modes, tx depths) on the device and codes each diagonal with the
two calls of kernels/intra_wave.py: hand CUDA kernels on the card, their
plain PyTorch versions (the arithmetic that used to be this loop's body)
on the CPU.  The schedule pads every diagonal to the longest one; the
padded lanes are never written (the kernels do not compute them).
"""

from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.kernels.intra_wave import (
    WaveTables, wave_luma16, wave_sub_chroma,
)
from av1tpu_torch.models.intra_v import (
    LAM_PIX, _plane_params, ac_squared, compact_values, fold_consts,
    from_blocks, sig_bitmap, unfuse,
)
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


def wave_diagonals(height: int, width: int) -> int:
    """The diagonals of a wavefront keyframe coded at height x width
    (multiples of 16): each is one launch of each of its two kernels."""
    return _diagonals(height // 16, width // 16)[0].shape[0]


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


def wave_tables(qindex: int, bit_depth: int, lam_scale: float,
                noise_gate: float, device) -> WaveTables:
    """The diagonal step's tables for one encode (kernels/intra_wave.py:
    WaveTables), from the device's constant tables."""
    from av1tpu_torch.models.rates import kf_mode_bits, qctx_index

    dev = torch.device(device)
    T = tables(dev)
    qctx = qctx_index(qindex)
    lam, lam_txd0 = wave_lambdas(qindex, bit_depth, lam_scale, dev)

    def consts(d):
        dr = np.zeros((len(WAVE_MODES), 2), np.int32)
        for m in (D45_PRED, D67_PRED):
            dr[m, 0] = DR_INTRA_DERIVATIVE[MODE_ANGLE[m]]
        dr[D203_PRED, 0] = DR_INTRA_DERIVATIVE[270 - MODE_ANGLE[D203_PRED]]
        for m in (D113_PRED, D135_PRED, D157_PRED):
            dr[m] = (DR_INTRA_DERIVATIVE[180 - MODE_ANGLE[m]],
                     DR_INTRA_DERIVATIVE[MODE_ANGLE[m] - 90])
        order = list(_TX_ORDER)

        def t(a, dt):
            return torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                   device=d)
        return {
            "fwd16": torch.stack([T.fwdt(16, x) for x in range(4)]),
            "fwd8": torch.stack([T.fwdt(8, x) for x in range(4)]),
            "fwd4": torch.stack([T.fwdt(4, x) for x in range(4)]),
            "gain16": torch.stack([T.coef_gains(16, x) for x in range(4)]),
            "gain8": torch.stack([T.coef_gains(8, x) for x in range(4)]),
            "gain4": torch.stack([T.coef_gains(4, x) for x in range(4)]),
            "gainc": T.coef_gains(8),
            "mode_bits": t(kf_mode_bits()[[WAVE_MODES[i] for i in order]],
                           torch.float32),
            "mode_vals": t([WAVE_MODES[i] for i in order], torch.int8),
            "grp_of_pos": t([x for x, idxs in _TX_GROUPS for _ in idxs],
                            torch.int64),
            # sub_chain predicts with row `pick` of the WAVE_MODES-ordered
            # stack, as the reference does (ROADMAP queue 3 item 1)
            "sub_pred_row": t(np.arange(len(WAVE_MODES)), torch.int64),
            "sm_w": t(np.concatenate([SM_WEIGHTS[n] for n in (4, 8, 16)]),
                      torch.int32),
            "pred_dr": t(dr, torch.int32),
            **{f"rank{n}": T.rate_model(n, 0).rank for n in (16, 8, 4)},
        }

    c = T.const("wave_tables", consts)
    rows = {}
    for n, key in ((16, "16"), (8, "8"), (4, "4"), (8, "c")):
        step, q, cap = _plane_params(qindex, n, bit_depth, dev)
        rows.update({f"step{key}": step, f"q{key}": q, f"cap{key}": cap,
                     f"off{key}": T.q_offsets(n * n)})
    for n in (16, 8, 4):
        rm = T.rate_model(n, 0)
        rows.update({f"tab{n}": rm.tabs[qctx], f"skip{n}": rm.skip[qctx],
                     f"eob{n}": rm.eob[qctx]})
    return WaveTables(lam=lam, lam_txd0=lam_txd0, gate=f32(noise_gate),
                      bit_depth=bit_depth, tabc=T.rate_tabs(8, 1)[qctx],
                      **c, **rows)


def wave_setup(y, u, v, qindex: int, bit_depth: int, lam_scale: float,
               noise_gate: float):
    """What a wavefront encode of the planes y, u, v carries: (tables,
    (src_y, src_u, src_v) int32 planes, the schedule as a list of per-
    diagonal wrapper arguments (r, c, valid, ur, bl, lane count, valid
    count), the eight zeroed grids rec_y, rec_u, rec_v, lv_y, lv_u, lv_v,
    modes, txds)."""
    h, w = y.shape
    dev = y.device
    rows, cols = h // 16, w // 16
    tabs = wave_tables(qindex, bit_depth, lam_scale, noise_gate, dev)
    src = tuple(p.to(torch.int32).contiguous() for p in (y, u, v))

    r_np, c_np, valid_np = _diagonals(rows, cols)
    n_lanes = r_np.shape[1]
    n_valid = valid_np.sum(axis=1)
    r_all = torch.as_tensor(r_np, dtype=torch.int64, device=dev)
    c_all = torch.as_tensor(c_np, dtype=torch.int64, device=dev)
    valid_all = torch.as_tensor(valid_np, device=dev)
    ur_all = torch.as_tensor(_ur_avail_grid(rows, cols)[r_np, c_np]
                             & valid_np, device=dev)
    bl_all = torch.as_tensor(_bl_avail_grid(rows, cols)[r_np, c_np]
                             & valid_np, device=dev)
    diags = [(r_all[d], c_all[d], valid_all[d], ur_all[d], bl_all[d],
              n_lanes, int(n_valid[d])) for d in range(r_np.shape[0])]

    def zeros(n, dtype, blocks=True):
        shape = (rows, cols, n, n) if blocks else (rows, cols)
        return torch.zeros(shape, dtype=dtype, device=dev)
    grids = [zeros(16, torch.int32), zeros(8, torch.int32),
             zeros(8, torch.int32), zeros(16, torch.int16),
             zeros(8, torch.int16), zeros(8, torch.int16),
             zeros(0, torch.int8, False), zeros(0, torch.int8, False)]
    return tabs, src, diags, grids


def wave_outputs(grids) -> dict:
    """encode_intra_wave's result from the eight carried grids."""
    rec_y, rec_u, rec_v, lv_y, lv_u, lv_v, modes, txds = grids
    return {"levels_y": lv_y, "levels_u": lv_u, "levels_v": lv_v,
            "modes": modes, "txd": txds,
            "recon_y": from_blocks(rec_y), "recon_u": from_blocks(rec_u),
            "recon_v": from_blocks(rec_v)}


def encode_intra_wave(y, u, v, qindex: int, bit_depth: int = 8,
                      lam_scale: float = 1.0, noise_gate: float = 0.0):
    """Full-frame wavefront intra encode.  Returns level grids, recon
    planes, per-block luma modes and tx depths (uv is DC_PRED everywhere).

    lam_scale: RDO lambda multiplier (a GOP keyframe is referenced by every
    following frame of the scene, so its distortion weighs more than its
    bits).  noise_gate: (3*sigma)^2 RDOQ noise floor, a Python float
    (0 = only exact zeros fall under it).

    Each diagonal is two calls, kernels/intra_wave.py's wave_luma16 and
    wave_sub_chroma: the hand kernels on the card, their plain versions on
    the CPU.  The schedule's lane and valid counts are host ints, so the
    loop never waits for the device."""
    tabs, (src_y, src_u, src_v), diags, grids = wave_setup(
        y, u, v, qindex, bit_depth, lam_scale, noise_gate)
    for diag in diags:
        best = wave_luma16(src_y, grids[0], tabs, *diag)
        wave_sub_chroma(src_y, src_u, src_v, *grids, tabs, *diag, *best)
    return wave_outputs(grids)


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
