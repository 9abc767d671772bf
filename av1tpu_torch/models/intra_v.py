"""Intra encode pipeline, V_PRED family (port of av1tpu/models/intra_v.py).

Fixed 16x16 luma / 8x8 chroma blocks.  V_PRED makes every block row depend
only on the reconstructed bottom row of the row above, so a plane encodes as
a loop over block rows with all columns batched; the first block row (which
predicts from the left neighbour's top edge pixel) is a per-column loop.
`_encode_plane` runs its forward transform + quantize through the hand
kernel (kernels/transform_quant.py) on CUDA, with the U and V planes in one
pass.

Bit depth is an explicit argument everywhere (the JAX package infers it from
a uint8/uint16 buffer dtype; 10-bit sources here are int32 tensors).
"""

from __future__ import annotations

import numpy as np
import torch

from av1tpu_torch.kernels.transform_quant import TQPlane, transform_quantize
from av1tpu_torch.ops.transforms import inverse_transform
from av1tpu_torch.state import tables

# deadzone rounding offsets (av1tpu/models/intra_v.py:44-45 defaults)
Q_OFFSET = 0.25
Q_OFFSET_DC = 0.25


def quantize_coefs(coefs: torch.Tensor, step: torch.Tensor,
                   cap: torch.Tensor) -> torch.Tensor:
    """Deadzone quantizer: sign(c) * floor(|c|/step + offset), clipped.
    coefs: (..., n*n) float32 with the DC coefficient at index 0.

    The offsets row is made on every call, and on a GPU writing its DC
    entry from the host waits for the stream (the fast keyframe's RDO
    calls it; the inter step's coder, code_blocks, and the partition
    probe's kernels hold the row as a constant of their CodePlane and
    PartSite).  When the inter chain still called it, a row kept on the
    device made the 48-frame 1080p encode about 1 s slower on an H100
    (PERF.md)."""
    off = torch.full((coefs.shape[-1],), Q_OFFSET, dtype=torch.float32,
                     device=coefs.device)
    off[0] = Q_OFFSET_DC
    return quantize_with_offsets(coefs, step, cap, off)


def quantize_with_offsets(coefs: torch.Tensor, step: torch.Tensor,
                          cap: torch.Tensor,
                          off: torch.Tensor) -> torch.Tensor:
    """quantize_coefs with a given (n*n,) float32 offsets row."""
    mag = torch.floor(coefs.abs() / step + off).to(torch.int32)
    lv = torch.sign(coefs).to(torch.int32) * mag
    return torch.clamp(lv, -cap, cap)


def plane_params_np(qindex: int, n: int, bit_depth: int, device):
    """Quantizer rows as numpy: step f32, q i32, cap i32, each (n*n,)."""
    dcq, acq = tables(device).quant_rows(bit_depth)
    q = np.full((n * n,), acq[qindex], np.int32)
    q[0] = dcq[qindex]
    # cap levels so dequantized values stay well inside int32 headroom and
    # below the decoder's inter-stage clamp (+-2^(bd+7))
    cap = np.minimum((1 << 16) // q, 1 << 14).astype(np.int32)
    return q.astype(np.float32), q, cap


def _plane_params(qindex: int, n: int, bit_depth: int, device):
    """Quantizer rows on `device`: step (f32), q (i32), cap (i32), (n*n,)."""
    step, q, cap = plane_params_np(qindex, n, bit_depth, device)
    return (torch.as_tensor(step, device=device),
            torch.as_tensor(q, device=device),
            torch.as_tensor(cap, device=device))


# pixel-domain RD lambda = LAM_PIX * ac^2 (the partition, wavefront and
# inter pipelines share it)
LAM_PIX = 0.0234


def ac_squared(qindex: int, bit_depth: int, device) -> np.float32:
    """ac * ac in float32 for the 16x16 AC step: the base of every scalar
    lambda."""
    ac = np.float32(plane_params_np(qindex, 16, bit_depth, device)[0][1])
    return np.float32(ac * ac)


def fold_consts(*consts: float) -> np.float32:
    """The one float32 constant that the reference's compiled graph
    multiplies by where its source reads x * c1 * c2 * ...: XLA rewrites
    (x * c1) * c2 into x * (c1 * c2) and folds the constants in float32,
    left to right."""
    out = np.float32(consts[0])
    for c in consts[1:]:
        out = np.float32(out * np.float32(c))
    return out


# above-right availability for 16x16 blocks in 64x64 superblocks (spec
# BlockDecoded model), rows by block row % 4, cols by block col % 4
_UR_MASK = np.array([[1, 1, 1, 1],
                     [1, 0, 1, 0],
                     [1, 1, 1, 0],
                     [1, 0, 1, 0]], np.bool_)

# (mode value, Dr_Intra_Derivative dx) for the above-only directional modes
_RDO_MODES = ((3, 64), (8, 27))  # D45, D67; V handled separately


def _avail_ur_grid(rows: int, cols: int) -> np.ndarray:
    """Copy of av1tpu/models/intra_v.py:_avail_ur_grid (numpy)."""
    g = np.zeros((rows, cols), np.bool_)
    for r in range(1, rows):
        g[r] = _UR_MASK[r % 4][np.arange(cols) % 4]
    g[:, cols - 1] = False
    return g


def _rs_pred(x):
    return (x + 16) >> 5


def _directional_pred(ae: torch.Tensor, dx: int, n: int) -> torch.Tensor:
    """ae: (cols, 2n) above edge (with above-right) -> (cols, n, n) pred.
    Spec 7.11.2.4 for pAngle < 90, upsample/edge-filter off."""
    i = np.arange(1, n + 1, dtype=np.int64)[:, None]
    j = np.arange(n, dtype=np.int64)[None, :]
    idx = i * dx
    pos = np.minimum((idx >> 6) + j, 2 * n - 1)
    shift = torch.as_tensor(((idx >> 1) & 0x1F).astype(np.int32),
                            device=ae.device)
    hit_max = torch.as_tensor(((idx >> 6) + j) >= (2 * n - 1),
                              device=ae.device)
    p0 = torch.as_tensor(pos.ravel(), device=ae.device)
    p1 = torch.as_tensor(np.minimum(pos + 1, 2 * n - 1).ravel(),
                         device=ae.device)
    g0 = ae[:, p0].reshape(-1, n, n)
    g1 = ae[:, p1].reshape(-1, n, n)
    p = _rs_pred(g0 * (32 - shift) + g1 * shift)
    last = ae[:, 2 * n - 1][:, None, None]
    return torch.where(hit_max[None], last, p)


def log2_rate(lv: torch.Tensor, dims) -> torch.Tensor:
    """The log2 level-rate proxy, 2 + log2(1 + |l|) per nonzero level,
    summed over dims (float32)."""
    a = lv.to(torch.float32).abs()
    return (torch.where(a > 0, 2.0, 0.0) + torch.log2(1.0 + a)).sum(dim=dims)


def rep2d(a: torch.Tensor, f: int) -> torch.Tensor:
    """Repeat each entry of the first two axes f times (a block map at a
    finer grid)."""
    return a.repeat_interleave(f, 0).repeat_interleave(f, 1)


def to_blocks(plane: torch.Tensor, n: int) -> torch.Tensor:
    """(..., H, W) planes -> (..., rows, cols, n, n) block views."""
    *lead, h, w = plane.shape
    return plane.reshape(*lead, h // n, n, w // n, n).transpose(-3, -2)


def from_blocks(b: torch.Tensor) -> torch.Tensor:
    """(..., rows, cols, n, n) blocks -> (..., rows*n, cols*n) planes."""
    *lead, rows, cols, n, _ = b.shape
    return b.transpose(-3, -2).reshape(*lead, rows * n, cols * n)


def _encode_plane(src: torch.Tensor, qindex: int, n: int, base: int,
                  tx_type: int = 0, bit_depth: int = 8):
    """Encode a stack of P planes with n x n blocks, V_PRED.  src: (P, H, W)
    int32 with H, W multiples of n.  The planes share n, tx_type and
    qindex and are coded independently; each forward transform + quantize
    launch (the hand kernel) takes the blocks of all P planes.  Returns
    (levels (P, rows, cols, n, n) int16, recon (P, H, W) int32)."""
    p, h, w = src.shape
    dev = src.device
    rows, cols = h // n, w // n
    pix_max = (1 << bit_depth) - 1
    step, q, cap = _plane_params(qindex, n, bit_depth, dev)
    plane = TQPlane(tables(dev).fwdt(n, tx_type), step[None], q[None],
                    cap[None])
    src_rows = to_blocks(src, n)                    # (P, rows, cols, n, n)

    def encode_blocks(blocks, pred):
        """blocks (..., n, n), pred broadcastable -> (levels i16, recon),
        both (..., n, n)."""
        resid = (blocks - pred).to(torch.float32)
        lv16, dq = transform_quantize(resid.reshape(-1, n * n), plane)
        r = inverse_transform(dq.reshape(resid.shape), n, n, tx_type)
        rec = torch.clamp(pred + r, 0, pix_max)
        return lv16.reshape(resid.shape), rec

    # first block row: per-column loop (missing-above rule: 127-style base
    # for the corner, else the left neighbour's reconstructed top pixel)
    edge = torch.full((p, 1, 1), base - 1, dtype=torch.int32, device=dev)
    lv0, rec0 = [], []
    for c in range(cols):
        lv, rec = encode_blocks(src_rows[:, 0, c], edge)
        edge = rec[:, :1, n - 1 :]
        lv0.append(lv)
        rec0.append(rec)
    levels = [torch.stack(lv0, dim=1)]
    recs = [torch.stack(rec0, dim=1)]

    # remaining rows: columns batched, the bottom row is the next predictor
    for r in range(1, rows):
        lv, rec = encode_blocks(src_rows[:, r], recs[-1][:, :, n - 1 :, :])
        levels.append(lv)
        recs.append(rec)
    return (torch.stack(levels, dim=1),
            from_blocks(torch.stack(recs, dim=1)))


def _encode_plane_rdo(src: torch.Tensor, qindex: int, n: int, base: int,
                      bit_depth: int = 8):
    """Luma encode with per-block mode RDO over {V_PRED, D45, D67} (modes
    predicted from the row above only).  Returns (levels int16, recon,
    modes (rows, cols) int8 AV1 mode values)."""
    h, w = src.shape
    dev = src.device
    rows, cols = h // n, w // n
    pix_max = (1 << bit_depth) - 1
    fwdt = tables(dev).fwdt(n, 0)
    step_np, _, _ = plane_params_np(qindex, n, bit_depth, dev)
    step, q, cap = _plane_params(qindex, n, bit_depth, dev)
    # RD cost in the coefficient domain: cost = D_coef + lambda * R with
    # lambda = 0.15 * Qstep^2 (float32, as the reference computes it)
    ac = np.float32(step_np[1])
    lam = float(ac * ac * np.float32(0.15))

    src_rows = to_blocks(src, n)
    avail = torch.as_tensor(_avail_ur_grid(rows, cols), device=dev)

    def tq_recon(blocks, pred):
        b = blocks.shape[0]
        resid = (blocks - pred).reshape(b, n * n).to(torch.float32)
        coefs = resid @ fwdt
        lv = quantize_coefs(coefs, step, cap)
        r = inverse_transform((lv * q).reshape(b, n, n), n, n, 0)
        rec = torch.clamp(pred + r, 0, pix_max)
        return lv.reshape(b, n, n).to(torch.int16), rec

    edge = torch.tensor(base - 1, dtype=torch.int32, device=dev)
    lv0, rec0 = [], []
    for c in range(cols):
        lv, rec = tq_recon(src_rows[0, c][None], edge)
        edge = rec[0, 0, n - 1]
        lv0.append(lv[0])
        rec0.append(rec[0])
    levels = [torch.stack(lv0)]
    recs = [torch.stack(rec0)]
    modes = [torch.full((cols,), 1, dtype=torch.int8, device=dev)]

    win_idx = torch.as_tensor(np.arange(cols)[:, None] * n
                              + np.arange(2 * n)[None, :], device=dev)
    k_lt_n = torch.arange(2 * n, device=dev)[None, :] < n
    mode_vals = torch.tensor([1] + [m for m, _ in _RDO_MODES],
                             dtype=torch.int8, device=dev)
    nm = 1 + len(_RDO_MODES)
    mode_bits = torch.tensor([0.0] + [4.0] * (nm - 1), dtype=torch.float32,
                             device=dev)[:, None]
    qb = q.reshape(n, n)
    bottom = recs[0][:, n - 1, :].reshape(-1)
    for r in range(1, rows):
        blocks = src_rows[r]
        av = avail[r]
        # above edge with above-right extension: (cols, 2n) windows
        padded = torch.cat([bottom, bottom[-1:].expand(n)])
        ae = padded[win_idx]
        repl = ae[:, n - 1][:, None]
        ae = torch.where(k_lt_n | av[:, None], ae, repl)

        pred_v = ae[:, None, :n].expand(cols, n, n)
        cands = [pred_v] + [_directional_pred(ae, dx, n)
                            for _, dx in _RDO_MODES]
        preds = torch.cat(cands, dim=0)                 # (nm*cols, n, n)
        blocks_r = blocks.repeat(nm, 1, 1)
        resid = (blocks_r - preds).reshape(nm * cols, n * n).to(
            torch.float32)
        coefs = resid @ fwdt
        lv_all = quantize_coefs(coefs, step, cap)
        d = coefs - lv_all * step
        dist = (d * d).sum(dim=1).reshape(nm, -1)
        alv = lv_all.to(torch.float32).abs()
        rate = (torch.where(alv > 0, 2.0, 0.0)
                + torch.log2(1.0 + alv)).sum(dim=1).reshape(nm, -1)
        rate = rate + mode_bits
        cost = dist + lam * rate                        # (nm, cols)
        choice = torch.argmin(cost, dim=0)              # first minimum
        lv_all = lv_all.reshape(nm, cols, n, n)
        preds = preds.reshape(nm, cols, n, n)
        sel = choice[None, :, None, None].expand(1, cols, n, n)
        lv = torch.gather(lv_all, 0, sel)[0]
        pred = torch.gather(preds, 0, sel)[0]
        rr = inverse_transform(lv * qb, n, n, 0)
        rec = torch.clamp(pred + rr, 0, pix_max)
        levels.append(lv.to(torch.int16))
        recs.append(rec)
        modes.append(mode_vals[choice])
        bottom = rec[:, n - 1, :].reshape(-1)
    return (torch.stack(levels), from_blocks(torch.stack(recs)),
            torch.stack(modes))


def encode_intra_v(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                   qindex: int, bit_depth: int = 8, rdo: bool = False):
    """Full-frame intra encode.  y: (H, W) int32 (16-aligned), u/v: (H/2,
    W/2) int32.  Returns the dict of level grids (int16), reconstructions
    (int32) and per-block luma modes (int8).  rdo=True selects the luma
    mode per block from {V, D45, D67}; chroma is V_PRED (ADST_DCT), U and V
    in one pass."""
    base = 1 << (bit_depth - 1)
    if rdo:
        ly, ry, modes = _encode_plane_rdo(y, qindex, 16, base,
                                          bit_depth=bit_depth)
    else:
        ly, ry = _encode_plane(y[None], qindex, 16, base, tx_type=0,
                               bit_depth=bit_depth)
        ly, ry = ly[0], ry[0]
        modes = torch.full((y.shape[0] // 16, y.shape[1] // 16), 1,
                           dtype=torch.int8, device=y.device)
    lc, rc = _encode_plane(torch.stack([u, v]), qindex, 8, base, tx_type=1,
                           bit_depth=bit_depth)
    return {"levels_y": ly, "levels_u": lc[0], "levels_v": lc[1],
            "recon_y": ry, "recon_u": rc[0], "recon_v": rc[1],
            "modes": modes}


def unfuse(f: torch.Tensor, height: int, width: int):
    """Fused [y | u | v] buffer -> three int32 planes."""
    ny = height * width
    nc = ny // 4
    return (f[:ny].reshape(height, width).to(torch.int32),
            f[ny : ny + nc].reshape(height // 2, width // 2).to(torch.int32),
            f[ny + nc :].reshape(height // 2, width // 2).to(torch.int32))


def wrap16(x: torch.Tensor) -> torch.Tensor:
    """int32 values in [0, 2^16) -> int16 with the same bits (the
    reference's uint16 -> int16 bitcast)."""
    return (((x + 32768) & 0xFFFF) - 32768).to(torch.int16)


def pack_bits(b: torch.Tensor) -> torch.Tensor:
    """Flags -> int16 words, 16 per word, LSB first, zero-padded to a whole
    word (the reference shifts and sums in uint16 and bitcasts; here it is
    int32 arithmetic wrapped to int16, so a word with bit 15 set comes out
    negative with the same bits)."""
    v = b.reshape(-1).to(torch.int32)
    pad = (-v.shape[0]) % 16
    if pad:
        v = torch.cat([v, torch.zeros(pad, dtype=torch.int32,
                                      device=v.device)])
    shifts = torch.arange(16, dtype=torch.int32, device=v.device)
    return wrap16((v.reshape(-1, 16) << shifts).sum(dim=1, dtype=torch.int32))


def sig_bitmap(flat: torch.Tensor) -> torch.Tensor:
    """Significance bitmap: 1 bit per coefficient, 16 per int16 word, LSB
    first."""
    return pack_bits(flat != 0)


def stable_partition(stream: torch.Tensor, keep: torch.Tensor):
    """The elements of `stream` where `keep` is set, in order, then the
    others, in order: what the reference's stable key sort (kept keys =
    position, dropped keys all equal) produces, as one cumsum-scatter."""
    k = keep.to(torch.int32)
    n_keep = k.sum()
    pos_keep = torch.cumsum(k, dim=0) - 1
    pos_drop = n_keep + torch.cumsum(1 - k, dim=0) - 1
    idx = torch.where(keep, pos_keep, pos_drop).to(torch.int64)
    return torch.empty_like(stream).scatter_(0, idx, stream)


def compact_values(flat: torch.Tensor, cap: int) -> tuple:
    """The first `cap` nonzero values of `flat` in order, zero-filled, as
    int16, plus the int16 [count_lo, count_hi] head.  A cumsum-scatter: the
    stable compaction the reference does with a scatter or lax.sort."""
    sig = flat != 0
    m = flat.shape[0]
    pos = torch.cumsum(sig.to(torch.int32), dim=0) - 1
    count = pos[-1] + 1
    dump = max(m, cap)
    idx = torch.where(sig & (pos < cap), pos,
                      torch.full_like(pos, dump)).to(torch.int64)
    out = torch.zeros((dump + 1,), dtype=torch.int16, device=flat.device)
    out.scatter_(0, idx, flat.to(torch.int16))
    head = torch.stack([count & 0x7FFF, count >> 15]).to(torch.int16)
    return head, out[:cap]


def _apply_lf(o: dict, lf, height: int, width: int, bit_depth: int):
    """In-loop deblock of keyframe recon (uniform 16-block edges)."""
    if lf is None or not any(lf):
        return o
    from av1tpu_torch.models.deblock import deblock_planes
    rows, cols = height // 16, width // 16
    dev = o["recon_y"].device
    ry, ru, rv = deblock_planes(
        o["recon_y"], o["recon_u"], o["recon_v"],
        torch.ones((rows, cols - 1), dtype=torch.bool, device=dev),
        torch.ones((rows - 1, cols), dtype=torch.bool, device=dev),
        lf[0], lf[1], lf[2], 0, bit_depth)
    o = dict(o)
    o["recon_y"], o["recon_u"], o["recon_v"] = ry, ru, rv
    return o


def compact_buffer(flat: torch.Tensor, meta, cap: int) -> torch.Tensor:
    """The compact transport buffer [count_lo, count_hi, significance
    bitmap, the first `cap` nonzero values, meta...] of the level list
    `flat`, with the int16 meta arrays (modes, split maps) appended."""
    head, vals = compact_values(flat, cap)
    return torch.cat([head, sig_bitmap(flat), vals,
                      *(m.reshape(-1).to(torch.int16) for m in meta)])


def encode_intra_v_key_recon(frame: torch.Tensor, qindex: int, height: int,
                             width: int, cap: int = 163840, rdo: bool = True,
                             lf=None, bit_depth: int = 8):
    """Fast-preset keyframe for a GOP: the compact int16 transport buffer
    [count_lo, count_hi, bitmap, values (cap), modes] and the fused int32
    reconstruction (device-resident reference for the inter chain).
    frame: fused [y | u | v] source (uint8, or int32 for 10-bit)."""
    y, u, v = unfuse(frame, height, width)
    o = encode_intra_v(y, u, v, qindex, bit_depth=bit_depth, rdo=rdo)
    o = _apply_lf(o, lf, height, width, bit_depth)
    flat = torch.cat([o["levels_y"].reshape(-1), o["levels_u"].reshape(-1),
                      o["levels_v"].reshape(-1)])
    buf = compact_buffer(flat, (o["modes"],), cap)
    recon = torch.cat([o["recon_y"].reshape(-1), o["recon_u"].reshape(-1),
                       o["recon_v"].reshape(-1)]).to(torch.int32)
    return buf, recon


def encode_intra_v_u8(frame: torch.Tensor, qindex: int, height: int,
                      width: int, rdo: bool = True, bit_depth: int = 8):
    """One fused source [y | u | v] in, one fused int16 buffer [levels y |
    u | v | per-block luma modes] out."""
    o = encode_intra_v(*unfuse(frame, height, width), qindex,
                       bit_depth=bit_depth, rdo=rdo)
    return torch.cat([o["levels_y"].reshape(-1), o["levels_u"].reshape(-1),
                      o["levels_v"].reshape(-1),
                      o["modes"].reshape(-1).to(torch.int16)])


def encode_intra_v_compact(frame: torch.Tensor, qindex: int, height: int,
                           width: int, cap: int = 163840, rdo: bool = True,
                           bit_depth: int = 8):
    """The compact transport of encode_intra_v_u8: [count_lo, count_hi,
    significance bitmap, nonzero values (cap slots), modes].  Past `cap`
    values the list is cut; the host retries with a larger cap."""
    nblocks = (height // 16) * (width // 16)
    full = encode_intra_v_u8(frame, qindex, height, width, rdo=rdo,
                             bit_depth=bit_depth)
    return compact_buffer(full[:-nblocks], (full[-nblocks:],), cap)


def encode_intra_v_chunk(frames: torch.Tensor, qindex: int, height: int,
                         width: int, cap: int = 163840, rdo: bool = True,
                         bit_depth: int = 8):
    """All-intra chunk of the fast preset: (K, n_pixels) fused sources ->
    (K, compact_len) int16, one encode_intra_v_compact per frame."""
    return torch.stack([encode_intra_v_compact(f, qindex, height, width,
                                               cap, rdo, bit_depth)
                        for f in frames])


def split_compact(buf: np.ndarray, height: int, width: int):
    """Copy of av1tpu/models/intra_v.py:split_compact (host numpy).
    Returns (count, bitmap uint16, values int16, modes int16)."""
    count = int(buf[0]) | (int(buf[1]) << 15)
    nwords = (height * width + height * width // 2) // 16
    nblocks = (height // 16) * (width // 16)
    bitmap = buf[2 : 2 + nwords].view(np.uint16)
    vals = buf[2 + nwords : len(buf) - nblocks]
    modes = buf[len(buf) - nblocks :]
    return count, bitmap, vals, modes


def fuse_planes(y, u, v, bit_depth: int = 8) -> np.ndarray:
    """Copy of av1tpu/models/intra_v.py:fuse_planes (host numpy): padded
    planes -> one fused buffer (uint8 for 8-bit, uint16 for 10-bit)."""
    dt = np.uint8 if bit_depth == 8 else np.uint16
    return np.concatenate([np.asarray(y, dt).ravel(),
                           np.asarray(u, dt).ravel(),
                           np.asarray(v, dt).ravel()])
