"""The wavefront keyframe as one persistent CUDA kernel, and its plain
version.

Port of the jitted step of av1tpu/models/intra_wave.py (`step`, :383,
scanned over the diagonals at :569; not a `pallas_call`).  `wave_key`
codes the diagonals [d0, d1) of a keyframe in one launch (the encode
passes them all): per lane (a 16x16 block of a diagonal)

- the 13 WAVE_MODES candidates at TX_16X16 (prediction, forward
  transform, quantize, rd_zero, inverse, SSE and rate), the D203 mask and
  the argmin (`wave_luma16_plain`);
- the winner re-coded at TX_8X8 and TX_4X4 with per-tx-block prediction
  (`sub_chain`), the tx-depth choice, U and V DC_PRED at 8x8, and the
  write of the lane into the carried grids (`wave_sub_chroma_plain`).

The hand kernel lives in av1tpu_torch/csrc/intra_wave.cu (built for
sm_90a by av1tpu_torch._build); the note at its top states its design,
what bounds it and why it cannot deadlock.  Every table the step reads is
checked once per encode, into a `WaveTables`, and the lane schedule once
per frame size, into a `WaveSchedule`; each call then checks the frame's
tensors.  The wrapper takes the plain version (the two plain pieces, once
each per diagonal) only for tensors on the CPU.  A CUDA tensor always
launches the kernel, and anything the kernel does not take raises: there
is no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from av1tpu_torch.kernels.transform_quant import _check

N_POS = 13          # mode candidates per block (WAVE_MODES)
MAX_GROUP = 4       # candidates of one transform type, at most
MAX_BLOCKS = 1 << 12  # block rows and columns a schedule entry holds


class WaveTabsC(ctypes.Structure):
    """The kernel's view of a WaveTables: device pointers and float32
    scalars, in the order of `struct WaveTabs` in csrc/intra_wave.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "fwd16", "fwd8", "fwd4",
        "step16", "q16", "cap16", "off16",
        "step8", "q8", "cap8", "off8",
        "step4", "q4", "cap4", "off4",
        "stepc", "qc", "capc", "offc",
        "tab16", "skip16", "rank16", "eob16",
        "tab8", "skip8", "rank8", "eob8",
        "tab4", "skip4", "rank4", "eob4", "tabc",
        "gain16", "gain8", "gain4", "gainc",
        "mode_bits", "mode_vals", "grp_of_pos", "sub_pred_row",
        "sm_w", "pred_dr")] + [
        ("lam", ctypes.c_float), ("lam_txd0", ctypes.c_float),
        ("gate", ctypes.c_float), ("bit_depth", ctypes.c_int)]


# name -> (dtype, shape) of every tensor of a WaveTables
_SPEC = {
    "fwd16": (torch.float32, (4, 256, 256)),
    "fwd8": (torch.float32, (4, 64, 64)),
    "fwd4": (torch.float32, (4, 16, 16)),
    **{f"{k}{n}": (dt, (nn,)) for n, nn in (("16", 256), ("8", 64),
                                             ("4", 16), ("c", 64))
       for k, dt in (("step", torch.float32), ("q", torch.int32),
                     ("cap", torch.int32), ("off", torch.float32))},
    **{f"tab{n}": (torch.float32, (256,)) for n in ("16", "8", "4", "c")},
    **{f"skip{n}": (torch.float32, (2,)) for n in ("16", "8", "4")},
    "rank16": (torch.int32, (16, 16)), "rank8": (torch.int32, (8, 8)),
    "rank4": (torch.int32, (4, 4)),
    "eob16": (torch.float32, (257,)), "eob8": (torch.float32, (65,)),
    "eob4": (torch.float32, (17,)),
    "gain16": (torch.float32, (4, 256)), "gain8": (torch.float32, (4, 64)),
    "gain4": (torch.float32, (4, 16)), "gainc": (torch.float32, (64,)),
    "mode_bits": (torch.float32, (N_POS,)),
    "mode_vals": (torch.int8, (N_POS,)),
    "grp_of_pos": (torch.int64, (N_POS,)),
    "sub_pred_row": (torch.int64, (N_POS,)),
    "sm_w": (torch.int32, (28,)),
    "pred_dr": (torch.int32, (N_POS, 2)),
}


class WaveTables:
    """Every table the keyframe step reads, checked once per encode.

    Candidates are indexed by their position in _TX_ORDER (grouped by the
    transform type their mode derives).  Tensors (all contiguous, on one
    device; `_SPEC` has each dtype and shape):
      fwd16/8/4: (4, n*n, n*n) transposed forward matrices per tx type
        (coefs = resid @ fwd[t]);
      step/q/cap/off 16, 8, 4 and c (chroma 8x8): quantizer rows and the
        deadzone offsets row (a constant, never written per call);
      tab16/8/4, skip, rank, eob: the luma RateModel rows of the encode's
        quality bucket; tabc: the chroma 8x8 bits per magnitude (rd_zero);
      gain16/8/4 (4, n*n) per tx type, gainc (64,): rd_zero's gains;
      mode_bits, mode_vals (int8), grp_of_pos (tx type): per position;
      sub_pred_row: position -> row of the WAVE_MODES-ordered prediction
        stack that sub_chain predicts with (the identity, the reference's
        row: it signals mode_vals[pick] but predicts with row pick);
      sm_w: SM_WEIGHTS at 4, 8 and 16 concatenated; pred_dr: (dx, dy)
        Dr_Intra_Derivative steps per mode value (the directional modes';
        0 elsewhere).
    Scalars: lam, lam_txd0 and gate as float32 values, bit_depth (8 or
    10).  Positions of one tx type must be contiguous and at most
    MAX_GROUP long, and the tx types 0..3 at most (the kernel codes each
    run on a CTA of its own, with that type's matrices).

    `groups` lists (tx type, candidates) in position order."""

    def __init__(self, *, lam, lam_txd0, gate, bit_depth: int, **tensors):
        if set(tensors) != set(_SPEC):
            raise ValueError(f"WaveTables: expected tensors {sorted(_SPEC)}, "
                             f"got {sorted(tensors)}")
        dev = tensors["fwd16"].device
        for name, (dtype, shape) in _SPEC.items():
            _check(name, tensors[name], dtype, shape, dev)
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        if bit_depth not in (8, 10):
            raise ValueError(f"bit_depth must be 8 or 10, got {bit_depth}")
        for name, v in (("lam", lam), ("lam_txd0", lam_txd0),
                        ("gate", gate)):
            if not isinstance(v, np.float32):
                raise TypeError(f"{name}: expected a numpy float32 value, "
                                f"got {type(v).__name__}")
        grp = tensors["grp_of_pos"].cpu().numpy()
        runs = [(int(t), int(np.sum(grp == t))) for t in dict.fromkeys(grp)]
        if (sorted(t for t, _ in runs) != list(range(len(runs)))
                or len(runs) > 4 or any(n > MAX_GROUP for _, n in runs)
                or not np.array_equal(grp, np.repeat(*zip(*runs)))):
            raise ValueError("grp_of_pos: each tx type's positions must be "
                             f"one run of at most {MAX_GROUP}, got {grp}")
        self.__dict__.update(tensors)
        self.lam, self.lam_txd0, self.gate = lam, lam_txd0, gate
        self.bit_depth = bit_depth
        self.device = dev
        self.groups = runs             # (tx type, candidates) in order
        if dev.type == "cpu":
            return
        from av1tpu_torch._build import cuda_lib

        self._key = cuda_lib().av1_wave_key
        self.c = WaveTabsC(
            **{k: tensors[k].data_ptr() for k, _ in WaveTabsC._fields_
               if k in tensors},
            lam=float(lam), lam_txd0=float(lam_txd0), gate=float(gate),
            bit_depth=bit_depth)
        self.c_ptr = ctypes.addressof(self.c)


class WaveSchedule:
    """The wavefront's lanes for one frame size on one device, in both
    forms the step takes.

    From numpy (nd, L) arrays r_i, c_i (block rows and columns), valid,
    ur, bl (bool: a lane exists; above-right available; D203 masked), each
    diagonal's valid lanes first (models/intra_wave.py:_diagonals):
      diags: per diagonal the plain version's arguments (r, c int64; valid,
        ur, bl bool; L; the valid count), tensors of L lanes;
      lanes: (N,) int32, the N valid lanes diagonal after diagonal, each
        r | c << 12 | ur << 24 | bl << 25 (the kernel's tickets);
      starts: nd + 1 host ints, diagonal d's lanes are lanes[starts[d] :
        starts[d + 1]]."""

    def __init__(self, rows: int, cols: int, r_i, c_i, valid, ur, bl,
                 device):
        if not (0 < rows <= MAX_BLOCKS and 0 < cols <= MAX_BLOCKS):
            raise ValueError(f"a schedule holds at most {MAX_BLOCKS} block "
                             f"rows and columns, got {rows} x {cols}")
        dev = torch.device(device)
        self.rows, self.cols, self.device = rows, cols, dev
        self.nd, n_lanes = r_i.shape
        n_valid = valid.sum(axis=1)
        self.starts = [0] + np.cumsum(n_valid).tolist()
        as_t = lambda a, dt=None: torch.as_tensor(a, dtype=dt, device=dev)
        r_all, c_all = as_t(r_i, torch.int64), as_t(c_i, torch.int64)
        v_all, ur_all, bl_all = as_t(valid), as_t(ur), as_t(bl)
        self.diags = [(r_all[d], c_all[d], v_all[d], ur_all[d], bl_all[d],
                       n_lanes, int(n_valid[d])) for d in range(self.nd)]
        packed = (r_i.astype(np.int64) | (c_i.astype(np.int64) << 12)
                  | (ur.astype(np.int64) << 24) | (bl.astype(np.int64) << 25))
        self.lanes = as_t(packed[valid].astype(np.int32))


def _check_frame(tabs: WaveTables, src_y, rec_y) -> tuple[int, int]:
    if src_y.dim() != 2 or src_y.shape[0] % 16 or src_y.shape[1] % 16:
        raise ValueError("src_y: expected (H, W) with H, W multiples of 16, "
                         f"got {tuple(src_y.shape)}")
    h, w = src_y.shape
    _check("src_y", src_y, torch.int32, (h, w), tabs.device)
    _check("rec_y", rec_y, torch.int32, (h // 16, w // 16, 16, 16),
           tabs.device)
    return h, w


def _on_card(tabs: WaveTables) -> bool:
    """Whether a call launches the kernel (tensors on the card) or runs the
    plain version (on the CPU)."""
    if tabs.device.type == "cpu":
        return False
    if tabs.device.index != torch.cuda.current_device():
        raise ValueError(f"tables on {tabs.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return True


def wave_luma16_plain(src_y, rec_y, tabs: WaveTables, r_i, c_i, valid, ur_ok,
                      bl, n_lanes: int, n_valid: int):
    """The luma half of wave_key's plain version: full-mode RDO at
    TX_16X16 for every lane of one diagonal (padded lanes included, then
    discarded).  r_i .. n_valid: WaveSchedule.diags[d].
    Returns (pick int64 (L,) position in _TX_ORDER, levels int16 (L, 16,
    16), recon int32 (L, 16, 16), cost_b float32 (L,) = the winner's cost
    + lam_txd0, grp_b int64 (L,) its tx type)."""
    return _luma16_plain(src_y, rec_y, tabs, r_i, c_i, valid, ur_ok, bl,
                         n_lanes)[:5]


def _luma16_plain(src_y, rec_y, tabs, r_i, c_i, valid, ur_ok, bl, n_lanes):
    """wave_luma16_plain's outputs and the (13, L) candidate costs."""
    from av1tpu_torch.models.intra_v import quantize_with_offsets, to_blocks
    from av1tpu_torch.models.intra_wave import (
        _D203_POS, _TX_GROUPS, _edges_from_blocks, _predict_modes,
    )
    from av1tpu_torch.models.rates import coef_bits
    from av1tpu_torch.models.rdoq import rd_zero
    from av1tpu_torch.ops.transforms import inverse_transform
    from av1tpu_torch.state import tables

    base = 1 << (tabs.bit_depth - 1)
    pix_max = (1 << tabs.bit_depth) - 1
    lam, gate = float(tabs.lam), float(tabs.gate)
    have_a = (r_i > 0) & valid
    have_l = (c_i > 0) & valid
    above32, left, corner = _edges_from_blocks(
        rec_y, r_i, c_i, have_a, have_l, ur_ok, base, 16)
    left2n = torch.cat([left, left[:, 15:].expand(n_lanes, 16)], dim=1)
    preds = _predict_modes(above32, left2n, corner, have_a, have_l,
                           base)                        # (M, L, 16, 16)
    src_b = to_blocks(src_y, 16)[r_i, c_i]              # (L, 16, 16)
    qf = tabs.q16.to(torch.float32)
    grp_rows = tables(src_y.device).const("wave_grp_rows", lambda d: [
        torch.tensor(idxs, device=d) for _, idxs in _TX_GROUPS])

    def code_luma(src, pred, tx):
        """(..., 16, 16) blocks coded at TX_16X16 with transform type tx ->
        levels, recon, dist, rate from the rate model.  Near-threshold
        levels are RD-pruned against the frame lambda."""
        sh = src.shape[:-2]
        resid = (src - pred).reshape(-1, 256).to(torch.float32)
        coefs = resid @ tabs.fwd16[tx]
        lv = quantize_with_offsets(coefs, tabs.step16, tabs.cap16,
                                   tabs.off16)
        lv = rd_zero(lv, coefs, qf, lam, tabs.tab16, tabs.gain16[tx],
                     noise_gate=gate)
        rec = torch.clamp(
            pred.reshape(-1, 16, 16)
            + inverse_transform((lv * tabs.q16).reshape(-1, 16, 16), 16, 16,
                                tx), 0, pix_max)
        e = rec - src.reshape(-1, 16, 16)
        dist = (e * e).sum(dim=(1, 2)).to(torch.float32)
        rate = coef_bits(lv.reshape(-1, 16, 16), tabs.tab16, tabs.skip16,
                         tabs.rank16, tabs.eob16)
        return (lv.reshape(sh + (16, 16)), rec.reshape(sh + (16, 16)),
                dist.reshape(sh), rate.reshape(sh))

    # per-tx-group residual coding (preds reordered to _TX_ORDER so the
    # concatenated candidates line up with mode_vals/mode_bits)
    parts = []
    for (t, _), gi in zip(_TX_GROUPS, grp_rows):
        pg = preds[gi]
        parts.append(code_luma(src_b[None].expand(pg.shape), pg, t))
    lv, rec, dist, rate = (torch.cat([p[k] for p in parts], dim=0)
                           for k in range(4))
    cost = dist + lam * (rate + tabs.mode_bits[:, None])
    # D203 is anti-causal where the decoder has real below-left pixels
    # (see _bl_avail_grid): exclude it there
    cost[_D203_POS] += torch.where(bl, float("inf"), 0.0)
    pick = torch.argmin(cost, dim=0)                    # (L,)
    sel16 = pick[None, :, None, None].expand(1, n_lanes, 16, 16)
    lv_b = torch.gather(lv, 0, sel16)[0].to(torch.int16)
    rec_b = torch.gather(rec, 0, sel16)[0]
    cost_b = cost.amin(dim=0) + float(tabs.lam_txd0)
    return pick, lv_b, rec_b, cost_b, tabs.grp_of_pos[pick], cost


def wave_sub_chroma_plain(src_y, src_u, src_v, rec_y, rec_u, rec_v, lv_y,
                          lv_u, lv_v, modes, txds, tabs: WaveTables, r_i,
                          c_i, valid, ur_ok, bl, n_lanes: int, n_valid: int,
                          pick, lv16, rec16, cost_b, grp_b) -> None:
    """The other half of wave_key's plain version: each lane's winner
    (wave_luma16_plain's pick, levels, recon, cost_b and grp_b) re-coded at
    TX_8X8 and TX_4X4 (sub_chain), the tx depth chosen, U and V coded with
    8x8 DC_PRED, and the valid lanes (the first n_valid) written into the
    carried grids rec_y/u/v, lv_y/u/v, modes and txds, which are updated in
    place."""
    _sub_chroma_plain(src_y, src_u, src_v, rec_y, rec_u, rec_v, lv_y, lv_u,
                      lv_v, modes, txds, tabs, r_i, c_i, valid, ur_ok,
                      n_lanes, n_valid, pick, lv16, rec16, cost_b, grp_b)


def _sub_chroma_plain(src_y, src_u, src_v, rec_y, rec_u, rec_v, lv_y, lv_u,
                      lv_v, modes, txds, tabs, r_i, c_i, valid, ur_ok,
                      n_lanes, n_valid, pick, lv16, rec16, cost_b, grp_b):
    """wave_sub_chroma_plain; returns the (L,) costs at tx depths 1 and
    2."""
    from av1tpu_torch.models.intra_v import quantize_with_offsets, to_blocks
    from av1tpu_torch.models.intra_wave import (
        _TXD_BITS, _edges_from_blocks, _predict_modes,
    )
    from av1tpu_torch.models.rates import coef_bits
    from av1tpu_torch.models.rdoq import rd_zero
    from av1tpu_torch.ops.transforms import inverse_transform
    from av1tpu_torch.state import tables

    dev = src_y.device
    T = tables(dev)
    L_ = n_lanes
    base = 1 << (tabs.bit_depth - 1)
    pix_max = (1 << tabs.bit_depth) - 1
    lam, gate = float(tabs.lam), float(tabs.gate)
    tx_ids = [t for t, _ in tabs.groups]
    have_a = (r_i > 0) & valid
    have_l = (c_i > 0) & valid
    above32, left, corner = _edges_from_blocks(
        rec_y, r_i, c_i, have_a, have_l, ur_ok, base, 16)
    src_b = to_blocks(src_y, 16)[r_i, c_i]
    mode_b = tabs.mode_vals[pick]
    grp_masks = [(grp_b == t) for t in tx_ids]
    mbits_b = tabs.mode_bits[pick]
    row_b = tabs.sub_pred_row[pick]
    ones = torch.ones_like(have_a)

    def clamped(lo: int, n: int, hi: int):
        """Device index row [lo, lo + n) clamped to hi (edge replication
        past a block's last decoded sample)."""
        return T.const(("wave_idx", lo, n, hi), lambda dv: torch.clamp(
            torch.arange(lo, lo + n, device=dv), max=hi))

    def sub_chain(ns, fwd, step, q, cap, off, tab, skip, rank, eob, gains):
        """Re-code every lane's winning mode at tx size ns with
        per-tx-block prediction (raster order inside the block, the
        decoder's coding order; edges come from already-reconstructed
        sub-blocks, with the spec's availability substitutions).  The
        prediction is row sub_pred_row[pick] of _predict_modes'
        WAVE_MODES-ordered stack, as in the reference."""
        k = 16 // ns
        recb = torch.zeros((L_, 16, 16), dtype=torch.int32, device=dev)
        lvb = torch.zeros((L_, 16, 16), dtype=torch.int16, device=dev)
        distb = torch.zeros(L_, dtype=torch.float32, device=dev)
        rateb = torch.zeros(L_, dtype=torch.float32, device=dev)
        qf = q.to(torch.float32)
        gain_l = gains[grp_b]                           # (L, ns*ns)
        sel = row_b[None, :, None, None].expand(1, L_, ns, ns)
        for si in range(k):
            for sj in range(k):
                y0, x0 = si * ns, sj * ns
                if si == 0:
                    a2 = above32[:, x0 : x0 + 2 * ns]
                    if sj > 0:  # frame-top row: decoder substitutes from
                        # the left neighbor's TOP pixel
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
                    # below-left of an interior sub is never decoded yet:
                    # replicate
                    l2 = recb[:, clamped(y0, 2 * ns, y0 + ns - 1), x0 - 1]
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
                resid = (srcs - pred).reshape(L_, ns * ns).to(torch.float32)
                coefs = torch.zeros_like(resid)
                for t, m in zip(tx_ids, grp_masks):
                    coefs = coefs + torch.where(m[:, None], resid @ fwd[t],
                                                0.0)
                lvq = quantize_with_offsets(coefs, step, cap, off)
                lvq = rd_zero(lvq, coefs, qf, lam, tab, gain_l,
                              noise_gate=gate)
                dq = (lvq * q).reshape(L_, ns, ns)
                inv = torch.zeros((L_, ns, ns), dtype=torch.int32, device=dev)
                for t, m in zip(tx_ids, grp_masks):
                    inv = inv + torch.where(m[:, None, None],
                                            inverse_transform(dq, ns, ns, t),
                                            0)
                recs = torch.clamp(pred + inv, 0, pix_max)
                e = recs - srcs
                distb = distb + (e * e).sum(dim=(1, 2)).to(torch.float32)
                rateb = rateb + coef_bits(lvq.reshape(L_, ns, ns), tab, skip,
                                          rank, eob)
                recb[:, y0 : y0 + ns, x0 : x0 + ns] = recs
                lvb[:, y0 : y0 + ns, x0 : x0 + ns] = lvq.reshape(
                    L_, ns, ns).to(torch.int16)
        return lvb, recb, distb, rateb

    lv8, rec8, dist8, rate8 = sub_chain(
        8, tabs.fwd8, tabs.step8, tabs.q8, tabs.cap8, tabs.off8, tabs.tab8,
        tabs.skip8, tabs.rank8, tabs.eob8, tabs.gain8)
    lv4, rec4, dist4, rate4 = sub_chain(
        4, tabs.fwd4, tabs.step4, tabs.q4, tabs.cap4, tabs.off4, tabs.tab4,
        tabs.skip4, tabs.rank4, tabs.eob4, tabs.gain4)
    cost8 = dist8 + lam * (rate8 + mbits_b + _TXD_BITS[1])
    cost4 = dist4 + lam * (rate4 + mbits_b + _TXD_BITS[2])
    txd_b = torch.where(cost8 < torch.minimum(cost_b, cost4), 1,
                        torch.where(cost4 < cost_b, 2, 0)).to(torch.int8)
    d1 = (txd_b == 1)[:, None, None]
    d2 = (txd_b == 2)[:, None, None]
    lv_b = torch.where(d1, lv8, torch.where(d2, lv4, lv16))
    rec_b = torch.where(d1, rec8, torch.where(d2, rec4, rec16))

    # ---- chroma: DC only ----
    qfc = tabs.qc.to(torch.float32)

    def dc8(rec_c):
        above2n, left8, _ = _edges_from_blocks(rec_c, r_i, c_i, have_a,
                                               have_l, ur_ok, base, 8)
        sa = above2n[:, :8].sum(dim=1, dtype=torch.int32)
        sl = left8.sum(dim=1, dtype=torch.int32)
        val = torch.where(have_a & have_l, (sa + sl + 8) >> 4,
                          torch.where(have_a, (sa + 4) >> 3,
                                      torch.where(have_l, (sl + 4) >> 3,
                                                  base)))
        return val[:, None, None].expand(val.shape[0], 8, 8)

    def code_chroma(src, pred):
        """8x8 DCT chroma blocks -> (levels, recon)."""
        resid = (src - pred).reshape(-1, 64).to(torch.float32)
        coefs = resid @ tabs.fwd8[0]
        lv = quantize_with_offsets(coefs, tabs.stepc, tabs.capc, tabs.offc)
        lv = rd_zero(lv, coefs, qfc, lam, tabs.tabc, tabs.gainc,
                     noise_gate=gate)
        rec = torch.clamp(
            pred + inverse_transform((lv * tabs.qc).reshape(-1, 8, 8), 8, 8,
                                     0), 0, pix_max)
        return lv.reshape(-1, 8, 8), rec

    lvu_b, recu_b = code_chroma(to_blocks(src_u, 8)[r_i, c_i], dc8(rec_u))
    lvv_b, recv_b = code_chroma(to_blocks(src_v, 8)[r_i, c_i], dc8(rec_v))

    # the padded lanes carry duplicate (0, 0) indices: write the valid
    # lanes only (they come first in every diagonal)
    nv = n_valid
    rv_, cv_ = r_i[:nv], c_i[:nv]
    rec_y[rv_, cv_] = rec_b[:nv]
    rec_u[rv_, cv_] = recu_b[:nv]
    rec_v[rv_, cv_] = recv_b[:nv]
    lv_y[rv_, cv_] = lv_b[:nv]
    lv_u[rv_, cv_] = lvu_b[:nv].to(torch.int16)
    lv_v[rv_, cv_] = lvv_b[:nv].to(torch.int16)
    modes[rv_, cv_] = mode_b[:nv]
    txds[rv_, cv_] = txd_b[:nv]
    return cost8, cost4




_GRIDS = ("rec_y", "rec_u", "rec_v", "lv_y", "lv_u", "lv_v", "modes",
          "txds")


def wave_key_plain(src_y, src_u, src_v, rec_y, rec_u, rec_v, lv_y, lv_u,
                   lv_v, modes, txds, tabs: WaveTables,
                   sched: WaveSchedule, d0: int, d1: int) -> None:
    """Plain version of wave_key: the diagonals d0 .. d1 - 1 in turn, each
    wave_luma16_plain then wave_sub_chroma_plain (the step's arithmetic)."""
    for d in range(d0, d1):
        diag = sched.diags[d]
        best = wave_luma16_plain(src_y, rec_y, tabs, *diag)
        wave_sub_chroma_plain(src_y, src_u, src_v, rec_y, rec_u, rec_v, lv_y,
                              lv_u, lv_v, modes, txds, tabs, *diag, *best)


def wave_key(src_y, src_u, src_v, rec_y, rec_u, rec_v, lv_y, lv_u, lv_v,
             modes, txds, tabs: WaveTables, sched: WaveSchedule, d0: int,
             d1: int) -> None:
    """The wavefront keyframe's diagonals [d0, d1) in one launch.  src_y:
    (H, W) int32 luma source, src_u, src_v: (H/2, W/2) int32; the carried
    grids rec_y (H/16, W/16, 16, 16) and rec_u, rec_v (H/16, W/16, 8, 8)
    int32, lv_y, lv_u, lv_v int16 shaped alike, modes, txds (H/16, W/16)
    int8, updated in place (the blocks of the diagonals before d0 must hold
    their final values); sched: the schedule of this frame size on the
    tables' device; 0 <= d0 < d1 <= sched.nd."""
    h, w = _check_frame(tabs, src_y, rec_y)
    dev, rows, cols = tabs.device, h // 16, w // 16
    for name, t, dtype, shape in (
            ("src_u", src_u, torch.int32, (h // 2, w // 2)),
            ("src_v", src_v, torch.int32, (h // 2, w // 2)),
            ("rec_u", rec_u, torch.int32, (rows, cols, 8, 8)),
            ("rec_v", rec_v, torch.int32, (rows, cols, 8, 8)),
            ("lv_y", lv_y, torch.int16, (rows, cols, 16, 16)),
            ("lv_u", lv_u, torch.int16, (rows, cols, 8, 8)),
            ("lv_v", lv_v, torch.int16, (rows, cols, 8, 8)),
            ("modes", modes, torch.int8, (rows, cols)),
            ("txds", txds, torch.int8, (rows, cols))):
        _check(name, t, dtype, shape, dev)
    if not isinstance(sched, WaveSchedule):
        raise TypeError(f"sched: expected a WaveSchedule, got "
                        f"{type(sched).__name__}")
    if (sched.rows, sched.cols) != (rows, cols) or sched.device != dev:
        raise ValueError(f"sched: for {sched.rows} x {sched.cols} blocks on "
                         f"{sched.device}, the frame is {rows} x {cols} on "
                         f"{dev}")
    for name, d in (("d0", d0), ("d1", d1)):
        if not isinstance(d, int) or isinstance(d, bool):
            raise TypeError(f"{name}: expected an int, got "
                            f"{type(d).__name__}")
    if not 0 <= d0 < d1 <= sched.nd:
        raise ValueError(f"diagonals [{d0}, {d1}) not in [0, {sched.nd})")
    if not _on_card(tabs):
        wave_key_plain(src_y, src_u, src_v, rec_y, rec_u, rec_v, lv_y, lv_u,
                       lv_v, modes, txds, tabs, sched, d0, d1)
        return
    lo, hi = sched.starts[d0], sched.starts[d1]
    # the ready flags, then the ticket counter
    flags = torch.zeros(rows * cols + 1, dtype=torch.int32, device=dev)
    err = tabs._key(
        tabs.c_ptr, src_y.data_ptr(), src_u.data_ptr(), src_v.data_ptr(), h,
        w, rec_y.data_ptr(), rec_u.data_ptr(), rec_v.data_ptr(),
        lv_y.data_ptr(), lv_u.data_ptr(), lv_v.data_ptr(), modes.data_ptr(),
        txds.data_ptr(), sched.lanes.data_ptr() + 4 * lo, hi - lo, d0,
        flags.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"wave_key kernel launch failed: cudaError {err}")
    wave_key.launches += 1


wave_key.launches = 0


def block_diffs(got, want) -> dict:
    """Blocks of two sets of the eight carried grids (rec_y .. txds) that
    differ: in the mode, else the tx depth, else a level (any plane), else
    a recon sample or the chroma (must not happen where the decisions and
    levels agree); and level_max_diff, the largest |level difference| in
    the blocks whose mode and tx depth agree.  Every count 0 means the two
    sets are equal bit for bit."""
    rows, cols = want[6].shape
    differs = {}
    for name, a, b in zip(_GRIDS, got, want):
        differs[name] = (a != b).reshape(rows, cols, -1).any(-1)
    mode = differs["modes"]
    txd = differs["txds"] & ~mode
    levels = (differs["lv_y"] | differs["lv_u"] | differs["lv_v"]) & ~(
        mode | txd)
    recon = (differs["rec_y"] | differs["rec_u"] | differs["rec_v"]) & ~(
        mode | txd | levels)
    level_max = 0
    for a, b in zip(got[3:6], want[3:6]):
        d = (a.int() - b.int()).abs().reshape(rows, cols, -1).amax(-1)
        level_max = max(level_max, int(torch.where(mode | txd, 0, d).max()))
    return {"blocks": rows * cols, "modes": int(mode.sum()),
            "txds": int(txd.sum()), "levels": int(levels.sum()),
            "recon": int(recon.sum()), "level_max_diff": level_max}


def wave_compare(y, u, v, qindex: int, bit_depth: int = 8,
                 lam_scale: float = 1.0, noise_gate: float = 0.0,
                 sync=None):
    """The kernel against its plain version from the same carried state:
    the plain keyframe of the planes y, u, v (on their device, the card),
    and at every diagonal d the kernel run over [d, d + 1) from the plain
    version's grids (copies).  Per valid lane, compares pick (from the
    signalled mode), tx depth and levels, and where all three agree the
    recon, the mode and the chroma.  Then the whole keyframe in one launch
    against the plain keyframe, and against the kernel's own chain of
    one-diagonal launches, each from the state the one before it left (a
    one-diagonal launch waits on no flag: its neighbours lie on earlier
    diagonals; the one launch waits on every flag).  Returns a dict:
    lanes; picks, txds (the differing lanes: diagonal, block row and
    column, both choices and the plain version's costs of both);
    level_lanes (decisions agree, a level differs) with level_max_diff;
    recon_lanes (decisions and levels agree, recon or mode differs: must
    be 0); whole (block_diffs of the one-launch keyframe against the plain
    one); chain (block_diffs of the one-launch keyframe against the
    chain: the kernel is deterministic, so every count must be 0); plain
    (encode_intra_wave's result of the plain keyframe); plain_seconds, the
    host clock around the plain calls, each interval closed by sync()
    (pass torch.cuda.synchronize on the card)."""
    import time

    from av1tpu_torch.models.intra_wave import wave_outputs, wave_setup

    tabs, src, sched, grids = wave_setup(y, u, v, qindex, bit_depth,
                                         lam_scale, noise_gate)
    src_y, src_u, src_v = src
    # the position that signals each mode value
    pos_of_mode = torch.full((N_POS,), -1, dtype=torch.int64)
    pos_of_mode[tabs.mode_vals.long().cpu()] = torch.arange(N_POS)
    out = {"lanes": 0, "picks": [], "txds": [], "level_lanes": 0,
           "level_max_diff": 0, "recon_lanes": 0, "plain_seconds": 0.0}
    sync = sync or (lambda: None)
    for d, diag in enumerate(sched.diags):
        r_i, c_i, nv = diag[0], diag[1], diag[6]
        kg = [g.clone() for g in grids]
        wave_key(*src, *kg, tabs, sched, d, d + 1)
        sync()
        t = time.perf_counter()
        pb = _luma16_plain(src_y, grids[0], tabs, *diag[:6])
        cost8, cost4 = _sub_chroma_plain(src_y, src_u, src_v, *grids, tabs,
                                         *diag[:4], *diag[5:], *pb[:5])
        sync()
        out["plain_seconds"] += time.perf_counter() - t
        rv, cv = r_i[:nv], c_i[:nv]
        pick_p = pb[0][:nv].cpu()
        pick_k = pos_of_mode[kg[6][rv, cv].long().cpu()]
        cost_p = pb[5][:, :nv].cpu()
        costs_t = torch.stack([pb[3][:nv], cost8[:nv], cost4[:nv]]).cpu()
        txd_p, txd_k = grids[7][rv, cv].cpu(), kg[7][rv, cv].cpu()
        lv_diff = torch.zeros(nv, dtype=torch.int32)
        for gi in (3, 4, 5):
            dl = (kg[gi][rv, cv].int() - grids[gi][rv, cv].int()).abs()
            lv_diff = torch.maximum(lv_diff, dl.reshape(nv, -1).amax(1).cpu())
        other = torch.zeros(nv, dtype=torch.bool)
        for gi in (0, 1, 2, 6):
            other |= (kg[gi][rv, cv] != grids[gi][rv, cv]).reshape(
                nv, -1).any(1).cpu()
        rows, cols = rv.cpu().tolist(), cv.cpu().tolist()
        for k in range(nv):
            a, b = int(pick_p[k]), int(pick_k[k])
            if a != b:
                out["picks"].append({
                    "diag": d, "r": rows[k], "c": cols[k], "plain": a,
                    "kernel": b, "plain_cost": float(cost_p[a, k]),
                    "kernel_choice_cost": float(cost_p[b, k])})
            elif int(txd_p[k]) != int(txd_k[k]):
                out["txds"].append({
                    "diag": d, "r": rows[k], "c": cols[k],
                    "plain": int(txd_p[k]), "kernel": int(txd_k[k]),
                    "plain_costs_txd012": costs_t[:, k].tolist()})
            elif int(lv_diff[k]):
                out["level_lanes"] += 1
                out["level_max_diff"] = max(out["level_max_diff"],
                                            int(lv_diff[k]))
            elif bool(other[k]):
                out["recon_lanes"] += 1
        out["lanes"] += nv
    whole = [torch.zeros_like(g) for g in grids]
    wave_key(*src, *whole, tabs, sched, 0, sched.nd)
    chain = [torch.zeros_like(g) for g in grids]
    for d in range(sched.nd):
        wave_key(*src, *chain, tabs, sched, d, d + 1)
    out["whole"] = block_diffs(whole, grids)
    out["chain"] = block_diffs(whole, chain)
    out["plain"] = wave_outputs(grids)
    return out
