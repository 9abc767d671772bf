"""Inter-frame encode pipeline (port of av1tpu/models/inter_v.py).

Every 16x16 block searches motion in the previous reconstruction,
motion-compensates with the normative 8-tap filters, and codes its residual
(16x16 luma DCT, 8x8 chroma DCT, deadzone quantize + RDOQ), with a joint
skip-vs-code RD choice per block.  The quality preset's partitioned step
(`encode_inter_part`) adds per-8x8 sub-block MVs at motion boundaries, a
per-block LAST/GOLDEN choice, and the merge of equal-MV blocks into 32x32
and 64x64 blocks by pixel-domain RD.  The search is hierarchical:

  1. coarse: a SAD sweep over +-8 samples on 4x4-pooled luma, with the
     frame-dominant shift snap, a second-basin candidate and the top-K
     global shifts;
  2. refine: +-2 full-pel around each candidate base (per-block patches);
  3. global: the best frame-global shift judged at full resolution;
  4. subpel: a 49-candidate quarter-pel sweep of normative 8-tap MC.

The reference builds its per-block patches with masked selects (TPU
gathers are slow); here they are clamped-index gathers, which the
reference's docstrings state are bit-identical (the edge padding there is
the normative frame-bound clamp).  Pixels stay int32 throughout: the
reference narrows the streamed search tensors to uint8/int16, but every
difference is widened before it is taken, so the values are the same.

Scalar lambdas are float32 values computed on the host with numpy float32
as the reference's compiled graph computes them (a chain of constant
factors folded into one float32 constant, intra_v.fold_consts) and passed
as Python floats.

Every residual coder here is a forward product (a matmul) followed by
kernels/inter_code.py:code_blocks (the quantize, rd_zero, the inverse
transform, the recon, the SSEs and the rate), with each site's constants
checked once into a cached CodePlane (`_coder`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from av1tpu_torch.kernels.inter_code import CodePlane, code_blocks
from av1tpu_torch.kernels.motion import (
    coarse_search, global_search, refine_subpel,
)
from av1tpu_torch.models.intra_v import (
    LAM_PIX, _plane_params, ac_squared, fold_consts, from_blocks, log2_rate,
    pack_bits, plane_params_np, rep2d, sig_bitmap, stable_partition,
    to_blocks, unfuse,
)
from av1tpu_torch.state import tables

f32 = np.float32

_SPLIT_OVERHEAD_BITS = 12.0  # extra signaling of 4 sub-blocks vs 1 merged
# merge-size lambda discount: excess distortion in a merged block compounds
# down the reference chain, while the bit saving is one-time
_REF_LAM_SCALE = 0.3
_MV_BIAS = 0.3
_COARSE_R = 8      # +-8 at quarter res = +-32 px, step 4 px
_REFINE_R = 2      # +-2 px local refine
_PATCH = 16 + 2 * _REFINE_R
MAX_MV_PX = 4 * _COARSE_R + _REFINE_R
_GLOBAL_K = 4
_SUBPEL_D = (-6, -4, -2, 0, 2, 4, 6)   # 1/8-pel offsets (quarter-pel grid)


def _block_sad(diff: torch.Tensor, n: int) -> torch.Tensor:
    """(H, W) abs-diff -> (H/n, W/n) int32 block sums."""
    h, w = diff.shape
    return diff.reshape(h // n, n, w // n, n).sum(dim=(1, 3),
                                                  dtype=torch.int32)


def _edge_pad(x: torch.Tensor, p: int) -> torch.Tensor:
    """Edge-replicating pad of the last two axes by p (clamped gather:
    F.pad(mode="replicate") takes no integer 2-D tensors)."""
    h, w = x.shape[-2:]
    ri = torch.clamp(torch.arange(-p, h + p, device=x.device), 0, h - 1)
    ci = torch.clamp(torch.arange(-p, w + p, device=x.device), 0, w - 1)
    return x[..., ri, :][..., ci]


def _exact_total(sads: torch.Tensor, dims) -> torch.Tensor:
    """Frame totals of integer-valued block SADs over dims: the exact
    integer sum, rounded once to float32.  (A float32 sum depends on its
    order once it passes 2^24, as a 1080p frame's totals do; the exact sum
    is the same on every device and in the hand kernels' 64-bit atomics.)"""
    return sads.sum(dim=dims, dtype=torch.int64).to(torch.float32)


def _mv_bias(m: np.ndarray, lam: np.float32) -> np.ndarray:
    """lam * (3 + log2(1 + 4|m|)) for m != 0, else 0 (float32)."""
    a = (np.abs(m).astype(f32) * f32(4.0)).astype(f32)
    b = np.where(a > 0, f32(3.0) + np.log2(f32(1.0) + a), f32(0.0))
    return (lam * b.astype(f32)).astype(f32)


def _coarse_search(src_q: torch.Tensor, ref_q: torch.Tensor, lam: np.float32,
                   snap_margin: np.float32):
    """Quarter-res full search.  src_q/ref_q: (H/4, W/4) int32.  Returns
    (best (r16, c16, 2), second-basin candidate (r16, c16, 2), shifts4
    (K, 2)) as int32 full-res px (multiples of 4)."""
    dev = src_q.device
    hq, wq = src_q.shape
    rows, cols = hq // 4, wq // 4
    r = _COARSE_R
    nd = 2 * r + 1
    pad = _edge_pad(ref_q, r)
    rows_sh = torch.stack([pad[r + dy : r + dy + hq, :]
                           for dy in range(-r, r + 1)])   # (nd, hq, wq+2r)
    dys_np = np.arange(-r, r + 1, dtype=np.int32)
    dys = torch.as_tensor(dys_np, device=dev)
    bias_np = _mv_bias(dys_np, lam)                       # (nd,)
    bias_dy = torch.as_tensor(bias_np, device=dev)

    inf = float("inf")
    best_cost = torch.full((rows, cols), inf, device=dev)
    best_sad = torch.full((rows, cols), inf, device=dev)
    best_dy = torch.zeros((rows, cols), dtype=torch.int32, device=dev)
    best_dx = torch.zeros((rows, cols), dtype=torch.int32, device=dev)
    sad_cols = []
    for dx in range(-r, r + 1):
        cand = rows_sh[:, :, r + dx : r + dx + wq]
        diff = (src_q[None] - cand).abs()
        sad = diff.reshape(nd, rows, 4, cols, 4).sum(
            dim=(2, 4), dtype=torch.int32).to(torch.float32)
        sad_cols.append(sad)
        add = (bias_np + _mv_bias(np.int32(dx), lam)).astype(f32)
        cost = sad + torch.as_tensor(add, device=dev)[:, None, None]
        c, k = torch.min(cost, dim=0)
        take = c < best_cost
        best_cost = torch.where(take, c, best_cost)
        best_sad = torch.where(take, sad.amin(dim=0), best_sad)
        best_dy = torch.where(take, dys[k], best_dy)
        best_dx = torch.where(take, dx, best_dx)

    # coherence snap to the frame-dominant shift where nearly as good
    all_sad = torch.stack(sad_cols, 1)                    # (dy, dx, r, c)
    totals = _exact_total(all_sad, (2, 3))
    g = torch.argmin(totals.reshape(-1))
    g_dy, g_dx = g // nd, g % nd
    sad_g = all_sad.reshape(nd * nd, rows, cols)[g]
    snap_g = sad_g <= best_sad + float(snap_margin)

    # second coarse candidate from a different basin (Chebyshev > 1)
    cost_vol = (all_sad + bias_dy[:, None, None, None]
                + bias_dy[None, :, None, None])
    ddy = (dys[:, None, None, None] - best_dy[None, None]).abs()
    ddx = (dys[None, :, None, None] - best_dx[None, None]).abs()
    near = torch.maximum(ddy, ddx) <= 1
    masked = torch.where(near, inf, cost_vol).reshape(nd * nd, rows, cols)
    k2 = torch.argmin(masked, dim=0)
    c2_dy = dys[k2 // nd]
    c2_dx = dys[k2 % nd]

    best_dy = torch.where(snap_g, dys[g_dy], best_dy)
    best_dx = torch.where(snap_g, dys[g_dx], best_dx)
    # top-K global shifts by quarter-res totals (ties: lower index first,
    # as lax.top_k orders them)
    topi = torch.sort(totals.reshape(-1), stable=True).indices[:_GLOBAL_K]
    shifts4 = torch.stack([dys[topi // nd], dys[topi % nd]], dim=-1) * 4
    return (torch.stack([best_dy, best_dx], dim=-1) * 4,
            torch.stack([c2_dy, c2_dx], dim=-1) * 4, shifts4)


def _gather_patches(ref: torch.Tensor, mv_px: torch.Tensor, n: int,
                    pad_each: int) -> torch.Tensor:
    """Per-block reference patches at the block MV.  ref: (H, W); mv_px:
    (rows, cols, 2) full-pel px.  Returns (rows, cols, n+2p, n+2p) with
    reads clamped to frame bounds (normative MC clamp)."""
    h, w = ref.shape
    rows, cols = mv_px.shape[:2]
    m = n + 2 * pad_each
    dev = ref.device
    ar = torch.arange(m, device=dev)
    ys = (torch.arange(rows, device=dev)[:, None, None, None] * n - pad_each
          + ar[None, None, :, None] + mv_px[:, :, 0:1, None])
    xs = (torch.arange(cols, device=dev)[None, :, None, None] * n - pad_each
          + ar[None, None, None, :] + mv_px[:, :, None, 1:2])
    ys = torch.clamp(ys, 0, h - 1)
    xs = torch.clamp(xs, 0, w - 1)
    return ref[ys, xs]


def _patches_select(ref: torch.Tensor, coarse_px: torch.Tensor):
    """(_PATCH x _PATCH) patches at the coarse MV (the reference's masked-
    select assembly equals this clamped gather)."""
    return _gather_patches(ref, coarse_px, 16, _REFINE_R)


def _patches40_select(ref: torch.Tensor, coarse_px: torch.Tensor,
                      off_px: torch.Tensor):
    """40x40 patches: row/col j <-> ref[16R + coarse + off + j - 12]."""
    return _gather_patches(ref, coarse_px + off_px, 16, 12)


def _refine_search(src_b: torch.Tensor, patches: torch.Tensor,
                   coarse_px: torch.Tensor, lam: np.float32):
    """+-_REFINE_R full-pel sweep with a running minimum.  Returns (mv
    (rows, cols, 2) px, sad, cost)."""
    dev = src_b.device
    shape = src_b.shape[:2]
    inf = float("inf")
    best_cost = torch.full(shape, inf, device=dev)
    best_sad = torch.full(shape, inf, device=dev)
    best = torch.zeros(shape + (2,), dtype=torch.int32, device=dev)
    unit = f32(f32(lam * f32(_MV_BIAS)) * f32(2.0))
    R = _REFINE_R
    offs = torch.tensor([(dy, dx) for dy in range(-R, R + 1)
                         for dx in range(-R, R + 1)], dtype=torch.int32,
                        device=dev)
    i = 0
    for dy in range(-R, R + 1):
        for dx in range(-R, R + 1):
            cand = patches[:, :, R + dy : R + dy + 16, R + dx : R + dx + 16]
            sad = (src_b - cand).abs().sum(dim=(2, 3), dtype=torch.int32).to(
                torch.float32)
            total = coarse_px + offs[i]
            i += 1
            cost = sad + float(f32(unit * f32(abs(dy) + abs(dx))))
            take = cost < best_cost
            best_cost = torch.where(take, cost, best_cost)
            best_sad = torch.where(take, sad, best_sad)
            best = torch.where(take[..., None], total, best)
    return best, best_sad, best_cost


def _global_full(src: torch.Tensor, ref: torch.Tensor,
                 shifts4: torch.Tensor):
    """Frame-global motion at full resolution: +-_REFINE_R around the top-2
    coarse global candidates and zero, then two descent steps from the
    running winner, judged by whole-plane SAD.  Returns (c0 (2,) 4-px
    base, g_full (2,), sad_g (rows, cols) per-block SAD at g_full).
    The candidate shifts are read on the host (three syncs per call): the
    reference's dynamic slices become static slices.  This is the plain
    version of kernels/motion.py:global_search, whose kernels read them
    on the card."""
    dev = src.device
    h, w = src.shape
    P = MAX_MV_PX + 8
    refp = _edge_pad(ref, P)

    def sad_at(d0: int, d1: int):
        pl = refp[P + d0 : P + d0 + h, P + d1 : P + d1 + w]
        return _block_sad((src - pl).abs(), 16).to(torch.float32)

    cands = [tuple(c) for c in shifts4[:2].tolist()] + [(0, 0)]
    best_tot = torch.tensor(float("inf"), device=dev)
    g_full = torch.tensor(cands[0], dtype=torch.int32, device=dev)
    sad_g = None

    def sweep(base, clip: bool):
        nonlocal best_tot, g_full, sad_g
        ds = []
        for dy in range(-_REFINE_R, _REFINE_R + 1):
            for dx in range(-_REFINE_R, _REFINE_R + 1):
                d = (base[0] + dy, base[1] + dx)
                if clip:
                    d = tuple(min(max(v, -MAX_MV_PX), MAX_MV_PX) for v in d)
                ds.append(d)
        dt = torch.tensor(ds, dtype=torch.int32, device=dev)
        for i, d in enumerate(ds):
            sadb = sad_at(*d)
            tot = _exact_total(sadb, (0, 1))
            take = tot < best_tot
            best_tot = torch.where(take, tot, best_tot)
            g_full = torch.where(take, dt[i], g_full)
            sad_g = sadb if sad_g is None else torch.where(take, sadb, sad_g)

    for base in cands:
        sweep(base, clip=False)
    # iterative full-res descent from the running winner
    for _ in range(2):
        sweep(tuple(g_full.tolist()), clip=True)
    c0 = torch.clamp(((g_full + 2) >> 2) << 2, -4 * _COARSE_R,
                     4 * _COARSE_R)
    return c0, g_full, sad_g


def _subpel_refine(src_b: torch.Tensor, P24: torch.Tensor,
                   mv_px: torch.Tensor, lam: np.float32, pix_max: int):
    """Quarter-pel sweep around the full-pel winner: every candidate is the
    normative 8-tap MC (InterRound0/1).  src_b: (rows, cols, 16, 16);
    P24: 24x24 patches at mv_px (pad 4).  Returns (mv8 1/8-pel, pred)."""
    dev = src_b.device
    bank = tables(dev).subpel_bank_np()
    shape = src_b.shape[:2]
    hors = {}
    for dx in _SUBPEL_D:
        ix = dx >> 3
        f = bank[(dx & 7) << 1]
        h = torch.zeros(shape + (24, 16), dtype=torch.int32, device=dev)
        for k in range(8):
            h = h + int(f[k]) * P24[..., :, 1 + ix + k : 17 + ix + k]
        hors[dx] = (h + 4) >> 3                             # InterRound0

    inf = float("inf")
    best_cost = torch.full(shape, inf, device=dev)
    best_sad = torch.full(shape, inf, device=dev)
    best_d = torch.zeros(shape + (2,), dtype=torch.int32, device=dev)
    best_pred = torch.zeros(shape + (16, 16), dtype=torch.int32, device=dev)
    offs = torch.tensor([(dy, dx) for dy in _SUBPEL_D for dx in _SUBPEL_D],
                        dtype=torch.int32, device=dev)
    unit = f32(lam * f32(_MV_BIAS))
    sads = []
    i = 0
    for dy in _SUBPEL_D:
        iy = dy >> 3
        g = bank[(dy & 7) << 1]
        for dx in _SUBPEL_D:
            v = torch.zeros(shape + (16, 16), dtype=torch.int32, device=dev)
            hh = hors[dx]
            for k in range(8):
                v = v + int(g[k]) * hh[..., 1 + iy + k : 17 + iy + k, :]
            v = torch.clamp((v + 1024) >> 11, 0, pix_max)   # InterRound1
            sad = (src_b - v).abs().sum(dim=(2, 3), dtype=torch.int32).to(
                torch.float32)
            sads.append(sad)
            bias = f32(unit * f32(f32(2.0) * f32(dy != 0)
                                  + f32(2.0) * f32(dx != 0)))
            cost = sad + float(bias)
            take = cost < best_cost
            best_cost = torch.where(take, cost, best_cost)
            best_sad = torch.where(take, sad, best_sad)
            best_d = torch.where(take[..., None], offs[i], best_d)
            best_pred = torch.where(take[..., None, None], v, best_pred)
            i += 1

    # dominant-offset coherence snap
    totals = _exact_total(torch.stack(sads), (1, 2))
    gi = torch.argmin(totals)
    d_g = offs[gi]
    hor_g = torch.zeros(shape + (24, 16), dtype=torch.int32, device=dev)
    for dx in _SUBPEL_D:
        hor_g = hor_g + torch.where(d_g[1] == dx, hors[dx], 0)
    pred_g = torch.zeros(shape + (16, 16), dtype=torch.int32, device=dev)
    for dy in _SUBPEL_D:
        iy = dy >> 3
        g = bank[(dy & 7) << 1]
        v = torch.zeros(shape + (16, 16), dtype=torch.int32, device=dev)
        for k in range(8):
            v = v + int(g[k]) * hor_g[..., 1 + iy + k : 17 + iy + k, :]
        v = torch.clamp((v + 1024) >> 11, 0, pix_max)
        pred_g = pred_g + torch.where(d_g[0] == dy, v, 0)
    sad_g = (src_b - pred_g).abs().sum(dim=(2, 3), dtype=torch.int32).to(
        torch.float32)
    snap = sad_g <= best_sad + float(f32(lam * f32(14.0)))
    best_d = torch.where(snap[..., None], d_g, best_d)
    best_pred = torch.where(snap[..., None, None], pred_g, best_pred)
    return mv_px * 8 + best_d, best_pred


def _chroma_patches_select(ref2: torch.Tensor, mv_int: torch.Tensor):
    """Per-block 16x16 chroma patches (8-block + 4 pad) of both planes at
    the integer chroma MV.  ref2: (2, H/2, W/2)."""
    return torch.stack([_gather_patches(ref2[0], mv_int, 8, 4),
                        _gather_patches(ref2[1], mv_int, 8, 4)])


def _chroma_mc_pair(ref_u: torch.Tensor, ref_v: torch.Tensor,
                    mv8: torch.Tensor, pix_max: int):
    """8x8 chroma MC of both planes for 1/8-pel luma MVs (separable 8-tap
    EIGHTTAP-regular at 1/16-pel chroma resolution, rounding 3 then 11).
    Returns (pred_u, pred_v) int32 (rows, cols, 8, 8)."""
    mv_int = torch.stack([mv8[..., 0] >> 4, mv8[..., 1] >> 4], -1)
    fy = (mv8[..., 0] & 15).long()
    fx = (mv8[..., 1] & 15).long()
    patch = _chroma_patches_select(torch.stack([ref_u, ref_v]), mv_int)
    bank = tables(mv8.device).subpel_bank()
    tx = bank[fx]
    ty = bank[fy]
    hor = torch.zeros(patch.shape[:3] + (16, 8), dtype=torch.int32,
                      device=mv8.device)
    for k in range(8):
        hor = hor + tx[None, :, :, k, None, None] * patch[..., :, k + 1 : k + 9]
    hor = (hor + 4) >> 3                                    # InterRound0
    out = torch.zeros(patch.shape[:3] + (8, 8), dtype=torch.int32,
                      device=mv8.device)
    for k in range(8):
        out = out + ty[None, :, :, k, None, None] * hor[..., k + 1 : k + 9, :]
    out = torch.clamp((out + 1024) >> 11, 0, pix_max)      # InterRound1
    return out[0], out[1]


@functools.cache
def _coder(qindex: int, bit_depth: int, device, n: int, ptype: int,
           quant_n: int, dq_shift: int, lam: np.float32, gate,
           with_rate: bool) -> CodePlane:
    """The CodePlane of one coder site, built and checked once: n x n
    blocks of plane type ptype, quantized with the rows of the quant_n x
    quant_n transform with step * 2^-dq_shift (32x32: the step halved and
    the dequantize shifted by 1; TX_64X64: the 32x32 rows at a quarter,
    shifted by 2), the rate rows of the frame's quality bucket, lambda
    lam and the optional noise gate; with_rate returns the RateModel's
    bits."""
    from av1tpu_torch.models.rates import qctx_index

    T = tables(device)
    step, q, cap = _plane_params(qindex, quant_n, bit_depth, device)
    if dq_shift:
        step = step * (0.5 ** dq_shift)
    rm = T.rate_model(n, ptype)
    qctx = qctx_index(qindex)
    rate = (dict(skip=rm.skip[qctx], rank=rm.rank.contiguous(),
                 eob=rm.eob[qctx])
            if with_rate else {})
    return CodePlane(n=n, step=step, q=q, cap=cap, gains=T.coef_gains(n),
                     tab=rm.tabs[qctx], lam=lam, gate=gate,
                     dq_shift=dq_shift, bit_depth=bit_depth, **rate)


def _code_plane_inter(src: torch.Tensor, pred: torch.Tensor,
                      plane: CodePlane):
    """Batched residual coding: (rows, cols, n, n) src/pred -> (levels i16,
    recon blocks, dist (rows, cols), dskip).  Near-threshold levels are
    RD-pruned (rdoq.rd_zero) with the plane's rate row and lambda."""
    n = plane.n
    rows, cols = src.shape[:2]
    s = src.reshape(-1, n, n).contiguous()
    p = pred.reshape(-1, n, n).contiguous()
    coefs = (s - p).reshape(-1, n * n).to(torch.float32) @ tables(
        src.device).fwdt(n, 0)
    lv, rec, dist, _, dskip = code_blocks(coefs, s, p, plane)
    return (lv.reshape(rows, cols, n, n).to(torch.int16),
            rec.reshape(rows, cols, n, n), dist.reshape(rows, cols),
            dskip.reshape(rows, cols))


def _search_mv(y: torch.Tensor, ref_y: torch.Tensor, lam: np.float32,
               pix_max: int, prev_mv=None):
    """Full luma motion search (coarse + snap, refine around the coarse
    winner, a second-basin candidate and, where given, the co-located
    previous frame's MV, the full-resolution global candidate, then the
    quarter-pel sweep).  y/ref_y: (H, W) int32; lam: float32 SAD-domain
    lambda; prev_mv: optional (rows, cols, 2) int32 full-pel MV field of
    the previous frame.  Returns (mv8 1/8-pel, pred_y (rows, cols, 16, 16),
    src_b, (p40, mv_px)): the 40x40 patches and the full-pel winner feed
    the 8x8 sub-block stage's extended MC."""
    p = _search_parts(y, ref_y, lam, pix_max, prev_mv)
    return p["mv8"], p["pred_y"], p["src_b"], (p["p40"], p["mv_px"])


def _search_parts(y: torch.Tensor, ref_y: torch.Tensor, lam: np.float32,
                  pix_max: int, prev_mv=None) -> dict:
    """_search_mv's stages with every intermediate: kernels/motion.py's
    coarse_search, global_search and refine_subpel (on the card, their
    kernels: nothing is read back to the host), then the 40x40 patches."""
    lam = f32(lam)
    coarse, coarse2, shifts4 = coarse_search(y, ref_y, lam)
    bases = [coarse, coarse2]
    if prev_mv is not None:
        # temporal base: nearest 4-aligned point (the +-2 refine sweep
        # then covers the exact previous MV), clipped to the coarse range
        bases.append(torch.clamp(((prev_mv + 2) >> 2) << 2,
                                 -4 * _COARSE_R, 4 * _COARSE_R))
    c0, g_full, sad_g = global_search(y, ref_y, shifts4)
    mv8, pred_y, mv_px, coarse_f, off_f = refine_subpel(
        y, ref_y, bases, c0, g_full, sad_g, lam, pix_max)
    return dict(coarse=coarse, coarse2=coarse2, shifts4=shifts4, c0=c0,
                g_full=g_full, sad_g=sad_g, mv8=mv8, pred_y=pred_y,
                mv_px=mv_px, src_b=to_blocks(y, 16),
                p40=_patches40_select(ref_y, coarse_f, off_f))


def _rate_of(lv: torch.Tensor) -> torch.Tensor:
    return log2_rate(lv, (-2, -1))


@functools.cache
def inter_lambdas(qindex: int, bit_depth: int, device):
    """(lam, lamp) float32: the SAD-domain search lambda and the pixel-
    domain RD lambda, both from the 16x16 AC step (once per q: a layered
    chunk alternates two)."""
    ac = f32(plane_params_np(qindex, 16, bit_depth, device)[0][1])
    lamp = f32(f32(ac * ac) * f32(LAM_PIX))
    return f32(np.sqrt(lamp)), lamp


def encode_inter_v(y, u, v, ref_y, ref_u, ref_v, qindex: int,
                   bit_depth: int = 8):
    """Encode one inter frame against the previous reconstruction.
    y: (H, W) int32, 64-multiple dims; u/v: (H/2, W/2); ref_*: the LAST
    frame's reconstruction.  Returns dict with levels_y (r16, c16, 16, 16)
    int16, levels_u/v (r16, c16, 8, 8) int16, mv (r16, c16, 2) int32
    1/8-pel (row, col), and recon planes (int32)."""
    dev = y.device
    lam, lamp = inter_lambdas(qindex, bit_depth, dev)
    pix_max = (1 << bit_depth) - 1
    mv8, pred_y, src_b, _ = _search_mv(y, ref_y, lam, pix_max)
    pred_u, pred_v = _chroma_mc_pair(ref_u, ref_v, mv8, pix_max)

    lp = float(lamp)
    py, pc = (_coder(qindex, bit_depth, dev, n, ptype, n, 0, lamp, None,
                     False) for n, ptype in ((16, 0), (8, 1)))
    ly, ry, dy, dsky = _code_plane_inter(src_b, pred_y, py)
    lu, ru, du_, dsku = _code_plane_inter(to_blocks(u, 8), pred_u, pc)
    lv, rv, dv_, dskv = _code_plane_inter(to_blocks(v, 8), pred_v, pc)
    # joint skip-vs-code RD per 16-block (one skip flag covers all planes)
    coded = (dy + du_ + dv_
             + lp * (_rate_of(ly) + _rate_of(lu) + _rate_of(lv)))
    m = (dsky + dsku + dskv + lp) < coded
    me = m[:, :, None, None]
    ly, lu, lv = (torch.where(me, 0, t) for t in (ly, lu, lv))
    ry = torch.where(me, pred_y, ry)
    ru = torch.where(me, pred_u, ru)
    rv = torch.where(me, pred_v, rv)
    return {"levels_y": ly, "levels_u": lu, "levels_v": lv, "mv": mv8,
            "recon_y": from_blocks(ry), "recon_u": from_blocks(ru),
            "recon_v": from_blocks(rv)}


def inter_sizes(height: int, width: int):
    nb = (height // 16) * (width // 16)
    return nb, nb * 256 + 2 * nb * 64


def _compact(levels_flat: torch.Tensor, mv: torch.Tensor, cap: int):
    """[count_lo, count_hi, bitmap, vals(min(cap, m)), mv_y, mv_x] int16:
    the nonzero levels in order (the reference's stable key sort), then
    zeros, truncated to the value capacity."""
    from av1tpu_torch.models.intra_v import compact_values

    m = levels_flat.shape[0]
    head, vals = compact_values(levels_flat, min(cap, m))
    return torch.cat([head, sig_bitmap(levels_flat), vals,
                      mv[..., 0].reshape(-1).to(torch.int16),
                      mv[..., 1].reshape(-1).to(torch.int16)])


def split_compact_inter(buf: np.ndarray, height: int, width: int):
    """Copy of av1tpu/models/inter_v.py:split_compact_inter (host numpy)
    -> (count, bitmap u16, vals i16, mv (r16, c16, 2) i32)."""
    nb, ncoef = inter_sizes(height, width)
    nwords = ncoef // 16
    count = int(buf[0]) | (int(buf[1]) << 15)
    bitmap = buf[2 : 2 + nwords].view(np.uint16)
    vals = buf[2 + nwords : len(buf) - 2 * nb]
    mvs = buf[len(buf) - 2 * nb :].astype(np.int32)
    mv = np.stack([mvs[:nb], mvs[nb:]], axis=-1).reshape(
        height // 16, width // 16, 2)
    return count, bitmap, vals, mv


def _gop_step_body(frame: torch.Tensor, ref_fused: torch.Tensor,
                   qindex: int, height: int, width: int, cap: int,
                   lf3=None, cdef_s=None, bit_depth: int = 8):
    """One inter frame against the fused running recon.  lf3: None or 3
    loop-filter levels; cdef_s: None or 4 coded CDEF strengths (Python
    ints).  Returns (compact int16 buffer, new fused recon int32)."""
    yy, uu, vv = unfuse(frame, height, width)
    ry, ru, rv = unfuse(ref_fused, height, width)
    o = encode_inter_v(yy, uu, vv, ry, ru, rv, qindex, bit_depth=bit_depth)
    flat = torch.cat([o["levels_y"].reshape(-1), o["levels_u"].reshape(-1),
                      o["levels_v"].reshape(-1)])
    buf = _compact(flat, o["mv"], cap)
    rcy, rcu, rcv = o["recon_y"], o["recon_u"], o["recon_v"]
    dev = frame.device
    if lf3 is not None:
        from av1tpu_torch.models.deblock import deblock_planes
        rows, cols = height // 16, width // 16
        rcy, rcu, rcv = deblock_planes(
            rcy, rcu, rcv,
            torch.ones((rows, cols - 1), dtype=torch.bool, device=dev),
            torch.ones((rows - 1, cols), dtype=torch.bool, device=dev),
            lf3[0], lf3[1], lf3[2], 0, bit_depth)
    if cdef_s is not None:
        from av1tpu_torch.models.cdef import (
            cdef_planes, skip8_of, skip16_from_levels,
        )
        s16 = skip16_from_levels(o["levels_y"], o["levels_u"],
                                 o["levels_v"])
        rcy, rcu, rcv = cdef_planes(rcy, rcu, rcv, skip8_of(s16),
                                    cdef_s[0], cdef_s[1], cdef_s[2],
                                    cdef_s[3], 3, bit_depth)
    new_ref = torch.cat([rcy.reshape(-1), rcu.reshape(-1), rcv.reshape(-1)])
    return buf, new_ref


def encode_gop_chunk(frames: torch.Tensor, ref_fused: torch.Tensor,
                     qindex: int, height: int, width: int, cap: int = 131072,
                     lf=None, cdef_s=None, bit_depth: int = 8):
    """Encode a chunk of inter frames against a running reconstruction.
    frames: (K, n_pixels) fused sources; ref_fused: (n_pixels,) int32 fused
    recon of the preceding frame.  A Python loop that carries the fused
    recon on the device.  Returns (list of K compact int16 buffers, final
    fused recon int32)."""
    lf3 = tuple(int(x) for x in lf) if (lf is not None and any(lf)) else None
    cs = None if cdef_s is None else tuple(int(x) for x in cdef_s)
    bufs = []
    ref = ref_fused
    for k in range(frames.shape[0]):
        buf, ref = _gop_step_body(frames[k], ref, qindex, height, width,
                                  cap, lf3, cs, bit_depth)
        bufs.append(buf)
    return bufs, ref


# ----------------------------------------------------------------------
# partitioned inter: 8x8 sub-block MVs at motion boundaries, LAST/GOLDEN
# per block, and the merge of equal-MV 16-blocks into 32x32 / 64x64 NONE
# blocks by pixel-domain RD
# ----------------------------------------------------------------------

_SUB8_NONPARENT_BITS = 10.0   # NEWMV diff / DRL cost of a sub-block MV
_SUB8_HDR_BITS = 4.0          # per-sub-block skip+mode+ref signaling


def _mc_ext32(P40: torch.Tensor, mv8: torch.Tensor, mv_px: torch.Tensor,
              pix_max: int):
    """Extended 32x32 normative luma MC per 16-block at its own 1/8-pel
    MV: E[r, c][a, b] = MC of pixel (16r + a - 8, 16c + b - 8) at
    mv8[r, c] (EIGHTTAP regular, InterRound0/1), so the [8:24, 8:24]
    center equals the block's own prediction bit-exactly.  P40: patches
    from _patches40_select at the full-pel search winner mv_px; mv8 =
    8*mv_px + d with d in [-6, 6], so the integer part mv8 >> 3 is mv_px
    or mv_px - 1 per axis, folded in as a +-1 read shift."""
    dev = P40.device
    sy = ((mv8[..., 0] >> 3) - mv_px[..., 0])[..., None, None]   # {-1, 0}
    sx = ((mv8[..., 1] >> 3) - mv_px[..., 1])[..., None, None]
    bank = tables(dev).subpel_bank()
    tx = bank[((mv8[..., 1] & 7) << 1).long()]    # (rows, cols, 8)
    ty = bank[((mv8[..., 0] & 7) << 1).long()]
    hor = torch.zeros(P40.shape[:2] + (40, 32), dtype=torch.int32,
                      device=dev)
    for k in range(8):
        rd = torch.where(sx < 0, P40[..., :, k : 32 + k],
                         P40[..., :, 1 + k : 33 + k])
        hor = hor + tx[..., k, None, None] * rd
    hor = (hor + 4) >> 3                          # InterRound0
    out = torch.zeros(P40.shape[:2] + (32, 32), dtype=torch.int32,
                      device=dev)
    for k in range(8):
        rd = torch.where(sy < 0, hor[..., k : 32 + k, :],
                         hor[..., 1 + k : 33 + k, :])
        out = out + ty[..., k, None, None] * rd
    return torch.clamp((out + 1024) >> 11, 0, pix_max)


def _chroma_patches24_select(ref2: torch.Tensor, mv_int: torch.Tensor):
    """Per-block 24x24 chroma reference patches (8-block + 4-px ring +
    4-tap margins) of both planes: row j <-> ref[8R' + cmv + j - 8], reads
    clamped to the plane (the reference's masked-select assembly over an
    edge-padded plane equals this clamped gather)."""
    return torch.stack([_gather_patches(ref2[0], mv_int, 8, 8),
                        _gather_patches(ref2[1], mv_int, 8, 8)])


def _chroma_ext16(ref_u: torch.Tensor, ref_v: torch.Tensor,
                  mv8: torch.Tensor, pix_max: int):
    """Extended 16x16 chroma MC of both planes with the normative 4-TAP
    bank (the 4x4 chroma of 8x8 inter blocks): Ec[p, r, c][a, b] = MC of
    chroma pixel (8r + a - 4, 8c + b - 4) at the block's mv8 (1/16-pel
    chroma units), so the [4:12, 4:12] center is the block's own 4-tap
    chroma prediction and the 4-px ring covers adjacent sub-blocks."""
    dev = mv8.device
    mv_int = torch.stack([mv8[..., 0] >> 4, mv8[..., 1] >> 4], -1)
    fy = (mv8[..., 0] & 15).long()
    fx = (mv8[..., 1] & 15).long()
    patch = _chroma_patches24_select(torch.stack([ref_u, ref_v]), mv_int)
    bank = tables(dev).subpel_bank4()
    tx = bank[fx]                          # (rows, cols, 8)
    ty = bank[fy]
    hor = torch.zeros(patch.shape[:3] + (24, 16), dtype=torch.int32,
                      device=dev)
    for k in range(8):
        hor = hor + (tx[None, :, :, k, None, None]
                     * patch[..., :, k + 1 : k + 17])
    hor = (hor + 4) >> 3                                    # InterRound0
    out = torch.zeros(patch.shape[:3] + (16, 16), dtype=torch.int32,
                      device=dev)
    for k in range(8):
        out = out + (ty[None, :, :, k, None, None]
                     * hor[..., k + 1 : k + 17, :])
    return torch.clamp((out + 1024) >> 11, 0, pix_max)     # InterRound1


def _quads(b: torch.Tensor, n: int):
    """(rows, cols, 2n, 2n) blocks -> (2*rows, 2*cols, n, n) quadrants."""
    rows, cols = b.shape[:2]
    return (b.reshape(rows, cols, 2, n, 2, n).permute(0, 2, 1, 4, 3, 5)
            .reshape(2 * rows, 2 * cols, n, n))


def _unquads(b: torch.Tensor, n: int):
    """(2*rows, 2*cols, n, n) -> (rows, cols, 2n, 2n): inverse of _quads."""
    rows, cols = b.shape[0] // 2, b.shape[1] // 2
    return (b.reshape(rows, 2, cols, 2, n, n).permute(0, 2, 1, 4, 3, 5)
            .reshape(rows, cols, 2 * n, 2 * n))


def _sub8_stage(y, ref_y, ref_u, ref_v, mv16, pred_b16, p40, mv_px,
                lam: np.float32, pix_max: int):
    """Per-8x8 sub-block MV selection for motion boundaries.

    Candidates per 8x8 sub-block: the parent 16-block's MV, the zero MV,
    and the ADJACENT neighbor blocks' MVs (vertical neighbor for the
    touching half, horizontal for the other axis).  All candidate
    predictions are slices of ONE extended 32x32 luma MC pass (_mc_ext32,
    reusing the search's 40x40 patches) and ONE extended 16x16 4-tap
    chroma pass (_chroma_ext16).  At frame edges the neighbor candidates
    degenerate to the parent.

    Returns dict: mv8 (rows8, cols8, 2) 1/8-pel, pred (rows8, cols8, 8,
    8) luma, pred_uv (2, rows8, cols8, 4, 4), mv_bits (rows8, cols8)."""
    rows, cols = mv16.shape[:2]
    lam = f32(lam)
    src8 = _quads(to_blocks(y, 16), 8)
    pred_p = _quads(pred_b16, 8)
    mv_p = rep2d(mv16, 2)

    E = _mc_ext32(p40, mv16, mv_px, pix_max)          # (rows, cols, 32, 32)
    Ec = _chroma_ext16(ref_u, ref_v, mv16, pix_max)   # (2, rows, cols, 16, 16)

    # ---- vertical-adjacent candidate: qr=0 reads the up neighbor's
    # bottom ring, qr=1 the down neighbor's top ring; frame edges fall
    # back to the parent's own quadrant (whose MV the shift also yields)
    top = torch.cat([E[:1, :, 8:16, 8:24], E[:-1, :, 24:32, 8:24]], dim=0)
    bot = torch.cat([E[1:, :, 0:8, 8:24], E[-1:, :, 16:24, 8:24]], dim=0)
    vp = torch.stack([top, bot], dim=1).reshape(2 * rows, cols, 8, 16)
    vpred = (vp.reshape(2 * rows, cols, 8, 2, 8).permute(0, 1, 3, 2, 4)
             .reshape(2 * rows, 2 * cols, 8, 8))
    mvu = torch.cat([mv16[:1], mv16[:-1]], 0)
    mvd = torch.cat([mv16[1:], mv16[-1:]], 0)
    vmv = (torch.stack([mvu, mvd], dim=1).reshape(2 * rows, cols, 2)
           .repeat_interleave(2, dim=1))

    # ---- horizontal-adjacent candidate (same along columns)
    lef = torch.cat([E[:, :1, 8:24, 8:16], E[:, :-1, 8:24, 24:32]], dim=1)
    rig = torch.cat([E[:, 1:, 8:24, 0:8], E[:, -1:, 8:24, 16:24]], dim=1)
    hp = torch.stack([lef, rig], dim=2).reshape(rows, 2 * cols, 16, 8)
    hpred = (hp.reshape(rows, 2 * cols, 2, 8, 8).permute(0, 2, 1, 3, 4)
             .reshape(2 * rows, 2 * cols, 8, 8))
    mvl = torch.cat([mv16[:, :1], mv16[:, :-1]], 1)
    mvr = torch.cat([mv16[:, 1:], mv16[:, -1:]], 1)
    hmv = (torch.stack([mvl, mvr], dim=2).reshape(rows, 2 * cols, 2)
           .repeat_interleave(2, dim=0))

    def sad8(pred):
        return (src8 - pred).abs().sum(dim=(2, 3), dtype=torch.int32).to(
            torch.float32)

    best_cost = sad8(pred_p)
    best_mv = mv_p                        # parent pays no extra signaling
    best_pred = pred_p
    best_idx = torch.zeros((2 * rows, 2 * cols), dtype=torch.int32,
                           device=y.device)
    cands = (
        # candidate 1, zero MV: the co-located reference block, no filter
        (1, torch.zeros_like(mv_p), to_blocks(ref_y, 8),
         float(f32(lam * fold_consts(_MV_BIAS, 4.0)))),
        (2, vmv, vpred, float(f32(lam * fold_consts(_MV_BIAS, 6.0)))),
        (3, hmv, hpred, float(f32(lam * fold_consts(_MV_BIAS, 6.0)))))
    for idx, mv_cand8, pred_cand, penalty in cands:
        cost = sad8(pred_cand) + penalty
        take = cost < best_cost
        best_cost = torch.where(take, cost, best_cost)
        best_idx = torch.where(take, idx, best_idx)
        best_mv = torch.where(take[..., None], mv_cand8, best_mv)
        best_pred = torch.where(take[..., None, None], pred_cand, best_pred)

    # ---- chroma: slices of Ec / the reference, selected by winner index
    def qc(a):
        return torch.stack([_quads(a[0], 4), _quads(a[1], 4)])

    pred_uv = qc(Ec[:, :, :, 4:12, 4:12])             # parent (4-tap)
    zero_uv = qc(torch.stack([to_blocks(ref_u, 8), to_blocks(ref_v, 8)]))
    ctop = torch.cat([Ec[:, :1, :, 4:8, 4:12],
                      Ec[:, :-1, :, 12:16, 4:12]], dim=1)
    cbot = torch.cat([Ec[:, 1:, :, 0:4, 4:12],
                      Ec[:, -1:, :, 8:12, 4:12]], dim=1)
    cv = torch.stack([ctop, cbot], dim=2).reshape(2, 2 * rows, cols, 4, 8)
    cvpred = (cv.reshape(2, 2 * rows, cols, 4, 2, 4)
              .permute(0, 1, 2, 4, 3, 5)
              .reshape(2, 2 * rows, 2 * cols, 4, 4))
    clef = torch.cat([Ec[:, :, :1, 4:12, 4:8],
                      Ec[:, :, :-1, 4:12, 12:16]], dim=2)
    crig = torch.cat([Ec[:, :, 1:, 4:12, 0:4],
                      Ec[:, :, -1:, 4:12, 8:12]], dim=2)
    ch = torch.stack([clef, crig], dim=3).reshape(2, rows, 2 * cols, 8, 4)
    chpred = (ch.reshape(2, rows, 2 * cols, 2, 4, 4)
              .permute(0, 1, 3, 2, 4, 5)
              .reshape(2, 2 * rows, 2 * cols, 4, 4))
    for i, cand in ((1, zero_uv), (2, cvpred), (3, chpred)):
        m = (best_idx == i)[None, :, :, None, None]
        pred_uv = torch.where(m, cand, pred_uv)

    mv_bits = _SUB8_HDR_BITS + torch.where(best_idx != 0,
                                           _SUB8_NONPARENT_BITS, 2.0)
    return {"mv8": best_mv, "pred": best_pred, "pred_uv": pred_uv,
            "mv_bits": mv_bits}


def _join_blocks(b: torch.Tensor, f: int):
    """(rows, cols, n, n) -> (rows/f, cols/f, n*f, n*f) by tiling."""
    rows, cols, n = b.shape[0], b.shape[1], b.shape[2]
    return (b.reshape(rows // f, f, cols // f, f, n, n)
            .permute(0, 2, 1, 4, 3, 5)
            .reshape(rows // f, cols // f, f * n, f * n))


def _code_nn(src, pred, fwdt, plane: CodePlane):
    """Generic n x n DCT residual coding on (..., n, n) blocks: the forward
    product, then code_blocks with the site's CodePlane (_coder).  Returns
    (levels i32 (..., cw, cw), recon, dist_pix f32, rate f32, dskip f32):
    the rate is the plane's RateModel bits (expected bits from the
    coefficient CDFs); near-threshold levels whose bit cost exceeds their
    distortion value are pruned (rdoq.rd_zero), inside the plane's noise
    gate too.  TX_64X64 (n = 64) codes the top-left 32x32 levels."""
    n, cw = plane.n, plane.cw
    sh = src.shape[:-2]
    s = src.reshape(-1, n, n).contiguous()
    p = pred.reshape(-1, n, n).contiguous()
    coefs = (s - p).reshape(-1, n * n).to(torch.float32) @ fwdt
    lv, rec, dist, rate, dskip = code_blocks(coefs, s, p, plane)
    return (lv.reshape(sh + (cw, cw)), rec.reshape(sh + (n, n)),
            dist.reshape(sh), rate.reshape(sh), dskip.reshape(sh))


def _skip_rdo(lam: float, yt, ut, vt, py, pu, pv):
    """Joint skip-vs-code RD choice at one partition size.

    AV1 signals one skip flag per block covering all three planes.
    yt/ut/vt: (lv, rec, dist, rate, dskip) per plane from _code_nn;
    py/pu/pv: the MC predictions.  Where dskip_total + lam*1 beats
    dist_total + lam*rate_total, zero the levels (the packer then codes
    skip=1, no residual), recon becomes the prediction, and the returned
    dist/rate feed the merge RDO honestly."""
    coded = (yt[2] + lam * yt[3] + ut[2] + lam * ut[3]
             + vt[2] + lam * vt[3])
    skipc = yt[4] + ut[4] + vt[4] + lam  # ~1 bit: the skip flag itself
    m = skipc < coded
    me = m[:, :, None, None]

    def sel(t, p):
        return (torch.where(me, 0, t[0]), torch.where(me, p, t[1]),
                torch.where(m, t[4], t[2]), torch.where(m, 0.0, t[3]))

    return m, sel(yt, py), sel(ut, pu), sel(vt, pv)


@functools.cache
def part_lambdas(qindex: int, bit_depth: int, device):
    """(lam_full, lam, lam_split) float32 values of the partition RDO:
    the full frame lambda (skip and coefficient-pruning decisions), the
    reference-chain discounted one (merge-size choices) and the latter
    times the split overhead bits."""
    a2 = ac_squared(qindex, bit_depth, device)
    return (f32(a2 * f32(LAM_PIX)),
            f32(a2 * fold_consts(LAM_PIX, _REF_LAM_SCALE)),
            f32(a2 * fold_consts(LAM_PIX, _REF_LAM_SCALE,
                                 _SPLIT_OVERHEAD_BITS)))


def _inter_partition(src_b, pred_b, src_cb, pred_cb, mv8, qindex: int,
                     bit_depth: int, sub8=None, use_g=None,
                     noise_gate=None):
    """Partition RDO on top of the 16-grid search results.

    src_b/pred_b: (rows, cols, 16, 16) luma; src_cb/pred_cb: pairs of
    (rows, cols, 8, 8) chroma (u, v).  sub8: optional _sub8_stage output
    (per-8x8 candidate MVs/preds) enabling 16->8x8 splits at motion
    boundaries.  use_g: optional (rows, cols) bool, blocks referencing
    GOLDEN (they never split to 8x8, and 32/64 merges require a uniform
    reference).  Returns dict of per-size level grids, split maps and
    recon planes (union-layout-ready)."""
    dev = mv8.device
    rows, cols = mv8.shape[:2]
    rows32, cols32 = rows // 2, cols // 2
    rows64, cols64 = rows // 4, cols // 4
    T = tables(dev)

    fwd16t, fwd32t, fwd8t = T.fwdt(16, 0), T.fwdt(32, 0), T.fwdt(8, 0)
    lams = part_lambdas(qindex, bit_depth, dev)
    lam_full, lam, lam_split = (float(x) for x in lams)

    def coder(n, ptype, quant_n=None, dq_shift=0):
        """The CodePlane of n x n blocks of plane type ptype (every site
        here prunes with the full frame lambda and the noise gate)."""
        return _coder(qindex, bit_depth, dev, n, ptype, quant_n or n,
                      dq_shift, lams[0], noise_gate, True)

    # MV equality maps (and reference uniformity: a merged block codes
    # ONE ref, so all children must agree)
    eq32 = (mv8.reshape(rows32, 2, cols32, 2, 2)
            == mv8[::2, ::2][:, None, :, None, :]).all(dim=4).all(
                dim=3).all(dim=1)
    eq64 = (mv8.reshape(rows64, 4, cols64, 4, 2)
            == mv8[::4, ::4][:, None, :, None, :]).all(dim=4).all(
                dim=3).all(dim=1)
    if use_g is not None:
        g = use_g.to(torch.int32)
        c32 = g.reshape(rows32, 2, cols32, 2).sum(dim=(1, 3))
        eq32 = eq32 & ((c32 == 0) | (c32 == 4))
        c64 = g.reshape(rows64, 4, cols64, 4).sum(dim=(1, 3))
        eq64 = eq64 & ((c64 == 0) | (c64 == 16))

    def code_uv(src_pair, pred_pair, fwdt, plane):
        """u and v coded in one _code_nn call (stacked leading axis)."""
        t = _code_nn(torch.stack(list(src_pair)),
                     torch.stack(list(pred_pair)), fwdt, plane)
        return tuple(x[0] for x in t), tuple(x[1] for x in t)

    # ---- 16 leaf (luma + chroma) ----
    y16t = _code_nn(src_b, pred_b, fwd16t, coder(16, 0))
    cl = code_uv(src_cb, pred_cb, fwd8t, coder(8, 1))
    _, (lv16, rec16, d16, r16), (lu8, recu8, du8, ru8), \
        (lv8, recv8, dv8, rv8) = _skip_rdo(lam_full, y16t, cl[0], cl[1],
                                           pred_b, pred_cb[0], pred_cb[1])

    # ---- 8x8 split (motion boundaries; TX_8X8 luma + TX_4X4 chroma) ----
    if sub8 is not None:
        src8 = _quads(src_b, 8)
        sc4 = [_quads(s, 4) for s in src_cb]
        pc4 = sub8["pred_uv"]              # (2, rows8, cols8, 4, 4)
        y8t = _code_nn(src8, sub8["pred"], fwd8t, coder(8, 0))
        c4 = code_uv(sc4, (pc4[0], pc4[1]), T.fwdt(4, 0), coder(4, 1))
        _, (l8y, rec8y, d8, r8), (l4u, rec4u, du4, ru4), \
            (l4v, rec4v, dv4, rv4) = _skip_rdo(lam_full, y8t, c4[0], c4[1],
                                               sub8["pred"], pc4[0], pc4[1])
        cost8 = (d8 + du4 + dv4
                 + lam * (r8 + ru4 + rv4 + sub8["mv_bits"]))
        cost8s = cost8.reshape(rows, 2, cols, 2).sum(dim=(1, 3)) + lam_split
        cost16leaf = d16 + du8 + dv8 + lam * (r16 + ru8 + rv8)
        split16 = cost8s < cost16leaf
        if use_g is not None:   # golden blocks never split (sub8
            split16 = split16 & ~use_g  # candidates are all LAST-MC)
    else:
        split16 = torch.zeros((rows, cols), dtype=torch.bool, device=dev)

    # split blocks can't join a 32/64 merge
    eq32 = eq32 & ~split16.reshape(rows32, 2, cols32, 2).any(dim=3).any(dim=1)
    eq64 = eq64 & ~split16.reshape(rows64, 4, cols64, 4).any(dim=3).any(dim=1)

    # ---- 32 merge (luma 32 DCT shift1 + chroma 16 DCT) ----
    s32 = _join_blocks(src_b, 2)
    p32 = _join_blocks(pred_b, 2)
    y32t = _code_nn(s32, p32, fwd32t, coder(32, 0, dq_shift=1))
    sc16 = [_join_blocks(s, 2) for s in src_cb]
    pc16 = [_join_blocks(p, 2) for p in pred_cb]
    cc = code_uv(sc16, pc16, fwd16t, coder(16, 1))
    _, (lv32, rec32, d32, r32), (lu16, recu16, du16, ru16), \
        (lv16c, recv16, dv16, rv16) = _skip_rdo(lam_full, y32t, cc[0], cc[1],
                                                p32, pc16[0], pc16[1])

    def sum4(x, r2, c2):
        return x.reshape(r2, 2, c2, 2).sum(dim=(1, 3))

    d16s = (sum4(d16, rows32, cols32) + sum4(du8, rows32, cols32)
            + sum4(dv8, rows32, cols32))
    cost16 = (sum4(d16 + lam * r16, rows32, cols32)
              + sum4(du8 + lam * ru8, rows32, cols32)
              + sum4(dv8 + lam * rv8, rows32, cols32) + lam_split)
    d32s = d32 + du16 + dv16
    cost32 = (d32 + lam * r32 + du16 + lam * ru16 + dv16 + lam * rv16)
    # distortion gate: merged blocks feed the reference chain, where excess
    # distortion compounds frame over frame while the bit saving is
    # one-time; only merge where quality is (near-)preserved
    ch32 = eq32 & (cost32 < cost16) & (d32s <= d16s * 1.1 + 64.0)

    # ---- 64 merge (luma TX_64X64, coded 32x32, shift2; chroma 32 shift1)
    s64 = _join_blocks(src_b, 4)
    p64 = _join_blocks(pred_b, 4)
    y64t = _code_nn(s64, p64, T.fwd64t(), coder(64, 0, 32, dq_shift=2))
    sc32 = [_join_blocks(s, 4) for s in src_cb]
    pc32 = [_join_blocks(p, 4) for p in pred_cb]
    c32 = code_uv(sc32, pc32, fwd32t, coder(32, 1, dq_shift=1))
    _, (lv64, rec64q, d64, r64l), (lu32, recu32, du32, ru32), \
        (lv32c, recv32, dv32, rv32) = _skip_rdo(lam_full, y64t, c32[0],
                                                c32[1], p64, pc32[0],
                                                pc32[1])
    cost64 = d64 + lam * r64l + du32 + lam * ru32 + dv32 + lam * rv32
    cost_sel32 = torch.where(ch32, cost32, cost16)
    cost_sub = sum4(cost_sel32, rows64, cols64) + lam_split
    d64s = d64 + du32 + dv32
    d_sub = sum4(torch.where(ch32, d32s, d16s), rows64, cols64)
    ch64 = eq64 & (cost64 < cost_sub) & (d64s <= d_sub * 1.1 + 256.0)

    # ---- zero the losing branches ----
    k32 = rep2d(ch64, 2)                      # per 32-region
    k16 = rep2d(ch64, 4)                   # per 16-block
    ch32 = ch32 & ~k32
    c32_16 = rep2d(ch32, 2)
    m16 = c32_16 | k16                     # 16 losing

    def z16(a):
        return torch.where(m16[:, :, None, None], 0, a)

    def z32(a):
        return torch.where(ch32[:, :, None, None], a, 0)

    def z64(a):
        return torch.where(ch64[:, :, None, None], a, 0)

    # ---- split-16 union embed: 8x8/4x4 levels into the parent slots ----
    if sub8 is not None:
        se = split16[:, :, None, None]
        s8 = rep2d(split16, 2)
        s8e = s8[..., None, None]
        lv16 = torch.where(se, _unquads(torch.where(s8e, l8y, 0), 8), lv16)
        lu8 = torch.where(se, _unquads(torch.where(s8e, l4u, 0), 4), lu8)
        lv8 = torch.where(se, _unquads(torch.where(s8e, l4v, 0), 4), lv8)

    i16 = torch.int16
    out = {
        "lv16": z16(lv16).to(i16), "lu8": z16(lu8).to(i16),
        "lv8": z16(lv8).to(i16),
        "lv32": z32(lv32).to(i16), "lu16": z32(lu16).to(i16),
        "lv16c": z32(lv16c).to(i16),
        "lv64": z64(lv64).to(i16), "lu32": z64(lu32).to(i16),
        "lv32c": z64(lv32c).to(i16),
        "split32": ~ch32 & ~k32,    # True = split into 16s (given no 64)
        "split64": ~ch64,           # True = split into 32-level
    }

    # ---- stitched recon planes ----
    def plane_recon(recS, rec32m, rec64m, n):
        """recS: (rows, cols, n, n); rec32m: (rows32, cols32, 2n, 2n);
        rec64m: (rows64, cols64, 4n, 4n) -> (H, W) selected."""
        as16_32 = (rec32m.reshape(rows32, cols32, 2, n, 2, n)
                   .permute(0, 2, 1, 4, 3, 5).reshape(rows, cols, n, n))
        as16_64 = (rec64m.reshape(rows64, cols64, 4, n, 4, n)
                   .permute(0, 2, 1, 4, 3, 5).reshape(rows, cols, n, n))
        sel = torch.where(k16[:, :, None, None], as16_64,
                          torch.where(c32_16[:, :, None, None], as16_32,
                                      recS))
        return from_blocks(sel)

    out["recon_y"] = plane_recon(rec16, rec32, rec64q, 16)
    out["recon_u"] = plane_recon(recu8, recu16, recu32, 8)
    out["recon_v"] = plane_recon(recv8, recv16, recv32, 8)

    out["split16"] = split16
    if sub8 is not None:
        # recon override + per-8 MV transport for split blocks
        my = rep2d(s8, 8)                  # luma pixel mask
        mc = rep2d(s8, 4)                  # chroma pixel mask
        out["recon_y"] = torch.where(my, from_blocks(rec8y), out["recon_y"])
        out["recon_u"] = torch.where(mc, from_blocks(rec4u), out["recon_u"])
        out["recon_v"] = torch.where(mc, from_blocks(rec4v), out["recon_v"])
        out["mv8"] = torch.where(s8[..., None], sub8["mv8"], rep2d(mv8, 2))
        # zeroed-where-unsplit grids for CDEF skip gating
        out["lv8y"] = torch.where(s8e, l8y, 0).to(i16)
        out["lu4"] = torch.where(s8e, l4u, 0).to(i16)
        out["lv4"] = torch.where(s8e, l4v, 0).to(i16)
    else:
        out["mv8"] = rep2d(mv8, 2)
    return out


def encode_inter_part(y, u, v, ref_y, ref_u, ref_v, qindex: int,
                      bit_depth: int = 8, sub8: bool = True,
                      gld_y=None, gld_u=None, gld_v=None, prev_mv=None,
                      noise_gate=None):
    """Partitioned inter encode: 16-grid motion search, 16->8x8 splits at
    motion boundaries, then 32/64 merge RDO.  Returns per-size level
    grids, MV grids (per-16 "mv" + per-8 "mv8"), split maps, a per-16
    reference map ("ref16": False=LAST, True=GOLDEN) and recon planes.

    gld_y/u/v: optional GOLDEN reference planes (the scene keyframe's
    in-loop-filtered recon, ref slot 1).  Blocks where the co-located
    GOLDEN block beats the LAST motion-searched prediction switch to
    ref=GOLDEN at the zero MV."""
    dev = y.device
    lam, _ = inter_lambdas(qindex, bit_depth, dev)
    pix_max = (1 << bit_depth) - 1
    mv8, pred_y, src_b, (p40, mv_px) = _search_mv(y, ref_y, lam, pix_max,
                                                  prev_mv=prev_mv)
    pred_u, pred_v = _chroma_mc_pair(ref_u, ref_v, mv8, pix_max)

    s8 = None
    if sub8:
        # pure-LAST stage: golden overrides come after, and golden blocks
        # never split (their candidates would mix references)
        s8 = _sub8_stage(y, ref_y, ref_u, ref_v, mv8, pred_y, p40, mv_px,
                         lam, pix_max)

    use_g = None
    if gld_y is not None:
        gzy = to_blocks(gld_y, 16)
        sad_l = (src_b - pred_y).abs().sum(dim=(2, 3)).to(torch.float32)
        sad_g = (src_b - gzy).abs().sum(dim=(2, 3)).to(torch.float32)
        # the ref flag costs ~2 bits and breaking the LAST MV field's
        # coherence costs neighbors' stack quality: golden must win by a
        # clear margin
        use_g = sad_g + float(f32(lam * fold_consts(_MV_BIAS, 6.0))) < sad_l
        ge = use_g[..., None, None]
        mv8 = torch.where(use_g[..., None], 0, mv8)
        pred_y = torch.where(ge, gzy, pred_y)
        pred_u = torch.where(ge, to_blocks(gld_u, 8), pred_u)
        pred_v = torch.where(ge, to_blocks(gld_v, 8), pred_v)

    out = _inter_partition(src_b, pred_y, (to_blocks(u, 8), to_blocks(v, 8)),
                           (pred_u, pred_v), mv8, qindex, bit_depth,
                           sub8=s8, use_g=use_g, noise_gate=noise_gate)
    out["mv"] = mv8
    out["mv_px"] = mv_px               # full-pel per-16 winner: the next
    # frame's temporal search candidate (golden blocks keep their
    # searched LAST MV here: it is a search hint, not a coded value)
    out["ref16"] = (use_g if use_g is not None else
                    torch.zeros(mv8.shape[:2], dtype=torch.bool, device=dev))
    return out


def inter_part_sizes(height: int, width: int):
    nb = (height // 16) * (width // 16)
    nb32 = (height // 32) * (width // 32)
    nb64 = (height // 64) * (width // 64)
    ncoef = nb * 256 + 2 * nb * 64      # union layout: y16 | u8 | v8
    return nb, nb32, nb64, ncoef


def _gop_step_part_body(frame, ref_fused, qindex: int, height: int,
                        width: int, cap: int, lf3=None, cdef_s=None,
                        gld_fused=None, prev_mv=None, noise_gate=None,
                        bit_depth: int = 8):
    """One partitioned inter frame against the fused running recon, with
    the prefix transport of inter_part_layout: [head(8) | L2 word bitmap |
    packed split16/32/64 + ref16 flags | per-16 mv (y then x) | dynamic
    stream].  The dynamic stream is a stable compaction of three keyed
    sections in order: nonzero significance-bitmap words, nonzero
    coefficient levels, and the 8x8 sub-MVs of split16 blocks; what was
    not kept follows in its original order, as the reference's stable
    key sort leaves it.  `cap` is unused (the stream always covers the
    worst case and only its used prefix is fetched).  lf3: None or 3
    loop-filter levels; cdef_s: None or 4 coded CDEF strengths; gld_fused:
    optional fused GOLDEN reference.  Returns (int16 buffer, new fused
    recon int32, mv_px (rows, cols, 2) for the next frame's search)."""
    from av1tpu_torch.models.intra_part import (
        _embed64, _merge_quads, _merge_tiles4,
    )

    yy, uu, vv = unfuse(frame, height, width)
    ry, ru, rv = unfuse(ref_fused, height, width)
    gkw = {}
    if gld_fused is not None:
        gy, gu, gv = unfuse(gld_fused, height, width)
        gkw = {"gld_y": gy, "gld_u": gu, "gld_v": gv}
    o = encode_inter_part(yy, uu, vv, ry, ru, rv, qindex,
                          bit_depth=bit_depth, prev_mv=prev_mv,
                          noise_gate=noise_gate, **gkw)
    y16 = _embed64(_merge_quads(o["lv16"], o["lv32"], 16), o["lv64"])
    u8 = _merge_tiles4(_merge_quads(o["lu8"], o["lu16"], 8), o["lu32"], 8)
    v8 = _merge_tiles4(_merge_quads(o["lv8"], o["lv16c"], 8), o["lv32c"], 8)
    flat = torch.cat([y16.reshape(-1), u8.reshape(-1), v8.reshape(-1)])

    sig = flat != 0
    rows, cols = height // 16, width // 16
    nb = rows * cols
    bitmap = pack_bits(sig)
    w_nz = bitmap != 0
    count = sig.sum(dtype=torch.int32)
    countw = w_nz.sum(dtype=torch.int32)
    ns = o["split16"].sum(dtype=torch.int32)
    # L2: one bit per bitmap word
    l2 = pack_bits(w_nz)
    # per-16-block groups of 8 sub-MVs [y00 x00 y01 x01 y10 x10 y11 x11]
    mvd = (o["mv8"].reshape(rows, 2, cols, 2, 2).permute(0, 2, 1, 3, 4)
           .reshape(nb * 8))
    keep = torch.cat([w_nz, sig, o["split16"].reshape(-1)
                      .repeat_interleave(8)])
    stream = torch.cat([bitmap, flat, mvd.to(torch.int16)])
    dyn = stable_partition(stream, keep)
    zero = torch.zeros((), dtype=torch.int32, device=frame.device)
    head = torch.stack([count & 0x7FFF, count >> 15,
                        countw & 0x7FFF, countw >> 15,
                        ns & 0x7FFF, ns >> 15, zero, zero]).to(torch.int16)
    buf = torch.cat([
        head, l2, pack_bits(o["split16"]), pack_bits(o["split32"]),
        pack_bits(o["split64"]), pack_bits(o["ref16"]),
        o["mv"][..., 0].reshape(-1).to(torch.int16),
        o["mv"][..., 1].reshape(-1).to(torch.int16), dyn])

    rcy, rcu, rcv = o["recon_y"], o["recon_u"], o["recon_v"]
    if lf3 is not None:
        from av1tpu_torch.models.deblock import deblock_planes, edge_gates_j
        v_on, h_on = edge_gates_j(o["split32"], o["split64"], rows, cols)
        rcy, rcu, rcv = deblock_planes(rcy, rcu, rcv, v_on, h_on,
                                       lf3[0], lf3[1], lf3[2], 0,
                                       bit_depth, split16=o["split16"])
    if cdef_s is not None:
        from av1tpu_torch.models.cdef import (
            cdef_planes, merge_skip16, skip8_split, skip16_from_levels,
        )
        s16 = merge_skip16(skip16_from_levels(y16, u8, v8), o["split32"],
                           o["split64"])
        rcy, rcu, rcv = cdef_planes(
            rcy, rcu, rcv, skip8_split(s16, o["split16"], y16, u8, v8),
            cdef_s[0], cdef_s[1], cdef_s[2], cdef_s[3], 3, bit_depth)
    new_ref = torch.cat([rcy.reshape(-1), rcu.reshape(-1), rcv.reshape(-1)])
    return buf, new_ref, o["mv_px"]


def _gop_chunk_loop(frames: torch.Tensor, ref_fused: torch.Tensor, q_f,
                    is_ref, mv_scale, height: int, width: int, cap: int,
                    lf=None, cdef_s=None, gld_fused=None, prev_mv=None,
                    noise_gate=None, bit_depth: int = 8):
    """The reference's _gop_chunk_scan as a Python loop over the chunk's
    frames, with the fused recon and the full-pel MV field carried on the
    device.  Per frame: q_f its qindex, is_ref whether its recon becomes
    the next frame's reference, mv_scale the temporal MV hint's scale (2
    for a reference frame at distance 2).  A non-reference frame leaves
    the recon carry unchanged, so its in-loop filters, whose output only
    the carry would read, are not run (its TU signals them off).  The MV
    carry takes each frame's field, halved after a scaled reference frame.
    Returns (list of int16 buffers, ref, mv)."""
    lf3 = tuple(int(x) for x in lf) if (lf is not None and any(lf)) else None
    cs = None if cdef_s is None else tuple(int(x) for x in cdef_s)
    if prev_mv is None:
        prev_mv = torch.zeros((height // 16, width // 16, 2),
                              dtype=torch.int32, device=frames.device)
    bufs = []
    ref, pm = ref_fused, prev_mv
    for k in range(frames.shape[0]):
        keep, msc = is_ref[k], mv_scale[k]
        buf, new_ref, mvpx = _gop_step_part_body(
            frames[k], ref, q_f[k], height, width, cap,
            lf3 if keep else None, cs if keep else None, gld_fused,
            pm * msc if msc != 1 else pm, noise_gate, bit_depth)
        bufs.append(buf)
        if keep:
            ref = new_ref
            pm = mvpx >> 1 if msc > 1 else mvpx
        else:
            pm = mvpx
    return bufs, ref, pm


def encode_gop_chunk_part(frames: torch.Tensor, ref_fused: torch.Tensor,
                          qindex: int, height: int, width: int,
                          cap: int = 131072, lf=None, cdef_s=None,
                          gld_fused=None, prev_mv=None, noise_gate=None,
                          bit_depth: int = 8):
    """Partitioned GOP chunk, every frame a reference at qindex.
    gld_fused: optional GOLDEN reference (the scene keyframe's filtered
    recon), constant across the scene.  prev_mv: optional (rows, cols, 2)
    full-pel MV field carried from the previous chunk's last frame (zeros
    for a scene's first chunk, as the reference's scan starts).  Returns
    (list of K int16 buffers, ref, mv): thread mv into the next chunk's
    prev_mv; fetch per-frame prefixes with fetch_inter_part_prefix(bufs[k],
    ...)."""
    k = frames.shape[0]
    return _gop_chunk_loop(frames, ref_fused, [qindex] * k, [1] * k, [1] * k,
                           height, width, cap, lf, cdef_s, gld_fused, prev_mv,
                           noise_gate, bit_depth)


def encode_gop_chunk_layered(frames: torch.Tensor, ref_fused: torch.Tensor,
                             qindex: int, q_nr: int, height: int, width: int,
                             cap: int = 131072, lf=None, cdef_s=None,
                             gld_fused=None, prev_mv=None,
                             start_parity: int = 1, noise_gate=None,
                             bit_depth: int = 8):
    """2-layer low-delay pyramid chunk: odd-parity frames are
    non-reference (refresh_frame_flags = 0 in their headers), coded at the
    coarser q_nr against the running reference, and the recon and CDF
    chains advance on even-parity frames only.  Reference frames then code
    at temporal distance 2, seeded with a doubled temporal MV hint.
    Returns (bufs, parities, ref, mv)."""
    k = frames.shape[0]
    pars = [(start_parity + i) % 2 for i in range(k)]
    bufs, ref, pm = _gop_chunk_loop(
        frames, ref_fused, [q_nr if p else qindex for p in pars],
        [1 - p for p in pars], [1 if p else 2 for p in pars], height, width,
        cap, lf, cdef_s, gld_fused, prev_mv, noise_gate, bit_depth)
    return bufs, pars, ref, pm


def inter_part_layout(height: int, width: int):
    """Copy of av1tpu/models/inter_v.py:inter_part_layout: the prefix
    transport's offsets.  The host needs only head+fixed plus the dynamic
    prefix of length countw + count + 8*ns (nonzero bitmap words, nonzero
    levels, split-block sub-MVs)."""
    nb, nb32, nb64, ncoef = inter_part_sizes(height, width)
    nwords = ncoef // 16
    l2 = nwords // 16

    def w(n):
        return (n + 15) // 16

    off_l2 = 8
    off_s16 = off_l2 + l2
    off_s32 = off_s16 + w(nb)
    off_s64 = off_s32 + w(nb32)
    off_ref = off_s64 + w(nb64)
    off_mv = off_ref + w(nb)
    fixed = off_mv + 2 * nb
    total = fixed + nwords + ncoef + 8 * nb
    return {"nb": nb, "nb32": nb32, "nb64": nb64, "ncoef": ncoef,
            "nwords": nwords, "l2": l2, "off_l2": off_l2,
            "off_s16": off_s16, "off_s32": off_s32, "off_s64": off_s64,
            "off_ref": off_ref, "off_mv": off_mv, "fixed": fixed,
            "total": total}


def _unpackb(words: np.ndarray, n: int):
    """Inverse of pack_bits on the host: int16 words -> (n,) bool."""
    return np.unpackbits(words.view(np.uint16).view(np.uint8),
                         bitorder="little")[:n].astype(bool)


def inter_part_prefix_len(head: np.ndarray, height: int, width: int):
    """Total prefix elements (head+fixed+dynamic) needed from a
    partitioned inter buffer whose first 8 int16s are `head`."""
    lay = inter_part_layout(height, width)
    count = int(head[0]) | (int(head[1]) << 15)
    countw = int(head[2]) | (int(head[3]) << 15)
    ns = int(head[4]) | (int(head[5]) << 15)
    return lay["fixed"] + countw + count + 8 * ns


def fetch_inter_part_prefix(buf_dev: torch.Tensor, height: int, width: int,
                            state: dict | None = None) -> np.ndarray:
    """Fetch ONLY the used prefix of a partitioned inter buffer from the
    device: one speculative fetch sized from the last frame's usage, plus
    a tail fetch on undershoot.  The slices are cut on the device, so only
    they are copied.  Returns an array split_compact_inter_part accepts."""
    lay = inter_part_layout(height, width)
    guess = lay["fixed"] + 98304
    if state is not None:
        guess = state.get("guess", guess)
    first = buf_dev[: min(guess, lay["total"])].cpu().numpy()
    need = inter_part_prefix_len(first[:8], height, width)
    if need > len(first):
        first = np.concatenate(
            [first, buf_dev[len(first) : need].cpu().numpy()])
    if state is not None:  # 1.5x headroom keeps refetches rare
        state["guess"] = need + (need - lay["fixed"]) // 2 + 4096
    return first[:need]


def split_compact_inter_part(buf: np.ndarray, height: int, width: int):
    """Copy of av1tpu/models/inter_v.py:split_compact_inter_part: host
    split of the prefix transport -> (count, bitmap u16 dense, vals i16,
    split16, split32, split64, ref16, mv (r8, c8, 2) i32 per-8-block).
    `buf` may be the full buffer or just the used prefix."""
    buf = np.asarray(buf)
    lay = inter_part_layout(height, width)
    nb, nb32, nb64 = lay["nb"], lay["nb32"], lay["nb64"]
    nwords = lay["nwords"]
    r16, c16 = height // 16, width // 16
    count = int(buf[0]) | (int(buf[1]) << 15)
    countw = int(buf[2]) | (int(buf[3]) << 15)
    ns = int(buf[4]) | (int(buf[5]) << 15)
    w_nz = _unpackb(buf[lay["off_l2"] : lay["off_s16"]], nwords)
    split16 = _unpackb(buf[lay["off_s16"] : lay["off_s32"]],
                       nb).reshape(r16, c16)
    split32 = _unpackb(buf[lay["off_s32"] : lay["off_s64"]],
                       nb32).reshape(height // 32, width // 32)
    split64 = _unpackb(buf[lay["off_s64"] : lay["off_ref"]],
                       nb64).reshape(height // 64, width // 64)
    ref16 = _unpackb(buf[lay["off_ref"] : lay["off_mv"]],
                     nb).reshape(r16, c16)
    mv16 = np.asarray(buf[lay["off_mv"] : lay["fixed"]]).astype(np.int32)
    dyn = buf[lay["fixed"] : lay["fixed"] + countw + count + 8 * ns]
    bitmap = np.zeros(nwords, np.uint16)
    bitmap[w_nz] = dyn[:countw].view(np.uint16)
    vals = dyn[countw : countw + count]
    # per-8 MV grid: parent per-16 MV everywhere, split blocks overridden
    # by their transported sub-MVs
    mv = np.stack([mv16[:nb], mv16[nb:]], axis=-1).reshape(r16, c16, 2)
    mv8 = np.repeat(np.repeat(mv.reshape(r16, 1, c16, 1, 2), 2, 1), 2, 3)
    if ns:
        mvd = np.asarray(dyn[countw + count :]).astype(
            np.int32).reshape(ns, 2, 2, 2)
        ri, ci = np.nonzero(split16)
        mv8[ri, :, ci, :, :] = mvd
    mv8 = mv8.reshape(height // 8, width // 8, 2)
    return count, bitmap, vals, split16, split32, split64, ref16, mv8
