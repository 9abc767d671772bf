"""The luma motion search of one inter frame: three CUDA kernels and their
plain versions.

Port of the jitted search of av1tpu/models/inter_v.py (`_coarse_search`,
:89; `_global_full`, :287; `_refine_search`, :252, with the global snap of
`_search_mv`, :888-950; `_subpel_refine`, :374; not `pallas_call`s).
models/inter_v.py's `_search_mv` runs the three in turn:

- `coarse_search`: the 4x4 mean pool, the +-8 quarter-res full search with
  its snap to the frame-dominant shift, the second-basin candidate and the
  top-4 global shifts (3 launches);
- `global_search`: the full-resolution global candidate, judged by
  whole-frame SADs around the top-2 shifts and zero, then two descent
  sweeps (3 launches, the last CTA of each sweep taking its select);
- `refine_subpel`: the +-2 full-pel refine around each base, the snap to
  the global candidate, and the 49-candidate quarter-pel sweep with its
  snap to the dominant offset (2 launches).

The hand kernels live in av1tpu_torch/csrc/motion.cu (built for sm_90a by
av1tpu_torch._build); the note at its top states their design and what
bounds them.  They repeat the plain versions' arithmetic (the float
decisions rounded operation by operation, each frame total the exact
integer sum rounded once), so they are bit-exact with them.  On the card
the search reads nothing back to the host.  Each wrapper takes its plain
version only for tensors on the CPU.  A CUDA tensor always launches the
kernels, and anything they do not take raises: there is no fallback.
Each wrapper's `launches` counts its kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from av1tpu_torch.kernels.transform_quant import _check

f32 = np.float32

# kernel launches of one call of each wrapper
COARSE_LAUNCHES, GLOBAL_LAUNCHES, REFINE_LAUNCHES = 3, 3, 2
# coarse_search's sweep: a CTA per tile of 4 x 8 16x16 blocks, a warp per
# column of the tile; the pool and the select take 256 threads per CTA
COARSE_TILE, COARSE_THREADS = (4, 8), 256
_NGLOBAL = 125     # global candidates: 3 bases x 25, then 2 sweeps x 25


def _check_planes(y, ref_y):
    if y.dim() != 2 or y.shape[0] % 16 or y.shape[1] % 16 or y.numel() == 0:
        raise ValueError("y: expected (H, W) with H, W multiples of 16, got "
                         f"{tuple(y.shape)}")
    _check("y", y, torch.int32, tuple(y.shape), y.device)
    _check("ref_y", ref_y, torch.int32, tuple(y.shape), y.device)
    return y.shape[0] // 16, y.shape[1] // 16


def _cuda_device(dev) -> None:
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"planes on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _coarse_lams(lam):
    """The quarter-res SAD domain's MV-bias lambda and snap margin."""
    from av1tpu_torch.models.inter_v import _MV_BIAS

    lam = f32(lam)
    return (f32(f32(lam * f32(_MV_BIAS)) / f32(16.0)),
            f32(f32(lam * f32(14.0)) / f32(16.0)))


def coarse_search_plain(y, ref_y, lam):
    """Plain version of coarse_search: the 4x4 mean pool and
    models/inter_v.py:_coarse_search."""
    from av1tpu_torch.models.inter_v import _block_sad, _coarse_search

    src_q = _block_sad(y, 4) // 16          # 4x4 mean pool (exact ints /16)
    ref_q = _block_sad(ref_y, 4) // 16
    return _coarse_search(src_q, ref_q, *_coarse_lams(lam))


def coarse_layout(h: int, w: int) -> dict:
    """coarse_search's three launches on an h x w frame, as
    csrc/motion.cu builds them: the CTAs of the pool (a thread per
    quarter-res pixel of both planes), of the sweep (a tile of blocks
    each) and of the select (a thread per block), the sweep's threads per
    CTA and its static shared bytes (the 32 x 48 quarter-res window at row
    stride 49, the tile's 16 x 32 source, a row of 289 partial totals per
    warp, the 17 dy biases and the 289 combined ones)."""
    from av1tpu_torch.models.inter_v import _COARSE_R

    nd = 2 * _COARSE_R + 1
    nc = nd * nd
    rows, cols = h // 16, w // 16
    tr, tc = COARSE_TILE
    warps = COARSE_THREADS // 32
    win = (4 * tr + 2 * _COARSE_R) * 49
    smem = 4 * (win + 16 * tr * tc + warps * nc + nd + nc)
    return {"pool_ctas": -(-max(2 * (h // 4) * (w // 4), nc)
                            // COARSE_THREADS),
            "sweep_ctas": -(-rows // tr) * -(-cols // tc),
            "select_ctas": -(-rows * cols // COARSE_THREADS),
            "sweep_threads": COARSE_THREADS, "sweep_smem": smem}


@functools.cache
def _coarse_bias(lam_c: float):
    """(2 x 17) float32 host table: _mv_bias over the offsets, as the plain
    version's dy table, then of each offset alone, as its dx term."""
    from av1tpu_torch.models.inter_v import _COARSE_R, _mv_bias

    lam_c = f32(lam_c)
    dys = np.arange(-_COARSE_R, _COARSE_R + 1, dtype=np.int32)
    vec = _mv_bias(dys, lam_c)
    sca = np.array([_mv_bias(np.int32(d), lam_c) for d in dys], f32)
    return (ctypes.c_float * (2 * len(dys)))(*np.concatenate([vec, sca]))


def coarse_search(y, ref_y, lam):
    """y, ref_y: (H, W) int32 luma, H and W multiples of 16, contiguous on
    one device; lam: the float32 SAD-domain lambda.  Returns (coarse,
    coarse2, shifts4): the snapped quarter-res winner and the second-basin
    candidate, (rows, cols, 2) int32 px (multiples of 4), and the top-4
    global shifts (4, 2) int32."""
    rows, cols = _check_planes(y, ref_y)
    dev = y.device
    if dev.type == "cpu":
        return coarse_search_plain(y, ref_y, lam)
    _cuda_device(dev)
    from av1tpu_torch._build import cuda_lib

    lib = cuda_lib()
    h, w = y.shape
    lam_c, margin = _coarse_lams(lam)
    ws = torch.empty(lib.av1_motion_ws_words(0, h, w), dtype=torch.int32,
                     device=dev)
    nblk = rows * cols
    out = torch.empty(4 * nblk + 8, dtype=torch.int32, device=dev)
    coarse, coarse2, shifts4 = (out[:2 * nblk].view(rows, cols, 2),
                                out[2 * nblk : 4 * nblk].view(rows, cols, 2),
                                out[4 * nblk :].view(4, 2))
    _raise_on(lib.av1_coarse_search(
        y.data_ptr(), ref_y.data_ptr(), h, w, _coarse_bias(float(lam_c)),
        float(margin), ws.data_ptr(), coarse.data_ptr(), coarse2.data_ptr(),
        shifts4.data_ptr(), _stream(dev)), "coarse_search")
    coarse_search.launches += COARSE_LAUNCHES
    return coarse, coarse2, shifts4


coarse_search.launches = 0


def global_search_plain(y, ref_y, shifts4):
    """Plain version of global_search: models/inter_v.py:_global_full (it
    reads the candidate shifts on the host)."""
    from av1tpu_torch.models.inter_v import _global_full

    return _global_full(y, ref_y, shifts4)


def global_search(y, ref_y, shifts4):
    """y, ref_y: (H, W) int32 luma as for coarse_search; shifts4: (4, 2)
    int32, coarse_search's top-4 shifts (multiples of 4 within +-32).
    Returns (c0 (2,) the winner's 4-px base, g_full (2,), sad_g (rows,
    cols) float32 per-block SAD at g_full)."""
    rows, cols = _check_planes(y, ref_y)
    dev = y.device
    _check("shifts4", shifts4, torch.int32, (4, 2), dev)
    if dev.type == "cpu":
        return global_search_plain(y, ref_y, shifts4)
    _cuda_device(dev)
    from av1tpu_torch._build import cuda_lib

    lib = cuda_lib()
    h, w = y.shape
    zws = torch.zeros(lib.av1_motion_ws_words(1, h, w) + 4,
                      dtype=torch.int32, device=dev)
    c0, g_full = zws[-4:-2], zws[-2:]
    vol = torch.empty(_NGLOBAL * rows * cols, dtype=torch.int32, device=dev)
    sad_g = torch.empty((rows, cols), dtype=torch.float32, device=dev)
    _raise_on(lib.av1_global_search(
        y.data_ptr(), ref_y.data_ptr(), h, w, shifts4.data_ptr(),
        zws.data_ptr(), vol.data_ptr(), sad_g.data_ptr(), c0.data_ptr(),
        g_full.data_ptr(), _stream(dev)), "global_search")
    global_search.launches += GLOBAL_LAUNCHES
    return c0, g_full, sad_g


global_search.launches = 0


def refine_subpel_plain(y, ref_y, bases, c0, g_full, sad_g, lam,
                        pix_max: int):
    """Plain version of refine_subpel: models/inter_v.py:_refine_search
    around each base, the snap to the global candidate, and
    _subpel_refine on the 24x24 patches at the full-pel winner."""
    from av1tpu_torch.models.inter_v import (
        _gather_patches, _patches_select, _refine_search, _subpel_refine,
    )
    from av1tpu_torch.models.intra_v import to_blocks

    lam = f32(lam)
    src_b = to_blocks(y, 16)
    mv_px = best_sad = best_cost = base_f = None
    for b in bases:
        m, sd, c = _refine_search(src_b, _patches_select(ref_y, b), b, lam)
        if mv_px is None:
            mv_px, best_sad, best_cost, base_f = m, sd, c, b
        else:
            take = c < best_cost
            mv_px = torch.where(take[..., None], m, mv_px)
            best_sad = torch.where(take, sd, best_sad)
            best_cost = torch.where(take, c, best_cost)
            base_f = torch.where(take[..., None], b, base_f)

    snap = sad_g <= best_sad + float(f32(lam * f32(14.0)))
    mv_px = torch.where(snap[..., None], g_full, mv_px)
    coarse_f = torch.where(snap[..., None], c0[None, None], base_f)
    off_f = mv_px - coarse_f
    # the 24x24 patch at mv_px: rows/cols 8..31 of _search_mv's 40x40
    # patches at coarse_f + off_f
    mv8, pred_y = _subpel_refine(src_b, _gather_patches(ref_y, mv_px, 16, 4),
                                 mv_px, lam, pix_max)
    return mv8, pred_y, mv_px, coarse_f, off_f


# the quarter-pel offsets (1/8 pel) the kernel is built for
_KERNEL_SUBPEL_D = (-6, -4, -2, 0, 2, 4, 6)


def subpel_taps() -> np.ndarray:
    """(7 x 8) int32: the 8-tap bank rows (d & 7) << 1 of the quarter-pel
    offsets d of models/inter_v.py:_SUBPEL_D."""
    from av1tpu_torch.models.inter_v import _SUBPEL_D
    from av1tpu_torch.spec import tables as spec_tables

    bank = np.asarray(spec_tables.subpel_filters()["regular"], np.int32)
    return np.stack([bank[(d & 7) << 1] for d in _SUBPEL_D])


def check_subpel_phases(d, taps) -> None:
    """The premise of refine_subpel's kernel, which computes each filter
    phase once and reads the seven offsets as shifted views: the offsets
    are -6..6 in steps of 2; -6 and 2, -4 and 4, -2 and 6 have equal rows
    (one phase, one pixel apart); 0 is the identity (tap 3 = 128); taps 0
    and 7 are zero.  Raises ValueError otherwise."""
    taps = np.asarray(taps)
    ident = np.zeros(8, taps.dtype)
    ident[3] = 128
    if tuple(d) != _KERNEL_SUBPEL_D or taps.shape != (7, 8):
        raise ValueError(f"refine_subpel's kernel takes the offsets "
                         f"{_KERNEL_SUBPEL_D}, got {tuple(d)}")
    for lo, hi in ((0, 4), (1, 5), (2, 6)):
        if not np.array_equal(taps[lo], taps[hi]):
            raise ValueError(f"offsets {d[lo]} and {d[hi]} have different "
                             f"filter rows {taps[lo]} and {taps[hi]}")
    if not np.array_equal(taps[3], ident):
        raise ValueError(f"offset 0's filter row {taps[3]} is not the "
                         "identity")
    if taps[:, 0].any() or taps[:, 7].any():
        raise ValueError("the filter rows' taps 0 and 7 are not all zero")


@functools.cache
def _subpel_taps():
    """The 7 x 8 tap table as a host array for the kernel, its premise
    checked once per process (check_subpel_phases)."""
    from av1tpu_torch.models.inter_v import _SUBPEL_D

    taps = subpel_taps()
    check_subpel_phases(_SUBPEL_D, taps)
    return (ctypes.c_int * taps.size)(*taps.ravel().tolist())


def refine_subpel(y, ref_y, bases, c0, g_full, sad_g, lam, pix_max: int):
    """y, ref_y: (H, W) int32 luma as for coarse_search; bases: 2 or 3
    (rows, cols, 2) int32 full-pel bases (coarse_search's two candidates,
    then the optional temporal base); c0, g_full, sad_g: global_search's
    outputs; lam: the float32 SAD-domain lambda; pix_max: 255 or 1023.
    Returns (mv8 (rows, cols, 2) 1/8-pel, pred_y (rows, cols, 16, 16), the
    full-pel winner mv_px, and coarse_f / off_f, its base and offset: the
    40x40 patches of _search_mv sit at coarse_f + off_f), all int32."""
    rows, cols = _check_planes(y, ref_y)
    dev = y.device
    bases = tuple(bases)
    if len(bases) not in (2, 3):
        raise ValueError(f"bases: expected 2 or 3, got {len(bases)}")
    for k, b in enumerate(bases):
        _check(f"bases[{k}]", b, torch.int32, (rows, cols, 2), dev)
    _check("c0", c0, torch.int32, (2,), dev)
    _check("g_full", g_full, torch.int32, (2,), dev)
    _check("sad_g", sad_g, torch.float32, (rows, cols), dev)
    if pix_max not in (255, 1023):
        raise ValueError(f"pix_max must be 255 or 1023, got {pix_max}")
    if dev.type == "cpu":
        return refine_subpel_plain(y, ref_y, bases, c0, g_full, sad_g, lam,
                                   pix_max)
    _cuda_device(dev)
    from av1tpu_torch._build import cuda_lib
    from av1tpu_torch.models.inter_v import _MV_BIAS

    lam = f32(lam)
    unit_s = f32(lam * f32(_MV_BIAS))
    unit_r = f32(unit_s * f32(2.0))
    m14 = f32(lam * f32(14.0))
    h, w = y.shape
    nblk = rows * cols
    taps = _subpel_taps()
    tot = torch.zeros(2 * 49, dtype=torch.int32, device=dev)
    vol = torch.empty(49 * nblk, dtype=torch.int32, device=dev)
    out = torch.empty(10 * nblk, dtype=torch.int32, device=dev)
    pred = torch.empty((rows, cols, 16, 16), dtype=torch.int32, device=dev)
    _raise_on(cuda_lib().av1_refine_subpel(
        y.data_ptr(), ref_y.data_ptr(), h, w, bases[0].data_ptr(),
        bases[1].data_ptr(), bases[2].data_ptr() if len(bases) == 3 else None,
        c0.data_ptr(), g_full.data_ptr(), sad_g.data_ptr(), float(unit_r),
        float(unit_s), float(m14), pix_max, taps, tot.data_ptr(),
        vol.data_ptr(), out.data_ptr(), pred.data_ptr(), _stream(dev)),
        "refine_subpel")
    refine_subpel.launches += REFINE_LAUNCHES
    mv8, mv_px, coarse_f, off_f = (
        out[2 * k * nblk : 2 * (k + 1) * nblk].view(rows, cols, 2)
        for k in range(4))
    return mv8, pred, mv_px, coarse_f, off_f


refine_subpel.launches = 0
