"""CDEF of one frame with one frame-wide preset: CUDA kernel and plain
version.

Port of the jitted CDEF of av1tpu/models/cdef_tpu.py (`cdef_dirs`, :73,
and `_filter_plane`, :116, as `cdef_planes`, :173, runs them on the three
planes; not a `pallas_call`).  `cdef_filter` is what models/cdef.py's
`cdef_planes` computes once a preset has a nonzero strength: the per-8x8
direction search and variance, the luma primary strength adjusted by the
variance, the primary and secondary taps with constrain() and the min/max
clamp, chroma at damping - 1, and the skip8 gate.

The hand kernel lives in av1tpu_torch/csrc/cdef.cu (built for sm_90a by
av1tpu_torch._build); the note at its top states its design and what
bounds it.  It is all integer, so it is bit-exact with the plain version.
The wrapper takes the plain version only for tensors on the CPU.  A CUDA
tensor always launches the kernel, and anything the kernel does not take
raises: there is no fallback.  `cdef_layout` mirrors the kernel's tile
geometry for the CPU tests; the card test holds it to the library
(av1_cdef_layout).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from av1tpu_torch.kernels.transform_quant import _check


class CdefLayout(NamedTuple):
    """csrc/cdef.cu's tiles: a CTA of `threads` per tr x tc 8x8 units,
    which stages the luma rows from ar above to ar below the tile and the
    columns from ac left to ac right of it at a row stride of ls words (the
    chroma planes' halves at cs), CDEF_VERY_LARGE outside the plane."""
    tr: int
    tc: int
    ar: int
    ac: int
    ls: int
    cs: int
    threads: int


def cdef_layout() -> CdefLayout:
    """The kernel's tile geometry, mirrored (av1_cdef_layout)."""
    tr, tc, ar, ac = 2, 16, 2, 4
    return CdefLayout(tr, tc, ar, ac, 8 * tc + 2 * ac, 4 * tc + 2 * ac, 256)


def cdef_filter_plain(y, u, v, skip8, pri_y: int, sec_y: int, pri_uv: int,
                      sec_uv: int, damping: int, bit_depth: int):
    """Plain version of cdef_filter (the body of cdef_planes after its
    all-zero pass-through).  Returns the three filtered int32 planes."""
    from av1tpu_torch.models.cdef import _filter_plane, _floor_log2, cdef_dirs
    from av1tpu_torch.models.intra_v import rep2d

    coeff_shift = bit_depth - 8
    h, w = y.shape
    sec_y_eff = (sec_y + (sec_y == 3)) << coeff_shift
    sec_uv_eff = (sec_uv + (sec_uv == 3)) << coeff_shift

    # direction search only when some primary strength is nonzero
    if pri_y > 0 or pri_uv > 0:
        dir8, var8 = cdef_dirs(y, coeff_shift)
    else:
        dir8 = torch.zeros((h // 8, w // 8), dtype=torch.int32,
                           device=y.device)
        var8 = dir8

    live = ~skip8
    out = []
    if pri_y > 0 or sec_y > 0:
        # luma primary: variance-modulated per block (spec adjust_strength)
        v6 = var8 >> 6
        i = torch.where(v6 > 0, torch.clamp(_floor_log2(v6), max=12), 0)
        pri_y_blk = torch.where(var8 > 0,
                                ((pri_y << coeff_shift) * (4 + i) + 8) >> 4,
                                0)
        par_y = (pri_y_blk >> coeff_shift) & 1
        yy = _filter_plane(y, rep2d(dir8, 8), rep2d(pri_y_blk, 8),
                           rep2d(par_y, 8), sec_y_eff,
                           damping + coeff_shift, h, w)
        out.append(torch.where(rep2d(live, 8), yy, y))
    else:
        out.append(y)

    ch, cw = u.shape
    if pri_uv > 0 or sec_uv > 0:
        dir_c = rep2d(dir8, 4)
        pri_c = torch.full((ch, cw), pri_uv << coeff_shift,
                           dtype=torch.int32, device=y.device)
        livec = rep2d(live, 4)
        dmp_c = damping - 1 + coeff_shift
        for p in (u, v):
            pp = _filter_plane(p, dir_c, pri_c, pri_uv & 1, sec_uv_eff,
                               dmp_c, ch, cw)
            out.append(torch.where(livec, pp, p))
    else:
        out += [u, v]
    return tuple(out)


def cdef_filter(y, u, v, skip8, pri_y: int, sec_y: int, pri_uv: int,
                sec_uv: int, damping: int = 3, bit_depth: int = 8):
    """y: (H, W) int32, u, v: (H/2, W/2) int32 deblocked planes, H and W
    multiples of 8, 16-byte aligned on the card; skip8: (H/8, W/8) bool,
    True = unit unfiltered; all contiguous on one device.  pri/sec: the
    CODED strengths as host ints (sec 3 means 4), not all zero
    (cdef_planes passes an all-zero preset through without a call).
    Returns the filtered (y, u, v), int32."""
    for name, x in (("pri_y", pri_y), ("pri_uv", pri_uv)):
        if not 0 <= x <= 15:
            raise ValueError(f"{name} must be in [0, 15], got {x}")
    for name, x in (("sec_y", sec_y), ("sec_uv", sec_uv)):
        if not 0 <= x <= 3:
            raise ValueError(f"{name} must be in [0, 3], got {x}")
    if not (pri_y or sec_y or pri_uv or sec_uv):
        raise ValueError("an all-zero preset passes through: no call")
    if bit_depth not in (8, 10):
        raise ValueError(f"bit_depth must be 8 or 10, got {bit_depth}")
    if not 1 <= damping <= 6:
        raise ValueError(f"damping must be in [1, 6], got {damping}")
    if y.dim() != 2 or y.shape[0] % 8 or y.shape[1] % 8 or y.numel() == 0:
        raise ValueError("y: expected (H, W) with H, W multiples of 8, got "
                         f"{tuple(y.shape)}")
    h, w = y.shape
    dev = y.device
    _check("y", y, torch.int32, (h, w), dev)
    _check("u", u, torch.int32, (h // 2, w // 2), dev)
    _check("v", v, torch.int32, (h // 2, w // 2), dev)
    _check("skip8", skip8, torch.bool, (h // 8, w // 8), dev)
    if dev.type == "cpu":
        return cdef_filter_plain(y, u, v, skip8, pri_y, sec_y, pri_uv,
                                 sec_uv, damping, bit_depth)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"planes on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    for name, p in (("y", y), ("u", u), ("v", v)):
        if p.data_ptr() % 16:
            raise ValueError(f"{name}: the kernel reads 16-byte pieces, "
                             "the plane must start 16-byte aligned")
    from av1tpu_torch._build import cuda_lib
    from av1tpu_torch.state import tables

    weights = tables(dev).cdef_dirs()[1]
    oy, ou, ov = (torch.empty_like(p) for p in (y, u, v))
    err = cuda_lib().av1_cdef_filter(
        y.data_ptr(), u.data_ptr(), v.data_ptr(), skip8.data_ptr(),
        weights.data_ptr(), h, w, pri_y, sec_y, pri_uv, sec_uv, damping,
        bit_depth - 8, oy.data_ptr(), ou.data_ptr(), ov.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"cdef_filter kernel launch failed: cudaError "
                           f"{err}")
    cdef_filter.launches += 1
    return oy, ou, ov


cdef_filter.launches = 0
