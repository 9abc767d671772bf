"""The in-loop deblocking filter of one plane, both directions: CUDA
kernel and plain version.

Port of the jitted loop filter of av1tpu/models/deblock_tpu.py
(`deblock_planes`, :394, with `_deblock_plane_v`, :324, and
`_deblock_interior_v`, :293; not a `pallas_call`).  `deblock_edges` is
what models/deblock.py's `deblock_planes` runs once per plane whose level
is above 0: the vertical edges, then the horizontal ones, each every
enabled block edge's 14/8/4-tap (luma) or 6/4-tap (chroma) chain, capped
beside split blocks, and the interior edges of the blocks that `split16`
splits.  Its plain version, `deblock_plane_plain`, is
`deblock_edges_plain` (one direction, the arithmetic the CPU tests hold
against the reference) over the vertical edges and then the horizontal
ones.

The hand kernel lives in av1tpu_torch/csrc/deblock.cu (built for sm_90a by
av1tpu_torch._build); the note at its top states its design, why one pass
per direction and one tile with a halo are exact, and what bounds it.  It
is all integer, so it is bit-exact with the plain version.  The wrapper
takes the plain version only for tensors on the CPU.  A CUDA tensor always
launches the kernel, and anything the kernel does not take raises: there
is no fallback.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from av1tpu_torch.kernels.transform_quant import _check


def deblock_edges_plain(plane, edge_on, lvl: int, sharpness: int,
                        bit_depth: int, luma: bool, vertical: bool,
                        split16=None):
    """One direction of deblock_planes' per-plane passes (the horizontal
    edges as the vertical pass of the transposed plane); deblock_edges'
    plain version, deblock_plane_plain, runs it for both."""
    from av1tpu_torch.models.deblock import (
        _deblock_interior_v, _deblock_plane_v, _filter_chroma4_lines,
        _filter_luma8_lines, _thresholds,
    )

    def ex(a, n):  # block-edge map -> per-line map
        return torch.repeat_interleave(a, n, dim=0)

    nblk = 16 if luma else 8
    li, bl, th = _thresholds(lvl, sharpness)
    p = plane if vertical else plane.T.contiguous()
    on = edge_on if vertical else edge_on.T
    if split16 is None:
        p = _deblock_plane_v(p, nblk, ex(on, nblk), li, bl, th, bit_depth,
                             luma)
    else:
        s = split16 if vertical else split16.T
        cap = ~(s[:, 1:] | s[:, :-1])
        inner = _filter_luma8_lines if luma else _filter_chroma4_lines

        def filt(w):
            return inner(w, li, bl, th, bit_depth)

        geo = (16, 8, 4, 3) if luma else (8, 4, 2, 2)
        p = _deblock_interior_v(p, *geo, ex(s, nblk), filt)
        p = _deblock_plane_v(p, nblk, ex(on, nblk), li, bl, th, bit_depth,
                             luma, allow14=ex(cap, nblk))
    return p if vertical else p.T.contiguous()


def deblock_plane_plain(plane, v_on16, h_on16, lvl: int, sharpness: int,
                        bit_depth: int, luma: bool, split16=None):
    """Plain version of deblock_edges: deblock_edges_plain over the
    vertical edges, then over the horizontal ones."""
    p = deblock_edges_plain(plane, v_on16, lvl, sharpness, bit_depth, luma,
                            True, split16)
    return deblock_edges_plain(p, h_on16, lvl, sharpness, bit_depth, luma,
                               False, split16)


class DeblockTile(NamedTuple):
    """The launch geometry of csrc/deblock.cu's kernel for one plane kind:
    a CTA of `threads` per th x tw output tile, which loads the rows from
    taps above to taps below it and the columns from hl left to hl right
    of it (clamped to the plane) into shared memory at a row stride of
    `stride` words."""
    th: int
    tw: int
    taps: int
    hl: int
    stride: int
    smem: int
    threads: int


def deblock_layout(luma: bool) -> DeblockTile:
    """csrc/deblock.cu's Tile of luma (16-px blocks) or chroma (8-px),
    mirrored; the card test holds it to av1_deblock_layout."""
    th, tw, taps = (48, 128, 7) if luma else (24, 64, 3)
    hl = (taps + 3) // 4 * 4
    stride = tw + 2 * hl + 1
    return DeblockTile(th, tw, taps, hl, stride, 4 * (th + 2 * taps) * stride,
                       32 * (tw // (16 if luma else 8) + 1))


def deblock_tiles(h: int, w: int, luma: bool):
    """The CTAs of one launch on an h x w plane: each tile's output (r0,
    c0, rows, cols) and the window it loads (rows y0 to y1 and columns x0
    to x1, ends excluded, before clamping to the plane)."""
    L = deblock_layout(luma)
    for r0 in range(0, h, L.th):
        for c0 in range(0, w, L.tw):
            yield ((r0, c0, min(L.th, h - r0), min(L.tw, w - c0)),
                   (r0 - L.taps, r0 + L.th + L.taps, c0 - L.hl,
                    c0 + L.tw + L.hl))


def deblock_edges(plane, v_on16, h_on16, lvl: int, sharpness: int,
                  bit_depth: int, luma: bool, split16=None):
    """plane: (H, W) int32, H and W multiples of 16 (luma) or 8 (chroma),
    the block grid (rows, cols) = (H, W) / that size, 16-byte aligned on
    the card; v_on16, h_on16: bool, per block edge of the 16 grid, (rows,
    cols-1) for the vertical edges and (rows-1, cols) for the horizontal
    ones; split16: None or (rows, cols) bool, the 16-blocks split into 8x8
    transforms; all contiguous on one device.  lvl (1..63), sharpness
    (0..7) and bit_depth are host ints.  Returns the plane with its
    vertical edges filtered and then its horizontal ones, int32."""
    if not 1 <= lvl <= 63:
        raise ValueError(f"lvl must be in [1, 63] (a level of 0 passes "
                         f"through: no call), got {lvl}")
    if not 0 <= sharpness <= 7:
        raise ValueError(f"sharpness must be in [0, 7], got {sharpness}")
    if bit_depth not in (8, 10):
        raise ValueError(f"bit_depth must be 8 or 10, got {bit_depth}")
    nblk = 16 if luma else 8
    if (plane.dim() != 2 or plane.shape[0] % nblk or plane.shape[1] % nblk
            or plane.shape[0] < 2 * nblk or plane.shape[1] < 2 * nblk):
        raise ValueError(f"plane: expected (H, W), multiples of {nblk} and "
                         f"at least two blocks each way, got "
                         f"{tuple(plane.shape)}")
    h, w = plane.shape
    rows, cols = h // nblk, w // nblk
    dev = plane.device
    _check("plane", plane, torch.int32, (h, w), dev)
    _check("v_on16", v_on16, torch.bool, (rows, cols - 1), dev)
    _check("h_on16", h_on16, torch.bool, (rows - 1, cols), dev)
    if split16 is not None:
        _check("split16", split16, torch.bool, (rows, cols), dev)
    if dev.type == "cpu":
        return deblock_plane_plain(plane, v_on16, h_on16, lvl, sharpness,
                                   bit_depth, luma, split16)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"plane on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    if plane.data_ptr() % 16:
        raise ValueError("plane: the kernel loads 16-byte vectors; its "
                         "first pixel is not 16-byte aligned")
    from av1tpu_torch._build import cuda_lib
    from av1tpu_torch.models.deblock import _thresholds

    limit, blimit, thresh = _thresholds(lvl, sharpness)
    out = torch.empty_like(plane)
    err = cuda_lib().av1_deblock_edges(
        plane.data_ptr(), out.data_ptr(), h, w, int(luma),
        v_on16.data_ptr(), h_on16.data_ptr(),
        split16.data_ptr() if split16 is not None else None, limit, blimit,
        thresh, bit_depth, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"deblock_edges kernel launch failed: cudaError "
                           f"{err}")
    deblock_edges.launches += 1
    return out


deblock_edges.launches = 0
