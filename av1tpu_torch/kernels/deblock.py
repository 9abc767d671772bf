"""One direction of the in-loop deblocking filter on one plane: CUDA kernel
and plain version.

Port of the jitted loop filter of av1tpu/models/deblock_tpu.py
(`deblock_planes`, :394, with `_deblock_plane_v`, :324, and
`_deblock_interior_v`, :293; not a `pallas_call`).  `deblock_edges` is
what models/deblock.py's `deblock_planes` runs twice per plane whose level
is above 0, the vertical edges first: every enabled block edge's
14/8/4-tap (luma) or 6/4-tap (chroma) chain, capped beside split blocks,
and the interior edges of the blocks that `split16` splits.

The hand kernel lives in av1tpu_torch/csrc/deblock.cu (built for sm_90a by
av1tpu_torch._build); the note at its top states its design, why one pass
per direction is exact, and what bounds it.  It is all integer, so it is
bit-exact with the plain version.  The wrapper takes the plain version
only for tensors on the CPU.  A CUDA tensor always launches the kernel,
and anything the kernel does not take raises: there is no fallback.
"""

from __future__ import annotations

import torch

from av1tpu_torch.kernels.transform_quant import _check


def deblock_edges_plain(plane, edge_on, lvl: int, sharpness: int,
                        bit_depth: int, luma: bool, vertical: bool,
                        split16=None):
    """Plain version of deblock_edges: one direction of deblock_planes'
    per-plane passes (the horizontal edges as the vertical pass of the
    transposed plane)."""
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


def deblock_edges(plane, edge_on, lvl: int, sharpness: int, bit_depth: int,
                  luma: bool, vertical: bool, split16=None):
    """plane: (H, W) int32, H and W multiples of 16 (luma) or 8 (chroma),
    the block grid (rows, cols) = (H, W) / that size; edge_on: bool, per
    block edge of the 16 grid, (rows, cols-1) for the vertical edges or
    (rows-1, cols) for the horizontal ones; split16: None or (rows, cols)
    bool, the 16-blocks split into 8x8 transforms; all contiguous on one
    device.  lvl (1..63), sharpness (0..7) and bit_depth are host ints.
    Returns the plane with that direction's edges filtered, int32."""
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
    _check("edge_on", edge_on, torch.bool,
           (rows, cols - 1) if vertical else (rows - 1, cols), dev)
    if split16 is not None:
        _check("split16", split16, torch.bool, (rows, cols), dev)
    if dev.type == "cpu":
        return deblock_edges_plain(plane, edge_on, lvl, sharpness, bit_depth,
                                   luma, vertical, split16)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"plane on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    from av1tpu_torch._build import cuda_lib
    from av1tpu_torch.models.deblock import _thresholds

    limit, blimit, thresh = _thresholds(lvl, sharpness)
    out = torch.empty_like(plane)
    err = cuda_lib().av1_deblock_edges(
        plane.data_ptr(), out.data_ptr(), h, w, int(luma), int(vertical),
        edge_on.data_ptr(), split16.data_ptr() if split16 is not None
        else None, limit, blimit, thresh, bit_depth,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"deblock_edges kernel launch failed: cudaError "
                           f"{err}")
    deblock_edges.launches += 1
    return out


deblock_edges.launches = 0
