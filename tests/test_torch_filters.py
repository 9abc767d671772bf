"""Port parity for the loop filters and the keyframe temporal filter:
deblock_planes (uniform grid and the split16 branch), edge_gates_j,
cdef_planes and the cdef_filter kernel's wrapper (edge units, all units
skipped), the CDEF strength search, the split-aware skip maps and
temporal_filter_key of av1tpu_torch equal av1tpu's (filtered pixels bit
for bit, noise sigmas to rtol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import jax

from av1tpu.models import cdef_tpu as jax_cdef
from av1tpu.models import deblock_tpu as jax_deblock
from av1tpu.models.cdef_tpu import cdef_sse_fused as jax_sse
from av1tpu.models.cdef_tpu import cdef_tpu
from av1tpu.models.cdef_tpu import select_strengths as jax_select
from av1tpu.models.deblock_tpu import deblock_tpu
from av1tpu.models.intra_v import fuse_planes
from av1tpu.models.tfilter import temporal_filter_key as jax_tf
from av1tpu.utils.yuv import synthetic_clip
from av1tpu_torch.kernels.cdef import cdef_filter
from av1tpu_torch.models import cdef, deblock, tfilter
from av1tpu_torch.models.intra_v import encode_intra_v
from tests.test_inter_pipeline import moving_clip
from tests.test_torch_threads import single_torch_thread  # noqa: F401

H, W = 64, 128


def _recon(bit_depth, q, seed):
    """A blocky fast-preset intra recon (the filters' real input) and its
    source, as numpy int32 planes."""
    c = synthetic_clip(W, H, 1, bit_depth=bit_depth, seed=seed)
    src = [torch.from_numpy(p[0].astype(np.int32)) for p in (c.y, c.u, c.v)]
    o = encode_intra_v(*src, q, bit_depth=bit_depth)
    rec = [o[k].numpy() for k in ("recon_y", "recon_u", "recon_v")]
    return rec, [s.numpy() for s in src]


@pytest.mark.parametrize("bit_depth,q,lvls,gates", [
    (8, 160, (34, 17, 17), "all"), (8, 90, (16, 8, 0), "random"),
    (10, 120, (24, 12, 12), "all")])
def test_deblock_matches_jax(bit_depth, q, lvls, gates):
    rec, _ = _recon(bit_depth, q, seed=8)
    rows, cols = H // 16, W // 16
    rng = np.random.RandomState(2)
    v_on = np.ones((rows, cols - 1), bool)
    h_on = np.ones((rows - 1, cols), bool)
    if gates == "random":
        v_on = rng.rand(rows, cols - 1) < 0.6
        h_on = rng.rand(rows - 1, cols) < 0.6
    want = deblock_tpu(*(jnp.asarray(p) for p in rec), jnp.asarray(v_on),
                       jnp.asarray(h_on), *lvls, bit_depth=bit_depth)
    got = deblock.deblock_planes(*(torch.from_numpy(p) for p in rec),
                                 torch.from_numpy(v_on),
                                 torch.from_numpy(h_on), *lvls, 0,
                                 bit_depth)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


def _split_maps(seed):
    rows, cols = H // 16, W // 16
    rng = np.random.RandomState(seed)
    split64 = rng.rand(rows // 4, cols // 4) < 0.5
    split32 = (rng.rand(rows // 2, cols // 2) < 0.5) & np.repeat(
        np.repeat(split64, 2, 0), 2, 1)
    split16 = (rng.rand(rows, cols) < 0.4) & np.repeat(
        np.repeat(split32, 2, 0), 2, 1)
    return split16, split32, split64


@pytest.mark.parametrize("bit_depth,q,lvls,seed", [
    (8, 90, (16, 0, 8), 6), (10, 120, (24, 12, 12), 7)])
def test_deblock_split16_and_edge_gates_match_jax(bit_depth, q, lvls, seed):
    rec, _ = _recon(bit_depth, q, seed=8)
    rows, cols = H // 16, W // 16
    split16, split32, split64 = _split_maps(seed)

    @jax.jit
    def jax_fn(y, u, v, s16, s32, s64):
        v_on, h_on = jax_deblock.edge_gates_j(s32, s64, rows, cols)
        return v_on, h_on, jax_deblock.deblock_planes(
            y, u, v, v_on, h_on, *lvls, 0, bit_depth, split16=s16)

    wv, wh, want = jax_fn(*(jnp.asarray(p) for p in rec),
                          jnp.asarray(split16), jnp.asarray(split32),
                          jnp.asarray(split64))
    gv, gh = deblock.edge_gates_j(torch.from_numpy(split32),
                                  torch.from_numpy(split64), rows, cols)
    assert np.array_equal(gv.numpy(), np.asarray(wv))
    assert np.array_equal(gh.numpy(), np.asarray(wh))
    # the host-loop form of the reference agrees with both
    hv, hh = jax_deblock.edge_gates(split32, split64, rows, cols)
    assert np.array_equal(gv.numpy(), hv) and np.array_equal(gh.numpy(), hh)
    got = deblock.deblock_planes(*(torch.from_numpy(p) for p in rec), gv, gh,
                                 *lvls, 0, bit_depth,
                                 split16=torch.from_numpy(split16))
    for g, w, p in zip(got, want, rec):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert not np.array_equal(got[0].numpy(), rec[0])   # it filtered


@pytest.mark.parametrize("seed", [1, 2])
def test_merge_skip16_and_skip8_split_match_jax(seed):
    rows, cols = H // 16, W // 16
    split16, split32, split64 = _split_maps(seed)
    rng = np.random.RandomState(seed)

    def sparse(shape, p):
        return (rng.randint(-3, 4, size=shape)
                * (rng.rand(*shape[:2], 1, 1) < p)
                * (rng.rand(*shape) < 0.05)).astype(np.int16)

    y16 = sparse((rows, cols, 16, 16), 0.5)
    u8 = sparse((rows, cols, 8, 8), 0.3)
    v8 = sparse((rows, cols, 8, 8), 0.3)
    ty, tu, tv = (torch.from_numpy(a) for a in (y16, u8, v8))
    w16 = jax_cdef.skip16_from_levels(jnp.asarray(y16), jnp.asarray(u8),
                                      jnp.asarray(v8))
    g16 = cdef.skip16_from_levels(ty, tu, tv)
    assert np.array_equal(g16.numpy(), np.asarray(w16))
    wm = jax_cdef.merge_skip16(w16, jnp.asarray(split32),
                               jnp.asarray(split64))
    gm = cdef.merge_skip16(g16, torch.from_numpy(split32),
                           torch.from_numpy(split64))
    assert np.array_equal(gm.numpy(), np.asarray(wm))
    w8 = jax_cdef.skip8_split(wm, jnp.asarray(split16), jnp.asarray(y16),
                              jnp.asarray(u8), jnp.asarray(v8))
    g8 = cdef.skip8_split(gm, torch.from_numpy(split16), ty, tu, tv)
    assert np.array_equal(g8.numpy(), np.asarray(w8))
    # skip8_host with split maps, from the packed significance bitmap
    flat = np.concatenate([a.ravel() for a in (y16, u8, v8)])
    bitmap = np.packbits(flat != 0, bitorder="little").view(np.uint16)
    for maps in ((None, None), (split32, split64)):
        assert np.array_equal(cdef.skip8_host(bitmap, H, W, *maps),
                              jax_cdef.skip8_host(bitmap, H, W, *maps))


@pytest.mark.parametrize("bit_depth,strengths", [
    (8, (4, 1, 3, 1)), (8, (0, 2, 0, 3)), (8, (12, 3, 9, 3)),
    (8, (1, 0, 0, 0)), (10, (6, 2, 4, 1))])
def test_cdef_planes_matches_jax(bit_depth, strengths):
    rec, _ = _recon(bit_depth, 120, seed=9)
    skip8 = np.random.RandomState(3).rand(H // 8, W // 8) < 0.3
    want = cdef_tpu(*(jnp.asarray(p) for p in rec), jnp.asarray(skip8),
                    *strengths, bit_depth=bit_depth)
    got = cdef.cdef_planes(*(torch.from_numpy(p) for p in rec),
                           torch.from_numpy(skip8), *strengths, 3,
                           bit_depth)
    # cdef_planes is kernels/cdef.py:cdef_filter for a preset that is not
    # all zero; its wrapper on CPU tensors runs the plain version
    direct = cdef_filter(*(torch.from_numpy(p) for p in rec),
                         torch.from_numpy(skip8), *strengths, 3, bit_depth)
    for g, d, w in zip(got, direct, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
        assert torch.equal(d, g)


@pytest.mark.parametrize("bit_depth,strengths,frame,skip_share", [
    (8, (12, 3, 9, 3), (16, 24), 0.0), (10, (6, 2, 4, 1), (24, 16), 0.3),
    (8, (4, 1, 3, 1), (64, 128), 1.0)])
def test_cdef_filter_edges_and_skips_match_jax(bit_depth, strengths, frame,
                                               skip_share):
    """cdef_filter's wrapper (the plain version on the CPU) against the
    reference on frames whose every 8x8 unit touches an edge (the taps
    read CDEF_VERY_LARGE outside), and with every unit skipped (the planes
    pass through)."""
    h, w = frame
    rec, _ = _recon(bit_depth, 120, seed=9)
    rec = [np.ascontiguousarray(rec[0][:h, :w])] + [
        np.ascontiguousarray(p[: h // 2, : w // 2]) for p in rec[1:]]
    skip8 = np.random.RandomState(4).rand(h // 8, w // 8) < skip_share
    want = cdef_tpu(*(jnp.asarray(p) for p in rec), jnp.asarray(skip8),
                    *strengths, bit_depth=bit_depth)
    got = cdef_filter(*(torch.from_numpy(p) for p in rec),
                      torch.from_numpy(skip8), *strengths, 3, bit_depth)
    for g, wt, p in zip(got, want, rec):
        assert np.array_equal(g.numpy(), np.asarray(wt))
        if skip_share == 1.0:
            assert np.array_equal(g.numpy(), p)
    if skip_share == 0.0:
        assert not np.array_equal(got[0].numpy(), rec[0])   # it filtered


@pytest.mark.parametrize("q", [60, 200])
def test_select_strengths_matches_jax(q):
    rec, src = _recon(8, q, seed=10)
    ref_fused = np.concatenate([p.ravel() for p in rec]).astype(np.int32)
    src_fused = fuse_planes(*src)
    skip8 = np.random.RandomState(q).rand(H // 8, W // 8) < 0.2
    want = jax_select(jnp.asarray(ref_fused), jnp.asarray(src_fused),
                      jnp.asarray(skip8), H, W)
    args = (torch.from_numpy(ref_fused), torch.from_numpy(src_fused),
            torch.from_numpy(skip8))
    got = cdef.select_strengths(*args, H, W)
    assert np.array_equal(got, want)
    for p in cdef.CDEF_PRESETS[::3]:
        w = float(jax_sse(jnp.asarray(ref_fused), jnp.asarray(src_fused),
                          jnp.asarray(skip8), jnp.asarray(p), H, W))
        g = float(cdef.cdef_sse_fused(*args, tuple(p), H, W))
        assert g == w


@pytest.fixture(scope="module")
def tf_pair():
    clip = moving_clip(W, H, 4, seed=41, dy=1, dx=2)
    frames = [fuse_planes(clip.y[k], clip.u[k], clip.v[k]) for k in range(4)]
    neigh = np.stack([frames[1], frames[2], frames[3]] + [frames[0]] * 4)
    want = jax_tf(jnp.asarray(frames[0]), jnp.asarray(neigh), H, W)
    got = tfilter.temporal_filter_key(torch.from_numpy(frames[0]),
                                      torch.from_numpy(neigh), H, W)
    return [np.asarray(x) for x in want], got


def test_temporal_filter_pixels_match_jax(tf_pair):
    want, got = tf_pair
    assert got[0].dtype == torch.uint8
    diff = int((got[0].numpy() != want[0]).sum())
    assert diff == 0, f"{diff} filtered pixels differ"


def test_temporal_filter_sigmas_match_jax(tf_pair):
    want, got = tf_pair
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def test_median_averages_the_middle_pair():
    x = torch.tensor([4.0, 1.0, 3.0, 2.0])
    assert float(tfilter._median(x)) == 2.5
    assert float(tfilter._median(x[:3])) == 3.0


# ---- deblock_edges' launch geometry (kernels/deblock.py mirrors
# csrc/deblock.cu's tiles; tests/test_torch_cuda.py holds the mirror to the
# library) ----

@pytest.mark.parametrize("h,w,luma", [
    (1088, 1920, True), (544, 960, False), (1088, 1936, True),
    (544, 968, False), (48, 80, True), (48, 80, False), (32, 32, True),
    (16, 16, False)])
def test_deblock_tiles_cover_every_pixel_once(h, w, luma):
    """At the main path's shapes and ragged ones: the tiles' outputs cover
    every pixel exactly once, each tile loads TAPS rows and at least TAPS
    columns (whole 16-byte loads) beyond its output on every side, its
    columns are whole warps of 32 (the copy-out's int4s), a warp per block
    boundary of its columns, the row stride is odd, and a CTA's shared
    memory is within the card's 232,448 bytes."""
    from av1tpu_torch.kernels.deblock import deblock_layout, deblock_tiles

    L = deblock_layout(luma)
    nb, taps = (16, 7) if luma else (8, 3)
    assert L.taps == taps and L.hl >= taps and L.hl % 4 == 0
    assert L.th % nb == 0 and L.tw % 32 == 0
    assert L.threads == 32 * (L.tw // nb + 1)     # a warp per boundary
    assert L.stride % 2 == 1 and L.stride >= L.tw + 2 * L.hl
    assert L.smem == 4 * L.stride * (L.th + 2 * taps) <= 232_448
    cover = np.zeros((h, w), np.int32)
    for (r0, c0, th, tw), (y0, y1, x0, x1) in deblock_tiles(h, w, luma):
        assert th % nb == 0 and tw % nb == 0 and th > 0 and tw > 0
        assert (y0, y1, x0, x1) == (r0 - taps, r0 + L.th + taps,
                                    c0 - L.hl, c0 + L.tw + L.hl)
        cover[r0:r0 + th, c0:c0 + tw] += 1
    assert (cover == 1).all()


def _tiled_plain(plane, v_on, h_on, lvl, bd, luma, s16, th, tw):
    """deblock_plane_plain run tile by tile on windows one block beyond
    each th x tw tile (more than the TAPS rows and columns the kernel's
    tiles load), each tile's output kept: the halo argument of
    csrc/deblock.cu, with the plain arithmetic."""
    from av1tpu_torch.kernels.deblock import deblock_plane_plain

    nb = 16 if luma else 8
    h, w = plane.shape
    out = torch.empty_like(plane)
    for r0 in range(0, h, th):
        for c0 in range(0, w, tw):
            R0, C0 = max(r0 // nb - 1, 0), max(c0 // nb - 1, 0)
            R1, C1 = min((r0 + th) // nb + 1, h // nb), min(
                (c0 + tw) // nb + 1, w // nb)
            win = deblock_plane_plain(
                plane[R0 * nb:R1 * nb, C0 * nb:C1 * nb].contiguous(),
                v_on[R0:R1, C0:C1 - 1].contiguous(),
                h_on[R0:R1 - 1, C0:C1].contiguous(), lvl, 0, bd, luma,
                None if s16 is None else s16[R0:R1, C0:C1].contiguous())
            oy, ox = r0 - R0 * nb, c0 - C0 * nb
            out[r0:r0 + th, c0:c0 + tw] = win[oy:oy + th, ox:ox + tw]
    return out


@pytest.mark.parametrize("luma,split,bd", [
    (True, False, 8), (True, True, 10), (False, True, 8),
    (False, False, 10)])
def test_deblock_edges_on_cpu_is_both_plain_passes(luma, split, bd):
    """deblock_edges on the CPU (deblock_plane_plain) equals deblock_planes'
    two plain passes, the vertical edges and then the horizontal ones, with
    every edge on across the tiles' borders; and a plane cut into tiles
    with a one-block halo gives the same pixels tile by tile (the kernel's
    halo argument, at 32 x 64 luma and 24 x 32 chroma tiles)."""
    from av1tpu_torch.kernels.deblock import (
        deblock_edges, deblock_edges_plain,
    )

    nb = 16 if luma else 8
    h, w = (64, 128) if luma else (48, 64)
    rng = np.random.RandomState(11 + bd)
    pm = (1 << bd) - 1
    base = np.repeat(np.repeat(rng.randint(0, pm + 1, (h // 4, w // 4)), 4,
                               0), 4, 1)
    plane = torch.from_numpy(np.clip(base // 8 * 8 + rng.randint(
        -2, 3, (h, w)), 0, pm).astype(np.int32))
    rows, cols = h // nb, w // nb
    v_on = torch.from_numpy(rng.rand(rows, cols - 1) < 0.7)
    h_on = torch.from_numpy(rng.rand(rows - 1, cols) < 0.7)
    th, tw = (32, 64) if luma else (24, 32)
    v_on[:, tw // nb - 1::tw // nb] = True       # the tiles' borders
    h_on[th // nb - 1::th // nb] = True
    s16 = torch.from_numpy(rng.rand(rows, cols) < 0.4) if split else None
    got = deblock_edges(plane, v_on, h_on, 24, 0, bd, luma, s16)
    want = deblock_edges_plain(
        deblock_edges_plain(plane, v_on, 24, 0, bd, luma, True, s16), h_on,
        24, 0, bd, luma, False, s16)
    assert torch.equal(got, want) and not torch.equal(got, plane)
    assert torch.equal(_tiled_plain(plane, v_on, h_on, 24, bd, luma, s16,
                                    th, tw), want)


# ---- cdef_filter's tiles (kernels/cdef.py:cdef_layout mirrors
# csrc/cdef.cu's and tests/test_torch_cuda.py holds it to the library;
# _cdef_tiles mirrors the kernel's grid) ----

def _cdef_tiles(h: int, w: int):
    """The CTAs of one cdef_filter launch on an h x w frame (csrc/cdef.cu's
    grid of ceil(w/8 / tc) x ceil(h/8 / tr) tiles): each tile's first unit
    (row, column) and its units inside the frame (rows, columns)."""
    from av1tpu_torch.kernels.cdef import cdef_layout

    L = cdef_layout()
    nbr, nbc = h // 8, w // 8
    for r in range(0, nbr, L.tr):
        for c in range(0, nbc, L.tc):
            yield r, c, min(L.tr, nbr - r), min(L.tc, nbc - c)


@pytest.mark.parametrize("h,w", [(1088, 1920), (1080, 1920), (40, 56),
                                 (72, 200), (8, 8), (24, 136)])
def test_cdef_tiles_take_every_unit_once(h, w):
    """At the main path's 1088x1920 and at sizes that are multiples of 8
    but not of the tile: the tiles take each 8x8 unit exactly once, 32 a
    tile (a lane each), and each stages its apron: at least the 2 rows and
    2 columns the taps reach, in 16-byte pieces, at a row stride that puts
    a warp's 4 x 8 luma pixels (and its two 4 x 4 chroma units, V four
    words after U) on 32 banks."""
    from av1tpu_torch.kernels.cdef import cdef_layout

    L = cdef_layout()
    assert L.tr * L.tc == 32 and L.threads % 32 == 0
    assert L.ar >= 2 and L.ac >= 2 and L.ac % 4 == 0
    assert L.ls == 8 * L.tc + 2 * L.ac and L.cs == 4 * L.tc + 2 * L.ac
    assert L.ls % 32 == 8 and L.cs % 32 == 8
    cr = 4 * L.tr + 2 * L.ar
    banks = {(8 * i + j) % 32 for i in range(4) for j in range(8)}
    assert len(banks) == 32
    chroma = {(i * L.cs + j + off) % 32 for i in range(4) for j in range(4)
              for off in (0, cr * L.cs + 4)}
    assert len(chroma) == 32
    cover = np.zeros((h // 8, w // 8), np.int32)
    for r, c, nr, nc in _cdef_tiles(h, w):
        assert r % L.tr == 0 and c % L.tc == 0 and nr > 0 and nc > 0
        cover[r:r + nr, c:c + nc] += 1
    assert (cover == 1).all()


LARGE = 0x4000


def _taps_numpy(stage, at, d, stride, pri, par, sec, damping):
    """cdef.cu's filter_px on a staged plane (numpy): the sample at the
    flat positions `at`, its 12 taps read at +-offset along d (primary)
    and d + 2, d + 6 (secondary), no bound tested."""
    from av1tpu_torch.spec.cdef import CDEF_DIRECTIONS

    def floor_log2(x):
        return 0 if x <= 1 else int(x).bit_length() - 1

    def constrain(diff, thr, damp):
        if thr <= 0:
            return np.zeros_like(diff)
        ad = np.abs(diff)
        m = np.minimum(ad, np.maximum(thr - (ad >> damp), 0))
        return np.where(diff < 0, -m, m)

    flat = stage.reshape(-1)
    px = flat[at]
    dp, ds = max(damping - floor_log2(pri), 0), max(damping - floor_log2(sec),
                                                    0)
    total, mn, mx = np.zeros_like(px), px.copy(), px.copy()
    for k in range(2):
        for o in range(3):
            dy, dx = CDEF_DIRECTIONS[(d, d + 2, d + 6)[o] & 7][k]
            off = dy * stride + dx
            for s in (1, -1):
                q = flat[at + s * off]
                total += ((4 - par, 2 + par)[k] * constrain(q - px, pri, dp)
                          if o == 0 else (2, 1)[k] * constrain(q - px, sec,
                                                               ds))
                mn = np.minimum(mn, q)
                mx = np.maximum(mx, np.where(q == LARGE, -1, q))
    out = px + ((8 + total - (total < 0)) >> 4)
    return np.minimum(np.maximum(out, mn), mx)


def _cdef_tiled(y, u, v, skip8, pri_y, sec_y, pri_uv, sec_uv, damping, bd):
    """csrc/cdef.cu's live path mirrored in numpy, tile by tile: each
    plane's window staged with its apron (CDEF_VERY_LARGE outside the
    frame), every tap read from the stage; the directions and variances
    from the plain version's search."""
    from av1tpu_torch.kernels.cdef import cdef_layout
    from av1tpu_torch.models.cdef import cdef_dirs

    L, cs = cdef_layout(), bd - 8
    dirs, vars_ = (t.numpy() for t in cdef_dirs(torch.from_numpy(y), cs))
    search = pri_y > 0 or pri_uv > 0
    outs = [p.copy() for p in (y, u, v)]
    for r, c, nr, nc in _cdef_tiles(*y.shape):
        for k, (p, n8, stride) in enumerate(((y, 8, L.ls), (u, 4, L.cs),
                                             (v, 4, L.cs))):
            rows = L.tr * n8 + 2 * L.ar
            stage = np.full((rows, stride), LARGE, np.int64)
            y0, x0 = r * n8 - L.ar, c * n8 - L.ac
            ys = slice(max(y0, 0), min(y0 + rows, p.shape[0]))
            xs = slice(max(x0, 0), min(x0 + stride, p.shape[1]))
            stage[ys.start - y0:ys.stop - y0, xs.start - x0:xs.stop - x0] = \
                p[ys, xs]
            luma = k == 0
            if not (pri_y or sec_y if luma else pri_uv or sec_uv):
                continue
            for ur in range(nr):
                for uc in range(nc):
                    R, C = r + ur, c + uc
                    if skip8[R, C]:
                        continue
                    d, var = (dirs[R, C], vars_[R, C]) if search else (0, 0)
                    i, j = np.mgrid[0:n8, 0:n8]
                    at = ((L.ar + ur * n8 + i) * stride + L.ac + uc * n8
                          + j).ravel()
                    if luma:
                        v6 = var >> 6
                        ii = min(int(v6).bit_length() - 1, 12) if v6 > 0 \
                            else 0
                        pri = (((pri_y << cs) * (4 + ii) + 8) >> 4
                               if var > 0 else 0)
                        res = _taps_numpy(stage, at, d, stride, pri,
                                          (pri >> cs) & 1,
                                          (sec_y + (sec_y == 3)) << cs,
                                          damping + cs)
                    else:
                        res = _taps_numpy(stage, at, d, stride,
                                          pri_uv << cs, pri_uv & 1,
                                          (sec_uv + (sec_uv == 3)) << cs,
                                          damping - 1 + cs)
                    outs[k][R * n8:(R + 1) * n8,
                            C * n8:(C + 1) * n8] = res.reshape(n8, n8)
    return outs


@pytest.mark.parametrize("bit_depth,strengths,frame,skip_share", [
    (8, (12, 3, 9, 3), (24, 136), 0.0), (10, (6, 2, 4, 1), (40, 56), 0.3),
    (8, (0, 2, 0, 3), (16, 264), 0.2), (10, (1, 0, 5, 0), (24, 16), 0.0)])
def test_cdef_taps_from_a_padded_apron_match_the_plain_version(
        bit_depth, strengths, frame, skip_share):
    """The premise of cdef.cu's live tiles: every tap read from a tile's
    stage, whose apron beyond the frame holds CDEF_VERY_LARGE, with no
    bound tested, gives cdef_filter_plain's pixels, on frames whose tiles
    are cut by the frame's right and bottom edges and whose units touch
    every edge."""
    h, w = frame
    rng = np.random.RandomState(h + w)
    pm = (1 << bit_depth) - 1
    y = np.clip(np.repeat(np.repeat(rng.randint(0, pm + 1, (h // 4, w // 4)),
                                    4, 0), 4, 1)
                + rng.randint(-9, 10, (h, w)), 0, pm).astype(np.int32)
    u, v = (rng.randint(0, pm + 1, (h // 2, w // 2)).astype(np.int32)
            for _ in range(2))
    skip8 = rng.rand(h // 8, w // 8) < skip_share
    got = _cdef_tiled(y, u, v, skip8, *strengths, 3, bit_depth)
    want = cdef_filter(*(torch.from_numpy(p) for p in (y, u, v)),
                       torch.from_numpy(skip8), *strengths, 3, bit_depth)
    for g, wt in zip(got, want):
        assert np.array_equal(g, wt.numpy())
    assert not np.array_equal(got[0] if strengths[0] or strengths[1]
                              else got[1], (y if strengths[0] or strengths[1]
                                            else u))
