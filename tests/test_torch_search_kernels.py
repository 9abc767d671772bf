"""The motion search's and the loop filter's kernel wrappers on the CPU:
coarse_search, global_search, refine_subpel (kernels/motion.py) and
deblock_edges (kernels/deblock.py) take their plain versions for CPU
tensors and give what those give; they reject what the kernels do not
take; and the search's three frame totals (the coarse 289, the global 125
and the sub-pel 49) are the exact integer sums rounded once to float32, at
sizes where a float32 sum of the block SADs is not exact.

No reference graph is compiled here: the plain versions are held against
av1tpu by tests/test_torch_inter.py (test_search_mv_matches_jax),
tests/test_torch_inter10.py, tests/test_torch_inter_part.py and the
deblock tests of tests/test_torch_filters.py.  The kernels themselves are
held against the plain versions on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from av1tpu_torch.kernels import deblock as kdeblock
from av1tpu_torch.kernels import motion
from av1tpu_torch.models import inter_v
from av1tpu_torch.models.deblock import deblock_planes
from tests.test_torch_threads import single_torch_thread  # noqa: F401

H, W = 64, 128
LAM = np.float32(9.5)


def _pair(bd=8, seed=3, shift=(2, -5)):
    """A source and a reference that is it shifted by `shift` px, noisy."""
    rng = np.random.RandomState(seed)
    pm = (1 << bd) - 1
    big = np.repeat(np.repeat(rng.randint(0, pm + 1, (H // 4 + 8, W // 4 + 8)),
                              4, 0), 4, 1)
    big = np.clip(big + rng.randint(-pm // 16, pm // 16 + 1, big.shape), 0,
                  pm)
    dy, dx = shift
    y = big[16 : 16 + H, 16 : 16 + W]
    r = big[16 + dy : 16 + dy + H, 16 + dx : 16 + dx + W]
    return (torch.from_numpy(np.ascontiguousarray(y, np.int32)),
            torch.from_numpy(np.ascontiguousarray(r, np.int32)))


def _eq(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("bd,nbases", [(8, 2), (10, 3)])
def test_motion_wrappers_on_cpu_are_plain(bd, nbases):
    y, r = _pair(bd)
    pm = (1 << bd) - 1
    c = motion.coarse_search(y, r, LAM)
    _eq(c, motion.coarse_search_plain(y, r, LAM))
    g = motion.global_search(y, r, c[2])
    _eq(g, motion.global_search_plain(y, r, c[2]))
    bases = [c[0], c[1]]
    if nbases == 3:
        prev = torch.from_numpy(np.random.RandomState(1).randint(
            -40, 41, (H // 16, W // 16, 2)).astype(np.int32))
        bases.append(torch.clamp(((prev + 2) >> 2) << 2, -32, 32))
    got = motion.refine_subpel(y, r, bases, *g, LAM, pm)
    _eq(got, motion.refine_subpel_plain(y, r, bases, *g, LAM, pm))
    # and _search_mv, which runs the three in turn, finds the shift
    mv8 = inter_v._search_mv(y, r, LAM, pm)[0]
    assert torch.equal(mv8, got[0])
    assert (mv8 == torch.tensor([-16, 40], dtype=torch.int32)).all(
        -1).float().mean() > 0.5


def _bad_motion_calls():
    y, r = _pair()
    c1, c2, s4 = motion.coarse_search_plain(y, r, LAM)
    c0, g, sg = motion.global_search_plain(y, r, s4)
    meta = torch.empty_like(y, device="meta")
    return {
        "coarse_dtype": (motion.coarse_search, (y.short(), r, LAM), TypeError),
        "coarse_shape": (motion.coarse_search, (y, r[:48].contiguous(), LAM),
                         ValueError),
        "coarse_not_16": (motion.coarse_search,
                          (y[:40].contiguous(), r[:40].contiguous(), LAM),
                          ValueError),
        "coarse_device": (motion.coarse_search, (meta, meta, LAM),
                          ValueError),
        "coarse_strided": (motion.coarse_search,
                           (y.t().contiguous().t(), r, LAM), ValueError),
        "global_shifts": (motion.global_search, (y, r, s4[:3].contiguous()),
                          ValueError),
        "global_dtype": (motion.global_search, (y, r, s4.long()), TypeError),
        "refine_one_base": (motion.refine_subpel,
                            (y, r, [c2], c0, g, sg, LAM, 255), ValueError),
        "refine_four_bases": (motion.refine_subpel,
                              (y, r, [c2, c1, c1, c2], c0, g, sg, LAM, 255),
                              ValueError),
        "refine_base_shape": (motion.refine_subpel,
                              (y, r, [c2, c1[:2].contiguous()], c0, g, sg,
                               LAM, 255), ValueError),
        "refine_sad_dtype": (motion.refine_subpel,
                             (y, r, [c2, c1], c0, g, sg.double(), LAM, 255),
                             TypeError),
        "refine_pix_max": (motion.refine_subpel,
                           (y, r, [c2, c1], c0, g, sg, LAM, 511), ValueError),
        "refine_device": (motion.refine_subpel,
                          (y, r, [c2, c1.to("meta")], c0, g, sg, LAM, 255),
                          ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_motion_calls()))
def test_motion_wrappers_reject_bad_inputs(case):
    fn, args, err = _bad_motion_calls()[case]
    with pytest.raises(err):
        fn(*args)


def _deblock_case(bd, seed, nblk):
    rng = np.random.RandomState(seed)
    pm = (1 << bd) - 1
    rows, cols = 4, 6
    h, w = rows * nblk, cols * nblk
    base = np.repeat(np.repeat(rng.randint(0, pm + 1, (h // 4, w // 4)), 4,
                               0), 4, 1)
    plane = np.clip(base // 8 * 8 + rng.randint(-2, 3, (h, w)), 0, pm)
    return (torch.from_numpy(plane.astype(np.int32)),
            torch.from_numpy(rng.rand(rows, cols - 1) < 0.7),
            torch.from_numpy(rng.rand(rows - 1, cols) < 0.7),
            torch.from_numpy(rng.rand(rows, cols) < 0.4))


@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_edges_on_cpu_is_plain(bd):
    for luma, split in ((True, False), (True, True), (False, True),
                        (False, False)):
        plane, von, hon, s16 = _deblock_case(bd, 4, 16 if luma else 8)
        s = s16 if split else None
        got = kdeblock.deblock_edges(plane, von, hon, 20, 0, bd, luma, s)
        want = kdeblock.deblock_plane_plain(plane, von, hon, 20, 0, bd, luma,
                                            s)
        assert torch.equal(got, want)
        assert not torch.equal(got, plane)
    # a level of 0 passes its plane through with no call
    y, von, hon, s16 = _deblock_case(bd, 5, 16)
    u = _deblock_case(bd, 6, 8)[0]
    out = deblock_planes(y, u, u, von, hon, 0, 9, 0, 0, bd, split16=s16)
    assert out[0] is y and out[2] is u and not torch.equal(out[1], u)


def test_deblock_edges_rejects_bad_inputs():
    plane, von, hon, s16 = _deblock_case(8, 1, 16)
    ok = (plane, von, hon, 12, 0, 8, True, s16)
    kdeblock.deblock_edges(*ok)
    bad = [
        ((plane, von, hon, 0, 0, 8, True, s16), ValueError),    # level 0
        ((plane, von, hon, 12, 8, 8, True, s16), ValueError),   # sharpness
        ((plane, von, hon, 12, 0, 9, True, s16), ValueError),   # bit depth
        ((plane.short(), von, hon, 12, 0, 8, True, s16), TypeError),
        ((plane, hon, von, 12, 0, 8, True, s16), ValueError),   # swapped
        ((plane, von, hon, 12, 0, 8, True, s16.int()), TypeError),
        ((plane[:, :88].contiguous(), von, hon, 12, 0, 8, True, s16),
         ValueError),                                            # not 16
        ((plane.t().contiguous().t(), von, hon, 12, 0, 8, True, s16),
         ValueError),                                            # strided
        ((plane, von.to("meta"), hon, 12, 0, 8, True, s16), ValueError),
        ((plane.to("meta"), von.to("meta"), hon.to("meta"), 12, 0, 8, True,
          s16.to("meta")), ValueError),                          # device
    ]
    for args, err in bad:
        with pytest.raises(err):
            kdeblock.deblock_edges(*args)


def _spy_totals(monkeypatch):
    seen = []
    exact = inter_v._exact_total

    def spy(sads, dims):
        out = exact(sads, dims)
        seen.append((sads.numpy().astype(np.int64), dims, out.numpy()))
        return out

    monkeypatch.setattr(inter_v, "_exact_total", spy)
    return seen


@pytest.mark.parametrize("site", ["coarse", "global", "subpel"])
def test_frame_totals_are_exact(site, monkeypatch):
    """10-bit frames of full-contrast noise, where the totals pass 2^24: a
    float32 sum of the block SADs would depend on its order, the exact
    integer sum rounded once does not."""
    rng = np.random.RandomState(7)
    if site == "coarse":        # 256x256 quarter-res = 4096 16x16 blocks
        src_q, ref_q = (torch.from_numpy(rng.randint(0, 1024, (256, 256))
                                         .astype(np.int32)) for _ in range(2))
        args = (src_q, ref_q, np.float32(1.0), np.float32(40.0))
    y, r = (torch.from_numpy(rng.randint(0, 1024, (256, 256)).astype(
        np.int32)) for _ in range(2))
    seen = _spy_totals(monkeypatch)
    if site == "coarse":
        inter_v._coarse_search(*args)
    elif site == "global":
        inter_v._global_full(y, r, torch.tensor([[4, -4], [0, 8], [0, 0],
                                                 [8, 8]], dtype=torch.int32))
    else:
        mv = torch.zeros((16, 16, 2), dtype=torch.int32)
        inter_v._subpel_refine(inter_v.to_blocks(y, 16),
                               inter_v._gather_patches(r, mv, 16, 4), mv,
                               np.float32(30.0), 1023)
    assert len(seen) == {"coarse": 1, "global": 125, "subpel": 1}[site]
    big = 0
    for sads, dims, out in seen:
        want = sads.sum(axis=dims).astype(np.float32)
        assert out.dtype == np.float32 and np.array_equal(out, want)
        big = max(big, int(sads.sum(axis=dims).max()))
    assert big > 1 << 24


def _clamp(v, pm):
    return np.clip(v, 0, pm)


@pytest.mark.parametrize("bd", [8, 10])
def test_subpel_offsets_are_four_shared_phases(bd, monkeypatch):
    """refine_subpel's kernel computes each filter phase once, 6 taps wide,
    and reads the seven quarter-pel offsets as shifted views: -6/2, -4/4
    and -2/6 are one phase one pixel apart, 0 the identity.  On seeded
    24x24 patches (_subpel_refine's P24) at 8 and 10 bits: the seven
    horizontal passes of _subpel_refine equal the phase passes shifted as
    the kernel reads them, the 49 vertical passes likewise (so the 49 SADs
    _subpel_refine totals, and its prediction, come out of the phase
    passes), and phase 0 is the identity.  The wrapper's premise check
    passes on the port's table and raises on a table without this shape."""
    from av1tpu_torch.spec import tables as spec_tables

    pm = (1 << bd) - 1
    d_all = inter_v._SUBPEL_D
    bank = np.asarray(spec_tables.subpel_filters()["regular"], np.int64)
    rng = np.random.RandomState(bd)
    rows, cols = 2, 3
    p24 = rng.randint(0, pm + 1, (rows, cols, 24, 24)).astype(np.int64)
    src = rng.randint(0, pm + 1, (rows, cols, 16, 16)).astype(np.int64)

    def hor(d):          # _subpel_refine's horizontal pass of offset d
        f, ix = bank[(d & 7) << 1], d >> 3
        return (sum(int(f[k]) * p24[..., :, 1 + ix + k : 17 + ix + k]
                    for k in range(8)) + 4) >> 3

    def ver(hh, d):      # and its vertical pass of offset d
        g, iy = bank[(d & 7) << 1], d >> 3
        return _clamp((sum(int(g[k]) * hh[..., 1 + iy + k : 17 + iy + k, :]
                           for k in range(8)) + 1024) >> 11, pm)

    # the kernel's passes: phase q over 17 columns (rows), taps 1..6; the
    # negative offset reads 0..15, the positive one 1..16
    hphase = {q: (sum(int(bank[q][k]) * p24[..., :, k : k + 17]
                      for k in range(1, 7)) + 4) >> 3 for q in (4, 8, 12)}

    def hview(d):
        if d == 0:
            return (128 * p24[..., :, 4:20] + 4) >> 3
        ph = hphase[(d & 7) << 1]
        return ph[..., :, 0:16] if d < 0 else ph[..., :, 1:17]

    def vview(hh, d):
        if d == 0:
            return _clamp((128 * hh[..., 4:20, :] + 1024) >> 11, pm)
        g = bank[(d & 7) << 1]
        ph = _clamp((sum(int(g[k]) * hh[..., k : k + 17, :]
                         for k in range(1, 7)) + 1024) >> 11, pm)
        return ph[..., 0:16, :] if d < 0 else ph[..., 1:17, :]

    assert bank[0].tolist() == [0, 0, 0, 128, 0, 0, 0, 0]
    assert np.array_equal(hor(0), 16 * p24[..., :, 4:20])
    preds = {}
    for dx in d_all:
        assert np.array_equal(hor(dx), hview(dx)), dx
        for dy in d_all:
            preds[dy, dx] = vview(hview(dx), dy)
            assert np.array_equal(ver(hor(dx), dy), preds[dy, dx]), (dy, dx)
    assert np.array_equal(preds[0, 0], p24[..., 4:20, 4:20])

    # _subpel_refine itself: its 49 SADs and its prediction
    seen = _spy_totals(monkeypatch)
    mv = torch.zeros((rows, cols, 2), dtype=torch.int32)
    mv8, pred = inter_v._subpel_refine(
        torch.from_numpy(src.astype(np.int32)),
        torch.from_numpy(p24.astype(np.int32)), mv, np.float32(2.0), pm)
    sads = np.stack([np.abs(src - preds[dy, dx]).sum((2, 3))
                     for dy in d_all for dx in d_all])
    assert np.array_equal(seen[0][0], sads)
    for r in range(rows):
        for c in range(cols):
            dy, dx = mv8[r, c].tolist()
            assert np.array_equal(pred[r, c].numpy(), preds[dy, dx][r, c])

    # the wrapper's check of the same premise
    taps = motion.subpel_taps()
    motion.check_subpel_phases(d_all, taps)
    # a pair's rows apart, the identity off, taps 0 of a pair not zero
    for rows_, tap in (([4], 7), ([3], 3), ([1, 5], 0)):
        t = taps.copy()
        t[rows_, tap] += 1
        with pytest.raises(ValueError):
            motion.check_subpel_phases(d_all, t)
    with pytest.raises(ValueError):
        motion.check_subpel_phases((-6, -4, -2, 0, 2, 4, 5), taps)


# ---- the premises of coarse_search's warp argmins ------------------------

def _coarse_sads(src_q, ref_q):
    """The 289 quarter-res SADs per 4x4 block, [dy, dx, row, col] int64,
    dy and dx the offset index 0..16 (offset - 8), the reference read
    with its edges clamped."""
    r = inter_v._COARSE_R
    nd = 2 * r + 1
    hq, wq = src_q.shape
    pad = np.pad(ref_q, r, mode="edge")
    sad = np.empty((nd, nd, hq // 4, wq // 4), np.int64)
    for dy in range(nd):
        for dx in range(nd):
            d = np.abs(src_q - pad[dy : dy + hq, dx : dx + wq])
            sad[dy, dx] = d.reshape(hq // 4, 4, wq // 4, 4).sum((1, 3))
    return sad


def _coarse_by_keys(src_q, ref_q, lam, margin, winner="dx", best="column",
                    basin="dy"):
    """coarse_search as its kernel computes it, in numpy: the winner the
    least (cost, dx, dy), best_sad the least raw SAD of the winner's
    column, the second basin the least (cost, dy-major index) outside
    Chebyshev 1, g the first least total, shifts4 four argmins on (total,
    index) each without the earlier picks.  winner="dy", best="winner" and
    basin="dx" give the formulations the kernel must not use (the
    dy-major winner, the SAD at the winner, a dx-major basin)."""
    r = inter_v._COARSE_R
    nd = 2 * r + 1
    offs = np.arange(-r, r + 1, dtype=np.int32)
    vec = inter_v._mv_bias(offs, lam)
    sca = np.array([inter_v._mv_bias(np.int32(d), lam) for d in offs],
                   np.float32)
    sad = _coarse_sads(src_q, ref_q)
    sadf = sad.astype(np.float32)
    cost = sadf + (vec[:, None] + sca[None, :]).astype(np.float32)[
        ..., None, None]
    rows, cols = sad.shape[2:]
    order = cost.transpose(1, 0, 2, 3) if winner == "dx" else cost
    k = np.argmin(order.reshape(nd * nd, rows, cols), axis=0)
    bdx, bdy = (k // nd, k % nd) if winner == "dx" else (k % nd, k // nd)
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    best_sad = (sadf[:, bdx, rr, cc].min(0) if best == "column"
                else sadf[bdy, bdx, rr, cc])
    cost2 = (sadf + vec[:, None, None, None]) + vec[None, :, None, None]
    dyi = np.arange(nd)[:, None, None, None]
    dxi = np.arange(nd)[None, :, None, None]
    near = np.maximum(np.abs(dyi - bdy), np.abs(dxi - bdx)) <= 1
    cost2 = np.where(near, np.float32(np.inf), cost2)
    if basin == "dx":
        k2 = np.argmin(cost2.transpose(1, 0, 2, 3).reshape(nd * nd, rows,
                                                             cols), axis=0)
        k2 = (k2 % nd) * nd + k2 // nd
    else:
        k2 = np.argmin(cost2.reshape(nd * nd, rows, cols), axis=0)
    totals = sad.sum((2, 3)).reshape(-1).astype(np.float32)
    g = int(np.argmin(totals))
    picks = []
    for _ in range(4):           # the select warp's four argmins
        v = totals.copy()
        v[picks] = np.inf
        picks.append(int(np.argmin(v)))
    snap = sadf.reshape(nd * nd, rows, cols)[g] <= (best_sad
                                                  + np.float32(margin))
    coarse = np.stack([np.where(snap, g // nd, bdy),
                       np.where(snap, g % nd, bdx)], -1)
    coarse2 = np.stack([k2 // nd, k2 % nd], -1)
    shifts4 = np.array([(p // nd, p % nd) for p in picks])
    return [(a - r) * 4 for a in (coarse, coarse2, shifts4)]


def _pooled(kind, seed, hq=16, wq=16):
    """Quarter-res planes of at most 64x64 frames: binary noise (SADs of
    0..16, so costs often tie), a flat pair (every SAD ties) or a
    period-2 texture (the totals tie a period apart)."""
    rng = np.random.RandomState(seed)
    if kind == "noise":
        src = rng.randint(0, 2, (hq, wq))
        ref = rng.randint(0, 2, (hq, wq))
    elif kind == "flat":
        src = np.full((hq, wq), 7)
        ref = np.full((hq, wq), 7)
    else:
        yy, xx = np.mgrid[:hq, :wq]
        src = (yy % 2) * 3 + (xx % 2) * 5
        ref = np.roll(src, (1, 0), (0, 1)) + rng.randint(0, 2, (hq, wq))
    return src.astype(np.int32), ref.astype(np.int32)


CASES = [(kind, seed, lam) for kind, seeds in (("noise", range(6)),
                                              ("flat", [0]),
                                              ("periodic", [0, 1]))
         for seed in seeds for lam in (0.0, 3.0)]


@pytest.mark.parametrize("kind,seed,lam", CASES)
def test_coarse_search_is_its_keys(kind, seed, lam):
    """The plain coarse search (models/inter_v.py:_coarse_search) equals
    the lexicographic keys coarse_search's kernel takes its argmins on."""
    src, ref = _pooled(kind, seed)
    lam, margin = np.float32(lam), np.float32(lam * 2)
    got = inter_v._coarse_search(torch.from_numpy(src), torch.from_numpy(ref),
                                 lam, margin)
    for g, w in zip(got, _coarse_by_keys(src, ref, lam, margin)):
        assert np.array_equal(g.numpy(), w)


def test_coarse_keys_are_the_only_ones():
    """On the same frames each wrong formulation of a key (the dy-major
    winner, best_sad at the winner, a dx-major second basin, g or the top
    4 by the last least total) gives another result somewhere, so
    test_coarse_search_is_its_keys holds each key."""
    wrong = {"winner": dict(winner="dy"), "best": dict(best="winner"),
             "basin": dict(basin="dx")}
    seen = set()
    for kind, seed, lam in CASES:
        src, ref = _pooled(kind, seed)
        lam, margin = np.float32(lam), np.float32(lam * 2)
        right = _coarse_by_keys(src, ref, lam, margin)
        for name, kw in wrong.items():
            alt = _coarse_by_keys(src, ref, lam, margin, **kw)
            if any(not np.array_equal(a, b) for a, b in zip(alt, right)):
                seen.add(name)
        totals = _coarse_sads(src, ref).sum((2, 3)).reshape(-1)
        if (totals == totals.min()).sum() > 1:
            seen.add("g tie")
        top = np.sort(totals)[:5]
        if len(set(top[:4])) < 4 or top[3] == top[4]:
            seen.add("top-4 tie")
    assert seen == {"winner", "best", "basin", "g tie", "top-4 tie"}, seen


def test_shifts4_is_a_stable_sort(monkeypatch):
    """The select's four argmins on (total, index), each without the
    earlier picks, are the stable sort's first four on totals with ties."""
    seen = _spy_totals(monkeypatch)
    for kind, seed in (("flat", 0), ("periodic", 0), ("periodic", 1)):
        src, ref = _pooled(kind, seed)
        shifts4 = inter_v._coarse_search(
            torch.from_numpy(src), torch.from_numpy(ref), np.float32(1.0),
            np.float32(2.0))[2].numpy()
        totals = seen[-1][2].reshape(-1)
        stable = np.argsort(totals, kind="stable")[:4]
        assert np.array_equal(shifts4 // 4 + 8, np.stack(
            [stable // 17, stable % 17], -1))
        assert len(set(totals[stable].tolist())) < 4 or kind == "periodic"


# ---- the launch layouts at the main path's shapes -------------------------

# the quality path's 8 coder batches of a 1088x1920 inter frame
# (n, blocks) and the search's frame
CODER_BATCHES = ((16, 8160), (8, 16320), (8, 32640), (4, 65280), (32, 2040),
                 (16, 4080), (64, 510), (32, 1020))


@pytest.mark.parametrize("n,nblocks", CODER_BATCHES)
def test_code_layout_fits_the_card(n, nblocks):
    """code_blocks' launch (kernels/inter_code.py:code_layout, which
    tests/test_torch_cuda.py holds to the library on the card): the CTAs
    cover the batch with one partial CTA at most; each line of the inverse
    (TX_64X64: its 32 coded rows) has a thread; a block's coefficients
    spread over the first version's min(cw^2, 256) threads, so a thread
    holds a power of two of blocks, at most a warp's lanes; and the shared
    memory of a CTA is within the H100's 232,448 bytes."""
    from av1tpu_torch.kernels import inter_code

    lay = inter_code.code_layout(n, nblocks)
    nb, threads = lay["blocks_per_cta"], lay["threads"]
    per_block = min(min(n, 32) ** 2, threads)
    slots = nb * per_block // threads
    assert (lay["ctas"] - 1) * nb < nblocks <= lay["ctas"] * nb
    assert nb * n <= threads and nb * per_block % threads == 0
    assert slots & (slots - 1) == 0 and 1 <= slots <= min(per_block, 32)
    assert lay["smem"] <= inter_code.SMEM_PER_CTA_MAX
    assert lay["dynamic_smem"] == 4 * nb * (n * (n + 1) + min(n, 32) ** 2)


@pytest.mark.parametrize("h,w", [(1088, 1920), (1088, 1936), (48, 80)])
def test_coarse_layout_fits_the_card(h, w):
    """coarse_search's three launches (kernels/motion.py:coarse_layout):
    the sweep's tiles cover the block grid, the pool a thread per
    quarter-res pixel of both planes, the select a thread per block, and
    the sweep's shared memory within a CTA's 232,448 bytes."""
    from av1tpu_torch.kernels.inter_code import SMEM_PER_CTA_MAX

    lay = motion.coarse_layout(h, w)
    rows, cols = h // 16, w // 16
    tr, tc = motion.COARSE_TILE
    assert lay["sweep_ctas"] * tr * tc >= rows * cols
    assert (lay["sweep_ctas"] == -(-rows // tr) * -(-cols // tc)
            < rows * cols)
    assert lay["pool_ctas"] * motion.COARSE_THREADS >= 2 * (h // 4) * (w // 4)
    assert lay["select_ctas"] * motion.COARSE_THREADS >= rows * cols
    assert lay["sweep_threads"] == 32 * tc
    assert lay["sweep_smem"] <= SMEM_PER_CTA_MAX
