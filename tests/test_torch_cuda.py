"""Tests that need an NVIDIA GPU: the CUDA transform+quantize kernel agrees
with its plain PyTorch version at the main path's shapes, the wavefront
keyframe's kernel agrees with its plain version from the same carried
state at every diagonal and over the whole frame (and its ranges add up
to the whole keyframe), the wrappers reject what the kernels do not take, the inter coder's, CDEF's,
the motion search's and the loop filter's kernels agree with their plain
versions bit for bit, the partition probe's four kernels give every output
of its plain versions (and their rate per level is torch.log2's, bit for
bit), the launch layouts' Python mirrors equal the library's, a launch
that the card or the library refuses raises, and the scene batch runs on
the visible GPUs (its workers launching one wavefront launch per
keyframe).  They skip where CUDA is absent.
This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from av1tpu_torch.kernels.inter_code import CODE_BLOCKS_PER_CTA
from av1tpu_torch.kernels.intra_wave import (
    block_diffs, wave_compare, wave_key, wave_key_plain,
)
from av1tpu_torch.kernels.transform_quant import (
    TQPlane, count_level_flips, transform_quantize, transform_quantize_ref,
)
from av1tpu_torch.models.intra_wave import (
    wave_diagonals, wave_setup,
)
from av1tpu_torch.ops.transforms import forward_matrix
from av1tpu_torch.utils.yuv import synthetic_clip


def _case(n, b, seed, tx_type=0):
    rng = np.random.RandomState(seed)
    resid = rng.randint(-255, 255, size=(b, n * n)).astype(np.float32)
    fwdt = np.ascontiguousarray(forward_matrix(n, n, tx_type).T)
    step = np.full((1, n * n), 19.0, np.float32)
    step[0, 0] = 17.0
    q = np.full((1, n * n), 19, np.int32)
    q[0, 0] = 17
    cap = np.full((1, n * n), 1 << 14, np.int32)
    return resid, fwdt, step, q, cap


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(dev):
    # (120, 256) luma rows and (1, 256) the first row's column scan; (240,
    # 64) and (2, 64) the U and V planes together; 37 rows a ragged tile
    for n, b, seed, tx in ((16, 120, 0, 0), (16, 1, 2, 0), (8, 240, 3, 1),
                           (8, 2, 4, 1), (8, 37, 1, 0), (16, 37, 5, 0)):
        resid, *consts = [torch.from_numpy(a).to(dev)
                          for a in _case(n, b, seed, tx)]
        plane = TQPlane(*consts)
        before = transform_quantize.launches
        lv, dq = transform_quantize(resid, plane)
        torch.cuda.synchronize()
        assert transform_quantize.launches == before + 1
        lv_ref, _ = transform_quantize_ref(resid, plane)
        count_level_flips(lv, dq, lv_ref, resid, *consts[:3])


@pytest.mark.cuda
def test_cuda_wrapper_rejects_bad_inputs(dev):
    resid, fwdt, step, q, cap = [torch.from_numpy(a).to(dev)
                                 for a in _case(8, 4, 0)]
    plane = TQPlane(fwdt, step, q, cap)
    with pytest.raises(TypeError):
        transform_quantize(resid.double(), plane)
    with pytest.raises(ValueError):
        transform_quantize(resid.t().contiguous().t(), plane)
    with pytest.raises(ValueError):
        transform_quantize(resid[:, :32].contiguous(), plane)
    with pytest.raises(ValueError):
        transform_quantize(resid, TQPlane(fwdt.cpu(), step.cpu(), q.cpu(),
                                          cap.cpu()))
    # a per-plane constant of the wrong shape, type or device still raises
    with pytest.raises(ValueError):
        TQPlane(fwdt, step[:, :32], q, cap)
    with pytest.raises(ValueError):
        TQPlane(fwdt, step, q.reshape(-1), cap)
    with pytest.raises(TypeError):
        TQPlane(fwdt, step, q, cap.float())
    with pytest.raises(ValueError):
        TQPlane(fwdt, step, q.cpu(), cap)
    # transform sizes the kernel does not take (4x4, 32x32)
    _, *c4 = [torch.from_numpy(a).to(dev) for a in _case(4, 4, 0)]
    with pytest.raises(ValueError):
        TQPlane(*c4)


@pytest.mark.cuda
def test_scene_batch_on_the_gpus(dev):
    """The scene batch on the visible GPUs (one listed twice where there is
    one, so that two worker processes share it): each scene equals the
    same scene encoded in this process on the first card."""
    from av1tpu_torch.models.intra_v import fuse_planes
    from av1tpu_torch.parallel import gop
    from av1tpu_torch.utils.yuv import synthetic_clip

    def scene(n, seed):
        c = synthetic_clip(64, 64, n, seed=seed)
        return {"frames": np.stack([fuse_planes(c.y[i], c.u[i], c.v[i])
                                    for i in range(n)]),
                "q": 100, "key_q": 80, "key_lf": (0, 0, 0),
                "inter_lf": (12, 8, 8), "key_gate": 0.0, "inter_gate": 0.0}

    scenes = [scene(3, 100), scene(2, 101)]
    devices = gop.scene_devices(2, "cuda")
    devices = devices * (2 // len(devices))
    with gop.ScenePool(devices, timeout=600.0) as pool:
        res = gop.SceneBatchEncoder(scenes, pool, 64, 64).encode(8192, 8192)
    assert [r["device"] for r in res] == [str(d) for d in devices]
    assert all(r["peak_bytes"] > 0 for r in res)
    # each worker's keyframe: one wavefront launch
    for r in res:
        assert r["launches"]["wave_key"] == 1, r["launches"]
    for sc, r in zip(scenes, res):
        here = gop._encode_scene(
            dict(sc, frames=torch.from_numpy(sc["frames"])), dev, 64, 64, 8,
            8192, 8192, True, lambda b: gop.key_skip8(b, 64, 64), 1.0)
        for k in ("key_buf", "cdef_s", "ref"):
            assert np.array_equal(here[k], r[k]), k
        assert len(r["inter_bufs"]) == len(sc["frames"]) - 1
        for a, b in zip(here["inter_bufs"], r["inter_bufs"]):
            assert np.array_equal(a, b)


def _wave_planes(bd, dev, w=192, h=128, seed=7):
    c = synthetic_clip(w, h, 1, seed=seed)
    planes = [torch.from_numpy(a[0].astype(np.int32)) for a in (c.y, c.u, c.v)]
    if bd == 10:
        planes = [p * 4 + 2 for p in planes]
    return [p.to(dev) for p in planes]


@pytest.mark.cuda
@pytest.mark.parametrize("bd,q,gate", [(8, 72, 0.0), (10, 40, 6.25)])
def test_wave_kernels_match_plain(dev, bd, q, gate):
    """wave_key over each diagonal from the plain version's carried state
    on a 128x192 frame, then over the whole frame in one launch: where
    pick, tx depth and levels agree the recon, mode and chroma are
    identical (the integer path is exact); a level may differ by 1 where
    the decisions agree (a quantize or rd_zero rounding boundary, float32
    sums in another order than cuBLAS's); a decision may flip at a
    near-tie, or a level differ, in at most 1 of the 96 lanes, in the
    per-diagonal check and in the whole keyframe.  The one launch equals
    the kernel's own chain of one-diagonal launches bit for bit (only the
    one launch waits on the ready flags)."""
    before = wave_key.launches
    o = wave_compare(*_wave_planes(bd, dev), q, bit_depth=bd, lam_scale=0.3,
                     noise_gate=gate)
    torch.cuda.synchronize()
    nd = wave_diagonals(128, 192)
    assert wave_key.launches == before + 2 * nd + 1
    print({k: v for k, v in o.items() if k != "plain"})
    assert o["lanes"] == 96
    assert o["recon_lanes"] == 0
    assert o["level_max_diff"] <= 1
    assert len(o["picks"]) + len(o["txds"]) + o["level_lanes"] <= 1
    whole = o["whole"]
    assert whole["recon"] == 0 and whole["level_max_diff"] <= 1
    assert whole["modes"] + whole["txds"] + whole["levels"] <= 1
    assert o["chain"] == dict.fromkeys(o["chain"], 0) | {"blocks": 96}


@pytest.mark.cuda
@pytest.mark.parametrize("bd,q,ranges", [
    (8, 72, ((0, 1), (1, 9), (9, 10), (10, 26))),
    (10, 40, ((0, 13), (13, 26)))])
def test_wave_key_ranges_equal_the_whole(dev, bd, q, ranges):
    """wave_key over consecutive ranges of diagonals (one launch each)
    gives the whole keyframe's one launch bit for bit, 128x192; the plain
    version over the same ranges gives the plain keyframe."""
    tabs, src, sched, grids = wave_setup(*_wave_planes(bd, dev), q, bd, 0.3,
                                         6.25)
    assert sched.nd == 26
    whole = [g.clone() for g in grids]
    wave_key(*src, *whole, tabs, sched, 0, sched.nd)
    parts = [g.clone() for g in grids]
    for d0, d1 in ranges:
        wave_key(*src, *parts, tabs, sched, d0, d1)
    plain = [g.clone() for g in grids]
    wave_key_plain(*src, *plain, tabs, sched, 0, sched.nd)
    torch.cuda.synchronize()
    for a, b in zip(parts, whole):
        assert torch.equal(a, b)
    diffs = block_diffs(whole, plain)
    assert diffs["recon"] == 0 and diffs["level_max_diff"] <= 1
    assert diffs["modes"] + diffs["txds"] + diffs["levels"] <= 1


@pytest.mark.cuda
def test_wave_wrappers_reject_bad_inputs(dev):
    from av1tpu_torch.models.intra_wave import wave_schedule

    y, u, v = _wave_planes(8, dev, 64, 48)
    tabs, (sy, su, sv), sched, grids = wave_setup(y, u, v, 72, 8, 1.0, 0.0)
    wave_key(sy, su, sv, *grids, tabs, sched, 0, 3)
    before = wave_key.launches
    with pytest.raises(ValueError):                 # on the CPU
        wave_key(sy.cpu(), su, sv, *grids, tabs, sched, 3, 4)
    with pytest.raises(ValueError):                 # not contiguous
        wave_key(sy.t().contiguous().t(), su, sv, *grids, tabs, sched, 3, 4)
    with pytest.raises(ValueError):                 # the grid's shape
        wave_key(sy, su, sv, grids[0][:, :2].contiguous(), *grids[1:],
                 tabs, sched, 3, 4)
    with pytest.raises(TypeError):                  # the levels' dtype
        wave_key(sy, su, sv, *grids[:3], grids[3].int(), *grids[4:], tabs,
                 sched, 3, 4)
    with pytest.raises(ValueError):                 # an empty range
        wave_key(sy, su, sv, *grids, tabs, sched, 3, 3)
    with pytest.raises(ValueError):                 # the schedule's device
        wave_key(sy, su, sv, *grids, tabs, wave_schedule(3, 4, "cpu"), 3, 4)
    with pytest.raises(ValueError):                 # another frame size
        wave_key(sy, su, sv, *grids, tabs, wave_schedule(4, 4, dev), 3, 4)
    assert wave_key.launches == before
    # the tables: one tensor on another device, or of another dtype
    t = {k: getattr(tabs, k) for k in ("fwd16", "mode_vals")}
    with pytest.raises(ValueError):
        wave_tables_like(tabs, fwd16=t["fwd16"].cpu())
    with pytest.raises(TypeError):
        wave_tables_like(tabs, mode_vals=t["mode_vals"].int())


def wave_tables_like(tabs, **changed):
    """A WaveTables with tabs' tensors and scalars, some tensors changed."""
    from av1tpu_torch.kernels.intra_wave import _SPEC, WaveTables

    return WaveTables(lam=tabs.lam, lam_txd0=tabs.lam_txd0, gate=tabs.gate,
                      bit_depth=tabs.bit_depth,
                      **dict({k: getattr(tabs, k) for k in _SPEC}, **changed))


# the inter coder's sites on the quality path: (n, plane type, the quant
# rows' size, dq_shift), and the fast preset's two (no rate, no gate)
CODER_SITES = ((16, 0, 16, 0), (8, 1, 8, 0), (8, 0, 8, 0), (4, 1, 4, 0),
               (32, 0, 32, 1), (16, 1, 16, 0), (32, 1, 32, 1),
               (64, 0, 32, 2))


def _coder_case(dev, n, bd, b, seed, amp):
    """b blocks of n x n int32 source and clipped prediction on dev, and
    their forward product's coefficients."""
    from av1tpu_torch.state import tables

    rng = np.random.RandomState(seed)
    pm = (1 << bd) - 1
    src = torch.from_numpy(rng.randint(0, pm + 1, (b, n, n)).astype(np.int32))
    pred = torch.clamp(src + torch.from_numpy(
        rng.randint(-amp, amp + 1, (b, n, n)).astype(np.int32)), 0, pm)
    src, pred = src.to(dev), pred.to(dev)
    fwdt = tables(dev).fwd64t() if n == 64 else tables(dev).fwdt(n, 0)
    coefs = (src - pred).reshape(b, -1).to(torch.float32) @ fwdt
    return coefs, src, pred


@pytest.mark.cuda
@pytest.mark.parametrize("bd,q,gate", [(8, 72, 4.0), (8, 160, None),
                                       (10, 40, 6.25)])
def test_code_blocks_matches_plain(dev, bd, q, gate):
    """code_blocks against its plain version on the card at every site:
    levels, recon and the integer SSE exactly (the quantize and rd_zero are
    written with the plain version's roundings); the rate and the skip SSE
    are float32 sums in another order than PyTorch's, within 1e-4 of the
    value (n * eps for the at most 1024 or 4096 positive terms)."""
    from av1tpu_torch.kernels.inter_code import code_blocks, code_blocks_plain
    from av1tpu_torch.models import inter_v

    lam = inter_v.part_lambdas(q, bd, dev)[0]
    fast = [(16, 0, 16, 0, None, False), (8, 1, 8, 0, None, False)]
    for k, (n, pt, qn, sh, g, rate) in enumerate(
            [s + (gate, True) for s in CODER_SITES] + fast):
        plane = inter_v._coder(q, bd, dev, n, pt, qn, sh, lam, g, rate)
        nb = CODE_BLOCKS_PER_CTA[n]
        # a batch of one block, one short of a CTA's and of two CTAs', and
        # one that is neither, its even blocks without a level (the
        # kernel skips their inverse)
        for amp, b in ((4, 1), (40, max(nb - 1, 1)),
                       ((1 << bd) - 1, 2 * nb - 1),
                       (20, {4: 97, 8: 45, 16: 13}.get(n, 6))):
            coefs, src, pred = _coder_case(dev, n, bd, b, 10 * k + amp, amp)
            if amp == 20:
                coefs[::2] = 0.0
            before = code_blocks.launches
            got = code_blocks(coefs, src, pred, plane)
            torch.cuda.synchronize()
            assert code_blocks.launches == before + 1
            want = code_blocks_plain(coefs, src, pred, plane)
            for i in range(3):
                assert torch.equal(got[i], want[i]), (n, sh, amp, i)
            for i in (3, 4) if rate else (4,):
                torch.testing.assert_close(got[i], want[i], rtol=1e-4,
                                           atol=0.0)


@pytest.mark.cuda
def test_code_blocks_rejects_bad_inputs(dev):
    from av1tpu_torch.kernels.inter_code import CodePlane, code_blocks
    from av1tpu_torch.models import inter_v

    lam = inter_v.part_lambdas(72, 8, dev)[0]
    plane = inter_v._coder(72, 8, dev, 16, 0, 16, 0, lam, None, True)
    coefs, src, pred = _coder_case(dev, 16, 8, 4, 0, 20)
    code_blocks(coefs, src, pred, plane)
    with pytest.raises(TypeError):                  # float64 coefficients
        code_blocks(coefs.double(), src, pred, plane)
    with pytest.raises(ValueError):                 # on the CPU
        code_blocks(coefs.cpu(), src.cpu(), pred.cpu(), plane)
    with pytest.raises(ValueError):                 # not contiguous
        code_blocks(coefs, src.transpose(1, 2), pred, plane)
    with pytest.raises(ValueError):                 # another block count
        code_blocks(coefs[:3].contiguous(), src, pred, plane)
    with pytest.raises(ValueError):                 # no block
        code_blocks(coefs[:0], src[:0], pred[:0], plane)
    with pytest.raises(TypeError):                  # int16 prediction
        code_blocks(coefs, src, pred.short(), plane)
    # the bundle: a row of the wrong size, type or device
    kw = dict(n=16, step=plane.step, q=plane.q, cap=plane.cap,
              gains=plane.gains, tab=plane.tab, lam=lam, gate=None,
              dq_shift=0, bit_depth=8)
    CodePlane(**kw)
    with pytest.raises(ValueError):
        CodePlane(**dict(kw, step=plane.step[:64].contiguous()))
    with pytest.raises(TypeError):
        CodePlane(**dict(kw, q=plane.q.float()))
    with pytest.raises(ValueError):
        CodePlane(**dict(kw, gains=plane.gains.cpu()))
    with pytest.raises(TypeError):
        CodePlane(**dict(kw, lam=float(lam)))
    with pytest.raises(ValueError):
        CodePlane(**dict(kw, n=12))


def _cdef_case(dev, bd, h, w, seed, skip_share):
    rng = np.random.RandomState(seed)
    pm = (1 << bd) - 1
    base = np.repeat(np.repeat(rng.randint(0, pm + 1, (h // 4, w // 4)), 4,
                               0), 4, 1)
    y = np.clip(base + rng.randint(-9, 10, (h, w)), 0, pm)
    u, v = (rng.randint(0, pm + 1, (h // 2, w // 2)) for _ in range(2))
    skip8 = rng.rand(h // 8, w // 8) < skip_share
    return [torch.from_numpy(a.astype(np.int32)).to(dev) for a in (y, u, v)
            ] + [torch.from_numpy(skip8).to(dev)]


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
def test_cdef_filter_matches_plain(dev, bd):
    """cdef_filter against its plain version on the card, bit for bit (all
    integer): every strength preset of the search and the edge cases (a
    secondary or chroma strength alone, the largest strengths), units at
    the frame's edges (a 40x56 frame has no interior row of units), sizes
    that are multiples of 8 but not of the kernel's 16 x 128 tile, with
    none, some (a mixed map: tiles that are copied, filtered and both)
    and all units skipped."""
    from av1tpu_torch.kernels.cdef import cdef_filter, cdef_filter_plain
    from av1tpu_torch.models.cdef import CDEF_PRESETS

    presets = [tuple(int(x) for x in p) for p in CDEF_PRESETS[1:]] + [
        (0, 2, 0, 3), (1, 0, 0, 0), (0, 0, 5, 0), (15, 3, 15, 3)]
    for h, w, seed in ((1088, 1920, 1), (40, 56, 2), (72, 200, 3),
                       (24, 136, 4)):
        for skip_share in (0.0, 0.3, 1.0):
            y, u, v, sk = _cdef_case(dev, bd, h, w, seed, skip_share)
            for p in presets:
                before = cdef_filter.launches
                got = cdef_filter(y, u, v, sk, *p, 3, bd)
                torch.cuda.synchronize()
                assert cdef_filter.launches == before + 1
                want = cdef_filter_plain(y, u, v, sk, *p, 3, bd)
                for g, wt in zip(got, want):
                    assert torch.equal(g, wt), (h, w, skip_share, p)


@pytest.mark.cuda
def test_cdef_filter_rejects_bad_inputs(dev):
    from av1tpu_torch.kernels.cdef import cdef_filter

    y, u, v, sk = _cdef_case(dev, 8, 64, 64, 0, 0.3)
    cdef_filter(y, u, v, sk, 4, 1, 3, 1)
    with pytest.raises(ValueError):                 # all zero: no call
        cdef_filter(y, u, v, sk, 0, 0, 0, 0)
    with pytest.raises(ValueError):                 # a strength's range
        cdef_filter(y, u, v, sk, 16, 1, 3, 1)
    with pytest.raises(TypeError):                  # int16 luma
        cdef_filter(y.short(), u, v, sk, 4, 1, 3, 1)
    with pytest.raises(TypeError):                  # an int8 skip map
        cdef_filter(y, u, v, sk.to(torch.int8), 4, 1, 3, 1)
    with pytest.raises(ValueError):                 # the chroma's shape
        cdef_filter(y, u[:16].contiguous(), v, sk, 4, 1, 3, 1)
    with pytest.raises(ValueError):                 # not a multiple of 8
        cdef_filter(y[:60].contiguous(), u, v, sk, 4, 1, 3, 1)
    with pytest.raises(ValueError):                 # mixed devices
        cdef_filter(y, u.cpu(), v, sk, 4, 1, 3, 1)
    with pytest.raises(ValueError):                 # not contiguous
        cdef_filter(y.t().contiguous().t(), u, v, sk, 4, 1, 3, 1)


@pytest.mark.cuda
def test_refused_launches_raise(dev):
    """A launch the card refuses (cdef_filter's grid over 65,535 tile rows)
    and one the library refuses (part_chain's four jobs) raise, and count
    no launch."""
    from av1tpu_torch.kernels import intra_part as kpart
    from av1tpu_torch.kernels.cdef import cdef_filter

    h, w = 8 * 2 * 65_536, 8
    y = torch.zeros((h, w), dtype=torch.int32, device=dev)
    u, v = (torch.zeros((h // 2, w // 2), dtype=torch.int32, device=dev)
            for _ in range(2))
    sk = torch.zeros((h // 8, w // 8), dtype=torch.bool, device=dev)
    before = cdef_filter.launches
    with pytest.raises(RuntimeError, match="cdef_filter kernel launch"):
        cdef_filter(y, u, v, sk, 4, 1, 3, 1)
    assert cdef_filter.launches == before
    jobs = _chain_jobs(dev, 8, 72, 2, None)
    with pytest.raises(RuntimeError, match="part_chain kernel launch"):
        kpart._launch(kpart._lib().av1_part_chain, kpart.ChainJobC, [
            kpart.ChainJobC(s=j.site.c, fwdt=j.fwdt.data_ptr(),
                            src=j.src.data_ptr(), lv=j.lv.data_ptr(),
                            rec=j.rec.data_ptr(), cols=2, width=j.src.shape[1],
                            edge0=127) for j in jobs + jobs[:1]],
            "part_chain")
    torch.cuda.synchronize()


def _chain_jobs(dev, bd, q, cols, fill, seed=3):
    """The probe's first-row jobs (luma 16x16, U and V 8x8) over `cols`
    columns: a gradient with noise, or every pixel `fill`."""
    from av1tpu_torch.kernels.intra_part import ChainJob
    from av1tpu_torch.models import intra_part
    from av1tpu_torch.state import tables

    S, T = intra_part._sites(q, bd, dev), tables(dev)
    rng = np.random.RandomState(seed)
    pm = (1 << bd) - 1
    jobs = []
    for site, fwdt, n in ((S.y_chain, T.fwdt(16, 0), 16),
                          (S.c8, T.fwdt(8, 1), 8), (S.c8, T.fwdt(8, 1), 8)):
        x = (np.arange(cols * n)[None, :] * (pm // 300 + 1)
             + np.arange(n)[:, None] * 2)
        img = np.clip(x % (pm + 1) + rng.randint(-pm // 8, pm // 8 + 1,
                                                 x.shape), 0, pm)
        if fill is not None:
            img[:] = fill
        src = torch.from_numpy(img.astype(np.int32)).to(dev)
        jobs.append(ChainJob(site, fwdt, src, torch.full(
            (cols, n, n), -1, dtype=torch.int16, device=dev),
            torch.full((n, cols * n), -1, dtype=torch.int32, device=dev)))
    return jobs


@pytest.mark.cuda
@pytest.mark.parametrize("bd,q", [(8, 72), (10, 40)])
def test_part_chain_matches_plain(dev, bd, q):
    """part_chain (a cluster per plane) beside part_chain_plain under
    chip_smoke.py's _chain_check, at 1, 2, 3 and 120 columns, with the
    planes in one launch and alone: every level the float64 level of its
    coefficient from the kernel's own carry (or, within TIE_REL of a
    boundary, the level across it), every recon pixel exact; on
    gradients and on planes of 0 and of the peak value, where the carried
    edge sits at 0 and at pix_max."""
    import chip_smoke
    from av1tpu_torch.kernels import intra_part as kpart

    pm = (1 << bd) - 1
    for cols in (1, 2, 3, 120):
        for fill in (None, 0, pm):
            jobs = _chain_jobs(dev, bd, q, cols, fill, seed=cols)
            for group in (jobs, jobs[:1], jobs[1:]):
                plain = [chip_smoke._clone_job(j) for j in group]
                before = kpart.part_chain.launches
                kpart.part_chain(group)
                kpart.part_chain_plain(plain)
                torch.cuda.synchronize()
                assert kpart.part_chain.launches == before + 1
                for j, p in zip(group, plain):
                    chip_smoke._chain_check(torch, j, p)


@pytest.mark.cuda
def test_chain_and_cdef_layouts_match_the_library(dev):
    """kernels/intra_part.py:chain_layout and kernels/cdef.py:cdef_layout,
    the Python mirrors of the launches, equal the library's
    (av1_part_chain_layout, av1_cdef_layout)."""
    import ctypes

    from av1tpu_torch._build import cuda_lib
    from av1tpu_torch.kernels import intra_part as kpart
    from av1tpu_torch.kernels.cdef import cdef_layout

    jobs = _chain_jobs(dev, 8, 72, 2, None)
    for group in (jobs, jobs[:1], jobs[1:], jobs[2:]):
        arr = (kpart.ChainJobC * len(group))(*[
            kpart.ChainJobC(s=j.site.c, cols=2, width=j.src.shape[1])
            for j in group])
        out = (ctypes.c_int * 4)()
        assert kpart._lib().av1_part_chain_layout(arr, len(group), out) == 0
        assert tuple(out) == tuple(kpart.chain_layout(
            [j.site.n for j in group]))
    out = (ctypes.c_int * 7)()
    assert cuda_lib().av1_cdef_layout(out) == 0
    assert tuple(out) == tuple(cdef_layout())


def _search_pair(dev, bd, h, w, seed, shift, kind="texture"):
    """A source and a reference that is it shifted by `shift` px: with
    noise, synthetic_clip's texture (10-bit: times 4 plus noise); without,
    blurred noise (one clear minimum), a flat frame or a periodic texture
    of period 4, where SADs tie."""
    rng = np.random.RandomState(seed)
    pm = (1 << bd) - 1
    if kind == "smooth":
        big = rng.rand(h + 96, w + 96)
        for _ in range(3):          # three 7-tap box blurs in each direction
            for ax in (0, 1):
                c = np.cumsum(np.pad(big, [(4, 3) if i == ax else (0, 0)
                                           for i in (0, 1)], mode="edge"),
                              axis=ax)
                n = c.shape[ax]
                big = (np.take(c, range(7, n), ax)
                       - np.take(c, range(n - 7), ax)) / 7
        big = ((big - big.min()) / (big.max() - big.min()) * pm).astype(
            np.int32)
    elif kind == "flat":
        big = np.full((h + 96, w + 96), pm // 3)
    elif kind == "periodic":
        yy, xx = np.mgrid[: h + 96, : w + 96]
        big = ((yy % 4) * 40 + (xx % 4) * 20) * (pm // 255)
    else:
        big = synthetic_clip(w + 96, h + 96, 1, seed=seed).y[0].astype(
            np.int32)
        if bd == 10:
            big = big * 4 + rng.randint(0, 4, big.shape)
    dy, dx = shift
    y = big[48 : 48 + h, 48 : 48 + w]
    r = big[48 + dy : 48 + dy + h, 48 + dx : 48 + dx + w]
    if kind == "texture":
        r = np.clip(r + rng.randint(-2, 3, (h, w)), 0, pm)
    return (torch.from_numpy(np.ascontiguousarray(y, np.int32)).to(dev),
            torch.from_numpy(np.ascontiguousarray(r, np.int32)).to(dev))


# (h, w), shift, seed, kind: the main path's 1088x1920, a frame of 4x8
# blocks, 384x640 and 720x1280 (block grids 24x40 and 45x80, which the
# global sweep's 2x4 tiles do not all divide), a pan near the +-34 clamp
# and one past it (the descents' candidates clipped), and a flat frame
# and a periodic texture, where every SAD ties; then block grids that the
# coarse sweep's 4x8 tiles do not divide (68x121 and 3x5), with a tie in
# the totals (flat: all 289 equal) and in the top 4 (periodic: equal
# totals at shifts a period apart)
SEARCH_FRAMES = (((1088, 1920), (3, -7), 1, "texture"),
                 ((64, 128), (0, 0), 2, "texture"),
                 ((384, 640), (30, -33), 3, "texture"),
                 ((720, 1280), (-5, 9), 4, "texture"),
                 ((384, 640), (36, -37), 7, "smooth"),
                 ((384, 640), (0, 0), 5, "flat"),
                 ((720, 1280), (2, 1), 6, "periodic"),
                 ((1088, 1936), (-6, 11), 8, "texture"),
                 ((48, 80), (2, -3), 9, "texture"),
                 ((48, 80), (0, 0), 10, "flat"),
                 ((1088, 1936), (1, 2), 11, "periodic"))


@pytest.mark.cuda
@pytest.mark.parametrize("bd,nbases", [(8, 2), (8, 3), (10, 2), (10, 3)])
def test_motion_kernels_match_plain(dev, bd, nbases):
    """coarse_search, global_search and refine_subpel against their plain
    versions on the card, every output equal, on SEARCH_FRAMES, with the
    inter steps' lambda and the temporal filter's (4.0), with 2 bases and
    with a temporal third."""
    from av1tpu_torch.kernels import motion
    from av1tpu_torch.models.inter_v import inter_lambdas

    pm = (1 << bd) - 1
    for (h, w), shift, seed, kind in SEARCH_FRAMES:
        y, r = _search_pair(dev, bd, h, w, seed, shift, kind)
        for lam in (inter_lambdas(72 if bd == 8 else 40, bd, dev)[0],
                    np.float32(4.0)):
            n0 = (motion.coarse_search.launches, motion.global_search.launches,
                  motion.refine_subpel.launches)
            c = motion.coarse_search(y, r, lam)
            cw = motion.coarse_search_plain(y, r, lam)
            g = motion.global_search(y, r, c[2])
            gw = motion.global_search_plain(y, r, cw[2])
            bases = [c[0], c[1]]
            if nbases == 3:
                prev = torch.from_numpy(np.random.RandomState(seed).randint(
                    -40, 41, (h // 16, w // 16, 2)).astype(np.int32)).to(dev)
                bases.append(torch.clamp(((prev + 2) >> 2) << 2, -32, 32))
            got = motion.refine_subpel(y, r, bases, *g, lam, pm)
            want = motion.refine_subpel_plain(y, r, bases, *gw, lam, pm)
            torch.cuda.synchronize()
            assert (motion.coarse_search.launches - n0[0],
                    motion.global_search.launches - n0[1],
                    motion.refine_subpel.launches - n0[2]) == (3, 3, 2)
            names = ("coarse", "coarse2", "shifts4", "c0", "g_full", "sad_g",
                     "mv8", "pred_y", "mv_px", "coarse_f", "off_f")
            for name, a, b in zip(names, (*c, *g, *got), (*cw, *gw, *want)):
                assert a.dtype == b.dtype and torch.equal(a, b), (
                    h, w, shift, kind, float(lam), name, int((a != b).sum()))


@pytest.mark.cuda
def test_coder_and_coarse_layouts_match_the_library(dev):
    """kernels/inter_code.py:code_layout and kernels/motion.py:
    coarse_layout, the Python mirrors of the two kernels' launches, equal
    what the built library launches (blocks and threads per CTA, grids,
    dynamic and static shared bytes, cudaFuncGetAttributes' included)."""
    import ctypes

    from av1tpu_torch._build import cuda_lib
    from av1tpu_torch.kernels import inter_code, motion

    lib = cuda_lib()
    for n in inter_code.SIZES:
        out = (ctypes.c_int * 4)()
        assert lib.av1_code_blocks_layout(n, out) == 0
        want = inter_code.code_layout(n, 1)
        assert list(out) == [want[k] for k in (
            "blocks_per_cta", "threads", "dynamic_smem", "static_smem")], n
    for h, w in ((1088, 1920), (1088, 1936), (48, 80), (64, 128)):
        out = (ctypes.c_int * 5)()
        assert lib.av1_coarse_layout(h, w, out) == 0
        want = motion.coarse_layout(h, w)
        assert list(out) == [want[k] for k in (
            "pool_ctas", "sweep_ctas", "select_ctas", "sweep_threads",
            "sweep_smem")], (h, w)


@pytest.mark.cuda
def test_motion_kernels_reject_bad_inputs(dev):
    from av1tpu_torch.kernels import motion

    y, r = _search_pair(dev, 8, 64, 128, 3, (1, 1))
    lam = np.float32(9.0)
    c1, c2, s4 = motion.coarse_search(y, r, lam)
    c0, g, sg = motion.global_search(y, r, s4)
    motion.refine_subpel(y, r, [c1, c2], c0, g, sg, lam, 255)
    with pytest.raises(TypeError):                  # int16 source
        motion.coarse_search(y.short(), r, lam)
    with pytest.raises(ValueError):                 # mixed devices
        motion.coarse_search(y, r.cpu(), lam)
    with pytest.raises(ValueError):                 # not a multiple of 16
        motion.coarse_search(y[:40].contiguous(), r[:40].contiguous(), lam)
    with pytest.raises(ValueError):                 # not contiguous
        motion.global_search(y.t().contiguous().t(), r, s4)
    with pytest.raises(ValueError):                 # shifts4's shape
        motion.global_search(y, r, s4[:3].contiguous())
    with pytest.raises(ValueError):                 # one base
        motion.refine_subpel(y, r, [c1], c0, g, sg, lam, 255)
    with pytest.raises(ValueError):                 # four bases
        motion.refine_subpel(y, r, [c1, c2, c1, c2], c0, g, sg, lam, 255)
    with pytest.raises(ValueError):                 # a base on the CPU
        motion.refine_subpel(y, r, [c1, c2.cpu()], c0, g, sg, lam, 255)
    with pytest.raises(TypeError):                  # sad_g's type
        motion.refine_subpel(y, r, [c1, c2], c0, g, sg.double(), lam, 255)
    with pytest.raises(ValueError):                 # pix_max
        motion.refine_subpel(y, r, [c1, c2], c0, g, sg, lam, 511)


def _deblock_planes_case(dev, bd, h, w, seed, p_on=0.8, p_split=0.3):
    """Blocky planes (4x4 cells on a coarse grid, small noise: every filter
    branch fires), random edge gates and a random split map (all on and
    all split at p_on = p_split = 1)."""
    rng = np.random.RandomState(seed)
    pm = (1 << bd) - 1

    def plane(hh, ww):
        base = np.repeat(np.repeat(rng.randint(0, pm + 1, (hh // 4, ww // 4)),
                                   4, 0), 4, 1)
        return np.clip(base // 8 * 8 + rng.randint(-2, 3, (hh, ww)), 0, pm)

    rows, cols = h // 16, w // 16
    planes = [torch.from_numpy(p.astype(np.int32)).to(dev) for p in (
        plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2))]
    maps = [torch.from_numpy(m).to(dev) for m in (
        rng.rand(rows, cols - 1) < p_on, rng.rand(rows - 1, cols) < p_on,
        rng.rand(rows, cols) < p_split)]
    return planes, maps


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
def test_deblock_edges_matches_plain(dev, bd):
    """deblock_edges (both directions of a plane, one launch) against its
    plain version on the card, bit for bit (all integer): luma and chroma,
    with and without the split map, levels from 1 to 63, sharpness 0 and
    5, at 1088x1920, at sizes that are no multiple of the kernel's tiles
    (1088x1936 with 544x968 chroma, 48x80), a frame of 2x3 blocks and one
    of two blocks each way; every edge on and every block split at levels
    1, 32 and 63; and deblock_planes through the kernel against
    deblock_planes through the plain version."""
    from av1tpu_torch.kernels import deblock as kdeblock
    from av1tpu_torch.models import deblock as mdeblock

    levels = ((1, 0), (12, 0), (32, 0), (40, 5), (63, 0))
    for (h, w), seed, p_on, p_split, lv in (
            ((1088, 1920), 1, 0.8, 0.3, levels),
            ((1088, 1936), 3, 0.8, 0.3, levels),
            ((48, 80), 4, 0.8, 0.3, levels),
            ((32, 48), 2, 0.8, 0.3, levels),
            ((32, 32), 5, 0.8, 0.3, levels),
            ((1088, 1936), 6, 1.0, 1.0, ((1, 0), (32, 0), (63, 0))),
            ((64, 96), 7, 1.0, 1.0, ((1, 0), (32, 0), (63, 0)))):
        (y, u, v), (von, hon, s16) = _deblock_planes_case(
            dev, bd, h, w, seed, p_on, p_split)
        for plane, luma in ((y, True), (u, False)):
            for split in (None, s16):
                for lvl, sharp in lv:
                    before = kdeblock.deblock_edges.launches
                    got = kdeblock.deblock_edges(plane, von, hon, lvl, sharp,
                                                 bd, luma, split)
                    torch.cuda.synchronize()
                    assert kdeblock.deblock_edges.launches == before + 1
                    want = kdeblock.deblock_plane_plain(
                        plane, von, hon, lvl, sharp, bd, luma, split)
                    assert torch.equal(got, want), (
                        h, w, luma, split is None, lvl, sharp,
                        int((got != want).sum()))
        for split in (None, s16):
            got = mdeblock.deblock_planes(y, u, v, von, hon, 20, 20, 10, 0,
                                          bd, split16=split)
            saved = mdeblock.deblock_edges
            mdeblock.deblock_edges = kdeblock.deblock_plane_plain
            try:
                want = mdeblock.deblock_planes(y, u, v, von, hon, 20, 20, 10,
                                               0, bd, split16=split)
            finally:
                mdeblock.deblock_edges = saved
            for g, wt in zip(got, want):
                assert torch.equal(g, wt)


@pytest.mark.cuda
def test_deblock_edges_rejects_bad_inputs(dev):
    from av1tpu_torch.kernels.deblock import deblock_edges

    (y, _, _), (von, hon, s16) = _deblock_planes_case(dev, 8, 64, 96, 0)
    deblock_edges(y, von, hon, 12, 0, 8, True, s16)
    with pytest.raises(ValueError):                 # level 0: no call
        deblock_edges(y, von, hon, 0, 0, 8, True, s16)
    with pytest.raises(TypeError):                  # int16 plane
        deblock_edges(y.short(), von, hon, 12, 0, 8, True, s16)
    with pytest.raises(ValueError):                 # the edge maps swapped
        deblock_edges(y, hon, von, 12, 0, 8, True, s16)
    with pytest.raises(TypeError):                  # an int split map
        deblock_edges(y, von, hon, 12, 0, 8, True, s16.int())
    with pytest.raises(ValueError):                 # mixed devices
        deblock_edges(y, von.cpu(), hon, 12, 0, 8, True, s16)
    with pytest.raises(ValueError):                 # not contiguous
        deblock_edges(y.t().contiguous().t(), von, hon, 12, 0, 8, True, s16)
    with pytest.raises(ValueError):                 # not a multiple of 16
        deblock_edges(y[:, :88].contiguous(), von, hon, 12, 0, 8, True, s16)
    with pytest.raises(ValueError):                 # not 16-byte aligned
        deblock_edges(torch.cat([y.flatten()[:1], y.flatten()])[1:].view(
            64, 96), von, hon, 12, 0, 8, True, s16)


@pytest.mark.cuda
def test_deblock_layout_matches_the_library(dev):
    """kernels/deblock.py:deblock_layout, the Python mirror of the
    kernel's tiles, equals csrc/deblock.cu's (av1_deblock_layout)."""
    import ctypes

    from av1tpu_torch._build import cuda_lib
    from av1tpu_torch.kernels.deblock import deblock_layout

    for luma in (True, False):
        out = (ctypes.c_int * 7)()
        assert cuda_lib().av1_deblock_layout(int(luma), out) == 0
        assert tuple(out) == tuple(deblock_layout(luma))


PARTS = ("part_chain", "part_pred", "part_code", "part_merge")


@pytest.mark.cuda
@pytest.mark.parametrize("bd,q", [(8, 72), (8, 180), (10, 72), (10, 30)])
def test_probe_kernels_match_plain(dev, bd, q):
    """The partition probe on the card with its four kernels
    (kernels/intra_part.py) and with their plain versions, on a 256x384
    frame (four superblock rows): every output of encode_intra_part equal,
    and each kernel launched part_launches times."""
    from av1tpu_torch.kernels import intra_part as kpart
    from av1tpu_torch.models import intra_part

    planes = _wave_planes(bd, dev, w=384, h=256, seed=5)
    before = {n: getattr(kpart, n).launches for n in PARTS}
    got = intra_part.encode_intra_part(*planes, q, bit_depth=bd)
    torch.cuda.synchronize()
    assert {n: getattr(kpart, n).launches - before[n] for n in PARTS} == (
        intra_part.part_launches(256, 384))
    saved = {n: getattr(intra_part, n) for n in PARTS}
    try:
        for n in PARTS:
            setattr(intra_part, n, getattr(kpart, n + "_plain"))
        want = intra_part.encode_intra_part(*planes, q, bit_depth=bd)
    finally:
        for n, f in saved.items():
            setattr(intra_part, n, f)
    torch.cuda.synchronize()
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), (k, int((got[k] != want[k])
                                                     .sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10])
def test_probe_flat_and_narrow_frames_match_plain(dev, bd):
    """part_code beside part_code_plain on every call of the probe, on a
    flat frame (the prediction is the source: every column of every site,
    the 64 and 32 ones included, has no level and skips its inverse) and
    on a frame one superblock wide (64 px, three superblock rows): the
    levels, recon, modes and rates of every call equal (==), and every
    output of encode_intra_part equal to the probe through the plain
    versions."""
    from av1tpu_torch.kernels import intra_part as kpart
    from av1tpu_torch.models import intra_part

    # the first row's prediction, (1 << (bd - 1)) - 1, everywhere
    flat = [torch.full((h, w), (1 << (bd - 1)) - 1, dtype=torch.int32,
                       device=dev) for h, w in ((256, 384), (128, 192),
                                                (128, 192))]
    for planes, q in ((flat, 72), (_wave_planes(bd, dev, w=64, h=192,
                                                seed=9), 40)):
        seen = {"columns": 0, "skipped": 0}
        code = intra_part.part_code

        def both(jobs):
            copies = [j._replace(**{k: v.clone() for k, v in
                                    j._asdict().items()
                                    if isinstance(v, torch.Tensor)})
                      for j in jobs]
            kpart.part_code_plain(copies)
            code(jobs)
            torch.cuda.synchronize()
            # before a later merge rewrites the recon bands
            for j, p in zip(jobs, copies):
                for k in ("lv", "rec", "modes", "rate"):
                    a = getattr(j, k)
                    if a is not None:
                        assert torch.equal(a, getattr(p, k)), (
                            k, j.site.n, int((a != getattr(p, k)).sum()))
                seen["columns"] += j.lv.shape[0]
                seen["skipped"] += int((j.lv.flatten(1) == 0).all(1).sum())

        intra_part.part_code = both
        try:
            got = intra_part.encode_intra_part(*planes, q, bit_depth=bd)
        finally:
            intra_part.part_code = code
        torch.cuda.synchronize()
        if planes is flat:      # every column of every site skips
            assert seen["skipped"] == seen["columns"] > 0, seen
        saved = {n: getattr(intra_part, n) for n in PARTS}
        try:
            for n in PARTS:
                setattr(intra_part, n, getattr(kpart, n + "_plain"))
            want = intra_part.encode_intra_part(*planes, q, bit_depth=bd)
        finally:
            for n, f in saved.items():
                setattr(intra_part, n, f)
        for k in want:
            assert torch.equal(got[k], want[k]), (k, int((got[k] != want[k])
                                                        .sum()))


@pytest.mark.cuda
def test_part_code_layout_matches_the_library(dev):
    """kernels/intra_part.py:code_ctas and code_smem, the Python mirrors
    of part_code's launch, equal the library's (av1_part_code_layout) on
    every launch kind of the probe at 1088x1920 (U and V together), and the
    shared memory per CTA stays within the card's 232,448 bytes."""
    import ctypes

    from av1tpu_torch.kernels import intra_part as kpart
    from av1tpu_torch.models import intra_part

    calls = []
    code = intra_part.part_code

    def catch(jobs):
        calls.append(list(jobs))
        return code(jobs)

    intra_part.part_code = catch
    try:
        intra_part.encode_intra_part(*_wave_planes(8, dev, w=1920, h=1088,
                                                   seed=3), 72)
    finally:
        intra_part.part_code = code
    kinds = {}
    for jobs in calls:
        kinds.setdefault(tuple(j.site.n for j in jobs), jobs)
    assert len(kinds) == 6
    for jobs in kinds.values():
        arr = (kpart.CodeJobC * len(jobs))(*[kpart.CodeJobC(
            s=j.site.c, coefs=j.coefs.data_ptr(), pred=j.pred.data_ptr(),
            src=j.src.data_ptr(), lv=j.lv.data_ptr(), rec=j.rec.data_ptr(),
            cols=j.lv.shape[0], width=j.src.shape[1]) for j in jobs])
        out = (ctypes.c_int * 3)()
        assert kpart._lib().av1_part_code_layout(arr, len(jobs), out) == 0
        assert (out[0], out[1]) == (kpart.code_ctas(jobs),
                                    kpart.code_smem(jobs))
        assert out[1] + out[2] <= 232_448


@pytest.mark.cuda
def test_part_code_log2_rate_bit_for_bit(dev):
    """part_code's rate per level, 2 + log2f(1 + |l|) (no fast math),
    against torch.log2 on the card for every magnitude up to the cap (q
    index 0: 16384): block c holds the one level c + 1, so its rate is that
    level's; the plain version's rate equals it too."""
    from av1tpu_torch.kernels.intra_part import (
        COST_NONE, CodeJob, PartSite, part_code, part_code_plain,
    )
    from av1tpu_torch.models.intra_v import _plane_params

    step, q, cap = _plane_params(0, 16, 8, dev)
    cols = int(cap[1])
    site = PartSite(n=16, tx=0, nm=1, step=step, q=q, cap=cap, tab=None,
                    gains=None, lam=np.float32(1.0), dq_shift=0,
                    cost=COST_NONE, bit_depth=8)
    a = torch.arange(1, cols + 1, dtype=torch.float32, device=dev)
    coefs = torch.zeros((cols, 256), device=dev)
    coefs[:, 1] = a * step[1]
    pred = torch.zeros((cols, 256), dtype=torch.int32, device=dev)
    src = torch.zeros((16, 16 * cols), dtype=torch.int32, device=dev)

    def run(fn):
        lv = torch.empty((cols, 16, 16), dtype=torch.int16, device=dev)
        rec = torch.empty((16, 16 * cols), dtype=torch.int32, device=dev)
        rate = torch.empty((1, cols), device=dev)
        fn([CodeJob(site, coefs, pred, src, lv, rec, rate=rate)])
        return lv, rate

    lv, rate = run(part_code)
    _, plain_rate = run(part_code_plain)
    torch.cuda.synchronize()
    assert torch.equal(lv.flatten(1)[:, 1].to(torch.float32), a)
    assert int(lv.flatten(1)[:, 2:].abs().sum()) == 0
    assert torch.equal(rate[0], 2.0 + torch.log2(1.0 + a))
    assert torch.equal(rate, plain_rate)


def _probe_calls(dev, names, h=1088, w=1920):
    """Each call of the probe's wrappers `names` on a 1088x1920 frame at q
    72 (8 bits), by wrapper: the jobs of every call, in order."""
    from av1tpu_torch.models import intra_part

    calls = {n: [] for n in names}
    saved = {n: getattr(intra_part, n) for n in names}

    def catch(name):
        def run(jobs):
            calls[name].append(list(jobs))
            return saved[name](jobs)
        return run

    try:
        for n in names:
            setattr(intra_part, n, catch(n))
        intra_part.encode_intra_part(*_wave_planes(8, dev, w=w, h=h,
                                                   seed=3), 72)
    finally:
        for n, f in saved.items():
            setattr(intra_part, n, f)
    torch.cuda.synchronize()
    return calls


def _pred_structs(jobs):
    from av1tpu_torch.kernels import intra_part as kpart

    return (kpart.PredJobC * len(jobs))(*[kpart.PredJobC(
        bottom=j.bottom.data_ptr(), src=j.src.data_ptr(),
        av=None if j.av is None else j.av.data_ptr(),
        resid=j.resid.data_ptr(), pred=j.pred.data_ptr(), n=j.src.shape[0],
        nm=1 if j.av is None else 3, cols=j.src.shape[1] // j.src.shape[0],
        width=j.src.shape[1]) for j in jobs])


def _merge_structs(jobs):
    from av1tpu_torch.kernels import intra_part as kpart

    return (kpart.MergeJobC * len(jobs))(*[kpart.MergeJobC(
        ns=j.lv_s.shape[-1], width=j.recon.shape[1], sb_row=j.sb_row,
        half=j.half, do_big=int(j.do_big)) for j in jobs])


@pytest.mark.cuda
def test_pred_and_merge_layouts_match_the_library(dev):
    """kernels/intra_part.py:pred_ctas and merge_layout, the Python
    mirrors of part_pred's flat grid and part_merge's clusters, equal the
    library's (av1_part_pred_layout, av1_part_merge_layout) on every launch
    kind of the probe at 1088x1920: a CTA per 16 8x8, 4 16x16 or one
    larger column, the programmatic-serialization attribute on both, two
    CTAs a cluster for part_merge, and its shared memory within the card's
    232,448 bytes."""
    import ctypes

    from av1tpu_torch.kernels import intra_part as kpart

    calls = _probe_calls(dev, ("part_pred", "part_merge"))
    kinds = {}
    for jobs in calls["part_pred"]:
        kinds.setdefault(tuple(j.src.shape[0] for j in jobs), jobs)
    assert len(kinds) == 6
    for jobs in kinds.values():
        out = (ctypes.c_int * 4)()
        assert kpart._lib().av1_part_pred_layout(_pred_structs(jobs),
                                                 len(jobs), out) == 0
        assert tuple(out) == (kpart.pred_ctas(jobs), 256, 1, 1)
    kinds = {}
    for jobs in calls["part_merge"]:
        kinds.setdefault((len(jobs), jobs[0].do_big), jobs)
    assert len(kinds) == 4
    for jobs in kinds.values():
        out = (ctypes.c_int * 6)()
        assert kpart._lib().av1_part_merge_layout(_merge_structs(jobs),
                                                  len(jobs), out) == 0
        assert tuple(out[:4]) == tuple(kpart.merge_layout(jobs))
        assert out[5] == 2 and 0 < out[4] <= 232_448


@pytest.mark.cuda
def test_refused_pred_and_merge_launches_raise(dev, monkeypatch):
    """part_pred and part_merge never fall back: a launch that the library
    refuses (seven part_pred jobs, three part_merge jobs) raises, and so
    does one whose launch with the programmatic-serialization attribute
    or the cluster is refused (the launcher's cudaError, here
    cudaErrorNotSupported 801 and cudaErrorInvalidClusterSize 912): no launch
    counted, the plain version not run, the outputs untouched."""
    from av1tpu_torch.kernels import intra_part as kpart

    calls = _probe_calls(dev, ("part_pred", "part_merge"), h=128, w=192)
    pred, merge = calls["part_pred"][1], calls["part_merge"][-1]
    lib = kpart._lib()
    with pytest.raises(RuntimeError, match="part_pred kernel launch"):
        kpart._launch(lib.av1_part_pred, kpart.PredJobC,
                      list(_pred_structs(pred * 7)[:7]), "part_pred")
    with pytest.raises(RuntimeError, match="part_merge kernel launch"):
        kpart._launch(lib.av1_part_merge, kpart.MergeJobC,
                      list(_merge_structs(merge * 3)), "part_merge")

    class Refusing:
        def __init__(self, code):
            self.code = code

        def __getattr__(self, name):
            return lambda *a: self.code

    def no_plain(jobs):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(kpart, "part_pred_plain", no_plain)
    monkeypatch.setattr(kpart, "part_merge_plain", no_plain)
    for code in (801, 912):
        monkeypatch.setattr(kpart, "_lib", lambda code=code: Refusing(code))
        for fn, jobs, outs in ((kpart.part_pred, pred, ("resid", "pred")),
                               (kpart.part_merge, merge, ("recon", "lv_s",
                                                          "split"))):
            before = fn.launches
            kept = [[getattr(j, k).clone() for k in outs] for j in jobs]
            with pytest.raises(RuntimeError, match=f"cudaError {code}"):
                fn(jobs)
            assert fn.launches == before
            for j, old in zip(jobs, kept):
                for k, t in zip(outs, old):
                    assert torch.equal(getattr(j, k), t), k
    torch.cuda.synchronize()
