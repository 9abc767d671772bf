"""The wavefront keyframe as one wrapped persistent kernel
(av1tpu_torch/kernels/intra_wave.py:wave_key) on the CPU: the tables
bundle, the schedule and the wrapper refuse what the kernel does not take,
the kernel's tickets and waits (walked here in plain Python) never wait on
a later ticket and finish every block a lane reads before it starts, the
plain version's ranges add up to the whole keyframe, the CPU path takes
the plain pair once each per diagonal and launches nothing, the bundle
holds the rows the encode reads, sub_chain's prediction row is the
reference's, and the compare helper that chip_smoke.py runs on the card
reports what differs.

The plain pair is held against the reference's keyframe (every level,
mode, tx depth and recon pixel) by
tests/test_torch_slice_quality.py::test_wave_key_recon_matches_jax, which
has the reference's wavefront graph compiled already; the kernel against
the plain version on the card by tests/test_torch_cuda.py."""

import random

import numpy as np
import pytest
import torch

from av1tpu.models import intra_wave as ref_wave
from av1tpu_torch.kernels import intra_wave as K
from av1tpu_torch.models import intra_wave as M
from av1tpu_torch.utils.yuv import synthetic_clip
from tests.test_torch_threads import single_torch_thread  # noqa: F401

# frames of a few diagonals keep the plain pair's CPU time small (it runs
# about 16,600 small operations per diagonal)
H, W, Q = 32, 48, 72


def _planes(w=W, h=H, seed=5):
    c = synthetic_clip(w, h, 1, seed=seed)
    return [torch.from_numpy(a[0].astype(np.int32)) for a in (c.y, c.u, c.v)]


@pytest.fixture(scope="module")
def tabs():
    return M.wave_tables(Q, 8, 0.3, 6.25, "cpu")


def _tensors(tabs):
    return {k: getattr(tabs, k) for k in K._SPEC}


def _rebuild(tabs, **changed):
    kw = dict(lam=tabs.lam, lam_txd0=tabs.lam_txd0, gate=tabs.gate,
              bit_depth=tabs.bit_depth)
    kw.update({k: v for k, v in changed.items() if k in kw})
    t = _tensors(tabs)
    t.update({k: v for k, v in changed.items() if k not in kw})
    return K.WaveTables(**kw, **{k: v for k, v in t.items()
                                 if v is not None})


@pytest.mark.parametrize("change,err", [
    pytest.param(lambda t: {"mode_vals": t.mode_vals.int()}, TypeError,
                 id="dtype"),
    pytest.param(lambda t: {"fwd8": t.fwd8[:, :32].contiguous()},
                 ValueError, id="shape"),
    pytest.param(lambda t: {"step16": t.step16.to("meta")}, ValueError,
                 id="device"),
    pytest.param(lambda t: {"gain16": t.gain16.t().contiguous().t()},
                 ValueError, id="strided"),
    pytest.param(lambda t: {"tabc": None}, ValueError, id="missing"),
    pytest.param(lambda t: {"lam": np.float64(t.lam)}, TypeError,
                 id="lam-float64"),
    pytest.param(lambda t: {"gate": float(t.gate)}, TypeError,
                 id="gate-python-float"),
    pytest.param(lambda t: {"bit_depth": 9}, ValueError, id="bit-depth"),
    # a tx type's positions split in two runs, and a run of 5
    pytest.param(lambda t: {"grp_of_pos": torch.tensor(
        [0, 1, 0, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3])}, ValueError, id="split-run"),
    pytest.param(lambda t: {"grp_of_pos": torch.tensor(
        [0] * 5 + [1] * 4 + [2] * 4)}, ValueError, id="run-of-5"),
    # five tx types: the kernel's clusters have a CTA for each of four
    pytest.param(lambda t: {"grp_of_pos": torch.tensor(
        [0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 4, 4])}, ValueError,
                 id="five-types"),
])
def test_tables_refuse_bad_tensors(tabs, change, err):
    with pytest.raises(err):
        _rebuild(tabs, **change(tabs))


def test_tables_refuse_a_device_without_kernels(tabs):
    meta = {k: v.to("meta") for k, v in _tensors(tabs).items()}
    with pytest.raises(ValueError, match="unsupported device"):
        _rebuild(tabs, **meta)


def test_tables_hold_the_encode_rows(tabs):
    """The bundle's rows are the device tables the step read before it
    had a bundle: forward matrices, quantizer rows and offsets, the rate
    model's rows at the q's bucket, gains and the scalar lambdas."""
    from av1tpu_torch.models.intra_v import _plane_params
    from av1tpu_torch.models.rates import qctx_index
    from av1tpu_torch.state import tables

    T = tables("cpu")
    qctx = qctx_index(Q)
    for n, key in ((16, "16"), (8, "8"), (4, "4"), (8, "c")):
        for name, row in zip(("step", "q", "cap"), _plane_params(Q, n, 8,
                                                                 "cpu")):
            assert torch.equal(getattr(tabs, name + key), row)
        assert torch.equal(getattr(tabs, "off" + key), T.q_offsets(n * n))
    for n in (16, 8, 4):
        rm = T.rate_model(n, 0)
        for t in range(4):
            assert torch.equal(getattr(tabs, f"fwd{n}")[t], T.fwdt(n, t))
            assert torch.equal(getattr(tabs, f"gain{n}")[t],
                               T.coef_gains(n, t))
        assert torch.equal(getattr(tabs, f"tab{n}"), rm.tabs[qctx])
        assert torch.equal(getattr(tabs, f"eob{n}"), rm.eob[qctx])
        assert torch.equal(getattr(tabs, f"rank{n}"), rm.rank)
    assert torch.equal(tabs.tabc, T.rate_tabs(8, 1)[qctx])
    assert (tabs.lam, tabs.lam_txd0) == M.wave_lambdas(Q, 8, 0.3, "cpu")
    assert tabs.gate == np.float32(6.25)
    assert tabs.groups == [(0, 2), (1, 4), (2, 4), (3, 3)]


def test_sub_pred_row_is_the_reference_row(tabs):
    """sub_chain predicts with row `pick` of the WAVE_MODES-ordered stack
    and signals mode_vals[pick], as the reference does: the table is the
    identity, so for most positions the mode it predicts with is not the
    mode it signals (ROADMAP queue 3 item 1, kept on purpose)."""
    assert M.WAVE_MODES == ref_wave.WAVE_MODES
    assert M._TX_ORDER == ref_wave._TX_ORDER
    assert torch.equal(tabs.sub_pred_row, torch.arange(13))
    signalled = [M.WAVE_MODES[i] for i in M._TX_ORDER]
    assert tabs.mode_vals.tolist() == signalled
    predicted = [M.WAVE_MODES[int(r)] for r in tabs.sub_pred_row]
    assert predicted != signalled and predicted[0] == signalled[0]


@pytest.mark.parametrize("hw,want", [((1088, 1920), 254), ((384, 640), 86),
                                     ((128, 192), 26), ((32, 48), 5)])
def test_wave_diagonals(hw, want):
    h, w = hw
    assert M.wave_diagonals(h, w) == want
    assert ref_wave._diagonals(h // 16, w // 16)[0].shape[0] == want


@pytest.fixture(scope="module")
def key_args(tabs):
    """(src_y, src_u, src_v), the schedule and the zeroed grids at H x W
    (five diagonals)."""
    _, src, sched, grids = M.wave_setup(*_planes(), Q, 8, 0.3, 6.25)
    assert sched.nd == 5
    return src, sched, grids


_KEY_NAMES = ("src_y", "src_u", "src_v", "rec_y", "rec_u", "rec_v", "lv_y",
              "lv_u", "lv_v", "modes", "txds")


@pytest.mark.parametrize("bad,err", [
    pytest.param(lambda k: {"src_y": k["src_y"].short()}, TypeError,
                 id="src-int16"),
    pytest.param(lambda k: {"src_y": torch.zeros((H, W - 8),
                                                  dtype=torch.int32)},
                 ValueError, id="src-width"),
    pytest.param(lambda k: {"src_u": torch.zeros((H, W),
                                                  dtype=torch.int32)},
                 ValueError, id="chroma-shape"),
    pytest.param(lambda k: {"src_v": k["src_v"].to("meta")}, ValueError,
                 id="chroma-device"),
    pytest.param(lambda k: {"rec_y": torch.zeros((3, 5, 16, 16),
                                                  dtype=torch.int32)},
                 ValueError, id="grid-shape"),
    pytest.param(lambda k: {"rec_u": k["rec_u"].transpose(-1, -2)},
                 ValueError, id="strided"),
    pytest.param(lambda k: {"lv_y": k["lv_y"].int()}, TypeError,
                 id="levels-int32"),
    pytest.param(lambda k: {"lv_v": k["lv_v"][:, :1].contiguous()},
                 ValueError, id="levels-shape"),
    pytest.param(lambda k: {"modes": k["modes"].to(torch.int16)}, TypeError,
                 id="modes-int16"),
    pytest.param(lambda k: {"txds": k["txds"][:1].contiguous()}, ValueError,
                 id="txds-shape"),
    pytest.param(lambda k: {"sched": k["sched"].diags}, TypeError,
                 id="not-a-schedule"),
    pytest.param(lambda k: {"sched": M.wave_schedule(2, 4, "cpu")},
                 ValueError, id="schedule-size"),
    pytest.param(lambda k: {"d0": 2, "d1": 2}, ValueError, id="empty-range"),
    pytest.param(lambda k: {"d1": 6}, ValueError, id="past-the-frame"),
    pytest.param(lambda k: {"d0": -1}, ValueError, id="negative-d0"),
    pytest.param(lambda k: {"d0": 1.0}, TypeError, id="float-d0"),
    pytest.param(lambda k: {"d1": True}, TypeError, id="bool-d1"),
])
def test_wave_key_refuses_bad_inputs(tabs, key_args, bad, err):
    src, sched, grids = key_args
    kw = dict(zip(_KEY_NAMES, (*src, *grids)), sched=sched, d0=0, d1=5)
    kw.update(bad(kw))
    launches = K.wave_key.launches
    with pytest.raises(err):
        K.wave_key(*(kw[n] for n in _KEY_NAMES), tabs, kw["sched"],
                   kw["d0"], kw["d1"])
    assert K.wave_key.launches == launches


def test_schedule_refuses_more_blocks_than_an_entry_holds():
    r_i = c_i = np.zeros((1, 1), np.int32)
    flags = np.ones((1, 1), np.bool_)
    with pytest.raises(ValueError, match="at most 4096"):
        K.WaveSchedule(1, 4097, r_i, c_i, flags, flags, flags, "cpu")


def _kernel_waits(r, c, cols, d0):
    """The blocks csrc/intra_wave.cu:wait_ready waits on before coding
    block (r, c): left, above and above-right where they lie in the frame
    and on a diagonal of the launch (>= d0)."""
    return [(rr, cc) for rr, cc in ((r, c - 1), (r - 1, c), (r - 1, c + 1))
            if rr >= 0 and 0 <= cc < cols and 2 * rr + cc >= d0]


def _plain_reads(r, c, ur, cols):
    """The blocks the plain step reads to code block (r, c): above,
    above-right where ur, left and the corner (_edges_from_blocks; chroma
    reads above and left)."""
    reads = []
    if r > 0:
        reads.append((r - 1, c))
        if ur and c + 1 < cols:
            reads.append((r - 1, c + 1))
    if c > 0:
        reads.append((r, c - 1))
    if r > 0 and c > 0:
        reads.append((r - 1, c - 1))
    return reads


@pytest.mark.parametrize("rows,cols,ctas,d0", [
    (1, 5, 2, 0), (3, 4, 1, 0), (3, 4, 3, 0), (4, 7, 5, 0), (6, 9, 8, 0),
    (6, 9, 60, 0), (5, 8, 4, 6)])
def test_tickets_wait_only_on_earlier_tickets(rows, cols, ctas, d0):
    """A plain-Python walk of the kernel's persistent loop over the
    schedule's lanes of [d0, nd) (the diagonals before d0 done already):
    `ctas` CTAs take tickets in order, each waits on _kernel_waits, codes
    its lane for a random time and publishes it.  Every wait is on a
    smaller ticket, every block the plain step reads is finished when the
    lane starts (lanes without above-right and the right edge included),
    and every lane is coded."""
    sched = M.wave_schedule(rows, cols, "cpu")
    lo = sched.starts[d0]
    lanes = [(e & 0xfff, (e >> 12) & 0xfff, (e >> 24) & 1)
             for e in sched.lanes[lo:].tolist()]
    assert len(lanes) == rows * cols - lo
    ticket = {(r, c): k for k, (r, c, _) in enumerate(lanes)}
    done = {(r, c) for r in range(rows) for c in range(cols)
            if 2 * r + c < d0}
    assert any(not ur for _, c, ur in lanes if c < cols - 1) or rows < 3
    rng = random.Random(rows * 100 + cols + ctas)
    held = [None] * ctas        # per CTA: [ticket, work left or None]
    nxt = steps = 0
    while len(done) < rows * cols:
        steps += 1
        assert steps < 100 * rows * cols, "no progress"
        for k in rng.sample(range(ctas), ctas):   # any order of the CTAs
            if held[k] is None:
                if nxt == len(lanes):
                    continue
                held[k], nxt = [nxt, None], nxt + 1
                r, c, _ = lanes[held[k][0]]
                for blk in _kernel_waits(r, c, cols, d0):
                    assert ticket[blk] < held[k][0], (blk, (r, c))
            tk, left = held[k]
            r, c, ur = lanes[tk]
            if left is None:
                if all(b in done for b in _kernel_waits(r, c, cols, d0)):
                    for blk in _plain_reads(r, c, ur, cols):
                        assert blk in done, (blk, (r, c))
                    held[k][1] = rng.randint(1, 4)
            elif left > 1:
                held[k][1] = left - 1
            else:
                done.add((r, c))
                held[k] = None
    assert nxt == len(lanes)


@pytest.fixture(scope="module")
def whole_32():
    """The plain keyframe of a 32x32 frame (4 diagonals) in one call."""
    tabs = M.wave_tables(Q, 8, 0.3, 6.25, "cpu")
    _, src, sched, grids = M.wave_setup(*_planes(32, 32), Q, 8, 0.3, 6.25)
    K.wave_key_plain(*src, *grids, tabs, sched, 0, sched.nd)
    return tabs, src, sched, grids


@pytest.mark.parametrize("k", [1, 3])
def test_plain_ranges_equal_the_whole(whole_32, k):
    """wave_key_plain over [0, k) then [k, nd) gives the keyframe of one
    call over [0, nd), bit for bit."""
    tabs, src, sched, want = whole_32
    got = [torch.zeros_like(g) for g in want]
    K.wave_key_plain(*src, *got, tabs, sched, 0, k)
    K.wave_key_plain(*src, *got, tabs, sched, k, sched.nd)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert K.block_diffs(got, want) == {"blocks": 4, "modes": 0, "txds": 0,
                                        "levels": 0, "recon": 0,
                                        "level_max_diff": 0}


def test_cpu_takes_the_plain_pair_once_each_per_diagonal(monkeypatch):
    """On CPU tensors encode_intra_wave calls wave_luma16_plain and
    wave_sub_chroma_plain in turn, once per diagonal each, and the kernel's
    launch counter does not move."""
    calls = []
    for name in ("wave_luma16_plain", "wave_sub_chroma_plain"):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    monkeypatch.setattr(K.wave_key, "launches", 0)
    out = M.encode_intra_wave(*_planes(32, 16), Q, lam_scale=0.3)
    nd = M.wave_diagonals(16, 32)
    assert calls == ["wave_luma16_plain", "wave_sub_chroma_plain"] * nd
    assert K.wave_key.launches == 0
    assert int((out["levels_y"] != 0).sum()) > 0


def test_compare_reports_what_differs(monkeypatch):
    """wave_compare (chip_smoke.py's same-input phase) on the CPU, on a
    16x48 frame (three diagonals of one lane), with the kernel side
    perturbed: the first lane's signalled mode, the second's chroma level
    and the third's chroma recon sample (their decisions agree); then the
    whole keyframe, with one luma level perturbed, against the plain one
    and against the chain of one-diagonal launches (perturbed as above)."""
    key = K.wave_key
    ranges = []

    def bad_key(*a):
        key(*a)
        d0, d1 = a[-2:]
        ranges.append((d0, d1))
        if (d0, d1) == (0, 3):                   # the whole keyframe
            a[6][0, 1, 0, 0] += 1                # lv_y
        c = d0                                   # block (0, d0)
        if d0 == 0 and d1 == 1:                  # another signalled mode
            a[9][0, c] = a[11].mode_vals[(int(
                (a[11].mode_vals == a[9][0, c]).nonzero()) + 1) % 13]
        if (d0, d1) == (1, 2):
            a[7][0, c, 0, 0] += 1                # lv_u
        if (d0, d1) == (2, 3):
            a[5][0, c, 0, 0] += 1                # rec_v

    monkeypatch.setattr(K, "wave_key", bad_key)
    o = K.wave_compare(*_planes(48, 16), Q, lam_scale=0.3)
    assert ranges == [(0, 1), (1, 2), (2, 3), (0, 3), (0, 1), (1, 2),
                      (2, 3)] and o["lanes"] == 3
    assert [(p["diag"], p["r"], p["c"]) for p in o["picks"]] == [(0, 0, 0)]
    p = o["picks"][0]
    assert p["kernel"] == (p["plain"] + 1) % 13
    assert p["kernel_choice_cost"] >= p["plain_cost"]
    assert o["whole"] == {"blocks": 3, "modes": 0, "txds": 0, "levels": 1,
                          "recon": 0, "level_max_diff": 1}
    assert o["chain"] == {"blocks": 3, "modes": 1, "txds": 0, "levels": 1,
                          "recon": 1, "level_max_diff": 1}
    assert o["txds"] == []
    assert (o["level_lanes"], o["level_max_diff"]) == (1, 1)
    assert o["recon_lanes"] == 1
    assert o["plain"]["modes"].shape == (1, 3)


def test_scene_worker_reports_its_launches(monkeypatch):
    """A scene-batch worker's result carries the hand kernels' launches of
    its scene (counted here by making the plain versions count as the
    kernels would): one wavefront launch per keyframe, and
    one CDEF filter per nonzero preset of the strength search plus the
    keyframe's, where its chosen preset is not all zero.  A one-frame
    16x64 scene: its keyframe, CDEF search and filter, no inter step, so
    no motion search (the temporal filter runs in the parent) and no loop
    filter (the wavefront keyframe signals it off)."""
    from av1tpu_torch.kernels import cdef as KC
    from av1tpu_torch.kernels import deblock as KD
    from av1tpu_torch.kernels import motion as KM
    from av1tpu_torch.models.cdef import CDEF_PRESETS
    from av1tpu_torch.models.intra_v import fuse_planes
    from av1tpu_torch.parallel import gop

    for mod, name, wrapper, n in (
            (K, "wave_key_plain", K.wave_key, 1),
            (KC, "cdef_filter_plain", KC.cdef_filter, 1),
            (KM, "coarse_search_plain", KM.coarse_search, 3),
            (KM, "global_search_plain", KM.global_search, 6),
            (KM, "refine_subpel_plain", KM.refine_subpel, 2),
            (KD, "deblock_plane_plain", KD.deblock_edges, 1)):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _w=wrapper, _n=n, **k):
            _w.launches += _n
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    c = synthetic_clip(64, 16, 1, seed=9)
    frames = fuse_planes(c.y[0], c.u[0], c.v[0])[None]
    scene = {"frames": torch.from_numpy(frames), "q": 100, "key_q": 80,
             "key_lf": (0, 0, 0), "inter_lf": (12, 8, 8)}
    res = gop._encode_scene(scene, torch.device("cpu"), 16, 64, 8, 8192,
                            8192, False, lambda b: gop.key_skip8(b, 16, 64),
                            0.3)
    searched = int(sum(bool(p.any()) for p in CDEF_PRESETS))
    assert res["launches"] == {
        "transform_quantize": 0, "wave_key": 1,
        "code_blocks": 0,
        "cdef_filter": searched + bool(np.any(res["cdef_s"])),
        "coarse_search": 0, "global_search": 0, "refine_subpel": 0,
        "deblock_edges": 0, "part_chain": 0, "part_pred": 0, "part_code": 0,
        "part_merge": 0}
    assert res["inter_bufs"] == []
