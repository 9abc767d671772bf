"""The wavefront keyframe's diagonal step as two wrapped kernels
(av1tpu_torch/kernels/intra_wave.py) on the CPU: the tables bundle and the
wrappers refuse what the kernels do not take, the CPU path takes the plain
pair once each per diagonal and launches nothing, the bundle holds the
rows the encode reads, sub_chain's prediction row is the reference's, and
the compare helper that chip_smoke.py runs on the card reports what
differs.

The plain pair is held against the reference's keyframe (every level,
mode, tx depth and recon pixel) by
tests/test_torch_slice_quality.py::test_wave_key_recon_matches_jax, which
has the reference's wavefront graph compiled already; the kernels against
the plain pair on the card by tests/test_torch_cuda.py."""

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
def diag_args(tabs):
    """(src_y, src_u, src_v), grids, diagonal 2's arguments (two lanes)
    and its luma outputs at H x W."""
    _, src, diags, grids = M.wave_setup(*_planes(), Q, 8, 0.3, 6.25)
    best = K.wave_luma16(src[0], grids[0], tabs, *diags[2])
    assert diags[2][5:] == (2, 2)
    return src, grids, diags[2], best


@pytest.mark.parametrize("bad,err", [
    pytest.param(lambda d: {"r": d[0].int()}, TypeError, id="r-int32"),
    pytest.param(lambda d: {"valid": d[2].to(torch.int8)}, TypeError,
                 id="valid-int8"),
    pytest.param(lambda d: {"c": d[1][:1]}, ValueError, id="c-length"),
    pytest.param(lambda d: {"n_valid": 0}, ValueError, id="no-valid-lane"),
    pytest.param(lambda d: {"n_valid": d[5] + 1}, ValueError,
                 id="valid-past-lanes"),
    pytest.param(lambda d: {"src_y": torch.zeros((H, W - 8),
                                                  dtype=torch.int32)},
                 ValueError, id="src-width"),
    pytest.param(lambda d: {"rec_y": torch.zeros((3, 5, 16, 16),
                                                  dtype=torch.int32)},
                 ValueError, id="grid-shape"),
    pytest.param(lambda d: {"bl": d[4].to("meta")}, ValueError,
                 id="bl-device"),
])
def test_luma16_refuses_bad_inputs(tabs, diag_args, bad, err):
    src, grids, diag, _ = diag_args
    names = ("r", "c", "valid", "ur", "bl", "n_lanes", "n_valid")
    kw = dict(src_y=src[0], rec_y=grids[0], **dict(zip(names, diag)))
    kw.update(bad(diag))
    with pytest.raises(err):
        K.wave_luma16(kw.pop("src_y"), kw.pop("rec_y"), tabs,
                      *(kw[n] for n in names))


@pytest.mark.parametrize("bad,err", [
    pytest.param(lambda g, b: {"modes": g[6].to(torch.int16)}, TypeError,
                 id="modes-int16"),
    pytest.param(lambda g, b: {"lv_u": g[4][:, :1].contiguous()},
                 ValueError, id="grid-shape"),
    pytest.param(lambda g, b: {"rec_v": g[2].transpose(-1, -2)},
                 ValueError, id="strided"),
    pytest.param(lambda g, b: {"pick": b[0][:1]}, ValueError,
                 id="pick-length"),
    pytest.param(lambda g, b: {"lv16": b[1].int()}, TypeError,
                 id="levels-int32"),
    pytest.param(lambda g, b: {"cost_b": b[3].double()}, TypeError,
                 id="cost-float64"),
    pytest.param(lambda g, b: {"src_u": torch.zeros((H, W),
                                                     dtype=torch.int32)},
                 ValueError, id="chroma-shape"),
])
def test_sub_chroma_refuses_bad_inputs(tabs, diag_args, bad, err):
    src, grids, diag, best = diag_args
    names = ("src_y", "src_u", "src_v", "rec_y", "rec_u", "rec_v", "lv_y",
             "lv_u", "lv_v", "modes", "txds")
    outs = ("pick", "lv16", "rec16", "cost_b", "grp_b")
    kw = dict(zip(names, (*src, *grids)), **dict(zip(outs, best)))
    kw.update(bad(grids, best))
    with pytest.raises(err):
        K.wave_sub_chroma(*(kw[n] for n in names), tabs, *diag,
                          *(kw[n] for n in outs))


def test_cpu_takes_the_plain_pair_once_each_per_diagonal(monkeypatch):
    """On CPU tensors encode_intra_wave calls wave_luma16_plain and
    wave_sub_chroma_plain in turn, once per diagonal each, and neither
    launch counter moves."""
    calls = []
    for name in ("wave_luma16_plain", "wave_sub_chroma_plain"):
        fn = getattr(K, name)
        monkeypatch.setattr(K, name, lambda *a, _fn=fn, _n=name, **k: (
            calls.append(_n), _fn(*a, **k))[1])
    monkeypatch.setattr(K.wave_luma16, "launches", 0)
    monkeypatch.setattr(K.wave_sub_chroma, "launches", 0)
    out = M.encode_intra_wave(*_planes(32, 16), Q, lam_scale=0.3)
    nd = M.wave_diagonals(16, 32)
    assert calls == ["wave_luma16_plain", "wave_sub_chroma_plain"] * nd
    assert K.wave_luma16.launches == K.wave_sub_chroma.launches == 0
    assert int((out["levels_y"] != 0).sum()) > 0


def test_compare_reports_what_differs(monkeypatch):
    """wave_compare (chip_smoke.py's same-input phase) on the CPU, on a
    16x48 frame (three diagonals of one lane), with the kernel side
    perturbed: the first lane's pick, the second's chroma level and the
    third's chroma recon sample (their decisions agree)."""
    luma, sub = K.wave_luma16, K.wave_sub_chroma
    seen = {"luma": 0, "sub": 0}

    def bad_luma(*a):
        out = luma(*a)
        seen["luma"] += 1
        if seen["luma"] == 1:                    # diagonal 0
            out[0][0] = (out[0][0] + 1) % 13
        return out

    def bad_sub(*a):
        sub(*a)
        seen["sub"] += 1
        r, c = int(a[12][0]), int(a[13][0])      # lane 0's block
        if seen["sub"] == 2:
            a[7][r, c, 0, 0] += 1                # lv_u
        if seen["sub"] == 3:
            a[5][r, c, 0, 0] += 1                # rec_v

    monkeypatch.setattr(K, "wave_luma16", bad_luma)
    monkeypatch.setattr(K, "wave_sub_chroma", bad_sub)
    o = K.wave_compare(*_planes(48, 16), Q, lam_scale=0.3)
    assert seen == {"luma": 3, "sub": 3} and o["lanes"] == 3
    assert [(p["diag"], p["r"], p["c"]) for p in o["picks"]] == [(0, 0, 0)]
    p = o["picks"][0]
    assert p["kernel"] == (p["plain"] + 1) % 13
    assert p["kernel_choice_cost"] >= p["plain_cost"]
    assert o["txds"] == []
    assert (o["level_lanes"], o["level_max_diff"]) == (1, 1)
    assert o["recon_lanes"] == 1
    assert o["plain"]["modes"].shape == (1, 3)


def test_scene_worker_reports_its_launches(monkeypatch):
    """A scene-batch worker's result carries the hand kernels' launches of
    its scene (counted here by making the plain versions count as the
    kernels would): one of each wavefront kernel per keyframe diagonal, and
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
            (K, "wave_luma16_plain", K.wave_luma16, 1),
            (K, "wave_sub_chroma_plain", K.wave_sub_chroma, 1),
            (KC, "cdef_filter_plain", KC.cdef_filter, 1),
            (KM, "coarse_search_plain", KM.coarse_search, 3),
            (KM, "global_search_plain", KM.global_search, 6),
            (KM, "refine_subpel_plain", KM.refine_subpel, 2),
            (KD, "deblock_edges_plain", KD.deblock_edges, 1)):
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
    nd = M.wave_diagonals(16, 64)
    searched = int(sum(bool(p.any()) for p in CDEF_PRESETS))
    assert res["launches"] == {
        "transform_quantize": 0, "wave_luma16": nd, "wave_sub_chroma": nd,
        "code_blocks": 0,
        "cdef_filter": searched + bool(np.any(res["cdef_s"])),
        "coarse_search": 0, "global_search": 0, "refine_subpel": 0,
        "deblock_edges": 0, "part_chain": 0, "part_pred": 0, "part_code": 0,
        "part_merge": 0}
    assert res["inter_bufs"] == []
