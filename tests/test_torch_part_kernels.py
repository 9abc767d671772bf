"""The partition probe's kernel wrappers on the CPU (kernels/intra_part.py):
part_chain, part_pred, part_code and part_merge take their plain versions
for CPU tensors; each plain version equals the eager code it replaced (the
port's `_mode_rdo` with `_recon16`/`_recon32`, the 64x64 candidate, the
chroma coder, the first-row chains, and the merges of `row32_step`,
`sb_step`, `row16_step` and `chroma_sb_step`, transcribed below from the
port before the kernels) at the rows of 64x128 and 128x192 frames, in 8
and 10 bits; the probe calls each wrapper as often as
models/intra_part.part_launches says and launches nothing; a frame where
the 64, the 32 and the 16 each win somewhere keeps the losers' levels at
zero; the wrappers reject what the kernels do not take; and the launch
plans of part_code and part_chain cover every column or position once.

No reference graph is compiled and no forward matrix is built: stand-in
matrices (the orthonormal DCT basis over the integer inverse's DC gain)
take the place of the pseudo-inverses, which take tens of seconds.  The
probe is held bit for bit against av1tpu with the real matrices by
tests/test_torch_intra_part.py and tests/test_torch_slice_quality.py; the
kernels against the plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py phase 7e.
"""

import numpy as np
import pytest
import torch

from av1tpu_torch.kernels import intra_part as K
from av1tpu_torch.kernels.intra_part import (
    ChainJob, CodeJob, MergeJob, PredJob, edges, part_chain, part_code,
    part_merge, part_pred,
)
from av1tpu_torch.models import intra_part as M
from av1tpu_torch.models.intra_v import (
    _RDO_MODES, _directional_pred, _plane_params, log2_rate, quantize_coefs,
)
from av1tpu_torch.models.rdoq import rd_zero
from av1tpu_torch.ops.transforms import _inverse_2d, inverse_transform
from av1tpu_torch.state import Tables
from av1tpu_torch.utils.yuv import synthetic_clip
from tests.test_torch_threads import single_torch_thread  # noqa: F401

f32 = np.float32
ROWS = [(128, 8, 72), (192, 8, 72), (128, 10, 140), (192, 10, 140)]
ROW_IDS = [f"w{w}-{bd}bit" for w, bd, _ in ROWS]


def _stand_in(n: int, coded: int | None = None) -> torch.Tensor:
    """A transposed forward matrix for tests: the separable orthonormal
    DCT-II basis over the integer inverse's DC gain (coefs = r @ it); with
    `coded`, only the top-left coded x coded coefficients (TX_64X64)."""
    k = np.arange(n)
    d = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    d = d * np.sqrt(2 / n)
    d[0] /= np.sqrt(2)
    unit = torch.zeros((1, n, n), dtype=torch.int64)
    unit[0, 0, 0] = 1 << 12
    gain = float(_inverse_2d(unit, n, n, 0)[0, 0, 0]) / (1 << 12) * n
    d = d[:coded or n]
    f = np.kron(d, d) / gain
    return torch.from_numpy(np.ascontiguousarray(f.T, np.float32))


class _StandInTables(Tables):
    """The CPU tables with the stand-in forward matrices and their gains."""

    def fwdt(self, n, tx_type=0):
        return self._get(("fwdt", n, tx_type), lambda: _stand_in(n))

    def fwd64t(self):
        return self._get("fwd64t", lambda: _stand_in(64, 32))

    def coef_gains(self, n, tx_type=0):
        f = self.fwd64t() if n == 64 else self.fwdt(n, tx_type)
        return self._get(("gains", n, tx_type),
                         lambda: (1.0 / (f * f).sum(0)).to(torch.float32))


@pytest.fixture(scope="module")
def T():
    tabs = _StandInTables("cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(M, "tables", lambda device: tabs)
        yield tabs


def _consts(T, q, bd):
    """The eager code's scalars: (lam_pix, lam_split, qctx)."""
    from av1tpu_torch.models.intra_v import LAM_PIX, ac_squared, fold_consts
    from av1tpu_torch.models.rates import qctx_index

    a2 = ac_squared(q, bd, "cpu")
    return (float(f32(a2 * f32(LAM_PIX))),
            float(f32(a2 * fold_consts(LAM_PIX, 12.0))), qctx_index(q))


def _rng_rows(w, n, bd, seed, rows=1):
    """A row above (w,) and a source band (rows * n, w), int32: a smooth
    gradient with noise, so that the quantizer keeps some levels."""
    rng = np.random.RandomState(seed)
    pm = (1 << bd) - 1
    x = np.arange(w)[None, :] * (pm // 300 + 1) + np.arange(rows * n + 1)[
        :, None] * 2
    img = np.clip(x % (pm + 1) + rng.randint(-pm // 8, pm // 8 + 1,
                                             x.shape), 0, pm)
    img = img.astype(np.int32)
    return torch.from_numpy(img[0].copy()), torch.from_numpy(img[1:].copy())


def _blocks(band, n):
    """(n, w) band -> (w/n, n, n) blocks."""
    return band.reshape(n, -1, n).transpose(0, 1)


def _band(blocks):
    """(cols, n, n) blocks -> (n, cols*n) band."""
    c, n, _ = blocks.shape
    return blocks.transpose(0, 1).reshape(n, c * n)


# ---- the eager code the kernels replaced, transcribed ----

def _mode_rdo(blocks, ae, consts):
    n, fwdt, step_eff, cap, lam_pix, tab, gains = consts
    cols = blocks.shape[0]
    pred_v = ae[:, None, :n].expand(cols, n, n)
    cands = [pred_v] + [_directional_pred(ae, dx, n) for _, dx in _RDO_MODES]
    nm = len(cands)
    preds = torch.cat(cands, dim=0)
    resid = (blocks.repeat(nm, 1, 1) - preds).reshape(nm * cols, n * n).to(
        torch.float32)
    coefs = resid @ fwdt
    lv_all = quantize_coefs(coefs, step_eff, cap)
    lv_all = rd_zero(lv_all, coefs, step_eff, lam_pix, tab, gains)
    d = coefs - lv_all * step_eff
    dist = ((d * d).sum(dim=1)
            * float(f32(1.0) / f32(M._RATIO[n]))).reshape(nm, -1)
    rate = log2_rate(lv_all, 1).reshape(nm, -1) + torch.tensor(
        [0.0, 4.0, 4.0])[:, None]
    cost = dist + lam_pix * rate
    choice = torch.argmin(cost, dim=0)
    sel = choice[None, :, None, None].expand(1, cols, n, n)
    lv = torch.gather(lv_all.reshape(nm, cols, n, n), 0, sel)[0]
    pred = torch.gather(preds.reshape(nm, cols, n, n), 0, sel)[0]
    best = torch.gather(cost, 0, choice[None])[0]
    return lv, pred, torch.tensor([1, 3, 8], dtype=torch.int8)[choice], best


def _dq_shift(lv, q, shift):
    return torch.sign(lv) * ((lv.abs() * q) >> shift)


# ---- the sites ----

def _code_site(site, fwdt, bottom, band, av):
    """part_pred, the product and part_code on one site: (lv, rec band,
    modes, cost)."""
    n, w = band.shape
    cols, nm = w // n, site.nm
    resid = torch.empty((nm * cols, n * n))
    pred = torch.empty((nm * cols, n * n), dtype=torch.int32)
    part_pred([PredJob(bottom, band, av, resid, pred)])
    lv = torch.empty((cols, site.cw, site.cw), dtype=torch.int16)
    rec = torch.empty((n, w), dtype=torch.int32)
    modes = torch.empty((cols,), dtype=torch.int8)
    cost = torch.empty((cols,))
    part_code([CodeJob(site, resid @ fwdt, pred, band, lv, rec,
                       modes if site.nm == 3 else None,
                       cost if site.cost else None)])
    return lv, rec, modes, cost


@pytest.mark.parametrize("n", [16, 32])
@pytest.mark.parametrize("w,bd,q", ROWS, ids=ROW_IDS)
def test_mode_rdo_site_matches_the_eager_code(T, n, w, bd, q):
    """The luma 16 and 32 sites: _mode_rdo + _recon16/_recon32."""
    S = M._sites(q, bd, "cpu")
    site = S.y16 if n == 16 else S.y32
    bottom, band = _rng_rows(w, n, bd, seed=n + w + bd)
    cols = w // n
    av = torch.from_numpy(np.random.RandomState(w).rand(cols) < 0.5)
    av[-1] = False
    lv, rec, modes, cost = _code_site(site, T.fwdt(n, 0), bottom, band, av)

    lam, _, qctx = _consts(T, q, bd)
    step, qq, cap = _plane_params(q, n, bd, "cpu")
    step_eff = step if n == 16 else step * 0.5
    want = _mode_rdo(_blocks(band, n), edges(bottom, av, n, cols),
                     (n, T.fwdt(n, 0), step_eff, cap, lam,
                      T.rate_tabs(n, 0)[qctx], T.coef_gains(n)))
    wlv, wpred, wmodes, wcost = want
    dq = (wlv * qq.reshape(16, 16) if n == 16 else
          _dq_shift(wlv, qq.reshape(32, 32), 1))
    wrec = torch.clamp(wpred + inverse_transform(dq, n, n, 0), 0,
                       (1 << bd) - 1)
    assert torch.equal(lv, wlv.to(torch.int16))
    assert torch.equal(rec, _band(wrec))
    assert torch.equal(modes, wmodes) and torch.equal(cost, wcost)
    assert int(lv.abs().sum()) > 0


@pytest.mark.parametrize("w,bd,q", ROWS, ids=ROW_IDS)
def test_64_candidate_matches_the_eager_code(T, w, bd, q):
    """sb_step's 64x64 V_PRED candidate, its pixel SSE and cost."""
    S = M._sites(q, bd, "cpu")
    bottom, band = _rng_rows(w, 64, bd, seed=w + bd)
    lv, rec, _, cost = _code_site(S.y64, T.fwd64t(), bottom, band, None)

    lam, _, qctx = _consts(T, q, bd)
    step32, q32, cap32 = _plane_params(q, 32, bd, "cpu")
    cols = w // 64
    blocks = _blocks(band, 64)
    pred64 = bottom.reshape(cols, 1, 64).expand(cols, 64, 64)
    coefs = (blocks - pred64).reshape(cols, 4096).to(torch.float32) @ \
        T.fwd64t()
    wlv = quantize_coefs(coefs, step32 * 0.25, cap32)
    wlv = rd_zero(wlv, coefs, q32.to(torch.float32) * 0.25, lam,
                  T.rate_tabs(64, 0)[qctx], T.coef_gains(64))
    full = torch.zeros((cols, 64, 64), dtype=torch.int32)
    full[:, :32, :32] = _dq_shift(wlv, q32, 2).reshape(cols, 32, 32)
    wrec = torch.clamp(pred64 + inverse_transform(full, 64, 64, 0), 0,
                       (1 << bd) - 1)
    e = wrec - blocks
    wcost = (e * e).sum(dim=(1, 2)).to(torch.float32) + lam * log2_rate(
        wlv, 1)
    assert torch.equal(lv, wlv.reshape(cols, 32, 32).to(torch.int16))
    assert torch.equal(rec, _band(wrec)) and torch.equal(cost, wcost)


@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("w,bd,q", ROWS, ids=ROW_IDS)
def test_chroma_site_matches_the_eager_code(T, n, w, bd, q):
    """The chroma coder `enc` at 8x8 and 16x16 (ADST_DCT) and 32x32."""
    S = M._sites(q, bd, "cpu")
    site = {8: S.c8, 16: S.c16, 32: S.c32}[n]
    tt = 0 if n == 32 else 1
    bottom, band = _rng_rows(w // 2, n, bd, seed=n + w + bd + 1)
    lv, rec, _, _ = _code_site(site, T.fwdt(n, tt), bottom, band, None)

    lam, _, qctx = _consts(T, q, bd)
    step, qq, cap = _plane_params(q, n, bd, "cpu")
    shift = 1 if n == 32 else 0
    cols = (w // 2) // n
    pred = bottom.reshape(cols, 1, n).expand(cols, n, n)
    resid = (_blocks(band, n) - pred).reshape(cols, n * n).to(torch.float32)
    coefs = resid @ T.fwdt(n, tt)
    wlv = quantize_coefs(coefs, step * (0.5 ** shift), cap)
    wlv = rd_zero(wlv, coefs, qq.to(torch.float32) * (0.5 ** shift), lam,
                  T.rate_tabs(n, 1)[qctx], T.coef_gains(n, tt))
    dq = wlv * qq if shift == 0 else _dq_shift(wlv, qq, 1)
    wrec = torch.clamp(pred + inverse_transform(dq.reshape(cols, n, n), n, n,
                                                tt), 0, (1 << bd) - 1)
    assert torch.equal(lv, wlv.reshape(cols, n, n).to(torch.int16))
    assert torch.equal(rec, _band(wrec))


@pytest.mark.parametrize("w,bd,q", ROWS, ids=ROW_IDS)
def test_chains_match_the_eager_code(T, w, bd, q):
    """The first block row: luma's 16x16 chain (no rd_zero) and U's and
    V's 8x8 ADST_DCT chains, in one part_chain call."""
    S = M._sites(q, bd, "cpu")
    _, y = _rng_rows(w, 16, bd, seed=w)
    _, u = _rng_rows(w // 2, 8, bd, seed=w + 1)
    _, v = _rng_rows(w // 2, 8, bd, seed=w + 2)
    outs = [(torch.empty((w // 16, 16, 16), dtype=torch.int16),
             torch.empty((16, w), dtype=torch.int32))] + [
        (torch.empty((w // 16, 8, 8), dtype=torch.int16),
         torch.empty((8, w // 2), dtype=torch.int32)) for _ in range(2)]
    part_chain([ChainJob(S.y_chain, T.fwdt(16, 0), y, *outs[0]),
                ChainJob(S.c8, T.fwdt(8, 1), u, *outs[1]),
                ChainJob(S.c8, T.fwdt(8, 1), v, *outs[2])])

    lam, _, qctx = _consts(T, q, bd)
    pix_max = (1 << bd) - 1
    for (lv, rec), src, n in zip(outs, (y, u, v), (16, 8, 8)):
        step, qq, cap = _plane_params(q, n, bd, "cpu")
        edge = torch.full((1, 1), (1 << (bd - 1)) - 1, dtype=torch.int32)
        for c, blk in enumerate(_blocks(src, n)):
            coefs = (blk - edge).reshape(1, n * n).to(torch.float32) @ \
                T.fwdt(n, 0 if n == 16 else 1)
            wlv = quantize_coefs(coefs, step, cap)
            if n == 8:
                wlv = rd_zero(wlv, coefs, step, lam, T.rate_tabs(8, 1)[qctx],
                              T.coef_gains(8, 1))
            wrec = torch.clamp(edge + inverse_transform(
                (wlv * qq).reshape(n, n), n, n, 0 if n == 16 else 1), 0,
                pix_max)
            edge = wrec[:1, n - 1:]
            assert torch.equal(lv[c], wlv.reshape(n, n).to(torch.int16))
            assert torch.equal(rec[:, c * n:(c + 1) * n], wrec)


# ---- the merges ----

def _merge_state(w, bd, ns, seed, luma):
    """Random grids of one superblock row (4 small rows) at width w: the
    level grids, the recon and source, the mid and big sites' recon
    bands, the luma costs and the split grids."""
    rng = np.random.RandomState(seed)
    pm = (1 << bd) - 1
    h = 8 * ns             # two superblock rows; row 1 is merged
    cs = w // ns

    def lv(shape):
        a = rng.randint(-3, 4, shape) * (rng.rand(*shape) < 0.3)
        return torch.from_numpy(a.astype(np.int16))

    def px(shape):
        return torch.from_numpy(rng.randint(0, pm + 1, shape).astype(
            np.int32))

    st = {"lv_s": lv((h // ns, cs, ns, ns)),
          "lv_m": lv((h // ns // 2, cs // 2, 2 * ns, 2 * ns)),
          "lv_b": lv((h // ns // 4, cs // 4, 32, 32)),
          "recon": px((h, w)), "rec_m": [px((2 * ns, w)) for _ in "ab"],
          "rec_b": px((4 * ns, w))}
    if luma:
        st.update(src=px((h, w)),
                  cost_s=[torch.from_numpy(rng.rand(2, cs).astype(f32) * 4e4)
                          for _ in "ab"],
                  cost_m=[torch.from_numpy(rng.rand(cs // 2).astype(f32)
                                           * 8e4) for _ in "ab"],
                  cost_b=torch.from_numpy(rng.rand(cs // 4).astype(f32)
                                          * 3e5),
                  split=torch.zeros((h // ns // 2, cs // 2), dtype=torch.bool),
                  split64=torch.zeros((h // ns // 4, cs // 4),
                                      dtype=torch.bool))
    else:          # luma's grids, split64 alternating in row 1
        split64 = torch.zeros((h // ns // 4, cs // 4), dtype=torch.bool)
        split64[1, ::2] = True
        split = torch.from_numpy(rng.rand(h // ns // 2, cs // 2) < 0.5)
        st.update(split=split & split64.repeat_interleave(
            2, 0).repeat_interleave(2, 1), split64=split64)
    return st


def _eager_merges(st, ns, lam, lam_split, luma):
    """row32_step's (row16_step's) merge of both halves of superblock
    row 1, then sb_step's (chroma_sb_step's), on copies: (the grids as the
    eager code leaves them, luma's cost_sub or None)."""
    st = {k: (v.clone() if torch.is_tensor(v) else
              [x.clone() for x in v] if isinstance(v, list) else v)
          for k, v in st.items()}
    nm, nb = 2 * ns, 4 * ns
    w = st["recon"].shape[1]
    cm, cb = w // nm, w // nb
    costs = []
    for half in (0, 1):
        r = 2 + half
        band = st["recon"][r * nm:(r + 1) * nm]
        pair = st["lv_s"][2 * r:2 * r + 2]
        if luma:
            c16 = (st["cost_s"][half][0].reshape(cm, 2).sum(1)
                   + st["cost_s"][half][1].reshape(cm, 2).sum(1) + lam_split)
            split = c16 < st["cost_m"][half]
            st["split"][r] = split
        else:
            split = st["split"][r]
        s2 = split.repeat_interleave(2)
        pair[:] = torch.where(s2[None, :, None, None], pair, 0)
        st["lv_m"][r] = torch.where(split[:, None, None], 0, st["lv_m"][r])
        sel = split.repeat_interleave(nm)[None]
        band[:] = torch.where(sel, band, st["rec_m"][half])
        if luma:
            e = (band - st["src"][r * nm:(r + 1) * nm]).reshape(nm, 2 * cm,
                                                                ns)
            d_sel = (e * e).sum(dim=(0, 2)).to(torch.float32)
            r16 = log2_rate(pair, (0, 2, 3)).reshape(cm, 2).sum(1)
            r32 = log2_rate(st["lv_m"][r], (1, 2))
            costs.append(d_sel.reshape(cm, 2).sum(1) + lam * (r16 + r32))
    sub = None
    if luma:
        sub = (costs[0].reshape(cb, 2).sum(1) + costs[1].reshape(cb, 2).sum(1)
               + lam_split)
        split64 = sub < st["cost_b"]
        st["split64"][1] = split64
    else:
        split64 = st["split64"][1]
    st["lv_b"][1] = torch.where(split64[:, None, None], 0, st["lv_b"][1])
    k2, k4 = split64.repeat_interleave(2), split64.repeat_interleave(4)
    st["lv_s"][4:8] = torch.where(k4[None, :, None, None], st["lv_s"][4:8], 0)
    st["lv_m"][2:4] = torch.where(k2[None, :, None, None], st["lv_m"][2:4], 0)
    if luma:
        st["split"][2:4] &= k2
    big = st["recon"][nb:2 * nb]
    big[:] = torch.where(split64.repeat_interleave(nb)[None], big,
                         st["rec_b"])
    return st, sub


@pytest.mark.parametrize("luma", [True, False], ids=["luma", "chroma"])
@pytest.mark.parametrize("w,bd,q", ROWS, ids=ROW_IDS)
def test_merges_match_the_eager_code(T, luma, w, bd, q):
    """Both halves of a superblock row, then its 64 (chroma 32) merge."""
    ns = 16 if luma else 8
    w = w if luma else w // 2
    st = _merge_state(w, bd, ns, seed=w + bd + luma, luma=luma)
    lam, lam_split, _ = _consts(T, q, bd)
    want, sub = _eager_merges(st, ns, lam, lam_split, luma)
    if luma:       # the 64 against its sub-levels: alternately won, lost
        st["cost_b"] = sub * torch.tensor([0.5, 2.0]).repeat(
            sub.shape[0])[:sub.shape[0]]
        want, _ = _eager_merges(st, ns, lam, lam_split, luma)
    region = torch.empty((2, w // (2 * ns)))
    for half in (0, 1):
        kw = dict(src=st["src"], cost_s=st["cost_s"][half],
                  cost_m=st["cost_m"][half], cost_b=st["cost_b"],
                  cost_region=region, lam=f32(lam),
                  lam_split=f32(lam_split)) if luma else {}
        part_merge([MergeJob(st["lv_s"], st["lv_m"], st["lv_b"], st["recon"],
                             st["rec_m"][half], st["rec_b"], st["split"],
                             st["split64"], 1, half, half == 1, **kw)])
    for k in ("lv_s", "lv_m", "lv_b", "recon", "split", "split64"):
        assert torch.equal(st[k], want[k]), k
    assert bool(st["split64"][1].any()) and not bool(st["split64"][1].all())


# ---- the probe ----

def _frame(h, w, bd, seed):
    c = synthetic_clip(w, h, 1, seed=seed)
    planes = [c.y[0], c.u[0], c.v[0]]
    if bd == 10:
        planes = [p.astype(np.int32) * 4 + 1 for p in planes]
    return [torch.from_numpy(p.astype(np.int32)) for p in planes]


@pytest.mark.parametrize("h,w,bd,q", [(64, 128, 10, 140),
                                      (128, 192, 8, 72)])
def test_probe_takes_each_plain_version_per_stage(T, monkeypatch, h, w, bd,
                                                  q):
    """On the CPU the probe launches nothing and calls each wrapper's plain
    version part_launches times, with the stage's jobs: luma's sites
    apart, U's and V's together."""
    calls = {n: [] for n in ("part_chain", "part_pred", "part_code",
                             "part_merge")}
    for name in calls:
        plain = getattr(K, name + "_plain")

        def spy(jobs, plain=plain, name=name):
            calls[name].append(len(jobs))
            return plain(jobs)
        monkeypatch.setattr(K, name + "_plain", spy)
    before = [k.launches for k in (part_chain, part_pred, part_code,
                                   part_merge)]
    M.encode_intra_part(*_frame(h, w, bd, seed=h + q), q, bit_depth=bd)
    assert [k.launches for k in (part_chain, part_pred, part_code,
                                 part_merge)] == before
    assert {k: len(v) for k, v in calls.items()} == M.part_launches(h, w)
    assert calls["part_chain"] == [3]
    assert calls["part_pred"] == calls["part_code"]
    # luma: the 16-row after the chain, then per half the top 16-row with
    # the 32 (and the 64 in a superblock's first half), the bottom 16-row
    halves = M._halves(h // 64)
    luma = [1] + [n for s, hf in halves for n in ((3 if hf == 0 else 2), 1)]
    assert calls["part_pred"] == luma + [2 * n for n in luma]
    assert calls["part_merge"] == [1] * len(halves) + [2] * len(halves)


def test_a_frame_where_64_32_and_16_each_win(T):
    """Each partition wins somewhere, and the losers' levels are zero:
    where the 64 wins, its superblock's 16 and 32 levels (and chroma's 8
    and 16); where the 32 wins, its 16s (chroma 8s); where the 16s win,
    the 32 (chroma 16); where the sub-levels win, the 64 (chroma 32)."""
    o = M.encode_intra_part(*_frame(128, 192, 8, seed=2), 140)
    s64 = o["split64"]
    sp = o["split"]
    s64r = s64.repeat_interleave(2, 0).repeat_interleave(2, 1)
    assert int((~s64[1:]).sum()) > 0                   # a 64 wins
    assert int((s64r & ~sp)[2:].sum()) > 0             # a 32 wins
    assert int(sp[2:].sum()) > 0                       # the 16s win
    assert not bool((sp & ~s64r).any())                # split & split64

    def at32(lv, grid):     # a block has a level, at the 32 grid
        m = (lv != 0).flatten(2).any(2)
        if grid == "small":
            return m.reshape(m.shape[0] // 2, 2, m.shape[1] // 2, 2).any(
                3).any(1)
        if grid == "big":
            return m.repeat_interleave(2, 0).repeat_interleave(2, 1)
        return m

    for small, mid, big in (("levels_y16", "levels_y32", "levels_y64"),
                            ("levels_u8", "levels_u16", "levels_u32"),
                            ("levels_v8", "levels_v16", "levels_v32")):
        assert not bool((at32(o[small], "small") & ~sp).any())
        assert not bool((at32(o[mid], "mid") & (sp | ~s64r)).any())
        assert not bool((at32(o[big], "big") & s64r).any())
    assert int((o["levels_y64"] != 0).sum()) > 0


# ---- what the wrappers refuse ----

def _good_pred_job(n=16, w=128):
    bottom, band = _rng_rows(w, n, 8, seed=1)
    cols = w // n
    return PredJob(bottom, band, torch.zeros(cols, dtype=torch.bool),
                   torch.empty((3 * cols, n * n)),
                   torch.empty((3 * cols, n * n), dtype=torch.int32))


@pytest.mark.parametrize("bad,err", [
    (dict(resid=torch.empty((24, 256), dtype=torch.float64)), TypeError),
    (dict(pred=torch.empty((23, 256), dtype=torch.int32)), ValueError),
    (dict(bottom=torch.empty((128,), dtype=torch.int32, device="meta")),
     ValueError),
    (dict(av=torch.zeros(8, dtype=torch.int32)), TypeError),
    (dict(src=torch.empty((16, 120), dtype=torch.int32)), ValueError),
], ids=["dtype", "shape", "device", "av-dtype", "width"])
def test_part_pred_rejects_bad_jobs(bad, err):
    with pytest.raises(err):
        part_pred([_good_pred_job()._replace(**bad)])


def test_wrappers_reject_bad_calls(T):
    S = M._sites(72, 8, "cpu")
    job = _good_pred_job()
    with pytest.raises(ValueError):
        part_pred([])
    with pytest.raises(ValueError):
        part_pred([job] * 7)
    lv = torch.empty((8, 16, 16), dtype=torch.int16)
    rec = torch.empty((16, 128), dtype=torch.int32)
    code = CodeJob(S.y16, torch.empty((24, 256)), job.pred, job.src, lv, rec)
    with pytest.raises(TypeError):
        part_code([code._replace(lv=lv.int())])
    with pytest.raises(ValueError):
        part_code([code._replace(coefs=torch.empty((24, 64)))])
    with pytest.raises(ValueError):
        part_code([code._replace(site=S.c8)])        # an 8x8 site, 16 rows
    chain = ChainJob(S.y_chain, T.fwdt(16, 0), job.src, lv, rec)
    with pytest.raises(ValueError):
        part_chain([chain._replace(site=S.y16)])     # not a chain site
    with pytest.raises(ValueError):
        part_chain([chain] * 4)
    with pytest.raises(ValueError):
        part_chain([chain._replace(fwdt=T.fwdt(8, 1))])
    st = _merge_state(128, 8, 16, seed=0, luma=False)
    merge = MergeJob(st["lv_s"], st["lv_m"], st["lv_b"], st["recon"],
                     st["rec_m"][0], st["rec_b"], st["split"],
                     st["split64"], 1, 1, True)
    with pytest.raises(ValueError):
        part_merge([merge._replace(half=0)])         # do_big after half 1
    with pytest.raises(ValueError):
        part_merge([merge._replace(sb_row=2)])
    with pytest.raises(ValueError):
        part_merge([merge._replace(src=st["recon"])])   # chroma: no src
    with pytest.raises(TypeError):
        part_merge([merge._replace(split=st["split"].int())])
    step, q, cap = _plane_params(72, 32, 8, "cpu")
    with pytest.raises(ValueError):
        K.PartSite(n=32, tx=1, nm=1, step=step, q=q, cap=cap, tab=None,
                   gains=None, lam=f32(1), dq_shift=1, cost=K.COST_NONE,
                   bit_depth=8)                      # no ADST at 32
    with pytest.raises(TypeError):
        K.PartSite(n=32, tx=0, nm=1, step=step, q=q, cap=cap, tab=None,
                   gains=None, lam=1.0, dq_shift=1, cost=K.COST_NONE,
                   bit_depth=8)                      # lam not float32
    step8, q8, cap8 = _plane_params(72, 8, 8, "cpu")
    site8 = K.PartSite(n=8, tx=1, nm=3, step=step8, q=q8, cap=cap8,
                       tab=None, gains=None, lam=f32(1), dq_shift=0,
                       cost=K.COST_COEF, bit_depth=8, inv_ratio=f32(1))
    with pytest.raises(ValueError):                  # 8x8 codes V_PRED alone
        part_code([CodeJob(site8, torch.empty((48, 64)),
                           torch.empty((48, 64), dtype=torch.int32),
                           torch.empty((8, 128), dtype=torch.int32),
                           torch.empty((16, 8, 8), dtype=torch.int16),
                           torch.empty((8, 128), dtype=torch.int32))])


def test_job_struct_mirrors_match_the_source(tmp_path, monkeypatch):
    """csrc/intra_part.cu's job structs and av1_part_layout, built by the
    host compiler (the layout nvcc gives them on x86-64), against the
    ctypes mirrors through _lib's check; a mirror with two fields swapped
    is refused."""
    import ctypes
    import pathlib
    import shutil
    import subprocess

    import av1tpu_torch._build as build

    src = (pathlib.Path(K.__file__).parent.parent / "csrc" /
           "intra_part.cu").read_text()
    structs = src[src.index("struct PartSite {"):src.index("namespace {")]
    layout = src[src.index("// The job structs' layout"):]
    cpp, so = tmp_path / "layout.cpp", tmp_path / "liblayout.so"
    cpp.write_text("#include <stddef.h>\n#include <stdint.h>\n"
                   "#include <stdio.h>\n" + structs + layout)
    subprocess.run([shutil.which("g++"), "-std=c++17", "-shared", "-fPIC",
                    "-o", str(so), str(cpp)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.av1_part_layout.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.av1_part_layout.restype = ctypes.c_int
    monkeypatch.setattr(build, "cuda_lib", lambda: lib)
    K._lib.cache_clear()
    try:
        assert K._lib() is lib
        fields = list(K.MergeJobC._fields_)
        fields[3], fields[4] = fields[4], fields[3]    # recon, src
        monkeypatch.setattr(K, "MergeJobC", type(
            "MergeJobC", (ctypes.Structure,), {"_fields_": fields}))
        K._lib.cache_clear()
        with pytest.raises(RuntimeError, match="MergeJob.recon"):
            K._lib()
    finally:
        K._lib.cache_clear()


# ---- part_code's launch (kernels/intra_part.py:code_ctas and code_smem
# mirror csrc/intra_part.cu's CodeLayout and flat grid; the card test holds
# them to the library) ----

def _code_jobs(sizes, width):
    """Stand-ins of one launch's CodeJobs: (n, nm, cost) per site, U and V
    for chroma, at a frame `width` luma pixels wide."""
    from types import SimpleNamespace

    jobs = []
    for n, nm, cost, planes in sizes:
        cols = (width if cost else width // 2) // n
        site = SimpleNamespace(n=n, nm=nm, cost=cost)
        jobs += [SimpleNamespace(site=site, lv=torch.empty((cols, 1)))
                 for _ in range(planes)]
    return jobs


_Y16, _Y32, _Y64 = (16, 3, 1, 1), (32, 3, 1, 1), (64, 1, 2, 1)
_C8, _C16, _C32 = (8, 1, 0, 2), (16, 1, 0, 2), (32, 1, 0, 2)
_KINDS = [[_Y16], [_Y16, _Y32], [_Y16, _Y32, _Y64], [_C8], [_C8, _C16],
          [_C8, _C16, _C32]]


@pytest.mark.parametrize("width", [1920, 1936, 64, 192])
@pytest.mark.parametrize("kind", range(6), ids=[
    "+".join(("y" if s[2] else "c") + str(s[0]) for s in k) for k in _KINDS])
def test_part_code_grid_takes_every_column_once(kind, width):
    """Every launch kind of the probe at 1920 (the main path) and ragged
    widths: the flat grid, jobs by size from 64 down, covers each job's
    columns exactly once (four 8x8 columns a CTA, one elsewhere), with no
    CTA left without a column, and a CTA's dynamic shared memory within
    the card's 232,448 bytes (at most 70,144: the 64 site's block, scratch,
    prediction, source and coefficients)."""
    jobs = _code_jobs(_KINDS[kind], width)
    order = sorted(range(len(jobs)), key=lambda k: -jobs[k].site.n)
    first, total = [], 0
    for k in order:
        first.append(total)
        total += -(-jobs[k].lv.shape[0] // K.CODE_COLS[jobs[k].site.n])
    assert K.code_ctas(jobs) == total
    seen = [np.zeros(j.lv.shape[0], np.int32) for j in jobs]
    for b in range(total):
        i = max(i for i in range(len(first)) if first[i] <= b)
        j = jobs[order[i]]
        cols = K.CODE_COLS[j.site.n]
        c0 = cols * (b - first[i])
        assert c0 < j.lv.shape[0]
        seen[order[i]][c0:c0 + cols] += 1
    assert all((s == 1).all() for s in seen)
    smem = K.code_smem(jobs)
    assert smem == max(4 * K.CODE_COLS[s.n] * (2 * s.n * (s.n + 1) + (
        s.nm + (s.cost == 2)) * s.n * s.n + s.nm * min(s.n, 32) ** 2)
        for s in (j.site for j in jobs))
    assert smem <= 70_144 <= 232_448


def _warp_sums(v):
    """(warps,) float32: each warp's xor butterfly of its 32 lanes, as
    __shfl_xor_sync leaves it in lane 0 (partners add in either order:
    float addition commutes)."""
    v = v.reshape(-1, 32).copy()
    for o in (16, 8, 4, 2, 1):
        v = v + v[:, np.arange(32) ^ o]
    return v[:, 0]


@pytest.mark.parametrize("seed", range(4))
def test_part_code_8x8_sums_keep_the_block_order(seed):
    """The premise of part_code's packed 8x8 columns: a column's sum over
    its two warps (64 threads, one element each) equals, bit for bit in
    float32, the first version's sum over the whole CTA's eight warps,
    whose six other warps hold +0.0, for non-negative addends (squared
    distortions, log2 rates) of every scale, zeros included."""
    rng = np.random.RandomState(seed)
    x = (rng.rand(64) * 10.0 ** rng.randint(-6, 8, 64)).astype(f32)
    x[rng.rand(64) < 0.3] = 0
    block = np.zeros(256, f32)
    block[:64] = x
    red = _warp_sums(block)
    first = red[0]
    for w in range(1, 8):
        first = f32(first + red[w])
    red2 = _warp_sums(x)
    assert first.tobytes() == f32(red2[0] + red2[1]).tobytes()
    # and a column whose elements are all +0.0 sums to +0.0
    assert _warp_sums(np.zeros(64, f32))[0].tobytes() == f32(0).tobytes()


# ---- part_chain's launch (kernels/intra_part.py:chain_layout mirrors
# csrc/intra_part.cu's clusters and the card test holds it to the
# library; _chain_plan mirrors chain_plane's index arithmetic) ----

def _chain_plan(n: int):
    """Per CTA of a plane's cluster (rank r): the coefficient positions it
    codes, a thread each (csrc/intra_part.cu chain_plane: pos = r * SL +
    t), and per thread the source positions of a column whose residual it
    forms (e = t + i * CHAIN_NT; every CTA forms the whole residual)."""
    nn = n * n
    sl = nn // K.CHAIN_CL
    return [(list(range(r * sl, (r + 1) * sl)),
             [list(range(t, nn, K.CHAIN_NT)) for t in range(K.CHAIN_NT)])
            for r in range(K.CHAIN_CL)]


@pytest.mark.parametrize("n", [16, 8], ids=["luma256", "chroma64"])
def test_chain_plan_takes_each_position_once(n):
    """A plane's cluster of CHAIN_CL CTAs: their slices take each of the
    n*n coefficient positions exactly once, a thread each and in 16-byte
    pieces of the forward matrix's row; every CTA's threads form the whole
    residual, each source position once; and a CTA's shared memory (its
    slice of the matrix, the residual, the two parity blocks, the
    inverse's scratch, rd_zero's table) fits the card's 232,448 bytes."""
    nn = n * n
    plan = _chain_plan(n)
    assert len(plan) == K.CHAIN_CL
    coded = np.zeros(nn, np.int32)
    for positions, sources in plan:
        assert len(positions) <= K.CHAIN_NT and len(positions) % 4 == 0
        assert positions == list(range(positions[0],
                                       positions[0] + len(positions)))
        coded[positions] += 1
        formed = np.zeros(nn, np.int32)
        for per_thread in sources:
            formed[per_thread] += 1
        assert (formed == 1).all()
    assert (coded == 1).all()
    words = K.chain_words(n)
    assert words == nn * nn // K.CHAIN_CL + nn + 3 * n * (n + 1) + 8
    lay = K.chain_layout([16, 8, 8] if n == 16 else [8, 8])
    assert lay.ctas == K.CHAIN_CL * (3 if n == 16 else 2)
    assert lay.smem == 4 * words <= 232_448


# ---- part_pred's launch (kernels/intra_part.py:PRED_COLS and pred_ctas
# mirror csrc/intra_part.cu's PredLayout and flat grid; the card test holds
# them to the library; _pred_plan mirrors pred_columns' index arithmetic)
# ----

def _pred_jobs(sizes, width):
    """Stand-ins of one launch's PredJobs: (n, nm, planes) per site at a
    frame `width` luma pixels wide (chroma half as wide)."""
    from types import SimpleNamespace

    return [SimpleNamespace(n=n, nm=nm, src=np.empty((n, w // n * n),
                                                     np.int8))
            for n, nm, luma, planes in sizes
            for w in [width if luma else width // 2] for _ in range(planes)]


_P16, _P32, _P64 = (16, 3, True, 1), (32, 3, True, 1), (64, 1, True, 1)
_P8C, _P16C, _P32C = (8, 1, False, 2), (16, 1, False, 2), (32, 1, False, 2)
_PRED_KINDS = [[_P16], [_P16, _P32], [_P16, _P32, _P64], [_P8C],
               [_P8C, _P16C], [_P8C, _P16C, _P32C]]


def _pred_plan(jobs):
    """The flat grid of part_pred, as the kernel walks it: per CTA its
    job (the jobs heaviest size first) and first column; per thread t and
    quad k < PER the quad u = t + 256 k, column c0 + u // QUADS, quad
    u % QUADS; the threads t < COLS * 2n load the edges, pixel t % 2n of
    column c0 + t // 2n.  Returns (order, [(job, c0)] per CTA), the
    elements of each job's resid and pred written, and its edge loads."""
    order = sorted(range(len(jobs)), key=lambda k: -jobs[k].n)
    ctas = []
    for k in order:
        n = jobs[k].n
        cols = jobs[k].src.shape[1] // n
        ctas += [(k, K.PRED_COLS[n] * b)
                 for b in range(-(-cols // K.PRED_COLS[n]))]
    written = [np.zeros(j.nm * (j.src.shape[1] // j.n) * j.n * j.n,
                        np.int32) for j in jobs]
    edges = [np.zeros((j.src.shape[1] // j.n, 2 * j.n), np.int32)
             for j in jobs]
    t = np.arange(256)
    for k, c0 in ctas:
        j = jobs[k]
        n, cols = j.n, j.src.shape[1] // j.n
        quads = n * n // 4
        per = max(1, quads // 256)
        for q in range(per):
            u = t + 256 * q
            c, p4 = c0 + u // quads, u % quads
            live = c < cols
            for m in range(j.nm):
                row = ((m * cols + c[live]) * n * n + 4 * p4[live])
                for e in range(4):
                    np.add.at(written[k], row + e, 1)
        et = t[t < K.PRED_COLS[n] * 2 * n]
        ec = c0 + et // (2 * n)
        np.add.at(edges[k], (ec[ec < cols], (et % (2 * n))[ec < cols]), 1)
    return order, ctas, written, edges


@pytest.mark.parametrize("width", [1920, 1936, 64, 192])
@pytest.mark.parametrize("kind", range(6), ids=[
    "+".join(("y" if s[2] else "c") + str(s[0]) for s in k)
    for k in _PRED_KINDS])
def test_part_pred_grid_writes_every_row_once(kind, width):
    """Every launch kind of the probe at 1920 (the main path) and ragged
    widths: part_pred's flat grid has exactly pred_ctas CTAs, the 64
    site's first, every CTA with a column; each (site, candidate, column)
    row of resid and pred is written exactly once, element by element in
    16-byte quads; and each column's 2n edge pixels are loaded once."""
    jobs = _pred_jobs(_PRED_KINDS[kind], width)
    order, ctas, written, edges = _pred_plan(jobs)
    assert len(ctas) == K.pred_ctas(jobs)
    sizes = [jobs[k].n for k, _ in ctas]
    assert sizes == sorted(sizes, reverse=True)
    assert all(c0 < jobs[k].src.shape[1] // jobs[k].n for k, c0 in ctas)
    for w, e in zip(written, edges):
        assert (w == 1).all() and (e == 1).all()
    # every thread of a full CTA has a quad: no warp idles
    for n in (8, 16, 32, 64):
        assert K.PRED_COLS[n] * n * n // 4 >= 256


# ---- part_merge's launch (kernels/intra_part.py:MERGE_CL and
# merge_layout mirror csrc/intra_part.cu's clusters; the card test holds
# them to the library; _merge_plan mirrors part_merge_kernel's indices) ----

def _merge_plan(ns, width, big):
    """What each CTA of one plane's part_merge launch takes, as the kernel
    indexes it: CTA x of the grid is rank k = x % MERGE_CL of superblock
    column C = x // MERGE_CL and takes region cm = 2C + k; its staged
    window quads (row p // q, pixels 4 (p % q) .. + 3), and with do_big
    (the 64 wins) its columns of the big window, rows of the small and
    mid levels and half of the big levels.  Returns per output the count
    of CTAs taking each element."""
    nm, nb = 2 * ns, 4 * ns
    cols_b, cols_m, cols_s = width // nb, width // nm, width // ns
    q = nm // 4
    out = {"region": np.zeros(cols_m, np.int32),
           "window": np.zeros((nm, width), np.int32),
           "big": np.zeros((nb, width), np.int32),
           "lv_s": np.zeros((4, cols_s, ns * ns), np.int32),
           "lv_m": np.zeros((2, cols_m, nm * nm), np.int32),
           "lv_b": np.zeros((cols_b, 1024), np.int32)}
    lay = K.merge_layout([MergeJob(
        torch.empty((1, cols_s, ns, ns)), None, None,
        torch.empty((nb, width)), None, None, None, None, 0, 1, big)])
    assert lay.cluster == K.MERGE_CL and lay.ctas == K.MERGE_CL * cols_b
    for x in range(lay.ctas):
        k, C = x % K.MERGE_CL, x // K.MERGE_CL
        cm = 2 * C + k
        out["region"][cm] += 1
        for key, rows in (("window", nm),) + ((("big", nb),) if big else ()):
            p = np.arange(rows * q)[:, None]
            np.add.at(out[key], (p // q, cm * nm + 4 * (p % q)
                                 + np.arange(4)), 1)
        if big:
            out["lv_s"][:, 2 * cm:2 * cm + 2] += 1
            out["lv_m"][:, cm] += 1
            out["lv_b"][C, k * 512 + np.arange(512)] += 1
    return out


@pytest.mark.parametrize("big", [False, True], ids=["half", "do_big"])
@pytest.mark.parametrize("ns,width", [(16, 1920), (8, 960), (16, 64),
                                      (8, 96)],
                         ids=["luma1920", "chroma960", "luma64", "chroma96"])
def test_part_merge_clusters_take_each_region_once(ns, width, big):
    """part_merge's clusters of MERGE_CL CTAs at the main path's widths and
    one superblock: each region of the half is taken by one CTA, whose
    staged window covers its nm x nm pixels once; with do_big the two CTAs
    of a superblock column split the 64x64 (chroma 32x32) window, the 16
    small and 4 mid level blocks and the big block's 1024 levels, each
    element once."""
    out = _merge_plan(ns, width, big)
    assert (out["region"] == 1).all() and (out["window"] == 1).all()
    for k in ("big", "lv_s", "lv_m", "lv_b"):
        assert (out[k] == (1 if big else 0)).all(), k


def _region_cost(lvs, lvm, sse, lam, split, parent):
    """A luma region's cost as part_merge sums it, in float32: the parent
    kernel's loops over the 16s' (lvs: (2 rows, 2 sides, 256)) and the
    32's (lvm: (1024,)) levels after the loser was zeroed, or the new
    kernel's over the winner's staged levels alone (row * 512 + side *
    256 + pos); element p on thread p mod 256 as its (p div 256)-th
    addend, the warps' xor butterflies, the warps in order."""
    def rate(v):
        v = np.abs(v.astype(np.float32))
        return np.where(v == 0, f32(0), f32(2) + np.log2(f32(1) + v))

    if parent:
        small = lvs if split else np.zeros_like(lvs)
        mid = np.zeros_like(lvm) if split else lvm
    rt = np.zeros((3, 256), f32)
    if parent or split:
        src = (small if parent else lvs).reshape(-1)
        for p in range(1024):
            side, r, pos = p // 512, p % 512 // 256, p % 256
            rt[side, p % 256] = f32(rt[side, p % 256]
                                    + rate(src[r * 512 + side * 256 + pos]))
    if parent or not split:
        src = mid if parent else lvm
        for p in range(1024):
            rt[2, p % 256] = f32(rt[2, p % 256] + rate(src[p]))
    tot = []
    for i in range(3):
        red = _warp_sums(rt[i])
        v = red[0]
        for w in range(1, 8):
            v = f32(v + red[w])
        tot.append(v)
    d = f32(f32(sse[0]) + f32(sse[1]))
    return f32(d + f32(lam * f32(f32(tot[0] + tot[1]) + tot[2])))


@pytest.mark.parametrize("seed", range(4))
def test_part_merge_rates_keep_the_parent_order(seed):
    """The premise of part_merge's rates: the winner's levels alone, read
    from the staged layout, give the region cost of the parent kernel's
    sums over both candidates' levels after the loser was zeroed (+0.0
    terms), bit for bit in float32, whichever wins, at levels of every
    magnitude with zeros among them."""
    rng = np.random.RandomState(seed)
    mags = 2 ** rng.randint(0, 14, (2, 2, 256))
    lvs = np.where(rng.rand(2, 2, 256) < 0.6, 0,
                   rng.randint(-1, 2, (2, 2, 256)) * mags).astype(np.int16)
    lvm = np.where(rng.rand(1024) < 0.5, 0,
                   rng.randint(-300, 300, 1024)).astype(np.int16)
    sse = rng.randint(0, 1 << 28, 2)
    lam = f32(rng.rand() * 300)
    for split in (True, False):
        a = _region_cost(lvs, lvm, sse, lam, split, parent=True)
        b = _region_cost(lvs, lvm, sse, lam, split, parent=False)
        assert a.tobytes() == b.tobytes(), (split, a, b)
