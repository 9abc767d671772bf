"""Port parity for the fast-preset inter pipeline: motion search, chroma
MC, encode_inter_v, the compact transport and the whole GOP step (with the
in-loop deblock and CDEF) of av1tpu_torch equal av1tpu.models.inter_v bit
for bit.  Both sides start from the JAX keyframe's recon (handed over with
state.carry_from_numpy), then each carries its own recon one frame on.

All JAX outputs of a frame come from ONE jitted function, so the inter
graph compiles once per bit depth."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.models import intra_v as ref_intra
from av1tpu.models import inter_v as ref
from av1tpu_torch.models import inter_v as port
from av1tpu_torch.state import carry_from_numpy
from tests.test_inter_pipeline import moving_clip
from tests.test_torch_threads import single_torch_thread  # noqa: F401

H, W = 64, 128
CAP = 4096
LF = (9, 4, 4)
CDEF = (2, 1, 2, 1)


@functools.partial(jax.jit, static_argnames=("q", "bd"))
def _jax_frame(frame, ref_fused, q, bd):
    ny, nc = H * W, H * W // 4

    def unfuse(f):
        return (f[:ny].reshape(H, W).astype(jnp.int32),
                f[ny : ny + nc].reshape(H // 2, W // 2).astype(jnp.int32),
                f[ny + nc :].reshape(H // 2, W // 2).astype(jnp.int32))

    y, u, v = unfuse(frame)
    ry, ru, rv = unfuse(ref_fused)
    pix_max = (1 << bd) - 1
    ac = ref_intra._plane_params(q, 16, bd)[0][1]
    lam = (ac * ac * 0.0234) ** 0.5
    mv8, pred_y, _, _ = ref._search_mv(y, ry, lam, pix_max)
    pu, pv = ref._chroma_mc_pair(ru, rv, mv8, pix_max)
    o = ref.encode_inter_v(y, u, v, ry, ru, rv, q, bit_depth=bd)
    buf, new_ref = ref._gop_step_body(frame, ref_fused, q, H, W, CAP,
                                      jnp.asarray(LF, jnp.int32),
                                      jnp.asarray(CDEF, jnp.int32))
    return {"mv8": mv8, "pred_y": pred_y, "pred_u": pu, "pred_v": pv,
            "inter": o, "buf": buf, "new_ref": new_ref}


def _port_frame(frame, ref_fused, q, bd):
    from av1tpu_torch.models.intra_v import unfuse

    y, u, v = unfuse(frame, H, W)
    ry, ru, rv = unfuse(ref_fused, H, W)
    pix_max = (1 << bd) - 1
    lam, _ = port.inter_lambdas(q, bd, frame.device)
    mv8, pred_y, _, _ = port._search_mv(y, ry, lam, pix_max)
    pu, pv = port._chroma_mc_pair(ru, rv, mv8, pix_max)
    o = port.encode_inter_v(y, u, v, ry, ru, rv, q, bit_depth=bd)
    buf, new_ref = port._gop_step_body(frame, ref_fused, q, H, W, CAP,
                                       LF, CDEF, bit_depth=bd)
    return {"mv8": mv8, "pred_y": pred_y, "pred_u": pu, "pred_v": pv,
            "inter": o, "buf": buf, "new_ref": new_ref}


def _clip_frames(bd, seed):
    c = moving_clip(W, H, 3, seed=seed, dy=1, dx=3)
    frames = []
    for k in range(3):
        planes = [c.y[k], c.u[k], c.v[k]]
        if bd == 10:
            planes = [p.astype(np.int32) * 4 + 1 for p in planes]
        frames.append(ref_intra.fuse_planes(*planes, bit_depth=bd))
    return frames


def run_chain(bd, q, seed):
    """JAX keyframe on frame 0, then two inter frames on each side."""
    frames = _clip_frames(bd, seed)
    _, key_rec = ref_intra.encode_intra_v_key_recon(
        jnp.asarray(frames[0]), q, H, W, cap=CAP, lf=LF)
    ref_p, _, _ = carry_from_numpy(np.asarray(key_rec), None, None, "cpu")
    ref_j = jnp.asarray(np.asarray(key_rec))
    out = []
    tdt = torch.uint8 if bd == 8 else torch.int32
    for k in (1, 2):
        want = _jax_frame(jnp.asarray(frames[k]), ref_j, q, bd)
        got = _port_frame(torch.from_numpy(frames[k].astype(
            np.uint8 if bd == 8 else np.int32)).to(tdt), ref_p, q, bd)
        out.append((jax.tree_util.tree_map(np.asarray, want), got))
        ref_j, ref_p = want["new_ref"], got["new_ref"]
    return out


@pytest.fixture(scope="module")
def chain8():
    return run_chain(8, 90, seed=31)


def _eq(got, want, name):
    g = got.numpy()
    assert g.shape == want.shape, name
    assert np.array_equal(g, want), (name, int((g != want).sum()))


@pytest.mark.parametrize("k", [0, 1])
def test_search_mv_matches_jax(chain8, k):
    want, got = chain8[k]
    _eq(got["mv8"], want["mv8"], "mv8")
    _eq(got["pred_y"], want["pred_y"], "pred_y")


@pytest.mark.parametrize("k", [0, 1])
def test_chroma_mc_pair_matches_jax(chain8, k):
    want, got = chain8[k]
    _eq(got["pred_u"], want["pred_u"], "pred_u")
    _eq(got["pred_v"], want["pred_v"], "pred_v")


@pytest.mark.parametrize("k", [0, 1])
def test_encode_inter_v_matches_jax(chain8, k):
    want, got = chain8[k]
    assert set(got["inter"]) == set(want["inter"])
    for name, w in want["inter"].items():
        assert got["inter"][name].numpy().dtype == w.dtype, name
        _eq(got["inter"][name], w, name)


@pytest.mark.parametrize("k", [0, 1])
def test_gop_step_buffer_and_recon_match_jax(chain8, k):
    want, got = chain8[k]
    assert got["buf"].dtype == torch.int16
    _eq(got["buf"], want["buf"], "compact buffer")
    _eq(got["new_ref"], want["new_ref"], "deblocked + CDEF'd recon")


def test_compact_truncates_like_jax():
    rng = np.random.RandomState(4)
    flat = (rng.randint(-3, 4, size=H * W * 3 // 2)
            * (rng.rand(H * W * 3 // 2) < 0.1)).astype(np.int16)
    mv = rng.randint(-200, 200, size=(H // 16, W // 16, 2)).astype(np.int32)
    for cap in (16, 1000, 1 << 20):
        want = np.asarray(ref._compact(jnp.asarray(flat), jnp.asarray(mv),
                                       cap))
        got = port._compact(torch.from_numpy(flat), torch.from_numpy(mv),
                            cap)
        _eq(got, want, f"compact cap={cap}")


@pytest.mark.parametrize("n,ptype,q", [(16, 0, 90), (8, 1, 30), (8, 1, 200)])
def test_rate_model_and_rd_zero_match_jax(n, ptype, q):
    from av1tpu.models.rates import RateModel as JaxRateModel
    from av1tpu.models.rates import qctx_index as jax_qctx
    from av1tpu.models.rdoq import rd_zero as jax_rd_zero
    from av1tpu_torch.models.rates import RateModel, qctx_index
    from av1tpu_torch.models.rdoq import coef_gains, rd_zero

    rng = np.random.RandomState(n + q)
    lv = (rng.randint(-40, 41, size=(6, n, n))
          * (rng.rand(6, n, n) < 0.3)).astype(np.int32)
    lv[0] = 0
    qctx = qctx_index(q)
    assert qctx == int(jax_qctx(q))
    want = np.asarray(JaxRateModel(n, ptype)(jnp.asarray(lv), qctx))
    got = RateModel(n, ptype, "cpu")(torch.from_numpy(lv), qctx).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)

    m = n * n
    coefs = (lv.reshape(6, m) * 19.0
             + rng.uniform(-9, 9, size=(6, m))).astype(np.float32)
    flat = lv.reshape(6, m)
    dq = np.full((m,), 19.0, np.float32)
    tab = np.array(JaxRateModel(n, ptype).tabs[qctx])
    gains = coef_gains(n)
    for gate in (None, 900.0):
        w = np.asarray(jax_rd_zero(jnp.asarray(flat), jnp.asarray(coefs),
                                   jnp.asarray(dq), jnp.float32(700.0),
                                   jnp.asarray(tab), jnp.asarray(gains),
                                   noise_gate=gate))
        g = rd_zero(torch.from_numpy(flat), torch.from_numpy(coefs),
                    torch.from_numpy(dq), 700.0, torch.from_numpy(tab),
                    torch.from_numpy(gains), noise_gate=gate).numpy()
        assert np.array_equal(g, w)
