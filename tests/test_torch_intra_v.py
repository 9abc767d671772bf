"""Port parity for the fast-preset intra pipeline: av1tpu_torch's
encode_intra_v (rdo on and off) and encode_intra_v_key_recon (with the
in-loop deblock) equal av1tpu.models.intra_v bit for bit: level grids,
reconstructions, modes and the compact transport buffer.  The port codes
U and V in one _encode_plane pass; each plane equals its own pass and the
reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.models import intra_v as ref
from av1tpu.utils.yuv import synthetic_clip
from av1tpu_torch.models import intra_v as port
from tests.test_torch_threads import single_torch_thread  # noqa: F401

H, W = 64, 128


def _planes(bit_depth, seed):
    c = synthetic_clip(W, H, 1, bit_depth=bit_depth, seed=seed)
    return tuple(p[0].astype(np.int32) for p in (c.y, c.u, c.v))


@pytest.fixture(scope="module")
def planes8():
    return _planes(8, 3)


@pytest.mark.parametrize("rdo", [False, True])
@pytest.mark.parametrize("q", [40, 160])
def test_encode_intra_v_matches_jax(planes8, rdo, q):
    want = ref.encode_intra_v(*(jnp.asarray(p) for p in planes8), q,
                              bit_depth=8, rdo=rdo)
    got = port.encode_intra_v(*(torch.from_numpy(p) for p in planes8), q,
                              bit_depth=8, rdo=rdo)
    assert set(got) == set(want)
    for k in want:
        w = np.asarray(want[k])
        g = got[k].numpy()
        assert g.dtype == w.dtype, k
        assert np.array_equal(g, w), k


@pytest.mark.parametrize("bit_depth,q,lf", [(8, 60, (9, 4, 4)),
                                            (10, 90, (16, 8, 8)),
                                            (8, 200, None)])
def test_key_recon_matches_jax(bit_depth, q, lf):
    y, u, v = _planes(bit_depth, 5)
    fused = ref.fuse_planes(y, u, v, bit_depth=bit_depth)
    cap = 4096
    wbuf, wrec = ref.encode_intra_v_key_recon(jnp.asarray(fused), q, H, W,
                                              cap=cap, lf=lf)
    src = torch.from_numpy(fused.astype(np.uint8 if bit_depth == 8
                                        else np.int32))
    gbuf, grec = port.encode_intra_v_key_recon(src, q, H, W, cap=cap, lf=lf,
                                               bit_depth=bit_depth)
    assert gbuf.dtype == torch.int16 and grec.dtype == torch.int32
    assert np.array_equal(gbuf.numpy(), np.asarray(wbuf))
    assert np.array_equal(grec.numpy(), np.asarray(wrec))


def test_key_recon_capacity_truncates_like_jax(planes8):
    fused = ref.fuse_planes(*planes8)
    wbuf, _ = ref.encode_intra_v_key_recon(jnp.asarray(fused), 20, H, W,
                                           cap=64, lf=None)
    gbuf, _ = port.encode_intra_v_key_recon(torch.from_numpy(fused), 20, H,
                                            W, cap=64, lf=None)
    count = int(gbuf[0]) | (int(gbuf[1]) << 15)
    assert count > 64
    assert np.array_equal(gbuf.numpy(), np.asarray(wbuf))


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_chroma_pair_matches_single_planes_and_jax(bit_depth):
    _, u, v = _planes(bit_depth, 9)
    base = 1 << (bit_depth - 1)
    lv2, rec2 = port._encode_plane(torch.from_numpy(np.stack([u, v])), 90,
                                   8, base, tx_type=1, bit_depth=bit_depth)
    assert lv2.shape == (2, H // 16, W // 16, 8, 8)
    assert rec2.shape == (2, H // 2, W // 2)
    ref_plane = jax.jit(ref._encode_plane, static_argnums=(1, 2, 3, 4, 5))
    for i, p in enumerate((u, v)):
        lv1, rec1 = port._encode_plane(torch.from_numpy(p)[None], 90, 8,
                                       base, tx_type=1, bit_depth=bit_depth)
        assert torch.equal(lv2[i], lv1[0]) and torch.equal(rec2[i], rec1[0])
        jlv, jrec = ref_plane(jnp.asarray(p), 90, 8, base, 1, bit_depth)
        assert np.array_equal(lv2[i].numpy(), np.asarray(jlv))
        assert np.array_equal(rec2[i].numpy(), np.asarray(jrec))


@pytest.mark.parametrize("q,cap", [(40, 163840), (160, 64)])
def test_intra_v_compact_and_chunk_match_jax(planes8, q, cap, monkeypatch):
    """encode_intra_v_compact (the fast all-intra frame's transport; cap 64
    cuts the value list) against the reference's.  The reference is
    reached through the jitted functions' __wrapped__ bodies, so that its
    inner encode_intra_v(rdo=True) hits the executable that
    test_encode_intra_v_matches_jax compiled (same shapes, bit depth and a
    Python-int q) instead of compiling the whole frame again."""
    monkeypatch.setattr(ref, "encode_intra_v_u8",
                        ref.encode_intra_v_u8.__wrapped__)
    fused = ref.fuse_planes(*planes8)
    want = np.asarray(ref.encode_intra_v_compact.__wrapped__(
        jnp.asarray(fused), q, H, W, cap, True))
    got = port.encode_intra_v_compact(torch.from_numpy(fused), q, H, W,
                                      cap=cap)
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy(), want)
    a = ref.split_compact(want, H, W)
    assert (a[0] > cap) == (cap == 64)
    chunk = port.encode_intra_v_chunk(
        torch.from_numpy(np.stack([fused, fused[::-1].copy()])), q, H, W,
        cap=cap)
    assert chunk.shape == (2, len(want))
    assert np.array_equal(chunk[0].numpy(), want)
    assert not np.array_equal(chunk[1].numpy(), want)
