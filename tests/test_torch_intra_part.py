"""Port parity for the quality preset's q probe: encode_intra_part of
av1tpu_torch equals av1tpu.models.intra_part bit for bit (every level grid,
mode grid, split map and recon plane) at 128x192 in 8 bits (two superblock
rows, so the 64x64 candidates run) and at 64x128 in 10 bits.  The jitted
reference compiles once per (shape, bit depth).
probe_quality(partitions=True), a second jit of the same graph, is held in
tests/test_torch_a_slice_quality.py, which has it compiled already."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.models import intra_part as ref
from av1tpu.utils.yuv import synthetic_clip
from av1tpu_torch.models import intra_part as port
from tests.test_torch_threads import single_torch_thread  # noqa: F401

CASES = [(128, 192, 8, 72), (64, 128, 10, 140)]


def _planes(h, w, bd, seed):
    c = synthetic_clip(w, h, 1, seed=seed)
    planes = [c.y[0], c.u[0], c.v[0]]
    if bd == 10:
        planes = [p.astype(np.int32) * 4 + 1 for p in planes]
    return [p.astype(np.int32) for p in planes]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{h}x{w}-{bd}bit-q{q}" for h, w, bd, q in CASES])
def pair(request):
    h, w, bd, q = request.param
    planes = _planes(h, w, bd, seed=h + q)
    want = ref.encode_intra_part(*[jnp.asarray(p) for p in planes], q,
                                 bit_depth=bd)
    got = port.encode_intra_part(*[torch.from_numpy(p) for p in planes], q,
                                 bit_depth=bd)
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()}, planes, q, bd)


def test_encode_intra_part_matches_jax(pair):
    want, got, *_ = pair
    assert set(got) == set(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert np.array_equal(g, w), (k, int((g != w).sum()))


def test_partition_choices_are_exercised(pair):
    want, *_ = pair
    # the case is only a test of the merge logic if some regions merge
    assert want["split"].size > want["split"].sum() or \
        want["split64"].size > want["split64"].sum()


def test_fwd64_and_its_gains_bit_for_bit():
    """The TX_64X64 forward matrix over the 1024 coded coefficients, built
    from the port's own integer inverse, and the gains derived from it."""
    from av1tpu.models.rdoq import coef_gains as ref_gains
    from av1tpu_torch.models.rdoq import coef_gains
    from av1tpu_torch.ops.transforms import fwd64

    a, b = fwd64(), ref._fwd64()
    assert a.dtype == b.dtype == np.float32 and a.shape == (1024, 4096)
    assert np.array_equal(a.view(np.int32), b.view(np.int32))
    assert np.array_equal(coef_gains(64), ref_gains(64))


def test_part_compact_and_recon_matches_jax(pair):
    """The quality preset's all-intra frame: the union-layout compact
    buffer, its split and the fused recon against the reference's
    _part_compact_and_recon called eagerly, so that its inner
    encode_intra_part reuses the fixture's executable (cap 96 cuts the
    10-bit value list).  encode_intra_key_recon adds the in-loop deblock
    with the merge-gated edges: held as the port's edge_gates_j and
    deblock_planes (both held against the reference in
    tests/test_torch_filters.py) on that recon, which spares the reference's
    eager deblock its many small compiles."""
    from av1tpu.models.intra_v import fuse_planes
    from av1tpu_torch.models.deblock import deblock_planes, edge_gates_j

    want_o, got_o, planes, q, bd = pair
    h, w = planes[0].shape
    cap = 163840 if bd == 8 else 96
    fused = fuse_planes(*planes, bit_depth=bd)
    wbuf, wrec = ref._part_compact_and_recon(jnp.asarray(fused), q, h, w,
                                             cap)
    src = torch.from_numpy(fused.astype(np.uint8 if bd == 8 else np.int32))
    gbuf, grec = port._part_compact_and_recon(src, q, h, w, cap,
                                              bit_depth=bd)
    assert gbuf.dtype == torch.int16 and grec.dtype == torch.int32
    assert np.array_equal(gbuf.numpy(), np.asarray(wbuf))
    assert np.array_equal(grec.numpy(), np.asarray(wrec))
    assert port.part_sizes(h, w) == ref.part_sizes(h, w)
    a = ref.split_compact_part(np.asarray(wbuf), h, w)
    b = port.split_compact_part(gbuf.numpy(), h, w)
    assert a[0] == b[0] > 0 and (a[0] > cap) == (bd == 10)
    for x, z in zip(a[1:], b[1:]):
        assert x.dtype == z.dtype and np.array_equal(x, z)
    chunk = port.encode_intra_part_chunk(src[None], q, h, w, cap=cap,
                                         bit_depth=bd)
    assert torch.equal(chunk[0], gbuf) and chunk.shape[0] == 1
    assert torch.equal(port.encode_intra_part_compact(
        src, q, h, w, cap=cap, bit_depth=bd), gbuf)

    lf = (12, 6, 6)
    kbuf, krec = port.encode_intra_key_recon(src, q, h, w, cap=cap, lf=lf,
                                             bit_depth=bd)
    assert torch.equal(kbuf, gbuf)
    v_on, h_on = edge_gates_j(torch.from_numpy(got_o["split"]),
                              torch.from_numpy(got_o["split64"]), h // 16,
                              w // 16)
    planes_lf = deblock_planes(*(torch.from_numpy(got_o[k]) for k in
                                 ("recon_y", "recon_u", "recon_v")),
                               v_on, h_on, *lf, 0, bd)
    assert torch.equal(krec, torch.cat([p.reshape(-1) for p in planes_lf]))
    assert not torch.equal(krec, grec)          # the deblock ran
