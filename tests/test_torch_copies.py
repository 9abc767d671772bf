"""The port's own copies of host-side code equal their originals in av1tpu:
the TU wrappers, the packer wrapper, the rate-table functions, the spec
tables, the forward transform matrices (bit for bit) and the clip helpers
with their y4m IO."""

import itertools

import numpy as np
import pytest
import torch

from av1tpu import cli as ref_cli
from av1tpu.coding.packer import Packer as RefPacker
from av1tpu.models import rates as ref_rates
from av1tpu.spec import enums as ref_enums
from av1tpu.spec import tables as ref_tables
from av1tpu.spec.transforms import _forward_matrix
from av1tpu.utils import yuv as ref_yuv
from av1tpu_torch import cli as port_cli
from av1tpu_torch._build import packer_lib_path
from av1tpu_torch.coding.packer import Packer
from av1tpu_torch.models import intra_v
from av1tpu_torch.models import rates as port_rates
from av1tpu_torch.ops.transforms import forward_matrix
from av1tpu_torch.spec import enums as port_enums
from av1tpu_torch.spec import tables as port_tables
from av1tpu_torch.utils import yuv as port_yuv
from tests.test_torch_threads import single_torch_thread  # noqa: F401

# (coded w, coded h, render w, render h)
SIZES = [(128, 64, 128, 64), (1920, 1088, 1920, 1080)]
TILE = bytes(range(7))


@pytest.mark.parametrize("size", SIZES, ids=["small", "1080p"])
@pytest.mark.parametrize("bit_depth", [8, 10])
def test_wrap_tu_copy(size, bit_depth):
    grid = itertools.product((1, 72, 255), ((0, 0, 0, 0), (9, 9, 4, 4),
                                            (0, 5, 2, 0)),
                             (None, (3, 1, 2, 0)), (False, True),
                             (False, True))
    for q, lf, cdef, tx_select, cdf_save in grid:
        kw = dict(lf=lf, cdef=cdef, tx_select=tx_select, cdf_save=cdf_save)
        assert (port_cli._wrap_tu(TILE, *size, q, bit_depth, **kw)
                == ref_cli._wrap_tu(TILE, *size, q, bit_depth, **kw)), kw


@pytest.mark.parametrize("size", SIZES, ids=["small", "1080p"])
@pytest.mark.parametrize("bit_depth", [8, 10])
def test_wrap_tu_inter_copy(size, bit_depth):
    grid = itertools.product((1, 120), ((0, 0, 0, 0), (9, 9, 4, 4)),
                             (None, (2, 3, 1, 1)), (None, 0), (False, True),
                             (False, True), (False, True))
    for q, lf, cdef, primary_ref, cdf_save, golden, refresh in grid:
        kw = dict(lf=lf, cdef=cdef, primary_ref=primary_ref,
                  cdf_save=cdf_save, golden=golden, refresh=refresh)
        assert (port_cli._wrap_tu_inter(TILE, *size, q, bit_depth, **kw)
                == ref_cli._wrap_tu_inter(TILE, *size, q, bit_depth,
                                          **kw)), kw


def test_host_helper_copies():
    assert port_cli.KEY_Q_BOOST == ref_cli.KEY_Q_BOOST
    rng = np.random.RandomState(3)
    a = rng.randint(0, 1023, size=(37, 53))
    for h, w in ((37, 53), (64, 64), (40, 96)):
        assert np.array_equal(port_cli._pad_plane(a, h, w),
                              ref_cli._pad_plane(a, h, w))
    for cdef in (None, (1, 2, 3, 0)):
        assert port_cli._cdef_cfg_kw(cdef) == ref_cli._cdef_cfg_kw(cdef)


def _sparse_levels(rng, n, density):
    flat = np.where(rng.rand(n) < density,
                    rng.randint(-40, 41, size=n), 0).astype(np.int16)
    bitmap = np.packbits(flat != 0, bitorder="little").view(np.uint16)
    return bitmap, flat[flat != 0]


def test_packer_copy():
    ref, port = RefPacker(packer_lib_path()), Packer()
    h, w = 64, 128
    # a keyframe buffer from the port's own pipeline
    rng = np.random.RandomState(11)
    planes = [rng.randint(0, 256, size=s).astype(np.int32)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    fused = torch.from_numpy(intra_v.fuse_planes(*planes))
    ncoef = h * w * 3 // 2
    buf, _ = intra_v.encode_intra_v_key_recon(fused, 60, h, w, cap=ncoef)
    count, bm, vals, modes = intra_v.split_compact(buf.numpy(), h, w)
    assert count <= len(vals)   # the packer reads `count` values
    blobs = [p.new_cdf_blob() for p in (ref, port)]
    tiles = [p.pack_tile_compact(bm, vals, h, w, 60, modes=modes, uv_mode=1,
                                 cdf_out=blob)
             for p, blob in zip((ref, port), blobs)]
    assert tiles[0] == tiles[1] and np.array_equal(*blobs)
    # inter frames chained on the keyframe's CDFs
    for density in (0.002, 0.05):
        bm, vals = _sparse_levels(rng, ncoef, density)
        mv = 2 * rng.randint(-16, 17, size=(h // 16, w // 16, 2))
        outs = []
        for p, blob in zip((ref, port), blobs):
            outs.append(p.pack_tile_inter(bm, vals, mv, h, w, 90,
                                          cdf_in=blob, cdf_out=blob))
        assert outs[0] == outs[1] and np.array_equal(*blobs)


def test_packer_copy_quality_calls():
    """The wavefront keyframe pack (modes, uv_mode=0, tx_from_mode, txd) and
    the partitioned inter pack (split maps, per-8 MVs, refs) give the same
    bytes and CDF blobs through both wrappers."""
    from av1tpu_torch.models import intra_wave

    ref, port = RefPacker(packer_lib_path()), Packer()
    h, w = 64, 128
    rng = np.random.RandomState(12)
    planes = [rng.randint(0, 256, size=s).astype(np.int32)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    fused = torch.from_numpy(intra_v.fuse_planes(*planes))
    ncoef = h * w * 3 // 2
    buf, _ = intra_wave.encode_intra_wave_key_recon(fused, 60, h, w,
                                                    cap=ncoef)
    count, bm, vals, modes, txd = intra_wave.split_compact_wave(
        buf.numpy(), h, w)
    assert count <= len(vals) and txd.any()
    blobs = [p.new_cdf_blob() for p in (ref, port)]
    tiles = [p.pack_tile_compact(bm, vals, h, w, 60, modes=modes, uv_mode=0,
                                 tx_from_mode=True, cdf_out=blob, txd=txd)
             for p, blob in zip((ref, port), blobs)]
    assert tiles[0] == tiles[1] and np.array_equal(*blobs)
    # partitioned inter frames chained on the keyframe's CDFs
    r16, c16 = h // 16, w // 16
    for density, with_refs in ((0.002, False), (0.05, True)):
        bm, vals = _sparse_levels(rng, ncoef, density)
        split64 = rng.rand(r16 // 4, c16 // 4) < 0.5
        split32 = (rng.rand(r16 // 2, c16 // 2) < 0.6) & np.repeat(
            np.repeat(split64, 2, 0), 2, 1)
        split16 = (rng.rand(r16, c16) < 0.3) & np.repeat(
            np.repeat(split32, 2, 0), 2, 1)
        mv16 = 2 * rng.randint(-16, 17, size=(r16 // 4, c16 // 4, 2))
        mv = np.repeat(np.repeat(mv16, 8, 0), 8, 1)    # per-8, merge-uniform
        refs = None
        if with_refs:
            refs = np.repeat(np.repeat(rng.rand(r16 // 4, c16 // 4) < 0.5,
                                       4, 0), 4, 1) & ~split16
            mv = np.where(np.repeat(np.repeat(refs, 2, 0), 2, 1)[..., None],
                          0, mv)
        outs = []
        for p, blob in zip((ref, port), blobs):
            outs.append(p.pack_tile_inter_part(
                bm, vals, split32, split64, mv, h, w, 90, cdf_in=blob,
                cdf_out=blob, refs=refs, split16=split16))
        assert outs[0] == outs[1] and np.array_equal(*blobs)
    with pytest.raises(ValueError):
        port.pack_tile_inter_part(bm, vals, split32, split64, mv[::2, ::2],
                                  h, w, 90, split16=split16)


def test_quality_host_constant_copies():
    """kf_mode_bits, the per-transform-type gains, the prediction
    constants and the mode enums equal the reference's.  (The TX_64X64
    forward matrix and its gains are held in
    tests/test_torch_intra_part.py, which builds the reference's anyway.)"""
    from av1tpu.models import rdoq as ref_rdoq
    from av1tpu.spec import predict as ref_predict
    from av1tpu_torch.models import rdoq as port_rdoq
    from av1tpu_torch.spec import predict as port_predict

    assert np.array_equal(port_rates.kf_mode_bits(), ref_rates.kf_mode_bits())
    for n, t in [(n, t) for n in (4, 8, 16) for t in range(4)]:
        assert np.array_equal(port_rdoq.coef_gains(n, t),
                              ref_rdoq.coef_gains(n, t)), (n, t)
    assert port_predict.DR_INTRA_DERIVATIVE == ref_predict.DR_INTRA_DERIVATIVE
    assert port_predict.MODE_ANGLE == ref_predict.MODE_ANGLE
    for n, wts in port_predict.SM_WEIGHTS.items():
        assert np.array_equal(wts, ref_predict.SM_WEIGHTS[n])
    for name in ("DC_PRED", "V_PRED", "H_PRED", "D45_PRED", "D135_PRED",
                 "D113_PRED", "D157_PRED", "D203_PRED", "D67_PRED",
                 "SMOOTH_PRED", "SMOOTH_V_PRED", "SMOOTH_H_PRED",
                 "PAETH_PRED"):
        assert getattr(port_enums, name) == getattr(ref_enums, name), name


@pytest.mark.parametrize("tx_ctx", range(5))
def test_rate_table_copies(tx_ctx):
    for ptype in (0, 1):
        a = port_rates.coef_rate_tables(tx_ctx, ptype)
        b = ref_rates.coef_rate_tables(tx_ctx, ptype)
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert np.array_equal(port_rates.txb_skip_bits(tx_ctx),
                          ref_rates.txb_skip_bits(tx_ctx))
    n = 4 << tx_ctx
    assert np.array_equal(port_rates.scan_rank(n), ref_rates.scan_rank(n))
    area = min(n, 32) ** 2
    for ptype in (0, 1):
        assert np.array_equal(port_rates.eob_bits_tables(area, ptype),
                              ref_rates.eob_bits_tables(area, ptype))
    assert port_enums.tx_size_ctx(tx_ctx) == ref_enums.tx_size_ctx(tx_ctx)
    assert np.array_equal(port_enums.default_scan(tx_ctx),
                          ref_enums.default_scan(tx_ctx))


@pytest.mark.parametrize("name", ["quant", "coef_cdfs", "subpel_filters",
                                  "mode_cdfs"])
def test_spec_table_copies(name):
    a, b = getattr(port_tables, name)(), getattr(ref_tables, name)()
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("n,tx_type", [(n, t) for n in (4, 8, 16)
                                       for t in range(4)] + [(32, 0)])
def test_forward_matrix_bit_for_bit(n, tx_type):
    a = forward_matrix(n, n, tx_type)
    b = _forward_matrix(n, n, tx_type).astype(np.float32)
    assert a.dtype == np.float32 and a.shape == b.shape
    assert np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("bit_depth", [8, 10])
def test_clip_and_y4m_copies(bit_depth, tmp_path):
    for seed, (w, h), motion in ((0, (96, 64), True), (7, (192, 128), False)):
        kw = dict(bit_depth=bit_depth, seed=seed, motion=motion)
        a = port_yuv.synthetic_clip(w, h, 3, **kw)
        b = ref_yuv.synthetic_clip(w, h, 3, **kw)
        for p in ("y", "u", "v"):
            x, z = getattr(a, p), getattr(b, p)
            assert x.dtype == z.dtype and np.array_equal(x, z), p
    port_yuv.write_y4m(str(tmp_path / "p.y4m"), a)
    ref_yuv.write_y4m(str(tmp_path / "r.y4m"), b)
    assert (tmp_path / "p.y4m").read_bytes() == (tmp_path / "r.y4m").read_bytes()
    c, d = port_yuv.read_y4m(str(tmp_path / "r.y4m")), \
        ref_yuv.read_y4m(str(tmp_path / "p.y4m"))
    assert (c.bit_depth, c.fps_num, c.fps_den) == (d.bit_depth, d.fps_num,
                                                   d.fps_den) == (
        bit_depth, 30, 1)
    for p in ("y", "u", "v"):
        assert np.array_equal(getattr(c, p), getattr(d, p))
        assert np.array_equal(getattr(c, p), getattr(a, p))
