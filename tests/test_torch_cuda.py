"""Tests that need an NVIDIA GPU: the CUDA transform+quantize kernel agrees
with its plain PyTorch version at the main path's shapes, the wavefront
keyframe's two kernels agree with theirs from the same carried state, the
wrappers reject what the kernels do not take, and the scene batch runs on
the visible GPUs (its workers launching the wavefront kernels).  They skip
where CUDA is absent.
This file imports no JAX, so it also runs on a GPU machine without it:

    python -m pytest --noconftest -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from av1tpu_torch.kernels.intra_wave import (
    wave_compare, wave_luma16, wave_sub_chroma,
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
    # each worker's keyframe: two wavefront launches per diagonal
    nd = wave_diagonals(64, 64)
    for r in res:
        assert r["launches"]["wave_luma16"] == nd, r["launches"]
        assert r["launches"]["wave_sub_chroma"] == nd, r["launches"]
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
    """Each diagonal's two kernels from the plain version's carried state
    on a 128x192 frame: where pick, tx depth and levels agree the recon,
    mode and chroma are identical (the integer path is exact); a level may
    differ by 1 where the decisions agree (a quantize or rd_zero rounding
    boundary, float32 sums in another order than cuBLAS's); a decision may
    flip at a near-tie, in at most 1 of the 96 lanes."""
    before = (wave_luma16.launches, wave_sub_chroma.launches)
    o = wave_compare(*_wave_planes(bd, dev), q, bit_depth=bd, lam_scale=0.3,
                     noise_gate=gate)
    torch.cuda.synchronize()
    nd = wave_diagonals(128, 192)
    assert (wave_luma16.launches, wave_sub_chroma.launches) == (
        before[0] + nd, before[1] + nd)
    print({k: v for k, v in o.items() if k != "plain"})
    assert o["lanes"] == 96
    assert o["recon_lanes"] == 0
    assert o["level_max_diff"] <= 1
    assert len(o["picks"]) + len(o["txds"]) <= 1


@pytest.mark.cuda
def test_wave_wrappers_reject_bad_inputs(dev):
    y, u, v = _wave_planes(8, dev, 64, 48)
    tabs, (sy, su, sv), diags, grids = wave_setup(y, u, v, 72, 8, 1.0, 0.0)
    diag = diags[3]
    best = wave_luma16(sy, grids[0], tabs, *diag)
    wave_sub_chroma(sy, su, sv, *grids, tabs, *diag, *best)
    with pytest.raises(TypeError):                  # int32 rows
        wave_luma16(sy, grids[0], tabs, diag[0].int(), *diag[1:])
    with pytest.raises(ValueError):                 # on the CPU
        wave_luma16(sy.cpu(), grids[0], tabs, *diag)
    with pytest.raises(ValueError):                 # not contiguous
        wave_luma16(sy.t().contiguous().t(), grids[0], tabs, *diag)
    with pytest.raises(ValueError):                 # no valid lane
        wave_luma16(sy, grids[0], tabs, *diag[:6], 0)
    with pytest.raises(ValueError):                 # the grid's shape
        wave_sub_chroma(sy, su, sv, grids[0][:, :2].contiguous(),
                        *grids[1:], tabs, *diag, *best)
    with pytest.raises(TypeError):                  # the levels' dtype
        wave_sub_chroma(sy, su, sv, *grids[:3], grids[3].int(), *grids[4:],
                        tabs, *diag, *best)
    with pytest.raises(TypeError):                  # a float64 cost
        wave_sub_chroma(sy, su, sv, *grids, tabs, *diag, *best[:3],
                        best[3].double(), best[4])
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
