"""The transform+quantize kernel module: its plain version equals the JAX
Pallas kernel (interpret mode on the CPU) on the cases of
tests/test_kernels.py, and the wrapper takes the plain version for CPU
tensors only.  The CUDA kernel's own tests are in tests/test_torch_cuda.py
(no JAX import, so they run on a GPU machine without JAX)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.kernels.transform_quant import transform_quantize as jax_tq
from av1tpu_torch.kernels.transform_quant import (
    TQPlane, count_level_flips, transform_quantize, transform_quantize_ref,
)
from av1tpu_torch.ops.transforms import forward_matrix
from tests.test_torch_threads import single_torch_thread  # noqa: F401


def _case(n, b, seed, tx_type=0):
    """tests/test_kernels.py:_case, as numpy."""
    rng = np.random.RandomState(seed)
    resid = rng.randint(-255, 255, size=(b, n * n)).astype(np.float32)
    fwdt = np.ascontiguousarray(forward_matrix(n, n, tx_type).T)
    step = np.full((1, n * n), 19.0, np.float32)
    step[0, 0] = 17.0
    q = np.full((1, n * n), 19, np.int32)
    q[0, 0] = 17
    cap = np.full((1, n * n), 1 << 14, np.int32)
    return resid, fwdt, step, q, cap


@pytest.mark.parametrize("n,b,seed,tx_type", [(16, 120, 0, 0), (8, 37, 1, 0),
                                               (16, 1, 2, 0), (8, 120, 3, 1)])
def test_plain_matches_jax_kernel(n, b, seed, tx_type):
    args = _case(n, b, seed, tx_type)
    jlv, jdq = jax_tq(*(jnp.asarray(a) for a in args))
    resid, *consts = (torch.from_numpy(a) for a in args)
    before = transform_quantize.launches
    lv, dq = transform_quantize(resid, TQPlane(*consts))
    assert transform_quantize.launches == before   # CPU: plain version
    assert lv.dtype == torch.int16 and dq.dtype == torch.int32
    assert np.array_equal(lv.numpy(), np.asarray(jlv))
    assert np.array_equal(dq.numpy(), np.asarray(jdq))


def test_flip_rule_accepts_boundary_flips_only():
    resid, fwdt, step, q, cap = (torch.from_numpy(a)
                                 for a in _case(8, 16, 5))
    lv, dq = transform_quantize_ref(resid, TQPlane(fwdt, step, q, cap))
    assert count_level_flips(lv, dq, lv, resid, fwdt, step, q) == 0
    bad = lv.clone()
    bad[3, 5] += 1                     # away from any rounding boundary
    with pytest.raises(AssertionError):
        count_level_flips(bad, bad.int() * q, lv, resid, fwdt, step, q)
    with pytest.raises(AssertionError):
        count_level_flips(lv, dq + 1, lv, resid, fwdt, step, q)


def test_plane_constants_are_checked():
    _, fwdt, step, q, cap = (torch.from_numpy(a) for a in _case(8, 1, 6))
    with pytest.raises(ValueError):
        TQPlane(fwdt, step[:, :32].contiguous(), q, cap)
    with pytest.raises(TypeError):
        TQPlane(fwdt, step, q.float(), cap)
    with pytest.raises(ValueError):
        TQPlane(fwdt.t(), step, q, cap)


def test_probe_col_step_takes_the_wrapper_once_per_column(monkeypatch):
    """The quality probe's first-row luma chain is the Pallas kernel's
    function per 16x16 column (product, quantize, dequantize from the
    carried edge pixel).  It runs in one part_chain call with the U and V
    chains (on the CPU its plain version), the probe no longer calls
    transform_quantize, and each column's levels are what
    transform_quantize_ref gives on that column's residual from the
    carried pixel: the frame's first block row.  The rows after the
    first are not run: the test reads row 0 alone."""
    from av1tpu.utils.yuv import synthetic_clip
    from av1tpu_torch.kernels.intra_part import part_chain
    from av1tpu_torch.models import intra_part
    from av1tpu_torch.models.intra_v import _plane_params
    from av1tpu_torch.state import tables

    calls = []

    def spy(jobs):
        calls.append(len(jobs))
        return part_chain(jobs)

    monkeypatch.setattr(intra_part, "part_chain", spy)
    monkeypatch.setattr(intra_part, "_luma_rows", lambda *a: None)
    monkeypatch.setattr(intra_part, "_chroma_rows", lambda *a: None)
    clip = synthetic_clip(128, 64, 1, seed=3)
    y, u, v = (torch.from_numpy(p[0].astype(np.int32))
               for p in (clip.y, clip.u, clip.v))
    before = (transform_quantize.launches, part_chain.launches)
    o = intra_part.encode_intra_part(y, u, v, 72)
    assert (transform_quantize.launches, part_chain.launches) == before
    assert calls == [3] and not hasattr(intra_part, "transform_quantize")
    step, q, cap = _plane_params(72, 16, 8, "cpu")
    plane = TQPlane(tables("cpu").fwdt(16, 0), step[None], q[None],
                    cap[None])
    edge = 127
    for c in range(128 // 16):
        resid = (y[:16, 16 * c:16 * c + 16] - edge).reshape(1, 256).to(
            torch.float32)
        rlv, _ = transform_quantize_ref(resid, plane)
        assert torch.equal(o["levels_y16"][0, c].reshape(1, 256), rlv)
        edge = int(o["recon_y"][0, 16 * c + 15])
    assert int(o["levels_y16"][0].abs().sum()) > 0
