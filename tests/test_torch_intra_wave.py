"""The wavefront keyframe's host-side pieces: the scalar lambdas carry the
reference's bits, and the schedule and availability grids equal the
reference's.  The encode itself (every level, mode, tx depth and recon
pixel, through encode_intra_wave_key_recon's buffer, its split and the
fused recon, at two q, with and without the RDOQ noise gate) is held at
64x128 in tests/test_torch_a_slice_quality.py, which has the reference's
wavefront graph compiled already: a second compile of it here cost the
suite minutes when its workers share the cores."""

import jax.numpy as jnp
import numpy as np
import pytest

from av1tpu.models import intra_wave as ref
from av1tpu_torch.models import intra_wave as port
from tests.test_torch_threads import single_torch_thread  # noqa: F401


@pytest.mark.parametrize("q,bd,ls", [(q, bd, ls) for q in (1, 60, 133, 255)
                                     for bd in (8, 10)
                                     for ls in (1.0, 0.3)][::2])
def test_wave_lambdas_bits(q, bd, ls):
    """The host's float32 lambdas carry the bits of the compiled
    reference's (constant factors folded into one)."""
    import functools

    import jax

    from av1tpu.models.intra_v import _plane_params

    @functools.partial(jax.jit, static_argnames=("bd", "ls"))
    def lambdas(qi, bd, ls):
        ac = _plane_params(qi, 16, bd)[0][1]
        lam = (ac * ac * 0.0234 * ls).astype(jnp.float32)
        return lam, jnp.zeros(3) + lam * 1.42

    want = lambdas(q, bd, ls)
    got = port.wave_lambdas(q, bd, ls, "cpu")
    assert np.float32(want[0]) == got[0]
    assert np.float32(np.asarray(want[1])[0]) == got[1]


@pytest.mark.parametrize("rows,cols", [(4, 8), (8, 12), (68, 120), (5, 3)])
def test_schedule_and_grids_match_reference(rows, cols):
    for a, b in zip(port._diagonals(rows, cols), ref._diagonals(rows, cols)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    r_i, c_i, valid = port._diagonals(rows, cols)
    # every block exactly once, valid lanes first in each diagonal
    seen = np.zeros((rows, cols), np.int32)
    np.add.at(seen, (r_i[valid], c_i[valid]), 1)
    assert (seen == 1).all()
    assert (np.diff(valid.astype(np.int8), axis=1) <= 0).all()
    assert np.array_equal(port._ur_avail_grid(rows, cols),
                          ref._ur_avail_grid(rows, cols))
    assert np.array_equal(port._bl_avail_grid(rows, cols),
                          ref._bl_avail_grid(rows, cols))
