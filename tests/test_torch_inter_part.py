"""Host-side pieces of the quality preset's partitioned inter step: every
scalar lambda and penalty carries the bits of the compiled reference's
value, pack_bits wraps bit 15 as the reference's uint16 bitcast does, and
stable_partition is the reference's stable key sort.

The step itself (the search with the temporal MV base, the 8x8 sub-block
stage, the partition and skip RDO, GOLDEN, the loop filters, the prefix
transport and the carried recon and MV field) is held through
encode_gop_chunk_part in tests/test_torch_slice_quality.py, which has the
reference's chunk graph compiled already: inside that 4-frame chunk frames
2 to 4 search with the carried MV field of the frame before.  Frame-level
compares of _search_mv(prev_mv=...), _sub8_stage, _inter_partition and
encode_inter_part (8- and 10-bit) passed while this port was written and
were cut from the suite for its time limit: each costs the reference a
compile of one to two minutes alone."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.models import inter_v as ref
from av1tpu.models.intra_v import _plane_params
from av1tpu_torch.models import inter_v as port
from av1tpu_torch.models.intra_v import pack_bits, stable_partition
from tests.test_torch_threads import single_torch_thread  # noqa: F401


@pytest.mark.parametrize("q,bd", [(q, bd) for q in (1, 40, 90, 133, 255)
                                  for bd in (8, 10)])
def test_inter_lambdas_bits(q, bd):
    """Every scalar lambda and penalty of the partitioned step carries the
    bits of the compiled reference's value (constant factors folded)."""
    @functools.partial(jax.jit, static_argnames=("bd",))
    def lambdas(qi, bd):
        ac = _plane_params(qi, 16, bd)[0][1]
        lam_s = (ac * ac * 0.0234) ** 0.5
        lam_full = (ac * ac * 0.0234).astype(jnp.float32)
        lam = (lam_full * ref._REF_LAM_SCALE).astype(jnp.float32)
        z = jnp.zeros(2)
        return (lam_s, z + lam_s * ref._MV_BIAS * 4.0,
                z + lam_s * ref._MV_BIAS * 6.0, lam_full, lam,
                z + lam * ref._SPLIT_OVERHEAD_BITS)

    w = [np.float32(np.asarray(x).ravel()[0]) for x in lambdas(q, bd)]
    lam_s, _ = port.inter_lambdas(q, bd, "cpu")
    fold = port.fold_consts
    assert w[0] == lam_s
    assert w[1] == np.float32(lam_s * fold(port._MV_BIAS, 4.0))
    assert w[2] == np.float32(lam_s * fold(port._MV_BIAS, 6.0))
    assert tuple(w[3:]) == port.part_lambdas(q, bd, "cpu")


def test_pack_bits_wraps_bit_15():
    b = torch.zeros(40, dtype=torch.bool)
    b[15] = True          # word 0: only bit 15 -> -32768
    b[16:32] = True       # word 1: all ones -> -1
    b[33] = True          # word 2 (padded): bit 1
    got = pack_bits(b).numpy()
    assert got.dtype == np.int16 and got.tolist() == [-32768, -1, 2]
    assert got.view(np.uint16).tolist() == [0x8000, 0xFFFF, 2]


def test_stable_partition_is_the_stable_key_sort():
    rng = np.random.RandomState(9)
    stream = rng.randint(-300, 300, size=5000).astype(np.int16)
    keep = rng.rand(5000) < 0.3
    key = jnp.where(jnp.asarray(keep), jnp.arange(5000, dtype=jnp.int32),
                    jnp.int32(0x7FFFFFFF))
    _, want = jax.lax.sort((key, jnp.asarray(stream)), num_keys=1)
    got = stable_partition(torch.from_numpy(stream), torch.from_numpy(keep))
    assert np.array_equal(got.numpy(), np.asarray(want))
