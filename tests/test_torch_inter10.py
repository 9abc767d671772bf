"""10-bit port parity for the inter pipeline (search, chroma MC,
encode_inter_v, compact buffer, deblocked + CDEF'd recon), on the chain of
tests/test_torch_inter.py.  A file of its own: the 10-bit JAX graph is a
second compile."""

import numpy as np
import pytest
import torch

from tests.test_torch_inter import run_chain
from tests.test_torch_threads import single_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def chain10():
    return run_chain(10, 120, seed=57)


@pytest.mark.parametrize("k", [0, 1])
@pytest.mark.parametrize("key", ["mv8", "pred_y", "pred_u", "pred_v", "buf",
                                 "new_ref"])
def test_inter_10bit_matches_jax(chain10, k, key):
    want, got = chain10[k]
    assert np.array_equal(got[key].numpy(), want[key]), key


@pytest.mark.parametrize("k", [0, 1])
def test_encode_inter_v_10bit_matches_jax(chain10, k):
    want, got = chain10[k]
    for name, w in want["inter"].items():
        g = got["inter"][name]
        assert g.numpy().dtype == w.dtype, name
        assert np.array_equal(g.numpy(), w), name
