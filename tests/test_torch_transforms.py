"""Port parity: av1tpu_torch.ops.transforms.inverse_transform equals the
JAX butterflies (av1tpu/ops/transforms_jax.py) bit for bit on random
levels, at every block size and transform type the pipelines emit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.ops.transforms_jax import inverse_transform as jax_inverse
from av1tpu_torch.ops.transforms import inverse_transform
from tests.test_torch_threads import single_torch_thread  # noqa: F401

CASES = ([(n, 0) for n in (4, 8, 16, 32, 64)]
         + [(n, t) for n in (4, 8, 16) for t in (1, 2, 3)])


@pytest.mark.parametrize("n,tx_type", CASES)
def test_inverse_transform_matches_jax(n, tx_type):
    rng = np.random.RandomState(100 * n + tx_type)
    # dequantized magnitudes of the pipelines' range (levels x q, capped)
    coefs = rng.randint(-4096, 4097, size=(6, n, n)).astype(np.int32)
    coefs[0] = 0
    coefs[1, 0, 0] = 65536            # a lone DC at the cap
    want = np.asarray(jax_inverse(jnp.asarray(coefs), n, n, tx_type))
    got = inverse_transform(torch.from_numpy(coefs), n, n, tx_type)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_inverse_transform_rejects_other_dtypes():
    with pytest.raises(TypeError):
        inverse_transform(torch.zeros((1, 8, 8), dtype=torch.int64), 8, 8)
