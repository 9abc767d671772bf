"""The inter residual coder's plain version against the reference's.

code_blocks (kernels/inter_code.py), through its wrapper on CPU tensors
(the plain version), holds against av1tpu's residual coder at every site
of the partitioned inter step: `_code_nn` at 16 (luma), 8 (chroma and the
luma sub-blocks), 4 (the sub-blocks' chroma), 32 (luma, shift 1) and 16
and 32 (the merges' chroma), the TX_64X64 luma merge (its lines of
`_inter_partition`, with the rate on and off), and the fast preset's
`_code_plane_inter`.  Levels, recon and the integer SSE must be equal bit
for bit.  The rate and the skip SSE are float32 sums over a block's
coefficients and pixels, which PyTorch and eager XLA:CPU take in different
orders: they must be equal, or within the bound of a float32 sum of m
positive terms, m * 2^-24 of the value (m = the block's coded
coefficients or pixels).  They differ only where a block's sum is long and
inexact: the noise block's 256 to 1024 coded coefficients.

The reference functions run eagerly on a few blocks (no graph of a whole
stage is compiled: jitted alone, the 32- and 64-point coders compile for
3 to 12 s each, where their eager operations compile once per block shape
and every case here shares its size's shape).  The TX_64X64 case gives both sides one surrogate
forward matrix and gains row: the real ones are the pseudo-inverse of a
4096 x 1024 matrix (tens of seconds on the CPU) and are held bit for bit
by tests/test_torch_copies.py; the coder after the product is what is
tested here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from av1tpu.models import inter_v as jiv
from av1tpu.models.intra_v import _plane_params as j_plane_params
from av1tpu.models.intra_v import quantize_coefs as j_quantize
from av1tpu.models.rates import RateModel as JRateModel
from av1tpu.models.rates import qctx_index
from av1tpu.models.rdoq import coef_gains as j_gains
from av1tpu.models.rdoq import rd_zero as j_rd_zero
from av1tpu.ops.transforms_jax import forward_matrix as j_forward
from av1tpu.ops.transforms_jax import inverse_transform as j_inverse
from av1tpu_torch.kernels.inter_code import CodePlane, code_blocks
from av1tpu_torch.models import inter_v
from av1tpu_torch.models.intra_v import _plane_params
from av1tpu_torch.state import tables
from tests.test_torch_threads import single_torch_thread  # noqa: F401

CPU = torch.device("cpu")
# (n, plane type, the quant rows' size, dq_shift): the sites of
# _inter_partition's size table but TX_64X64
SITES = {"luma16": (16, 0, 16, 0), "chroma8": (8, 1, 8, 0),
         "luma_sub8": (8, 0, 8, 0), "chroma_sub4": (4, 1, 4, 0),
         "luma32": (32, 0, 32, 1), "chroma16_merge": (16, 1, 16, 0),
         "chroma32_merge": (32, 1, 32, 1)}


def _blocks(shape, bd, seed):
    """Source and clipped prediction blocks (int32 numpy): mostly small
    residuals, one block of noise and one saturating block (source at the
    top of the range, prediction at 0)."""
    rng = np.random.RandomState(seed)
    pm = (1 << bd) - 1
    src = rng.randint(0, pm + 1, shape)
    pred = np.clip(src + rng.randint(-6, 7, shape), 0, pm)
    flat_s = src.reshape(-1, *shape[-2:])
    flat_p = pred.reshape(-1, *shape[-2:])
    flat_p[1] = rng.randint(0, pm + 1, shape[-2:])
    flat_s[-1], flat_p[-1] = pm, 0
    return src.astype(np.int32), pred.astype(np.int32)


def _lam(q, bd):
    return inter_v.part_lambdas(q, bd, CPU)[0]


def _same(got, want, what, terms=0):
    """Equal bit for bit; a float32 sum of `terms` positive terms may also
    differ by the sum's error bound, terms * 2^-24 of its value."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if terms and not np.array_equal(got, want):
        np.testing.assert_allclose(got, want, rtol=terms * 2.0 ** -24,
                                   atol=0, err_msg=what)
        return
    assert np.array_equal(got, want), what


@pytest.mark.parametrize("site", sorted(SITES))
@pytest.mark.parametrize("bd,q,gate", [(8, 72, 4.0), (10, 40, None)])
def test_code_nn_matches_jax(site, bd, q, gate):
    n, ptype, quant_n, sh = SITES[site]
    src, pred = _blocks((2, 2, n, n), bd, seed=n + 7 * sh + bd)
    lam = _lam(q, bd)
    step, jq, cap = j_plane_params(q, quant_n, bd)
    fwd, rm, gains = (jnp.asarray(j_forward(n, n, 0)), JRateModel(n, ptype),
                      jnp.asarray(j_gains(n)))
    want = jiv._code_nn(jnp.asarray(src), jnp.asarray(pred), fwd,
                        step * (0.5 ** sh), jq, sh, cap, (1 << bd) - 1, rm,
                        qctx_index(q), jnp.float32(lam), gains,
                        None if gate is None else jnp.float32(gate))
    plane = inter_v._coder(q, bd, CPU, n, ptype, quant_n, sh, lam, gate,
                           True)
    got = inter_v._code_nn(torch.from_numpy(src), torch.from_numpy(pred),
                           tables(CPU).fwdt(n, 0), plane)
    cw = min(n, 32)
    for name, g, w, m in zip(("levels", "recon", "dist", "rate", "dskip"),
                             got, want, (0, 0, 0, cw * cw, n * n)):
        _same(g.numpy(), w, name, m)
    assert int((got[0] != 0).sum()) > 0        # something was coded


def _surrogate64(seed):
    """A (4096, 1024) forward matrix and (1024,) gains shared by both
    sides (scaled like the real ones: coefficients of a few hundred)."""
    rng = np.random.RandomState(seed)
    fwd = (rng.standard_normal((1024, 4096)) / 64).astype(np.float32)
    gains = (rng.rand(1024) * 0.5 + 0.75).astype(np.float32)
    return fwd, gains


@pytest.mark.parametrize("bd,q,gate,rate", [
    (8, 72, 4.0, True), (8, 72, None, False), (10, 40, None, True),
    (10, 160, 9.0, False)])
def test_tx64_matches_jax(bd, q, gate, rate):
    """The TX_64X64 luma merge: 32x32 levels quantized at a quarter step,
    rd_zero at a quarter dequant, sign(lv) * ((|lv| * q) >> 2) in the
    top-left of a 64x64 block, the 64-point inverse; the reference's lines
    of _inter_partition with its own functions."""
    src, pred = _blocks((1, 2, 64, 64), bd, seed=64 + bd + q)
    fwd, gains = _surrogate64(q)
    lam = _lam(q, bd)
    pm = (1 << bd) - 1
    qctx = int(qctx_index(q))
    rm = JRateModel(64, 0)
    step32, q32, cap32 = j_plane_params(q, 32, bd)

    def ref(s64, p64, lam, gate):
        """The reference's TX_64X64 lines (av1tpu/models/inter_v.py:
        1236-1250)."""
        resid64 = (s64 - p64).reshape(-1, 4096).astype(jnp.float32)
        coef64 = resid64 @ jnp.asarray(fwd).T
        lv64 = j_quantize(coef64, step32 * 0.25, cap32)
        lv64 = j_rd_zero(lv64, coef64, q32.astype(jnp.float32) * 0.25, lam,
                         rm.tabs[qctx], jnp.asarray(gains), noise_gate=gate)
        dq64 = jnp.sign(lv64) * ((jnp.abs(lv64) * q32) >> 2)
        full = jnp.zeros((2, 64, 64), jnp.int32).at[:, :32, :32].set(
            dq64.reshape(-1, 32, 32))
        rec64 = jnp.clip(p64.reshape(-1, 64, 64)
                         + j_inverse(full, 64, 64, 0), 0, pm)
        d64 = jnp.sum((rec64 - s64.reshape(-1, 64, 64)) ** 2,
                      axis=(1, 2)).astype(jnp.float32)
        lv64 = lv64.reshape(1, 2, 32, 32)
        return (lv64, rec64.reshape(1, 2, 64, 64), d64.reshape(1, 2),
                rm(lv64, qctx), jnp.sum(resid64 ** 2, axis=1).reshape(1, 2))

    want = ref(jnp.asarray(src), jnp.asarray(pred), jnp.float32(lam),
               None if gate is None else jnp.float32(gate))

    step, tq, cap = _plane_params(q, 32, bd, CPU)
    rm_t = tables(CPU).rate_model(64, 0)
    rate_rows = (dict(skip=rm_t.skip[qctx], rank=rm_t.rank.contiguous(),
                      eob=rm_t.eob[qctx]) if rate else {})
    plane = CodePlane(n=64, step=step * 0.25, q=tq, cap=cap,
                      gains=torch.from_numpy(gains), tab=rm_t.tabs[qctx],
                      lam=lam, gate=gate, dq_shift=2, bit_depth=bd,
                      **rate_rows)
    s, p = torch.from_numpy(src), torch.from_numpy(pred)
    coefs = (s - p).reshape(-1, 4096).to(torch.float32) @ torch.from_numpy(
        fwd).T
    lv, rec, dist, r, dskip = code_blocks(coefs, s.reshape(-1, 64, 64),
                                          p.reshape(-1, 64, 64), plane)
    _same(lv.reshape(1, 2, 32, 32).numpy(), want[0], "levels")
    _same(rec.reshape(1, 2, 64, 64).numpy(), want[1], "recon")
    _same(dist.reshape(1, 2).numpy(), want[2], "dist")
    _same(dskip.reshape(1, 2).numpy(), want[4], "dskip", 4096)
    if rate:
        _same(r.reshape(1, 2).numpy(), want[3], "rate", 1024)
    else:
        assert r is None
    assert int((lv != 0).sum()) > 0


@pytest.mark.parametrize("n,ptype,bd,q", [(16, 0, 8, 72), (8, 1, 10, 120)])
def test_code_plane_inter_matches_jax(n, ptype, bd, q):
    """The fast preset's coder: rd_zero with the rate row, no rate, no
    gate, no shift."""
    src, pred = _blocks((2, 2, n, n), bd, seed=n + bd)
    _, lamp = inter_v.inter_lambdas(q, bd, CPU)
    rm = JRateModel(n, ptype)
    want = jiv._code_plane_inter(jnp.asarray(src), jnp.asarray(pred), q, n,
                                 bd, rm, qctx_index(q), jnp.float32(lamp))
    plane = inter_v._coder(q, bd, CPU, n, ptype, n, 0, lamp, None, False)
    got = inter_v._code_plane_inter(torch.from_numpy(src),
                                    torch.from_numpy(pred), plane)
    for name, g, w, m in zip(("levels", "recon", "dist", "dskip"), got,
                             want, (0, 0, 0, n * n)):
        _same(g.numpy(), w, name, m)
