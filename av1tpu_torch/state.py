"""Device constants and the running state an encode carries.

An encoder has no learned weights: what it carries is constant tables (quant
rows, forward transform matrices, sub-pel filter banks, the CDEF direction
matrix, CDF-derived rate tables) plus the running state of a GOP chunk (the
fused reference recon, the previous MV field, the scene's CDEF strengths).
`tables(device)` makes every constant once per device with the port's
numpy table functions (copies of the JAX package's); `carry_from_numpy` turns
state produced elsewhere (for instance by the JAX reference) into the
port's tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from av1tpu_torch.spec import tables as spec_tables


class Tables:
    """Constant tensors on one device, built lazily and kept."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._cache: dict = {}

    def _get(self, key, build):
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    def _t(self, a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=self.device)

    def quant_rows(self, bit_depth: int):
        """(dc_q, ac_q) numpy int32 rows indexed by qindex (host lookups:
        qindex is a host int in the port)."""
        def build():
            q = spec_tables.quant()
            return (np.asarray(q[f"dc_q_{bit_depth}"], np.int32),
                    np.asarray(q[f"ac_q_{bit_depth}"], np.int32))
        return self._get(("quant", bit_depth), build)

    def fwdt(self, n: int, tx_type: int = 0) -> torch.Tensor:
        """(n*n, n*n) float32 transposed forward matrix (coefs = r @ fwdt)."""
        from av1tpu_torch.ops.transforms import forward_matrix
        return self._get(("fwdt", n, tx_type), lambda: self._t(
            forward_matrix(n, n, tx_type).T, torch.float32))

    def fwd64t(self) -> torch.Tensor:
        """(4096, 1024) float32: transposed TX_64X64 forward matrix over
        the 1024 coded coefficients (coefs = r @ fwd64t)."""
        from av1tpu_torch.ops.transforms import fwd64
        return self._get("fwd64t", lambda: self._t(fwd64().T, torch.float32))

    def subpel_bank4(self) -> torch.Tensor:
        """(16, 8) int32 4-tap regular bank (zero taps 0, 1, 6, 7), for
        prediction blocks with a dimension <= 4."""
        return self._get("subpel4", lambda: self._t(
            spec_tables.subpel_filters()["regular_4"], torch.int32))

    def subpel_bank(self) -> torch.Tensor:
        """(16, 8) int32 EIGHTTAP-regular bank."""
        return self._get("subpel", lambda: self._t(self.subpel_bank_np(),
                                                   torch.int32))

    def subpel_bank_np(self) -> np.ndarray:
        """The same bank as numpy (taps read on the host)."""
        return self._get("subpel_np", lambda: np.asarray(
            spec_tables.subpel_filters()["regular"], np.int32))

    def cdef_dirs(self):
        """((64, 90) float32 0/1 bin assignment, (90,) int32 weights)."""
        from av1tpu_torch.models.cdef import dir_tables

        def build():
            a, w = dir_tables()
            return self._t(a, torch.float32), self._t(w, torch.int32)
        return self._get("cdef_dirs", build)

    def q_offsets(self, n2: int) -> torch.Tensor:
        """(n2,) float32 deadzone rounding offsets, the DC one first."""
        from av1tpu_torch.models.intra_v import Q_OFFSET, Q_OFFSET_DC

        def build():
            off = np.full((n2,), Q_OFFSET, np.float32)
            off[0] = Q_OFFSET_DC
            return self._t(off, torch.float32)
        return self._get(("q_offsets", n2), build)

    def coef_gains(self, n: int, tx_type: int = 0) -> torch.Tensor:
        from av1tpu_torch.models.rdoq import coef_gains
        return self._get(("gains", n, tx_type), lambda: self._t(
            coef_gains(n, tx_type), torch.float32))

    def rate_model(self, n: int, ptype: int):
        """The RateModel of one transform size / plane type on this
        device."""
        from av1tpu_torch.models.rates import RateModel
        return self._get(("rm", n, ptype),
                         lambda: RateModel(n, ptype, self.device))

    def const(self, key, build):
        """A module's own constant tensors on this device: `build(device)`
        runs once per key."""
        return self._get(("const", key), lambda: build(self.device))

    def rate_tabs(self, n: int, ptype: int) -> torch.Tensor:
        """(4, 256) float32 coefficient-magnitude bits per quality bucket."""
        from av1tpu_torch.models.rates import coef_rate_tables
        from av1tpu_torch.spec.enums import tx_size_ctx
        tx = {4: 0, 8: 1, 16: 2, 32: 3, 64: 4}[n]
        return self._get(("rate", n, ptype), lambda: self._t(
            coef_rate_tables(tx_size_ctx(tx), ptype), torch.float32))


@functools.cache
def _tables(device_str: str) -> Tables:
    return Tables(torch.device(device_str))


def tables(device) -> Tables:
    """The shared constant tables for `device` (built once per device)."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return _tables(str(d))


def carry_from_numpy(ref_fused, prev_mv, cdef_s, device):
    """Running GOP state from numpy arrays (e.g. JAX outputs) to the port's
    types: (ref_fused int32 (n_pix,), prev_mv int32 (rows, cols, 2) or None,
    cdef_s tuple of 4 Python ints or None)."""
    ref = torch.tensor(np.asarray(ref_fused, np.int32), device=device)
    mv = (None if prev_mv is None else
          torch.tensor(np.asarray(prev_mv, np.int32), device=device))
    cs = None if cdef_s is None else tuple(int(x) for x in
                                           np.asarray(cdef_s).ravel())
    return ref, mv, cs
