"""Fused forward transform + quantize + dequantize: CUDA kernel and plain version.

Port of the Pallas TPU kernel av1tpu/kernels/transform_quant.py
(`_tq_kernel`, launched by `pl.pallas_call` at :64).  The hand kernel lives
in av1tpu_torch/csrc/transform_quant.cu (built for sm_90a by
av1tpu_torch._build); the source note there states its design and what
bounds it.

A plane's constants (fwdt, step, q, cap) are checked once, into a
`TQPlane`; each `transform_quantize` call then checks only its residual
rows.  The wrapper takes the plain PyTorch version only for tensors on the
CPU.  A CUDA tensor always launches the kernel, and anything the kernel
does not take raises: there is no fallback.
"""

from __future__ import annotations

import torch

from av1tpu_torch.state import tables

STRIP = 32            # the kernel's coefficient columns per block
CUDA_N2 = (64, 256)   # the kernel's transform sizes: 8x8 and 16x16


def _check(name, t, dtype, shape, device):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: expected shape {shape}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


class TQPlane:
    """The per-plane constants of transform_quantize, checked once.

    fwdt: (N2, N2) float32, transposed so that coefs = resid @ fwdt; step:
    (1, N2) float32; q, cap: (1, N2) int32; all contiguous on one device.
    On CUDA, N2 must be 64 or 256, and the bundle also holds fwdt cut into
    32-column strips, each contiguous, so that the kernel copies a block's
    strip with one bulk copy."""

    def __init__(self, fwdt: torch.Tensor, step: torch.Tensor,
                 q: torch.Tensor, cap: torch.Tensor):
        if fwdt.dim() != 2:
            raise ValueError(f"fwdt must be 2-D, got {tuple(fwdt.shape)}")
        n2 = fwdt.shape[1]
        dev = fwdt.device
        _check("fwdt", fwdt, torch.float32, (n2, n2), dev)
        _check("step", step, torch.float32, (1, n2), dev)
        _check("q", q, torch.int32, (1, n2), dev)
        _check("cap", cap, torch.int32, (1, n2), dev)
        self.fwdt, self.step, self.q, self.cap = fwdt, step, q, cap
        self.n2, self.device = n2, dev
        # the plain version's offsets row, a device constant, so that the
        # plain version never waits for the stream
        self.off = tables(dev).q_offsets(n2)
        if dev.type == "cpu":
            return
        if dev.type != "cuda":
            raise ValueError(f"unsupported device {dev}")
        if n2 not in CUDA_N2:
            raise ValueError(f"the kernel takes N2 in {CUDA_N2}, got {n2}")
        from av1tpu_torch._build import cuda_lib
        from av1tpu_torch.models.intra_v import Q_OFFSET, Q_OFFSET_DC

        self.strips = fwdt.reshape(n2, n2 // STRIP, STRIP).transpose(
            0, 1).contiguous()
        self._launch = cuda_lib().av1_transform_quantize
        self._consts = (self.strips.data_ptr(), step.data_ptr(),
                        q.data_ptr(), cap.data_ptr())
        self._offsets = (Q_OFFSET_DC, Q_OFFSET)


def transform_quantize_ref(resid: torch.Tensor, plane: TQPlane):
    """Plain version: coefs = resid @ fwdt, then the deadzone quantizer of
    intra_v.quantize_coefs.  Returns (levels int16 (B, N2), dq int32 (B,
    N2))."""
    from av1tpu_torch.models.intra_v import quantize_with_offsets

    coefs = resid @ plane.fwdt
    lv = quantize_with_offsets(coefs, plane.step.reshape(-1),
                               plane.cap.reshape(-1), plane.off)
    return lv.to(torch.int16), lv * plane.q.reshape(-1)


def transform_quantize(resid: torch.Tensor, plane: TQPlane):
    """resid: (B, N2) float32 residual rows, B >= 1, contiguous and 16-byte
    aligned on CUDA; plane: the TQPlane of their plane(s).  Returns (levels
    int16 (B, N2), dq int32 (B, N2))."""
    if resid.device.type == "cpu":
        return transform_quantize_ref(resid, plane)
    if resid.device != plane.device:
        raise ValueError(f"resid on {resid.device}, the plane's constants "
                         f"on {plane.device}")
    if resid.dtype != torch.float32:
        raise TypeError(f"resid: expected torch.float32, got {resid.dtype}")
    if resid.dim() != 2 or resid.shape[0] == 0 or resid.shape[1] != plane.n2:
        raise ValueError(f"resid: expected (B >= 1, {plane.n2}), got "
                         f"{tuple(resid.shape)}")
    if not resid.is_contiguous() or resid.data_ptr() % 16:
        raise ValueError("resid: must be contiguous and 16-byte aligned")
    dev = plane.device
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"resid on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    b, n2 = resid.shape
    lv = torch.empty((b, n2), dtype=torch.int16, device=dev)
    dq = torch.empty((b, n2), dtype=torch.int32, device=dev)
    err = plane._launch(resid.data_ptr(), *plane._consts, lv.data_ptr(),
                        dq.data_ptr(), b, n2, *plane._offsets,
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"transform_quantize kernel launch failed: "
                           f"cudaError {err}")
    transform_quantize.launches += 1
    return lv, dq


transform_quantize.launches = 0


def count_level_flips(lv: torch.Tensor, dq: torch.Tensor,
                      lv_ref: torch.Tensor, resid: torch.Tensor,
                      fwdt: torch.Tensor, step: torch.Tensor,
                      q: torch.Tensor) -> int:
    """Hold kernel output (lv, dq) against the plain version's lv_ref.

    Summation orders differ between the kernel, cuBLAS and CPU BLAS, so a
    level may flip where |c|/step + off lands on an integer.  With a
    float64 product as arbiter, every level that differs must differ by
    exactly 1 in magnitude and have |c64|/step + off within 1e-4 of an
    integer; dq == lv * q must hold exactly.  Returns the number of flips,
    raises AssertionError on anything else."""
    from av1tpu_torch.models.intra_v import Q_OFFSET, Q_OFFSET_DC

    lv32 = lv.to(torch.int32).cpu()
    ref32 = lv_ref.to(torch.int32).cpu()
    q_c = q.reshape(1, -1).cpu()
    if not torch.equal(dq.cpu(), lv32 * q_c):
        raise AssertionError("dq != lv * q")
    diff = lv32 != ref32
    n = int(diff.sum())
    if n == 0:
        return 0
    if not bool(((lv32.abs() - ref32.abs()).abs()[diff] == 1).all()):
        raise AssertionError("a level differs by more than 1 in magnitude")
    c64 = resid.double().cpu() @ fwdt.double().cpu()
    off = torch.full((c64.shape[1],), Q_OFFSET, dtype=torch.float64)
    off[0] = Q_OFFSET_DC
    x = c64.abs() / step.reshape(1, -1).double().cpu() + off
    dist = (x - torch.round(x)).abs()
    if not bool((dist[diff] <= 1e-4).all()):
        raise AssertionError("a level differs away from a rounding "
                             "boundary")
    return n
