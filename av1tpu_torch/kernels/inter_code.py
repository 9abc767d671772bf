"""The inter step's residual coder after the forward product: CUDA kernel
and plain version.

Port of the jitted residual coding of av1tpu/models/inter_v.py (`_code_nn`,
:1022; the TX_64X64 luma merge, :1236-1250; the fast preset's
`_code_plane_inter`, :852; not a `pallas_call`).  `code_blocks` takes the
forward product's coefficients (a cuBLAS matmul in the caller, as the JAX
package leaves it to XLA) and codes each block: the deadzone quantize,
rdoq.rd_zero, the dequantize, the integer inverse transform, the recon clip,
the SSE, the skip SSE and, where asked, the RateModel bits.

The hand kernel lives in av1tpu_torch/csrc/inter_code.cu (built for sm_90a
by av1tpu_torch._build); the note at its top states its design and what
bounds it.  A size's constants are checked once, into a `CodePlane`; each
call then checks only its blocks.  The wrapper takes the plain version only
for tensors on the CPU.  A CUDA tensor always launches the kernel, and
anything the kernel does not take raises: there is no fallback.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from av1tpu_torch.kernels.transform_quant import _check

SIZES = (4, 8, 16, 32, 64)
# csrc/inter_code.cu's launch layout: transform blocks per CTA of
# CODE_THREADS threads at each size (measured: PERF.md, code_blocks per
# site)
CODE_BLOCKS_PER_CTA = {4: 64, 8: 32, 16: 8, 32: 2, 64: 2}
CODE_THREADS = 256
SMEM_PER_CTA_MAX = 232_448     # an H100 CTA's shared memory, in bytes


def code_layout(n: int, nblocks: int) -> dict:
    """The launch of code_blocks on nblocks blocks of n x n, as
    csrc/inter_code.cu's Layout<n> builds it: its CTAs, blocks and threads
    per CTA, and shared bytes per CTA.  Dynamic: the inverse's buffer (nb
    blocks of n rows of n + 1 words) and the coefficients' and levels'
    (nb x cw x cw words).  Static: the reduction scratch (a word per warp
    and block of a thread where a block spans warps, n >= 8) and five
    words per block, rounded up to 16 bytes."""
    nb = CODE_BLOCKS_PER_CTA[n]
    per_block = min(min(n, 32) ** 2, CODE_THREADS)   # threads per block
    dynamic = 4 * nb * (n * (n + 1) + min(n, 32) ** 2)
    red = nb * per_block // 32 if per_block > 32 else 0
    static = -(-4 * (red + 5 * nb) // 16) * 16     # in 16-byte units
    return {"ctas": -(-nblocks // nb), "blocks_per_cta": nb,
            "threads": CODE_THREADS, "dynamic_smem": dynamic,
            "static_smem": static, "smem": dynamic + static}


class CodeTabsC(ctypes.Structure):
    """The kernel's view of a CodePlane, in the order of `struct CodeTabs`
    in csrc/inter_code.cu."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "step", "dq_scale", "off", "gain", "q", "cap", "tab", "skip", "eob",
        "rank")] + [
        ("lam", ctypes.c_float), ("gate", ctypes.c_float),
        ("n", ctypes.c_int), ("dq_shift", ctypes.c_int),
        ("has_gate", ctypes.c_int), ("with_rate", ctypes.c_int),
        ("pix_max", ctypes.c_int)]


class CodePlane:
    """The constants of one coder site, checked once.

    n: the block size in pixels (4 to 64); the coded levels are cw x cw,
    cw = min(n, 32) (TX_64X64 codes its top-left 32x32).  Tensors, each
    (cw*cw,) and contiguous on one device: step (float32, any downscale
    folded in), q and cap (int32), gains (float32, rdoq.coef_gains).
    Rate rows of the frame's quality bucket: tab (256,) float32, the bits
    per magnitude (rd_zero reads it too); with_rate adds skip (2,), rank
    (cw, cw) int32 and eob (cw*cw + 1,) float32 (RateModel's rows), and
    the call returns the bits.  lam: the pixel-domain lambda as a numpy
    float32; gate: rd_zero's noise gate (a real number, compared in
    float32 as PyTorch compares a tensor with a Python float) or None;
    dq_shift: the dequantize's right shift (0, 1 at 32x32, 2 for
    TX_64X64); bit_depth 8 or 10.  The bundle
    also holds the deadzone offsets row and rd_zero's dequant scale row
    (q * 2^-dq_shift) as constants, so that no call writes a row."""

    def __init__(self, *, n: int, step, q, cap, gains, tab, lam, gate,
                 dq_shift: int, bit_depth: int, skip=None, rank=None,
                 eob=None):
        from av1tpu_torch.state import tables

        if n not in SIZES:
            raise ValueError(f"n must be one of {SIZES}, got {n}")
        if bit_depth not in (8, 10):
            raise ValueError(f"bit_depth must be 8 or 10, got {bit_depth}")
        if dq_shift not in (0, 1, 2):
            raise ValueError(f"dq_shift must be 0, 1 or 2, got {dq_shift}")
        if not isinstance(lam, np.float32):
            raise TypeError("lam: expected a numpy float32 value, got "
                            f"{type(lam).__name__}")
        cw = min(n, 32)
        nc = cw * cw
        dev = step.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        for name, t, dtype in (("step", step, torch.float32),
                               ("q", q, torch.int32),
                               ("cap", cap, torch.int32),
                               ("gains", gains, torch.float32)):
            _check(name, t, dtype, (nc,), dev)
        _check("tab", tab, torch.float32, (256,), dev)
        self.with_rate = skip is not None
        if self.with_rate:
            _check("skip", skip, torch.float32, (2,), dev)
            _check("rank", rank, torch.int32, (cw, cw), dev)
            _check("eob", eob, torch.float32, (nc + 1,), dev)
        elif rank is not None or eob is not None:
            raise ValueError("rank and eob come with skip (the rate rows)")
        self.n, self.cw, self.dq_shift = n, cw, dq_shift
        self.step, self.q, self.cap, self.gains, self.tab = (step, q, cap,
                                                             gains, tab)
        self.skip, self.rank, self.eob = skip, rank, eob
        self.lam, self.bit_depth = lam, bit_depth
        self.gate = None if gate is None else float(gate)
        self.pix_max = (1 << bit_depth) - 1
        self.device = dev
        self.off = tables(dev).q_offsets(nc)
        self.dq_scale = q.to(torch.float32) * (0.5 ** dq_shift)
        if dev.type == "cpu":
            return
        from av1tpu_torch._build import cuda_lib

        self._launch = cuda_lib().av1_code_blocks
        ptrs = dict(step=step, dq_scale=self.dq_scale, off=self.off,
                    gain=gains, q=q, cap=cap, tab=tab, skip=skip, eob=eob,
                    rank=rank)
        self.c = CodeTabsC(
            **{k: (t.data_ptr() if t is not None else None)
               for k, t in ptrs.items()},
            lam=float(lam), gate=0.0 if gate is None else self.gate, n=n,
            dq_shift=dq_shift, has_gate=int(gate is not None),
            with_rate=int(self.with_rate), pix_max=self.pix_max)
        self.c_ptr = ctypes.addressof(self.c)


def code_blocks_plain(coefs, src, pred, plane: CodePlane):
    """Plain version of code_blocks: the residual coding of _code_nn after
    the forward product.  Returns (levels int32 (B, cw, cw), recon int32
    (B, n, n), dist float32 (B,), rate float32 (B,) or None without the
    rate rows, dskip float32 (B,))."""
    from av1tpu_torch.models.intra_v import quantize_with_offsets
    from av1tpu_torch.models.rates import coef_bits
    from av1tpu_torch.models.rdoq import rd_zero
    from av1tpu_torch.ops.transforms import inverse_transform

    n, cw, sh = plane.n, plane.cw, plane.dq_shift
    resid = (src - pred).reshape(-1, n * n).to(torch.float32)
    lv = quantize_with_offsets(coefs, plane.step, plane.cap, plane.off)
    lv = rd_zero(lv, coefs, plane.dq_scale, float(plane.lam), plane.tab,
                 plane.gains, noise_gate=plane.gate)
    dq = lv * plane.q
    if sh:
        dq = torch.sign(dq) * (dq.abs() >> sh)
    dq = dq.reshape(-1, cw, cw)
    if cw < n:          # TX_64X64: the coded 32x32 in the top-left
        full = torch.zeros((dq.shape[0], n, n), dtype=torch.int32,
                           device=dq.device)
        full[:, :cw, :cw] = dq
        dq = full
    r = inverse_transform(dq, n, n, 0)
    rec = torch.clamp(pred.reshape(-1, n, n) + r, 0, plane.pix_max)
    e = rec - src.reshape(-1, n, n)
    # summed in int32, wrapping as the reference's jnp.sum does (only a
    # 10-bit 64x64 block with an SSE of 2^31 or more wraps)
    dist = (e * e).sum(dim=(1, 2), dtype=torch.int32).to(torch.float32)
    dskip = (resid * resid).sum(dim=1)
    lv = lv.reshape(-1, cw, cw)
    rate = (coef_bits(lv, plane.tab, plane.skip, plane.rank, plane.eob)
            if plane.with_rate else None)
    return lv, rec, dist, rate, dskip


def code_blocks(coefs, src, pred, plane: CodePlane):
    """coefs: (B, cw*cw) float32, the forward product's coefficients of B
    blocks (B >= 1); src, pred: (B, n, n) int32 (pred already pixel-clipped,
    so the skip SSE is the recon-equals-prediction distortion); all
    contiguous on the plane's device.  Returns code_blocks_plain's
    outputs."""
    dev, n, cw = plane.device, plane.n, plane.cw
    if coefs.dim() != 2 or coefs.shape[0] == 0:
        raise ValueError(f"coefs: expected (B >= 1, {cw * cw}), got "
                         f"{tuple(coefs.shape)}")
    b = coefs.shape[0]
    _check("coefs", coefs, torch.float32, (b, cw * cw), dev)
    _check("src", src, torch.int32, (b, n, n), dev)
    _check("pred", pred, torch.int32, (b, n, n), dev)
    if dev.type == "cpu":
        return code_blocks_plain(coefs, src, pred, plane)
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"blocks on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    lv = torch.empty((b, cw, cw), dtype=torch.int32, device=dev)
    rec = torch.empty((b, n, n), dtype=torch.int32, device=dev)
    dist, rate, dskip = (torch.empty(b, dtype=torch.float32, device=dev)
                         for _ in range(3))
    err = plane._launch(plane.c_ptr, coefs.data_ptr(), src.data_ptr(),
                        pred.data_ptr(), b, lv.data_ptr(), rec.data_ptr(),
                        dist.data_ptr(), rate.data_ptr(), dskip.data_ptr(),
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"code_blocks kernel launch failed: cudaError "
                           f"{err}")
    code_blocks.launches += 1
    return lv, rec, dist, rate if plane.with_rate else None, dskip


code_blocks.launches = 0
