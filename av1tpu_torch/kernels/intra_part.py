"""The quality preset's partition probe: four CUDA kernels and their plain
versions.

Port of the jitted probe of av1tpu/models/intra_part.py (`encode_intra_part`,
:639; not a `pallas_call`).  models/intra_part.py drives the stages; each
stage is one call of these wrappers, with a list of jobs (every site the
stage codes, U and V together):

- `part_chain`: the first block row's serial chains (luma 16x16, U and V
  8x8 ADST_DCT), a cluster of CHAIN_CL CTAs per plane;
- `part_pred`: a stage's candidate predictions and residuals from the row
  above (V, D45, D67 at the luma 16 and 32 sites; V_PRED elsewhere), a
  flat grid of CTAs that each build every candidate of their columns;
- `part_code`: after the forward product (a matmul in the caller, as the
  JAX package leaves it to XLA), the quantize, rd_zero, the mode RDO, the
  dequantize, the inverse, the recon and the site's cost;
- `part_merge`: one half of a superblock row's split decisions (and after
  the second half the 64's), the losers' levels zeroed, the winner's recon
  in the frame, a cluster of MERGE_CL CTAs per superblock column.

part_pred and part_merge launch with programmatic stream serialization:
each may start while the previous kernel of the stream still runs, and
reads what that kernel writes only after it waits for it.  Before the
wait part_pred reads its source band, part_merge the luma source band,
the big site's recon band and cost and the first half's region costs: the
caller must not have those written by a kernel still running, which on
the probe's path holds (each was written before the stream's previous
kernel, which launches without the attribute or waits in turn).

The hand kernels live in av1tpu_torch/csrc/intra_part.cu (built for
sm_90a by av1tpu_torch._build); the note at its top states their design
and what bounds them.  A site's constants are checked once, into a
`PartSite`; each call checks its jobs' tensors.  The wrappers take the
plain versions only for tensors on the CPU.  A CUDA tensor always launches
the kernel, and anything the kernel does not take raises: there is no
fallback.  Every output is written in place, into the caller's tensors.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from av1tpu_torch.kernels.transform_quant import _check

COST_NONE, COST_COEF, COST_PIXEL = 0, 1, 2
# the mode RDO's candidates: V, then intra_v._RDO_MODES' D45 and D67
MODE_VALS = (1, 3, 8)
MODE_BITS = (0.0, 4.0, 4.0)
_vp, _ci, _cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


class PartSiteC(ctypes.Structure):
    """`struct PartSite` of csrc/intra_part.cu, field for field, as the
    job structs below mirror theirs; _lib checks every layout when it
    loads the library."""
    _fields_ = [(k, _vp) for k in ("step", "off", "gain", "tab", "q",
                                   "cap")] + [
        ("lam", _cf), ("inv_ratio", _cf)] + [
        (k, _ci) for k in ("n", "tx", "dq_shift", "nm", "cost", "pix_max")]


class ChainJobC(ctypes.Structure):
    _fields_ = [("s", PartSiteC)] + [
        (k, _vp) for k in ("fwdt", "src", "lv", "rec")] + [
        (k, _ci) for k in ("cols", "width", "edge0")]


class PredJobC(ctypes.Structure):
    _fields_ = [(k, _vp) for k in ("bottom", "src", "av", "resid",
                                   "pred")] + [
        (k, _ci) for k in ("n", "nm", "cols", "width")]


class CodeJobC(ctypes.Structure):
    _fields_ = [("s", PartSiteC)] + [
        (k, _vp) for k in ("coefs", "pred", "src", "lv", "rec", "modes",
                           "cost", "rate")] + [
        (k, _ci) for k in ("cols", "width")]


class MergeJobC(ctypes.Structure):
    _fields_ = [(k, _vp) for k in (
        "lv_s", "lv_m", "lv_b", "recon", "src", "rec_m", "rec_b", "split",
        "split64", "cost_s", "cost_m", "cost_b", "cost_region")] + [
        ("lam", _cf), ("lam_split", _cf)] + [
        (k, _ci) for k in ("ns", "width", "sb_row", "half", "do_big")]


class PartSite:
    """The constants of one coding site of the probe, checked once.

    n: the block size (8, 16, 32 or 64); the coded levels are cw x cw,
    cw = min(n, 32).  tx: 0 DCT_DCT or 1 ADST_DCT (ADST at n <= 16).  nm:
    3 for the V/D45/D67 mode RDO, 1 for V_PRED alone.  step, q, cap (each
    (cw*cw,), float32, int32, int32; step with the dequantize shift
    folded in) and dq_shift (0, 1 at 32x32, 2 for TX_64X64).  tab (256,)
    and gains (cw*cw,) float32: rd_zero's bits per magnitude and gains, or
    both None (no rd_zero).  lam: the pixel-domain lambda as a numpy
    float32.  cost: COST_COEF (coefficient-domain distortion times
    inv_ratio, a numpy float32, plus lam times the rate with the mode
    bits), COST_PIXEL (the pixel SSE plus lam times the rate) or
    COST_NONE.  bit_depth 8 or 10.  All tensors contiguous on one device.
    The deadzone offsets row is a constant of the bundle."""

    def __init__(self, *, n: int, tx: int, nm: int, step, q, cap, tab,
                 gains, lam, dq_shift: int, cost: int, bit_depth: int,
                 inv_ratio=None):
        from av1tpu_torch.state import tables

        if n not in (8, 16, 32, 64):
            raise ValueError(f"n must be 8, 16, 32 or 64, got {n}")
        if tx not in (0, 1) or (tx == 1 and n > 16):
            raise ValueError(f"tx {tx} at n={n}: DCT_DCT, or ADST_DCT up "
                             "to 16")
        if nm not in (1, 3) or (nm == 3 and cost != COST_COEF):
            raise ValueError(f"nm must be 3 (with COST_COEF) or 1, got {nm}")
        if cost not in (COST_NONE, COST_COEF, COST_PIXEL):
            raise ValueError(f"unknown cost kind {cost}")
        if dq_shift not in (0, 1, 2):
            raise ValueError(f"dq_shift must be 0, 1 or 2, got {dq_shift}")
        if bit_depth not in (8, 10):
            raise ValueError(f"bit_depth must be 8 or 10, got {bit_depth}")
        if not isinstance(lam, np.float32):
            raise TypeError("lam: expected a numpy float32 value, got "
                            f"{type(lam).__name__}")
        if (cost == COST_COEF) != isinstance(inv_ratio, np.float32):
            raise TypeError("inv_ratio: a numpy float32 with COST_COEF, "
                            "else None")
        if (tab is None) != (gains is None):
            raise ValueError("tab and gains come together (rd_zero)")
        cw = min(n, 32)
        nc = cw * cw
        dev = step.device
        if dev.type not in ("cpu", "cuda"):
            raise ValueError(f"unsupported device {dev}")
        for name, t, dtype in (("step", step, torch.float32),
                               ("q", q, torch.int32),
                               ("cap", cap, torch.int32)):
            _check(name, t, dtype, (nc,), dev)
        if tab is not None:
            _check("tab", tab, torch.float32, (256,), dev)
            _check("gains", gains, torch.float32, (nc,), dev)
        self.n, self.tx, self.nm, self.cw, self.nc = n, tx, nm, cw, nc
        self.step, self.q, self.cap, self.tab, self.gains = (step, q, cap,
                                                             tab, gains)
        self.lam, self.inv_ratio, self.cost = lam, inv_ratio, cost
        self.dq_shift, self.bit_depth = dq_shift, bit_depth
        self.pix_max = (1 << bit_depth) - 1
        self.device = dev
        self.off = tables(dev).q_offsets(nc)
        # the kernels' view (the tensors above keep its pointers alive)
        self.c = PartSiteC(
            step=_ptr(step), off=_ptr(self.off), gain=_ptr(gains),
            tab=_ptr(tab), q=_ptr(q), cap=_ptr(cap), lam=float(lam),
            inv_ratio=0.0 if inv_ratio is None else float(inv_ratio), n=n,
            tx=tx, dq_shift=dq_shift, nm=nm, cost=cost, pix_max=self.pix_max)


class ChainJob(NamedTuple):
    """One plane's first block row.  fwdt (n*n, n*n) float32, the
    transposed forward matrix of the site's tx; src (n, width) int32, the
    plane's first n rows; lv (cols, n, n) int16 and rec (n, width) int32
    outputs (row 0 of the level grid, the recon's first n rows)."""
    site: PartSite
    fwdt: torch.Tensor
    src: torch.Tensor
    lv: torch.Tensor
    rec: torch.Tensor


class PredJob(NamedTuple):
    """One site's candidates.  bottom (width,) int32: the row above; src
    (n, width) int32: the site's band of the source; av (cols,) bool: the
    blocks' above-right availability (the V/D45/D67 candidates), or None
    (V_PRED alone); resid (nm*cols, n*n) float32 and pred (the same) int32
    outputs, candidate m of column c at row m*cols + c."""
    bottom: torch.Tensor
    src: torch.Tensor
    av: torch.Tensor | None
    resid: torch.Tensor
    pred: torch.Tensor


class CodeJob(NamedTuple):
    """One site after the forward product.  coefs (nm*cols, cw*cw) float32
    and pred (nm*cols, n*n) int32 (part_pred's layout); src (n, width)
    int32, the site's band (read by COST_PIXEL); outputs: lv (cols, cw, cw)
    int16 and rec (n, width) int32, the chosen candidate's; modes (cols,)
    int8, cost (cols,) float32 and rate (nm, cols) float32 (each
    candidate's log2 rate without the mode bits), each optional."""
    site: PartSite
    coefs: torch.Tensor
    pred: torch.Tensor
    src: torch.Tensor
    lv: torch.Tensor
    rec: torch.Tensor
    modes: torch.Tensor | None = None
    cost: torch.Tensor | None = None
    rate: torch.Tensor | None = None


class MergeJob(NamedTuple):
    """One plane's merges of half `half` of superblock row `sb_row`, and
    with do_big the superblock's merge after it.  Block sizes ns (small:
    luma 16, chroma 8), 2ns (mid) and 4ns (big, coded 32x32).  Grids, all
    updated in place: lv_s (rows, cols, ns, ns), lv_m (.., 2ns, 2ns), lv_b
    (.., 32, 32) int16; recon (h, width) int32; split (h/2ns, width/2ns)
    and split64 (h/4ns, width/4ns) bool.  rec_m (2ns, width) and rec_b
    (4ns, width) int32: the mid and big sites' recon bands.  Luma decides
    by cost: src (h, width) int32, cost_s (2, width/ns), cost_m
    (width/2ns,), cost_b (width/4ns,) float32 and cost_region (2,
    width/2ns) float32 (written for this half, read for the superblock),
    lam and lam_split numpy float32, and writes split and split64.
    Chroma follows luma's split and split64: src, the costs, lam and
    lam_split None."""
    lv_s: torch.Tensor
    lv_m: torch.Tensor
    lv_b: torch.Tensor
    recon: torch.Tensor
    rec_m: torch.Tensor
    rec_b: torch.Tensor
    split: torch.Tensor
    split64: torch.Tensor
    sb_row: int
    half: int
    do_big: bool
    src: torch.Tensor | None = None
    cost_s: torch.Tensor | None = None
    cost_m: torch.Tensor | None = None
    cost_b: torch.Tensor | None = None
    cost_region: torch.Tensor | None = None
    lam: np.float32 | None = None
    lam_split: np.float32 | None = None


def _ptr(t):
    return None if t is None else t.data_ptr()


def _on_card(dev: torch.device) -> bool:
    """False for the CPU (the plain version); raises on anything the
    kernels do not take."""
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"tensors on {dev}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return True


def _launch(fn, cls, structs, name: str) -> None:
    arr = (cls * len(structs))(*structs)
    err = fn(arr, len(structs), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def _aligned(name: str, tensors) -> None:
    """Raise unless every tensor starts 16-byte aligned (the kernels move
    16-byte pieces)."""
    for k, t in tensors:
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: {k} is not 16-byte aligned")


def _layout() -> dict:
    """{"Struct": size, "Struct.field": offset} of the ctypes mirrors."""
    out = {}
    for cls in (PartSiteC, ChainJobC, PredJobC, CodeJobC, MergeJobC):
        name = cls.__name__[:-1]
        out[name] = ctypes.sizeof(cls)
        out.update({f"{name}.{k}": getattr(cls, k).offset
                    for k, _ in cls._fields_})
    return out


@functools.cache
def _lib():
    """The kernel library, once its job structs' layout (av1_part_layout:
    sizes and field offsets by name) is found equal to the mirrors'."""
    from av1tpu_torch._build import cuda_lib

    lib = cuda_lib()
    buf = ctypes.create_string_buffer(4096)
    if lib.av1_part_layout(buf, len(buf)) >= len(buf):
        raise RuntimeError("av1_part_layout: its text outgrew the buffer")
    got = {k: int(v) for k, v in (line.split() for line in
                                  buf.value.decode().splitlines())}
    want = _layout()
    if got != want:
        diff = sorted(k for k in got.keys() | want.keys()
                      if got.get(k) != want.get(k))
        raise RuntimeError("csrc/intra_part.cu's job structs differ from "
                           f"kernels/intra_part.py's mirrors at {diff}")
    return lib


# ---- part_chain ----

def _check_chain(j: ChainJob) -> torch.device:
    s = j.site
    n, dev = s.n, s.device
    if n not in (8, 16) or s.nm != 1 or s.cost != COST_NONE or s.dq_shift:
        raise ValueError("a chain site is 8x8 or 16x16, V_PRED, no cost, "
                         "no dequantize shift")
    if j.src.dim() != 2 or j.src.shape[0] != n or j.src.shape[1] % n:
        raise ValueError(f"src: expected ({n}, width), width a multiple "
                         f"of {n}, got {tuple(j.src.shape)}")
    width = j.src.shape[1]
    _check("fwdt", j.fwdt, torch.float32, (n * n, n * n), dev)
    _check("src", j.src, torch.int32, (n, width), dev)
    _check("lv", j.lv, torch.int16, (width // n, n, n), dev)
    _check("rec", j.rec, torch.int32, (n, width), dev)
    return dev


def _by_site(jobs, width):
    """The jobs in groups that share a site and a width (U and V): each
    group is coded as one batch, whose integer and elementwise steps give
    each job's own values."""
    groups: dict = {}
    for j in jobs:
        groups.setdefault((id(j.site), width(j)), []).append(j)
    return list(groups.values())


def part_chain_plain(jobs) -> None:
    """Plain version of part_chain: per column the flat prediction from
    the carried pixel (1 << (bit_depth - 1)) - 1 at the first), the
    product, the quantize (rd_zero where the site has a table), the
    dequantize, the inverse and the recon; the carry is rec[0, n - 1].
    Planes that share a site walk their columns together (one product per
    plane and column, as the reference's scan)."""
    from av1tpu_torch.models.intra_v import quantize_with_offsets
    from av1tpu_torch.models.rdoq import rd_zero
    from av1tpu_torch.ops.transforms import inverse_transform

    for group in _by_site(jobs, lambda j: j.src.shape[1]):
        s = group[0].site
        n, k = s.n, len(group)
        edge = torch.full((k, 1, 1), (1 << (s.bit_depth - 1)) - 1,
                          dtype=torch.int32, device=s.device)
        for c in range(group[0].src.shape[1] // n):
            cut = slice(c * n, (c + 1) * n)
            coefs = torch.cat([
                (j.src[:, cut] - edge[i]).reshape(1, n * n).to(torch.float32)
                @ j.fwdt for i, j in enumerate(group)])
            lv = quantize_with_offsets(coefs, s.step, s.cap, s.off)
            if s.tab is not None:
                lv = rd_zero(lv, coefs, s.step, float(s.lam), s.tab, s.gains)
            rec = torch.clamp(edge + inverse_transform(
                (lv * s.q).reshape(k, n, n), n, n, s.tx), 0, s.pix_max)
            edge = rec[:, :1, n - 1:]
            for i, j in enumerate(group):
                j.lv[c] = lv[i].reshape(n, n)
                j.rec[:, cut] = rec[i]


# part_chain's launch (csrc/intra_part.cu: CHAIN_CL, CHAIN_NT,
# chain_words); the card test holds chain_layout to av1_part_chain_layout
CHAIN_CL = 4
CHAIN_NT = 256 // CHAIN_CL
KEEP_ALWAYS = 8


class ChainLayout(NamedTuple):
    """part_chain's launch: CTAs, CTAs per cluster (a plane each), threads
    per CTA, dynamic shared bytes per CTA."""
    ctas: int
    cluster: int
    threads: int
    smem: int


def chain_words(n: int) -> int:
    """A CTA's shared words for an n x n plane: its slice of the forward
    matrix (every row, n*n / CHAIN_CL columns), the residual, the two
    dequantized blocks (the columns' parity), the inverse's scratch and
    rd_zero's first table entries."""
    nn = n * n
    return nn * (nn // CHAIN_CL) + nn + 3 * n * (n + 1) + KEEP_ALWAYS


def chain_layout(sizes) -> ChainLayout:
    """The launch of part_chain on jobs of these block sizes (8 or 16)."""
    return ChainLayout(CHAIN_CL * len(sizes), CHAIN_CL, CHAIN_NT,
                       4 * max(chain_words(n) for n in sizes))


def part_chain(jobs) -> None:
    """jobs: 1 to 3 ChainJobs (a plane each), written in place.  On the
    card each forward matrix is read in 16-byte pieces: it must start
    16-byte aligned."""
    if not 1 <= len(jobs) <= 3:
        raise ValueError(f"part_chain: 1 to 3 jobs, got {len(jobs)}")
    devs = {_check_chain(j) for j in jobs}
    if len(devs) != 1:
        raise ValueError(f"part_chain: jobs on several devices {devs}")
    if not _on_card(devs.pop()):
        return part_chain_plain(jobs)
    if any(j.fwdt.data_ptr() % 16 for j in jobs):
        raise ValueError("fwdt: the forward matrix must start 16-byte "
                         "aligned")
    _launch(_lib().av1_part_chain, ChainJobC, [
        ChainJobC(s=j.site.c, fwdt=_ptr(j.fwdt), src=_ptr(j.src),
                  lv=_ptr(j.lv), rec=_ptr(j.rec),
                  cols=j.src.shape[1] // j.site.n, width=j.src.shape[1],
                  edge0=(1 << (j.site.bit_depth - 1)) - 1)
        for j in jobs], "part_chain")
    part_chain.launches += 1


part_chain.launches = 0


# ---- part_pred ----

# part_pred's kernel: columns per CTA at each size (a 16-byte quad of every
# candidate per thread; csrc/intra_part.cu:PredLayout), and its flat grid
PRED_COLS = {8: 16, 16: 4, 32: 1, 64: 1}


def pred_ctas(jobs) -> int:
    """The CTAs of part_pred's launch on these jobs (n, cols from src)."""
    return sum(-(-(j.src.shape[1] // j.src.shape[0])
                 // PRED_COLS[j.src.shape[0]]) for j in jobs)


def _pred_shape(j: PredJob):
    if j.src.dim() != 2 or j.src.shape[0] not in (8, 16, 32, 64):
        raise ValueError(f"src: expected (n, width), n in 8..64, got "
                         f"{tuple(j.src.shape)}")
    n, width = j.src.shape
    if width % n:
        raise ValueError(f"src: width {width} is not a multiple of {n}")
    cols, nm = width // n, (1 if j.av is None else 3)
    dev = j.src.device
    _check("src", j.src, torch.int32, (n, width), dev)
    _check("bottom", j.bottom, torch.int32, (width,), dev)
    if j.av is not None:
        _check("av", j.av, torch.bool, (cols,), dev)
    _check("resid", j.resid, torch.float32, (nm * cols, n * n), dev)
    _check("pred", j.pred, torch.int32, (nm * cols, n * n), dev)
    return n, nm, cols, width, dev


def edges(bottom: torch.Tensor, av: torch.Tensor, n: int, cols: int):
    """(cols, 2n) above edges with above-right from a full-width bottom
    row, replicated where unavailable (av/intra_part.py:_edges)."""
    from av1tpu_torch.state import tables

    padded = torch.cat([bottom, bottom[-1:].expand(n)])
    win, k_lt_n = tables(bottom.device).const(("edges", n, cols), lambda d: (
        torch.as_tensor(np.arange(cols)[:, None] * n
                        + np.arange(2 * n)[None, :], device=d),
        torch.arange(2 * n, device=d)[None, :] < n))
    ae = padded[win]
    repl = ae[:, n - 1][:, None]
    return torch.where(k_lt_n | av[:, None], ae, repl)


def part_pred_plain(jobs) -> None:
    """Plain version of part_pred: the candidates of
    av1tpu/models/intra_part.py's _mode_rdo, or V_PRED alone."""
    from av1tpu_torch.models.intra_v import _RDO_MODES, _directional_pred

    for j in jobs:
        n, nm, cols, _, _ = _pred_shape(j)
        if nm == 1:
            preds = j.bottom.reshape(cols, 1, n).expand(cols, n, n)
        else:
            ae = edges(j.bottom, j.av, n, cols)
            preds = torch.cat([ae[:, None, :n].expand(cols, n, n)] + [
                _directional_pred(ae, dx, n) for _, dx in _RDO_MODES])
        blocks = j.src.reshape(n, cols, n).transpose(0, 1)
        resid = (blocks.repeat(nm, 1, 1) - preds).reshape(
            nm * cols, n * n).to(torch.float32)
        j.resid.copy_(resid)
        j.pred.copy_(preds.reshape(nm * cols, n * n))


def part_pred(jobs) -> None:
    """jobs: 1 to 6 PredJobs on one device, written in place.  On the card
    src, resid and pred are moved in 16-byte pieces: each must start
    16-byte aligned; src is read before the launch waits for the stream's
    previous kernel (see the module's note)."""
    if not 1 <= len(jobs) <= 6:
        raise ValueError(f"part_pred: 1 to 6 jobs, got {len(jobs)}")
    shapes = [_pred_shape(j) for j in jobs]
    devs = {s[-1] for s in shapes}
    if len(devs) != 1:
        raise ValueError(f"part_pred: jobs on several devices {devs}")
    if not _on_card(devs.pop()):
        return part_pred_plain(jobs)
    for j in jobs:
        _aligned("part_pred", (("src", j.src), ("resid", j.resid),
                               ("pred", j.pred)))
    _launch(_lib().av1_part_pred, PredJobC, [
        PredJobC(bottom=_ptr(j.bottom), src=_ptr(j.src), av=_ptr(j.av),
                 resid=_ptr(j.resid), pred=_ptr(j.pred), n=n, nm=nm,
                 cols=cols, width=width)
        for j, (n, nm, cols, width, _) in zip(jobs, shapes)], "part_pred")
    part_pred.launches += 1


part_pred.launches = 0


# ---- part_code ----

def _code_shape(j: CodeJob):
    s = j.site
    n, nm, nc, dev = s.n, s.nm, s.nc, s.device
    if nm != 1 and n in (8, 64):
        raise ValueError(f"part_code: a {n}x{n} site codes V_PRED alone "
                         f"(nm 1), got nm {nm}")
    if j.src.dim() != 2 or j.src.shape[0] != n or j.src.shape[1] % n:
        raise ValueError(f"src: expected ({n}, width), width a multiple "
                         f"of {n}, got {tuple(j.src.shape)}")
    width = j.src.shape[1]
    cols = width // n
    _check("src", j.src, torch.int32, (n, width), dev)
    _check("coefs", j.coefs, torch.float32, (nm * cols, nc), dev)
    _check("pred", j.pred, torch.int32, (nm * cols, n * n), dev)
    _check("lv", j.lv, torch.int16, (cols, s.cw, s.cw), dev)
    _check("rec", j.rec, torch.int32, (n, width), dev)
    if j.modes is not None:
        _check("modes", j.modes, torch.int8, (cols,), dev)
    if j.cost is not None:
        _check("cost", j.cost, torch.float32, (cols,), dev)
    if j.rate is not None:
        _check("rate", j.rate, torch.float32, (nm, cols), dev)
    return cols, width, dev


def _dq_shift(lv, q, shift: int):
    """sign(lv) * ((|lv| * q) >> shift): the decoder's 32/64 dequant."""
    return torch.sign(lv) * ((lv.abs() * q) >> shift)


def part_code_plain(jobs) -> None:
    """Plain version of part_code: av1tpu/models/intra_part.py's
    _mode_rdo after the product with _recon16/_recon32, the 64x64
    candidate of sb_step and the chroma enc, as the port's eager code
    computed them (U and V, which share a site, in one batch)."""
    for group in _by_site(jobs, lambda j: _code_shape(j)[1]):
        if group[0].site.cost == COST_NONE:
            _code_group_plain(group)
        else:
            for j in group:
                _code_group_plain([j])


def _code_group_plain(group) -> None:
    """part_code_plain of jobs that share a site and a width; a site with
    a cost comes alone."""
    from av1tpu_torch.models.intra_v import log2_rate, quantize_with_offsets
    from av1tpu_torch.models.rdoq import rd_zero
    from av1tpu_torch.ops.transforms import inverse_transform
    from av1tpu_torch.state import tables

    j = group[0]
    s = j.site
    cols, _, dev = _code_shape(j)
    n, nm, cw, k = s.n, s.nm, s.cw, len(group)
    coefs = torch.cat([g.coefs for g in group]) if k > 1 else j.coefs
    pred = torch.cat([g.pred for g in group]) if k > 1 else j.pred
    lv = quantize_with_offsets(coefs, s.step, s.cap, s.off)
    if s.tab is not None:
        lv = rd_zero(lv, coefs, s.step, float(s.lam), s.tab, s.gains)
    if any(g.rate is not None for g in group):
        rates = log2_rate(lv, 1).reshape(k, nm, cols)
        for g, r in zip(group, rates):
            if g.rate is not None:
                g.rate.copy_(r)
    if s.cost == COST_COEF:
        d = coefs - lv * s.step
        # the compiled reference multiplies by the float32 reciprocal
        dist = ((d * d).sum(dim=1) * float(s.inv_ratio)).reshape(nm, -1)
        mode_vals, mode_bits = tables(dev).const(
            ("part_modes", nm), lambda dv: (
                torch.tensor(MODE_VALS[:nm], dtype=torch.int8, device=dv),
                torch.tensor(MODE_BITS[:nm], dtype=torch.float32,
                             device=dv)[:, None]))
        rate = log2_rate(lv, 1).reshape(nm, -1) + mode_bits
        cost = dist + float(s.lam) * rate
        choice = torch.argmin(cost, dim=0)
        lv = torch.gather(lv.reshape(nm, cols, -1), 0,
                          choice[None, :, None].expand(1, cols, s.nc))[0]
        pred = torch.gather(pred.reshape(nm, cols, -1), 0,
                            choice[None, :, None].expand(1, cols, n * n))[0]
        if j.cost is not None:
            j.cost.copy_(torch.gather(cost, 0, choice[None])[0])
        if j.modes is not None:
            j.modes.copy_(mode_vals[choice])
    else:
        for g in group:
            if g.modes is not None:
                g.modes.fill_(MODE_VALS[0])
    b = k * cols
    dq = (lv * s.q if s.dq_shift == 0 else
          _dq_shift(lv, s.q, s.dq_shift)).reshape(b, cw, cw)
    if cw < n:          # TX_64X64: the coded 32x32 in the top-left
        full = torch.zeros((b, n, n), dtype=torch.int32, device=dev)
        full[:, :cw, :cw] = dq
        dq = full
    rec = torch.clamp(pred.reshape(b, n, n)
                      + inverse_transform(dq, n, n, s.tx), 0, s.pix_max)
    lv = lv.reshape(k, cols, cw, cw)
    for i, g in enumerate(group):
        g.rec.view(n, cols, n).copy_(rec[i * cols:(i + 1) * cols]
                                     .transpose(0, 1))
        g.lv.copy_(lv[i])
    if s.cost == COST_PIXEL:
        e = rec - j.src.reshape(n, cols, n).transpose(0, 1)
        # summed in int32, wrapping, as the reference's jnp.sum
        d64 = (e * e).sum(dim=(1, 2), dtype=torch.int32).to(torch.float32)
        if j.cost is not None:
            j.cost.copy_(d64 + float(s.lam) * log2_rate(
                lv[0].reshape(cols, -1), 1))


# part_code's kernel: 8x8 columns per CTA (each on two warps); one column
# a CTA at the other sizes (csrc/intra_part.cu:CodeLayout)
CODE_COLS = {8: 4, 16: 1, 32: 1, 64: 1}


def code_ctas(jobs) -> int:
    """The CTAs of part_code's launch on these jobs (its flat grid)."""
    return sum(-(-j.lv.shape[0] // CODE_COLS[j.site.n]) for j in jobs)


def code_smem(jobs) -> int:
    """The launch's dynamic shared bytes per CTA: the most any job's size
    needs, per column the block and its scratch (n x (n + 1) words each),
    the candidates' predictions and, for the pixel cost, the source, and
    the candidates' coefficients."""
    def column(s):
        return (2 * s.n * (s.n + 1) + (s.nm + (s.cost == COST_PIXEL))
                * s.n ** 2 + s.nm * min(s.n, 32) ** 2)

    return max(4 * CODE_COLS[j.site.n] * column(j.site) for j in jobs)


def part_code(jobs) -> None:
    """jobs: 1 to 6 CodeJobs on one device, written in place.  On the card
    the predictions and the source are read in 16-byte pieces: each must
    start 16-byte aligned."""
    if not 1 <= len(jobs) <= 6:
        raise ValueError(f"part_code: 1 to 6 jobs, got {len(jobs)}")
    shapes = [_code_shape(j) for j in jobs]
    devs = {s[-1] for s in shapes}
    if len(devs) != 1:
        raise ValueError(f"part_code: jobs on several devices {devs}")
    if not _on_card(devs.pop()):
        return part_code_plain(jobs)
    for j in jobs:
        _aligned("part_code", (("pred", j.pred), ("src", j.src)))
    _launch(_lib().av1_part_code, CodeJobC, [
        CodeJobC(s=j.site.c, coefs=_ptr(j.coefs), pred=_ptr(j.pred),
                 src=_ptr(j.src), lv=_ptr(j.lv), rec=_ptr(j.rec),
                 modes=_ptr(j.modes), cost=_ptr(j.cost), rate=_ptr(j.rate),
                 cols=cols, width=width)
        for j, (cols, width, _) in zip(jobs, shapes)], "part_code")
    part_code.launches += 1


part_code.launches = 0


# ---- part_merge ----

def _merge_shape(j: MergeJob):
    if j.lv_s.dim() != 4 or j.lv_s.shape[-1] not in (8, 16):
        raise ValueError(f"lv_s: expected (rows, cols, ns, ns), ns 8 or 16,"
                         f" got {tuple(j.lv_s.shape)}")
    ns = j.lv_s.shape[-1]
    dev = j.lv_s.device
    if j.recon.dim() != 2 or j.recon.shape[0] % (4 * ns) or \
            j.recon.shape[1] % (4 * ns):
        raise ValueError(f"recon: expected (h, width), multiples of "
                         f"{4 * ns}, got {tuple(j.recon.shape)}")
    h, width = j.recon.shape
    rs, cs = h // ns, width // ns
    _check("recon", j.recon, torch.int32, (h, width), dev)
    _check("lv_s", j.lv_s, torch.int16, (rs, cs, ns, ns), dev)
    _check("lv_m", j.lv_m, torch.int16, (rs // 2, cs // 2, 2 * ns, 2 * ns),
           dev)
    _check("lv_b", j.lv_b, torch.int16, (rs // 4, cs // 4, 32, 32), dev)
    _check("rec_m", j.rec_m, torch.int32, (2 * ns, width), dev)
    _check("split", j.split, torch.bool, (rs // 2, cs // 2), dev)
    _check("split64", j.split64, torch.bool, (rs // 4, cs // 4), dev)
    if j.do_big:
        _check("rec_b", j.rec_b, torch.int32, (4 * ns, width), dev)
    if not (0 <= j.sb_row < rs // 4 and j.half in (0, 1)) or (
            j.do_big and j.half != 1):
        raise ValueError(f"sb_row {j.sb_row}, half {j.half}, do_big "
                         f"{j.do_big}: out of the grid")
    luma = j.cost_m is not None
    if luma:
        _check("src", j.src, torch.int32, (h, width), dev)
        _check("cost_s", j.cost_s, torch.float32, (2, cs), dev)
        _check("cost_m", j.cost_m, torch.float32, (cs // 2,), dev)
        _check("cost_b", j.cost_b, torch.float32, (cs // 4,), dev)
        _check("cost_region", j.cost_region, torch.float32, (2, cs // 2),
               dev)
        if not (isinstance(j.lam, np.float32)
                and isinstance(j.lam_split, np.float32)):
            raise TypeError("lam, lam_split: numpy float32 values")
    elif any(x is not None for x in (j.src, j.cost_s, j.cost_b,
                                     j.cost_region, j.lam, j.lam_split)):
        raise ValueError("a chroma merge (no cost_m) takes no src, costs "
                         "or lambdas")
    return ns, width, dev


def part_merge_plain(jobs) -> None:
    """Plain version of part_merge: av1tpu/models/intra_part.py's
    row32_step and sb_step merges (luma), row16_step and chroma_sb_step
    merges (chroma), as the port's eager code computed them."""
    from av1tpu_torch.models.intra_v import log2_rate

    for j in jobs:
        ns, width, _ = _merge_shape(j)
        nm, nb = 2 * ns, 4 * ns
        cols_m, cols_b = width // nm, width // nb
        s, r = j.sb_row, 2 * j.sb_row + j.half
        band = j.recon[r * nm:(r + 1) * nm]
        lv_pair, lv_m = j.lv_s[2 * r:2 * r + 2], j.lv_m[r]
        luma = j.cost_m is not None
        if luma:
            cost_small = (j.cost_s[0].reshape(cols_m, 2).sum(1)
                          + j.cost_s[1].reshape(cols_m, 2).sum(1)
                          + float(j.lam_split))
            split = cost_small < j.cost_m
            j.split[r] = split
        else:
            split = j.split[r]
        s2 = split.repeat_interleave(2)
        lv_pair.copy_(torch.where(s2[None, :, None, None], lv_pair, 0))
        lv_m.copy_(torch.where(split[:, None, None], 0, lv_m))
        band.copy_(torch.where(split.repeat_interleave(nm)[None], band,
                               j.rec_m))
        if luma:
            # exact pixel-domain cost of the selected coding per region
            e = band - j.src[r * nm:(r + 1) * nm]
            d_sel = (e * e).reshape(nm, cols_m * 2, ns).sum(
                dim=(0, 2)).to(torch.float32)
            d_region = d_sel.reshape(cols_m, 2).sum(1)
            r16 = log2_rate(lv_pair, (0, 2, 3)).reshape(cols_m, 2).sum(1)
            r32 = log2_rate(lv_m, (1, 2))
            j.cost_region[j.half] = d_region + float(j.lam) * (r16 + r32)
        if not j.do_big:
            continue
        if luma:
            cost_sub = (j.cost_region[0].reshape(cols_b, 2).sum(1)
                        + j.cost_region[1].reshape(cols_b, 2).sum(1)
                        + float(j.lam_split))
            split64 = cost_sub < j.cost_b
            j.split64[s] = split64
        else:
            split64 = j.split64[s]
        j.lv_b[s].copy_(torch.where(split64[:, None, None], 0, j.lv_b[s]))
        k2, k4 = split64.repeat_interleave(2), split64.repeat_interleave(4)
        sub_s, sub_m = j.lv_s[4 * s:4 * s + 4], j.lv_m[2 * s:2 * s + 2]
        sub_s.copy_(torch.where(k4[None, :, None, None], sub_s, 0))
        sub_m.copy_(torch.where(k2[None, :, None, None], sub_m, 0))
        if luma:
            j.split[2 * s:2 * s + 2] &= k2
        big = j.recon[s * nb:(s + 1) * nb]
        big.copy_(torch.where(split64.repeat_interleave(nb)[None], big,
                              j.rec_b))


# part_merge's kernel: CTAs per superblock column (a cluster, one per
# region of the half; csrc/intra_part.cu:MERGE_CL)
MERGE_CL = 2


class MergeLayout(NamedTuple):
    """part_merge's launch: CTAs along x (MERGE_CL per superblock column of
    the widest job), rows (a job each), CTAs per cluster, threads."""
    ctas: int
    rows: int
    cluster: int
    threads: int


def merge_layout(jobs) -> MergeLayout:
    """The launch of part_merge on these jobs."""
    cols_b = max(j.recon.shape[1] // (4 * j.lv_s.shape[-1]) for j in jobs)
    return MergeLayout(MERGE_CL * cols_b, len(jobs), MERGE_CL, 256)


def part_merge(jobs) -> None:
    """jobs: 1 or 2 MergeJobs (a plane each) on one device, in place.  On
    the card the grids, the bands and the source are moved in 16-byte
    pieces: each must start 16-byte aligned; some inputs are read before
    the launch waits for the stream's previous kernel (see the module's
    note)."""
    if not 1 <= len(jobs) <= 2:
        raise ValueError(f"part_merge: 1 or 2 jobs, got {len(jobs)}")
    shapes = [_merge_shape(j) for j in jobs]
    devs = {s[-1] for s in shapes}
    if len(devs) != 1:
        raise ValueError(f"part_merge: jobs on several devices {devs}")
    if not _on_card(devs.pop()):
        return part_merge_plain(jobs)
    for j in jobs:
        _aligned("part_merge", [(k, getattr(j, k)) for k in (
            "lv_s", "lv_m", "lv_b", "recon", "rec_m", "rec_b", "src")])
    _launch(_lib().av1_part_merge, MergeJobC, [
        MergeJobC(lv_s=_ptr(j.lv_s), lv_m=_ptr(j.lv_m), lv_b=_ptr(j.lv_b),
                  recon=_ptr(j.recon), src=_ptr(j.src),
                  rec_m=_ptr(j.rec_m), rec_b=_ptr(j.rec_b),
                  split=_ptr(j.split), split64=_ptr(j.split64),
                  cost_s=_ptr(j.cost_s), cost_m=_ptr(j.cost_m),
                  cost_b=_ptr(j.cost_b), cost_region=_ptr(j.cost_region),
                  lam=0.0 if j.lam is None else float(j.lam),
                  lam_split=0.0 if j.lam_split is None else
                  float(j.lam_split),
                  ns=ns, width=width, sb_row=j.sb_row, half=j.half,
                  do_big=int(j.do_big))
        for j, (ns, width, _) in zip(jobs, shapes)], "part_merge")
    part_merge.launches += 1


part_merge.launches = 0
