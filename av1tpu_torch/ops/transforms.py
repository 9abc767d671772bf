"""Integer-exact AV1 inverse transforms on int32 tensors (+ forward matrices).

PyTorch counterpart of av1tpu/ops/transforms_jax.py: the same butterfly
structure and per-stage roundings as the numpy spec model
(av1tpu/spec/transforms.py), batched over every leading axis.  int32 on
the encode path; Python-int weights keep the tensor's dtype (torch, like
JAX, does not promote a tensor for a Python scalar), and int32 products
wrap exactly as they do in XLA.  The forward matrices are built from the
same butterflies in int64, as the spec model builds them.
"""

from __future__ import annotations

import numpy as np
import torch

# 12-bit cosine table: cos128(i) = round(cos(i*pi/128) * 4096) (spec cos128)
COS128 = np.round(np.cos(np.arange(65) * np.pi / 128) * 4096).astype(np.int64)
COS = [int(v) for v in COS128]
# round(sin(i*pi/9) * sqrt2 * 4096) anchors of the 4-point ADST (spec sinpi)
SINPI = [0, 1321, 2482, 3344, 3803]


def _rs(x, n: int):
    """round2: (x + 2^(n-1)) >> n (arithmetic shift; n=0 is a no-op)."""
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _btf(w0: int, a, w1: int, b):
    return _rs(w0 * a + w1 * b, 12)


def idct4(x):
    b0, b1, b2, b3 = x[..., 0], x[..., 2], x[..., 1], x[..., 3]
    s0 = _btf(COS[32], b0, COS[32], b1)
    s1 = _btf(COS[32], b0, -COS[32], b1)
    s2 = _btf(COS[48], b2, -COS[16], b3)
    s3 = _btf(COS[16], b2, COS[48], b3)
    return torch.stack([s0 + s3, s1 + s2, s1 - s2, s0 - s3], dim=-1)


def idct8(x):
    e = idct4(x[..., 0::2])
    b4, b5, b6, b7 = x[..., 1], x[..., 5], x[..., 3], x[..., 7]
    s4 = _btf(COS[56], b4, -COS[8], b7)
    s5 = _btf(COS[24], b5, -COS[40], b6)
    s6 = _btf(COS[40], b5, COS[24], b6)
    s7 = _btf(COS[8], b4, COS[56], b7)
    t4 = s4 + s5
    t5 = s4 - s5
    t6 = -s6 + s7
    t7 = s6 + s7
    u5 = _btf(-COS[32], t5, COS[32], t6)
    u6 = _btf(COS[32], t5, COS[32], t6)
    o = [e[..., 0] + t7, e[..., 1] + u6, e[..., 2] + u5, e[..., 3] + t4,
         e[..., 3] - t4, e[..., 2] - u5, e[..., 1] - u6, e[..., 0] - t7]
    return torch.stack(o, dim=-1)


def idct16(x):
    e = idct8(x[..., 0::2])
    b = [x[..., 1], x[..., 9], x[..., 5], x[..., 13],
         x[..., 3], x[..., 11], x[..., 7], x[..., 15]]
    s8 = _btf(COS[60], b[0], -COS[4], b[7])
    s9 = _btf(COS[28], b[1], -COS[36], b[6])
    s10 = _btf(COS[44], b[2], -COS[20], b[5])
    s11 = _btf(COS[12], b[3], -COS[52], b[4])
    s12 = _btf(COS[52], b[3], COS[12], b[4])
    s13 = _btf(COS[20], b[2], COS[44], b[5])
    s14 = _btf(COS[36], b[1], COS[28], b[6])
    s15 = _btf(COS[4], b[0], COS[60], b[7])
    t8 = s8 + s9
    t9 = s8 - s9
    t10 = -s10 + s11
    t11 = s10 + s11
    t12 = s12 + s13
    t13 = s12 - s13
    t14 = -s14 + s15
    t15 = s14 + s15
    u9 = _btf(-COS[16], t9, COS[48], t14)
    u10 = _btf(-COS[48], t10, -COS[16], t13)
    u13 = _btf(-COS[16], t10, COS[48], t13)
    u14 = _btf(COS[48], t9, COS[16], t14)
    v8 = t8 + t11
    v9 = u9 + u10
    v10 = u9 - u10
    v11 = t8 - t11
    v12 = -t12 + t15
    v13 = -u13 + u14
    v14 = u13 + u14
    v15 = t12 + t15
    w10 = _btf(-COS[32], v10, COS[32], v13)
    w11 = _btf(-COS[32], v11, COS[32], v12)
    w12 = _btf(COS[32], v11, COS[32], v12)
    w13 = _btf(COS[32], v10, COS[32], v13)
    odd = [v15, v14, w13, w12, w11, w10, v9, v8]
    o = [e[..., i] + odd[i] for i in range(8)] + \
        [e[..., 7 - i] - odd[7 - i] for i in range(8)]
    return torch.stack(o, dim=-1)


def iadst8(x):
    b = [x[..., 7], x[..., 0], x[..., 5], x[..., 2],
         x[..., 3], x[..., 4], x[..., 1], x[..., 6]]
    s = [
        _btf(COS[4], b[0], COS[60], b[1]),
        _btf(COS[60], b[0], -COS[4], b[1]),
        _btf(COS[20], b[2], COS[44], b[3]),
        _btf(COS[44], b[2], -COS[20], b[3]),
        _btf(COS[36], b[4], COS[28], b[5]),
        _btf(COS[28], b[4], -COS[36], b[5]),
        _btf(COS[52], b[6], COS[12], b[7]),
        _btf(COS[12], b[6], -COS[52], b[7]),
    ]
    t = [s[0] + s[4], s[1] + s[5], s[2] + s[6], s[3] + s[7],
         s[0] - s[4], s[1] - s[5], s[2] - s[6], s[3] - s[7]]
    u = t[:4] + [
        _btf(COS[16], t[4], COS[48], t[5]),
        _btf(COS[48], t[4], -COS[16], t[5]),
        _btf(-COS[48], t[6], COS[16], t[7]),
        _btf(COS[16], t[6], COS[48], t[7]),
    ]
    v = [u[0] + u[2], u[1] + u[3], u[0] - u[2], u[1] - u[3],
         u[4] + u[6], u[5] + u[7], u[4] - u[6], u[5] - u[7]]
    w = [v[0], v[1],
         _btf(COS[32], v[2], COS[32], v[3]),
         _btf(COS[32], v[2], -COS[32], v[3]),
         v[4], v[5],
         _btf(COS[32], v[6], COS[32], v[7]),
         _btf(COS[32], v[6], -COS[32], v[7])]
    return torch.stack([w[0], -w[4], w[6], -w[2], w[3], -w[7], w[5], -w[1]],
                       dim=-1)


def _c128(a: int) -> int:
    a &= 255
    if a <= 64:
        return COS[a]
    if a <= 128:
        return -COS[128 - a]
    if a <= 192:
        return -COS[a - 128]
    return COS[256 - a]


def idct32(x):
    e = idct16(x[..., 0::2])
    xo = [x[..., i] for i in (1, 17, 9, 25, 5, 21, 13, 29,
                              3, 19, 11, 27, 7, 23, 15, 31)]
    angles = [(62, 2), (30, 34), (46, 18), (14, 50),
              (54, 10), (22, 42), (38, 26), (6, 58)]
    s = [None] * 16
    for k, (a1, a2) in enumerate(angles):
        lo, hi = xo[k], xo[15 - k]
        s[k] = _btf(_c128(a1), lo, -_c128(a2), hi)
        s[15 - k] = _btf(_c128(a2), lo, _c128(a1), hi)
    t = [None] * 16
    for i in range(0, 16, 4):
        t[i] = s[i] + s[i + 1]
        t[i + 1] = s[i] - s[i + 1]
        t[i + 2] = -s[i + 2] + s[i + 3]
        t[i + 3] = s[i + 2] + s[i + 3]
    u = list(t)
    u[1] = _btf(-COS[8], t[1], COS[56], t[14])
    u[2] = _btf(-COS[56], t[2], -COS[8], t[13])
    u[13] = _btf(-COS[8], t[2], COS[56], t[13])
    u[14] = _btf(COS[56], t[1], COS[8], t[14])
    u[5] = _btf(-COS[40], t[5], COS[24], t[10])
    u[6] = _btf(-COS[24], t[6], -COS[40], t[9])
    u[9] = _btf(-COS[40], t[6], COS[24], t[9])
    u[10] = _btf(COS[24], t[5], COS[40], t[10])
    v = [u[0] + u[3], u[1] + u[2], u[1] - u[2], u[0] - u[3],
         -u[4] + u[7], -u[5] + u[6], u[5] + u[6], u[4] + u[7],
         u[8] + u[11], u[9] + u[10], u[9] - u[10], u[8] - u[11],
         -u[12] + u[15], -u[13] + u[14], u[13] + u[14], u[12] + u[15]]
    w = list(v)
    w[2] = _btf(-COS[16], v[2], COS[48], v[13])
    w[3] = _btf(-COS[16], v[3], COS[48], v[12])
    w[12] = _btf(COS[48], v[3], COS[16], v[12])
    w[13] = _btf(COS[48], v[2], COS[16], v[13])
    w[4] = _btf(-COS[48], v[4], -COS[16], v[11])
    w[5] = _btf(-COS[48], v[5], -COS[16], v[10])
    w[10] = _btf(-COS[16], v[5], COS[48], v[10])
    w[11] = _btf(-COS[16], v[4], COS[48], v[11])
    y = [w[0] + w[7], w[1] + w[6], w[2] + w[5], w[3] + w[4],
         w[3] - w[4], w[2] - w[5], w[1] - w[6], w[0] - w[7],
         -w[8] + w[15], -w[9] + w[14], -w[10] + w[13], -w[11] + w[12],
         w[11] + w[12], w[10] + w[13], w[9] + w[14], w[8] + w[15]]
    z = list(y)
    for i in (4, 5, 6, 7):
        z[i] = _btf(-COS[32], y[i], COS[32], y[15 - i])
        z[15 - i] = _btf(COS[32], y[i], COS[32], y[15 - i])
    o = [e[..., i] + z[15 - i] for i in range(16)] + \
        [e[..., 15 - i] - z[i] for i in range(16)]
    return torch.stack(o, dim=-1)


def iadst16(x):
    b = [x[..., 15], x[..., 0], x[..., 13], x[..., 2],
         x[..., 11], x[..., 4], x[..., 9], x[..., 6],
         x[..., 7], x[..., 8], x[..., 5], x[..., 10],
         x[..., 3], x[..., 12], x[..., 1], x[..., 14]]
    ang = [2, 10, 18, 26, 34, 42, 50, 58]
    s = [None] * 16
    for i in range(8):
        a = ang[i]
        s[2 * i] = _btf(_c128(a), b[2 * i], _c128(64 - a), b[2 * i + 1])
        s[2 * i + 1] = _btf(_c128(64 - a), b[2 * i], -_c128(a),
                            b[2 * i + 1])
    t = [s[i] + s[i + 8] for i in range(8)] + \
        [s[i] - s[i + 8] for i in range(8)]
    u = t[:8] + [
        _btf(COS[8], t[8], COS[56], t[9]),
        _btf(COS[56], t[8], -COS[8], t[9]),
        _btf(COS[40], t[10], COS[24], t[11]),
        _btf(COS[24], t[10], -COS[40], t[11]),
        _btf(-COS[56], t[12], COS[8], t[13]),
        _btf(COS[8], t[12], COS[56], t[13]),
        _btf(-COS[24], t[14], COS[40], t[15]),
        _btf(COS[40], t[14], COS[24], t[15]),
    ]
    v = [u[i] + u[i + 4] for i in range(4)] + \
        [u[i] - u[i + 4] for i in range(4)] + \
        [u[8 + i] + u[12 + i] for i in range(4)] + \
        [u[8 + i] - u[12 + i] for i in range(4)]
    w = v[:4] + [
        _btf(COS[16], v[4], COS[48], v[5]),
        _btf(COS[48], v[4], -COS[16], v[5]),
        _btf(-COS[48], v[6], COS[16], v[7]),
        _btf(COS[16], v[6], COS[48], v[7]),
    ] + v[8:12] + [
        _btf(COS[16], v[12], COS[48], v[13]),
        _btf(COS[48], v[12], -COS[16], v[13]),
        _btf(-COS[48], v[14], COS[16], v[15]),
        _btf(COS[16], v[14], COS[48], v[15]),
    ]
    y = [w[0] + w[2], w[1] + w[3], w[0] - w[2], w[1] - w[3],
         w[4] + w[6], w[5] + w[7], w[4] - w[6], w[5] - w[7],
         w[8] + w[10], w[9] + w[11], w[8] - w[10], w[9] - w[11],
         w[12] + w[14], w[13] + w[15], w[12] - w[14], w[13] - w[15]]
    z = list(y)
    for i in (2, 6, 10, 14):
        z[i] = _btf(COS[32], y[i], COS[32], y[i + 1])
        z[i + 1] = _btf(COS[32], y[i], -COS[32], y[i + 1])
    return torch.stack(
        [z[0], -z[8], z[12], -z[4], z[6], -z[14], z[10], -z[2],
         z[3], -z[11], z[15], -z[7], z[5], -z[13], z[9], -z[1]],
        dim=-1)


def _brev(v: int, bits: int) -> int:
    out = 0
    for _ in range(bits):
        out = (out << 1) | (v & 1)
        v >>= 1
    return out


def idct64(x):
    """64-point inverse DCT via the generic odd-half recursion (mirrors
    av1tpu/ops/transforms_jax.py idct64)."""
    e = idct32(x[..., 0::2])
    m, bits = 32, 5
    a = [x[..., 2 * _brev(k, bits) + 1] for k in range(m)]
    s = [None] * m
    for k in range(m // 2):
        a2 = (32 // m) * (2 * _brev(k, bits) + 1)
        lo, hi = a[k], a[m - 1 - k]
        s[k] = _btf(_c128(64 - a2), lo, -_c128(a2), hi)
        s[m - 1 - k] = _btf(_c128(a2), lo, _c128(64 - a2), hi)
    a = s
    g = 4
    while g <= m:
        h = g // 2
        b = [None] * m
        for base in range(0, m, g):
            for i in range(h // 2):
                lo, hi = a[base + i], a[base + h - 1 - i]
                b[base + i] = lo + hi
                b[base + h - 1 - i] = lo - hi
                lo2, hi2 = a[base + h + i], a[base + g - 1 - i]
                b[base + h + i] = -lo2 + hi2
                b[base + g - 1 - i] = lo2 + hi2
        a = b
        c = list(a)
        if g == m:
            for i in range(m // 4, m // 2):
                lo, hi = a[i], a[m - 1 - i]
                c[i] = _btf(-COS[32], lo, COS[32], hi)
                c[m - 1 - i] = _btf(COS[32], lo, COS[32], hi)
        else:
            a_base = 32 * g // m
            blk_bits = bits - int(np.log2(2 * g)) + 1
            for i in range(m // 2):
                r = i % g
                j = i // g
                aa = a_base * (2 * _brev(j, blk_bits) + 1)
                bb = 64 - aa
                lo, hi = a[i], a[m - 1 - i]
                if g // 4 <= r < g // 2:
                    c[i] = _btf(-COS[aa], lo, COS[bb], hi)
                    c[m - 1 - i] = _btf(COS[bb], lo, COS[aa], hi)
                elif g // 2 <= r < 3 * g // 4:
                    c[i] = _btf(-COS[bb], lo, -COS[aa], hi)
                    c[m - 1 - i] = _btf(-COS[aa], lo, COS[bb], hi)
        a = c
        g *= 2
    o = [e[..., i] + a[m - 1 - i] for i in range(m)] + \
        [e[..., m - 1 - i] - a[i] for i in range(m)]
    return torch.stack(o, dim=-1)


def iadst4(x):
    """Normative 4-point inverse ADST (spec 7.13.2.6; sinpi basis)."""
    x0, x1, x2, x3 = (x[..., i] for i in range(4))
    s0 = SINPI[1] * x0 + SINPI[4] * x2 + SINPI[2] * x3
    s1 = SINPI[2] * x0 - SINPI[1] * x2 - SINPI[4] * x3
    s3b = SINPI[3] * x1
    s2 = SINPI[3] * (x0 - x2 + x3)
    return torch.stack([_rs(s0 + s3b, 12), _rs(s1 + s3b, 12),
                        _rs(s2, 12), _rs(s0 + s1 - s3b, 12)], dim=-1)


_1D = {("d", 4): idct4, ("d", 8): idct8, ("d", 16): idct16,
       ("d", 32): idct32, ("d", 64): idct64,
       ("a", 4): iadst4, ("a", 8): iadst8, ("a", 16): iadst16}

# (vertical kind, horizontal kind): DCT_DCT / ADST_DCT / DCT_ADST / ADST_ADST
_TX_KIND = {0: ("d", "d"), 1: ("a", "d"), 2: ("d", "a"), 3: ("a", "a")}

_ROW_SHIFT = {(4, 4): 0, (8, 8): 1, (16, 16): 2, (32, 32): 2, (64, 64): 2}


def _inverse_2d(coefs: torch.Tensor, w: int, h: int,
                tx_type: int) -> torch.Tensor:
    """The 2D inverse on (..., h, w) integer coefficients of any width."""
    vk, hk = _TX_KIND[tx_type]
    t = _rs(_1D[(hk, w)](coefs), _ROW_SHIFT[(w, h)])
    t = _1D[(vk, h)](t.transpose(-1, -2))
    return _rs(t.transpose(-1, -2), 4)


def inverse_transform(coefs: torch.Tensor, w: int, h: int,
                      tx_type: int = 0) -> torch.Tensor:
    """Normative 2D inverse transform.  coefs: (..., h, w) int32."""
    if w != h:
        raise ValueError("square transforms only")
    if coefs.dtype != torch.int32:
        raise TypeError(f"coefs must be int32, got {coefs.dtype}")
    return _inverse_2d(coefs, w, h, tx_type)


# The forward matrices built in this process, by (w, h, tx_type) and
# "fwd64".  Their np.linalg.pinv bits depend on the BLAS thread count and
# the larger ones take tens of seconds on the CPU, so a scene-batch worker
# process adopts its parent's (parallel/gop.py) instead of building its own.
_FORWARD: dict = {}


def forward_matrix(w: int, h: int, tx_type: int = 0) -> np.ndarray:
    """Encoder forward transform as a (h*w, h*w) float32 numpy matrix: the
    pseudo-inverse of the normative inverse linearized on unit coefficients
    of amplitude 1024 (int64 on the CPU), built as
    av1tpu/spec/transforms.py:_forward_matrix builds it, so the two agree
    bit for bit."""
    if w != h:
        raise ValueError("square transforms only")
    key = (w, h, tx_type)
    if key not in _FORWARD:
        n = h * w
        amp = 1 << 10
        units = (torch.eye(n, dtype=torch.int64) * amp).reshape(n, h, w)
        resp = _inverse_2d(units, w, h, tx_type).reshape(n, n).numpy()
        # column k is the response to unit coefficient k
        m = np.ascontiguousarray(resp.T).astype(np.float64) / amp
        _FORWARD[key] = np.linalg.pinv(m).astype(np.float32)
    return _FORWARD[key]


def fwd64() -> np.ndarray:
    """Forward transform for TX_64X64 as a (1024, 4096) float32 matrix: the
    pseudo-inverse of the integer inverse linearized over the 1024 coded
    (top-left 32x32) coefficients, the only ones the bitstream carries
    (av1tpu/models/intra_part.py:_fwd64, built from the port's own int64
    inverse)."""
    if "fwd64" not in _FORWARD:
        units = torch.zeros((1024, 64, 64), dtype=torch.int64)
        idx = torch.arange(1024)
        units[idx, idx // 32, idx % 32] = 1 << 12  # rounding fidelity
        pixels = _inverse_2d(units, 64, 64, 0).reshape(1024, 4096).numpy()
        _FORWARD["fwd64"] = np.linalg.pinv(
            (pixels / (1 << 12)).T).astype(np.float32)
    return _FORWARD["fwd64"]


def built_forward_matrices() -> dict:
    """The forward matrices this process has built so far."""
    return dict(_FORWARD)


def adopt_forward_matrices(mats: dict) -> None:
    """Take matrices built by another process (built_forward_matrices) as
    this process's own."""
    _FORWARD.update(mats)
