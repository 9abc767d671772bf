"""Bit writer for AV1 uncompressed syntax (spec sections 4 and 5.3).

Copy of the writers of av1tpu/spec/bits.py.  Headers are plain big-endian
bit strings; only tile payloads use the range coder (the C++ packer).
"""

from __future__ import annotations

__all__ = ["BitWriter", "write_leb128"]


class BitWriter:
    def __init__(self):
        self.bits: list[int] = []

    def f(self, v: int, n: int) -> "BitWriter":
        assert 0 <= v < (1 << n), (v, n)
        for i in range(n - 1, -1, -1):
            self.bits.append((v >> i) & 1)
        return self

    def su(self, v: int, n: int) -> "BitWriter":
        sign_mask = 1 << (n - 1)
        if v < 0:
            v += 2 * sign_mask
        return self.f(v, n)

    def byte_align(self) -> "BitWriter":
        while len(self.bits) % 8:
            self.bits.append(0)
        return self

    def trailing_bits(self) -> "BitWriter":
        """spec trailing_bits(): a 1 then zeros to byte alignment."""
        self.bits.append(1)
        return self.byte_align()

    def bytes(self) -> bytes:
        assert len(self.bits) % 8 == 0, "call byte_align()/trailing_bits()"
        out = bytearray(len(self.bits) // 8)
        for i, b in enumerate(self.bits):
            if b:
                out[i >> 3] |= 1 << (7 - (i & 7))
        return bytes(out)


def write_leb128(v: int, min_bytes: int = 1) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v or len(out) + 1 < min_bytes:
            out.append(b | 0x80)
        else:
            out.append(b)
            break
    return bytes(out)
