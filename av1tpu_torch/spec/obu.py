"""OBU framing (spec section 5.3) and the IVF writer.

Copy of the writers of av1tpu/spec/obu.py.
"""

from __future__ import annotations

import struct

from av1tpu_torch.spec.bits import write_leb128

OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME = 6


def build_obu(otype: int, payload: bytes) -> bytes:
    header = bytes([(otype << 3) | 0x02])  # has_size_field=1, no extension
    return header + write_leb128(len(payload)) + payload


def temporal_delimiter() -> bytes:
    return build_obu(OBU_TEMPORAL_DELIMITER, b"")


def write_ivf(path: str, frames: list[bytes], width: int, height: int,
              fps_num: int = 30, fps_den: int = 1) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack(
            "<4sHH4sHHIII4x", b"DKIF", 0, 32, b"AV01",
            width, height, fps_num, fps_den, len(frames),
        ))
        for i, data in enumerate(frames):
            f.write(struct.pack("<IQ", len(data), i))
            f.write(data)
