"""Planar YUV clip model, y4m IO and synthetic content (copy of
av1tpu/utils/yuv.py).

Only 4:2:0 subsampling is modeled; 8- and 10-bit depths are supported.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Clip", "read_y4m", "write_y4m", "synthetic_clip"]


@dataclasses.dataclass
class Clip:
    """A planar 4:2:0 YUV clip.

    y: (T, H, W)      uint8 (bit_depth 8) or uint16 (bit_depth 10)
    u: (T, H/2, W/2)
    v: (T, H/2, W/2)
    """

    y: np.ndarray
    u: np.ndarray
    v: np.ndarray
    bit_depth: int = 8
    fps_num: int = 30
    fps_den: int = 1

    @property
    def num_frames(self) -> int:
        return self.y.shape[0]

    @property
    def height(self) -> int:
        return self.y.shape[1]

    @property
    def width(self) -> int:
        return self.y.shape[2]

    def frame_planes(self, t: int):
        return self.y[t], self.u[t], self.v[t]

    def validate(self) -> None:
        t, h, w = self.y.shape
        if h % 2 or w % 2:
            raise ValueError(f"4:2:0 requires even dimensions, got {h}x{w}")
        if self.u.shape != (t, h // 2, w // 2) or self.v.shape != self.u.shape:
            raise ValueError("chroma plane shape mismatch")
        want = np.uint8 if self.bit_depth == 8 else np.uint16
        for p in (self.y, self.u, self.v):
            if p.dtype != want:
                raise ValueError(f"expected {want}, got {p.dtype}")


def _dtype_for_depth(bit_depth: int):
    if bit_depth == 8:
        return np.uint8
    if bit_depth == 10:
        return np.uint16
    raise ValueError(f"unsupported bit depth {bit_depth}")


def synthetic_clip(
    width: int = 192,
    height: int = 128,
    frames: int = 8,
    bit_depth: int = 8,
    seed: int = 0,
    motion: bool = True,
    noise: float = 2.0,
) -> Clip:
    """Deterministic synthetic content: smooth gradients, a moving textured
    box, and mild sensor noise (gradients exercise intra prediction, the box
    motion search, the noise quantization), fully reproducible."""
    rng = np.random.RandomState(seed)
    dt = _dtype_for_depth(bit_depth)
    maxv = (1 << bit_depth) - 1
    scale = maxv / 255.0

    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    base = 60 + 80 * (xx / width) + 40 * (yy / height)

    texture = rng.randint(0, 90, size=(height, width)).astype(np.float32)

    y = np.empty((frames, height, width), dtype=np.float32)
    u = np.empty((frames, height // 2, width // 2), dtype=np.float32)
    v = np.empty_like(u)

    bw, bh = max(8, width // 6), max(8, height // 6)
    for t in range(frames):
        f = base.copy()
        # moving textured box
        ox = (7 * t) % max(1, width - bw) if motion else 10
        oy = (3 * t) % max(1, height - bh) if motion else 10
        f[oy : oy + bh, ox : ox + bw] = (
            100 + texture[:bh, :bw] + (20 if motion else 0)
        )
        if noise > 0:
            f += rng.normal(0, noise, size=f.shape).astype(np.float32)
        y[t] = f
        cu = 110 + 30 * (xx[::2, ::2] / width) + (2 * t if motion else 0)
        cv = 130 - 30 * (yy[::2, ::2] / height)
        u[t], v[t] = cu, cv

    def q(p):
        return np.clip(p * scale, 0, maxv).round().astype(dt)

    return Clip(y=q(y), u=q(u), v=q(v), bit_depth=bit_depth)


def write_y4m(path: str, clip: Clip) -> None:
    clip.validate()
    cs = "420" if clip.bit_depth == 8 else "420p10"
    header = (
        f"YUV4MPEG2 W{clip.width} H{clip.height} "
        f"F{clip.fps_num}:{clip.fps_den} Ip A1:1 C{cs}\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        for t in range(clip.num_frames):
            f.write(b"FRAME\n")
            for plane in clip.frame_planes(t):
                f.write(np.ascontiguousarray(plane).tobytes())


def read_y4m(path: str) -> Clip:
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"\n"):
            c = f.read(1)
            if not c:
                raise ValueError("truncated y4m header")
            header += c
        fields = header.decode().strip().split(" ")
        if fields[0] != "YUV4MPEG2":
            raise ValueError("not a y4m file")
        w = h = None
        fps_num, fps_den = 30, 1
        bit_depth = 8
        for tok in fields[1:]:
            if tok.startswith("W"):
                w = int(tok[1:])
            elif tok.startswith("H"):
                h = int(tok[1:])
            elif tok.startswith("F"):
                fps_num, fps_den = (int(x) for x in tok[1:].split(":"))
            elif tok.startswith("C"):
                cs = tok[1:]
                if cs.startswith("420p10"):
                    bit_depth = 10
                elif not cs.startswith("420"):
                    raise ValueError(f"unsupported colorspace {cs}")
        if w is None or h is None:
            raise ValueError("y4m missing dimensions")

        dt = _dtype_for_depth(bit_depth)
        itemsize = np.dtype(dt).itemsize
        ysz, csz = w * h * itemsize, (w // 2) * (h // 2) * itemsize
        ys, us, vs = [], [], []
        while True:
            marker = f.readline()
            if not marker:
                break
            if not marker.startswith(b"FRAME"):
                raise ValueError("bad frame marker")
            raw = f.read(ysz + 2 * csz)
            if len(raw) != ysz + 2 * csz:
                raise ValueError("truncated frame")
            ys.append(np.frombuffer(raw[:ysz], dt).reshape(h, w))
            us.append(
                np.frombuffer(raw[ysz : ysz + csz], dt).reshape(h // 2, w // 2)
            )
            vs.append(np.frombuffer(raw[ysz + csz :], dt).reshape(h // 2, w // 2))
    return Clip(
        y=np.stack(ys),
        u=np.stack(us),
        v=np.stack(vs),
        bit_depth=bit_depth,
        fps_num=fps_num,
        fps_den=fps_den,
    )
