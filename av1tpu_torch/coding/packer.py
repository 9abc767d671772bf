"""ctypes bridge to the C++ tile packer (native/coding/pack.cpp).

Copy of the parts of av1tpu/coding/packer.py that the port calls: the
CDF carry blob, the keyframe's compact pack (fast and wavefront forms), the
partitioned keyframe's pack, the inter frame's pack and the partitioned
inter frame's pack.
The C++ source is shared with the JAX package; the port compiles its own
copy of the library into av1tpu_torch/_build/ (av1tpu_torch._build).
"""

from __future__ import annotations

import ctypes

import numpy as np

_I16P = ctypes.POINTER(ctypes.c_int16)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U16P = ctypes.POINTER(ctypes.c_uint16)


class Packer:
    """Serialize compact level transport buffers into AV1 tile payloads."""

    def __init__(self, lib_path: str | None = None):
        if lib_path is None:
            from av1tpu_torch._build import packer_lib_path
            lib_path = packer_lib_path()
        self._lib = ctypes.CDLL(lib_path)
        fi = self._lib.pack_tile_inter
        fi.restype = ctypes.c_size_t
        fi.argtypes = [_U16P] + [_I16P] * 4 + [ctypes.c_int] * 4 + \
                      [ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                       _I32P, _I32P]
        self._fni = fi
        fp = self._lib.pack_tile_inter_part
        fp.restype = ctypes.c_size_t
        fp.argtypes = [_U16P] + [_I16P] * 6 + [ctypes.c_int] + [_I16P] + \
                      [ctypes.c_int] * 4 + \
                      [ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                       _I32P, _I32P]
        self._fnp = fp
        fw = self._lib.av1pack_cdf_words
        fw.restype = ctypes.c_int
        fw.argtypes = []
        self.cdf_words = int(fw())
        f2u = self._lib.pack_tile_v2_uv
        f2u.restype = ctypes.c_size_t
        f2u.argtypes = [_U16P, _I16P, _I16P] + [ctypes.c_int] * 6 + \
                       [ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                        _I32P, _I32P, _I16P]
        self._fn2u = f2u
        f3 = self._lib.pack_tile_v3
        f3.restype = ctypes.c_size_t
        f3.argtypes = [_U16P] + [_I16P] * 5 + [ctypes.c_int] * 4 + \
                      [ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
                       _I32P, _I32P]
        self._fn3 = f3

    def new_cdf_blob(self) -> np.ndarray:
        """Allocate a CDF carry blob (one frame's end-of-frame CDF save;
        pass as cdf_out to a pack call, then as cdf_in to the next frame's
        — the C++ equivalent of the decoder's ref-slot CDF save/load)."""
        return np.zeros(self.cdf_words, np.int32)

    @staticmethod
    def _cdf_ptrs(cdf_in, cdf_out):
        null = _I32P()
        pi = cdf_in.ctypes.data_as(_I32P) if cdf_in is not None else null
        po = cdf_out.ctypes.data_as(_I32P) if cdf_out is not None else null
        return pi, po

    def pack_tile_compact(self, bitmap: np.ndarray, vals: np.ndarray,
                          height: int, width: int, qindex: int,
                          modes: np.ndarray, uv_mode: int = 1,
                          tx_from_mode: bool = False,
                          cdf_in: np.ndarray | None = None,
                          cdf_out: np.ndarray | None = None,
                          txd: np.ndarray | None = None) -> bytes:
        """Pack a keyframe from the compact form: significance bitmap
        (uint16 words) + nonzero values (int16) + per-block luma modes + a
        frame-wide chroma mode (V_PRED default; the wavefront keyframe
        uses DC, 0).  tx_from_mode: luma tx_type derived from the mode
        (Mode_To_Txfm, the wavefront keyframe); False = DCT everywhere.
        txd: optional per-block luma tx depth (0..2); its presence means
        the frame header signals TX_MODE_SELECT and every block codes a
        tx-depth symbol, with sub-tx luma levels in the 16x16 slot as
        raster tiles.  height/width: padded luma dims (multiples of 64)."""
        bm = np.ascontiguousarray(bitmap, np.uint16)
        vv = np.ascontiguousarray(vals, np.int16)
        mm = np.ascontiguousarray(modes, np.int16)
        tptr = _I16P()
        if txd is not None:
            tt = np.ascontiguousarray(txd, np.int16)
            tptr = tt.ctypes.data_as(_I16P)
        # worst case ~40 bits per coefficient (1.5 coefs per luma pixel)
        cap = height * width * 8 + 65536
        out = (ctypes.c_uint8 * cap)()
        n = self._fn2u(bm.ctypes.data_as(_U16P), vv.ctypes.data_as(_I16P),
                       mm.ctypes.data_as(_I16P), uv_mode, int(tx_from_mode),
                       height // 4, width // 4, qindex, 0, out, cap,
                       *self._cdf_ptrs(cdf_in, cdf_out), tptr)
        if n == 0:
            raise RuntimeError("pack_tile_v2 failed (buffer too small?)")
        return bytes(bytearray(out)[:n])

    def pack_tile_part(self, bitmap: np.ndarray, vals: np.ndarray,
                       modes16: np.ndarray, modes32: np.ndarray,
                       split: np.ndarray, split64: np.ndarray,
                       height: int, width: int, qindex: int,
                       cdf_in: np.ndarray | None = None,
                       cdf_out: np.ndarray | None = None) -> bytes:
        """Pack a keyframe from the partition-RDO compact form (the union
        layout of intra_part._part_compact_and_recon: bitmap, values, the
        16x16 and 32x32 luma modes and the 32/64 split maps)."""
        bm = np.ascontiguousarray(bitmap, np.uint16)
        arrs = [np.ascontiguousarray(a, np.int16)
                for a in (vals, modes16, modes32, split, split64)]
        cap = height * width * 8 + 65536
        out = (ctypes.c_uint8 * cap)()
        n = self._fn3(bm.ctypes.data_as(_U16P),
                      *(a.ctypes.data_as(_I16P) for a in arrs),
                      height // 4, width // 4, qindex, 0, out, cap,
                      *self._cdf_ptrs(cdf_in, cdf_out))
        if n == 0:
            raise RuntimeError("pack_tile_v3 failed (buffer too small?)")
        return bytes(bytearray(out)[:n])

    def pack_tile_inter(self, bitmap: np.ndarray, vals: np.ndarray,
                        mv: np.ndarray, height: int, width: int,
                        qindex: int, cdf_in: np.ndarray | None = None,
                        cdf_out: np.ndarray | None = None) -> bytes:
        """Pack one inter tile of the single-reference LAST chain from the
        compact form: significance bitmap + nonzero values + per-16x16-block
        MV grid (r16, c16, 2) int 1/8-pel."""
        bm = np.ascontiguousarray(bitmap, np.uint16)
        vv = np.ascontiguousarray(vals, np.int16)
        mv = np.asarray(mv)
        mvr = np.ascontiguousarray(mv[..., 0].reshape(-1), np.int16)
        mvc = np.ascontiguousarray(mv[..., 1].reshape(-1), np.int16)
        cap = height * width * 8 + 65536
        out = (ctypes.c_uint8 * cap)()
        n = self._fni(bm.ctypes.data_as(_U16P), vv.ctypes.data_as(_I16P),
                      mvr.ctypes.data_as(_I16P), mvc.ctypes.data_as(_I16P),
                      None, height // 4, width // 4, qindex, 0, out, cap,
                      *self._cdf_ptrs(cdf_in, cdf_out))
        if n == 0:
            raise RuntimeError("pack_tile_inter failed (buffer too small?)")
        return bytes(bytearray(out)[:n])

    def pack_tile_inter_part(self, bitmap: np.ndarray, vals: np.ndarray,
                             split32: np.ndarray, split64: np.ndarray,
                             mv: np.ndarray, height: int, width: int,
                             qindex: int,
                             cdf_in: np.ndarray | None = None,
                             cdf_out: np.ndarray | None = None,
                             refs: np.ndarray | None = None,
                             split16: np.ndarray | None = None) -> bytes:
        """Pack one partitioned inter tile (union-layout compact form +
        split maps + MV grid).  refs: optional per-16-block reference grid
        (0=LAST, 1=GOLDEN; merged blocks take their top-left entry).
        split16: optional per-16-block map; nonzero blocks split into four
        8x8 sub-blocks whose levels live in the parent slot's quadrants.
        The MV grid is per-16-block (h/16, w/16, 2) or per-8-block (h/8,
        w/8, 2), told apart by its shape; split16 needs the per-8 grid."""
        bm = np.ascontiguousarray(bitmap, np.uint16)
        vv = np.ascontiguousarray(vals, np.int16)
        s32 = np.ascontiguousarray(np.asarray(split32).reshape(-1), np.int16)
        s64 = np.ascontiguousarray(np.asarray(split64).reshape(-1), np.int16)
        mv = np.asarray(mv)
        mv_per8 = int(mv.shape[0] == height // 8)
        if split16 is not None and not mv_per8:
            raise ValueError("split16 needs a per-8-block MV grid")
        mvr = np.ascontiguousarray(mv[..., 0].reshape(-1), np.int16)
        mvc = np.ascontiguousarray(mv[..., 1].reshape(-1), np.int16)
        s16p = _I16P()
        if split16 is not None:
            s16 = np.ascontiguousarray(np.asarray(split16).reshape(-1),
                                       np.int16)
            s16p = s16.ctypes.data_as(_I16P)
        rfp = None
        if refs is not None:
            rf = np.ascontiguousarray(np.asarray(refs).reshape(-1), np.int16)
            rfp = rf.ctypes.data_as(_I16P)
        cap = height * width * 8 + 65536
        out = (ctypes.c_uint8 * cap)()
        n = self._fnp(bm.ctypes.data_as(_U16P), vv.ctypes.data_as(_I16P),
                      s16p, s32.ctypes.data_as(_I16P),
                      s64.ctypes.data_as(_I16P), mvr.ctypes.data_as(_I16P),
                      mvc.ctypes.data_as(_I16P), mv_per8, rfp,
                      height // 4, width // 4, qindex, 0, out, cap,
                      *self._cdf_ptrs(cdf_in, cdf_out))
        if n == 0:
            raise RuntimeError("pack_tile_inter_part failed")
        return bytes(bytearray(out)[:n])
