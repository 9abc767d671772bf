"""The encoder's header configuration (copy of av1tpu/spec/encode_frame.py:26-78,
165-185): EncoderConfig and the sequence, KEY and INTER frame headers
made from it.  The spec engine's tile coder is not copied.
"""

from __future__ import annotations

import dataclasses

from av1tpu_torch.spec.enums import BLOCK_16X16
from av1tpu_torch.spec.headers import (
    INTER_FRAME, TX_MODE_SELECT, FrameHeader, SequenceHeader,
)


@dataclasses.dataclass
class EncoderConfig:
    base_q_idx: int = 100
    leaf_bsize: int = BLOCK_16X16
    bit_depth: int = 8
    disable_cdf_update: int = 0
    tx_mode_select: int = 0  # 1 = TX_MODE_SELECT (per-block tx depth)
    loop_filter_level: tuple = (0, 0, 0, 0)
    loop_filter_sharpness: int = 0
    # CDEF (spec 7.15): cdef_bits = 0, one frame-wide strength preset.
    # Strengths are the coded header values (sec == 3 means 4).
    enable_cdef: int = 0
    cdef_damping: int = 3
    cdef_y_pri: int = 0
    cdef_y_sec: int = 0
    cdef_uv_pri: int = 0
    cdef_uv_sec: int = 0


def make_sequence_header(width: int, height: int,
                         cfg: EncoderConfig) -> SequenceHeader:
    seq = SequenceHeader()
    seq.seq_profile = 0
    seq.seq_level_idx = 8
    seq.frame_width_bits = max(width - 1, 1).bit_length()
    seq.frame_height_bits = max(height - 1, 1).bit_length()
    seq.max_frame_width = width
    seq.max_frame_height = height
    seq.bit_depth = cfg.bit_depth
    seq.enable_cdef = cfg.enable_cdef
    return seq


def make_frame_header(seq: SequenceHeader, cfg: EncoderConfig) -> FrameHeader:
    fh = FrameHeader()
    fh.width = seq.max_frame_width
    fh.height = seq.max_frame_height
    fh.render_width, fh.render_height = fh.width, fh.height
    fh.base_q_idx = cfg.base_q_idx
    fh.disable_cdf_update = cfg.disable_cdf_update
    fh.disable_frame_end_update_cdf = 1
    if cfg.tx_mode_select:
        fh.tx_mode = TX_MODE_SELECT
    fh.loop_filter_level = cfg.loop_filter_level
    fh.loop_filter_sharpness = cfg.loop_filter_sharpness
    if cfg.enable_cdef:
        fh.cdef_damping = cfg.cdef_damping
        fh.cdef_y_pri_strength = (cfg.cdef_y_pri,)
        fh.cdef_y_sec_strength = (cfg.cdef_y_sec,)
        fh.cdef_uv_pri_strength = (cfg.cdef_uv_pri,)
        fh.cdef_uv_sec_strength = (cfg.cdef_uv_sec,)
    return fh


def make_frame_header_inter(seq: SequenceHeader,
                            cfg: EncoderConfig,
                            golden: bool = False,
                            refresh: bool = True) -> FrameHeader:
    """Inter frame header at this encoder's operating point: LAST = slot 0
    (the previous frame), refresh slot 0, CDFs reset per frame
    (PRIMARY_REF_NONE), reduced tx set (inter tx-type set 3).  golden:
    also map GOLDEN to slot 1 — the scene keyframe, which refreshes every
    slot (0xFF) and stays in slot 1 because inter frames only refresh
    slot 0.  refresh=False codes a non-reference frame
    (refresh_frame_flags = 0)."""
    fh = make_frame_header(seq, cfg)
    fh.frame_type = INTER_FRAME
    fh.refresh_frame_flags = 0x01 if refresh else 0x00
    fh.ref_frame_idx = ((0, 0, 0, 1, 0, 0, 0) if golden
                        else (0, 0, 0, 0, 0, 0, 0))
    fh.reduced_tx_set = 1
    return fh
