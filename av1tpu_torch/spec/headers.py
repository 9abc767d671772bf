"""AV1 sequence and frame header writers (spec sections 5.5, 5.9).

Copy of the header dataclasses and of the writers of av1tpu/spec/headers.py
that the port's TU wrappers call: the sequence header, the KEY and INTER
frame headers, and their tile-info and quantization parts.  The parsers
are not copied.
"""

from __future__ import annotations

import dataclasses

from av1tpu_torch.spec.bits import BitWriter

KEY_FRAME = 0
INTER_FRAME = 1

PRIMARY_REF_NONE = 7

TX_MODE_LARGEST = 1
TX_MODE_SELECT = 2


@dataclasses.dataclass
class SequenceHeader:
    seq_profile: int = 0
    still_picture: int = 0
    reduced_still_picture_header: int = 0
    seq_level_idx: int = 8
    seq_tier: int = 0
    frame_width_bits: int = 16
    frame_height_bits: int = 16
    max_frame_width: int = 0
    max_frame_height: int = 0
    frame_id_numbers_present: int = 0
    use_128x128_superblock: int = 0
    enable_filter_intra: int = 0
    enable_intra_edge_filter: int = 0
    enable_interintra_compound: int = 0
    enable_masked_compound: int = 0
    enable_warped_motion: int = 0
    enable_dual_filter: int = 0
    enable_order_hint: int = 0
    enable_jnt_comp: int = 0
    enable_ref_frame_mvs: int = 0
    seq_force_screen_content_tools: int = 0
    seq_force_integer_mv: int = 0
    order_hint_bits: int = 0
    enable_superres: int = 0
    enable_cdef: int = 0
    enable_restoration: int = 0
    # color config
    bit_depth: int = 8
    mono_chrome: int = 0
    color_primaries: int = 2  # unspecified
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_description_present: int = 0
    color_range: int = 0
    subsampling_x: int = 1
    subsampling_y: int = 1
    chroma_sample_position: int = 0
    separate_uv_delta_q: int = 0
    film_grain_params_present: int = 0

    @property
    def num_planes(self) -> int:
        return 1 if self.mono_chrome else 3


@dataclasses.dataclass
class TileInfo:
    uniform_spacing: int = 1
    tile_cols_log2: int = 0
    tile_rows_log2: int = 0
    tile_cols: int = 1
    tile_rows: int = 1
    mi_col_starts: list = dataclasses.field(default_factory=list)
    mi_row_starts: list = dataclasses.field(default_factory=list)
    context_update_tile_id: int = 0
    tile_size_bytes: int = 4


@dataclasses.dataclass
class FrameHeader:
    frame_type: int = KEY_FRAME
    show_frame: int = 1
    showable_frame: int = 0
    error_resilient_mode: int = 0
    disable_cdf_update: int = 0
    allow_screen_content_tools: int = 0
    frame_size_override: int = 0
    order_hint: int = 0
    primary_ref_frame: int = PRIMARY_REF_NONE
    refresh_frame_flags: int = 0xFF
    # inter: which of the 8 ref slots each of LAST..ALTREF points to
    ref_frame_idx: tuple = (0, 0, 0, 0, 0, 0, 0)
    width: int = 0
    height: int = 0
    render_width: int = 0
    render_height: int = 0
    use_superres: int = 0
    allow_intrabc: int = 0
    disable_frame_end_update_cdf: int = 0
    tiles: TileInfo = dataclasses.field(default_factory=TileInfo)
    # quantization
    base_q_idx: int = 0
    delta_q_y_dc: int = 0
    delta_q_u_dc: int = 0
    delta_q_u_ac: int = 0
    delta_q_v_dc: int = 0
    delta_q_v_ac: int = 0
    using_qmatrix: int = 0
    qm_y: int = 0
    qm_u: int = 0
    qm_v: int = 0
    delta_q_present: int = 0
    delta_q_res: int = 0
    delta_lf_present: int = 0
    delta_lf_res: int = 0
    delta_lf_multi: int = 0
    coded_lossless: int = 0
    all_lossless: int = 0
    # loop filter
    loop_filter_level: tuple = (0, 0, 0, 0)
    loop_filter_sharpness: int = 0
    loop_filter_delta_enabled: int = 0
    # cdef
    cdef_damping: int = 3
    cdef_bits: int = 0
    cdef_y_pri_strength: tuple = (0,)
    cdef_y_sec_strength: tuple = (0,)
    cdef_uv_pri_strength: tuple = (0,)
    cdef_uv_sec_strength: tuple = (0,)
    # loop restoration
    lr_type: tuple = (0, 0, 0)
    # modes
    tx_mode: int = TX_MODE_LARGEST
    reduced_tx_set: int = 0
    apply_grain: int = 0

    @property
    def mi_cols(self) -> int:
        return 2 * ((self.width + 7) >> 3)

    @property
    def mi_rows(self) -> int:
        return 2 * ((self.height + 7) >> 3)


def tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


def _compute_lossless(fh: FrameHeader):
    # all segments share base_q_idx here (no segmentation)
    fh.coded_lossless = int(
        fh.base_q_idx == 0 and fh.delta_q_y_dc == 0
        and fh.delta_q_u_dc == 0 and fh.delta_q_u_ac == 0
        and fh.delta_q_v_dc == 0 and fh.delta_q_v_ac == 0
    )
    fh.all_lossless = fh.coded_lossless and not fh.use_superres


def write_sequence_header(seq: SequenceHeader) -> bytes:
    bw = BitWriter()
    bw.f(seq.seq_profile, 3)
    bw.f(seq.still_picture, 1)
    bw.f(seq.reduced_still_picture_header, 1)
    assert not seq.reduced_still_picture_header
    bw.f(0, 1)  # timing_info_present
    bw.f(0, 1)  # initial_display_delay_present
    bw.f(0, 5)  # operating_points_cnt_minus_1
    bw.f(0, 12)  # operating_point_idc[0]
    bw.f(seq.seq_level_idx, 5)
    if seq.seq_level_idx > 7:
        bw.f(seq.seq_tier, 1)
    bw.f(seq.frame_width_bits - 1, 4)
    bw.f(seq.frame_height_bits - 1, 4)
    bw.f(seq.max_frame_width - 1, seq.frame_width_bits)
    bw.f(seq.max_frame_height - 1, seq.frame_height_bits)
    bw.f(seq.frame_id_numbers_present, 1)
    assert not seq.frame_id_numbers_present
    bw.f(seq.use_128x128_superblock, 1)
    bw.f(seq.enable_filter_intra, 1)
    bw.f(seq.enable_intra_edge_filter, 1)
    bw.f(seq.enable_interintra_compound, 1)
    bw.f(seq.enable_masked_compound, 1)
    bw.f(seq.enable_warped_motion, 1)
    bw.f(seq.enable_dual_filter, 1)
    bw.f(seq.enable_order_hint, 1)
    if seq.enable_order_hint:
        bw.f(seq.enable_jnt_comp, 1)
        bw.f(seq.enable_ref_frame_mvs, 1)
    if seq.seq_force_screen_content_tools == 2:
        bw.f(1, 1)
    else:
        bw.f(0, 1)
        bw.f(seq.seq_force_screen_content_tools, 1)
    if seq.seq_force_screen_content_tools > 0:
        if seq.seq_force_integer_mv == 2:
            bw.f(1, 1)
        else:
            bw.f(0, 1)
            bw.f(seq.seq_force_integer_mv, 1)
    if seq.enable_order_hint:
        bw.f(seq.order_hint_bits - 1, 3)
    bw.f(seq.enable_superres, 1)
    bw.f(seq.enable_cdef, 1)
    bw.f(seq.enable_restoration, 1)
    # color config
    high = int(seq.bit_depth > 8)
    bw.f(high, 1)
    if seq.seq_profile == 2 and high:
        bw.f(int(seq.bit_depth == 12), 1)
    if seq.seq_profile != 1:
        bw.f(seq.mono_chrome, 1)
    bw.f(seq.color_description_present, 1)
    if seq.color_description_present:
        bw.f(seq.color_primaries, 8)
        bw.f(seq.transfer_characteristics, 8)
        bw.f(seq.matrix_coefficients, 8)
    if not seq.mono_chrome:
        bw.f(seq.color_range, 1)
        if seq.seq_profile == 0:
            pass  # 4:2:0 implied
        else:
            raise NotImplementedError
        if seq.subsampling_x and seq.subsampling_y:
            bw.f(seq.chroma_sample_position, 2)
        bw.f(seq.separate_uv_delta_q, 1)
    else:
        bw.f(seq.color_range, 1)
    bw.f(seq.film_grain_params_present, 1)
    bw.trailing_bits()
    return bw.bytes()


def write_frame_header_key(
    seq: SequenceHeader, fh: FrameHeader, bw: BitWriter
) -> BitWriter:
    """Write an intra KEY frame header (without trailing bits: the caller
    appends tile group data when packing an OBU_FRAME)."""
    assert fh.frame_type == KEY_FRAME and fh.show_frame
    bw.f(0, 1)  # show_existing_frame
    bw.f(KEY_FRAME, 2)
    bw.f(1, 1)  # show_frame
    # error_resilient implied 1 for shown keyframes
    bw.f(fh.disable_cdf_update, 1)
    if seq.seq_force_screen_content_tools == 2:
        bw.f(fh.allow_screen_content_tools, 1)
    bw.f(fh.frame_size_override, 1)
    if seq.enable_order_hint:
        bw.f(fh.order_hint, seq.order_hint_bits)
    # refresh_frame_flags implied all for shown keyframe
    if fh.frame_size_override:
        bw.f(fh.width - 1, seq.frame_width_bits)
        bw.f(fh.height - 1, seq.frame_height_bits)
    if seq.enable_superres:
        bw.f(0, 1)
    bw.f(0, 1)  # render size same
    if fh.allow_screen_content_tools:
        bw.f(fh.allow_intrabc, 1)
    if not fh.disable_cdf_update:
        bw.f(fh.disable_frame_end_update_cdf, 1)
    _write_tile_info(bw, seq, fh)
    _write_quantization(bw, seq, fh)
    bw.f(0, 1)  # segmentation_enabled
    if fh.base_q_idx > 0:
        bw.f(fh.delta_q_present, 1)
    if fh.delta_q_present:
        bw.f(fh.delta_q_res, 2)
        if not fh.allow_intrabc:
            bw.f(fh.delta_lf_present, 1)
        if fh.delta_lf_present:
            bw.f(fh.delta_lf_res, 2)
            bw.f(fh.delta_lf_multi, 1)
    _compute_lossless(fh)
    # loop filter
    if not (fh.coded_lossless or fh.allow_intrabc):
        l0, l1, l2, l3 = fh.loop_filter_level
        bw.f(l0, 6)
        bw.f(l1, 6)
        if seq.num_planes > 1 and (l0 or l1):
            bw.f(l2, 6)
            bw.f(l3, 6)
        bw.f(fh.loop_filter_sharpness, 3)
        bw.f(fh.loop_filter_delta_enabled, 1)
        if fh.loop_filter_delta_enabled:
            bw.f(0, 1)  # no delta updates
    # cdef
    if not (fh.coded_lossless or fh.allow_intrabc) and seq.enable_cdef:
        bw.f(fh.cdef_damping - 3, 2)
        bw.f(fh.cdef_bits, 2)
        for i in range(1 << fh.cdef_bits):
            bw.f(fh.cdef_y_pri_strength[i], 4)
            bw.f(fh.cdef_y_sec_strength[i], 2)
            bw.f(fh.cdef_uv_pri_strength[i], 4)
            bw.f(fh.cdef_uv_sec_strength[i], 2)
    # loop restoration
    if not (fh.all_lossless or fh.allow_intrabc) and seq.enable_restoration:
        for p in range(seq.num_planes):
            bw.f(fh.lr_type[p], 2)
        assert not any(fh.lr_type), "LR writing not implemented"
    # tx mode
    if not fh.coded_lossless:
        bw.f(int(fh.tx_mode == TX_MODE_SELECT), 1)
    bw.f(fh.reduced_tx_set, 1)
    if seq.film_grain_params_present and (fh.show_frame or fh.showable_frame):
        bw.f(fh.apply_grain, 1)
        assert not fh.apply_grain
    return bw


def write_frame_header_inter(
    seq: SequenceHeader, fh: FrameHeader, bw: BitWriter
) -> BitWriter:
    """Write a shown INTER frame header for this encoder's operating point:
    no order hints, primary_ref_frame = NONE (per-frame CDF reset) or 0
    (LAST: CDFs carried from the previous frame's saved state), all
    seven ref slots -> slot 0 (LAST = previous frame), refresh slot 0,
    force_integer_mv = 0 with allow_high_precision_mv = 0 (the encoder
    restricts itself to quarter/full-pel MVs), non-switchable EIGHTTAP
    filter, single reference mode, global motion identity."""
    assert fh.frame_type == INTER_FRAME and fh.show_frame
    assert not seq.enable_order_hint and not seq.enable_ref_frame_mvs
    bw.f(0, 1)  # show_existing_frame
    bw.f(INTER_FRAME, 2)
    bw.f(1, 1)  # show_frame (showable implied 1)
    bw.f(fh.error_resilient_mode, 1)
    assert not fh.error_resilient_mode
    bw.f(fh.disable_cdf_update, 1)
    if seq.seq_force_screen_content_tools == 2:
        bw.f(fh.allow_screen_content_tools, 1)
    assert not fh.allow_screen_content_tools  # force_integer_mv stays 0
    bw.f(fh.frame_size_override, 1)
    assert not fh.frame_size_override
    # PRIMARY_REF_NONE resets CDFs per frame; a real slot (0 = LAST) loads
    # the previous frame's saved CDFs
    bw.f(fh.primary_ref_frame, 3)
    assert (fh.primary_ref_frame == PRIMARY_REF_NONE
            or fh.primary_ref_frame == 0)
    bw.f(fh.refresh_frame_flags, 8)
    assert fh.refresh_frame_flags != 0xFF
    for i in range(7):
        bw.f(fh.ref_frame_idx[i], 3)
    # frame_size(): no override -> max dims, no bits; render_size():
    if seq.enable_superres:
        bw.f(0, 1)
    bw.f(0, 1)  # render_and_frame_size_different
    bw.f(0, 1)  # allow_high_precision_mv (force_integer_mv == 0)
    bw.f(0, 1)  # is_filter_switchable = 0
    bw.f(0, 2)  # interpolation_filter = EIGHTTAP
    bw.f(0, 1)  # is_motion_mode_switchable
    # use_ref_frame_mvs: seq disables -> no bit
    if not fh.disable_cdf_update:
        bw.f(fh.disable_frame_end_update_cdf, 1)
    _write_tile_info(bw, seq, fh)
    _write_quantization(bw, seq, fh)
    bw.f(0, 1)  # segmentation_enabled
    if fh.base_q_idx > 0:
        bw.f(fh.delta_q_present, 1)
        assert not fh.delta_q_present
    _compute_lossless(fh)
    if not fh.coded_lossless:
        l0, l1, l2, l3 = fh.loop_filter_level
        bw.f(l0, 6)
        bw.f(l1, 6)
        if seq.num_planes > 1 and (l0 or l1):
            bw.f(l2, 6)
            bw.f(l3, 6)
        bw.f(fh.loop_filter_sharpness, 3)
        bw.f(fh.loop_filter_delta_enabled, 1)
        if fh.loop_filter_delta_enabled:
            bw.f(0, 1)  # no delta updates
    # cdef (same syntax as the key header)
    if not (fh.coded_lossless or fh.allow_intrabc) and seq.enable_cdef:
        bw.f(fh.cdef_damping - 3, 2)
        bw.f(fh.cdef_bits, 2)
        for i in range(1 << fh.cdef_bits):
            bw.f(fh.cdef_y_pri_strength[i], 4)
            bw.f(fh.cdef_y_sec_strength[i], 2)
            bw.f(fh.cdef_uv_pri_strength[i], 4)
            bw.f(fh.cdef_uv_sec_strength[i], 2)
    assert not seq.enable_restoration
    if not fh.coded_lossless:
        bw.f(int(fh.tx_mode == TX_MODE_SELECT), 1)
    bw.f(0, 1)  # reference_select = 0 (single reference mode)
    # skip_mode_present: not allowed without compound + order hints -> no bit
    # allow_warped_motion: seq disables -> no bit
    bw.f(fh.reduced_tx_set, 1)
    for _ in range(7):  # global motion per ref: is_global = 0 (IDENTITY)
        bw.f(0, 1)
    assert not seq.film_grain_params_present
    return bw


def _write_tile_info(bw: BitWriter, seq: SequenceHeader, fh: FrameHeader):
    t = fh.tiles
    sb_shift = 5 if seq.use_128x128_superblock else 4
    sb_cols = (fh.mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (fh.mi_rows + (1 << sb_shift) - 1) >> sb_shift
    sb_size = sb_shift + 2
    max_tile_width_sb = 4096 >> sb_size
    max_tile_area_sb = (4096 * 2304) >> (2 * sb_size)
    min_log2_cols = tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = tile_log2(1, min(sb_cols, 64))
    max_log2_rows = tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(
        min_log2_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols)
    )
    assert t.uniform_spacing
    bw.f(1, 1)
    assert t.tile_cols_log2 >= min_log2_cols, "tile cols below minimum"
    for _ in range(t.tile_cols_log2 - min_log2_cols):
        bw.f(1, 1)
    if t.tile_cols_log2 < max_log2_cols:
        bw.f(0, 1)
    tile_width_sb = (sb_cols + (1 << t.tile_cols_log2) - 1) >> t.tile_cols_log2
    t.mi_col_starts = [
        min(i * (tile_width_sb << sb_shift), fh.mi_cols)
        for i in range(0, (sb_cols + tile_width_sb - 1) // tile_width_sb + 1)
    ]
    t.tile_cols = len(t.mi_col_starts) - 1
    min_log2_rows = max(min_log2_tiles - t.tile_cols_log2, 0)
    assert t.tile_rows_log2 >= min_log2_rows
    for _ in range(t.tile_rows_log2 - min_log2_rows):
        bw.f(1, 1)
    if t.tile_rows_log2 < max_log2_rows:
        bw.f(0, 1)
    tile_height_sb = (sb_rows + (1 << t.tile_rows_log2) - 1) >> t.tile_rows_log2
    t.mi_row_starts = [
        min(i * (tile_height_sb << sb_shift), fh.mi_rows)
        for i in range(0, (sb_rows + tile_height_sb - 1) // tile_height_sb + 1)
    ]
    t.tile_rows = len(t.mi_row_starts) - 1
    if t.tile_cols_log2 > 0 or t.tile_rows_log2 > 0:
        bw.f(t.context_update_tile_id, t.tile_rows_log2 + t.tile_cols_log2)
        bw.f(t.tile_size_bytes - 1, 2)


def _write_quantization(bw: BitWriter, seq: SequenceHeader, fh: FrameHeader):
    bw.f(fh.base_q_idx, 8)
    for dq in (fh.delta_q_y_dc,):
        bw.f(int(dq != 0), 1)
        if dq:
            bw.su(dq, 7)
    if seq.num_planes > 1:
        if seq.separate_uv_delta_q:
            bw.f(0, 1)
        for dq in (fh.delta_q_u_dc, fh.delta_q_u_ac):
            bw.f(int(dq != 0), 1)
            if dq:
                bw.su(dq, 7)
    bw.f(fh.using_qmatrix, 1)
    if fh.using_qmatrix:
        bw.f(fh.qm_y, 4)
        bw.f(fh.qm_u, 4)
        if seq.separate_uv_delta_q:
            bw.f(fh.qm_v, 4)
