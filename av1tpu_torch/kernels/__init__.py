"""The port's hand kernels: each module holds a CUDA kernel's wrapper, with
its launch counter, beside its plain PyTorch version."""


def hand_kernels() -> tuple:
    """Every hand kernel's wrapper, each with its launch counter
    (`wrapper.launches`, a plain integer: one per kernel launch; the
    motion search's wrappers launch several kernels per call)."""
    from av1tpu_torch.kernels.cdef import cdef_filter
    from av1tpu_torch.kernels.deblock import deblock_edges
    from av1tpu_torch.kernels.inter_code import code_blocks
    from av1tpu_torch.kernels.intra_part import (
        part_chain, part_code, part_merge, part_pred,
    )
    from av1tpu_torch.kernels.intra_wave import wave_key
    from av1tpu_torch.kernels.motion import (
        coarse_search, global_search, refine_subpel,
    )
    from av1tpu_torch.kernels.transform_quant import transform_quantize

    return (transform_quantize, wave_key, code_blocks, cdef_filter,
            coarse_search, global_search, refine_subpel,
            deblock_edges, part_chain, part_pred, part_code, part_merge)
