"""TF32 rounding for the CPU tests that emulate the tensor-core kernels'
3xTF32 arithmetic (``csrc/tile_fused_gemm_spmm.cu``, ``csrc/fused_ffn.cu``).
"""
import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 → the nearest TF32 value (10 mantissa bits; ties away from zero,
    as ``cvt.rna``): add half of the dropped 13 bits, then clear them."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
