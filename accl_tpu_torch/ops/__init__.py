"""Kernels of the dataplane: hand-written CUDA C++ (csrc/) behind
wrappers that run their plain PyTorch versions on CPU tensors."""

from .combine import combine, combine_ref
from .compression import (bs_combine, bs_combine_requant, bs_dequant,
                          bs_dequant_combine, bs_dequantize, bs_quant,
                          bs_quantize)

__all__ = ["combine", "combine_ref", "bs_quant", "bs_dequant",
           "bs_combine", "bs_quantize", "bs_dequantize",
           "bs_combine_requant", "bs_dequant_combine"]
