"""Kernels of the dataplane and of attention: hand-written CUDA C++
(csrc/) behind wrappers that run their plain PyTorch versions on CPU
tensors."""

from .attention import (flash_attention, flash_attention_fwd,
                        flash_attention_ref, flash_decode, flash_decode_ref)
from .combine import combine, combine_ref
from .compression import (bs_combine, bs_combine_requant, bs_dequant,
                          bs_dequant_combine, bs_dequantize, bs_quant,
                          bs_quantize, cast, cast_lane, compress_fp8,
                          decompress_fp8, fp8_dequant, fp8_dequantize,
                          fp8_quant, fp8_quantize, fp8_scale, wire_compress,
                          wire_decompress)

__all__ = ["combine", "combine_ref", "bs_quant", "bs_dequant",
           "bs_combine", "bs_quantize", "bs_dequantize",
           "bs_combine_requant", "bs_dequant_combine", "cast", "cast_lane",
           "fp8_scale", "fp8_quant", "fp8_dequant", "fp8_quantize",
           "fp8_dequantize", "compress_fp8", "decompress_fp8",
           "wire_compress", "wire_decompress", "flash_attention",
           "flash_attention_fwd", "flash_attention_ref", "flash_decode",
           "flash_decode_ref"]
