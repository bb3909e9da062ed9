"""Block-scaled quantized wire: constants and dtype names.

The port's own copy of what the device codec needs from
``accl_tpu/quant.py``. Semantics per block of ``block`` elements:

* ``amax = max(|x|)`` (NaN-propagating);
* ``scale = amax / qmax``, set to 1.0 unless positive, normal and finite;
* ``q = encode(x * (1/scale))`` — fp8 round-to-nearest-even with e4m3fn
  overflow to NaN and e5m2 overflow to inf; int8 rounds half to even,
  clips to +-127 and quantizes non-finite values to 0;
* ``x' = float32(q) * scale`` — one f32 rounding.

A message on the block-scaled wire counts the reference's packed
segment: an ``HDR_BYTES`` header (magic, code, block, count), one f32
scale a block and one byte a code (:func:`packed_nbytes`). The port keeps
codes and scales as two tensors; the header is a logical count.

The kernels live in :mod:`accl_tpu_torch.ops.compression`.
"""

from __future__ import annotations

import torch

MIN_BLOCK = 32
MAX_BLOCK = 4096
DEFAULT_BLOCK = 128
HDR_BYTES = 8    # the packed segment's header: u8 magic, u8 code, u16, u32

_FLT_MIN = 1.1754943508222875e-38   # smallest normal f32

# quantizable wire dtype names -> qmax
_QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0, "float8_e5m2": 57344.0}
WIRE_DTYPE_NAMES = tuple(_QMAX)

# name -> torch dtype of the wire codes
WIRE_DTYPES = {"int8": torch.int8,
               "float8_e4m3fn": torch.float8_e4m3fn,
               "float8_e5m2": torch.float8_e5m2}

# wire dtype -> the integer code the kernels take
WIRE_CODES = {"int8": 0, "float8_e4m3fn": 1, "float8_e5m2": 2}


def clamp_block(block: int) -> int:
    """Clamp a requested block size into [MIN_BLOCK, MAX_BLOCK], rounded
    down to a power of two."""
    b = max(MIN_BLOCK, min(MAX_BLOCK, int(block)))
    return 1 << (b.bit_length() - 1)


def n_blocks(count: int, block: int) -> int:
    return -(-int(count) // int(block))


def packed_nbytes(count: int, block: int, qbytes: int = 1) -> int:
    """Wire bytes of one packed block-scaled message of ``count``
    elements: header, scales, codes."""
    return HDR_BYTES + 4 * n_blocks(count, block) + int(count) * qbytes
