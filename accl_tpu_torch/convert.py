"""Per-rank operand data and wire formats between numpy and the port.

The state that crosses from the reference to the port is operand data
and wire formats. fp8 arrays travel as raw uint8 codes plus a dtype
name, so this module needs no ``ml_dtypes``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .arith import to_torch_dtype


def from_reference(arrays: Sequence[np.ndarray], device,
                   dtype: str | None = None) -> list[torch.Tensor]:
    """Per-rank numpy arrays -> rank tensors on ``device``. With
    ``dtype`` naming a 1-byte type ("float8_e4m3fn", "float8_e5m2",
    "int8"), the arrays hold its raw codes as uint8 and the tensors come
    back in that dtype."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if dtype is not None:
            t = torch.from_numpy(a.view(np.uint8).copy()).view(
                to_torch_dtype(dtype))
        else:
            t = torch.from_numpy(a.copy())
        out.append(t.to(device))
    return out


def wire_to_numpy(q: torch.Tensor, scales: torch.Tensor
                  ) -> tuple[np.ndarray, np.ndarray]:
    """A block-scaled wire payload -> (uint8 codes, f32 scales) for a
    bitwise comparison with the reference's ``bs_quantize`` outputs."""
    codes = q.detach().contiguous().view(torch.uint8).cpu().numpy()
    return codes, scales.detach().to(torch.float32).cpu().numpy()
