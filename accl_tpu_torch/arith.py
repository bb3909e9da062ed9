"""Arithmetic / datatype configuration registry.

An :class:`ArithConfig` names, for a pair of (uncompressed, compressed)
dtypes, how operands combine and travel on the wire. The registry is
keyed by the same dtype-name strings as ``accl_tpu/arith.py``; its
values hold torch dtypes.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def dtype_name(dtype) -> str:
    """Canonical name of a torch dtype, numpy dtype or dtype name
    ("float32", "bfloat16", "float8_e4m3fn", ...)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    if isinstance(dtype, str):
        return str(to_torch_dtype(dtype)).removeprefix("torch.")
    return np.dtype(dtype).name


def to_torch_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype, a numpy dtype or a name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    name = dtype if isinstance(dtype, str) else np.dtype(dtype).name
    out = getattr(torch, name, None)
    if not isinstance(out, torch.dtype):
        raise TypeError(f"no torch dtype named {name!r}")
    return out


@dataclasses.dataclass(frozen=True)
class ArithConfig:
    """Datatype-pair configuration for combine/compression.

    ``quant_block > 0`` means ETH_COMPRESSED traffic under this config
    is block-scale quantized with that many elements per scale."""

    uncompressed_dtype: torch.dtype
    compressed_dtype: torch.dtype
    quant_block: int = 0

    @property
    def is_compressing(self) -> bool:
        return self.uncompressed_dtype != self.compressed_dtype


def _mk(u: str, c: str) -> ArithConfig:
    return ArithConfig(to_torch_dtype(u), to_torch_dtype(c))


DEFAULT_ARITH_CONFIGS: dict[tuple[str, str], ArithConfig] = {
    k: _mk(*k) for k in [
        ("float32", "float32"), ("float64", "float64"),
        ("int32", "int32"), ("int64", "int64"),
        ("float16", "float16"), ("float32", "float16"),
        ("int8", "int8"), ("float32", "int8"),
        ("bfloat16", "bfloat16"), ("float32", "bfloat16"),
        ("float8_e4m3fn", "float8_e4m3fn"), ("float32", "float8_e4m3fn"),
        ("float8_e5m2", "float8_e5m2"), ("float32", "float8_e5m2"),
    ]
}


def resolve_arith_config(dtypes, registry=None) -> ArithConfig:
    """Resolve the dtype set of a call's operands to an ArithConfig: one
    dtype maps to the same-dtype config, a {wide, narrow} pair to the
    mixed config."""
    registry = registry if registry is not None else DEFAULT_ARITH_CONFIGS
    names = sorted({dtype_name(d) for d in dtypes})
    if len(names) == 1:
        key = (names[0], names[0])
    elif len(names) == 2:
        a, b = names
        if (a, b) in registry:
            key = (a, b)
        elif (b, a) in registry:
            key = (b, a)
        else:
            raise KeyError(f"no arithmetic config for dtype pair {names}")
    else:
        raise ValueError(f"calls may mix at most 2 dtypes, got {names}")
    if key not in registry:
        raise KeyError(f"no arithmetic config for dtype pair {key}")
    return registry[key]
