"""Per-rank operand data and wire formats between numpy and the port.

The state that crosses from the reference to the port is operand data
and wire payloads: per-tensor lanes (f16 / bf16 / fp8 codes, with one
f32 scale per payload or per leading row for fp8) and the block-scaled
lane (int8 / fp8 codes with per-block f32 scales). Wire codes travel as
raw bits (uint8 for 1-byte types, uint16 for f16 / bf16) plus a dtype
name, so this module needs no ``ml_dtypes``. The reference Llama's
parameter pytree maps onto the port's ``state_dict`` the same way
(``llama_params_from_reference``) and back
(``llama_params_to_reference``, whose bf16 leaves take numpy's
"bfloat16" type where ``ml_dtypes`` has registered it), the
mixture-of-experts Llama's expert leaves too, and so does a bare
``MoELayer``'s dict (``moe_params_from_reference`` and
``moe_params_to_reference``).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .arith import to_torch_dtype

# code width -> (numpy dtype the raw codes are returned in, the signed
# view torch and numpy share for them)
_RAW = {1: (np.uint8, np.uint8), 2: (np.uint16, np.int16)}


def from_reference(arrays: Sequence[np.ndarray], device,
                   dtype: str | None = None) -> list[torch.Tensor]:
    """Per-rank numpy arrays -> rank tensors on ``device``. With
    ``dtype`` naming a wire type ("float16", "bfloat16", "float8_e4m3fn",
    "float8_e5m2", "int8"), the arrays hold its raw codes (any dtype of
    its width: uint16 bits, uint8 codes, or the ml_dtypes array itself)
    and the tensors come back in that dtype."""
    out = []
    for a in arrays:
        a = np.ascontiguousarray(a)
        if dtype is not None:
            tdt = to_torch_dtype(dtype)
            t = torch.from_numpy(a.view(_RAW[tdt.itemsize][1]).copy())
            t = t.view(tdt)
        else:
            t = torch.from_numpy(a.copy())
        out.append(t.to(device))
    return out


def wire_to_numpy(q: torch.Tensor, scales: torch.Tensor | None = None
                  ) -> tuple[np.ndarray, np.ndarray | None]:
    """A wire payload -> (raw codes: uint8 for 1-byte types, uint16 for
    f16 / bf16; f32 scales or None) for a bitwise comparison with the
    reference's payloads (``bs_quantize``, ``fp8_quantize``,
    ``compress_fp8``, ``cast_lane``)."""
    out_np, shared = _RAW[q.element_size()]
    codes = q.detach().contiguous().view(
        getattr(torch, np.dtype(shared).name)).cpu().numpy().view(out_np)
    if scales is None:
        return codes, None
    return codes, scales.detach().to(torch.float32).cpu().numpy()


# the reference Llama's parameter pytree (accl_tpu/models/llama.py
# ``Llama.init``, dense FFN): top-level leaves and stacked layer leaves
LLAMA_TOP_KEYS = ("embed", "final_norm", "lm_head")
LLAMA_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                    "w_gate", "w_up", "w_down")
# an MoELayer's leaves (accl_tpu/models/moe.py ``MoELayer.init``): router
# (d, E), w_gate and w_up (E, d, f), w_down (E, f, d); in the MoE Llama
# each is stacked over the layers, its port name ``layers.<i>.moe.<key>``
MOE_KEYS = ("router", "w_gate", "w_up", "w_down")
LLAMA_MOE_LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                        *MOE_KEYS)


def llama_layer_keys(moe: bool) -> tuple:
    """The reference's stacked layer leaves, dense or with experts."""
    return LLAMA_MOE_LAYER_KEYS if moe else LLAMA_LAYER_KEYS


def port_layer_name(key: str, moe: bool) -> str:
    """A reference layer leaf's name in one port layer's state dict."""
    return f"moe.{key}" if moe and key in MOE_KEYS else key


def _leaf_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf -> a CPU tensor of the same dtype; bf16 (ml_dtypes)
    travels through its uint16 bits."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _require_keys(got, want, where: str):
    got, want = set(got), set(want)
    if got != want:
        raise KeyError(f"reference Llama params{where}: missing "
                       f"{sorted(want - got)}, unexpected "
                       f"{sorted(got - want)}")


def llama_params_from_reference(params: dict) -> dict:
    """The reference Llama's parameter pytree (numpy leaves; layer leaves
    stacked along a leading n_layers axis) -> the port's ``state_dict``
    (``embed``, ``layers.<i>.<name>``, ``final_norm``, ``lm_head``; an
    expert leaf ``layers.<i>.moe.<name>``), one slice per layer, dtypes
    kept. A ``router`` leaf marks the mixture-of-experts Llama. Raises
    ``KeyError`` on a missing or an unexpected key."""
    _require_keys(params, LLAMA_TOP_KEYS + ("layers",), "")
    layers = params["layers"]
    moe = "router" in layers
    keys = llama_layer_keys(moe)
    _require_keys(layers, keys, "['layers']")
    out = {k: _leaf_tensor(params[k]) for k in LLAMA_TOP_KEYS}
    n_layers = {np.shape(layers[k])[0] for k in keys}
    if len(n_layers) != 1:
        raise ValueError(f"reference Llama params: layer leaves disagree "
                         f"on the layer count {sorted(n_layers)}")
    for name in keys:
        stacked = _leaf_tensor(layers[name])
        for i in range(stacked.shape[0]):
            out[f"layers.{i}.{port_layer_name(name, moe)}"] = \
                stacked[i].clone()
    return out


def moe_params_from_reference(params: dict) -> dict:
    """A reference ``MoELayer``'s parameter dict (numpy leaves) -> the
    port's ``MoELayer`` state dict, dtypes kept."""
    _require_keys(params, MOE_KEYS, " (MoELayer)")
    return {k: _leaf_tensor(params[k]) for k in MOE_KEYS}


def moe_params_to_reference(tensors: dict) -> dict:
    """The inverse of :func:`moe_params_from_reference`."""
    _require_keys(tensors, MOE_KEYS, " (MoELayer port keys)")
    return {k: _leaf_numpy(tensors[k]) for k in MOE_KEYS}


def _leaf_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor -> a numpy leaf of the same dtype; bf16 travels through
    its int16 bits into numpy's "bfloat16", the type ``ml_dtypes``
    registers wherever the reference runs (this module imports none)."""
    t = t.detach().cpu().contiguous()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    try:
        bf16 = np.dtype("bfloat16")
    except TypeError:
        raise TypeError("a bf16 leaf needs numpy's bfloat16 type: import "
                        "ml_dtypes (or jax) first") from None
    return t.view(torch.int16).numpy().view(bf16)


def llama_params_to_reference(tensors: dict) -> dict:
    """The inverse of :func:`llama_params_from_reference`: the port's
    ``state_dict`` (or the same keys mapped to gradients) -> the
    reference's parameter pytree of numpy leaves, layer leaves stacked
    along a leading n_layers axis, dtypes kept. Raises ``KeyError`` on a
    missing or an unexpected key."""
    n_layers = len({k.split(".")[1] for k in tensors
                    if k.startswith("layers.")})
    moe = "layers.0.moe.router" in tensors
    keys = llama_layer_keys(moe)
    _require_keys(tensors, LLAMA_TOP_KEYS + tuple(
        f"layers.{i}.{port_layer_name(name, moe)}" for i in range(n_layers)
        for name in keys), " (port keys)")
    out = {k: _leaf_numpy(tensors[k]) for k in LLAMA_TOP_KEYS}
    out["layers"] = {name: np.stack([
        _leaf_numpy(tensors[f"layers.{i}.{port_layer_name(name, moe)}"])
        for i in range(n_layers)]) for name in keys}
    return out
