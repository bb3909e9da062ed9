"""Attention at head dims past 256 on the CPU, against the reference.

The reference's Pallas kernels take any head dim; the port's kernels take
any too: past ``COLS_HEAD_DIM`` (256) every kind runs a form of its own on
the card (the 16-bit column-group and cluster forms of
``csrc/attention_sm90.cu`` and ``csrc/attention_bwd_sm90.cu``; the f32
cluster forms of ``csrc/attention.cu`` and ``csrc/attention_bwd.cu``,
their band forms past 4096 and the split and band decodes of
``csrc/attention_decode.cu``), which ``chip_smoke.py`` holds to the plain
versions (phases 17a and 17e). Here
the same numpy inputs go through ``accl_tpu.ops.attention`` (Pallas in
interpret mode) and the port's wrappers on CPU tensors (the plain
versions) at D = 264, 320 and 512, per dtype: the forward (B8 and B9 by
the reference's block rule; ``test_torch_attention_wide_bwd.py`` holds
the gradients, B10 and B11, and B12's decode and chunked prefill on the
same cases); a tiny Llama with head dim 320 against the reference's
forward; and the wrapper's contract at those head dims
(``_kernel_ready``, ``_pad_d``, the route names of the C header).

Tolerances as ``test_torch_attention_dtypes.py``'s: f32 rtol = atol =
2e-5; 16-bit outputs within two ulps of the output scale, gradients
within four.
"""

from __future__ import annotations

import dataclasses
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from accl_tpu.models import llama as RL  # noqa: E402
from accl_tpu.ops import attention as R  # noqa: E402
from accl_tpu_torch.models import Llama, LlamaConfig  # noqa: E402
from accl_tpu_torch.ops import attention as A  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment."""
    yield


ROOT = pathlib.Path(__file__).resolve().parents[1]
F32_TOL = 2e-5
SIG = {"bfloat16": 8, "float16": 11}      # significant bits
CASES = [(dt, d) for d in (264, 320, 512)
         for dt in ("float32", "bfloat16", "float16")]


def _ids(case):
    return f"{case[0]}-d{case[1]}"


def _close(got: torch.Tensor, want, dtype: str, what: str, ulps: int = 2):
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert np.isfinite(g).all(), what
    if dtype == "float32":
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=what)
        return
    tol = ulps * 2.0 ** -(SIG[dtype] - 1) * float(np.abs(w).max())
    np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=what)


def _inputs(seed, shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("case", CASES, ids=_ids)
@pytest.mark.parametrize("bk", [None, 16])
def test_forward_matches_reference(case, bk):
    """O at S = 24, causal, GQA 2/1: B9 under the reference's own block
    (one block), B8 under block_k = 16 (two blocks)."""
    dtype, D = case
    B, H, Hkv, S = 1, 2, 1, 24
    xs = _inputs(D + (bk or 0), [(B, H, S, D), (B, Hkv, S, D),
                                 (B, Hkv, S, D)])
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = R.flash_attention(*(jnp.asarray(x).astype(jdt) for x in xs),
                             causal=True, block_k=bk)
    before = dict(A.plain_runs)
    o, lse = A.flash_attention_fwd(*(torch.from_numpy(x).to(tdt)
                                     for x in xs), causal=True, block_k=bk)
    single = bk is None
    assert A.plain_runs["fwd_single"] - before["fwd_single"] == int(single)
    assert A.plain_runs["fwd"] - before["fwd"] == int(not single)
    assert o.dtype == tdt and o.shape == (B, H, S, D)
    assert lse.shape == (B * H, S) and torch.isfinite(lse).all()
    _close(o, want, dtype, f"{case} block_k={bk} O")


def test_llama_head_dim_320_matches_reference():
    """A tiny Llama with head dim 320 (dim 640 over 2 q heads, 1 kv head),
    f32, the reference's parameters: the port's logits within f32's
    tolerance of the reference's ``forward``, and its cached prefill and
    decode equal to its own forward's last positions."""
    kw = dict(dim=640, n_layers=2, n_heads=2, n_kv_heads=1, ffn_dim=128)
    ref = RL.Llama(dataclasses.replace(RL.LlamaConfig.tiny(**kw),
                                       dtype=jnp.float32))
    params = jax.tree.map(np.asarray, ref.init(jax.random.key(3)))
    cfg = dataclasses.replace(LlamaConfig.tiny(**kw), dtype=torch.float32)
    assert cfg.head_dim == 320
    port = Llama(cfg, device="cpu").load_reference_params(params)
    tokens = np.random.default_rng(5).integers(0, 256, (2, 9)).astype(
        np.int32)
    want = np.asarray(ref.forward(params, jnp.asarray(tokens)), np.float32)
    got = port(torch.from_numpy(tokens).long()).float().numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
    cache = port.init_kv_cache(2, 9)
    pre, cache = port.forward_cached(torch.from_numpy(tokens[:, :8]).long(),
                                     cache)
    step, cache = port.forward_cached(torch.from_numpy(tokens[:, 8:]).long(),
                                      cache)
    np.testing.assert_allclose(pre.numpy(), got[:, :8], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(step.numpy(), got[:, 8:], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("D", [264, 320, 512, 1024])
def test_kernel_contract_takes_head_dims_past_256(D, dtype):
    """Every head dim past 256 reaches a kernel: the wrapper pads it (to a
    multiple of 8 for f32, of COLS_CHUNK = 128 for the 16-bit
    column-group kernels, whose chunks of S are whole TMA tiles) and the
    check every CUDA call makes before a launch takes the padded
    operands; the unpadded 16-bit ones it refuses, naming the step."""
    tdt = getattr(torch, dtype)
    ops = [torch.zeros(1, 2, 8, D, dtype=tdt) for _ in range(3)]
    padded = A._pad_d(*ops)
    step = 8 if dtype == "float32" else A.COLS_CHUNK
    assert padded[0].shape[-1] == -(-D // step) * step
    assert all(not p[..., D:].any() for p in padded)
    A._kernel_ready("flash_attention", *padded)
    if padded[0].shape[-1] != D:
        with pytest.raises(ValueError, match=f"multiple of {step}"):
            A._kernel_ready("flash_decode", *ops)


def test_column_group_routes_are_the_headers():
    """The wrapper's route names are the C header's ROUTE_* codes, the
    column-group forms ("_cols") among them, one for each kind and route
    family past 256."""
    text = (ROOT / "accl_tpu_torch" / "csrc" / "attention_route.cuh"
            ).read_text()
    codes = {int(n): name for name, n in
             re.findall(r"ROUTE_(\w+) = (\d+)", text)}
    assert set(codes) == set(A.ROUTES)
    for n, name in codes.items():
        parts = name.lower().split("_")
        if "cols" in parts:            # ROUTE_FWD_COLS_WGMMA -> fwd_wgmma_cols
            parts.remove("cols")
            parts.append("cols")
        assert A.ROUTES[n] == "_".join(parts), (n, name)
    cols = {r for r in A.ROUTES.values() if r.endswith("_cols")}
    assert cols == {f"{k}_{route}_cols"
                    for k in ("fwd", "fwd_single", "prefill", "decode",
                              "bwd_dkv", "bwd_dq")
                    for route in ("wgmma", "tf32")}


def test_padding_past_256_is_exact():
    """What the 16-bit column-group route runs at D = 264: q, k, v padded
    with zero columns to 384, the scale kept at 264 ** -0.5, the outputs
    sliced back: the forward, B10, B11 and B12 on the padded operands
    equal the unpadded plain versions within one bf16 ulp."""
    D, S = 264, 20
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(
        9, [(1, 2, S, D), (1, 1, S, D), (1, 1, S, D), (1, 2, S, D)]))
    qp, kp, vp, dop = A._pad_d(q, k, v, do)
    assert qp.shape[-1] == 384
    sc = D ** -0.5
    tol = dict(rtol=2.0 ** -7, atol=2.0 ** -8)
    o, lse = A.flash_attention_ref(q, k, v, True, sc)
    op, lsep = A.flash_attention_ref(qp, kp, vp, True, sc)
    torch.testing.assert_close(op[..., :D], o, **tol)
    assert not op[..., D:].any()
    torch.testing.assert_close(lsep, lse, rtol=1e-6, atol=1e-6)
    delta = (do.float() * o.float()).sum(-1).reshape(2, S)
    parts = A.flash_attention_bwd_dkv_ref(q, do, k, v, lse, delta, True, sc)
    pparts = A.flash_attention_bwd_dkv_ref(qp, dop, kp, vp, lse, delta, True,
                                           sc)
    dq = A.flash_attention_bwd_dq_ref(q, do, k, v, lse, delta, True, sc)
    pdq = A.flash_attention_bwd_dq_ref(qp, dop, kp, vp, lse, delta, True, sc)
    for a, b in zip(parts + (dq,), pparts + (pdq,)):
        assert not b[..., D:].any()
        torch.testing.assert_close(b[..., :D], a, **tol)
    cfg = dataclasses.replace(LlamaConfig.tiny(), dim=264 * 2, n_heads=2,
                              n_kv_heads=1)
    assert cfg.head_dim == D
