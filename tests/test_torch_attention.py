"""The port's attention (B8, B9, B12 and their dispatch) against the
reference's, on the CPU.

The same numpy inputs go through ``accl_tpu.ops.attention`` (Pallas in
interpret mode, as ``test_ops.py`` runs it) and through
``accl_tpu_torch.ops.attention``, whose wrappers run the plain versions
on CPU tensors. Tolerances: f32 outputs and every LSE within rtol = atol
= 2e-5 (one f32 softmax computed in another summation order); a bf16
output within one bf16 ulp of the output scale (2^-7 * max |O|: both
sides round the same f32 value, which may sit on either side of a
rounding boundary).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from accl_tpu.ops import attention as R  # noqa: E402
from accl_tpu_torch.ops import attention as A  # noqa: E402
from conftest import dense_attention  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


F32_TOL = 2e-5


def _inputs(seed, B, H, Hkv, Sq, Skv, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, Sq, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32))


def _to_jax(xs, dtype):
    return [jnp.asarray(x).astype(dtype) for x in xs]


def _to_torch(xs, dtype):
    return [torch.from_numpy(x).to(dtype) for x in xs]


def _close_out(got: torch.Tensor, want, bf16: bool, what: str):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert np.isfinite(g).all(), what
    if bf16:
        tol = 2.0 ** -7 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=what)


# (B, H, Hkv, Sq, Skv, D, causal, block_q, block_k, branch)
CASES = {
    "mha-causal-single": (1, 2, 2, 64, 64, 16, True, None, None,
                          "fwd_single"),
    "mha-ragged130-stream": (1, 2, 2, 130, 130, 32, False, None, None,
                             "fwd"),
    "gqa-causal-straddle": (1, 4, 2, 96, 96, 16, True, 24, 32, "fwd"),
    "mqa-ragged96-single": (2, 4, 1, 96, 96, 16, False, None, None,
                            "fwd_single"),
    "gqa-causal-sq-ne-skv": (1, 4, 2, 40, 96, 16, True, None, 32, "fwd"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_matches_reference(case, dtype):
    """O against ``flash_attention``, the LSE against ``_fwd``'s, and
    the dispatch (B9 when the padded KV is one reference block, B8
    otherwise) seen through the plain-branch counters."""
    B, H, Hkv, Sq, Skv, D, causal, bq, bk, branch = CASES[case]
    xs = _inputs(sorted(CASES).index(case), B, H, Hkv, Sq, Skv, D)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = _to_jax(xs, jdt)
    want_o = R.flash_attention(jq, jk, jv, causal=causal, block_q=bq,
                               block_k=bk)
    rbq = min(bq or R._auto_block(Sq), max(Sq, 8))
    rbk = min(bk or R._auto_block(Skv), max(Skv, 8))
    assert ((-(-Skv // rbk)) == 1) == (branch == "fwd_single")
    fwd = jax.jit(R._fwd, static_argnums=(3, 4, 5, 6))
    want_lse = np.asarray(fwd(jq, jk, jv, causal, D ** -0.5, rbq,
                              rbk)[1])[..., 0][:, :Sq]

    before = dict(A.plain_runs)
    o, lse = A.flash_attention_fwd(*_to_torch(xs, tdt), causal=causal,
                                   block_q=bq, block_k=bk)
    ran = {k: A.plain_runs[k] - before[k] for k in before}
    assert ran == {"fwd": int(branch == "fwd"),
                   "fwd_single": int(branch == "fwd_single"), "bwd_dkv": 0,
                   "bwd_dq": 0, "decode": 0}
    assert o.dtype == tdt and o.shape == (B, H, Sq, D)
    assert lse.dtype == torch.float32 and lse.shape == (B * H, Sq)
    _close_out(o, want_o, dtype == "bfloat16", f"{case} O")
    np.testing.assert_allclose(lse.numpy(), want_lse, rtol=F32_TOL,
                               atol=F32_TOL, err_msg=f"{case} LSE")
    out = A.flash_attention(*_to_torch(xs, tdt), causal=causal,
                            block_q=bq, block_k=bk)
    assert torch.equal(out, o)


def test_causal_mask_is_top_left_aligned():
    """The reference's causal mask sees key j from query i when j <= i
    (top-left), where ``conftest.dense_attention`` aligns the diagonal
    bottom-right (tril(k=Skv-Sq)). With Sq != Skv they differ; the port
    follows ``flash_attention``."""
    xs = _inputs(7, 1, 2, 2, 40, 96, 16)
    jq, jk, jv = _to_jax(xs, jnp.float32)
    want = np.asarray(R.flash_attention(jq, jk, jv, causal=True))
    got = A.flash_attention(*_to_torch(xs, torch.float32), causal=True)
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    bottom_right = np.asarray(dense_attention(jq, jk, jv, True))
    assert np.abs(got.numpy() - bottom_right).max() > 0.1


@pytest.mark.parametrize("s", [1, 7, 8, 96, 128, 130, 255, 256, 300, 511,
                               512, 513, 1000, 1024, 2047, 2048, 4096])
def test_dispatch_follows_the_reference_blocks(s):
    """B9 exactly where the reference's nk == 1 (its clamped block)."""
    for bk in (None, 32, 128, 512, 4096):
        rbk = min(bk or R._auto_block(s), max(s, 8))
        assert A.is_single_block(s, bk) == (-(-s // rbk) == 1), (s, bk)


def test_auto_block_sweep():
    """``_auto_block`` equals the reference's at every length 1..4096."""
    assert all(A._auto_block(s) == R._auto_block(s) for s in range(1, 4097))


T = 100   # not a multiple of the block


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s_new,kv_len",
                         [(1, 1), (1, 37), (3, 64), (5, 100), (7, T)])
def test_flash_decode_matches_reference(s_new, kv_len, dtype):
    """Decode and chunked prefill over a part-full cache in its native
    layout, GQA, with NaN in every cache row at or past kv_len: the
    output stays finite and equal to the reference's."""
    B, H, Hkv, D = 2, 8, 2, 32
    rng = np.random.default_rng(kv_len * 10 + s_new)
    kc = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    vc = rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
    kc[:, kv_len:] = np.nan
    vc[:, kv_len:] = np.nan
    q = rng.standard_normal((B, H, s_new, D)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv = _to_jax((q, kc, vc), jdt)
    want = R.flash_decode(jq, jk, jv, jnp.int32(kv_len), block_k=32)
    before = A.plain_runs["decode"]
    tq, tk, tv = _to_torch((q, kc, vc), tdt)
    got = A.flash_decode(tq, tk, tv, kv_len, block_k=32)
    assert A.plain_runs["decode"] == before + 1
    assert got.dtype == tdt and got.shape == (B, H, s_new, D)
    _close_out(got, want, dtype == "bfloat16", f"decode {s_new}/{kv_len}")


def test_decode_prefill_equals_causal_forward():
    """A prefill of the whole cache (S_new = kv_len = T) is causal
    attention: B12's plain version equals B8's on the same keys."""
    B, H, Hkv, D, S = 1, 4, 2, 16, 48
    q, k, v = _to_torch(_inputs(3, B, H, Hkv, S, S, D), torch.float32)
    kc, vc = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    got = A.flash_decode(q, kc, vc, S)
    want = A.flash_attention(q, k, v, causal=True)
    torch.testing.assert_close(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_decode_and_attention_reject_bad_shapes():
    q = torch.zeros(1, 4, 3, 16)
    kc = torch.zeros(1, 10, 2, 16)
    with pytest.raises(ValueError, match="kv_len"):
        A.flash_decode(q, kc, kc, 2)          # fewer keys than new tokens
    with pytest.raises(ValueError, match="kv_len"):
        A.flash_decode(q, kc, kc, 11)         # past the cache
    with pytest.raises(ValueError, match="multiple"):
        A.flash_attention(torch.zeros(1, 3, 8, 16), torch.zeros(1, 2, 8, 16),
                          torch.zeros(1, 2, 8, 16))


def test_cpu_path_keeps_autograd():
    """On the CPU, ``flash_attention`` is differentiable through the
    same autograd Function as on the card; its backward runs the plain
    versions of B10 and B11 there."""
    q, k, v = (t.requires_grad_() for t in _to_torch(
        _inputs(4, 1, 2, 1, 16, 16, 16), torch.float32))
    A.flash_attention(q, k, v).square().sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all()
               for t in (q, k, v))


def _kernel_operands(dtype, D):
    return [torch.zeros(1, 2, 8, D, dtype=dtype) for _ in range(3)]


def test_kernel_contract_refuses_float16():
    """The attention kernels take f32 or bf16 operands only: ``_kernel_ready``
    (the check every CUDA call makes before a launch) raises TypeError
    for f16, where the reference's wrappers check no dtype."""
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        A._kernel_ready("flash_attention", *_kernel_operands(torch.float16,
                                                             64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [80, 96])
def test_kernel_contract_refuses_other_head_dims(D, dtype):
    """Head dims outside (16, 32, 64, 128) raise ValueError naming the
    accepted ones (the reference's wrappers check no head dim; no path of
    the port needs another: Llama-3-8B has D = 128)."""
    with pytest.raises(ValueError, match=r"\(16, 32, 64, 128\)"):
        A._kernel_ready("flash_decode",
                        *_kernel_operands(getattr(torch, dtype), D))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [16, 32, 64, 128])
def test_kernel_contract_accepts(D, dtype):
    """f32 and bf16 with head dim 16, 32, 64 or 128 pass the check."""
    assert A.KERNEL_HEAD_DIMS == (16, 32, 64, 128)
    A._kernel_ready("flash_attention",
                    *_kernel_operands(getattr(torch, dtype), D))
