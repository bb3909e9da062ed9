"""The port's attention backward (B10, B11 and ``_FlashAttention``)
against the reference's, on the CPU.

The same numpy inputs and output cotangent go through ``jax.vjp`` of
``accl_tpu.ops.attention.flash_attention`` (its custom VJP, Pallas in
interpret mode, as ``test_ops.py`` runs it) and through the port's
``flash_attention``, whose autograd Function runs the plain versions of
B8-B11 on CPU tensors. The plain B10/B11 are also held against torch
autograd through dense attention with the reference's top-left causal
mask. Tolerances: f32 gradients within rtol = atol = 1e-5 (the same f32
FlashAttention-2 arithmetic summed in another order); a bf16 gradient
within one bf16 ulp of its scale (2^-7 * max |grad|: both sides round the
same f32 value, which may sit on either side of a rounding boundary).

The card's bf16 route of B10/B11 (tensor cores) rounds P and dS to bf16
before the second products, and its f32 route (TF32 tensor cores) forms
every product from two TF32 parts of each operand (3xTF32); the tests
below emulate both on the CPU and hold the emulations to the limits the
card's kernels are held to in ``chip_smoke.py`` (the kernels themselves
run only on the card).
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from accl_tpu.ops import attention as R  # noqa: E402
from accl_tpu_torch.ops import attention as A  # noqa: E402

F32_TOL = 1e-5


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


# (B, H, Hkv, Sq, Skv, D, causal, block_q, block_k)
CASES = {
    "mha-causal": (1, 8, 8, 80, 80, 16, True, 16, 32),
    "mha": (1, 8, 8, 80, 80, 16, False, 16, 32),
    "gqa-causal": (1, 8, 2, 80, 80, 16, True, 16, 32),
    "gqa": (1, 8, 2, 80, 80, 16, False, 16, 32),
    "mqa-causal": (1, 8, 1, 80, 80, 16, True, 16, 32),
    "mqa": (1, 8, 1, 80, 80, 16, False, 16, 32),
    "gqa-causal-ragged130": (1, 8, 2, 130, 130, 32, True, None, None),
    "gqa-sq40-skv96": (2, 4, 2, 40, 96, 16, False, None, 32),
    "gqa-causal-sq40-skv96": (2, 4, 2, 40, 96, 16, True, None, 32),
}


def _inputs(case):
    B, H, Hkv, Sq, Skv, D = CASES[case][:6]
    rng = np.random.default_rng(sorted(CASES).index(case) + 100)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((B, H, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D),
             (B, H, Sq, D))]


def _close(got: torch.Tensor, want, bf16: bool, what: str):
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    assert np.isfinite(g).all(), what
    if bf16:
        tol = 2.0 ** -7 * float(np.abs(w).max())
        np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=what)
    else:
        np.testing.assert_allclose(g, w, rtol=F32_TOL, atol=F32_TOL,
                                   err_msg=what)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_grads_match_reference(case, dtype):
    """dq, dk, dv of ``flash_attention`` against the reference's custom
    VJP on the same cotangent; the CPU backward ran the plain B10 and B11
    once each."""
    B, H, Hkv, Sq, Skv, D, causal, bq, bk = CASES[case]
    xq, xk, xv, xdo = _inputs(case)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jq, jk, jv, jdo = (jnp.asarray(x).astype(jdt) for x in (xq, xk, xv, xdo))
    want_o, vjp = jax.vjp(lambda q, k, v: R.flash_attention(
        q, k, v, causal=causal, block_q=bq, block_k=bk), jq, jk, jv)
    want = vjp(jdo)

    q, k, v = (torch.from_numpy(x).to(tdt).requires_grad_()
               for x in (xq, xk, xv))
    before = dict(A.plain_runs)
    o = A.flash_attention(q, k, v, causal=causal, block_q=bq, block_k=bk)
    assert type(o.grad_fn).__name__ == "_FlashAttentionBackward"
    o.backward(torch.from_numpy(xdo).to(tdt))
    ran = {key: A.plain_runs[key] - before[key] for key in before}
    single = A.is_single_block(Skv, bk)
    assert ran == {"fwd": int(not single), "fwd_single": int(single),
                   "bwd_dkv": 1, "bwd_dq": 1, "decode": 0}
    bf16 = dtype == "bfloat16"
    _close(o.detach(), want_o, bf16, f"{case} O")
    for t, w, name in zip((q, k, v), want, "qkv"):
        assert t.grad.dtype == tdt and t.grad.shape == t.shape
        _close(t.grad, w, bf16, f"{case} d{name}")


def _dense_topleft(q, k, v, causal):
    """Softmax attention in f32 with the reference's mask (key j seen by
    query i when j <= i), differentiable by torch autograd."""
    s = torch.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if causal:
        Sq, Skv = q.shape[2], k.shape[2]
        mask = (torch.arange(Skv)[None, :] <= torch.arange(Sq)[:, None])
        s = torch.where(mask, s, torch.finfo(torch.float32).min)
    return torch.matmul(torch.softmax(s, dim=-1), v)


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_parts_match_dense_autograd(case):
    """The plain B10 partials are the gradients of the per-q-head
    repeated K and V, B11's dq that of q, and the Function's dk/dv their
    group sums: all against torch autograd through dense attention."""
    B, H, Hkv, Sq, Skv, D, causal, _bq, _bk = CASES[case]
    xq, xk, xv, xdo = (torch.from_numpy(x) for x in _inputs(case))
    g = H // Hkv
    q = xq.clone().requires_grad_()
    k_rep = xk.repeat_interleave(g, dim=1).requires_grad_()
    v_rep = xv.repeat_interleave(g, dim=1).requires_grad_()
    _dense_topleft(q, k_rep, v_rep, causal).backward(xdo)

    scale = D ** -0.5
    o, lse = A.flash_attention_fwd(xq, xk, xv, causal)
    delta = (xdo * o).sum(-1).reshape(B * H, Sq)
    dk_part, dv_part = A.flash_attention_bwd_dkv(xq, xdo, xk, xv, lse, delta,
                                                 causal, scale)
    dq = A.flash_attention_bwd_dq(xq, xdo, xk, xv, lse, delta, causal, scale)
    assert dk_part.dtype == dv_part.dtype == torch.float32
    assert dk_part.shape == dv_part.shape == (B * H, Skv, D)
    tol = dict(rtol=F32_TOL, atol=F32_TOL)
    torch.testing.assert_close(dk_part, k_rep.grad.reshape(B * H, Skv, D),
                               **tol)
    torch.testing.assert_close(dv_part, v_rep.grad.reshape(B * H, Skv, D),
                               **tol)
    torch.testing.assert_close(dq, q.grad, **tol)

    tq, tk, tv = (x.clone().requires_grad_() for x in (xq, xk, xv))
    A.flash_attention(tq, tk, tv, causal=causal).backward(xdo)
    torch.testing.assert_close(tk.grad, k_rep.grad.reshape(
        B, Hkv, g, Skv, D).sum(2), **tol)
    torch.testing.assert_close(tv.grad, v_rep.grad.reshape(
        B, Hkv, g, Skv, D).sum(2), **tol)
    torch.testing.assert_close(tq.grad, q.grad, **tol)


# The bf16 route of B10/B11 (tensor cores) rounds P and dS to bf16 as the
# first operand of dV, dK and dQ. Its limit against the plain versions,
# per element, with m the magnitude of the rounded sum
# (``bwd_rounding_magnitudes``): a rounding moves each term by less than
# 2^-8 of its magnitude, and the f32 accumulation order of the card sits
# in the floor: dk, dv (f32) 2^-8*m + 2e-5*max|plain|; dq (bf16)
# 2^-8*m + 2^-7*|plain| + 2^-7*median|plain|.
def _bf16_limit(plain, part, mag):
    p = plain.float().abs()
    if part == "dq":
        return 2.0 ** -8 * mag + 2.0 ** -7 * p + 2.0 ** -7 * float(p.median())
    return 2.0 ** -8 * mag + 2e-5 * float(p.max())


def _bf16_operands(case):
    """bf16-valued q, k, v, dout of ``case`` and the backward's operands:
    the forward's LSE, delta from O in bf16 (as ``_FlashAttention``)."""
    B, H, _, Sq, _, D, causal = CASES[case][:7]
    xq, xk, xv, xdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in _inputs(case))
    o, lse = A.flash_attention_fwd(xq, xk, xv, causal)
    delta = (xdo.float() * o.float()).sum(-1).reshape(B * H, Sq)
    return xq, xdo, xk, xv, lse, delta, causal, D ** -0.5


def _bf16_route(q, do, k, v, lse, delta, causal, scale):
    """An emulation of the bf16 route: the plain backward's f32 P and dS,
    rounded to bf16 (round to nearest even) before the second products."""
    qf, dof, kf, p, ds = A._bwd_parts(q, do, k, v, lse, delta, causal, scale)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    pb, dsb = p.bfloat16().float(), ds.bfloat16().float()
    dv = torch.matmul(pb.transpose(-1, -2), dof).reshape(B * H, Skv, D)
    dk = (torch.matmul(dsb.transpose(-1, -2), qf) * scale).reshape(
        B * H, Skv, D)
    dq = (torch.matmul(dsb, kf) * scale).reshape(q.shape).to(q.dtype)
    return dk, dv, dq


def _bf16_ratios(args, outs):
    """Largest error/limit of (dk, dv, dq) against the plain versions."""
    plain = (*A.flash_attention_bwd_dkv_ref(*args),
             A.flash_attention_bwd_dq_ref(*args))
    mags = A.bwd_rounding_magnitudes(*args)
    return [float(((g.float() - w.float()).abs()
                   / _bf16_limit(w, part, m)).max())
            for g, w, m, part in zip(outs, plain, mags, ("dk", "dv", "dq"))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_route_emulation_within_limit(case):
    """The emulated bf16 route stays within the limit of the card's bf16
    route on every case, and differs from the plain versions (the limit
    is not vacuous)."""
    args = _bf16_operands(case)
    outs = _bf16_route(*args)
    assert outs[0].dtype == outs[1].dtype == torch.float32
    assert outs[2].dtype == torch.bfloat16
    ratios = _bf16_ratios(args, outs)
    assert max(ratios) <= 1.0, ratios
    assert min(ratios) > 0.0, ratios


@pytest.mark.parametrize("case", sorted(CASES))
def test_bf16_limit_catches_a_moved_element(case):
    """dk with one element moved by 2^-5 * max|dk| fails the limit (at
    its largest element and at its middle one), so the limit is not
    loose."""
    args = _bf16_operands(case)
    dk, dv, dq = _bf16_route(*args)
    step = 2.0 ** -5 * float(dk.abs().max())
    for flat in (int(dk.abs().argmax()), dk.numel() // 2):
        moved = dk.clone()
        moved.view(-1)[flat] += step
        assert _bf16_ratios(args, (moved, dv, dq))[0] > 1.0, (case, flat)


def test_rounding_magnitudes_brute_force():
    """``bwd_rounding_magnitudes`` against sums of |terms| written out
    term by term on a small GQA causal case."""
    rng = np.random.default_rng(7)
    B, H, Hkv, Sq, Skv, D, causal = 1, 4, 2, 6, 5, 16, True
    q, do = (torch.from_numpy(rng.standard_normal((B, H, Sq, D))).bfloat16()
             for _ in range(2))
    k, v = (torch.from_numpy(rng.standard_normal((B, Hkv, Skv, D)))
            .bfloat16() for _ in range(2))
    o, lse = A.flash_attention_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).reshape(B * H, Sq)
    scale = D ** -0.5
    mdk, mdv, mdq = A.bwd_rounding_magnitudes(q, do, k, v, lse, delta,
                                              causal, scale)
    qf, dof, kf, vf = (t.double() for t in (q, do, k, v))
    want_dk, want_dv = torch.zeros(B * H, Skv, D), torch.zeros(B * H, Skv, D)
    want_dq = torch.zeros(B, H, Sq, D)
    for h in range(H):
        kv = h // (H // Hkv)
        for i in range(Sq):
            for j in range(Skv):
                if causal and j > i:
                    continue
                s = float(qf[0, h, i] @ kf[0, kv, j]) * scale
                p = np.exp(s - float(lse[h, i]))
                ds = p * (float(dof[0, h, i] @ vf[0, kv, j])
                          - float(delta[h, i]))
                want_dv[h, j] += p * dof[0, h, i].abs().float()
                want_dk[h, j] += scale * abs(ds) * qf[0, h, i].abs().float()
                want_dq[0, h, i] += (scale * abs(ds)
                                     * kf[0, kv, j].abs().float())
    for got, want in ((mdk, want_dk), (mdv, want_dv), (mdq, want_dq)):
        assert got.dtype == torch.float32 and got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-6)


def test_no_grad_calls_the_forward_directly():
    """Without grad (or with no input requiring it) nothing is saved and
    no graph is built; the Function's backward is once-differentiable, as
    the reference's pallas_call has no second derivative."""
    xq, xk, xv, _ = (torch.from_numpy(x) for x in _inputs("gqa-causal"))
    before = dict(A.plain_runs)
    assert A.flash_attention(xq, xk, xv).grad_fn is None
    with torch.no_grad():
        assert A.flash_attention(xq.requires_grad_(), xk, xv).grad_fn is None
    assert A.plain_runs["bwd_dkv"] == before["bwd_dkv"]
    o = A.flash_attention(xq, xk, xv)
    (dq,) = torch.autograd.grad(o.square().sum(), xq, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        dq.sum().backward()


def test_backward_rejects_bad_operands():
    xq, xk, xv, xdo = (torch.from_numpy(x) for x in _inputs("gqa"))
    B, H, Sq = xq.shape[:3]
    lse = torch.zeros(B * H, Sq)
    with pytest.raises(ValueError, match="lse"):
        A.flash_attention_bwd_dkv(xq, xdo, xk, xv, lse[:, 1:], lse, False,
                                  0.25)
    with pytest.raises(ValueError, match="delta"):
        A.flash_attention_bwd_dq(xq, xdo, xk, xv, lse, lse.double(), False,
                                 0.25)
    with pytest.raises(ValueError, match="dout"):
        A.flash_attention_bwd_dq(xq, xdo[:, :, 1:], xk, xv, lse, lse, False,
                                 0.25)


# The f32 route of B10/B11 (TF32 tensor cores, csrc/attention_bwd.cu)
# splits each f32 operand into hi = tf32(a) and lo = tf32(a - hi) and
# forms every product as lo*hi + hi*lo + hi*hi in f32 (3xTF32). The tests
# below emulate that arithmetic for all five products (S, dP, dV, dK, dQ)
# and hold it to the f32 limit the card's kernels are held to in
# ``chip_smoke.py`` (BWD_TOL: 2e-5*|plain| + 2e-5*max|plain| per
# element); one TF32 product a product breaks that limit.
def _tf32(x):
    """``x`` rounded to TF32 as ``cvt.rna.tf32.f32``: 10 mantissa bits,
    ties away from zero (half an ulp added to the magnitude's bits, the
    13 low bits cleared); infinities and NaN as they are."""
    u = x.float().contiguous().view(torch.int32).to(torch.int64)
    mag, sign = u & 0x7FFFFFFF, u & ~0x7FFFFFFF
    out = torch.where(mag < 0x7F800000, (mag + 0x1000) & 0x7FFFE000, mag)
    return (sign | out).to(torch.int32).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _mm_tf32x3(a, b):
    """a @ b in 3xTF32: the two small products first, then hi * hi, each
    product exact (11 x 11 significant bits) and summed in f32."""
    (ah, al), (bh, bl) = _split(a), _split(b)
    return (torch.matmul(al, bh) + torch.matmul(ah, bl)) + torch.matmul(
        ah, bh)


def _mm_tf32x1(a, b):
    """a @ b as one TF32 product."""
    return torch.matmul(_tf32(a), _tf32(b))


def _tf32_route(q, do, k, v, lse, delta, causal, scale, mm):
    """The backward of the plain versions (``_bwd_parts``, dV, dK, dQ)
    with each of its five products through ``mm``: (dk, dv, dq)."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    qf, dof = (t.reshape(B, Hkv, g, Sq, D).float() for t in (q, do))
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    s = mm(qf, kf.transpose(-1, -2)) * scale
    mask = (torch.arange(Skv)[None, :] <= torch.arange(Sq)[:, None]
            if causal else torch.ones(Sq, Skv, dtype=torch.bool))
    p = torch.where(mask, torch.exp(s - lse.reshape(B, Hkv, g, Sq, 1)), 0.0)
    dp = mm(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.reshape(B, Hkv, g, Sq, 1))
    dv = mm(p.transpose(-1, -2), dof).reshape(B * H, Skv, D)
    dk = (mm(ds.transpose(-1, -2), qf) * scale).reshape(B * H, Skv, D)
    dq = (mm(ds, kf) * scale).reshape(q.shape)
    return dk, dv, dq


# the nine CASES and phase 8's head dim at a causal GQA S = 512
TF32_CASES = {**{c: CASES[c][:7] for c in CASES},
              "gqa-causal-d128-s512": (1, 4, 2, 512, 512, 128, True)}


def _f32_operands(case):
    """f32 q, dout, k, v of ``case`` and the backward's operands: the
    forward's LSE, delta from O."""
    B, H, Hkv, Sq, Skv, D, causal = TF32_CASES[case]
    rng = np.random.default_rng(sorted(TF32_CASES).index(case) + 300)
    xq, xdo = (torch.from_numpy(rng.standard_normal((B, H, Sq, D))
                                .astype(np.float32)) for _ in range(2))
    xk, xv = (torch.from_numpy(rng.standard_normal((B, Hkv, Skv, D))
                               .astype(np.float32)) for _ in range(2))
    o, lse = A.flash_attention_fwd(xq, xk, xv, causal)
    delta = (xdo * o).sum(-1).reshape(B * H, Sq)
    return xq, xdo, xk, xv, lse, delta, causal, D ** -0.5


def _f32_ratios(args, outs):
    """Largest error/limit of (dk, dv, dq) against the plain versions
    under the f32 rule of BWD_TOL."""
    plain = (*A.flash_attention_bwd_dkv_ref(*args),
             A.flash_attention_bwd_dq_ref(*args))
    return [float(((g - w).abs() / (2e-5 * w.abs()
                                    + 2e-5 * float(w.abs().max()))).max())
            for g, w in zip(outs, plain)]


@pytest.mark.parametrize("x, want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),              # a tie: away from 0
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),              # below the tie
    (-3.0 - 2.0 ** -9 - 2.0 ** -12, -3.0 - 2.0 ** -9),  # negative, down
    (float("inf"), float("inf")),
    (float("-inf"), float("-inf")),
    (1.5, 1.5),                                         # lo is 0
])
def test_tf32_rounds_as_cvt_rna(x, want):
    """``_tf32`` on pinned bit patterns: a tie rounds away from zero (both
    signs), infinities stay, and an exact TF32 value splits into itself
    and lo = 0."""
    t = torch.tensor([x], dtype=torch.float32)
    got = _tf32(t)
    assert got.item() == want
    assert got.view(torch.int32).item() & 0x1FFF == 0
    if np.isfinite(x):
        hi, lo = _split(t)
        assert hi.item() == want
        assert lo.item() == _tf32(t - want).item()
        assert (lo.item() == 0.0) == (float(np.float32(x)) == want)


def test_tf32_split_recovers_f32():
    """hi + lo holds an f32 value to 2^-21 of it (21 of its 24 bits), NaN
    stays NaN."""
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(4096)
                         .astype(np.float32))
    hi, lo = _split(x)
    assert ((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all()
    assert torch.isnan(_tf32(torch.tensor([float("nan")]))).all()


@pytest.mark.parametrize("case", sorted(TF32_CASES))
def test_tf32x3_route_emulation_within_f32_limit(case):
    """The emulated f32 route (3xTF32 for all five products) stays within
    the f32 limit of the card's kernels on every case, and differs from
    the plain versions (the limit is not vacuous)."""
    args = _f32_operands(case)
    outs = _tf32_route(*args, _mm_tf32x3)
    ratios = _f32_ratios(args, outs)
    assert max(ratios) <= 1.0, ratios
    assert min(ratios) > 0.0, ratios


@pytest.mark.parametrize("case", sorted(TF32_CASES))
def test_single_tf32_product_exceeds_f32_limit(case):
    """One TF32 product a product moves the gradients past the f32 limit:
    the limit is not loose, and the route needs three."""
    args = _f32_operands(case)
    assert max(_f32_ratios(args, _tf32_route(*args, _mm_tf32x1))) > 1.0
