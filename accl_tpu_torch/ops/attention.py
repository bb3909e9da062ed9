"""Kernels B8-B12: flash attention forward and backward, KV-cache decode.

The counterpart of ``accl_tpu/ops/attention.py``. The layouts are the
reference's: q (B, H, S, D); k/v (B, Hkv, S, D) with Hkv dividing H; the
decode cache (B, T, Hkv, D), read as it is. GQA is index arithmetic (the
counterpart of ``_kv_head_row``): KV is never repeated.

Wrappers: on CUDA tensors they launch the hand-written kernels of
``csrc/attention.cu``, ``csrc/attention_sm90.cu``,
``csrc/attention_decode.cu``, ``csrc/attention_bwd.cu`` and
``csrc/attention_bwd_sm90.cu``; on CPU tensors they run the plain
PyTorch versions (``*_ref``).

- ``flash_attention`` / ``flash_attention_fwd``: B9 when the padded KV
  is one block of the reference's block size (its ``nk == 1`` test, with
  ``_auto_block`` and its clamp), B8 otherwise. The kernels' own tiles
  are not the reference's 512-wide blocks: only this dispatch follows
  them. B8 and B9 each have two routes: bf16 operands run on the tensor
  cores (``attn_fwd_wgmma_kernel`` and ``attn_fwd_single_wgmma_kernel``
  of ``csrc/attention_sm90.cu``: wgmma and TMA; P rounded to bf16 before
  P V, see ``fwd_rounding_magnitudes``), f32 operands on the CUDA cores
  (``attn_fwd_kernel`` and ``attn_fwd_single_kernel`` of
  ``csrc/attention.cu``).
- ``flash_attention_bwd_dkv``: B10, per-q-head f32 partials of dK and
  dV; ``flash_attention_bwd_dq``: B11, dQ in q's dtype. Two routes, one
  kernel each: bf16 operands run on the tensor cores
  (``attn_bwd_{dkv,dq}_wgmma_kernel`` of ``csrc/attention_bwd_sm90.cu``:
  wgmma and TMA; P and dS rounded to bf16 before the second products,
  see ``bwd_rounding_magnitudes``), f32 operands on the CUDA cores
  (``attn_bwd_{dkv,dq}_kernel`` of ``csrc/attention_bwd.cu``).
  ``flash_attention`` is differentiable through ``_FlashAttention`` (the
  counterpart of the reference's ``custom_vjp``), whose backward runs
  them.
- ``flash_decode``: B12. Single-token decode (S_new == 1), f32 or bf16,
  runs the split-KV kernel of ``csrc/attention_decode.cu``
  (``attn_decode_split_kernel``: ``decode_splits`` slices of the filled
  prefix, merged by the last slice to finish; f32 arithmetic). A
  bf16 chunk of S_new > 1 new tokens (prefill) runs B8's tensor-core
  kernel over the cache in its own layout (``attn_fwd_wgmma_kernel`` with
  a 4-D tensor map, bottom-right causal); an f32 chunk runs
  ``attn_decode_kernel`` of ``csrc/attention.cu``.

The kernels take f32 or bf16 operands with head dim 16, 32, 64 or 128
(``KERNEL_HEAD_DIMS``); a CUDA call outside that raises TypeError (the
dtype) or ValueError (the head dim). The reference's wrappers check
neither.

Launch counters: ``fwd_launches`` (B8), ``fwd_single_launches`` (B9),
``bwd_dkv_launches`` (B10), ``bwd_dq_launches`` (B11), and B12's two,
``decode_launches`` (one new token, S_new == 1) and ``prefill_launches``
(a chunk, S_new > 1); beside them the routes' own,
``fwd_wgmma_launches`` (the B8 launches on the tensor cores),
``fwd_single_wgmma_launches`` (the B9 launches on the tensor cores),
``prefill_wgmma_launches`` (the B12 prefill launches on the tensor
cores) and ``decode_split_launches`` (the B12 decode launches on the
split-KV kernel; ``last_decode_splits`` holds the last one's
``n_split``). ``plain_runs`` counts the plain versions' runs on the CPU
under the branch the dispatch chose ("fwd", "fwd_single", "bwd_dkv",
"bwd_dq", "decode").
"""

from __future__ import annotations

import torch

from .. import _build

_NEG_INF = torch.finfo(torch.float32).min
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/attention.cu
KERNEL_HEAD_DIMS = (16, 32, 64, 128)
# f32 B9 holds a 16-row tile of scores in shared memory; the bf16 route
# streams its key tiles and has no such limit
SINGLE_MAX_KEYS = 2048
SPLIT_TILE = 64          # a decode split's key range is a multiple of it
DECODE_BLOCKS_PER_SM = 4  # csrc/attention_decode.cu BLOCKS_PER_SM

fwd_launches = 0
fwd_single_launches = 0
bwd_dkv_launches = 0
bwd_dq_launches = 0
decode_launches = 0
prefill_launches = 0
fwd_wgmma_launches = 0
fwd_single_wgmma_launches = 0
prefill_wgmma_launches = 0
decode_split_launches = 0
last_decode_splits = None
plain_runs = {"fwd": 0, "fwd_single": 0, "bwd_dkv": 0, "bwd_dq": 0,
              "decode": 0}


def _auto_block(s: int) -> int:
    """The reference's block rule for length ``s`` (512 or 256 when it
    divides ``s`` or ``s`` is at least 4 blocks long, else 128)."""
    for b in (512, 256):
        if s % b == 0 or s >= 4 * b:
            return b
    return 128


def is_single_block(skv: int, block_k: int | None = None) -> bool:
    """The reference's ``nk == 1``: the KV padded to its (clamped) block
    is one block. Selects B9 over B8."""
    bk = min(block_k or _auto_block(skv), max(skv, 8))
    return -(-skv // bk) == 1


def _check_fwd(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q (B, H, S, D), k/v (B, Hkv, "
                         f"S, D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, _, D = q.shape
    if k.shape[0] != B or k.shape[3] != D:
        raise ValueError("flash_attention: q and k/v differ in batch or "
                         "head dim")
    if H % k.shape[1]:
        raise ValueError(f"q heads {H} not a multiple of kv heads "
                         f"{k.shape[1]}")


def _kernel_ready(what: str, *ts):
    t0 = ts[0]
    for t in ts:
        if t.device != t0.device or t.dtype != t0.dtype:
            raise ValueError(f"{what}: operands differ in device or dtype")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: operands must start on a 16-byte "
                             f"boundary (the kernels load 16-byte vectors)")
    if t0.dtype not in _DTYPE_CODES:
        raise TypeError(f"{what} kernel: unsupported dtype {t0.dtype} "
                        f"(float32 or bfloat16)")
    if t0.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"{what} kernel: head dim {t0.shape[-1]} not in "
                         f"{KERNEL_HEAD_DIMS}")


def _softmax_parts(s, mask):
    """(m, p, l) of masked scores, as the reference's kernels write them:
    masked scores are finfo(f32).min, l is floored at 1e-30."""
    s = torch.where(mask, s, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    return m, p, p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _fwd_parts(q, k, v, causal: bool, scale: float, off: int = 0):
    """The forward's softmax in f32, the q heads of one kv head side by
    side: (m, p, l, v as f32), shapes (B, Hkv, group * Sq, .). q (B, H,
    Sq, D); k/v (B, Hkv, Skv, D). Under ``causal`` key j is seen by query
    i when j <= i + off (0: the reference's top-left mask; kv_len - S_new:
    B12's bottom-right one); a hidden pair has p = 0."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    # q head h = kv head * group + g: rows of one kv head side by side
    qf = q.reshape(B, Hkv, (H // Hkv) * Sq, D).float()
    s = torch.matmul(qf, k.float().transpose(-1, -2)) * scale
    rows = torch.arange(qf.shape[2], device=q.device) % Sq
    keys = torch.arange(Skv, device=q.device)
    mask = (keys[None, :] <= rows[:, None] + off if causal
            else torch.ones(rows.numel(), Skv, dtype=torch.bool,
                            device=q.device))
    m, p, l = _softmax_parts(s, mask)
    return m, torch.where(mask, p, 0.0), l, v.float()


def flash_attention_ref(q, k, v, causal: bool = True,
                        sm_scale: float | None = None):
    """Plain PyTorch version of B8/B9 (any device): softmax attention in
    f32 with the reference's mask (top-left causal: key j is seen by query
    i when j <= i) and its constants. Returns (O in q's dtype, LSE (B*H,
    Sq) f32)."""
    B, H, Sq, D = q.shape
    scale = float(D) ** -0.5 if sm_scale is None else sm_scale
    m, p, l, vf = _fwd_parts(q, k, v, causal, scale)
    o = torch.matmul(p, vf) / l
    lse = (m + torch.log(l)).reshape(B * H, Sq)
    return o.reshape(B, H, Sq, D).to(q.dtype), lse


def fwd_rounding_magnitudes(q, k, v, causal: bool = True,
                            scale: float | None = None, off: int = 0):
    """Plain helper for the limit of the forward's bf16 route (B8, and
    B12 with S_new > 1), which rounds P to bf16 as the first operand of
    P V (any device; the main path never calls it). The magnitude of each
    output's rounded sum, m_i = sum_j p_ij |v_j| / l_i, shaped like O
    (B, H, Sq, D), f32. q (B, H, Sq, D); k/v (B, Hkv, Skv, D); the mask
    as ``_fwd_parts`` (for B12: the filled cache prefix as (B, Hkv,
    kv_len, D) and off = kv_len - S_new)."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else scale
    _m, p, l, vf = _fwd_parts(q, k, v, causal, scale, off)
    return (torch.matmul(p, vf.abs()) / l).reshape(q.shape)


def flash_attention_fwd(q, k, v, causal: bool = True,
                        sm_scale: float | None = None,
                        block_q: int | None = None,
                        block_k: int | None = None):
    """Fused attention forward. q (B, H, Sq, D); k/v (B, Hkv, Skv, D).
    Returns (O (B, H, Sq, D) in q's dtype, LSE (B*H, Sq) f32: the
    residual the backward pass will read). ``block_k`` is the
    reference's: with its clamp it selects B9 (one KV block) or B8, and
    nothing else; ``block_q`` is accepted for the reference's signature
    (the kernels' tiles are their own)."""
    global fwd_launches, fwd_single_launches, fwd_wgmma_launches
    global fwd_single_wgmma_launches
    _check_fwd(q, k, v)
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    scale = float(D) ** -0.5 if sm_scale is None else float(sm_scale)
    single = is_single_block(Skv, block_k)
    if q.device.type == "cpu":
        plain_runs["fwd_single" if single else "fwd"] += 1
        return flash_attention_ref(q, k, v, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    _kernel_ready("flash_attention", q, k, v)
    if single and q.dtype == torch.float32 and Skv > SINGLE_MAX_KEYS:
        raise ValueError(f"flash_attention: one f32 KV block of {Skv} keys "
                         f"exceeds B9's {SINGLE_MAX_KEYS}; pass a smaller "
                         f"block_k")
    o = torch.empty_like(q)
    lse = torch.empty(B * H, Sq, dtype=torch.float32, device=q.device)
    fn = (_build.library().accl_attn_fwd_single if single
          else _build.library().accl_attn_fwd)
    _build.check(fn(_DTYPE_CODES[q.dtype], D, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), lse.data_ptr(), B, H, Hkv,
                    Sq, Skv, int(causal), scale, _build.stream_of(q)),
                 "flash_attention")
    if single:
        fwd_single_launches += 1
        if q.dtype == torch.bfloat16:
            fwd_single_wgmma_launches += 1
    else:
        fwd_launches += 1
        if q.dtype == torch.bfloat16:
            fwd_wgmma_launches += 1
    return o, lse


def _check_bwd(q, do, k, v, lse, delta):
    _check_fwd(q, k, v)
    B, H, Sq, _ = q.shape
    if do.shape != q.shape:
        raise ValueError(f"flash_attention backward: dout {tuple(do.shape)} "
                         f"is not q's shape {tuple(q.shape)}")
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (B * H, Sq) or t.dtype != torch.float32:
            raise ValueError(f"flash_attention backward: {name} must be "
                             f"(B*H, Sq) = {(B * H, Sq)} float32, got "
                             f"{tuple(t.shape)} {t.dtype}")


def _bwd_parts(q, do, k, v, lse, delta, causal, scale):
    """The backward's shared step in f32, as the reference's
    ``_recompute_p`` and kernels compute it: p = where(mask, exp(s - lse),
    0) under the forward's mask (top-left causal), dp = do v^T, ds = p (dp
    - delta). Shapes (B, Hkv, group, Sq, .): the q heads of one kv head
    side by side, against that kv head's keys."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    qf = q.reshape(B, Hkv, g, Sq, D).float()
    dof = do.reshape(B, Hkv, g, Sq, D).float()
    kf = k.float()[:, :, None]
    vf = v.float()[:, :, None]
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    keys = torch.arange(Skv, device=q.device)
    rows = torch.arange(Sq, device=q.device)
    mask = (keys[None, :] <= rows[:, None] if causal
            else torch.ones(Sq, Skv, dtype=torch.bool, device=q.device))
    p = torch.where(mask, torch.exp(s - lse.reshape(B, Hkv, g, Sq, 1)), 0.0)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta.reshape(B, Hkv, g, Sq, 1))
    return qf, dof, kf, p, ds


def flash_attention_bwd_dkv_ref(q, do, k, v, lse, delta, causal: bool,
                                scale: float):
    """Plain PyTorch version of B10 (any device): the per-q-head f32
    partials (dk_part, dv_part), each (B*H, Skv, D): dv = p^T do, dk =
    scale ds^T q (the GQA group sum is the caller's)."""
    qf, dof, _kf, p, ds = _bwd_parts(q, do, k, v, lse, delta, causal, scale)
    B, H, _, D = q.shape
    Skv = k.shape[2]
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dk.reshape(B * H, Skv, D), dv.reshape(B * H, Skv, D)


def flash_attention_bwd_dq_ref(q, do, k, v, lse, delta, causal: bool,
                               scale: float):
    """Plain PyTorch version of B11 (any device): dq = scale ds k,
    (B, H, Sq, D) in q's dtype."""
    _qf, _dof, kf, _p, ds = _bwd_parts(q, do, k, v, lse, delta, causal,
                                       scale)
    return (torch.matmul(ds, kf) * scale).reshape(q.shape).to(q.dtype)


def bwd_rounding_magnitudes(q, do, k, v, lse, delta, causal: bool,
                            scale: float):
    """Plain helper for the limits of B10/B11's bf16 route, which rounds
    P and dS to bf16 as the first operand of dV, dK and dQ (any device;
    the main path never calls it). The magnitudes of those sums, shaped
    like the outputs, f32: (scale |dS|^T |Q|, |P|^T |dO|) as (B*H, Skv,
    D) each, like (dk_part, dv_part), and scale |dS| |K| (B, H, Sq, D),
    like dq."""
    qf, dof, kf, p, ds = _bwd_parts(q, do, k, v, lse, delta, causal, scale)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    dsa = ds.abs()
    dk = torch.matmul(dsa.transpose(-1, -2), qf.abs()) * scale
    dv = torch.matmul(p.transpose(-1, -2), dof.abs())     # p >= 0
    dq = torch.matmul(dsa, kf.abs()) * scale
    return (dk.reshape(B * H, Skv, D), dv.reshape(B * H, Skv, D),
            dq.reshape(B, H, Sq, D))


def _bwd_launch(name, what, q, do, k, v, lse, delta, outs, causal, scale):
    _kernel_ready(what, q, do, k, v)
    for t in (lse, delta):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: lse and delta must be contiguous on "
                             f"q's device")
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    fn = getattr(_build.library(), name)
    _build.check(fn(_DTYPE_CODES[q.dtype], D, q.data_ptr(), do.data_ptr(),
                    k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), *(t.data_ptr() for t in outs), B, H,
                    Hkv, Sq, Skv, int(causal), scale, _build.stream_of(q)),
                 what)


def flash_attention_bwd_dkv(q, do, k, v, lse, delta, causal: bool,
                            scale: float):
    """B10: the per-q-head f32 partials (dk_part, dv_part), each (B*H,
    Skv, D), of the attention whose forward gave ``lse``; ``delta`` =
    rowsum(do * o) (B*H, Sq) f32. q/do (B, H, Sq, D); k/v (B, Hkv, Skv,
    D)."""
    global bwd_dkv_launches
    _check_bwd(q, do, k, v, lse, delta)
    if q.device.type == "cpu":
        plain_runs["bwd_dkv"] += 1
        return flash_attention_bwd_dkv_ref(q, do, k, v, lse, delta, causal,
                                           scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    B, H, _, D = q.shape
    Skv = k.shape[2]
    dk = torch.empty(B * H, Skv, D, dtype=torch.float32, device=q.device)
    dv = torch.empty_like(dk)
    _bwd_launch("accl_attn_bwd_dkv", "flash_attention_bwd_dkv", q, do, k, v,
                lse, delta, (dk, dv), causal, scale)
    bwd_dkv_launches += 1
    return dk, dv


def flash_attention_bwd_dq(q, do, k, v, lse, delta, causal: bool,
                           scale: float):
    """B11: dq (B, H, Sq, D) in q's dtype (operands as
    :func:`flash_attention_bwd_dkv`)."""
    global bwd_dq_launches
    _check_bwd(q, do, k, v, lse, delta)
    if q.device.type == "cpu":
        plain_runs["bwd_dq"] += 1
        return flash_attention_bwd_dq_ref(q, do, k, v, lse, delta, causal,
                                          scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    dq = torch.empty_like(q)
    _bwd_launch("accl_attn_bwd_dq", "flash_attention_bwd_dq", q, do, k, v,
                lse, delta, (dq,), causal, scale)
    bwd_dq_launches += 1
    return dq


def _dense(t):
    """``t`` contiguous and on a 16-byte boundary (the kernels' vector
    loads): a gradient may arrive as a strided or offset view."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


class _FlashAttention(torch.autograd.Function):
    """Fused attention with the FlashAttention-2 backward (the reference's
    ``_flash`` custom VJP, attention.py:527-538): forward B8/B9 keeps O
    and the LSE; backward forms delta = rowsum(do * o) from O in q's dtype
    (attention.py:433), runs B10 for the per-q-head partials, sums each
    GQA group in f32 and casts to k's and v's dtype (:522-523), and runs
    B11 for dq. On CPU tensors the same steps run the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, block_k):
        o, lse = flash_attention_fwd(q, k, v, causal, scale, None, block_k)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        B, H, Sq, D = q.shape
        Hkv, Skv = k.shape[1], k.shape[2]
        do = _dense(do)
        delta = (do.float() * o.float()).sum(dim=-1).reshape(B * H, Sq)
        dk_part, dv_part = flash_attention_bwd_dkv(
            q, do, k, v, lse, delta, ctx.causal, ctx.scale)
        g = H // Hkv
        dk = dk_part.reshape(B, Hkv, g, Skv, D).sum(2).to(k.dtype)
        dv = dv_part.reshape(B, Hkv, g, Skv, D).sum(2).to(v.dtype)
        dq = flash_attention_bwd_dq(q, do, k, v, lse, delta, ctx.causal,
                                    ctx.scale)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, causal: bool = True,
                    sm_scale: float | None = None,
                    block_q: int | None = None,
                    block_k: int | None = None):
    """Fused attention (see :func:`flash_attention_fwd`); returns O.
    Differentiable: when grad is enabled and an input requires grad, it
    runs through ``_FlashAttention`` (backward B10 and B11); otherwise it
    calls the forward directly and saves nothing."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        scale = (float(q.shape[-1]) ** -0.5 if sm_scale is None
                 else float(sm_scale))
        return _FlashAttention.apply(q, k, v, causal, scale, block_k)
    return flash_attention_fwd(q, k, v, causal, sm_scale, block_q,
                               block_k)[0]


def _check_decode(q, k_cache, v_cache, kv_len: int):
    if q.dim() != 4 or k_cache.dim() != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"flash_decode: q (B, H, S_new, D), cache (B, T, "
                         f"Hkv, D); got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}")
    B, H, S_new, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError("flash_decode: q and cache differ in batch or "
                         "head dim")
    if H % Hkv:
        raise ValueError(f"q heads {H} not a multiple of kv heads {Hkv}")
    if not S_new <= kv_len <= T:
        raise ValueError(f"flash_decode: need S_new ({S_new}) <= kv_len "
                         f"({kv_len}) <= T ({T})")


def cache_prefix(k_cache, v_cache, kv_len: int):
    """The filled prefix of a (B, T, Hkv, D) cache as k/v (B, Hkv, kv_len,
    D) views: the forward's layout."""
    return (k_cache[:, :kv_len].transpose(1, 2),
            v_cache[:, :kv_len].transpose(1, 2))


_SM_COUNTS: dict = {}
_SPLIT_COUNTERS: dict = {}


def _sm_count(device) -> int:
    """The SM count of a CUDA device, read once per device."""
    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _SM_COUNTS:
        _SM_COUNTS[idx] = \
            torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNTS[idx]


def _ptr(t):
    """A tensor's device pointer, or None (NULL) for no tensor."""
    return None if t is None else t.data_ptr()


def _split_counters(device, n: int):
    """At least ``n`` zeroed int32 counters on ``device`` for the split
    decode kernel, kept per device: the kernel's last block of each (b,
    kv head) sets its counter back to zero."""
    t = _SPLIT_COUNTERS.get(device)
    if t is None or t.numel() < n:
        t = _SPLIT_COUNTERS[device] = torch.zeros(n, dtype=torch.int32,
                                                  device=device)
    return t


def decode_splits(B: int, Hkv: int, T: int, sm_count: int) -> int:
    """The number of key slices the split-KV decode kernel launches per
    (b, kv head): as many as one wave holds, n_split * B * Hkv blocks at
    most four an SM (what fits; a fifth would wait for a second wave),
    which covers the SMs at least twice; capped so that every slice can
    hold one 64-key tile of the cache (T keys). It does not depend on
    kv_len, so the launch geometry stays the same from step to step."""
    want = DECODE_BLOCKS_PER_SM * sm_count // (B * Hkv)
    return max(1, min(want, -(-T // SPLIT_TILE)))


def decode_split_ranges(kv_len: int, n_split: int) -> list:
    """The key range [lo, hi) of each of the ``n_split`` slices of a
    filled prefix of ``kv_len`` keys, as the kernel derives them: c =
    ceil(kv_len / n_split) rounded up to 64 keys, slice s over [s*c,
    min((s+1)*c, kv_len)); a slice past the prefix is empty (lo == hi)."""
    c = -(-(-(-kv_len // n_split)) // SPLIT_TILE) * SPLIT_TILE
    out = []
    for s in range(n_split):
        lo = min(s * c, kv_len)
        out.append((lo, min(lo + c, kv_len)))
    return out


def flash_decode_ref(q, k_cache, v_cache, kv_len: int,
                     sm_scale: float | None = None):
    """Plain PyTorch version of B12 (any device). Query i of the S_new
    new tokens sits at position kv_len - S_new + i and sees cache
    positions up to its own; nothing at or past kv_len is read."""
    S_new, D = q.shape[2], q.shape[3]
    scale = float(D) ** -0.5 if sm_scale is None else sm_scale
    k, v = cache_prefix(k_cache, v_cache, kv_len)
    _m, p, l, vf = _fwd_parts(q, k, v, True, scale, kv_len - S_new)
    return (torch.matmul(p, vf) / l).reshape(q.shape).to(q.dtype)


def flash_decode(q, k_cache, v_cache, kv_len: int,
                 sm_scale: float | None = None,
                 block_k: int | None = None):
    """KV-cache attention for decode and chunked prefill. q (B, H, S_new,
    D): the newest tokens' queries at positions kv_len - S_new ..
    kv_len - 1; k_cache/v_cache (B, T, Hkv, D), filled through
    ``kv_len`` (a host int: no device sync). Causal within the new
    tokens. Returns (B, H, S_new, D). ``block_k`` is the reference's
    argument; the kernel's key tile is its own."""
    global decode_launches, prefill_launches, prefill_wgmma_launches
    global decode_split_launches, last_decode_splits
    kv_len = int(kv_len)
    _check_decode(q, k_cache, v_cache, kv_len)
    B, H, S_new, D = q.shape
    T, Hkv = k_cache.shape[1], k_cache.shape[2]
    scale = float(D) ** -0.5 if sm_scale is None else float(sm_scale)
    if q.device.type == "cpu":
        plain_runs["decode"] += 1
        return flash_decode_ref(q, k_cache, v_cache, kv_len, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode: no kernel for device {q.device}")
    _kernel_ready("flash_decode", q, k_cache, v_cache)
    o = torch.empty_like(q)
    n_split, ws, counters = 0, None, None
    if S_new == 1:    # the split route's counters and partials (acc, m, l)
        n_split = decode_splits(B, Hkv, T, _sm_count(q.device))
        counters = _split_counters(q.device, B * H)
        ws = torch.empty(B * H * n_split * (D + 2), dtype=torch.float32,
                         device=q.device)
    _build.check(_build.library().accl_attn_decode(
        _DTYPE_CODES[q.dtype], D, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), o.data_ptr(), _ptr(ws), _ptr(counters), B, H,
        Hkv, T, S_new, kv_len, n_split, scale, _build.stream_of(q)),
        "flash_decode")
    if S_new == 1:
        decode_launches += 1
        decode_split_launches += 1
        last_decode_splits = n_split
    else:
        prefill_launches += 1
        if q.dtype == torch.bfloat16:
            prefill_wgmma_launches += 1
    return o
