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
  them. B8 and B9 each have two routes: bf16 and f16 operands run on the
  tensor cores (``attn_fwd_wgmma_kernel`` and
  ``attn_fwd_single_wgmma_kernel`` of ``csrc/attention_sm90.cu``: wgmma
  and TMA; P rounded to the operands' type before P V, see
  ``fwd_rounding_magnitudes``), f32 operands on the TF32 tensor
  cores with 3xTF32 products (``attn_fwd_kernel`` and
  ``attn_fwd_single_kernel`` of ``csrc/attention.cu``: mma.sync, Q, K, V
  and P each split into two TF32 parts, so the products keep about f32
  accuracy).
- ``flash_attention_bwd_dkv``: B10, per-q-head f32 partials of dK and
  dV; ``flash_attention_bwd_dq``: B11, dQ in q's dtype. Two routes, one
  kernel each: bf16 and f16 operands run on the tensor cores
  (``attn_bwd_{dkv,dq}_wgmma_kernel`` of ``csrc/attention_bwd_sm90.cu``:
  wgmma and TMA; P and dS rounded to the operands' type before the
  second products, see ``bwd_rounding_magnitudes``), f32 operands on the
  TF32 tensor
  cores with 3xTF32 products (``attn_bwd_{dkv,dq}_kernel`` of
  ``csrc/attention_bwd.cu``: mma.sync, each f32 operand split into two
  TF32 parts, so the products keep about f32 accuracy).
  ``flash_attention`` is differentiable through ``_FlashAttention`` (the
  counterpart of the reference's ``custom_vjp``), whose backward runs
  them.
- ``flash_decode``: B12. Single-token decode (S_new == 1), any dtype,
  runs the split-KV kernel of ``csrc/attention_decode.cu``
  (``attn_decode_split_kernel``: ``decode_splits`` slices of the filled
  prefix, merged by the last slice to finish; f32 arithmetic; past head
  dim 256 up to ``DECODE_SPLIT_MAX_D``, every dtype,
  ``attn_decode_split_wide_kernel``, its columns dealt over the threads
  and its slices merged as a tree of fan-in 8: ``takes_split``). Its
  ticket counters are kept per (device, stream): two decodes on two
  streams never share them (``_split_counters``). A 16-bit chunk of
  S_new > 1 new tokens (prefill) runs B8's tensor-core kernel over the
  cache in its own layout (``attn_fwd_wgmma_kernel`` with a 4-D tensor
  map, bottom-right causal); an f32 chunk runs ``attn_decode_kernel`` of
  ``csrc/attention.cu``, B8's 3xTF32 tile over the cache in its own
  layout.

The kernels take f32, bf16 or f16 operands with any head dim D: each
kernel is built on a few column tiers and takes D at run time, a
multiple of 8 (the tensor maps' 16-byte rows); for another D the wrapper
zero-pads q, k and v (and dO) to the next multiple of 8 (of 128 on the
16-bit kernels past 256 but the split decode: ``_pad_d``), keeps the
scale at the true D's, and slices the outputs: zero columns change no
score and give zero output columns, and the same kernel runs. Past
``COLS_HEAD_DIM`` (256), where a 64 x D f32 accumulator no longer fits a
warpgroup's registers, every kind runs a form of its own, one launch a
call. 16-bit operands: B8, B9 and the B12 chunks up to
``FWD16_CLUSTER_MAX_D`` (2048) the cluster form
(``attn_fwd_cluster_wgmma_kernel``: a cluster of ceil(D / 256) blocks,
each keeping one 256-column slice of O, forms S once a tile and sums it
through distributed shared memory in block order, two blocks by an
all-gather, more by owners) but in ``FWD16_COLS_BAND`` (512, 768] (and
B9 up to ``FWD16_SINGLE_MIN_D``, 384), and
B11 past ``BWD16_DQ_CLUSTER_MIN_D`` (640) up to 2048 its cluster form
(``attn_bwd_dq_cluster_wgmma_kernel``: S and dP once a tile, the owners
send dS back); B10 up to ``BWD16_CLUSTER_MAX_D`` (1024) the cluster form
(``attn_bwd_dkv_cluster_wgmma_kernel``: a cluster of D / 128 blocks, each
keeping one 128-column slice, forms S and dP once a tile and sums them
through distributed shared memory); at the other head dims past 256,
where the cluster forms ran no faster on an H100, the column-group form
(``attn_fwd_cols_wgmma_kernel``, ``attn_bwd_{dkv,dq}_cols_wgmma_kernel``:
a block keeps one group of the output columns (grid z) and forms S, and
dP, over the whole head dim in chunks, each group the same chunks in the
same order; ``takes_cluster16`` says which). f32 operands past 256 up
to 4096 run the cluster form (``attn_fwd_cluster_kernel`` for B8 and B9,
``attn_decode_cluster_kernel`` for B12 chunks of S_new > 1,
``attn_bwd_{dkv,dq}_cluster_kernel``: a thread-block cluster splits the
head dim into 64-column slices and forms S, and dP, once a tile); past
``F32_CLUSTER_MAX_D`` (4096) the band form: B8, B9 and the B12 chunks
(``csrc/attention_band_fwd.cu``: ``attn_fwd_band_score_kernel`` forms S
once a 128 x 64 tile over the whole head dim and stores it, with each
tile's row maxima and sums, in a workspace, ``attn_fwd_band_norm_kernel``
merges each row's stats into its LSE and turns its S into P there, and
``attn_fwd_band_pv_kernel`` forms O = P V; a band of ``fwd_band_rows`` query rows at a time, the workspace
``fwd_band_workspace_floats``), and B10 and B11
(``attn_bwd_band_score_kernel`` forms S and dP once a tile and stores P
and dS, from which ``attn_bwd_band_{dkv,dq}_kernel`` form dV, dK and dQ;
``band_rows`` rows a band, the workspace ``band_workspace_floats``);
each workspace, which the wrapper allocates, stays within q's own bytes.
A 16-bit single-token decode past ``DECODE_SPLIT_MAX_D`` runs the
chunk's form at S_new = 1; an f32 one the band decode
(``attn_decode_band_{score,pv}_kernel`` of ``csrc/attention_decode.cu``:
the scores of 8-key tiles with their stats into a workspace, then P V
over ``band_decode_splits`` key splits, 256-column slices, the splits'
partials added in split order by the last to finish: ``takes_band_decode``).
A CUDA call with another dtype raises TypeError. The reference's
wrappers check neither.

Launch counters: ``fwd_launches`` (B8), ``fwd_single_launches`` (B9),
``bwd_dkv_launches`` (B10), ``bwd_dq_launches`` (B11), and B12's two,
``decode_launches`` (one new token, S_new == 1) and ``prefill_launches``
(a chunk, S_new > 1). The C entry points report the route each launch
took (``accl_attn_last_route``: the kernel, the dtype and the column
tier), and the wrapper counts it after the launch in ``route_launches``
((route, dtype name, tier) -> launches; routes in ``ROUTES``) and in
the routes' own counters, ``fwd_wgmma_launches``,
``fwd_single_wgmma_launches``, ``prefill_wgmma_launches`` (the B8, B9
and B12 prefill launches on the tensor cores),
``decode_split_launches`` (the B12 decode launches on the split-KV
kernels) and ``decode_band_launches`` (on the band decode;
``last_decode_splits`` holds the last decode's ``n_split`` on either).
``plain_runs`` counts the plain versions' runs on the CPU under the
branch the dispatch chose ("fwd", "fwd_single", "bwd_dkv", "bwd_dq",
"decode").
"""

from __future__ import annotations

import torch

from .. import _build

_NEG_INF = torch.finfo(torch.float32).min
# csrc/attention.cu's dtype codes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
COLS_HEAD_DIM = 256      # past it: the column-group kernels
KERNEL_D_STEP = 8        # the kernels' head dims: multiples of 8 ...
COLS_CHUNK = 128         # ... and of 128 on the 16-bit ones past 256
_HALF = (torch.bfloat16, torch.float16)
# the route codes of csrc/attention_route.cuh (ROUTE_*); "_cols": head
# dims past COLS_HEAD_DIM (the column-group form, or for f32 to 4096 the
# cluster form, whose tier is a block's columns: 128, 256 or 512);
# "_cluster": the 16-bit cluster forms (tier a block's slice: 128 for
# B10, 256 for B8, B9, the B12 chunks and B11); "_band": the f32 B10 and
# B11 past F32_CLUSTER_MAX_D, "fwd_*_tf32_band", "prefill_tf32_band" the
# f32 B8, B9 and B12 chunks there (tier a product tile's 128 columns), and
# "decode_band" the f32 single-token decode past DECODE_SPLIT_MAX_D (tier
# a product slice's 256 columns); no launch reports 19 any more
ROUTES = {1: "fwd_wgmma", 2: "fwd_single_wgmma", 3: "prefill_wgmma",
          4: "decode_split", 5: "fwd_tf32", 6: "fwd_single_tf32",
          7: "prefill_tf32", 8: "bwd_dkv_wgmma", 9: "bwd_dq_wgmma",
          10: "bwd_dkv_tf32", 11: "bwd_dq_tf32",
          12: "fwd_wgmma_cols", 13: "fwd_single_wgmma_cols",
          14: "prefill_wgmma_cols", 15: "decode_wgmma_cols",
          16: "fwd_tf32_cols", 17: "fwd_single_tf32_cols",
          18: "prefill_tf32_cols", 19: "decode_tf32_cols",
          20: "bwd_dkv_wgmma_cols", 21: "bwd_dq_wgmma_cols",
          22: "bwd_dkv_tf32_cols", 23: "bwd_dq_tf32_cols",
          24: "bwd_dkv_wgmma_cluster", 25: "fwd_wgmma_cluster",
          26: "fwd_single_wgmma_cluster", 27: "prefill_wgmma_cluster",
          28: "bwd_dq_wgmma_cluster", 29: "bwd_dkv_tf32_band",
          30: "bwd_dq_tf32_band", 31: "fwd_tf32_band",
          32: "fwd_single_tf32_band", 33: "prefill_tf32_band",
          34: "decode_band"}
_DTYPE_NAMES = {0: "float32", 1: "bfloat16", 2: "float16"}
SPLIT_TILE = 64          # a decode split's key range is a multiple of it
DECODE_SPLIT_MAX_D = 2048  # single-token decode: split-KV up to it
BWD16_CLUSTER_MAX_D = 1024  # 16-bit B10: the cluster form up to it
# 16-bit B8, B9 and the B12 chunks: the cluster form past 256 (B9 past
# FWD16_SINGLE_MIN_D) up to FWD16_CLUSTER_MAX_D, but at FWD16_COLS_BAND
# (clusters of three blocks, slower than the column groups); B11 past
# BWD16_DQ_CLUSTER_MIN_D up to
# FWD16_CLUSTER_MAX_D (csrc/attention_sm90.cu fwd16_cluster,
# csrc/attention_bwd_sm90.cu)
FWD16_CLUSTER_MAX_D = 2048
FWD16_COLS_BAND = (512, 768)
FWD16_SINGLE_MIN_D = 384       # B9: the column groups up to it
BWD16_DQ_CLUSTER_MIN_D = 640
DECODE_BLOCKS_PER_SM = 4  # csrc/attention_decode.cu BLOCKS_PER_SM
# the f32 cluster forms' last head dim (csrc/attention_cluster.cuh
# CLUSTER_MAX_D); past it the f32 B10 and B11 take the band form, whose
# bands are whole tiles of BAND_TILE rows (csrc/attention_bwd.cu BT)
F32_CLUSTER_MAX_D = 4096
BAND_TILE = 64
# the f32 single-token decode's band form past DECODE_SPLIT_MAX_D
# (csrc/attention_decode.cu): keys a score tile (BD_KEYS), f32 columns a
# product slice (bd_slice<float>)
BAND_DECODE_KEYS = 8
BAND_DECODE_SLICE = 256

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
decode_band_launches = 0
last_decode_splits = None
route_launches: dict = {}
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


def _d_step(dtype, D: int, split: bool = False) -> int:
    """The multiple of which the kernels take head dim D: KERNEL_D_STEP,
    or COLS_CHUNK for the 16-bit kernels past COLS_HEAD_DIM (their chunks
    and slices are whole TMA tiles of 128 columns) but the split decode
    (``split``), whose wide kernel takes any multiple of 8 up to its
    tier."""
    if D > COLS_HEAD_DIM and dtype in _HALF and not split:
        return COLS_CHUNK
    return KERNEL_D_STEP


def _kernel_ready(what: str, *ts, split: bool = False):
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
                        f"(float32, bfloat16 or float16)")
    D = t0.shape[-1]
    step = _d_step(t0.dtype, D, split)
    if D % step or D < step:
        raise ValueError(f"{what} kernel: head dim {D} not a positive "
                         f"multiple of {step} (the wrapper pads to one)")


def _pad_d(*ts, split: bool = False):
    """``ts`` zero-padded in their last dim to the next multiple of
    ``_d_step``: KERNEL_D_STEP, or COLS_CHUNK for the 16-bit kernels past
    COLS_HEAD_DIM (their chunks of S are whole TMA tiles) unless the call
    takes the split decode (``split``: a single-token decode that
    ``takes_split``; the wide kernel reads only the columns to the next
    multiple of 8, where 128 would read up to 45 % more at D 264); as
    they are when already a multiple."""
    D = ts[0].shape[-1]
    pad = -D % _d_step(ts[0].dtype, D, split)
    if not pad:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in ts)


def takes_cluster16(kind: str, head_dim: int) -> bool:
    """Whether a 16-bit launch of ``kind`` ("fwd", "fwd_single", "prefill"
    (a B12 chunk of S_new > 1), "bwd_dkv", "bwd_dq") at the padded head
    dim ``head_dim`` takes its thread-block cluster form: B10 past
    ``COLS_HEAD_DIM`` up to ``BWD16_CLUSTER_MAX_D``; B8, B9 (past
    ``FWD16_SINGLE_MIN_D``) and the chunks up to ``FWD16_CLUSTER_MAX_D``
    but in ``FWD16_COLS_BAND`` (lo, hi];
    B11 past ``BWD16_DQ_CLUSTER_MIN_D`` up to ``FWD16_CLUSTER_MAX_D``. The
    C entry points decide; this mirrors them."""
    if kind == "bwd_dkv":
        return COLS_HEAD_DIM < head_dim <= BWD16_CLUSTER_MAX_D
    if kind == "bwd_dq":
        return BWD16_DQ_CLUSTER_MIN_D < head_dim <= FWD16_CLUSTER_MAX_D
    if kind not in ("fwd", "fwd_single", "prefill"):
        return False
    lo, hi = FWD16_COLS_BAND
    first = FWD16_SINGLE_MIN_D if kind == "fwd_single" else COLS_HEAD_DIM
    return (first < head_dim <= FWD16_CLUSTER_MAX_D
            and not lo < head_dim <= hi)


def _took_route():
    """Count the route the last launch took, as the C entry point reported
    it."""
    global fwd_wgmma_launches, fwd_single_wgmma_launches
    global prefill_wgmma_launches, decode_split_launches
    global decode_band_launches
    code = _build.library().accl_attn_last_route()
    route = ROUTES.get(code >> 16, f"unknown {code >> 16}")
    key = (route, _DTYPE_NAMES.get((code >> 12) & 15, "unknown"),
           code & 0xFFF)
    route_launches[key] = route_launches.get(key, 0) + 1
    # the tensor-core counters: every form
    base = route.removesuffix("_cols").removesuffix("_cluster")
    if base == "fwd_wgmma":
        fwd_wgmma_launches += 1
    elif base == "fwd_single_wgmma":
        fwd_single_wgmma_launches += 1
    elif base == "prefill_wgmma":
        prefill_wgmma_launches += 1
    elif route == "decode_split":
        decode_split_launches += 1
    elif route == "decode_band":
        decode_band_launches += 1


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


def fwd_subnormal_magnitudes(q, k, v, causal: bool = True,
                             scale: float | None = None, off: int = 0):
    """Plain helper for the limit of the forward's f16 route, where a P
    below 2^-14 rounds in f16's subnormal range with an absolute step of
    2^-24 (any device; the main path never calls it): s_i = sum over the
    visible keys j of |v_j| / l_i, shaped like O, f32, so that 2^-25 * s
    bounds what those roundings move an output by. Arguments as
    :func:`fwd_rounding_magnitudes`."""
    scale = float(q.shape[-1]) ** -0.5 if scale is None else scale
    _m, p, l, vf = _fwd_parts(q, k, v, causal, scale, off)
    return (torch.matmul((p > 0).float(), vf.abs()) / l).reshape(q.shape)


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
    global fwd_launches, fwd_single_launches
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
    q, k, v = _pad_d(q, k, v)
    _kernel_ready("flash_attention", q, k, v)
    DK = q.shape[-1]
    o = torch.empty_like(q)
    lse = torch.empty(B * H, Sq, dtype=torch.float32, device=q.device)
    ws = None
    if takes_band(q.dtype, DK):
        ws = torch.empty(fwd_band_workspace_floats(B * H, Sq, Skv, DK),
                         dtype=torch.float32, device=q.device)
    fn = (_build.library().accl_attn_fwd_single if single
          else _build.library().accl_attn_fwd)
    _build.check(fn(_DTYPE_CODES[q.dtype], DK, q.data_ptr(), k.data_ptr(),
                    v.data_ptr(), o.data_ptr(), lse.data_ptr(), _ptr(ws), B,
                    H, Hkv, Sq, Skv, int(causal), scale,
                    _build.stream_of(q)),
                 "flash_attention")
    _took_route()
    if single:
        fwd_single_launches += 1
    else:
        fwd_launches += 1
    return (o if DK == D else o[..., :D].contiguous()), lse


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


def bwd_subnormal_magnitudes(q, do, k, v, lse, delta, causal: bool,
                             scale: float):
    """Plain helper for the limits of B10/B11's f16 route (any device;
    the main path never calls it): a P or dS below 2^-14 rounds in f16's
    subnormal range with an absolute step of 2^-24. The sums of the
    other operand's magnitudes over each output's visible pairs, shaped
    like (dk_part, dv_part, dq), f32: scale sum_i |q_i|, sum_i |do_i|
    (over the queries that see key j) and scale sum_j |k_j| (over the
    keys query i sees), so that 2^-25 times each bounds what those
    roundings move an output by."""
    qf, dof, kf, p, _ds = _bwd_parts(q, do, k, v, lse, delta, causal, scale)
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    vis = (p > 0).float()
    dk = torch.matmul(vis.transpose(-1, -2), qf.abs()) * scale
    dv = torch.matmul(vis.transpose(-1, -2), dof.abs())
    dq = torch.matmul(vis, kf.abs()) * scale
    return (dk.reshape(B * H, Skv, D), dv.reshape(B * H, Skv, D),
            dq.reshape(B, H, Sq, D))


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def _band_words(dkv: bool, R: int, Skv: int) -> int:
    """A head's workspace words for a band of R rows (csrc/attention_bwd.cu
    ``band_words``): B10 P^T and dS^T, Skv rows at a pitch of round4(R)
    each; B11 dS, R rows at a pitch of round4(Skv)."""
    return 2 * Skv * _round4(R) if dkv else R * _round4(Skv)


def band_rows(dkv: bool, Sq: int, Skv: int, head_dim: int) -> int:
    """The query rows a band of the f32 B10 (``dkv``) or B11 band form
    takes (csrc/attention_bwd.cu ``band_rows``, which decides; this
    mirrors it): Sq where the workspace fits in q's own words, Sq *
    head_dim a head; else the largest multiple of ``BAND_TILE`` that
    fits, at least min(Sq, BAND_TILE)."""
    budget = Sq * head_dim
    if _band_words(dkv, Sq, Skv) <= budget:
        return Sq
    r = budget // (2 * Skv if dkv else _round4(Skv)) // BAND_TILE * BAND_TILE
    return min(max(r, min(Sq, BAND_TILE)), Sq)


def band_workspace_floats(dkv: bool, B: int, H: int, Sq: int, Skv: int,
                          head_dim: int) -> int:
    """The f32 words of the band form's workspace for one call: each of
    the B * H heads' buffers for a band of ``band_rows`` rows."""
    return B * H * _band_words(dkv, band_rows(dkv, Sq, Skv, head_dim), Skv)


def takes_band(dtype, head_dim: int) -> bool:
    """Whether B8, B9, the B12 chunks, B10 and B11 of ``dtype`` at the
    padded ``head_dim`` run the band form: f32 past ``F32_CLUSTER_MAX_D``."""
    return dtype == torch.float32 and head_dim > F32_CLUSTER_MAX_D


def _fwd_band_words(R: int, keys: int) -> int:
    """A head's workspace words of the forward's band form for a band of R
    rows (csrc/attention_band_fwd.cu ``fwd_band_words``): S at a pitch of
    round4(keys), then each row's (m, l) of every BAND_TILE-key tile."""
    return R * (_round4(keys) + 2 * -(-keys // BAND_TILE))


def fwd_band_rows(rows: int, keys: int, head_dim: int) -> int:
    """The query rows a band of the f32 forward's band form takes
    (csrc/attention_band_fwd.cu ``fwd_band_rows``, which decides; this
    mirrors it): a head's ``rows`` (B8, B9: Sq; a B12 chunk: group *
    S_new) where the workspace fits in q's own words, rows * head_dim a
    head; else the largest multiple of ``BAND_TILE`` that fits, at least
    min(rows, BAND_TILE)."""
    budget = rows * head_dim
    if _fwd_band_words(rows, keys) <= budget:
        return rows
    per_row = _round4(keys) + 2 * -(-keys // BAND_TILE)
    r = budget // per_row // BAND_TILE * BAND_TILE
    return min(max(r, min(rows, BAND_TILE)), rows)


def fwd_band_workspace_floats(heads: int, rows: int, keys: int,
                              head_dim: int) -> int:
    """The f32 words of the forward band form's workspace for one call:
    each of the ``heads`` heads' (B8, B9: B * H; a chunk: B * Hkv) S and
    stats for a band of ``fwd_band_rows`` rows."""
    return heads * _fwd_band_words(fwd_band_rows(rows, keys, head_dim),
                                   keys)


def _bwd_launch(name, what, q, do, k, v, lse, delta, make_outs, causal,
                scale):
    """Launch B10 or B11 with outputs ``make_outs(q_padded)`` (a tuple)
    and, on the band form, its workspace; returns the outputs sliced back
    to the true head dim."""
    D = q.shape[-1]
    q, do, k, v = _pad_d(q, do, k, v)
    _kernel_ready(what, q, do, k, v)
    for t in (lse, delta):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{what}: lse and delta must be contiguous on "
                             f"q's device")
    B, H, Sq, DK = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    outs = make_outs(q)
    ws = None
    if takes_band(q.dtype, DK):
        ws = torch.empty(band_workspace_floats(
            name.endswith("dkv"), B, H, Sq, Skv, DK), dtype=torch.float32,
            device=q.device)
    fn = getattr(_build.library(), name)
    _build.check(fn(_DTYPE_CODES[q.dtype], DK, q.data_ptr(), do.data_ptr(),
                    k.data_ptr(), v.data_ptr(), lse.data_ptr(),
                    delta.data_ptr(), *(t.data_ptr() for t in outs),
                    _ptr(ws), B, H, Hkv, Sq, Skv, int(causal), scale,
                    _build.stream_of(q)),
                 what)
    _took_route()
    return tuple(t if DK == D else t[..., :D].contiguous() for t in outs)


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
    B, H = q.shape[:2]
    Skv = k.shape[2]

    def outs(qp):
        dk = torch.empty(B * H, Skv, qp.shape[-1], dtype=torch.float32,
                         device=q.device)
        return dk, torch.empty_like(dk)
    dk, dv = _bwd_launch("accl_attn_bwd_dkv", "flash_attention_bwd_dkv", q,
                         do, k, v, lse, delta, outs, causal, scale)
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
    dq, = _bwd_launch("accl_attn_bwd_dq", "flash_attention_bwd_dq", q, do,
                      k, v, lse, delta, lambda qp: (torch.empty_like(qp),),
                      causal, scale)
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
_SPLIT_COUNTERS: dict = {}   # (device index, stream handle) -> counters


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


def _split_counters(key, device, n: int):
    """At least ``n`` zeroed int32 counters on ``device`` for the split
    decode kernel, kept per ``key``: (device index, stream handle), the
    stream the launch goes to. The kernel's last block of each (b, kv
    head) takes a ticket and sets its counter back to zero, so two
    launches in flight at once must not share counters: two streams get
    two tensors, and one stream's launches run in order on its own. A
    tensor is replaced (to hold more) only by a call on its own stream,
    so the old one is freed behind that stream's earlier launches (the
    caching allocator orders a free by the stream of its allocation).
    Zeroed once, not a call: a memset would add a launch to every decode
    step."""
    t = _SPLIT_COUNTERS.get(key)
    if t is None or t.numel() < n:
        t = _SPLIT_COUNTERS[key] = torch.zeros(n, dtype=torch.int32,
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


def takes_split(dtype, head_dim: int) -> bool:
    """Whether a single-token decode (S_new == 1) of ``dtype`` (f32, bf16
    or f16) at head dim ``head_dim`` runs the split-KV kernel: up to
    ``DECODE_SPLIT_MAX_D``, every dtype (past ``COLS_HEAD_DIM`` the wide
    kernel of ``csrc/attention_decode.cu``); past it 16-bit the chunk's
    route at S_new = 1 (the tensor-core prefill form), f32 the band decode
    (``takes_band_decode``)."""
    return dtype in _DTYPE_CODES and head_dim <= DECODE_SPLIT_MAX_D


def takes_band_decode(dtype, head_dim: int) -> bool:
    """Whether a single-token decode of ``dtype`` at the padded
    ``head_dim`` runs the band decode of ``csrc/attention_decode.cu``: f32
    past ``DECODE_SPLIT_MAX_D``."""
    return dtype == torch.float32 and head_dim > DECODE_SPLIT_MAX_D


def band_decode_tiles(T: int) -> int:
    """The band decode's score tiles over a cache of T rows (the score
    pass's grid; csrc/attention_decode.cu ``bd_tiles``)."""
    return -(-T // BAND_DECODE_KEYS)


def band_decode_splits(B: int, Hkv: int, T: int, head_dim: int,
                       sm_count: int) -> int:
    """The key splits of the band decode's product pass: about two blocks
    an SM over its (slices of ``BAND_DECODE_SLICE`` columns, splits, B *
    Hkv) grid, at most one a score tile of the T-row cache. It does not
    depend on kv_len, so the launch geometry stays the same from step to
    step."""
    slices = -(-head_dim // BAND_DECODE_SLICE)
    want = 2 * sm_count // (B * Hkv * slices)
    return max(1, min(want, band_decode_tiles(T)))


def band_decode_workspace_floats(B: int, H: int, T: int, n_split: int,
                                 head_dim: int) -> int:
    """The f32 words of the band decode's workspace: each of the B * H
    rows' n_split partials of head_dim columns, its scores at a pitch of
    the tiles' keys, and its (m, l) of every tile."""
    tiles = band_decode_tiles(T)
    return B * H * (n_split * head_dim + tiles * BAND_DECODE_KEYS + 2 * tiles)


def split_workspace_floats(B: int, H: int, n_split: int,
                           head_dim: int) -> int:
    """The f32 words of the split route's workspace: each of the B * H
    rows' n_split partials (acc over head_dim columns, then m and l)."""
    return B * H * n_split * (head_dim + 2)


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
    global decode_launches, prefill_launches, last_decode_splits
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
    split = S_new == 1 and takes_split(q.dtype, D)
    q, k_cache, v_cache = _pad_d(q, k_cache, v_cache, split=split)
    _kernel_ready("flash_decode", q, k_cache, v_cache, split=split)
    DK = q.shape[-1]
    band = S_new == 1 and takes_band_decode(q.dtype, DK)
    o = torch.empty_like(q)
    n_split, ws, counters = 0, None, None
    stream = _build.stream_of(q)
    if split:         # the split route's counters and partials (acc, m, l)
        n_split = decode_splits(B, Hkv, T, _sm_count(q.device))
        # the wide kernel's merge tree: a counter a node, n_split a row
        counters = _split_counters(
            (q.device.index, stream), q.device,
            B * H * (n_split if DK > COLS_HEAD_DIM else 1))
        ws = torch.empty(split_workspace_floats(B, H, n_split, DK),
                         dtype=torch.float32, device=q.device)
    elif band:        # the band decode's counters, partials and scores
        n_split = band_decode_splits(B, Hkv, T, DK, _sm_count(q.device))
        counters = _split_counters(
            (q.device.index, stream), q.device,
            B * H * -(-DK // BAND_DECODE_SLICE))
        ws = torch.empty(band_decode_workspace_floats(B, H, T, n_split, DK),
                         dtype=torch.float32, device=q.device)
    elif S_new > 1 and takes_band(q.dtype, DK):   # the chunk's band form
        ws = torch.empty(fwd_band_workspace_floats(
            B * Hkv, (H // Hkv) * S_new, kv_len, DK), dtype=torch.float32,
            device=q.device)
    _build.check(_build.library().accl_attn_decode(
        _DTYPE_CODES[q.dtype], DK, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), o.data_ptr(), _ptr(ws), _ptr(counters), B, H,
        Hkv, T, S_new, kv_len, n_split, scale, stream), "flash_decode")
    _took_route()
    if S_new == 1:
        decode_launches += 1
        last_decode_splits = n_split if split or band else None
    else:
        prefill_launches += 1
    return o if DK == D else o[..., :D].contiguous()
