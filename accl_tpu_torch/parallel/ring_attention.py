"""Ring attention: exact long-context attention over the W sequence shards
of one rank group.

The counterpart of ``accl_tpu/parallel/ring_attention.py``. Rank r holds
the r-th slice of the sequence (q, k, v each (B, h, S/W, D)); K/V blocks
travel the ring, one permutation round a hop
(``RankCollectives.exchange``, pairs (j, j - 1): the reference's
ppermute), so that at hop i rank r holds the block that started at rank
(r + i) % W, and no rank ever holds more than S/W keys. GQA K/V travel
un-repeated (Hkv heads).

Operands are rank rows: a (W, B, h, S/W, D) tensor, row r being rank
r's shard. Each visible (rank, block) pair is one launch of the
attention kernels of :mod:`..ops.attention`:

- forward (``ring_attention_fwd``): ``flash_attention_fwd`` (B8, or B9
  for a block of at most 512 keys) over the block, causal on the
  diagonal block, unmasked on a past one; a future block (causal) is
  skipped, where the reference computes it fully masked, which adds
  nothing. Each launch's O and LSE merge into the rank's running result
  in f32 (``lse' = logaddexp(lse, lse_b)``, the split-KV decode's
  rule); O is cast to q's dtype once at the end. A causal call launches
  W(W+1)/2 blocks, a non-causal one W^2.
- backward (``_RingAttention``): the hops walked back, K/V with their
  f32 dK/dV accumulators travelling the other way (pairs (j, j + 1)),
  so that each block's gradient is home after hop 0; each visible pair
  runs B10 (per-q-head f32 dK, dV partials, group-summed) and B11 (dQ)
  with the rank's merged LSE and delta = rowsum(dO * O); every gradient
  accumulates in f32 and is cast to its input's dtype once.

On CPU tensors the same steps run the kernels' plain versions.
``block_update`` is the reference's per-block online-softmax step,
literally; ``ring_attention_ref`` runs the reference's whole schedule
through it (every block, future ones masked), differentiable by torch
autograd: the plain version of the ring, which the main path never
calls.
"""

from __future__ import annotations

import torch

from ..ops.attention import (_dense, bwd_rounding_magnitudes,
                             flash_attention_bwd_dkv, flash_attention_bwd_dq,
                             flash_attention_bwd_dq_ref, flash_attention_fwd,
                             flash_attention_ref, fwd_rounding_magnitudes)
from .collectives import RankCollectives

_NEG_INF = torch.finfo(torch.float32).min


def block_update(q, k, v, m, l, acc, q_pos, k_pos, sm_scale, causal):
    """One online-softmax accumulation of q against a (k, v) block (the
    reference's ``_block_update``).

    Grouped GQA layout: q (B, Hkv, G, Sq, D), G query heads per KV head;
    k/v (B, Hkv, Skv, D); m/l (B, Hkv, G, Sq, 1); acc (B, Hkv, G, Sq, D)
    f32; q_pos/k_pos the global positions. Returns updated (m, l, acc)."""
    s = torch.einsum("bngqd,bnkd->bngqk", q.float(), k.float()) * sm_scale
    if causal:
        mask = k_pos[None, :] <= q_pos[:, None]          # (Sq, Skv)
        s = torch.where(mask, s, _NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
    # rows with no valid key yet keep m == -inf; exp of (-inf - finite)
    # underflows to 0 instead of producing NaN
    safe = torch.where(m_new == _NEG_INF, 0.0, m_new)
    p = torch.exp(s - safe)
    if causal:
        p = torch.where(mask, p, 0.0)
    alpha = torch.exp(torch.where(m == _NEG_INF, _NEG_INF, m - safe))
    l = l * alpha + p.sum(dim=-1, keepdim=True)
    acc = acc * alpha + torch.einsum("bngqk,bnkd->bngqd", p, v.float())
    return m_new, l, acc


def to_rank_rows(x: torch.Tensor, W: int) -> torch.Tensor:
    """A global (B, h, S, D) tensor as W rank rows (W, B, h, S/W, D):
    rank r gets sequence slice r (a view)."""
    B, h, S, D = x.shape
    if S % W:
        raise ValueError(f"sequence length {S} not divisible by the axis "
                         f"size {W}")
    return x.reshape(B, h, W, S // W, D).permute(2, 0, 1, 3, 4)


def from_rank_rows(rows: torch.Tensor) -> torch.Tensor:
    """The inverse of :func:`to_rank_rows`: (W, B, h, S_l, D) -> (B, h,
    W * S_l, D)."""
    W, B, h, S, D = rows.shape
    return rows.permute(1, 2, 0, 3, 4).reshape(B, h, W * S, D)


def _check(q, k, v, coll: RankCollectives):
    """Rank rows of the shapes both sequence-parallel attentions take,
    on the rank group's device."""
    what = "sequence-parallel attention"
    W = coll.W
    if q.dim() != 5 or k.dim() != 5 or v.shape != k.shape:
        raise ValueError(f"{what}: q (W, B, H, S, D), k/v (W, B, Hkv, S, "
                         f"D); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[0] != W or k.shape[0] != W:
        raise ValueError(f"{what}: {W} rank rows expected, got "
                         f"{q.shape[0]} and {k.shape[0]}")
    if (k.shape[1], k.shape[3], k.shape[4]) != (q.shape[1], q.shape[3],
                                                q.shape[4]):
        raise ValueError(f"{what}: q and k/v differ in batch, shard length "
                         f"or head dim")
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads "
                         f"{k.shape[2]}")
    for t in (q, k, v):
        if t.device != coll.device:
            raise ValueError(f"{what}: operands on {t.device}, the rank "
                             f"group on {coll.device}")


def _scale(q, sm_scale):
    return float(q.shape[-1]) ** -0.5 if sm_scale is None else float(
        sm_scale)


def _visible(me: int, origin: int, causal: bool) -> bool:
    """Whether rank ``me``'s queries see any key of the block that
    started at rank ``origin``."""
    return not causal or origin <= me


def _ring_fwd(q, k, v, coll: RankCollectives, causal: bool, scale: float):
    W, B, H, S, D = q.shape
    o = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.empty((W, B * H, S), dtype=torch.float32, device=q.device)
    kv = [(k[r], v[r]) for r in range(W)]
    pairs = [(j, (j - 1) % W) for j in range(W)]
    for i in range(W):
        for me in range(W):
            origin = (me + i) % W
            if not _visible(me, origin, causal):
                continue
            o_b, lse_b = flash_attention_fwd(q[me], *kv[me],
                                             causal and origin == me, scale)
            if i == 0:                         # the diagonal block
                o[me].copy_(o_b)
                lse[me].copy_(lse_b)
                continue
            new = torch.logaddexp(lse[me], lse_b)
            w = torch.exp(lse[me] - new).view(B, H, S, 1)
            w_b = torch.exp(lse_b - new).view(B, H, S, 1)
            o[me].mul_(w).add_(o_b * w_b)
            lse[me].copy_(new)
        if i < W - 1:
            kv = coll.exchange(kv, pairs)
    return o.to(q.dtype), lse


def ring_attention_fwd(q, k, v, coll: RankCollectives, causal: bool = True,
                       sm_scale: float | None = None):
    """Ring attention forward over the W ranks of ``coll``. q (W, B, H,
    S_l, D), k/v (W, B, Hkv, S_l, D) rank rows. Returns (O (W, B, H, S_l,
    D) in q's dtype, the merged LSE (W, B*H, S_l) f32: row r in the
    kernels' (B*H, S_l) layout)."""
    q, k, v = (_dense(t) for t in (q, k, v))
    _check(q, k, v, coll)
    return _ring_fwd(q, k, v, coll, causal, _scale(q, sm_scale))


class _RingAttention(torch.autograd.Function):
    """Ring attention with the FlashAttention-2 backward per block (see
    the module docstring): forward saves q, k, v, the merged O and LSE;
    backward runs B10 and B11 once per visible (rank, block) pair."""

    @staticmethod
    def forward(ctx, q, k, v, coll, causal, scale):
        o, lse = _ring_fwd(q, k, v, coll, causal, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.coll, ctx.causal, ctx.scale = coll, causal, scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        coll, causal, scale = ctx.coll, ctx.causal, ctx.scale
        W, B, H, S, D = q.shape
        Hkv = k.shape[2]
        g = H // Hkv
        do = _dense(do)
        delta = (do.float() * o.float()).sum(dim=-1).reshape(W, B * H, S)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros_like(dk)
        # the forward's last hop: rank me holds the block of origin
        # (me + W - 1) % W; walking back, blocks move to the next rank
        last = [(me + W - 1) % W for me in range(W)]
        hop = [(k[j], v[j], dk[j], dv[j]) for j in last]
        back = [(j, (j + 1) % W) for j in range(W)]
        for i in reversed(range(W)):
            for me in range(W):
                origin = (me + i) % W
                if not _visible(me, origin, causal):
                    continue
                kb, vb, dkb, dvb = hop[me]
                args = (q[me], do[me], kb, vb, lse[me], delta[me],
                        causal and origin == me, scale)
                dk_p, dv_p = flash_attention_bwd_dkv(*args)
                dkb += dk_p.view(B, Hkv, g, S, D).sum(2)
                dvb += dv_p.view(B, Hkv, g, S, D).sum(2)
                dq[me] += flash_attention_bwd_dq(*args)
            if i > 0:
                hop = coll.exchange(hop, back)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None)


def ring_attention(q, k, v, coll: RankCollectives, causal: bool = True,
                   sm_scale: float | None = None) -> torch.Tensor:
    """Exact attention with K/V ring-rotated over the W ranks of
    ``coll``. q (W, B, H, S_l, D), k/v (W, B, Hkv, S_l, D) rank rows
    (row r: rank r's sequence slice, global positions r*S_l ..); returns
    O (W, B, H, S_l, D) in q's dtype. Differentiable: when grad is
    enabled and an input requires grad, it runs through
    ``_RingAttention`` (backward B10 and B11 a visible block)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        q, k, v = (_dense(t) for t in (q, k, v))
        _check(q, k, v, coll)
        return _RingAttention.apply(q, k, v, coll, causal,
                                    _scale(q, sm_scale))
    return ring_attention_fwd(q, k, v, coll, causal, sm_scale)[0]


def ring_attention_ref(q, k, v, causal: bool = True,
                       sm_scale: float | None = None) -> torch.Tensor:
    """Plain version of the ring (any device): the reference's schedule
    for every rank, each of the W blocks through :func:`block_update`
    (future blocks masked, as the reference computes them), then acc /
    max(l, 1e-30). Rank rows as :func:`ring_attention`; differentiable
    by torch autograd."""
    W, B, H, S, D = q.shape
    Hkv = k.shape[2]
    scale = _scale(q, sm_scale)
    pos = torch.arange(S, device=q.device)
    out = []
    for me in range(W):
        qg = q[me].reshape(B, Hkv, H // Hkv, S, D)
        m = torch.full((B, Hkv, H // Hkv, S, 1), _NEG_INF,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, Hkv, H // Hkv, S, D), device=q.device)
        for i in range(W):
            origin = (me + i) % W
            m, l, acc = block_update(qg, k[origin], v[origin], m, l, acc,
                                     me * S + pos, origin * S + pos, scale,
                                     causal)
        out.append((acc / l.clamp_min(1e-30)).reshape(B, H, S, D)
                   .to(q.dtype))
    return torch.stack(out)


def ring_rounding_magnitudes(q, k, v, lse, do=None, o=None,
                             causal: bool = True,
                             sm_scale: float | None = None) -> dict:
    """Plain helper for the limits of a bf16 ring (any device; the main
    path never calls it). Each visible block's O (B8/B9) and dQ (B11)
    are written in q's dtype before the f32 merge, so the ring adds one
    rounding of each; the bf16 kernels round P (forward), P and dS
    (backward) as ``fwd_rounding_magnitudes`` / ``bwd_rounding_magnitudes``
    say, block by block; and delta = rowsum(dO * O) is formed from O in
    q's dtype (as ``_FlashAttention`` forms it), one rounding of O away
    from the exact one. q/k/v rank rows as :func:`ring_attention`;
    ``lse`` the merged LSE (W, B*H, S_l); ``do`` and ``o`` (the ring's
    output) for the backward's. Returns f32 tensors shaped like the
    outputs they bound: "o_parts" = sum_b w_b |o_b| with w_b =
    exp(lse_b - lse), "o" = sum_b w_b m_b (the P V magnitude over the
    whole sequence); with ``do``: "dq_parts" = sum_b |dq_b|, and "dq",
    "dk", "dv", the backward's magnitudes summed over the blocks (dk, dv
    over the GQA group too), dq and dk each with the magnitude of its
    dependence on delta, scale * sum_j p_ij (sum_d |dO_id| |O_id|) |k_j|
    for dq (|q_i| and the sum over i for dk), so that 2^-8 of it bounds
    the effect of O's rounding."""
    W, B, H, S, D = q.shape
    Hkv = k.shape[2]
    scale = _scale(q, sm_scale)
    shapes = {"o_parts": q, "o": q}
    if do is not None:
        shapes.update(dq_parts=q, dq=q, dk=k, dv=k)
        dof, of = do.float(), o.float()
        delta = (dof * of).sum(dim=-1).reshape(W, B * H, S)
        delta_mag = (dof.abs() * of.abs()).sum(dim=-1).reshape(W, B * H, S)
        zero = torch.zeros_like(do[0])
    z = {name: torch.zeros(t.shape, dtype=torch.float32, device=q.device)
         for name, t in shapes.items()}
    for me in range(W):
        for origin in range(W):
            if not _visible(me, origin, causal):
                continue
            c = causal and origin == me
            blk = (q[me], k[origin], v[origin])
            o_b, lse_b = flash_attention_ref(*blk, c, scale)
            w = torch.exp(lse_b - lse[me]).view(B, H, S, 1)
            z["o_parts"][me] += w * o_b.float().abs()
            z["o"][me] += w * fwd_rounding_magnitudes(*blk, c, scale)
            if do is None:
                continue
            args = (q[me], do[me], k[origin], v[origin], lse[me],
                    delta[me], c, scale)
            z["dq_parts"][me] += flash_attention_bwd_dq_ref(
                *args).float().abs()
            dk, dv, dq = bwd_rounding_magnitudes(*args)
            # dO = 0 and delta = delta_mag: |dS| = p * delta_mag
            ek, _ev, eq = bwd_rounding_magnitudes(
                q[me], zero, k[origin], v[origin], lse[me], delta_mag[me],
                c, scale)
            z["dq"][me] += dq + eq
            z["dk"][origin] += (dk + ek).view(B, Hkv, H // Hkv, S, D).sum(2)
            z["dv"][origin] += dv.view(B, Hkv, H // Hkv, S, D).sum(2)
    return z


def ring_attention_sharded(q, k, v, mesh, axis_name: str = "sp",
                           causal: bool = True,
                           sm_scale: float | None = None) -> torch.Tensor:
    """Global-tensor wrapper: q/k/v (B, H, S, D) with S split over the
    ranks of ``mesh``'s axis ``axis_name`` (a :class:`RankMesh`, on the
    card unless made on the CPU); returns (B, H, S, D) in q's dtype."""
    coll = RankCollectives(mesh.group(axis_name))
    rows = [to_rank_rows(t, coll.W) for t in (q, k, v)]
    return from_rank_rows(ring_attention(*rows, coll, causal, sm_scale))
