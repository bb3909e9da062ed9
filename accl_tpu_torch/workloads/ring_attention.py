"""Ring attention as a host workload: each K/V rotation issued before
the fold of the block in hand.

The port of ``accl_tpu/workloads/ring_attention.py``, on tensors of the
rank's device. Rank r holds a query block and a K/V block; it folds every
rank's K/V block into an online-softmax accumulator (running max,
denominator, numerator) while the blocks rotate one hop a step. At step
k the next block's rotation (an async send and a chained recv, double
buffered) is issued before this block's fold; ``overlap=False`` waits on
the rotation first (the serial baseline).

The fold runs in float64 torch ops on the rank's device, where the
reference folds in numpy float64, so the result matches
:func:`ring_attention_reference` to float32 rtol although the blocks
arrive in ring order. This is the driver-level workload; the model's
sequence-parallel attention kernels live in
:mod:`accl_tpu_torch.parallel.ring_attention`.
"""

from __future__ import annotations

import math

import torch

__all__ = ["ring_attention_forward", "ring_attention_reference"]


def ring_attention_reference(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor) -> torch.Tensor:
    """Serial oracle: softmax(Q K^T / sqrt(d)) V over the FULL key/value
    sequence, float64 inside."""
    q64, k64, v64 = q.double(), k.double(), v.double()
    s = (q64 @ k64.T) / math.sqrt(q.shape[-1])
    s = s - s.amax(dim=-1, keepdim=True)
    p = torch.exp(s)
    return ((p @ v64) / p.sum(dim=-1, keepdim=True)).to(q.dtype)


def _fold_block(q64, kblk, vblk, m, l, acc, scale):
    """One online-softmax update: fold a K/V block into the running
    (row max ``m``, denominator ``l``, numerator ``acc``), in place."""
    s = (q64 @ kblk.double().T) * scale
    m_new = torch.maximum(m, s.amax(dim=-1))
    corr = torch.exp(m - m_new)
    p = torch.exp(s - m_new[:, None])
    l.copy_(l * corr + p.sum(dim=-1))
    acc.copy_(acc * corr[:, None] + p @ vblk.double())
    m.copy_(m_new)


def ring_attention_forward(a, q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, comm=None,
                           compress_dtype=None,
                           block_scale: bool | int = False,
                           overlap: bool = True, use_chain: bool = True,
                           meter=None):
    """Forward pass of ring attention on driver ``a``.

    ``q``/``k``/``v`` are this rank's blocks, (block_len, d); every
    rank's K/V block has the same shape. Returns ``(out, stats)``: the
    attention output of the local queries, in q's dtype on the rank's
    device, and the meter's stats.

    Each step packs (K, V) in one device-resident buffer, sends it async
    to the next rank and posts the paired recv with ``chain=use_chain``,
    then folds the block in hand. The sends are eager, so the ring
    cannot deadlock; the recv lands in the buffer the fold is not
    reading. ``compress_dtype`` / ``block_scale`` put the rotation on a
    compressed wire (B5 and B6 with ``block_scale``)."""
    from . import OverlapMeter
    comm = comm or a.comm
    W, me = comm.size, comm.local_rank
    if k.shape != v.shape or k.ndim != 2 or q.ndim != 2 \
            or q.shape[1] != k.shape[1]:
        raise ValueError(
            f"q/k/v must be (block_len, d) with one d: got q "
            f"{tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    lkv, d = k.shape
    scale = 1.0 / math.sqrt(d)
    meter = meter if meter is not None else OverlapMeter()
    dev = a.device.ctx.device

    q64 = q.to(dev).double()
    m = torch.full((q.shape[0],), -math.inf, dtype=torch.float64,
                   device=dev)
    l = torch.zeros(q.shape[0], dtype=torch.float64, device=dev)
    acc = torch.zeros((q.shape[0], d), dtype=torch.float64, device=dev)

    if W == 1:
        _fold_block(q64, k.to(dev), v.to(dev), m, l, acc, scale)
        stats = meter.publish(a.rank, "ring_attention", steps=1)
        return (acc / l[:, None]).to(q.dtype), stats

    n = 2 * lkv * d
    cur = a.buffer((n,), torch.float32, device_resident=True)
    nxt = a.buffer((n,), torch.float32, device_resident=True)
    cur.tensor[:lkv * d] = k.to(dev, torch.float32).reshape(-1)
    cur.tensor[lkv * d:] = v.to(dev, torch.float32).reshape(-1)
    nxt_rank = (me + 1) % W
    prv_rank = (me - 1) % W

    for step in range(W):
        inflight = None
        if step < W - 1:
            # tagged by step, so that a slow rank's message cannot be
            # claimed by the next step's recv
            hs = a.send(cur, n, nxt_rank, tag=step, comm=comm,
                        compress_dtype=compress_dtype,
                        block_scale=block_scale, run_async=True)
            hr = a.recv(nxt, n, prv_rank, tag=step, comm=comm,
                        compress_dtype=compress_dtype,
                        block_scale=block_scale, run_async=True,
                        chain=use_chain)
            meter.issue(hs)
            meter.issue(hr)
            inflight = (hs, hr)
            if not overlap:
                meter.wait(hs)
                meter.wait(hr)
        kblk = cur.tensor[:lkv * d].view(lkv, d)
        vblk = cur.tensor[lkv * d:].view(lkv, d)
        _fold_block(q64, kblk, vblk, m, l, acc, scale)
        if inflight is not None:
            if overlap:
                for h in inflight:
                    meter.wait(h)
            cur, nxt = nxt, cur
    cur.free_buffer()       # this call's own: withdrawn from the registry
    nxt.free_buffer()

    stats = meter.publish(a.rank, "ring_attention", steps=W)
    return (acc / l[:, None]).to(q.dtype), stats
