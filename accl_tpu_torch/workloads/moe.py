"""Expert-parallel MoE dispatch and combine on ``alltoallv``.

The port of ``accl_tpu/workloads/moe.py``, on tensors of the rank's
device. Top-1 routing gives every local token a destination expert rank;
a skewed router makes the exchange the variable-count collective:

1. one fixed-count ``alltoall`` of the per-peer token counts;
2. ``alltoallv`` DISPATCH of the tokens grouped by destination
   (optionally on the block-scaled fp8 wire);
3. this rank's expert on what landed;
4. ``alltoallv`` COMBINE with the mirrored vectors, landing the expert
   outputs where their tokens came from.

The tokens split into ``n_chunks`` chunks: chunk c+1's dispatch and
chunk c's combine are issued before chunk c's expert runs. Every rank
derives the chunk split from the count vectors alone (floor-division
boundaries), so the per-chunk vectors stay pairwise consistent.
``overlap=False`` waits on every call at once (the serial baseline).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["moe_dispatch_combine", "moe_reference", "default_expert"]


def default_expert(rank: int, d: int, device="cuda",
                   dtype: torch.dtype = torch.float32):
    """Rank ``rank``'s expert, tanh(x W + b), with the reference's weights
    (numpy ``default_rng(1000 + rank)``, float32) moved to ``device`` in
    ``dtype`` (the card unless the caller names another device): both
    packages compute the same expert, and a float64 copy of it is the
    oracle's."""
    rng = np.random.default_rng(1000 + rank)
    w = rng.standard_normal((d, d)).astype(np.float32) / np.sqrt(d)
    b = rng.standard_normal(d).astype(np.float32) * 0.1
    wt = torch.from_numpy(w).to(device=device, dtype=dtype)
    bt = torch.from_numpy(b).to(device=device, dtype=dtype)

    def f(x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(x.to(dtype) @ wt + bt)
    f.weight, f.bias = wt, bt
    return f


def moe_reference(tokens, dest, expert_fns):
    """Serial oracle: ``tokens[r]`` is rank r's (T_r, d) tensor and
    ``dest[r]`` its destination ranks; returns each rank's outputs in its
    token order, each token through its destination rank's expert (in
    the experts' dtype)."""
    out = []
    for toks, dst in zip(tokens, dest):
        dst = torch.as_tensor(dst, device=toks.device)
        y = None
        for r in torch.unique(dst).tolist():
            sel = dst == r
            yr = expert_fns[int(r)](toks[sel])
            if y is None:
                y = torch.empty(toks.shape, dtype=yr.dtype,
                                device=toks.device)
            y[sel] = yr
        out.append(y if y is not None else toks.clone())
    return out


def _chunk_split(counts: tuple[int, ...], n_chunks: int):
    """Split a count vector into ``n_chunks`` per-chunk vectors (chunk c
    of a count-n segment is [n*c//K, n*(c+1)//K))."""
    return [tuple(c * (ci + 1) // n_chunks - c * ci // n_chunks
                  for c in counts)
            for ci in range(n_chunks)]


def moe_dispatch_combine(a, tokens: torch.Tensor, dest, *, comm=None,
                         expert_fn=None, n_chunks: int = 2,
                         compress_dtype=None,
                         block_scale: bool | int = False,
                         overlap: bool = True, meter=None):
    """Dispatch local ``tokens`` (T, d) to their ``dest`` ranks over
    ``alltoallv``, run this rank's expert on what lands, combine the
    outputs back. Returns ``(out, stats)``: ``out`` (T, d) float32 on the
    rank's device in the original token order, ``stats`` the overlap
    ledger with the count vectors.

    ``compress_dtype`` / ``block_scale`` apply to the DISPATCH leg only;
    the combine returns expert outputs at full precision. ``expert_fn``
    defaults to this rank's :func:`default_expert`."""
    from . import OverlapMeter
    comm = comm or a.comm
    W, me = comm.size, comm.local_rank
    if tokens.ndim != 2:
        raise ValueError(f"tokens must be (T, d); got {tuple(tokens.shape)}")
    t_total, d = tokens.shape
    dest = np.asarray(torch.as_tensor(dest).cpu(), dtype=np.int64)
    if dest.shape != (t_total,):
        raise ValueError(
            f"dest must be one rank per token; got {dest.shape} for "
            f"{t_total} tokens")
    if t_total and (dest.min() < 0 or dest.max() >= W):
        raise ValueError("dest ranks out of range")
    dev = a.device.ctx.device
    expert_fn = expert_fn or default_expert(me, d, dev)
    meter = meter if meter is not None else OverlapMeter()
    n_chunks = max(1, min(n_chunks, max(1, t_total)))

    # group tokens by destination (stable, so the combine un-permutes)
    order = torch.as_tensor(np.argsort(dest, kind="stable"), device=dev)
    send_tok = tokens.to(dev, torch.float32)[order]
    send_counts = tuple(int(c) for c in np.bincount(dest, minlength=W))

    # 1) count exchange: one fixed-count alltoall of the vectors
    cnt_src = a.buffer((W,), torch.int64)
    cnt_dst = a.buffer((W,), torch.int64)
    cnt_src.data[:] = send_counts
    a.alltoall(cnt_src, cnt_dst, 1, comm=comm)
    recv_counts = tuple(int(c) for c in cnt_dst.data)
    t_recv = sum(recv_counts)

    send_chunks = _chunk_split(send_counts, n_chunks)
    recv_chunks = _chunk_split(recv_counts, n_chunks)
    soff = np.concatenate(([0], np.cumsum(send_counts)))

    def chunk_rows(ci):
        """Rows of the sorted tokens in chunk ci: slice ci of every peer
        segment (not contiguous)."""
        return torch.as_tensor(np.concatenate([
            np.arange(soff[p] + send_counts[p] * ci // n_chunks,
                      soff[p] + send_counts[p] * (ci + 1) // n_chunks)
            for p in range(W)]), dtype=torch.int64, device=dev)

    def buf(n):
        return a.buffer((max(1, n * d),), torch.float32,
                        device_resident=True)

    disp_src, disp_dst, comb_src, comb_dst = [], [], [], []
    for ci in range(n_chunks):
        ns, nr = sum(send_chunks[ci]), sum(recv_chunks[ci])
        disp_src.append(buf(ns))
        disp_dst.append(buf(nr))
        comb_src.append(buf(nr))
        comb_dst.append(buf(ns))
        if ns:
            disp_src[ci].tensor[:ns * d] = send_tok[chunk_rows(ci)].reshape(-1)

    def _vec(counts):
        return tuple(c * d for c in counts)   # elements = tokens * d

    # 2) dispatch every chunk up front
    disp_h = []
    for ci in range(n_chunks):
        h = a.alltoallv(disp_src[ci], disp_dst[ci], _vec(send_chunks[ci]),
                        _vec(recv_chunks[ci]), comm=comm,
                        compress_dtype=compress_dtype,
                        block_scale=block_scale, run_async=True)
        meter.issue(h)
        disp_h.append(h)
        if not overlap:
            meter.wait(h)

    # 3+4) the expert per chunk, its combine issued right after
    comb_h = []
    for ci in range(n_chunks):
        meter.wait(disp_h[ci])
        nr = sum(recv_chunks[ci])
        if nr:
            x = disp_dst[ci].tensor[:nr * d].view(nr, d)
            comb_src[ci].tensor[:nr * d] = \
                expert_fn(x).to(torch.float32).reshape(-1)
        h = a.alltoallv(comb_src[ci], comb_dst[ci], _vec(recv_chunks[ci]),
                        _vec(send_chunks[ci]), comm=comm, run_async=True)
        meter.issue(h)
        comb_h.append(h)
        if not overlap:
            meter.wait(h)
    if overlap:
        for h in comb_h:
            meter.wait(h)

    # un-permute: chunk ci's rows are slice ci of every peer segment of
    # the sorted order
    out_sorted = torch.empty((t_total, d), dtype=torch.float32, device=dev)
    for ci in range(n_chunks):
        ns = sum(send_chunks[ci])
        if ns:
            out_sorted[chunk_rows(ci)] = \
                comb_dst[ci].tensor[:ns * d].view(ns, d)
    out = torch.empty_like(out_sorted)
    out[order] = out_sorted
    # the staging buffers are this call's own: withdraw them from the
    # device's registry, so that their memory goes with them
    for b in (cnt_src, cnt_dst, *disp_src, *disp_dst, *comb_src,
              *comb_dst):
        b.free_buffer()

    stats = meter.publish(a.rank, "moe", steps=n_chunks)
    stats["tokens"] = t_total
    stats["recv_tokens"] = t_recv
    stats["send_counts"] = send_counts
    stats["recv_counts"] = recv_counts
    return out, stats
