"""Disaggregated prefill/decode serving over one-sided KV puts.

The port's counterpart of the reference's disaggregated serving pattern
(``examples/09_disaggregated_serving.py``, ``benchmarks/serving.py``),
driven through the control plane of this package and the driver's RMA
verbs:

1. :class:`~.kvcache.KVBlockManager` places the requests on the decode
   ranks (prefix affinity, then load) and :class:`~.batcher.
   ContinuousBatcher` admits them; a block is ``block_tokens`` tokens of
   every layer's K and V, ``(L, 2, block_tokens, Hkv, hd)``.
2. Each prefill rank runs ``Llama.forward_cached`` over the prompts of
   the requests placed on its decode rank, packs every block that missed
   the decode rank's cache into a staging tensor, and puts it with
   ``notify=token`` into ``(ref.rank, window, ref.offset)``: one
   put-with-notify per missed block; a prefix hit moves nothing.
3. Each decode rank discovers the landed blocks by polling its notify
   queue (no call, no collective), checks each against its source bit
   for bit, unpacks its requests' blocks into a ``(L, B, max_len, Hkv,
   hd)`` cache and runs the greedy decode steps; the batcher's
   ``step_end`` closes each step once every decode rank finished it.

All ranks share one device and one model; each rank's part runs on its
own thread (:func:`~accl_tpu_torch.testing.run_ranks`). A forward of the
model holds one lock: every torch op hands the interpreter lock over,
so two rank threads running the model at once would interleave op by op
and each wait on the other's Python; their kernels run one after the
other on the one device either way.
"""

from __future__ import annotations

import dataclasses
import threading
import time

import torch

from ..testing import run_ranks
from .batcher import ContinuousBatcher, Request
from .kvcache import KVBlockManager, prefix_hashes

__all__ = ["DisaggregatedRun", "serve_disaggregated", "counter_total"]


def counter_total(accl, name: str, **want) -> int:
    """The sum of counter ``name`` over this driver's rows in the metrics
    snapshot (its rank in its world), restricted to the labels in
    ``want`` (e.g. ``op="put"``)."""
    want = {k: str(v) for k, v in want.items()}
    want["rank"] = str(accl.rank)
    ctx = getattr(accl.device, "ctx", None)
    if ctx is not None:
        want["ctx"] = str(ctx.seq)
    rows = accl.metrics_snapshot()["counters"].get(name, {})
    n = 0
    for labels, v in rows.items():
        kv = dict(p.split("=", 1) for p in labels.split(","))
        if all(kv.get(k) == w for k, w in want.items()):
            n += v
    return int(n)


@dataclasses.dataclass
class DisaggregatedRun:
    """What one disaggregated drive produced and measured."""

    requests: list            # the batcher's Request records, rid order
    tokens: torch.Tensor      # (B, steps + 1): the prefill's greedy
    #                           token, then one per decode step
    step_logits: torch.Tensor  # (B, steps, vocab) f32, decode steps
    prefill_logits: torch.Tensor  # (B, vocab) f32, last prompt position
    block_nbytes: int
    puts: int                 # put-with-notify calls (one a missed block)
    put_bytes: int            # their bytes (accl_bytes_total of op put)
    hits: int                 # blocks shared from the decode rank's cache
    misses: int
    polls: int                # poll_notifications calls, all decode ranks
    calls_while_polling: int  # accl_calls_total delta across the polls
    records: int              # notify records received
    duplicates: int           # records whose token had arrived before
    landed_mismatches: int    # landed blocks not bitwise their source
    kv_seconds: float         # first put issued -> last record polled
    decode_ms: list           # host ms of each decode step (all ranks)
    decode_rank: dict         # rid -> decode rank
    shared: set               # rids that hold a block another put landed
    caches: dict              # decode rank -> its KV cache after the steps


def serve_disaggregated(model, accls, prompts: torch.Tensor, steps: int, *,
                        prefill_ranks, decode_ranks, block_tokens: int = 16,
                        blocks_per_rank: int = 160,
                        poll_timeout: float = 120.0) -> DisaggregatedRun:
    """Serve ``prompts`` (B, S) tokens on ``accls`` (a world whose ranks
    share ``model``'s device): prefill on ``prefill_ranks``, KV blocks put
    with notify into the ``decode_ranks``' windows, ``steps`` greedy
    decode steps there. Decode rank ``decode_ranks[i]`` takes its prefill
    from ``prefill_ranks[i % len(prefill_ranks)]``. S must be a multiple
    of ``block_tokens``."""
    c = model.config
    B, S = prompts.shape
    if S % block_tokens:
        raise ValueError(f"prompt length {S} is not a multiple of the "
                         f"block of {block_tokens} tokens")
    L, Hkv, hd, dt = c.n_layers, c.n_kv_heads, c.head_dim, c.dtype
    T = block_tokens
    block_elems = L * 2 * T * Hkv * hd
    esize = torch.empty((), dtype=dt).element_size()
    block_nbytes = block_elems * esize
    max_len = S + steps
    dev = model.device
    sync = (torch.cuda.synchronize if dev.type == "cuda"
            else (lambda: None))

    # -- decode ranks expose their KV arenas ------------------------------
    arenas, wids = {}, set()
    for d in decode_ranks:
        a = accls[d]
        arenas[d] = a.buffer((blocks_per_rank * block_elems,), dt,
                             device_resident=True)
        wids.add(a.register_window(arenas[d]))
    if len(wids) != 1:
        raise RuntimeError(f"decode ranks' window ids disagree: {wids}")
    wid = wids.pop()

    # -- control plane: placement and admission ---------------------------
    manager = KVBlockManager(block_nbytes, blocks_per_rank, decode_ranks)
    batcher = ContinuousBatcher(kv=manager, max_batch=B)
    t_submit = time.monotonic()
    reqs = [Request(rid=i, prompt_tokens=S, decode_tokens=steps,
                    prefix_hashes=prefix_hashes(prompts[i].tolist(), T))
            for i in range(B)]
    for r in reqs:
        batcher.submit(r, now=t_submit)
    batch, misses = batcher.step_begin()
    if len(batch) != B:
        raise RuntimeError(f"{B - len(batch)} requests not admitted")
    miss_keys = {(m.key, m.rank) for m in misses}
    # each missed block is put by the prefill of the first request (in
    # admission order) that holds it; later holders hit it
    plan, owner, shared = [], {}, set()
    for r in batch:
        for b, ref in enumerate(manager.lookup(r.prefix_hashes, r.kv_rank)):
            key = (ref.key, ref.rank)
            if key in miss_keys and key not in owner:
                owner[key] = len(plan)
                plan.append((r, b, ref))
            elif key in owner and plan[owner[key]][0] is not r:
                shared.add(r.rid)
    groups = {d: [r for r in batch if r.kv_rank == d] for d in decode_ranks}
    prefill_of = {prefill_ranks[i % len(prefill_ranks)]: []
                  for i in range(len(decode_ranks))}
    for i, d in enumerate(decode_ranks):
        prefill_of[prefill_ranks[i % len(prefill_ranks)]].append(d)

    sources: dict[int, torch.Tensor] = {}     # token -> staged block
    first_token: dict[int, torch.Tensor] = {}
    prefill_logits: dict[int, torch.Tensor] = {}
    step_logits = {r.rid: [] for r in batch}
    caches: dict = {}
    step_tokens = {r.rid: [] for r in batch}
    put_start: list[float] = []
    decode_ms: list[float] = []
    stats = {"polls": 0, "calls": 0, "records": 0, "dups": 0, "bad": 0,
             "last": 0.0}
    mu = threading.Lock()
    model_lock = threading.Lock()      # one forward at a time (see above)
    # set once a decode rank's prefill has issued its puts: its first
    # tokens are known (a rank whose blocks all hit waits on this alone)
    prefilled = {d: threading.Event() for d in decode_ranks}
    t_step = [0.0]

    def start_steps():
        t_step[0] = time.monotonic()

    def close_step():
        """Every decode rank finished the step: the batcher closes it."""
        now = time.monotonic()
        decode_ms.append((now - t_step[0]) * 1e3)
        batcher.step_end(now=now)
        t_step[0] = now

    nd = len(decode_ranks)
    start_barrier = threading.Barrier(nd, action=start_steps,
                                      timeout=poll_timeout)
    step_barrier = threading.Barrier(nd, action=close_step,
                                     timeout=poll_timeout)

    def prefill(a):
        handles, bufs = [], []
        for d in prefill_of[a.rank]:
            group = groups[d]
            if not group:
                prefilled[d].set()
                continue
            toks = prompts[[r.rid for r in group]]
            cache = model.init_kv_cache(len(group), max_len)
            with model_lock:
                logits, cache = model.forward_cached(toks, cache)
            firsts = logits[:, -1].argmax(-1)
            rids = {r.rid for r in group}
            mine = [(i, p) for i, p in enumerate(plan) if p[0].rid in rids]
            stage = torch.empty((len(mine), L, 2, T, Hkv, hd), dtype=dt,
                                device=dev)
            for j, r in enumerate(group):
                first_token[r.rid] = firsts[j]
                prefill_logits[r.rid] = logits[j, -1]
            for s, (i, (r, b, ref)) in enumerate(mine):
                j = group.index(r)
                stage[s, :, 0].copy_(cache["k"][:, j, b * T:(b + 1) * T])
                stage[s, :, 1].copy_(cache["v"][:, j, b * T:(b + 1) * T])
            del cache
            for s, (i, (r, b, ref)) in enumerate(mine):
                token = i + 1
                src = a.buffer(data=stage[s].reshape(-1))
                bufs.append(src)
                sources[token] = stage[s].reshape(-1)
                if not put_start:
                    put_start.append(time.monotonic())
                handles.append(a.put(src, block_elems, dst=ref.rank,
                                     window=wid, offset=ref.offset,
                                     notify=token, run_async=True))
            prefilled[d].set()
        for h in handles:
            h.wait()
        for buf in bufs:
            buf.free_buffer()

    def decode(a):
        d = a.rank
        group = groups[d]
        want = {i + 1: ref for i, (r, b, ref) in enumerate(plan)
                if ref.rank == d}
        arena = arenas[d].tensor
        seen: set[int] = set()
        polls = dups = bad = 0
        calls0 = counter_total(a, "accl_calls_total")
        deadline = time.monotonic() + poll_timeout
        while len(seen) < len(want):
            recs = a.poll_notifications(wid)
            polls += 1
            for rec in recs:
                if rec.token in seen:
                    dups += 1
                    continue
                seen.add(rec.token)
                ref = want.get(rec.token)
                lo = rec.offset // esize
                if (ref is None or rec.err or rec.offset != ref.offset
                        or rec.nbytes != block_nbytes
                        or not torch.equal(
                            arena[lo:lo + block_elems].view(torch.int16),
                            sources[rec.token].view(torch.int16))):
                    bad += 1
            if not recs:
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"decode rank {d}: {len(seen)} of {len(want)} "
                        f"KV blocks arrived")
                time.sleep(0.0005)
        calls = counter_total(a, "accl_calls_total") - calls0
        with mu:
            stats["polls"] += polls
            stats["calls"] += calls
            stats["records"] += len(seen) + dups
            stats["dups"] += dups
            stats["bad"] += bad
            stats["last"] = max(stats["last"], time.monotonic())
        if not prefilled[d].wait(poll_timeout):
            raise TimeoutError(f"decode rank {d}: no prefill")
        start_barrier.wait()
        if not group:
            for _ in range(steps):
                step_barrier.wait()
            return
        # unpack the blocks (hits and misses) into a decode cache
        cache = model.init_kv_cache(len(group), max_len)
        for j, r in enumerate(group):
            for b, ref in enumerate(manager.lookup(r.prefix_hashes, d)):
                lo = ref.offset // esize
                blk = arena[lo:lo + block_elems].view(L, 2, T, Hkv, hd)
                cache["k"][:, j, b * T:(b + 1) * T] = blk[:, 0]
                cache["v"][:, j, b * T:(b + 1) * T] = blk[:, 1]
        cache["pos"] = S
        tok = torch.stack([first_token[r.rid] for r in group])
        for _ in range(steps):
            with model_lock:
                logits, cache = model.forward_cached(tok[:, None], cache)
            last = logits[:, -1]
            for j, r in enumerate(group):
                step_logits[r.rid].append(last[j])
                step_tokens[r.rid].append(tok[j])
            tok = last.argmax(-1)
            sync()
            step_barrier.wait()
        caches[d] = cache

    def fn(a):
        if a.rank in prefill_of:
            prefill(a)
        if a.rank in groups:
            decode(a)

    def put_bytes():
        return sum(counter_total(a, "accl_bytes_total", op="put")
                   for a in accls)

    bytes0 = put_bytes()
    try:
        run_ranks(accls, fn)
    finally:
        for d in decode_ranks:
            accls[d].deregister_window(wid)
            arenas[d].free_buffer()
    by_rid = sorted(batch, key=lambda r: r.rid)
    return DisaggregatedRun(
        requests=by_rid,
        tokens=torch.stack([torch.stack(step_tokens[r.rid]
                                        + [step_logits[r.rid][-1].argmax()])
                            for r in by_rid]),
        step_logits=torch.stack([torch.stack(step_logits[r.rid])
                                 for r in by_rid]),
        prefill_logits=torch.stack([prefill_logits[r.rid] for r in by_rid]),
        block_nbytes=block_nbytes, puts=len(plan),
        put_bytes=put_bytes() - bytes0,
        hits=manager.hits, misses=manager.misses, polls=stats["polls"],
        calls_while_polling=stats["calls"], records=stats["records"],
        duplicates=stats["dups"], landed_mismatches=stats["bad"],
        kv_seconds=stats["last"] - put_start[0] if put_start else 0.0,
        decode_ms=decode_ms,
        decode_rank={r.rid: r.kv_rank for r in batch}, shared=shared,
        caches=caches)
