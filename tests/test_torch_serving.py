"""The port's serving control plane against the reference's, on the CPU,
and the disaggregated prefill -> put-with-notify -> decode drive.

``KVBlockManager`` and ``ContinuousBatcher`` (pure host code in both
packages) are fed one seeded trace each and must give the reference's
outputs exactly: block refs, placements, evictions, hit counts,
admissions, metrics rows. Then ``serve_disaggregated`` on ``cuda_world(4,
device="cpu")`` with a tiny f32 Llama loaded from the reference's
parameters: landed blocks bitwise equal to the prefill cache, decode
logits bitwise equal to a local run where no block was shared and within
``test_torch_llama.py``'s tolerance where one was, and the prefill cache
within that tolerance of the reference's ``forward_cached``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from accl_tpu import serving as jserving  # noqa: E402
from accl_tpu.models import llama as RL  # noqa: E402
from accl_tpu_torch import cuda_world  # noqa: E402
from accl_tpu_torch import serving as pserving  # noqa: E402
from accl_tpu_torch.models import Llama, LlamaConfig  # noqa: E402
from accl_tpu_torch.serving.disagg import serve_disaggregated  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


SIDES = {"ref": jserving, "port": pserving}


def _prompts(rng, n: int, vocab: int = 50):
    """``n`` token lists of 1-9 blocks of 4, many sharing prefixes."""
    base = [list(rng.integers(0, vocab, 36)) for _ in range(3)]
    out = []
    for _ in range(n):
        b = base[int(rng.integers(0, 3))]
        keep = int(rng.integers(0, 36))
        tail = list(rng.integers(0, vocab, int(rng.integers(1, 12))))
        out.append([int(t) for t in b[:keep] + tail])
    return out


def _rows(obj):
    return sorted((k, n, tuple(sorted(l.items())), v)
                  for k, n, l, v in obj._metrics_rows())


def _kv_trace(mod, seed: int) -> list:
    """A seeded trace on a KVBlockManager of 2-3 small decode ranks:
    acquire, release, lookup, drop_rank, add_rank and the gauges; every
    outcome recorded (block refs as tuples, errors by type)."""
    rng = np.random.default_rng(seed)
    kv = mod.KVBlockManager(block_nbytes=256, blocks_per_rank=6,
                            ranks=(2, 3), name=f"t{seed}")
    prompts = _prompts(rng, 12)
    held: list[tuple] = []
    out = []
    for _ in range(120):
        op = int(rng.integers(0, 10))
        if op < 4:
            h = mod.prefix_hashes(prompts[int(rng.integers(0, 12))], 4)
            try:
                rank, hits, misses = kv.acquire(h)
            except MemoryError as exc:
                out.append(("acquire!", str(exc)))
                continue
            held.append((h, rank))
            out.append(("acquire", rank,
                        [dataclasses.astuple(b) for b in hits],
                        [dataclasses.astuple(b) for b in misses]))
        elif op < 7 and held:
            h, rank = held.pop(int(rng.integers(0, len(held))))
            kv.release(h, rank)
            out.append(("release", rank))
        elif op == 7 and held:
            h, rank = held[int(rng.integers(0, len(held)))]
            try:
                out.append(("lookup", [dataclasses.astuple(b)
                                       for b in kv.lookup(h, rank)]))
            except KeyError:
                out.append(("lookup!",))
        elif op == 8:
            r = int(rng.integers(2, 5))
            if rng.random() < 0.5 and len(kv.ranks) > 1:
                out.append(("drop", r, sorted(kv.drop_rank(r))))
                held = [x for x in held if x[1] != r]
            else:
                kv.add_rank(r)
                out.append(("add", r, kv.ranks))
        out.append((kv.hits, kv.misses, kv.evictions, kv.wire_bytes_saved,
                    kv.cached_blocks(), kv.hit_ratio(),
                    [kv.blocks_in_use(r) for r in kv.ranks], _rows(kv)))
    return out


@pytest.mark.parametrize("seed", range(8))
def test_kv_block_manager_matches_reference_trace(seed):
    ref, got = _kv_trace(SIDES["ref"], seed), _kv_trace(SIDES["port"], seed)
    assert got == ref
    assert any(step[0] == "acquire" and step[2] for step in got
               if isinstance(step[0], str)), "the trace hit no prefix"


def test_prefix_hashes_match_reference():
    rng = np.random.default_rng(5)
    for n in (0, 1, 15, 16, 17, 64, 1000):
        toks = [int(t) for t in rng.integers(-2 ** 40, 2 ** 40, n)]
        for bt in (1, 4, 16):
            assert (pserving.prefix_hashes(toks, bt)
                    == jserving.prefix_hashes(toks, bt))
    with pytest.raises(ValueError):
        pserving.prefix_hashes([1, 2], 0)


def _batcher_trace(mod, seed: int, with_kv: bool) -> list:
    """A seeded trace on a ContinuousBatcher (with a small block manager
    or none): submit, step_begin, step_end, requeue and the queues; the
    admitted batch, the misses, the retirements and every request's
    fields recorded."""
    rng = np.random.default_rng(seed)
    kv = (mod.KVBlockManager(block_nbytes=64, blocks_per_rank=10,
                             ranks=(0, 1), name=f"b{seed}")
          if with_kv else None)
    cb = mod.ContinuousBatcher(kv=kv, max_inflight_tokens=120,
                               max_batch=4, name=f"b{seed}")
    prompts = _prompts(rng, 10)
    reqs = []
    out = []
    now = 0.0
    for _ in range(60):
        now += 1.0
        op = int(rng.integers(0, 6))
        if op < 2:
            toks = prompts[int(rng.integers(0, 10))]
            req = mod.Request(rid=len(reqs), prompt_tokens=len(toks),
                              decode_tokens=int(rng.integers(1, 6)),
                              prefix_hashes=mod.prefix_hashes(toks, 4))
            reqs.append(req)
            cb.submit(req, now=now)
        elif op < 4:
            batch, misses = cb.step_begin(now=now)
            out.append(("begin", [r.rid for r in batch],
                        [dataclasses.astuple(m) for m in misses]))
        elif op < 5:
            out.append(("end", [r.rid for r in cb.step_end(now=now)]))
        elif cb.active():
            act = cb.active()
            cb.requeue(act[int(rng.integers(0, len(act)))])
            out.append(("requeue",))
        out.append(([r.rid for r in cb.active()], cb.pending_count(),
                    [r.rid for r in cb.done()], cb.admitted_total,
                    cb.retired_total, cb.deferred_total, _rows(cb)))
    out.append([r.rid for r in cb.drain_done()])
    out.append([dataclasses.astuple(r) for r in reqs])
    if kv is not None:
        out.append((kv.hits, kv.misses, kv.evictions, _rows(kv)))
    return out


@pytest.mark.parametrize("with_kv", [True, False], ids=["kv", "no_kv"])
@pytest.mark.parametrize("seed", range(6))
def test_continuous_batcher_matches_reference_trace(seed, with_kv):
    ref = _batcher_trace(SIDES["ref"], seed, with_kv)
    got = _batcher_trace(SIDES["port"], seed, with_kv)
    assert got == ref


# -- the disaggregated drive ------------------------------------------------

TOL = 2e-4                     # test_torch_llama.py's f32 tolerance
TINY = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128)
S, STEPS, BLOCK = 64, 8, 16


@pytest.fixture(scope="module")
def drive():
    """The reference's tiny f32 model and its parameters, the port's
    model loaded from them, four 64-token prompts (0 and 2 share their
    first 32 tokens) and one disaggregated run on cuda_world(4)."""
    rcfg = dataclasses.replace(RL.LlamaConfig.tiny(**TINY), dtype=jnp.float32)
    ref = RL.Llama(rcfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
    pcfg = dataclasses.replace(LlamaConfig.tiny(**TINY), dtype=torch.float32)
    port = Llama(pcfg, device="cpu").load_reference_params(params)
    rng = np.random.default_rng(11)
    prompts = rng.integers(0, pcfg.vocab_size, (4, S))
    prompts[2, :S // 2] = prompts[0, :S // 2]
    accls = cuda_world(4, device="cpu")
    try:
        run = serve_disaggregated(
            port, accls, torch.from_numpy(prompts), STEPS,
            prefill_ranks=(0, 1), decode_ranks=(2, 3), block_tokens=BLOCK,
            blocks_per_rank=16)
    finally:
        for a in accls:
            a.deinit()
    return ref, params, port, prompts, run


def test_disaggregated_control_plane_counts(drive):
    """Placement by prefix then load; one put-with-notify per missed
    block, each token exactly once; request 2's shared blocks are hits
    that move no byte; the polls issued no call."""
    *_, run = drive
    nb = S // BLOCK
    assert run.decode_rank == {0: 2, 1: 3, 2: 2, 3: 3}
    assert run.shared == {2}
    assert run.hits == nb // 2 and run.misses == 4 * nb - nb // 2
    assert run.puts == run.misses == run.records
    assert run.put_bytes == run.misses * run.block_nbytes
    assert run.duplicates == 0 and run.landed_mismatches == 0
    assert run.calls_while_polling == 0 and run.polls >= 2
    assert len(run.decode_ms) == STEPS
    assert all(r.decoded == STEPS and r.ttft_s > 0 for r in run.requests)


def _local(port, prompts, rids):
    """A local run of the same batch: prefill into a cache of the drive's
    length, then STEPS greedy steps; (cache, prefill logits, step
    logits, tokens)."""
    cache = port.init_kv_cache(len(rids), S + STEPS)
    logits, cache = port.forward_cached(torch.from_numpy(prompts[rids]),
                                        cache)
    first = logits[:, -1]
    tok = first.argmax(-1)
    toks, steps = [tok], []
    for _ in range(STEPS):
        logits, cache = port.forward_cached(tok[:, None], cache)
        steps.append(logits[:, -1])
        tok = logits[:, -1].argmax(-1)
        toks.append(tok)
    return cache, first, torch.stack(steps, 1), torch.stack(toks, 1)


@pytest.mark.parametrize("rank", [2, 3], ids=["shared", "unshared"])
def test_disaggregated_decode_matches_local_run(drive, rank):
    """The decode rank's cache and logits against the same batch served
    locally: bitwise on the rank none of whose blocks was shared, within
    the f32 tolerance on the rank holding request 2's shared prefix
    (request 0's prefill wrote it)."""
    _, _, port, prompts, run = drive
    rids = [r for r, d in sorted(run.decode_rank.items()) if d == rank]
    cache, first, steps, toks = _local(port, prompts, rids)
    got_cache = run.caches[rank]
    if rank == 3:
        assert torch.equal(got_cache["k"], cache["k"])
        assert torch.equal(got_cache["v"], cache["v"])
        assert torch.equal(run.step_logits[rids], steps)
    else:
        torch.testing.assert_close(got_cache["k"], cache["k"], rtol=TOL,
                                   atol=TOL)
        torch.testing.assert_close(got_cache["v"], cache["v"], rtol=TOL,
                                   atol=TOL)
        torch.testing.assert_close(run.step_logits[rids], steps, rtol=TOL,
                                   atol=TOL)
    assert torch.equal(run.prefill_logits[rids], first)
    assert torch.equal(run.tokens[rids], toks)
    want = port.generate(torch.from_numpy(prompts[rids]), max_new=STEPS + 1)
    assert torch.equal(run.tokens[rids], want)


def test_disaggregated_prefill_cache_matches_reference(drive):
    """The prompt part of every decode cache (landed blocks) and the
    first decode step's logits against the reference's forward_cached on
    the same prompts, within the f32 tolerance."""
    ref, params, _, prompts, run = drive
    rcache = ref.init_kv_cache(4, S + STEPS)
    rlog, rcache = ref.forward_cached(params, jnp.asarray(prompts),
                                      rcache)
    tok = np.asarray(rlog[:, -1]).argmax(-1)
    rstep, _ = ref.forward_cached(params, jnp.asarray(tok[:, None]), rcache)
    rk, rv = np.asarray(rcache["k"]), np.asarray(rcache["v"])
    for rank, cache in run.caches.items():
        rids = [r for r, d in sorted(run.decode_rank.items()) if d == rank]
        np.testing.assert_allclose(cache["k"][:, :, :S].numpy(),
                                   rk[:, rids, :S], rtol=TOL, atol=TOL)
        np.testing.assert_allclose(cache["v"][:, :, :S].numpy(),
                                   rv[:, rids, :S], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(run.prefill_logits.numpy(),
                               np.asarray(rlog[:, -1]), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(run.step_logits[:, 0].numpy(),
                               np.asarray(rstep[:, -1]), rtol=TOL, atol=TOL)
