"""The port's point-to-point and local ops against the reference's, on
the CPU.

``cuda_world(4, device="cpu")`` against ``tpu_world(4, platform="cpu")``
(and ``emu_world(4)`` for the block-scaled wire) through ``run_ranks``:
send/recv on every wire with host-mirror and device-resident buffers,
tag matching, eager completion, self-sends and the error words; the
eager snapshot; the exchange window's batching; copy and combine with
plain and compressed operands over a corpus that keeps NaN, +-inf and
+-0. Results are bitwise unless a test states otherwise.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

from accl_tpu import quant as jquant  # noqa: E402
from accl_tpu.constants import ReduceFunc as JRF  # noqa: E402
from accl_tpu.constants import TAG_ANY as J_TAG_ANY  # noqa: E402
from accl_tpu.device.tpu import tpu_world  # noqa: E402
from accl_tpu.testing import emu_world  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu_torch import (ACCLError, Communicator, ErrorCode,  # noqa: E402
                            Rank, ReduceFunc, TAG_ANY, cuda_world)
from accl_tpu_torch.testing import run_ranks  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


W = 4
NP = {"float32": np.float32, "float16": np.float16,
      "bfloat16": ml_dtypes.bfloat16, "float8_e4m3fn": ml_dtypes.float8_e4m3fn,
      "float8_e5m2": ml_dtypes.float8_e5m2, "int8": np.int8,
      "int32": np.int32, "int64": np.int64}
TORCH = {"float32": torch.float32, "float16": torch.float16,
         "bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
         "float8_e5m2": torch.float8_e5m2, "int8": torch.int8,
         "int32": torch.int32, "int64": torch.int64}
_BITS = {1: np.uint8, 2: np.uint16, 4: np.uint32, 8: np.uint64}


@pytest.fixture(scope="module")
def worlds():
    tw = tpu_world(W, platform="cpu")
    cw = cuda_world(W, device="cpu")
    yield tw, cw
    for a in tw + cw:
        a.deinit()


@pytest.fixture(scope="module")
def emu():
    ew = emu_world(W)
    yield ew
    for a in ew:
        a.deinit()


# -- the two sides ----------------------------------------------------------

def to_torch(x: np.ndarray) -> torch.Tensor:
    bits = _BITS[x.dtype.itemsize]
    if x.dtype.name in ("bfloat16", "float8_e4m3fn", "float8_e5m2"):
        signed = {1: np.int8, 2: np.int16}[x.dtype.itemsize]
        t = torch.from_numpy(x.view(bits).view(signed).copy())
        return t.view(TORCH[x.dtype.name])
    return torch.from_numpy(x.copy())


def to_np(data) -> np.ndarray:
    """A buffer's ``.data`` (numpy, or a CPU tensor where numpy has no
    such dtype) as numpy."""
    if isinstance(data, torch.Tensor):
        name = str(data.dtype).removeprefix("torch.")
        signed = {1: torch.int8, 2: torch.int16}[data.element_size()]
        return data.view(signed).numpy().view(NP[name]).copy()
    return np.asarray(data).copy()


class Side:
    """Buffers and constants of one tier: the reference (jax) or the
    port (torch)."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.TAG_ANY = J_TAG_ANY if jax_side else TAG_ANY

    def dtype(self, name):
        return None if name is None else (
            np.dtype(NP[name]) if self.jax else TORCH[name])

    def func(self, f: ReduceFunc):
        return JRF(int(f)) if self.jax else f

    def buf(self, a, x: np.ndarray, resident: bool = False):
        if self.jax:
            if resident:
                import jax.numpy as jnp
                return a.buffer(data=jnp.asarray(x))
            return a.buffer(data=x.copy())
        return a.buffer(data=to_torch(x), device_resident=resident)

    def empty(self, a, n: int, name: str = "float32",
              resident: bool = False):
        return a.buffer((n,), self.dtype(name), device_resident=resident)


def both(worlds, body):
    """``body(side)`` returns the per-rank fn; run it on both tiers."""
    tw, cw = worlds
    return (j_run_ranks(tw, body(Side(True))),
            run_ranks(cw, body(Side(False))))


def same_bits(got: np.ndarray, ref: np.ndarray, what: str = ""):
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    bits = _BITS[got.dtype.itemsize]
    np.testing.assert_array_equal(got.view(bits), ref.view(bits), what)


def corpus(n: int, seed: int, name: str = "float32") -> np.ndarray:
    """Seeded values of ``name`` with NaN, +-inf and +-0 among them
    (floats), or the full range of small integers."""
    rng = np.random.default_rng(seed)
    if name.startswith("int"):
        return rng.integers(-1000, 1000, n).astype(NP[name])
    x = (rng.standard_normal(n) * 30.0).astype(np.float32)
    x[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 0.0, -0.0, 1e-40]
    rng.shuffle(x)
    return x.astype(NP[name])


def _err(fn):
    """Run ``fn``; the error word it raised, or 0."""
    try:
        fn()
    except Exception as exc:  # ACCLError of either package
        return int(exc.error_word)
    return 0


# -- send / recv ------------------------------------------------------------

WIRES = [None, "float16", "bfloat16", "float8_e4m3fn", "float8_e5m2"]


@pytest.mark.parametrize("wire", WIRES, ids=lambda w: w or "fp32")
@pytest.mark.parametrize("resident", [False, True],
                         ids=["host", "resident"])
def test_ring_shift_matches_tpu_world(worlds, resident, wire):
    """Rank r sends to r+1 and receives from r-1, both calls async. The
    wire casts per element (fp8 too: no scale), so e4m3fn's overflow is
    NaN and e5m2's inf, as in the reference."""
    count = 257
    ins = [corpus(count, 10 + r) * np.float32(20.0) for r in range(W)]

    def body(side):
        def fn(a):
            src = side.buf(a, ins[a.rank], resident)
            dst = side.empty(a, count, resident=resident)
            hs = a.send(src, count, dst=(a.rank + 1) % W, tag=5,
                        compress_dtype=side.dtype(wire), run_async=True)
            hr = a.recv(dst, count, src=(a.rank - 1) % W, tag=5,
                        compress_dtype=side.dtype(wire), run_async=True)
            hs.wait()
            hr.wait()
            return to_np(dst.data)
        return fn

    ref, got = both(worlds, body)
    for r in range(W):
        same_bits(got[r], ref[r], f"rank {r}")
    if wire is None:
        same_bits(got[1], ins[0])
    else:                               # the wire really narrowed
        assert not np.array_equal(got[1], ins[0])


@pytest.mark.parametrize("case", ["send_any", "recv_any", "ordered"])
def test_tag_matching_matches_tpu_world(worlds, case):
    """TAG_ANY on the send or the recv side, and three sends from one
    source taken in the order they were made (MPI order per (comm, src,
    dst)), the second recv's tag skipping a parked send."""
    xs = [corpus(16, 40 + k) for k in range(3)]

    def body(side):
        any_ = side.TAG_ANY

        def fn(a):
            if a.rank == 1:
                tags = {"send_any": [any_] * 3, "recv_any": [7, 8, 9],
                        "ordered": [7, 8, 7]}[case]
                for x, t in zip(xs, tags):
                    a.send(side.buf(a, x), 16, dst=2, tag=t)
            elif a.rank == 2:
                tags = {"send_any": [9, 3, 9], "recv_any": [any_] * 3,
                        "ordered": [7, 7, 8]}[case]
                outs = []
                for t in tags:
                    d = side.empty(a, 16)
                    a.recv(d, 16, src=1, tag=t)
                    outs.append(to_np(d.data))
                return outs
            return None
        return fn

    ref, got = both(worlds, body)
    for g, r in zip(got[2], ref[2]):
        same_bits(g, r)
    order = {"send_any": [0, 1, 2], "recv_any": [0, 1, 2],
             "ordered": [0, 2, 1]}[case]
    for g, k in zip(got[2], order):
        same_bits(g, xs[k])


def test_send_completes_before_recv_is_posted(worlds):
    _, cw = worlds
    x = corpus(32, 3)

    def fn(a):
        if a.rank == 0:
            a.send(a.buffer(data=torch.from_numpy(x.copy())), 32, dst=1)
            return "sent"
        if a.rank == 1:
            time.sleep(0.1)
            d = a.buffer((32,), torch.float32)
            a.recv(d, 32, src=0)
            return d.data.copy()
        return None

    res = run_ranks(cw, fn)
    assert res[0] == "sent"
    same_bits(res[1], x)


@pytest.mark.parametrize("resident", [False, True],
                         ids=["host", "resident"])
def test_self_send_skips_the_exchange(worlds, resident):
    tw, cw = worlds
    ctx = cw[0].device.ctx
    x = corpus(40, 4)

    def body(side):
        def fn(a):
            if a.rank != 2:
                return None
            a.send(side.buf(a, x, resident), 40, dst=2, tag=1)
            d = side.empty(a, 40, resident=resident)
            a.recv(d, 40, src=2, tag=1)
            return to_np(d.data)
        return fn

    rounds = ctx.exchange_rounds
    ref, got = both(worlds, body)
    same_bits(got[2], ref[2])
    same_bits(got[2], x)
    assert ctx.exchange_rounds == rounds


def test_recv_error_words_match_tpu_world(worlds):
    """A recv that times out, and a send shorter than the posted recv,
    fail with the reference's words on both tiers."""
    def body(side):
        def fn(a):
            if a.rank == 0:
                a.set_timeout(0.2)
                try:
                    timeout = _err(lambda: a.recv(side.empty(a, 8), 8,
                                                  src=3, tag=77))
                finally:
                    a.set_timeout(30.0)
                return timeout
            if a.rank == 1:
                a.send(side.empty(a, 4), 4, dst=2, tag=11)
            if a.rank == 2:
                return _err(lambda: a.recv(side.empty(a, 8), 8, src=1,
                                           tag=11))
            return None
        return fn

    ref, got = both(worlds, body)
    assert got[0] == ref[0] == int(ErrorCode.RECEIVE_TIMEOUT_ERROR)
    assert got[2] == ref[2] == int(ErrorCode.DMA_MISMATCH_ERROR)


def test_parked_send_overflow_matches_tpu_world(worlds):
    """The parked-send bound, set to 2 here (1024 by default) on both
    tiers: the third unmatched send fails with the pool's overflow word;
    a recv frees a slot."""
    tw, cw = worlds
    contexts = [tw[0].device.ctx, cw[0].device.ctx]
    for ctx in contexts:
        ctx.max_parked_sends = 2
    try:
        def body(side):
            def fn(a):
                if a.rank != 3:
                    return None
                b = side.buf(a, corpus(8, 5))
                words = [_err(lambda: a.send(b, 8, dst=0, tag=t))
                         for t in (1, 2, 3)]
                return words
            return fn
        ref, got = both(worlds, body)
        assert got[3] == ref[3] == [
            0, 0, int(ErrorCode.RECEIVE_OFFCHIP_SPARE_BUFF_OVERFLOW)]

        def drain(side):
            def fn(a):
                if a.rank == 0:
                    for t in (1, 2):
                        a.recv(side.empty(a, 8), 8, src=3, tag=t)
                return None
            return fn
        both(worlds, drain)
    finally:
        for ctx in contexts:
            ctx.max_parked_sends = 1024
    assert cw[0].device.ctx._parked_sends == 0


@pytest.mark.parametrize("resident", [False, True],
                         ids=["host", "resident"])
def test_eager_snapshot_survives_overwrite(worlds, resident):
    """torch tensors are written in place: the send's snapshot, not the
    source, is the message. The source is overwritten (and a collective
    lands in it) right after send returns; the recv gets the old
    values."""
    _, cw = worlds
    x = corpus(64, 6)

    def fn(a):
        if a.rank == 0:
            src = a.buffer(data=torch.from_numpy(x.copy()),
                           device_resident=resident)
            a.send(src, 64, dst=1, tag=2)
            src.storage.fill_(-1.0)
            a.allreduce(src, src, 64)
            return None
        d = a.buffer((64,), torch.float32, device_resident=resident)
        a.allreduce(a.buffer((64,), torch.float32), d, 64)
        if a.rank == 1:
            a.recv(d, 64, src=0, tag=2)
            return d.data.copy()
        return None

    got = run_ranks(cw, fn)
    same_bits(got[1], x)


def hold_exchange(ctx, cid: int, k: int, timeout: float = 30.0):
    """Keep the exchange of communicator ``cid`` busy, as a running batch
    does, until ``k`` transfers wait in its window; they then ride the
    next batch together. Returns the thread that frees it."""
    with ctx._lock:
        ctx._xchg_running.add(cid)

    def free():
        end = time.monotonic() + timeout
        with ctx._lock:
            while (len(ctx._xchg_pending[cid]) < k
                   and time.monotonic() < end):
                ctx._lock.wait(0.01)
            ctx._xchg_running.discard(cid)
            ctx._lock.notify_all()

    th = threading.Thread(target=free, daemon=True)
    th.start()
    return th


@pytest.mark.parametrize("held", [True, False], ids=["held", "free"])
@pytest.mark.parametrize("pattern", ["ring", "conflicting"])
def test_concurrent_transfers_take_at_most_two_rounds(pattern, held):
    """K = 8 transfers deposited while the exchange is busy ride one
    batch, not one round each (the reference's contract: at most 2,
    tests/test_device_resident.py): a ring shift over 8 ranks (one
    permutation) takes one round; the conflicting set (ranks 0-3 send to
    r+4 and to (r+1) % 4: every source twice, every destination once)
    takes two. ``held`` keeps the exchange busy until all 8 wait, so the
    count is exact; ``free`` leaves batching to the arrival order (no
    transfer waits for a window to fill), at most one round a transfer."""
    K = 8
    cw = cuda_world(K, device="cpu")
    ctx = cw[0].device.ctx
    count = 24
    ins = [corpus(count, 60 + r) for r in range(K)]
    if pattern == "ring":
        sends = {r: [(r + 1) % K] for r in range(K)}
    else:
        sends = {r: [r + 4, (r + 1) % 4] for r in range(4)}
    src_of = {d: s for s, ds in sends.items() for d in ds}

    def fn(a):
        r = a.rank
        src = a.buffer(data=torch.from_numpy(ins[r].copy()),
                       device_resident=True)
        out = a.buffer((count,), torch.float32, device_resident=True)
        hs = [a.send(src, count, dst=d, tag=1, run_async=True)
              for d in sends.get(r, [])]
        hr = a.recv(out, count, src=src_of[r], tag=1, run_async=True)
        for h in hs + [hr]:
            h.wait(30)
        return out.data.copy()

    try:
        before = ctx.exchange_rounds
        freer = hold_exchange(ctx, cw[0].comm.comm_id, K) if held else None
        got = run_ranks(cw, fn)
        rounds = ctx.exchange_rounds - before
        if freer is not None:
            freer.join()
    finally:
        for a in cw:
            a.deinit()
    for r in range(K):
        same_bits(got[r], ins[src_of[r]])
    if held:
        assert rounds == (1 if pattern == "ring" else 2)
    else:
        assert 1 <= rounds <= K


def test_exchange_is_one_permutation_round(worlds):
    coll = cw_coll(worlds)
    rows = [torch.full((3,), float(r)) for r in range(W)]
    out = [torch.zeros(3) for _ in range(W)]
    got = coll.exchange(rows, [(0, 2), (2, 1)], [out[0], None, out[2],
                                                 None])
    assert got[1] is rows[2] and got[2] is out[2]
    assert torch.equal(out[2], rows[0]) and got[0] is None
    with pytest.raises(ValueError, match="permutation"):
        coll.exchange(rows, [(0, 1), (0, 2)])


def cw_coll(worlds):
    return worlds[1][0].device.ctx.coll


# -- the block-scaled wire --------------------------------------------------

def _bs_body(x, wire, block, count, resident, port):
    def fn(a):
        dt = TORCH[wire] if port else NP[wire]
        if a.rank == 0:
            src = (a.buffer(data=torch.from_numpy(x.copy()),
                            device_resident=resident) if port
                   else a.buffer(data=x.copy()))
            a.send(src, count, dst=3, tag=4, compress_dtype=dt,
                   block_scale=block)
        elif a.rank == 3:
            d = (a.buffer((count,), torch.float32, device_resident=resident)
                 if port else a.buffer((count,), np.float32))
            a.recv(d, count, src=0, tag=4, compress_dtype=dt,
                   block_scale=block)
            return np.asarray(d.data).copy()
        return None
    return fn


@pytest.mark.parametrize("resident", [False, True],
                         ids=["host", "resident"])
@pytest.mark.parametrize("block", [32, 128, 4096])
@pytest.mark.parametrize("wire", ["float8_e4m3fn", "float8_e5m2", "int8"])
def test_block_scaled_sendrecv_matches_emulator(worlds, emu, wire, block,
                                                resident):
    """B5 at send, B6 at recv: bitwise the emulator tier and the
    reference codec ``dequantize_packed(quantize_packed(x))``; 5000
    elements leave a ragged last block at every block size, and the
    corpus keeps NaN, +-inf and +-0."""
    count = 5000
    x = corpus(count, 70) * np.float32(50.0)
    gold = jquant.dequantize_packed(
        jquant.quantize_packed(x, NP[wire], block), count)
    ref = j_run_ranks(emu, _bs_body(x, wire, block, count, False, False))[3]
    _, cw = worlds
    ctx = cw[0].device.ctx
    nbytes = ctx.exchange_bytes
    got = run_ranks(cw, _bs_body(x, wire, block, count, resident, True))[3]
    same_bits(got, ref)
    same_bits(got, gold)
    assert ctx.exchange_bytes - nbytes == jquant.packed_nbytes(count, block)


def _block_bound(x: np.ndarray, seg: int, block: int) -> np.ndarray:
    """The codec's bound per element, amax(block) * 2^-4 / (1 - 2^-4),
    with the scale blocks starting afresh every ``seg`` elements."""
    amax = np.empty_like(x)
    for o in range(0, x.size, seg):
        s = np.abs(x[o:o + seg])
        for b in range(0, s.size, block):
            amax[o + b:o + b + block] = s[b:b + block].max()
    return amax * np.float32(2.0 ** -4 / (1 - 2.0 ** -4))


@pytest.mark.parametrize("segment", [4620, 4096],
                         ids=["whole-blocks", "ragged-blocks"])
def test_block_scaled_p2p_above_one_segment(worlds, segment):
    """Above one wire segment the emulator tier quantizes each segment on
    its own (``quant.seg_elems`` elements: 4096 at a 4620-byte segment,
    3630 at 4096 bytes); the port quantizes the message whole, as the
    device tier's collectives do. Where a segment holds whole scale
    blocks the two agree bitwise; where it ends in a ragged block
    (as at the emulator's 1 MiB default: 932,056 elements) the scale
    blocks differ and so do the decoded values, each within the codec's
    bound over its own blocks: a departure (ROADMAP §C)."""
    wire, block = "float8_e4m3fn", 128
    seg = jquant.seg_elems(segment, 1)
    count = 2 * seg + 1000
    x = (np.random.default_rng(71).standard_normal(count)
         * 50.0).astype(np.float32)
    ew = emu_world(W, max_segment_size=segment)
    try:
        ref = j_run_ranks(ew, _bs_body(x, wire, block, count, False,
                                       False))[3]
    finally:
        for a in ew:
            a.deinit()
    got = run_ranks(worlds[1], _bs_body(x, wire, block, count, True,
                                        True))[3]

    def codec(lo, hi):
        return jquant.dequantize_packed(
            jquant.quantize_packed(x[lo:hi], NP[wire], block), hi - lo)

    same_bits(got, codec(0, count))
    same_bits(ref, np.concatenate([codec(o, min(o + seg, count))
                                   for o in range(0, count, seg)]))
    assert np.all(np.abs(got - x) <= _block_bound(x, count, block))
    assert np.all(np.abs(ref - x) <= _block_bound(x, seg, block))
    if seg % block == 0:
        same_bits(got, ref)
    else:
        assert int((got != ref).sum()) > 0


def test_block_scaled_p2p_departs_from_tpu_tier_nans(worlds, emu):
    """The reference's device tier ignores ``block_scale`` on send/recv
    and casts each element to e4m3fn with no scale, so every |x| > 448
    becomes NaN (129 of these 256 values); the emulator tier quantizes
    per scale block. The port follows the emulator tier, bitwise."""
    tw, cw = worlds
    count = 256
    x = ((np.arange(count) - 128) * 7.3).astype(np.float32)
    tpu = j_run_ranks(tw, _bs_body(x, "float8_e4m3fn", 128, count, False,
                                   False))[3]
    ref = j_run_ranks(emu, _bs_body(x, "float8_e4m3fn", 128, count, False,
                                    False))[3]
    got = run_ranks(cw, _bs_body(x, "float8_e4m3fn", 128, count, False,
                                 True))[3]
    assert int(np.isnan(tpu).sum()) == 129
    assert not np.isnan(got).any()
    same_bits(got, ref)
    assert 0 < np.abs(got - x).max() <= 934.4 / 448 * 2.0 ** -4 * 256


_MISMATCH = {
    # name: (send kwargs, recv kwargs, send count, recv count)
    "block differs": (("float8_e4m3fn", 128), ("float8_e4m3fn", 64), 256,
                      256),
    "wire differs": (("float8_e4m3fn", 128), ("float8_e5m2", 128), 256, 256),
    "recv plain": (("float8_e4m3fn", 128), None, 256, 256),
    "recv f16": (("float8_e4m3fn", 128), ("float16", 0), 256, 256),
    "send plain": (None, ("float8_e4m3fn", 128), 256, 256),
    "send f16": (("float16", 0), ("float8_e4m3fn", 128), 256, 256),
    "count differs": (("float8_e4m3fn", 128), ("float8_e4m3fn", 128), 128,
                      256),
}


@pytest.mark.parametrize("case", list(_MISMATCH))
def test_block_scaled_mismatch_matches_emulator(worlds, emu, case):
    """A recv posted with another block, wire or count than the send: the
    emulator tier's packed segment is self-describing, so a different
    block or wire still decodes with the sender's; a plain recv of a
    packed segment is DMA_MISMATCH_ERROR, a block-scaled recv of plain
    elements or of another count COMPRESSION_ERROR. The port gives the
    same outcome."""
    skw, rkw, cs, cr = _MISMATCH[case]
    x = ((np.arange(256) - 128) * 7.3).astype(np.float32)

    def kw(spec, port):
        if spec is None:
            return {}
        wire, block = spec
        out = {"compress_dtype": TORCH[wire] if port else NP[wire]}
        if block:
            out["block_scale"] = block
        return out

    def body(port):
        def fn(a):
            if a.rank == 0:
                src = (a.buffer(data=torch.from_numpy(x[:cs].copy()))
                       if port else a.buffer(data=x[:cs].copy()))
                a.send(src, cs, dst=1, tag=6, **kw(skw, port))
            elif a.rank == 1:
                d = (a.buffer((cr,), torch.float32) if port
                     else a.buffer((cr,), np.float32))
                err = _err(lambda: a.recv(d, cr, src=0, tag=6,
                                          **kw(rkw, port)))
                return err, np.asarray(d.data).copy()
            return None
        return fn

    ref = j_run_ranks(emu, body(False))[1]
    got = run_ranks(worlds[1], body(True))[1]
    assert got[0] == ref[0]
    if ref[0] == 0:
        same_bits(got[1], ref[1])


def test_block_scaled_descriptor_checks():
    """The reference's checks of a block-scaled descriptor, at the call
    site: float32 over an int8/fp8 wire only, and no stream operand."""
    from accl_tpu_torch import StreamFlags
    cw = cuda_world(2, device="cpu")
    try:
        a = cw[0]
        b = a.buffer((8,), torch.float32)
        with pytest.raises(ValueError, match="int8/fp8 wire"):
            a.send(b, 8, dst=1, compress_dtype=torch.float16, block_scale=64)
        with pytest.raises(ValueError, match="stream-port"):
            a.send(None, 8, dst=1, compress_dtype=torch.float8_e4m3fn,
                   block_scale=64, stream_flags=StreamFlags.OP0_STREAM)
        with pytest.raises(ValueError, match="block-scaled"):
            a.send(b, 8, dst=1, compress_dtype=torch.int8)
    finally:
        for a in cw:
            a.deinit()


# -- copy and combine -------------------------------------------------------

FUNCS = [ReduceFunc.SUM, ReduceFunc.MAX, ReduceFunc.MIN, ReduceFunc.PROD]


def _tie(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Where a and b are zeros of either sign (a MAX/MIN tie)."""
    return (a == 0) & (b == 0)


@pytest.mark.parametrize("resident", [False, True],
                         ids=["host", "resident"])
@pytest.mark.parametrize("name", ["float32", "float16", "bfloat16",
                                  "int32"])
@pytest.mark.parametrize("func", FUNCS, ids=lambda f: f.name)
def test_combine_matches_tpu_world(worlds, func, name, resident):
    """B1 out of place into the result buffer, over a corpus with NaN,
    +-inf and +-0 in both operands. Bitwise, but for two stated
    departures: at a +-0 tie of MAX/MIN the port follows jnp (ROADMAP
    §C; the reference's local combine runs numpy, which returns the
    first operand), and a bf16 NaN result matches a NaN (IEEE 754 leaves
    its sign and payload unspecified: ml_dtypes gives 0x7FC0 where torch's
    bf16 arithmetic gives 0xFFFF); f32 and f16 NaNs match bit for bit."""
    count = 300
    x, y = corpus(count, 80, name), corpus(count, 81, name)
    k = np.arange(24)        # every pairing of +0 and -0
    x[:24] = np.where(k % 2, -0.0, 0.0).astype(x.dtype)
    y[:24] = np.where(k % 4 < 2, -0.0, 0.0).astype(y.dtype)

    def body(side):
        def fn(a):
            if a.rank != 1:
                return None
            res = side.empty(a, count, name, resident)
            a.combine(count, side.func(func), side.buf(a, x, resident),
                      side.buf(a, y, resident), res)
            return to_np(res.data)
        return fn

    ref, got = both(worlds, body)
    ref, got = ref[1], got[1]
    keep = np.ones(count, bool)
    if name == "bfloat16":
        nan = np.isnan(ref.astype(np.float32))
        assert np.array_equal(nan, np.isnan(got.astype(np.float32)))
        keep &= ~nan
    if name != "int32":
        if func in (ReduceFunc.MAX, ReduceFunc.MIN):
            xf, yf = x.astype(np.float32), y.astype(np.float32)
            tie = _tie(xf, yf)
            keep &= ~tie
            neg = np.signbit(xf[tie]), np.signbit(yf[tie])
            want = (neg[0] | neg[1] if func == ReduceFunc.MIN
                    else neg[0] & neg[1])
            assert tie.sum() >= 24
            assert (np.signbit(got.astype(np.float32)[tie]) == want).all()
    same_bits(got[keep], ref[keep])


def test_local_combine_signed_zero_ties_follow_jnp(worlds):
    """The stated departure: on a +-0 tie numpy's maximum/minimum return
    one of the operands as it is (numpy 2.0's the second), jnp's order -0
    below +0. The reference's local combine runs numpy; B1 keeps jnp's
    rule, as the collectives do."""
    x = np.array([0.0, -0.0, 0.0, -0.0], np.float32)
    y = np.array([-0.0, 0.0, 0.0, -0.0], np.float32)

    def body(side):
        def fn(a):
            if a.rank != 0:
                return None
            outs = []
            for f in (ReduceFunc.MAX, ReduceFunc.MIN):
                res = side.empty(a, 4)
                a.combine(4, side.func(f), side.buf(a, x), side.buf(a, y),
                          res)
                outs.append(np.signbit(to_np(res.data)))
            return outs
        return fn

    ref, got = both(worlds, body)
    assert got[0][0].tolist() == [False, False, False, True]  # +0 > -0
    assert got[0][1].tolist() == [True, True, False, True]
    for r in ref[0]:                    # an operand, taken as it is
        assert ((r == np.signbit(x)) | (r == np.signbit(y))).all()
    assert ref[0][0].tolist() != got[0][0].tolist() \
        or ref[0][1].tolist() != got[0][1].tolist()


@pytest.mark.parametrize("which", ["op0", "op1", "res"])
@pytest.mark.parametrize("name", ["float16", "bfloat16", "float8_e4m3fn"])
def test_combine_compressed_operand_matches_tpu_world(worlds, name, which):
    """An operand or the result stored in the compressed dtype of a
    float32 call: widened (B2 up) before the f32 combine, narrowed (B2
    down) into the result buffer."""
    count = 200
    x, y = corpus(count, 90), corpus(count, 91)
    low = {"op0": x, "op1": y, "res": None}[which]

    def body(side):
        def fn(a):
            if a.rank != 2:
                return None
            bufs = {}
            for key, v in (("op0", x), ("op1", y)):
                bufs[key] = side.buf(a, v.astype(NP[name]) if v is low
                                     else v)
            res = side.empty(a, count, name if which == "res" else
                             "float32")
            a.combine(count, side.func(ReduceFunc.SUM), bufs["op0"],
                      bufs["op1"], res)
            return to_np(res.data)
        return fn

    ref, got = both(worlds, body)
    same_bits(got[2], ref[2])


@pytest.mark.parametrize("resident", [False, True],
                         ids=["host", "resident"])
@pytest.mark.parametrize("src_name,dst_name", [
    ("float32", "float32"), ("int32", "int32"), ("float16", "float32"),
    ("float32", "bfloat16"), ("float32", "float8_e5m2"),
    ("bfloat16", "bfloat16")])
def test_copy_matches_tpu_world(worlds, src_name, dst_name, resident):
    """A device copy, or B2 where the source or the result is stored in
    the compressed dtype."""
    count = 150
    x = corpus(count, 95, src_name)

    def body(side):
        def fn(a):
            if a.rank != 3:
                return None
            d = side.empty(a, count, dst_name, resident)
            a.copy(side.buf(a, x, resident), d, count)
            return to_np(d.data)
        return fn

    ref, got = both(worlds, body)
    same_bits(got[3], ref[3])


def test_wide_result_refused_in_device_resident_buffer(worlds):
    """A 64-bit result may not land in a device-resident buffer (the
    reference cannot hold one: jax, with x64 off, would truncate it);
    a host mirror takes it."""
    _, cw = worlds
    a = cw[0]
    x = np.array([2 ** 53 + 1, -7, 2 ** 62, 5], np.int64)
    src = a.buffer(data=torch.from_numpy(x.copy()))
    with pytest.raises(ACCLError) as ei:
        a.copy(src, a.buffer((4,), torch.int64, device_resident=True), 4)
    assert ei.value.error_word == int(ErrorCode.INVALID_CALL)
    host = a.buffer((4,), torch.int64)
    a.copy(src, host, 4)
    np.testing.assert_array_equal(host.data, x)


# -- concurrency ------------------------------------------------------------

def test_subcomm_collective_beside_world_p2p(worlds):
    """A sub-communicator's allreduce and the world's allreduce run
    beside world send/recv, all async, eight times over: the rendezvous
    keys on (comm, index) and the p2p on (comm, src, dst, tag), so no
    stream of calls crosses another, and a recv waiting on its worker
    deadlocks no collective (the reference's
    test_concurrent_world_subcomm_and_p2p)."""
    _, cw = worlds
    half = W // 2

    def fn(a):
        r = a.rank
        members = list(range(half)) if r < half else list(range(half, W))
        sub = Communicator([Rank(device=a.comm.ranks[g].device,
                                 global_rank=g) for g in members],
                           local_rank=members.index(r))
        a.device.configure_communicator(sub)
        n = 32
        for it in range(8):
            d = a.buffer((n,), torch.float32)
            h1 = a.allreduce(a.buffer(data=torch.full((n,), r + 1.0)), d, n,
                             run_async=True)
            d2 = a.buffer((n,), torch.float32)
            h2 = a.allreduce(a.buffer(data=torch.full((n,), 10.0 + r)), d2,
                             n, comm=sub, run_async=True)
            dst = a.buffer((n,), torch.float32, device_resident=True)
            hs = a.send(a.buffer(data=torch.full((n,), 100.0 + r)), n,
                        dst=(r + 1) % W, tag=it, run_async=True)
            hr = a.recv(dst, n, src=(r - 1) % W, tag=it, run_async=True)
            for h in (h1, h2, hs, hr):
                h.wait(60)
            assert d.data[0] == W * (W + 1) / 2, (r, it)
            assert d2.data[0] == sum(10.0 + m for m in members), (r, it)
            assert dst.data[0] == 100.0 + (r - 1) % W, (r, it)
        return True

    assert all(run_ranks(cw, fn, timeout=120.0))
