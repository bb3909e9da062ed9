"""The port's one-sided RMA against the reference's, on the CPU.

Data: ``cuda_world(W, device="cpu")`` against ``tpu_world(W,
platform="cpu")`` at W = 1, 2 and 4, bitwise: put and get rings on the
plain, f16, bf16 and fp8-e4m3 wires (fp8 is a per-element cast, no
scale), at aligned and byte-misaligned offsets and into a window of
another dtype, with host-mirror and device-resident windows; ``waitfor``
chaining, self-puts and self-gets over overlapping ranges, concurrent
puts both ways. Notify: against ``emu_world`` record for record (the
reference's device tier keeps no notify queue, a stated departure). Then
the typed window errors, auto window ids, the parked-send count under a
put storm, the registry and queue against the reference's on seeded
operation traces, and the metrics rows a poll does not add.
"""

from __future__ import annotations

import dataclasses
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

from accl_tpu.constants import ACCLError as JACCLError  # noqa: E402
from accl_tpu.device.tpu import tpu_world  # noqa: E402
from accl_tpu.rma import notify as jnotify  # noqa: E402
from accl_tpu.rma import window as jwindow  # noqa: E402
from accl_tpu.testing import emu_world  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu_torch import ACCLError, ErrorCode, cuda_world  # noqa: E402
from accl_tpu_torch.rma import (ANY_WINDOW, NotifyQueue,  # noqa: E402
                                NotifyRecord, WindowRegistry, sweep_leaked)
from accl_tpu_torch.serving.disagg import counter_total  # noqa: E402
from accl_tpu_torch.testing import run_ranks  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


@pytest.fixture(autouse=True)
def _port_window_leak_sweep():
    """The port's registries: a closed one must be empty after a test."""
    sweep_leaked()
    yield
    assert sweep_leaked() == []


NP = {"float32": np.float32, "float16": np.float16,
      "bfloat16": ml_dtypes.bfloat16, "float8_e4m3fn": ml_dtypes.float8_e4m3fn}
TORCH = {"float32": torch.float32, "float16": torch.float16,
         "bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn}
_BITS = {1: np.uint8, 2: np.uint16, 4: np.uint32}
WIN = 5                 # the window id every test pins
WIN_ELEMS = 96          # window elements (of its own dtype)
COUNT = 40              # elements a put or get moves


@pytest.fixture(scope="module", params=[1, 2, 4], ids=lambda w: f"W{w}")
def worlds(request):
    tw = tpu_world(request.param, platform="cpu")
    cw = cuda_world(request.param, device="cpu")
    yield tw, cw
    for a in tw + cw:
        a.deinit()


@pytest.fixture(scope="module")
def worlds4():
    tw = tpu_world(4, platform="cpu")
    cw = cuda_world(4, device="cpu")
    yield tw, cw
    for a in tw + cw:
        a.deinit()


def to_torch(x: np.ndarray) -> torch.Tensor:
    if x.dtype.name in ("bfloat16", "float8_e4m3fn"):
        signed = {1: np.int8, 2: np.int16}[x.dtype.itemsize]
        t = torch.from_numpy(x.view(signed).copy())
        return t.view(TORCH[x.dtype.name])
    return torch.from_numpy(x.copy())


def to_np(data) -> np.ndarray:
    if isinstance(data, torch.Tensor):
        name = str(data.dtype).removeprefix("torch.")
        if name in ("bfloat16", "float8_e4m3fn"):
            signed = {1: torch.int8, 2: torch.int16}[data.element_size()]
            return data.view(signed).numpy().view(NP[name]).copy()
        return data.numpy().copy()
    return np.asarray(data).copy()


class Side:
    """Buffers of one tier: the reference (jax) or the port (torch)."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side

    def dtype(self, name):
        return None if name is None else (
            np.dtype(NP[name]) if self.jax else TORCH[name])

    def buf(self, a, x: np.ndarray, resident: bool = False):
        if self.jax:
            if resident:
                import jax.numpy as jnp
                return a.buffer(data=jnp.asarray(x))
            return a.buffer(data=x.copy())
        return a.buffer(data=to_torch(x), device_resident=resident)


def both(worlds, body):
    """``body(side)`` returns the per-rank fn; run it on both tiers."""
    tw, cw = worlds
    return (j_run_ranks(tw, body(Side(True))),
            run_ranks(cw, body(Side(False))))


def same_bits(got: np.ndarray, ref: np.ndarray, what: str = "",
              nan_any: bool = False):
    """Bit for bit; with ``nan_any`` a NaN matches any NaN (its sign and
    payload after a wire cast are unspecified: numpy keeps a payload that
    torch and jnp canonicalise)."""
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    bits = _BITS[got.dtype.itemsize]
    g, r = got.view(bits), ref.view(bits)
    if nan_any:
        gn = np.isnan(got.astype(np.float32))
        np.testing.assert_array_equal(gn, np.isnan(ref.astype(np.float32)),
                                      what)
        g, r = g[~gn], r[~gn]
    np.testing.assert_array_equal(g, r, what)


def same_window(got: np.ndarray, ref: np.ndarray, off: int, n: int,
                what: str = "", nan_any: bool = False):
    """Two windows' bytes: exact outside the ``n`` f32 that landed at
    byte ``off``, those compared as f32 (:func:`same_bits`)."""
    gb, rb = got.view(np.uint8), ref.view(np.uint8)
    end = off + 4 * n
    np.testing.assert_array_equal(gb[:off], rb[:off], what)
    np.testing.assert_array_equal(gb[end:], rb[end:], what)
    same_bits(gb[off:end].copy().view(np.float32),
              rb[off:end].copy().view(np.float32), what, nan_any)


def corpus(n: int, seed: int, name: str = "float32") -> np.ndarray:
    """Seeded values with NaN, +-inf, +-0 and values past e4m3fn's 448
    among them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n) * 300.0).astype(np.float32)
    x[:6] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-40]
    rng.shuffle(x)
    return x.astype(NP[name])


def _err(fn):
    """Run ``fn``; the error word it raised, or 0."""
    try:
        fn()
    except (ACCLError, JACCLError) as exc:
        return int(exc.error_word)
    return 0


# -- put and get rings against tpu_world --------------------------------------

WIRES = [None, "float16", "bfloat16", "float8_e4m3fn"]
# (window dtype, byte offset): aligned, misaligned by 2 and by 6 bytes,
# and an f32 payload landing in a bf16 window
PLACES = {"aligned": ("float32", 32), "off2": ("float32", 2),
          "off6": ("float32", 6), "bf16_window": ("bfloat16", 12)}


def _ring(worlds, op: str, wire, resident: bool, place: str):
    """Every rank's window holds a corpus; rank r puts ``COUNT`` f32 into
    rank r+1's window (put) or gets them from it into a buffer of its
    own (get). Returns (reference, port) per-rank (window, result)."""
    wname, off = PLACES[place]
    W = len(worlds[0])

    def body(side):
        def fn(a):
            r = a.rank
            win = side.buf(a, corpus(WIN_ELEMS, 100 + r, wname), resident)
            assert a.register_window(win, window=WIN) == WIN
            src = side.buf(a, corpus(COUNT, 200 + r), resident)
            dst = side.buf(a, np.zeros(COUNT, np.float32), resident)
            a.barrier()
            if op == "put":
                a.put(src, COUNT, dst=(r + 1) % W, window=WIN, offset=off,
                      compress_dtype=side.dtype(wire))
            else:
                a.get(dst, COUNT, src=(r + 1) % W, window=WIN, offset=off,
                      compress_dtype=side.dtype(wire))
            a.barrier()
            out = to_np(win.data), to_np(dst.data)
            a.barrier()
            a.deregister_window(WIN)
            return out
        return fn

    return both(worlds, body)


@pytest.mark.parametrize("place", list(PLACES))
@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
@pytest.mark.parametrize("wire", WIRES, ids=lambda w: w or "fp32")
def test_put_ring_matches_tpu_world(worlds, wire, resident, place):
    ref, got = _ring(worlds, "put", wire, resident, place)
    W = len(ref)
    wname, off = PLACES[place]
    for r in range(W):
        same_window(got[r][0], ref[r][0], off, COUNT, f"rank {r} window",
                    nan_any=wire is not None)
    raw = got[1 % W][0].view(np.uint8)
    sent = corpus(COUNT, 200).view(np.uint8)
    if wire is None:        # the payload's bytes, at the byte offset
        np.testing.assert_array_equal(raw[off:off + sent.size], sent)
    before = corpus(WIN_ELEMS, 100 + 1 % W, wname).view(np.uint8)
    np.testing.assert_array_equal(raw[:off], before[:off])
    np.testing.assert_array_equal(raw[off + sent.size:],
                                  before[off + sent.size:])


@pytest.mark.parametrize("place", list(PLACES))
@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
@pytest.mark.parametrize("wire", WIRES, ids=lambda w: w or "fp32")
def test_get_ring_matches_tpu_world(worlds, wire, resident, place):
    ref, got = _ring(worlds, "get", wire, resident, place)
    W = len(ref)
    for r in range(W):
        same_bits(got[r][1], ref[r][1], f"rank {r} result",
                  nan_any=wire is not None)
        same_bits(got[r][0], ref[r][0], f"rank {r} window untouched")
    wname, off = PLACES[place]
    if wire is None:
        win = corpus(WIN_ELEMS, 100 + 1 % W, wname).view(np.uint8)
        np.testing.assert_array_equal(
            got[0][1].view(np.uint8), win[off:off + 4 * COUNT])


@pytest.mark.parametrize("wire", WIRES, ids=lambda w: w or "fp32")
@pytest.mark.parametrize("src_resident", [False, True],
                         ids=["host_src", "resident_src"])
def test_put_get_source_kinds_match_tpu_world(worlds4, wire, src_resident):
    """A host-mirror source into a device-resident window and the other
    way round, and the get back into the other kind of buffer."""
    def body(side):
        def fn(a):
            r = a.rank
            win = side.buf(a, corpus(WIN_ELEMS, 300 + r), not src_resident)
            a.register_window(win, window=WIN)
            src = side.buf(a, corpus(COUNT, 400 + r), src_resident)
            dst = side.buf(a, np.zeros(COUNT, np.float32), src_resident)
            a.barrier()
            a.put(src, COUNT, dst=(r + 2) % 4, window=WIN, offset=16,
                  compress_dtype=side.dtype(wire))
            a.barrier()
            a.get(dst, COUNT, src=(r + 3) % 4, window=WIN, offset=8,
                  compress_dtype=side.dtype(wire))
            a.barrier()
            out = to_np(win.data), to_np(dst.data)
            a.barrier()
            a.deregister_window(WIN)
            return out
        return fn

    ref, got = both(worlds4, body)
    for r in range(4):
        same_window(got[r][0], ref[r][0], 16, COUNT, f"rank {r} window",
                    nan_any=wire is not None)
        same_bits(got[r][1], ref[r][1], f"rank {r} result",
                  nan_any=wire is not None)


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_put_chains_behind_waitfor(worlds4, resident):
    """A put issued behind an async copy sends what the copy wrote; a get
    behind the put reads what the put landed."""
    def body(side):
        def fn(a):
            r = a.rank
            win = side.buf(a, np.zeros(WIN_ELEMS, np.float32), resident)
            a.register_window(win, window=WIN)
            x = side.buf(a, corpus(COUNT, 500 + r), resident)
            stage = side.buf(a, np.zeros(COUNT, np.float32), resident)
            back = side.buf(a, np.zeros(COUNT, np.float32), resident)
            a.barrier()
            h1 = a.copy(x, stage, COUNT, run_async=True)
            h2 = a.put(stage, COUNT, dst=(r + 1) % 4, window=WIN,
                       offset=4 * 8, run_async=True, waitfor=[h1])
            h2.wait()
            a.barrier()
            h3 = a.get(back, COUNT, src=r, window=WIN, offset=4 * 8,
                       run_async=True)
            h3.wait()
            a.barrier()
            out = to_np(win.data), to_np(back.data)
            a.barrier()
            a.deregister_window(WIN)
            return out
        return fn

    ref, got = both(worlds4, body)
    for r in range(4):
        same_bits(got[r][0], ref[r][0])
        same_bits(got[r][1], ref[r][1])
        same_bits(got[r][1], corpus(COUNT, 500 + (r - 1) % 4))


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
@pytest.mark.parametrize("op", ["put", "get"])
def test_self_put_get_over_overlapping_ranges(worlds4, op, resident):
    """A rank puts its window's first COUNT elements to byte 8 of the
    same window (or gets bytes 8.. into its start): the ranges overlap;
    the reference reads an immutable array, the port stages a copy."""
    def body(side):
        def fn(a):
            r = a.rank
            win = side.buf(a, corpus(WIN_ELEMS, 600 + r), resident)
            a.register_window(win, window=WIN)
            if op == "put":
                a.put(win, COUNT, dst=r, window=WIN, offset=8)
            else:
                a.get(win, COUNT, src=r, window=WIN, offset=8)
            out = to_np(win.data)
            a.deregister_window(WIN)
            return out
        return fn

    ref, got = both(worlds4, body)
    for r in range(4):
        same_bits(got[r], ref[r])
        x = corpus(WIN_ELEMS, 600 + r)
        want = x.copy()
        if op == "put":
            want[2:2 + COUNT] = x[:COUNT]
        else:
            want[:COUNT] = x[2:2 + COUNT]
        same_bits(got[r], want)


@pytest.mark.parametrize("resident", [False, True], ids=["host", "resident"])
def test_concurrent_puts_both_directions(worlds4, resident):
    """Every rank puts 6 async puts into every other rank's window at
    once (each pair both ways), at offsets of their own: held to a numpy
    oracle, and to the reference for host-mirror windows. The
    reference's device-resident window takes concurrent puts as
    read-modify-rebind of a donated array, which races ("Buffer has
    been deleted or donated", or a lost update): not compared there."""
    n = 8

    def body(side):
        def fn(a):
            r = a.rank
            win = side.buf(a, np.zeros(4 * 6 * n, np.float32), resident)
            a.register_window(win, window=WIN)
            srcs = [side.buf(a, corpus(n, 700 + 10 * r + k), resident)
                    for k in range(6)]
            a.barrier()
            hs = []
            for k in range(6):
                for d in range(4):
                    if d != r:
                        hs.append(a.put(srcs[k], n, dst=d, window=WIN,
                                        offset=4 * n * (6 * r + k),
                                        run_async=True))
            for h in hs:
                h.wait()
            a.barrier()
            out = to_np(win.data)
            a.barrier()
            a.deregister_window(WIN)
            return out
        return fn

    tw, cw = worlds4
    got = run_ranks(cw, body(Side(False)))
    ref = None if resident else j_run_ranks(tw, body(Side(True)))
    for r in range(4):
        want = np.zeros(4 * 6 * n, np.float32)
        for s in range(4):
            for k in range(6):
                if s != r:
                    want[n * (6 * s + k):n * (6 * s + k + 1)] = \
                        corpus(n, 700 + 10 * s + k)
        same_bits(got[r], want)
        if ref is not None:
            same_bits(got[r], ref[r])


# -- notify against emu_world ---------------------------------------------------

def _notify_scenario(side_jax: bool):
    """Rank 0 puts into rank 1's two windows: notified plain and f16
    puts, an un-notified one, and two that fail at the target (unknown
    window, range past the end); then rank 1 puts into itself with
    notify.
    Returns rank 1's records: a window-filtered partial poll, then the
    rest round-robin, as tuples."""
    def fn(a):
        np_dt = np.float32
        win1 = a.buffer((1 << 12,), np_dt) if side_jax else \
            a.buffer((1 << 12,), torch.float32)
        win2 = a.buffer((1 << 10,), np_dt) if side_jax else \
            a.buffer((1 << 10,), torch.float32)
        assert a.register_window(win1) == 1
        assert a.register_window(win2) == 2
        a.barrier()
        f16 = np.float16 if side_jax else torch.float16

        def data(n, seed):
            x = corpus(n, seed)
            return a.buffer(data=x) if side_jax else \
                a.buffer(data=torch.from_numpy(x))

        errs = []
        if a.rank == 0:
            a.put(data(64, 1), 64, dst=1, window=1, offset=256, notify=0xAB)
            a.put(data(512, 2), 512, dst=1, window=2, offset=0,
                  notify=0xCD, compress_dtype=f16)
            a.put(data(64, 3), 64, dst=1, window=1)           # no notify
            a.put(data(16, 4), 16, dst=1, window=1, offset=4096,
                  notify=0xEF)
            a.put(data(16, 5), 16, dst=1, window=2, offset=64, notify=7)
            errs.append(_err(lambda: a.put(data(16, 6), 16, dst=1,
                                           window=77, notify=0xBEEF)))
            errs.append(_err(lambda: a.put(data(16, 7), 16, dst=1,
                                           window=1, offset=(1 << 14) - 8,
                                           notify=0xF00D)))
        a.barrier()
        if a.rank == 1:
            a.put(data(32, 8), 32, dst=1, window=1, offset=1024,
                  notify=0x11)
        a.barrier()
        recs = []
        if a.rank == 1:
            recs.append(a.poll_notifications(window=1, max_records=2))
            recs.append(a.poll_notifications(max_records=64))
            recs.append(a.poll_notifications())
        a.barrier()
        a.deregister_window(1)
        a.deregister_window(2)
        return errs, [[dataclasses.astuple(r) for r in rs] for rs in recs]
    return fn


def test_notify_records_match_emulator():
    ew = emu_world(2, timeout=15.0)
    cw = cuda_world(2, device="cpu")
    try:
        ref = j_run_ranks(ew, _notify_scenario(True))
        got = run_ranks(cw, _notify_scenario(False))
    finally:
        for a in ew:
            a.device.deinit()
        for a in cw:
            a.deinit()
    assert got == ref
    errs, polls = got[0][0], got[1][1]
    word = int(ErrorCode.RMA_WINDOW_ERROR)
    assert all(e & word for e in errs) and len(errs) == 2
    assert [r[0] for r in polls[0]] == [0xAB, 0xEF]        # window 1 first
    tokens = sorted(r[0] for rs in polls for r in rs)
    assert tokens == sorted([0xAB, 0xCD, 0xEF, 7, 0xBEEF, 0xF00D, 0x11])
    by_tok = {r[0]: r for rs in polls for r in rs}
    assert by_tok[0xCD] == (0xCD, 2, 0, 0, 0, 512 * 4)   # uncompressed bytes
    assert by_tok[0x11][2] == 1                           # a self-put
    assert by_tok[0xBEEF][3] & word and by_tok[0xBEEF][5] == 0
    assert polls[2] == []


def test_notify_departs_from_tpu_tier():
    """The reference's device tier lands the data but drops the token:
    its poll returns []. The port follows the emulator tier: one record,
    after the data landed."""
    def body(side):
        def fn(a):
            win = side.buf(a, np.zeros(64, np.float32))
            a.register_window(win, window=WIN)
            a.barrier()
            if a.rank == 0:
                a.put(side.buf(a, np.arange(16, dtype=np.float32)), 16,
                      dst=1, window=WIN, offset=32, notify=77)
            a.barrier()
            recs = a.poll_notifications() if a.rank == 1 else []
            out = to_np(win.data)
            a.barrier()
            a.deregister_window(WIN)
            return [dataclasses.astuple(r) for r in recs], out
        return fn

    tw = tpu_world(2, platform="cpu")
    cw = cuda_world(2, device="cpu")
    try:
        ref, got = both((tw, cw), body)
    finally:
        for a in tw + cw:
            a.deinit()
    assert ref[1][0] == []
    assert got[1][0] == [(77, WIN, 0, 0, 32, 64)]
    for r in range(2):
        same_bits(got[r][1], ref[r][1])
    np.testing.assert_array_equal(got[1][1][8:24], np.arange(16))


# -- typed errors -------------------------------------------------------------

def test_window_errors_match_tpu_world(worlds4):
    """An unknown window, ranges past the end and before the start, a
    deregistered window: RMA_WINDOW_ERROR at the initiator, for put and
    get, as in the reference."""
    def body(side):
        def fn(a):
            win = side.buf(a, np.zeros(64, np.float32))
            a.register_window(win, window=WIN)
            x = side.buf(a, np.ones(16, np.float32))
            a.barrier()
            peer = (a.rank + 1) % 4
            words = [
                _err(lambda: a.put(x, 16, dst=peer, window=WIN + 1)),
                _err(lambda: a.get(x, 16, src=peer, window=WIN + 1)),
                _err(lambda: a.put(x, 16, dst=peer, window=WIN,
                                   offset=4 * 64 - 8)),
                _err(lambda: a.get(x, 16, src=peer, window=WIN,
                                   offset=4 * 60)),
                _err(lambda: a.put(x, 16, dst=peer, window=WIN,
                                   offset=-4)),
                _err(lambda: a.put(x, 16, dst=peer, window=WIN,
                                   offset=4 * 48)),           # fits: 0
            ]
            a.barrier()
            a.deregister_window(WIN)
            a.barrier()
            words.append(_err(lambda: a.put(x, 16, dst=peer, window=WIN)))
            words.append(_err(lambda: a.get(x, 16, src=peer, window=WIN)))
            return words
        return fn

    ref, got = both(worlds4, body)
    assert got == ref
    word = int(ErrorCode.RMA_WINDOW_ERROR)
    for words in got:
        assert words[5] == 0
        assert all(w & word for i, w in enumerate(words) if i != 5)


def test_put_after_deinit_fails_typed():
    """Puts against a rank that was deinitialised fail with the window
    error (its registry is closed and empty); calls of a deinitialised
    rank fail with CONNECTION_CLOSED, sync or async, and its notify queue
    is empty."""
    cw = cuda_world(2, device="cpu")
    try:
        for a in cw:
            a.register_window(a.buffer((64,), torch.float32), window=WIN)
        x = cw[0].buffer(data=torch.ones(16))
        cw[0].put(x, 16, dst=1, window=WIN, notify=3)
        cw[1].deinit()
        assert len(cw[1].device.windows) == 0 and cw[1].device.windows.closed
        assert cw[1].poll_notifications() == []
        assert _err(lambda: cw[0].put(x, 16, dst=1, window=WIN)) \
            & int(ErrorCode.RMA_WINDOW_ERROR)
        assert _err(lambda: cw[1].put(x, 16, dst=0, window=WIN)) \
            & int(ErrorCode.CONNECTION_CLOSED)
        h = cw[1].get(x, 16, src=0, window=WIN, run_async=True)
        assert _err(lambda: h.wait(5.0)) & int(ErrorCode.CONNECTION_CLOSED)
    finally:
        for a in cw:
            a.deinit()
    assert all(len(a.device.windows) == 0 for a in cw)


# -- mechanisms ---------------------------------------------------------------

def test_auto_window_ids_skip_pinned_like_reference():
    """Auto ids count from 1 and skip ids pinned earlier; a pinned id
    may be re-pinned; deregistered ids are not reused by the counter."""
    def ids(a, buf):
        out = [a.register_window(buf, window=2), a.register_window(buf),
               a.register_window(buf), a.register_window(buf, window=5),
               a.register_window(buf), a.register_window(buf)]
        a.deregister_window(1)
        out.append(a.register_window(buf))
        for w in set(out):
            a.deregister_window(w)
        return out

    ew = emu_world(1)
    cw = cuda_world(1, device="cpu")
    try:
        ref = ids(ew[0], ew[0].buffer((8,), np.float32))
        got = ids(cw[0], cw[0].buffer((8,), torch.float32))
    finally:
        ew[0].device.deinit()
        cw[0].deinit()
    assert got == ref == [2, 1, 3, 5, 4, 6, 7]


def test_put_storm_parks_no_send():
    """128 async puts with notify take no parked-send slot: the count
    stays 0, the bound unchanged, and a send/recv beside the storm still
    matches."""
    cw = cuda_world(2, device="cpu")
    ctx = cw[0].device.ctx
    bound = ctx.max_parked_sends
    seen = [0]
    stop = threading.Event()

    def watch():
        while not stop.wait(0.0005):
            seen[0] = max(seen[0], ctx._parked_sends)

    try:
        for a in cw:
            a.register_window(a.buffer((128 * 16,), torch.float32),
                              window=WIN)
        th = threading.Thread(target=watch, daemon=True)
        th.start()

        def fn(a):
            if a.rank == 0:
                x = a.buffer(data=torch.arange(16, dtype=torch.float32))
                hs = [a.put(x, 16, dst=1, window=WIN, offset=64 * k,
                            notify=k + 1, run_async=True)
                      for k in range(128)]
                a.send(x, 16, dst=1, tag=9)
                for h in hs:
                    h.wait()
                return None
            d = a.buffer((16,), torch.float32)
            a.recv(d, 16, src=0, tag=9)
            return d.data.copy()

        got = run_ranks(cw, fn)
        stop.set()
        th.join(5.0)
        np.testing.assert_array_equal(got[1], np.arange(16))
        recs = cw[1].poll_notifications(max_records=1000)
        assert sorted(r.token for r in recs) == list(range(1, 129))
    finally:
        stop.set()
        for a in cw:
            a.deinit()
    assert ctx.max_parked_sends == bound
    assert seen[0] <= 1                     # the one send, never a put
    assert ctx._parked_sends == 0


def test_poll_issues_no_call():
    """A poll loop adds no accl_calls_total row on any rank; the put and
    get themselves are counted with their bytes."""
    cw = cuda_world(2, device="cpu")
    try:
        for a in cw:
            a.register_window(a.buffer((64,), torch.float32), window=WIN)
        x = cw[0].buffer(data=torch.ones(16))
        cw[0].put(x, 16, dst=1, window=WIN, notify=1)
        cw[0].get(x, 16, src=1, window=WIN)
        before = cw[0].metrics_snapshot()["counters"]
        for _ in range(50):
            cw[1].poll_notifications(window=WIN)
            cw[1].poll_notifications()
        after = cw[0].metrics_snapshot()["counters"]
        assert after["accl_calls_total"] == before["accl_calls_total"]
        assert counter_total(cw[0], "accl_calls_total", op="put") == 1
        assert counter_total(cw[0], "accl_bytes_total", op="get") == 64
        assert counter_total(cw[1], "accl_calls_total") == 0
    finally:
        for a in cw:
            a.deinit()


def test_soft_reset_keeps_windows_and_drops_records():
    cw = cuda_world(2, device="cpu")
    try:
        for a in cw:
            a.register_window(a.buffer((64,), torch.float32), window=WIN)
        x = cw[0].buffer(data=torch.arange(16, dtype=torch.float32))
        cw[0].put(x, 16, dst=1, window=WIN, notify=1)
        for a in cw:
            a.soft_reset()
        assert cw[1].poll_notifications() == []
        cw[0].put(x, 16, dst=1, window=WIN, offset=64, notify=2)
        assert [r.token for r in cw[1].poll_notifications()] == [2]
        np.testing.assert_array_equal(
            cw[1].device._window(WIN, 64, 64)[0][16:32].numpy(),
            np.arange(16))
    finally:
        for a in cw:
            a.deinit()


def _registry_trace(reg_cls, err_cls, seed: int) -> list:
    """A seeded trace of register / deregister / get / resolve / len /
    close on one registry: every outcome, errors by their word."""
    rng = np.random.default_rng(seed)
    reg = reg_cls(owner="t")
    out = []
    for _ in range(200):
        op = rng.integers(0, 6)
        wid = int(rng.integers(0, 6))
        if op == 0:
            nbytes = int(rng.integers(-2, 64))
            try:
                reg.register(wid, 4096 * (wid + 1), nbytes)
                out.append(("reg", wid, nbytes))
            except ValueError:
                out.append(("reg!", wid, nbytes))
        elif op == 1:
            reg.deregister(wid)
            out.append(("dereg", wid))
        elif op == 2:
            w = reg.get(wid)
            out.append(("get", None if w is None
                        else (w.wid, w.addr, w.nbytes)))
        elif op == 3:
            off, n = int(rng.integers(-4, 64)), int(rng.integers(0, 32))
            try:
                out.append(("resolve", reg.resolve(wid, off, n)))
            except err_cls as exc:
                out.append(("resolve!", exc.error_word))
        elif op == 4:
            out.append(("len", len(reg)))
        elif rng.random() < 0.1:
            reg.close()
            out.append(("close", reg.closed))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_window_registry_matches_reference_trace(seed):
    assert (_registry_trace(WindowRegistry, ACCLError, seed)
            == _registry_trace(jwindow.WindowRegistry, JACCLError, seed))


def _queue_trace(queue_cls, rec_cls, any_window, seed: int) -> list:
    """A seeded trace of push / poll (one window or all, partial) /
    pending / clear on a small-capacity queue, with its counters."""
    rng = np.random.default_rng(seed)
    q = queue_cls(cap=5)
    out = []
    for i in range(300):
        op = rng.integers(0, 10)
        w = int(rng.integers(1, 4))
        if op < 5:
            q.push(rec_cls(token=i, window=w, src=int(rng.integers(0, 4)),
                           err=0, offset=8 * i, nbytes=4 * i))
        elif op < 8:
            win = any_window if rng.random() < 0.5 else w
            n = int(rng.integers(0, 8))
            out.append([dataclasses.astuple(r) for r in q.poll(win, n)])
        elif op == 8:
            out.append((q.pending(), q.pending(w)))
        elif rng.random() < 0.2:
            q.clear()
        out.append((q.enqueued, q.dropped, q.polled))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_notify_queue_matches_reference_trace(seed):
    assert (_queue_trace(NotifyQueue, NotifyRecord, ANY_WINDOW, seed)
            == _queue_trace(jnotify.NotifyQueue, jnotify.NotifyRecord,
                            jnotify.ANY_WINDOW, seed))


@pytest.mark.parametrize("seed", range(3))
def test_metrics_registry_matches_reference(seed):
    """The port's MetricsRegistry against the reference's on one seeded
    trace of counters, gauges, histogram samples and a collector: the
    same snapshot."""
    from accl_tpu.tracing import MetricsRegistry as JRegistry
    from accl_tpu_torch.tracing import MetricsRegistry

    class Owner:
        def rows(self):
            yield ("counter", "c0", {"k": 1}, 5)
            yield ("gauge", "g0", {"k": 2}, 1.5)
            yield ("histogram", "h0", {"k": 1}, [2, 3.0, [1] + [0] * 9 + [1]])

    def trace(cls):
        rng = np.random.default_rng(seed)
        reg, owner = cls(), Owner()
        reg.register_collector(owner, Owner.rows)
        for _ in range(100):
            op, k = int(rng.integers(0, 3)), int(rng.integers(0, 3))
            v = float(rng.choice([0.5, 3.0, 70.0, 5e5, 1e7]))
            if op == 0:
                reg.inc(f"c{k}", v, k=k)
            elif op == 1:
                reg.set_gauge(f"g{k}", v, k=k)
            else:
                reg.observe(f"h{k}", v, k=k)
        return reg.snapshot()

    assert trace(MetricsRegistry) == trace(JRegistry)
