"""The port's alltoallv against the reference's, on the CPU.

``cuda_world(4, device="cpu")`` against ``emu_world(4)``: the reference's
device tier has no alltoallv (``tpu_world`` refuses it with
COLLECTIVE_NOT_IMPLEMENTED), so the port follows the emulator tier (a
stated departure, ROADMAP §C). Each exchange is described by a count
matrix M (M[i][j] = elements rank i sends rank j): rank i's send vector
is row i, its recv vector column i. Results are bitwise against the
emulator and against the matrix oracle unless a test states a bound.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

from accl_tpu import quant as jquant  # noqa: E402
from accl_tpu.constants import ACCLError as JACCLError  # noqa: E402
from accl_tpu.constants import ErrorCode as JErrorCode  # noqa: E402
from accl_tpu.device.tpu import tpu_world  # noqa: E402
from accl_tpu.testing import emu_world  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu_torch import ACCLError, ErrorCode, cuda_world  # noqa: E402
from accl_tpu_torch.ops import compression as C  # noqa: E402
from accl_tpu_torch.parallel import collectives as P  # noqa: E402
from accl_tpu_torch.testing import run_ranks  # noqa: E402
from accl_tpu_torch.tracing import METRICS  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep: the port creates no shm
    segment."""
    yield


W = 4
NP = {"float16": np.float16, "bfloat16": ml_dtypes.bfloat16,
      "float8_e4m3fn": ml_dtypes.float8_e4m3fn,
      "float8_e5m2": ml_dtypes.float8_e5m2, "int8": np.int8}


@pytest.fixture(scope="module")
def cw():
    world = cuda_world(W, device="cpu")
    yield world
    for a in world:
        a.deinit()


@pytest.fixture(scope="module")
def ew():
    world = emu_world(W, timeout=30.0, nbufs=32)
    yield world
    for a in world:
        a.deinit()


def matrix(seed: int, zero_frac: float = 0.3, cmax: int = 40) -> np.ndarray:
    """Seeded count matrix with skew and zero-count peers (a rank that
    sends nothing at seeds divisible by 3, one that receives nothing at
    seeds divisible by 4): the reference test's corpus."""
    rng = np.random.default_rng(seed)
    m = rng.integers(1, cmax, size=(W, W))
    m[rng.random((W, W)) < zero_frac] = 0
    if seed % 3 == 0:
        m[seed % W, :] = 0
    if seed % 4 == 0:
        m[:, (seed + 1) % W] = 0
    return m.astype(np.int64)


def inputs(m: np.ndarray, scale: float = 1.0) -> list:
    return [(np.random.default_rng(100 + r).standard_normal(
        max(1, int(m[r].sum()))) * scale).astype(np.float32)[:int(m[r].sum())]
        for r in range(W)]


def expected(m: np.ndarray, ins, r: int) -> np.ndarray:
    """Rank r's landing: each source's r-th send interval, in order."""
    pieces = [ins[s][int(m[s, :r].sum()):int(m[s, :r + 1].sum())]
              for s in range(W)]
    return np.concatenate(pieces)


def body(m, ins, port: bool, *, in_place=False, run_async=False,
         wire=None, block=False, resident=False):
    def fn(a):
        r = a.rank
        ns, nr = int(m[r].sum()), int(m[:, r].sum())
        cap = max(1, ns, nr)
        if port:
            mk = (lambda n: a.buffer((n,), torch.float32,
                                     device_resident=resident))
            cd = None if wire is None else getattr(torch, wire)
        else:
            mk = (lambda n: a.buffer((n,), np.float32))
            cd = None if wire is None else np.dtype(NP[wire])
        if in_place:
            src = dst = mk(cap)
        else:
            src, dst = mk(max(1, ns)), mk(max(1, nr))
        if port:
            src.storage[:ns] = torch.from_numpy(ins[r].copy())
            if not in_place:
                dst.storage.fill_(-7.0)
        else:
            src.data[:ns] = ins[r]
            if not in_place:
                dst.data[:] = -7.0
        h = a.alltoallv(src, dst, tuple(m[r]), tuple(m[:, r]),
                        compress_dtype=cd, block_scale=block,
                        run_async=run_async)
        if run_async:
            h.wait()
        return np.asarray(dst.data)[:nr].copy()
    return fn


def run_port(cw, m, ins, **kw):
    return run_ranks(cw, body(m, ins, True, **kw))


def run_emu(ew, m, ins, **kw):
    return j_run_ranks(ew, body(m, ins, False, **kw))


def same_bits(got, ref, what=""):
    assert got.dtype == ref.dtype and got.shape == ref.shape, what
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32),
                                  what)


# -- exact exchanges --------------------------------------------------------

@pytest.mark.parametrize("seed,run_async,resident", list(itertools.product(
    (1, 3, 4, 8), (False, True), (False, True))))
def test_uneven_matches_emulator_and_oracle(cw, ew, seed, run_async,
                                            resident):
    """Seeded uneven corpus, zero-count peers included: bitwise the
    matrix oracle and the emulator tier, sync and async, host-mirror and
    device-resident buffers."""
    m = matrix(seed * 7 + W)
    ins = inputs(m)
    got = run_port(cw, m, ins, run_async=run_async, resident=resident)
    ref = run_emu(ew, m, ins, run_async=run_async)
    for r in range(W):
        same_bits(got[r], expected(m, ins, r), f"oracle rank {r}")
        same_bits(got[r], ref[r], f"emulator rank {r}")


def test_zero_count_world(cw):
    """A wholly zero matrix completes, with nothing landed."""
    m = np.zeros((W, W), np.int64)
    got = run_port(cw, m, inputs(m))
    assert all(o.size == 0 for o in got)


@pytest.mark.parametrize("seed,run_async,resident", list(itertools.product(
    (2, 5), (False, True), (False, True))))
def test_in_place_is_staged(cw, ew, seed, run_async, resident):
    """src and dst one buffer: uneven intervals alias across different
    peers' chunks, so only the staging copy makes this right."""
    m = matrix(seed)
    ins = inputs(m)
    got = run_port(cw, m, ins, in_place=True, run_async=run_async,
                   resident=resident)
    ref = run_emu(ew, m, ins, in_place=True, run_async=run_async)
    for r in range(W):
        same_bits(got[r], expected(m, ins, r))
        same_bits(got[r], ref[r])


def test_async_in_place_stage_is_recycled(cw):
    """An async in-place call draws a private stage from a pool and
    returns it when it retires: two calls in a row reuse one buffer."""
    m = matrix(2)
    ins = inputs(m)
    run_port(cw, m, ins, in_place=True, run_async=True, resident=True)
    pools = [dict(a._redist_stage_pool) for a in cw]
    run_port(cw, m, ins, in_place=True, run_async=True, resident=True)
    for a, before in zip(cw, pools):
        assert {k: len(v) for k, v in a._redist_stage_pool.items()} \
            == {k: len(v) for k, v in before.items()}
        assert all(len(v) == 1 for v in a._redist_stage_pool.values())


# -- compressed wires ---------------------------------------------------------

@pytest.mark.parametrize("wire", ["float16", "bfloat16", "float8_e4m3fn",
                                  "float8_e5m2"])
def test_per_tensor_wire_matches_emulator(cw, ew, wire):
    """f16, bf16 and the fp8 pure cast: every cross chunk a cast down
    and up, the own chunk exact; bitwise the emulator tier (values kept
    inside every wire's range)."""
    m = matrix(11)
    ins = inputs(m, scale=8.0)
    got = run_port(cw, m, ins, wire=wire, resident=True)
    ref = run_emu(ew, m, ins, wire=wire)
    for r in range(W):
        same_bits(got[r], ref[r], f"rank {r}")
        exp = expected(m, ins, r)
        off = int(m[:r, r].sum())
        own = slice(off, off + int(m[r, r]))
        same_bits(got[r][own], exp[own], "own chunk")
        cast = exp.astype(NP[wire]).astype(np.float32)
        same_bits(np.delete(got[r], np.arange(own.start, own.stop)),
                  np.delete(cast, np.arange(own.start, own.stop)),
                  "cross chunks")


@pytest.mark.parametrize("wire,block", [("float8_e4m3fn", 128),
                                        ("float8_e5m2", 64),
                                        ("int8", 32)])
def test_block_scaled_within_one_segment_matches_emulator(cw, ew, wire,
                                                          block):
    """Every cross chunk below one wire segment: the emulator quantizes
    it as one message, as the port does, so the two agree bitwise; the
    own chunk stays exact."""
    m = matrix(13, cmax=600)
    ins = inputs(m, scale=30.0)
    got = run_port(cw, m, ins, wire=wire, block=block, resident=True)
    ref = run_emu(ew, m, ins, wire=wire, block=block)
    for r in range(W):
        same_bits(got[r], ref[r], f"rank {r}")
        off = int(m[:r, r].sum())
        same_bits(got[r][off:off + int(m[r, r])],
                  ins[r][int(m[r, :r].sum()):int(m[r, :r + 1].sum())])


def _block_bound(x: np.ndarray, seg: int, block: int) -> np.ndarray:
    """The e4m3 codec's bound per element, amax(block) * 2^-4 / (1 -
    2^-4), the scale blocks starting afresh every ``seg`` elements."""
    amax = np.empty_like(x)
    for o in range(0, x.size, seg):
        s = np.abs(x[o:o + seg])
        for b in range(0, s.size, block):
            amax[o + b:o + b + block] = s[b:b + block].max()
    return amax * np.float32(2.0 ** -4 / (1 - 2.0 ** -4))


def test_block_scaled_above_one_segment(cw):
    """A chunk above one wire segment: the emulator (4096-element
    segments at a 4620-byte segment size; 3630 at 4096 bytes) quantizes
    each segment, the port the chunk whole (ROADMAP §C). Where the
    segment holds whole scale blocks they agree bitwise; where it ends
    in a ragged block the decoded values differ, each within the codec's
    bound over its own blocks."""
    m = np.zeros((W, W), np.int64)
    m[0, 2] = 2 * 4096 + 1000
    m[1, 1] = 50
    ins = inputs(m, scale=50.0)
    wire, block = "float8_e4m3fn", 128
    got = run_port(cw, m, ins, wire=wire, block=block, resident=True)[2]
    x = ins[0]
    for segment in (4620, 4096):
        seg = jquant.seg_elems(segment, 1)
        ew = emu_world(W, timeout=30.0, max_segment_size=segment)
        try:
            ref = run_emu(ew, m, ins, wire=wire, block=block)[2]
        finally:
            for a in ew:
                a.deinit()
        assert np.all(np.abs(got - x) <= _block_bound(x, x.size, block))
        assert np.all(np.abs(ref - x) <= _block_bound(x, seg, block))
        if seg % block == 0:
            same_bits(got, ref)
        else:
            assert int((got != ref).sum()) > 0


def test_codec_launches_once_per_distinct_chunk_length():
    """The block-scaled and cast codecs take rows of one length: the
    dataplane launches them once for each distinct cross-chunk length
    (zero-count pairs launch nothing, the own chunk never crosses)."""
    calls = {"bs_quant": 0, "bs_dequant": 0, "cast": 0}

    def counted(name, fn):
        def f(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return f

    k = P.KERNELS._replace(
        bs_quant=counted("bs_quant", C.bs_quant),
        bs_dequant=counted("bs_dequant", C.bs_dequant),
        cast=counted("cast", C.cast))
    m = np.array([[5, 7, 0, 7], [3, 9, 7, 0], [0, 0, 4, 3], [7, 3, 3, 2]])
    ins = [torch.from_numpy(x) for x in inputs(m)]
    outs = [torch.zeros(int(m[:, r].sum())) for r in range(W)]
    lengths = {int(m[i, j]) for i in range(W) for j in range(W)
               if i != j and m[i, j]}
    sends = [tuple(int(c) for c in m[r]) for r in range(W)]
    recvs = [tuple(int(c) for c in m[:, r]) for r in range(W)]
    P.alltoallv(ins, outs, sends, recvs, k, "float8_e4m3fn", 32)
    assert calls == {"bs_quant": len(lengths), "bs_dequant": len(lengths),
                     "cast": 0}
    P.alltoallv(ins, outs, sends, recvs, k, "bfloat16", 0)
    assert calls["cast"] == 2 * len(lengths)


# -- ACCL's validation, metrics and departures --------------------------------

def _message(fn):
    with pytest.raises((ValueError, ACCLError, JACCLError)) as ei:
        fn()
    return str(ei.value)


def test_validation_messages_match_reference(cw, ew):
    """Each refusal raises the reference's ValueError, word for word."""
    cases = [((1, 1), (1, 1, 1, 1)), ((1, -1, 1, 1), (1, 1, 1, 1)),
             ((8, 8, 8, 8), (0, 0, 0, 0)), ((0, 0, 0, 0), (9, 0, 0, 0))]
    p, e = cw[0], ew[0]
    ps, pd = p.buffer((8,), torch.float32), p.buffer((8,), torch.float32)
    es, ed = e.buffer((8,), np.float32), e.buffer((8,), np.float32)
    for s, r in cases:
        assert _message(lambda: p.alltoallv(ps, pd, s, r)) \
            == _message(lambda: e.alltoallv(es, ed, s, r))
    assert "block_scale needs a compress_dtype" in _message(
        lambda: p.alltoallv(ps, pd, (1,) * W, (1,) * W, block_scale=128))


def test_metrics(cw):
    """alltoallv_total, _bytes_total, _zero_peers_total and the skew
    gauge (largest peer chunk over the even share) per rank."""
    m = np.array([[0, 6, 0, 2], [1, 1, 1, 1], [2, 2, 2, 2], [4, 0, 0, 0]])

    def snap():
        return METRICS.snapshot()

    before = snap()["counters"]
    run_port(cw, m, inputs(m))
    after = snap()
    for r in range(W):
        lab = f"rank={r}"
        count = max(int(m[r].sum()), int(m[:, r].sum()))
        zero = int((m[r] == 0).sum() + (m[:, r] == 0).sum())

        def delta(name):
            return (after["counters"].get(name, {}).get(lab, 0)
                    - before.get(name, {}).get(lab, 0))

        assert delta("alltoallv_total") == 1
        assert delta("alltoallv_bytes_total") == 4 * count
        assert delta("alltoallv_zero_peers_total") == zero
        cmax = max(int(m[r].max()), int(m[:, r].max()))
        assert after["gauges"]["alltoallv_skew"][lab] \
            == round(cmax * W / count, 3)


def test_inconsistent_vectors_fail_every_member(cw):
    """The one controller sees every member's vectors at launch: when
    rank 0's send to rank 1 disagrees with rank 1's recv from rank 0,
    every member fails with DMA_MISMATCH_ERROR (the emulator tier can
    instead run into a recv deadline: ROADMAP §C)."""
    m = np.full((W, W), 2, np.int64)

    def fn(a):
        r = a.rank
        send = [2] * W
        recv = [2] * W
        if r == 1:
            recv[0] = 3
        src = a.buffer((8,), torch.float32)
        dst = a.buffer((9,), torch.float32)
        with pytest.raises(ACCLError) as ei:
            a.alltoallv(src, dst, send, recv)
        return ei.value.error_word

    words = run_ranks(cw, fn)
    assert all(w & int(ErrorCode.DMA_MISMATCH_ERROR) for w in words)
    # and the world still runs afterwards
    ins = inputs(m)
    got = run_port(cw, m, ins)
    for r in range(W):
        same_bits(got[r], expected(m, ins, r))


def test_tpu_tier_refuses_alltoallv():
    """The departure: the reference's device tier has no alltoallv and
    refuses it with COLLECTIVE_NOT_IMPLEMENTED; the port runs it."""
    tw = tpu_world(2, platform="cpu")
    try:
        def fn(a):
            src = a.buffer(data=np.ones(4, np.float32))
            dst = a.buffer((4,), np.float32)
            with pytest.raises(JACCLError) as ei:
                a.alltoallv(src, dst, (2, 2), (2, 2))
            return ei.value.error_word
        words = j_run_ranks(tw, fn)
    finally:
        for a in tw:
            a.deinit()
    assert all(w & int(JErrorCode.COLLECTIVE_NOT_IMPLEMENTED) for w in words)
