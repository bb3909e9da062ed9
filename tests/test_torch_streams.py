"""The port's stream ports against the reference's, on the CPU.

The scenario of the reference's ``test_streams_tpu_tier``
(``tests/test_streaming.py``) through ``cuda_world(4, device="cpu")``,
its steps held bitwise against ``tpu_world(4, platform="cpu")``: the
remote-stream ``stream_put``, streamed copy, combine, send and recv, takes
that span entries, stalled streams, 64-bit payloads, the soft reset and
the refusal of a streamed collective.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from accl_tpu.constants import CCLOp as JCCLOp  # noqa: E402
from accl_tpu.constants import ReduceFunc as JRF  # noqa: E402
from accl_tpu.constants import StreamFlags as JSF  # noqa: E402
from accl_tpu.device.tpu import tpu_world  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu_torch import (ACCLError, CCLOp, CudaDevice,  # noqa: E402
                            ErrorCode, ReduceFunc, StreamFlags, cuda_world)
from accl_tpu_torch.testing import run_ranks  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


W = 4
N = 8


def _x(k):
    return (np.arange(N, dtype=np.float32) + 1) * k


@pytest.fixture(scope="module")
def worlds():
    tw = tpu_world(W, platform="cpu")
    cw = cuda_world(W, device="cpu")
    yield tw, cw
    for a in tw + cw:
        a.deinit()


class Side:
    """One tier's flags, funcs and buffers."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.SF = JSF if jax_side else StreamFlags

    def func(self, f):
        return JRF(int(f)) if self.jax else f

    def buf(self, a, x=None, n=N, resident=False):
        if self.jax:
            if x is None:
                return a.buffer((n,), np.float32, device_resident=resident)
            if resident:
                import jax.numpy as jnp
                return a.buffer(data=jnp.asarray(x))
            return a.buffer(data=x.copy())
        if x is None:
            return a.buffer((n,), torch.float32, device_resident=resident)
        return a.buffer(data=torch.from_numpy(x.copy()),
                        device_resident=resident)

    def f16(self):
        return np.float16 if self.jax else torch.float16


def _np(t):
    return np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t).copy()


def _remote_put(side):
    def fn(a):
        if a.rank == 0:
            a.stream_put(side.buf(a, _x(1)), N, dst=1)
        elif a.rank == 1:
            dst = side.buf(a)
            a.copy(None, dst, N, stream_flags=side.SF.OP0_STREAM)
            return _np(dst.data)
        return None
    return fn


def _res_stream_pop(side):
    def fn(a):
        if a.rank != 2:
            return None
        a.copy(side.buf(a, _x(2), resident=True), None, N,
               stream_flags=side.SF.RES_STREAM)
        return _np(a.stream_pop(5.0))
    return fn


def _send_recv_streams(side):
    def fn(a):
        if a.rank == 0:
            a.stream_push(_x(3))
            a.send(None, N, dst=3, tag=7, stream_flags=side.SF.OP0_STREAM)
        elif a.rank == 3:
            a.recv(None, N, src=0, tag=7, stream_flags=side.SF.RES_STREAM)
            return _np(a.stream_pop(5.0))
        return None
    return fn


def _send_recv_streams_f16(side):
    def fn(a):
        if a.rank == 1:
            a.stream_push(_x(3) / np.float32(7.0))
            a.send(None, N, dst=2, tag=8, compress_dtype=side.f16(),
                   stream_flags=side.SF.OP0_STREAM)
        elif a.rank == 2:
            a.recv(None, N, src=1, tag=8, compress_dtype=side.f16(),
                   stream_flags=side.SF.RES_STREAM)
            return _np(a.stream_pop(5.0))
        return None
    return fn


def _combine_from_stream(side):
    def fn(a):
        if a.rank != 0:
            return None
        a.stream_push(_x(7))
        res = side.buf(a, resident=True)
        a.combine(N, side.func(ReduceFunc.SUM), None,
                  side.buf(a, np.full(N, 10.0, np.float32)), res,
                  stream_flags=side.SF.OP0_STREAM)
        a.stream_push(_x(-2))
        a.combine(N, side.func(ReduceFunc.MAX), None, side.buf(a, _x(1)),
                  None, stream_flags=side.SF.OP0_STREAM | side.SF.RES_STREAM)
        return _np(res.data), _np(a.stream_pop(5.0))
    return fn


def _spanning_takes(side):
    def fn(a):
        if a.rank != 1:
            return None
        a.stream_push(_x(1)[:3])
        a.stream_push(_x(1)[3:])
        a.stream_push(_x(2))
        d, d2 = side.buf(a), side.buf(a)
        a.copy(None, d, N, stream_flags=side.SF.OP0_STREAM)
        a.copy(None, d2, N, stream_flags=side.SF.OP0_STREAM)
        # the stream-out port: two entries, read across and then whole
        for k in (4, 5):
            a.copy(side.buf(a, _x(k)), None, N,
                   stream_flags=side.SF.RES_STREAM)
        part = a.stream_pop(5.0, count=N + 3)
        rest = a.stream_pop(5.0)
        return _np(d.data), _np(d2.data), _np(part), _np(rest)
    return fn


SCENARIO = {"remote_put": _remote_put, "res_stream_pop": _res_stream_pop,
            "send_recv_streams": _send_recv_streams,
            "send_recv_streams_f16": _send_recv_streams_f16,
            "combine_from_stream": _combine_from_stream,
            "spanning_takes": _spanning_takes}


def _flat(res):
    out = []
    for r in res:
        if r is None:
            continue
        out += list(r) if isinstance(r, tuple) else [r]
    return out


@pytest.mark.parametrize("step", list(SCENARIO))
def test_stream_scenario_matches_tpu_world(worlds, step):
    tw, cw = worlds
    ref = _flat(j_run_ranks(tw, SCENARIO[step](Side(True))))
    got = _flat(run_ranks(cw, SCENARIO[step](Side(False))))
    assert len(got) == len(ref) > 0
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g.view(np.uint8), r.view(np.uint8))


def test_spanning_takes_values(worlds):
    _, cw = worlds
    d, d2, part, rest = run_ranks(cw, _spanning_takes(Side(False)))[1]
    np.testing.assert_array_equal(d, _x(1))
    np.testing.assert_array_equal(d2, _x(2))
    np.testing.assert_array_equal(part, np.concatenate([_x(4), _x(5)[:3]]))
    np.testing.assert_array_equal(rest, _x(5)[3:])   # what is left of it


def test_stream_paths_stay_on_the_device(worlds, monkeypatch):
    """Send-from-stream to recv-to-stream makes no operand read and no
    result write (the payload never visits a buffer), and what the port
    holds is a tensor on the rank's device."""
    _, cw = worlds
    crossings = []
    for name in ("_read_operand", "_write_result"):
        orig = getattr(CudaDevice, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            crossings.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(CudaDevice, name, spy)
    got = run_ranks(cw, _send_recv_streams(Side(False)))[3]
    np.testing.assert_array_equal(got, _x(3))
    assert not crossings
    a0 = cw[0]
    a0.stream_push(_x(6))
    a0.copy(None, None, N, stream_flags=StreamFlags.OP0_STREAM
            | StreamFlags.RES_STREAM)
    popped = a0.stream_pop(5.0)
    assert isinstance(popped, torch.Tensor)
    assert popped.device == a0.device.ctx.device


def test_push_snapshots_the_callers_array(worlds):
    _, cw = worlds
    a0 = cw[0]
    vol = _x(4).copy()
    a0.stream_push(vol)
    vol[:] = -999.0
    t = torch.from_numpy(_x(5).copy())
    a0.stream_push(t)
    t.fill_(-1.0)
    for k in (4, 5):
        d = a0.buffer((N,), torch.float32)
        a0.copy(None, d, N, stream_flags=StreamFlags.OP0_STREAM)
        np.testing.assert_array_equal(d.data, _x(k))


def test_stream_out_copy_of_a_buffer_is_a_snapshot(worlds):
    """A memory operand put on the stream-out port is copied: a later
    write to the buffer does not reach the entry."""
    _, cw = worlds
    a0 = cw[0]
    b = a0.buffer(data=torch.from_numpy(_x(3).copy()), device_resident=True)
    a0.copy(b, None, N, stream_flags=StreamFlags.RES_STREAM)
    b.tensor.fill_(0.0)
    np.testing.assert_array_equal(_np(a0.stream_pop(5.0)), _x(3))


def test_wide_payloads_stay_exact_and_local(worlds):
    """64-bit payloads: streamed copy and combine keep every bit; a
    streamed 64-bit send is refused with STREAM_NOT_SUPPORTED before the
    stream is consumed (as the reference refuses to carry it between
    devices), and the data stays for the local path."""
    _, cw = worlds
    a0 = cw[0]
    big = np.array([2 ** 53 + 1, -7, 2 ** 62, 5, 0, 1, 2, 3], np.int64)
    a0.stream_push(big)
    a0.copy(None, None, N, stream_dtype=np.int64,
            stream_flags=StreamFlags.OP0_STREAM | StreamFlags.RES_STREAM)
    got = _np(a0.stream_pop(5.0))
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, big)
    a0.stream_push(big)
    res = a0.buffer((N,), torch.int64)
    a0.combine(N, ReduceFunc.SUM, None,
               a0.buffer(data=torch.ones(N, dtype=torch.int64)), res,
               stream_dtype=np.int64, stream_flags=StreamFlags.OP0_STREAM)
    np.testing.assert_array_equal(res.data, big + 1)
    a0.stream_push(big)
    with pytest.raises(ACCLError) as ei:
        a0.send(None, N, dst=1, stream_dtype=np.int64,
                stream_flags=StreamFlags.OP0_STREAM)
    assert ei.value.error_word == int(ErrorCode.STREAM_NOT_SUPPORTED)
    a0.copy(None, None, N, stream_dtype=np.int64,
            stream_flags=StreamFlags.OP0_STREAM | StreamFlags.RES_STREAM)
    np.testing.assert_array_equal(_np(a0.stream_pop(5.0)), big)


def test_stalled_stream_times_out_and_consumes_nothing(worlds):
    _, cw = worlds
    a0 = cw[0]
    a0.set_timeout(0.3)
    try:
        a0.stream_push(_x(1)[: N // 2])
        with pytest.raises(ACCLError) as ei:
            a0.copy(None, a0.buffer((N,), torch.float32), N,
                    stream_flags=StreamFlags.OP0_STREAM)
        assert ei.value.error_word == int(ErrorCode.KRNL_TIMEOUT_STS_ERROR)
        a0.stream_push(_x(1)[N // 2:])
        dst = a0.buffer((N,), torch.float32)
        a0.copy(None, dst, N, stream_flags=StreamFlags.OP0_STREAM)
        np.testing.assert_array_equal(dst.data, _x(1))
    finally:
        a0.set_timeout(30.0)


def test_pop_whole_entry_and_empty_port(worlds):
    """``stream_pop(count=None)`` returns the next entry whole; an empty
    port raises IndexError once the timeout passes."""
    _, cw = worlds
    a0 = cw[0]
    a0.copy(a0.buffer(data=torch.arange(5.0)), None, 5,
            stream_flags=StreamFlags.RES_STREAM)
    a0.copy(a0.buffer(data=torch.arange(3.0)), None, 3,
            stream_flags=StreamFlags.RES_STREAM)
    np.testing.assert_array_equal(_np(a0.stream_pop(1.0)), np.arange(5.0))
    np.testing.assert_array_equal(_np(a0.stream_pop(1.0, count=None)),
                                  np.arange(3.0))
    with pytest.raises(IndexError):
        a0.stream_pop(0.05)


def _put_beside_send(side):
    """A parked send, then a stream_put to the same rank: the recv gets
    the send's payload (the put bypasses the matching and takes no place
    in it); the put lands on the stream-in port."""
    def fn(a):
        if a.rank == 2:
            a.send(side.buf(a, _x(1)), N, dst=3, tag=9)
            a.stream_put(side.buf(a, _x(2)), N, dst=3, tag=9)
            a.send(side.buf(a, _x(3)), N, dst=3, tag=9)
        elif a.rank == 3:
            got = []
            for _ in range(2):
                d = side.buf(a)
                a.recv(d, N, src=2, tag=9)
                got.append(_np(d.data))
            s = side.buf(a)
            a.copy(None, s, N, stream_flags=side.SF.OP0_STREAM)
            return got[0], got[1], _np(s.data)
        return None
    return fn


def test_stream_put_takes_no_place_in_the_matching(worlds):
    tw, cw = worlds
    ref = j_run_ranks(tw, _put_beside_send(Side(True)))[3]
    got = run_ranks(cw, _put_beside_send(Side(False)))[3]
    for g, r, k in zip(got, ref, (1, 3, 2)):
        np.testing.assert_array_equal(g, r)
        np.testing.assert_array_equal(g, _x(k))


def test_soft_reset_drains_the_ports(worlds):
    _, cw = worlds
    a0 = cw[0]
    a0.stream_push(_x(9))
    a0.copy(a0.buffer(data=torch.from_numpy(_x(9))), None, N,
            stream_flags=StreamFlags.RES_STREAM)
    a0.soft_reset()
    with pytest.raises(IndexError):
        a0.stream_pop(0.05)
    a0.set_timeout(0.1)
    try:
        with pytest.raises(ACCLError):
            a0.copy(None, a0.buffer((N,), torch.float32), N,
                    stream_flags=StreamFlags.OP0_STREAM)
    finally:
        a0.set_timeout(30.0)


def test_streamed_collective_is_refused(worlds):
    """A streamed operand of a collective belongs inside its program: the
    device refuses it with STREAM_NOT_SUPPORTED, on the reference's tier
    as on the port's; the memory path still works on the same world."""
    tw, cw = worlds
    for accls, op, flags in ((tw, JCCLOp.allreduce, JSF),
                             (cw, CCLOp.allreduce, StreamFlags)):
        a0 = accls[0]
        port = accls is cw
        src = (a0.buffer(data=torch.from_numpy(_x(4))) if port
               else a0.buffer(data=_x(4)))
        res = (a0.buffer((N,), torch.float32) if port
               else a0.buffer((N,), np.float32))
        desc = a0._prepare(op, count=N, comm=a0.comm, op0=src, res=res)
        desc.stream_flags = flags.OP0_STREAM
        with pytest.raises(Exception) as ei:
            a0.device.call_sync(desc, timeout=5.0)
        assert ei.value.error_word == int(ErrorCode.STREAM_NOT_SUPPORTED)

    def fn(acc):
        s = acc.buffer(data=torch.from_numpy(_x(4)))
        d = acc.buffer((N,), torch.float32)
        acc.allreduce(s, d, N)
        return d.data.copy()

    for out in run_ranks(cw, fn):
        np.testing.assert_array_equal(out, W * _x(4))
