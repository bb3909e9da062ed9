"""The port's call contract and membership against the reference's, on
the CPU.

``cuda_world(4, device="cpu")`` against ``tpu_world(4, platform="cpu")``
(the reference's device tier): split communicators and concurrent
world / sub-comm / p2p traffic, the comm ids of split, shrink and grow,
the revoked refusal and the argument errors word for word, ``chain=``.
Against ``emu_world(2)``: a revoke aborting a call in flight (the
device tier's ``abort_comm`` is a no-op; the port follows the
emulator's, ROADMAP §C) and the retry loop's error words. ``RetryPolicy``
against the reference's, bit for bit.
"""

from __future__ import annotations

import time
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from accl_tpu.constants import ACCLError as JACCLError  # noqa: E402
from accl_tpu.constants import ErrorCode as JErrorCode  # noqa: E402
from accl_tpu.device.tpu import tpu_world  # noqa: E402
from accl_tpu.retry import RetryPolicy as JRetryPolicy  # noqa: E402
from accl_tpu.retry import resolve_policy as j_resolve  # noqa: E402
from accl_tpu.testing import emu_world  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu_torch import (ACCLError, ErrorCode, Rank,  # noqa: E402
                            cuda_world)
from accl_tpu_torch.retry import (DEFAULT_RETRYABLE,  # noqa: E402
                                  RetryPolicy, mix_unit, resolve_policy)
from accl_tpu_torch.testing import run_ranks  # noqa: E402
from accl_tpu_torch.tracing import METRICS  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep: the port creates no shm
    segment."""
    yield


W = 4


@pytest.fixture(scope="module")
def worlds():
    tw = tpu_world(W, platform="cpu")
    cw = cuda_world(W, device="cpu")
    yield tw, cw
    for a in tw + cw:
        a.deinit()


def both(worlds, fn):
    tw, cw = worlds
    return j_run_ranks(tw, lambda a: fn(a, True)), \
        run_ranks(cw, lambda a: fn(a, False))


def buf(a, jax_side: bool, x: np.ndarray):
    return a.buffer(data=x.copy() if jax_side else torch.from_numpy(x.copy()))


def empty(a, jax_side: bool, n: int):
    return a.buffer((n,), np.float32 if jax_side else torch.float32)


def _message(fn) -> str:
    with pytest.raises((ValueError, ACCLError, JACCLError)) as ei:
        fn()
    return str(ei.value)


# -- split communicators (test_tpu_device.py:218-347) --------------------------

def test_split_comm_allreduce_matches_reference(worlds):
    def fn(a, jax_side):
        if a.rank in (1, 2, 3):
            sub = a.split_communicator([1, 2, 3])
            src = buf(a, jax_side, np.full(8, float(a.rank), np.float32))
            dst = empty(a, jax_side, 8)
            a.allreduce(src, dst, 8, comm=sub)
            return sub.comm_id, float(dst.data[0])
        return None

    ref, got = both(worlds, fn)
    assert got == ref
    assert got[1][1] == 6.0 and got[0] is None


def test_concurrent_world_subcomm_and_p2p(worlds):
    """World and disjoint sub-communicator collectives and p2p in flight
    at once never cross-match (the rendezvous keys on (comm, index))."""
    half = W // 2

    def fn(a, jax_side):
        r = a.rank
        sub = a.split_communicator(list(range(half)) if r < half
                                   else list(range(half, W)))
        seen = []
        for it in range(6):
            n = 32
            d = empty(a, jax_side, n)
            h1 = a.allreduce(buf(a, jax_side, np.full(n, r + 1.0,
                                                      np.float32)),
                             d, n, run_async=True)
            d2 = empty(a, jax_side, n)
            h2 = a.allreduce(buf(a, jax_side, np.full(n, 10.0 + r,
                                                      np.float32)),
                             d2, n, comm=sub, run_async=True)
            dst = empty(a, jax_side, n)
            hs = a.send(buf(a, jax_side, np.full(n, 100.0 + r, np.float32)),
                        n, dst=(r + 1) % W, tag=it, run_async=True)
            hr = a.recv(dst, n, src=(r - 1) % W, tag=it, run_async=True)
            for h in (h1, h2, hs, hr):
                h.wait(60)
            seen.append((float(d.data[0]), float(d2.data[0]),
                         float(dst.data[0])))
        return seen

    ref, got = both(worlds, fn)
    assert got == ref
    assert got[0][0] == (10.0, 21.0, 103.0)


def test_comm_ids_of_split_shrink_and_grow_match_reference(worlds):
    """The ids derive from the membership and key by the reference's
    crc32, so both packages agree on every one: a split with and without
    a key, the survivors of a shrink, and the comm grown back by a
    joiner that passes ``base_members``."""
    def fn(a, jax_side):
        ids = [a.comm.comm_id]
        if a.rank in (0, 2, 3):
            ids.append(a.split_communicator([0, 2, 3]).comm_id)
            ids.append(a.split_communicator([0, 2, 3], key=9).comm_id)
        if a.rank != 1:
            sub = a.shrink_communicator([1])
            ids.append(sub.comm_id)
            grown = a.grow_communicator([1], comm=sub, key=21)
        else:
            grown = a.grow_communicator([1], base_members=[0, 2, 3],
                                        key=21)
        ids.append(grown.comm_id)
        ids.append([r.global_rank for r in grown.ranks])
        ids.append(a.comm_of(grown.comm_id) is grown)
        return ids

    ref, got = both(worlds, fn)
    assert got == ref


def test_grow_back_to_the_world_reconfigures_it(worlds):
    """Shrink away rank 3, then grow back: the grown membership is the
    world's, so it takes the world's comm id; it replaces the revoked
    world object in the registry and carries collectives again."""
    _, cw = worlds
    subs, grown = {}, {}

    def shrink(a):
        if a.rank != 3:
            a.revoke()
            subs[a.rank] = a.shrink_communicator([3])
            d = a.buffer((4,), torch.float32)
            a.allreduce(a.buffer(data=torch.ones(4)), d, 4,
                        comm=subs[a.rank])
            return float(d.data[0])

    assert run_ranks(cw, shrink)[:3] == [3.0] * 3

    def grow(a):
        if a.rank == 3:
            grown[3] = a.grow_communicator([3], base_members=[0, 1, 2])
        else:
            grown[a.rank] = a.grow_communicator([3], comm=subs[a.rank])
        assert grown[a.rank].comm_id == a.comm.comm_id
        assert a.comm is grown[a.rank] and not a.comm.revoked
        d = a.buffer((4,), torch.float32)
        a.allreduce(a.buffer(data=torch.ones(4)), d, 4)
        return float(d.data[0])

    assert run_ranks(cw, grow) == [4.0] * W
    snap = METRICS.snapshot()["counters"]
    assert sum(snap["membership_grow_total"].values()) >= W
    assert sum(snap["membership_shrink_total"].values()) >= 3


# -- refusals, word for word ----------------------------------------------------

def test_revoked_refusal_matches_reference():
    tw = tpu_world(2, platform="cpu")
    cw = cuda_world(2, device="cpu")
    try:
        msgs = []
        for a, jax_side in ((tw[0], True), (cw[0], False)):
            sub = a.split_communicator([0], key=3)
            a.revoke(sub)
            src = buf(a, jax_side, np.ones(4, np.float32))
            dst = empty(a, jax_side, 4)
            with pytest.raises((ACCLError, JACCLError)) as ei:
                a.allreduce(src, dst, 4, comm=sub)
            msgs.append((str(ei.value), ei.value.error_word))
            with pytest.raises((ACCLError, JACCLError)) as ei:
                a.send(src, 4, 0, comm=sub, run_async=True)
            msgs.append((str(ei.value), ei.value.error_word))
        assert msgs[:2] == msgs[2:]
        assert msgs[0][1] == int(ErrorCode.PEER_FAILED)
    finally:
        for a in tw + cw:
            a.deinit()


def test_shrink_and_grow_argument_errors_match_reference(worlds):
    tw, cw = worlds
    a, b = tw[0], cw[0]
    cases = [
        lambda x: x.shrink_communicator([0]),
        lambda x: x.shrink_communicator([7]),
        lambda x: x.grow_communicator([0, 1]),
        lambda x: x.grow_communicator([1], comm=x.comm,
                                      base_members=[0, 1]),
        lambda x: x.grow_communicator([5], base_members=[1, 5]),
    ]
    for case in cases:
        assert _message(lambda: case(b)) == _message(lambda: case(a))
    with pytest.raises(ValueError, match="explicit global ranks"):
        b.grow_communicator([Rank(global_rank=-1)], base_members=[0, 1])


def test_dump_communicator_names_every_member(worlds):
    _, cw = worlds
    text = cw[2].dump_communicator()
    assert text.splitlines()[0].startswith(
        f"Communicator {cw[2].comm.comm_id}: size={W} local_rank=2")
    assert len(text.splitlines()) == W + 1
    with pytest.raises(KeyError):
        cw[0].comm_of(12345)


# -- revoke aborts calls in flight -------------------------------------------------

def _inflight_abort(a, buf_of):
    dst = buf_of(a)
    t0 = time.monotonic()
    h = a.recv(dst, 64, src=0, tag=77, run_async=True)   # nothing is sent
    time.sleep(0.2)
    assert not h.done()
    a.revoke()
    with pytest.raises((ACCLError, JACCLError)) as ei:
        h.wait(6.0)
    elapsed = time.monotonic() - t0
    with pytest.raises((ACCLError, JACCLError)) as ei2:
        a.recv(dst, 64, src=0, tag=78)
    return ei.value.error_word, ei2.value.error_word, elapsed


def test_revoke_aborts_inflight_recv_like_emulator():
    """An async recv in flight when its comm is revoked fails with
    PEER_FAILED at once, on both tiers (well under the 8 s deadline);
    the next call refuses typed."""
    ew = emu_world(2, timeout=8.0)
    cw = cuda_world(2, device="cpu", timeout=8.0)
    try:
        ref = _inflight_abort(ew[1], lambda a: a.buffer((64,), np.float32))
        got = _inflight_abort(cw[1],
                              lambda a: a.buffer((64,), torch.float32))
    finally:
        for a in ew + cw:
            a.deinit()
    assert got[:2] == ref[:2] == (int(ErrorCode.PEER_FAILED),) * 2
    assert got[2] < 1.5


def test_revoke_fails_a_parked_collective_deposit():
    """A rank's collective deposit parked for its peers fails with
    PEER_FAILED when that rank revokes the comm."""
    cw = cuda_world(2, device="cpu", timeout=8.0)
    try:
        a = cw[0]
        d = a.buffer((4,), torch.float32)
        h = a.allreduce(a.buffer(data=torch.ones(4)), d, 4, run_async=True)
        time.sleep(0.1)
        assert not h.done()
        t0 = time.monotonic()
        a.revoke()
        with pytest.raises(ACCLError) as ei:
            h.wait(6.0)
        assert ei.value.error_word == int(ErrorCode.PEER_FAILED)
        assert time.monotonic() - t0 < 1.0
    finally:
        for a in cw:
            a.deinit()


# -- chain= ------------------------------------------------------------------------

def test_chain_is_admitted_and_changes_no_result(worlds):
    """``chain=True`` on async calls changes no result (the device tier
    never reads it; the hint reaches the descriptor)."""
    def fn(a, jax_side):
        r = a.rank
        out = []
        for chain in (False, True):
            dst = empty(a, jax_side, 16)
            hs = a.send(buf(a, jax_side, np.arange(16, dtype=np.float32)
                            + r), 16, dst=(r + 1) % W, tag=3,
                        run_async=True, chain=chain)
            hr = a.recv(dst, 16, src=(r - 1) % W, tag=3, run_async=True,
                        chain=chain)
            hs.wait(30)
            hr.wait(30)
            d2 = empty(a, jax_side, 16)
            a.allreduce(dst, d2, 16, run_async=True, chain=chain).wait(30)
            out.append(np.asarray(d2.data).tolist())
        return out

    ref, got = both(worlds, fn)
    assert got == ref
    assert got[0][0] == got[0][1]


# -- RetryPolicy ------------------------------------------------------------------

def test_backoff_is_the_reference_bit_for_bit():
    ids = np.random.default_rng(5).integers(0, 2 ** 32, 16).tolist()
    for kw in ({}, {"jitter": 0.0}, {"backoff_s": 0.01, "backoff_mult": 3.0,
                                     "backoff_max_s": 0.5, "jitter": 0.4}):
        mine, ref = RetryPolicy(retries=9, **kw), JRetryPolicy(retries=9,
                                                               **kw)
        for cid in ids:
            for attempt in range(6):
                assert mine.backoff(attempt, cid) \
                    == ref.backoff(attempt, cid)
    from accl_tpu.emulator.reliability import mix_unit as j_mix_unit
    for parts in ((0,), (1, 2, 3), (2 ** 63, 7, 0x52E7)):
        assert mix_unit(*parts) == j_mix_unit(*parts)


def test_should_retry_over_every_error_bit():
    for unknown in (False, True):
        mine = RetryPolicy(retries=2, retry_unknown=unknown)
        ref = JRetryPolicy(retries=2, retry_unknown=unknown)
        assert mine.retryable == ref.retryable == DEFAULT_RETRYABLE
        words = [int(e) for e in JErrorCode if int(e)]
        words += [words[i] | words[j] for i in range(len(words))
                  for j in range(i)]
        for w in words:
            for attempt in range(3):
                assert mine.should_retry(w, attempt) \
                    == ref.should_retry(w, attempt), (hex(w), attempt)


def test_resolve_policy_precedence():
    base = RetryPolicy(retries=1, backoff_s=0.2)
    jbase = JRetryPolicy(retries=1, backoff_s=0.2)
    assert resolve_policy(None, None, None) is None
    assert resolve_policy(None, None, base) is base
    assert resolve_policy(3, None, base) == RetryPolicy(retries=3,
                                                        backoff_s=0.2)
    assert resolve_policy(3, None, None) == RetryPolicy(retries=3)
    assert resolve_policy(3, base, None) is base
    assert j_resolve(3, None, jbase).retries == 3


def _late_send(a, retries, run_async, delay, jax_side):
    """Rank 1 posts a recv with a 0.2 s deadline before rank 0 sends
    (``delay`` later); returns rank 1's outcome and data."""
    if a.rank == 0:
        time.sleep(delay)
        a.send(buf(a, jax_side, np.arange(4, dtype=np.float32)), 4, dst=1,
               tag=5)
        return None
    if a.rank != 1:
        return None
    a.set_timeout(0.2)
    try:
        dst = empty(a, jax_side, 4)
        try:
            h = a.recv(dst, 4, src=0, tag=5, retries=retries,
                       run_async=run_async)
            h.wait(10)
        except (ACCLError, JACCLError) as exc:
            return exc.error_word, None
        return 0, np.asarray(dst.data).tolist()
    finally:
        a.set_timeout(30.0)


def _retries_of(snapshot, before) -> int:
    c = snapshot["counters"].get("call_retries_total", {})
    b = before["counters"].get("call_retries_total", {})
    return sum(c.values()) - sum(b.values())


@pytest.mark.parametrize("run_async", [False, True])
def test_retry_outlasts_a_late_sender(worlds, run_async):
    """With ``retries=3`` a recv whose peer sends after its first
    deadline succeeds and counts a retry, as on the reference's device
    tier, whose parked send the retried recv matches (the emulator tier
    moves a retry to a fresh sequence epoch, which the late send does not
    reach); with ``retries=0`` it fails with RECEIVE_TIMEOUT_ERROR."""
    tw, cw = worlds
    # the send comes 0.3 s after a recv with a 0.2 s deadline, or 0.6 s
    # where the recv must fail (a margin for a loaded machine)
    for retries, want, delay in (
            (3, 0, 0.3), (0, int(ErrorCode.RECEIVE_TIMEOUT_ERROR), 0.6)):
        before = METRICS.snapshot()
        got = run_ranks(cw, lambda a: _late_send(a, retries, run_async,
                                                 delay, False))[1]
        n_port = _retries_of(METRICS.snapshot(), before)
        ref = j_run_ranks(tw, lambda a: _late_send(a, retries, run_async,
                                                   delay, True))[1]
        assert got[0] == ref[0] == want
        if not want:
            assert got[1] == ref[1] == [0.0, 1.0, 2.0, 3.0]
            assert n_port >= 1
        else:
            assert n_port == 0
        # the late send of the failed case stays parked: drop it
        run_ranks(cw, lambda a: a.soft_reset())
        j_run_ranks(tw, lambda a: a.soft_reset())


@pytest.mark.parametrize("run_async", [False, True])
def test_retries_exhausted_is_flagged(run_async):
    """A peer that never sends: once the attempts are spent the word
    carries CALL_RETRIES_EXHAUSTED beside the timeout, on both tiers."""
    ew, cw = emu_world(2), cuda_world(2, device="cpu")
    pol = dict(retries=2, backoff_s=0.01)
    try:
        words = []
        for a, jax_side, P in ((cw[1], False, RetryPolicy),
                               (ew[1], True, JRetryPolicy)):
            a.set_timeout(0.1)
            dst = empty(a, jax_side, 4)
            with pytest.raises((ACCLError, JACCLError)) as ei:
                a.recv(dst, 4, src=0, tag=9, retry_policy=P(**pol),
                       run_async=run_async).wait(10)
            words.append(ei.value.error_word)
        assert words[0] == words[1] == (
            int(ErrorCode.RECEIVE_TIMEOUT_ERROR)
            | int(ErrorCode.CALL_RETRIES_EXHAUSTED))
    finally:
        for a in ew + cw:
            a.deinit()


def test_driver_default_policy_applies_to_every_call():
    """``cuda_world(retry_policy=)`` is every driver's default; a
    per-call ``retries=0`` overrides it."""
    cw = cuda_world(2, device="cpu",
                    retry_policy=RetryPolicy(retries=3, backoff_s=0.05))
    try:
        out = run_ranks(cw, lambda a: _late_send(a, None, False, 0.3,
                                                 False))
        assert out[1] == (0, [0.0, 1.0, 2.0, 3.0])
        out = run_ranks(cw, lambda a: _late_send(a, 0, False, 0.6, False))
        assert out[1][0] == int(ErrorCode.RECEIVE_TIMEOUT_ERROR)
    finally:
        for a in cw:
            a.deinit()


def test_join_handshake_runs_under_the_policy():
    """A handshake that fails with JOIN_FAILED is retried under the
    policy; once the policy gives up the grown comm is revoked and the
    error raises."""
    cw = cuda_world(3, device="cpu")
    try:
        a = cw[2]
        fails = {"left": 2}
        real = a.device.join_handshake

        def flaky(comm, timeout):
            if fails["left"]:
                fails["left"] -= 1
                return int(ErrorCode.JOIN_FAILED)
            return real(comm, timeout)

        a.device.join_handshake = flaky
        sub = a.split_communicator([2], key=1)
        g = a.grow_communicator([1], comm=sub, key=4,
                                retry_policy=RetryPolicy(retries=3,
                                                         backoff_s=0.01))
        assert [r.global_rank for r in g.ranks] == [1, 2]
        fails["left"] = 5
        with pytest.raises(ACCLError) as ei:
            a.grow_communicator([0], comm=sub, key=4, retries=1)
        assert ei.value.error_word == int(ErrorCode.JOIN_FAILED)
        # the failed comm was never registered
        with pytest.raises(KeyError):
            a.comm_of(zlib.crc32(b"0,2#4"))
    finally:
        for a in cw:
            a.deinit()
