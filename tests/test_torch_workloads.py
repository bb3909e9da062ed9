"""The port's host workloads against the reference's, on the CPU: MoE
dispatch and combine on ``alltoallv`` and ring attention with chained
recvs, on ``cuda_world(4, device="cpu")``, against the reference's
oracles (``moe_reference``, ``ring_attention_reference``) and the
reference workloads on ``emu_world(4)``; the ``OverlapMeter`` ledger.

Tolerances: the experts' f32 matmuls and the ring's float64 folds sum in
another order than numpy's, so the outputs agree within rtol 1e-5, atol
1e-6 (the reference test's); the values the dispatch leg lands are
bitwise the emulator's.
"""

from __future__ import annotations

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

from accl_tpu.testing import emu_world  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu.workloads import moe as j_moe  # noqa: E402
from accl_tpu.workloads import ring_attention as j_ring  # noqa: E402
from accl_tpu_torch import cuda_world  # noqa: E402
from accl_tpu_torch.testing import run_ranks  # noqa: E402
from accl_tpu_torch.tracing import METRICS  # noqa: E402
from accl_tpu_torch.workloads import OverlapMeter  # noqa: E402
from accl_tpu_torch.workloads.moe import (default_expert,  # noqa: E402
                                          moe_dispatch_combine,
                                          moe_reference)
from accl_tpu_torch.workloads.ring_attention import (  # noqa: E402
    ring_attention_forward, ring_attention_reference)


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep: the port creates no shm
    segment."""
    yield


W = 4
RTOL, ATOL = 1e-5, 1e-6
F8 = np.dtype(ml_dtypes.float8_e4m3fn)


@pytest.fixture(scope="module")
def cw():
    world = cuda_world(W, device="cpu")
    yield world
    for a in world:
        a.deinit()


@pytest.fixture(scope="module")
def ew():
    world = emu_world(W, timeout=30.0, nbufs=64)
    yield world
    for a in world:
        a.deinit()


def t(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x))


# -- MoE ---------------------------------------------------------------------------

def moe_inputs(seed: int, T: int, D: int, p=(0.55, 0.25, 0.15, 0.05)):
    rng = np.random.default_rng(seed)
    toks = [rng.standard_normal((T, D)).astype(np.float32)
            for _ in range(W)]
    dest = [rng.choice(W, size=T, p=np.roll(p, r)) for r in range(W)]
    return toks, dest


def run_moe(cw, ew, toks, dest, **kw):
    def port(a):
        out, stats = moe_dispatch_combine(a, t(toks[a.rank]), dest[a.rank],
                                          **kw)
        return out.numpy(), stats

    def ref(a):
        jkw = dict(kw)
        if jkw.get("compress_dtype") is not None:
            jkw["compress_dtype"] = F8
        return j_moe.moe_dispatch_combine(a, toks[a.rank], dest[a.rank],
                                          **jkw)

    return run_ranks(cw, port), j_run_ranks(ew, ref)


def test_default_expert_is_the_reference_expert():
    """Same numpy generator, same weights: the f32 expert agrees with
    the reference's within the matmul's summation order."""
    x = np.random.default_rng(1).standard_normal((5, 16)).astype(np.float32)
    for r in range(W):
        got = default_expert(r, 16, "cpu")(t(x)).numpy()
        np.testing.assert_allclose(got, j_moe.default_expert(r, 16)(x),
                                   rtol=RTOL, atol=ATOL)
        f = default_expert(r, 16, "cpu", dtype=torch.float64)
        assert f.weight.dtype == torch.float64
        assert np.array_equal(f.weight.float().numpy(),
                              default_expert(r, 16, "cpu").weight.numpy())


def test_default_expert_defaults_to_the_card():
    """The expert's weights go to the card unless the caller names
    another device: without CUDA the default raises instead of running
    on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises((RuntimeError, AssertionError), match="CUDA|cuda"):
        default_expert(0, 16)


@pytest.mark.parametrize("n_chunks", [1, 2, 3])
@pytest.mark.parametrize("overlap", [True, False])
def test_moe_matches_reference(cw, ew, n_chunks, overlap):
    """Skewed routing in chunks: the outputs land in the original token
    order and agree with the port's oracle (float64 experts), the
    reference's oracle and the reference workload; the count vectors
    are the reference's."""
    T, D = 48, 8
    toks, dest = moe_inputs(7, T, D)
    got, ref = run_moe(cw, ew, toks, dest, n_chunks=n_chunks,
                       overlap=overlap)
    f64 = [default_expert(r, D, "cpu", dtype=torch.float64)
           for r in range(W)]
    oracle = moe_reference([t(x) for x in toks], dest, f64)
    j_oracle = j_moe.moe_reference(
        toks, dest, [j_moe.default_expert(r, D) for r in range(W)])
    for r in range(W):
        out, stats = got[r]
        assert stats["tokens"] == T and stats["steps"] == n_chunks
        for key in ("send_counts", "recv_counts", "recv_tokens"):
            assert stats[key] == ref[r][1][key]
        np.testing.assert_allclose(out, oracle[r].numpy(), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(out, j_oracle[r], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out, ref[r][0], rtol=RTOL, atol=ATOL)


def test_moe_routing_collapse(cw, ew):
    """Every rank routes every token to rank 0: the other entries of the
    vectors are zero, rank 0 computes everything, and the combine still
    un-permutes."""
    T, D = 20, 6
    rng = np.random.default_rng(9)
    toks = [rng.standard_normal((T, D)).astype(np.float32)
            for _ in range(W)]
    dest = [np.zeros(T, np.int64) for _ in range(W)]
    got, ref = run_moe(cw, ew, toks, dest, n_chunks=3)
    j_oracle = j_moe.moe_reference(
        toks, dest, [j_moe.default_expert(r, D) for r in range(W)])
    for r in range(W):
        assert got[r][1]["recv_tokens"] == (W * T if r == 0 else 0)
        np.testing.assert_allclose(got[r][0], j_oracle[r], rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(got[r][0], ref[r][0], rtol=RTOL,
                                   atol=ATOL)


def test_moe_fp8_dispatch_lands_the_emulators_values(cw, ew):
    """The dispatch leg on the fp8-e4m3 block-scaled wire: an identity
    expert returns what landed, which is bitwise the emulator tier's
    (each chunk one message, below one segment); the end-to-end error
    of the default expert stays within the bound the expert's
    Lipschitz constant gives (|dy| <= sum_i |dx_i| |W_ij|, |dx_i| <=
    2^-4 |x_i| + 2^-10 amax/448)."""
    T, D = 32, 128
    toks, dest = moe_inputs(13, T, D)
    kw = dict(n_chunks=2, compress_dtype=torch.float8_e4m3fn,
              block_scale=128)
    got = run_ranks(cw, lambda a: moe_dispatch_combine(
        a, t(toks[a.rank]), dest[a.rank], expert_fn=lambda x: x,
        **kw)[0].numpy())
    ref = j_run_ranks(ew, lambda a: j_moe.moe_dispatch_combine(
        a, toks[a.rank], dest[a.rank], expert_fn=lambda x: x,
        n_chunks=2, compress_dtype=F8, block_scale=128)[0])
    for r in range(W):
        assert got[r].tobytes() == ref[r].tobytes()
    out = run_ranks(cw, lambda a: moe_dispatch_combine(
        a, t(toks[a.rank]), dest[a.rank], **kw)[0].numpy())
    f64 = [default_expert(r, D, "cpu", dtype=torch.float64)
           for r in range(W)]
    oracle = moe_reference([t(x) for x in toks], dest, f64)
    for r in range(W):
        x = toks[r].astype(np.float64)
        dx = 2.0 ** -4 * np.abs(x) + 2.0 ** -10 * np.abs(x).max(
            axis=1, keepdims=True) / 448.0
        bound = np.empty_like(x)
        for p in range(W):
            sel = dest[r] == p
            bound[sel] = dx[sel] @ np.abs(f64[p].weight.numpy())
        err = np.abs(out[r] - oracle[r].numpy())
        assert np.all(err <= bound + 1e-5), float((err / bound).max())


def test_moe_rejects_bad_dest(cw):
    toks = torch.zeros((4, 2))
    with pytest.raises(ValueError, match="out of range"):
        run_ranks(cw, lambda a: moe_dispatch_combine(
            a, toks, np.array([0, 1, 5, 0])))
    with pytest.raises(ValueError, match="one rank per token"):
        run_ranks(cw, lambda a: moe_dispatch_combine(
            a, toks, np.array([0, 1])))
    with pytest.raises(ValueError, match=r"\(T, d\)"):
        run_ranks(cw, lambda a: moe_dispatch_combine(
            a, torch.zeros(4), np.array([0, 1, 1, 0])))


# -- ring attention ------------------------------------------------------------------

def ring_inputs(seed: int, L: int, D: int):
    rng = np.random.default_rng(seed)
    return [[rng.standard_normal((L, D)).astype(np.float32)
             for _ in range(W)] for _ in range(3)]


@pytest.mark.parametrize("overlap,chain", [(True, True), (False, True),
                                           (True, False)])
def test_ring_attention_matches_reference(cw, ew, overlap, chain):
    """Blocks arrive in ring order and fold online in float64: the
    result agrees with softmax over the whole sequence (the port's and
    the reference's oracles) and with the reference workload."""
    L, D = 24, 16
    q, k, v = ring_inputs(3, L, D)
    K, V = np.concatenate(k), np.concatenate(v)
    got = run_ranks(cw, lambda a: ring_attention_forward(
        a, t(q[a.rank]), t(k[a.rank]), t(v[a.rank]), overlap=overlap,
        use_chain=chain))
    ref = j_run_ranks(ew, lambda a: j_ring.ring_attention_forward(
        a, q[a.rank], k[a.rank], v[a.rank], overlap=overlap,
        use_chain=chain)[0])
    for r in range(W):
        out, stats = got[r]
        assert stats["steps"] == W
        mine = ring_attention_reference(t(q[r]), t(K), t(V)).numpy()
        golden = j_ring.ring_attention_reference(q[r], K, V)
        np.testing.assert_allclose(mine, golden, rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(out.numpy(), golden, rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(out.numpy(), ref[r], rtol=RTOL,
                                   atol=ATOL)


def test_ring_attention_block_scaled_rotation(cw, ew):
    """The rotation on the fp8-e4m3 block-128 wire (B5 and B6 on the
    card): every hop requantizes the K/V it forwards, as on the
    emulator tier, so the folds see the emulator's blocks and agree with
    its result within the fold's tolerance."""
    L, D = 16, 64
    q, k, v = ring_inputs(5, L, D)
    got = run_ranks(cw, lambda a: ring_attention_forward(
        a, t(q[a.rank]), t(k[a.rank]), t(v[a.rank]),
        compress_dtype=torch.float8_e4m3fn, block_scale=128)[0].numpy())
    ref = j_run_ranks(ew, lambda a: j_ring.ring_attention_forward(
        a, q[a.rank], k[a.rank], v[a.rank], compress_dtype=F8,
        block_scale=128)[0])
    golden = [j_ring.ring_attention_reference(
        q[r], np.concatenate(k), np.concatenate(v)) for r in range(W)]
    for r in range(W):
        np.testing.assert_allclose(got[r], ref[r], rtol=RTOL, atol=ATOL)
        rel = np.linalg.norm(got[r] - golden[r]) / np.linalg.norm(golden[r])
        assert rel < 2.0 ** -3


def test_ring_attention_single_rank_and_bad_shapes():
    one = cuda_world(1, device="cpu")
    try:
        rng = np.random.default_rng(4)
        q, k, v = (rng.standard_normal((8, 4)).astype(np.float32)
                   for _ in range(3))
        out, stats = ring_attention_forward(one[0], t(q), t(k), t(v))
        np.testing.assert_allclose(out.numpy(),
                                   j_ring.ring_attention_reference(q, k, v),
                                   rtol=RTOL, atol=ATOL)
        assert stats["steps"] == 1 and stats["overlap_frac"] == 1.0
        with pytest.raises(ValueError, match="block_len"):
            ring_attention_forward(one[0], torch.zeros(4, 8),
                                   torch.zeros(4, 6), torch.zeros(4, 6))
    finally:
        one[0].deinit()


# -- the meter ---------------------------------------------------------------------

class _FakeHandle:
    def __init__(self):
        self._cbs = []

    def add_done_callback(self, cb):
        self._cbs.append(cb)

    def complete(self):
        for cb in self._cbs:
            cb(0)

    def wait(self):
        self.complete()


def test_overlap_meter_hidden_vs_exposed():
    """A handle that retires before the wait is hidden (near 1); a wait
    that blocks for the whole span is exposed (near 0); none issued is
    1."""
    assert OverlapMeter().overlap_frac == 1.0
    m = OverlapMeter()
    h = _FakeHandle()
    m.issue(h)
    time.sleep(0.02)
    h.complete()
    m.wait(h)
    assert m.overlap_frac > 0.9

    m2 = OverlapMeter()
    h2 = _FakeHandle()
    m2.issue(h2)

    def slow_wait():
        time.sleep(0.02)
        h2.complete()
    h2.wait = slow_wait
    m2.wait(h2)
    assert m2.overlap_frac < 0.3


def test_overlap_meter_publishes_metrics():
    stats = OverlapMeter().publish(rank=0, workload="unit-port", steps=5)
    assert stats["overlap_frac"] == 1.0 and stats["steps"] == 5
    snap = METRICS.snapshot()
    assert snap["gauges"]["workload_overlap_frac"][
        "rank=0,workload=unit-port"] == 1.0
    assert snap["counters"]["workload_steps_total"][
        "rank=0,workload=unit-port"] == 5


def test_a_real_handle_feeds_the_meter(cw):
    """``add_done_callback`` on a real handle: the meter sees the
    call's completion, and a callback added after it runs at once."""
    a = cw[0]
    h = a.copy(a.buffer(data=torch.ones(4)), a.buffer((4,), torch.float32),
               run_async=True)
    m = OverlapMeter()
    m.issue(h)
    m.wait(h)
    seen = []
    h.add_done_callback(seen.append)
    assert seen == [0] and 0.0 <= m.overlap_frac <= 1.0
