"""Result-integrity verification of the port against the reference's.

``fingerprint_of`` is the reference's crc32 over the same bytes (host
mirrors and device-resident buffers, every dtype); ``verify_integrity``
runs the same cross-check on ``cuda_world(W, device="cpu")`` as on
``tpu_world(W, platform="cpu")``: the happy path of allreduce, allgather
and bcast, the mismatch naming the minority rank, the W = 2 tie, the
per-call kwarg and its refusals (texts word for word), and a
hierarchical call verified once.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

from accl_tpu.constants import ACCLError as JError  # noqa: E402
from accl_tpu.device.tpu import tpu_world  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu.tracing import METRICS as J_METRICS  # noqa: E402
from accl_tpu_torch import ACCLError, ErrorCode, cuda_world  # noqa: E402
from accl_tpu_torch.testing import run_ranks  # noqa: E402
from accl_tpu_torch.tracing import METRICS  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep: the port creates no shm."""
    yield


def _tot(metrics, name: str) -> float:
    return sum(metrics.snapshot()["counters"].get(name, {}).values())


@pytest.fixture(scope="module")
def worlds3():
    tw = tpu_world(3, platform="cpu")
    cw = cuda_world(3, device="cpu")
    yield tw, cw
    for a in tw + cw:
        a.deinit()


_DTYPES = ("float32", "float16", "bfloat16", "int32", "int64", "uint8",
           "float8_e4m3fn")


# a device-resident buffer holds no 64-bit dtype, in either package
@pytest.mark.parametrize("dtype,resident", [
    (d, r) for d in _DTYPES for r in (False, True)
    if not (r and d == "int64")])
def test_fingerprint_equals_reference(worlds3, dtype, resident):
    tw, cw = worlds3
    rng = np.random.default_rng(1)
    np_dt = getattr(ml_dtypes, dtype, None) or np.dtype(dtype)
    x = (rng.standard_normal(1000) * 50).astype(np_dt)
    jb = tw[0].buffer(data=x.copy())
    tb = cw[0].buffer(data=torch.from_numpy(x.view(np.uint8).copy()).view(
        getattr(torch, dtype)), device_resident=resident)
    for n in (None, 1, 17, 999):
        assert cw[0].fingerprint_of(tb, n) == tw[0].fingerprint_of(jb, n)


def _ops_body(torch_side: bool, n: int = 64):
    def fn(a):
        v = float(a.rank + 1)
        if torch_side:
            src = a.buffer(data=torch.full((n,), v))
            dst = a.buffer((n,), torch.float32)
            g = a.buffer((n * a.world_size,), torch.float32)
        else:
            src = a.buffer(data=np.full(n, v, np.float32))
            dst = a.buffer((n,), np.float32)
            g = a.buffer((n * a.world_size,), np.float32)
        a.allreduce(src, dst, n)
        a.allgather(src, g, n)
        a.bcast(dst, n, root=0)
        return True
    return fn


def test_verify_happy_path_counts_like_the_reference(worlds3):
    tw, cw = worlds3
    for a in tw + cw:
        a.verify_integrity = True
    try:
        j0, t0 = _tot(J_METRICS, "integrity_verified_total"), \
            _tot(METRICS, "integrity_verified_total")
        assert all(j_run_ranks(tw, _ops_body(False)))
        assert all(run_ranks(cw, _ops_body(True)))
        dj = _tot(J_METRICS, "integrity_verified_total") - j0
        dt = _tot(METRICS, "integrity_verified_total") - t0
        assert dt == dj == 9          # 3 ops x 3 ranks
    finally:
        for a in tw + cw:
            a.verify_integrity = False


def _mismatch_body(torch_side: bool, n: int):
    Err = ACCLError if torch_side else JError

    def fn(a):
        if torch_side:
            src = a.buffer(data=torch.full((n,), 1.0))
            dst = a.buffer((n,), torch.float32)
        else:
            src = a.buffer(data=np.full(n, 1.0, np.float32))
            dst = a.buffer((n,), np.float32)
        with pytest.raises(Err) as ei:
            a.allreduce(src, dst, n, verify_integrity=True)
        assert ei.value.error_word & int(ErrorCode.DATA_INTEGRITY_ERROR)
        return str(ei.value)
    return fn


@pytest.mark.parametrize("W", [2, 3], ids=["tie", "majority"])
def test_mismatch_names_the_rank_like_the_reference(W):
    tw = tpu_world(W, platform="cpu")
    cw = cuda_world(W, device="cpu")
    for a in (tw[1], cw[1]):
        a.fingerprint_of = lambda buf, nelems=None: 0xDEAD
    try:
        j0, t0 = _tot(J_METRICS, "integrity_mismatch_total"), \
            _tot(METRICS, "integrity_mismatch_total")
        want = j_run_ranks(tw, _mismatch_body(False, 32))
        got = run_ranks(cw, _mismatch_body(True, 32))
        assert _tot(METRICS, "integrity_mismatch_total") - t0 == \
            _tot(J_METRICS, "integrity_mismatch_total") - j0 == W
    finally:
        for a in tw + cw:
            a.deinit()
    # the messages name the same ranks in the same words (the comm ids,
    # which derive from each package's membership hash, may differ)
    strip = [m.split(": result fingerprint mismatch")[1] for m in want]
    assert [m.split(": result fingerprint mismatch")[1] for m in got] == strip
    if W == 2:
        assert all("undecidable" in m and "[0, 1]" in m for m in got)
    else:
        assert all("[1]" in m for m in got)


def test_per_call_kwarg_and_refusals_match(worlds3):
    tw, cw = worlds3

    def body(torch_side):
        def fn(a):
            if torch_side:
                src = a.buffer(data=torch.full((32,), 1.0))
                dst = a.buffer((32,), torch.float32)
                wire = torch.float16
            else:
                src = a.buffer(data=np.full(32, 1.0, np.float32))
                dst = a.buffer((32,), np.float32)
                wire = np.float16
            a.allreduce(src, dst, 32)                    # not verified
            a.allreduce(src, dst, 32, verify_integrity=True)
            msgs = []
            with pytest.raises(ValueError) as e:
                a.allreduce(src, dst, 32, run_async=True,
                            verify_integrity=True)
            msgs.append(str(e.value))
            with pytest.raises(ValueError) as e:
                a.allreduce(src, dst, 32, compress_dtype=wire,
                            verify_integrity=True)
            msgs.append(str(e.value))
            # the driver default skips the async and compressed calls
            a.verify_integrity = True
            try:
                a.allreduce(src, dst, 32, compress_dtype=wire)
                a.allreduce(src, dst, 32, run_async=True).wait(30.0)
            finally:
                a.verify_integrity = False
            return msgs
        return fn

    j0, t0 = _tot(J_METRICS, "integrity_verified_total"), \
        _tot(METRICS, "integrity_verified_total")
    want = j_run_ranks(tw, body(False))
    got = run_ranks(cw, body(True))
    assert got == want
    assert _tot(METRICS, "integrity_verified_total") - t0 == \
        _tot(J_METRICS, "integrity_verified_total") - j0 == 3


def test_hierarchical_call_verified_once():
    hosts = [0, 0, 1, 1]
    cw = cuda_world(4, device="cpu")
    for a in cw:
        a.verify_integrity = True
        a.configure_hierarchy(hosts)
    n = 1024
    t0 = _tot(METRICS, "integrity_verified_total")
    try:
        def body(a):
            src = a.buffer(data=torch.full((n,), float(a.rank + 1)))
            dst = a.buffer((n,), torch.float32)
            a.allreduce(src, dst, n, algorithm="HIERARCHICAL")
            return float(dst.data[0])

        assert all(r == 10.0 for r in run_ranks(cw, body, timeout=120.0))
    finally:
        for a in cw:
            a.deinit()
    assert _tot(METRICS, "integrity_verified_total") - t0 == 4
