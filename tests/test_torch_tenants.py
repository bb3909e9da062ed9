"""Tenants, the constructor and the housekeeping methods against the
reference's driver.

The call-accounting rows carry the reference's ``tenant`` label (the
port adds ``ctx``, ROADMAP §C2); ``ACCL`` binds the same parameters by
position as ``accl_tpu.ACCL`` (``tenant`` between ``tuner`` and
``retry_policy``); ``validate_tenant`` accepts and refuses the same
labels with the same message; two tenants' driver sets sharing each
rank's device interleave their calls (collectives, the rendezvous and
the p2p exchange) with results bitwise a single tenant's, and split their
rows, records and the device's grouping per tenant; the housekeeping
methods return what the reference's do; no public method of the
reference's driver is missing.
"""

from __future__ import annotations

import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import accl_tpu  # noqa: E402
from accl_tpu.device.tpu import tpu_world  # noqa: E402
from accl_tpu.retry import RetryPolicy as JRetryPolicy  # noqa: E402
from accl_tpu.service import validate_tenant as j_validate  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu.tracing import METRICS as J_METRICS  # noqa: E402
from accl_tpu_torch import ACCL, RetryPolicy, cuda_world  # noqa: E402
from accl_tpu_torch.service import tenant_label, validate_tenant  # noqa: E402
from accl_tpu_torch.testing import add_tenant, run_ranks  # noqa: E402
from accl_tpu_torch.tracing import METRICS  # noqa: E402

W = 4
N = 96


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep: the port creates no shm."""
    yield


def _rows(snapshot, name, pred=lambda kv: True):
    out = []
    for labels, v in snapshot["counters"].get(name, {}).items():
        kv = dict(p.split("=", 1) for p in labels.split(","))
        if pred(kv):
            out.append((kv, v))
    return out


def _ops(jax_side: bool):
    def fn(a):
        if jax_side:
            src = a.buffer(data=np.arange(N, dtype=np.float32))
            dst = a.buffer((N,), np.float32)
        else:
            src = a.buffer(data=torch.arange(N, dtype=torch.float32))
            dst = a.buffer((N,), torch.float32)
        a.allreduce(src, dst, N)
        a.bcast(dst, N, root=1)
        return True
    return fn


def test_metric_rows_carry_the_reference_labels():
    """The rows of ``accl_calls_total`` and ``accl_bytes_total`` carry the
    reference's label set (rank, op, comm_id, tenant) plus the port's
    ``ctx``, with ``tenant`` the communicator's own where the driver has
    none."""
    tw = tpu_world(W, platform="cpu")
    cw = cuda_world(W, device="cpu")
    try:
        j_run_ranks(tw, _ops(True))
        run_ranks(cw, _ops(False))
        cid = cw[0].comm.comm_id
        assert cid == tw[0].comm.comm_id
        ctx = str(cw[0].device.ctx.seq)
        for name in ("accl_calls_total", "accl_bytes_total"):
            ref = _rows(J_METRICS.snapshot(), name,
                        lambda kv: kv["comm_id"] == str(cid))
            got = _rows(METRICS.snapshot(), name,
                        lambda kv: kv.get("ctx") == ctx)
            assert got and ref
            ref_keys = {frozenset(kv) for kv, _ in ref}
            got_keys = {frozenset(kv) - {"ctx"} for kv, _ in got}
            assert got_keys == ref_keys == {frozenset(
                {"rank", "op", "comm_id", "tenant"})}
            assert {kv["tenant"] for kv, _ in got} == {
                kv["tenant"] for kv, _ in ref} == {f"comm-{cid}"}
            assert sorted((kv["rank"], kv["op"]) for kv, _ in got) == sorted(
                (kv["rank"], kv["op"]) for kv, _ in ref)
    finally:
        for a in tw + cw:
            a.deinit()


def test_constructor_binds_the_reference_positions():
    """The same parameter names in the same order; a nine-positional call
    binds ``tenant`` 7th, ``retry_policy`` 8th and ``verify_integrity``
    9th on both packages."""
    ref = list(inspect.signature(accl_tpu.ACCL.__init__).parameters)
    got = list(inspect.signature(ACCL.__init__).parameters)
    assert got == ref
    assert got.index("tenant") == got.index("tuner") + 1
    tw = tpu_world(2, platform="cpu")
    cw = cuda_world(2, device="cpu")
    try:
        made = []
        for world, cls, pol in ((tw, accl_tpu.ACCL, JRetryPolicy(retries=2)),
                                (cw, ACCL, RetryPolicy(retries=2))):
            a = cls(world[0].device, world[0].comm, 5.0, 1 << 16, None,
                    None, "tenant-x", pol, True)
            made.append((a.tenant, a.retry_policy is pol,
                         a.verify_integrity, a.device.timeout))
        assert made[0] == made[1] == ("tenant-x", True, True, 5.0)
    finally:
        for a in tw + cw:
            a.deinit()


GOOD = ("a", "tenant-b", "T.9_x-y", "0", "x" * 64)
BAD = ("", "-lead", ".x", "has space", "comma,x", 'quo"te', "new\nline",
       "x" * 65, "ütf")


@pytest.mark.parametrize("label", GOOD + BAD)
def test_validate_tenant_matches_reference(label):
    try:
        want = j_validate(label)
    except ValueError as exc:
        with pytest.raises(ValueError) as ei:
            validate_tenant(label)
        assert str(ei.value) == str(exc)
        assert label in BAD
    else:
        assert validate_tenant(label) == want == label
        assert label in GOOD


def test_invalid_tenant_is_refused_at_construction():
    tw = tpu_world(2, platform="cpu")
    cw = cuda_world(2, device="cpu")
    try:
        msgs = []
        for world, cls in ((tw, accl_tpu.ACCL), (cw, ACCL)):
            with pytest.raises(ValueError) as ei:
                cls(world[0].device, world[0].comm, tenant="bad label")
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]
        with pytest.raises(ValueError):
            add_tenant(cw, "a,b")
    finally:
        for a in tw + cw:
            a.deinit()


def test_tenant_label_default():
    assert tenant_label(7) == "comm-7"
    assert tenant_label(7, {7: "t"}) == "t"
    assert tenant_label(8, {7: "t"}) == "comm-8"


def _interleaved(a, b, seed: int):
    """One rank's interleaved calls of two tenants' drivers ``a`` and
    ``b``, async where they may overlap: each tenant's allreduce (ring and
    xla), a ring shift of point-to-point transfers, and an allgather."""
    r, Wn = a.rank, a.world_size
    rng = np.random.default_rng(seed + r)
    xs = [torch.from_numpy(rng.standard_normal(N).astype(np.float32))
          for _ in range(4)]
    out, src, hs = {}, {}, []
    for name, d, x, y in (("a", a, xs[0], xs[1]), ("b", b, xs[2], xs[3])):
        out[name] = {k: d.buffer((n,), torch.float32) for k, n in
                     (("ring", N), ("xla", N), ("p2p", N), ("ag", N * Wn))}
        src[name] = (d.buffer(data=x), d.buffer(data=y))
    for name, d in (("a", a), ("b", b)):
        hs.append(d.allreduce(src[name][0], out[name]["ring"], N,
                              algorithm="ring", run_async=True))
    for name, d in (("b", b), ("a", a)):
        hs.append(d.allreduce(src[name][1], out[name]["xla"], N,
                              run_async=True))
        hs.append(d.send(src[name][0], N, dst=(r + 1) % Wn, tag=3,
                         run_async=True))
    for name, d in (("a", a), ("b", b)):
        hs.append(d.recv(out[name]["p2p"], N, src=(r - 1) % Wn, tag=3,
                         run_async=True))
    for h in hs:
        h.wait(30)
    for name, d in (("a", a), ("b", b)):
        d.allgather(src[name][1], out[name]["ag"], N)
    return {name: {k: v.data.copy() for k, v in o.items()}
            for name, o in out.items()}


def _alone(a, seed: int, which: str):
    """The same operands through one tenant's driver alone."""
    r, Wn = a.rank, a.world_size
    rng = np.random.default_rng(seed + r)
    xs = [torch.from_numpy(rng.standard_normal(N).astype(np.float32))
          for _ in range(4)]
    x, y = (xs[0], xs[1]) if which == "a" else (xs[2], xs[3])
    s, t = a.buffer(data=x), a.buffer(data=y)
    out = {k: a.buffer((n,), torch.float32) for k, n in
           (("ring", N), ("xla", N), ("p2p", N), ("ag", N * Wn))}
    a.allreduce(s, out["ring"], N, algorithm="ring")
    a.allreduce(t, out["xla"], N)
    h = a.send(s, N, dst=(r + 1) % Wn, tag=3, run_async=True)
    a.recv(out["p2p"], N, src=(r - 1) % Wn, tag=3)
    h.wait(30)
    a.allgather(t, out["ag"], N)
    return {k: v.data.copy() for k, v in out.items()}


def test_two_tenants_interleave_bitwise():
    """Two driver sets on the same devices (comm keys 0 and 1) interleave
    their calls; each result is bitwise the same calls of one tenant
    alone, the rows split by tenant with the right counts, the records
    name their tenant and the device maps each comm to its tenant."""
    base = cuda_world(W, device="cpu")
    cw = add_tenant(base, "tenant-a", key=1)
    tb = add_tenant(base, "tenant-b", key=2)
    solo = cuda_world(W, device="cpu")
    try:
        assert all(x.device is y.device for x, y in zip(cw, tb))
        assert cw[0].comm.comm_id != tb[0].comm.comm_id
        for a, b in zip(cw, tb):
            a.start_profiling()
            b.start_profiling()
        both = run_ranks(cw, lambda a: _interleaved(a, tb[a.rank], 11))
        for which in ("a", "b"):
            ref = run_ranks(solo, lambda a: _alone(a, 11, which))
            for r in range(W):
                for k in ("ring", "xla", "p2p", "ag"):
                    assert np.array_equal(both[r][which][k], ref[r][k]), (
                        which, k, r)
        ctx = str(cw[0].device.ctx.seq)
        rows = _rows(METRICS.snapshot(), "accl_calls_total",
                     lambda kv: kv.get("ctx") == ctx)
        per = {}
        for kv, v in rows:
            per.setdefault(kv["tenant"], {}).setdefault(kv["op"], 0)
            per[kv["tenant"]][kv["op"]] += v
        want = {"allreduce": 2 * W, "send": W, "recv": W, "allgather": W}
        assert per == {"tenant-a": want, "tenant-b": want}
        for drivers, t in ((cw, "tenant-a"), (tb, "tenant-b")):
            for d in drivers:
                assert {x.tenant for x in d.profiler.records} == {t}
                assert len(d.profiler.records) == 5
                assert d.device.tenant_of(d.comm.comm_id) == t
        assert cw[0].device.tenant_of(12345) == "comm-12345"
    finally:
        for a in base + solo:
            a.deinit()


def test_splits_and_membership_keep_the_tenant():
    base = cuda_world(W, device="cpu")
    cw = add_tenant(base, "team-1")
    try:
        def split(a):
            sub = a.split_communicator([0, 1, 2, 3], key=5)
            return a.device.tenant_of(sub.comm_id)
        assert run_ranks(cw, split) == ["team-1"] * W

        def shrink(a):
            if a.rank == 3:
                return None
            sub = a.shrink_communicator([3])
            return a.device.tenant_of(sub.comm_id)
        assert run_ranks(cw, shrink)[:3] == ["team-1"] * 3
    finally:
        for a in base:
            a.deinit()


def test_housekeeping_returns_match_reference():
    """open_port, init_connection, close_connections and set_stack_type
    are config calls that return None; an unknown stack raises KeyError;
    dump_rx_buffers reads "<no rx pool>" on both device tiers; the
    profiling config calls succeed and toggle the driver's profiler (the
    port's device keeps no profiling flag of its own: nothing reads it)."""
    tw = tpu_world(2, platform="cpu")
    cw = cuda_world(2, device="cpu")
    try:
        for a in (tw[0], cw[0]):
            assert a.open_port() is None
            assert a.init_connection() is None
            assert a.init_connection(a.comm) is None
            assert a.close_connections() is None
            assert a.set_stack_type("udp") is None
            assert a.set_stack_type("tcp") is None
            with pytest.raises(KeyError):
                a.set_stack_type("rdma")
            assert a.dump_rx_buffers() == "<no rx pool>"
            assert a.start_profiling() is None
            assert a.profiler.enabled
            assert a.end_profiling() is None
            assert not a.profiler.enabled
    finally:
        for a in tw + cw:
            a.deinit()


def _public(cls) -> set:
    return {n for n, v in inspect.getmembers(cls)
            if not n.startswith("_") and callable(v)}


def test_no_public_method_of_the_reference_is_missing():
    missing = _public(accl_tpu.ACCL) - _public(ACCL)
    assert missing == set()
