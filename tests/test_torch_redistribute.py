"""The port's sharding specs, redistribution planner and
``ACCL.redistribute`` against the reference's, on the CPU.

Plans are compared field for field with ``accl_tpu.hier`` over a seeded
corpus of spec pairs (block, even, balanced, cyclic, block_cyclic with
subset orders, replicated); executions on ``cuda_world(4, device="cpu")``
bitwise against ``redistribute_oracle`` and against ``emu_world(4)``;
the elastic KV helpers against ``accl_tpu.serving.elastic``.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from accl_tpu.hier import ShardSpec as JSpec  # noqa: E402
from accl_tpu.hier import plan_redistribute as j_plan  # noqa: E402
from accl_tpu.hier import redistribute_oracle as j_oracle  # noqa: E402
from accl_tpu.serving import elastic as j_elastic  # noqa: E402
from accl_tpu.testing import emu_world  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu_torch import cuda_world  # noqa: E402
from accl_tpu_torch.hier import (ShardSpec, plan_redistribute,  # noqa: E402
                                 redistribute_oracle)
from accl_tpu_torch.serving import (kv_shard_spec,  # noqa: E402
                                    reshard_plan_counts)
from accl_tpu_torch.testing import run_ranks  # noqa: E402
from accl_tpu_torch.tracing import METRICS  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep: the port creates no shm
    segment."""
    yield


W = 4


@pytest.fixture(scope="module")
def cw():
    world = cuda_world(W, device="cpu")
    yield world
    for a in world:
        a.deinit()


@pytest.fixture(scope="module")
def ew():
    world = emu_world(W, nbufs=32)
    yield world
    for a in world:
        a.deinit()


# -- specs and plans ---------------------------------------------------------------

def spec_args(rng, n: int, world: int):
    """One random (constructor, args) of a spec of ``n`` elements over
    ``world`` ranks, or None where the kind does not fit ``n``."""
    kind = rng.choice(["block", "even", "balanced", "cyclic",
                       "block_cyclic", "replicated"])
    if kind == "block":
        cuts = np.sort(rng.integers(0, n + 1, world - 1))
        counts = np.diff(np.concatenate(([0], cuts, [n])))
        return "block", (tuple(int(c) for c in counts),)
    if kind == "even":
        return ("even", (n, world)) if n % world == 0 else None
    if kind == "balanced":
        return "balanced", (n, world)
    if kind == "cyclic":
        for chunk in (1, 2, 3, 4, 8):
            if n % chunk == 0 and (n // chunk) % world == 0:
                return "cyclic", (n, world, chunk)
        return None
    if kind == "block_cyclic":
        k = int(rng.integers(1, world + 1))
        order = tuple(int(r) for r in rng.permutation(world)[:k])
        return "block_cyclic", (n, world, int(rng.integers(1, 9)), order)
    return "replicated", (n, world)


def build(pkg, args):
    name, a = args
    return getattr(pkg, name)(*a)


def as_tuple(plan):
    return (plan.kind, tuple(dataclasses.astuple(s) for s in plan.steps),
            plan.coll_count, plan.send_counts, plan.recv_counts, plan.rank,
            plan.wire_transfers)


def corpus(seed: int, pairs: int):
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < pairs:
        world = int(rng.integers(1, 9))
        n = int(rng.integers(0, 97))
        a, b = spec_args(rng, n, world), spec_args(rng, n, world)
        if a is not None and b is not None:
            out.append((a, b))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_plans_match_reference_field_for_field(seed):
    """Every rank's plan over 60 seeded spec pairs (every kind, subset
    orders, zero blocks, partial chunks), and the specs' geometry."""
    for a, b in corpus(seed, 60):
        src, dst = build(ShardSpec, a), build(ShardSpec, b)
        jsrc, jdst = build(JSpec, a), build(JSpec, b)
        assert dataclasses.astuple(src) == dataclasses.astuple(jsrc)
        for r in range(src.world):
            assert src.intervals(r) == jsrc.intervals(r)
            assert src.local_count(r) == jsrc.local_count(r)
            assert as_tuple(plan_redistribute(src, dst, r)) \
                == as_tuple(j_plan(jsrc, jdst, r)), (a, b, r)
        assert src.participants() == jsrc.participants()
        assert src.describe() == jsrc.describe()


def test_spec_and_plan_errors_match_reference():
    bad = [("even", (10, 4)), ("cyclic", (10, 4, 3)), ("cyclic", (12, 4, 2)),
           ("block_cyclic", (10, 4, 0, None)),
           ("block_cyclic", (10, 4, 2, (0, 0))),
           ("block_cyclic", (10, 4, 2, (5,))), ("block", ((1, -1),)),
           ("balanced", (10, 0))]
    for args in bad:
        with pytest.raises(ValueError) as mine:
            build(ShardSpec, args)
        with pytest.raises(ValueError) as ref:
            build(JSpec, args)
        assert str(mine.value) == str(ref.value)
    for a, b in (((10, 4), (12, 4)), ((8, 4), (8, 2))):
        with pytest.raises(ValueError) as mine:
            plan_redistribute(ShardSpec.balanced(*a),
                              ShardSpec.balanced(*b), 0)
        with pytest.raises(ValueError) as ref:
            j_plan(JSpec.balanced(*a), JSpec.balanced(*b), 0)
        assert str(mine.value) == str(ref.value)


def test_oracle_matches_reference():
    for a, b in corpus(99, 40):
        src, dst = build(ShardSpec, a), build(ShardSpec, b)
        glob = np.arange(src.n, dtype=np.float32) * 1.5
        shards = _shards_for(src, glob)
        for mine, ref in zip(redistribute_oracle(shards, src, dst),
                             j_oracle(shards, build(JSpec, a),
                                      build(JSpec, b))):
            assert mine.tobytes() == ref.tobytes()


# -- the elastic KV helpers ----------------------------------------------------------

@pytest.mark.parametrize("blocks,world,old,new", [
    (10, 4, (1, 2), (1, 2, 3)), (224, 4, (1, 2), (1, 2, 3)),
    (36, 4, (0, 1, 2, 3), (3, 1)), (60, 6, (0, 2, 4), (4, 0, 2)),
    (7, 3, None, (2, 0))])
def test_kv_helpers_match_reference(blocks, world, old, new):
    src = kv_shard_spec(blocks, 16, world, order=old)
    dst = kv_shard_spec(blocks, 16, world, order=new)
    jsrc = j_elastic.kv_shard_spec(blocks, 16, world, order=old)
    jdst = j_elastic.kv_shard_spec(blocks, 16, world, order=new)
    assert dataclasses.astuple(src) == dataclasses.astuple(jsrc)
    counts = reshard_plan_counts(src, dst)
    assert counts == j_elastic.reshard_plan_counts(jsrc, jdst)
    assert counts["moved_elems"] < counts["oracle_moved_elems"]
    with pytest.raises(ValueError) as mine:
        kv_shard_spec(0, 16, world)
    with pytest.raises(ValueError) as ref:
        j_elastic.kv_shard_spec(0, 16, world)
    assert str(mine.value) == str(ref.value)


# -- execution -------------------------------------------------------------------

def _shards_for(spec, glob: np.ndarray):
    out = []
    for r in range(spec.world):
        s = np.zeros(spec.local_count(r), glob.dtype)
        for g0, c, l0 in spec.intervals(r):
            s[l0:l0 + c] = glob[g0:g0 + c]
        out.append(s)
    return out


def _body(shards, src_spec, dst_spec, port: bool, *, inplace=False,
          run_async=False, compress=None, resident=False, members=None):
    def fn(a):
        if members is not None and a.rank not in members:
            return None
        r = a.rank if members is None else members.index(a.rank)
        sc, dc = src_spec.local_count(r), dst_spec.local_count(r)
        if port:
            def mk(n):
                return a.buffer((n,), torch.float32,
                                device_resident=resident)

            def fill(b, x):
                b.storage[:x.size] = torch.from_numpy(x.copy())
            cd = None if compress is None else getattr(torch, compress)
        else:
            def mk(n):
                return a.buffer((n,), np.float32)

            def fill(b, x):
                b.data[:x.size] = x
            cd = None if compress is None else np.dtype(compress)
        kw = dict(compress_dtype=cd, run_async=run_async)
        if members is not None:
            kw["members"] = members
        if inplace:
            src = dst = mk(max(sc, dc, 1))
        else:
            src, dst = mk(max(sc, 1)), mk(max(dc, 1))
        fill(src, shards[r])
        h = a.redistribute(src, src_spec, dst, dst_spec, **kw)
        if run_async:
            h.wait(60)
        return np.asarray(dst.data)[:dc].copy()
    return fn


def _specs(a, b):
    return (build(ShardSpec, a), build(ShardSpec, b),
            build(JSpec, a), build(JSpec, b))


CASES = {
    "block-to-replicated": (("even", (64, 4)), ("replicated", (64, 4))),
    "block-to-cyclic": (("even", (64, 4)), ("cyclic", (64, 4, 4))),
    "cyclic-to-block": (("cyclic", (64, 4, 4)), ("even", (64, 4))),
    "replicated-to-block": (("replicated", (64, 4)), ("even", (64, 4))),
    "uneven-to-even": (("block", ((10, 30, 4, 20),)), ("even", (64, 4))),
    "dense-uneven": (("block", ((40, 3, 17, 4),)),
                     ("block", ((4, 30, 10, 20),))),
    "boundary-shift": (("balanced", (50, 4)), ("block", ((13, 13, 12, 12),))),
    "block-to-block_cyclic": (("balanced", (50, 4)),
                              ("block_cyclic", (50, 4, 8, None))),
    "block_cyclic-to-block": (("block_cyclic", (50, 4, 8, None)),
                              ("balanced", (50, 4))),
    "grow-deal": (("block_cyclic", (40, 4, 4, (0, 1, 2))),
                  ("block_cyclic", (40, 4, 4, (0, 1, 2, 3)))),
    "shrink-deal": (("block_cyclic", (36, 4, 8, (0, 1, 2, 3))),
                    ("block_cyclic", (36, 4, 8, (3, 1)))),
    "identity": (("balanced", (30, 4)), ("balanced", (30, 4))),
}
MODES = {"sync": {}, "async": {"run_async": True},
         "resident": {"resident": True},
         "in-place": {"inplace": True},
         "in-place-async": {"inplace": True, "run_async": True,
                            "resident": True}}


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", sorted(CASES))
def test_redistribute_matches_oracle_and_emulator(cw, ew, case, mode):
    """Bitwise the serial gather-reshard-scatter oracle and the emulator
    tier's landing, sync and async, host-mirror and device-resident, in
    place (staged) and not."""
    a, b = CASES[case]
    src, dst, jsrc, jdst = _specs(a, b)
    rng = np.random.default_rng(src.n * 31 + W)
    glob = rng.standard_normal(src.n).astype(np.float32)
    shards = _shards_for(src, glob)
    oracle = redistribute_oracle(shards, src, dst)
    kw = MODES[mode]
    got = run_ranks(cw, _body(shards, src, dst, True, **kw))
    jkw = {k: v for k, v in kw.items() if k != "resident"}
    ref = j_run_ranks(ew, _body(shards, jsrc, jdst, False, **jkw))
    for r in range(W):
        assert got[r].tobytes() == oracle[r].tobytes(), (case, r)
        assert got[r].tobytes() == ref[r].tobytes(), (case, r)


def test_redistribute_on_a_compressed_wire(cw, ew):
    """f16 on the wire: integer values stay exact, as in the reference's
    test; bitwise the emulator tier on a general corpus too."""
    a, b = CASES["grow-deal"]
    src, dst, jsrc, jdst = _specs(a, b)
    for glob in (np.random.default_rng(3).integers(
            -128, 128, src.n).astype(np.float32),
            np.random.default_rng(4).standard_normal(src.n)
            .astype(np.float32)):
        shards = _shards_for(src, glob)
        got = run_ranks(cw, _body(shards, src, dst, True,
                                  compress="float16"))
        ref = j_run_ranks(ew, _body(shards, jsrc, jdst, False,
                                    compress="float16"))
        for r in range(W):
            assert got[r].tobytes() == ref[r].tobytes()
    oracle = redistribute_oracle(_shards_for(src, np.arange(
        src.n, dtype=np.float32)), src, dst)
    got = run_ranks(cw, _body(_shards_for(src, np.arange(
        src.n, dtype=np.float32)), src, dst, True, compress="float16"))
    assert all(g.tobytes() == o.tobytes() for g, o in zip(got, oracle))


def test_redistribute_members_subset(cw):
    """``members=`` runs the exchange over a cached sub-communicator of
    those world ranks (key 0x52ED, the reference's id); the others stay
    idle."""
    members = (0, 2, 3)
    src, dst = ShardSpec.block((24, 12, 12)), ShardSpec.even(48, 3)
    shards = _shards_for(src, np.arange(48, dtype=np.float32))
    oracle = redistribute_oracle(shards, src, dst)

    def twice(a):
        if a.rank not in members:
            return None
        n = len(a.communicators)
        out = _body(shards, src, dst, True, members=members)(a)
        out2 = _body(shards, src, dst, True, members=members)(a)
        assert len(a.communicators) in (n, n + 1)
        assert np.array_equal(out, out2)
        sub = a._redist_comms[members]
        return out, sub.comm_id

    got = run_ranks(cw, twice)
    for i, r in enumerate(members):
        assert got[r][0].tobytes() == oracle[i].tobytes()
        # the reference's id: crc32 of the members and key 0x52ED
        assert got[r][1] == zlib.crc32(b"0,2,3#21229")
    assert got[1] is None


def test_redistribute_validation_matches_reference(cw, ew):
    a, e = cw[0], ew[0]
    cases = [
        (ShardSpec.even(16, 2), ShardSpec.even(16, 4), JSpec.even(16, 2),
         JSpec.even(16, 4), 16, 16, None),
        (ShardSpec.even(16, 4), ShardSpec.even(16, 4), JSpec.even(16, 4),
         JSpec.even(16, 4), 2, 4, None),
        (ShardSpec.even(16, 4), ShardSpec.even(16, 4), JSpec.even(16, 4),
         JSpec.even(16, 4), 4, 4, "float16"),
    ]
    for s, d, js, jd, ns, nd, dt in cases:
        pd = torch.float32 if dt is None else getattr(torch, dt)
        ed = np.float32 if dt is None else np.dtype(dt)
        with pytest.raises(ValueError) as mine:
            a.redistribute(a.buffer((ns,), torch.float32), s,
                           a.buffer((nd,), pd), d)
        with pytest.raises(ValueError) as ref:
            e.redistribute(e.buffer((ns,), np.float32), js,
                           e.buffer((nd,), ed), jd)
        assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError) as mine:
        a.redistribute(a.buffer((4,), torch.float32), ShardSpec.even(12, 3),
                       a.buffer((4,), torch.float32), ShardSpec.even(12, 3),
                       comm=a.comm, members=(0, 1, 2))
    with pytest.raises(ValueError) as ref:
        e.redistribute(e.buffer((4,), np.float32), JSpec.even(12, 3),
                       e.buffer((4,), np.float32), JSpec.even(12, 3),
                       comm=e.comm, members=(0, 1, 2))
    assert str(mine.value) == str(ref.value)
    with pytest.raises(ValueError) as mine:
        a.redistribute(a.buffer((2, 8), torch.float32),
                       ShardSpec.even(64, 4),
                       a.buffer((16,), torch.float32),
                       ShardSpec.cyclic(64, 4, 4))
    with pytest.raises(ValueError) as ref:
        e.redistribute(e.buffer((2, 8), np.float32), JSpec.even(64, 4),
                       e.buffer((16,), np.float32), JSpec.cyclic(64, 4, 4))
    assert str(mine.value) == str(ref.value)


def test_reshard_metrics_and_aggregate_handle(cw):
    """``reshard_total`` by plan kind and ``reshard_bytes_total``; an
    async p2p program returns one handle that retires after every
    sub-call."""
    a, b = CASES["grow-deal"]
    src, dst = build(ShardSpec, a), build(ShardSpec, b)
    shards = _shards_for(src, np.arange(src.n, dtype=np.float32))
    before = METRICS.snapshot()["counters"]
    got = run_ranks(cw, _body(shards, src, dst, True, run_async=True,
                              resident=True))
    after = METRICS.snapshot()["counters"]
    oracle = redistribute_oracle(shards, src, dst)
    assert all(g.tobytes() == o.tobytes() for g, o in zip(got, oracle))
    for r in range(W):
        kind = plan_redistribute(src, dst, r).kind
        lab = f"kind={kind},rank={r}"
        assert after["reshard_total"][lab] \
            - before.get("reshard_total", {}).get(lab, 0) == 1
        lab = f"rank={r}"
        assert after["reshard_bytes_total"][lab] \
            - before.get("reshard_bytes_total", {}).get(lab, 0) \
            == 4 * src.n
