"""The port's tuning-table producer against ``benchmarks/tune.py``.

``accl_tpu_torch.tuner.sweep.run_tune`` on ``cuda_world(4, device="cpu")``
and the reference's ``run_tune`` on ``emu_world(4)`` at the same small
sizes write rows and tables of the same schema: the same forced and
chosen rows (op, world, count, nbytes, bucket, source; every legal
algorithm but HIERARCHICAL, and the AUTO / AUTO+fp8-bs wire pair), the
same table fields and keys (times and winners differ with the tier).
The port's table loads through the port's ``tuner/cache.py`` into a
fresh ``Tuner`` whose ``select`` returns every chosen row's algorithm,
as do the drivers of a world that loads it from ``ACCL_TPU_TUNING_CACHE``;
``write_rows`` and ``format_rows`` match the reference's byte for byte.
"""

from __future__ import annotations

import json

import pytest

torch = pytest.importorskip("torch")

from benchmarks import tune as jtune  # noqa: E402
from accl_tpu_torch import Tuner, cuda_world  # noqa: E402
from accl_tpu_torch.constants import (CollectiveAlgorithm,  # noqa: E402
                                      VALID_ALGORITHMS)
from accl_tpu_torch.testing import run_ranks  # noqa: E402
from accl_tpu_torch.tuner import cache, sweep  # noqa: E402

SIZES = [256, 4096]
OPS = ["allreduce", "allgather", "reduce_scatter", "gather", "reduce",
       "bcast"]


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep: the port creates no shm."""
    yield


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    d = tmp_path_factory.mktemp("tune")
    port = sweep.run_tune(4, sizes=SIZES, ops=OPS, reps=2,
                          cache_path=str(d / "port.json"), device="cpu")
    ref = jtune.run_tune(world=4, sizes=SIZES, ops=OPS, reps=2,
                         cache_path=str(d / "ref.json"))
    return port, ref


def _key(row):
    alg = row["algorithm"]
    if row["source"] == "chosen":
        alg = None                       # the winner depends on the tier
    return (row["op"], row["world"], row["count"], row["nbytes"],
            row["bucket"], row["source"], alg)


def test_rows_match_reference_schema(tables):
    port, ref = tables
    assert [set(r) for r in port["rows"]] == [set(r) for r in ref["rows"]]
    assert [_key(r) for r in port["rows"]] == [_key(r) for r in ref["rows"]]
    forced = [r for r in port["rows"] if r["source"] == "forced"]
    assert all(r["seconds_per_op"] > 0 for r in forced)
    assert {r["algorithm"] for r in forced if r["op"] == "allreduce"} == {
        a.name for a in VALID_ALGORITHMS["allreduce"]
        if a != CollectiveAlgorithm.HIERARCHICAL} | {"AUTO", "AUTO+fp8-bs"}
    assert not any("HIERARCHICAL" in r["algorithm"] for r in port["rows"])


def test_table_matches_reference_schema(tables):
    port, ref = tables
    docs = [json.load(open(t["cache_path"])) for t in (port, ref)]
    assert docs[0].keys() == docs[1].keys() == {"version", "entries",
                                                "topology"}
    assert docs[0]["version"] == docs[1]["version"] == cache.SCHEMA_VERSION
    assert docs[0]["topology"].keys() == docs[1]["topology"].keys()
    assert docs[0]["topology"]["tier"] != docs[1]["topology"]["tier"]
    keys = [sorted((e["op"], e["world"], e["bucket"]) for e in d["entries"])
            for d in docs]
    assert keys[0] == keys[1]
    assert [set(e) for e in docs[0]["entries"]] == [
        set(e) for e in docs[1]["entries"]]
    assert all(e["samples"] == 2 for e in docs[0]["entries"])


def test_table_loads_and_auto_follows_chosen(tables):
    port, _ = tables
    fresh = Tuner()
    n = cache.load_into(fresh, port["cache_path"], strict=True)
    assert n == len(json.load(open(port["cache_path"]))["entries"])
    assert fresh.topology.tier == port["tuner"].topology.tier
    for r in port["rows"]:
        if r["source"] != "chosen":
            continue
        alg = r["algorithm"].split("+")[0]
        assert fresh.select(r["op"], r["world"], r["nbytes"]).name == alg
        assert port["tuner"].select(r["op"], r["world"],
                                    r["nbytes"]).name == alg
        assert ("+fp8-bs" in r["algorithm"]) == (
            r["op"] in sweep.WIRE_OPS and port["tuner"].select_wire(
                r["op"], r["world"], r["nbytes"]))


def test_world_from_env_table_resolves_auto(tables, monkeypatch):
    """Drivers built with a tuner pin the ``ACCL_TPU_TUNING_CACHE`` table
    at construction; an AUTO allreduce then runs the chosen algorithm."""
    port, _ = tables
    monkeypatch.setenv(cache.ENV_VAR, port["cache_path"])
    tuner = Tuner()
    accls = cuda_world(4, device="cpu", tuner=tuner)
    try:
        chosen = {r["nbytes"]: r["algorithm"].split("+")[0]
                  for r in port["rows"]
                  if r["source"] == "chosen" and r["op"] == "allreduce"}
        for nbytes, alg in chosen.items():
            n = nbytes // 4

            def fn(a):
                src = a.buffer(data=torch.ones(n))
                dst = a.buffer((n,), torch.float32)
                a.start_profiling()
                a.allreduce(src, dst, n)
                a.end_profiling()
                return a.profiler.records[-1].algorithm, float(dst.data[0])
            assert run_ranks(accls, fn) == [(alg, 4.0)] * 4
            for a in accls:
                a.profiler.clear()
    finally:
        for a in accls:
            a.deinit()


def test_write_and_format_rows_match_reference(tables, tmp_path):
    port, _ = tables
    p = sweep.write_rows(port["rows"], str(tmp_path / "p"))
    r = jtune.write_rows(port["rows"], str(tmp_path / "r"))
    assert open(p).read() == open(r).read()
    assert sweep.format_rows(port["rows"]) == jtune.format_rows(port["rows"])


def test_rank_body_times_each_rep():
    """Every rep of the body is one synchronous call; the durations come
    back one a rep; an op the sweep does not know raises."""
    accls = cuda_world(2, device="cpu")
    try:
        body = sweep._rank_body("allreduce", 8, 2, CollectiveAlgorithm.RING,
                                3)
        out = run_ranks(accls, body)
        assert [len(ts) for ts, _ in out] == [3, 3]
        assert all(t > 0 for ts, _ in out for t in ts)
        assert [kept for _, kept in out] == [None, None]
        with pytest.raises(ValueError):
            run_ranks(accls, sweep._rank_body("scatter", 8, 2,
                                              CollectiveAlgorithm.AUTO, 1))
    finally:
        for a in accls:
            a.deinit()


def _golden(op, count, kept):
    """The float64 result of ``op`` on the kept sources, and the ranks
    whose output it is (root 0 for the rooted ops)."""
    W = len(kept)
    xs = [src.double() for src, _ in kept]
    if op == "allreduce":
        return sum(xs), range(W)
    if op == "reduce":
        return sum(xs), [0]
    if op == "bcast":
        return xs[0], range(W)
    if op in ("allgather", "gather"):
        return torch.cat(xs), range(W) if op == "allgather" else [0]
    if op == "reduce_scatter":
        return sum(xs), range(W)
    raise ValueError(op)


def test_check_sees_each_warm_up_once():
    """``check`` sees the warm-up of every (op, algorithm, wire) the sweep
    times exactly once, at the first swept size, before its reps. The
    sources are seeded random, a different row a rank; every output is
    its op on the sources: within 1e-5 of a float64 golden on the full
    wire, within W * 2^-4 of the summed source magnitudes on the fp8
    wire (3 mantissa bits, one requantisation a hop); and the same call
    fed the kept sources again (``sources=``) is bitwise the same."""
    seen = []
    W, count = 4, SIZES[0] // 4
    yard = cuda_world(W, device="cpu")

    def check(op, n, alg, kw, kept):
        seen.append((op, alg.name + ("+fp8-bs" if kw else "")))
        assert n == count
        srcs = [src for src, _ in kept]
        assert not torch.equal(srcs[0], srcs[1])
        want, ranks = _golden(op, n, kept)
        wire = bool(kw)
        tol = (W * 2 ** -4 * sum(float(x.abs().max()) for x in srcs)
               if wire else 1e-5)
        for r in ranks:
            got = kept[r][1].double()
            if op == "reduce_scatter":
                ref = want[r * n:(r + 1) * n]
            else:
                ref = want
            err = float((got - ref).abs().max())
            assert err <= (tol if wire else tol * (1 + float(
                ref.abs().max()))), (op, alg, kw, r, err)
        again = run_ranks(yard, sweep._rank_body(op, n, W, alg, 0, True,
                                                 sources=srcs, **kw))
        for (_, k0), (_, k1) in zip(kept, [kk for _, kk in again]):
            assert torch.equal(k0[1], k1[1]), (op, alg, kw)

    try:
        out = sweep.run_tune(W, sizes=SIZES, ops=OPS, reps=1, device="cpu",
                             check=check)
    finally:
        for a in yard:
            a.deinit()
    forced = {(r["op"], r["algorithm"]) for r in out["rows"]
              if r["source"] == "forced" and r["count"] == count}
    assert len(seen) == len(set(seen)) == len(forced)
    assert set(seen) == forced
