"""The port's tuner (``accl_tpu_torch/tuner``) against the reference's.

The cost models are pure Python floats, so the port must return the
reference's predictions bit for bit over every op and algorithm, worlds
of 2 to 16 ranks, payloads of 2^0 to 2^30 bytes and the default, two-tier
and three-tier topologies; the Tuner's decisions, its learned entries
after one observe sequence, its seeded exploration picks and its tuning
tables (saved by either package, loaded by the other) must agree too.
"""

from __future__ import annotations

import dataclasses
import random

import pytest

pytest.importorskip("torch")

from accl_tpu.constants import CollectiveAlgorithm as JA  # noqa: E402
from accl_tpu.hier import MeshTopology as JMesh  # noqa: E402
from accl_tpu.tuner import Tuner as JTuner  # noqa: E402
from accl_tpu.tuner import cache as jcache  # noqa: E402
from accl_tpu.tuner import cost as jcost  # noqa: E402
from accl_tpu.tuner import nbytes_bucket as j_bucket  # noqa: E402
from accl_tpu_torch.constants import CollectiveAlgorithm as TA  # noqa: E402
from accl_tpu_torch.hier import MeshTopology as TMesh  # noqa: E402
from accl_tpu_torch.tracing import METRICS  # noqa: E402
from accl_tpu_torch.tuner import Tuner as TTuner  # noqa: E402
from accl_tpu_torch.tuner import cache as tcache  # noqa: E402
from accl_tpu_torch.tuner import cost as tcost  # noqa: E402
from accl_tpu_torch.tuner import nbytes_bucket as t_bucket  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep: nothing here creates shm."""
    yield


WORLDS = (2, 3, 4, 8, 16)
SIZES = tuple(1 << k for k in range(31))
OPS = ("bcast", "scatter", "gather", "reduce", "allgather", "allreduce",
       "reduce_scatter", "alltoall", "alltoallv")
CHIPS8 = [0, 0, 1, 1, 2, 2, 3, 3]
RACKS8 = [0, 0, 0, 0, 1, 1, 1, 1]


def _topos(pkg):
    """Both packages' topologies, built from the same figures."""
    if pkg == "j":
        Topology, Mesh = jcost.Topology, JMesh
    else:
        Topology, Mesh = tcost.Topology, TMesh
    return {
        "default": Topology(),
        "emu": Topology(world_size=4, alpha_us=20.0, beta_gbps=4.0,
                        tier="emu", pipeline_depth=4.0),
        "two_tier": Mesh.from_hosts([0, 0, 0, 0, 1, 1, 1, 1]),
        "uneven": Mesh.from_hosts([0, 0, 0, 1, 1, 1, 1, 1],
                                  alpha_us=20.0, beta_gbps=4.0,
                                  inter_alpha_us=200.0,
                                  inter_beta_gbps=0.2),
        "three_tier": Mesh.from_nest(
            [(CHIPS8, 100.0, 0.2), (RACKS8, 300.0, 0.02)],
            alpha_us=20.0, beta_gbps=4.0),
    }


J_TOPOS, T_TOPOS = _topos("j"), _topos("t")
TOPO_IDS = sorted(J_TOPOS)


def _algs(op):
    from accl_tpu_torch.constants import VALID_ALGORITHMS
    return sorted(VALID_ALGORITHMS.get(op, ())) or [TA.AUTO]


def _same(a, b):
    """Bit-for-bit float equality (inf == inf; the models make no NaN)."""
    return a == b and type(a) is type(b)


def test_topologies_are_the_same_dataclass_values():
    for k in TOPO_IDS:
        assert dataclasses.asdict(J_TOPOS[k]) == \
            dataclasses.asdict(T_TOPOS[k]), k


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("topo", TOPO_IDS)
def test_predict_us_bit_for_bit(topo, op):
    jt, tt = J_TOPOS[topo], T_TOPOS[topo]
    n = 0
    for alg in _algs(op):
        for w in WORLDS:
            for nb in SIZES:
                want = jcost.predict_us(op, JA(int(alg)), jt, nb, w)
                got = tcost.predict_us(op, alg, tt, nb, w)
                assert _same(got, want), (op, alg.name, w, nb, got, want)
                if op not in ("scatter",):
                    qw = jcost.predict_quantized_us(op, JA(int(alg)), jt,
                                                    nb, w)
                    qg = tcost.predict_quantized_us(op, alg, tt, nb, w)
                    assert _same(qg, qw), (op, alg.name, w, nb)
                n += 1
    assert n >= len(WORLDS) * len(SIZES)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("topo", TOPO_IDS)
def test_rank_algorithms_and_wire_bit_for_bit(topo, op):
    jt, tt = J_TOPOS[topo], T_TOPOS[topo]
    for w in WORLDS:
        for nb in SIZES:
            want = [(a.name, c) for a, c in
                    jcost.rank_algorithms(op, jt, nb, w)]
            got = [(a.name, c) for a, c in
                   tcost.rank_algorithms(op, tt, nb, w)]
            assert got == want, (op, w, nb)
            for ratio in (None, 2.0):
                jq, ja = jcost.rank_wire(op, jt, nb, w, ratio)
                tq, ta = tcost.rank_wire(op, tt, nb, w, ratio)
                assert (tq, getattr(ta, "name", ta)) == \
                    (jq, getattr(ja, "name", ja)), (op, w, nb, ratio)


@pytest.mark.parametrize("topo", TOPO_IDS)
def test_segment_size_and_wire_ratio_bit_for_bit(topo):
    jt, tt = J_TOPOS[topo], T_TOPOS[topo]
    for pref in (1 << 10, 4096, 1 << 16, 1 << 20, 1 << 24):
        for frac in (0.05, 0.1, 0.5):
            for depth in (None, 1.0, 4.0):
                assert tcost.recommend_segment_size(
                    tt, pref, frac, overlap_depth=depth) == \
                    jcost.recommend_segment_size(
                        jt, pref, frac, overlap_depth=depth)
    for u, q, b in ((4, 1, 32), (4, 1, 128), (4, 2, 256), (2, 1, 64)):
        assert _same(tcost.wire_byte_ratio(u, q, b),
                     jcost.wire_byte_ratio(u, q, b))
    counts = [(0, 3, 5, 7), (9, 0, 0, 1), (4, 4, 4, 4), (0, 0, 0, 0)]
    for a in counts:
        for b in counts:
            for eb in (1, 2, 4):
                assert _same(tcost.predict_alltoallv_us(tt, a, b, eb),
                             jcost.predict_alltoallv_us(jt, a, b, eb))
    assert [t_bucket(n) for n in range(0, 5000, 37)] == \
        [j_bucket(n) for n in range(0, 5000, 37)]


@pytest.mark.parametrize("topo", TOPO_IDS)
def test_tuner_decisions_equal(topo):
    jt, tt = JTuner(topology=J_TOPOS[topo]), TTuner(topology=T_TOPOS[topo])
    for op in OPS:
        for w in WORLDS:
            for nb in SIZES[::3]:
                assert tt.select(op, w, nb).name == \
                    jt.select(op, w, nb).name, (op, w, nb)
                assert tt.select_wire(op, w, nb) == \
                    jt.select_wire(op, w, nb), (op, w, nb)
    for nb in SIZES:
        assert tt.recommend_quant_block(nb) == jt.recommend_quant_block(nb)
    for pref in (4096, 1 << 20, 1 << 24):
        assert tt.recommend_segment_size(pref) == \
            jt.recommend_segment_size(pref)
    assert tt.recommend_rma_eager_max() == jt.recommend_rma_eager_max()


def _observations(seed: int, n: int = 600):
    rng = random.Random(seed)
    out = []
    for _ in range(n):
        op = rng.choice(["allreduce", "allgather", "reduce_scatter",
                         "bcast", "gather"])
        algs = _algs(op)
        out.append((op, rng.choice([2, 4, 8]), rng.choice(SIZES[4:24]),
                    rng.choice(algs), rng.uniform(1e-6, 5e-3),
                    0 if rng.random() > 0.05 else 1))
    return out


@pytest.mark.parametrize("topo", ["default", "two_tier", "three_tier"])
def test_tuner_learns_the_same_from_one_observe_sequence(topo):
    jt, tt = JTuner(topology=J_TOPOS[topo]), TTuner(topology=T_TOPOS[topo])
    for op, w, nb, alg, dt, err in _observations(11):
        assert tt.observe(op, w, nb, alg, dt, err) == \
            jt.observe(op, w, nb, JA(int(alg)), dt, err)
        q = bool(int(dt * 1e6) % 2)
        assert tt.observe_wire(op, w, nb, q, dt, err) == \
            jt.observe_wire(op, w, nb, q, dt, err)
        assert tt.observe_rma_put(nb, q, dt, err) == \
            jt.observe_rma_put(nb, q, dt, err)
    jt.refresh()
    tt.refresh()
    assert tt.entries() == jt.entries()
    assert tt.describe() == jt.describe()
    for op in ("allreduce", "allgather", "reduce_scatter", "bcast"):
        for w in (2, 4, 8):
            for nb in SIZES[4:24]:
                assert tt.select(op, w, nb).name == \
                    jt.select(op, w, nb).name, (op, w, nb)
                assert tt.select_wire(op, w, nb) == \
                    jt.select_wire(op, w, nb)
    assert tt.recommend_rma_eager_max() == jt.recommend_rma_eager_max()


class _Rec:
    def __init__(self, op, nbytes, algorithm, duration_s, comm_id=0):
        self.op, self.nbytes, self.algorithm = op, nbytes, algorithm
        self.duration_s, self.comm_id, self.error_word = \
            duration_s, comm_id, 0


def test_ingest_records_pins_and_clear_match():
    recs = [_Rec("allreduce", 1 << k, a, 1e-4 * (k + i))
            for k in range(8, 14) for i, a in
            enumerate(["RING", "FUSED_RING", "AUTO", "bogus"])]
    jt, tt = JTuner(), TTuner()
    assert tt.ingest_records(recs, 4, {0: 4}) == \
        jt.ingest_records(recs, 4, {0: 4})
    tt.pin("allgather", 8, 12, TA.ROUND_ROBIN)
    jt.pin("allgather", 8, 12, JA.ROUND_ROBIN)
    assert tt.entries() == jt.entries()
    with pytest.raises(ValueError) as te:
        tt.pin("scatter", 4, 3, TA.RING)
    with pytest.raises(ValueError) as je:
        jt.pin("scatter", 4, 3, JA.RING)
    assert str(te.value) == str(je.value)
    tt.clear_pins()
    jt.clear_pins()
    tt.clear_measurements()
    jt.clear_measurements()
    assert tt.entries() == jt.entries() == []
    assert tt.plan_cache_stats() == jt.plan_cache_stats()


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_exploration_picks_equal_for_one_seed(seed):
    topo = "two_tier"
    jt = JTuner(topology=J_TOPOS[topo], epsilon=0.4, seed=seed)
    tt = TTuner(topology=T_TOPOS[topo], epsilon=0.4, seed=seed)

    def picks_total():
        return sum(METRICS.snapshot()["counters"].get(
            "tuner_exploration_picks_total", {}).values())

    before = picks_total()
    picks = []
    for rnd in range(3):
        for op in ("allreduce", "allgather", "reduce_scatter", "bcast",
                   "gather", "reduce"):
            for w in (2, 4, 8):
                for nb in SIZES[::2]:
                    got, want = tt.select(op, w, nb), jt.select(op, w, nb)
                    assert got.name == want.name, (rnd, op, w, nb)
                    picks.append(got.name)
        tt.refresh()
        jt.refresh()
    assert picks_total() > before     # exploration drew and was counted
    assert "HIERARCHICAL" in picks


def _pins(t) -> dict:
    return {k: a.name for k, a in t._pinned.items()}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_tuning_table_round_trips_between_packages(tmp_path, writer):
    path = str(tmp_path / "table.json")
    jt, tt = JTuner(topology=J_TOPOS["emu"]), TTuner(topology=T_TOPOS["emu"])
    for op, w, nb, alg, dt, err in _observations(5, 300):
        jt.observe(op, w, nb, JA(int(alg)), dt, err)
        tt.observe(op, w, nb, alg, dt, err)
    src, dst_mod = (jt, tcache) if writer == "reference" else (tt, jcache)
    (jcache if writer == "reference" else tcache).save(src, path)
    fresh = TTuner() if writer == "reference" else JTuner()
    n = dst_mod.load_into(fresh, path)
    assert n == len(src.entries()) > 0
    assert _pins(fresh) == {(e["op"], e["world"], e["bucket"]):
                            e["algorithm"] for e in src.entries()}
    assert dataclasses.asdict(fresh.topology) == \
        dataclasses.asdict(src.topology)
    # the tier guard refuses a table measured on another tier, alike
    other_t = TTuner(topology=T_TOPOS["default"])
    other_j = JTuner(topology=J_TOPOS["default"])
    assert tcache.load_into(other_t, path) == \
        jcache.load_into(other_j, path) == 0


def test_cache_env_var_and_bad_tables_match(tmp_path, monkeypatch):
    assert tcache.ENV_VAR == jcache.ENV_VAR
    assert tcache.SCHEMA_VERSION == jcache.SCHEMA_VERSION
    path = tmp_path / "t.json"
    monkeypatch.setenv(tcache.ENV_VAR, str(path))
    assert tcache.default_cache_path() == jcache.default_cache_path()
    path.write_text('{"version": 99, "entries": []}')
    assert tcache.load() == jcache.load()
    with pytest.raises(ValueError) as te:
        tcache.load(strict=True)
    with pytest.raises(ValueError) as je:
        jcache.load(strict=True)
    assert str(te.value) == str(je.value)
    monkeypatch.delenv(tcache.ENV_VAR)
    with pytest.raises(ValueError) as te:
        tcache.save(TTuner())
    with pytest.raises(ValueError) as je:
        jcache.save(JTuner())
    assert str(te.value) == str(je.value)


def test_async_quiescence_counts():
    t = TTuner()
    assert t.quiescent()
    t.note_async_issue()
    assert not t.quiescent()
    t.note_async_retire()
    assert t.quiescent()
