"""The port's per-tensor wire lanes against the reference's, on the CPU.

The same numpy inputs (made from a seed) go through ``accl_tpu`` (Pallas
in interpret mode, or the jnp codec under ``jit`` as the collectives
trace it) and through ``accl_tpu_torch`` on CPU tensors, where each
kernel wrapper runs its plain PyTorch version:

* B2 ``cast`` / ``cast_lane``, B3 ``fp8_quant`` (with its amax ->
  scale -> inverse step) and B4 ``fp8_dequant``: bitwise. A NaN result
  may differ from the reference's in its sign only where XLA widens an
  e5m2 NaN and drops the sign (IEEE 754 leaves a NaN's sign
  unspecified); those positions must be NaN on both sides.
* Per-tensor rings (``MeshCollectives(..., algorithm="ring")``):
  bitwise, except SUM over an fp8 wire, where XLA:CPU contracts the
  reference's dequantize-multiply and add into one fma rounding; there
  the port equals a numpy oracle of the unfused codec bitwise, and the
  reference within W fp8 quanta of the result's magnitude.
* The xla-compressed family: within rtol=1e-6, atol=1e-6 (the reduction
  order over ranks differs); the allgather bitwise.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from accl_tpu.constants import ReduceFunc as JRF  # noqa: E402
from accl_tpu.ops import compression as jcomp  # noqa: E402
from accl_tpu.parallel.collectives import MeshCollectives  # noqa: E402
from accl_tpu.parallel.mesh import cpu_mesh  # noqa: E402
from accl_tpu_torch import convert  # noqa: E402
from accl_tpu_torch.constants import ReduceFunc  # noqa: E402
from accl_tpu_torch.ops import compression as tcomp  # noqa: E402
from accl_tpu_torch.parallel.collectives import (  # noqa: E402
    PLAIN, RankCollectives)
from accl_tpu_torch.parallel.mesh import make_group  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


W = 4
WIRES = ["float16", "bfloat16", "float8_e4m3fn", "float8_e5m2"]
FP8 = ["float8_e4m3fn", "float8_e5m2"]
FUNCS = list(ReduceFunc)


def _np_dtype(name: str):
    return np.dtype(np.float16) if name == "float16" else \
        np.dtype(getattr(ml_dtypes, name))


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32}[a.itemsize])


def _tbits(t: torch.Tensor) -> np.ndarray:
    iv = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[t.element_size()]
    return _bits(t.contiguous().view(iv).numpy())


def assert_same(got: np.ndarray, ref: np.ndarray, what: str,
                nan_sign: bool = True):
    """Bit for bit; with ``nan_sign=False`` a NaN matches a NaN of any
    sign and payload (f32 results only)."""
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    gb, rb = _bits(got), _bits(ref)
    bad = gb != rb
    if not nan_sign:
        bad &= ~(np.isnan(got) & np.isnan(ref))
    assert not bad.any(), (
        f"{what}: {int(bad.sum())}/{bad.size} mismatches, first at "
        f"{int(np.argmax(bad))}: got {gb[bad][:4]} ref {rb[bad][:4]}")


def edge_corpus(seed: int, n: int = 9000, nan: bool = True) -> np.ndarray:
    """Every magnitude from f32 denormals to past every wire's max, with
    NaN payloads, +-inf, +-0 and values on f16 / fp8 rounding edges;
    ``n`` is ragged for every tiling."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n).astype(np.float32)
         * np.float32(10.0) ** rng.integers(-40, 39, n).astype(np.float32))
    specials = np.array([np.inf, -np.inf, 0.0, -0.0, 1e-40, -3e-42, 448.0,
                         464.0, 480.0, 57344.0, 61440.0, 65504.0, 65520.0,
                         -65519.0, 6e-8, 2.9e-8, 1e38], np.float32)
    nans = np.array([0x7FC00000, 0xFFC00000, 0x7F800001, 0xFF800001,
                     0x7FBFFFFF, 0x7F802000], np.uint32).view(np.float32)
    x = np.concatenate([x, specials] + ([nans] if nan else []))
    rng.shuffle(x)
    return x


# -- B2 cast ---------------------------------------------------------------

@pytest.mark.parametrize("wire", WIRES)
def test_cast_down_matches_reference(wire):
    x = edge_corpus(5)
    ref = np.asarray(jcomp.cast_lane(jnp.asarray(x), _np_dtype(wire)))
    got = tcomp.cast_lane(torch.from_numpy(x), wire)
    assert got.dtype == getattr(torch, wire)
    assert_same(_tbits(got), _bits(ref), f"f32 -> {wire}")


@pytest.mark.parametrize("wire", WIRES)
def test_cast_up_matches_reference_on_every_code(wire):
    bits = 8 if wire in FP8 else 16
    codes = np.arange(1 << bits, dtype=np.uint64).astype(
        np.uint8 if bits == 8 else np.uint16)
    ref = np.asarray(jcomp.cast_lane(
        jnp.asarray(codes.view(_np_dtype(wire))), jnp.float32))
    t = torch.from_numpy(codes.view(np.int16) if bits == 16 else codes)
    got = tcomp.cast_lane(t.view(getattr(torch, wire)), torch.float32)
    assert_same(got.numpy(), ref, f"{wire} -> f32")


@pytest.mark.parametrize("wire", WIRES)
def test_cast_roundtrip_of_corpus(wire):
    """Down and back up over the corpus (a ragged length: the reference
    pads the tile, and then drops an e5m2 NaN's sign)."""
    x = edge_corpus(6)
    down = jcomp.cast_lane(jnp.asarray(x), _np_dtype(wire))
    ref = np.asarray(jcomp.cast_lane(down, jnp.float32))
    got = tcomp.cast_lane(tcomp.cast_lane(torch.from_numpy(x), wire),
                          torch.float32).numpy()
    assert_same(got, ref, f"f32 -> {wire} -> f32", nan_sign=False)
    # the lane is idempotent: a second trip changes nothing
    again = tcomp.cast_lane(tcomp.cast_lane(torch.from_numpy(got), wire),
                            torch.float32).numpy()
    assert_same(again, got, f"{wire} second trip")


def test_cast_rejects_pairs_without_float32():
    with pytest.raises(TypeError):
        tcomp.cast([torch.zeros(4, dtype=torch.float16)], torch.bfloat16)
    with pytest.raises(TypeError):
        tcomp.cast([torch.zeros(4)], torch.int8)


# -- B3 / B4: the per-tensor fp8 codec --------------------------------------

def _scaled_inputs(seed: int, count: int = 40):
    """Payloads at every decade of scale, ragged lengths, no NaN."""
    rng = np.random.default_rng(seed)
    for t in range(count):
        n = int(rng.integers(1, 3000))
        yield (rng.standard_normal(n)
               * 10.0 ** rng.integers(-30, 30)).astype(np.float32)


@pytest.mark.parametrize("wire", FP8)
def test_compress_fp8_matches_pallas_reference(wire):
    for x in _scaled_inputs(11):
        jq, js = jcomp.compress_fp8(jnp.asarray(x), _np_dtype(wire))
        tq, ts = tcomp.compress_fp8(torch.from_numpy(x), wire)
        assert tuple(ts.shape) == (1, 1)
        assert_same(_tbits(tq), _bits(np.asarray(jq)), f"codes {wire}")
        assert_same(ts.numpy(), np.asarray(js), f"scale {wire}")
        ref = np.asarray(jcomp.decompress_fp8(jq, js))
        got = tcomp.decompress_fp8(tq, ts).numpy()
        assert_same(got, ref, f"decompress {wire}")


@pytest.mark.parametrize("axes", [None, "tail"])
@pytest.mark.parametrize("wire", FP8)
def test_fp8_quantize_matches_traced_reference(wire, axes):
    """The jnp codec as the collectives trace it (under jit)."""
    ax = None if axes is None else (1,)
    quant = jax.jit(lambda v: jcomp.fp8_quantize(v, _np_dtype(wire), ax))
    deq = jax.jit(jcomp.fp8_dequantize)
    for x in _scaled_inputs(12, 25):
        x = np.resize(x, (4, x.size // 4 + 1))
        jq, js = quant(jnp.asarray(x))
        tq, ts = tcomp.fp8_quantize(torch.from_numpy(x.copy()), wire, ax)
        assert tuple(ts.shape) == np.asarray(js).shape
        assert_same(_tbits(tq), _bits(np.asarray(jq)), f"codes {wire}")
        assert_same(ts.numpy(), np.asarray(js), f"scales {wire}")
        assert_same(tcomp.fp8_dequantize(tq, ts).numpy(),
                    np.asarray(deq(jq, js)), f"dequantize {wire}")


@pytest.mark.parametrize("wire", FP8)
def test_fp8_scale_is_a_reciprocal_multiply(wire):
    """The reference's scale under jit is amax * f32(1/fp8_max): XLA folds
    the division by the constant. Over these amax values an IEEE division
    gives another scale in many cases, so a port that divides fails."""
    fp8_max = float(ml_dtypes.finfo(_np_dtype(wire)).max)
    rng = np.random.default_rng(13)
    amax = (rng.random(400) * 10.0 ** rng.integers(-20, 20, 400)).astype(
        np.float32)
    x = np.zeros((400, 8), np.float32)
    x[:, 3] = -amax
    jq, js = jax.jit(lambda v: jcomp.fp8_quantize(
        v, _np_dtype(wire), (1,)))(jnp.asarray(x))
    _, ts = tcomp.fp8_quantize(torch.from_numpy(x), wire, (1,))
    mult = np.maximum(amax * np.float32(1.0 / fp8_max), np.float32(1e-30))
    div = np.maximum(amax / np.float32(fp8_max), np.float32(1e-30))
    assert_same(np.asarray(js), mult, "reference scale = reciprocal multiply")
    assert_same(ts.numpy(), mult, "port scale = reciprocal multiply")
    assert (div.view(np.uint32) != mult.view(np.uint32)).sum() > 20


@pytest.mark.parametrize("wire", FP8)
def test_fp8_nan_poisons_the_tensor_and_scale_floor_holds(wire):
    x = np.linspace(-3, 3, 64).astype(np.float32)
    x[17] = np.nan
    q, s = tcomp.fp8_quantize(torch.from_numpy(x), wire)
    assert np.isnan(float(s))
    assert np.isnan(tcomp.fp8_dequantize(q, s).numpy()).all()
    q, s = tcomp.fp8_quantize(torch.zeros(9), wire)     # amax 0
    assert float(s) == np.float32(1e-30)
    assert not tcomp.fp8_dequantize(q, s).numpy().any()


@pytest.mark.parametrize("wire", WIRES)
def test_wire_compress_dispatch_matches_reference(wire):
    x = next(_scaled_inputs(14, 1))
    jp, jaux = jcomp.wire_compress(jnp.asarray(x), _np_dtype(wire))
    tp, taux = tcomp.wire_compress(torch.from_numpy(x), wire)
    assert (jaux is None) == (taux is None) == (wire not in FP8)
    assert_same(_tbits(tp), _bits(np.asarray(jp)), f"payload {wire}")
    ref = np.asarray(jcomp.wire_decompress(jp, jaux, jnp.float32))
    assert_same(tcomp.wire_decompress(tp, taux, torch.float32).numpy(), ref,
                f"decompress {wire}")
    t = torch.from_numpy(x)
    assert tcomp.wire_compress(t, torch.float32) == (t, None)


@pytest.mark.parametrize("wire", WIRES)
def test_wire_payloads_cross_between_numpy_and_torch(wire):
    """convert: the reference's wire payloads (codes and fp8 scales)
    enter the port and leave it again bit for bit."""
    x = next(_scaled_inputs(15, 1))
    jp, jaux = jcomp.wire_compress(jnp.asarray(x), _np_dtype(wire))
    (tp,) = convert.from_reference([np.asarray(jp)], "cpu", wire)
    assert tp.dtype == getattr(torch, wire)
    codes, scales = convert.wire_to_numpy(
        tp, None if jaux is None else torch.from_numpy(np.asarray(jaux)))
    assert_same(codes, _bits(np.asarray(jp)), f"codes {wire}")
    assert (scales is None) == (jaux is None)
    ref = np.asarray(jcomp.wire_decompress(jp, jaux, jnp.float32))
    got = tcomp.wire_decompress(
        tp, None if jaux is None else torch.from_numpy(scales), torch.float32)
    assert_same(got.numpy(), ref, f"decompress {wire}")


@pytest.mark.parametrize("kernel", ["cast", "fp8_scale", "fp8_quant",
                                    "fp8_dequant"])
def test_lane_wrappers_take_plain_version_only_for_cpu_tensors(kernel):
    x = torch.zeros(64, device="meta")
    one = torch.ones(1, device="meta")
    q = torch.zeros(64, dtype=torch.uint8, device="meta")
    fn = getattr(tcomp, kernel)
    before = fn.launches
    with pytest.raises(ValueError, match="no kernel for device"):
        if kernel == "cast":
            fn([x], torch.float16)
        elif kernel == "fp8_scale":
            fn([x], "float8_e4m3fn")
        elif kernel == "fp8_quant":
            fn([x], [one], "float8_e4m3fn")
        else:
            fn([q], [one], "float8_e4m3fn")
    assert fn.launches == before
    cpu = [torch.ones(64)]
    s, inv = tcomp.fp8_scale(cpu, "float8_e5m2")
    tcomp.fp8_dequant(tcomp.fp8_quant(cpu, inv, "float8_e5m2"), s,
                      "float8_e5m2")
    tcomp.cast(cpu, torch.bfloat16)
    assert all(getattr(tcomp, k).launches == 0 for k in
               ("cast", "fp8_scale", "fp8_quant", "fp8_dequant"))


# -- per-tensor rings --------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_coll():
    return MeshCollectives(cpu_mesh(W))


@pytest.fixture(scope="module")
def rank_coll():
    return RankCollectives(make_group(W, "cpu"))


def _ring_inputs(op: str, func: ReduceFunc, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = {"allreduce": W * 250 - 3, "reduce_scatter": W * 250,
         "allgather": 250}[op]
    x = rng.standard_normal((W, n)).astype(np.float32)
    if func == ReduceFunc.PROD:
        x = (1.0 + 0.05 * x).astype(np.float32)
    return x


def _fp8_hop(sent: np.ndarray, wd) -> np.ndarray:
    """One unfused per-tensor fp8 hop: quantize with one reciprocal-
    multiply scale, dequantize to f32 (one rounding)."""
    rcp = np.float32(1.0 / float(ml_dtypes.finfo(wd).max))
    s = np.maximum(np.abs(sent).max() * rcp, np.float32(1e-30))
    q = (sent * (np.float32(1.0) / s)).astype(wd)
    return q.astype(np.float32) * s


def _oracle(op: str, x: np.ndarray, wire: str) -> np.ndarray:
    """numpy ring (SUM) over the unfused fp8 codec: each hop's partial
    lands in f32 before it is added to the local chunk; the allgather's
    relays re-encode every hop."""
    wd = _np_dtype(wire)
    n = x.shape[1]
    if op == "allreduce":
        x = np.pad(x, ((0, 0), (0, (-n) % W)))
    ch = x.reshape(W, W, -1)
    acc = [ch[r, (r + 1) % W] for r in range(W)]
    for i in range(1, W):
        landed = [_fp8_hop(sent, wd) for sent in acc]
        acc = [landed[(r + 1) % W] + ch[r, (r + 1 + i) % W]
               for r in range(W)]
    if op == "reduce_scatter":
        return np.stack(acc)
    out = np.zeros_like(ch)
    buf = acc
    for r in range(W):
        out[r, r] = acc[r]
    for i in range(1, W):
        landed = [_fp8_hop(sent, wd) for sent in buf]
        buf = [landed[(r + 1) % W] for r in range(W)]
        for r in range(W):
            out[r, (r + i) % W] = buf[r]
    return out.reshape(W, -1)[:, :n]


@pytest.mark.parametrize("func", FUNCS, ids=lambda f: f.name)
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("op", ["allreduce", "reduce_scatter"])
def test_ring_per_tensor_wire(mesh_coll, rank_coll, op, wire, func):
    x = _ring_inputs(op, func, 40 + int(func))
    ref = np.asarray(getattr(mesh_coll, op)(
        mesh_coll.shard(list(x)), func=JRF(int(func)), algorithm="ring",
        wire_dtype=_np_dtype(wire)))
    got = getattr(rank_coll, op)(torch.from_numpy(x), func=func,
                                 algorithm="ring", wire_dtype=wire).numpy()
    if func == ReduceFunc.SUM and wire in FP8:
        assert_same(got, _oracle(op, x, wire), f"{op} {wire} vs oracle")
        # the fma moves a partial by an ulp, which may move a later hop's
        # fp8 code by one quantum (2^-mantissa bits of the hop's amax)
        quantum = 2.0 ** -(3 if wire == "float8_e4m3fn" else 2)
        np.testing.assert_allclose(got, ref,
                                   atol=W * quantum * np.abs(ref).max())
        return
    assert_same(got, ref, f"{op} {wire} {func.name}")
    if func == ReduceFunc.SUM and op == "allreduce":   # really on the wire
        assert np.abs(got[0] - x.sum(0)).max() > 0


@pytest.mark.parametrize("wire", WIRES)
def test_ring_allgather_per_tensor_wire(mesh_coll, rank_coll, wire):
    """Bitwise; relays re-encode what they forward (a fresh fp8 scale per
    hop) and the own chunk lands exact."""
    x = _ring_inputs("allgather", ReduceFunc.SUM, 9)
    x[1] *= np.float32(1e3)      # chunks of different scales
    ref = np.asarray(mesh_coll.allgather(mesh_coll.shard(list(x)),
                                         algorithm="ring",
                                         wire_dtype=_np_dtype(wire)))
    got = rank_coll.allgather(torch.from_numpy(x), algorithm="ring",
                              wire_dtype=wire).numpy()
    assert_same(got, ref, f"allgather {wire}")
    n = x.shape[1]
    for r in range(W):
        assert_same(got[r, r * n:(r + 1) * n], x[r], "own chunk exact")


# -- the xla-compressed family -----------------------------------------------

@pytest.mark.parametrize("func", [ReduceFunc.SUM, ReduceFunc.MAX,
                                  ReduceFunc.MIN], ids=lambda f: f.name)
@pytest.mark.parametrize("wire", WIRES)
@pytest.mark.parametrize("op", ["allreduce", "reduce_scatter"])
def test_xla_compressed_within_tolerance(mesh_coll, rank_coll, op, wire,
                                         func):
    x = _ring_inputs(op, func, 60 + int(func))
    ref = np.asarray(getattr(mesh_coll, op)(
        mesh_coll.shard(list(x)), func=JRF(int(func)), algorithm="xla",
        wire_dtype=_np_dtype(wire)))
    got = getattr(rank_coll, op)(torch.from_numpy(x), func=func,
                                 algorithm="xla", wire_dtype=wire).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("wire", WIRES)
def test_xla_compressed_allgather_bitwise(mesh_coll, rank_coll, wire):
    x = _ring_inputs("allgather", ReduceFunc.SUM, 10)
    ref = np.asarray(mesh_coll.allgather(mesh_coll.shard(list(x)),
                                         algorithm="xla",
                                         wire_dtype=_np_dtype(wire)))
    got = rank_coll.allgather(torch.from_numpy(x), algorithm="xla",
                              wire_dtype=wire).numpy()
    assert_same(got, ref, f"xla allgather {wire}")


@pytest.mark.parametrize("wire", WIRES)
def test_plain_kernel_set_gives_the_same_rings(rank_coll, wire):
    x = torch.from_numpy(_ring_inputs("allreduce", ReduceFunc.SUM, 3))
    plain = RankCollectives(rank_coll.group, kernels=PLAIN)
    for alg in ("ring", "xla"):
        a = plain.allreduce(x, algorithm=alg, wire_dtype=wire)
        b = rank_coll.allreduce(x, algorithm=alg, wire_dtype=wire)
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
