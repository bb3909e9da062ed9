"""The port's kernels against the reference's, on the CPU.

The same numpy inputs (made from a seed) go through ``accl_tpu.ops``
(Pallas in interpret mode, as tests/test_pallas_quant.py runs it) and
through ``accl_tpu_torch.ops`` on CPU tensors, where each kernel
wrapper runs its plain PyTorch version. Every comparison is bitwise.
The CUDA kernels themselves are held against these plain versions on
the card by ``chip_smoke.py``.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from accl_tpu.constants import ReduceFunc as JRF  # noqa: E402
from accl_tpu.ops.combine import combine as j_combine  # noqa: E402
from accl_tpu.ops import compression as jcomp  # noqa: E402
from accl_tpu_torch import convert  # noqa: E402
from accl_tpu_torch.constants import ReduceFunc  # noqa: E402
from accl_tpu_torch.ops.combine import combine as t_combine  # noqa: E402
from accl_tpu_torch.ops import compression as tcomp  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


WIRES = ["int8", "float8_e4m3fn", "float8_e5m2"]
FUNCS = list(ReduceFunc)
NP_FUNCS = {ReduceFunc.SUM: np.add, ReduceFunc.MAX: np.maximum,
            ReduceFunc.MIN: np.minimum, ReduceFunc.PROD: np.multiply}


def _bits(a: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(a)
    return a.view({1: np.uint8, 2: np.uint16, 4: np.uint32,
                   8: np.uint64}[a.itemsize])


def assert_bitwise(got, ref, what: str, nan_sign: bool = True):
    """Bit for bit; with ``nan_sign=False`` a NaN matches a NaN of any
    sign and payload (f32 values) and a NaN code any NaN code of the
    same wire (uint8 fp8 codes: pass ``nan_codes``)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    gb, rb = _bits(got), _bits(ref)
    bad = gb != rb
    if not nan_sign:
        bad &= ~(np.isnan(got) & np.isnan(ref))
    assert not bad.any(), (
        f"{what}: {int(bad.sum())}/{bad.size} bit mismatches, first at "
        f"{int(np.argmax(bad))}: got {gb[bad][:4]} ref {rb[bad][:4]}")


def edge_corpus(seed: int = 3, n: int = 9000) -> np.ndarray:
    """Scale-mixed values from denormal-producing to overflow-producing
    block scales, seeded with NaN, +-inf, +-0, f32 denormals, values past
    every qmax and an all-zero block; ``n`` is ragged for every block."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(n).astype(np.float32)
         * np.float32(10.0) ** rng.integers(-24, 24, n).astype(np.float32))
    specials = np.array([np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-40, -3e-42,
                         500.0, -1e5, 7e4] * 4, np.float32)
    x = np.concatenate([x, specials])
    rng.shuffle(x)
    return np.concatenate([np.zeros(4096, np.float32), x])


def _np_wire(name):
    return np.dtype(np.int8) if name == "int8" else \
        np.dtype(getattr(ml_dtypes, name))


# -- B1 combine --------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "int32", "bfloat16"])
@pytest.mark.parametrize("func", FUNCS, ids=lambda f: f.name)
def test_combine_matches_reference(dtype, func):
    rng = np.random.default_rng(11 + int(func))
    n = 3000
    if dtype == "int32":
        a = rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64)
        b = rng.integers(-2 ** 31, 2 ** 31 - 1, n, dtype=np.int64)
        a, b = a.astype(np.int32), b.astype(np.int32)
    else:
        a = rng.standard_normal(n).astype(np.float32) * 100
        b = rng.standard_normal(n).astype(np.float32) * 100
    if dtype == "bfloat16":
        ja, jb = jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16)
        ta = torch.from_numpy(a).to(torch.bfloat16)
        tb = torch.from_numpy(b).to(torch.bfloat16)
    else:
        ja, jb = jnp.asarray(a), jnp.asarray(b)
        ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ref = np.asarray(j_combine(ja, jb, JRF(int(func))))
    got = t_combine(ta, tb, func)
    if dtype == "bfloat16":
        got, ref = got.view(torch.int16).numpy(), ref.view(np.int16)
    assert_bitwise(got.numpy() if isinstance(got, torch.Tensor) else got,
                   ref, f"combine {func.name} {dtype}")


def test_combine_nan_and_signed_zero_follow_jnp():
    a = np.array([0.0, -0.0, np.nan, 1.0, -np.nan, np.inf, -0.0],
                 np.float32)
    b = np.array([-0.0, 0.0, 1.0, np.nan, 2.0, np.nan, -0.0], np.float32)
    for func in (ReduceFunc.MAX, ReduceFunc.MIN):
        ref = np.asarray(j_combine(jnp.asarray(a), jnp.asarray(b),
                                          JRF(int(func))))
        got = t_combine(torch.from_numpy(a), torch.from_numpy(b),
                               func).numpy()
        assert_bitwise(got, ref, f"combine {func.name} specials")


def test_combine_rows_in_place_counts_no_launch_on_cpu():
    before = t_combine.launches
    rows = [torch.arange(5, dtype=torch.float32) + r for r in range(3)]
    other = [torch.ones(5) for _ in range(3)]
    out = t_combine(rows, other, ReduceFunc.SUM, out=rows)
    assert out[0] is rows[0]
    assert torch.equal(rows[2], torch.arange(5, dtype=torch.float32) + 3)
    assert t_combine.launches == before   # CPU: plain version


# -- B5 / B6 / B7 block-scale codec ------------------------------------------

@pytest.mark.parametrize("block", [32, 128, 4096])
@pytest.mark.parametrize("wire", WIRES)
def test_bs_quantize_matches_reference(wire, block):
    x = edge_corpus(5 + block)
    jq, js = jcomp.bs_quantize(jnp.asarray(x), _np_wire(wire), block)
    tq, ts = tcomp.bs_quantize(torch.from_numpy(x), wire, block)
    codes, scales = convert.wire_to_numpy(tq, ts)
    assert tq.dtype == getattr(torch, wire)
    assert_bitwise(codes, np.asarray(jq).view(np.uint8), f"q {wire}/{block}")
    assert_bitwise(scales, np.asarray(js), f"scales {wire}/{block}")


@pytest.mark.parametrize("block", [32, 128, 4096])
@pytest.mark.parametrize("wire", WIRES)
def test_bs_dequantize_matches_reference(wire, block):
    x = edge_corpus(7 + block)
    jq, js = jcomp.bs_quantize(jnp.asarray(x), _np_wire(wire), block)
    ref = np.asarray(jcomp.bs_dequantize(jq, js, block))
    (tq,) = convert.from_reference([np.asarray(jq).view(np.uint8)],
                                   "cpu", wire)
    got = tcomp.bs_dequantize(tq, torch.from_numpy(np.asarray(js)), block)
    assert_bitwise(got.numpy(), ref, f"dequant {wire}/{block}")


def _no_denormals(x: np.ndarray) -> np.ndarray:
    tiny = (np.abs(x) < np.float32(1.1754944e-38)) & (x != 0)
    return np.where(tiny, np.float32(0.0), x)


def assert_bitwise_ftz(got, ref, what: str, nan_sign: bool = True):
    """Bitwise, except where the reference flushed an f32 denormal
    result to zero: XLA on the CPU runs with flush-to-zero and
    denormals-are-zero, while the port (on the CPU and the card alike)
    and the reference's own numpy codec (accl_tpu/quant.py) keep them."""
    got, ref = np.asarray(got), np.asarray(ref)
    flushed = (np.abs(got) < np.float32(1.1754944e-38)) & (ref == 0)
    assert_bitwise(np.where(flushed, ref, got), ref, what, nan_sign)


def nan_codes_merged(codes: np.ndarray, wire: str) -> np.ndarray:
    """fp8 codes with every NaN code (either sign) mapped to 0x7F."""
    if wire == "int8":
        return codes
    mag = codes & 0x7F
    nan = mag == 0x7F if wire == "float8_e4m3fn" else mag > 0x7C
    return np.where(nan, np.uint8(0x7F), codes).astype(np.uint8)


# B7's kernel takes a block of at most 128 by warp shuffles, one up to a
# tile (1024) through shared memory, a larger one over several steps a
# thread: the plain version is held at a block of each (the corpus is
# ragged for every one)
COMBINE_BLOCKS = [32, 128, 1024, 4096]


@pytest.mark.parametrize("block", COMBINE_BLOCKS)
@pytest.mark.parametrize("func", FUNCS, ids=lambda f: f.name)
@pytest.mark.parametrize("wire", WIRES)
def test_bs_combine_matches_reference(wire, func, block):
    """B7 against the Pallas kernel on denormal-free inputs (and against
    the reference's numpy codec on the full corpus, denormals included,
    in the next test). The sign of a NaN is compared with the numpy
    codec only: IEEE 754 leaves it unspecified, and XLA:CPU's fp8 -> f32
    widening keeps it on some code paths and drops it on others (a
    ragged e5m2 payload of -NaN codes widens to +NaN), so the Pallas
    reference's NaN signs follow its code generation, not the codec."""
    x = _no_denormals(edge_corpus(9 + int(func)))
    other = _no_denormals(edge_corpus(21 + int(func))[::-1].copy())
    jq, js = jcomp.bs_quantize(jnp.asarray(x), _np_wire(wire), block)
    (tq,) = convert.from_reference([np.asarray(jq).view(np.uint8)],
                                   "cpu", wire)
    ts, tother = torch.from_numpy(np.asarray(js)), torch.from_numpy(other)
    jq2, js2 = jcomp.bs_combine_requant(jq, js, jnp.asarray(other),
                                        JRF(int(func)), _np_wire(wire),
                                        block)
    tq2, ts2 = tcomp.bs_combine_requant(tq, ts, tother, func, wire, block)
    codes, scales = convert.wire_to_numpy(tq2, ts2)
    assert_bitwise(nan_codes_merged(codes, wire),
                   nan_codes_merged(np.asarray(jq2).view(np.uint8), wire),
                   f"requant q {wire} {func.name}")
    assert_bitwise(scales, np.asarray(js2), f"requant s {wire} {func.name}",
                   nan_sign=False)
    ref = np.asarray(jcomp.bs_dequant_combine(jq, js, jnp.asarray(other),
                                              JRF(int(func)), block))
    got = tcomp.bs_dequant_combine(tq, ts, tother, func, block)
    assert_bitwise_ftz(got.numpy(), ref, f"dequant-combine {wire} {func.name}",
                       nan_sign=False)


@pytest.mark.parametrize("block", COMBINE_BLOCKS)
@pytest.mark.parametrize("func", FUNCS, ids=lambda f: f.name)
@pytest.mark.parametrize("wire", WIRES)
def test_bs_combine_matches_numpy_codec_with_denormals(wire, func, block):
    from accl_tpu import quant
    x = edge_corpus(9 + int(func))
    other = edge_corpus(21 + int(func))[::-1].copy()
    s, q = quant._np_quantize(x, _np_wire(wire), block)
    with np.errstate(all="ignore"):
        acc = NP_FUNCS[func](other, quant._np_dequant(s, q, block))
        s2, q2 = quant._np_quantize(acc, _np_wire(wire), block)
    (tq,) = convert.from_reference([q.view(np.uint8)], "cpu", wire)
    ts, tother = torch.from_numpy(s), torch.from_numpy(other)
    got = tcomp.bs_dequant_combine(tq, ts, tother, func, block).numpy()
    codes, scales = convert.wire_to_numpy(
        *tcomp.bs_combine_requant(tq, ts, tother, func, wire, block))
    ref_codes = q2.view(np.uint8)
    if func in (ReduceFunc.MAX, ReduceFunc.MIN):
        # np.maximum/np.minimum return the first operand on a +-0 tie;
        # the port follows jnp (-0 orders below +0): compare zeros unsigned
        got, acc = got + np.float32(0), acc + np.float32(0)
        if wire != "int8":
            codes = np.where(codes == 0x80, 0, codes).astype(np.uint8)
            ref_codes = np.where(ref_codes == 0x80, 0, ref_codes)
    assert_bitwise(got, acc, f"dequant-combine {wire} {func.name}")
    assert_bitwise(codes, ref_codes.astype(np.uint8),
                   f"requant q {wire} {func.name}")
    assert_bitwise(scales, s2, f"requant s {wire} {func.name}")


@pytest.mark.parametrize("wire", ["float8_e4m3fn", "float8_e5m2"])
def test_fp8_encoder_matches_ml_dtypes_dense(wire):
    """Every f16-representable value (a dense sweep over every fp8
    rounding boundary, overflow and denormal) encodes to the ml_dtypes
    round-to-nearest-even code; every code decodes exactly."""
    v = np.arange(0, 1 << 16, dtype=np.uint32).astype(np.uint16)
    v = v.view(np.float16).astype(np.float32)
    ref = v.astype(_np_wire(wire)).view(np.uint8)
    got = tcomp.encode_ref(torch.from_numpy(v), wire).numpy()
    finite = np.isfinite(v)
    assert_bitwise(got[finite], ref[finite], f"encode {wire}")
    codes = np.arange(256, dtype=np.uint8)
    dec = tcomp.decode_ref(torch.from_numpy(codes), wire).numpy()
    ref_dec = np.asarray(jnp.asarray(codes.view(_np_wire(wire)))
                         .astype(jnp.float32))
    assert_bitwise(dec, ref_dec, f"decode {wire}")


def test_wrappers_validate_rows():
    x = [torch.zeros(256), torch.zeros(128)]
    with pytest.raises(ValueError):
        tcomp.bs_quant(x, "int8", 32)
    with pytest.raises(ValueError):
        tcomp.bs_quantize(torch.zeros(64), "float16", 32)
    with pytest.raises(TypeError):
        tcomp.bs_quant([torch.zeros(64, dtype=torch.float64)], "int8", 32)


@pytest.mark.parametrize("kernel", ["combine", "bs_quant", "bs_dequant",
                                    "bs_combine"])
def test_wrappers_take_plain_version_only_for_cpu_tensors(kernel):
    """A tensor off the CPU goes to the kernel or raises: the plain
    version never runs for it and no launch is counted."""
    x = torch.zeros(256, device="meta")
    q = torch.zeros(256, dtype=torch.uint8, device="meta")
    s = torch.ones(8, device="meta")
    fn = t_combine if kernel == "combine" else getattr(tcomp, kernel)
    before = fn.launches
    with pytest.raises(ValueError, match="no kernel for device"):
        if kernel == "combine":
            fn(x, x, ReduceFunc.SUM)
        elif kernel == "bs_quant":
            fn([x], "int8", 32)
        elif kernel == "bs_dequant":
            fn([q], [s], "int8", 32)
        else:
            fn([q], [s], [x], ReduceFunc.SUM, "int8", 32)
    assert fn.launches == before
