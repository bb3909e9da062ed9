"""Reductions on fp8 payloads (e4m3fn, e5m2): the port against the reference.

* B1's plain version (``combine_ref``, which the kernel of
  ``csrc/combine.cu`` is held to bitwise on the card) against
  ``accl_tpu.ops.combine.combine`` over all 65,536 pairs of codes of each
  format, for each function: bitwise, NaN codes included (the kernel's
  rules reproduce XLA's NaN codes, and jnp's +-0 ties of MAX and MIN).
* The driver tier, ``cuda_world(4, device="cpu")`` against
  ``tpu_world(4, platform="cpu")``, host-mirror and device-resident:
  ``allreduce``, ``reduce_scatter`` and ``reduce`` on the ring and
  ``auto`` selectors, and the local ``combine``: bitwise. The ring rounds
  to fp8 at every hop (B1); the reference's xla family is a psum, which
  XLA folds in f16 in rank order and rounds once
  (``collectives.ordered_fold``).
* The one departure: the reference's xla ``reduce_scatter`` sums whatever
  its function (a psum_scatter; f32 alike), where the port reduces with
  MAX or MIN (ROADMAP §C2). Held here against the ring, which is exact
  for MAX and MIN.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

from accl_tpu.constants import ReduceFunc as JRF  # noqa: E402
from accl_tpu.device.tpu import tpu_world  # noqa: E402
from accl_tpu.ops.combine import combine as j_combine  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu_torch import cuda_world  # noqa: E402
from accl_tpu_torch.constants import ReduceFunc  # noqa: E402
from accl_tpu_torch.ops.combine import combine, combine_ref  # noqa: E402
from accl_tpu_torch.parallel.collectives import (PLAIN,  # noqa: E402
                                                 RankCollectives)
from accl_tpu_torch.parallel.mesh import RankGroup  # noqa: E402
from accl_tpu_torch.testing import run_ranks  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment."""
    yield


FORMATS = ("float8_e4m3fn", "float8_e5m2")
FUNCS = (ReduceFunc.SUM, ReduceFunc.MAX, ReduceFunc.MIN, ReduceFunc.PROD)
W = 4
N = 256


def _codes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().copy()
    return np.asarray(x).view(np.uint8).copy()


@pytest.mark.parametrize("func", FUNCS, ids=lambda f: f.name)
@pytest.mark.parametrize("fmt", FORMATS)
def test_b1_every_code_pair(fmt, func):
    """Every pair of codes, bitwise: the port's plain version (and the
    CPU wrapper) against the reference's Pallas kernel in interpret
    mode."""
    import jax.numpy as jnp
    codes = np.arange(256, dtype=np.uint8)
    a, b = np.repeat(codes, 256), np.tile(codes, 256)
    md = getattr(ml_dtypes, fmt)
    ref = _codes(j_combine(jnp.asarray(a.view(md)), jnp.asarray(b.view(md)),
                           JRF(int(func))))
    td = getattr(torch, fmt)
    ta, tb = torch.from_numpy(a).view(td), torch.from_numpy(b).view(td)
    got = _codes(combine_ref(ta, tb, func))
    bad = np.nonzero(got != ref)[0]
    assert bad.size == 0, (
        f"{fmt} {func.name}: {bad.size} pairs differ, e.g. "
        + ", ".join(f"{a[i]:02x}.{b[i]:02x}: {got[i]:02x} vs {ref[i]:02x}"
                    for i in bad[:4]))
    np.testing.assert_array_equal(_codes(combine(ta, tb, func)), got)


@pytest.fixture(scope="module")
def worlds():
    tw = tpu_world(W, platform="cpu")
    cw = cuda_world(W, device="cpu")
    yield tw, cw
    for a in tw + cw:
        a.deinit()


def _inputs(fmt: str, n: int, seed: int) -> list:
    """Per-rank fp8 payloads of scale 3: e4m3fn products overflow to NaN
    now and then, sums round at every step."""
    rng = np.random.default_rng(seed)
    md = getattr(ml_dtypes, fmt)
    return [(rng.standard_normal(n) * 3).astype(md) for _ in range(W)]


def _body(op, fmt, ins, n_in, func, alg, resident, jax_side, root=1):
    md, td = getattr(ml_dtypes, fmt), getattr(torch, fmt)

    def fn(a):
        x = ins[a.rank][:n_in]
        if jax_side:
            import jax.numpy as jnp
            src = (a.buffer(data=jnp.asarray(x)) if resident
                   else a.buffer(data=x.copy()))
            dst = a.buffer((N,), md, device_resident=resident)
            f = JRF(int(func))
        else:
            t = torch.from_numpy(x.view(np.uint8).copy()).view(td)
            src = a.buffer(data=t, device_resident=resident)
            dst = a.buffer((N,), td, device_resident=resident)
            f = func
        if op == "reduce":
            a.reduce(src, dst, N, root=root, func=f, algorithm=alg)
        else:
            getattr(a, op)(src, dst, N, func=f, algorithm=alg)
        return _codes(dst.data)
    return fn


CASES = [(op, alg, res) for op in ("allreduce", "reduce_scatter", "reduce")
         for alg in ("ring", "auto") for res in (False, True)]


@pytest.mark.parametrize("op,alg,resident", CASES,
                         ids=[f"{o}-{a}-{'resident' if r else 'host'}"
                              for o, a, r in CASES])
@pytest.mark.parametrize("fmt", FORMATS)
def test_driver_matches_tpu_world(worlds, fmt, op, alg, resident):
    """Each function on each path, bitwise (the root's row for reduce)."""
    tw, cw = worlds
    n_in = W * N if op == "reduce_scatter" else N
    ins = _inputs(fmt, W * N, len(op) + 7 * resident)
    for func in FUNCS:
        if (op == "reduce_scatter" and alg == "auto"
                and func in (ReduceFunc.MAX, ReduceFunc.MIN)):
            continue     # the reference sums: test_xla_reduce_scatter_*
        args = (op, fmt, ins, n_in, func, alg, resident)
        ref = j_run_ranks(tw, _body(*args, jax_side=True))
        got = run_ranks(cw, _body(*args, jax_side=False))
        for r in ([1] if op == "reduce" else range(W)):
            bad = int((got[r] != ref[r]).sum())
            assert bad == 0, f"{fmt} {op} {func.name} {alg} rank {r}: " \
                             f"{bad} of {N} codes differ"


@pytest.mark.parametrize("func", [ReduceFunc.MAX, ReduceFunc.MIN],
                         ids=lambda f: f.name)
@pytest.mark.parametrize("fmt", FORMATS)
def test_xla_reduce_scatter_reduces_with_its_function(worlds, fmt, func):
    """The port's xla reduce_scatter applies MAX and MIN (the reference's
    sums, f32 alike: ROADMAP §C2); on fp8 it equals the ring, which is
    exact for them, and differs from the sum."""
    _, cw = worlds
    ins = _inputs(fmt, W * N, 3)
    xla = run_ranks(cw, _body("reduce_scatter", fmt, ins, W * N, func,
                              "auto", True, False))
    ring = run_ranks(cw, _body("reduce_scatter", fmt, ins, W * N, func,
                               "ring", True, False))
    total = run_ranks(cw, _body("reduce_scatter", fmt, ins, W * N,
                                ReduceFunc.SUM, "auto", True, False))
    for r in range(W):
        np.testing.assert_array_equal(xla[r], ring[r])
        assert (xla[r] != total[r]).any()


@pytest.mark.parametrize("resident", [False, True],
                         ids=["host", "resident"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_local_combine_matches_tpu_world(worlds, fmt, resident):
    """The driver's local combine (B1 on the rank's own operands), every
    function, bitwise."""
    tw, cw = worlds
    md, td = getattr(ml_dtypes, fmt), getattr(torch, fmt)
    ins = _inputs(fmt, 2 * N, 11)

    def body(func, jax_side):
        def fn(a):
            x, y = ins[a.rank][:N], ins[a.rank][N:]
            if jax_side:
                import jax.numpy as jnp

                def buf(v):
                    return (a.buffer(data=jnp.asarray(v)) if resident
                            else a.buffer(data=v.copy()))
                res = a.buffer((N,), md, device_resident=resident)
                f = JRF(int(func))
            else:
                def buf(v):
                    return a.buffer(data=torch.from_numpy(
                        v.view(np.uint8).copy()).view(td),
                        device_resident=resident)
                res = a.buffer((N,), td, device_resident=resident)
                f = func
            a.combine(N, f, buf(x), buf(y), res)
            return _codes(res.data)
        return fn

    for func in FUNCS:
        ref = j_run_ranks(tw, body(func, True))
        got = run_ranks(cw, body(func, False))
        for r in range(W):
            np.testing.assert_array_equal(got[r], ref[r],
                                          err_msg=f"{fmt} {func.name}")


@pytest.mark.parametrize("fmt", FORMATS)
def test_xla_sum_is_the_f16_fold(fmt):
    """The port's xla SUM over fp8 rows rounds to f16 after each add in
    rank order and to fp8 once: it differs from one f32 sum rounded once
    only where f16 rounding moved a partial sum, and a ring (fp8 at every
    hop) differs more."""
    from accl_tpu_torch.ops.compression import decode_ref, encode_ref
    ins = _inputs(fmt, 4096, 5)
    td = getattr(torch, fmt)
    rows = [torch.from_numpy(x.view(np.uint8).copy()).view(td) for x in ins]
    coll = RankCollectives(RankGroup(W, torch.device("cpu")), PLAIN)
    got = coll.allreduce(rows, ReduceFunc.SUM, "xla")[0].view(torch.uint8)
    f = [decode_ref(r.view(torch.uint8), fmt) for r in rows]
    acc = f[0].half()
    for x in f[1:]:
        acc = (acc.float() + x).half()
    torch.testing.assert_close(got, encode_ref(acc.float(), fmt),
                               rtol=0, atol=0)
    ring = coll.allreduce(rows, ReduceFunc.SUM, "ring")[0].view(torch.uint8)
    assert (ring != got).any()
