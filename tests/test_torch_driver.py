"""The port's driver tier against the reference's, on the CPU.

``cuda_world(4, device="cpu")`` against ``tpu_world(4, platform="cpu")``
through ``run_ranks``: the three dense collectives with host-mirror and
device-resident buffers, at fp32 and on the fp8 block-scaled wire, plus
the error paths and the package's isolation from JAX.
"""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402

from accl_tpu.device.tpu import tpu_world  # noqa: E402
from accl_tpu.testing import run_ranks as j_run_ranks  # noqa: E402
from accl_tpu_torch import ACCLError, CCLOp, ErrorCode, cuda_world  # noqa: E402
from accl_tpu_torch.call import CallDescriptor  # noqa: E402
from accl_tpu_torch.constants import ReduceFunc  # noqa: E402
from accl_tpu_torch.testing import run_ranks  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


W = 4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def worlds():
    tw = tpu_world(W, platform="cpu")
    cw = cuda_world(W, device="cpu")
    yield tw, cw
    for a in tw + cw:
        a.deinit()


def _inputs(op: str, count: int, seed: int):
    rng = np.random.default_rng(seed)
    n_in = W * count if op == "reduce_scatter" else count
    return [rng.standard_normal(n_in).astype(np.float32) for _ in range(W)]


def _body(op, count, ins, resident, wire, jax_side, func=ReduceFunc.SUM,
          algorithm="ring"):
    n_out = W * count if op == "allgather" else count

    def fn(a):
        if jax_side:
            import jax.numpy as jnp
            src = (a.buffer(data=jnp.asarray(ins[a.rank]))
                   if resident else a.buffer(data=ins[a.rank].copy()))
            dst = a.buffer((n_out,), np.float32, device_resident=resident)
            kw = {"compress_dtype": (ml_dtypes.float8_e4m3fn
                                     if wire else None)}
        else:
            src = a.buffer(data=torch.from_numpy(ins[a.rank].copy()),
                           device_resident=resident)
            dst = a.buffer((n_out,), torch.float32,
                           device_resident=resident)
            kw = {"compress_dtype": torch.float8_e4m3fn if wire else None}
        if wire:
            kw["block_scale"] = 64
        if op != "allgather":
            from accl_tpu.constants import ReduceFunc as JRF
            kw["func"] = JRF(int(func)) if jax_side else func
        getattr(a, op)(src, dst, count, algorithm=algorithm, **kw)
        return np.asarray(dst.data, dtype=np.float32).copy()
    return fn


@pytest.mark.parametrize("wire", [False, True], ids=["fp32", "fp8bs"])
@pytest.mark.parametrize("resident", [False, True],
                         ids=["host", "resident"])
@pytest.mark.parametrize("op", ["allreduce", "reduce_scatter", "allgather"])
def test_driver_matches_tpu_world(worlds, op, resident, wire):
    tw, cw = worlds
    count = 300 if op == "allreduce" else 75
    ins = _inputs(op, count, 7)
    ref = j_run_ranks(tw, _body(op, count, ins, resident, wire, True))
    got = run_ranks(cw, _body(op, count, ins, resident, wire, False))
    for r in range(W):
        np.testing.assert_array_equal(got[r].view(np.uint32),
                                      ref[r].view(np.uint32))
    if wire and op == "allreduce":   # the wire was really quantized
        assert np.abs(got[0] - sum(ins)).max() > 0


@pytest.mark.parametrize("op", ["allreduce", "reduce_scatter"])
def test_driver_xla_family_within_tolerance(worlds, op):
    tw, cw = worlds
    count = 256
    ins = _inputs(op, count, 8)
    ref = j_run_ranks(tw, _body(op, count, ins, True, False, True,
                                algorithm="auto"))
    got = run_ranks(cw, _body(op, count, ins, True, False, False,
                              algorithm="auto"))
    for r in range(W):
        np.testing.assert_allclose(got[r], ref[r], rtol=1e-6, atol=1e-6)


def test_device_resident_buffers_update_in_place(worlds):
    _, cw = worlds
    ts = [torch.full((8,), float(r + 1)) for r in range(W)]

    def fn(a):
        buf = a.buffer(data=ts[a.rank], device_resident=True)
        a.allreduce(buf, buf, 8, algorithm="ring")
        a.barrier()
        return buf.tensor

    out = run_ranks(cw, fn)
    for r in range(W):
        assert out[r] is ts[r]           # adopted zero-copy, in place
        assert torch.equal(ts[r], torch.full((8,), 10.0))


def test_block_scale_without_compress_dtype_raises(worlds):
    _, cw = worlds
    a = cw[0]
    src = a.buffer((16,), torch.float32)
    with pytest.raises(ValueError, match="block_scale"):
        a.allreduce(src, src, 16, block_scale=True)
    with pytest.raises(ValueError, match="block-scaled"):
        a.allreduce(src, src, 16, compress_dtype="int8")


def test_unported_operations_report_not_implemented(worlds):
    """alltoallv (not ported yet) fails typed on every rank instead of
    running or hanging."""
    _, cw = worlds

    def fn(a):
        words = []
        for op in (CCLOp.alltoallv,):
            desc = CallDescriptor(op, count=4, comm_id=a.comm.comm_id)
            with pytest.raises(ACCLError) as ei:
                a.device.call_sync(desc)
            words.append(ei.value.error_word)
        return words

    for words in run_ranks(cw, fn):
        assert all(w & int(ErrorCode.COLLECTIVE_NOT_IMPLEMENTED)
                   for w in words)


def test_incomplete_group_times_out():
    cw = cuda_world(2, device="cpu", timeout=0.3)
    try:
        src = cw[0].buffer((4,), torch.float32)
        with pytest.raises(ACCLError) as ei:
            cw[0].allreduce(src, src, 4)
        assert ei.value.error_word & int(ErrorCode.RECEIVE_TIMEOUT_ERROR)
    finally:
        for a in cw:
            a.deinit()


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        cuda_world(2)


# -- isolation ---------------------------------------------------------------

_FORBIDDEN = ("jax", "ml_dtypes", "accl_tpu")


def _imports(path: str) -> set[str]:
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add((node.module or "").split(".")[0])
    return names


def test_port_imports_no_jax():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, fnames in os.walk(os.path.join(REPO, "accl_tpu_torch")):
        files += [os.path.join(root, f) for f in fnames if f.endswith(".py")]
    assert len(files) > 10
    for path in files:
        bad = _imports(path) & set(_FORBIDDEN)
        assert not bad, f"{os.path.relpath(path, REPO)} imports {bad}"


def test_import_leaves_jax_unloaded():
    code = ("import sys, accl_tpu_torch, accl_tpu_torch.testing, "
            "accl_tpu_torch.convert, accl_tpu_torch.models, "
            "accl_tpu_torch.ops.attention; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{_FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
