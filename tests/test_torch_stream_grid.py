"""The tiles of B1 and B2's stream launches (``csrc/stream.cuh``) on the
CPU.

On the card, ``combine`` (B1) and ``cast`` (B2) launch one block of
STREAM_THREADS threads for each tile of a row: a tile is one thread-step
of every thread, 16 bytes of each B1 operand or CAST_STEP elements of
B2. The kernels run only on the card, where ``chip_smoke.py``'s
``stream_edges`` holds them bitwise against their plain versions at the
edges of those tiles. These tests hold that check to the kernels'
sources: its tile sizes are the ones the CUDA code launches, its row
lengths fall on each kernel's tile edges, its row counts span two
launches, and it covers every (dtype) and (lane pair) instantiation that
the C entry points dispatch to.
"""

from __future__ import annotations

import importlib.util
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from accl_tpu_torch.ops.combine import _DTYPE_CODES, MAX_ROWS  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "accl_tpu_torch" / "csrc"
SMS, BLOCKS_PER_SM = 132, 2048 // 256   # an H100 SXM: threads an SM / block


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


def _define(path: pathlib.Path, name: str) -> int:
    m = re.search(rf"^#define {name} (\d+)", path.read_text(), re.M)
    assert m, f"{name} not defined in {path.name}"
    return int(m.group(1))


def _kernels():
    """(name, step elements, tile elements) of every stream kernel
    instantiation, as chip_smoke's edge check sizes it."""
    out = []
    for name in CS.COMBINE_DTYPES:
        vec = CS.combine_step(getattr(torch, name).itemsize)
        out.append((f"combine-{name}", vec, CS.STREAM_THREADS * vec))
    for src, dst in CS.CAST_PAIRS:
        out.append((f"cast-{src}-{dst}", CS.CAST_STEP,
                    CS.STREAM_THREADS * CS.CAST_STEP))
    return out


def test_tiles_are_the_kernels():
    """STREAM_THREADS threads a block; a B1 step is one 16-byte vector of
    its dtype, a B2 step CAST_STEP elements; both kernels launch one
    block a tile of those steps (csrc/combine.cu, csrc/wire_lanes.cu)."""
    assert CS.STREAM_THREADS == _define(CSRC / "stream.cuh",
                                        "STREAM_THREADS")
    assert CS.CAST_STEP == _define(CSRC / "wire_lanes.cu", "CAST_STEP")
    combine_cu = (CSRC / "combine.cu").read_text()
    assert "constexpr int V = 16 / sizeof(S);" in combine_cu
    assert "stream_tile<V>(" in combine_cu
    assert "stream_grid<V>(" in combine_cu
    lanes_cu = (CSRC / "wire_lanes.cu").read_text()
    assert "stream_tile<CAST_STEP>(" in lanes_cu
    assert "stream_grid<CAST_STEP>(" in lanes_cu
    assert [CS.combine_step(s) for s in (1, 2, 4, 8)] == [16, 8, 4, 2]


def test_every_instantiation_is_edge_checked():
    """Every dtype that accl_combine dispatches, and every lane pair of
    accl_cast's switch, has its edge cases."""
    assert set(CS.COMBINE_DTYPES) == {str(d).split(".")[1]
                                      for d in _DTYPE_CODES}
    lanes = {"F32": "float32", "F16": "float16", "BF16": "bfloat16",
             "E4M3": "float8_e4m3fn", "E5M2": "float8_e5m2"}
    text = (CSRC / "wire_lanes.cu").read_text()
    body = text[text.index('extern "C" int accl_cast('):]
    body = body[:body.index("\n}\n")]
    pairs = {(lanes[a], lanes[b]) for a, b in
             re.findall(r"case L_(\w+) \* 8 \+ L_(\w+):", body)}
    assert len(pairs) == 8
    assert set(CS.CAST_PAIRS) == pairs


def test_edge_rows_span_two_launches():
    """One row, a few, a full launch of ACCL_MAX_ROWS, and one more row,
    which the wrappers split into a second launch."""
    assert MAX_ROWS == _define(CSRC / "common.cuh", "ACCL_MAX_ROWS")
    assert {1, MAX_ROWS, MAX_ROWS + 1} <= set(CS.EDGE_ROWS)


@pytest.mark.parametrize("nrows", CS.EDGE_ROWS)
@pytest.mark.parametrize("kernel", _kernels(), ids=lambda k: k[0])
def test_edge_lengths_meet_the_tiles(kernel, nrows):
    """The lengths of one launch of ``nrows`` rows fall on the kernel's
    edges: empty, one element, one vector step - 1 (all scalar), one tile
    - 1, one tile and one tile + 1 (a whole tile and its neighbours), and
    one with more blocks than the card holds at once whose last tile is
    ragged past a whole step (vector body and scalar tail)."""
    _, vec, tile = kernel
    rows = min(nrows, MAX_ROWS)
    lengths = CS.edge_lengths(vec, tile, rows)
    assert {0, 1, vec - 1, tile - 1, tile, tile + 1} <= set(lengths)
    long = max(lengths)
    assert rows * -(-long // tile) > SMS * BLOCKS_PER_SM
    assert long % tile > vec and (long % tile) % vec != 0
