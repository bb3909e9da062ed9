"""The tiles of B7's launch (``bs_combine_kernel`` in
``csrc/bs_codec.cu``) on the CPU.

On the card, ``bs_combine`` (B7) launches one block of BS_THREADS
threads for each tile of a row: a thread-step is BS_STEP consecutive
elements, a tile one step of every thread, or as many steps as a scale
block larger than that needs, so that a tile holds whole scale blocks.
The kernel runs only on the card, where ``chip_smoke.py``'s ``bs_edges``
holds it bitwise against ``bs_combine_ref`` in both modes at the edges
of those tiles. These tests hold that check to the kernel's source: its
tile sizes are the ones the CUDA code launches, its row lengths fall on
the scale blocks' and the tiles' edges, its row counts span two
launches, and it covers every (wire, func, requant) instantiation that
``accl_bs_combine`` dispatches to, and every block size the codec takes.
"""

from __future__ import annotations

import importlib.util
import pathlib
import re

import pytest

torch = pytest.importorskip("torch")

from accl_tpu_torch.ops.combine import MAX_ROWS  # noqa: E402
from accl_tpu_torch.quant import WIRE_CODES, n_blocks  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BS_CODEC = ROOT / "accl_tpu_torch" / "csrc" / "bs_codec.cu"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
SOURCE = BS_CODEC.read_text()


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


def _define(name: str) -> str:
    m = re.search(rf"^#define {name} (.+)$", SOURCE, re.M)
    assert m, f"{name} not defined in bs_codec.cu"
    return m.group(1).strip()


def _entry(name: str) -> str:
    """The body of the C entry point ``name``."""
    body = SOURCE[SOURCE.index(f'extern "C" int {name}('):]
    return body[:body.index("\n}\n")]


def _blocks_taken() -> list:
    """Every block size ``bad_args`` lets through: powers of two between
    its bounds."""
    m = re.search(r"block < (\d+) \|\| block > (\d+) \|\|\s*"
                  r"\(block & \(block - 1\)\) != 0", SOURCE)
    assert m, "bad_args no longer bounds block to powers of two"
    lo, hi = int(m.group(1)), int(m.group(2))
    return [1 << k for k in range(lo.bit_length() - 1, hi.bit_length())]


def test_tiles_are_the_kernels():
    """BS_THREADS threads a block, BS_STEP elements a thread-step; the
    launch takes one step a thread unless a scale block is larger than
    one step of every thread, and sizes its grid by that tile."""
    assert CS.BS_THREADS == int(_define("BS_THREADS"))
    assert CS.BS_STEP == int(_define("BS_STEP"))
    assert _define("BS_TILE") == "(BS_THREADS * BS_STEP)"
    assert ("return block > BS_TILE ? block / BS_TILE : 1;" in SOURCE)
    assert ("constexpr long long TILE = static_cast<long long>(BS_TILE) * S;"
            in SOURCE)
    assert "bs_combine_kernel<WIRE, F, REQUANT, S><<<grid, BS_THREADS" in SOURCE
    assert "__launch_bounds__(BS_THREADS)" in SOURCE
    tile = CS.BS_THREADS * CS.BS_STEP
    for block in _blocks_taken():
        steps = block // tile if block > tile else 1
        assert CS.bs_tile(block) == tile * steps
        assert CS.bs_tile(block) % block == 0     # whole scale blocks


def test_every_block_size_is_edge_checked():
    """The edge check runs every block size the codec takes, which spans
    the three amax reductions (shuffles within a warp up to 128,
    shared memory up to one tile, several steps a thread past it)."""
    assert tuple(_blocks_taken()) == CS.BS_BLOCKS
    tile = CS.BS_THREADS * CS.BS_STEP
    assert {b <= 32 * CS.BS_STEP for b in CS.BS_BLOCKS} == {True, False}
    assert any(32 * CS.BS_STEP < b <= tile for b in CS.BS_BLOCKS)
    assert any(b > tile for b in CS.BS_BLOCKS)
    assert {32, 128, 1024, 4096} <= set(CS.BS_BLOCKS)


def test_every_instantiation_is_edge_checked():
    """Every (wire, func) that accl_bs_combine dispatches to meets the
    edge check, and each case runs both modes (requant and the
    round-closing f32 mode); the SASS check expects every (wire, func,
    requant, steps) kernel."""
    body = _entry("accl_bs_combine")
    wires = set(re.findall(r"combine_func<W_(\w+)>", body))
    assert wires == {"INT8", "E4M3", "E5M2"}
    funcs = set(re.findall(r"case F_(\w+): launch_combine", SOURCE))
    assert funcs == {"SUM", "MAX", "MIN", "PROD"}
    # bs_combine_instantiations names the wires by their codes
    assert [WIRE_CODES[w] for w in CS.BS_WIRES] == [0, 1, 2]
    cases = CS.bs_edge_cases()
    seen = {(c[0], c[4]) for c in cases}
    assert seen == {(w, f) for w in CS.BS_WIRES for f in range(4)}
    # each (wire, block) meets all four funcs and every layout
    for w in CS.BS_WIRES:
        for b in CS.BS_BLOCKS:
            mine = [c for c in cases if c[0] == w and c[1] == b]
            assert {c[4] for c in mine} == set(range(4))
            assert {c[5] for c in mine} == set(CS.BS_LAYOUTS)
    steps = {CS.bs_tile(b) // (CS.BS_THREADS * CS.BS_STEP)
             for b in CS.BS_BLOCKS}
    assert steps == {1, 2, 4}
    inst = CS.bs_combine_instantiations()
    assert len(inst) == 3 * 4 * (len(steps) + 1)
    for s in (2, 4):
        assert f"case {s}: launch_tiles<WIRE, F, true, {s}>" in SOURCE \
            or f"default: launch_tiles<WIRE, F, true, {s}>" in SOURCE
    assert "launch_tiles<WIRE, F, false, 1>" in SOURCE


def test_edge_rows_span_two_launches():
    """One row, a few, a full launch of ACCL_MAX_ROWS and one more row,
    which the wrapper splits into a second launch."""
    assert {1, MAX_ROWS, MAX_ROWS + 1} <= set(CS.EDGE_ROWS)
    assert {c[2] for c in CS.bs_edge_cases()} == set(CS.EDGE_ROWS)


@pytest.mark.parametrize("block", CS.BS_BLOCKS)
def test_edge_lengths_meet_the_tiles(block):
    """Empty, one element, less than one step, one scale block - 1, + 0
    and + 1 (a ragged scale block, a whole one and one past it), one
    tile - 1, + 0 and + 1 (a ragged tile, a whole one and one past it),
    for every row count."""
    tile = CS.bs_tile(block)
    lengths = CS.bs_edge_lengths(block)
    assert {0, 1, CS.BS_STEP - 1, block - 1, block, block + 1, tile - 1,
            tile, tile + 1} == set(lengths)
    for n in lengths:
        for nrows in CS.EDGE_ROWS:
            assert any(c[1] == block and c[2] == nrows and c[3] == n
                       for c in CS.bs_edge_cases())
    # the last tile is ragged, whole, or one element into the next
    assert {n % tile for n in lengths if n} >= {1, tile - 1, 0}
    assert n_blocks(tile + 1, block) == tile // block + 1


def test_edge_payloads_reach_both_encoders():
    """Rows of the edge check hold blocks whose scale falls back to 1
    (the integer encoder: amax NaN, inf, 0, denormal) and blocks whose
    scale is good (the hardware conversion), rounding ties at scale 1
    among them."""
    import numpy as np
    from accl_tpu_torch.ops import compression as C
    from accl_tpu_torch.quant import _FLT_MIN
    rng = np.random.default_rng(0)
    block, nrows = 128, len(CS.BS_KINDS)
    kinds = {}
    for wire in CS.BS_WIRES:
        x, other = CS.bs_edge_payload(rng, wire, block, nrows, 2 * block,
                                      0, device="cpu")
        q, s = C.bs_quant(list(x), wire, block)
        acc = C.bs_combine(q, s, list(other), 0, wire, block,
                           requant=False)
        for r in range(nrows):
            kind = CS.BS_KINDS[r % len(CS.BS_KINDS)]
            amax = acc[r][:block].abs().max()
            s0 = float(amax) / C._QMAX[wire]
            good = _FLT_MIN <= s0 < float("inf")
            kinds.setdefault(kind, set()).add(good)
    assert kinds["nan"] == kinds["inf"] == kinds["zero"] == {False}
    assert kinds["denormal"] == {False}
    assert kinds["tiny"] == kinds["ties"] == {True}

