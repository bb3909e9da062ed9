"""The f32 B10 and B11 past head dim 256 (the cluster form of
``csrc/attention_bwd.cu``) emulated on the CPU.

On the card a cluster of C = ceil(ceil(D / 64) / NS) blocks forms S and
dP once a tile, NS = 2 to D 1024, 4 to 2048 and 8 to 4096 (so C <= 8):
block c holds the 64-column slices NS*c .. NS*c + NS - 1, forms each
slice's partial (3xTF32, a fresh accumulator) and adds its live slices'
partials in slice order; the owner of each position sums the C block
partials in block order with f32 adds, and every block updates its own
columns of dV, dK (B10) or dQ (B11) from the same P and dS, each
streamed tile of 32 rows (B11: keys) summed in a fresh accumulator.
The emulation below follows that order: every product through the
3xTF32 split of ``test_torch_attention_bwd`` (each operand's hi and lo
parts, the three products summed in f32), the partials and the tile sums
added in order.
It is held to the f32 rule of ``chip_smoke.py``'s BWD_TOL (2e-5*|plain| +
2e-5*max|plain| per element) against the plain versions, which the card's
kernels are held to as well; the kernels themselves run only on the card.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from accl_tpu_torch.ops import attention as A  # noqa: E402

from test_torch_attention_bwd import _f32_ratios, _mm_tf32x3  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
WIDTH = 64      # a slice of the head dim
TILE = 32       # streamed rows (B10) and keys (B11) a step
# the slices a block holds by head dim (the kernel's cluster_ns): the
# fewest of 2, 4, 8 that keep a cluster at 8 blocks
TIERS = ((1024, 2), (2048, 4), (4096, 8))


def _ns(D):
    return next(ns for top, ns in TIERS if D <= top)


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment."""
    yield


def _operands(D, causal, seed):
    """f32 q, dout, k, v (B 1, H 2, Hkv 1, S 96 queries over 128 keys
    unmasked, 112 each causal) and the backward's operands: the forward's
    LSE, delta from O."""
    sq, skv = (112, 112) if causal else (96, 128)
    rng = np.random.default_rng(seed)
    xq, xdo = (torch.from_numpy(rng.standard_normal((1, 2, sq, D))
                                .astype(np.float32)) for _ in range(2))
    xk, xv = (torch.from_numpy(rng.standard_normal((1, 1, skv, D))
                               .astype(np.float32)) for _ in range(2))
    o, lse = A.flash_attention_fwd(xq, xk, xv, causal)
    delta = (xdo * o).sum(-1).reshape(2, sq)
    return xq, xdo, xk, xv, lse, delta, causal, D ** -0.5


def _sliced(a, b, order):
    """a @ b^T over the last dim: one 3xTF32 product a WIDTH-column slice,
    a block's NS slices added in slice order (the last block's live ones
    only), the blocks' partials added in f32 in ``order``."""
    ns = _ns(a.shape[-1])
    parts = [_mm_tf32x3(a[..., c * WIDTH:(c + 1) * WIDTH],
                        b[..., c * WIDTH:(c + 1) * WIDTH].transpose(-1, -2))
             for c in range(-(-a.shape[-1] // WIDTH))]
    blocks = []
    for i in range(0, len(parts), ns):
        acc = parts[i]
        for part in parts[i + 1:i + ns]:
            acc = acc + part
        blocks.append(acc)
    out = blocks[order[0]]
    for c in order[1:]:
        out = out + blocks[c]
    return out


def _tiled(a, b):
    """a @ b, the reduced dim cut into TILE-row tiles, each a 3xTF32
    product (a fresh accumulator), the tiles added in f32 in order."""
    out = None
    for t0 in range(0, a.shape[-1], TILE):
        part = _mm_tf32x3(a[..., t0:t0 + TILE], b[..., t0:t0 + TILE, :])
        out = part if out is None else out + part
    return out


def _blocks(D):
    """The blocks of a cluster at head dim D."""
    return -(-(-(-D // WIDTH)) // _ns(D))


def _cluster_route(q, do, k, v, lse, delta, causal, scale, order=None):
    """(dk, dv, dq) as the cluster form computes them; ``order`` the
    blocks' summation order (block order when None)."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    g = H // Hkv
    order = order or list(range(_blocks(D)))
    qf, dof = (t.reshape(B, Hkv, g, Sq, D).float() for t in (q, do))
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    s = _sliced(qf, kf, order)
    dp = _sliced(dof, vf, order)
    mask = (torch.arange(Skv)[None, :] <= torch.arange(Sq)[:, None]
            if causal else torch.ones(Sq, Skv, dtype=torch.bool))
    p = torch.where(mask, torch.exp(s * scale - lse.reshape(B, Hkv, g, Sq, 1)),
                    0.0)
    ds = p * (dp - delta.reshape(B, Hkv, g, Sq, 1))
    dv = _tiled(p.transpose(-1, -2), dof).reshape(B * H, Skv, D)
    dk = (_tiled(ds.transpose(-1, -2), qf) * scale).reshape(B * H, Skv, D)
    dq = (_tiled(ds, kf) * scale).reshape(q.shape)
    return dk, dv, dq


# each tier's first and last head dims, an odd slice count (264), and one
# live slice in the last block of the 4- and 8-slice tiers (1032, 2056)
DIMS = (264, 512, 1024, 1032, 2048, 2056, 4096)
CASES = [(D, causal) for D in DIMS for causal in (True, False)]


def _ids(case):
    return f"d{case[0]}-{'causal' if case[1] else 'full'}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_cluster_route_emulation_within_f32_limit(case):
    """The emulated cluster form (64-column slices summed NS to a block in
    slice order, the blocks in block order, 32-row tiles in order) stays
    within the f32 limit against the plain versions for dk, dv and dq, and
    differs from them (the limit is not vacuous)."""
    D, causal = case
    args = _operands(D, causal, 700 + D + causal)
    ratios = _f32_ratios(args, _cluster_route(*args))
    assert max(ratios) <= 1.0, ratios
    assert min(ratios) > 0.0, ratios


@pytest.mark.parametrize("D", DIMS)
def test_cluster_route_emulation_repeats_bitwise(D):
    """With the summation order fixed (block order, as every owner of a
    position sums), the emulation gives the same bits twice; the blocks'
    partials summed in reverse order give other bits, so the order is
    what fixes them."""
    args = _operands(D, True, 800 + D)
    first, again = _cluster_route(*args), _cluster_route(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    other = _cluster_route(*args, order=list(range(_blocks(D)))[::-1])
    assert not all(torch.equal(a, b) for a, b in zip(first, other))
    assert max(_f32_ratios(args, other)) <= 1.0


def test_emulated_width_is_the_kernels():
    """The emulation's slices, tiers and tile are the cluster kernels':
    ``SL`` columns a slice; NS = 2, 4, 8 slices a block up to D = 8 * 2 *
    SL, 8 * 4 * SL and 8 * 8 * SL (``cluster_ns``), C = ceil(ceil(D / SL)
    / NS) blocks, at most 8: a portable cluster, so head dims past 256 up
    to 4096; ``SROWS`` streamed rows a step; and the cases reach each
    tier's last head dim. The tiers live in ``attention_cluster.cuh`` and
    the streamed rows in ``attention_band.cuh``, which the kernels' source
    includes."""
    csrc = ROOT / "accl_tpu_torch" / "csrc"
    src = (csrc / "attention_bwd.cu").read_text()
    assert '#include "attention_cluster.cuh"' in src
    assert '#include "attention_band.cuh"' in src
    src += (csrc / "attention_cluster.cuh").read_text()
    src += (csrc / "attention_band.cuh").read_text()
    assert re.search(r"constexpr int SL = (\d+),", src).group(1) == str(WIDTH)
    assert re.search(r"constexpr int SROWS = (\d+);", src).group(1) == str(
        TILE)
    assert re.search(r"constexpr int CLUSTER_MAX_D = 8 \* 8 \* SL;", src)
    assert re.search(r"return D <= 8 \* 2 \* SL \? 2 : D <= 8 \* 4 \* SL \? 4 "
                     r": 8;", src)
    assert re.search(r"cluster_size\(int D\) \{\s*return \(\(D \+ SL - 1\) / "
                     r"SL \+ cluster_ns\(D\) - 1\) / cluster_ns\(D\);", src)
    assert re.search(r"return D > 256 && D <= CLUSTER_MAX_D;", src)
    assert TIERS == tuple((8 * ns * WIDTH, ns) for ns in (2, 4, 8))
    assert {top for top, _ in TIERS} <= {D for D, _ in CASES}
    assert all(_blocks(D) <= 8 for D, _ in CASES)
