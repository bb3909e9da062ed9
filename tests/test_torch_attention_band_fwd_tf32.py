"""The f32 forward past head dim 4096 (B8, B9 and the B12 chunks on the
band form of ``csrc/attention_band_fwd.cu``) and the f32 single-token
decode past head dim 2048 (the band decode of
``csrc/attention_decode.cu``) emulated on the CPU.

On the card the band forward forms S = Q K^T once a 128 x 64 tile over
the whole head dim, in chunks of 32 columns (3xTF32, each chunk's product
in a fresh accumulator, added to the running sum in f32), scales and
masks it (finfo(f32).min) and stores it with each tile's row maximum m_t
and sum l_t = sum exp(s - m_t); the normalisation merges each row's tile
stats into the LSE, M + log max(L, 1e-30) with M = max m_t and L = sum
l_t exp(m_t - M) (a warp a row: each lane its tiles in key-tile order,
then a butterfly of the 32 lanes), and turns S into P = exp(S - LSE)
under the mask; the product pass forms O = P V in steps of 32 keys (each
step in a fresh accumulator, added in f32). The query rows go a band of
``fwd_band_rows`` at a time; nothing in a row depends on the band. The
band decode forms each (q row, key) score in f32 over the whole head
dim, with the stats of 8-key tiles, merges the stats as the
normalisation does, and adds P V over ``band_decode_splits`` key
splits (four key groups a split, strided by 4 within 128-key chunks,
summed in group order), the splits' partials added in split order.

The emulation below follows those orders (the products through the
3xTF32 split of ``test_torch_attention_bwd``) and is held to the f32 rule
of ``chip_smoke.py``'s ATTN_TOL, |got - plain| <= 2e-5 + 2e-5 * |plain|
per element of O and of the LSE, against the plain versions, which the
card's kernels are held to as well; the kernels themselves run only on
the card.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from accl_tpu_torch.ops import attention as A  # noqa: E402

from test_torch_attention_bwd import _mm_tf32x1, _mm_tf32x3  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "accl_tpu_torch" / "csrc"
F32_TOL = 2e-5
NEG = torch.finfo(torch.float32).min
CHUNK = 32       # head-dim columns of a score chunk (attention_band.cuh BCH)
STEP = 32        # keys of a product step (SROWS)
TILE = 64        # a score tile's keys (BT); bands are multiples of it
DEC_KEYS = 8     # the band decode's score tile (attention_decode.cu BD_KEYS)
DEC_GROUPS = 4   # its product pass's key groups (BD_PKG)
DEC_CHUNK = 128  # the keys of P it holds at once (BD_PCH)
SM_COUNT = 132   # an H100's SMs, for band_decode_splits


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment."""
    yield


def ratio(got, want) -> float:
    """Largest error/limit over the elements (ATTN_TOL's f32 rule)."""
    w = torch.as_tensor(np.array(want, np.float32))
    return float(((got.float() - w).abs() / (F32_TOL + F32_TOL * w.abs()))
                 .max())


def _tile_sums(p):
    """Each row's sum of p over every TILE-key tile (keys padded to whole
    tiles with zeros) in the kernel's order: a lane's 8 keys (8j + 2t + e,
    j then e) in sequence, the quad's 4 lanes as a butterfly, then the two
    warps' halves of the tile in key order."""
    *lead, n = p.shape
    nt = -(-n // TILE)
    p = torch.nn.functional.pad(p, (0, nt * TILE - n))
    # key 32 * half + 8 j + 2 t + e -> (half, t, j, e)
    x = p.reshape(*lead, nt, 2, 4, 4, 2).transpose(-3, -2)
    x = x.reshape(*lead, nt, 2, 4, 8)
    s = x[..., 0]
    for i in range(1, 8):
        s = s + x[..., i]
    s = (s[..., 0] + s[..., 1]) + (s[..., 2] + s[..., 3])
    return s[..., 0] + s[..., 1]


def _band_fwd(q, k, v, causal, off=0, rows=None, mm=_mm_tf32x3,
              chunk=False):
    """O (and the LSE) of the band form, the q heads of one kv head side
    by side (row g * Sq + i at position off + i), bands of ``rows`` rows
    of a head (``A.fwd_band_rows``'s when None): a B8 or B9 head is a q
    head, so its bands are cut within each group's Sq rows; a ``chunk``'s
    head is the kv head's G * S_new rows."""
    B, H, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    G = H // Hkv
    scale = D ** -0.5
    qf = q.reshape(B, Hkv, G * Sq, D).float()
    kf, vf = k.float(), v.float()
    pos = torch.arange(G * Sq) % Sq + off
    keys = torch.arange(Skv)
    head_rows = G * Sq if chunk else Sq
    R = rows or A.fwd_band_rows(head_rows, Skv, D)
    o = torch.empty_like(qf)
    lse = torch.empty(*qf.shape[:3])
    for h0 in range(0, G * Sq, head_rows):
        for r0 in range(h0, h0 + head_rows, R):
            sl = slice(r0, min(r0 + R, h0 + head_rows))
            s = None
            for c in range(0, D, CHUNK):   # each chunk in a fresh sum
                part = mm(qf[..., sl, c:c + CHUNK],
                          kf[..., c:c + CHUNK].transpose(-1, -2))
                s = part if s is None else s + part
            mask = (keys[None, :] <= pos[sl, None] if causal
                    else torch.ones(sl.stop - sl.start, Skv, dtype=torch.bool))
            s = torch.where(mask, s * scale, NEG)
            nt = -(-Skv // TILE)
            padded = torch.nn.functional.pad(s, (0, nt * TILE - Skv),
                                             value=NEG)
            m_t = padded.reshape(*s.shape[:-1], nt, TILE).amax(-1)
            rep = m_t.repeat_interleave(TILE, -1)[..., :Skv]
            l_t = _tile_sums(torch.where(mask, torch.exp(s - rep), 0.0))
            row_lse = _merge(m_t, l_t)
            p = torch.where(mask, torch.exp(s - row_lse[..., None]), 0.0)
            out = None
            for t0 in range(0, Skv, STEP):  # each step in a fresh sum
                part = mm(p[..., t0:t0 + STEP], vf[..., t0:t0 + STEP, :])
                out = part if out is None else out + part
            o[..., sl, :] = out
            lse[..., sl] = row_lse
    return o.reshape(q.shape), lse.reshape(B * H, Sq)


def _merge(m_t, l_t):
    """Each row's LSE from its tiles' stats (last dim) as a warp merges
    them: M = max m_t; lane i adds l_t exp(m_t - M) of tiles i, i + 32,
    ... in order; the lanes' sums meet in a butterfly; M + log max(L,
    1e-30)."""
    M = m_t.amax(-1)
    lanes = torch.zeros(*m_t.shape[:-1], 32)
    for t in range(m_t.shape[-1]):
        lanes[..., t % 32] = lanes[..., t % 32] + l_t[..., t] * torch.exp(
            m_t[..., t] - M)
    return M + torch.log(_butterfly(lanes).clamp_min(1e-30))


def _butterfly(x):
    """The value lane 0 holds after a butterfly of fadds over the last dim
    (32 lanes, offsets 16 .. 1)."""
    idx = torch.arange(x.shape[-1])
    off = x.shape[-1] // 2
    while off:
        x = x + x[..., idx ^ off]
        off //= 2
    return x[..., 0]


def _band_decode(q, kc, vc, kv_len, n_split=None):
    """One new token over the (B, T, Hkv, D) cache as the band decode
    forms it, ``n_split`` key splits (``A.band_decode_splits``'s when
    None)."""
    B, H, _, D = q.shape
    T, Hkv = kc.shape[1], kc.shape[2]
    G = H // Hkv
    k, v = (t.float() for t in A.cache_prefix(kc, vc, kv_len))
    qf = q.reshape(B, Hkv, G, D).float()
    s = torch.matmul(qf, k.transpose(-1, -2)) * D ** -0.5   # (B, Hkv, G, kv)
    tiles = A.band_decode_tiles(T)
    live = -(-kv_len // DEC_KEYS)
    padded = torch.nn.functional.pad(s, (0, live * DEC_KEYS - kv_len),
                                     value=NEG)
    x = padded.reshape(B, Hkv, G, live, DEC_KEYS)
    m_t = x.amax(-1)
    e = torch.where(x > NEG, torch.exp(x - m_t[..., None]), 0.0)
    # 8 lanes: a butterfly at offsets 4, 2, 1
    idx = torch.arange(DEC_KEYS)
    for off in (4, 2, 1):
        e = e + e[..., idx ^ off]
    row_lse = _merge(m_t, e[..., 0])
    p = torch.exp(s - row_lse[..., None])
    n_split = n_split or A.band_decode_splits(B, Hkv, T, D, SM_COUNT)
    per = -(-tiles // n_split) * DEC_KEYS
    out = None
    for sp in range(n_split):
        lo = min(sp * per, kv_len)
        hi = min(lo + per, kv_len)
        groups = [torch.zeros(B, Hkv, G, D) for _ in range(DEC_GROUPS)]
        for k0 in range(lo, hi, DEC_CHUNK):
            for j in range(k0, min(k0 + DEC_CHUNK, hi)):
                gi = (j - k0) % DEC_GROUPS
                groups[gi] = groups[gi] + p[..., j, None] * v[:, :, None, j]
        part = groups[0]
        for gsum in groups[1:]:
            part = part + gsum
        out = part if out is None else out + part
    return out.reshape(q.shape)


def _operands(B, H, Hkv, sq, skv, D, seed):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s).astype(np.float32)
          for s in ((B, H, sq, D), (B, Hkv, skv, D), (B, Hkv, skv, D))]
    return xs, [torch.from_numpy(x) for x in xs]


def _cache(B, H, Hkv, T, kv_len, s_new, D, seed):
    """q (B, H, s_new, D) and a (B, T, Hkv, D) cache with NaN at and past
    kv_len, numpy f32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, s_new, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, T, Hkv, D)).astype(np.float32)
              for _ in range(2))
    kc[:, kv_len:] = np.nan
    vc[:, kv_len:] = np.nan
    return q, kc, vc


# (B, H, Hkv, Sq, Skv, D, causal, block_k): a head dim past the cluster
# form (17a's 4104) and one that is not a multiple of 64 (4360), ragged
# lengths from 64 to 200, causal and unmasked, GQA 4/2 and 2/1; B9 over
# one reference block
CASES = {
    "b8-d4104-causal-200": (1, 4, 2, 200, 200, 4104, True, 16),
    "b8-d4104-full-130x200": (1, 4, 2, 130, 200, 4104, False, 16),
    "b8-d4360-causal-72": (1, 2, 1, 72, 72, 4360, True, 16),
    "b8-d4360-full-64x96": (1, 2, 1, 64, 96, 4360, False, 16),
    "b9-d4104-causal-100": (1, 4, 2, 100, 100, 4104, True, None),
}
# one band (the rule's own at these shapes) and bands of one tile
BANDS = (None, TILE)


@pytest.mark.parametrize("rows", BANDS, ids=["one-band", "bands-of-64"])
@pytest.mark.parametrize("case", list(CASES))
def test_band_fwd_emulation_within_f32_limit(case, rows):
    """The emulated band forward (32-column chunks, the tile stats merged
    as a warp merges them, 32-key steps, the bands in order) within the f32
    limit of the plain forward for O and the LSE, and not equal to it (the
    limit is not vacuous); the case dispatches as its name says."""
    B, H, Hkv, sq, skv, D, causal, bk = CASES[case]
    assert A.is_single_block(skv, bk) == case.startswith("b9")
    _xs, (q, k, v) = _operands(B, H, Hkv, sq, skv, D, 910 + D + sq)
    if rows is None:
        assert A.fwd_band_rows(sq, skv, D) == sq
    o, lse = _band_fwd(q, k, v, causal, rows=rows)
    po, plse = A.flash_attention_ref(q, k, v, causal)
    r = max(ratio(o, po), ratio(lse, plse))
    assert 0.0 < r <= 1.0, r


def test_band_fwd_emulation_repeats_bitwise():
    """The emulation gives the same bits twice, and bands of 64 rows the
    same bits as one band: nothing in a row depends on its band."""
    _xs, (q, k, v) = _operands(1, 4, 2, 200, 200, 4104, 911)
    first, again = _band_fwd(q, k, v, True), _band_fwd(q, k, v, True)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    banded = _band_fwd(q, k, v, True, rows=TILE)
    assert all(torch.equal(a, b) for a, b in zip(first, banded))


def test_band_fwd_single_tf32_exceeds_f32_limit():
    """One TF32 product a product (S and P V) moves O or the LSE past the
    f32 limit: the route needs three."""
    _xs, (q, k, v) = _operands(1, 2, 1, 72, 72, 4360, 912)
    o, lse = _band_fwd(q, k, v, True, mm=_mm_tf32x1)
    po, plse = A.flash_attention_ref(q, k, v, True)
    assert max(ratio(o, po), ratio(lse, plse)) > 1.0


def test_band_fwd_matches_jax():
    """The emulated band forward at D 4104 (GQA 2/1, causal, S 64)
    against the JAX package's ``flash_attention`` (Pallas in interpret
    mode) on the same f32 inputs, within the f32 limit taken around its
    output."""
    jnp = pytest.importorskip("jax.numpy")
    from accl_tpu.ops import attention as R
    xs, (q, k, v) = _operands(1, 2, 1, 64, 64, 4104, 913)
    want = R.flash_attention(*(jnp.asarray(x) for x in xs), causal=True)
    assert ratio(_band_fwd(q, k, v, True)[0], np.asarray(want)) <= 1.0


# (S_new, kv_len) over a 320-row cache with NaN past kv_len: a chunk of
# five new tokens and single-token decodes
CACHE_T = 320
CHUNKS = ((5, 65), (5, 300))
DECODES = (1, 65, 300)


@pytest.mark.parametrize("rows", BANDS, ids=["one-band", "bands-of-64"])
@pytest.mark.parametrize("s_new,kv_len", CHUNKS)
def test_band_chunk_emulation_within_f32_limit(s_new, kv_len, rows):
    """A B12 chunk on the band form (the GR heads x S_new tokens of a kv
    head as its rows, bottom-right causal) over a cache with NaN past
    kv_len: finite and within the f32 limit of the plain version."""
    qn, kcn, vcn = _cache(1, 8, 2, CACHE_T, kv_len, s_new, 4104,
                          920 + kv_len)
    q, kc, vc = (torch.from_numpy(x) for x in (qn, kcn, vcn))
    k, v = A.cache_prefix(kc, vc, kv_len)
    o = _band_fwd(q, k, v, True, off=kv_len - s_new, rows=rows,
                  chunk=True)[0]
    assert torch.isfinite(o).all()
    assert ratio(o, A.flash_decode_ref(q, kc, vc, kv_len)) <= 1.0


@pytest.mark.parametrize("D", [2056, 4104])
@pytest.mark.parametrize("kv_len", DECODES)
def test_band_decode_emulation_within_f32_limit(kv_len, D):
    """The emulated band decode (8-key tiles, the stats merged a warp a
    row, the key splits' partials in split order) over a cache with NaN
    past kv_len at 16/2 heads: finite and within the f32 limit of the
    plain version, at the wrapper's splits and at one split."""
    qn, kcn, vcn = _cache(1, 16, 2, CACHE_T, kv_len, 1, D, 930 + kv_len)
    q, kc, vc = (torch.from_numpy(x) for x in (qn, kcn, vcn))
    want = A.flash_decode_ref(q, kc, vc, kv_len)
    for n_split in (None, 1):
        o = _band_decode(q, kc, vc, kv_len, n_split)
        assert torch.isfinite(o).all()
        assert ratio(o, want) <= 1.0


def test_band_decode_emulation_repeats_bitwise():
    """The emulated decode gives the same bits twice; other splits give
    other bits (the split order is what fixes them)."""
    qn, kcn, vcn = _cache(1, 8, 1, 1024, 1023, 1, 2056, 931)
    q, kc, vc = (torch.from_numpy(x) for x in (qn, kcn, vcn))
    first = _band_decode(q, kc, vc, 1023)
    assert torch.equal(first, _band_decode(q, kc, vc, 1023))
    assert A.band_decode_splits(1, 1, 1024, 2056, SM_COUNT) == 29
    assert not torch.equal(first, _band_decode(q, kc, vc, 1023, 3))


def test_band_chunk_and_decode_match_jax():
    """A chunk of 5 new tokens and a single-token decode at D 4104 over a
    64-row cache with NaN past kv_len 60, emulated, against the JAX
    package's ``flash_decode`` (Pallas in interpret mode), within the f32
    limit taken around its output."""
    jnp = pytest.importorskip("jax.numpy")
    from accl_tpu.ops import attention as R
    for s_new in (5, 1):
        xs = _cache(1, 4, 2, 64, 60, s_new, 4104, 940 + s_new)
        q, kc, vc = (torch.from_numpy(x) for x in xs)
        want = np.asarray(R.flash_decode(*(jnp.asarray(x) for x in xs),
                                         jnp.int32(60), block_k=32))
        assert np.isfinite(want).all()
        if s_new == 1:
            got = _band_decode(q, kc, vc, 60)
        else:
            k, v = A.cache_prefix(kc, vc, 60)
            got = _band_fwd(q, k, v, True, off=60 - s_new, chunk=True)[0]
        assert ratio(got, want) <= 1.0


def _fwd_words(R, keys):
    return R * (-(-keys // 4) * 4 + 2 * -(-keys // TILE))


def test_fwd_band_rule_bounds_the_workspace():
    """``fwd_band_rows`` over a grid of shapes: all rows when the
    workspace fits in q's own words, else a multiple of 64 below them; the
    largest that fits (one more tile does not), and the workspace within
    q's words whenever a band of one tile fits;
    ``fwd_band_workspace_floats`` is the heads' band words."""
    for rows in (1, 5, 63, 64, 130, 200, 1024, 4160, 8192):
        for keys in (1, 65, 300, 1024, 4160, 100000):
            for D in (264, 4104, 4360, 8192):
                R = A.fwd_band_rows(rows, keys, D)
                budget = rows * D
                if _fwd_words(rows, keys) <= budget:
                    assert R == rows
                    continue
                assert R <= rows and (R % TILE == 0 or R == rows)
                if _fwd_words(min(rows, TILE), keys) <= budget:
                    assert _fwd_words(R, keys) <= budget
                    assert _fwd_words(R + TILE, keys) > budget or \
                        R + TILE >= rows
                assert A.fwd_band_workspace_floats(6, rows, keys, D) == \
                    6 * _fwd_words(R, keys)
    # the 17a shape: one band, 33 MB of S and stats (B 1, H 8)
    assert A.fwd_band_rows(1024, 1024, 4104) == 1024
    assert A.fwd_band_workspace_floats(8, 1024, 1024, 4104) * 4 == 33 << 20
    # the card's several-band case: H 2/1, S 4160, D 4104
    assert A.fwd_band_rows(4160, 4160, 4104) == 3968


def test_band_decode_geometry():
    """The band decode's splits and workspace depend on B, Hkv, T and D,
    never on kv_len: about two blocks an SM over (256-column slices,
    splits, B * Hkv), at most one split a score tile; the workspace holds
    each row's partials, scores and tile stats."""
    assert A.band_decode_splits(1, 1, 1024, 4104, SM_COUNT) == 15
    assert A.band_decode_splits(4, 1, 1024, 4104, SM_COUNT) == 3
    assert A.band_decode_splits(4, 1, 1024, 2056, SM_COUNT) == 7
    assert A.band_decode_splits(64, 8, 1024, 8192, SM_COUNT) == 1
    assert A.band_decode_splits(1, 1, 8, 2056, SM_COUNT) == 1
    assert A.band_decode_tiles(1023) == A.band_decode_tiles(1024) == 128
    assert A.band_decode_workspace_floats(2, 8, 320, 5, 4104) == \
        2 * 8 * (5 * 4104 + 320 + 2 * 40)
    assert A.takes_band_decode(torch.float32, 2056)
    assert not A.takes_band_decode(torch.float32, 2048)
    assert not A.takes_band_decode(torch.bfloat16, 4104)
    assert A.takes_split(torch.float32, 2048)
    assert not A.takes_split(torch.float32, 2056)


def test_band_rules_tiles_and_routes_are_the_kernels():
    """The mirrors' constants and rules are the kernel sources': the tile,
    chunk and step sizes, the band rule and workspace words, the decode's
    tile, slice, key groups and chunk; the dispatch past CLUSTER_MAX_D and
    DECODE_SPLIT_MAX_D; route codes 31-34 the header's and the wrapper's;
    no column-group kernel of the f32 forward is left."""
    band = (CSRC / "attention_band.cuh").read_text()
    fwd = (CSRC / "attention_band_fwd.cu").read_text()
    dec = (CSRC / "attention_decode.cu").read_text()
    entry = (CSRC / "attention.cu").read_text()
    for name, want in (("BT", TILE), ("BCH", CHUNK), ("SROWS", STEP)):
        assert re.search(rf"constexpr int {name} = (\d+);", band).group(1) \
            == str(want), name
    assert A.BAND_TILE == TILE
    assert re.search(
        r"return static_cast<long long>\(R\) \*\s*"
        r"\(round4\(keys\) \+ 2 \* \(\(keys \+ BT - 1\) / BT\)\);", fwd)
    assert re.search(
        r"fwd_band_rows\(int rows, int keys, int D\) \{\s*"
        r"const long long budget = static_cast<long long>\(rows\) \* D;\s*"
        r"if \(fwd_band_words\(rows, keys\) <= budget\) return rows;\s*"
        r"const long long r =\s*budget / \(round4\(keys\) \+ 2 \* "
        r"\(\(keys \+ BT - 1\) / BT\)\) / BT \* BT;\s*"
        r"const int lo = rows < BT \? rows : BT;\s*"
        r"return r < lo \? lo : r > rows \? rows : static_cast<int>\(r\);",
        fwd)
    for name, want in (("BD_KEYS", DEC_KEYS), ("BD_PKG", DEC_GROUPS),
                       ("BD_PCH", DEC_CHUNK), ("BD_PT", 64)):
        assert re.search(rf"constexpr int {name} = (\d+);", dec).group(1) \
            == str(want), name
    assert A.BAND_DECODE_KEYS == DEC_KEYS
    assert A.BAND_DECODE_SLICE == 64 * 4   # BD_PT threads of 4 f32 columns
    assert entry.count("if (head_dim > CLUSTER_MAX_D)\n    return "
                       "attn_fwd_band(") == 2            # B8, B9
    assert "if (head_dim > CLUSTER_MAX_D)\n    return attn_prefill_band(" \
        in entry
    assert "  if (s_new == 1)\n    return attn_decode_band(" in entry
    header = (CSRC / "attention_route.cuh").read_text()
    assert ("ROUTE_FWD_TF32_BAND = 31, ROUTE_FWD_SINGLE_TF32_BAND = 32,\n"
            "  ROUTE_PREFILL_TF32_BAND = 33, ROUTE_DECODE_BAND = 34") in header
    assert [A.ROUTES[n] for n in (31, 32, 33, 34)] == [
        "fwd_tf32_band", "fwd_single_tf32_band", "prefill_tf32_band",
        "decode_band"]
    for kern in ("attn_fwd_band_score_kernel", "attn_fwd_band_norm_kernel",
                 "attn_fwd_band_pv_kernel"):
        assert f"{kern}<<<" in fwd, kern
    for kern in ("attn_decode_band_score_kernel", "attn_decode_band_pv_kernel"):
        assert f"{kern}<T, GR>;" in dec, kern
    for gone in ("attn_fwd_cols_kernel", "attn_decode_cols_kernel",
                 "cols_tile", "launch_fwd_cols", "launch_decode_cols",
                 "COLS_SMEM"):
        for src in (entry, fwd, dec):
            assert gone not in src, gone
