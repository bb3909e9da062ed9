"""The port's ring attention against the reference's, on the CPU.

The same numpy-seeded q, k, v go through the reference's
``ring_attention_sharded`` (shard_map over the 8-device virtual CPU
mesh, ``cpu_mesh``) and the port's (W virtual ranks on the CPU, where
the ring's per-block launches of B8/B9 forward and B10/B11 backward run
their plain versions: the kernel route's decomposition, block by block,
with the f32 merge of O and LSE).

Tolerances: f32 per element |port - ref| <= 2e-5 + 2e-5 * |ref| (one
f32 softmax summed in another order: the reference's online update
against per-block softmaxes merged by their LSE); bf16 within the
reference's own test bound against dense attention (rtol = atol =
5e-2); gradients against ``jax.grad`` of the reference, f32, rtol =
atol = 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from accl_tpu.parallel import cpu_mesh as ref_cpu_mesh  # noqa: E402
from accl_tpu.parallel.ring_attention import (  # noqa: E402
    _block_update as ref_block_update,
    ring_attention_sharded as ref_ring_sharded)
from accl_tpu_torch.ops import attention as A  # noqa: E402
from accl_tpu_torch.parallel import (  # noqa: E402
    RankCollectives, block_update, cpu_mesh, make_mesh, ring_attention,
    ring_attention_fwd, ring_attention_ref, ring_attention_sharded,
    ring_rounding_magnitudes)
from accl_tpu_torch.parallel.ring_attention import (  # noqa: E402
    from_rank_rows, to_rank_rows)

RTOL = ATOL = 2e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


def _qkv(seed, B, H, Hkv, S, D, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(dtype),
            rng.standard_normal((B, Hkv, S, D)).astype(dtype),
            rng.standard_normal((B, Hkv, S, D)).astype(dtype))


def _ref(q, k, v, W, causal):
    mesh = ref_cpu_mesh(W, axis_names=("sp",))
    return np.asarray(ref_ring_sharded(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh, "sp",
        causal=causal))


def _port(q, k, v, W, causal):
    t = [torch.from_numpy(x) for x in (q, k, v)]
    return ring_attention_sharded(*t, cpu_mesh(W, axis_names=("sp",)),
                                  "sp", causal=causal)


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want)
    lim = atol + rtol * np.abs(want)
    assert got.shape == want.shape, what
    assert (err <= lim).all(), (f"{what}: max abs err {err.max():.3g}, "
                                f"{(err / lim).max():.3g} times the limit")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("W", [4, 8])
def test_ring_matches_reference(W, causal):
    q, k, v = _qkv(0, 2, 4, 4, 16 * W, 16)
    out = _port(q, k, v, W, causal)
    assert out.dtype == torch.float32 and out.shape == q.shape
    _close(out.numpy(), _ref(q, k, v, W, causal), f"W={W} causal={causal}")


@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_ring_gqa_unrepeated_kv_matches_reference(hkv):
    q, k, v = _qkv(12, 2, 8, hkv, 64, 16)
    _close(_port(q, k, v, 4, True).numpy(), _ref(q, k, v, 4, True),
           f"Hkv={hkv}")


def test_ring_bf16_matches_reference():
    q, k, v = _qkv(3, 1, 2, 2, 64, 32)
    qb, kb, vb = (torch.from_numpy(x).bfloat16() for x in (q, k, v))
    out = ring_attention_sharded(qb, kb, vb, cpu_mesh(4, axis_names=("sp",)),
                                 "sp", causal=True)
    assert out.dtype == torch.bfloat16
    ref = ref_ring_sharded(
        *(jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)),
        ref_cpu_mesh(4, axis_names=("sp",)), "sp", causal=True)
    assert ref.dtype == jnp.bfloat16
    _close(out.float().numpy(), np.asarray(ref, np.float32), "bf16",
           rtol=5e-2, atol=5e-2)


def test_ring_long_context_matches_reference():
    """S = 512 over W = 8: each rank holds 64 keys."""
    q, k, v = _qkv(4, 1, 2, 2, 512, 8)
    _close(_port(q, k, v, 8, True).numpy(), _ref(q, k, v, 8, True),
           "S=512 W=8")


@pytest.mark.parametrize("W,causal,hkv", [(4, True, 4), (4, False, 2),
                                          (8, True, 2), (8, False, 1)])
def test_ring_gradients_match_jax_grad(W, causal, hkv):
    q, k, v = _qkv(5, 2, 4, hkv, 8 * W, 16)
    do = np.random.default_rng(6).standard_normal(q.shape).astype(
        np.float32)
    mesh = ref_cpu_mesh(W, axis_names=("sp",))

    def f(q, k, v):
        out = ref_ring_sharded(q, k, v, mesh, "sp", causal=causal)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                            for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ring_attention_sharded(*leaves, cpu_mesh(W, axis_names=("sp",)),
                                 "sp", causal=causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        err = np.abs(g.numpy() - w)
        assert (err <= GRAD_TOL + GRAD_TOL * np.abs(w)).all(), (
            f"{name}: max abs err {err.max():.3g} (rtol = atol = 1e-4)")


@pytest.mark.parametrize("causal", [True, False])
def test_block_update_matches_reference(causal):
    """One step of the online softmax from a running state (m -inf on the
    rows no block has reached yet, as at the first hop), q and k at
    overlapping global positions so that the causal mask cuts the
    block."""
    rng = np.random.default_rng(7)
    B, Hkv, G, Sq, Skv, D = 2, 2, 3, 8, 8, 16
    q = rng.standard_normal((B, Hkv, G, Sq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
            for _ in range(2))
    m = rng.standard_normal((B, Hkv, G, Sq, 1)).astype(np.float32)
    m[:, :, :, :3] = np.finfo(np.float32).min
    l = np.abs(rng.standard_normal(m.shape)).astype(np.float32)
    l[:, :, :, :3] = 0
    acc = rng.standard_normal((B, Hkv, G, Sq, D)).astype(np.float32)
    acc[:, :, :, :3] = 0
    q_pos = np.arange(Sq) + 4
    k_pos = np.arange(Skv) + 6
    want = ref_block_update(*(jnp.asarray(x) for x in (q, k, v, m, l, acc,
                                                        q_pos, k_pos)),
                            0.25, causal)
    got = block_update(*(torch.from_numpy(x) for x in (q, k, v, m, l, acc,
                                                        q_pos, k_pos)),
                       0.25, causal)
    for name, g, w in zip(("m", "l", "acc"), got, want):
        _close(g.numpy(), np.asarray(w), name)


def ring_limit(plain, mag, part):
    """The bf16 ring's limit for output ``part`` ("o", "dq", "dk", "dv")
    against the f32 plain ring, per element, as ``chip_smoke.py`` holds
    it on the card: 2^-8 of the magnitude of its rounded sums (the
    kernels' P and dS, and delta from the rounded O; mag[part]) and of
    its rounded per-block partials (O and dq, mag[part + "_parts"]),
    plus one bf16 ulp of the element floored at one ulp of the median
    (2^-7 * |plain| + 2^-7 * median |plain|)."""
    a = plain.abs()
    lim = 2.0 ** -8 * mag[part] + 2.0 ** -7 * (a + float(a.median()))
    if part + "_parts" in mag:
        lim = lim + 2.0 ** -8 * mag[part + "_parts"]
    return lim


def _rows(seed, W, B, H, Hkv, S_l, D, dtype=torch.float32):
    q, k, v = _qkv(seed, B, H, Hkv, W * S_l, D)
    return [to_rank_rows(torch.from_numpy(x).to(dtype), W)
            for x in (q, k, v)]


@pytest.mark.parametrize("W,causal", [(4, True), (4, False), (8, True)])
def test_launches_rounds_and_bytes(W, causal):
    """A ring call launches W(W+1)/2 blocks causal, W^2 not, forward
    (B9 here: one key block a shard) and backward (B10 and B11 each);
    each direction takes W - 1 exchange rounds, and K/V cross them with
    their Hkv heads, not H."""
    B, H, Hkv, S_l, D = 2, 8, 2, 8, 16
    q, k, v = (t.requires_grad_() for t in _rows(8, W, B, H, Hkv, S_l, D))
    coll = RankCollectives(cpu_mesh(W, axis_names=("sp",)).group("sp"))
    A.plain_runs.update(dict.fromkeys(A.plain_runs, 0))
    out = ring_attention(q, k, v, coll, causal=causal)
    blocks = W * (W + 1) // 2 if causal else W * W
    assert A.plain_runs == {"fwd": 0, "fwd_single": blocks, "bwd_dkv": 0,
                            "bwd_dq": 0, "decode": 0}
    kv_hop = 2 * B * Hkv * S_l * D * 4          # one rank's K and V, f32
    assert coll.exchange_rounds == W - 1
    assert coll.wire_bytes == (W - 1) * W * kv_hop
    torch.autograd.grad(out, (q, k, v), torch.ones_like(out))
    assert A.plain_runs["bwd_dkv"] == A.plain_runs["bwd_dq"] == blocks
    assert coll.exchange_rounds == 2 * (W - 1)
    # backward: K, V and their f32 dK, dV accumulators
    assert coll.wire_bytes == (W - 1) * W * 3 * kv_hop


@pytest.mark.parametrize("causal", [True, False])
def test_merged_lse_is_the_whole_sequence_lse(causal):
    """The ring's merged LSE of rank r is the LSE of its queries over the
    whole sequence (finite on every row: the diagonal block always shows
    query i its own key)."""
    W, B, H, Hkv, S_l, D = 4, 2, 4, 2, 8, 16
    q, k, v = _rows(9, W, B, H, Hkv, S_l, D)
    coll = RankCollectives(cpu_mesh(W, axis_names=("sp",)).group("sp"))
    o, lse = ring_attention_fwd(q, k, v, coll, causal=causal)
    assert lse.shape == (W, B * H, S_l) and lse.is_contiguous()
    assert torch.isfinite(lse).all()
    whole_o, whole_lse = A.flash_attention_ref(
        *(from_rank_rows(t) for t in (q, k, v)), causal)
    _close(from_rank_rows(o).numpy(), whole_o.numpy(), "O")
    want = whole_lse.reshape(B * H, W, S_l).transpose(0, 1)
    _close(lse.numpy(), want.numpy(), "LSE")


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_route_against_plain_ring(dtype, causal):
    """The kernel route (per-block launches, the LSE merge, the
    backward's per-block B10/B11) against the plain ring
    (``block_update`` through the reference's schedule, torch autograd)
    on f32 copies of the same inputs, as the card holds them. f32: the
    f32 attention limit (2e-5 + 2e-5 * |plain|; gradients 1e-4, as
    ``jax.grad`` above). bf16: ``ring_limit`` (one bf16 rounding of each
    block's O and dq before the f32 merge, of O in delta and of the
    result; it also allows for the kernels' rounding of P and dS, which
    the plain versions on the CPU do not round)."""
    W, B, H, Hkv, S_l, D = 4, 1, 4, 2, 16, 16
    rows = _rows(10, W, B, H, Hkv, S_l, D, dtype)
    leaves = [t.clone().requires_grad_() for t in rows]
    exact = [t.float().requires_grad_() for t in rows]
    coll = RankCollectives(cpu_mesh(W, axis_names=("sp",)).group("sp"))
    do = torch.randn(rows[0].shape, generator=torch.Generator().manual_seed(
        0)).to(dtype)
    got = ring_attention(*leaves, coll, causal=causal)
    want = ring_attention_ref(*exact, causal=causal)
    assert got.dtype == dtype
    gg = torch.autograd.grad(got, leaves, do)
    gw = torch.autograd.grad(want, exact, do.float())
    if dtype == torch.bfloat16:
        o, lse = ring_attention_fwd(*rows, coll, causal=causal)
        mag = ring_rounding_magnitudes(*rows, lse, do, o, causal)
    for name, g, w in zip(("O", "dq", "dk", "dv"), (got,) + gg,
                          (want,) + gw):
        assert g.dtype == dtype, name
        g, w = g.detach().float(), w.detach()
        if dtype == torch.float32:
            tol = 2e-5 if name == "O" else 1e-4
            lim = tol + tol * w.abs()
        else:
            lim = ring_limit(w, mag, name.lower())
        ratio = float(((g - w).abs() / lim).max())
        assert ratio <= 1.0, (f"{name} {dtype}: max abs err "
                              f"{float((g - w).abs().max()):.3g}, {ratio:.3g} "
                              f"times its limit")


def test_ring_refuses_indivisible_sequence():
    q, k, v = (torch.zeros(1, 2, 30, 16) for _ in range(3))
    with pytest.raises(ValueError, match="not divisible"):
        ring_attention_sharded(q, k, v, cpu_mesh(4, axis_names=("sp",)))


def test_mesh_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: make_mesh builds on it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh((4,), ("sp",))


def test_rank_mesh_axes_and_groups():
    mesh = cpu_mesh(8, (2, 4), ("dp", "sp"))
    assert mesh.shape == {"dp": 2, "sp": 4} and tuple(mesh.shape) == (
        "dp", "sp")
    assert mesh.size == 8 and mesh.device == torch.device("cpu")
    assert mesh.group("sp").size == 4 and mesh.group("dp").size == 2
    with pytest.raises(ValueError, match="not in mesh"):
        mesh.group("tp")
    with pytest.raises(ValueError, match="needs 16 ranks, have 8"):
        cpu_mesh(8, (4, 4), ("dp", "sp"))
    with pytest.raises(ValueError, match="differ in length"):
        cpu_mesh(8, (2, 4), ("sp",))


def test_communicator_mesh_bindings_match_reference():
    """``communicator_from_mesh`` numbers the mesh's ranks row-major as
    the reference numbers its devices: the same global ranks and comm id;
    ``mesh_from_communicator`` binds them back to a 1-D mesh."""
    from accl_tpu.parallel.mesh import (
        communicator_from_mesh as ref_from_mesh,
        mesh_from_communicator as ref_to_mesh)
    from accl_tpu_torch.parallel import (communicator_from_mesh,
                                         mesh_from_communicator)
    want = ref_from_mesh(ref_cpu_mesh(8, (2, 4), ("dp", "sp")), "sp")
    got = communicator_from_mesh(cpu_mesh(8, (2, 4), ("dp", "sp")), "sp")
    assert [r.global_rank for r in got.ranks] == [
        r.global_rank for r in want.ranks]
    assert (got.comm_id, got.mesh_axis, got.size) == (
        want.comm_id, want.mesh_axis, want.size)
    mesh = mesh_from_communicator(got, "ring")
    ref_mesh = ref_to_mesh(want, "ring")
    assert mesh.shape == dict(ref_mesh.shape) and got.mesh_axis == "ring"
    assert mesh.device == torch.device("cpu")
