"""The port's Ulysses sequence parallelism against the reference's, on
the CPU.

The same numpy-seeded tensors go through the reference
(``seq_to_heads`` / ``heads_to_seq`` and ``ulysses_attention_sharded``
under shard_map on the 8-device virtual CPU mesh, its flash attention in
interpret mode) and the port (W virtual ranks on the CPU: the reshards
are ``RankCollectives.alltoall`` rounds, the attention one
``flash_attention`` call with the rank a batch axis, whose plain version
runs here). The reshards are pure data movement and are held bitwise;
attention in f32 per element within 2e-5 + 2e-5 * |ref|, gradients
against ``jax.grad`` within rtol = atol = 1e-4.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from accl_tpu.parallel import cpu_mesh as ref_cpu_mesh  # noqa: E402
from accl_tpu.parallel.ulysses import (  # noqa: E402
    heads_to_seq as ref_heads_to_seq, seq_to_heads as ref_seq_to_heads,
    ulysses_attention_sharded as ref_ulysses_sharded)
from accl_tpu.utils.compat import shard_map  # noqa: E402
from accl_tpu_torch.parallel import (RankCollectives, cpu_mesh,  # noqa: E402
                                     heads_to_seq, seq_to_heads,
                                     ulysses_attention,
                                     ulysses_attention_sharded)
from accl_tpu_torch.parallel.ring_attention import to_rank_rows  # noqa: E402

RTOL = ATOL = 2e-5
GRAD_TOL = 1e-4


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


def _coll(W):
    return RankCollectives(cpu_mesh(W, axis_names=("sp",)).group("sp"))


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _ref_per_rank(fn, x, W):
    """``fn`` on every rank of the reference's sp axis, x (W, ...) holding
    rank r's operand in row r; returns the ranks' outputs stacked."""
    mesh = ref_cpu_mesh(W, axis_names=("sp",))
    spec = P("sp")
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
    f = shard_map(lambda y: fn(y[0], "sp")[None], mesh=mesh, in_specs=spec,
                  out_specs=spec)
    return np.asarray(jax.jit(f)(xs))


def _close(got, want, what, tol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = np.abs(got - want)
    assert (err <= tol + tol * np.abs(want)).all(), (
        f"{what}: max abs err {err.max():.3g}")


@pytest.mark.parametrize("W", [4, 8])
def test_reshard_round_trip_is_bitwise(W):
    x = torch.from_numpy(_normal(1, W, 2, 8, 4, 4))
    coll = _coll(W)
    y = seq_to_heads(x, coll)
    assert y.shape == (W, 2, 8 // W, 4 * W, 4)
    assert torch.equal(heads_to_seq(y, coll), x)


@pytest.mark.parametrize("W", [4, 8])
def test_seq_to_heads_matches_reference(W):
    x = _normal(2, W, 2, 8, 4, 4)          # rank r: (B, H, S_l, D)
    got = seq_to_heads(torch.from_numpy(x), _coll(W)).numpy()
    want = _ref_per_rank(ref_seq_to_heads, x, W)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("W", [4, 8])
def test_heads_to_seq_matches_reference(W):
    x = _normal(3, W, 2, 2, 4 * W, 4)      # rank r: (B, H/W, S, D)
    got = heads_to_seq(torch.from_numpy(x), _coll(W)).numpy()
    want = _ref_per_rank(ref_heads_to_seq, x, W)
    np.testing.assert_array_equal(got, want)


def _qkv(seed, B, H, Hkv, S, D):
    return (_normal(seed, B, H, S, D), _normal(seed + 1, B, Hkv, S, D),
            _normal(seed + 2, B, Hkv, S, D))


def _ref(q, k, v, W, causal):
    return np.asarray(ref_ulysses_sharded(
        *(jnp.asarray(x) for x in (q, k, v)),
        ref_cpu_mesh(W, axis_names=("sp",)), "sp", causal=causal))


def _port(q, k, v, W, causal):
    return ulysses_attention_sharded(
        *(torch.from_numpy(x) for x in (q, k, v)),
        cpu_mesh(W, axis_names=("sp",)), "sp", causal=causal)


@pytest.mark.parametrize("hkv", [8, 4, 2])
def test_ulysses_gqa_matches_reference(hkv):
    q, k, v = _qkv(11, 2, 16, hkv, 64, 16)
    _close(_port(q, k, v, 8, True).numpy(), _ref(q, k, v, 8, True),
           f"Hkv={hkv}")


@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_reference(causal):
    q, k, v = _qkv(21, 2, 8, 8, 64, 16)
    _close(_port(q, k, v, 4, causal).numpy(), _ref(q, k, v, 4, causal),
           f"causal={causal}")


@pytest.mark.parametrize("W,H,hkv,wire_heads", [
    (8, 16, 8, 8),      # Hkv splits over the ranks: un-repeated
    (4, 8, 8, 8),
    (8, 16, 4, 8),      # W % Hkv == 0: repeated to one head a rank
    (8, 16, 2, 8),
    (4, 8, 2, 4),
    (4, 12, 3, 12)])    # neither: repeated to H
def test_alltoall_carries_kv_heads(W, H, hkv, wire_heads):
    """K and V cross the alltoall with Hkv heads when Hkv splits over the
    ranks (Hkv/W a rank), else minimally repeated; the logical bytes
    that leave a rank are (W - 1)/W of q, k, v and the output."""
    B, S_l, D = 2, 4, 8
    q, k, v = (to_rank_rows(torch.from_numpy(x), W)
               for x in _qkv(31, B, H, hkv, W * S_l, D))
    coll = _coll(W)
    rows = []
    alltoall = coll.alltoall
    coll.alltoall = lambda x, **kw: rows.append(x.shape) or alltoall(x, **kw)
    ulysses_attention(q, k, v, coll, causal=True)
    one_head = B * S_l * D
    assert rows == [(W, H * one_head), (W, wire_heads * one_head),
                    (W, wire_heads * one_head), (W, H * one_head)]
    assert coll.wire_bytes == (W - 1) * 4 * one_head * (
        2 * H + 2 * wire_heads)


@pytest.mark.parametrize("W,causal,hkv", [(8, True, 8), (8, True, 2),
                                          (4, False, 4)])
def test_ulysses_gradients_match_jax_grad(W, causal, hkv):
    q, k, v = _qkv(41, 2, 8, hkv, 8 * W, 16)
    do = _normal(44, *q.shape)
    mesh = ref_cpu_mesh(W, axis_names=("sp",))

    def f(q, k, v):
        out = ref_ulysses_sharded(q, k, v, mesh, "sp", causal=causal)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                            for x in (q, k, v)))
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ulysses_attention_sharded(*leaves, cpu_mesh(W, axis_names=("sp",)),
                                    "sp", causal=causal)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.numpy(), w, name, GRAD_TOL)


def test_ulysses_refuses_heads_that_do_not_split():
    q, k, v = (to_rank_rows(torch.zeros(1, 6, 16, 8), 4) for _ in range(3))
    with pytest.raises(ValueError, match="not divisible by axis size"):
        ulysses_attention(q, k, v, _coll(4))
