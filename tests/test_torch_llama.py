"""The port's Llama serving path against the reference's, on the CPU.

The reference's ``Llama.init(jax.random.key(0))`` parameters go through
``llama_params_from_reference`` into the port's module; the same tokens
then go through both. On the CPU the port's attention wrappers run their
plain versions. Tolerances: f32 logits within rtol = atol = 2e-4 (the
tolerance of the reference's own cache-against-forward test,
``test_models.py:135``); greedy tokens equal element for element.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from accl_tpu.models import llama as RL  # noqa: E402
from accl_tpu_torch.convert import llama_params_from_reference  # noqa: E402
from accl_tpu_torch.models import Llama, LlamaConfig  # noqa: E402
from accl_tpu_torch.models import llama as PL  # noqa: E402
from accl_tpu_torch.ops import attention as A  # noqa: E402


@pytest.fixture(autouse=True)
def _shm_leak_sweep():
    """Overrides conftest's /dev/shm sweep for this module: the port
    creates no shm segment, and a segment another xdist worker's
    ShmFabric world holds must not fail these tests at teardown."""
    yield


TOL = 2e-4
TINY = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, ffn_dim=128)
B, S = 2, 10


def _pair(dtype="float32", attention="flash"):
    rcfg = dataclasses.replace(RL.LlamaConfig.tiny(**TINY),
                               dtype=getattr(jnp, dtype), attention=attention)
    ref = RL.Llama(rcfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
    pcfg = dataclasses.replace(LlamaConfig.tiny(**TINY),
                               dtype=getattr(torch, dtype),
                               attention=attention)
    port = Llama(pcfg, device="cpu").load_reference_params(params)
    return ref, params, port


@pytest.fixture(scope="module")
def f32_flash():
    return _pair()


@pytest.fixture(scope="module")
def tokens():
    return np.random.default_rng(0).integers(0, 256, (B, S)).astype(np.int32)


def _t(tok):
    return torch.from_numpy(np.asarray(tok)).long()


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_forward_matches_reference(attention, tokens):
    ref, params, port = _pair(attention=attention)
    want = np.asarray(ref.forward(params, jnp.asarray(tokens)))
    before = dict(A.plain_runs)
    got = port(_t(tokens))
    assert got.dtype == torch.float32 and got.shape == (B, S, 256)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # flash: B9's plain branch once per layer (S fits one reference block)
    ran = A.plain_runs["fwd_single"] - before["fwd_single"]
    assert ran == (TINY["n_layers"] if attention == "flash" else 0)


@pytest.mark.parametrize("attention", ["flash", "dense"])
def test_forward_cached_matches_reference_per_step(attention, tokens):
    """Prefill 6 tokens, then 4 single-token decodes: each step's logits
    equal the reference's step and the port's own full forward."""
    ref, params, port = _pair(attention=attention)
    full = port(_t(tokens)).numpy()
    rcache = ref.init_kv_cache(B, max_len=S)
    cache = port.init_kv_cache(B, max_len=S)
    steps = [(0, 6)] + [(t, t + 1) for t in range(6, S)]
    for a, b in steps:
        want, rcache = ref.forward_cached(params, jnp.asarray(tokens[:, a:b]),
                                          rcache)
        got, out_cache = port.forward_cached(_t(tokens[:, a:b]), cache)
        assert out_cache is cache and cache["pos"] == b
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL, err_msg=f"step {a}:{b}")
        np.testing.assert_allclose(got.numpy(), full[:, a:b], rtol=TOL,
                                   atol=TOL, err_msg=f"vs forward {a}:{b}")
    np.testing.assert_allclose(cache["k"].numpy(), np.asarray(rcache["k"]),
                               rtol=TOL, atol=TOL)
    assert int(rcache["pos"]) == cache["pos"] == S


def test_generate_greedy_matches_reference(f32_flash):
    ref, params, port = f32_flash
    prompt = np.asarray([[5, 9, 3, 77], [1, 2, 250, 8]], np.int32)
    want = np.asarray(ref.generate(params, jnp.asarray(prompt), max_new=6))
    got = port.generate(_t(prompt), max_new=6)
    assert got.shape == (2, 6) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_bf16_forward_close_to_reference(tokens):
    """bf16 activations (the reference's default dtype). Every layer
    rounds its activations to bf16 at some ten points (2^-8 relative
    each), and XLA and torch place some of those roundings differently
    (fused elementwise chains, matmul accumulation), so one position's
    logits can move by a few bf16 ulps: they are held within 8 ulps of
    the logit scale (8 * 2^(floor(log2 max|logit|) - 7)); the greedy
    choice must still agree on most positions."""
    ref, params, port = _pair(dtype="bfloat16")
    want = np.asarray(ref.forward(params, jnp.asarray(tokens)))
    got = port(_t(tokens)).numpy()
    assert np.isfinite(got).all()
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    np.testing.assert_allclose(got, want, rtol=0, atol=8 * ulp)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.9


def test_dense_and_flash_cached_agree(f32_flash, tokens):
    _ref, params, flash = f32_flash
    dense = Llama(dataclasses.replace(flash.config, attention="dense"),
                  device="cpu").load_reference_params(params)
    cf, cd = flash.init_kv_cache(B, 16), dense.init_kv_cache(B, 16)
    for a, b in ((0, 7), (7, 8), (8, 10)):
        lf, _ = flash.forward_cached(_t(tokens[:, a:b]), cf)
        ld, _ = dense.forward_cached(_t(tokens[:, a:b]), cd)
        torch.testing.assert_close(lf, ld, rtol=TOL, atol=TOL)


def test_helpers_match_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, 3, 16)).astype(np.float32)
    w = rng.standard_normal(16).astype(np.float32)
    pos = np.arange(3, 10)
    np.testing.assert_allclose(
        PL._rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5).numpy(),
        np.asarray(RL._rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        PL._apply_rope(torch.from_numpy(x), PL._rope_tables(
            torch.from_numpy(pos), 16, 500_000.0)).numpy(),
        np.asarray(RL._rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)),
        rtol=1e-5, atol=1e-5)


def test_init_reproducible_with_reference_shapes_and_spread(f32_flash):
    """One seed gives one set of weights; shapes and dtypes are the
    reference's per-layer slices; every matrix has std fan_in^-0.5
    (within 10 %, at least 2048 draws per leaf) and every norm is one."""
    _ref, params, port = f32_flash
    cfg = port.config
    a = Llama(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    b = Llama(cfg, device="cpu").init(torch.Generator().manual_seed(3))
    c = Llama(cfg, device="cpu").init(torch.Generator().manual_seed(4))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    want = llama_params_from_reference(params)
    assert sa.keys() == want.keys()
    fan_in = {"embed": cfg.dim, "lm_head": cfg.dim, "wq": cfg.dim,
              "wk": cfg.dim, "wv": cfg.dim, "w_gate": cfg.dim,
              "w_up": cfg.dim, "wo": cfg.dim, "w_down": cfg.ffn_dim}
    for key, t in sa.items():
        assert torch.equal(t, sb[key]), key
        assert t.shape == want[key].shape and t.dtype == want[key].dtype
        name = key.split(".")[-1]
        if name.endswith("norm"):
            assert torch.equal(t, torch.ones_like(t)), key
            continue
        assert not torch.equal(t, sc[key]), key
        std = float(t.std())
        assert abs(std / fan_in[name] ** -0.5 - 1) < 0.1, (key, std)
        assert abs(std / float(np.std(want[key].numpy())) - 1) < 0.1, key
    assert a.param_count() == sum(int(np.prod(x.shape))
                                  for x in jax.tree.leaves(params))


def test_conversion_rejects_missing_and_extra_keys(f32_flash):
    _ref, params, _port = f32_flash
    missing = dict(params, layers={k: v for k, v in params["layers"].items()
                                   if k != "wq"})
    with pytest.raises(KeyError, match="wq"):
        llama_params_from_reference(missing)
    extra = dict(params, bias=np.zeros(3, np.float32))
    with pytest.raises(KeyError, match="bias"):
        llama_params_from_reference(extra)
    without = {k: v for k, v in params.items() if k != "lm_head"}
    with pytest.raises(KeyError, match="lm_head"):
        llama_params_from_reference(without)


def test_conversion_carries_bf16_bits():
    import ml_dtypes
    x = np.random.default_rng(1).standard_normal((2, 8)).astype(
        ml_dtypes.bfloat16)
    params = {"embed": x, "final_norm": x[0], "lm_head": x,
              "layers": {k: x[:, None] for k in
                         ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm",
                          "w_gate", "w_up", "w_down")}}
    sd = llama_params_from_reference(params)
    assert sd["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(sd["embed"].view(torch.int16).numpy(),
                                  x.view(np.int16))
    assert sd["layers.1.wq"].shape == (1, 8)


def test_forward_cached_refuses_to_overrun(f32_flash, tokens):
    """The reference clamps the write position of a cache that is too
    short (dynamic_update_slice); the port raises."""
    _ref, _params, port = f32_flash
    cache = port.init_kv_cache(B, max_len=8)
    port.forward_cached(_t(tokens[:, :6]), cache)
    with pytest.raises(ValueError, match="overrun"):
        port.forward_cached(_t(tokens[:, 6:9]), cache)
    assert cache["pos"] == 6
    with pytest.raises(ValueError, match="max_len"):
        port.generate(_t(tokens[:, :6]), max_new=4, max_len=7)


def test_temperature_sampling_follows_the_generator(f32_flash):
    _ref, _params, port = f32_flash
    prompt = torch.tensor([[5, 9, 3]])
    runs = [port.generate(prompt, max_new=5, temperature=0.8,
                          generator=torch.Generator().manual_seed(s))
            for s in (11, 11)]
    assert torch.equal(runs[0], runs[1])
    assert ((runs[0] >= 0) & (runs[0] < 256)).all()


def test_refusals():
    with pytest.raises(ValueError, match="attention"):
        Llama(dataclasses.replace(LlamaConfig.tiny(), attention="ring"),
              device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            Llama(LlamaConfig.tiny())


def test_llama3_8b_geometry():
    c = LlamaConfig.llama3_8b()
    r = RL.LlamaConfig.llama3_8b()
    for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
              "ffn_dim", "rope_theta", "norm_eps", "head_dim"):
        assert getattr(c, f) == getattr(r, f), f
    assert c.head_dim == 128 and c.n_heads // c.n_kv_heads == 4


# -- causality (ROADMAP §C) ----------------------------------------------------

def _causality_inputs(vocab: int):
    """The reference test's two inputs (``test_models.py::test_causality``):
    16 seeded tokens, and the same with the last token changed."""
    rng = np.random.default_rng(0)
    t1 = rng.integers(0, vocab, (1, 16)).astype(np.int32)
    t2 = t1.copy()
    t2[0, -1] = (t2[0, -1] + 1) % vocab
    return t1, t2


@pytest.mark.parametrize("attention", ["dense", "flash"])
def test_causality(attention):
    """A future token must not move earlier logits (atol 1e-5): the
    port's bf16 model on the CPU plain path, both attentions."""
    cfg = dataclasses.replace(LlamaConfig.tiny(), attention=attention)
    port = Llama(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    t1, t2 = _causality_inputs(cfg.vocab_size)
    l1, l2 = port(_t(t1)), port(_t(t2))
    np.testing.assert_allclose(l1[0, :-1].numpy(), l2[0, :-1].numpy(),
                               atol=1e-5)
    assert not torch.equal(l1[0, -1], l2[0, -1])


def _oracle_forward(params: dict, tokens: np.ndarray, c) -> np.ndarray:
    """The reference Llama's forward in float64 numpy: RMSNorm, RoPE,
    causal GQA attention, SwiGLU, from its parameter pytree."""
    p = jax.tree.map(lambda a: np.asarray(a, np.float64), params)
    hd, nh, nkv = c.head_dim, c.n_heads, c.n_kv_heads
    B, S = tokens.shape

    def norm(x, w):
        return x / np.sqrt(np.mean(x * x, -1, keepdims=True) + c.norm_eps) * w

    ang = np.arange(S)[:, None] * (
        1.0 / c.rope_theta ** (np.arange(0, hd, 2) / hd))[None]
    cos, sin = np.cos(ang)[:, None], np.sin(ang)[:, None]

    def rope(x):
        x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
        return np.concatenate([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)

    x = p["embed"][tokens]
    mask = np.tril(np.ones((S, S), bool))
    for i in range(c.n_layers):
        ly = {k: v[i] for k, v in p["layers"].items()}
        h = norm(x, ly["attn_norm"])
        q = rope((h @ ly["wq"]).reshape(B, S, nh, hd))
        k = rope((h @ ly["wk"]).reshape(B, S, nkv, hd))
        v = (h @ ly["wv"]).reshape(B, S, nkv, hd)
        k, v = (np.repeat(t, nh // nkv, axis=2) for t in (k, v))
        s = np.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        s = np.where(mask, s, -np.inf)
        pr = np.exp(s - s.max(-1, keepdims=True))
        pr /= pr.sum(-1, keepdims=True)
        a = np.einsum("bhqk,bkhd->bqhd", pr, v).reshape(B, S, nh * hd)
        x = x + a @ ly["wo"]
        h = norm(x, ly["mlp_norm"])
        g = h @ ly["w_gate"]
        x = x + (g / (1 + np.exp(-g)) * (h @ ly["w_up"])) @ ly["w_down"]
    return norm(x, p["final_norm"]) @ p["lm_head"]


def test_reference_forward_on_causality_inputs_matches_oracle():
    """The reference's forward (tiny, bf16 activations, flash) on the two
    inputs of its causality test against a float64 numpy oracle: within
    2^-4 of the oracle's norm (bf16 rounding through 2 layers), and the
    oracle itself moves no earlier logit."""
    cfg = RL.LlamaConfig.tiny()
    ref = RL.Llama(cfg)
    params = jax.tree.map(np.asarray, ref.init(jax.random.key(0)))
    t1, t2 = _causality_inputs(cfg.vocab_size)
    o1, o2 = (_oracle_forward(params, t, cfg) for t in (t1, t2))
    np.testing.assert_allclose(o1[0, :-1], o2[0, :-1], rtol=0, atol=1e-12)
    for t, o in ((t1, o1), (t2, o2)):
        got = np.asarray(ref.forward(params, jnp.asarray(t)), np.float64)
        rel = np.linalg.norm(got - o) / np.linalg.norm(o)
        assert rel <= 2.0 ** -4, rel
