"""Llama-family transformer: ``accl_tpu/models/llama.py`` on one device.

Shapes follow the Llama-3 family (GQA, SwiGLU, RoPE, RMSNorm);
``LlamaConfig.llama3_8b()`` is the 8B geometry. Weights keep the
reference's (in, out) orientation (``x @ w``), and a Python loop over
the layers replaces its ``lax.scan``. Attention runs the fused kernels of
:mod:`accl_tpu_torch.ops.attention` (``attention="flash"``: B8/B9 in
``forward`` with B10/B11 in its backward, B12 in ``forward_cached``) or
the reference's own score-materialising path (``attention="dense"``,
trained by plain autograd), which is the plain version of the model.

Serving: ``forward``, ``forward_cached`` (prefill and decode over a
preallocated KV cache) and ``generate``, which build no autograd graph.
Training: ``loss`` and ``make_train_step``. Parameters are created
without gradients (serving needs none); ``make_train_step`` turns them
on. The sharded paths and MoE are later slices (ROADMAP A9).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..convert import llama_params_from_reference
from ..ops.attention import flash_attention, flash_decode
from ..parallel.mesh import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    ffn_dim: int = 14_336
    max_seq_len: int = 8192
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16      # activations
    param_dtype: torch.dtype = torch.float32
    attention: str = "flash"                 # "flash" or "dense"
    # Mixture-of-experts FFN: kept for the reference's field set; any
    # n_experts > 0 is refused until ROADMAP A9 ports it
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_coef: float = 0.01

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def llama3_8b(cls) -> "LlamaConfig":
        return cls()

    @classmethod
    def tiny(cls, vocab: int = 256, dim: int = 64, n_layers: int = 2,
             n_heads: int = 4, n_kv_heads: int = 2, ffn_dim: int = 128,
             max_seq_len: int = 128) -> "LlamaConfig":
        return cls(vocab_size=vocab, dim=dim, n_layers=n_layers,
                   n_heads=n_heads, n_kv_heads=n_kv_heads, ffn_dim=ffn_dim,
                   max_seq_len=max_seq_len)


def _rms_norm(x, w, eps):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


def _rope_tables(positions, hd, theta):
    """(cos, sin) of the rotary angles, (seq, 1, hd/2) f32: computed once
    per call and shared by every layer's q and k."""
    exps = torch.arange(0, hd, 2, dtype=torch.float32,
                        device=positions.device) / hd
    freqs = 1.0 / (theta ** exps)
    angles = positions[..., None].float() * freqs          # (seq, hd/2)
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def _apply_rope(x, tables):
    cos, sin = tables
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _param(*shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class _Layer(nn.Module):
    """One decoder layer's weights (the reference's per-layer slices)."""

    def __init__(self, c: LlamaConfig, device):
        super().__init__()
        hd, pd = c.head_dim, c.param_dtype
        self.attn_norm = _param(c.dim, dtype=pd, device=device)
        self.wq = _param(c.dim, c.n_heads * hd, dtype=pd, device=device)
        self.wk = _param(c.dim, c.n_kv_heads * hd, dtype=pd, device=device)
        self.wv = _param(c.dim, c.n_kv_heads * hd, dtype=pd, device=device)
        self.wo = _param(c.n_heads * hd, c.dim, dtype=pd, device=device)
        self.mlp_norm = _param(c.dim, dtype=pd, device=device)
        self.w_gate = _param(c.dim, c.ffn_dim, dtype=pd, device=device)
        self.w_up = _param(c.dim, c.ffn_dim, dtype=pd, device=device)
        self.w_down = _param(c.ffn_dim, c.dim, dtype=pd, device=device)


class Llama(nn.Module):
    """The model on one device (``device="cuda"`` by default, which
    raises without CUDA; pass ``"cpu"`` for the plain versions of the
    kernels). Weights are uninitialised until :meth:`init` or
    :meth:`load_reference_params`."""

    def __init__(self, config: LlamaConfig, device="cuda"):
        super().__init__()
        if config.n_experts:
            raise NotImplementedError(
                "Mixture-of-experts Llama (n_experts > 0) is not ported "
                "yet (ROADMAP A9)")
        if config.attention not in ("flash", "dense"):
            raise ValueError(f"attention must be 'flash' or 'dense', not "
                             f"{config.attention!r}")
        self.config = config
        dev = resolve_device(device)
        pd = config.param_dtype
        self.embed = _param(config.vocab_size, config.dim, dtype=pd,
                            device=dev)
        self.layers = nn.ModuleList(_Layer(config, dev)
                                    for _ in range(config.n_layers))
        self.final_norm = _param(config.dim, dtype=pd, device=dev)
        self.lm_head = _param(config.dim, config.vocab_size, dtype=pd,
                              device=dev)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    # -- parameters --------------------------------------------------------
    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Llama":
        """Draw the reference's distribution from ``generator``: every
        matrix normal x fan_in^-0.5 in param_dtype (fan_in = its input
        width; the embedding's is dim), every norm weight one. Draws on
        the generator's device, then lands on the model's."""
        c = self.config

        def dense(p, fan_in):
            x = torch.randn(p.shape, generator=generator,
                            dtype=c.param_dtype, device=generator.device)
            p.copy_(x * (fan_in ** -0.5))

        dense(self.embed, c.dim)
        for lyr in self.layers:
            lyr.attn_norm.fill_(1)
            lyr.mlp_norm.fill_(1)
            for name in ("wq", "wk", "wv", "w_gate", "w_up"):
                dense(getattr(lyr, name), c.dim)
            dense(lyr.wo, c.n_heads * c.head_dim)
            dense(lyr.w_down, c.ffn_dim)
        self.final_norm.fill_(1)
        dense(self.lm_head, c.dim)
        return self

    def load_reference_params(self, params: dict) -> "Llama":
        """Load the reference's parameter pytree (numpy leaves, layer
        leaves stacked along a leading n_layers axis)."""
        self.load_state_dict(llama_params_from_reference(params),
                             strict=True)
        return self

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # -- forward -----------------------------------------------------------
    def _embed(self, tokens):
        return self.embed[tokens].to(self.config.dtype)

    def _qkv(self, x, lyr, rope):
        c = self.config
        B, S, _ = x.shape
        hd = c.head_dim
        h = _rms_norm(x, lyr.attn_norm.to(x.dtype), c.norm_eps)
        q = (h @ lyr.wq.to(x.dtype)).reshape(B, S, c.n_heads, hd)
        k = (h @ lyr.wk.to(x.dtype)).reshape(B, S, c.n_kv_heads, hd)
        v = (h @ lyr.wv.to(x.dtype)).reshape(B, S, c.n_kv_heads, hd)
        return _apply_rope(q, rope), _apply_rope(k, rope), v

    def _finish_layer(self, x, lyr, attn):
        c = self.config
        x = x + attn @ lyr.wo.to(x.dtype)
        h = _rms_norm(x, lyr.mlp_norm.to(x.dtype), c.norm_eps)
        gate = torch.nn.functional.silu(h @ lyr.w_gate.to(h.dtype))
        up = h @ lyr.w_up.to(h.dtype)
        return x + (gate * up) @ lyr.w_down.to(h.dtype)

    def _logits(self, x):
        c = self.config
        x = _rms_norm(x, self.final_norm.to(x.dtype), c.norm_eps)
        return (x @ self.lm_head.to(c.dtype)).float()

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """Logits (B, S, vocab) f32 for (B, S) integer tokens."""
        c = self.config
        B, S = tokens.shape
        x = self._embed(tokens)
        rope = _rope_tables(torch.arange(S, device=x.device), c.head_dim,
                            c.rope_theta)
        rep = c.n_heads // c.n_kv_heads
        mask = (None if c.attention == "flash" else torch.tril(
            torch.ones(S, S, dtype=torch.bool, device=x.device)))
        for lyr in self.layers:
            q, k, v = self._qkv(x, lyr, rope)
            if c.attention == "flash":
                # KV heads stay un-repeated: the kernel routes each q head
                qt, kt, vt = (t.transpose(1, 2).contiguous()
                              for t in (q, k, v))
                attn = flash_attention(qt, kt, vt, causal=True)
            else:
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                scores = torch.matmul(qt.float(), kt.float().transpose(
                    -1, -2)) * (c.head_dim ** -0.5)
                scores = torch.where(mask, scores,
                                     torch.finfo(torch.float32).min)
                probs = torch.softmax(scores, dim=-1).to(x.dtype)
                attn = torch.matmul(probs, vt)
            attn = attn.transpose(1, 2).reshape(B, S, c.n_heads * c.head_dim)
            x = self._finish_layer(x, lyr, attn)
        return self._logits(x)

    # -- inference: KV-cache decode ----------------------------------------
    def init_kv_cache(self, batch: int, max_len: int, dtype=None) -> dict:
        """Preallocated KV cache: k and v (L, B, max_len, Hkv, hd) and the
        fill position ``pos``, a host int (a step needs no device sync)."""
        c = self.config
        shape = (c.n_layers, batch, max_len, c.n_kv_heads, c.head_dim)
        dt = dtype or c.dtype
        return {"k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device),
                "pos": 0}

    @torch.no_grad()
    def forward_cached(self, tokens: torch.Tensor, cache: dict):
        """Logits (B, S_new, vocab) f32 for S_new tokens appended at
        ``cache["pos"]`` (prefill: the prompt; decode: one token), and
        the cache. Unlike the reference, which returns a new cache
        (``dynamic_update_slice``), this writes the new keys and values
        into ``cache`` IN PLACE and advances ``cache["pos"]``; the
        returned cache is the same dict. Raises when the tokens do not
        fit (the reference silently clamps the write position)."""
        c = self.config
        B, S = tokens.shape
        pos = int(cache["pos"])
        max_len = cache["k"].shape[2]
        if pos + S > max_len:
            raise ValueError(f"forward_cached: {S} tokens at position {pos} "
                             f"overrun the cache of {max_len}")
        x = self._embed(tokens)
        positions = pos + torch.arange(S, device=x.device)
        rope = _rope_tables(positions, c.head_dim, c.rope_theta)
        rep = c.n_heads // c.n_kv_heads
        for i, lyr in enumerate(self.layers):
            kc, vc = cache["k"][i], cache["v"][i]     # (B, max_len, Hkv, hd)
            q, k, v = self._qkv(x, lyr, rope)
            kc[:, pos:pos + S] = k.to(kc.dtype)
            vc[:, pos:pos + S] = v.to(vc.dtype)
            if c.attention == "flash":
                attn = flash_decode(q.transpose(1, 2).contiguous(), kc, vc,
                                    kv_len=pos + S)
                attn = attn.transpose(1, 2)
            else:
                # the q group of each kv head folds into the product: no
                # repeated copy of the cache
                qg = q.reshape(B, S, c.n_kv_heads, rep, c.head_dim)
                kt, vt = kc.to(x.dtype), vc.to(x.dtype)
                scores = torch.einsum("bskrd,btkd->bkrst", qg.float(),
                                      kt.float()) * (c.head_dim ** -0.5)
                kpos = torch.arange(max_len, device=x.device)
                mask = kpos[None, :] <= positions[:, None]   # (S, max_len)
                scores = torch.where(mask, scores,
                                     torch.finfo(torch.float32).min)
                probs = torch.softmax(scores, dim=-1).to(x.dtype)
                attn = torch.einsum("bkrst,btkd->bskrd", probs, vt)
            attn = attn.reshape(B, S, c.n_heads * c.head_dim)
            x = self._finish_layer(x, lyr, attn)
        cache["pos"] = pos + S
        return self._logits(x), cache

    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, max_new: int,
                 max_len: int | None = None, temperature: float = 0.0,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """Greedy (argmax, first index on ties) or temperature decode:
        prefill the prompt, then one cached step per new token. Returns
        (B, max_new) int64 tokens."""
        B, S = prompt.shape
        max_len = max_len or (S + max_new)
        # the last sampled token is never stepped: S + max_new - 1 slots
        if max_len < S + max_new - 1:
            raise ValueError(
                f"max_len={max_len} too small for prompt {S} + "
                f"{max_new - 1} cached decode steps")
        cache = self.init_kv_cache(B, max_len)
        logits, cache = self.forward_cached(prompt, cache)
        last = logits[:, -1]
        out = []
        for i in range(max_new):
            if temperature > 0:
                probs = torch.softmax(last / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                tok = torch.argmax(last, dim=-1)
            out.append(tok)
            if i + 1 < max_new:
                logits, cache = self.forward_cached(tok[:, None], cache)
                last = logits[:, -1]
        return torch.stack(out, dim=1)

    # -- training ----------------------------------------------------------
    def loss(self, tokens: torch.Tensor) -> torch.Tensor:
        """Next-token cross entropy of (B, S) tokens on the f32 logits:
        the mean over the B * (S - 1) predicted positions (the reference's
        ``loss``; MoE, and with it the aux term, is refused at
        construction)."""
        logits = self(tokens)[:, :-1]
        targets = tokens[:, 1:]
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))

    def make_train_step(self, optimizer: torch.optim.Optimizer):
        """Returns ``train_step(tokens) -> loss``: zero the gradients, take
        ``loss``, backpropagate, ``optimizer.step()``; the loss comes back
        as a detached 0-dim f32 tensor. ``optimizer`` is built over
        ``self.parameters()``, whose gradients this turns on.

        This is the stateful PyTorch idiom for the reference's pure
        ``train_step(params, opt_state, tokens) -> (params, opt_state,
        loss)``: the module holds the parameters and the optimizer its
        state, both updated in place. The reference's sharding arguments
        (``dp``, ``sp``, ``mesh``, ``tp``) are not ported."""
        self.requires_grad_(True)

        def train_step(tokens: torch.Tensor) -> torch.Tensor:
            optimizer.zero_grad(set_to_none=True)
            loss = self.loss(tokens)
            loss.backward()
            optimizer.step()
            return loss.detach()

        return train_step
