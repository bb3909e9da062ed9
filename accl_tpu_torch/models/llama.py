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
on. The reference's parallel arguments are ported over a
:class:`~accl_tpu_torch.parallel.RankMesh` of virtual ranks: with a mesh
and an sp axis, ``forward``, ``loss`` and ``make_train_step`` run ring
attention over the sequence shards
(:mod:`accl_tpu_torch.parallel.ring_attention`); with a mesh and no sp,
they and ``forward_cached``/``generate`` run the reference's
Megatron-style tensor parallelism over the tp axis
(:mod:`accl_tpu_torch.parallel.tensor_parallel`: ``param_specs``,
``shard_params``, one attention launch a layer over every rank's head
shard, decode over per-rank KV-head shards of the cache).

Mixture of experts (``n_experts > 0``, the Mixtral form): every layer's
SwiGLU becomes a routed :class:`~accl_tpu_torch.models.moe.MoELayer`
(state-dict names ``layers.<i>.moe.<router|w_gate|w_up|w_down>``),
routed per sequence as the reference's vmap over the batch does, the B
sequences' slots folded into one (E, B*C, d) expert product. ``loss``
adds ``moe_aux_coef`` times the sum over layers of each layer's
batch-mean Switch aux; serving drops the aux. Under tensor parallelism
the router is replicated, gate and up are split on f and down on its
f rows, and the experts' partial sums take the dense FFN's one
all-reduce. Under sequence parallelism the row-wise layers see the whole
(B, S, D) activation, so each sequence still routes as one group.
"""

from __future__ import annotations

import dataclasses
import types

import torch
from torch import nn

from ..convert import (LLAMA_TOP_KEYS, MOE_KEYS, llama_layer_keys,
                       llama_params_from_reference, port_layer_name)
from ..ops.attention import flash_attention, flash_decode
from ..parallel.collectives import RankCollectives
from ..parallel.mesh import resolve_device
from ..parallel.ring_attention import ring_attention
from ..parallel.tensor_parallel import (rank_matmul, shard_view,
                                        tp_allreduce, vocab_parallel_embed,
                                        vocab_parallel_logits)
from . import moe as M
from .moe import _param


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
    # Mixture-of-experts FFN (Mixtral-style): n_experts > 0 replaces every
    # layer's SwiGLU with a top-k routed expert block (models.moe), the
    # Switch aux loss added in loss() with moe_aux_coef. 0 = dense FFN.
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


def _mm(x, w):
    """``x @ w``; with rank shards w (T, K, N), one GEMM a rank over the
    rank rows of x (T, ..., K)."""
    return x @ w if w.dim() == 2 else rank_matmul(x, w)


def _heads_major(*ts):
    """(..., S, heads, hd) -> (batch, heads, S, hd) contiguous, a rank
    axis folded into the batch: the attention kernels' layout."""
    return tuple(t.reshape(-1, *t.shape[-3:]).transpose(1, 2).contiguous()
                 for t in ts)


# the reference's Megatron layout (its ``param_specs``): the dimension of
# each parameter that the tp axis splits, None where it is replicated
_TP_DIM = {"embed": 0, "final_norm": None, "lm_head": 1, "attn_norm": None,
           "wq": 1, "wk": 1, "wv": 1, "wo": 0, "mlp_norm": None,
           "w_gate": 1, "w_up": 1, "w_down": 0}
# an expert tensor (E, d, f) or (E, f, d) splits on f: the last dimension
# of gate and up, dimension -2 of down; the router is replicated
_TP_DIM_MOE = {"router": None, "w_gate": 2, "w_up": 2, "w_down": 1}
_ATTN_NAMES = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm")
_FFN_NAMES = ("w_gate", "w_up", "w_down")


def _tp_dim(name: str):
    """The split dimension of the parameter ``name`` (a state-dict key)."""
    parts = name.rsplit(".", 2)
    if len(parts) == 3 and parts[1] == "moe":
        return _TP_DIM_MOE[parts[2]]
    return _TP_DIM[parts[-1]]


def moe_config(c: "LlamaConfig") -> M.MoEConfig:
    """The expert block of a Llama config (the reference's
    ``Llama._moe_layer``)."""
    return M.MoEConfig(dim=c.dim, ffn_dim=c.ffn_dim, n_experts=c.n_experts,
                       top_k=c.moe_top_k,
                       capacity_factor=c.moe_capacity_factor,
                       dtype=c.dtype, param_dtype=c.param_dtype)


class _Layer(nn.Module):
    """One decoder layer's weights (the reference's per-layer slices):
    the SwiGLU's three matrices, or with experts an ``moe`` block."""

    def __init__(self, c: LlamaConfig, device):
        super().__init__()
        hd, pd = c.head_dim, c.param_dtype
        self.attn_norm = _param(c.dim, dtype=pd, device=device)
        self.wq = _param(c.dim, c.n_heads * hd, dtype=pd, device=device)
        self.wk = _param(c.dim, c.n_kv_heads * hd, dtype=pd, device=device)
        self.wv = _param(c.dim, c.n_kv_heads * hd, dtype=pd, device=device)
        self.wo = _param(c.n_heads * hd, c.dim, dtype=pd, device=device)
        self.mlp_norm = _param(c.dim, dtype=pd, device=device)
        if c.n_experts:
            self.moe = M.MoELayer(moe_config(c), device)
            return
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
            for name in ("wq", "wk", "wv") + (() if c.n_experts
                                              else ("w_gate", "w_up")):
                dense(getattr(lyr, name), c.dim)
            dense(lyr.wo, c.n_heads * c.head_dim)
            if c.n_experts:
                lyr.moe.init(generator)
            else:
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

    # -- sharding ----------------------------------------------------------
    def param_specs(self, dp: str = "dp", tp: str = "tp") -> dict:
        """The reference's partition specs (its ``param_specs``: Megatron
        tensor parallelism, qkv, gate and up column-parallel, wo and down
        row-parallel, the embedding and the lm_head split by vocabulary),
        keyed by this module's ``state_dict`` names: one entry a
        dimension, the tp axis name where that dimension is split, else
        None. A layer's entry drops the reference's leading layer axis.
        ``dp`` names no parameter dimension, as in the reference."""
        return {name: tuple(tp if d == _tp_dim(name) else None
                            for d in range(p.dim()))
                for name, p in self.named_parameters()}

    def shard_params(self, mesh, dp: str = "dp", tp: str = "tp") -> dict:
        """Per-rank shards for a mesh with a ``tp`` axis of T ranks, keyed
        by ``state_dict`` names: each parameter whose spec names ``tp``
        as T shards along that dimension, a rank-major view (T, ...) of
        the parameter itself (:func:`~accl_tpu_torch.parallel.
        tensor_parallel.shard_view`: row r is rank r's shard, the
        reference's addressable shard on every device of tp index r);
        each other parameter as itself, which every rank reads. No
        weight is copied, and gradients through a shard land on the
        parameter."""
        if tp not in mesh.shape:
            raise ValueError(f"tp axis {tp!r} not in mesh "
                             f"{tuple(mesh.shape)}")
        if mesh.device != self.device:
            raise ValueError(f"mesh on {mesh.device}, model on "
                             f"{self.device}")
        T = mesh.shape[tp]
        return {name: p if _tp_dim(name) is None
                else shard_view(p, _tp_dim(name), T)
                for name, p in self.named_parameters()}

    def _rank_weights(self, mesh, tp: str):
        """(embedding shards, one namespace of weights a layer, lm_head
        shards) for the tp path: the matrices as rank shards, the norms
        and the router as they are; an expert block's four weights as
        the mapping ``moe_w``."""
        w = self.shard_params(mesh, tp=tp)
        layers = []
        for i in range(len(self.layers)):
            ns = types.SimpleNamespace(**{
                name: w[f"layers.{i}.{name}"] for name in _ATTN_NAMES})
            if self.config.n_experts:
                ns.moe_w = {name: w[f"layers.{i}.moe.{name}"]
                            for name in MOE_KEYS}
            else:
                for name in _FFN_NAMES:
                    setattr(ns, name, w[f"layers.{i}.{name}"])
            layers.append(ns)
        return w["embed"], layers, w["lm_head"]

    # -- forward -----------------------------------------------------------
    def _embed(self, tokens, coll=None, shards=None):
        if coll is not None:
            return vocab_parallel_embed(tokens, shards, coll,
                                        self.config.dtype)
        return self.embed[tokens].to(self.config.dtype)

    def _qkv(self, x, lyr, rope):
        """q, k, v (..., S, heads, hd) from x (..., S, D); with rank rows
        x (T, B, S, D) and shards, each rank's own heads."""
        c = self.config
        h = _rms_norm(x, lyr.attn_norm.to(x.dtype), c.norm_eps)
        q, k, v = (_mm(h, w.to(x.dtype)).unflatten(-1, (-1, c.head_dim))
                   for w in (lyr.wq, lyr.wk, lyr.wv))
        return _apply_rope(q, rope), _apply_rope(k, rope), v

    def _finish_layer(self, x, lyr, attn, coll=None, auxes=None):
        """The output projection and the FFN, with their residuals; with
        rank rows, wo and down leave partial sums that ``coll`` sums. An
        expert block's batch-mean aux is appended to ``auxes`` when it is
        given."""
        c = self.config

        def reduce(t):
            return t if coll is None else tp_allreduce(t, coll)

        x = x + reduce(_mm(attn, lyr.wo.to(x.dtype)))
        h = _rms_norm(x, lyr.mlp_norm.to(x.dtype), c.norm_eps)
        if c.n_experts:
            out, aux = self._moe_ffn(h, lyr, coll is not None)
            if auxes is not None:
                auxes.append(aux)
            return x + reduce(out)
        gate = torch.nn.functional.silu(_mm(h, lyr.w_gate.to(h.dtype)))
        up = _mm(h, lyr.w_up.to(h.dtype))
        return x + reduce(_mm(gate * up, lyr.w_down.to(h.dtype)))

    def _moe_ffn(self, h, lyr, ranked: bool):
        """The routed expert block on normed activations h (B, S, D), or
        tp rank rows (T, B, S, D) with ``ranked``: routed per sequence
        (the reference vmaps ``apply_dense`` over the batch), the B
        sequences' slots in one expert product. Rank rows are replicas
        of one activation: the routing of row 0 serves every rank, which
        gathers its own row's slots and runs its shards of the experts;
        the gated partial sums go back for the caller's all-reduce.
        Returns (out in h's dtype, the batch-mean aux)."""
        cfg = moe_config(self.config)
        params = lyr.moe_w if ranked else lyr.moe.weights()
        B, S, D = h.shape[-3:]
        r = M.route(cfg, params["router"], h[0] if ranked else h,
                    cfg.capacity(S))
        lead = h.shape[:-3]
        y = M.expert_ffn(cfg, params, M.dispatch(r, h.reshape(
            *lead, B * S, D)))
        out = M.combine(r, y, B * S).view(h.shape)
        return out.to(h.dtype), r.aux.mean()

    def _logits(self, x, shards=None):
        c = self.config
        x = _rms_norm(x, self.final_norm.to(x.dtype), c.norm_eps)
        if shards is not None:
            return vocab_parallel_logits(x, shards.to(c.dtype))
        return (x @ self.lm_head.to(c.dtype)).float()

    def _attention_path(self, B: int, S: int, dp, sp, mesh, tp):
        """The reference's choice of attention path (its ``forward``,
        llama.py:326-383), as (path, collectives): "flash" (the kernels,
        unsharded), "dense" (the plain path: the reference's sharding
        constraints place data and change no arithmetic), "ring" (ring
        attention over the sp axis's collectives) or "tp" (tensor
        parallelism over the tp axis's)."""
        c = self.config
        if c.attention != "flash" or mesh is None:
            unsharded = (c.attention == "flash" and dp is None
                         and sp is None and mesh is None)
            return ("flash" if unsharded else "dense"), None
        if sp is None:
            if tp not in mesh.shape:
                raise ValueError(
                    f"mesh given but tp axis {tp!r} is not in mesh "
                    f"{tuple(mesh.shape)}: name the model axis via tp=, "
                    "or omit mesh= for the unsharded fused kernel")
            T = mesh.shape[tp]
            if c.n_heads % T or c.n_kv_heads % T:
                raise ValueError(
                    f"tp axis size {T} must divide the head counts "
                    f"(n_heads={c.n_heads}, n_kv_heads={c.n_kv_heads})")
        else:
            if sp not in mesh.shape:
                raise ValueError(f"sp axis {sp!r} not in mesh "
                                 f"{tuple(mesh.shape)}")
            if S % mesh.shape[sp]:
                raise ValueError(
                    f"sequence length {S} not divisible by sp axis size "
                    f"{mesh.shape[sp]} — ring attention needs equal "
                    "sequence shards")
        self._check_mesh(B, dp, mesh)
        return (("tp", RankCollectives(mesh.group(tp))) if sp is None
                else ("ring", RankCollectives(mesh.group(sp))))

    def _check_mesh(self, B: int, dp, mesh):
        """The dp axis and the device: the checks the sp, tp and decode
        paths share."""
        if dp is not None and dp not in mesh.shape:
            raise ValueError(f"dp axis {dp!r} not in mesh "
                             f"{tuple(mesh.shape)}")
        if dp is not None and B % mesh.shape[dp]:
            raise ValueError(
                f"batch {B} not divisible by dp axis size "
                f"{mesh.shape[dp]}")
        if mesh.device != self.device:
            raise ValueError(f"mesh on {mesh.device}, model on "
                             f"{self.device}")

    def forward(self, tokens: torch.Tensor, dp: str | None = None,
                sp: str | None = None, mesh=None,
                tp: str = "tp") -> torch.Tensor:
        """Logits (B, S, vocab) f32 for (B, S) integer tokens.

        With ``mesh`` (a :class:`~accl_tpu_torch.parallel.RankMesh`) and
        ``sp`` naming one of its axes, attention is ring attention over
        the sp axis's W ranks: rank r holds tokens r*S/W .. of every
        sequence, its q/k/v shards one contiguous copy a layer, and K/V
        travel the ring un-repeated. The row-wise layers (norms, RoPE at
        the global positions, GEMMs, FFN) run once over the whole
        activation, every rank's slice in one launch.

        With ``mesh`` and no ``sp``, the model is tensor-parallel over
        the ``tp`` axis's T ranks (T must divide both head counts): the
        activation is T rank rows (T, B, S, D), the embedding and the
        lm_head are split by vocabulary, q/k/v, gate and up are
        column-parallel (rank r: q heads r*H/T .., KV heads r*Hkv/T ..),
        wo and down row-parallel with their partial sums all-reduced (2
        a layer, 1 for the embedding), and attention is one launch a
        layer over every rank's heads, the rank folded into the batch.

        The dp groups ride the batch axis (B must divide by the dp axis
        size). ``sp`` or ``dp`` without a mesh, or
        ``attention="dense"``, take the dense path unsharded, as the
        reference's do. With experts and ``sp``, the expert blocks route
        each whole sequence as one group, as the reference's do."""
        return self._forward_with_aux(tokens, dp, sp, mesh, tp)[0]

    def _forward_with_aux(self, tokens: torch.Tensor, dp: str | None = None,
                          sp: str | None = None, mesh=None, tp: str = "tp"):
        """(logits, aux): :meth:`forward`'s logits and the sum over layers
        of each expert block's batch-mean aux loss (a zero f32 scalar
        without experts), the reference's ``_forward_with_aux``."""
        c = self.config
        B, S = tokens.shape
        path, coll = self._attention_path(B, S, dp, sp, mesh, tp)
        tp_coll = coll if path == "tp" else None
        emb = head = None
        layers = self.layers
        if tp_coll is not None:
            emb, layers, head = self._rank_weights(mesh, tp)
        x = self._embed(tokens, tp_coll, emb)
        rope = _rope_tables(torch.arange(S, device=x.device), c.head_dim,
                            c.rope_theta)
        rep = c.n_heads // c.n_kv_heads
        mask = (None if path != "dense" else torch.tril(
            torch.ones(S, S, dtype=torch.bool, device=x.device)))
        auxes = []
        for lyr in layers:
            q, k, v = self._qkv(x, lyr, rope)
            if path == "ring":
                # rank rows (W, B, h, S/W, hd): rank r's sequence slice
                W = coll.W
                qr, kr, vr = (t.reshape(B, W, S // W, t.shape[2], c.head_dim)
                              .permute(1, 0, 3, 2, 4).contiguous()
                              for t in (q, k, v))
                attn = ring_attention(qr, kr, vr, coll, causal=True)
                attn = attn.permute(1, 0, 3, 2, 4)       # (B, W, S/W, H, hd)
            elif path != "dense":
                # KV heads stay un-repeated: the kernel routes each q
                # head; tp rank rows fold into the batch
                attn = flash_attention(*_heads_major(q, k, v), causal=True)
                attn = attn.transpose(1, 2)
            else:
                k = k.repeat_interleave(rep, dim=2)
                v = v.repeat_interleave(rep, dim=2)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                scores = torch.matmul(qt.float(), kt.float().transpose(
                    -1, -2)) * (c.head_dim ** -0.5)
                scores = torch.where(mask, scores,
                                     torch.finfo(torch.float32).min)
                probs = torch.softmax(scores, dim=-1).to(x.dtype)
                attn = torch.matmul(probs, vt).transpose(1, 2)
            attn = attn.reshape(*x.shape[:-1], -1)
            x = self._finish_layer(x, lyr, attn, tp_coll, auxes)
        aux = (torch.stack(auxes).sum() if auxes else
               torch.zeros((), dtype=torch.float32, device=x.device))
        return self._logits(x, head), aux

    # -- inference: KV-cache decode ----------------------------------------
    def _decode_path(self, B: int, mesh, dp, tp) -> RankCollectives:
        """The reference's checks of sharded decode (its
        ``forward_cached``, llama.py:494-517), then the tp axis's
        collectives."""
        c = self.config
        if c.attention != "flash":
            raise ValueError("mesh-sharded decode requires "
                             "attention='flash'")
        if tp not in mesh.shape:
            raise ValueError(f"tp axis {tp!r} not in mesh "
                             f"{tuple(mesh.shape)}")
        T = mesh.shape[tp]
        if c.n_heads % T or c.n_kv_heads % T:
            raise ValueError(
                f"tp axis size {T} must divide the "
                f"head counts ({c.n_heads} q / {c.n_kv_heads} kv) "
                "for sharded decode")
        self._check_mesh(B, dp, mesh)
        return RankCollectives(mesh.group(tp))

    def init_kv_cache(self, batch: int, max_len: int, dtype=None,
                      mesh=None, tp: str = "tp") -> dict:
        """Preallocated KV cache: k and v (L, B, max_len, Hkv, hd) and the
        fill position ``pos``, a host int (a step needs no device sync).
        With ``mesh``, the cache of tensor-parallel decode over its
        ``tp`` axis of T ranks: k and v (L, T, B, max_len, Hkv/T, hd),
        rank r's KV heads r*Hkv/T .. one contiguous shard, which the
        decode kernel reads where it lies (it is never gathered)."""
        c = self.config
        shape = (c.n_layers, batch, max_len, c.n_kv_heads, c.head_dim)
        if mesh is not None:
            T = self._decode_path(batch, mesh, None, tp).W
            shape = (c.n_layers, T, batch, max_len, c.n_kv_heads // T,
                     c.head_dim)
        dt = dtype or c.dtype
        return {"k": torch.zeros(shape, dtype=dt, device=self.device),
                "v": torch.zeros(shape, dtype=dt, device=self.device),
                "pos": 0}

    @torch.no_grad()
    def forward_cached(self, tokens: torch.Tensor, cache: dict, mesh=None,
                       dp: str | None = None, tp: str = "tp"):
        """Logits (B, S_new, vocab) f32 for S_new tokens appended at
        ``cache["pos"]`` (prefill: the prompt; decode: one token), and
        the cache. Unlike the reference, which returns a new cache
        (``dynamic_update_slice``), this writes the new keys and values
        into ``cache`` IN PLACE and advances ``cache["pos"]``; the
        returned cache is the same dict. Raises when the tokens do not
        fit (the reference silently clamps the write position). Expert
        blocks route the S_new tokens of each sequence as one group
        (capacity ``capacity(S_new)``: a decode step's one token never
        drops), as the reference does, and drop the aux.

        With ``mesh``, decode is tensor-parallel over its ``tp`` axis (as
        :meth:`forward`), on a cache from ``init_kv_cache(..., mesh=)``:
        each layer's B12 runs once over every rank's KV-head shard, the
        rank folded into the batch. A cache whose layout does not match
        the mesh (or a sharded cache without one) raises ValueError."""
        c = self.config
        B, S = tokens.shape
        coll = None if mesh is None else self._decode_path(B, mesh, dp, tp)
        kshape = tuple(cache["k"].shape)
        if coll is None and len(kshape) != 5:
            raise ValueError(f"forward_cached: a cache of k {kshape} is "
                             f"sharded over tp ranks: pass the mesh it was "
                             f"built for")
        if coll is not None and (len(kshape) != 6 or kshape[1] != coll.W
                                 or kshape[4] != c.n_kv_heads // coll.W):
            raise ValueError(f"forward_cached: a cache of k {kshape} is not "
                             f"laid out for the mesh's {coll.W} tp ranks: "
                             f"build it with init_kv_cache(..., mesh=mesh, "
                             f"tp={tp!r})")
        pos = int(cache["pos"])
        max_len = kshape[-3]
        if pos + S > max_len:
            raise ValueError(f"forward_cached: {S} tokens at position {pos} "
                             f"overrun the cache of {max_len}")
        emb = head = None
        layers = self.layers
        if coll is not None:
            emb, layers, head = self._rank_weights(mesh, tp)
        x = self._embed(tokens, coll, emb)
        positions = pos + torch.arange(S, device=x.device)
        rope = _rope_tables(positions, c.head_dim, c.rope_theta)
        rep = c.n_heads // c.n_kv_heads
        for i, lyr in enumerate(layers):
            # (B, max_len, Hkv, hd), or (T, B, max_len, Hkv/T, hd)
            kc, vc = cache["k"][i], cache["v"][i]
            q, k, v = self._qkv(x, lyr, rope)
            kc[..., pos:pos + S, :, :] = k.to(kc.dtype)
            vc[..., pos:pos + S, :, :] = v.to(vc.dtype)
            if c.attention == "flash":
                # tp rank rows fold into the batch: one launch a layer
                attn = flash_decode(*_heads_major(q), *(
                    t.reshape(-1, *t.shape[-3:]) for t in (kc, vc)),
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
            attn = attn.reshape(*x.shape[:-1], -1)
            x = self._finish_layer(x, lyr, attn, coll)
        cache["pos"] = pos + S
        return self._logits(x, head), cache

    @torch.no_grad()
    def generate(self, prompt: torch.Tensor, max_new: int,
                 max_len: int | None = None, temperature: float = 0.0,
                 generator: torch.Generator | None = None, mesh=None,
                 dp: str | None = None, tp: str = "tp") -> torch.Tensor:
        """Greedy (argmax, first index on ties) or temperature decode:
        prefill the prompt, then one cached step per new token. Returns
        (B, max_new) int64 tokens. With ``mesh``: tensor-parallel decode
        over its ``tp`` axis on a sharded cache (:meth:`forward_cached`)."""
        B, S = prompt.shape
        max_len = max_len or (S + max_new)
        # the last sampled token is never stepped: S + max_new - 1 slots
        if max_len < S + max_new - 1:
            raise ValueError(
                f"max_len={max_len} too small for prompt {S} + "
                f"{max_new - 1} cached decode steps")
        cache = self.init_kv_cache(B, max_len, mesh=mesh, tp=tp)
        logits, cache = self.forward_cached(prompt, cache, mesh, dp, tp)
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
                logits, cache = self.forward_cached(tok[:, None], cache,
                                                    mesh, dp, tp)
                last = logits[:, -1]
        return torch.stack(out, dim=1)

    # -- training ----------------------------------------------------------
    def loss(self, tokens: torch.Tensor, dp: str | None = None,
             sp: str | None = None, mesh=None,
             tp: str = "tp") -> torch.Tensor:
        """Next-token cross entropy of (B, S) tokens on the f32 logits:
        the mean over the B * (S - 1) predicted positions, plus, with
        experts, ``moe_aux_coef`` times the sum over layers of each
        layer's batch-mean Switch aux (the reference's ``loss``).
        ``dp``, ``sp``, ``mesh``, ``tp`` as :meth:`forward`."""
        logits, aux = self._forward_with_aux(tokens, dp, sp, mesh, tp)
        logits = logits[:, :-1]
        targets = tokens[:, 1:]
        nll = torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
        if self.config.n_experts:
            nll = nll + self.config.moe_aux_coef * aux
        return nll

    def make_train_step(self, optimizer: torch.optim.Optimizer,
                        dp: str | None = None, sp: str | None = None,
                        mesh=None, tp: str = "tp"):
        """Returns ``train_step(tokens) -> loss``: zero the gradients, take
        ``loss`` (with ``dp``, ``sp``, ``mesh``, ``tp`` as
        :meth:`forward`: ring attention over the sp shards when a mesh
        and sp are given, tensor parallelism over the tp axis when a mesh
        and no sp are), backpropagate, ``optimizer.step()``; the loss
        comes back as a detached 0-dim f32 tensor. ``optimizer`` is built
        over ``self.parameters()``, whose gradients this turns on (the tp
        shards are views of them, so their gradients land there).

        This is the stateful PyTorch idiom for the reference's pure
        ``train_step(params, opt_state, tokens) -> (params, opt_state,
        loss)``: the module holds the parameters and the optimizer its
        state, both updated in place. With experts the loss carries the
        aux term, whose gradient reaches the router."""
        self.requires_grad_(True)

        def train_step(tokens: torch.Tensor) -> torch.Tensor:
            optimizer.zero_grad(set_to_none=True)
            loss = self.loss(tokens, dp, sp, mesh, tp)
            loss.backward()
            optimizer.step()
            return loss.detach()

        return train_step

    def grad_buckets(self, bucket_bytes: int = 25 << 20) -> list[list[str]]:
        """The reference's ``grad_buckets`` under the name mapping of
        :mod:`~accl_tpu_torch.convert`: its parameter leaves (each layer
        weight one leaf stacked over the layers) walked in reverse key
        order and grouped into buckets of at least ``bucket_bytes`` (4
        bytes an element, as there). A stacked leaf lists this module's
        per-layer names in layer order, so a bucket fused in the order
        listed is the reference's fused buffer
        (:func:`~accl_tpu_torch.parallel.bucketing.plan_from_buckets`)."""
        L = self.config.n_layers
        moe = bool(self.config.n_experts)
        shapes = dict(self.named_parameters())
        leaves = []                      # the reference's leaf order
        for key in sorted(LLAMA_TOP_KEYS + ("layers",)):
            if key == "layers":
                leaves += [[f"layers.{i}.{port_layer_name(name, moe)}"
                            for i in range(L)]
                           for name in sorted(llama_layer_keys(moe))]
            else:
                leaves.append([key])
        buckets, cur, cur_bytes = [], [], 0
        for names in reversed(leaves):
            cur += names
            cur_bytes += sum(shapes[n].numel() for n in names) * 4
            if cur_bytes >= bucket_bytes:
                buckets.append(cur)
                cur, cur_bytes = [], 0
        if cur:
            buckets.append(cur)
        return buckets
