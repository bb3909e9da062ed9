"""Mixture-of-experts FFN: ``accl_tpu/models/moe.py`` over the port.

Top-k routing with a static capacity a group of tokens (tokens past an
expert's capacity are dropped, as in the reference), the Switch
load-balancing aux loss, and E SwiGLU experts with a leading experts
axis. The reference builds one-hot dispatch and combine tensors (T, E,
C) and contracts them with einsums; here the same routing is kept as
slot indices:

* dispatch gathers each expert slot's token (an empty slot reads a zero
  row), which equals the reference's ``einsum("tec,td->ecd")`` bit for
  bit (one term of weight 1 a slot);
* the experts run as one batched GEMM over (E, slots, d);
* combine ``index_add``s each slot's gated output back to its token: the
  same <= top_k f32 terms as the reference's ``einsum("tec,ecd->td")``,
  summed in another order (the same sum for top_k <= 2).

Routing runs per group: :meth:`MoELayer.apply_dense` routes one group
(T, d), :meth:`MoELayer.apply_groups` routes G groups (G, T, d) in one
pass (the Llama's per-sequence routing: each sequence's queues and
capacity are its own) and folds their slots into one (E, G*C, d)
product. The choice of experts is a stable descending sort, which
takes the lower expert index on a tie, as ``lax.top_k`` does. The
router's product runs in f32 and refuses a CUDA tensor while TF32 is
enabled for f32 matmuls (this module never changes that setting).

Expert parallelism: :meth:`MoELayer.apply_ep` runs W ranks' token rows
(W, T, d) over a :class:`~accl_tpu_torch.parallel.RankCollectives` of W
ranks, each holding E/W experts, with one ``alltoall`` each way of the
(W, E/W, C, d) slot rows; :func:`moe_apply_sharded` is the global-array
entry over a ``RankMesh``'s ``ep`` axis. No kernel of this module
reaches a Pallas call in the reference: the products are GEMMs and the
transfers the port's alltoall.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple

import torch
from torch import nn

from ..convert import MOE_KEYS
from ..parallel.collectives import RankCollectives
from ..parallel.mesh import resolve_device


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    dim: int = 64
    ffn_dim: int = 128
    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    dtype: torch.dtype = torch.float32
    param_dtype: torch.dtype = torch.float32

    def capacity(self, tokens: int) -> int:
        """Static per-group expert capacity for a token count."""
        return max(1, math.ceil(
            tokens * self.top_k * self.capacity_factor / self.n_experts))


class Routing(NamedTuple):
    """The routing of G groups of T tokens over E experts of capacity C.

    ``idx`` (G, T, k): the chosen experts, best first; ``keep`` (G, T, E):
    1 where a token holds a slot of an expert (chosen, within capacity);
    ``slot_token`` (E, G*C): the flat token (g*T + t) in each slot, G*T
    for an empty slot; ``slot_gate`` (E, G*C) f32: its renormalised gate,
    0 for an empty slot; ``aux`` (G,): each group's Switch aux loss."""

    idx: torch.Tensor
    keep: torch.Tensor
    slot_token: torch.Tensor
    slot_gate: torch.Tensor
    aux: torch.Tensor


def _top_k(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The k best experts of each row, best first; on a tie the lower
    index first (a stable descending sort, as ``lax.top_k`` orders)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :k]


def _check_f32_matmul(x: torch.Tensor):
    if x.is_cuda and (torch.backends.cuda.matmul.allow_tf32
                      or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the MoE router's product must run in true f32: TF32 is enabled "
            "for f32 matmuls (torch.backends.cuda.matmul.allow_tf32 / "
            "torch.set_float32_matmul_precision)")


def route(cfg: MoEConfig, router: torch.Tensor, x: torch.Tensor,
          capacity: int) -> Routing:
    """Route G groups of tokens x (G, T, d): the f32 router product,
    softmax, top-k, the gates renormalised over the chosen experts,
    first-come queue positions (a cumulative sum over each group's
    tokens), the capacity mask and the Switch aux loss (the reference's
    ``MoELayer._route``, per group)."""
    E, k, C = cfg.n_experts, cfg.top_k, capacity
    G, T, _ = x.shape
    _check_f32_matmul(x)
    logits = x.float() @ router.float()                        # (G, T, E)
    probs = torch.softmax(logits, dim=-1)
    idx = _top_k(probs.detach(), k)                            # (G, T, k)
    vals = probs.gather(-1, idx)
    mask = torch.zeros_like(probs).scatter_(-1, idx, 1.0)      # (G, T, E)
    gates = mask * probs / torch.clamp(vals.sum(-1, keepdim=True), min=1e-9)
    pos = torch.cumsum(mask, dim=1) - mask       # queue position (exact)
    keep = (pos < C) * mask
    # slot (e, g*C + pos) holds token g*T + t; dropped and unchosen pairs
    # write the dump slot E*G*C, which is cut off
    dev = x.device
    e_ar = torch.arange(E, device=dev)
    g_ar = torch.arange(G, device=dev)[:, None, None]
    slot = e_ar * (G * C) + g_ar * C + pos.long()
    slot = torch.where(keep.bool(), slot, E * G * C)
    tok = (g_ar * T + torch.arange(T, device=dev)[None, :, None]).expand(
        G, T, E)
    slot_token = torch.full((E * G * C + 1,), G * T, dtype=torch.long,
                            device=dev)
    slot_token.scatter_(0, slot.reshape(-1), tok.reshape(-1))
    slot_token = slot_token[:-1].view(E, G * C)
    flat_gates = torch.cat([gates.reshape(G * T, E),
                            gates.new_zeros(1, E)])
    slot_gate = flat_gates[slot_token, e_ar[:, None]]          # (E, G*C)
    frac_tokens = mask.mean(dim=1)
    frac_probs = probs.mean(dim=1)
    aux = E * torch.sum(frac_tokens * frac_probs, dim=-1) / k
    return Routing(idx, keep, slot_token, slot_gate, aux)


def dispatch(r: Routing, x: torch.Tensor) -> torch.Tensor:
    """Token rows x (..., N, d) (N = G*T flat tokens, any leading rank
    axes) -> (..., E, G*C, d): each slot's token, zeros in an empty
    slot; x's dtype."""
    pad = torch.cat([x, x.new_zeros(*x.shape[:-2], 1, x.shape[-1])], dim=-2)
    return pad[..., r.slot_token, :]


def combine(r: Routing, y: torch.Tensor, n_tokens: int) -> torch.Tensor:
    """Expert outputs y (..., E, G*C, d) -> (..., n_tokens, d) f32: each
    slot's output times its gate, added into its token's row."""
    lead = y.shape[:-3]
    d = y.shape[-1]
    w = (y.float() * r.slot_gate[..., None]).reshape(*lead, -1, d)
    out = w.new_zeros(*lead, n_tokens + 1, d)
    out = out.index_add(len(lead), r.slot_token.reshape(-1), w)
    return out[..., :n_tokens, :]


def expert_ffn(cfg: MoEConfig, params: Mapping[str, torch.Tensor],
               t: torch.Tensor) -> torch.Tensor:
    """SwiGLU per expert in ``cfg.dtype``: t (..., E, N, d) -> (..., E, N,
    d), the weights (..., E, d, f) and (..., E, f, d) with the same
    leading axes (rank shards) or none."""
    dt = cfg.dtype
    t = t.to(dt)
    gate = torch.nn.functional.silu(t @ params["w_gate"].to(dt))
    up = t @ params["w_up"].to(dt)
    return (gate * up) @ params["w_down"].to(dt)


def _param(*shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class MoELayer(nn.Module):
    """Router and E SwiGLU experts: ``router`` (d, E), ``w_gate`` and
    ``w_up`` (E, d, f), ``w_down`` (E, f, d) in ``param_dtype`` on
    ``device`` (``"cuda"`` by default, which raises without CUDA).
    Parameters are created without gradients; ``requires_grad_(True)``
    turns them on. Every method takes ``params``, a mapping of the four
    names to tensors (rank shards, another layer's slices), and defaults
    to this module's own."""

    def __init__(self, config: MoEConfig, device="cuda"):
        super().__init__()
        self.config = c = config
        dev = resolve_device(device)
        E, d, f, pd = c.n_experts, c.dim, c.ffn_dim, c.param_dtype
        self.router = _param(d, E, dtype=pd, device=dev)
        self.w_gate = _param(E, d, f, dtype=pd, device=dev)
        self.w_up = _param(E, d, f, dtype=pd, device=dev)
        self.w_down = _param(E, f, d, dtype=pd, device=dev)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MoELayer":
        """The reference's distribution: every weight normal x fan_in^-0.5
        (d for the router, gate and up; f for down), drawn on the
        generator's device."""
        c = self.config
        for name, fan_in in (("router", c.dim), ("w_gate", c.dim),
                             ("w_up", c.dim), ("w_down", c.ffn_dim)):
            p = getattr(self, name)
            x = torch.randn(p.shape, generator=generator,
                            dtype=c.param_dtype, device=generator.device)
            p.copy_(x * (fan_in ** -0.5))
        return self

    def weights(self) -> dict:
        return {name: getattr(self, name) for name in MOE_KEYS}

    def apply_groups(self, x: torch.Tensor, capacity: int | None = None,
                     params: Mapping[str, torch.Tensor] | None = None):
        """G groups of tokens x (G, T, d), each routed on its own (queues
        and capacity per group: ``capacity(T)`` unless given), every
        group's slots in one (E, G*C, d) expert product. Returns (out (G,
        T, d) in x's dtype, aux (G,) f32)."""
        p = self.weights() if params is None else params
        G, T, d = x.shape
        C = capacity or self.config.capacity(T)
        r = route(self.config, p["router"], x, C)
        y = expert_ffn(self.config, p, dispatch(r, x.reshape(G * T, d)))
        out = combine(r, y, G * T).view(G, T, d)
        return out.to(x.dtype), r.aux

    def apply_dense(self, x: torch.Tensor, capacity: int | None = None,
                    params: Mapping[str, torch.Tensor] | None = None):
        """All experts local; x (T, d). Returns (out (T, d), aux)."""
        out, aux = self.apply_groups(x[None], capacity, params)
        return out[0], aux[0]

    def apply_ep(self, x: torch.Tensor, coll: RankCollectives,
                 capacity: int | None = None,
                 params: Mapping[str, torch.Tensor] | None = None):
        """Expert parallelism over the W ranks of ``coll``: x (W, T, d), row
        r rank r's tokens; rank r holds experts r*E/W .. (the leading axis
        of the expert weights split W ways; the router replicated). Each
        rank routes its own tokens (capacity ``capacity(T)`` unless
        given), one alltoall sends each rank's (E/W, C, d) slot rows to
        the rank that holds those experts, the experts run there on W*C
        slots each, and one alltoall brings the outputs home. Returns
        (out (W, T, d) in x's dtype, aux (W,) each rank's). Differentiable:
        the alltoall's backward is the same alltoall."""
        c = self.config
        p = self.weights() if params is None else params
        W, T, d = x.shape
        if W != coll.W:
            raise ValueError(f"apply_ep: {W} token rows for {coll.W} ranks")
        if c.n_experts % W:
            raise ValueError(f"{c.n_experts} experts not divisible by "
                             f"ep={W}")
        E_loc = c.n_experts // W
        C = capacity or c.capacity(T)
        r = route(c, p["router"], x, C)
        # (E, W*C, d) -> rank rows (W, W, E_loc, C, d): [src][dst] blocks
        slots = dispatch(r, x.reshape(W * T, d)).view(W, E_loc, W, C, d)
        rows = slots.permute(2, 0, 1, 3, 4)
        got = _alltoall(rows, coll)                # [dst][src] blocks
        local = {k: p[k].view(W, E_loc, *p[k].shape[1:])
                 for k in ("w_gate", "w_up", "w_down")}
        t = got.permute(0, 2, 1, 3, 4).reshape(W, E_loc, W * C, d)
        y = expert_ffn(c, local, t).view(W, E_loc, W, C, d)
        back = _alltoall(y.permute(0, 2, 1, 3, 4), coll)    # [src][dst]
        y = back.permute(1, 2, 0, 3, 4).reshape(c.n_experts, W * C, d)
        out = combine(r, y, W * T).view(W, T, d)
        return out.to(x.dtype), r.aux


def _swap_blocks(x: torch.Tensor, coll: RankCollectives) -> torch.Tensor:
    W = coll.W
    got = coll.alltoall(x.reshape(W, -1))
    return got.view(x.shape)


class _AllToAll(torch.autograd.Function):
    """(W, W, ...) blocks, [a][b] -> [b][a] through ``coll.alltoall``; an
    involution, so its backward is itself."""

    @staticmethod
    def forward(ctx, x, coll):
        ctx.coll = coll
        return _swap_blocks(x, coll)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        return _swap_blocks(g, ctx.coll), None


def _alltoall(x: torch.Tensor, coll: RankCollectives) -> torch.Tensor:
    return _AllToAll.apply(x.contiguous(), coll)


def moe_apply_sharded(layer: MoELayer, x: torch.Tensor, mesh,
                      axis_name: str = "ep", capacity: int | None = None,
                      params: Mapping[str, torch.Tensor] | None = None):
    """Global-array entry: x (T, d) split over the W ranks of the mesh's
    ``axis_name`` axis (rank r: tokens r*T/W ..), the experts split on
    their leading axis. Returns (out (T, d), aux averaged over the
    ranks), as the reference's program returns its pmean."""
    W = mesh.shape[axis_name]
    T, d = x.shape
    if T % W:
        raise ValueError(f"{T} tokens not divisible by {axis_name}={W}")
    if x.device != mesh.device:
        raise ValueError(f"tokens on {x.device}, mesh on {mesh.device}")
    C = capacity or layer.config.capacity(T // W)
    coll = RankCollectives(mesh.group(axis_name))
    out, aux = layer.apply_ep(x.view(W, T // W, d), coll, C, params)
    return out.reshape(T, d), aux.mean()
