"""Single-device forward check and the dry run of every parallelism axis.

The counterpart of the reference's ``__graft_entry__.py`` (``entry`` and
``dryrun_multichip``), run over ``n_ranks`` virtual ranks on one device.
It runs in-process: the port has no platform to pin before import, so no
child process is needed.

:func:`dryrun_multichip` runs one step of each axis at the reference's
tiny shapes, each held to the same unsharded golden and threshold as
there: a wrong-but-finite collective (a permuted pipeline schedule, a
mis-rotated ring hop, a dropped bucket) fails it, not just a test.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from .models import Llama, LlamaConfig
from .models.moe import MoEConfig, MoELayer, moe_apply_sharded
from .parallel import (RankCollectives, bucketed_allreduce,
                       make_bucket_plan, make_mesh, pipeline_sharded,
                       ring_attention_sharded)
from .parallel.mesh import resolve_device

__all__ = ["entry", "dryrun_multichip", "DryrunFailure"]

CHECKS = ("dp x tp", "sp", "tp decode", "pp", "ep", "sp ring", "ddp")


class DryrunFailure(AssertionError):
    """A check of the dry run disagreed with its unsharded golden."""


def _need(cond, what: str):
    if not cond:
        raise DryrunFailure(what)


def _close(got: torch.Tensor, want: torch.Tensor, rtol: float, atol: float,
           what: str):
    got, want = got.double().cpu(), want.double().cpu()
    err = (got - want).abs()
    lim = atol + rtol * want.abs()
    _need(bool(torch.isfinite(got).all()) and bool((err <= lim).all()),
          f"{what}: max abs err {float(err.max()):.3g}, "
          f"{float((err / lim).max()):.3g} times the limit")


def _pp_stage(params, x):
    return torch.tanh(x @ params["w"] + params["b"])


def entry(device="cuda"):
    """A forward step of the flagship model at the tiny geometry, and its
    arguments: ``fn(*args)`` gives (2, 64, vocab) f32 logits."""
    config = LlamaConfig.tiny()
    model = Llama(config, device=device).init(
        torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, config.vocab_size, (2, 64))).to(model.device)

    @torch.no_grad()
    def fwd(tokens):
        return model.forward(tokens)

    return fwd, (tokens,)


def dryrun_multichip(n_ranks: int, device="cuda") -> dict:
    """One step of every parallelism axis over ``n_ranks`` virtual ranks
    on ``device`` (``"cuda"`` by default, which raises without CUDA),
    each against an unsharded golden:

      1. dp x tp: a Llama train step (AdamW) over a (dp, tp) mesh, tp the
         largest of 4, 2, 1 dividing ``n_ranks``; its loss within 1e-3
         (relative above 1) of the unsharded loss.
      2. sp: a train step with ring attention over a (1, n_ranks)
         ("dpx", "sp") mesh, held the same way.
      3. tp decode: ``generate`` over the tp mesh, greedy tokens agreeing
         with the unsharded ones at a rate of at least 0.65.
      4. pp: the pipeline over n_ranks stages against the stages in
         sequence (rtol = atol = 1e-5).
      5. ep: an MoE layer over n_ranks expert ranks against the dense
         layer at a capacity that drops nothing (rtol 1e-4, atol 1e-5).
      6. sp ring: causal ring attention against dense attention over the
         whole sequence (rtol = atol = 2e-4) at head dim 8.
      7. ddp: bucketed ring all-reduce of per-rank gradients r, averaged
         to the exact mean (rtol 1e-6).

    Checks 2 and 3 run, as in the reference, only where ``n_ranks``
    divides the sequence (32) and tp the head counts (4). Returns the
    seconds of each check that ran, by name, in ``CHECKS`` order (a
    check that did not run has no entry); raises :class:`DryrunFailure`
    on the first that disagrees."""
    dev = resolve_device(device)
    n = int(n_ranks)
    secs = {}
    t0 = time.perf_counter()

    def done(name):
        nonlocal t0
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        secs[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    tp = max(t for t in (4, 2, 1) if n % t == 0)
    dp = n // tp
    mesh = make_mesh((dp, tp), ("dp", "tp"), dev)

    # -- 3. tp decode, then 1. the dp x tp Llama train step -----------------
    config = LlamaConfig.tiny(dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
                              ffn_dim=128)
    model = Llama(config, device=dev).init(torch.Generator().manual_seed(0))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    batch = torch.from_numpy(np.random.default_rng(1).integers(
        0, config.vocab_size, (2 * dp, 32))).to(dev)
    with torch.no_grad():
        golden_loss = float(model.loss(batch))
    if config.n_heads % tp == 0 and config.n_kv_heads % tp == 0:
        # greedy ties may flip between the two paths: the agreement rate
        prompt = batch[:dp * 2, :8]
        golden_tokens = model.generate(prompt, max_new=3)
        tp_tokens = model.generate(prompt, max_new=3, mesh=mesh, dp="dp")
        agree = float((tp_tokens == golden_tokens).float().mean())
        _need(agree >= 0.65, f"tp decode: greedy agreement {agree}")
        done("tp decode")
    step = model.make_train_step(torch.optim.AdamW(model.parameters(),
                                                   lr=1e-3),
                                 dp="dp", mesh=mesh)
    loss = float(step(batch))
    _need(math.isfinite(loss), f"dp x tp: loss {loss}")
    _need(abs(loss - golden_loss) < 1e-3 * max(1.0, golden_loss),
          f"dp x tp: loss {loss} against the unsharded {golden_loss}")
    done("dp x tp")

    # -- 2. sp: sequence-parallel train step --------------------------------
    if batch.shape[1] % n == 0:
        sp_model = Llama(config, device=dev)
        sp_model.load_state_dict(init)
        sp_mesh2 = make_mesh((1, n), ("dpx", "sp"), dev)
        sp_step = sp_model.make_train_step(
            torch.optim.AdamW(sp_model.parameters(), lr=1e-3), dp="dpx",
            sp="sp", mesh=sp_mesh2)
        sp_loss = float(sp_step(batch))
        _need(abs(sp_loss - golden_loss) < 1e-3 * max(1.0, golden_loss),
              f"sp: loss {sp_loss} against the unsharded {golden_loss}")
        done("sp")

    # -- 4. pp: the pipeline over n stages ----------------------------------
    W, d = n, 16
    rng = np.random.default_rng(2)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    stage_params = {"w": t(rng.standard_normal((W, d, d)) * 0.1),
                    "b": t(np.zeros((W, d)))}
    micro = t(rng.standard_normal((2 * W, 4, d)))
    with torch.no_grad():
        out = pipeline_sharded(_pp_stage, stage_params, micro,
                               make_mesh((W,), ("pp",), dev), axis_name="pp")
        ref = micro
        for s in range(W):
            ref = _pp_stage({"w": stage_params["w"][s],
                             "b": stage_params["b"][s]}, ref)
    _close(out, ref, 1e-5, 1e-5, "pp")
    done("pp")

    # -- 5. ep: MoE expert-parallel dispatch --------------------------------
    layer = MoELayer(MoEConfig(dim=16, ffn_dim=32, n_experts=n, top_k=2),
                     device=dev).init(torch.Generator().manual_seed(3))
    x = t(rng.standard_normal((n * 4, 16)))
    cap = x.shape[0]                      # drops nothing on either path
    with torch.no_grad():
        y, _aux = moe_apply_sharded(layer, x, make_mesh((n,), ("ep",), dev),
                                    axis_name="ep", capacity=cap)
        y_ref, _ = layer.apply_dense(x, capacity=cap)
    _close(y, y_ref, 1e-4, 1e-5, "ep")
    done("ep")

    # -- 6. sp: ring attention over the sequence ----------------------------
    S, D = 8 * n, 8
    q, k, v = (t(rng.standard_normal((1, 2, S, D))) for _ in range(3))
    with torch.no_grad():
        o = ring_attention_sharded(q, k, v, make_mesh((n,), ("sp",), dev),
                                   axis_name="sp", causal=True,
                                   sm_scale=D ** -0.5)
        sf = torch.einsum("bhqd,bhkd->bhqk", q, k) * (D ** -0.5)
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=dev))
        sf = torch.where(mask, sf, torch.finfo(torch.float32).min)
        o_ref = torch.einsum("bhqk,bhkd->bhqd", torch.softmax(sf, -1), v)
    _close(o, o_ref, 2e-4, 2e-4, "sp ring")
    done("sp ring")

    # -- 7. DDP bucketed gradient all-reduce --------------------------------
    grads = [{"w1": torch.full((64, 8), float(r), device=dev),
              "w2": torch.full((128,), float(r), device=dev)}
             for r in range(n)]
    plan = make_bucket_plan(grads[0], bucket_bytes=1 << 10)
    coll = RankCollectives(make_mesh((n,), ("dp",), dev).group("dp"))
    synced = bucketed_allreduce(grads, coll, plan=plan, average=True,
                                algorithm="ring")
    expect = sum(range(n)) / n
    for r, tree in enumerate(synced):
        for name, leaf in tree.items():
            _close(leaf, torch.full_like(leaf, expect), 1e-6, 0.0,
                   f"ddp rank {r} {name}")
    done("ddp")
    return {name: secs[name] for name in CHECKS if name in secs}
