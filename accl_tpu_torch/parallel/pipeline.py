"""Pipeline parallelism: the GPipe microbatch schedule over a pp axis.

The counterpart of ``accl_tpu/parallel/pipeline.py``. Rank r of the pp
axis owns stage r's parameters; activations flow stage to stage with one
neighbour exchange a step (:meth:`RankCollectives.exchange`, the
reference's ``ppermute``). The fill/drain schedule runs ``n_micro + W -
1`` steps: at step t stage 0 takes microbatch t, every stage applies
itself to the activation it holds, the last stage's output is output t
- (W - 1), and the exchange shifts each activation to the next stage.

The reference keeps the schedule static under jit: every rank computes
at every step and masks discard the steps before the fill front and
after the drain tail. Here the single controller SKIPS those steps: at
step t only the ranks r with 0 <= t - r < n_micro apply their stage,
and the exchange carries only their activations (the last stage's
outputs stay; the reference's wrap from it to stage 0 carries nothing
that is read). The outputs are the same either way; on one device the
virtual ranks serialize, so the skipped steps are time saved. The
schedule is differentiable: an exchange hands the same tensor on, so
autograd's backward of the shift is the inverse shift, and gradients
reach every stage's parameters.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from .collectives import RankCollectives


def pipeline_apply(stage_fn: Callable,
                   stage_params: Mapping[str, torch.Tensor],
                   microbatches: torch.Tensor, coll: RankCollectives,
                   replicate_out: bool = True) -> torch.Tensor:
    """Run ``stage_fn(params, x)`` as a W-stage pipeline over the W ranks
    of ``coll``.

    Args:
        stage_fn: the per-stage function ``(params, x) -> y`` with
            ``y.shape == x.shape`` (homogeneous stages).
        stage_params: the stages' parameters as rank rows: each leaf
            (W, ...), row r stage r's (rank r receives ``{k: v[r]}``).
        microbatches: (n_micro, mb, ...); only stage 0 reads it.
        coll: the pp axis's collectives.
        replicate_out: True returns the (n_micro, mb, ...) outputs, which
            every rank holds after the reference's masked psum (one copy:
            the ranks share one device); False returns rank rows (W,
            n_micro, mb, ...), the outputs in the last row and zeros in
            the others, as the reference's non-final ranks return.

    Steps before the fill front and after the drain tail are skipped,
    not computed and masked (module docstring)."""
    W = coll.W
    n_micro = microbatches.shape[0]
    for k, v in stage_params.items():
        if v.shape[0] != W:
            raise ValueError(f"stage parameter {k!r} has {v.shape[0]} "
                             f"rows for {W} pp ranks")
    params = [{k: v[r] for k, v in stage_params.items()} for r in range(W)]
    state = [None] * W
    outputs = []
    for t in range(n_micro + W - 1):
        live = [r for r in range(W) if 0 <= t - r < n_micro]
        y = [None] * W
        for r in live:
            x_in = microbatches[t] if r == 0 else state[r]
            y[r] = stage_fn(params[r], x_in)
        if live[-1] == W - 1:                  # output t - (W - 1)
            outputs.append(y[W - 1])
        state = coll.exchange(y, [(r, r + 1) for r in live if r < W - 1])
    out = torch.stack(outputs)
    if replicate_out:
        return out
    return torch.cat([out.new_zeros((W - 1, *out.shape)), out[None]])


def pipeline_sharded(stage_fn: Callable,
                     stacked_params: Mapping[str, torch.Tensor],
                     microbatches: torch.Tensor, mesh,
                     axis_name: str = "pp") -> torch.Tensor:
    """Global-array entry: ``stacked_params`` is a flat dict whose leaves
    carry a leading (W,) stage axis, W the size of the mesh's
    ``axis_name`` axis; ``microbatches`` is (n_micro, mb, ...). Returns
    the (n_micro, mb, ...) outputs, every microbatch through the W
    stages in order."""
    coll = RankCollectives(mesh.group(axis_name))
    for k, v in stacked_params.items():
        if v.device != mesh.device:
            raise ValueError(f"stage parameter {k!r} on {v.device}, mesh "
                             f"on {mesh.device}")
    return pipeline_apply(stage_fn, stacked_params, microbatches, coll,
                          replicate_out=True)
