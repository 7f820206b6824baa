"""Training step: mixed-precision loss/grad + optimizer apply.

Counterpart of the unguarded ``repro/training/train_step.py``. Paper setup
(Sec 4.2): fp32 master parameters; the forward and backward run on a cast
to ``compute_dtype`` (bf16 by default); gradients and optimizer state are
fp32. The MuonBP phase ('block' | 'full') is an argument, chosen per step
by the launcher. The reference's guard and fault injection belong to the
resilience slice and are not ported yet.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core.combine import apply_updates
from repro_torch.core.muon import Optimizer
from repro_torch.models.model import loss_fn


class TrainState(NamedTuple):
    params: Any      # nested dict of fp32 master tensors
    opt_state: Any
    step: int


def init_train_state(params, optimizer: Optimizer) -> TrainState:
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def cast_tree(tree, dtype):
    return tree_lib.tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def loss_and_grads(params, batch, cfg, compute_dtype=torch.bfloat16, bf16_grads: bool = False):
    """(loss, metrics, grads) with grads shaped like ``params``."""
    flat = tree_lib.flatten_with_path(params)
    if bf16_grads:
        # Differentiate w.r.t. the compute-dtype copies: grads arrive in
        # that dtype, the optimizer widens them to fp32.
        leaves = [p.detach().to(compute_dtype).requires_grad_(True) for _, p in flat]
        compute = tree_lib.unflatten([(k, t) for (k, _), t in zip(flat, leaves)])
    else:
        leaves = [p.detach().requires_grad_(True) for _, p in flat]
        compute = cast_tree(tree_lib.unflatten([(k, t) for (k, _), t in zip(flat, leaves)]),
                            compute_dtype)
    loss, metrics = loss_fn(compute, batch, cfg)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), metrics, tree_lib.unflatten([(k, g) for (k, _), g in zip(flat, grads)])


def train_step(
    state: TrainState,
    batch: dict,
    *,
    cfg: ModelConfig,
    optimizer: Optimizer,
    phase: str = "block",
    compute_dtype=torch.bfloat16,
    accum_steps: int = 1,
    bf16_grads: bool = False,
) -> tuple[TrainState, dict]:
    """One optimization step. Returns (new_state, metrics).

    ``accum_steps > 1`` splits the batch into microbatches and averages
    their gradients (same total work, less activation memory).
    ``bf16_grads`` differentiates w.r.t. the compute-dtype cast of the
    parameters instead of the fp32 masters.
    """
    if accum_steps > 1:
        micro = [
            {k: v.reshape(accum_steps, v.shape[0] // accum_steps, *v.shape[1:])[i]
             for k, v in batch.items()}
            for i in range(accum_steps)
        ]
        grads = None
        losses = []
        for mb in micro:
            loss_i, _, g = loss_and_grads(state.params, mb, cfg, compute_dtype, bf16_grads)
            g = tree_lib.tree_map(lambda x: x.to(torch.float32) / accum_steps, g)
            grads = g if grads is None else tree_lib.tree_map(torch.add, grads, g)
            losses.append(loss_i)
        loss = torch.stack(losses).mean()
        metrics = {"ce": loss, "loss": loss}
    else:
        loss, metrics, grads = loss_and_grads(state.params, batch, cfg, compute_dtype, bf16_grads)
    updates, new_opt_state = optimizer.update(grads, state.opt_state, state.params, phase)
    with torch.no_grad():
        new_params = apply_updates(state.params, updates)
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = torch.sqrt(
            sum(torch.sum(g.to(torch.float32) ** 2) for g in tree_lib.leaves(grads))
        )
    return TrainState(new_params, new_opt_state, state.step + 1), metrics
