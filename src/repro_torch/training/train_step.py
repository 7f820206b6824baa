"""Training step: mixed-precision loss/grad + optimizer apply.

Counterpart of ``repro/training/train_step.py``. Paper setup (Sec 4.2):
fp32 master parameters; the forward and backward run on a cast to
``compute_dtype`` (bf16 by default); gradients and optimizer state are
fp32. The MuonBP phase ('block' | 'full') is an argument, chosen per step
by the launcher. ``guard=`` runs the optimizer apply behind the health
check of ``training/resilience.py``; ``fault=`` injects a fault of
``training/faults.py`` into the step.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core.combine import apply_updates
from repro_torch.core.muon import Optimizer
from repro_torch.models.model import loss_fn
from repro_torch.training import faults as faults_lib
from repro_torch.training import resilience


class TrainState(NamedTuple):
    params: Any      # nested dict of fp32 master tensors
    opt_state: Any
    step: int
    # resilience.GuardState when the guarded step is on, None otherwise.
    guard: Any = None


def init_train_state(params, optimizer: Optimizer, guard: bool = False) -> TrainState:
    device = tree_lib.leaves(params)[0].device
    return TrainState(params=params, opt_state=optimizer.init(params), step=0,
                      guard=resilience.init_guard_state(device) if guard else None)


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
    guard=None,
    fault=None,
) -> tuple[TrainState, dict]:
    """One optimization step. Returns (new_state, metrics).

    ``accum_steps > 1`` splits the batch into microbatches and averages
    their gradients (same total work, less activation memory).
    ``bf16_grads`` differentiates w.r.t. the compute-dtype cast of the
    parameters instead of the fp32 masters.

    ``guard``: an optional :class:`resilience.GuardConfig`. Healthy steps
    equal the unguarded step bitwise; unhealthy ones leave params and
    optimizer state untouched and bump ``state.guard.skipped``. The metrics
    then also carry ``healthy``, ``skipped``, ``ema_loss`` and ``lr_scale``.

    ``fault``: an optional in-step :class:`faults.Fault` (tests and the
    chaos drill only).
    """
    if accum_steps > 1:
        micro = [
            {k: v.reshape(accum_steps, v.shape[0] // accum_steps, *v.shape[1:])[i]
             for k, v in batch.items()}
            for i in range(accum_steps)
        ]
        grads = None
        losses, micro_metrics = [], []
        for mb in micro:
            loss_i, m_i, g = loss_and_grads(state.params, mb, cfg, compute_dtype, bf16_grads)
            g = tree_lib.tree_map(lambda x: x.to(torch.float32) / accum_steps, g)
            grads = g if grads is None else tree_lib.tree_map(torch.add, grads, g)
            losses.append(loss_i)
            micro_metrics.append(m_i)
        loss = torch.stack(losses).mean()
        # Every metric is the mean over the microbatches, as the reference's.
        metrics = {k: torch.stack([m[k].detach() for m in micro_metrics]).mean()
                   for k in micro_metrics[0]}
    else:
        loss, metrics, grads = loss_and_grads(state.params, batch, cfg, compute_dtype, bf16_grads)
    metrics = {k: v.detach() for k, v in metrics.items()}
    if fault is not None:
        loss, grads, metrics = faults_lib.inject(fault, loss, grads, metrics)
    with torch.no_grad():
        grad_sq_norm = sum(torch.sum(g.to(torch.float32) ** 2) for g in tree_lib.leaves(grads))
        metrics["grad_norm"] = torch.sqrt(grad_sq_norm)
    if guard is not None:
        gstate = state.guard
        if gstate is None:
            gstate = resilience.init_guard_state(loss.device)
        new_params, new_opt_state, new_guard, healthy = resilience.guarded_update(
            optimizer, guard, grads, state.opt_state, state.params, gstate, loss,
            grad_sq_norm, phase)
        metrics["healthy"] = healthy.to(torch.int32)
        metrics["skipped"] = new_guard.skipped
        metrics["ema_loss"] = resilience.debiased_ema(guard, new_guard)
        metrics["lr_scale"] = new_guard.lr_scale
        return TrainState(new_params, new_opt_state, state.step + 1, new_guard), metrics
    updates, new_opt_state = optimizer.update(grads, state.opt_state, state.params, phase)
    with torch.no_grad():
        new_params = apply_updates(state.params, updates)
    return TrainState(new_params, new_opt_state, state.step + 1, state.guard), metrics
