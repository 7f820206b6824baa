"""Training step: mixed-precision loss/grad + optimizer apply.

Counterpart of ``repro/training/train_step.py``. Paper setup (Sec 4.2):
fp32 master parameters; the forward and backward run on a cast to
``compute_dtype`` (bf16 by default); gradients and optimizer state are
fp32. The MuonBP phase ('block' | 'full') is an argument, chosen per step
by the launcher. ``guard=`` runs the optimizer apply behind the health
check of ``training/resilience.py``; ``fault=`` injects a fault of
``training/faults.py`` into the step.

``engine=`` (``distributed.engine.ShardMapEngine``, under the launcher's
``--mesh``) runs the step on a mesh of ranks, on one of two paths
(``sharding.specs.mesh_path``):

* tensor-parallel (``ctx=``, a tensor-parallel ``sharding.specs.ShardCtx``;
  the dense and MoE models): each rank holds its param-layout shards and
  runs the tensor-parallel forward and backward on the rows of its data
  coordinate, so its gradients come out in the param layout. Where the
  residual is sequence-sharded, each rank's gradient of a leaf the model
  axis does not split (the norm gains) covers only its sequence shard, and
  an MoE router's sees only the rank's ``d_ff`` slice of the experts: those
  are summed over the model axis first (phase ``'tp'``). The gradients are then
  averaged over the data axes (``grad_reduce``), the optimizer returns its
  updates in the momentum layout and the plan's 'apply' gathers bring them
  to the param layout each rank adds to its shards;
* replicated (every other arch): every rank runs the whole model on its
  slice of the batch, the full gradients are averaged over the data axes,
  and after the 'apply' gathers the replica gather over the model axes
  brings each update to the full tensor every rank adds to its replica.

Each part runs in a span (``train.fwd_bwd``, ``train.grad_reduce``,
``train.update``, ``train.apply``, and ``train.replica_gather`` on the
replicated path), the guarded step's too; a step the guard skips runs the
first two only.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.configs.base import ModelConfig
from repro_torch.core.combine import apply_updates
from repro_torch.core.muon import Optimizer
from repro_torch.distributed.tensor_parallel import grad_is_partial
from repro_torch.models.model import loss_fn
from repro_torch.obs import get_bus, span
from repro_torch.sharding.specs import data_axes_for
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


def loss_and_grads(params, batch, cfg, compute_dtype=torch.bfloat16, bf16_grads: bool = False,
                   ctx=None):
    """(loss, metrics, grads) with grads shaped like ``params`` (``ctx``:
    the model's ``ShardCtx``; tensor-parallel, ``params`` are the rank's
    shards and so are the grads)."""
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
    loss, metrics = loss_fn(compute, batch, cfg, ctx=ctx)
    # A leaf the loss does not read (hymba's ssm_norm: its hybrid layer
    # norms once, with attn_norm) gets zeros, as jax.grad gives it.
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
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
    engine=None,
    ctx=None,
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

    ``engine``: the distributed engine, and ``ctx`` the model's context on
    its mesh (see the module docstring). With ``guard`` too, every rank
    takes the branch the mesh agreed on (``resilience.guarded_update``).
    """
    bus = get_bus()
    sync = None if engine is None else engine.comm.sync
    with span(bus if engine is not None else None, "train.fwd_bwd", sync=sync):
        loss, metrics, grads = _loss_and_grads(state, batch, cfg, compute_dtype, accum_steps,
                                               bf16_grads, ctx)
    if engine is not None:
        with span(bus, "train.grad_reduce", sync=sync):
            loss, metrics = reduce_grads(engine, loss, metrics, grads, ctx)
    if fault is not None:
        loss, grads, metrics = faults_lib.inject(fault, loss, grads, metrics)
    with torch.no_grad():
        if engine is not None:
            grad_sq_norm = engine.global_sq_sum(tree_lib.flatten_with_path(grads))
        else:
            grad_sq_norm = sum(torch.sum(g.to(torch.float32) ** 2)
                               for g in tree_lib.leaves(grads))
        metrics["grad_norm"] = torch.sqrt(grad_sq_norm)
    if guard is not None:
        gstate = state.guard
        if gstate is None:
            gstate = resilience.init_guard_state(loss.device)
        new_params, new_opt_state, new_guard, healthy = resilience.guarded_update(
            optimizer, guard, grads, state.opt_state, state.params, gstate, loss,
            grad_sq_norm, phase, engine=engine)
        metrics["healthy"] = healthy.to(torch.int32)
        metrics["skipped"] = new_guard.skipped
        metrics["ema_loss"] = resilience.debiased_ema(guard, new_guard)
        metrics["lr_scale"] = new_guard.lr_scale
        return TrainState(new_params, new_opt_state, state.step + 1, new_guard), metrics
    with span(bus if engine is not None else None, "train.update", sync=sync):
        updates, new_opt_state = optimizer.update(grads, state.opt_state, state.params, phase)
    del grads
    with torch.no_grad():
        if engine is not None:
            updates = full_updates(engine, updates, sync=sync)
        new_params = apply_updates(state.params, updates)
    return TrainState(new_params, new_opt_state, state.step + 1, state.guard), metrics


def _loss_and_grads(state, batch, cfg, compute_dtype, accum_steps, bf16_grads, ctx):
    """(loss, metrics, grads) of the step, over ``accum_steps`` microbatches."""
    if accum_steps > 1:
        micro = [
            {k: v.reshape(accum_steps, v.shape[0] // accum_steps, *v.shape[1:])[i]
             for k, v in batch.items()}
            for i in range(accum_steps)
        ]
        grads = None
        losses, micro_metrics = [], []
        for mb in micro:
            loss_i, m_i, g = loss_and_grads(state.params, mb, cfg, compute_dtype, bf16_grads,
                                            ctx)
            g = tree_lib.tree_map(lambda x: x.to(torch.float32) / accum_steps, g)
            grads = g if grads is None else tree_lib.tree_map(torch.add, grads, g)
            losses.append(loss_i)
            micro_metrics.append(m_i)
        loss = torch.stack(losses).mean()
        # Every metric is the mean over the microbatches, as the reference's.
        metrics = {k: torch.stack([m[k].detach() for m in micro_metrics]).mean()
                   for k in micro_metrics[0]}
    else:
        loss, metrics, grads = loss_and_grads(state.params, batch, cfg, compute_dtype, bf16_grads,
                                              ctx)
    return loss, {k: v.detach() for k, v in metrics.items()}, grads


@torch.no_grad()
def reduce_grads(engine, loss, metrics: dict, grads, ctx=None) -> tuple:
    """Average the gradients (in place), the loss and the metrics over the
    data axes: the ``grad_reduce`` collectives. Returns (loss, metrics).

    With a tensor-parallel ``ctx``, the gradients that are partial over
    the model axis (``tensor_parallel.grad_is_partial``: with a
    sequence-sharded residual every leaf the axis does not split, each
    rank's covering its sequence shard's tokens; the MoE router in either
    layout) are first summed over it (phase ``'tp'``)."""
    if ctx is not None and ctx.tensor_parallel:
        for key, g in tree_lib.flatten_with_path(grads):
            if grad_is_partial(key, engine.model_split(key, g.dim()), ctx):
                engine.comm.all_reduce(g, ctx.model_axes, phase="tp")
    axes = tuple(a for a in data_axes_for(engine.axis_sizes) if engine.axis_sizes[a] > 1)
    if not axes:
        return loss, metrics
    n = engine.comm.size(axes)
    for g in tree_lib.leaves(grads):
        engine.comm.all_reduce(g, axes, phase="grad_reduce").div_(n)
    names = sorted(metrics)
    vals = torch.stack([loss.to(torch.float32)] + [metrics[k].to(torch.float32) for k in names])
    vals = engine.comm.all_reduce(vals, axes, phase="grad_reduce") / n
    return vals[0], {k: vals[i + 1] for i, k in enumerate(names)}


@torch.no_grad()
def full_updates(engine, updates, sync=None):
    """The optimizer's momentum-layout updates as the tensors each rank adds
    to its parameters: the 'apply' gathers to the param layout, and on the
    replicated path the replica gather to the full tensor."""
    bus = get_bus()
    flat = tree_lib.flatten_with_path(updates)
    with span(bus, "train.apply", sync=sync):
        flat = [(k, engine.to_param_layout(k, u)) for k, u in flat]
    if not engine.tensor_parallel:
        with span(bus, "train.replica_gather", sync=sync):
            flat = [(k, engine.replicate(k, u)) for k, u in flat]
    return tree_lib.unflatten(flat)
