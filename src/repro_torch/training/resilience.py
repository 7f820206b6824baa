"""Guarded training steps and the host-side escalation ladder.

Counterpart of ``repro/training/resilience.py``. A single NaN gradient
propagates into momentum forever, and a transient loss blow-up poisons the
steps after it; this module detects both and reacts:

* **Guard** (:func:`guarded_update`): a health predicate -- all-finite
  over the loss and the gradient square-norm, plus an EMA loss-spike
  detector carried in :class:`GuardState` -- decides whether the optimizer
  update runs. The reference branches with ``lax.cond`` inside its compiled
  step; the port reads the scalar predicate on the host once, before the
  update (one device sync a step), so an unhealthy step runs no optimizer
  work at all, as the reference's identity branch does. Healthy steps run
  exactly the unguarded update (bitwise: the same computation, and the
  escalation ``lr_scale`` multiplier is exact at 1.0); unhealthy steps
  leave params and optimizer state untouched and bump the skip counter.
  On a mesh of ranks (``engine=``) the predicate is agreed over the whole
  mesh before the host reads it: one all-reduce (MIN) of the int32 flag,
  phase ``'guard'``. The reference's ``lax.cond`` reads global scalars
  under its partitioner; here the loss and the gradient norm are already
  reduced alike on every rank, and the agreement makes every rank take the
  same branch by construction, not by equal rounding. A skipped step then
  issues no optimizer collective (``block``, ``full``, ``apply``,
  ``replica_gather``) on any rank.

* **Escalation ladder** (:class:`Escalator`): the launcher reads the
  cumulative skip counter each step and walks skip -> force an early
  'full'-phase step -> LR backoff (``GuardState.lr_scale``, folded into the
  update) -> checkpoint-and-abort.

Fault injection for exercising all of this lives in
``repro_torch.training.faults``; durable checkpoints in
``repro_torch.training.checkpoint``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core.combine import apply_updates
from repro_torch.obs import get_bus, span


class GuardState(NamedTuple):
    """Guard state as 0-d tensors on the step's device (``TrainState.guard``)."""

    ema_loss: torch.Tensor   # f32 biased EMA of healthy-step losses
    ema_count: torch.Tensor  # i32 healthy steps folded into the EMA
    skipped: torch.Tensor    # i32 cumulative skipped (unhealthy) steps
    lr_scale: torch.Tensor   # f32 escalation multiplier on the update (1.0 = off)


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


def _i32(value, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.int32, device=device)


def init_guard_state(device="cpu") -> GuardState:
    return GuardState(ema_loss=_f32(0.0, device), ema_count=_i32(0, device),
                      skipped=_i32(0, device), lr_scale=_f32(1.0, device))


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Static health-check configuration."""

    spike_factor: float = 3.0   # unhealthy if loss > spike_factor * EMA(loss)
    ema_beta: float = 0.98
    warmup_steps: int = 10      # spike detection off until the EMA has this many samples


def debiased_ema(cfg: GuardConfig, gstate: GuardState) -> torch.Tensor:
    """Bias-corrected EMA loss (Adam-style ``ema / (1 - beta^t)``)."""
    beta = _f32(cfg.ema_beta, gstate.ema_loss.device)
    t = torch.clamp(gstate.ema_count, min=1).to(torch.float32)
    return gstate.ema_loss / (1.0 - beta ** t)


def health_check(cfg: GuardConfig, loss: torch.Tensor, grad_sq_norm: torch.Tensor,
                 gstate: GuardState) -> torch.Tensor:
    """0-d bool tensor: is this step safe to apply?

    ``grad_sq_norm`` is the fp32 sum of squares over every gradient leaf:
    non-finite iff any gradient element is non-finite (or the norm itself
    overflowed, which the guard also treats as unstable). The spike check
    only engages once the EMA has ``warmup_steps`` healthy samples.
    """
    finite = torch.isfinite(loss) & torch.isfinite(grad_sq_norm)
    warm = gstate.ema_count >= cfg.warmup_steps
    spike = warm & (loss > _f32(cfg.spike_factor, loss.device) * debiased_ema(cfg, gstate))
    return finite & ~spike


def fold_observation(cfg: GuardConfig, gstate: GuardState, loss: torch.Tensor,
                     healthy: torch.Tensor) -> GuardState:
    """Advance the guard state: the EMA folds healthy losses only (a spike or
    a NaN must not poison the detector's baseline), skips count the rest."""
    beta = _f32(cfg.ema_beta, gstate.ema_loss.device)
    h = healthy.to(torch.int32)
    new_ema = torch.where(healthy, beta * gstate.ema_loss + (1.0 - beta) * loss,
                          gstate.ema_loss)
    return GuardState(ema_loss=new_ema, ema_count=gstate.ema_count + h,
                      skipped=gstate.skipped + (1 - h), lr_scale=gstate.lr_scale)


@torch.no_grad()
def guarded_update(optimizer, cfg: GuardConfig, grads, opt_state, params,
                   gstate: GuardState, loss: torch.Tensor, grad_sq_norm: torch.Tensor,
                   phase: str, engine=None):
    """The optimizer apply behind the health predicate.

    Returns ``(new_params, new_opt_state, new_guard_state, healthy)``. A
    healthy step runs ``optimizer.update`` and ``params + updates`` exactly
    as the unguarded step does (times ``lr_scale``, exact for 1.0); an
    unhealthy one returns params and optimizer state untouched -- momentum
    is NOT advanced past a corrupt gradient -- and launches nothing.

    ``engine`` (``distributed.engine.ShardMapEngine``): the step runs on a
    mesh of ranks. The predicate is agreed over all of it first (one
    all-reduce, MIN, of the int32 flag, phase ``'guard'``); a healthy
    step is the unguarded mesh step, in its spans: ``optimizer.update``,
    the ``lr_scale`` product, ``train_step.full_updates`` (the 'apply'
    gathers, and the replica gather on the replicated path), then the add.
    """
    healthy = health_check(cfg, loss, grad_sq_norm, gstate)
    if engine is not None:
        flag = healthy.to(torch.int32).reshape(1)
        engine.comm.all_reduce(flag, tuple(engine.axis_sizes), phase="guard", op="min")
        healthy = flag[0].to(torch.bool)
    if bool(healthy):  # the one host read of the predicate
        bus = sync = None
        if engine is not None:
            bus, sync = get_bus(), engine.comm.sync
        with span(bus, "train.update", sync=sync):
            updates, new_opt_state = optimizer.update(grads, opt_state, params, phase)
        scale = gstate.lr_scale
        updates = tree_lib.tree_map(lambda u: scale.to(u.dtype) * u, updates)
        if engine is not None:
            # Imported here: train_step imports this module.
            from repro_torch.training.train_step import full_updates

            updates = full_updates(engine, updates, sync=sync)
        new_params = apply_updates(params, updates)
    else:
        new_params, new_opt_state = params, opt_state
    return new_params, new_opt_state, fold_observation(cfg, gstate, loss, healthy), healthy


# ---------------------------------------------------------------------------
# Host-side escalation ladder (copied from the reference)
# ---------------------------------------------------------------------------

ACTIONS = ("none", "force_full", "backoff", "abort")


@dataclasses.dataclass(frozen=True)
class EscalationPolicy:
    """Thresholds on *consecutive* skipped steps. Each rung fires while the
    streak sits in its band; a healthy step resets the streak. 0 disables a
    rung."""

    force_full_after: int = 1   # dispatch an early 'full' phase step
    backoff_after: int = 3      # multiply GuardState.lr_scale by backoff_factor
    backoff_factor: float = 0.5
    abort_after: int = 6        # checkpoint and exit non-zero


class Escalator:
    """Walks the ladder from the cumulative skip counter.

    The launcher calls :meth:`observe` once per step with
    ``int(metrics['skipped'])``; the returned action is one of
    :data:`ACTIONS`. State is purely host-side.
    """

    def __init__(self, policy: EscalationPolicy = EscalationPolicy()):
        self.policy = policy
        self.consecutive = 0
        self._last_total = 0
        self.history: list[tuple[int, str]] = []  # (step, action)

    def observe(self, step: int, skipped_total: int) -> str:
        delta = skipped_total - self._last_total
        self._last_total = skipped_total
        if delta <= 0:
            self.consecutive = 0
            return "none"
        self.consecutive += delta
        p = self.policy
        if p.abort_after and self.consecutive >= p.abort_after:
            action = "abort"
        elif p.backoff_after and self.consecutive >= p.backoff_after:
            action = "backoff"
        elif p.force_full_after and self.consecutive >= p.force_full_after:
            action = "force_full"
        else:
            action = "none"
        if action != "none":
            self.history.append((step, action))
        return action


def apply_backoff(state, factor: float):
    """LR backoff rung: scale the guard's update multiplier (the step reads
    ``lr_scale`` from the state)."""
    g = state.guard
    return state._replace(guard=g._replace(
        lr_scale=g.lr_scale * _f32(factor, g.lr_scale.device)))


# ---------------------------------------------------------------------------
# Checkpoint (de)serialization of the guard state
# ---------------------------------------------------------------------------

def guard_to_meta(gstate: Optional[GuardState]) -> Optional[dict]:
    """JSON-safe snapshot of the guard state for checkpoint ``meta.json``."""
    if gstate is None:
        return None
    return {
        "ema_loss": float(gstate.ema_loss),
        "ema_count": int(gstate.ema_count),
        "skipped": int(gstate.skipped),
        "lr_scale": float(gstate.lr_scale),
    }


def guard_from_meta(meta: Optional[dict], device="cpu") -> GuardState:
    if not meta:
        return init_guard_state(device)
    return GuardState(
        ema_loss=_f32(meta.get("ema_loss", 0.0), device),
        ema_count=_i32(meta.get("ema_count", 0), device),
        skipped=_i32(meta.get("skipped", 0), device),
        lr_scale=_f32(meta.get("lr_scale", 1.0), device),
    )
