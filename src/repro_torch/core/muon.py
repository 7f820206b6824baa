"""Muon / BlockMuon / MuonBP -- paper Algorithm 1 as a PyTorch optimizer.

Counterpart of ``repro/core/muon.py``, baseline variant only. One
implementation covers all three methods via the period ``P``:

  * ``P = 1``        -> Muon       (full orthogonalization every step)
  * ``P = None``     -> BlockMuon  (block orthogonalization every step)
  * ``P = 5`` (etc.) -> MuonBP     (block for P-1 steps, full every P-th)

The phase ('block' | 'full') is an argument of ``update``; the launcher
picks it per step with :func:`phase_for_step`. ``update`` runs Nesterov
momentum, interprets the compiled :class:`program.UpdateProgram` (one NS
chain per shape bucket through ``kernels.dispatch``), then the two-stepsize
RMS-matched epilogue with decoupled weight decay (Theorem 2, paper
Sec 3.2). The step count is a host integer, so schedules never sync the
device.

Trees are nested dicts (``repro_torch.tree``); ``None`` leaves are masked
out, as ``core.combine`` hands each sub-optimizer its own parameters.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import newton_schulz
from repro_torch.core import program as program_lib
from repro_torch.core.bucketing import dtype_name
from repro_torch.core.newton_schulz import PAPER_COEFFS

Schedule = Callable[[int], float]


class OptState(NamedTuple):
    momentum: dict  # path -> fp32 momentum tensor
    count: int      # step counter


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """``update(grads, state, params, phase) -> (updates, new_state)``;
    apply with ``params + updates`` (``combine.apply_updates``)."""

    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


def phase_for_step(step: int, period: Optional[int]) -> str:
    """Paper Algorithm 1 line 6: full iff t % P == 0; P=None means BlockMuon."""
    if period is None:
        return "block"
    if period <= 1:
        return "full"
    return "full" if step % period == 0 else "block"


def _as_schedule(lr) -> Schedule:
    if callable(lr):
        return lr
    return lambda count: float(lr)


def _rms_scale(m: int, n: int, target: float) -> float:
    # Liu et al. 2025: orth(M) of an m x n matrix has RMS ~ 1/sqrt(max(m, n)).
    return target * float(max(m, n)) ** 0.5


def muon(
    lr_full,
    lr_block=None,
    *,
    momentum: float = 0.95,
    nesterov: bool = True,
    period: Optional[int] = 5,
    ns_steps: int = 5,
    ns_coeffs=PAPER_COEFFS,
    rms_match: bool = True,
    rms_target: float = 0.2,
    weight_decay: float = 0.0,
    block_specs: Optional[dict] = None,
    bucketing: bool = True,
    ns_strategy: Optional[str] = None,
    variant: Any = None,
) -> Optimizer:
    """Build the Muon-family optimizer (paper Algorithm 1).

    Arguments as in the reference. ``block_specs`` is a nested dict of
    :class:`blocking.BlockSpec2D` (or None) matching params;
    ``ns_strategy`` pins every bucket's kernel (``dispatch.STRATEGIES``,
    ``"plain"`` for the plain PyTorch chain; None plans per bucket).
    Optimizer variants are not ported yet: any ``variant`` other than the
    baseline raises.
    """
    if variant not in (None, "muon"):
        raise NotImplementedError(f"optimizer variant {variant!r} is not ported yet")
    lr_full_fn = _as_schedule(lr_full)
    lr_block_fn = _as_schedule(lr_block if lr_block is not None else lr_full)
    mu = momentum
    bs_by_path = dict(tree_lib.flatten_with_path(block_specs)) if block_specs else {}
    programs: dict = {}

    def _program_for(leaf_specs: tuple, backend: str) -> program_lib.UpdateProgram:
        key = (leaf_specs, backend)
        if key not in programs:
            programs[key] = program_lib.compile_program(
                leaf_specs, bucketing=bucketing, backend=backend, strategy=ns_strategy,
            )
        return programs[key]

    def _orth(u: torch.Tensor, strategy: Optional[str] = None) -> torch.Tensor:
        return newton_schulz.orthogonalize(
            u, steps=ns_steps, coeffs=ns_coeffs, strategy=strategy
        )

    def init(params) -> OptState:
        return OptState(
            momentum={
                path: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for path, p in tree_lib.flatten_with_path(params)
            },
            count=0,
        )

    @torch.no_grad()
    def update(grads, state: OptState, params, phase: str = "block"):
        if phase not in ("block", "full"):
            raise ValueError(f"phase must be 'block' or 'full', got {phase!r}")
        count = state.count + 1
        lr_f = float(lr_full_fn(count))
        lr = lr_f if phase == "full" else float(lr_block_fn(count))

        flat = tree_lib.flatten_with_path(grads)
        keys = [path for path, _ in flat]
        g_leaves = [g.to(torch.float32) for _, g in flat]
        m_leaves = [mu * state.momentum[k] + g for k, g in zip(keys, g_leaves)]
        p_by_key = dict(tree_lib.flatten_with_path(params))
        p_leaves = [p_by_key[k] for k in keys]
        u_leaves = [g + mu * m for g, m in zip(g_leaves, m_leaves)] if nesterov else m_leaves

        leaf_specs = tuple(
            program_lib.LeafSpec(
                key=k, shape=tuple(u.shape), dtype=dtype_name(u.dtype),
                block=bs_by_path.get(k),
            )
            for k, u in zip(keys, u_leaves)
        )
        backend = u_leaves[0].device.type if u_leaves else "cpu"
        program = _program_for(leaf_specs, backend)
        o_leaves = program.execute(phase, u_leaves, _orth)
        prog_phase = program.phase(phase)

        upd_items = []
        for i, (k, o, p) in enumerate(zip(keys, o_leaves, p_leaves)):
            m_eff, n_eff = prog_phase.eff_dims(i)
            scale = _rms_scale(m_eff, n_eff, rms_target) if rms_match else 1.0
            upd = -lr * scale * o
            if weight_decay:
                upd = upd - lr * weight_decay * p.to(torch.float32)
            upd_items.append((k, upd.to(p.dtype)))
        new_m = dict(zip(keys, m_leaves))
        return tree_lib.unflatten(upd_items), OptState(momentum=new_m, count=count)

    return Optimizer(init=init, update=update)


def block_muon(lr_block, **kw) -> Optimizer:
    """BlockMuon (Boreiko et al. 2025) = Algorithm 1 with P = infinity."""
    kw.pop("period", None)
    return muon(lr_block, lr_block, period=None, **kw)


def muon_full(lr, **kw) -> Optimizer:
    """Baseline Muon (Jordan et al. 2024) = Algorithm 1 with P = 1."""
    kw.pop("period", None)
    return muon(lr, lr, period=1, **kw)
