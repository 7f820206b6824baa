"""Newton-Schulz dispatch: route ``orthogonalize`` to a kernel strategy.

Counterpart of ``repro/kernels/dispatch.py``. The backend is not a registry
name here: it follows the tensor's device. Every strategy calls kernel
wrappers that run their plain PyTorch version on a CPU tensor and launch
their Hopper kernel on a CUDA tensor, so the same compiled program runs in
the CPU tests and on the card.

Strategies (:data:`STRATEGIES`):

  * ``"plain"``       -- the plain PyTorch chain (``orthogonalize_plain``),
    the numerics oracle on either device;
  * ``"fused_chain"`` -- all K steps of a bucket in ONE launch (kernel #3);
  * ``"fused_iter"``  -- one launch per step (kernel #4), the A/B point;
  * ``"tiled"``       -- 3 product launches per step over the whole stack
    (kernels #1 and #2).

``plan_strategy`` is the compile-time choice the ``UpdateProgram`` records
per bucket: ``fused_chain`` when a unit fits ``fused.fits_budget`` (the fit
gate re-derived for the H100 as a cut in unit size; see ``fused.py``), else
``tiled``.
The reference's pipeline VMEM reserve (``dispatch.py:57-61``) belongs to
the multi-device engine, which is not ported.
"""

from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Optional

import torch

STRATEGIES = ("auto", "plain", "fused_chain", "fused_iter", "tiled")

# Launch observer: ``fn(device_type, strategy, shape)`` per orthogonalize
# call; exceptions propagate.
_launch_hook: Optional[Callable[[str, str, tuple], None]] = None


def set_launch_hook(fn: Optional[Callable[[str, str, tuple], None]]) -> None:
    """Install (or with None, clear) the NS dispatch observer."""
    global _launch_hook
    _launch_hook = fn


# Chain scope: ``fn(device_type, strategy, shape, steps)`` returns a context
# manager entered around each chain. The dry-run's FLOP counter pauses in
# it: a kernel on the card is opaque to the counter, so every device counts
# the chains from their shapes instead (``launch/dryrun.py``).
_chain_scope: Optional[Callable[[str, str, tuple, int], ContextManager]] = None


def set_chain_scope(fn: Optional[Callable[[str, str, tuple, int], ContextManager]]) -> None:
    """Install (or with None, clear) the context entered around each chain."""
    global _chain_scope
    _chain_scope = fn


def plan_strategy(shape, *, budget: Optional[int] = None) -> str:
    """Static kernel plan for a (stacked) unit shape: fused_chain or tiled."""
    from repro_torch.kernels.newton_schulz import fused

    budget = fused.UNIT_BUDGET_BYTES if budget is None else budget
    return "fused_chain" if fused.fits_budget(shape, budget=budget) else "tiled"


def shared_launch_groups(keys) -> dict:
    """Plan cross-bucket launch sharing over concat-mode ``(m, n, dtype)`` keys.

    Buckets that differ only in dtype share one launch at the promoted
    compute dtype. Returns ``{(m, n): (compute_dtype, (dtype, ...))}``;
    single-dtype groups map to ``(dtype, ())``.
    """
    by_shape: dict = {}
    for m, n, dt in keys:
        by_shape.setdefault((m, n), set()).add(dt)
    out = {}
    for shape_key, dtypes in by_shape.items():
        if len(dtypes) == 1:
            out[shape_key] = (next(iter(dtypes)), ())
            continue
        compute = getattr(torch, sorted(dtypes)[0])
        for dt in sorted(dtypes)[1:]:
            compute = torch.promote_types(compute, getattr(torch, dt))
        out[shape_key] = (str(compute).removeprefix("torch."), tuple(sorted(dtypes)))
    return out


def orthogonalize(
    g: torch.Tensor, *, steps: int, coeffs, eps: float,
    strategy: Optional[str] = None, normalize: bool = True,
) -> torch.Tensor:
    """``Orth(g)`` over the trailing two dims through the chosen strategy."""
    if strategy is None or strategy == "auto":
        strategy = plan_strategy(g.shape)
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown NS strategy {strategy!r}; available: {STRATEGIES}")
    if _launch_hook is not None:
        _launch_hook(g.device.type, strategy, tuple(g.shape))
    scope = (contextlib.nullcontext() if _chain_scope is None
             else _chain_scope(g.device.type, strategy, tuple(g.shape), steps))
    with scope:
        return _run(g, steps=steps, coeffs=coeffs, eps=eps, strategy=strategy,
                    normalize=normalize)


def _run(g: torch.Tensor, *, steps: int, coeffs, eps: float, strategy: str,
         normalize: bool) -> torch.Tensor:
    from repro_torch.core.newton_schulz import orthogonalize_plain
    from repro_torch.kernels.newton_schulz import fused, ops

    if strategy == "plain":
        return orthogonalize_plain(g, steps=steps, coeffs=coeffs, eps=eps, normalize=normalize)
    if strategy in ("fused_chain", "fused_iter"):
        return fused.orthogonalize(
            g, steps=steps, coeffs=coeffs, eps=eps,
            chain=strategy == "fused_chain", normalize=normalize,
        )
    return ops.orthogonalize(g, steps=steps, coeffs=coeffs, eps=eps, normalize=normalize)
