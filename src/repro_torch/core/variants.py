"""Optimizer-variant registry: the Muon family compiled through UpdateProgram.

Counterpart of ``repro/core/variants.py``. Every variant keeps "orthogonalize
the momentum" as its core op, so each drops into the same block-periodic
update program:

* ``muon`` -- the baseline MuonBP program, K = 5 NS iterations with the
  entry Frobenius normalization.
* ``turbo_muon`` -- spectral preconditioning before ``orthogonalize``: each
  packed stack is divided by a power-iteration estimate of its spectral norm,
  which lands every singular value near 1, inside the NS cubic's fast basin,
  so the chain runs K - 2 iterations with the entry normalization off.
* ``normuon`` -- the neuron-wise second-moment normalization after the NS
  program (``kernels/normuon.py``: a hand-written CUDA kernel and its plain
  version). The row statistics refresh only on full steps.
* ``dion`` -- the low-rank comparison (``core/dion.py``): the m x r projection
  ``B V`` is orthonormalized by the same compiled NS program (polar factor).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union


@dataclasses.dataclass(frozen=True)
class VariantSpec:
    """Static description of one optimizer variant's compiled program.

    ``ns_steps_delta`` adjusts the NS iteration count K (floored at 1);
    ``precondition``/``epilogue`` name the extra stages recorded on every
    bucket's ``KernelPlan``; ``beta2``/``stat_eps`` parameterize the NorMuon
    second-moment stage; ``low_rank`` routes to the Dion program.
    """

    name: str
    ns_steps_delta: int = 0
    precondition: Optional[str] = None
    epilogue: Optional[str] = None
    beta2: float = 0.95
    stat_eps: float = 1e-8
    low_rank: bool = False
    description: str = ""


VARIANTS = {
    "muon": VariantSpec(
        name="muon",
        description="baseline MuonBP program (K=5, Frobenius entry norm)"),
    "turbo_muon": VariantSpec(
        name="turbo_muon",
        ns_steps_delta=-2,
        precondition="spectral_scale",
        description="spectral preconditioning -> NS compiled with K-2"),
    "normuon": VariantSpec(
        name="normuon",
        epilogue="neuron_norm",
        description="neuron-wise second-moment NS epilogue"),
    "dion": VariantSpec(
        name="dion",
        low_rank=True,
        description="low-rank (rank-r) update; NS-polar through the program"),
}


def names() -> tuple[str, ...]:
    return tuple(VARIANTS)


def get(variant: Union[str, VariantSpec, None]) -> VariantSpec:
    """Resolve a variant name (or pass a spec through; None -> baseline)."""
    if variant is None:
        return VARIANTS["muon"]
    if isinstance(variant, VariantSpec):
        return variant
    try:
        return VARIANTS[variant]
    except KeyError:
        raise ValueError(
            f"unknown optimizer variant {variant!r}; available: {names()}"
        ) from None


# Keyword arguments the Dion program shares with ``muon``; the blocking
# knobs mean nothing to a low-rank update and are dropped.
_DION_KEYS = ("momentum", "weight_decay", "rms_target", "bucketing", "ns_strategy",
              "ns_steps", "period", "comm", "full_schedule")


def build_variant(variant: Union[str, VariantSpec], lr_full, lr_block=None, *,
                  rank: int = 64, **muon_kwargs):
    """Construct the variant's matrix optimizer (Muon family or Dion).

    ``muon_kwargs`` pass through to :func:`repro_torch.core.muon.muon` for the
    Muon-family variants; Dion takes the shared subset and ignores the rest.
    """
    from repro_torch.core.dion import dion as dion_fn
    from repro_torch.core.muon import muon as muon_fn

    spec = get(variant)
    if spec.low_rank:
        kw = {k: v for k, v in muon_kwargs.items() if k in _DION_KEYS}
        return dion_fn(lr_full, rank=rank, **kw)
    return muon_fn(lr_full, lr_block, variant=spec, **muon_kwargs)
