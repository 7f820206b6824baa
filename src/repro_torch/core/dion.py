"""Dion (Ahn et al. 2025) -- low-rank orthonormalized updates baseline.

Counterpart of ``repro/core/dion.py``, single device. Dion keeps a right
basis ``V`` (n x r) per matrix and each step runs one amortized power
iteration:

    B = M + G                      (momentum + fresh gradient)
    P = B V                        (m x r)
    Q = orthonormalize(P)          (polar factor)
    R = B^T Q                      (n x r)
    M <- B - (1 - mu) Q R^T        (error feedback keeps the residual)
    V <- column_normalize(R)
    dX = -lr * scale * Q V^T       (orthonormal low-rank update)

The polar factor of every ``P`` runs through the same compiled
:class:`program.UpdateProgram` as the Muon variants: spectral pre-scale,
then K = 6 NS steps on the small r side with the entry normalization off,
bucketed across leaves. The products around it are plain ``torch.matmul``.
The reference's ``_FactorEngineView`` belongs to its shard_map engine,
which the port does not have.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import newton_schulz
from repro_torch.core import program as program_lib
from repro_torch.core.bucketing import dtype_name
from repro_torch.core.muon import SPECTRAL_MARGIN, Optimizer, _as_schedule


class DionState(NamedTuple):
    momentum: dict  # path -> fp32 (..., m, n)
    basis: dict     # path -> fp32 (..., n, r)
    count: int      # step counter


def _column_normalize(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-2, keepdim=True) + eps)


def init_basis(shape: tuple, rank: int, device) -> torch.Tensor:
    """The column-normalized random start basis ``(..., n, r)`` of a leaf.

    Seeded as the reference seeds it (``n * 1315423911 % 2**31``), drawn from
    a ``torch.Generator`` on the CPU and moved to ``device``. The numbers are
    not the reference's ``jax.random`` ones; tests carry its basis over
    (``interop.opt_state_from_numpy``).
    """
    if len(shape) < 2:
        raise ValueError("dion only manages matrices; use combine()")
    n = shape[-1]
    r = min(rank, min(shape[-2], n))
    gen = torch.Generator().manual_seed(n * 1315423911 % (2**31))
    v = torch.randn((*shape[:-2], n, r), generator=gen, dtype=torch.float32)
    return _column_normalize(v).to(device)


def dion(
    learning_rate,
    *,
    rank: int = 64,
    momentum: float = 0.95,
    weight_decay: float = 0.0,
    rms_target: float = 0.2,
    bucketing: bool = True,
    ns_strategy: Optional[str] = None,
    ns_steps: int = 6,
    period: Optional[int] = None,
    comm=None,
    full_schedule: Optional[str] = None,
) -> Optimizer:
    """Build the Dion low-rank optimizer as a compiled update program.

    ``bucketing``/``ns_strategy``/``ns_steps`` configure the program that
    orthonormalizes the projected factors, as for ``muon``. ``period`` is
    accepted and ignored: Dion runs the same power iteration every step, so
    'block' and 'full' do the same work. ``full_schedule`` accepts
    'barrier'/'pipelined' (with no gathers they are the same) and rejects
    'staggered': a low-rank update has no per-leaf full-step gathers to
    stagger. ``comm`` (a distributed engine) raises: Dion on a mesh of ranks
    needs the reference's ``_FactorEngineView``, which a later slice of the
    port brings.
    """
    if full_schedule is None:
        full_schedule = os.environ.get("REPRO_FULL_SCHEDULE", "pipelined")
    if full_schedule == "staggered":
        raise ValueError("dion has no per-leaf full-step gathers to stagger; use "
                         "full_schedule='pipelined' or 'barrier'")
    if full_schedule not in program_lib.FULL_SCHEDULES:
        raise ValueError(f"full_schedule must be one of {program_lib.FULL_SCHEDULES}, "
                         f"got {full_schedule!r}")
    if comm is not None:
        raise NotImplementedError(
            "Dion on a mesh of ranks (--mesh) needs the reference's _FactorEngineView "
            "(src/repro/core/dion.py), which a later slice of the port brings")
    lr_fn = _as_schedule(learning_rate)
    mu = momentum
    del period
    programs: dict = {}

    def _program_for(leaf_specs: tuple, backend: str) -> program_lib.UpdateProgram:
        key = (leaf_specs, backend)
        if key not in programs:
            programs[key] = program_lib.compile_program(
                leaf_specs, bucketing=bucketing, backend=backend, strategy=ns_strategy,
                ns_steps=ns_steps,
            )
        return programs[key]

    def _orth(u: torch.Tensor, strategy: Optional[str] = None) -> torch.Tensor:
        # Spectral pre-scale: the error feedback keeps B - Q Q^T B in the
        # momentum, so the polar factor must be tight; a Frobenius start
        # puts sigma_max near 1/sqrt(r), where K = 6 would stall.
        sigma = newton_schulz.spectral_norm_est(u).to(u.dtype)
        u = u / (sigma * SPECTRAL_MARGIN + 1e-7)
        return newton_schulz.orthogonalize(u, steps=ns_steps, strategy=strategy,
                                           normalize=False)

    def init(params) -> DionState:
        flat = tree_lib.flatten_with_path(params)
        return DionState(
            momentum={path: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                      for path, p in flat},
            basis={path: init_basis(tuple(p.shape), rank, p.device) for path, p in flat},
            count=0,
        )

    @torch.no_grad()
    def update(grads, state: DionState, params, phase: str = "block"):
        if phase not in ("block", "full"):
            raise ValueError(
                f"dion phases are 'block' and 'full' (identical work), got {phase!r}")
        count = state.count + 1
        lr = float(lr_fn(count))

        flat = tree_lib.flatten_with_path(grads)
        keys = [path for path, _ in flat]
        p_by_key = dict(tree_lib.flatten_with_path(params))
        b_leaves = [state.momentum[k] + g.to(torch.float32) for k, g in flat]
        v_leaves = [state.basis[k] for k in keys]
        p_factors = [b @ v for b, v in zip(b_leaves, v_leaves)]

        leaf_specs = tuple(
            program_lib.LeafSpec(key=k, shape=tuple(pf.shape), dtype=dtype_name(pf.dtype))
            for k, pf in zip(keys, p_factors)
        )
        backend = p_factors[0].device.type if p_factors else "cpu"
        q_leaves = _program_for(leaf_specs, backend).execute(phase, p_factors, _orth)

        upd_items, new_m, new_v = [], {}, {}
        for k, q, b in zip(keys, q_leaves, b_leaves):
            p = p_by_key[k]
            r_mat = b.transpose(-1, -2) @ q                       # (..., n, r)
            new_m[k] = b - (1.0 - mu) * (q @ r_mat.transpose(-1, -2))
            new_v[k] = _column_normalize(r_mat)
            scale = rms_target * float(max(p.shape[-2], p.shape[-1])) ** 0.5
            upd = -lr * scale * (q @ new_v[k].transpose(-1, -2))
            if weight_decay:
                upd = upd - lr * weight_decay * p.to(torch.float32)
            upd_items.append((k, upd.to(p.dtype)))
        return tree_lib.unflatten(upd_items), DionState(momentum=new_m, basis=new_v,
                                                        count=count)

    return Optimizer(init=init, update=update)
