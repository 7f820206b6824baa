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

With ``comm=`` (``distributed.engine.ShardMapEngine``, under ``--mesh``)
the program compiles against :class:`_FactorEngineView`, as the
reference's: the factors are small and whole on every rank of their
group, so the program gathers nothing on either phase and block equals
full. Each rank keeps its momentum shard in the leaf's momentum layout and
the basis ``V (..., n, r)`` split on ``n`` wherever the momentum splits
its columns (a lead split, ZeRO-1's layers, cuts both alike). The
reference leaves the products to GSPMD; here they run on the shard ``B_s``
of ``B`` with their collectives written out, in the trace class
``'dion'``:

* columns split: ``P = sum_s B_s V_s``, one all-reduce of ``(m, r)``;
  ``R_s = B_s^T Q`` is local; the column norms of ``R`` take one
  all-reduce of the ``(r,)`` sums of squares;
* rows split: ``P`` is one all-gather of the ``(m/k, r)`` rows;
  ``R = sum_s B_s^T Q_s`` one all-reduce of ``(n, r)``.

The error feedback ``M <- B - (1 - mu) Q R^T`` and the update ``Q V^T``
are computed on the shard, so no collective moves a parameter-sized
buffer: about ``(m + n) r`` fp32 a matrix (``distributed.plan.dion_bytes``).
The updates leave in the momentum layout, and the engine's 'apply' gathers
bring them to the param layout, as for MuonBP.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import newton_schulz
from repro_torch.core import program as program_lib
from repro_torch.core.bucketing import dtype_name
from repro_torch.core.muon import SPECTRAL_MARGIN, Optimizer, _as_schedule, _pad_lead


PHASE = "dion"


class DionState(NamedTuple):
    momentum: dict  # path -> fp32 (..., m, n), the momentum shard under an engine
    basis: dict     # path -> fp32 (..., n, r), split on n as the momentum's columns
    count: int      # step counter


class _FactorEngineView:
    """The engine view the factor program compiles against (the reference's
    ``_FactorEngineView``): every factor's spec replicated and no flatten
    fallback, so the program has no gathers on either phase; it still runs
    through the engine's ``run_program`` (its stage spans)."""

    def __init__(self, inner):
        self.inner = inner

    @property
    def axis_sizes(self):
        return self.inner.axis_sizes

    def spec_for(self, key, ndim: int) -> tuple:
        return (None,) * ndim

    def flatten_for(self, key):
        return None

    def run_program(self, prog, leaves, orth):
        return self.inner.run_program(prog, leaves, orth)


def _split_axes(comm, key, ndim: int) -> tuple[tuple, tuple]:
    """The mesh axes (larger than one) that split the rows and the columns
    of the leaf's momentum layout; none without an engine."""
    from repro_torch.sharding.specs import spec_entry_names

    if comm is None:
        return (), ()
    spec = comm.spec_for(key, ndim)
    live = lambda entry: tuple(a for a in spec_entry_names(entry)
                               if comm.axis_sizes.get(a, 1) > 1)
    return live(spec[-2]), live(spec[-1])


def basis_spec(momentum_spec: tuple) -> tuple:
    """The basis' layout from its leaf's momentum layout: the lead entries,
    then ``n`` split as the columns, ``r`` whole."""
    return (*momentum_spec[:-2], momentum_spec[-1], None)


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
    stagger. ``comm`` is the distributed engine (see the module docstring).
    """
    if full_schedule is None:
        full_schedule = os.environ.get("REPRO_FULL_SCHEDULE", "pipelined")
    if full_schedule == "staggered":
        raise ValueError("dion has no per-leaf full-step gathers to stagger; use "
                         "full_schedule='pipelined' or 'barrier'")
    if full_schedule not in program_lib.FULL_SCHEDULES:
        raise ValueError(f"full_schedule must be one of {program_lib.FULL_SCHEDULES}, "
                         f"got {full_schedule!r}")
    lr_fn = _as_schedule(learning_rate)
    mu = momentum
    del period
    view = _FactorEngineView(comm) if comm is not None else None
    programs: dict = {}

    def _program_for(leaf_specs: tuple, backend: str) -> program_lib.UpdateProgram:
        key = (leaf_specs, backend)
        if key not in programs:
            programs[key] = program_lib.compile_program(
                leaf_specs, bucketing=bucketing, backend=backend, strategy=ns_strategy,
                engine=view, full_schedule=full_schedule, ns_steps=ns_steps,
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

    def _local(path, x: torch.Tensor) -> torch.Tensor:
        # This rank's momentum-layout shard of a tensor as the rank holds it.
        if comm is None:
            return x
        return comm.shard(path, _pad_lead(x, comm.state_shape_for(
            path, comm.full_shape(path, x.shape))[0]))

    def init(params) -> DionState:
        momentum, basis = {}, {}
        for path, p in tree_lib.flatten_with_path(params):
            if comm is None:
                momentum[path] = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                basis[path] = init_basis(tuple(p.shape), rank, p.device)
                continue
            state = comm.state_shape_for(path, comm.full_shape(path, p.shape))
            momentum[path] = torch.zeros(comm.local_shape(path, state), dtype=torch.float32,
                                         device=p.device)
            # The whole basis from its seed, then this rank's shard of it.
            whole = init_basis(state, rank, p.device)
            basis[path] = comm.cut(whole, basis_spec(comm.spec_for(path, len(state)))).clone()
        return DionState(momentum=momentum, basis=basis, count=0)

    def _factor_p(key, b, v):
        """P of ``B V``, whole on every rank of the leaf's group."""
        rows, cols = _split_axes(comm, key, b.dim())
        p = b @ v
        if cols:
            p = comm.comm.all_reduce(p, cols, phase=PHASE)
        if rows:
            p = comm.comm.all_gather(p, rows, dim=-2, phase=PHASE)
        return p

    def _power_step(key, q, b):
        """(Q's rows of the shard, R's shard, the new basis shard)."""
        rows, cols = _split_axes(comm, key, b.dim())
        if rows:
            m_local = b.shape[-2]
            q = q.narrow(-2, comm.comm.index(rows) * m_local, m_local)
        r_mat = b.transpose(-1, -2) @ q                           # (..., n, r)
        if rows:
            r_mat = comm.comm.all_reduce(r_mat, rows, phase=PHASE)
        if not cols:
            return q, r_mat, _column_normalize(r_mat)
        sq = comm.comm.all_reduce(torch.sum(r_mat * r_mat, dim=-2, keepdim=True), cols,
                                  phase=PHASE)
        return q, r_mat, r_mat / (torch.sqrt(sq) + 1e-8)

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
        full_shapes = [tuple(g.shape) if comm is None else comm.full_shape(k, g.shape)
                       for k, g in flat]
        b_leaves = [state.momentum[k] + _local(k, g.to(torch.float32)) for k, g in flat]
        p_factors = [_factor_p(k, b, state.basis[k]) for k, b in zip(keys, b_leaves)]

        leaf_specs = tuple(
            program_lib.LeafSpec(key=k, shape=tuple(pf.shape), dtype=dtype_name(pf.dtype))
            for k, pf in zip(keys, p_factors)
        )
        backend = p_factors[0].device.type if p_factors else "cpu"
        q_leaves = _program_for(leaf_specs, backend).execute(phase, p_factors, _orth)

        upd_items, new_m, new_v = [], {}, {}
        for k, q, b, shape in zip(keys, q_leaves, b_leaves, full_shapes):
            p = p_by_key[k]
            q, r_mat, new_v[k] = _power_step(k, q, b)
            new_m[k] = b - (1.0 - mu) * (q @ r_mat.transpose(-1, -2))
            scale = rms_target * float(max(shape[-2], shape[-1])) ** 0.5
            upd = -lr * scale * (q @ new_v[k].transpose(-1, -2))
            if weight_decay:
                upd = upd - lr * weight_decay * _local(k, p.to(torch.float32))
            upd_items.append((k, upd.to(p.dtype)))
        return tree_lib.unflatten(upd_items), DionState(momentum=new_m, basis=new_v,
                                                        count=count)

    return Optimizer(init=init, update=update)
