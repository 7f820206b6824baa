"""Muon / BlockMuon / MuonBP -- paper Algorithm 1 as a PyTorch optimizer.

Counterpart of ``repro/core/muon.py`` with its optimizer variants
(``core/variants.py``: Turbo-Muon, NorMuon; Dion is ``core/dion.py``). One
implementation covers all three methods via the period ``P``:

  * ``P = 1``        -> Muon       (full orthogonalization every step)
  * ``P = None``     -> BlockMuon  (block orthogonalization every step)
  * ``P = 5`` (etc.) -> MuonBP     (block for P-1 steps, full every P-th)

The phase ('block' | 'full', or ``"stagger:r"`` under the staggered
schedule) is an argument of ``update``; the launcher picks it per step
with :class:`StaggerSchedule`. ``update`` runs Nesterov
momentum, interprets the compiled :class:`program.UpdateProgram` (one NS
chain per shape bucket through ``kernels.dispatch``), then the two-stepsize
RMS-matched epilogue with decoupled weight decay (Theorem 2, paper
Sec 3.2). The step count is a host integer, so schedules never sync the
device. A variant changes three things: the chain length K, a pre-NS
stage (Turbo-Muon's spectral pre-scale) and a post-NS stage (NorMuon's
row normalization, ``kernels/normuon.py``, refreshed on full steps and,
staggered, on a leaf's due step).

Trees are nested dicts (``repro_torch.tree``); ``None`` leaves are masked
out, as ``core.combine`` hands each sub-optimizer its own parameters.

With ``comm=`` (``distributed.engine.ShardMapEngine``) each rank holds only
its shards: ``init`` allocates the momentum (and NorMuon's row statistics)
in the leaf's momentum spec -- lead-padded under the ZeRO-1 flatten
fallback -- and ``update`` takes the data-reduced gradients as the rank
holds them (its param-layout shards on the tensor-parallel path, the full
tensors on the replicated one), cuts this rank's momentum shard of them
(``engine.shard``), runs the program compiled against the engine on the
leaves' global shapes (block steps on the local shards, full steps through
the engine's gathers) and returns the updates in the momentum layout. The
engine's ``to_param_layout`` (and, replicated, ``replicate``) bring them
back (``training/train_step.py``).
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import newton_schulz
from repro_torch.core import program as program_lib
from repro_torch.core import variants as variants_lib
from repro_torch.core.bucketing import dtype_name
from repro_torch.core.newton_schulz import PAPER_COEFFS
from repro_torch.kernels import normuon as normuon_lib

Schedule = Callable[[int], float]

# Turbo-Muon spectral pre-scale margin: the power-iteration estimate
# converges to sigma_max from below, so dividing by est * margin keeps every
# singular value <= 1 with near-certainty (the NS cubic's basin reaches
# sqrt(3)).
SPECTRAL_MARGIN = 1.01


class OptState(NamedTuple):
    momentum: dict  # path -> fp32 momentum tensor
    count: int      # step counter
    # NorMuon only; None for every other variant, so their state is the
    # two-field state.
    second_moment: Optional[dict] = None  # path -> (..., 1) fp32 row second moments
    vcount: Optional[dict] = None         # path -> host-int refresh counter


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


@dataclasses.dataclass(frozen=True)
class StaggerSchedule:
    """Which compiled phase each training step runs.

    ``mode='synchronous'`` is the paper's Algorithm 1: every leaf goes full
    on the steps where ``step % P == 0`` (:func:`phase_for_step`).
    ``mode='staggered'`` maps step t to the mixed phase
    ``"stagger:{t % P}"``: each Muon leaf carries a residue offset
    (``program.UpdateProgram.stagger_offsets``) and goes full only on its
    own residue, so every step moves about 1/P of the full step's bytes.
    Over any P consecutive steps each leaf still gets P-1 block updates and
    one full update at the full-step LR.
    """

    period: Optional[int]
    mode: str = "synchronous"   # 'synchronous' | 'staggered'

    def __post_init__(self):
        if self.mode not in ("synchronous", "staggered"):
            raise ValueError(f"mode must be 'synchronous' or 'staggered', got {self.mode!r}")
        if self.mode == "staggered" and (self.period is None or self.period < 2):
            raise ValueError(f"staggered schedule needs period >= 2, got {self.period!r}")

    def phase_for(self, step: int) -> str:
        if self.mode == "synchronous":
            return phase_for_step(step, self.period)
        return program_lib.stagger_phase(step % self.period)

    def phases(self) -> tuple[str, ...]:
        """Every phase name this schedule emits."""
        if self.mode == "staggered":
            return tuple(program_lib.stagger_phase(r) for r in range(self.period))
        if self.period is None:
            return ("block",)
        if self.period <= 1:
            return ("full",)
        return ("block", "full")


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
    comm: Optional[Any] = None,
    layer_shard: Optional[tuple] = None,
    full_schedule: Optional[str] = None,
    variant: Any = None,
) -> Optimizer:
    """Build the Muon-family optimizer (paper Algorithm 1).

    Arguments as in the reference. ``block_specs`` is a nested dict of
    :class:`blocking.BlockSpec2D` (or None) matching params;
    ``ns_strategy`` pins every bucket's kernel (``dispatch.STRATEGIES``,
    ``"plain"`` for the plain PyTorch chain; None plans per bucket).
    ``comm`` is the distributed engine (see the module docstring) and
    ``full_schedule`` its full-step schedule, ``"pipelined"`` (the default;
    None reads ``REPRO_FULL_SCHEDULE``), ``"barrier"`` or ``"staggered"``
    (needs ``comm`` and ``period >= 2``; ``update`` then also takes the
    phases ``"stagger:r"``); without an engine the first two have no
    effect. ``layer_shard=(mesh, axis)`` splits the full step's stacks over
    ``axis``, so each rank orthogonalizes only its share of the layers and
    one all-gather over ``axis`` restores each stack (the engine's fold,
    ``core/program.py``); without ``comm`` only an axis of size one is
    accepted, where it changes nothing. ``variant`` is a name of ``core.variants.VARIANTS`` ("muon" |
    "turbo_muon" | "normuon"), a ``VariantSpec``, or None for the baseline;
    a low-rank variant raises ``ValueError`` (build it with
    ``variants.build_variant``).
    """
    vspec = variants_lib.get(variant)
    if vspec.low_rank:
        raise ValueError(
            f"variant {vspec.name!r} is a low-rank program; build it with "
            "core.variants.build_variant (it routes to core.dion)"
        )
    eff_ns_steps = max(1, ns_steps + vspec.ns_steps_delta)
    lr_full_fn = _as_schedule(lr_full)
    lr_block_fn = _as_schedule(lr_block if lr_block is not None else lr_full)
    mu = momentum
    if full_schedule is None:
        full_schedule = os.environ.get("REPRO_FULL_SCHEDULE", "pipelined")
    if full_schedule not in program_lib.FULL_SCHEDULES:
        raise ValueError(f"full_schedule must be one of {program_lib.FULL_SCHEDULES}, "
                         f"got {full_schedule!r}")
    if full_schedule == "staggered":
        if comm is None:
            raise ValueError("full_schedule='staggered' needs comm= (the distributed engine); "
                             "without one there are no per-leaf gathers to stagger")
        if period is None or period < 2:
            raise ValueError(f"full_schedule='staggered' needs period >= 2, got {period!r}")
    bs_by_path = dict(tree_lib.flatten_with_path(block_specs)) if block_specs else {}
    programs: dict = {}

    def _program_for(leaf_specs: tuple, backend: str) -> program_lib.UpdateProgram:
        key = (leaf_specs, backend)
        if key not in programs:
            programs[key] = program_lib.compile_program(
                leaf_specs, bucketing=bucketing, backend=backend, strategy=ns_strategy,
                engine=comm, layer_shard=layer_shard, full_schedule=full_schedule,
                ns_steps=eff_ns_steps,
                stagger_period=period if full_schedule == "staggered" else None,
                precondition=vspec.precondition, epilogue=vspec.epilogue,
            )
        return programs[key]

    def _state_shape(path, shape) -> tuple:
        # Lead-padded under the engine's ZeRO-1 flatten fallback.
        return tuple(shape) if comm is None else comm.state_shape_for(path, tuple(shape))

    def _local(path, x: torch.Tensor) -> torch.Tensor:
        # This rank's momentum-spec shard of a tensor as the rank holds it.
        if comm is None:
            return x
        return comm.shard(path, _pad_lead(x, _state_shape(path, x.shape)[0]))

    def _orth(u: torch.Tensor, strategy: Optional[str] = None) -> torch.Tensor:
        if vspec.precondition == "spectral_scale":
            # Turbo-Muon: divide by the spectral norm instead of the much
            # larger Frobenius norm the chain applies on entry, which lands
            # every singular value near 1 and buys the reduced K.
            sigma = newton_schulz.spectral_norm_est(u).to(u.dtype)
            u = u / (sigma * SPECTRAL_MARGIN + 1e-7)
            return newton_schulz.orthogonalize(
                u, steps=eff_ns_steps, coeffs=ns_coeffs, strategy=strategy, normalize=False
            )
        return newton_schulz.orthogonalize(
            u, steps=eff_ns_steps, coeffs=ns_coeffs, strategy=strategy
        )

    def _shard_shape(path, shape) -> tuple:
        # The momentum shard's shape from the shape the rank holds.
        if comm is None:
            return tuple(shape)
        return comm.local_shape(path, comm.full_shape(path, shape))

    def init(params) -> OptState:
        flat = tree_lib.flatten_with_path(params)
        zeros = lambda shape, p: torch.zeros(shape, dtype=torch.float32, device=p.device)
        second = vcount = None
        if vspec.epilogue == "neuron_norm":
            # One statistic per output neuron (row) of the (padded) state:
            # the shard shape with its last dim collapsed.
            second = {path: zeros(_row_stat_shape(_shard_shape(path, p.shape)), p)
                      for path, p in flat}
            vcount = {path: 0 for path, _ in flat}
        return OptState(momentum={path: zeros(_shard_shape(path, p.shape), p) for path, p in flat},
                        count=0, second_moment=second, vcount=vcount)

    @torch.no_grad()
    def update(grads, state: OptState, params, phase: str = "block"):
        residue = program_lib.parse_stagger_phase(phase)
        if residue is not None:
            if full_schedule != "staggered":
                raise ValueError(f"phase {phase!r} needs full_schedule='staggered', this "
                                 f"optimizer compiled {full_schedule!r}")
            if residue >= period:
                raise ValueError(f"phase {phase!r} out of range for period {period}")
        elif phase not in ("block", "full"):
            raise ValueError(f"phase must be 'block', 'full' or 'stagger:<r>', got {phase!r}")
        count = state.count + 1
        lr_f = float(lr_full_fn(count))
        lr = lr_f if phase == "full" else float(lr_block_fn(count))

        flat = tree_lib.flatten_with_path(grads)
        keys = [path for path, _ in flat]
        full_shapes = [tuple(g.shape) if comm is None else comm.full_shape(k, g.shape)
                       for k, g in flat]
        g_leaves = [_local(k, g.to(torch.float32)) for k, g in flat]
        m_leaves = [mu * state.momentum[k] + g for k, g in zip(keys, g_leaves)]
        p_by_key = dict(tree_lib.flatten_with_path(params))
        p_leaves = [p_by_key[k] for k in keys]
        u_leaves = [g + mu * m for g, m in zip(g_leaves, m_leaves)] if nesterov else m_leaves

        # The program is compiled on the (padded) global state shapes; with
        # an engine it runs on this rank's shards of them.
        leaf_specs = tuple(
            program_lib.LeafSpec(
                key=k, shape=_state_shape(k, shape), dtype=dtype_name(u.dtype),
                block=bs_by_path.get(k),
            )
            for k, shape, u in zip(keys, full_shapes, u_leaves)
        )
        backend = u_leaves[0].device.type if u_leaves else "cpu"
        program = _program_for(leaf_specs, backend)
        o_leaves = program.execute(phase, u_leaves, _orth)
        prog_phase = program.phase(phase)
        due = frozenset(prog_phase.due or ())

        # NorMuon: the row statistics refresh on full steps and on a
        # staggered step's due leaves only (whole after their gather); every
        # step applies them.
        new_second, new_vcount = state.second_moment, state.vcount
        if vspec.epilogue == "neuron_norm":
            new_second, new_vcount = dict(new_second), dict(new_vcount)
            for i, k in enumerate(keys):
                if o_leaves[i].dim() < 2:
                    continue
                o_leaves[i], new_second[k], new_vcount[k] = normuon_lib.apply_neuron_norm(
                    o_leaves[i], new_second[k], new_vcount[k], beta2=vspec.beta2,
                    eps=vspec.stat_eps, refresh=phase == "full" or i in due,
                    reduce=_shard_reduce(comm, k, full_shapes[i]),
                )

        # The two-stepsize rule a leaf: on a staggered step the due leaves
        # (orthogonalized whole) take the full-step LR, the rest the block LR.
        upd_items = []
        for i, (k, o, p) in enumerate(zip(keys, o_leaves, p_leaves)):
            m_eff, n_eff = prog_phase.eff_dims(i)
            scale = _rms_scale(m_eff, n_eff, rms_target) if rms_match else 1.0
            lr_i = lr_f if i in due else lr
            upd = -lr_i * scale * o
            if weight_decay:
                upd = upd - lr_i * weight_decay * _local(k, p.to(torch.float32))
            upd_items.append((k, upd.to(p.dtype)))
        new_m = dict(zip(keys, m_leaves))
        return tree_lib.unflatten(upd_items), OptState(
            momentum=new_m, count=count, second_moment=new_second, vcount=new_vcount)

    return Optimizer(init=init, update=update)


def _pad_lead(x: torch.Tensor, lead: int) -> torch.Tensor:
    """``x`` zero-padded on its lead dim to ``lead`` rows (the ZeRO-1 flatten
    fallback's padded layers, which stay exactly zero)."""
    if x.dim() == 0 or x.shape[0] == lead:
        return x
    return torch.cat([x, x.new_zeros((lead - x.shape[0], *x.shape[1:]))])


def _row_stat_shape(shape: tuple) -> tuple:
    """NorMuon's row statistics: one per output neuron (row), the shape with
    its last dim collapsed; sub-matrix leaves keep theirs (skipped)."""
    return tuple(shape[:-1]) + (1,) if len(shape) >= 2 else tuple(shape)


def _shard_reduce(comm, key, shape: tuple):
    """NorMuon's sums over a leaf sharded by the engine, or None."""
    if comm is None or not comm.is_sharded(key, len(shape)):
        return None
    ndim = len(shape)
    return normuon_lib.ShardReduce(
        rows=(lambda t: comm.row_sum(key, t)) if comm.rows_split(key, ndim) else None,
        total=lambda t: comm.leaf_sum(key, t, ndim),
        n=int(shape[-1]), numel=int(math.prod(shape)))


def block_muon(lr_block, **kw) -> Optimizer:
    """BlockMuon (Boreiko et al. 2025) = Algorithm 1 with P = infinity."""
    kw.pop("period", None)
    return muon(lr_block, lr_block, period=None, **kw)


def muon_full(lr, **kw) -> Optimizer:
    """Baseline Muon (Jordan et al. 2024) = Algorithm 1 with P = 1."""
    kw.pop("period", None)
    return muon(lr, lr, period=1, **kw)
