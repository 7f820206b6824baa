"""The collective trace: every collective the port issues, against the plan.

Counterpart of ``repro/distributed/audit.py`` in trace form. The reference
measures its compiler's collective schedule by parsing post-partitioning
HLO; eager PyTorch issues each collective itself, so here every collective
of the engine, the train step and the launcher goes through one wrapper,
:class:`Collectives`, which records a :class:`CollectiveEvent` --
``(phase, kind, axes, link, bytes, stage)`` -- in a
:class:`CollectiveTrace`. Bytes follow the plan's convention: the bytes of
the per-rank *result* buffer (``distributed/plan.py``). The HLO parsers
have no counterpart.

Phases: the plan's three (``'block'``, ``'full'``, ``'apply'``);
``'stagger'``, a step of the staggered schedule (``"stagger:r"``: the
class drops the residue, which each event keeps in ``residue``; the plan
prices it as ``predicted_by_axes('staggered', period=, residue=)``); and
the classes the plan does not price, kept apart: ``'grad_reduce'`` (the
data-parallel gradient all-reduce), ``'tp'`` (the tensor-parallel
forward and backward of ``distributed/tensor_parallel.py`` and the sum of
the replicated leaves' gradients over the model axis; ``plan.tp_bytes``
counts them), ``'norm'`` (the model-axis sums of the global gradient
norms on that path), ``'normuon'`` (NorMuon's row and
RMS sums of sharded leaves), ``'dion'`` (Dion's factor products on
sharded leaves, ``core/dion.py``; ``plan.dion_bytes`` counts them),
``'guard'`` (the guarded step's health flag,
agreed over the whole mesh: 4 B a step) and ``'checkpoint'`` (state
gathered for a snapshot): :data:`PHASES`.
:func:`bytes_by_axes`, :func:`bytes_by_link`, :func:`assert_matches_plan`,
:func:`assert_matches_plan_by_axes`, :func:`assert_pipelined_matches_plan`
and :func:`assert_staggered_matches_plan` read the trace.

The wrapper's groups: one axis is the ``DeviceMesh``'s own group
(``mesh.get_group(name)``); several axes (the ZeRO entry ``('pod',
'data')``, the data-parallel gradient reduce) a group over the ranks that
differ only along those axes, major to minor. A gather concatenates along
dim 0 in group order; a gather of another dim gathers into a new leading
rank dim, moves it next to that dim and merges the two.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.distributed.plan import CommPlan, link_class

GATHER = "all-gather"
REDUCE = "all-reduce"
REDUCE_SCATTER = "reduce-scatter"
# Every phase class the port's own code records (see the module docstring).
PHASES = ("block", "full", "apply", "stagger", "grad_reduce", "tp", "norm", "normuon",
          "dion", "guard", "checkpoint")
STAGGER = "stagger"


def phase_class(phase: str) -> tuple[str, Optional[int]]:
    """The trace class of a program phase and its residue: ``"stagger:3"``
    -> ``('stagger', 3)``, any other phase -> ``(phase, None)``."""
    from repro_torch.core.program import parse_stagger_phase

    residue = parse_stagger_phase(phase)
    return (phase, None) if residue is None else (STAGGER, residue)


@dataclasses.dataclass(frozen=True)
class CollectiveEvent:
    """One collective as issued: its phase class, kind, mesh axes, link
    class, per-rank result bytes, pipeline stage (None outside one), the
    step it ran in, its host wall in seconds (None for an asynchronous
    gather; with the wrapper's ``sync`` set, as under ``--obs-block``, it
    covers the device work before and after too) and, on a staggered step,
    the residue."""

    phase: str
    kind: str
    axes: tuple[str, ...]
    link: str
    bytes: int
    stage: Optional[int] = None
    step: Optional[int] = None
    wall_s: Optional[float] = None
    residue: Optional[int] = None


class CollectiveTrace:
    """The events of one rank, in issue order. ``step`` stamps new events."""

    def __init__(self):
        self.events: list[CollectiveEvent] = []
        self.step: Optional[int] = None

    def record(self, phase: str, kind: str, axes, nbytes: int,
               stage: Optional[int] = None, wall_s: Optional[float] = None,
               residue: Optional[int] = None) -> None:
        axes = tuple(axes)
        self.events.append(CollectiveEvent(phase=phase, kind=kind, axes=axes,
                                           link=link_class(axes), bytes=int(nbytes),
                                           stage=stage, step=self.step, wall_s=wall_s,
                                           residue=residue))

    def wall_s(self, phases=None, *, step: Optional[int] = None) -> float:
        """The summed host wall of the synchronous collectives selected."""
        return sum(e.wall_s for e in self.select(phases, step=step) if e.wall_s is not None)

    def select(self, phases=None, *, step: Optional[int] = None, kinds=None) -> list:
        if isinstance(phases, str):
            phases = (phases,)
        return [e for e in self.events
                if (phases is None or e.phase in phases)
                and (step is None or e.step == step)
                and (kinds is None or e.kind in kinds)]

    def total_bytes(self, phases=None, *, step: Optional[int] = None) -> int:
        return sum(e.bytes for e in self.select(phases, step=step))


class PendingGather:
    """An all-gather in flight; :meth:`wait` returns the gathered tensor."""

    def __init__(self, handle, finish):
        self._handle, self._finish = handle, finish

    def wait(self) -> torch.Tensor:
        if self._handle is not None:
            self._handle.wait()
        return self._finish()


class Collectives:
    """The one wrapper every collective of the port goes through.

    ``mesh`` is a live ``DeviceMesh``; ``trace`` (a new
    :class:`CollectiveTrace`) collects the events.
    Tensors go to the backend where they lie: gloo takes CUDA tensors (it
    copies them through the host), NCCL takes them on each rank's card.
    gloo's reduce-scatter takes CUDA tensors too (torch 2.11 on the H100
    machine; ``tests/test_torch_cuda.py`` holds it). ``sync``, when set,
    runs before and after each synchronous collective, so its recorded wall
    covers the device (the launcher sets it under ``--obs-block``).
    """

    def __init__(self, mesh):
        self.mesh = mesh
        self.sync = None
        self.trace = CollectiveTrace()
        self.axis_names = tuple(mesh.mesh_dim_names)
        # The mesh's ranks as host data, read once: a group is made later,
        # possibly under a FakeTensorMode (launch/dryrun.py).
        self._ranks = np.asarray(mesh.mesh.tolist())
        self.axis_sizes = dict(zip(self.axis_names, self._ranks.shape))
        self.coords = dict(zip(self.axis_names, mesh.get_coordinate()))
        self._groups: dict = {}

    def size(self, axes) -> int:
        return math.prod(self.axis_sizes.get(a, 1) for a in axes)

    def index(self, axes) -> int:
        """This rank's linear index over ``axes``, major to minor."""
        idx = 0
        for a in axes:
            idx = idx * self.axis_sizes.get(a, 1) + self.coords.get(a, 0)
        return idx

    def group(self, axes):
        """The process group of the ranks that differ only along ``axes``."""
        axes = tuple(a for a in self.axis_names if a in axes)
        if axes not in self._groups:
            if len(axes) == 1:
                self._groups[axes] = self.mesh.get_group(axes[0])
            else:
                import torch.distributed as dist

                # Every rank enumerates every group (new_group is collective
                # over the world), in the mesh's row-major rank order.
                nd = self._ranks.ndim
                ranks = np.moveaxis(self._ranks, [self.axis_names.index(a) for a in axes],
                                    list(range(nd - len(axes), nd)))
                lists = ranks.reshape(-1, self.size(axes)).tolist()
                self._groups[axes], _ = dist.new_subgroups_by_enumeration(lists)
        return self._groups[axes]

    def all_gather(self, x: torch.Tensor, axes, *, dim: int = 0, phase: str,
                   stage: Optional[int] = None, async_op: bool = False,
                   residue: Optional[int] = None):
        """Gather ``x`` over ``axes`` along ``dim`` (rank order = the axes'
        linear index, major to minor). With ``async_op`` returns a
        :class:`PendingGather`. ``residue`` is kept on the event of a
        staggered step's gather."""
        import torch.distributed as dist

        axes = tuple(axes)
        k = self.size(axes)
        dim = dim % x.dim()
        src = x.contiguous()
        # The concatenated form (k * rows, ...): gloo refuses the stacked one.
        out = torch.empty((k * src.shape[0], *src.shape[1:]), dtype=src.dtype,
                          device=src.device)
        # all_gather_into_tensor warns that it is deprecated from torch 2.13;
        # all_gather_single is the same call there.
        gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        t0 = self._start()
        handle = gather(out, src, group=self.group(axes), async_op=async_op)
        shape = list(x.shape)
        shape[dim] *= k
        self.trace.record(phase, GATHER, axes, math.prod(shape) * x.element_size(), stage,
                          wall_s=None if async_op else self._wall(t0), residue=residue)

        def finish() -> torch.Tensor:
            return out.view(k, *src.shape).movedim(0, dim).reshape(shape) if dim else out

        if async_op:
            return PendingGather(handle, finish)
        return finish()

    def all_reduce(self, x: torch.Tensor, axes, *, phase: str,
                   stage: Optional[int] = None, op: str = "sum") -> torch.Tensor:
        """Reduce ``x`` in place over ``axes`` (``op`` 'sum', 'max' or 'min');
        returns it."""
        import torch.distributed as dist

        axes = tuple(axes)
        t0 = self._start()
        ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}
        dist.all_reduce(x, op=ops[op], group=self.group(axes))
        self.trace.record(phase, REDUCE, axes, x.numel() * x.element_size(), stage,
                          wall_s=self._wall(t0))
        return x

    def reduce_scatter(self, x: torch.Tensor, axes, *, dim: int = 0,
                       phase: str) -> torch.Tensor:
        """Sum ``x`` over ``axes`` and keep this rank's slice of ``dim`` (the
        axes' linear index, major to minor); ``x`` is left as it was."""
        import torch.distributed as dist

        axes = tuple(axes)
        dim = dim % x.dim()
        n = x.shape[dim] // self.size(axes)
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((n, *src.shape[1:]), dtype=src.dtype, device=src.device)
        # reduce_scatter_tensor warns that it is deprecated from torch 2.13;
        # reduce_scatter_single is the same call there.
        scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor
        t0 = self._start()
        scatter(out, src, group=self.group(axes))
        self.trace.record(phase, REDUCE_SCATTER, axes, out.numel() * out.element_size(),
                          wall_s=self._wall(t0))
        return out.movedim(0, dim)

    def _start(self) -> float:
        if self.sync is not None:
            self.sync()
        return time.perf_counter()

    def _wall(self, t0: float) -> float:
        if self.sync is not None:
            self.sync()
        return time.perf_counter() - t0


def bytes_by_axes(trace: CollectiveTrace, phases, *, kinds=(GATHER,),
                  step: Optional[int] = None) -> dict[tuple[str, ...], int]:
    """Traced bytes per (sorted) mesh-axis set: the keying of
    ``CommPlan.predicted_by_axes``."""
    out: dict[tuple[str, ...], int] = {}
    for e in trace.select(phases, step=step, kinds=kinds):
        key = tuple(sorted(e.axes))
        out[key] = out.get(key, 0) + e.bytes
    return out


def bytes_by_link(trace: CollectiveTrace, phases, *, kinds=(GATHER,),
                  step: Optional[int] = None) -> dict[str, int]:
    """Traced bytes per modeled link class ({'ici': ..., 'dcn': ...})."""
    out = {"ici": 0, "dcn": 0}
    for axes, nbytes in bytes_by_axes(trace, phases, kinds=kinds, step=step).items():
        out[link_class(axes)] += nbytes
    return out


def assert_matches_plan(trace: CollectiveTrace, plan: CommPlan, phase: str, *,
                        step: Optional[int] = None, kinds=(GATHER,)) -> int:
    """The traced bytes of ``phase`` equal the plan's, to the byte.

    Compares the gathers the plan prices. Where the plan predicts none, the
    phase may record no collective of any kind. Returns the traced bytes.
    """
    pred = sum(v["bytes"] for op, v in plan.predicted(phase).items() if op in kinds)
    meas = sum(e.bytes for e in trace.select(phase, step=step, kinds=kinds))
    if meas != pred:
        raise AssertionError(
            f"collective bytes mismatch on {phase!r}: predicted {pred}, traced {meas}\n"
            f"  plan: {plan.predicted(phase)}\n"
            f"  trace: {bytes_by_axes(trace, phase, kinds=kinds, step=step)}")
    if pred == 0 and trace.select(phase, step=step):
        raise AssertionError(f"phase {phase!r} planned zero collectives but the trace holds "
                             f"{trace.select(phase, step=step)}")
    return meas


def assert_matches_plan_by_axes(trace: CollectiveTrace, plan: CommPlan, phases, *,
                                step: Optional[int] = None, kinds=(GATHER,)) -> dict:
    """Traced bytes per axis set equal the plan's for ``phases`` (one name or
    a tuple summed), to the byte. Returns the traced per-axes dict."""
    if isinstance(phases, str):
        phases = (phases,)
    pred: dict[tuple[str, ...], int] = {}
    for phase in phases:
        for axes, nbytes in plan.predicted_by_axes(phase).items():
            pred[axes] = pred.get(axes, 0) + nbytes
    return _assert_axes_bytes_equal(trace, pred, phases, kinds, step,
                                    label=f"phases {phases}")


def _assert_axes_bytes_equal(trace: CollectiveTrace, pred: dict, phases, kinds, step,
                             *, label: str) -> dict:
    meas = bytes_by_axes(trace, phases, kinds=kinds, step=step)
    pred = {k: v for k, v in pred.items() if v}
    if pred != {k: v for k, v in meas.items() if v}:
        raise AssertionError(f"per-axis collective bytes mismatch for {label}:\n"
                             f"  plan: {pred}\n  trace: {meas}")
    return meas


def assert_staggered_matches_plan(trace: CollectiveTrace, plan: CommPlan, *, period: int,
                                  residue: int, step: Optional[int] = None,
                                  include_apply: bool = False, kinds=(GATHER,)) -> dict:
    """One staggered step's traced bytes per axis set equal the plan's
    ``predicted_by_axes('staggered', period=, residue=)``, to the byte.

    The step's ``"stagger:r"`` phase gathers exactly the leaves whose offset
    is ``r`` (``plan.stagger_offsets(period)``, the balancer the program ran)
    and the unblocked sharded ones; ``include_apply`` adds the plan's
    'apply' (the ZeRO-1 writeback gathers run on every step). Every stagger
    event of the step must carry ``residue``. Returns the traced per-axes
    dict.
    """
    pred = dict(plan.predicted_by_axes("staggered", period=period, residue=residue))
    phases: tuple = (STAGGER,)
    if include_apply:
        phases += ("apply",)
        for axes, nbytes in plan.predicted_by_axes("apply").items():
            pred[axes] = pred.get(axes, 0) + nbytes
    wrong = {e.residue for e in trace.select(STAGGER, step=step)} - {residue}
    if wrong:
        raise AssertionError(f"staggered residue {residue}/{period}: the trace holds stagger "
                             f"events of residues {sorted(wrong)}")
    return _assert_axes_bytes_equal(trace, pred, phases, kinds, step,
                                    label=f"staggered residue {residue}/{period}")


def assert_pipelined_matches_plan(trace: CollectiveTrace, prog_phase, plan: CommPlan, *,
                                  phase: str = "full", step: Optional[int] = None) -> dict:
    """A full step's gathers against the plan and the compiled program.

    The reference's check of the same name reads its compiled HLO; here the
    trace. (1) The phase's gather bytes equal ``plan.predicted_bytes(phase)``
    plus the program's bucket-level comm (the layer_shard fold's gathers,
    which the program prices and the leaf-level plan does not), to the byte.
    (2) With a pipeline schedule, each stage's traced gathers equal what
    the stage issues: its leaves' gathers and its compute op's fold. Returns
    the traced bytes by stage (None: outside a stage).
    """
    events = trace.select(phase, step=step, kinds=(GATHER,))
    measured = sum(e.bytes for e in events)
    bucket = sum(b for op in prog_phase.ops if op.comm is not None
                 for kind, _, b in op.comm.collectives if kind == GATHER)
    predicted = plan.predicted_bytes(phase) + bucket
    if measured != predicted:
        raise AssertionError(
            f"{phase!r} gather bytes {measured} != plan {predicted} (leaf "
            f"{plan.predicted_bytes(phase)} + bucket {bucket})\n"
            f"  trace: {bytes_by_axes(trace, phase, step=step)}")
    by_stage: dict = {}
    for e in events:
        by_stage[e.stage] = by_stage.get(e.stage, 0) + e.bytes
    if prog_phase.schedule is not None:
        want = {s.index: s.gather_bytes + s.compute_comm_bytes
                for s in prog_phase.schedule.stages if s.gather_bytes + s.compute_comm_bytes}
        if by_stage != want:
            raise AssertionError(f"{phase!r} gathers by stage {by_stage}, the schedule's {want}")
    return by_stage
