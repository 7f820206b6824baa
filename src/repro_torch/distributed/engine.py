"""Explicitly scheduled distributed execution of the MuonBP update.

Counterpart of ``repro/distributed/engine.py``. The reference runs each
update inside one ``jax.shard_map`` region whose collectives it writes by
hand; here every rank is a process holding only its own shards, so the
same schedule is eager code over ``torch.distributed`` groups, and every
collective goes through ``distributed.audit.Collectives`` into the trace.
The name :class:`ShardMapEngine` is kept: it is the reference engine's
counterpart, not a ``shard_map``.

  * **block phase** -- a rank's shard *is* its MuonBP block (paper Sec 3:
    "block = the shard on one device"): Newton-Schulz runs on the local
    shard with zero collectives. Leaves whose block grid is finer than
    their shard grid (a replicated param carrying a block spec) are
    blocked by the residual factor locally.
  * **full phase** -- per sharded leaf: all-gather the momentum shards over
    the trailing-dim model axes (minor axis first within an entry), run the
    full NS redundantly on every rank of the group, slice the local shard
    back out (local). With the program's compiled
    :class:`program.PipelineSchedule` (``full_schedule='pipelined'``, the
    default) bucket i+1's gathers are issued asynchronously before bucket
    i's NS, so at most two buckets' gathered momentum is live; the barrier
    body gathers all, orthogonalizes all, writes back all.

All decisions are made at compile time: ``core/program.py`` builds the
engine-mode program from this engine's momentum specs (gather CommOps,
residual block grids, local bucket shapes), and :meth:`run_program` only
executes one phase of it. Each stage runs in a span
``muonbp.<phase>.s<i>.<gather|ns|writeback>`` (a ``torch.profiler`` region
too), as the reference's named scopes.

ZeRO-1: the engine's specs are the *momentum* specs
(``sharding.specs.momentum_spec``), so a data-split lead dim makes the
local NS batch smaller. When ``num_layers`` does not divide the ZeRO axes,
the flatten fallback (``zero1_flatten=True``) stores the momentum lead-
padded and split. Updates leave :meth:`run_program` (and the optimizer's
epilogue, which works on each rank's own layers) in the momentum layout;
:meth:`to_param_layout` then runs the plan's 'apply' gathers -- one over
the ZeRO axes, or the flatten fallback's per-axis gathers and the pad
slice -- and :meth:`replicate` the replica gather over the model axes.

The parameters and gradients a rank holds come in one of two layouts
(``sharding.specs.mesh_path``). On the tensor-parallel path
(``tensor_parallel=True``, the dense and MoE models) they are the rank's
param-layout shards, which the model computes with: :meth:`shard` cuts
them over the axes the momentum spec adds (ZeRO-1's), the 'apply' gathers
bring updates back to that layout, and nothing is replicated. On the
replicated path every rank runs the whole model on its slice of the batch,
with full parameters and data-reduced full gradients: :meth:`shard` cuts
the full tensor (a flatten leaf's lead dim zero-padded first) to the
momentum spec, and :meth:`replicate` pays the replica gather.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch import tree as tree_lib
from repro_torch.core import program as program_lib
from repro_torch.obs import get_bus, span, stage_scope
from repro_torch.sharding import specs as sh
from repro_torch.sharding.specs import spec_entries
from repro_torch.sharding.specs import spec_entry_names as _names
from repro_torch.sharding.specs import spec_entry_size as _factor

PathKey = tuple[str, ...]


@dataclasses.dataclass
class ShardMapEngine:
    """Executor of compiled MuonBP update programs on one mesh of ranks.

    ``uspec_by_path`` maps param paths to the *momentum* spec of the leaf
    (param spec plus ZeRO-1's lead-dim split), ``pspec_by_path`` to its
    param spec and ``flatten_by_path`` to the ``FlattenSpec`` of flatten-
    fallback leaves. ``mesh`` is a ``DeviceMesh``, or an ``{axis: size}``
    dict for a program compiled and priced without ranks; ``comm`` (the
    collective wrapper) is None then, and running raises. The wrapper's
    ``sync``, when set, also runs at the end of each stage span (device
    completion). ``tensor_parallel``: the ranks hold param-layout shards
    (see the module docstring); ``sharding.specs.make_ctx`` reads it.
    """

    mesh: Any
    uspec_by_path: dict
    pspec_by_path: dict = dataclasses.field(default_factory=dict)
    flatten_by_path: dict = dataclasses.field(default_factory=dict)
    comm: Any = None
    tensor_parallel: bool = False

    @property
    def axis_sizes(self) -> dict[str, int]:
        return sh.mesh_axis_sizes(self.mesh)

    def spec_for(self, key: PathKey, ndim: int) -> tuple:
        return tuple(spec_entries(self.uspec_by_path.get(tuple(key)), ndim)[:ndim])

    def flatten_for(self, key: PathKey):
        """FlattenSpec of a ZeRO-1 flatten-fallback leaf, or None."""
        return self.flatten_by_path.get(tuple(key))

    def state_shape_for(self, key: PathKey, shape: tuple) -> tuple:
        """Momentum / NS-input shape of a leaf: lead-padded under the flatten
        fallback, the param shape otherwise."""
        fl = self.flatten_by_path.get(tuple(key))
        return tuple(shape) if fl is None else fl.padded_shape(shape)

    def local_shape(self, key: PathKey, shape: tuple) -> tuple:
        """This rank's shard shape of the leaf's state (``shape``: the
        leaf's global shape)."""
        full = self.state_shape_for(key, shape)
        return sh.local_shape(self.spec_for(key, len(full)), full, self.axis_sizes)

    def full_shape(self, key: PathKey, shape) -> tuple:
        """A leaf's global shape from the shape a rank holds: its param-layout
        shard on the tensor-parallel path, the whole leaf otherwise."""
        if not self.tensor_parallel:
            return tuple(shape)
        spec = spec_entries(self.pspec_by_path.get(tuple(key)), len(shape))
        return tuple(d * _factor(e, self.axis_sizes) for d, e in zip(shape, spec))

    def model_split(self, key: PathKey, ndim: int) -> bool:
        """Whether the leaf's param spec splits it over the model axis."""
        spec = spec_entries(self.pspec_by_path.get(tuple(key)), ndim)
        return any(sh.MODEL_AXIS in _names(e) and self.axis_sizes.get(sh.MODEL_AXIS, 1) > 1
                   for e in spec)

    @torch.no_grad()
    def global_sq_sum(self, items) -> torch.Tensor:
        """The sum of squares over ``(key, tensor)`` leaves as the rank holds
        them, over the whole model: on the tensor-parallel path a leaf split
        over the model axis adds its shard's part, summed over that axis
        (one all-reduce, phase ``'norm'``); the replicated leaves count once.
        On the replicated path, the plain sum."""
        items = list(items)
        sq = lambda t: torch.sum(t.to(torch.float32) ** 2)
        if not self.tensor_parallel:
            return sum(sq(t) for _, t in items)
        split = [sq(t) for k, t in items if self.model_split(k, t.dim())]
        whole = [sq(t) for k, t in items if not self.model_split(k, t.dim())]
        total = sum(whole) if whole else None
        if split:
            part = self._comm().all_reduce(torch.stack(split).sum(), (sh.MODEL_AXIS,),
                                           phase="norm")
            total = part if total is None else total + part
        return total

    # -- cutting and gathering ------------------------------------------------

    def _comm(self):
        if self.comm is None:
            raise RuntimeError("this engine has no ranks (built on an axis-size dict); "
                               "build it on a DeviceMesh to run it")
        return self.comm

    def _slice(self, x: torch.Tensor, spec, dims) -> torch.Tensor:
        comm = self._comm()
        entries = spec_entries(spec, x.dim())
        for dim in dims:
            names = _names(entries[dim])
            factor = _factor(entries[dim], self.axis_sizes)
            if factor > 1:
                local = x.shape[dim] // factor
                x = x.narrow(dim, comm.index(names) * local, local)
        return x

    def _gather(self, x: torch.Tensor, spec, dims, *, phase: str,
                stage: Optional[int] = None) -> torch.Tensor:
        """Gather ``dims`` (in order) one mesh axis at a time, minor axis
        first within an entry, so the concatenation reproduces the entry's
        major-to-minor layout."""
        comm = self._comm()
        entries = spec_entries(spec, x.dim())
        for dim in dims:
            for name in reversed(_names(entries[dim])):
                if self.axis_sizes.get(name, 1) > 1:
                    x = comm.all_gather(x, (name,), dim=dim, phase=phase, stage=stage)
        return x

    def shard(self, key: PathKey, x: torch.Tensor) -> torch.Tensor:
        """This rank's momentum-spec shard of a gradient or parameter as the
        rank holds it (a flatten leaf's lead dim already padded,
        ``muon._pad_lead``): the full tensor on the replicated path; on the
        tensor-parallel path its param-layout shard, cut over the axes the
        momentum spec adds."""
        spec = self.spec_for(key, x.dim())
        if self.tensor_parallel:
            pspec = spec_entries(self.pspec_by_path.get(tuple(key)), x.dim())
            spec = tuple(None if p is not None else u for u, p in zip(spec, pspec))
        return self.cut(x, spec)

    def cut(self, x: torch.Tensor, spec) -> torch.Tensor:
        """This rank's shard of a full tensor laid out by ``spec``."""
        return self._slice(x, spec, range(x.dim()))

    def join(self, x: torch.Tensor, spec, *, phase: str = "checkpoint") -> torch.Tensor:
        """The full tensor from every rank's ``spec`` shard (every rank gets it)."""
        return self._gather(x, spec, range(x.dim()), phase=phase)

    def to_param_layout(self, key: PathKey, u: torch.Tensor) -> torch.Tensor:
        """The plan's 'apply': a momentum-layout update into the param layout.

        A ZeRO-1 lead split is undone by one all-gather over the ZeRO entry's
        axes (one group); a flatten leaf's by one gather per ZeRO axis,
        minor first, and the pad slice.
        """
        key = tuple(key)
        if u.dim() == 0:
            return u
        fl = self.flatten_for(key)
        uspec = self.spec_for(key, u.dim())
        if fl is not None:
            u = self._gather(u, uspec, [0], phase="apply")
            return u[:fl.lead]
        pspec = spec_entries(self.pspec_by_path.get(key), u.dim())
        if uspec[0] != pspec[0] and _factor(uspec[0], self.axis_sizes) > 1:
            u = self._comm().all_gather(u, _names(uspec[0]), dim=0, phase="apply")
        return u

    def replicate(self, key: PathKey, u: torch.Tensor) -> torch.Tensor:
        """The replica gather (the replicated path only): a param-layout
        tensor gathered over its model-sharded dims into the full tensor
        every rank holds."""
        if u.dim() == 0:
            return u
        return self._gather(u, self.pspec_by_path.get(tuple(key)), range(u.dim()),
                            phase="replica_gather")

    # -- NorMuon's sums over sharded leaves ------------------------------------

    def row_sum(self, key: PathKey, t: torch.Tensor) -> torch.Tensor:
        """Sum of per-row partial sums over the ranks sharing the rows (the
        last dim's axes)."""
        axes = _names(self.spec_for(key, t.dim())[-1])
        return self._reduce(t, axes)

    def leaf_sum(self, key: PathKey, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """Sum of per-shard partial sums over every axis sharding the leaf."""
        axes = tuple(a for e in self.spec_for(key, ndim) for a in _names(e))
        return self._reduce(t, axes)

    def _reduce(self, t: torch.Tensor, axes) -> torch.Tensor:
        axes = tuple(a for a in axes if self.axis_sizes.get(a, 1) > 1)
        if not axes:
            return t
        return self._comm().all_reduce(t, axes, phase="normuon")

    def is_sharded(self, key: PathKey, ndim: int) -> bool:
        return any(_factor(e, self.axis_sizes) > 1 for e in self.spec_for(key, ndim))

    def rows_split(self, key: PathKey, ndim: int) -> bool:
        """Whether the leaf's rows (its last dim) are split across ranks."""
        return _factor(self.spec_for(key, ndim)[-1], self.axis_sizes) > 1

    # -- the program ------------------------------------------------------------

    @contextlib.contextmanager
    def _scope(self, name: str):
        """A stage's span on the bus and its ``torch.profiler`` region."""
        sync = None if self.comm is None else self.comm.sync
        with span(get_bus(), name, sync=sync), stage_scope(name):
            yield

    def run_program(self, prog, u_leaves: Sequence[torch.Tensor], orth: Callable) -> list:
        """Execute one compiled phase on this rank's shards.

        Returns the orthogonalized leaves in the momentum layout. With a
        :class:`program.PipelineSchedule` the stages run in order: issue
        bucket i+1's gathers (asynchronous), orthogonalize bucket i once its
        gathers are in, slice bucket i-1 back. Without one: gather all, NS
        all, write back all.
        """
        if not u_leaves:
            return []
        leaf_execs = prog.leaf_execs
        phase = prog.phase
        trailing = lambda x: (x.dim() - 2, x.dim() - 1)

        def gather(x, le, stage=None):
            return self._gather(x, le.spec, trailing(x), phase=phase, stage=stage)

        def writeback(o, le):
            return self._slice(o, le.spec, trailing(o)) if le.gather is not None else o

        if prog.schedule is None:
            with self._scope(f"muonbp.{phase}.gather"):
                ins = [gather(x, le) if le.gather is not None else x
                       for x, le in zip(u_leaves, leaf_execs)]
            with self._scope(f"muonbp.{phase}.ns"):
                outs = program_lib.execute_ops(prog.ops, ins, orth)
            del ins
            with self._scope(f"muonbp.{phase}.writeback"):
                return [writeback(o, le) for o, le in zip(outs, leaf_execs)]

        results: list = [None] * len(u_leaves)
        pending: dict = {}    # leaf index -> NS output awaiting writeback
        in_flight: dict = {}  # leaf index -> _TrailingGather
        for stage in prog.schedule.stages:
            with self._scope(f"muonbp.{phase}.s{stage.index}.gather"):
                for li in stage.gathers:
                    in_flight[li] = _TrailingGather(self, u_leaves[li], leaf_execs[li],
                                                    phase, stage.index)
            if stage.compute is not None:
                op = prog.ops[stage.compute]
                with self._scope(f"muonbp.{phase}.s{stage.index}.ns"):
                    ins = list(u_leaves)
                    for le in op.leaves:
                        if le.index in in_flight:
                            ins[le.index] = in_flight.pop(le.index).wait()
                    for idx, out in program_lib.execute_op(op, ins, orth):
                        pending[idx] = out
                    del ins
            with self._scope(f"muonbp.{phase}.s{stage.index}.writeback"):
                for li in stage.writeback:
                    results[li] = writeback(pending.pop(li), leaf_execs[li])
        if pending or in_flight or any(r is None for r in results):
            raise AssertionError("pipeline schedule left leaves unwritten")
        return results


class _TrailingGather:
    """A leaf's trailing-dim gathers, the first issued asynchronously; the
    rest (a second axis or dim) follow when the result is waited for."""

    def __init__(self, engine: ShardMapEngine, x: torch.Tensor, le, phase: str, stage: int):
        entries = spec_entries(le.spec, x.dim())
        self.steps = [(dim, name) for dim in (x.dim() - 2, x.dim() - 1)
                      for name in reversed(_names(entries[dim]))
                      if engine.axis_sizes.get(name, 1) > 1]
        self.engine, self.phase, self.stage = engine, phase, stage
        self.first = None
        if self.steps:
            dim, name = self.steps[0]
            self.first = engine.comm.all_gather(x, (name,), dim=dim, phase=phase,
                                                stage=stage, async_op=True)
        self.x = x

    def wait(self) -> torch.Tensor:
        if self.first is None:
            return self.x
        x = self.first.wait()
        for dim, name in self.steps[1:]:
            x = self.engine.comm.all_gather(x, (name,), dim=dim, phase=self.phase,
                                            stage=self.stage)
        return x


def make_engine(params: Any, pspecs: Any, mesh, *, zero1: bool = False, zero1_axis=None,
                zero1_flatten: bool = False, tensor_parallel: bool = False) -> ShardMapEngine:
    """Build a :class:`ShardMapEngine` from the param tree and its specs.

    ``params`` may be tensors or anything with ``.shape``. With ``zero1``
    the momentum specs carry ZeRO-1's lead-dim split
    (``sharding.specs.momentum_spec``), over ``zero1_axis`` (a name, a
    tuple, or None for the mesh's data axes); with ``zero1_flatten`` leaves
    whose lead dim does not divide the ZeRO axes take the flatten fallback.
    Each leaf's label (``core.combine.default_label_fn``) picks its ZeRO-1
    rule: unlike the reference's engine, which serves the Muon leaves only,
    this one also holds the AdamW state's shards. On a ``DeviceMesh`` the
    engine gets a new ``audit.Collectives``, whose trace records every
    collective it issues. ``params`` have the global shapes; ``tensor_parallel`` says the
    ranks will hold their param-layout shards of them.
    """
    from repro_torch.core.combine import default_label_fn
    from repro_torch.distributed.audit import Collectives

    sizes = sh.mesh_axis_sizes(mesh)
    axes = sh.zero1_axes(sizes, zero1_axis)
    flat_p = tree_lib.flatten_with_path(params)
    spec_by_path = dict(tree_lib.flatten_with_path(pspecs))
    label_by_path = {p: default_label_fn(sh.path_str(p), leaf) for p, leaf in flat_p}
    uspecs: dict = {}
    pspec_out: dict = {}
    flatten: dict = {}
    for path, leaf in flat_p:
        if path not in spec_by_path:
            raise ValueError(f"no spec for param {sh.path_str(path)}")
        spec, shape, label = spec_by_path[path], tuple(leaf.shape), label_by_path[path]
        pspec_out[path] = tuple(spec_entries(spec, len(shape)))
        fl = (sh.zero1_flatten_info(spec, shape, sizes, zero1_axis=axes, label=label)
              if zero1 and zero1_flatten else None)
        if fl is not None:
            flatten[path] = fl
            uspecs[path] = sh.flatten_momentum_spec(spec, shape, fl)
        else:
            uspecs[path] = sh.momentum_spec(spec, shape, sizes, zero1=zero1, zero1_axis=axes,
                                            label=label)
    comm = None if isinstance(mesh, dict) else Collectives(mesh)
    return ShardMapEngine(mesh=mesh, uspec_by_path=uspecs, pspec_by_path=pspec_out,
                          flatten_by_path=flatten, comm=comm, tensor_parallel=tensor_parallel)
