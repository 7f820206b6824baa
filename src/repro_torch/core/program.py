"""UpdateProgram: the MuonBP update compiled once, interpreted every step.

Counterpart of ``repro/core/program.py``. From static leaf information
(shapes, dtypes, block grids, and with a distributed engine its momentum
specs) the compiler fixes, per phase, the ordered list of
:class:`BucketOp`\\ s -- pack -> orthogonalize (kernel plan) -> unpack --
and each leaf's RMS-matching effective dims, so ``muon.update`` merely
interprets the program.

Without an engine, full phases pack in ``concat`` mode and block phases in
``stack`` mode, as the reference's single-device (GSPMD) compiler does, so
bucket keys, packed shapes and effective dims match the reference leaf for
leaf. With an engine (``distributed/engine.py``), the program is planned on
each rank's local shard shapes, as the reference's ``_compile_phase_engine``:
everything is rank-local, so every bucket concat-packs one batched NS chain
per distinct local unit shape; a leaf that must be whole for NS carries a
``gather`` :class:`CommOp` (full steps, and sharded leaves with no usable
block grid), a ZeRO-1 flatten-fallback leaf an ``apply`` CommOp, each
priced in ``distributed/plan.py``'s result-buffer convention; and the full
phase compiles a :class:`PipelineSchedule` (``full_schedule='pipelined'``):
stage ``s`` gathers bucket ``s``, orthogonalizes bucket ``s-1`` and slices
bucket ``s-2`` back. Each bucket's :class:`KernelPlan` records the strategy
``dispatch.plan_strategy`` chose for the packed shape at compile time.

``full_schedule='staggered'`` (engine mode, ``stagger_period`` P >= 2)
also compiles one mixed phase per step residue, ``"stagger:0"`` ..
``"stagger:P-1"``, into the same program: each leaf carries a residue
offset (``distributed.plan.assign_stagger_offsets`` over its gather's
bytes, the plan's own balancer), and in phase ``"stagger:r"`` the leaves
due at ``r`` gather and orthogonalize whole while every other leaf takes
its block path, under one pipeline schedule over the due buckets.

``layer_shard=(mesh, axis)`` splits each full-step stack over ``axis`` so
that a rank orthogonalizes only its share of the layers: with an engine, a
``layer_shard`` :class:`CommOp` on each full-phase bucket whose packed
stack has a lead dim (the engine's fold: a local slice of the padded stack,
NS on the share, one all-gather over ``axis``; ``plan.layer_shard_dims``
pads it, ``plan.layer_shard_collectives(mode='engine')`` prices it). A
bucket whose leaves ZeRO-1 already splits over ``axis`` keeps its layers
whole, and no 2-D leaf or block phase is ever folded. The reference also
re-shards without an engine, through its compiler's partitioner; the port
has none, so without an engine only an axis of size one compiles (the op
is then numerically inert) and a larger one raises.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core import blocking
from repro_torch.core import bucketing as bucketing_lib

PathKey = tuple[str, ...]
FP32_BYTES = 4  # NS inputs are fp32 (momentum dtype): plan.py's convention

# Full-phase schedules of the engine: 'barrier' gathers every leaf, runs
# every bucket, slices everything back; 'pipelined' overlaps per-bucket
# gathers with the NS of the bucket before; 'staggered' also compiles one
# mixed phase per step residue ("stagger:r") in which only the leaves due
# at that residue run their full-step path and the rest their block path.
FULL_SCHEDULES = ("barrier", "pipelined", "staggered")

# Residue r of the staggered schedule runs the compiled phase "stagger:r";
# the plain 'full' phase is compiled beside them (the guard's forced-full
# step runs it).
STAGGER_PREFIX = "stagger:"


def stagger_phase(residue: int) -> str:
    """Phase name of one staggered step residue ("stagger:3")."""
    return f"{STAGGER_PREFIX}{int(residue)}"


def parse_stagger_phase(phase: str) -> Optional[int]:
    """Residue of a "stagger:r" phase name, or None for any other phase."""
    if isinstance(phase, str) and phase.startswith(STAGGER_PREFIX):
        tail = phase[len(STAGGER_PREFIX):]
        if tail.isdigit():
            return int(tail)
    return None


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Static description of one muon leaf -- all the compiler reads."""

    key: PathKey
    shape: tuple
    dtype: str
    block: Optional[blocking.BlockSpec2D] = None

    @property
    def blocked(self) -> bool:
        return self.block is not None and self.block.num_blocks > 1


@dataclasses.dataclass(frozen=True)
class CommOp:
    """One predicted communication step of the program.

    ``kind``: ``'gather'`` -- a leaf's all-gather of its trailing (matrix)
    dims before packing (engine full steps, and block steps of sharded
    leaves with no usable block grid); the slice back after NS is local.
    ``'apply'`` -- the writeback of a ZeRO-1 flatten-fallback leaf: one
    all-gather per ZeRO axis restores the padded stack's lead dim, the pad
    slice after is local; priced in the plan's 'apply' phase.
    ``collectives`` are ``(op, axes, per_rank_result_bytes)`` tuples in the
    convention of ``distributed.plan.Collective``.
    """

    kind: str
    axes: tuple[str, ...] = ()
    collectives: tuple[tuple[str, tuple[str, ...], int], ...] = ()

    @property
    def predicted_bytes(self) -> int:
        return sum(b for _, _, b in self.collectives)

    def predicted_link_bytes(self, link: str) -> int:
        from repro_torch.distributed.plan import link_class

        return sum(b for _, axes, b in self.collectives if link_class(axes) == link)


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Which NS kernel a bucket runs.

    ``backend`` is the device type the program was compiled for ("cuda" or
    "cpu"; on the CPU every strategy runs its kernels' plain versions);
    ``strategy`` is one of ``dispatch.STRATEGIES``; ``merged_dtypes`` records
    a cross-bucket launch merge (``dispatch.shared_launch_groups``).

    Variant stages (``core/variants.py``) are part of the plan: ``ns_steps``
    is the effective chain length K the bucket runs (None for a plan built
    without one), ``precondition`` a pre-NS stage ('spectral_scale': divide
    by a power-iteration spectral-norm estimate and skip the entry Frobenius
    normalization) and ``epilogue`` a post-NS stage ('neuron_norm': the
    NorMuon row normalization, applied by ``muon.update`` after unpack).
    The optimizer's ``orth`` callable runs them; the plan records them.
    """

    backend: str
    strategy: str
    merged_dtypes: tuple = ()
    ns_steps: Optional[int] = None
    precondition: Optional[str] = None
    epilogue: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class LeafExec:
    """Per-leaf execution record for one phase.

    ``spec`` and ``gather`` are set in engine mode; ``apply``/``out_spec``/
    ``lead`` only for ZeRO-1 flatten-fallback leaves: the writeback gathers
    the padded stack's lead dim over the ZeRO axes (``apply``), slices it
    back to ``lead`` layers, and the update leaves in the param layout
    (``out_spec``).
    """

    index: int                              # position in the flat muon-leaf list
    plan: bucketing_lib.LeafPlan            # pack plan on the local shape
    eff_dims: tuple[int, int]               # RMS-matching dims for this phase
    dtype: str = "float32"                  # leaf dtype (cast-epilogue target)
    spec: Optional[tuple] = None            # normalized momentum spec (engine)
    gather: Optional[CommOp] = None         # engine-mode pre-pack gather
    apply: Optional[CommOp] = None          # flatten-fallback writeback gather
    out_spec: Optional[tuple] = None        # out layout when != spec (fallback)
    lead: Optional[int] = None              # unpadded lead dim (fallback)


@dataclasses.dataclass(frozen=True)
class BucketOp:
    """One pack -> orthogonalize -> unpack step of a phase."""

    bucket_key: tuple
    leaves: tuple[LeafExec, ...]
    mode: str                               # 'concat' | 'stack'
    kernel: KernelPlan
    packed_shape: tuple = ()                # shape the kernel actually sees
    compute_dtype: Optional[str] = None     # launch-merge cast target
    comm: Optional[CommOp] = None           # bucket-level layer_shard


@dataclasses.dataclass(frozen=True)
class PipelineStage:
    """One stage of the pipelined full step: gather i+1 / NS i / slice i-1.

    ``gathers`` and ``writeback`` are flat leaf indices; ``compute`` indexes
    ``PhaseProgram.ops``. ``gather_bytes`` is what this stage's gathers
    move (plan.py's convention), ``overlap_bytes`` what the concurrent NS
    chain can hide at the modeled rates (``plan.overlappable_ns_bytes``),
    per link class; the exposed bytes are their clamped difference.
    ``compute_comm_bytes`` is what the compute op's own layer_shard gather
    moves, kept apart: it overlaps the next stage's compute, not this one's.
    """

    index: int
    gathers: tuple[int, ...]
    compute: Optional[int]
    writeback: tuple[int, ...]
    gather_bytes: int = 0
    overlap_bytes: int = 0
    compute_comm_bytes: int = 0
    dcn_gather_bytes: int = 0
    dcn_overlap_bytes: int = 0

    @property
    def ici_gather_bytes(self) -> int:
        return self.gather_bytes - self.dcn_gather_bytes

    @property
    def exposed_bytes(self) -> int:
        return (max(0, self.ici_gather_bytes - self.overlap_bytes)
                + max(0, self.dcn_gather_bytes - self.dcn_overlap_bytes))

    @property
    def exposed_dcn_bytes(self) -> int:
        return max(0, self.dcn_gather_bytes - self.dcn_overlap_bytes)


@dataclasses.dataclass(frozen=True)
class PipelineSchedule:
    """The compiled full-step pipeline: bucket order and stages.

    ``order`` is the ops[] execution order, largest gathers first (the
    inter-pod bytes the primary key), gather-free buckets last. Stage *s*
    issues the gathers of ``order[s]``, orthogonalizes ``order[s-1]`` and
    writes back ``order[s-2]``, so at most two buckets' gathered momentum is
    live.
    """

    order: tuple[int, ...]
    stages: tuple[PipelineStage, ...]

    @property
    def gather_bytes(self) -> int:
        return sum(s.gather_bytes for s in self.stages)

    @property
    def exposed_bytes(self) -> int:
        return sum(s.exposed_bytes for s in self.stages)

    @property
    def dcn_gather_bytes(self) -> int:
        return sum(s.dcn_gather_bytes for s in self.stages)

    @property
    def exposed_dcn_bytes(self) -> int:
        return sum(s.exposed_dcn_bytes for s in self.stages)

    def describe(self) -> list[str]:
        dcn = (f" (inter-pod: exposed {self.exposed_dcn_bytes} of "
               f"{self.dcn_gather_bytes} B)" if self.dcn_gather_bytes else "")
        lines = [f"pipelined: {len(self.stages)} stage(s) over {len(self.order)} "
                 f"bucket(s); exposed {self.exposed_bytes} of {self.gather_bytes} "
                 f"gathered B" + dcn]
        for s in self.stages:
            parts = []
            if s.gathers:
                link = f", {s.dcn_gather_bytes} B dcn" if s.dcn_gather_bytes else ""
                parts.append(f"gather {len(s.gathers)} leaf/leaves ({s.gather_bytes} B{link})")
            if s.compute is not None:
                ns = f"ns op{s.compute} (hides {s.overlap_bytes} B)"
                if s.compute_comm_bytes:
                    ns += f" +comm {s.compute_comm_bytes} B"
                parts.append(ns)
            if s.writeback:
                parts.append(f"writeback {len(s.writeback)} leaf/leaves")
            lines.append(f"  s{s.index}: " + (" | ".join(parts) if parts else "idle")
                         + (f" -> exposed {s.exposed_bytes} B" if s.gathers else ""))
        return lines


@dataclasses.dataclass(frozen=True)
class PhaseProgram:
    phase: str
    leaf_execs: tuple[LeafExec, ...]        # index order == muon leaf order
    ops: tuple[BucketOp, ...]
    schedule: Optional[PipelineSchedule] = None   # engine-mode pipelined fulls
    # Staggered phases only: the flat indices of the leaves due at this
    # residue, which gather whole and take the full-step LR. An unblocked
    # sharded leaf gathers on every phase but is due only at its residue.
    due: Optional[tuple[int, ...]] = None

    def predicted_comm_bytes(self) -> int:
        """Predicted collective bytes a step of this phase (plan.py's
        convention): the leaf gathers and the buckets' layer_shard gathers;
        the flatten writeback belongs to the plan's 'apply'
        (:meth:`predicted_apply_bytes`)."""
        return (sum(le.gather.predicted_bytes for le in self.leaf_execs if le.gather)
                + sum(op.comm.predicted_bytes for op in self.ops if op.comm))

    def predicted_apply_bytes(self) -> int:
        """ZeRO-1 flatten-fallback writeback bytes (the plan's 'apply')."""
        return sum(le.apply.predicted_bytes for le in self.leaf_execs if le.apply)

    def eff_dims(self, index: int) -> tuple[int, int]:
        return self.leaf_execs[index].eff_dims


@dataclasses.dataclass(frozen=True)
class UpdateProgram:
    """The compiled two-phase update schedule; ``execute`` interprets it."""

    leaf_specs: tuple[LeafSpec, ...]
    phases: dict                            # 'block'/'full'/'stagger:r' -> PhaseProgram
    engine: Optional[Any] = None            # distributed engine (duck-typed)
    stagger_period: Optional[int] = None    # staggered schedules only
    stagger_offsets: Optional[dict] = None  # 'a/b/c' path -> residue in [0, P)

    def phase(self, name: str) -> PhaseProgram:
        return self.phases[name]

    def execute(self, phase: str, u_leaves: Sequence, orth: Callable) -> list:
        """Run one phase over the NS inputs; ``orth(x, strategy=...)`` is bound
        to steps and coefficients. With an engine, ``u_leaves`` are this
        rank's shards and the engine runs the phase's gathers and slices."""
        if not u_leaves:
            return []
        prog = self.phases[phase]
        if self.engine is not None:
            return self.engine.run_program(prog, list(u_leaves), orth)
        return execute_ops(prog.ops, list(u_leaves), orth)

    def summary(self) -> str:
        """Human-readable program listing (for docs and debugging)."""
        lines = []
        for name, prog in self.phases.items():
            apply_b = prog.predicted_apply_bytes()
            due = f" due={len(prog.due)} leaf/leaves" if prog.due is not None else ""
            lines.append(f"{name}: {len(prog.ops)} bucket op(s), predicted comm "
                         f"{prog.predicted_comm_bytes()} B"
                         + (f" (+{apply_b} B zero1 apply)" if apply_b else "") + due)
            for op in prog.ops:
                comm = op.comm.kind if op.comm else (
                    "gather" if any(le.gather for le in op.leaves) else "none")
                merged = (f" merge={'+'.join(op.kernel.merged_dtypes)}"
                          if op.kernel.merged_dtypes else "")
                variant = ""
                if op.kernel.ns_steps is not None:
                    variant += f" K={op.kernel.ns_steps}"
                if op.kernel.precondition:
                    variant += f" pre={op.kernel.precondition}"
                if op.kernel.epilogue:
                    variant += f" epi={op.kernel.epilogue}"
                lines.append(f"  [{op.mode}] {len(op.leaves)} leaf/leaves -> "
                             f"{op.packed_shape} {op.kernel.backend}/{op.kernel.strategy}"
                             f"{merged}{variant} comm={comm}")
            if prog.schedule is not None:
                lines += ["  " + line for line in prog.schedule.describe()]
            elif name == "full":
                lines.append("  schedule: barrier")
        return "\n".join(lines)


def _flat_stack(x: torch.Tensor) -> tuple[torch.Tensor, Callable]:
    """A packed ``(..., m, n)`` stack as ``(stack, m, n)``, and the inverse:
    the layer_shard op without an engine, on an axis of size one."""
    *lead, m, n = x.shape

    def undo(o: torch.Tensor) -> torch.Tensor:
        return o.reshape(*lead, m, n)

    return x.reshape(-1, m, n), undo


def execute_op(op: BucketOp, leaves: Sequence, orth: Callable, *,
               layer_shard_apply: Optional[Callable] = None) -> list[tuple[int, Any]]:
    """Run ONE BucketOp: pack -> layer_shard -> orthogonalize -> unpack;
    returns ``(leaf_index, orthogonalized)`` pairs. ``layer_shard_apply(packed,
    op) -> (share, undo)`` is the engine's fold of a ``layer_shard`` op;
    without one the op is the inert size-one split."""
    parts = []
    for le in op.leaves:
        x = bucketing_lib.partition_leaf(leaves[le.index], le.plan)
        if op.compute_dtype is not None and bucketing_lib.dtype_name(x.dtype) != op.compute_dtype:
            x = x.to(getattr(torch, op.compute_dtype))
        parts.append(x)
    packed = bucketing_lib.pack_bucket(parts, op.mode)
    undo = None
    if op.comm is not None and op.comm.kind == "layer_shard":
        apply = layer_shard_apply or (lambda x, _op: _flat_stack(x))
        packed, undo = apply(packed, op)
    orthed = orth(packed, strategy=op.kernel.strategy)
    if undo is not None:
        orthed = undo(orthed)
    plans = [le.plan for le in op.leaves]
    outs = []
    for le, out in zip(op.leaves, bucketing_lib.unpack_bucket(orthed, plans, op.mode)):
        if op.compute_dtype is not None and bucketing_lib.dtype_name(out.dtype) != le.dtype:
            out = out.to(getattr(torch, le.dtype))
        outs.append((le.index, out))
    return outs


def execute_ops(ops: Sequence[BucketOp], leaves: list, orth: Callable, *,
                layer_shard_apply: Optional[Callable] = None) -> list:
    """Interpret a phase's BucketOps; results in flat leaf order."""
    results: list = [None] * len(leaves)
    for op in ops:
        for idx, out in execute_op(op, leaves, orth, layer_shard_apply=layer_shard_apply):
            results[idx] = out
    missing = [i for i, r in enumerate(results) if r is None]
    if missing:
        raise AssertionError(f"program left leaves {missing} unorthogonalized")
    return results


def _kernel_plan(packed_shape: tuple, backend: str, strategy: Optional[str],
                 merged_dtypes: tuple = (), **stages) -> KernelPlan:
    """``stages``: the variant's ``ns_steps``/``precondition``/``epilogue``."""
    from repro_torch.kernels import dispatch

    if strategy is not None and strategy != "auto":
        if strategy not in dispatch.STRATEGIES:
            raise ValueError(f"unknown NS strategy {strategy!r}; available: {dispatch.STRATEGIES}")
    else:
        strategy = dispatch.plan_strategy(packed_shape)
    return KernelPlan(backend=backend, strategy=strategy, merged_dtypes=merged_dtypes,
                      **stages)


def _group_buckets(leaf_execs: Sequence[LeafExec], mode: str, bucketing: bool):
    """Group leaves into buckets, sharing concat-mode launches across dtypes.

    Returns ``(bucket_key, members, compute_dtype, merged_dtypes)`` per bucket.
    """
    from repro_torch.kernels import dispatch

    buckets: dict = {}
    for le in leaf_execs:
        if not bucketing:
            key = ("leaf", le.index)
        elif mode == "concat":
            key = le.plan.key[:2]
        else:
            key = le.plan.key
        buckets.setdefault(key, []).append(le)

    out = []
    for key, members in buckets.items():
        compute_dtype: Optional[str] = None
        merged: tuple = ()
        bucket_key = key
        if bucketing and mode == "concat":
            compute_dtype, merged = dispatch.shared_launch_groups(
                [m.plan.key for m in members]
            )[key]
            bucket_key = (key[0], key[1], compute_dtype)
            if not merged:
                compute_dtype = None
        out.append((bucket_key, members, compute_dtype, merged))
    return out


def _packed_shape(plans: Sequence[bucketing_lib.LeafPlan], mode: str) -> tuple:
    if len(plans) == 1:
        return plans[0].block_shape
    if mode == "concat":
        units = sum(p.units for p in plans)
        return (units, plans[0].block_shape[-2], plans[0].block_shape[-1])
    return (len(plans), *plans[0].block_shape)


def _compile_phase(leaf_specs: Sequence[LeafSpec], phase: str, *, bucketing: bool,
                   backend: str, strategy: Optional[str], stages: dict,
                   layer_shard: Optional[tuple] = None) -> PhaseProgram:
    """Counterpart of the reference's ``_compile_phase_gspmd``. A
    ``layer_shard`` (its axis of size one: see :func:`compile_program`)
    marks every unblocked stack as the reference's does, flattened."""
    mode = "concat" if phase == "full" else "stack"
    leaf_execs: list[LeafExec] = []
    for i, ls in enumerate(leaf_specs):
        blocked = phase == "block" and ls.blocked
        spec2d = ls.block if blocked else None
        plan = bucketing_lib.plan_leaf(ls.shape, ls.dtype, spec2d, mode)
        m, n = int(ls.shape[-2]), int(ls.shape[-1])
        eff = (m // ls.block.r, n // ls.block.c) if blocked else (m, n)
        leaf_execs.append(LeafExec(index=i, plan=plan, eff_dims=eff, dtype=ls.dtype))

    ops = []
    for key, members, compute_dtype, merged in _group_buckets(leaf_execs, mode, bucketing):
        packed = _packed_shape([le.plan for le in members], mode)
        comm = None
        if layer_shard is not None and members[0].plan.spec is None and len(packed) >= 3:
            from repro_torch.distributed.plan import layer_shard_dims

            stack, _, m, n = layer_shard_dims(packed, 1)
            comm, packed = CommOp(kind="layer_shard", axes=(layer_shard[1],)), (stack, m, n)
        ops.append(BucketOp(
            bucket_key=key,
            leaves=tuple(members),
            mode=mode,
            kernel=_kernel_plan(packed, backend, strategy, merged, **stages),
            packed_shape=packed,
            compute_dtype=compute_dtype,
            comm=comm,
        ))
    return PhaseProgram(phase=phase, leaf_execs=tuple(leaf_execs), ops=tuple(ops))


def _engine_layer_shard_comm(packed_shape: tuple, axis: str, axis_size: int,
                             members: Sequence[LeafExec]) -> tuple[Optional[CommOp], tuple]:
    """The engine's fold of one full-step bucket: ``(comm_op, share_shape)``.

    The packed stack is whole over ``axis`` once the trailing gathers are
    in, so the rank's slice of the padded stack is local; the one
    collective is the all-gather that restores it
    (``plan.layer_shard_collectives(mode='engine')``). A 2-D bucket has no
    layer dim to split, and a bucket whose leaves ZeRO-1 splits over
    ``axis`` already holds only its own layers: both keep their shape.
    """
    from repro_torch.distributed.plan import layer_shard_collectives, layer_shard_dims
    from repro_torch.sharding.specs import spec_entry_names

    if len(packed_shape) < 3:
        return None, packed_shape
    if any(axis in spec_entry_names(e) for le in members for e in le.spec[:-2]):
        return None, packed_shape
    _, stack_p, m, n = layer_shard_dims(packed_shape, axis_size)
    comm = CommOp(kind="layer_shard", axes=(axis,),
                  collectives=layer_shard_collectives(packed_shape, axis, axis_size,
                                                      mode="engine"))
    return comm, (stack_p // max(axis_size, 1), m, n)


def _gather_comm(spec, shape: tuple, sizes: dict) -> Optional[CommOp]:
    """Predicted all-gather of the trailing dims (plan.py's convention):
    the canonical ``plan.trailing_gather_collectives`` sequence, one
    collective a mesh axis, minor first, as the engine issues them."""
    from repro_torch.distributed.plan import trailing_gather_collectives
    from repro_torch.sharding.specs import local_shape, spec_entries, spec_entry_size

    entries = spec_entries(spec, len(shape))
    if spec_entry_size(entries[-2], sizes) * spec_entry_size(entries[-1], sizes) == 1:
        return None
    local = 1
    for d in local_shape(spec, shape, sizes):
        local *= d
    collectives = trailing_gather_collectives(local, (entries[-2], entries[-1]), sizes)
    axes = tuple(name for _, (name,), _ in collectives)
    return CommOp(kind="gather", axes=axes, collectives=collectives)


def _op_gather_bytes(op: BucketOp) -> int:
    return sum(le.gather.predicted_bytes for le in op.leaves if le.gather)


def _op_gather_link_bytes(op: BucketOp, link: str) -> int:
    return sum(le.gather.predicted_link_bytes(link) for le in op.leaves if le.gather)


def _compile_schedule(ops: Sequence[BucketOp], ns_steps: int) -> Optional[PipelineSchedule]:
    """The per-bucket pipeline of an engine-mode phase, as the reference's.

    Buckets run in descending gather bytes, inter-pod bytes first; stage
    ``s`` gathers ``order[s]``, orthogonalizes ``order[s-1]``, writes back
    ``order[s-2]``: ``len(ops) + 2`` stages (a gather-only prologue and a
    writeback-only epilogue), each priced per link class.
    """
    if not ops:
        return None
    from repro_torch.distributed import plan as plan_lib

    order = tuple(sorted(range(len(ops)), key=lambda i: (
        -_op_gather_link_bytes(ops[i], "dcn"), -_op_gather_bytes(ops[i]), i)))
    n = len(order)
    stages = []
    for s in range(n + 2):
        g_op = order[s] if s < n else None
        c_op = order[s - 1] if 1 <= s <= n else None
        w_op = order[s - 2] if 2 <= s <= n + 1 else None
        stages.append(PipelineStage(
            index=s,
            gathers=tuple(le.index for le in ops[g_op].leaves if le.gather is not None)
            if g_op is not None else (),
            compute=c_op,
            writeback=tuple(le.index for le in ops[w_op].leaves) if w_op is not None else (),
            gather_bytes=_op_gather_bytes(ops[g_op]) if g_op is not None else 0,
            overlap_bytes=plan_lib.overlappable_ns_bytes(ops[c_op].packed_shape, ns_steps)
            if c_op is not None else 0,
            compute_comm_bytes=ops[c_op].comm.predicted_bytes
            if c_op is not None and ops[c_op].comm is not None else 0,
            dcn_gather_bytes=_op_gather_link_bytes(ops[g_op], "dcn") if g_op is not None else 0,
            dcn_overlap_bytes=plan_lib.overlappable_ns_bytes(
                ops[c_op].packed_shape, ns_steps, link="dcn") if c_op is not None else 0,
        ))
    return PipelineSchedule(order=order, stages=tuple(stages))


def _compile_phase_engine(leaf_specs: Sequence[LeafSpec], phase: str, *, bucketing: bool,
                          backend: str, strategy: Optional[str], engine: Any,
                          full_schedule: str, stages: dict,
                          full_leaves: Optional[frozenset] = None,
                          layer_shard: Optional[tuple] = None) -> PhaseProgram:
    """Engine mode: plan on each rank's local (post-gather) shapes.

    Every array is rank-local, so packing is always ``concat`` and bucket
    keys are local unit shapes. A leaf that is due whole (full phase, or no
    usable block grid) gathers its trailing dims; a blocked leaf runs NS on
    its shard, blocked locally by the residual factor where its block grid
    is finer than its shard grid (a replicated param carrying a block spec).

    ``full_leaves`` compiles a mixed staggered phase: those leaf indices
    take their full-step path and every other leaf its block path, in one
    body whose pipeline schedule spans the due buckets' gathers.
    ``layer_shard`` folds the plain full phase's stacks
    (:func:`_engine_layer_shard_comm`).
    """
    from repro_torch.distributed.plan import lead_gather_collectives
    from repro_torch.sharding.specs import local_shape, spec_entries, spec_entry_size

    sizes = dict(engine.axis_sizes)
    mode = "concat"
    leaf_execs: list[LeafExec] = []
    for i, ls in enumerate(leaf_specs):
        spec = engine.spec_for(ls.key, len(ls.shape))
        entries = spec_entries(spec, len(ls.shape))
        r = spec_entry_size(entries[-2], sizes)
        c = spec_entry_size(entries[-1], sizes)
        shard_shape = local_shape(spec, ls.shape, sizes)
        m, n = int(ls.shape[-2]), int(ls.shape[-1])
        gather = None
        due = phase == "full" or (full_leaves is not None and i in full_leaves)
        if due or not ls.blocked:
            # Gather the trailing dims back to global; lead dims stay local
            # (ZeRO-1 keeps each rank on its own layers).
            gather = _gather_comm(spec, ls.shape, sizes)
            body_shape = (*shard_shape[:-2], m, n)
            spec2d = None
            eff = (m, n)
        else:
            bs = ls.block
            if bs.r % r or bs.c % c:
                raise ValueError(f"block grid {bs} incompatible with shard grid ({r}, {c})")
            rr, rc = bs.r // r, bs.c // c
            body_shape = shard_shape
            spec2d = blocking.BlockSpec2D(rr, rc) if rr * rc > 1 else None
            eff = (m // bs.r, n // bs.c)
        plan = bucketing_lib.plan_leaf(body_shape, ls.dtype, spec2d, mode)
        apply_op = out_spec = lead = None
        fl = engine.flatten_for(ls.key)
        if fl is not None:
            if int(ls.shape[0]) != fl.padded_lead:
                raise ValueError(f"flatten-fallback leaf {ls.key} has lead dim {ls.shape[0]}, "
                                 f"expected padded {fl.padded_lead}")
            trailing_elems = 1
            for dim in shard_shape[1:]:
                trailing_elems *= int(dim)
            apply_op = CommOp(kind="apply", axes=fl.axes, collectives=lead_gather_collectives(
                int(shard_shape[0]), trailing_elems, fl.axes, sizes))
            out_spec = (None, *entries[1:])
            lead = fl.lead
        leaf_execs.append(LeafExec(index=i, plan=plan, eff_dims=eff, dtype=ls.dtype,
                                   spec=tuple(entries), gather=gather, apply=apply_op,
                                   out_spec=out_spec, lead=lead))

    ops = []
    for key, members, compute_dtype, merged in _group_buckets(leaf_execs, mode, bucketing):
        packed = _packed_shape([le.plan for le in members], mode)
        comm = None
        if layer_shard is not None and phase == "full":
            axis = layer_shard[1]
            comm, packed = _engine_layer_shard_comm(packed, axis, sizes.get(axis, 1), members)
        ops.append(BucketOp(
            bucket_key=key, leaves=tuple(members), mode=mode,
            kernel=_kernel_plan(packed, backend, strategy, merged, **stages),
            packed_shape=packed, compute_dtype=compute_dtype, comm=comm,
        ))
    # A mixed phase always pipelines (its due buckets' gathers overlap the
    # other buckets' NS); the plain full phase under 'staggered' too, as the
    # forced-full step runs it.
    pipelined = full_leaves is not None or (
        phase == "full" and full_schedule in ("pipelined", "staggered"))
    schedule = _compile_schedule(ops, stages["ns_steps"]) if pipelined else None
    return PhaseProgram(phase=phase, leaf_execs=tuple(leaf_execs), ops=tuple(ops),
                        schedule=schedule,
                        due=tuple(sorted(full_leaves)) if full_leaves is not None else None)


def compile_program(
    leaf_specs: Sequence[LeafSpec],
    *,
    bucketing: bool = True,
    backend: str = "cuda",
    strategy: Optional[str] = None,
    engine: Optional[Any] = None,
    layer_shard: Optional[tuple] = None,
    full_schedule: str = "pipelined",
    ns_steps: int = 5,
    stagger_period: Optional[int] = None,
    precondition: Optional[str] = None,
    epilogue: Optional[str] = None,
) -> UpdateProgram:
    """Compile the two-phase :class:`UpdateProgram` from static leaf info.

    ``bucketing=False`` compiles the degenerate one-bucket-per-leaf program;
    ``backend`` is the device type the program runs on; ``strategy`` pins
    every bucket's kernel (``None``/"auto" plans per packed shape).
    ``engine`` (``distributed.engine.ShardMapEngine``, duck-typed: it needs
    ``axis_sizes``, ``spec_for``, ``flatten_for`` and ``run_program``)
    compiles the explicit-comm program on local shapes, whose full phase
    gets a :class:`PipelineSchedule` under ``full_schedule='pipelined'``
    (``'barrier'``: gather all, NS all, write back all). ``'staggered'``
    (engine only, ``stagger_period`` >= 2) adds the mixed phases
    ``"stagger:0"`` .. ``"stagger:P-1"``, the leaves' offsets balanced over
    the residues by their gathers' inter-pod, then total bytes
    (``plan.assign_stagger_offsets``); the program carries the period and
    the offsets. ``ns_steps`` is the effective chain length K and
    ``precondition`` / ``epilogue`` the variant's stage names, recorded on
    every KernelPlan. ``layer_shard=(mesh, axis)`` folds the full phase's
    stacks over ``axis`` (see the module docstring): with an engine the axis
    must be one of its axes; without one (``mesh`` a ``DeviceMesh`` or an
    ``{axis: size}`` dict) it must have size one.
    """
    if full_schedule not in FULL_SCHEDULES:
        raise ValueError(f"full_schedule must be one of {FULL_SCHEDULES}, got {full_schedule!r}")
    if layer_shard is not None:
        axis = layer_shard[1]
        if engine is not None and axis not in dict(engine.axis_sizes):
            raise ValueError(f"layer_shard axis {axis!r} not in engine mesh axes "
                             f"{tuple(dict(engine.axis_sizes))}")
        if engine is None:
            from repro_torch.sharding.specs import mesh_axis_sizes

            if mesh_axis_sizes(layer_shard[0]).get(axis, 1) > 1:
                raise ValueError(
                    f"layer_shard over {axis!r} without an engine: the reference re-shards "
                    "through its partitioner, which eager PyTorch has not; pass comm= (the "
                    "distributed engine, distributed.engine.ShardMapEngine), which folds it")
    offsets: Optional[dict] = None
    period: Optional[int] = None
    if full_schedule == "staggered":
        if engine is None:
            raise ValueError("full_schedule='staggered' needs the distributed engine (without "
                             "one there are no per-leaf gathers to stagger)")
        if stagger_period is None or int(stagger_period) < 2:
            raise ValueError(f"full_schedule='staggered' needs stagger_period >= 2, "
                             f"got {stagger_period!r}")
        period = int(stagger_period)
        from repro_torch.distributed.plan import assign_stagger_offsets

        sizes = dict(engine.axis_sizes)
        items = []
        for ls in leaf_specs:
            comm = _gather_comm(engine.spec_for(ls.key, len(ls.shape)), ls.shape, sizes)
            items.append(("/".join(ls.key), comm.predicted_link_bytes("dcn") if comm else 0,
                          comm.predicted_bytes if comm else 0))
        offsets = assign_stagger_offsets(items, period)
    stages = dict(ns_steps=ns_steps, precondition=precondition, epilogue=epilogue)
    phase_names = ["block", "full"]
    if period is not None:
        phase_names += [stagger_phase(r) for r in range(period)]
    phases = {}
    for phase in phase_names:
        if engine is not None:
            residue = parse_stagger_phase(phase)
            full_leaves = None if residue is None else frozenset(
                i for i, ls in enumerate(leaf_specs) if offsets["/".join(ls.key)] == residue)
            phases[phase] = _compile_phase_engine(
                leaf_specs, phase, bucketing=bucketing, backend=backend, strategy=strategy,
                engine=engine, full_schedule=full_schedule, stages=stages,
                full_leaves=full_leaves, layer_shard=layer_shard)
        else:
            phases[phase] = _compile_phase(leaf_specs, phase, bucketing=bucketing,
                                           backend=backend, strategy=strategy, stages=stages,
                                           layer_shard=layer_shard)
    return UpdateProgram(leaf_specs=tuple(leaf_specs), phases=phases, engine=engine,
                         stagger_period=period, stagger_offsets=offsets)
