"""UpdateProgram: the MuonBP update compiled once, interpreted every step.

Counterpart of the single-device subset of ``repro/core/program.py``: no
distributed engine, no layer_shard, no staggered schedule. From static
leaf information (shapes, dtypes, block grids) the compiler fixes, per
phase, the ordered list of :class:`BucketOp`\\ s -- pack -> orthogonalize
(kernel plan) -> unpack -- and each leaf's RMS-matching effective dims, so
``muon.update`` merely interprets the program.

Full phases pack in ``concat`` mode, block phases in ``stack`` mode, exactly
as the reference's GSPMD compiler does, so bucket keys, packed shapes and
effective dims match the reference leaf for leaf. Each bucket's
:class:`KernelPlan` records the strategy ``dispatch.plan_strategy`` chose
for the packed shape at compile time.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.core import blocking
from repro_torch.core import bucketing as bucketing_lib

PathKey = tuple[str, ...]


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
class KernelPlan:
    """Which NS kernel a bucket runs.

    ``backend`` is the device type the program was compiled for ("cuda" or
    "cpu"; on the CPU every strategy runs its kernels' plain versions);
    ``strategy`` is one of ``dispatch.STRATEGIES``; ``merged_dtypes`` records
    a cross-bucket launch merge (``dispatch.shared_launch_groups``).
    """

    backend: str
    strategy: str
    merged_dtypes: tuple = ()


@dataclasses.dataclass(frozen=True)
class LeafExec:
    """Per-leaf execution record for one phase."""

    index: int                              # position in the flat muon-leaf list
    plan: bucketing_lib.LeafPlan            # pack plan
    eff_dims: tuple[int, int]               # RMS-matching dims for this phase
    dtype: str = "float32"                  # leaf dtype (cast-epilogue target)


@dataclasses.dataclass(frozen=True)
class BucketOp:
    """One pack -> orthogonalize -> unpack step of a phase."""

    bucket_key: tuple
    leaves: tuple[LeafExec, ...]
    mode: str                               # 'concat' | 'stack'
    kernel: KernelPlan
    packed_shape: tuple = ()                # shape the kernel actually sees
    compute_dtype: Optional[str] = None     # launch-merge cast target


@dataclasses.dataclass(frozen=True)
class PhaseProgram:
    phase: str
    leaf_execs: tuple[LeafExec, ...]        # index order == muon leaf order
    ops: tuple[BucketOp, ...]

    def eff_dims(self, index: int) -> tuple[int, int]:
        return self.leaf_execs[index].eff_dims


@dataclasses.dataclass(frozen=True)
class UpdateProgram:
    """The compiled two-phase update schedule; ``execute`` interprets it."""

    leaf_specs: tuple[LeafSpec, ...]
    phases: dict                            # 'block' | 'full' -> PhaseProgram

    def phase(self, name: str) -> PhaseProgram:
        return self.phases[name]

    def execute(self, phase: str, u_leaves: Sequence, orth: Callable) -> list:
        """Run one phase over the NS inputs; ``orth(x, strategy=...)`` is bound
        to steps and coefficients."""
        if not u_leaves:
            return []
        return execute_ops(self.phases[phase].ops, list(u_leaves), orth)


def execute_op(op: BucketOp, leaves: Sequence, orth: Callable) -> list[tuple[int, Any]]:
    """Run ONE BucketOp; returns ``(leaf_index, orthogonalized)`` pairs."""
    parts = []
    for le in op.leaves:
        x = bucketing_lib.partition_leaf(leaves[le.index], le.plan)
        if op.compute_dtype is not None and bucketing_lib.dtype_name(x.dtype) != op.compute_dtype:
            x = x.to(getattr(torch, op.compute_dtype))
        parts.append(x)
    packed = bucketing_lib.pack_bucket(parts, op.mode)
    orthed = orth(packed, strategy=op.kernel.strategy)
    plans = [le.plan for le in op.leaves]
    outs = []
    for le, out in zip(op.leaves, bucketing_lib.unpack_bucket(orthed, plans, op.mode)):
        if op.compute_dtype is not None and bucketing_lib.dtype_name(out.dtype) != le.dtype:
            out = out.to(getattr(torch, le.dtype))
        outs.append((le.index, out))
    return outs


def execute_ops(ops: Sequence[BucketOp], leaves: list, orth: Callable) -> list:
    """Interpret a phase's BucketOps; results in flat leaf order."""
    results: list = [None] * len(leaves)
    for op in ops:
        for idx, out in execute_op(op, leaves, orth):
            results[idx] = out
    missing = [i for i, r in enumerate(results) if r is None]
    if missing:
        raise AssertionError(f"program left leaves {missing} unorthogonalized")
    return results


def _kernel_plan(packed_shape: tuple, backend: str, strategy: Optional[str],
                 merged_dtypes: tuple = ()) -> KernelPlan:
    from repro_torch.kernels import dispatch

    if strategy is not None and strategy != "auto":
        if strategy not in dispatch.STRATEGIES:
            raise ValueError(f"unknown NS strategy {strategy!r}; available: {dispatch.STRATEGIES}")
        return KernelPlan(backend=backend, strategy=strategy, merged_dtypes=merged_dtypes)
    return KernelPlan(
        backend=backend, strategy=dispatch.plan_strategy(packed_shape),
        merged_dtypes=merged_dtypes,
    )


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
                   backend: str, strategy: Optional[str]) -> PhaseProgram:
    """Counterpart of the reference's ``_compile_phase_gspmd`` with no layer_shard."""
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
        ops.append(BucketOp(
            bucket_key=key,
            leaves=tuple(members),
            mode=mode,
            kernel=_kernel_plan(packed, backend, strategy, merged),
            packed_shape=packed,
            compute_dtype=compute_dtype,
        ))
    return PhaseProgram(phase=phase, leaf_execs=tuple(leaf_execs), ops=tuple(ops))


def compile_program(
    leaf_specs: Sequence[LeafSpec],
    *,
    bucketing: bool = True,
    backend: str = "cuda",
    strategy: Optional[str] = None,
) -> UpdateProgram:
    """Compile the two-phase :class:`UpdateProgram` from static leaf info.

    ``bucketing=False`` compiles the degenerate one-bucket-per-leaf program;
    ``backend`` is the device type the program runs on; ``strategy`` pins
    every bucket's kernel (``None``/"auto" plans per packed shape).
    """
    phases = {
        phase: _compile_phase(leaf_specs, phase, bucketing=bucketing,
                              backend=backend, strategy=strategy)
        for phase in ("block", "full")
    }
    return UpdateProgram(leaf_specs=tuple(leaf_specs), phases=phases)
