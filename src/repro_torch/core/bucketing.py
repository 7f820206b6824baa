"""Shape-bucketed Newton-Schulz packing (counterpart of ``repro/core/bucketing.py``).

Every NS unit of an update -- whole matrices on full steps, logical blocks
on block steps -- is grouped by its exact unit shape and dtype, packed into
one batched tensor, orthogonalized by ONE kernel chain per bucket, and
scattered back. Two packing modes, as in the reference:

  * ``"concat"`` -- flatten leading dims and concatenate units along the
    stack axis (full steps);
  * ``"stack"`` -- bucket by the entire blocked shape and stack members on
    a new leading axis (block steps).

Buckets are keyed by exact orientation: ``(m, n)`` and ``(n, m)`` units form
two buckets. Dtype names in keys are numpy-style (``"float32"``), the same
strings the reference uses.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import blocking

BucketKey = tuple


def dtype_name(dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the reference's key spelling)."""
    return str(dtype).removeprefix("torch.") if isinstance(dtype, torch.dtype) else str(dtype)


@dataclasses.dataclass(frozen=True)
class LeafPlan:
    """How one leaf maps into its bucket (enough to invert the packing)."""

    key: BucketKey
    units: int                                 # flattened units (concat mode)
    spec: Optional[blocking.BlockSpec2D]       # block partitioning applied
    block_shape: tuple                         # shape after blocking


def plan_leaf(shape: tuple, dtype, spec, mode: str) -> LeafPlan:
    """A leaf's bucket plan from shape and dtype alone."""
    applied = None
    if spec is not None and spec.num_blocks > 1:
        *lead, m, n = shape
        if m % spec.r or n % spec.c:
            raise ValueError(f"blocks {spec} do not divide matrix {(m, n)}")
        shape = (*lead, spec.num_blocks, m // spec.r, n // spec.c)
        applied = spec
    block_shape = tuple(int(d) for d in shape)
    units = 1
    for d in block_shape[:-2]:
        units *= d
    dt = dtype_name(dtype)
    if mode == "concat":
        key: BucketKey = (block_shape[-2], block_shape[-1], dt)
    elif mode == "stack":
        key = (block_shape, dt)
    else:
        raise ValueError(f"mode must be 'concat' or 'stack', got {mode!r}")
    return LeafPlan(key=key, units=units, spec=applied, block_shape=block_shape)


def partition_leaf(leaf: torch.Tensor, plan: LeafPlan) -> torch.Tensor:
    """Apply the plan's logical block partitioning (identity when unblocked)."""
    if plan.spec is not None:
        return blocking.partition_blocks(leaf, plan.spec)
    return leaf


def restore_leaf(x: torch.Tensor, plan: LeafPlan) -> torch.Tensor:
    """Inverse of :func:`partition_leaf` plus the bucket-shape reshape."""
    x = x.reshape(plan.block_shape)
    if plan.spec is not None:
        x = blocking.unpartition_blocks(x, plan.spec)
    return x


def pack_bucket(parts: Sequence[torch.Tensor], mode: str) -> torch.Tensor:
    """Pack already-partitioned members into one batched tensor.

    Single-member buckets pass through untouched.
    """
    if len(parts) == 1:
        return parts[0]
    if mode == "concat":
        return torch.cat([p.reshape(-1, p.shape[-2], p.shape[-1]) for p in parts], dim=0)
    return torch.stack(list(parts), dim=0)


def unpack_bucket(packed: torch.Tensor, plans: Sequence[LeafPlan], mode: str) -> list[torch.Tensor]:
    """Invert :func:`pack_bucket`: scatter the batched result per member."""
    if len(plans) == 1:
        return [restore_leaf(packed, plans[0])]
    if mode == "concat":
        out, offset = [], 0
        for plan in plans:
            out.append(restore_leaf(packed[offset : offset + plan.units], plan))
            offset += plan.units
        return out
    return [restore_leaf(packed[pos], plan) for pos, plan in enumerate(plans)]


def plan_buckets(leaves: Sequence, specs: Sequence[Optional[blocking.BlockSpec2D]],
                 mode: str = "concat") -> dict[BucketKey, list[int]]:
    """Bucket key -> leaf indices, without touching data (``leaves`` may be
    anything with ``.shape`` and ``.dtype``)."""
    buckets: dict[BucketKey, list[int]] = {}
    for idx, (leaf, spec) in enumerate(zip(leaves, specs)):
        plan = plan_leaf(tuple(leaf.shape), leaf.dtype, spec, mode)
        buckets.setdefault(plan.key, []).append(idx)
    return buckets


def bucketed_orthogonalize(leaves: Sequence[torch.Tensor],
                           specs: Sequence[Optional[blocking.BlockSpec2D]],
                           orth: Callable[[torch.Tensor], torch.Tensor],
                           mode: str = "concat") -> list[torch.Tensor]:
    """Orthogonalize every leaf with one ``orth`` call per shape bucket.

    ``specs`` are per-leaf block grids (None, or ``num_blocks == 1``, for a
    whole matrix); ``orth`` gets each packed bucket. Returns the leaves in
    their shapes and order.
    """
    plans = [plan_leaf(tuple(leaf.shape), leaf.dtype, spec, mode)
             for leaf, spec in zip(leaves, specs)]
    buckets: dict[BucketKey, list[int]] = {}
    for idx, plan in enumerate(plans):
        buckets.setdefault(plan.key, []).append(idx)
    results: list = [None] * len(leaves)
    for members in buckets.values():
        parts = [partition_leaf(leaves[i], plans[i]) for i in members]
        orthed = orth(pack_bucket(parts, mode))
        for i, out in zip(members, unpack_bucket(orthed, [plans[i] for i in members], mode)):
            results[i] = out
    return results
