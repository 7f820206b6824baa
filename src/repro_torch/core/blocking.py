"""Logical block partitioning aligned with model-parallel sharding.

Counterpart of ``repro/core/blocking.py``. A MuonBP block is the shard a
device would own under the model-parallel layout (paper Sec 3); here the
grid comes from a declared ``{axis: size}`` dict, so one GPU runs the same
block grids the reference derives from a mesh.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class BlockSpec2D:
    """Block grid for the trailing two dims of a parameter."""

    r: int  # row blocks
    c: int  # col blocks

    def __iter__(self):
        yield self.r
        yield self.c

    @property
    def num_blocks(self) -> int:
        return self.r * self.c


def block_spec_from_partition(spec, shape, mesh_axis_sizes: dict[str, int]) -> BlockSpec2D:
    """(r, c) block grid of a >=2D param from its partition spec.

    ``spec`` is a tuple with one entry per dim: ``None``, an axis name, or a
    tuple of axis names. Only the trailing two dims count; a dim's block
    count is the product of its axes' sizes, and a count that does not
    divide the dim falls back to 1.
    """
    if spec is None or len(shape) < 2:
        return BlockSpec2D(1, 1)
    entries = list(spec) + [None] * (len(shape) - len(spec))

    def axis_size(entry) -> int:
        if entry is None:
            return 1
        names = entry if isinstance(entry, tuple) else (entry,)
        size = 1
        for name in names:
            size *= mesh_axis_sizes.get(name, 1)
        return size

    r = axis_size(entries[-2])
    c = axis_size(entries[-1])
    if shape[-2] % r != 0:
        r = 1
    if shape[-1] % c != 0:
        c = 1
    return BlockSpec2D(r, c)


def partition_blocks(x: torch.Tensor, bs: BlockSpec2D) -> torch.Tensor:
    """(..., m, n) -> (..., r*c, m/r, n/c). Row-major block order."""
    r, c = bs
    *lead, m, n = x.shape
    if m % r or n % c:
        raise ValueError(f"blocks {bs} do not divide matrix {(m, n)}")
    x = x.reshape(*lead, r, m // r, c, n // c)
    x = torch.movedim(x, -2, -3)  # (..., r, c, m/r, n/c)
    return x.reshape(*lead, r * c, m // r, n // c)


def unpartition_blocks(blocks: torch.Tensor, bs: BlockSpec2D) -> torch.Tensor:
    """Inverse of :func:`partition_blocks`."""
    r, c = bs
    *lead, rc, mb, nb = blocks.shape
    if rc != r * c:
        raise ValueError(f"block count {rc} != {r}*{c}")
    x = blocks.reshape(*lead, r, c, mb, nb)
    x = torch.movedim(x, -3, -2)  # (..., r, m/r, c, n/c)
    return x.reshape(*lead, r * mb, c * nb)
