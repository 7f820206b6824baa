"""Block-granular paged KV-cache management for the serving engine.

Counterpart of ``repro/serving/kvcache.py``. Two layers:

* :class:`BlockPool` -- host-side block accounting, the reference's line for
  line. The KV budget is a fixed number of fixed-size blocks; admission
  control reserves a request's whole footprint
  (``blocks_for(prompt + new_token_budget)``) up front, so a request that is
  admitted can never be starved mid-decode, and eviction returns exactly
  what was reserved. Double-free and foreign-free are errors, and
  ``outstanding`` must return to zero after any request churn -- the no-leak
  invariant.

* :class:`PagedKVCache` -- the physical storage: one device tensor of shape
  ``(L, num_blocks + 1, block_size, H, Dh)`` per K and V, plus a host-side
  per-slot block table mapping each slot's logical block ``i`` to a physical
  block id. Physical block ``num_blocks`` is a reserved scratch block:
  unused table entries point at it, and inactive slots' decode writes land
  there. Every write is in place (``index_copy_``, ``index_put_``,
  ``index_fill_``): the reference donates its pools to the jitted decode, and
  a functional copy would cost the whole pool a step. The decode step goes
  through :class:`PagedLayer`, which writes a token's K/V into its
  block and gathers the slot's blocks into a ``(max_blocks_per_slot *
  block_size)`` window; the reference gathers first, writes into the window
  and scatters the block back, with the same values.

Why scrubbing matters: attention masks invalid positions with exact-zero
softmax weights, but ``0 * NaN = NaN`` in the ``p @ v`` contraction -- a NaN
anywhere in a gathered window poisons the slot's logits even if the
position is masked. So blocks are zeroed on release (``scrub=True``), the
scratch block only ever receives finite decode output, and a cache-corruption
fault (``corrupt_cache@N``) stays confined to the slot that owns the
poisoned block until the engine cancels it and scrubs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig

POOL_DTYPE = torch.bfloat16  # the reference engine's pool dtype


class KVCacheError(RuntimeError):
    """Pool misuse: over-allocation, double free, foreign free."""


def blocks_for(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` KV entries (ceil division)."""
    if tokens < 0:
        raise ValueError(f"negative token count {tokens}")
    return -(-tokens // block_size)


@dataclasses.dataclass(frozen=True)
class PoolStats:
    total_blocks: int
    block_size: int
    free: int
    outstanding: int
    high_water: int
    allocs: int
    frees: int


class BlockPool:
    """Fixed-capacity block allocator with ownership tracking.

    LIFO free list: recently released blocks are reused first, which keeps
    the long-run working set small and makes leak bugs show up as monotonic
    free-list shrinkage rather than silent address growth.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks <= 0 or block_size <= 0:
            raise ValueError(
                f"need positive pool dims, got num_blocks={num_blocks} "
                f"block_size={block_size}")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free: list[int] = list(range(self.num_blocks - 1, -1, -1))
        self._owner: dict[int, str] = {}
        self._high_water = 0
        self._allocs = 0
        self._frees = 0

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def outstanding(self) -> int:
        return self.num_blocks - len(self._free)

    def blocks_for(self, tokens: int) -> int:
        return blocks_for(tokens, self.block_size)

    def can_alloc(self, n: int) -> bool:
        return 0 <= n <= len(self._free)

    def alloc(self, n: int, owner: str) -> tuple[int, ...]:
        if n <= 0:
            raise KVCacheError(f"{owner}: asked for {n} blocks")
        if n > len(self._free):
            raise KVCacheError(
                f"{owner}: {n} blocks requested, {len(self._free)} free "
                f"of {self.num_blocks}")
        ids = tuple(self._free.pop() for _ in range(n))
        for b in ids:
            self._owner[b] = owner
        self._allocs += n
        self._high_water = max(self._high_water, self.outstanding)
        return ids

    def free(self, ids: tuple[int, ...], owner: str) -> None:
        for b in ids:
            got = self._owner.get(b)
            if got is None:
                raise KVCacheError(f"{owner}: double free of block {b}")
            if got != owner:
                raise KVCacheError(
                    f"{owner}: freeing block {b} owned by {got!r}")
        for b in ids:
            del self._owner[b]
            self._free.append(b)
        self._frees += len(ids)

    def owner_of(self, block: int) -> Optional[str]:
        return self._owner.get(block)

    def stats(self) -> PoolStats:
        return PoolStats(
            total_blocks=self.num_blocks,
            block_size=self.block_size,
            free=self.free_blocks,
            outstanding=self.outstanding,
            high_water=self._high_water,
            allocs=self._allocs,
            frees=self._frees,
        )


class PagedLayer:
    """One layer of a :class:`PagedKVCache` as a batched decode sees it.

    ``tables`` (S, max_blocks_per_slot) are the slots' block tables on the
    device and ``active`` (S,) which slots decode. :meth:`write` has the
    signature of ``models.layers.DenseKV.write``, so ``attention_block``
    takes either.
    """

    def __init__(self, cache: "PagedKVCache", layer: int, tables: torch.Tensor,
                 active: torch.Tensor):
        self.cache, self.layer = cache, layer
        self.tables, self.active = tables, active

    def write(self, k, v, index):
        """Write the (S, 1, H, Dh) token K/V at the (S,) positions ``index``
        into the pool in place, cast to the pool dtype, and return each
        slot's gathered (S, window, H, Dh) window. A slot's token goes to
        its block ``tables[s, p // block_size]`` at ``p % block_size``, an
        inactive slot's to the scratch block."""
        c, i = self.cache, self.layer
        block = self.tables.gather(1, (index // c.block_size)[:, None])[:, 0]
        phys = torch.where(self.active, block, c.scratch)
        off = index % c.block_size
        c.k[i].index_put_((phys, off), k[:, 0].to(POOL_DTYPE))
        c.v[i].index_put_((phys, off), v[:, 0].to(POOL_DTYPE))
        s = self.tables.shape[0]
        window = (s, c.window, *c.k.shape[3:])
        return c.k[i][self.tables].reshape(window), c.v[i][self.tables].reshape(window)


class PagedKVCache:
    """Physical paged KV storage + per-slot block tables.

    The pools live as two device tensors; the tables are host numpy (they
    change on every admit/evict, and a fresh device copy rides along with
    each decode step). ``scratch`` (= ``num_blocks``) is the reserved
    write-target for inactive slots and the read-target for unassigned
    table entries -- never allocatable, always finite.
    """

    def __init__(
        self,
        cfg: ModelConfig,
        *,
        slots: int,
        num_blocks: int,
        block_size: int,
        max_blocks_per_slot: int,
        device="cuda",
    ):
        if not cfg.num_heads or cfg.arch_type == "ssm":
            raise ValueError(
                f"paged KV cache needs an attention arch, got "
                f"{cfg.arch_type!r}")
        if max_blocks_per_slot <= 0:
            raise ValueError("max_blocks_per_slot must be positive")
        self.cfg = cfg
        self.slots = int(slots)
        self.block_size = int(block_size)
        self.max_blocks_per_slot = int(max_blocks_per_slot)
        self.pool = BlockPool(num_blocks, block_size)
        self.scratch = self.pool.num_blocks
        L, H, Dh = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        shape = (L, num_blocks + 1, block_size, H, Dh)
        self.k = torch.zeros(shape, dtype=POOL_DTYPE, device=device)
        self.v = torch.zeros(shape, dtype=POOL_DTYPE, device=device)
        self.tables = np.full(
            (self.slots, self.max_blocks_per_slot), self.scratch, np.int32)

    @property
    def window(self) -> int:
        """Gathered decode window length (static across all slots)."""
        return self.max_blocks_per_slot * self.block_size

    @property
    def device(self) -> torch.device:
        return self.k.device

    def write_prefill(self, slot: int, blocks: tuple[int, ...],
                      k: torch.Tensor, v: torch.Tensor) -> None:
        """Install a prefill cache into ``blocks`` and point ``slot`` at them.

        ``k``/``v`` are the prefill-produced per-layer caches, shape
        ``(L, P, H, Dh)``. The tail of the last block is zero-padded (those
        positions are masked until decode overwrites them).
        """
        L, P, H, Dh = k.shape
        need = blocks_for(P, self.block_size)
        if need > len(blocks):
            raise KVCacheError(
                f"slot {slot}: prefill of {P} tokens needs {need} blocks, "
                f"given {len(blocks)}")
        if len(blocks) > self.max_blocks_per_slot:
            raise KVCacheError(
                f"slot {slot}: {len(blocks)} blocks exceeds per-slot table "
                f"of {self.max_blocks_per_slot}")
        nb = len(blocks)
        idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
        for pool, t in ((self.k, k), (self.v, v)):
            padded = torch.zeros((L, nb * self.block_size, H, Dh), dtype=POOL_DTYPE,
                                 device=self.device)
            padded[:, :P] = t.to(POOL_DTYPE)
            pool.index_copy_(1, idx, padded.reshape(L, nb, self.block_size, H, Dh))
        self.tables[slot, :] = self.scratch
        self.tables[slot, :nb] = np.asarray(blocks, np.int32)

    def release(self, slot: int, blocks: tuple[int, ...], owner: str,
                *, scrub: bool = True) -> None:
        """Return ``blocks`` to the pool and detach ``slot``'s table.

        ``scrub`` zeroes the released physical blocks so whatever the dead
        request left there (including an injected NaN poison) can never
        reach a future request's gathered window.
        """
        if scrub and blocks:
            idx = torch.as_tensor(blocks, dtype=torch.long, device=self.device)
            self.k.index_fill_(1, idx, 0)
            self.v.index_fill_(1, idx, 0)
        self.tables[slot, :] = self.scratch
        self.pool.free(tuple(blocks), owner)

    def poison(self, slot: int) -> int:
        """Overwrite the slot's first physical block with NaN (fault
        injection: ``corrupt_cache@N``). Returns the poisoned block id."""
        block = int(self.tables[slot, 0])
        if block == self.scratch:
            raise KVCacheError(f"slot {slot} has no blocks to poison")
        self.k[:, block] = float("nan")
        return block
