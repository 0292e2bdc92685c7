"""Host-side paged KV-cache block accounting (serving v2).

The v1 cache was slot-contiguous — every admitted request owned
``max_seq`` rows of HBM whether it used 10 tokens or 2048.  Paging
(vLLM's PagedAttention idea) splits the cache into fixed-size BLOCKS
of ``block_size`` token positions and gives each request slot a
BLOCK TABLE: a padded ``int32`` row mapping logical block index →
physical block id.  HBM is then proportional to tokens actually
cached, and two requests can point their tables at the SAME physical
block (a shared prompt prefix) — the sharing/copy-on-write substrate
the radix prefix cache (``serving/prefix_cache.py``) builds on.

Everything here is host-side bookkeeping: the device arrays (the
block pools and the gather/scatter attention over them) live in
``serving/decoder.py``.  Two classes:

- ``BlockAllocator`` — free list + per-block refcounts + loud
  accounting.  Exhaustion raises ``OutOfBlocks`` carrying the full
  allocator state; the engine turns that into an admission-control
  shed (``finish_reason="no_blocks"``) instead of an opaque hang.
- ``BlockManager`` — per-slot block tables over one allocator:
  assignment (adopted shared blocks + fresh ones), incremental
  growth as decode crosses block boundaries, and
  ``ensure_writable`` — the copy-on-write gate every write position
  passes through (a block with refcount > 1 is copied to a fresh
  exclusive block before the first divergent write touches it).

Table rows are padded with the TRASH block id (``n_blocks`` — the
pools allocate one extra physical block for it): writes routed there
are dead by construction and reads of it are masked, so the decode
executable needs no dynamic shapes and no branches.

A copy of ``theanompi_tpu/serving/blocks.py`` (numpy only).
"""

from __future__ import annotations

import numpy as np


class OutOfBlocks(RuntimeError):
    """KV block pool exhausted.  Carries the allocator state so the
    shed path (and the operator) sees WHY: how many were requested,
    how many are in use / shared / free."""

    def __init__(self, requested: int, state: dict):
        super().__init__(
            f"out of KV-cache blocks: requested {requested}, "
            f"state {state}"
        )
        self.requested = requested
        self.state = state


class BlockAllocator:
    """Free list + refcounts over ``n_blocks`` physical KV blocks.

    A block is born with refcount 1 (its allocator).  Sharing bumps
    the count (``ref``); ``deref`` returns it to the free list at
    zero.  Counters make scarcity loud: ``n_oom`` increments on every
    failed allocation (before ``OutOfBlocks`` raises), ``n_cow``
    counts copy-on-write copies (bumped by ``BlockManager``).
    """

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 1 or block_size < 1:
            raise ValueError(
                f"need n_blocks >= 1 and block_size >= 1, got "
                f"{n_blocks}/{block_size}"
            )
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        # pop() from the end → lowest ids first (deterministic tables)
        self._free = list(range(self.n_blocks - 1, -1, -1))
        self._ref = np.zeros(self.n_blocks, np.int32)
        self.n_allocs = 0
        self.n_frees = 0
        self.n_cow = 0
        self.n_oom = 0
        self.peak_in_use = 0

    # -- accounting --------------------------------------------------------

    @property
    def blocks_free(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.n_blocks - len(self._free)

    def refcount(self, block: int) -> int:
        return int(self._ref[block])

    def stats(self) -> dict:
        return {
            "n_blocks": self.n_blocks,
            "block_size": self.block_size,
            "blocks_free": self.blocks_free,
            "blocks_in_use": self.blocks_in_use,
            "peak_in_use": self.peak_in_use,
            "n_allocs": self.n_allocs,
            "n_frees": self.n_frees,
            "n_cow": self.n_cow,
            "n_oom": self.n_oom,
        }

    # -- lifecycle ---------------------------------------------------------

    def alloc(self) -> int:
        """One fresh exclusive block (refcount 1), or ``OutOfBlocks``
        — loud, with the full state attached."""
        if not self._free:
            self.n_oom += 1
            raise OutOfBlocks(1, self.stats())
        bid = self._free.pop()
        self._ref[bid] = 1
        self.n_allocs += 1
        self.peak_in_use = max(self.peak_in_use, self.blocks_in_use)
        return bid

    def alloc_many(self, n: int) -> list[int]:
        """``n`` fresh blocks atomically: all or ``OutOfBlocks``
        (nothing leaks on the failure path)."""
        if n > len(self._free):
            self.n_oom += 1
            raise OutOfBlocks(n, self.stats())
        return [self.alloc() for _ in range(n)]

    def ref(self, block: int) -> None:
        """Take one more reference on a live block (prefix adoption /
        cache insertion)."""
        assert self._ref[block] > 0, f"ref of dead block {block}"
        self._ref[block] += 1

    def deref(self, block: int) -> bool:
        """Drop one reference; returns True when this freed the
        block (refcount reached zero → back on the free list)."""
        assert self._ref[block] > 0, f"deref of dead block {block}"
        self._ref[block] -= 1
        if self._ref[block] == 0:
            self._free.append(int(block))
            self.n_frees += 1
            return True
        return False


class BlockManager:
    """Per-slot block tables over one :class:`BlockAllocator`.

    ``tables`` is the host mirror the decoder ships to the device
    every step: ``[max_slots, max_blocks]`` int32, padded with the
    trash block id.  All mutation goes through this class so the
    refcount invariant holds: every non-trash table entry owns
    exactly one reference on its block.
    """

    def __init__(
        self,
        *,
        n_blocks: int | None = None,
        block_size: int,
        max_slots: int,
        max_seq: int,
    ):
        self.block_size = int(block_size)
        self.max_slots = int(max_slots)
        # enough table entries to cover max_seq positions — the ONE
        # derivation of the table width (the decoder's executable
        # shapes adopt it; a second copy of this ceil-div drifting
        # would make gathers read the wrong positions)
        self.max_blocks = -(-int(max_seq) // self.block_size)
        if n_blocks is None:
            # full provisioning (== contiguous HBM); the paged win
            # appears when the caller sets n_blocks BELOW this and
            # admission still succeeds because requests only hold
            # the blocks they use
            n_blocks = self.max_slots * self.max_blocks
        self.allocator = BlockAllocator(n_blocks, block_size)
        self.trash_id = int(n_blocks)   # pools hold one extra block
        self.tables = np.full(
            (self.max_slots, self.max_blocks), self.trash_id, np.int32
        )
        # blocks each slot's table actually owns (prefix of the row)
        self.n_owned = [0] * self.max_slots

    def blocks_for(self, n_tokens: int) -> int:
        """Table entries needed to cover ``n_tokens`` positions."""
        return -(-int(n_tokens) // self.block_size)

    # -- slot lifecycle ----------------------------------------------------

    def assign(self, slot: int, adopted: list[int], n_total: int) -> None:
        """Give ``slot`` a table of ``n_total`` blocks: the
        ``adopted`` shared blocks first (the caller has ALREADY taken
        one reference each — ownership transfers to the table), then
        freshly allocated exclusive ones.  Atomic: on ``OutOfBlocks``
        nothing is assigned and the adopted references are NOT
        consumed (the caller still owns and must release them)."""
        assert self.n_owned[slot] == 0, f"slot {slot} already assigned"
        assert n_total <= self.max_blocks, (n_total, self.max_blocks)
        n_new = n_total - len(adopted)
        fresh = self.allocator.alloc_many(n_new)  # may raise, atomically
        row = list(adopted) + fresh
        self.tables[slot, : len(row)] = row
        self.tables[slot, len(row):] = self.trash_id
        self.n_owned[slot] = len(row)

    def grow(self, slot: int, bidx: int) -> None:
        """Extend ``slot``'s table through block index ``bidx``
        (decode crossed a block boundary).  Raises ``OutOfBlocks``
        atomically when the pool can't cover it."""
        need = bidx + 1 - self.n_owned[slot]
        if need <= 0:
            return
        fresh = self.allocator.alloc_many(need)
        for i, bid in enumerate(fresh):
            self.tables[slot, self.n_owned[slot] + i] = bid
        self.n_owned[slot] += need

    def ensure_writable(self, slot: int, bidx: int, copy_block) -> bool:
        """Copy-on-write gate: if the block at table index ``bidx``
        is SHARED (refcount > 1 — a prefix-cache entry or another
        slot also points at it), copy it to a fresh exclusive block
        via ``copy_block(src, dst)`` (the decoder's jitted
        device-side copy), swap the table entry, and drop the shared
        reference.  Returns True when a copy happened."""
        assert bidx < self.n_owned[slot], (slot, bidx, self.n_owned[slot])
        bid = int(self.tables[slot, bidx])
        if self.allocator.refcount(bid) <= 1:
            return False
        fresh = self.allocator.alloc()            # may raise OutOfBlocks
        copy_block(bid, fresh)
        self.tables[slot, bidx] = fresh
        self.allocator.deref(bid)
        self.allocator.n_cow += 1
        return True

    def free_slot(self, slot: int) -> None:
        """Release every block the slot's table owns (shared blocks
        survive under their remaining references) and reset the row
        to trash."""
        for i in range(self.n_owned[slot]):
            self.allocator.deref(int(self.tables[slot, i]))
        self.tables[slot, :] = self.trash_id
        self.n_owned[slot] = 0

    def slot_blocks(self, slot: int, n: int | None = None) -> list[int]:
        """The first ``n`` (default: all owned) block ids of the
        slot's table."""
        n = self.n_owned[slot] if n is None else n
        assert n <= self.n_owned[slot]
        return [int(b) for b in self.tables[slot, :n]]

    def release_adopted(self, adopted: list[int]) -> None:
        """Failure path of an admission attempt: give back the
        references ``match`` handed out."""
        for bid in adopted:
            self.allocator.deref(bid)
