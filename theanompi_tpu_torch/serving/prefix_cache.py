"""Radix prefix cache over paged KV blocks (serving v2).

The dominant pattern when millions of users hit one deployment is a
SHARED SYSTEM PROMPT: thousands of requests whose token streams agree
on a long prefix.  The v1 engine re-prefilled that prefix per request.
This cache (the SGLang RadixAttention idea, adapted to block-granular
paging) maps token-id prefixes → the physical KV blocks that already
hold their computed K/V, so a new request ADOPTS the prefix blocks
(refcount bump, zero prefill compute) and only prefills its divergent
suffix.

Structure: a block-granularity trie.  Each node covers up to
``block_size`` consecutive tokens and owns one reference on one
physical block; children of a FULL node are keyed by their exact
token tuple.  Matching walks exact full-block children greedily, then
takes the best common prefix against one more child (full or
partial) — adopting a block mid-way is safe because the adopter's
first write into it passes the ``BlockManager.ensure_writable``
copy-on-write gate.  Partial tails with different tokens coexist as
sibling leaves (a true radix would merge them; duplication is bounded
by LRU eviction and keeps insert/match branch-free).

Eviction is leaf-only and LRU by a deterministic logical clock: only
nodes whose block has refcount 1 (held ONLY by the cache) are
evictable — evicting a block a live slot still reads would corrupt
it.  ``evict(n)`` is what the engine calls when the allocator runs
dry, before declaring ``no_blocks``.

All bitwise guarantees survive adoption: K/V rows are a per-row
function of the token prefix and absolute position only (row-wise
matmuls, per-position RoPE), so an adopted block holds bit-identical
content to what a cold prefill of the same tokens would write —
``tests/test_torch_decoder.py`` pins hit-vs-cold token equality.

A copy of ``theanompi_tpu/serving/prefix_cache.py`` (numpy only), its
import pointed at the port's ``blocks``.
"""

from __future__ import annotations

from theanompi_tpu_torch.serving.blocks import BlockAllocator


class _Node:
    __slots__ = (
        "tokens", "n_valid", "block", "children", "parent", "last_used",
    )

    def __init__(self, tokens: tuple, block: int | None, parent):
        self.tokens = tokens          # the token ids this block covers
        self.n_valid = len(tokens)    # == block_size for full nodes
        self.block = block            # physical block id (root: None)
        self.children: dict[tuple, _Node] = {}
        self.parent = parent
        self.last_used = 0


class PrefixCache:
    """Block-granularity radix/trie prefix cache over one allocator.

    The cache holds ONE reference per cached block; ``match`` hands
    the caller one more reference per returned block (the caller —
    the slot table — owns releasing it).
    """

    def __init__(self, allocator: BlockAllocator):
        self.allocator = allocator
        self.block_size = allocator.block_size
        self._root = _Node((), None, None)
        self._clock = 0               # logical LRU clock: deterministic
        self.n_lookups = 0
        self.n_hits = 0               # lookups that matched > 0 tokens
        self.matched_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0

    # -- introspection -----------------------------------------------------

    def n_nodes(self) -> int:
        def count(node: _Node) -> int:
            return 1 + sum(count(c) for c in node.children.values())

        return count(self._root) - 1   # root holds no block

    def stats(self) -> dict:
        return {
            "n_nodes": self.n_nodes(),
            "n_lookups": self.n_lookups,
            "n_hits": self.n_hits,
            "matched_tokens": self.matched_tokens,
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
        }

    # -- core operations ---------------------------------------------------

    def match(self, tokens, max_len: int | None = None):
        """Longest cached prefix of ``tokens``, capped at ``max_len``
        (the engine passes ``len(prompt) - 1`` so at least one prompt
        token is always prefilled — its logits seed the first sampled
        token).  Returns ``(matched_len, block_ids)`` where
        ``block_ids`` covers ``ceil(matched_len / block_size)``
        blocks, each with ONE reference taken for the caller."""
        bs = self.block_size
        limit = len(tokens) if max_len is None else min(
            max_len, len(tokens)
        )
        self._clock += 1
        self.n_lookups += 1
        node = self._root
        matched = 0
        blocks: list[int] = []
        while matched < limit:
            rem = tuple(tokens[matched: matched + bs])
            # a full remaining window can walk an exact full child
            if len(rem) == bs and limit - matched >= bs:
                child = node.children.get(rem)
                if child is not None and child.n_valid == bs:
                    self.allocator.ref(child.block)
                    blocks.append(child.block)
                    child.last_used = self._clock
                    matched += bs
                    node = child
                    continue
            # otherwise: best common prefix against ONE more child
            # (full or partial) — adoption stops here, CoW covers
            # the divergent writes
            rem = tuple(tokens[matched: limit])
            best, best_n = None, 0
            for child in node.children.values():
                lim = min(child.n_valid, len(rem))
                n = 0
                while n < lim and child.tokens[n] == rem[n]:
                    n += 1
                if n > best_n:
                    best, best_n = child, n
            if best is not None:
                self.allocator.ref(best.block)
                blocks.append(best.block)
                best.last_used = self._clock
                matched += best_n
            break
        if matched:
            self.n_hits += 1
            self.matched_tokens += matched
        return matched, blocks

    def unrecord_match(self, matched: int) -> None:
        """Roll back the counters of one ``match()`` whose adoption
        was abandoned (admission failed; the engine released the
        adopted references and requeued or shed the request).  A
        queue head retrying every engine step would otherwise record
        one lookup/hit per retry, so ``paging_stats`` could report
        more hits than requests served."""
        self.n_lookups -= 1
        if matched:
            self.n_hits -= 1
            self.matched_tokens -= matched

    def insert(self, tokens, block_ids) -> int:
        """Cache the prefix ``tokens`` whose K/V lives in
        ``block_ids`` (``ceil(len(tokens)/block_size)`` entries — the
        prompt part of a slot's table, immediately after its prefill
        completes).  Existing nodes are kept (their blocks already
        hold identical content — K/V is a deterministic function of
        (prefix, position)); new nodes take one cache-owned reference
        on their block.  Returns the number of newly cached blocks."""
        bs = self.block_size
        self._clock += 1
        node = self._root
        new_blocks = 0
        i = 0
        n = len(tokens)
        while i * bs < n:
            chunk = tuple(tokens[i * bs: min((i + 1) * bs, n)])
            child = node.children.get(chunk)
            if child is None:
                child = _Node(chunk, int(block_ids[i]), node)
                node.children[chunk] = child
                self.allocator.ref(child.block)
                new_blocks += 1
                self.inserted_blocks += 1
            child.last_used = self._clock
            if child.n_valid < bs:
                break           # partial tail: nothing descends past it
            node = child
            i += 1
        return new_blocks

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` blocks by dropping LRU leaves whose
        block the cache alone holds (refcount 1).  Shared leaves
        (a live slot still points at the block) are skipped — their
        turn comes when the slot releases.  Returns blocks actually
        freed.  O(nodes) per eviction — fine at serving scale, where
        eviction is the slow path by construction."""
        freed = 0
        while freed < n_blocks:
            victims = [
                node for node in self._walk(self._root)
                if not node.children
                and self.allocator.refcount(node.block) == 1
            ]
            if not victims:
                break
            victim = min(victims, key=lambda nd: nd.last_used)
            del victim.parent.children[victim.tokens]
            self.allocator.deref(victim.block)   # refcount 1 → freed
            self.evicted_blocks += 1
            freed += 1
        return freed

    def clear(self) -> int:
        """Drop every cached reference (bench arms use this to reset
        warm state between A/B arms).  Returns blocks released."""
        released = 0
        for node in list(self._walk(self._root)):
            self.allocator.deref(node.block)
            released += 1
        self._root = _Node((), None, None)
        return released

    def _walk(self, node: _Node):
        for child in node.children.values():
            yield child
            yield from self._walk(child)
