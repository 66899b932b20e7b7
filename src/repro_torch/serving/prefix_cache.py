"""Coded prefix caching: a radix cache over token prefixes (the port of
``repro.serving.prefix_cache``, in torch).

Every repeated prefix token re-pays its prefill — and in CoCoI its prefill
is a stack of *coded dispatches*: encode, n pieces, k-th-arrival decode.
Work that is skipped beats work that is merely protected, so the cache
never issues those dispatches at all.

A :class:`PrefixCache` is a radix tree (trie over fixed-size token
*blocks*) whose nodes own the post-decode KV slices of their block of
positions, as device tensors.  On admission the scheduler walks the tree
with the new prompt; every matched block's KV is restored into the lane's
ring cache and its coded GEMMs never run (counted on the executor's own
dispatch and run counters).  Only the unmatched suffix is prefilled; a
near-total hit's one-token suffix falls below every scheme's k and cannot
reach the pool at all.

* **Position-safe** — stored K/V are post-RoPE at absolute positions, and a
  prefix occupies the same positions in every prompt that shares it.
* **Coding-agnostic** — entries are post-*decode* plaintext, so
  ``Engine.retarget_coded``, worker churn or a backend swap invalidate
  nothing.
* **Deterministic eviction** — LRU by bytes with a monotone access counter
  and creation-order tie-breaks.

An entry's size is counted from its tensors' ``numel() * element_size()``:
no entry is copied to the host to be measured.  The cache never interprets
the KV trees it stores (the engine slices and reassembles them).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

__all__ = ["PrefixCache", "PrefixCacheStats"]


@dataclasses.dataclass
class PrefixCacheStats:
    """Cumulative counters; scheduler StepRecords snapshot deltas."""

    lookups: int = 0
    hits: int = 0            # lookups that matched >= 1 block
    misses: int = 0
    hit_tokens: int = 0      # prefill positions skipped via restored KV
    inserted_tokens: int = 0  # positions newly materialized into the tree
    evictions: int = 0        # blocks evicted
    evicted_tokens: int = 0

    @property
    def hit_rate(self) -> float:
        """Fraction of lookups that hit (not token-weighted)."""
        return self.hits / self.lookups if self.lookups else 0.0


class _Node:
    """One radix block: ``block`` tokens of KV, keyed by the token tuple."""

    __slots__ = ("key", "kv", "bytes", "children", "last_used", "order")

    def __init__(self, key: tuple, kv, nbytes: int, order: int):
        self.key = key
        self.kv = kv
        self.bytes = nbytes
        self.children: dict[tuple, _Node] = {}
        self.last_used = order
        self.order = order


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes  # host arrays (test doubles)


def _tree_bytes(kv) -> int:
    """Resident bytes of one entry, read from the tensors' sizes (a device
    tensor is never copied to the host to be measured)."""
    return int(sum(_nbytes(x) for x in _leaves(kv)))


class PrefixCache:
    """Radix cache of post-decode KV segments, block-granular, LRU-by-bytes.

    ``block`` is the match/storage granularity in tokens: prefixes are
    cached and matched in whole blocks only (a partial tail block is
    never stored — it would poison lookups for prompts that diverge
    inside it).  ``capacity_bytes`` bounds the resident KV; inserts that
    overflow it evict least-recently-used *leaf* blocks first (a parent
    block is always at least as recently used as its hottest descendant,
    so leaves-first LRU never strands an unreachable interior node).
    """

    def __init__(self, capacity_bytes: int = 64 << 20, block: int = 8):
        if block < 1:
            raise ValueError(f"need block >= 1, got {block}")
        if capacity_bytes < 1:
            raise ValueError(
                f"need capacity_bytes >= 1, got {capacity_bytes}")
        self.capacity_bytes = int(capacity_bytes)
        self.block = int(block)
        self._root: dict[tuple, _Node] = {}
        self._tick = 0
        self._order = 0
        self.bytes = 0
        self.stats = PrefixCacheStats()

    # -- internals ---------------------------------------------------------
    def _keys(self, tokens: Sequence[int]) -> list[tuple]:
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        nb = len(toks) // self.block  # whole blocks only
        return [tuple(toks[i * self.block:(i + 1) * self.block])
                for i in range(nb)]

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_used = self._tick

    # -- the API -----------------------------------------------------------
    def lookup(self, tokens: Sequence[int]) -> tuple[int, list]:
        """Longest cached prefix of ``tokens``: (hit length in tokens,
        [per-block KV segments, shallowest first]).

        Callers wanting a first token out of a FULL hit should look up
        ``prompt[:-1]`` — the last prompt position must always be
        computed (its logits mint the first generated token), exactly the
        vLLM rule.  Matched nodes are LRU-touched root-to-leaf.
        """
        hit = 0
        segs: list = []
        level = self._root
        self.stats.lookups += 1
        for key in self._keys(tokens):
            node = level.get(key)
            if node is None:
                break
            self._touch(node)
            hit += self.block
            segs.append(node.kv)
            level = node.children
        if hit:
            self.stats.hits += 1
            self.stats.hit_tokens += hit
        else:
            self.stats.misses += 1
        return hit, segs

    def insert(self, tokens: Sequence[int],
               segment_fn: Callable[[int, int], object]) -> int:
        """Cache ``tokens``'s whole-block prefixes.

        ``segment_fn(t0, t1)`` materializes the KV slice for positions
        [t0, t1) — called ONLY for blocks the tree does not already hold,
        so re-inserting a hot prefix is a pure LRU refresh (no copies).
        Returns the number of newly inserted tokens.  Eviction runs after
        the insert; the path just inserted is the most recently used, so
        it survives unless a single prompt alone exceeds capacity.
        """
        level = self._root
        added = 0
        for i, key in enumerate(self._keys(tokens)):
            node = level.get(key)
            if node is None:
                t0, t1 = i * self.block, (i + 1) * self.block
                kv = segment_fn(t0, t1)
                self._order += 1
                node = _Node(key, kv, _tree_bytes(kv), self._order)
                level[key] = node
                self.bytes += node.bytes
                added += self.block
            self._touch(node)
            level = node.children
        if added:
            self.stats.inserted_tokens += added
            self._evict()
        return added

    def _evict(self) -> None:
        """Drop LRU leaf blocks until the resident bytes fit capacity."""
        while self.bytes > self.capacity_bytes:
            leaf = None  # (last_used, order, parent_level, key)
            stack: list[tuple[dict, tuple]] = [(self._root, k)
                                               for k in self._root]
            while stack:
                level, key = stack.pop()
                node = level[key]
                if node.children:
                    stack.extend((node.children, k) for k in node.children)
                elif leaf is None or ((node.last_used, node.order)
                                      < (leaf[0], leaf[1])):
                    leaf = (node.last_used, node.order, level, key)
            if leaf is None:
                return  # tree empty; nothing left to free
            _, _, level, key = leaf
            node = level.pop(key)
            self.bytes -= node.bytes
            self.stats.evictions += 1
            self.stats.evicted_tokens += self.block

    def clear(self) -> None:
        """Drop every entry (stats are kept — they describe history)."""
        self._root.clear()
        self.bytes = 0

    @property
    def n_blocks(self) -> int:
        count = 0
        stack = list(self._root.values())
        while stack:
            node = stack.pop()
            count += 1
            stack.extend(node.children.values())
        return count
