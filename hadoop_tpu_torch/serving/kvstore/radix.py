"""Block-granular radix index over fully-filled prompt KV blocks.

The port's own copy of ``hadoop_tpu/serving/kvstore/radix.py``, device
tier only: the chain digests, hit counts and eviction hook that feed the
host-RAM and DFS tiers come with those tiers.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, List


class _RadixNode:
    __slots__ = ("key", "block", "parent", "children")

    def __init__(self, key=None, block=None, parent=None):
        self.key = key          # tuple of block_size tokens
        self.block = block      # pool page holding this chunk's K/V
        self.parent = parent
        self.children: Dict[tuple, "_RadixNode"] = {}


class PrefixCache:
    """Radix index over fully-filled prompt blocks: a trie at block
    granularity, where the path from the root IS the token prefix — so
    a block is only ever matched under the exact full prefix its K/V
    was computed for (KV at position i depends on tokens 0..i, not just
    the block's own tokens).

    The cache holds no refcounts itself; the pool's refcount is the
    truth. A node is evictable when it is a leaf and its block's
    refcount is zero; ``evict`` pops such leaves in LRU order (leaves
    first keeps the tree consistent — a parent can only go after its
    children). ``_lru`` holds ONLY the current leaves, in recency order
    (moved-to-end on every touch); evicting a leaf promotes a
    newly-childless parent to the cold end."""

    def __init__(self, block_size: int):
        self.block_size = block_size
        self._root = _RadixNode()
        self._nodes: Dict[int, _RadixNode] = {}        # every cached page
        self._lru: "OrderedDict[int, _RadixNode]" = OrderedDict()  # leaves

    def __len__(self) -> int:
        return len(self._nodes)

    def contains_block(self, block: int) -> bool:
        return block in self._nodes

    def _touch(self, node: _RadixNode) -> None:
        if node.block in self._lru:
            self._lru.move_to_end(node.block)

    def match(self, tokens: List[int]) -> List[int]:
        """Longest cached full-block prefix of ``tokens``; returns the
        pages in prefix order (no refcounting — caller pins them)."""
        node = self._root
        out: List[int] = []
        bs = self.block_size
        for i in range(len(tokens) // bs):
            child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            self._touch(child)
            out.append(child.block)
            node = child
        return out

    def insert(self, tokens: List[int], blocks: List[int]) -> int:
        """Register fully-filled pages for ``tokens`` (one page per
        ``block_size`` chunk, aligned). First writer wins: an existing
        node keeps its page and the duplicate stays with its owner (it
        is freed on that request's release). Returns how many pages
        were newly registered."""
        node = self._root
        new = 0
        bs = self.block_size
        for i, blk in enumerate(blocks):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = _RadixNode(key, blk, node)
                node.children[key] = child
                self._nodes[blk] = child
                if node is not self._root:
                    self._lru.pop(node.block, None)    # no longer a leaf
                self._lru[blk] = child
                new += 1
            else:
                self._touch(child)
            node = child
        return new

    def evict(self, n: int, refcount: Callable[[int], int]) -> List[int]:
        """Drop up to ``n`` LRU zero-ref leaf pages from the index and
        return them (caller returns them to the pool's free list)."""
        out: List[int] = []
        while len(out) < n:
            victim = None
            for blk, node in self._lru.items():  # oldest leaf first;
                if refcount(blk) == 0:           # scan past pinned ones
                    victim = node
                    break
            if victim is None:
                break
            del self._lru[victim.block]
            del self._nodes[victim.block]
            del victim.parent.children[victim.key]
            out.append(victim.block)
            parent = victim.parent
            if parent is not self._root and not parent.children:
                # newly a leaf, and at least as stale as the child we
                # just dropped: promote to the cold end of the LRU
                self._lru[parent.block] = parent
                self._lru.move_to_end(parent.block, last=False)
        return out
