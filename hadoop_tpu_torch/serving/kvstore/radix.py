"""Block-granular radix index over fully-filled prompt KV blocks.

The port's own copy of ``hadoop_tpu/serving/kvstore/radix.py``. Every
node carries a **chain digest** — a hash of the ENTIRE token prefix from
the root down to (and including) this node's chunk — which is the key
the host-RAM and DFS tiers store the block's payload under. KV at
position ``i`` depends on tokens ``0..i``, so the digest chains:
``digest = H(parent.digest || chunk_tokens)``; two blocks holding the
same tokens under different heads hash differently, exactly like the
trie path already guarantees for the HBM tier. The digests equal the
reference's byte for byte, so a DFS store is shared across the two
packages. Nodes also count ``hits`` (cross-request matches) so the tier
manager can persist hot shared prefixes past a conf-keyed threshold.
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import Callable, Dict, List, Optional


def chain_digest(parent_digest: bytes, chunk: tuple) -> bytes:
    """Digest of a prefix extended by one block-sized token chunk."""
    h = hashlib.sha256(parent_digest)
    h.update(("|".join(str(t) for t in chunk)).encode())
    return h.digest()


class _RadixNode:
    __slots__ = ("key", "block", "parent", "children", "digest", "hits",
                 "persisted")

    def __init__(self, key=None, block=None, parent=None,
                 digest: bytes = b""):
        self.key = key          # tuple of block_size tokens
        self.block = block      # pool page holding this chunk's K/V
        self.parent = parent
        self.children: Dict[tuple, "_RadixNode"] = {}
        self.digest = digest    # chain hash of the full prefix to here
        self.hits = 0           # cross-request matches (promotion signal)
        self.persisted = False  # already durable in the DFS tier


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
    newly-childless parent to the cold end. So the steady-state
    eviction — pool full of zero-ref cache, evict one page per block
    allocation — pops the front in O(1) under the scheduler lock,
    scanning past a node only when it is pinned (actively shared).

    ``salt`` seeds the root digest: the tier manager folds the KV
    layout (layers/heads/dims/dtype/block size) in, so payloads from an
    incompatible engine shape can never key-collide in a shared store.
    """

    def __init__(self, block_size: int, salt: bytes = b""):
        self.block_size = block_size
        self._root = _RadixNode(digest=salt)
        self._nodes: Dict[int, _RadixNode] = {}        # every cached page
        self._lru: "OrderedDict[int, _RadixNode]" = OrderedDict()  # leaves

    def __len__(self) -> int:
        return len(self._nodes)

    @property
    def root_digest(self) -> bytes:
        return self._root.digest

    def contains_block(self, block: int) -> bool:
        return block in self._nodes

    def node_for_block(self, block: int) -> Optional[_RadixNode]:
        return self._nodes.get(block)

    def nodes(self) -> List["_RadixNode"]:
        """Every resident node (no particular order) — the drain path
        walks these to persist the whole cache."""
        return list(self._nodes.values())

    def _touch(self, node: _RadixNode) -> None:
        if node.block in self._lru:
            self._lru.move_to_end(node.block)

    def match_nodes(self, tokens: List[int]) -> List["_RadixNode"]:
        """Longest cached full-block prefix of ``tokens``; returns the
        nodes in prefix order (no refcounting — caller pins them)."""
        node = self._root
        out: List[_RadixNode] = []
        bs = self.block_size
        for i in range(len(tokens) // bs):
            child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            self._touch(child)
            out.append(child)
            node = child
        return out

    def match(self, tokens: List[int]) -> List[int]:
        """Longest cached full-block prefix of ``tokens``; returns the
        pages in prefix order (no refcounting — caller pins them)."""
        return [n.block for n in self.match_nodes(tokens)]

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
                child = _RadixNode(key, blk, node,
                                   chain_digest(node.digest, key))
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

    def evict(self, n: int, refcount: Callable[[int], int],
              on_evict: Optional[Callable[["_RadixNode"], None]] = None,
              ) -> List[int]:
        """Drop up to ``n`` LRU zero-ref leaf pages from the index and
        return them (caller returns them to the pool's free list).
        ``on_evict`` sees each victim BEFORE its page is dropped — the
        tier manager's demotion hook (the page's bytes are still valid
        in the pool arrays at that point, so the host tier can copy
        them out)."""
        out: List[int] = []
        while len(out) < n:
            victim = None
            for blk, node in self._lru.items():  # oldest leaf first;
                if refcount(blk) == 0:           # scan past pinned ones
                    victim = node
                    break
            if victim is None:
                break
            if on_evict is not None:
                on_evict(victim)
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
