"""Tier-aware KV cache manager: HBM radix → host-RAM ring → DFS store.

The port's own copy of ``hadoop_tpu/serving/kvstore/tiered.py``, with
the reference's policy, conf keys, chain salt and statistics; payloads
are numpy arrays in ``codec.storage_dtype`` (bf16 as its uint16 bits).

Policy (the engine stays the device owner; this module owns storage and
placement decisions):

- **Demote before drop.** When the HBM tier evicts a zero-ref cached
  page to feed a live allocation, its payload is copied into the host
  ring first (``demote`` runs inside the radix eviction, while the
  page's bytes are still valid in the pool arrays). Only cold pages
  demote — a page with a positive refcount is never evictable in the
  first place, so an active decode can never lose KV under it.

- **Miss walks down.** A radix miss at admission consults the host
  ring, then the DFS store, chunk by chunk along the prefix chain
  (``fetch_cold``); a hit is injected back into a pool page and
  re-registered in the radix so siblings share it from HBM. Only the
  still-uncached tail falls back to prefill.

- **Hot prefixes go durable.** Every cross-request radix match bumps
  the node's hit count; at ``serving.kv.dfs.min-refs`` the block is
  extracted once and handed to a background writer that persists it
  through the DFS write pipeline — admission never blocks on a
  DataNode. ``persist_prefix`` is the forced variant the
  prefill/decode disaggregation handoff uses.

All mutation of radix/pool state happens on the engine's scheduler
thread under its scheduler lock; the host ring and the writer queue
have their own locks and never call back into the engine — the lock
order is strictly engine → tier, so the filesystem path (reached from
the writer thread WITHOUT the scheduler lock) cannot close a cycle. The
writer thread sees host copies only: it never touches a device tensor
and never calls back into the engine.
"""

from __future__ import annotations

import hashlib
import logging
import queue
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from hadoop_tpu_torch.serving.kvstore.codec import CODECS, dtype_name
from hadoop_tpu_torch.serving.kvstore.dfstier import DFSTier
from hadoop_tpu_torch.serving.kvstore.hosttier import HostTier
from hadoop_tpu_torch.serving.kvstore.pool import BlockPool
from hadoop_tpu_torch.serving.kvstore.radix import (PrefixCache,
                                                    _RadixNode,
                                                    chain_digest)
from hadoop_tpu_torch.tracing import carry_context, global_tracer

log = logging.getLogger(__name__)

HOST_BYTES_KEY = "serving.kv.host.bytes"
DFS_ENABLE_KEY = "serving.kv.dfs.enable"
DFS_DIR_KEY = "serving.kv.dfs.dir"
DFS_MIN_REFS_KEY = "serving.kv.dfs.min-refs"
CODEC_KEY = "serving.kv.codec"
FETCH_WINDOW_KEY = "serving.kv.fetch.window"


@dataclass
class ColdHit:
    """One chunk recovered from a cold tier, awaiting injection."""
    tier: str           # "host" | "dfs"
    digest: bytes
    k: np.ndarray
    v: np.ndarray


class TieredKVCache:
    """Storage/policy face of the KV cache; the engine owns the device
    arrays and passes ``extract(block) -> (k_np, v_np)`` for the
    payload copies demotion and persistence need. ``dtype`` is numpy's
    name of the KV dtype (a numpy or torch dtype is accepted and named);
    ``pin`` allocates the host ring in page-locked memory."""

    def __init__(self, pool: BlockPool, *, layers: int, kv_heads: int,
                 head_dim: int, dtype, enabled: bool = True,
                 host_bytes: int = 0, fs=None,
                 dfs_dir: str = "/kvcache", dfs_min_refs: int = 1,
                 codec: str = "raw", fetch_window: int = 4,
                 metrics=None, tracer=None,
                 extract: Optional[Callable] = None, pin: bool = False):
        if codec not in CODECS:
            raise ValueError(f"{CODEC_KEY} must be one of {CODECS}, "
                             f"got {codec!r}")
        self.pool = pool
        self.block_size = pool.block_size
        shape = (layers, pool.block_size, kv_heads, head_dim)
        self.block_shape = shape
        self.dtype = dtype_name(dtype)
        # the salt folds the KV layout into every chain digest, so two
        # engines with incompatible shapes sharing one store can never
        # key-collide (the per-file header is the second, loud, check)
        salt = hashlib.sha256(
            f"htpu-kv1:{layers}:{pool.block_size}:{kv_heads}:"
            f"{head_dim}:{self.dtype}".encode()).digest()
        # the chain root: held here (not only on the radix) so the
        # radix-less chain surfaces — longctx ingest/read — key blocks
        # identically to the radix tier they interoperate with
        self.chain_salt = salt
        self.radix = PrefixCache(pool.block_size, salt=salt) if enabled \
            else None
        self.host = HostTier(shape, self.dtype, host_bytes,
                             codec=codec, pin=pin) \
            if enabled and host_bytes > 0 else None
        if self.host is not None and self.host.capacity == 0:
            log.warning("%s=%d holds zero KV blocks (one block is %d "
                        "bytes); host tier disabled", HOST_BYTES_KEY,
                        host_bytes, self.host.block_bytes)
            self.host = None
        self.dfs = DFSTier(fs, dfs_dir, shape=shape, dtype=self.dtype,
                           codec=codec) if enabled and fs is not None \
            else None
        self.dfs_min_refs = max(1, int(dfs_min_refs))
        self.codec = codec
        self.metrics = metrics
        self.tracer = tracer or global_tracer()
        self._extract = extract
        # engine-local lifetime stats (the process-global metrics source
        # is shared across engines in one process — tests and the bench
        # read these instead)
        self.hits = {"hbm": 0, "host": 0, "dfs": 0}
        self.demotions = 0
        self.promotions = 0
        self.persists_enqueued = 0
        self.persists_done = 0      # guarded-by: _stats_lock
        self.persist_failures = 0   # guarded-by: _stats_lock
        self._stats_lock = threading.Lock()
        self._write_q: "queue.Queue" = queue.Queue()
        self._writer: Optional[threading.Thread] = None
        # cold DFS chunks are read in speculative parallel windows of
        # this many blocks (``serving.kv.fetch.window``): one DataNode
        # round-trip of wall time per window instead of one per block
        # (the walk runs under the scheduler lock, so every serial
        # round-trip is a decode stall for the whole replica); reads
        # past the chain's first miss are wasted but bounded by the
        # window. The default of 4 suits short radix-miss tails; a
        # long-context chain wants a window sized so the whole chain
        # pages in with O(chain/window) round trips, not O(chain).
        self.fetch_window = max(1, int(fetch_window))
        self._fetch_pool = ThreadPoolExecutor(
            max_workers=min(self.fetch_window, 32),
            thread_name_prefix="kv-dfs-fetch") if self.dfs is not None \
            else None
        self.chain_ingested = 0     # longctx blocks streamed in

    # ------------------------------------------------------------- flags

    @property
    def cold_enabled(self) -> bool:
        return self.host is not None or self.dfs is not None

    @property
    def dfs_enabled(self) -> bool:
        return self.dfs is not None

    def set_extract(self, fn: Callable) -> None:
        self._extract = fn

    # ---------------------------------------------------------- demotion

    def demote(self, node: _RadixNode) -> None:
        """Radix eviction hook: spill the victim's payload to the host
        ring before the page returns to the free list. Costs one
        device→host copy per evicted block — only armed when the host
        tier exists."""
        if self.host is None or self._extract is None:
            return
        k, v = self._extract(node.block)
        if self.host.put(node.digest, k, v):
            self.demotions += 1
            if self.metrics:
                self.metrics.kv_demotions.incr()

    # ------------------------------------------------------ cold fetches

    def fetch_cold(self, ctx: List[int], start_block: int, limit: int,
                   parent_ctx=None, start_digest: Optional[bytes] = None
                   ) -> List[ColdHit]:
        """Probe host then DFS for consecutive full-block chunks
        ``[start_block, limit)`` of ``ctx``, stopping at the first
        chunk neither tier holds (the chain must stay contiguous — a
        gap would leave unprefilled positions behind cached ones).
        ``start_digest`` is the chain digest of ``ctx``'s first
        ``start_block`` chunks when the caller already holds it (the
        matched radix node carries exactly this value) — without it the
        chain is rehashed from the root."""
        if not self.cold_enabled or start_block >= limit:
            return []
        bs = self.block_size
        if start_digest is not None:
            digest = start_digest
        else:
            digest = self.chain_salt
            for i in range(start_block):
                digest = chain_digest(digest,
                                      tuple(ctx[i * bs:(i + 1) * bs]))
        digests: List[bytes] = []
        for i in range(start_block, limit):
            digest = chain_digest(digest,
                                  tuple(ctx[i * bs:(i + 1) * bs]))
            digests.append(digest)
        hits: List[ColdHit] = []
        lookahead: Dict[bytes, Any] = {}
        sp = None
        try:
            for idx, digest in enumerate(digests):
                got, tier = None, None
                if self.host is not None:
                    t0 = time.monotonic()
                    got = self.host.get(digest)
                    if got is not None:
                        tier = "host"
                        if self.metrics:
                            # hits only: a miss is a microsecond dict
                            # probe that would drown the real memcpy
                            # latency the histogram advertises
                            self.metrics.kv_fetch_hist["host"].add(
                                time.monotonic() - t0)
                if got is None and self.dfs is not None:
                    if sp is None:
                        # one span covers the whole cold walk; it joins
                        # the request's trace through the carried door
                        # context (the scheduler thread holds no
                        # contextvar of its own)
                        sp = self.tracer.span("serving.kv.fetch",
                                              parent=parent_ctx)
                    if digest not in lookahead:
                        lookahead = self._dfs_read_window(digests, idx)
                    got = lookahead.get(digest)
                    tier = "dfs"
                if got is None:
                    break
                hits.append(ColdHit(tier, digest, got[0], got[1]))
        finally:
            if sp is not None:
                sp.add_kv("blocks_host",
                          str(sum(1 for h in hits if h.tier == "host")))
                sp.add_kv("blocks_dfs",
                          str(sum(1 for h in hits if h.tier == "dfs")))
                sp.finish()
        return hits

    def _dfs_read_window(self, digests: List[bytes], idx: int
                         ) -> Dict[bytes, Optional[Tuple]]:
        """Read DFS chunks ``digests[idx : idx+window]`` concurrently
        (each a full hedged-read round trip) and return digest →
        payload-or-None. Every read records its own fetch latency —
        a DFS miss is a real DataNode round trip, unlike a host probe."""
        window = digests[idx:idx + self.fetch_window]

        def read(d: bytes):
            t0 = time.monotonic()
            got = self.dfs.get(d)
            if self.metrics:
                self.metrics.kv_fetch_hist["dfs"].add(
                    time.monotonic() - t0)
            return d, got

        if len(window) == 1:
            return dict([read(window[0])])
        if self._fetch_pool is None:
            # no executor (hand-wired tests): read the whole window
            # serially so the caller's lookahead still covers it
            return dict(read(d) for d in window)
        return dict(self._fetch_pool.map(read, window))

    def read_chain(self, ctx: List[int], limit: int, parent_ctx=None
                   ) -> List[ColdHit]:
        """Page a digest chain back from the cold tiers WITHOUT going
        through the radix/pool (the long-context decode path: the
        chain lands host-resident and visits HBM one window at a
        time, never as pool pages). Same contiguity contract and
        speculative DFS windows as ``fetch_cold``; per-tier hit
        counters are bumped here because no ``mark_promoted``
        follows."""
        hits = self.fetch_cold(ctx, 0, limit, parent_ctx=parent_ctx)
        for h in hits:
            self.hits[h.tier] += 1
            if self.metrics:
                (self.metrics.kv_hits_host if h.tier == "host"
                 else self.metrics.kv_hits_dfs).incr()
        return hits

    # --------------------------------------------------- streamed ingest

    def ingest_chain(self, tokens: List[int], payloads,
                     parent_ctx=None) -> int:
        """Stream full-block KV payloads for ``tokens`` straight into
        the cold tiers — the long-context prefill sink. ``payloads``
        yields ``(k, v)`` ``[L, bs, Hkv, Dh]`` blocks in chain order
        (a generator: the caller never holds the whole context);
        each lands in the host ring now and rides the background DFS
        writer (digest-chained with the SAME salt/keying as the radix
        tier, so a later radix-path admission — or another replica —
        maps these blocks like any other persisted prefix; the codec
        applies per tier exactly as on the demotion path). Returns the
        number of blocks ingested."""
        bs = self.block_size
        digest = self.chain_salt
        n = 0
        for k, v in payloads:
            digest = chain_digest(digest,
                                  tuple(tokens[n * bs:(n + 1) * bs]))
            if self.host is not None:
                self.host.put(digest, np.asarray(k), np.asarray(v))
            if self.dfs is not None:
                self._enqueue_raw(digest, np.asarray(k), np.asarray(v),
                                  parent_ctx)
            n += 1
        self.chain_ingested += n
        return n

    def mark_promoted(self, hits: List[ColdHit], pages: List[int]
                      ) -> None:
        """Cold payloads are now resident in ``pages`` and registered
        in the radix: carry over durability (a DFS-sourced block is
        already persisted) and count the traffic."""
        for hit, page in zip(hits, pages):
            node = self.radix.node_for_block(page) if self.radix else None
            if node is not None:
                node.hits = 1
                if hit.tier == "dfs":
                    node.persisted = True
            self.hits[hit.tier] += 1
            self.promotions += 1
            if self.metrics:
                self.metrics.kv_promotions.incr()
                (self.metrics.kv_hits_host if hit.tier == "host"
                 else self.metrics.kv_hits_dfs).incr()

    # ------------------------------------------------------- hot persist

    def note_match(self, nodes: List[_RadixNode], parent_ctx=None,
                   count: bool = True) -> None:
        """HBM radix hits at admission: bump per-node hit counts and
        enqueue DFS persistence for nodes crossing the threshold.
        ``count=False`` for a preempted request re-matching its own
        surviving blocks — warm resume is not fleet-level reuse, so it
        neither counts as a hit nor heats the node toward DFS
        persistence (a thrashing pool re-admitting one private prompt
        must not push its blocks over the min-refs threshold)."""
        if not count or not nodes:
            return
        self.hits["hbm"] += len(nodes)
        if self.metrics:
            self.metrics.kv_hits_hbm.incr(len(nodes))
        if self.dfs is None:
            return
        for n in nodes:
            n.hits += 1
            if not n.persisted and n.hits >= self.dfs_min_refs:
                self._enqueue_persist(n, parent_ctx)

    def persist_prefix(self, tokens: List[int], parent_ctx=None) -> int:
        """Force-persist every cached full block of ``tokens`` (the
        disaggregation handoff: the prefill replica calls this right
        after prefilling, bypassing the hotness threshold). Returns the
        durable span in blocks — already-persisted blocks count, they
        are exactly as durable. Caller holds the scheduler lock."""
        if self.dfs is None or self.radix is None:
            return 0
        nodes = self.radix.match_nodes(tokens)
        for node in nodes:
            if not node.persisted:
                self._enqueue_persist(node, parent_ctx)
        return len(nodes)

    def persist_resident(self, parent_ctx=None) -> int:
        """Drain-time handoff: enqueue persistence of EVERY resident
        cached block — the whole HBM radix (not just min-refs-hot
        nodes) plus the host ring — so scale-in hands the fleet its
        cache instead of torching it. A block another replica already
        persisted dedups at the DFSTier rename. Caller holds the
        scheduler lock (same contract as ``persist_prefix``); returns
        the number of blocks enqueued, which bounds the caller's
        ``flush`` watermark."""
        if self.dfs is None:
            return 0
        n = 0
        if self.radix is not None:
            for node in self.radix.nodes():
                if not node.persisted:
                    self._enqueue_persist(node, parent_ctx)
                    n += 1
        if self.host is not None:
            for digest, k, v in self.host.items():
                self._enqueue_raw(digest, k, v, parent_ctx)
                n += 1
        return n

    def _enqueue_raw(self, digest: bytes, k, v, parent_ctx) -> None:
        """Persist a payload that has no radix node (a host-ring entry
        whose HBM page is long gone). Rides the same writer queue and
        done/failure counters so ``flush`` watermarks cover it."""
        self.persists_enqueued += 1
        job = carry_context(
            lambda: self._write_block(None, k, v, parent_ctx,
                                      digest=digest))
        self._write_q.put(job)
        self._ensure_writer()

    def _enqueue_persist(self, node: _RadixNode, parent_ctx) -> None:
        """Extract now (scheduler thread — the page could be evicted or
        rewritten the moment the lock drops), write later (writer
        thread — the DataNode round-trip must not stall admission)."""
        if self._extract is None:
            return
        k, v = self._extract(node.block)
        node.persisted = True   # cleared by the writer on failure
        self.persists_enqueued += 1
        job = carry_context(
            lambda: self._write_block(node, k, v, parent_ctx))
        self._write_q.put(job)
        self._ensure_writer()

    def _ensure_writer(self) -> None:
        if self._writer is None:
            self._writer = threading.Thread(
                target=self._write_loop, name="kv-dfs-writer",
                daemon=True)
            self._writer.start()

    def _write_block(self, node: Optional[_RadixNode], k, v, parent_ctx,
                     digest: Optional[bytes] = None) -> None:
        sp = self.tracer.span("serving.kv.persist", parent=parent_ctx)
        sp.add_kv("bytes", str(k.nbytes + v.nbytes))
        sp.add_kv("codec", self.codec)
        ok = False
        try:
            ok = self.dfs.put(node.digest if node is not None
                              else digest, k, v)
        finally:
            sp.add_kv("ok", str(ok))
            sp.finish()
            if not ok and node is not None:
                # let a later hot match retry the write; MUST precede
                # the counter bump — flush() returns the moment
                # done+failures reaches its watermark, and the caller
                # immediately reads node.persisted for the durable span
                node.persisted = False
            with self._stats_lock:
                if ok:
                    self.persists_done += 1
                else:
                    self.persist_failures += 1
            if ok and self.metrics:
                self.metrics.kv_dfs_persists.incr()

    def _write_loop(self) -> None:
        while True:
            job = self._write_q.get()
            if job is None:
                return
            try:
                job()
            except Exception as e:  # noqa: BLE001 — a poisoned write
                # must not kill the writer; the block simply stays
                # un-persisted and a later match retries
                log.warning("kv persist job failed: %s", e)
            finally:
                self._write_q.task_done()

    def flush(self, timeout: float = 30.0,
              up_to: Optional[int] = None) -> bool:
        """Wait until the first ``up_to`` enqueued persists have
        completed (default: everything enqueued so far). The watermark
        matters on a busy replica: the scheduler keeps enqueuing
        min-refs persists for other requests while a prefill-door
        flush waits, and chasing the global queue tail could time the
        handoff out long after its own blocks went durable."""
        target = self.persists_enqueued if up_to is None else up_to
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._stats_lock:
                done = self.persists_done + self.persist_failures
            if done >= target:
                return True
            time.sleep(0.005)
        return False

    def persisted_span(self, tokens: List[int]) -> int:
        """Contiguous head blocks of ``tokens`` currently marked
        durable in the radix — the writer clears ``persisted`` on a
        failed write, so after a ``flush`` this is the span a decode
        replica will actually find on the DataNodes. Caller holds the
        scheduler lock."""
        if self.dfs is None or self.radix is None:
            return 0
        n = 0
        for node in self.radix.match_nodes(tokens):
            if not node.persisted:
                break
            n += 1
        return n

    def close(self) -> None:
        if self._writer is not None:
            self._write_q.put(None)
            self._writer.join(timeout=5.0)
            self._writer = None
        if self._fetch_pool is not None:
            self._fetch_pool.shutdown(wait=False)
            self._fetch_pool = None

    # ------------------------------------------------------------- stats

    def stats(self) -> Dict[str, Any]:
        with self._stats_lock:
            done, failed = self.persists_done, self.persist_failures
        return {
            "host_enabled": self.host is not None,
            "dfs_enabled": self.dfs is not None,
            "codec": self.codec,
            "hits_hbm": self.hits["hbm"],
            "hits_host": self.hits["host"],
            "hits_dfs": self.hits["dfs"],
            "demotions": self.demotions,
            "promotions": self.promotions,
            "host_resident": len(self.host) if self.host is not None
                             else 0,
            "host_capacity_blocks": self.host.capacity
                                    if self.host is not None else 0,
            "dfs_persists": done,
            "dfs_persist_failures": failed,
            "chain_ingested": self.chain_ingested,
            "fetch_window": self.fetch_window,
        }
