"""Host-RAM KV tier: a ring of fixed slots under a conf-keyed byte budget.

The port's own copy of ``hadoop_tpu/serving/kvstore/hosttier.py``.
Every block payload has one fixed shape (``[L, block_size, Hkv, Dh]``
twice, K and V), so the tier is two preallocated arenas sliced into
fixed slots — no per-block allocation, no fragmentation. Eviction is the
ring itself: when the budget wraps, the oldest slot is overwritten and
its key drops out of the index. A demoted block costs one ``memcpy`` in,
a promotion one ``memcpy`` out; both are host-side only — the device
copies happen in the engine's page movers.

``pin=True`` (the engine's choice on a CUDA device) allocates the arenas
in page-locked memory, which the OS cannot page out and the card copies
from without a staging buffer.

``codec`` (``serving.kv.codec``, the knob the DFS tier honors too): with
``int8`` the arenas hold symmetric per-layer int8 payloads beside a
small f32 scale plane — one quantize on ``put``, one dequantize on
``get`` — so the same ``serving.kv.host.bytes`` budget holds ~4× the
blocks of an f32 engine (~2× bf16). Promotions out of an int8 ring are
allclose rather than bit-exact; ``raw`` (the default) stays
byte-identical. Payloads are numpy arrays in ``codec.storage_dtype``
(bf16 as its uint16 bits).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hadoop_tpu_torch.serving.kvstore.codec import (CODECS, dequant_int8,
                                                    dtype_name, quant_int8,
                                                    storage_dtype)


def _arena(shape: Tuple[int, ...], dtype: np.dtype, pin: bool
           ) -> np.ndarray:
    """A zeroed numpy array, page-locked when ``pin``."""
    if not pin:
        return np.zeros(shape, dtype)
    nbytes = int(np.prod(shape)) * dtype.itemsize
    buf = torch.zeros(max(1, nbytes), dtype=torch.uint8, pin_memory=True)
    return buf.numpy()[:nbytes].view(dtype).reshape(shape)


class HostTier:
    """FIFO ring of demoted KV blocks keyed by prefix chain digest."""

    def __init__(self, shape: Tuple[int, ...], dtype, budget_bytes: int,
                 codec: str = "raw", pin: bool = False):
        if codec not in CODECS:
            raise ValueError(f"serving.kv.codec must be one of {CODECS}, "
                             f"got {codec!r}")
        self.shape = tuple(shape)
        self.dtype = dtype_name(dtype)
        self.codec = codec
        store_dtype = np.dtype(np.int8) if codec == "int8" \
            else storage_dtype(self.dtype)
        n_layers = self.shape[0]
        per_block = 2 * int(np.prod(self.shape)) * store_dtype.itemsize
        if codec == "int8":
            per_block += 2 * n_layers * 4   # the f32 scale planes
        self.block_bytes = per_block
        self.capacity = max(0, int(budget_bytes) // per_block)
        self._k = _arena((self.capacity,) + self.shape, store_dtype, pin)
        self._v = _arena((self.capacity,) + self.shape, store_dtype, pin)
        if codec == "int8":
            self._k_scales = np.zeros((self.capacity, n_layers),
                                      np.float32)
            self._v_scales = np.zeros_like(self._k_scales)
        self._index: Dict[bytes, int] = {}            # guarded-by: _lock
        self._slot_key: List[Optional[bytes]] = \
            [None] * self.capacity                    # guarded-by: _lock
        self._next = 0                                # guarded-by: _lock
        self._lock = threading.Lock()

    def __len__(self) -> int:
        with self._lock:
            return len(self._index)

    @property
    def budget_bytes(self) -> int:
        return self.capacity * self.block_bytes

    def put(self, digest: bytes, k: np.ndarray, v: np.ndarray) -> bool:
        """Copy one block's payload into the ring (overwriting the
        oldest slot when full). Returns False when the tier has no
        capacity at all (budget below one block)."""
        if self.capacity == 0:
            return False
        if self.codec == "int8":
            # quantize OUTSIDE the lock — the ring write below is the
            # memcpy-cheap part a concurrent get should wait on
            kq, ks = quant_int8(k, self.dtype)
            vq, vs = quant_int8(v, self.dtype)
        with self._lock:
            slot = self._index.get(digest)
            if slot is None:
                slot = self._next
                self._next = (self._next + 1) % self.capacity
                old = self._slot_key[slot]
                if old is not None:
                    del self._index[old]
                self._slot_key[slot] = digest
                self._index[digest] = slot
            if self.codec == "int8":
                self._k[slot] = kq
                self._v[slot] = vq
                self._k_scales[slot] = ks
                self._v_scales[slot] = vs
            else:
                self._k[slot] = k
                self._v[slot] = v
        return True

    def _snapshot(self, slot: int) -> Tuple:
        """Copy one slot's raw payload (+ scales). Caller holds the
        lock — this is the memcpy-cheap part a concurrent ring wrap
        must not race; the float-expanding dequant runs OUTSIDE it."""
        if self.codec == "int8":
            return (self._k[slot].copy(), self._v[slot].copy(),
                    self._k_scales[slot].copy(),
                    self._v_scales[slot].copy())
        return self._k[slot].copy(), self._v[slot].copy(), None, None

    def _decode(self, snap: Tuple) -> Tuple[np.ndarray, np.ndarray]:
        """Materialize a snapshot's (K, V) in the engine dtype's storage
        — lock NOT held."""
        k, v, ks, vs = snap
        if ks is None:
            return k, v
        return (dequant_int8(k, ks, self.dtype),
                dequant_int8(v, vs, self.dtype))

    def items(self) -> List[Tuple[bytes, np.ndarray, np.ndarray]]:
        """Copies of every resident (digest, K, V) — the drain path
        persists the whole ring to the DFS tier before the process
        exits. Raw payloads copied under the lock like ``get``;
        decoded after it drops."""
        with self._lock:
            snaps = [(d, self._snapshot(s))
                     for d, s in self._index.items()]
        return [(d,) + self._decode(snap) for d, snap in snaps]

    def get(self, digest: bytes
            ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Copies of the block's (K, V), or None. Raw payload copied
        under the lock so a concurrent ring wrap can't overwrite the
        view mid-read; decoded after it drops."""
        with self._lock:
            slot = self._index.get(digest)
            if slot is None:
                return None
            snap = self._snapshot(slot)
        return self._decode(snap)
