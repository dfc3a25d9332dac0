"""Tiered KV cache of the port: HBM radix → host-RAM ring → DFS store.

The port's own copies of ``hadoop_tpu/serving/kvstore``, with its
exports: ``BlockPool`` (refcounted device pages), ``PrefixCache``
(block-granular radix with prefix chain digests), ``HostTier`` (a ring
under a byte budget), ``DFSTier`` (blocks persisted through any
``FileSystemLike``), and ``TieredKVCache`` (the demote/fetch/persist
policy that ties them together). ``serving/engine.py`` is a thin
consumer that owns the device pages.
"""

from hadoop_tpu_torch.serving.kvstore.codec import (CODECS, decode_block,
                                                    dequant_int8,
                                                    encode_block,
                                                    quant_int8)
from hadoop_tpu_torch.serving.kvstore.dfstier import DFSTier
from hadoop_tpu_torch.serving.kvstore.hosttier import HostTier
from hadoop_tpu_torch.serving.kvstore.pool import BlockPool
from hadoop_tpu_torch.serving.kvstore.radix import (PrefixCache,
                                                    _RadixNode,
                                                    chain_digest)
from hadoop_tpu_torch.serving.kvstore.tiered import (CODEC_KEY, DFS_DIR_KEY,
                                                     DFS_ENABLE_KEY,
                                                     DFS_MIN_REFS_KEY,
                                                     HOST_BYTES_KEY,
                                                     ColdHit,
                                                     TieredKVCache)

__all__ = [
    "BlockPool", "PrefixCache", "_RadixNode", "chain_digest",
    "HostTier", "DFSTier", "TieredKVCache", "ColdHit",
    "encode_block", "decode_block", "CODECS", "quant_int8",
    "dequant_int8",
    "HOST_BYTES_KEY", "DFS_ENABLE_KEY", "DFS_DIR_KEY",
    "DFS_MIN_REFS_KEY", "CODEC_KEY",
]
