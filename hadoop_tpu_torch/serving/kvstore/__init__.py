"""The serving KV store of the port: the refcounted page pool and the
radix prefix index (device tier; the host and DFS tiers come later)."""

from hadoop_tpu_torch.serving.kvstore.pool import BlockPool
from hadoop_tpu_torch.serving.kvstore.radix import PrefixCache

__all__ = ["BlockPool", "PrefixCache"]
