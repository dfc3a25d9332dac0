"""The client half of the DFS protocols: the records (``records``), the
data-transfer frames and their SASL (``datatransfer``), and block
tokens as a client carries them (``blocktoken``)."""

from hadoop_tpu_torch.dfs.protocol.records import (
    AlreadyBeingCreatedError, Block, DatanodeID, DatanodeInfo, FileStatus,
    LeaseExpiredError, LocatedBlock, NotReplicatedYetError,
    QuotaExceededError, ReplicaNotFoundError, SafeModeError)

__all__ = [
    "Block", "DatanodeID", "DatanodeInfo", "LocatedBlock", "FileStatus",
    "SafeModeError", "NotReplicatedYetError", "LeaseExpiredError",
    "AlreadyBeingCreatedError", "ReplicaNotFoundError",
    "QuotaExceededError",
]
