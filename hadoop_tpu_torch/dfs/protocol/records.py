"""DFS protocol records: the wire-visible data types a client reads.

The client half of ``hadoop_tpu/dfs/protocol/records.py``: ``Block``,
``DatanodeID``, ``DatanodeInfo``, ``LocatedBlock`` and ``FileStatus``
with the reference's ``to_wire``/``from_wire`` keys, and the
NameNode's and DataNode's errors a client may get back, registered with
the port's RPC error model under their bare class names, so a reference
daemon's exception (named by its own module path) comes back as the
port's class. It also holds the storage policies' media classes and
``DnCommand`` (NameNode to DataNode), which the port's daemons use.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from hadoop_tpu_torch.ipc.errors import register_exception


class SafeModeError(IOError):
    """Namespace mutations rejected while the NameNode is in safemode."""


class NotReplicatedYetError(IOError):
    """add_block called before the previous block reached min
    replication (retryable)."""


class LeaseExpiredError(IOError):
    pass


class AlreadyBeingCreatedError(IOError):
    pass


class ReplicaNotFoundError(IOError):
    pass


class QuotaExceededError(IOError):
    """Namespace or space quota violated."""


# Which media classes satisfy each storage policy, in preference order
# (ref: BlockStoragePolicySuite's storage-type lists). Shared by the
# placement policy, excess pruning, and the Mover.
POLICY_TYPES = {
    "HOT": ["DISK"],
    "WARM": ["DISK", "ARCHIVE"],
    "COLD": ["ARCHIVE"],
    "ALL_SSD": ["SSD"],
    "ONE_SSD": ["SSD", "DISK"],
    "LAZY_PERSIST": ["RAM_DISK", "DISK"],
    "PROVIDED": ["PROVIDED", "DISK"],
}


def effective_storage_policy(inode) -> str:
    """Nearest ancestor-or-self storage policy; HOT when unset."""
    node = inode
    while node is not None:
        sp = getattr(node, "storage_policy", None)
        if sp:
            return sp
        node = getattr(node, "parent", None)
    return "HOT"


for _cls in (SafeModeError, NotReplicatedYetError, LeaseExpiredError,
             AlreadyBeingCreatedError, ReplicaNotFoundError,
             QuotaExceededError):
    register_exception(_cls)
    register_exception(_cls, _cls.__name__)


class Block:
    """(block_id, generation_stamp, num_bytes). Ref: protocol/Block.java;
    the generation stamp versions replicas across pipeline recoveries."""

    __slots__ = ("block_id", "gen_stamp", "num_bytes")

    def __init__(self, block_id: int, gen_stamp: int, num_bytes: int = 0):
        self.block_id = block_id
        self.gen_stamp = gen_stamp
        self.num_bytes = num_bytes

    def name(self) -> str:
        return f"blk_{self.block_id}_{self.gen_stamp}"

    def to_wire(self) -> Dict:
        return {"id": self.block_id, "gs": self.gen_stamp, "nb": self.num_bytes}

    @classmethod
    def from_wire(cls, d: Dict) -> "Block":
        return cls(d["id"], d["gs"], d.get("nb", 0))

    def __eq__(self, other):
        return (isinstance(other, Block) and other.block_id == self.block_id
                and other.gen_stamp == self.gen_stamp)

    def __hash__(self):
        return hash((self.block_id, self.gen_stamp))

    def __repr__(self):
        return f"{self.name()}(len={self.num_bytes})"


class DatanodeID:
    """Identity + addresses of one block server. Ref: protocol/DatanodeID.java."""

    __slots__ = ("uuid", "host", "xfer_port", "ipc_port", "info_port")

    def __init__(self, uuid: str, host: str, xfer_port: int, ipc_port: int = 0,
                 info_port: int = 0):
        self.uuid = uuid
        self.host = host
        self.xfer_port = xfer_port
        self.ipc_port = ipc_port
        # admin HTTP port (ref: DatanodeID.infoPort) — how the fleet
        # doctor reaches /ws/v1/peers and /ws/v1/stacks on this node
        self.info_port = info_port

    def xfer_addr(self) -> tuple:
        return (self.host, self.xfer_port)

    def to_wire(self) -> Dict:
        return {"u": self.uuid, "h": self.host, "xp": self.xfer_port,
                "ip": self.ipc_port, "inf": self.info_port}

    @classmethod
    def from_wire(cls, d: Dict) -> "DatanodeID":
        return cls(d["u"], d["h"], d["xp"], d.get("ip", 0),
                   d.get("inf", 0))

    def __eq__(self, other):
        return isinstance(other, DatanodeID) and other.uuid == self.uuid

    def __hash__(self):
        return hash(self.uuid)

    def __repr__(self):
        return f"DN[{self.uuid[:8]}@{self.host}:{self.xfer_port}]"


class DatanodeInfo(DatanodeID):
    """DatanodeID + liveness/usage stats. Ref: protocol/DatanodeInfo.java.
    ``storage_type`` is the node's media class (ref: StorageType.java) —
    the dimension storage policies and the Mover act on."""

    __slots__ = ("capacity", "dfs_used", "remaining", "last_heartbeat",
                 "num_blocks", "state", "storage_type")

    STATE_LIVE = "live"
    STATE_DEAD = "dead"
    STATE_DECOMMISSIONING = "decommissioning"
    STATE_DECOMMISSIONED = "decommissioned"
    STATE_ENTERING_MAINTENANCE = "entering_maintenance"
    STATE_IN_MAINTENANCE = "in_maintenance"

    def __init__(self, uuid: str, host: str, xfer_port: int, ipc_port: int = 0,
                 capacity: int = 0, dfs_used: int = 0, remaining: int = 0,
                 storage_type: str = "DISK", info_port: int = 0):
        super().__init__(uuid, host, xfer_port, ipc_port,
                         info_port=info_port)
        self.capacity = capacity
        self.dfs_used = dfs_used
        self.remaining = remaining
        self.last_heartbeat = time.monotonic()
        self.num_blocks = 0
        self.state = self.STATE_LIVE
        self.storage_type = storage_type

    def utilization(self) -> float:
        return self.dfs_used / self.capacity if self.capacity else 0.0

    def to_wire(self) -> Dict:
        d = super().to_wire()
        d.update({"cap": self.capacity, "used": self.dfs_used,
                  "rem": self.remaining, "st": self.state,
                  "nblk": self.num_blocks, "sty": self.storage_type})
        return d

    @classmethod
    def from_wire(cls, d: Dict) -> "DatanodeInfo":
        info = cls(d["u"], d["h"], d["xp"], d.get("ip", 0), d.get("cap", 0),
                   d.get("used", 0), d.get("rem", 0),
                   d.get("sty", "DISK"), info_port=d.get("inf", 0))
        info.state = d.get("st", cls.STATE_LIVE)
        info.num_blocks = d.get("nblk", 0)
        return info


class LocatedBlock:
    """A block + where its replicas live + its offset in the file.
    LocatedStripedBlock.java) ``ec_policy`` names the policy and
    ``indices[i]`` is the storage-unit index served by ``locations[i]``."""

    __slots__ = ("block", "locations", "offset", "corrupt", "ec_policy",
                 "indices", "cached_uuids", "token")

    def __init__(self, block: Block, locations: List[DatanodeInfo],
                 offset: int = 0, corrupt: bool = False,
                 ec_policy: Optional[str] = None,
                 indices: Optional[List[int]] = None,
                 cached_uuids: Optional[List[str]] = None,
                 token: Optional[Dict] = None):
        self.block = block
        self.locations = locations
        self.offset = offset
        self.corrupt = corrupt
        self.ec_policy = ec_policy
        self.indices = indices
        # block access token (ref: LocatedBlock.blockToken) — minted by
        # the NN when dfs.block.access.token.enable is on
        self.token = token
        # replicas pinned in DN memory (ref: LocatedBlock's
        # cachedLocations) — readers prefer these
        self.cached_uuids = cached_uuids or []

    def to_wire(self) -> Dict:
        d = {"b": self.block.to_wire(),
             "locs": [x.to_wire() for x in self.locations],
             "off": self.offset, "cor": self.corrupt}
        if self.ec_policy:
            d["ec"] = self.ec_policy
            d["idx"] = self.indices
        if self.cached_uuids:
            d["cach"] = self.cached_uuids
        if self.token is not None:
            d["tok"] = self.token
        return d

    @classmethod
    def from_wire(cls, d: Dict) -> "LocatedBlock":
        return cls(Block.from_wire(d["b"]),
                   [DatanodeInfo.from_wire(x) for x in d["locs"]],
                   d.get("off", 0), d.get("cor", False),
                   d.get("ec"), d.get("idx"), d.get("cach"),
                   d.get("tok"))


class FileStatus:
    """Ref: fs/FileStatus.java + hdfs HdfsFileStatus.java."""

    __slots__ = ("path", "is_dir", "length", "replication", "block_size",
                 "mtime", "atime", "owner", "group", "permission",
                 "ec_policy")

    def __init__(self, path: str, is_dir: bool, length: int = 0,
                 replication: int = 0, block_size: int = 0,
                 mtime: float = 0.0, atime: float = 0.0, owner: str = "",
                 group: str = "", permission: int = 0o644,
                 ec_policy: Optional[str] = None):
        self.path = path
        self.is_dir = is_dir
        self.length = length
        self.replication = replication
        self.block_size = block_size
        self.mtime = mtime
        self.atime = atime
        self.owner = owner
        self.group = group
        self.permission = permission
        self.ec_policy = ec_policy

    def to_wire(self) -> Dict:
        d = {"p": self.path, "d": self.is_dir, "len": self.length,
             "rep": self.replication, "bs": self.block_size,
             "mt": self.mtime, "at": self.atime, "o": self.owner,
             "g": self.group, "perm": self.permission}
        if self.ec_policy:
            d["ec"] = self.ec_policy
        return d

    @classmethod
    def from_wire(cls, d: Dict) -> "FileStatus":
        return cls(d["p"], d["d"], d.get("len", 0), d.get("rep", 0),
                   d.get("bs", 0), d.get("mt", 0.0), d.get("at", 0.0),
                   d.get("o", ""), d.get("g", ""), d.get("perm", 0o644),
                   d.get("ec"))

    def __repr__(self):
        kind = "dir" if self.is_dir else f"file[{self.length}B]"
        return f"FileStatus({self.path}, {kind})"


class DnCommand:
    """NameNode → DataNode command piggybacked on heartbeat responses.
    Ref: server/protocol/DatanodeProtocol.proto (BlockCommandProto):
    TRANSFER = replicate a block to targets; INVALIDATE = delete blocks;
    RECOVER = recover an under-construction block to a new gen stamp."""

    TRANSFER = "transfer"
    INVALIDATE = "invalidate"
    RECOVER = "recover"
    REREGISTER = "reregister"
    # EC reconstruction (ref: BlockECReconstructionCommand.java): the
    # receiving DN reads surviving units from peers, decodes, and stores
    # the missing unit locally. ``extra`` carries the reconstruction info.
    EC_RECONSTRUCT = "ec_reconstruct"
    # Centralized cache (ref: DatanodeProtocol CACHE/UNCACHE in
    # BlockIdCommandProto): pin/unpin block replicas in memory.
    CACHE = "cache"
    UNCACHE = "uncache"

    def __init__(self, action: str, blocks: Optional[List[Block]] = None,
                 targets: Optional[List[List[DatanodeInfo]]] = None,
                 new_gen_stamps: Optional[List[int]] = None,
                 extra: Optional[Dict] = None):
        self.action = action
        self.blocks = blocks or []
        self.targets = targets or []
        self.new_gen_stamps = new_gen_stamps or []
        self.extra = extra or {}

    def to_wire(self) -> Dict:
        return {
            "a": self.action,
            "b": [b.to_wire() for b in self.blocks],
            "t": [[d.to_wire() for d in tgt] for tgt in self.targets],
            "gs": self.new_gen_stamps,
            "x": self.extra,
        }

    @classmethod
    def from_wire(cls, d: Dict) -> "DnCommand":
        return cls(d["a"], [Block.from_wire(x) for x in d.get("b", [])],
                   [[DatanodeInfo.from_wire(y) for y in t]
                    for t in d.get("t", [])],
                   d.get("gs", []), d.get("x", {}))
