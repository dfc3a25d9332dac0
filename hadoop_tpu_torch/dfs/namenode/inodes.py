"""In-memory namespace: inode tree + directory operations.

The port's copy of ``hadoop_tpu/dfs/namenode/inodes.py``, on the same
wire and disk formats.

Parity with the reference namespace core (ref: server/namenode/INode.java,
INodeFile.java, INodeDirectory.java, FSDirectory.java (2,077 LoC)): a rooted
tree of directories and files, files holding ordered block lists, with
owner/permission/times metadata. All mutations happen under the namesystem
lock (see fsnamesystem.py) — this module is lock-free by contract.
"""

from __future__ import annotations

import time
from typing import Dict, Iterator, List, Optional

from hadoop_tpu_torch.dfs.protocol.records import Block, FileStatus


class INode:
    __slots__ = ("name", "parent", "mtime", "atime", "owner", "group",
                 "permission", "xattrs", "acl", "storage_policy")

    def __init__(self, name: str, owner: str = "", group: str = "",
                 permission: int = 0o755):
        self.name = name
        self.parent: Optional["INodeDirectory"] = None
        self.mtime = time.time()
        self.atime = self.mtime
        self.owner = owner
        self.group = group
        self.permission = permission
        # Extended attributes (ref: XAttrFeature; user./trusted./system.
        # namespaces enforced at the RPC layer).
        self.xattrs: Optional[Dict[str, bytes]] = None
        # ACL entries beyond the permission bits (ref: AclFeature):
        # list of "type:name:perms" strings, e.g. "user:alice:rw-".
        self.acl: Optional[List[str]] = None
        # Storage policy name (ref: BlockStoragePolicySuite; HOT default,
        # inherited from the nearest ancestor that sets one).
        self.storage_policy: Optional[str] = None

    @property
    def is_dir(self) -> bool:
        return isinstance(self, INodeDirectory)

    def full_path(self) -> str:
        parts: List[str] = []
        node: Optional[INode] = self
        while node is not None and node.parent is not None:
            parts.append(node.name)
            node = node.parent
        return "/" + "/".join(reversed(parts))


class INodeFile(INode):
    __slots__ = ("replication", "block_size", "blocks", "under_construction",
                 "client_name", "ec_policy")

    def __init__(self, name: str, replication: int, block_size: int,
                 owner: str = "", permission: int = 0o644,
                 ec_policy: Optional[str] = None):
        super().__init__(name, owner=owner, permission=permission)
        self.replication = replication
        self.block_size = block_size
        self.blocks: List[Block] = []
        self.under_construction = False
        self.client_name: Optional[str] = None  # lease holder while open
        # Striped layout policy name, fixed at create (ref: INodeFile's
        # erasure-coding-policy ID in its header).
        self.ec_policy: Optional[str] = ec_policy

    def length(self) -> int:
        return sum(b.num_bytes for b in self.blocks)

    def last_block(self) -> Optional[Block]:
        return self.blocks[-1] if self.blocks else None

    def status(self, path: Optional[str] = None) -> FileStatus:
        return FileStatus(path if path is not None else self.full_path(),
                          False, self.length(), self.replication,
                          self.block_size, self.mtime, self.atime,
                          self.owner, self.group, self.permission,
                          ec_policy=self.ec_policy)


class INodeDirectory(INode):
    __slots__ = ("children", "ec_policy", "ns_quota", "space_quota",
                 "snapshottable", "snapshots")

    def __init__(self, name: str, owner: str = "", permission: int = 0o755):
        super().__init__(name, owner=owner, permission=permission)
        self.children: Dict[str, INode] = {}
        # EC policy set on this directory; inherited by files created under
        # it (ref: ErasureCodingPolicyManager + the EC xattr on dirs).
        self.ec_policy: Optional[str] = None
        # Quotas (ref: DirectoryWithQuotaFeature): -1 = unset.
        self.ns_quota: int = -1      # max inodes in subtree
        self.space_quota: int = -1   # max bytes × replication in subtree
        # Snapshots (ref: DirectorySnapshottableFeature): name → captured
        # root (an immutable deep copy of this subtree's metadata; block
        # objects are shared, the snapshot pins them against deletion).
        self.snapshottable = False
        self.snapshots: Optional[Dict[str, "INodeDirectory"]] = None

    def add_child(self, node: INode) -> None:
        node.parent = self
        self.children[node.name] = node
        self.mtime = time.time()

    def remove_child(self, name: str) -> Optional[INode]:
        node = self.children.pop(name, None)
        if node is not None:
            node.parent = None
            self.mtime = time.time()
        return node

    def get_child(self, name: str) -> Optional[INode]:
        return self.children.get(name)

    def status(self, path: Optional[str] = None) -> FileStatus:
        return FileStatus(path if path is not None else self.full_path(),
                          True, 0, 0, 0, self.mtime, self.atime, self.owner,
                          self.group, self.permission)


def _components(path: str) -> List[str]:
    # NOTE: deliberately permissive about "." / ".." — this resolver is
    # shared with edit-log REPLAY and with cleanup of inodes a pre-fix
    # tree may hold; name VALIDITY is enforced at the name-creating op
    # entries instead (FSNamesystem.check_path_names, the reference's
    # DFSUtil.isValidName placement).
    if not path.startswith("/"):
        raise ValueError(f"path must be absolute: {path!r}")
    return [c for c in path.split("/") if c]


SNAPSHOT_DIR = ".snapshot"


def snapshot_copy(node: INode) -> INode:
    """Immutable metadata copy of a subtree for a snapshot (ref:
    snapshot/Snapshot.java's root copy). Block objects are shared — the
    snapshot pins them, it does not duplicate data."""
    if isinstance(node, INodeDirectory):
        cp = INodeDirectory(node.name, owner=node.owner,
                            permission=node.permission)
        cp.group = node.group
        cp.mtime, cp.atime = node.mtime, node.atime
        cp.ec_policy = node.ec_policy
        cp.storage_policy = node.storage_policy
        cp.xattrs = dict(node.xattrs) if node.xattrs else None
        cp.acl = list(node.acl) if node.acl else None
        for child in node.children.values():
            cp.add_child(snapshot_copy(child))
        return cp
    f: INodeFile = node  # type: ignore[assignment]
    cp = INodeFile(f.name, f.replication, f.block_size, owner=f.owner,
                   permission=f.permission, ec_policy=f.ec_policy)
    cp.group = f.group
    cp.mtime, cp.atime = f.mtime, f.atime
    cp.storage_policy = f.storage_policy
    cp.xattrs = dict(f.xattrs) if f.xattrs else None
    cp.acl = list(f.acl) if f.acl else None
    if f.under_construction:
        # The trailing blocks of an open file are still mutated in place
        # (commit/recovery update num_bytes/gen_stamp on the shared
        # objects) — value-copy so the snapshot stays frozen at the
        # capture point. Finalized files' blocks are immutable and safe
        # to share.
        cp.blocks = [Block(b.block_id, b.gen_stamp, b.num_bytes)
                     for b in f.blocks]
    else:
        cp.blocks = list(f.blocks)
    return cp


def subtree_counts(node: INode) -> tuple:
    """(inodes, space) where space = Σ file length × replication — the
    quota dimensions (ref: QuotaCounts)."""
    inodes = 0
    space = 0
    for n in iter_tree(node):
        inodes += 1
        if isinstance(n, INodeFile):
            rep = 1 if n.ec_policy else max(1, n.replication)
            space += n.length() * rep
    return inodes, space


class FSDirectory:
    """Path-indexed view over the inode tree. Ref: FSDirectory.java."""

    def __init__(self):
        self.root = INodeDirectory("")
        self._inode_count = 1

    # ------------------------------------------------------------- resolve

    def get_inode(self, path: str) -> Optional[INode]:
        node: INode = self.root
        comps = _components(path)
        i = 0
        while i < len(comps):
            comp = comps[i]
            if not isinstance(node, INodeDirectory):
                return None
            if comp == SNAPSHOT_DIR and node.snapshottable:
                # /dir/.snapshot/<name>/... resolves inside the captured
                # subtree (ref: INodeDirectory.getChild's snapshot path).
                if i + 1 >= len(comps):
                    return node  # "/dir/.snapshot" itself → listed specially
                snap = (node.snapshots or {}).get(comps[i + 1])
                if snap is None:
                    return None
                node = snap
                i += 2
                continue
            nxt = node.get_child(comp)
            if nxt is None:
                return None
            node = nxt
            i += 1
        return node

    def get_parent(self, path: str) -> Optional[INodeDirectory]:
        comps = _components(path)
        if not comps:
            return None
        node: INode = self.root
        for comp in comps[:-1]:
            if not isinstance(node, INodeDirectory):
                return None
            nxt = node.get_child(comp)
            if nxt is None:
                return None
            node = nxt
        return node if isinstance(node, INodeDirectory) else None

    def exists(self, path: str) -> bool:
        return self.get_inode(path) is not None

    # ------------------------------------------------------------ mutations

    def mkdirs(self, path: str, owner: str = "",
               permission: int = 0o755) -> INodeDirectory:
        """Create all missing path components. Ref: FSDirectory.mkdirs."""
        node: INode = self.root
        for comp in _components(path):
            if not isinstance(node, INodeDirectory):
                raise NotADirectoryError(
                    f"{node.full_path()} is a file in path {path}")
            nxt = node.get_child(comp)
            if nxt is None:
                nxt = INodeDirectory(comp, owner=owner, permission=permission)
                node.add_child(nxt)
                self._inode_count += 1
            node = nxt
        if not isinstance(node, INodeDirectory):
            raise NotADirectoryError(f"{path} exists as a file")
        return node

    def add_file(self, path: str, replication: int, block_size: int,
                 owner: str = "", permission: int = 0o644,
                 ec_policy: Optional[str] = None) -> INodeFile:
        comps = _components(path)
        if not comps:
            raise IsADirectoryError("cannot create file at /")
        parent = self.mkdirs("/" + "/".join(comps[:-1]), owner=owner)
        if parent.get_child(comps[-1]) is not None:
            raise FileExistsError(f"{path} already exists")
        f = INodeFile(comps[-1], replication, block_size, owner=owner,
                      permission=permission, ec_policy=ec_policy)
        parent.add_child(f)
        self._inode_count += 1
        return f

    def delete(self, path: str, recursive: bool) -> Optional[INode]:
        """Detach the subtree at path; caller collects its blocks.
        Ref: FSDirectory.delete."""
        node = self.get_inode(path)
        if node is None:
            return None
        if node is self.root:
            raise PermissionError("cannot delete /")
        if isinstance(node, INodeDirectory) and node.children and not recursive:
            raise OSError(f"{path} is non-empty; use recursive delete")
        node.parent.remove_child(node.name)
        self._inode_count -= sum(1 for _ in iter_tree(node))
        return node

    def rename(self, src: str, dst: str) -> str:
        """POSIX-ish rename. Ref: FSDirectory.renameTo (RENAME semantics:
        fail if dst exists; moving into an existing dir targets dst/basename).
        Returns the actual destination path (after into-dir adjustment)."""
        node = self.get_inode(src)
        if node is None:
            raise FileNotFoundError(f"rename source {src} not found")
        if node is self.root:
            raise PermissionError("cannot rename /")
        dst_node = self.get_inode(dst)
        if isinstance(dst_node, INodeDirectory):
            dst = dst.rstrip("/") + "/" + node.name
            dst_node = self.get_inode(dst)
        if dst_node is not None:
            raise FileExistsError(f"rename target {dst} exists")
        if dst.startswith(src.rstrip("/") + "/"):
            raise ValueError(f"cannot rename {src} under itself: {dst}")
        dst_parent = self.get_parent(dst)
        if dst_parent is None:
            raise FileNotFoundError(f"rename target parent missing: {dst}")
        node.parent.remove_child(node.name)
        node.name = _components(dst)[-1]
        dst_parent.add_child(node)
        return dst

    # ------------------------------------------------------------- queries

    def listing(self, path: str) -> List[FileStatus]:
        base = path.rstrip("/")
        if base.endswith("/" + SNAPSHOT_DIR):
            parent = self.get_inode(base[:-len(SNAPSHOT_DIR) - 1] or "/")
            if not isinstance(parent, INodeDirectory) or \
                    not parent.snapshottable:
                raise FileNotFoundError(path)
            return [snap.status(f"{base}/{name}")
                    for name, snap in sorted((parent.snapshots or {}).items())]
        node = self.get_inode(path)
        if node is None:
            raise FileNotFoundError(path)
        if isinstance(node, INodeDirectory):
            return [child.status(f"{base}/{name}" if base else f"/{name}")
                    for name, child in sorted(node.children.items())]
        return [node.status(path)]

    def num_inodes(self) -> int:
        return self._inode_count


def iter_tree(node: INode) -> Iterator[INode]:
    yield node
    if isinstance(node, INodeDirectory):
        for child in list(node.children.values()):
            yield from iter_tree(child)


def collect_blocks(node: INode) -> List[Block]:
    out: List[Block] = []
    for n in iter_tree(node):
        if isinstance(n, INodeFile):
            out.extend(n.blocks)
    return out
