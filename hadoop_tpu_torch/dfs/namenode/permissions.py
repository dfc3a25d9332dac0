"""POSIX-model permission enforcement for the namespace.

The port's copy of ``hadoop_tpu/dfs/namenode/permissions.py``, on the
same wire and disk formats.

Parity with the reference's FSPermissionChecker (ref: hadoop-hdfs
server/namenode/FSPermissionChecker.java — per-op checks of the stored
owner/group/mode bits: EXECUTE to traverse every ancestor directory,
READ/WRITE/EXECUTE on the target or its parent depending on the op,
owner-or-superuser for chmod/chown-class ops; gated by
``dfs.permissions.enabled`` with a superuser bypass for the NameNode's
own user and the configured supergroup, FSNamesystem.java's
isPermissionEnabled / pc.checkSuperuserPrivilege pattern).

Named-entry ACLs layered on the mode bits: an inode carrying ACL
entries of the form ``user:<name>:rwx`` / ``group:<name>:r-x`` grants
those principals the listed bits in addition to the owner/group/other
classes (ref: the AclFeature consult inside FSPermissionChecker.check).
"""

from __future__ import annotations

from typing import List, Optional

from hadoop_tpu_torch.dfs.namenode.inodes import (SNAPSHOT_DIR, INode,
                                            INodeDirectory)
# The RPC-registered exception type (ipc/errors.py) so a denial crosses
# the wire as itself, not a generic RemoteError.
from hadoop_tpu_torch.security.ugi import AccessControlError  # noqa: F401

READ, WRITE, EXECUTE = 4, 2, 1


def _acl_bits(inode: INode, user: str, groups: List[str]) -> Optional[int]:
    """Bits granted to ``user`` by named ACL entries, or None when no
    entry names them. Entries look like "user:bob:rw-" / "group:eng:r-x"
    (the FsShell setfacl format this framework stores verbatim)."""
    granted = None
    for entry in inode.acl or ():
        parts = str(entry).split(":")
        if len(parts) != 3:
            continue
        kind, name, perm = parts
        if (kind == "user" and name == user) or \
                (kind == "group" and name in groups):
            bits = (READ if "r" in perm else 0) | \
                   (WRITE if "w" in perm else 0) | \
                   (EXECUTE if "x" in perm else 0)
            granted = bits if granted is None else granted | bits
    return granted


class FSPermissionChecker:
    """One caller's view: user + groups, with the superuser bypass."""

    def __init__(self, user: str, groups: List[str], superuser: str,
                 supergroup: str):
        self.user = user
        self.groups = list(groups or [])
        self.is_superuser = (user == superuser or
                             supergroup in self.groups)

    def _class_bits(self, inode: INode) -> int:
        mode = inode.permission
        if self.user == inode.owner:
            return (mode >> 6) & 7
        if inode.group and inode.group in self.groups:
            return (mode >> 3) & 7
        return mode & 7

    def _has(self, inode: INode, want: int) -> bool:
        if self._class_bits(inode) & want == want:
            return True
        acl = _acl_bits(inode, self.user, self.groups)
        return acl is not None and acl & want == want

    def _require(self, inode: INode, want: int, path: str,
                 what: str) -> None:
        if not self._has(inode, want):
            need = "".join(n for b, n in ((READ, "r"), (WRITE, "w"),
                                          (EXECUTE, "x")) if want & b)
            raise AccessControlError(
                f"Permission denied: user={self.user}, access={need} "
                f"({what}) inode=\"{path}\" owner={inode.owner} "
                f"group={inode.group} mode={inode.permission:04o}")

    def check(self, fsdir, path: str, *, parent: int = 0,
              target: int = 0, owner_only: bool = False,
              sub_dirs: int = 0) -> None:
        """Walk ``path`` enforcing EXECUTE on every ancestor directory,
        then ``parent`` bits on the deepest existing ancestor directory
        and ``target`` bits on the final inode when it exists.
        ``owner_only``: the final inode must be owned by this caller
        (chmod/chown/snapshot-admin class ops). ``sub_dirs``: bits
        required on EVERY directory of the target's subtree — the
        recursive-delete guard (ref: FSPermissionChecker.checkSubAccess
        with subAccess=ALL)."""
        if self.is_superuser:
            return
        from hadoop_tpu_torch.dfs.namenode.inodes import _components
        comps = _components(path)
        node: Optional[INode] = fsdir.root
        last_dir: INodeDirectory = fsdir.root
        i = 0
        while i < len(comps) and node is not None:
            if not isinstance(node, INodeDirectory):
                # an intermediate component is a regular file: the
                # target cannot exist under it. Treat as not-found (the
                # op raises its own FileNotFoundError/NotADirectory)
                # instead of applying target/sticky bits to the file
                # inode (ref: the reference resolves this as an invalid
                # path, not an access decision on the wrong inode).
                node = None
                break
            self._require(node, EXECUTE, path, "traverse")
            last_dir = node
            comp = comps[i]
            if comp == SNAPSHOT_DIR and node.snapshottable:
                if i + 1 >= len(comps):
                    node = node
                    break
                node = (node.snapshots or {}).get(comps[i + 1])
                i += 2
                continue
            node = node.get_child(comp)
            i += 1
        if parent:
            self._require(last_dir, parent, path, "parent")
            if parent & WRITE and node is not None and \
                    last_dir.permission & 0o1000 and \
                    self.user not in (last_dir.owner, node.owner):
                # sticky bit (ref: FSPermissionChecker.checkStickyBit):
                # in a shared 1777 dir, only the entry's owner or the
                # dir's owner may remove/rename it
                raise AccessControlError(
                    f"Permission denied by sticky bit: user={self.user} "
                    f"on \"{path}\" (inode owner={node.owner}, parent "
                    f"owner={last_dir.owner})")
        if node is not None:
            if target:
                self._require(node, target, path, "target")
            if sub_dirs and isinstance(node, INodeDirectory):
                stack = [node]
                while stack:
                    d = stack.pop()
                    self._require(d, sub_dirs, path, "subtree")
                    for child in d.children.values():
                        if isinstance(child, INodeDirectory):
                            stack.append(child)
            if owner_only and self.user != node.owner:
                raise AccessControlError(
                    f"Permission denied: user={self.user} is not the "
                    f"owner of inode \"{path}\" (owner={node.owner})")
        elif owner_only:
            # a missing target cannot be administered
            raise AccessControlError(
                f"Permission denied: {path} does not exist")
