"""Namespace checkpoint images.

The port's copy of ``hadoop_tpu/dfs/namenode/fsimage.py``, on the same
wire and disk formats.

Parity with the reference's fsimage (ref: server/namenode/FSImage.java
(1,562 LoC), FSImageFormatProtobuf.java): the full namespace serialized to
``fsimage_<txid>`` with an MD5 side file; startup loads the newest image then
replays edit segments past its txid (FSNamesystem.loadFromDisk:766). Saving
writes to ``.ckpt`` then renames — a torn save never shadows a good image.
"""

from __future__ import annotations

import hashlib
import logging
import os
from typing import Dict, List, Optional, Tuple

log = logging.getLogger(__name__)

from hadoop_tpu_torch.dfs.namenode.inodes import (FSDirectory, INode,
                                            INodeDirectory, INodeFile)
from hadoop_tpu_torch.dfs.protocol.records import Block
from hadoop_tpu_torch.io.wire import pack, unpack


def _common_attrs(node: INode, d: Dict) -> Dict:
    if node.xattrs:
        d["xa"] = dict(node.xattrs)
    if node.acl:
        d["acl"] = list(node.acl)
    if node.storage_policy:
        d["sp"] = node.storage_policy
    return d


def _restore_common(node: INode, d: Dict) -> None:
    node.mtime = d.get("mt", 0.0)
    node.group = d.get("g", "")
    node.xattrs = dict(d["xa"]) if d.get("xa") else None
    node.acl = list(d["acl"]) if d.get("acl") else None
    node.storage_policy = d.get("sp")


def _serialize_node(node: INode) -> Dict:
    if isinstance(node, INodeDirectory):
        d = {
            "k": "d", "n": node.name, "mt": node.mtime, "o": node.owner,
            "g": node.group, "pm": node.permission,
            "c": [_serialize_node(c) for c in node.children.values()],
        }
        if node.ec_policy:
            d["ec"] = node.ec_policy
        if node.ns_quota >= 0 or node.space_quota >= 0:
            d["nq"], d["sq"] = node.ns_quota, node.space_quota
        if node.snapshottable:
            d["snap"] = {name: _serialize_node(root)
                         for name, root in (node.snapshots or {}).items()}
        return _common_attrs(node, d)
    f: INodeFile = node  # type: ignore[assignment]
    d = {
        "k": "f", "n": f.name, "mt": f.mtime, "o": f.owner, "g": f.group,
        "pm": f.permission, "rep": f.replication, "bs": f.block_size,
        "uc": f.under_construction, "cl": f.client_name,
        "b": [b.to_wire() for b in f.blocks],
    }
    if f.ec_policy:
        d["ec"] = f.ec_policy
    return _common_attrs(f, d)


def _deserialize_node(d: Dict) -> INode:
    if d["k"] == "d":
        node = INodeDirectory(d["n"], owner=d.get("o", ""),
                              permission=d.get("pm", 0o755))
        _restore_common(node, d)
        node.ec_policy = d.get("ec")
        node.ns_quota = d.get("nq", -1)
        node.space_quota = d.get("sq", -1)
        if "snap" in d:
            node.snapshottable = True
            node.snapshots = {name: _deserialize_node(sd)
                              for name, sd in d["snap"].items()}
        for cd in d.get("c", []):
            node.add_child(_deserialize_node(cd))
        return node
    f = INodeFile(d["n"], d.get("rep", 3), d.get("bs", 0),
                  owner=d.get("o", ""), permission=d.get("pm", 0o644),
                  ec_policy=d.get("ec"))
    _restore_common(f, d)
    f.under_construction = d.get("uc", False)
    f.client_name = d.get("cl")
    f.blocks = [Block.from_wire(b) for b in d.get("b", [])]
    return f


class FSImage:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    def save(self, fsdir: FSDirectory, txid: int, extra: Dict) -> str:
        """Checkpoint the namespace as of ``txid``. ``extra`` carries counters
        that must survive restart (next block id, generation stamp, leases)."""
        payload = pack({
            "v": 1, "txid": txid, "extra": extra,
            "root": _serialize_node(fsdir.root),
            "inodes": fsdir.num_inodes(),
        })
        digest = hashlib.md5(payload).hexdigest()
        final = os.path.join(self.dir, f"fsimage_{txid:019d}")
        tmp = final + ".ckpt"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)
        # tmp+rename the side file too: a crash between the image rename
        # and a bare md5 write left a torn .md5 that failed load() hard
        md5_tmp = final + ".md5.tmp"
        with open(md5_tmp, "w") as f:
            f.write(digest)
            f.flush()
            os.fsync(f.fileno())
        os.replace(md5_tmp, final + ".md5")
        return final

    def _images(self) -> List[Tuple[int, str]]:
        out: List[Tuple[int, str]] = []
        for name in os.listdir(self.dir):
            if name.startswith("fsimage_") and not name.endswith(
                    (".md5", ".ckpt", ".tmp")):
                out.append((int(name.split("_", 1)[1]),
                            os.path.join(self.dir, name)))
        return sorted(out)

    def newest_image(self) -> Optional[Tuple[int, str]]:
        images = self._images()
        return images[-1] if images else None

    def load(self) -> Optional[Tuple[int, FSDirectory, Dict]]:
        """Load the newest VERIFIABLE image; returns (txid, fsdir,
        extra) or None. A corrupt/torn newest image falls back to the
        next retained one (the edit log replays the difference) instead
        of refusing to start — ref: FSImage iterating candidate images
        in save-order until one loads."""
        images = self._images()
        if not images:
            return None
        last_err: Optional[Exception] = None
        for txid, path in reversed(images):
            try:
                with open(path, "rb") as f:
                    payload = f.read()
                md5_path = path + ".md5"
                if os.path.exists(md5_path):
                    with open(md5_path) as f:
                        want = f.read().strip()
                    if not want:
                        # empty side file = the pre-atomic-write crash
                        # artifact; treat like a missing one (nothing to
                        # validate against) rather than condemning a
                        # perfectly good image
                        log.warning("fsimage %s has an empty .md5; "
                                    "skipping digest check", path)
                    else:
                        got = hashlib.md5(payload).hexdigest()
                        if want != got:
                            raise IOError(
                                f"fsimage {path} is corrupt (md5 {got} "
                                f"!= recorded {want})")
                d = unpack(payload)
            except Exception as e:  # noqa: BLE001 — try the older image
                log.error("fsimage %s unusable (%s); trying older", path, e)
                last_err = e
                continue
            fsdir = FSDirectory()
            fsdir.root = _deserialize_node(d["root"])  # type: ignore[assignment]
            fsdir._inode_count = d.get("inodes", 1)
            return d["txid"], fsdir, d.get("extra", {})
        raise IOError(f"no loadable fsimage in {self.dir}") from last_err

    def purge_old(self, keep: int = 2) -> None:
        """Retain the newest ``keep`` images. Ref: NNStorageRetentionManager."""
        images: List[Tuple[int, str]] = []
        for name in os.listdir(self.dir):
            if name.startswith("fsimage_") and not name.endswith((".md5", ".ckpt")):
                images.append((int(name.split("_", 1)[1]),
                               os.path.join(self.dir, name)))
        for _, path in sorted(images)[:-keep]:
            os.remove(path)
            if os.path.exists(path + ".md5"):
                os.remove(path + ".md5")
