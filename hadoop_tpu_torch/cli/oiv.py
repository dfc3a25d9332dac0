"""Offline Image Viewer + Offline Edits Viewer.

The port's copy of ``hadoop_tpu/cli/oiv.py``: the same text from
either package's name directory.

Parity with the reference tools (ref: hadoop-hdfs tools/
offlineImageViewer/OfflineImageViewerPB.java and tools/
offlineEditsViewer/OfflineEditsViewer.java): inspect NameNode
persistence WITHOUT a running NameNode — the image dumps as one JSON
object per inode, the edit segments as one JSON object per transaction.

  python -m hadoop_tpu_torch.cli.oiv  --name-dir /path/to/nn/name
  python -m hadoop_tpu_torch.cli.oev  --name-dir /path/to/nn/name [--from TXID]
"""

from __future__ import annotations

import json
import os
import sys


def dump_image(name_dir: str, out=sys.stdout) -> int:
    """One JSON line per inode (path, type, attrs). Returns inode count."""
    from hadoop_tpu_torch.dfs.namenode.fsimage import FSImage
    from hadoop_tpu_torch.dfs.namenode.inodes import INodeDirectory, INodeFile
    image = FSImage(os.path.join(name_dir, "image"))
    loaded = image.load()
    if loaded is None:
        print(json.dumps({"error": "no image found"}), file=out)
        return 0
    txid, fsdir, extra = loaded
    print(json.dumps({"image_txid": txid,
                      **{k: v for k, v in extra.items()
                         if isinstance(v, (int, str))}}), file=out)
    count = 0

    def walk(node, path: str) -> None:
        nonlocal count
        count += 1
        if isinstance(node, INodeFile):
            print(json.dumps({
                "path": path or "/", "type": "FILE",
                "replication": node.replication,
                "blocks": [{"id": b.block_id, "gs": b.gen_stamp,
                            "len": b.num_bytes} for b in node.blocks],
                "length": node.length(),
                "owner": getattr(node, "owner", ""),
                "uc": node.under_construction,
            }), file=out)
        else:
            print(json.dumps({
                "path": path or "/", "type": "DIRECTORY",
                "children": len(node.children),
                "owner": getattr(node, "owner", ""),
                "snapshots": sorted((node.snapshots or {}).keys())
                if isinstance(node, INodeDirectory) else [],
            }), file=out)
            for name, child in sorted(node.children.items()):
                walk(child, f"{path}/{name}")

    walk(fsdir.root, "")
    return count


def dump_edits(name_dir: str, from_txid: int = 1, out=sys.stdout) -> int:
    """One JSON line per edit transaction. Returns transaction count."""
    from hadoop_tpu_torch.dfs.namenode.editlog import FileJournalManager
    fjm = FileJournalManager(os.path.join(name_dir, "edits"))
    n = 0
    for rec in fjm.read_edits(from_txid):
        print(json.dumps(rec, default=str), file=out)
        n += 1
    return n


def main_oiv(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="oiv")
    ap.add_argument("--name-dir", required=True)
    args = ap.parse_args(argv)
    dump_image(args.name_dir)
    return 0


def main_oev(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="oev")
    ap.add_argument("--name-dir", required=True)
    ap.add_argument("--from", dest="from_txid", type=int, default=1)
    args = ap.parse_args(argv)
    dump_edits(args.name_dir, args.from_txid)
    return 0


if __name__ == "__main__":
    sys.exit(main_oiv())
