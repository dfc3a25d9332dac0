"""Multi-volume DataNode dataset + the intra-node DiskBalancer.

The port's copy of ``hadoop_tpu/dfs/datanode/volumes.py``, on the same
wire and disk formats.

``VolumeSet`` presents the single-``BlockStore`` API over N data
directories, one ``BlockStore`` per volume (ref: fsdataset/impl/
FsVolumeList.java — volumes each own their replica map; the dataset
routes by block). New replicas pick a volume by available space (ref:
AvailableSpaceVolumeChoosingPolicy.java; ``policy="round-robin"`` for
RoundRobinVolumeChoosingPolicy.java).

``DiskBalancer`` rebalances replicas *between volumes of one node*
(ref: hadoop-hdfs server/diskbalancer/ — DiskBalancerCluster computes
volume-density deltas, planner emits MoveStep's, DiskBalancerMover
copies block files volume→volume). The reference drives it over
ClientDatanodeProtocol (submitDiskBalancerPlan); here the DataNode
exposes report/plan/execute over its admin HTTP endpoint and in-process.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
from typing import Dict, List, Optional

from hadoop_tpu_torch.dfs.datanode.blockstore import (BlockStore, Replica,
                                                ReplicaNotFoundError)

log = logging.getLogger(__name__)


class VolumeSet:
    """N BlockStores behind the BlockStore API, routed by replica."""

    def __init__(self, directories: List[str], chunk_size: int = 512,
                 capacity_override: int = 0, sync_on_close: bool = False,
                 policy: str = "available-space"):
        if not directories:
            raise ValueError("VolumeSet needs at least one directory")
        per_vol_cap = capacity_override // len(directories) \
            if capacity_override else 0
        self.volumes = [BlockStore(d, chunk_size=chunk_size,
                                   capacity_override=per_vol_cap,
                                   sync_on_close=sync_on_close)
                        for d in directories]
        self.policy = policy
        self._rr = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------- routing

    @property
    def dir(self) -> str:  # compat with single-volume callers
        return self.volumes[0].dir

    def _vol_of(self, block_id: int) -> Optional[BlockStore]:
        for v in self.volumes:
            if v.get_replica(block_id) is not None:
                return v
        return None

    def _vol_or_raise(self, block_id: int) -> BlockStore:
        v = self._vol_of(block_id)
        if v is None:
            raise ReplicaNotFoundError(
                f"blk_{block_id} not on this node")
        return v

    def _choose(self) -> BlockStore:
        if self.policy == "round-robin":
            with self._lock:
                v = self.volumes[self._rr % len(self.volumes)]
                self._rr += 1
                return v
        return max(self.volumes, key=lambda v: v.stats()["remaining"])

    # ------------------------------------------------- delegated write path

    def create_rbw(self, block, checksum):
        # Pipeline recovery must land on the volume that already holds
        # the rbw replica (the writer rebind logic lives in that store).
        v = self._vol_of(block.block_id) or self._choose()
        return v.create_rbw(block, checksum)

    def finalize(self, open_rep) -> Replica:
        return open_rep.store.finalize(open_rep)

    def invalidate(self, block) -> bool:
        v = self._vol_of(block.block_id)
        return v.invalidate(block) if v is not None else False

    def finalize_existing(self, block_id: int) -> Optional[Replica]:
        return self._vol_or_raise(block_id).finalize_existing(block_id)

    def update_gen_stamp(self, block_id: int, new_gs: int) -> None:
        self._vol_or_raise(block_id).update_gen_stamp(block_id, new_gs)

    # -------------------------------------------------- delegated read path

    def get_replica(self, block_id: int) -> Optional[Replica]:
        v = self._vol_of(block_id)
        return v.get_replica(block_id) if v is not None else None

    def open_for_read(self, block):
        return self._vol_or_raise(block.block_id).open_for_read(block)

    def read_chunks(self, block, offset: int, length: int, opened=None):
        # ``opened`` is the xceiver's eager open_for_read probe result —
        # must be accepted (and forwarded) or every read on a
        # multi-volume DN dies with TypeError before the setup reply
        return self._vol_or_raise(block.block_id).read_chunks(
            block, offset, length, opened=opened)

    def verify_replica(self, block) -> None:
        self._vol_or_raise(block.block_id).verify_replica(block)

    def cache_block(self, block) -> bool:
        v = self._vol_of(block.block_id)
        return v.cache_block(block) if v is not None else False

    def uncache_block(self, block_id: int) -> bool:
        return any(v.uncache_block(block_id) for v in self.volumes)

    def cached_ids(self) -> List[int]:
        return [b for v in self.volumes for b in v.cached_ids()]

    def _path(self, state: str, block_id: int) -> str:
        v = self._vol_of(block_id)
        return (v or self.volumes[0])._path(state, block_id)

    # ----------------------------------------------------------- inventory

    def reconcile(self):
        vanished: List = []
        adopted: List = []
        for v in self.volumes:
            gone, found = v.reconcile()
            vanished.extend(gone)
            adopted.extend(found)
        return vanished, adopted

    def all_finalized(self):
        return [b for v in self.volumes for b in v.all_finalized()]

    def stats(self) -> Dict[str, int]:
        agg = {"capacity": 0, "dfs_used": 0, "remaining": 0,
               "num_replicas": 0}
        for v in self.volumes:
            s = v.stats()
            for k in agg:
                agg[k] += s.get(k, 0)
        return agg

    @property
    def max_cache_bytes(self) -> int:
        return sum(v.max_cache_bytes for v in self.volumes)

    @max_cache_bytes.setter
    def max_cache_bytes(self, total: int) -> None:
        per = total // len(self.volumes)
        for v in self.volumes:
            v.max_cache_bytes = per

    def volume_stats(self) -> List[Dict[str, int]]:
        out = []
        for v in self.volumes:
            s = v.stats()
            s["dir"] = v.dir
            out.append(s)
        return out

    # ------------------------------------------------- volume→volume moves

    def move_replica(self, block_id: int, dst_index: int) -> bool:
        """Copy one finalized replica onto ``volumes[dst_index]`` and
        retire the source copy (the DiskBalancerMover unit of work)."""
        dst = self.volumes[dst_index]
        src = self._vol_of(block_id)
        if src is None or src is dst:
            return False
        rep = src.get_replica(block_id)
        if rep is None or rep.state != Replica.FINALIZED:
            return False
        sdata = src._path(Replica.FINALIZED, block_id)
        ddata = dst._path(Replica.FINALIZED, block_id)
        tmp = ddata + ".dbtmp"
        try:
            shutil.copyfile(sdata, tmp)
            shutil.copyfile(sdata + ".meta", tmp + ".meta")
            # Commit meta first, data last: if the second replace fails,
            # the dst holds at worst an orphan .meta (ignored by the
            # directory scanner), never a finalized data file without a
            # .meta that a later reconcile could adopt as corrupt.
            os.replace(tmp + ".meta", ddata + ".meta")
            os.replace(tmp, ddata)
        except OSError as e:
            log.warning("disk-balancer move of blk_%d failed: %s",
                        block_id, e)
            for p in (tmp, tmp + ".meta", ddata + ".meta"):
                try:
                    if os.path.exists(p):
                        os.remove(p)
                except OSError:
                    pass
            return False
        with dst._lock:
            dst._replicas[block_id] = Replica(
                block_id, rep.gen_stamp, rep.num_bytes, Replica.FINALIZED)
        src.invalidate(rep.to_block())
        return True


class DiskBalancer:
    """Plan/execute volume rebalancing for one DataNode.

    Ref: server/diskbalancer/planner/GreedyPlanner.java — move bytes
    from volumes above the node's mean utilization to volumes below it
    until every volume is within ``threshold`` of the mean.
    """

    def __init__(self, store: VolumeSet):
        if not isinstance(store, VolumeSet):
            raise ValueError("disk balancer requires a multi-volume node")
        self.store = store

    def report(self) -> Dict:
        vols = self.store.volume_stats()
        node = self.store.stats()
        node_util = node["dfs_used"] / max(1, node["capacity"])
        for s in vols:
            s["utilization"] = round(
                s["dfs_used"] / max(1, s["capacity"]), 4)
            s["density"] = round(s["utilization"] - node_util, 4)
        return {"node_utilization": round(node_util, 4), "volumes": vols}

    def plan(self, threshold: float = 0.10) -> List[Dict]:
        """[{block_id, src, dst, bytes}] bringing volumes within
        threshold of the mean."""
        rep = self.report()
        vols = rep["volumes"]
        moves: List[Dict] = []
        # Work on mutable copies of used-bytes.
        used = [s["dfs_used"] for s in vols]
        cap = [max(1, s["capacity"]) for s in vols]
        mean = sum(used) / max(1, sum(cap))

        def density(i):
            return used[i] / cap[i] - mean

        for si, sv in enumerate(self.store.volumes):
            blocks = sorted(sv.all_finalized(), key=lambda b: -b.num_bytes)
            for b in blocks:
                if density(si) <= threshold:
                    break
                di = min(range(len(used)), key=density)
                if di == si or density(di) >= -1e-9:
                    break
                moves.append({"block_id": b.block_id, "src": si, "dst": di,
                              "bytes": b.num_bytes})
                used[si] -= b.num_bytes
                used[di] += b.num_bytes
        return moves

    def execute(self, moves: List[Dict]) -> Dict[str, int]:
        done = failed = 0
        for m in moves:
            if self.store.move_replica(m["block_id"], m["dst"]):
                done += 1
            else:
                failed += 1
        return {"moved": done, "failed": failed}
