"""DFSAdmin + Fsck: `hadoop-tpu dfsadmin` / `hadoop-tpu fsck`.

The port's copy of ``hadoop_tpu/cli/dfsadmin.py``, on the port's DFS
client (``fs.get_filesystem``) and RPC client; it drives either
package's NameNodes.

Parity with the reference admin tools (ref: hadoop-hdfs
hdfs/tools/DFSAdmin.java:112, hdfs/tools/DFSck.java:75; server support
NamenodeFsck.java): cluster report, safemode control, checkpointing,
quota management, node admin, HA transitions, and a namespace health
walk that
classifies every block as healthy / under-replicated / corrupt /
missing.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.cli.main import FS_DEFAULT_FS
from hadoop_tpu_torch.fs import get_filesystem
from hadoop_tpu_torch.io import erasurecode as ec


class DFSAdmin:
    """Ref: hdfs/tools/DFSAdmin.java."""

    def __init__(self, conf: Optional[Configuration] = None, out=None):
        self.conf = conf or Configuration()
        self.out = out or sys.stdout
        self._fs = None

    def _print(self, *args) -> None:
        print(*args, file=self.out)

    def fs(self):
        if self._fs is None:
            uri = self.conf.get(FS_DEFAULT_FS, "file:///")
            self._fs = get_filesystem(uri, self.conf)
            if not hasattr(self._fs, "client"):
                raise ValueError(
                    f"fs.defaultFS ({uri or 'unset'}) is not a DFS — pass "
                    f"-fs htpu://host:port")
        return self._fs

    def nn(self):
        return self.fs().client.nn

    def close(self) -> None:
        if self._fs is not None:
            self._fs.close()

    def run(self, argv: List[str]) -> int:
        if not argv:
            self._print("Usage: hadoop-tpu dfsadmin -<command> [args]")
            return 1
        cmd = argv[0].lstrip("-")
        handler = getattr(self, f"cmd_{cmd}", None)
        if handler is None:
            self._print(f"dfsadmin: unknown command -{cmd}")
            return 1
        try:
            return handler(argv[1:]) or 0
        except (IndexError, KeyError) as e:
            # only an EMPTY argv slice is an argument error here — a
            # KeyError from deep in the client/wire path must surface,
            # not masquerade as bad CLI usage
            import traceback
            tb = traceback.extract_tb(e.__traceback__)
            if any("hadoop_tpu_torch/cli/" not in (fr.filename or "")
                   for fr in tb[1:]):
                raise
            self._print(f"dfsadmin -{cmd}: missing or malformed arguments")
            return 1
        except (OSError, ValueError) as e:
            self._print(f"dfsadmin -{cmd}: {e}")
            return 1

    # ------------------------------------------------------------- commands

    def cmd_report(self, args: List[str]) -> int:
        stats = self.nn().get_stats()
        self._print(f"Files: {stats['files']}  Blocks: {stats['blocks']}  "
                    f"Under-replicated: {stats['under_replicated']}")
        self._print(f"Safemode: {stats['safemode']}  "
                    f"Txid: {stats['txid']}  Leases: {stats['leases']}")
        nodes = self.nn().get_datanode_report("all")
        self._print(f"\nDatanodes ({len(nodes)}):")
        for d in nodes:
            self._print(
                f"  {d['u'][:8]} {d['h']}:{d['xp']} [{d['st']}] "
                f"type={d.get('sty', 'DISK')} blocks={d.get('nblk', 0)} "
                f"used={d.get('used', 0)}")
        return 0

    def cmd_safemode(self, args: List[str]) -> int:
        action = args[0] if args else "get"
        on = self.nn().set_safemode(action)
        self._print(f"Safe mode is {'ON' if on else 'OFF'}")
        return 0

    def cmd_saveNamespace(self, args: List[str]) -> int:
        path = self.nn().save_namespace()
        self._print(f"Saved namespace image: {path}")
        return 0

    def cmd_rollEdits(self, args: List[str]) -> int:
        # save_namespace rolls the edit segment as part of checkpointing.
        self.nn().save_namespace()
        self._print("Edit log rolled")
        return 0

    def cmd_setQuota(self, args: List[str]) -> int:
        quota = int(args[0])
        for path in args[1:]:
            self.nn().set_quota(path, quota, -1)
        return 0

    def cmd_clrQuota(self, args: List[str]) -> int:
        for path in args:
            self.nn().set_quota(path, -1, -1)
        return 0

    def cmd_setSpaceQuota(self, args: List[str]) -> int:
        quota = int(args[0])
        for path in args[1:]:
            self.nn().set_quota(path, -1, quota)
        return 0

    def cmd_decommission(self, args: List[str]) -> int:
        for uuid in args:
            self.nn().decommission_datanode(uuid)
            self._print(f"Decommissioning {uuid}")
        return 0

    def cmd_maintenance(self, args: List[str]) -> int:
        action, uuid = args[0], args[1]
        if action == "start":
            self.nn().start_maintenance(uuid)
        else:
            self.nn().stop_maintenance(uuid)
        return 0

    def cmd_allowSnapshot(self, args: List[str]) -> int:
        self.nn().allow_snapshot(args[0])
        self._print(f"Allowing snapshot on {args[0]} succeeded")
        return 0

    def cmd_disallowSnapshot(self, args: List[str]) -> int:
        self.nn().disallow_snapshot(args[0])
        return 0

    def cmd_setStoragePolicy(self, args: List[str]) -> int:
        path, policy = args[0], args[1]
        self.nn().set_storage_policy(path, policy)
        return 0

    def cmd_getStoragePolicy(self, args: List[str]) -> int:
        self._print(self.nn().get_storage_policy(args[0]))
        return 0

    def cmd_setECPolicy(self, args: List[str]) -> int:
        path, policy = args[0], args[1]
        self.nn().set_ec_policy(path, policy)
        self._print(f"Set {policy} erasure coding policy on {path}")
        return 0

    def cmd_listECPolicies(self, args: List[str]) -> int:
        for p in self.nn().get_ec_policies():
            self._print(f"{p['name']}: {p['codec']} k={p['k']} m={p['m']} "
                        f"cell={p['cell']}")
        return 0

    # HA ------------------------------------------------------------------

    def _ha_proxy(self, addr_spec: str):
        from hadoop_tpu_torch.ipc import Client, get_proxy
        from hadoop_tpu_torch.util.misc import parse_addr_list
        addr = parse_addr_list(addr_spec)[0]
        client = Client(self.conf)
        return get_proxy("HAServiceProtocol", addr, client=client), client

    def cmd_transitionToActive(self, args: List[str]) -> int:
        proxy, client = self._ha_proxy(args[0])
        try:
            proxy.transition_to_active()
            self._print(f"{args[0]} is now active")
        finally:
            client.stop()
        return 0

    def cmd_transitionToStandby(self, args: List[str]) -> int:
        proxy, client = self._ha_proxy(args[0])
        try:
            proxy.transition_to_standby()
            self._print(f"{args[0]} is now standby")
        finally:
            client.stop()
        return 0

    def cmd_getServiceState(self, args: List[str]) -> int:
        proxy, client = self._ha_proxy(args[0])
        try:
            self._print(proxy.get_ha_status()["state"])
        finally:
            client.stop()
        return 0


class Fsck:
    """Namespace health checker. Ref: hdfs/tools/DFSck.java:75 +
    server/namenode/NamenodeFsck.java — walks the tree and classifies
    every block's replica health."""

    def __init__(self, conf: Optional[Configuration] = None, out=None):
        self.conf = conf or Configuration()
        self.out = out or sys.stdout
        self._fs = None

    def _print(self, *args) -> None:
        print(*args, file=self.out)

    def fs(self):
        if self._fs is None:
            uri = self.conf.get(FS_DEFAULT_FS, "file:///")
            self._fs = get_filesystem(uri, self.conf)
            if not hasattr(self._fs, "client"):
                raise ValueError(
                    f"fs.defaultFS ({uri or 'unset'}) is not a DFS — pass "
                    f"-fs htpu://host:port")
        return self._fs

    def close(self) -> None:
        if self._fs is not None:
            self._fs.close()

    def run(self, argv: List[str]) -> int:
        non_flags = [a for a in argv if not a.startswith("-")]
        path = non_flags[0] if non_flags else "/"
        verbose = "-files" in argv or "-blocks" in argv
        stats = {"files": 0, "dirs": 0, "bytes": 0, "blocks": 0,
                 "healthy": 0, "under": 0, "corrupt": 0, "missing": 0}
        try:
            nn = self.fs().client.nn
        except ValueError as e:
            self._print(f"fsck: {e}")
            return 1
        stack = [path]
        while stack:
            p = stack.pop()
            for st in nn.listing(p):
                if st["d"]:
                    stats["dirs"] += 1
                    stack.append(st["p"])
                    continue
                stats["files"] += 1
                stats["bytes"] += st["len"]
                self._check_file(nn, st, stats, verbose)
        healthy = stats["corrupt"] == 0 and stats["missing"] == 0
        self._print(f"\nStatus: {'HEALTHY' if healthy else 'CORRUPT'}")
        self._print(f" Total files:\t{stats['files']}")
        self._print(f" Total dirs:\t{stats['dirs']}")
        self._print(f" Total size:\t{stats['bytes']} B")
        self._print(f" Total blocks:\t{stats['blocks']}")
        self._print(f" Healthy blocks:\t{stats['healthy']}")
        self._print(f" Under-replicated:\t{stats['under']}")
        self._print(f" Corrupt blocks:\t{stats['corrupt']}")
        self._print(f" Missing blocks:\t{stats['missing']}")
        return 0 if healthy else 1

    def _check_file(self, nn, st, stats, verbose: bool) -> None:
        info = nn.get_block_locations(st["p"], 0, 1 << 62)
        line = [f"{st['p']} {st['len']} bytes, {len(info['blocks'])} "
                f"block(s):"]
        for bw in info["blocks"]:
            stats["blocks"] += 1
            n_locs = len(bw["locs"])
            if bw.get("ec"):
                policy = ec.get_policy(bw["ec"])
                if len(set(bw.get("idx") or [])) < policy.k:
                    stats["missing"] += 1
                    line.append(" MISSING(striped)")
                elif n_locs < policy.num_units:
                    stats["under"] += 1
                else:
                    stats["healthy"] += 1
                continue
            expected = st.get("rep", 1)
            if n_locs == 0:
                stats["missing"] += 1
                line.append(f" MISSING blk_{bw['b']['id']}")
            elif bw.get("cor"):
                stats["corrupt"] += 1
            elif n_locs < expected:
                stats["under"] += 1
                line.append(f" Under replicated blk_{bw['b']['id']} "
                            f"({n_locs}/{expected})")
            else:
                stats["healthy"] += 1
        if verbose or len(line) > 1:
            self._print("".join(line))
