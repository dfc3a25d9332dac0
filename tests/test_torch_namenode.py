"""The port's NameNode (``hadoop_tpu_torch/dfs/namenode``) against the
JAX package's.

- The units of ``tests/test_dfs_units.py`` that are the NameNode's
  (FSDirectory, the edit log with its torn tails and rolls, the fsimage
  and its md5, leases, the BlockManager's replication, reconstruction,
  excess and corrupt replicas and genstamps, SafeMode's threshold) and
  the cases of ``tests/test_namespace_features.py`` (snapshots, quotas,
  xattrs, ACLs, storage policies, concat, truncate),
  ``tests/test_permissions.py`` (permission checks, groups, WebHDFS),
  ``tests/test_topology.py`` (pod-aware placement),
  ``tests/test_cache_manager.py`` (cache directives) and
  ``tests/test_encryption_zones.py`` (zones on the NameNode, against the
  reference's KMS server) run on the port's modules, through
  ``torch_ported_cases``.
- On-disk state across packages: a cluster of one package's NameNode
  and DataNodes takes a sequence of namespace ops (mkdirs, files, a
  rename, snapshots, quotas, an xattr, an ACL, a storage policy, an EC
  policy, a checkpoint between them); the other package's NameNode and
  DataNodes then start from the same name and data directories, and
  serve the same listings, ``FileStatus``es, content summaries, snapshot
  diffs, block lists and bytes, through both packages' clients; both
  packages' block stores report the same replicas from every DataNode
  directory each cluster left.
- A NameNode without HA answers the HA admin protocol as the
  reference's does (the port's HA is tests/test_torch_ha.py's).

Every comparison is exact.
"""

import hashlib
import os

import numpy as np
import pytest

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.dfs.client.filesystem import DistributedFileSystem as JDFS
from hadoop_tpu.dfs.datanode import blockstore as jbs
from hadoop_tpu.testing import minicluster as jmini
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.dfs.client import DistributedFileSystem
from hadoop_tpu_torch.dfs.datanode import blockstore as pbs
from hadoop_tpu_torch.dfs.namenode import NameNode
from hadoop_tpu_torch.testing import minicluster as pmini
from torch_ported_cases import cases_on_port

# the DataNode's units are tests/test_torch_datanode.py's
_DATANODE_UNITS = ("test_blockstore_", "test_finalize_existing_")
_RACES_THE_MONITOR = "test_pending_recovery_pinned_to_inode_identity"
_UNITS = cases_on_port("test_dfs_units", {})
globals().update({k: v for k, v in _UNITS.items()
                  if not k.startswith(_DATANODE_UNITS)
                  and k != _RACES_THE_MONITOR})
globals().update(cases_on_port("test_namespace_features", {
    "test_trash_move_and_expunge":
        "the client's trash (hadoop_tpu/fs/trash.py) is not in the port: "
        "ROADMAP Queue A 12",
    "test_trash_expunges_collision_suffixed_checkpoints":
        "as above: ROADMAP Queue A 12",
    "test_trash_sibling_of_root_is_trashable":
        "as above: ROADMAP Queue A 12",
}, absent=("hadoop_tpu.fs.trash",), own_fixtures=True))
for _name in ("test_permissions", "test_topology", "test_cache_manager"):
    globals().update(cases_on_port(_name, {}, own_fixtures=True))
globals().update(cases_on_port("test_encryption_zones", {
    "test_client_without_kms_cannot_read":
        "a client case: the port's client refuses a zone's file without a "
        "KMS (PermissionError) where the reference's hands out the "
        "ciphertext, by design since its encryption zones "
        "(tests/test_torch_crypto.py)",
}, reference=("hadoop_tpu.crypto.kms",)))


def test_pending_recovery_pinned_to_inode_identity_monitor_off(
        tmp_path, monkeypatch):
    """``test_dfs_units``' case of that name with the NameNode's
    background monitor out of the way: between the case's close and its
    rename the monitor may finish the recovery it planted, on either
    package, under load (ROADMAP C 23)."""
    real = pmini.fast_conf

    def quiet(base=None):
        conf = real(base)
        conf.set("dfs.namenode.redundancy.interval", "1h")
        return conf

    monkeypatch.setattr(pmini, "fast_conf", quiet)
    _UNITS[_RACES_THE_MONITOR](tmp_path)


# ------------------------------------------------ on-disk state, both ways

MINIS = {"reference": jmini, "port": pmini}


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _clients(cluster):
    """The reference's and the port's clients on ``cluster``."""
    jconf = JConfiguration(load_defaults=False)
    pconf = Configuration()
    for k, v in cluster.conf.to_dict().items():
        jconf.set(k, v)
        pconf.set(k, v)
    return (JDFS([cluster.nn_addr], jconf),
            DistributedFileSystem([cluster.nn_addr], pconf))


def _mini(kind, base_dir):
    mini = MINIS[kind]
    conf = mini.fast_conf()
    conf.set("dfs.blocksize", str(256 * 1024))
    return mini.MiniDFSCluster(num_datanodes=5, conf=conf, base_dir=base_dir)


FILES = {"/x/a/f1": _bytes(700_000, 1), "/x/a/b/f2": _bytes(5_000, 2),
         "/x/a/f3": _bytes(300_001, 3), "/x/ec/f4": _bytes(600_000, 4),
         "/x/cold/f5": _bytes(1_000, 5)}


def _ops(fs, save_namespace):
    """The op sequence, with a checkpoint halfway: the image holds the
    first half, the edit log the rest."""
    fs.mkdirs("/x/a/b")
    fs.mkdirs("/x/q")
    fs.mkdirs("/x/cold")
    fs.mkdirs("/x/ec")
    for path in ("/x/a/f1", "/x/a/b/f2"):
        fs.write_all(path, FILES[path])
    fs.rename("/x/a/f1", "/x/a/f1r")
    fs.allow_snapshot("/x/a")
    fs.create_snapshot("/x/a", "s1")
    save_namespace()
    fs.write_all("/x/a/f3", FILES["/x/a/f3"])
    fs.delete("/x/a/b/f2")
    fs.create_snapshot("/x/a", "s2")
    fs.set_quota("/x/q", 10, 64 * 1024 * 1024)
    fs.set_xattr("/x/a/f1r", "user.tag", b"\x00tpu")
    fs.set_acl("/x/a/f3", ["user:alice:rw-", "group:infra:r--"])
    fs.set_storage_policy("/x/cold", "WARM")
    fs.write_all("/x/cold/f5", FILES["/x/cold/f5"])
    fs.client.set_ec_policy("/x/ec", "RS-3-2-64k")
    fs.write_all("/x/ec/f4", FILES["/x/ec/f4"])


def _status(st):
    return st.to_wire()


def _names(fs):
    """What a client sees of the namespace, reading no file (a read
    moves a file's access time)."""
    out = {}

    def walk(path):
        for st in fs.list_status(path):
            out[st.path] = _status(st)
            if st.is_dir:
                walk(st.path)
    walk("/x")
    for snap in ("s1", "s2"):
        out[f"ls {snap}"] = [_status(st) for st in
                             fs.list_status(f"/x/a/.snapshot/{snap}")]
    out["diff"] = fs.snapshot_diff("/x/a", "s1", "s2")
    out["summary"] = {p: fs.content_summary(p)
                      for p in ("/x", "/x/a", "/x/q", "/x/ec")}
    out["xattrs"] = fs.get_xattrs("/x/a/f1r")
    out["acl"] = fs.get_acl("/x/a/f3")
    out["policies"] = [fs.get_storage_policy(p)
                       for p in ("/x/cold", "/x/cold/f5", "/x/a")]
    out["ec"] = fs.get_file_status("/x/ec/f4").ec_policy
    return out


READ = ("/x/a/f1r", "/x/a/f3", "/x/ec/f4", "/x/cold/f5",
        "/x/a/.snapshot/s1/b/f2")


def _data(fs):
    """Each file's blocks and bytes."""
    return {p: ([b["b"] for b in fs.client.get_block_locations(p)["blocks"]],
                hashlib.sha256(fs.read_all(p)).hexdigest()) for p in READ}


def _disk_reports(base):
    """Each DataNode directory under ``base`` as both packages' block
    stores open it (the replicas a DataNode reports), once the daemons
    are down: the two must agree."""
    out = {}
    for d in sorted(os.listdir(base)):
        if not d.startswith("data"):
            continue
        path = os.path.join(base, d, "current")
        got = [sorted((b.block_id, b.gen_stamp, b.num_bytes)
                      for b in mod.BlockStore(path).all_finalized())
               for mod in (jbs, pbs)]
        assert got[0] == got[1], d
        out[d] = got[0]
    return out


def _less(names, lost):
    """``names`` with the fields ``lost(status)`` names taken out of
    every ``FileStatus``."""
    def cut(st):
        return {f: x for f, x in st.items() if f not in lost(st)}
    return {k: (cut(v) if k.startswith("/") else
                [cut(st) for st in v] if k.startswith("ls ") else v)
            for k, v in names.items()}


# A NameNode stamps with its own clock what its name directory does not
# hold, in either package (ROADMAP C 21): the edit log holds no times;
# the fsimage holds no access time, and loading it restamps a directory's
# modification time as it adds the directory's children.
def EDITS_LOSE(st):
    return ("mt", "at")


def IMAGE_LOSES(st):
    return ("mt", "at") if st["d"] else ("at",)


@pytest.mark.parametrize("writer", sorted(MINIS))
def test_each_package_starts_from_the_others_directories(tmp_path, writer):
    """The writer's image and edits start the reader's NameNode, whose
    own image then starts the writer's again."""
    reader = "port" if writer == "reference" else "reference"
    base = str(tmp_path / "dfs")
    with _mini(writer, base) as c:
        c.wait_active()
        jfs, pfs = _clients(c)
        try:
            _ops(pfs if writer == "port" else jfs,
                 c.namenode.fsn.save_namespace)
            names = _names(jfs)
            assert _names(pfs) == names
            data = _data(jfs)
            assert _data(pfs) == data
        finally:
            jfs.close()
            pfs.close()
    assert any(_disk_reports(base).values())
    assert names["diff"]["created"] and names["diff"]["deleted"]
    assert data["/x/a/.snapshot/s1/b/f2"][1] == \
        hashlib.sha256(FILES["/x/a/b/f2"]).hexdigest()
    with _mini(reader, base) as c:
        c.wait_active()
        jfs, pfs = _clients(c)
        try:
            replayed = _names(jfs)
            assert _less(replayed, EDITS_LOSE) == _less(names, EDITS_LOSE)
            assert _names(pfs) == replayed
            assert _data(jfs) == data
            assert _data(pfs) == data
            # the reader's own edits go on from the writer's log
            pfs.write_all("/x/after", b"after")
            c.restart_namenode()
            c.wait_active()
            assert jfs.read_all("/x/after") == b"after"
            c.namenode.fsn.save_namespace()
            saved = _names(jfs)
        finally:
            jfs.close()
            pfs.close()
    assert any(_disk_reports(base).values())
    with _mini(writer, base) as c:
        c.wait_active()
        jfs, pfs = _clients(c)
        try:
            loaded = _names(jfs)
            assert _less(loaded, IMAGE_LOSES) == _less(saved, IMAGE_LOSES)
            assert _names(pfs) == loaded
            assert _data(pfs) == data
            assert jfs.read_all("/x/after") == b"after"
        finally:
            jfs.close()
            pfs.close()


# ----------------------------------------------------- HTTP pages, WebHDFS

def _http(port, method, path, body=None):
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _http_round(cluster, payload):
    """The NameNode's pages and a WebHDFS round trip (a body past the
    HTTP server's streaming threshold, a percent-encoded path): status
    codes, JSON key sets and bytes."""
    import json
    port = cluster.namenode.http.port
    out = {}
    status, body = _http(port, "GET", "/fsstatus")
    out["fsstatus"] = (status, sorted(json.loads(body)))
    status, body = _http(port, "GET", "/ws/v1/datanodes")
    nodes = json.loads(body)["datanodes"]
    out["datanodes"] = (status, len(nodes), sorted(nodes[0]))
    status, body = _http(port, "GET", "/dfshealth")
    out["dfshealth"] = (status, "Datanodes (1)" in body.decode())
    web = "/webhdfs/v1/w/a%20b.bin"
    out["create"] = _http(port, "PUT", f"{web}?op=CREATE&user.name=root",
                          payload)[0]
    status, body = _http(port, "GET", f"{web}?op=OPEN&user.name=root")
    out["open"] = (status, body == payload)
    status, body = _http(port, "GET",
                         "/webhdfs/v1/w?op=LISTSTATUS&user.name=root")
    listed = json.loads(body)["FileStatuses"]["FileStatus"]
    out["list"] = (status, [(f["pathSuffix"], f["length"], f["type"])
                            for f in listed])
    out["delete"] = _http(port, "DELETE",
                          f"{web}?op=DELETE&user.name=root")[0]
    return out


def test_http_pages_and_webhdfs_as_the_references(tmp_path):
    payload = _bytes(5 * 1024 * 1024 + 3, 9)
    rounds = []
    for kind in ("reference", "port"):
        conf = MINIS[kind].fast_conf()
        conf.set("dfs.replication", "1")
        with MINIS[kind].MiniDFSCluster(
                num_datanodes=1, conf=conf,
                base_dir=str(tmp_path / kind)) as c:
            c.wait_active()
            rounds.append(_http_round(c, payload))
    assert rounds[0] == rounds[1]
    assert rounds[1]["open"] == (200, True)
    assert rounds[1]["list"][1] == [("a b.bin", len(payload), "FILE")]


# ------------------------------------------------------------ without HA

def test_a_single_namenode_stays_active(tmp_path):
    """The HA admin protocol on a NameNode without HA answers as the
    reference's: active already, no way to standby or observer."""
    from hadoop_tpu_torch.dfs.namenode.namenode import HAServiceProtocol
    with pmini.MiniDFSCluster(num_datanodes=1,
                              base_dir=str(tmp_path)) as c:
        proto = HAServiceProtocol(c.namenode)
        assert proto.transition_to_active()
        for move in (proto.transition_to_standby,
                     proto.transition_to_observer):
            with pytest.raises(ValueError, match="HA is not enabled"):
                move()
        assert proto.get_ha_status()["state"] == "active"
