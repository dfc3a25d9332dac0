"""The port's HA NameNodes (``hadoop_tpu_torch/dfs/namenode/ha.py`` and
the HA branches of ``namenode.py``) and ``MiniQJMHACluster`` against
the JAX package's.

- The HA cluster cases of ``tests/test_ha.py`` (election and the
  standby's refusals, tailing, failover under a live client, fencing of
  a deposed active, demote and re-promote, observer reads) and the cases
  of ``tests/test_fault_injection.py`` (the JournalNode faults on a
  minority and a majority, and its pipeline, wire-corruption and
  edit-log cases) run on the port's modules, through
  ``torch_ported_cases``.
- Mixed HA pairs over one mixed quorum, a reference active with a port
  standby and the reverse: the standby tails the active's edits to its
  txid and checkpoints, the active dies, the other package's NameNode
  wins the ``QuorumLease`` and serves the same listings, ``FileStatus``es
  (less the times neither package's edits keep, ROADMAP C 21) and bytes
  through the port's client; the other package's ``FSNamesystem`` loads
  the image the standby's ``StandbyCheckpointer`` wrote, and both
  packages' ``oiv`` print it the same.
- ROADMAP C 20: on a port standby the reference's client gets a
  ``RemoteError`` and does not fail over; the port's client fails over
  on both packages' pairs.
- ``dfsadmin -transitionToActive``, ``-transitionToStandby`` and
  ``-getServiceState`` print the same from either package's tool on
  either package's HA cluster.

Every comparison is exact.
"""

import hashlib
import inspect
import io
import json
import os
import re
import shutil
import threading
import time

import numpy as np
import pytest

from hadoop_tpu.cli import oiv as joiv
from hadoop_tpu.cli.dfsadmin import DFSAdmin as JDFSAdmin
from hadoop_tpu.dfs.client.filesystem import DistributedFileSystem as JDFS
from hadoop_tpu.dfs.datanode import DataNode as JDataNode
from hadoop_tpu.dfs.namenode import NameNode as JNameNode
from hadoop_tpu.dfs.namenode.fsnamesystem import FSNamesystem as JFSN
from hadoop_tpu.dfs.qjournal import JournalNode as JJournalNode
from hadoop_tpu.ipc import Client as JClient, get_proxy as jget_proxy
from hadoop_tpu.ipc.errors import RemoteError as JRemoteError
from hadoop_tpu.testing import minicluster as jmini
from hadoop_tpu_torch.cli import oiv as poiv
from hadoop_tpu_torch.cli.dfsadmin import DFSAdmin
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.dfs.client import DistributedFileSystem
from hadoop_tpu_torch.dfs.datanode import DataNode
from hadoop_tpu_torch.dfs.namenode import NameNode
from hadoop_tpu_torch.dfs.namenode.fsnamesystem import FSNamesystem
from hadoop_tpu_torch.dfs.qjournal import JournalNode
from hadoop_tpu_torch.testing import minicluster as pmini
from torch_ported_cases import (MixedHACluster, cases_on_port,
                                collect_sockets, jconf)

_HA = cases_on_port("test_ha", {})
# cases that race the daemons under load, on either package: each runs
# below as a port copy that waits for its condition
_RACES = ("test_standby_tails_edits", "test_demoted_active_is_fenced",
          "test_demote_then_repromote_same_node")
# the journal-layer cases on ``jns`` are test_torch_qjournal.py's
globals().update({
    k: v for k, v in _HA.items()
    if k != "jns" and k not in _RACES and not (
        k.startswith("test_") and "jns" in inspect.signature(v).parameters)})
globals().update(cases_on_port("test_fault_injection", {},
                               own_fixtures=True))

MINIS = {"port": pmini, "reference": jmini}


# ------------------------------------------- test_ha's racing cases

def test_standby_tails_edits_to_the_files_length(ha_cluster):
    """``test_ha``'s ``test_standby_tails_edits``, waiting for the
    standby to hold the file at its length: the case stopped waiting
    once the file existed, and under load the standby may have tailed
    the create but not yet the close that sets the length."""
    idx = ha_cluster.wait_active()
    fs = ha_cluster.get_filesystem()
    fs.mkdirs("/tailed/dir")
    with fs.create("/tailed/f.txt") as out:
        out.write(b"hello standby")
    standby = ha_cluster.namenodes[1 - idx]

    def tailed():
        inode = standby.fsn.fsdir.get_inode("/tailed/f.txt")
        return inode is not None and inode.length() == len(b"hello standby")
    _wait(tailed, "the standby never tailed the file's close", 20.0)
    assert standby.fsn.fsdir.exists("/tailed/dir")


def _controllers_off(cluster):
    """Stop every NameNode's failover controller: a case that moves the
    HA states by hand races them, since the lease holder's controller
    promotes it again (and fences the NameNode made active by hand)."""
    for nn in cluster.namenodes:
        if nn is not None and nn.failover is not None:
            nn.failover.stop()


@pytest.mark.parametrize("case", ["test_demoted_active_is_fenced",
                                  "test_demote_then_repromote_same_node"])
def test_manual_transitions_with_the_controllers_off(ha_cluster, case):
    """``test_ha``'s cases that demote and promote NameNodes by hand,
    run with the failover controllers stopped once an active is
    elected: with them running, the demoted lease holder's controller
    promotes it again mid-case, on either package."""
    ha_cluster.wait_active()
    _controllers_off(ha_cluster)
    _HA[case](ha_cluster)


def _port_conf(cluster):
    conf = Configuration()
    for k, v in cluster.conf.to_dict().items():
        conf.set(k, v)
    return conf


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _wait(cond, what, seconds=30.0):
    deadline = time.monotonic() + seconds
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.05)


# ------------------------------------------------------ mixed HA pairs

FILES = {"/m/a/one.bin": _bytes(1, 1),
         "/m/a/big.bin": _bytes(2 * 1024 * 1024 + 4321, 2),
         "/m/b/renamed.bin": _bytes(70_000, 3)}

# neither package's edits keep an inode's times (ROADMAP C 21): a
# NameNode that tailed them stamps its own
TIMES = ("mt", "at")


def _ops(fs):
    fs.mkdirs("/m/a")
    fs.mkdirs("/m/b")
    for path, data in FILES.items():
        src = path.replace("renamed", "first")
        fs.write_all(src, data)
        if src != path:
            fs.rename(src, path)
    fs.set_replication("/m/a/one.bin", 2)


def _view(fs):
    """Listings and statuses of the tree as the NameNode sends them,
    less their times, and each file's bytes' digest."""
    nn = fs.client.nn
    out = {}
    for d in ("/", "/m", "/m/a", "/m/b"):
        out[f"ls {d}"] = [{k: v for k, v in st.items() if k not in TIMES}
                          for st in nn.listing(d)]
    for path in FILES:
        st = nn.get_file_info(path)
        out[path] = ({k: v for k, v in st.items() if k not in TIMES},
                     hashlib.sha256(fs.read_all(path)).hexdigest())
    return out


def _image_dump(mod, name_dir):
    out = io.StringIO()
    mod.dump_image(name_dir, out=out)
    return out.getvalue()


def _loaded_listing(fsn_cls, conf, name_dir):
    """``fsn_cls`` loads ``name_dir``'s newest image read-only; its
    listing of every directory, less times."""
    fsn = fsn_cls(conf, name_dir)
    try:
        txid = fsn.load_from_disk(open_edits=False)
        return txid, {d: [{k: v for k, v in st.items() if k not in TIMES}
                          for st in fsn.listing(d)]
                      for d in ("/", "/m", "/m/a", "/m/b")}
    finally:
        fsn.close()


PAIRS = {"ref_active-port_standby": (JNameNode, NameNode),
         "port_active-ref_standby": (NameNode, JNameNode)}


@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_mixed_pair_tails_fails_over_and_serves_the_same(tmp_path, pair):
    first, second = PAIRS[pair]
    jn_classes = ((JournalNode, JJournalNode, JournalNode)
                  if first is JNameNode else
                  (JJournalNode, JournalNode, JJournalNode))
    with MixedHACluster(jn_classes, (first, second),
                        (DataNode, JDataNode), num_journalnodes=3,
                        num_datanodes=3,
                        base_dir=str(tmp_path / "ha")) as c:
        assert c.wait_active() == 0
        active, standby = c.namenodes
        assert standby.ha_state == "standby"
        fs = c.get_filesystem()
        _ops(fs)
        before = _view(fs)
        txid = active.fsn.editlog.last_txid
        _wait(lambda: standby.applied_txid() == txid,
              f"the standby tailed to {standby.applied_txid()} of {txid}")
        image = standby.checkpointer.do_checkpoint()
        assert os.path.basename(image) == f"fsimage_{txid:019d}"
        c.kill_active()
        assert c.wait_active() == 1
        assert standby.ha_state == "active"
        assert _view(fs) == before
        fs.write_all("/m/after.bin", b"after the failover")
        assert fs.read_all("/m/after.bin") == b"after the failover"
        name1 = os.path.join(c.base_dir, "name1")
        copy = str(tmp_path / "name1-copy")
        shutil.copytree(name1, copy)
    dumps = {mod.__name__: _image_dump(mod, copy) for mod in (joiv, poiv)}
    assert len(set(dumps.values())) == 1
    first_line = json.loads(next(iter(dumps.values())).splitlines()[0])
    assert first_line["image_txid"] == txid
    own, other = (FSNamesystem, JFSN) if second is NameNode else \
        (JFSN, FSNamesystem)
    conf = pmini.fast_conf()
    loaded = [_loaded_listing(own, conf if own is FSNamesystem
                              else jconf(conf), copy),
              _loaded_listing(other, conf if other is FSNamesystem
                              else jconf(conf), copy)]
    assert loaded[0] == loaded[1]
    assert loaded[0][0] == txid
    assert loaded[0][1]["/m/a"] == before["ls /m/a"]


# ----------------------------------------------------------------- C 20

@pytest.mark.parametrize("kind", sorted(MINIS))
def test_standby_answers_each_client_as_c20_records(tmp_path, kind):
    """The port's client fails over from a standby on both packages'
    pairs. The reference's client does on its own pair; on the port's
    it gets a ``RemoteError`` naming the port's ``StandbyError`` and
    stops there (ROADMAP C 20)."""
    with MINIS[kind].MiniQJMHACluster(num_journalnodes=3, num_namenodes=2,
                                      num_datanodes=1,
                                      base_dir=str(tmp_path)) as c:
        idx = c.wait_active()
        order = [("127.0.0.1", c.namenodes[1 - idx].port),
                 ("127.0.0.1", c.namenodes[idx].port)]
        pfs = DistributedFileSystem(order, _port_conf(c))
        jfs = JDFS(order, jconf(_port_conf(c)))
        try:
            assert pfs.mkdirs("/c20/port")
            assert pfs.get_file_status("/c20/port").is_dir
            if kind == "reference":
                assert jfs.mkdirs("/c20/reference")
            else:
                with pytest.raises(JRemoteError) as info:
                    jfs.mkdirs("/c20/reference")
                assert info.value.class_name == \
                    "hadoop_tpu_torch.ipc.errors.StandbyError"
            client = JClient(jconf(_port_conf(c)))
            try:
                proxy = jget_proxy("ClientProtocol", order[0],
                                   client=client)
                with pytest.raises(Exception) as info:
                    proxy.listing("/")
                assert type(info.value).__name__ == (
                    "StandbyError" if kind == "reference" else
                    "RemoteError")
            finally:
                client.stop()
        finally:
            pfs.close()
            jfs.close()


# ------------------------------------------------------ dfsadmin and HA

@pytest.fixture(scope="module", params=sorted(MINIS))
def manual_ha(request, tmp_path_factory):
    """Either package's HA pair with automatic failover off: both
    NameNodes start standby."""
    mini = MINIS[request.param]
    conf = mini.fast_conf()
    conf.set("dfs.ha.automatic-failover.enabled", "false")
    with mini.MiniQJMHACluster(
            num_journalnodes=3, num_namenodes=2, num_datanodes=1,
            conf=conf,
            base_dir=str(tmp_path_factory.mktemp("manual"))) as c:
        c.kind = request.param
        yield c


def _admin_round(tool_cls, conf_cls, cluster):
    addrs = [f"127.0.0.1:{nn.port}" for nn in cluster.namenodes]
    conf = conf_cls(load_defaults=False)
    for k, v in cluster.conf.to_dict().items():
        conf.set(k, v)
    out = io.StringIO()
    tool = tool_cls(conf, out=out)
    rcs = []
    try:
        for argv in (["-transitionToStandby", addrs[0]],
                     ["-transitionToStandby", addrs[1]],
                     ["-getServiceState", addrs[0]],
                     ["-transitionToActive", addrs[0]],
                     ["-getServiceState", addrs[0]],
                     ["-getServiceState", addrs[1]],
                     ["-transitionToStandby", addrs[0]],
                     ["-transitionToActive", addrs[1]],
                     ["-getServiceState", addrs[0]],
                     ["-getServiceState", addrs[1]],
                     ["-transitionToStandby", addrs[1]]):
            rcs.append(tool.run(argv))
    finally:
        tool.close()
    text = out.getvalue()
    for i, a in enumerate(addrs):
        text = text.replace(a, f"<nn{i}>")
    return rcs, text


@pytest.mark.parametrize("tool", ["port", "reference"])
def test_dfsadmin_ha_commands_print_the_same(manual_ha, tool):
    from hadoop_tpu.conf import Configuration as JConfiguration
    got = _admin_round(*((DFSAdmin, Configuration) if tool == "port" else
                         (JDFSAdmin, JConfiguration)), manual_ha)
    rcs, text = got
    assert rcs == [0] * 11
    assert text.splitlines() == [
        "<nn0> is now standby", "<nn1> is now standby", "standby",
        "<nn0> is now active", "active", "standby", "<nn0> is now standby",
        "<nn1> is now active", "standby", "active", "<nn1> is now standby"]
    assert not re.search(r"127\.0\.0\.1", text)


# ----------------------------------------------------------------- C 24

@pytest.mark.parametrize("kind", sorted(MINIS))
def test_a_fenced_active_sends_its_client_to_the_new_active(tmp_path, kind):
    """NameNode 0 is active; NameNode 1 is made active over it, whose
    journal recovery fences 0's epoch while 0 still takes itself for
    active. A write through 0 then fails at the quorum: the port's
    NameNode steps down and answers ``StandbyError``, so the port's
    client fails over and the write lands on NameNode 1 (ROADMAP C 24);
    the reference's sends the ``FencedError`` itself, the write fails,
    and it stays active. The fenced port NameNode reports ``fenced`` and
    refuses every transition, so an operator's ``-transitionToActive``
    on it leaves NameNode 1 active at its epoch."""
    from hadoop_tpu_torch.dfs.qjournal import FencedError
    mini = MINIS[kind]
    conf = mini.fast_conf()
    conf.set("dfs.ha.automatic-failover.enabled", "false")
    with mini.MiniQJMHACluster(num_journalnodes=3, num_namenodes=2,
                               num_datanodes=1, conf=conf,
                               base_dir=str(tmp_path)) as c:
        a, b = c.namenodes
        a.transition_to_active()
        order = [("127.0.0.1", a.port), ("127.0.0.1", b.port)]
        fs = DistributedFileSystem(order, _port_conf(c))
        try:
            assert fs.mkdirs("/c24/before")
            b.transition_to_active()
            assert a.ha_state == "active"
            if kind == "port":
                assert fs.mkdirs("/c24/after")
                assert a.ha_state == "fenced" and a.fenced_by
                assert not a.is_healthy()
                assert b.fsn.fsdir.exists("/c24/after")
                assert fs.get_file_status("/c24/before").is_dir
                epoch = b.fsn.editlog.journal.epoch
                promised = [jn.get_journal("ns").promised_epoch
                            for jn in c.journalnodes]
                out = io.StringIO()
                tool = DFSAdmin(_port_conf(c), out=out)
                addr = f"127.0.0.1:{a.port}"
                try:
                    rcs = [tool.run([cmd, addr]) for cmd in (
                        "-getServiceState", "-transitionToActive",
                        "-transitionToStandby")]
                finally:
                    tool.close()
                lines = out.getvalue().splitlines()
                assert rcs == [0, 1, 1] and lines[0] == "fenced"
                assert all("was fenced by a newer writer" in ln
                           for ln in lines[1:]), lines
                for call in (a.transition_to_active,
                             a.transition_to_observer):
                    with pytest.raises(FencedError):
                        call()
                assert a.ha_state == "fenced"
                assert b.ha_state == "active"
                assert b.fsn.editlog.journal.epoch == epoch
                assert [jn.get_journal("ns").promised_epoch
                        for jn in c.journalnodes] == promised
                assert fs.mkdirs("/c24/later")
                assert b.fsn.fsdir.exists("/c24/later")
                assert not a.fsn.fsdir.exists("/c24/later")
            else:
                with pytest.raises(FencedError):
                    fs.mkdirs("/c24/after")
                assert a.ha_state == "active"
                assert not b.fsn.fsdir.exists("/c24/after")
        finally:
            fs.close()


# ----------------------------------------------------------------- C 26

def _hold_answer(fsn, method, inflight, stopped, nth=1):
    """The ``nth`` call of ``fsn.method`` that succeeds (for
    ``complete``, that closes the file) runs, then holds its answer
    until the NameNode has stopped, so the answer is lost with the
    connection."""
    real = getattr(fsn, method)
    done = []

    def held(*args, **kwargs):
        out = real(*args, **kwargs)
        if out is not False:
            done.append(out)
            if len(done) == nth:
                inflight.set()
                stopped.wait(15.0)
        return out

    setattr(fsn, method, held)


@pytest.mark.parametrize("call", ["add_block", "complete"])
@pytest.mark.parametrize("kind", sorted(MINIS))
def test_a_call_in_flight_when_the_active_stops(tmp_path, kind, call):
    """The active NameNode stops while its answer to a writer's second
    ``add_block``, or to its ``complete``, is in flight. The port's
    client retries the call on the new active, which answers with the
    block the first call allocated or the file it closed, so the file
    reads back whole on its two blocks (ROADMAP C 26); the reference's
    client does not retry the call and the write fails."""
    data = _bytes(1024 * 1024 + 5000, 26)
    with MINIS[kind].MiniQJMHACluster(num_journalnodes=3, num_namenodes=2,
                                      num_datanodes=1,
                                      base_dir=str(tmp_path)) as c:
        idx = c.wait_active()
        inflight, stopped = threading.Event(), threading.Event()
        _hold_answer(c.namenodes[idx].fsn, call, inflight, stopped,
                     nth=2 if call == "add_block" else 1)
        order = [("127.0.0.1", nn.port) for nn in c.namenodes]
        fs = DistributedFileSystem(order, _port_conf(c)) \
            if kind == "port" else JDFS(order, jconf(_port_conf(c)))
        result = {}

        def write():
            try:
                fs.write_all("/c26/f.bin", data)
                result["ok"] = True
            except Exception as e:  # noqa: BLE001 — the reference's fault
                result["error"] = e

        writer = threading.Thread(target=write)
        writer.start()
        try:
            assert inflight.wait(30.0)
            c.kill_active()
            stopped.set()
            writer.join(60.0)
            assert not writer.is_alive()
            if kind == "port":
                assert result == {"ok": True}
                assert c.wait_active() == 1 - idx
                inode = c.namenodes[1 - idx].fsn.fsdir.get_inode(
                    "/c26/f.bin")
                assert not inode.under_construction
                assert [b.num_bytes for b in inode.blocks] == \
                    [1024 * 1024, 5000]
                assert fs.read_all("/c26/f.bin") == data
            else:
                assert "error" in result, result
        finally:
            stopped.set()
            writer.join(60.0)
            fs.close()

