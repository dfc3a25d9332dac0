"""The port's quorum journal (``hadoop_tpu_torch/dfs/qjournal.py``)
against the JAX package's.

- The journal-layer cases of ``tests/test_ha.py`` (quorum write and
  read, epoch fencing, recovery with a JournalNode down, a laggard
  synced past the fetch cap, stale and uncommitted copies, the gap and
  hole refusals, the committed floor, the lease) run on the port's
  modules, through ``torch_ported_cases``.
- Mixed quorums: two port JournalNodes and one reference JournalNode,
  and one and two, under each package's ``QuorumJournalManager``. A
  writer finalizes a segment, opens another, and dies with one txid on
  a single JournalNode; the other package's writer recovers. The
  recovered tail, what a tailer reads, and every file of the three
  storage directories (segments, ``epoch``, ``segment_epochs``,
  ``committed_txid``) equal those of the same run on a quorum of the
  reference's JournalNodes, and the three directories equal each other.
- Each package's JournalNode starts from the other's storage directory
  and answers ``get_state``, ``get_edits`` and ``new_epoch`` as the
  writer's package does, leaving the same files.

Every comparison is exact.
"""

import inspect
import os
import shutil
import struct

import pytest

from hadoop_tpu.dfs import qjournal as jqj
from hadoop_tpu.io.wire import pack as jpack
from hadoop_tpu_torch.dfs import qjournal as pqj
from hadoop_tpu_torch.io.wire import pack as ppack
from hadoop_tpu_torch.ipc import Client, get_proxy
from hadoop_tpu_torch.testing.minicluster import fast_conf
from torch_ported_cases import cases_on_port, collect_sockets, jconf

_HA = cases_on_port("test_ha", {})
# the cases on the ``jns`` fixture; the HA cluster's are test_torch_ha.py's
globals().update({
    k: v for k, v in _HA.items()
    if not k.startswith("test_") or
    "jns" in inspect.signature(v).parameters})

PACKAGES = {"port": (pqj, ppack), "reference": (jqj, jpack)}
MIXES = {"2port+1ref": ("port", "port", "reference"),
         "1port+2ref": ("reference", "port", "reference")}


def _other(kind):
    return "reference" if kind == "port" else "port"


def _start_jn(kind, storage_dir):
    conf = fast_conf()
    if kind == "reference":
        conf = jconf(conf)
    jn = PACKAGES[kind][0].JournalNode(conf, storage_dir=storage_dir)
    jn.init(conf)
    jn.start()
    return jn


def _blob(kind, first, last):
    out = bytearray()
    for t in range(first, last + 1):
        data = PACKAGES[kind][1]({"t": t, "op": "mkdir", "p": f"/d{t}"})
        out += struct.pack(">I", len(data)) + data
    return bytes(out)


def _write(qjm, kind, first, last):
    qjm.journal(_blob(kind, first, last), first, last - first + 1)
    qjm.sync()


def _files(storage_dir):
    """{name: bytes} of a JournalNode's journal ``ns``."""
    d = os.path.join(storage_dir, "ns")
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _crashed_writer(kind, addrs, lone):
    """``kind``'s writer: txids 1-5 in a finalized segment, 6-8 in an
    open one, then txid 9 on JournalNode ``lone`` only, and no more."""
    w = PACKAGES[kind][0].QuorumJournalManager(addrs)
    assert w.recover() == 0
    w.start_segment(1)
    _write(w, kind, 1, 3)
    _write(w, kind, 4, 5)
    w.finalize_segment(1, 5)
    w.start_segment(6)
    _write(w, kind, 6, 8)
    w._proxies[lone].journal("ns", w.epoch, _blob(kind, 9, 9), 9, 1, 9, 0)
    w.close()


def _quorum_run(tmp, jn_kinds, first, second):
    """The crashed writer of package ``first`` on JournalNodes of
    ``jn_kinds``, recovered by ``second``'s writer: the recovered last
    txid, the tail a tailer reads, and every JournalNode's files."""
    dirs = [str(tmp / f"jn{i}") for i in range(len(jn_kinds))]
    jns = [_start_jn(k, d) for k, d in zip(jn_kinds, dirs)]
    try:
        addrs = [("127.0.0.1", jn.port) for jn in jns]
        _crashed_writer(first, addrs, lone=1)
        w = PACKAGES[second][0].QuorumJournalManager(addrs)
        last = w.recover()
        tail = list(w.read_edits(1))
        w.close()
    finally:
        for jn in jns:
            jn.stop()
    return last, tail, [_files(d) for d in dirs]


@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("mix", sorted(MIXES))
def test_mixed_quorum_recovers_the_same_tail_and_files(tmp_path, mix,
                                                       writer):
    got = _quorum_run(tmp_path / "mixed", MIXES[mix], writer,
                      _other(writer))
    want = _quorum_run(tmp_path / "reference", ("reference",) * 3,
                       "reference", "reference")
    last, tail, files = got
    assert got == want
    assert last == 9 and [r["t"] for r in tail] == list(range(1, 10))
    assert files[0] == files[1] == files[2]
    assert set(files[0]) == {"edits_1-5", "edits_6-9", "epoch",
                             "segment_epochs", "committed_txid"}
    assert (files[0]["epoch"], files[0]["segment_epochs"],
            files[0]["committed_txid"]) == (b"2", b"1 1\n6 2\n", b"9")


def _answers(jns):
    """Each JournalNode's get_state, get_edits (whole, and from txid 4
    capped at 2), then new_epoch 7 and get_state again, through the
    port's client."""
    client = Client(fast_conf())
    out = []
    try:
        for jn in jns:
            p = get_proxy("JournalProtocol", ("127.0.0.1", jn.port),
                          client=client)
            out.append([p.get_state("ns"), p.get_edits("ns", 1),
                        p.get_edits("ns", 4, 2), p.new_epoch("ns", 7),
                        p.get_state("ns")])
    finally:
        client.stop()
    return out


@pytest.mark.parametrize("writer", sorted(PACKAGES))
def test_each_journalnode_serves_the_others_storage(tmp_path, writer):
    """The writer's JournalNodes hold a crashed writer's log (an open
    segment, a lone txid); stopped, each storage directory is copied;
    the writer's JournalNodes start again on one copy, the other
    package's on the other, and answer the same, leaving the same
    files."""
    dirs = [str(tmp_path / f"jn{i}") for i in range(3)]
    jns = [_start_jn(writer, d) for d in dirs]
    try:
        _crashed_writer(writer, [("127.0.0.1", jn.port) for jn in jns],
                        lone=1)
    finally:
        for jn in jns:
            jn.stop()
    runs = {}
    for kind in (writer, _other(writer)):
        copies = [f"{d}-{kind}" for d in dirs]
        for d, c in zip(dirs, copies):
            shutil.copytree(d, c)
        jns = [_start_jn(kind, c) for c in copies]
        try:
            runs[kind] = (_answers(jns), [_files(c) for c in copies])
        finally:
            for jn in jns:
                jn.stop()
    assert runs["port"] == runs["reference"]
    answers, files = runs["port"]
    assert [a[0] for a in answers] == [
        {"promised": 1, "last_txid": last} for last in (8, 9, 8)]
    assert [r["t"] for r in answers[1][1]["records"]] == list(range(1, 10))
    assert [r["t"] for r in answers[0][2]["records"]] == [4, 5]
    assert all(f["epoch"] == b"7" for f in files)


@pytest.mark.parametrize("kind", sorted(PACKAGES))
def test_a_down_journalnode_costs_one_refused_call_a_sync(tmp_path, kind):
    """With one JournalNode down, each sync makes one refused call to it
    (ROADMAP C 25): ten syncs take well under the 0.35 s a sync that the
    port's three retries with backoff cost at least."""
    import time
    jns = [_start_jn(kind, str(tmp_path / f"jn{i}")) for i in range(3)]
    try:
        w = PACKAGES[kind][0].QuorumJournalManager(
            [("127.0.0.1", jn.port) for jn in jns])
        w.recover()
        w.start_segment(1)
        jns[0].stop()
        t0 = time.monotonic()
        for t in range(1, 11):
            _write(w, kind, t, t)
        seconds = time.monotonic() - t0
        assert [r["t"] for r in w.read_edits(1)] == list(range(1, 11))
        w.close()
    finally:
        for jn in jns[1:]:
            jn.stop()
    assert seconds < 3.5, seconds
