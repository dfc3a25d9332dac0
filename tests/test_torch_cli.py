"""The port's command line (``python -m hadoop_tpu_torch.cli.main``).

``registry`` and ``doctor`` run as their own processes, serve (a port
``RegistryClient`` registers and lists; the doctor discovers the record
through the registry and answers ``/ws/v1/fleet/doctor``), and exit 0 on
SIGTERM; so do ``namenode`` and ``datanode``, in processes where JAX
cannot be imported, with the port's client writing and reading through
them, and ``journalnode``, which a port ``QuorumJournalManager`` writes
to and reads from; ``serve`` and ``autoscale`` hand over to their entry points; an
unported command of the reference's command line exits 2 naming its
ROADMAP item, an unknown one 1; the generic options set conf keys as the
reference's parser does.
"""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from hadoop_tpu.cli import main as jmain
from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu_torch.cli import main as cli
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.http import http_get
from hadoop_tpu_torch.registry import RegistryClient, ServiceRecord
from hadoop_tpu_torch.util.misc import free_port

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]


def _spawn(*args):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.Popen(
        [sys.executable, "-m", "hadoop_tpu_torch.cli.main", *args],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def _until(fn, seconds=60.0):
    deadline = time.monotonic() + seconds
    last = None
    while time.monotonic() < deadline:
        try:
            return fn()
        except (OSError, ValueError) as e:
            last = e
            time.sleep(0.1)
    raise AssertionError(f"not up in {seconds}s: {last}")


def _stop(proc):
    proc.send_signal(signal.SIGTERM)
    try:
        out, err = proc.communicate(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        raise AssertionError(f"no exit on SIGTERM: {err[-2000:]}")
    return proc.returncode, err


def test_registry_and_doctor_daemons_serve_and_stop_on_sigterm():
    reg_port, doc_port = free_port(), free_port()
    reg = _spawn("registry", "-D", f"registry.port={reg_port}")
    doc = None
    client = None
    try:
        client = RegistryClient(("127.0.0.1", reg_port),
                                Configuration(load_defaults=False))
        rec = ServiceRecord("/services/serving/svc/a",
                            {"http": "127.0.0.1:1"}, {"state": "serving"})
        _until(lambda: client.register(rec, ttl_s=120, auto_renew=False))
        assert [r.path for r in client.list("/services")] == [rec.path]
        doc = _spawn("doctor", "--registry", f"127.0.0.1:{reg_port}",
                     "--port", str(doc_port), "--interval", "3600",
                     "-D", "obs.doctor.scrape.timeout=1")
        report = _until(lambda: json.loads(http_get(
            "127.0.0.1", doc_port, "/ws/v1/fleet/doctor", 5.0)))
        assert report["generated_at"] == 0.0       # no poll yet
        for proc in (doc, reg):
            rc, err = _stop(proc)
            assert rc == 0, err[-2000:]
        doc = reg = None
    finally:
        if client is not None:
            client.close()
        for proc in (doc, reg):
            if proc is not None:
                proc.kill()
                proc.communicate()


def _spawn_without_jax(*args):
    """The command line in a process where ``jax`` and the JAX package
    cannot be imported."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['hadoop_tpu'] = None\n"
            "from hadoop_tpu_torch.cli.main import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.Popen([sys.executable, "-c", code, *args], cwd=REPO,
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def test_namenode_and_datanode_serve_without_jax(tmp_path):
    from hadoop_tpu_torch.dfs.client import DistributedFileSystem
    nn_port = free_port()
    fast = ["-D", "dfs.heartbeat.interval=0.1s",
            "-D", "dfs.namenode.heartbeat.recheck-interval=0.25s"]
    nn = _spawn_without_jax(
        "namenode", "-D", f"dfs.namenode.name.dir={tmp_path / 'name'}",
        "-D", f"dfs.namenode.rpc-port={nn_port}", *fast)
    dn = _spawn_without_jax(
        "datanode", "-D", f"dfs.datanode.data.dir={tmp_path / 'data'}",
        "-D", f"dfs.namenode.rpc-address=127.0.0.1:{nn_port}",
        "-D", f"dfs.domain.socket.path={tmp_path}/dn-_PORT.sock", *fast)
    conf = Configuration(load_defaults=False)
    conf.set("dfs.replication", "1")
    fs = DistributedFileSystem([("127.0.0.1", nn_port)], conf)
    try:
        def one_live():
            if fs.client.nn.get_stats()["live_datanodes"] != 1:
                raise OSError("the DataNode has not registered yet")
        _until(one_live)
        payload = os.urandom(300_000)
        fs.write_all("/cli/f.bin", payload)
        assert fs.read_all("/cli/f.bin") == payload
        fs.close()
        fs = None
        for proc in (dn, nn):
            rc, err = _stop(proc)
            assert rc == 0, err[-2000:]
        dn = nn = None
    finally:
        if fs is not None:
            fs.close()
        for proc in (dn, nn):
            if proc is not None:
                proc.kill()
                proc.communicate()


def test_journalnodes_serve_a_quorum_without_jax(tmp_path):
    """Three ``journalnode`` processes without JAX; a port writer
    recovers, writes and finalizes a segment on them and reads it back;
    each stops on SIGTERM with exit 0."""
    import struct
    from hadoop_tpu_torch.dfs.qjournal import QuorumJournalManager
    from hadoop_tpu_torch.io.wire import pack
    ports = [free_port() for _ in range(3)]
    procs = [_spawn_without_jax(
        "journalnode", "-D", f"dfs.journalnode.edits.dir={tmp_path}/jn{i}",
        "-D", f"dfs.journalnode.rpc-port={port}")
        for i, port in enumerate(ports)]
    qjm = QuorumJournalManager([("127.0.0.1", p) for p in ports],
                               conf=Configuration(load_defaults=False))
    try:
        # every JournalNode up before the writer starts its segment
        _until(lambda: [p.get_state("ns") for p in qjm._proxies])
        assert qjm.recover() == 0
        qjm.start_segment(1)
        recs = [{"t": t, "op": "mkdir", "p": f"/j{t}"} for t in (1, 2, 3)]
        qjm.journal(b"".join(struct.pack(">I", len(pack(r))) + pack(r)
                             for r in recs), 1, 3)
        qjm.sync()
        qjm.finalize_segment(1, 3)
        assert list(qjm.read_edits(1)) == recs
        for i in range(3):
            assert os.path.exists(tmp_path / f"jn{i}" / "ns" / "edits_1-3")
        for proc in procs:
            rc, err = _stop(proc)
            assert rc == 0, err[-2000:]
        procs = []
    finally:
        qjm.close()
        for proc in procs:
            proc.kill()
            proc.communicate()


@pytest.mark.parametrize("cmd", sorted(cli.UNPORTED))
def test_an_unported_command_exits_2_naming_its_item(cmd, capsys):
    assert cli.main([cmd, "x"]) == 2
    err = capsys.readouterr().err
    assert "not ported" in err and "ROADMAP Queue A 1" in err


def test_every_reference_command_is_served_or_named():
    """Each command the reference's ``_main`` dispatches is either run
    by the port or in ``UNPORTED``."""
    import inspect
    import re
    src = inspect.getsource(jmain._main)
    ref_cmds = set(re.findall(r'cmd == "([a-z0-9]+)"', src))
    served = {"version", "namenode", "datanode", "registry", "doctor",
              "serve", "autoscale", "journalnode", "oiv", "oev",
              "dfsadmin", "fsck"}
    assert ref_cmds == served | set(cli.UNPORTED)


def test_unknown_command_exits_1_and_help_0(capsys):
    assert cli.main(["bogus"]) == 1
    assert "unknown command" in capsys.readouterr().err
    assert cli.main([]) == 0
    assert "registry" in capsys.readouterr().out
    assert cli.main(["version"]) == 0
    assert cli.main(["registry", "-conf", "x.xml"]) == 2


@pytest.mark.parametrize("argv", [
    ["-D", "a.b=1", "rest", "-Dc.d=x=y", "-fs", "htpu://h:1", "tail"],
    ["plain"], ["-D", "k=", "x"], ["-D"]])
def test_generic_options_parse_as_the_references(argv):
    conf, jconf = Configuration(load_defaults=False), \
        JConfiguration(load_defaults=False)
    assert cli.parse_generic_options(conf, list(argv)) == \
        jmain.parse_generic_options(jconf, list(argv))
    assert conf.to_dict() == {k: v for k, v in jconf.to_dict().items()}


def test_serve_and_autoscale_hand_over(monkeypatch):
    from hadoop_tpu_torch.serving import service
    from hadoop_tpu_torch.serving.autoscale import __main__ as amain
    seen = []
    monkeypatch.setattr(service, "replica_main",
                        lambda argv, conf: seen.append(("serve", argv,
                                                        conf.get("k"))) or 7)
    monkeypatch.setattr(amain, "autoscaler_main",
                        lambda argv, conf: seen.append(("autoscale", argv,
                                                        conf.get("k"))) or 8)
    assert cli.main(["serve", "-D", "k=v", "--preset", "tiny"]) == 7
    assert cli.main(["autoscale", "--service", "s", "-Dk=w"]) == 8
    assert seen == [("serve", ["--preset", "tiny"], "v"),
                    ("autoscale", ["--service", "s"], "w")]
