"""The port's HA operator tools and multi-process RPC server against the
JAX package's: ``cli/oiv.py``, ``cli/oev.py``, ``cli/dfsadmin.py``
(``DFSAdmin``, ``Fsck``) and ``ipc/mpserver.py`` with
``ipc.server.reuseport``.

- ``tests/test_tools_extra.py::test_oiv_and_oev_dump`` and the
  ``dfsadmin`` and ``fsck`` cases of ``tests/test_cli.py`` run on the
  port's modules, through ``torch_ported_cases``; the other cases of
  those files are left out, each naming its ROADMAP item.
- ``oiv`` and ``oev`` print the same text from both packages on one
  name directory, written by either package's NameNode.
- ``dfsadmin -report``, ``-safemode`` and ``fsck`` print the same from
  both packages' tools on one cluster.
- ``tests/test_ipc.py``'s ``MultiProcessServer`` case on the port's
  ``MultiProcessServer``, client and proxies: each worker process runs
  the port's ``ipc.Server``.

Every comparison is exact.
"""

import io
import os
import re

import pytest

from hadoop_tpu.cli import dfsadmin as jadmin
from hadoop_tpu.cli import oiv as joiv
from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.dfs.namenode.fsnamesystem import FSNamesystem as JFSN
from hadoop_tpu_torch.cli import dfsadmin as padmin
from hadoop_tpu_torch.cli import oiv as poiv
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.dfs.namenode.fsnamesystem import FSNamesystem
from hadoop_tpu_torch.ipc import Client, get_proxy
from hadoop_tpu_torch.ipc.mpserver import MultiProcessServer
from hadoop_tpu_torch.testing import minicluster as pmini
from torch_ported_cases import cases_on_port, collect_sockets

REPO = __import__("pathlib").Path(__file__).resolve().parents[1]

_A11 = "ROADMAP Queue A 11 (the YARN daemons and the MapReduce engine)"
_A12 = "ROADMAP Queue A 12 (the tools and the rest of the command line)"
globals().update(cases_on_port("test_tools_extra", {
    "test_sls_runs_all_schedulers": f"sls: {_A12}",
    "test_sls_capacity_queues_respected": f"sls: {_A12}",
    "test_har_roundtrip": f"archive: {_A12}",
    "test_timeline_records_app_lifecycle": f"the history server: {_A11}",
    "test_rumen_builds_trace_and_sls_replays_it": f"rumen, sls: {_A12}",
    "test_dynamometer_replays_audit_log": f"dynamometer: {_A12}",
    "test_gridmix_replays_trace_as_real_jobs": f"gridmix: {_A12}",
    "test_gridmix_submission_policies": f"gridmix: {_A12}",
    "test_sls_rm_mode_real_rpc": f"sls on the RM: {_A11}",
    "test_dynamometer_generate_and_parallel_replay":
        f"dynamometer: {_A12}",
    "test_rumen_gridmix_sls_compose_with_load_emulation":
        f"rumen, gridmix, sls: {_A12}",
    "test_atsv2_reader_flow_run_aggregation": f"the timeline: {_A11}",
    "test_load_reducer_emits_per_input_record": f"gridmix: {_A12}",
}, own_fixtures=True))
globals().update(cases_on_port("test_cli", {
    "test_mkdir_put_ls_cat_get": f"the fs shell: {_A12}",
    "test_rm_with_trash_and_skiptrash": f"the fs shell and trash: {_A12}",
    "test_mv_cp_count_du_setrep": f"the fs shell: {_A12}",
    "test_xattr_and_snapshot_commands": f"the fs shell: {_A12}",
    "test_generic_options_and_version":
        "the port's `version` names the port (hadoop_tpu_torch); its "
        "generic options are tests/test_torch_cli.py's, held to the "
        "reference's parser",
    "test_cli_dispatches_tools": f"sls: {_A12}",
    "test_cli_job_control": f"job: {_A11}",
}, absent=("hadoop_tpu.cli.shell",), own_fixtures=True))


# ------------------------------------------------------------ oiv / oev

def _name_dir(fsn_cls, conf, name_dir):
    """A namespace with an image mid-way and edits past it."""
    fsn = fsn_cls(conf, name_dir)
    fsn.load_from_disk()
    fsn.bm.safemode.leave(force=True)
    fsn.mkdirs("/a/b")
    fsn.create("/a/f.txt", "client-1", 1, None, False)
    fsn.mkdirs("/snap")
    fsn.allow_snapshot("/snap")
    fsn.create_snapshot("/snap", "s0")
    fsn.save_namespace()
    fsn.mkdirs("/after-image/x")
    fsn.delete("/a/b", True)
    fsn.close()


def _dumps(mod, name_dir):
    image, edits = io.StringIO(), io.StringIO()
    n_inodes = mod.dump_image(name_dir, out=image)
    n_edits = mod.dump_edits(name_dir, 1, out=edits)
    n_late = mod.dump_edits(name_dir, 5, out=io.StringIO())
    return n_inodes, image.getvalue(), n_edits, edits.getvalue(), n_late


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_oiv_and_oev_print_the_same(tmp_path, writer):
    name_dir = str(tmp_path / "name")
    if writer == "port":
        _name_dir(FSNamesystem, Configuration(load_defaults=False), name_dir)
    else:
        _name_dir(JFSN, JConfiguration(load_defaults=False), name_dir)
    got = _dumps(poiv, name_dir)
    assert got == _dumps(joiv, name_dir)
    n_inodes, image, n_edits, edits, n_late = got
    assert n_inodes >= 5 and n_edits > n_late > 0
    assert '"path": "/snap", "type": "DIRECTORY"' in image
    assert '"/after-image/x"' in edits


def test_oiv_and_oev_commands_print_the_same(tmp_path):
    """The port's ``oiv`` and ``oev`` commands, in a process where JAX
    cannot be imported, print what the reference's dumps do."""
    import subprocess
    import sys
    name_dir = str(tmp_path / "name")
    _name_dir(FSNamesystem, Configuration(load_defaults=False), name_dir)
    want = {"oiv": io.StringIO(), "oev": io.StringIO()}
    joiv.dump_image(name_dir, out=want["oiv"])
    joiv.dump_edits(name_dir, 3, out=want["oev"])
    code = ("import sys\n"
            "sys.modules['jax'] = sys.modules['hadoop_tpu'] = None\n"
            "from hadoop_tpu_torch.cli.main import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    for argv in (["oiv", "--name-dir", name_dir],
                 ["oev", "--name-dir", name_dir, "--from", "3"]):
        out = subprocess.run(
            [sys.executable, "-c", code, *argv], cwd=REPO,
            capture_output=True, text=True, timeout=120,
            env=dict(os.environ, PYTHONPATH=str(REPO)))
        assert out.returncode == 0, out.stderr[-2000:]
        assert out.stdout == want[argv[0]].getvalue()
        assert out.stdout


# ---------------------------------------------------------- dfsadmin

@pytest.fixture(scope="module")
def admin_cluster():
    with pmini.MiniDFSCluster(num_datanodes=2) as c:
        c.wait_active()
        yield c


def _run(mod, tool, conf_cls, cluster, argv):
    conf = conf_cls(load_defaults=False)
    for k, v in cluster.conf.to_dict().items():
        conf.set(k, v)
    conf.set("fs.defaultFS", f"htpu://127.0.0.1:{cluster.namenode.port}")
    out = io.StringIO()
    t = getattr(mod, tool)(conf, out=out)
    try:
        rc = t.run(argv)
    finally:
        t.close()
    return rc, out.getvalue()


@pytest.mark.parametrize("argv", [
    ("DFSAdmin", ["-safemode", "get"]), ("DFSAdmin", ["-listECPolicies"]),
    ("DFSAdmin", ["-getStoragePolicy", "/adm"]),
    ("DFSAdmin", ["-nosuch"]), ("DFSAdmin", ["-setQuota"]),
    ("Fsck", ["/adm"]), ("Fsck", ["/adm", "-files"])],
    ids=lambda a: "-".join([a[0]] + [x.strip("-/") for x in a[1]]))
def test_admin_tools_print_the_same(admin_cluster, argv):
    tool, args = argv
    fs = admin_cluster.get_filesystem()
    if not fs.exists("/adm/f.bin"):
        fs.write_all("/adm/f.bin", os.urandom(300_000))
    got = _run(padmin, tool, Configuration, admin_cluster, args)
    assert got == _run(jadmin, tool, JConfiguration, admin_cluster, args)
    assert got[0] == (1 if args[0] in ("-nosuch", "-setQuota") else 0)


def test_report_prints_the_same_less_the_counters(admin_cluster):
    """``-report`` of both tools, less the figures that move between the
    two calls (txid, the DataNodes' used bytes)."""
    def cut(text):
        return re.sub(r"(Txid|used)[:=] ?\d+", r"\1=N", text)
    got = _run(padmin, "DFSAdmin", Configuration, admin_cluster,
               ["-report"])
    want = _run(jadmin, "DFSAdmin", JConfiguration, admin_cluster,
                ["-report"])
    assert (got[0], cut(got[1])) == (want[0], cut(want[1]))
    assert "Datanodes (2)" in got[1]


# ----------------------------------------------- multi-process server

def _mp_factory(conf):
    """Per-worker protocol: reports the serving pid and the module of
    the server whose handler runs it."""
    import os as _os

    from hadoop_tpu_torch.ipc import current_call

    class WhoProtocol:
        def whoserves(self):
            return _os.getpid()

        def server(self):
            return type(current_call()).__module__

        def echo(self, x):
            return x
    return {"WhoProtocol": WhoProtocol()}


def test_multiprocess_server_distributes_and_survives_worker_death():
    """``tests/test_ipc.py``'s case of that name on the port: the
    connections spread over the workers, each a port ``ipc.Server``
    bound with ``ipc.server.reuseport``, and killing one worker leaves
    the port serving."""
    import signal
    srv = MultiProcessServer(factory="test_torch_hatools:_mp_factory",
                             num_workers=3, num_handlers=2, name="mp-test")
    srv.start()
    try:
        pids, servers = set(), set()
        for _ in range(12):
            c = Client()
            try:
                p = get_proxy("WhoProtocol", ("127.0.0.1", srv.port),
                              client=c)
                pids.add(p.whoserves())
                servers.add(p.server())
            finally:
                c.stop()
        assert len(pids) >= 2, f"all connections on one worker: {pids}"
        assert os.getpid() not in pids
        assert servers == {"hadoop_tpu_torch.ipc.server"}
        victim = srv._procs[0]
        os.kill(victim.pid, signal.SIGKILL)
        victim.join(timeout=5)
        ok = 0
        for _ in range(8):
            c = Client()
            try:
                if get_proxy("WhoProtocol", ("127.0.0.1", srv.port),
                             client=c).echo(7) == 7:
                    ok += 1
            finally:
                c.stop()
        assert ok == 8
        assert srv.alive_workers() == 2
    finally:
        srv.stop()
    assert srv.alive_workers() == 0
