"""The port's command line: its daemons and its serving plane.

    python -m hadoop_tpu_torch.cli.main namenode [-D k=v ...]
    python -m hadoop_tpu_torch.cli.main datanode [-D k=v ...]
    python -m hadoop_tpu_torch.cli.main journalnode [-D k=v ...]
    python -m hadoop_tpu_torch.cli.main dfsadmin -fs htpu://H:P -<command>
        [args]
    python -m hadoop_tpu_torch.cli.main fsck -fs htpu://H:P [PATH]
        [-files]
    python -m hadoop_tpu_torch.cli.main oiv|oev --name-dir DIR
    python -m hadoop_tpu_torch.cli.main registry [-D k=v ...]
    python -m hadoop_tpu_torch.cli.main doctor [--registry H:P]
        [--service PREFIX] [--namenode-http H:P] [--endpoints LIST]
        [--port N] [--interval S]
    python -m hadoop_tpu_torch.cli.main serve --checkpoint URI
        --preset NAME [--registry H:P] [--role R] ...
    python -m hadoop_tpu_torch.cli.main autoscale --registry H:P
        --service NAME [--rm H:P --app ID] [--http-port N]
    python -m hadoop_tpu_torch.cli.main version

The daemon half of ``hadoop_tpu/cli/main.py``. Generic options come
before a command's own: ``-D key=value`` (or ``-Dkey=value``) sets a
conf key, ``-fs URI`` sets ``fs.defaultFS``. ``namenode``,
``datanode`` and ``journalnode`` run the port's DFS daemons
(``dfs.namenode.name.dir``, ``dfs.namenode.rpc-port``, and for HA
``dfs.namenode.shared.edits.dir``, the JournalNodes' ``host:port``
list; ``dfs.datanode.data.dir``, ``dfs.namenode.rpc-address``;
``dfs.journalnode.edits.dir``, ``dfs.journalnode.rpc-port``);
``dfsadmin`` and ``fsck`` the port's admin tools (``-report``,
``-safemode``, quotas, ``-transitionToActive H:P``,
``-transitionToStandby H:P``, ``-getServiceState H:P``, ...; a
namespace health walk); ``oiv`` and ``oev`` dump a name directory's
image and edits offline; ``registry`` the port's
``RegistryServer`` (``registry.port``, 0 for any); ``doctor`` the port's
``FleetDoctor`` (``obs/doctor.py``); each stops on SIGTERM or SIGINT and
exits 0. ``serve`` hands over to the replica's command line
(``serving.service.replica_main``) and ``autoscale`` to the
autoscaler's (``serving.autoscale.__main__.autoscaler_main``).

Every other command of the reference's command line exits 2 and names
the ROADMAP Queue A item that brings it (:data:`UNPORTED`); ``-conf
FILE`` does too, since the port's ``Configuration`` reads no XML
resource. An unknown command exits 1.
"""

from __future__ import annotations

import signal
import sys
import threading
from typing import Dict, List

from hadoop_tpu_torch.conf import ConfLike, Configuration

VERSION = "0.1.0"
FS_DEFAULT_FS = "fs.defaultFS"

_YARN = "ROADMAP Queue A 11 (the YARN daemons and the MapReduce engine)"
_REST = "ROADMAP Queue A 12 (the tools and the rest of the command line)"
# the reference's commands the port does not run yet, and the item that
# brings each
UNPORTED: Dict[str, str] = {
    **{c: _YARN for c in ("rm", "nodeagent", "historyserver", "job")},
    **{c: _REST for c in ("fs", "balancer", "mover",
                          "cacheadmin", "crypto", "kms", "httpfs",
                          "router", "distcp", "streaming", "archive",
                          "sls", "gridmix", "rumen", "dynamometer",
                          "fs2img", "resourceestimator", "lint")},
}


class _UsageError(ValueError):
    pass


def parse_generic_options(conf: ConfLike, argv: List[str]) -> List[str]:
    """Consume ``-D``/``-fs`` into ``conf``; the rest of the arguments."""
    rest: List[str] = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-D" and i + 1 < len(argv):
            key, _, val = argv[i + 1].partition("=")
            conf.set(key, val)
            i += 2
        elif a.startswith("-D") and "=" in a:
            key, _, val = a[2:].partition("=")
            conf.set(key, val)
            i += 1
        elif a == "-conf" and i + 1 < len(argv):
            raise _UsageError(f"-conf {argv[i + 1]}: the port reads no XML "
                              f"conf resource ({_REST}); use -D key=value")
        elif a == "-fs" and i + 1 < len(argv):
            conf.set(FS_DEFAULT_FS, argv[i + 1])
            i += 2
        else:
            rest.append(a)
            i += 1
    return rest


def _run_daemon(service, conf: ConfLike) -> int:
    """Init and start ``service``, wait for SIGTERM or SIGINT, stop it."""
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    service.init(conf)
    service.start()
    try:
        while not stop.wait(1.0):
            pass
    finally:
        service.stop()
    return 0


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help", "help"):
        print(__doc__)
        return 0
    cmd, *rest = argv
    conf = Configuration()
    try:
        rest = parse_generic_options(conf, rest)
    except _UsageError as e:
        print(f"hadoop_tpu_torch: {e}", file=sys.stderr)
        return 2
    if cmd == "version":
        print(f"hadoop_tpu_torch {VERSION}")
        return 0
    if cmd == "namenode":
        from hadoop_tpu_torch.dfs.namenode import NameNode
        return _run_daemon(NameNode(conf), conf)
    if cmd == "datanode":
        from hadoop_tpu_torch.dfs.datanode import DataNode
        return _run_daemon(DataNode(conf), conf)
    if cmd == "journalnode":
        from hadoop_tpu_torch.dfs.qjournal import JournalNode
        return _run_daemon(JournalNode(conf), conf)
    if cmd in ("dfsadmin", "fsck"):
        from hadoop_tpu_torch.cli.dfsadmin import DFSAdmin, Fsck
        tool = (DFSAdmin if cmd == "dfsadmin" else Fsck)(conf)
        try:
            return tool.run(rest)
        finally:
            tool.close()
    if cmd == "oiv":
        from hadoop_tpu_torch.cli.oiv import main_oiv
        return main_oiv(rest)
    if cmd == "oev":
        from hadoop_tpu_torch.cli.oiv import main_oev
        return main_oev(rest)
    if cmd == "registry":
        from hadoop_tpu_torch.registry import RegistryServer
        return _run_daemon(RegistryServer(conf), conf)
    if cmd == "doctor":
        from hadoop_tpu_torch.obs.doctor import doctor_main
        return doctor_main(rest, conf)
    if cmd == "serve":
        from hadoop_tpu_torch.serving.service import replica_main
        return replica_main(rest, conf)
    if cmd == "autoscale":
        from hadoop_tpu_torch.serving.autoscale.__main__ import \
            autoscaler_main
        return autoscaler_main(rest, conf)
    if cmd in UNPORTED:
        print(f"hadoop_tpu_torch: {cmd!r} is not ported: {UNPORTED[cmd]}",
              file=sys.stderr)
        return 2
    print(f"hadoop_tpu_torch: unknown command {cmd!r}; try `help`",
          file=sys.stderr)
    return 1


if __name__ == "__main__":
    sys.exit(main())
