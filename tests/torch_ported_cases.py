"""The JAX package's DFS test cases, run on the port's modules.

:func:`cases_on_port` loads one of the reference's test files with every
``hadoop_tpu.`` module it names replaced by its ``hadoop_tpu_torch.``
counterpart, so the very cases that hold the reference's NameNode,
DataNodes and ``MiniDFSCluster`` hold the port's. The caller binds the
returned tests and fixtures into its own module (pytest collects them
there), under the names the reference gave them, less the cases it
lists with a reason. :class:`MixedCluster` runs either package's
NameNode beside either package's DataNodes; :class:`MixedHACluster`
either package's JournalNodes, NameNodes and DataNodes in one HA
cluster.
"""

import gc
import os
import re
import time
import types
from pathlib import Path

import pytest

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.dfs.datanode import DataNode as JDataNode
from hadoop_tpu.dfs.namenode import NameNode as JNameNode
from hadoop_tpu.dfs.qjournal import JournalNode as JJournalNode
from hadoop_tpu_torch.testing import minicluster as pmini

TESTS = Path(__file__).resolve().parent


def cases_on_port(name: str, leave_out: dict, absent: tuple = (),
                  reference: tuple = (), own_fixtures: bool = False) -> dict:
    """``tests/<name>.py`` on the port: its fixtures and ``test_*``
    functions, less ``leave_out`` (test name -> the reason it cannot run
    on the port, which names the ROADMAP item that brings it).
    ``absent`` names reference modules the port has no copy of: their
    one-line module-level imports are dropped (only cases in
    ``leave_out`` may use them). ``reference`` names modules that stay
    the reference's (test harnesses and daemons the port does not have,
    such as the KDC). ``own_fixtures`` renames the module's fixtures
    (``cluster`` → ``cluster__<name>``, at every bare use), so modules
    whose fixtures share a name can be bound into one test module."""
    path = TESTS / f"{name}.py"
    src = path.read_text()
    for module in absent:
        src, n = re.subn(rf"^from {re.escape(module)} import [^\n(]*\n", "",
                         src, flags=re.M)
        assert n == 1, f"{name} imports {module} {n} times at the top"
    for i, module in enumerate(reference):
        assert module in src, f"{name} does not name {module}"
        src = src.replace(module, f"@KEEP{i}@")
    src = re.sub(r"\bhadoop_tpu\.", "hadoop_tpu_torch.", src)
    if own_fixtures:
        for fixture in re.findall(r"^@pytest\.fixture[^\n]*\ndef (\w+)", src,
                                  flags=re.M):
            src = re.sub(rf"(?<![.\w'\"]){fixture}\b(?!['\"])",
                         f"{fixture}__{name}", src)
    for i, module in enumerate(reference):
        src = src.replace(f"@KEEP{i}@", module)
    src = re.sub(r"\bfrom hadoop_tpu import\b", "from hadoop_tpu_torch import",
                 src)
    mod = types.ModuleType(f"{name}_on_port")
    mod.__file__ = str(path)
    exec(compile(src, str(path), "exec"), mod.__dict__)
    tests = {k for k in vars(mod) if k.startswith("test_")}
    unknown = set(leave_out) - tests
    assert not unknown, f"{name} has no {sorted(unknown)}"
    assert all(leave_out.values()), "every case left out needs a reason"
    cases = {k: v for k, v in vars(mod).items()
             if k not in leave_out and not k.startswith("__")
             and (k in tests or getattr(v, "_fixture_function_marker", None)
                  or type(v).__name__ == "FixtureFunctionDefinition")}
    cases["_reset_port_state"] = _reset_port_state
    return cases


@pytest.fixture(autouse=True)
def _reset_port_state():
    """After each case, the port's process-wide state as
    ``tests/conftest.py`` leaves the reference's: the login user, the
    data-transfer dial default, the metrics system and span collector."""
    yield
    from hadoop_tpu_torch.dfs.protocol import datatransfer
    from hadoop_tpu_torch.metrics import metrics_system
    from hadoop_tpu_torch.security.ugi import UserGroupInformation
    from hadoop_tpu_torch.tracing import span_collector
    datatransfer.set_default_security(None)
    UserGroupInformation._login_user = None
    metrics_system().reset_for_tests()
    span_collector().reset_for_tests()


@pytest.fixture(autouse=True)
def collect_sockets():
    """After each case, collect the reference cycles that still hold its
    daemons' and clients' sockets, so a test process does not pile up
    descriptors: past 1024 the reference's RPC client cannot connect
    (ROADMAP C 29). A module takes it by importing it."""
    yield
    gc.collect()


def jconf(conf):
    """A reference ``Configuration`` holding ``conf``'s keys."""
    out = JConfiguration(load_defaults=False)
    for k, v in conf.to_dict().items():
        out.set(k, v)
    return out


class MixedCluster(pmini.MiniDFSCluster):
    """The port's cluster with daemons of either package: ``nn_cls`` the
    NameNode's class, ``dn_classes[i % len]`` DataNode ``i``'s. Each
    reference daemon gets a reference ``Configuration`` of the same
    keys."""

    def __init__(self, nn_cls, dn_classes, **kwargs):
        super().__init__(**kwargs)
        self.nn_cls, self.dn_classes = nn_cls, list(dn_classes)

    def _conf_for(self, cls):
        conf = pmini.Configuration(other=self.conf)
        return jconf(conf) if cls in (JNameNode, JDataNode) else conf

    def _start_namenode(self) -> None:
        nn_conf = self._conf_for(self.nn_cls)
        if self.namenode is not None:
            nn_conf.set("dfs.namenode.rpc-port", self.namenode.port)
        self.namenode = self.nn_cls(
            nn_conf, name_dir=os.path.join(self.base_dir, "name"))
        self.namenode.init(nn_conf)
        self.namenode.start()
        self.conf.set("dfs.namenode.rpc-address",
                      f"127.0.0.1:{self.namenode.port}")

    def _start_datanode(self, i: int) -> None:
        dn_cls = self.dn_classes[i % len(self.dn_classes)]
        dn_conf = self._conf_for(dn_cls)
        dn = dn_cls(dn_conf,
                         data_dir=os.path.join(self.base_dir, f"data{i}"),
                         nn_addr=("127.0.0.1", self.namenode.port))
        dn.init(dn_conf)
        dn.start()
        if i < len(self.datanodes):
            self.datanodes[i] = dn
        else:
            self.datanodes.append(dn)


class MixedHACluster(pmini.MiniQJMHACluster):
    """The port's HA cluster with daemons of either package: JournalNode
    ``i`` of ``jn_classes[i % len]``, NameNode ``i`` of
    ``nn_classes[i]``, DataNode ``i`` of ``dn_classes[i % len]``. Each
    reference daemon gets a reference ``Configuration`` of the same
    keys. NameNode 0 is elected active before NameNode 1 starts, so it
    is the first active."""

    def __init__(self, jn_classes, nn_classes, dn_classes, **kwargs):
        super().__init__(num_namenodes=len(nn_classes), **kwargs)
        self.jn_classes, self.nn_classes = list(jn_classes), list(nn_classes)
        self.dn_classes = list(dn_classes)

    def _conf_for(self, cls):
        conf = pmini.Configuration(other=self.conf)
        return jconf(conf) if cls in (JNameNode, JDataNode,
                                      JJournalNode) else conf

    def _start_journalnode(self, i: int) -> None:
        cls = self.jn_classes[i % len(self.jn_classes)]
        conf = self._conf_for(cls)
        jn = cls(conf, storage_dir=os.path.join(self.base_dir,
                                                f"journal{i}"))
        jn.init(conf)
        jn.start()
        self.journalnodes.append(jn)

    def _start_namenode(self, i: int, observer: bool = False) -> None:
        cls = self.nn_classes[i]
        conf = self._conf_for(cls)
        first = i not in self._nn_ports
        if i in self._nn_ports:
            conf.set("dfs.namenode.rpc-port", self._nn_ports[i])
        nn = cls(conf, name_dir=os.path.join(self.base_dir, f"name{i}"),
                 nn_id=f"nn{i + 1}")
        nn.init(conf)
        nn.start()
        self._nn_ports[i] = nn.port
        if i < len(self.namenodes):
            self.namenodes[i] = nn
        else:
            self.namenodes.append(nn)
        deadline = time.monotonic() + 30.0
        while first and i == 0 and nn.ha_state != "active":
            assert time.monotonic() < deadline, "NameNode 0 never active"
            time.sleep(0.05)

    def _start_datanode(self, i: int) -> None:
        cls = self.dn_classes[i % len(self.dn_classes)]
        conf = self._conf_for(cls)
        dn = cls(conf, data_dir=os.path.join(self.base_dir, f"data{i}"),
                 nn_addr=[("127.0.0.1", nn.port) for nn in self.namenodes])
        dn.init(conf)
        dn.start()
        self.datanodes.append(dn)
