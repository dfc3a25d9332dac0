"""The port's conf-key registry (``hadoop_tpu_torch/conf/registry.py``,
generated by ``hadoop_tpu_torch/analysis/confscan.py``), its levers, its
gate on the command line, strict mode and a port door's
``/ws/v1/conf``, against the JAX package's registry, levers, strict
mode and ``/ws/v1/conf`` servlet.
"""

import json
import logging
import os
import subprocess
import sys
import textwrap
import urllib.request
from pathlib import Path

import pytest

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.conf import levers as jlevers
from hadoop_tpu.conf import registry as jregistry
from hadoop_tpu.http.server import HttpServer as JHttpServer
from hadoop_tpu_torch.analysis import confscan
from hadoop_tpu_torch.analysis.core import load_project
from hadoop_tpu_torch.conf import Configuration, levers, registry
from hadoop_tpu_torch.http.server import HttpServer

REPO = Path(__file__).resolve().parent.parent


def _cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "hadoop_tpu_torch.analysis", *args],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(REPO)))


def test_committed_registry_regenerates_to_itself():
    """The gate the tier-1 run holds: the shipped registry and README
    appendix are current, and every conf read of the port resolves."""
    ok, diff = confscan.check_registry(str(REPO))
    assert ok, "\n".join(diff[:60])
    project, errors = load_project([str(REPO / "hadoop_tpu_torch")],
                                   root=str(REPO))
    assert errors == []
    scan = confscan.scan_project(project)
    assert scan.unresolved == [], scan.unresolved
    assert {r.key for r in scan.reads if not r.is_pattern} == \
        set(registry.KEYS)
    assert all(r.rel.startswith("hadoop_tpu_torch/") for r in scan.reads)
    out = _cli("--check-conf-registry")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "current" in out.stdout


def test_stale_registry_fails_the_gate_and_write_repairs_it(tmp_path):
    pkg = tmp_path / "hadoop_tpu_torch"
    (pkg / "conf").mkdir(parents=True)
    (pkg / "__init__.py").write_text("")
    (pkg / "conf" / "__init__.py").write_text("")
    (pkg / "mod.py").write_text(textwrap.dedent("""
        KEY = "dfs.x.limit"

        def a(conf):
            return conf.get_int(KEY, 4), conf.get_time_seconds(
                f"dfs.{'y'}.wait", 1.5)
    """))
    (pkg / "conf" / "registry.py").write_text("KEYS = {}\n")  # stale
    (tmp_path / "README.md").write_text(
        "Levers: `dfs.x.limit`.\n\n"
        + confscan.README_BEGIN + "\n" + confscan.README_END + "\n")
    ok, diff = confscan.check_registry(str(tmp_path))
    assert not ok and diff
    out = _cli("--check-conf-registry", str(pkg))
    assert out.returncode == 1
    assert "STALE" in out.stdout and "+KEYS = {" in out.stdout
    out = _cli("--write-conf-registry", str(tmp_path))
    assert out.returncode == 0 and "updated" in out.stdout
    ok, diff = confscan.check_registry(str(tmp_path))
    assert ok, "\n".join(diff[:40])
    text = (pkg / "conf" / "registry.py").read_text()
    assert '"dfs.x.limit"' in text and '"dfs.y.wait"' in text
    ns = {}
    exec(compile(text.replace(
        "from hadoop_tpu_torch.conf.levers import LEVERS", "LEVERS = {}"),
        "registry", "exec"), ns)
    assert ns["KEYS"]["dfs.x.limit"]["documented"] is True
    assert ns["KEYS"]["dfs.y.wait"]["documented"] is False
    assert ns["KEYS"]["dfs.y.wait"]["type"] == "time"
    readme = (tmp_path / "README.md").read_text()
    assert "| `dfs.x.limit` | int | `4` | 1 |" in readme
    from hadoop_tpu_torch.analysis.__main__ import main
    assert main(["--check-conf-registry", str(tmp_path / "none")]) == 2


def test_readme_appendix_has_the_ports_own_markers():
    """The port's markers read as a generated region to the reference's
    scanner and are not its exact strings; the port's table comes after
    the reference's, so each key's first mention is hand-written text."""
    from hadoop_tpu.analysis import confscan as jconfscan
    text = (REPO / "README.md").read_text()
    for ours, theirs in ((confscan.README_BEGIN, jconfscan.README_BEGIN),
                         (confscan.README_END, jconfscan.README_END)):
        assert ours != theirs and theirs not in ours
        assert text.count(ours) == 1
    assert "conf-registry:begin" in confscan.README_BEGIN
    assert "conf-registry:end" in confscan.README_END
    assert text.index(jconfscan.README_END) < text.index(
        confscan.README_BEGIN)
    ok, diff = jconfscan.check_registry(str(REPO))
    assert ok, "\n".join(diff[:40])


def test_each_port_key_is_in_the_references_registry_without_drift():
    """Every key the port reads is registered by the reference with the
    same type, namespace and README bit; the port's defaults are some
    of the reference's. A key family the port reads through a prefix
    (the call queue's ``<prefix>.callqueue.impl``, ...) is the
    reference's pattern, held the same way."""
    assert set(registry.PATTERNS) <= set(jregistry.PATTERNS)
    for key, e in list(registry.KEYS.items()) + \
            list(registry.PATTERNS.items()):
        r = jregistry.KEYS.get(key) or jregistry.PATTERNS.get(key)
        assert r is not None, key
        assert e["type"] == r["type"], key
        assert set(e["defaults"]) <= set(r["defaults"]), key
        assert (e["namespace"], e["documented"]) == \
            (r["namespace"], r["documented"]), key
        assert e["sites"] >= 1 and all(
            f.startswith("hadoop_tpu_torch/") for f in e["files"])


def test_each_port_lever_is_the_references_entry():
    """``levers.py`` holds the reference's entry for exactly the levers
    whose keys the port reads, equal in every field (a note may drop the
    reference's trailing tracker tag)."""
    want = {k for k in jlevers.LEVERS if k in registry.KEYS}
    assert set(levers.LEVERS) == want
    assert registry.LEVERS is levers.LEVERS
    for key, lever in levers.LEVERS.items():
        ref = jlevers.LEVERS[key]
        assert set(lever) == set(ref), key
        for field, value in lever.items():
            if field == "note":
                assert ref["note"].startswith(value), key
            else:
                assert value == ref[field], (key, field)


@pytest.fixture(scope="module")
def doors():
    """A port chassis and a reference chassis on the same live conf: set
    registered keys (a lever, a secret), and keys nobody registers."""
    keys = {"serving.max.batch": "8",
            "serving.http.auth.secret": "s3cr3t",
            "serving.autoscale.util.high": "0.7",
            "dfs.client.hedged.read.threadpool.size": "4",
            "no.such.key": "1",
            "another.password": "p"}
    conf, jconf = Configuration(), JConfiguration(load_defaults=False)
    for k, v in keys.items():
        conf.set(k, v)
        jconf.set(k, v)
    port = HttpServer(conf, daemon_name="port")
    ref = JHttpServer(jconf, ("127.0.0.1", 0), daemon_name="ref")
    port.start()
    ref.start()
    yield port, ref, keys
    port.stop()
    ref.stop()


def _ws_conf(port, query=""):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/ws/v1/conf{query}", timeout=30) as r:
        assert r.status == 200
        return json.loads(r.read())


ROW_FIELDS = ("type", "namespace", "documented", "source", "effective")


def _same_lever(got, want):
    """Equal levers; the port's note may drop the reference's trailing
    tracker tag (``test_each_port_lever_is_the_references_entry``)."""
    if got is None or want is None:
        return got is want
    return set(got) == set(want) and all(
        want[f].startswith(v) if f == "note" else v == want[f]
        for f, v in got.items())


@pytest.mark.parametrize("query", ["", "?diff=1"], ids=["all", "diff"])
def test_ws_conf_rows_equal_the_reference_servlets(doors, query):
    port, ref, keys = doors
    got, want = _ws_conf(port.port, query), _ws_conf(ref.port, query)
    assert got["registry_keys"] == len(registry.KEYS)
    assert got["patterns"] == sorted(registry.PATTERNS)
    assert set(got["patterns"]) <= set(want["patterns"])
    want_rows = {r["key"]: r for r in want["keys"]}
    rows = {r["key"]: r for r in got["keys"]}
    assert len(rows) == len(got["keys"])
    if query:
        assert set(rows) == {k for k in keys if k in registry.KEYS}
        assert all(r["source"] == "set" for r in rows.values())
    else:
        assert set(rows) == set(registry.KEYS)
    for key, row in rows.items():
        for field in ROW_FIELDS:
            assert row.get(field) == want_rows[key].get(field), (key, field)
        assert _same_lever(row.get("lever"), want_rows[key].get("lever")), key
        assert set(row["defaults"]) <= set(want_rows[key]["defaults"])
    assert rows["serving.http.auth.secret"]["effective"] == "<redacted>"
    assert rows["serving.max.batch"]["effective"] == "8"
    assert rows["serving.autoscale.util.high"]["lever"]["guard"] == \
        "capacity"
    assert got["overridden"] == [k for k in want["overridden"]
                                 if k in registry.KEYS]
    assert got["unregistered"] == want["unregistered"] == [
        {"key": "another.password", "value": "<redacted>"},
        {"key": "no.such.key", "value": "1"}]


def test_strict_mode_warns_once_as_the_reference(caplog):
    """``conf.strict.keys=true``: a set() of a key the registry does not
    know warns once per key, a registered key is silent, as the
    reference's; with strict mode off nothing warns."""
    seen = {}
    for name, conf, logger in (
            ("port", Configuration(), "hadoop_tpu_torch.conf"),
            ("ref", JConfiguration(load_defaults=False), "hadoop_tpu.conf")):
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=logger):
            conf.set("quiet.before.strict", "1")
            conf.set("conf.strict.keys", "true")
            conf.set("serving.max.batch.typo", "1")
            conf.set("serving.max.batch", "4")
            conf.set("serving.max.batch.typo", "2")
            conf.set("dfs.client.hedged.read.threadpool.size", "2")
        seen[name] = [r.getMessage() for r in caplog.records
                      if "registry" in r.getMessage()]
    for name in seen:
        assert len(seen[name]) == 1, seen
        assert "serving.max.batch.typo" in seen[name][0]
    assert "hadoop_tpu_torch.analysis --write-conf-registry" in \
        seen["port"][0]
    caplog.clear()
    with caplog.at_level(logging.WARNING, logger="hadoop_tpu_torch.conf"):
        Configuration().set("total.garbage.key", "1")
    assert [r for r in caplog.records if "registry" in r.getMessage()] == []
