"""Encryption at rest in the port (``hadoop_tpu_torch/crypto`` and the
zone path of ``dfs/client/filesystem.py``) against the JAX package's
streams, key providers, KMS server and a ``MiniDFSCluster`` with an
encryption zone.

Every comparison is exact: the streams' bytes equal the reference's for
the same key, IV, offsets and lengths; a key file written by either
package is read by the other; zone files written by either client are
read by the other byte for byte, over every read path (TCP, short
circuit, hedged, striped), in both KMS URI forms; a replica serves a
checkpoint from a zone with the reference's greedy tokens, and a
``Trainer`` resumes in a zone on its own curve (rtol 1e-6, the
reference's own resume gate).
"""

import base64
import glob
import io
import os
import subprocess
import sys
import urllib.error
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.crypto import keys as jkeys
from hadoop_tpu.crypto import streams as jstreams
from hadoop_tpu.crypto.kms import KMSKeyProvider as JKMSKeyProvider
from hadoop_tpu.crypto.kms import KMSServer
from hadoop_tpu.dfs.client.filesystem import \
    DistributedFileSystem as JDistributedFileSystem
from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.testing.minicluster import MiniDFSCluster, fast_conf
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.crypto import keys, streams
from hadoop_tpu_torch.crypto.kms import KMSKeyProvider
from hadoop_tpu_torch.dfs.client import DistributedFileSystem
from hadoop_tpu_torch.dfs.client.filesystem import KMS_URI_KEY, kms_endpoint
from hadoop_tpu_torch.models import config, decoder, params_from_numpy
from hadoop_tpu_torch.parallel import MeshPlan, Trainer
from hadoop_tpu_torch.parallel.checkpoint import save_checkpoint
from hadoop_tpu_torch.serving import loader

REPO = Path(__file__).resolve().parent.parent


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------- streams

STREAM_CASES = {
    # (key bits, data length, write sizes, read offsets and lengths)
    "aligned": (128, 4096, [1024] * 4, [(0, 16), (16, 4080), (2048, 64)]),
    "unaligned": (128, 10_007, [1, 15, 17, 4096, 333, 5545],
                  [(1, 7), (13, 33), (4095, 2), (9999, 8), (5000, 9999)]),
    "aes256": (256, 3333, [7, 3326], [(3, 1000), (1029, 17)]),
}


@pytest.mark.parametrize("case", sorted(STREAM_CASES))
def test_streams_equal_the_references_bytes(case):
    bits, n, writes, reads = STREAM_CASES[case]
    key, iv, data = _bytes(bits // 8, 1), _bytes(16, 2), _bytes(n, 3)
    # an IV near the counter's wrap exercises the mod 2**128
    wrap_iv = b"\xff" * 15 + b"\xfe"
    for use_iv in (iv, wrap_iv):
        for off in (0, 1, 15, 16, 17, 4097):
            assert streams._crypt(key, use_iv, off, data) == \
                jstreams._crypt(key, use_iv, off, data)
    outs = []
    for mod in (streams, jstreams):
        buf = io.BytesIO()
        out = mod.CryptoOutputStream(buf, key, iv)
        pos = 0
        for w in writes:
            out.write(data[pos:pos + w])
            pos += w
        assert out.tell() == n
        out.flush()
        outs.append(buf.getvalue())
    assert outs[0] == outs[1] != data and len(outs[0]) == n
    blob = outs[0]
    for mod in (streams, jstreams):
        f = mod.CryptoInputStream(io.BytesIO(blob), key, iv)
        for at, length in reads:
            f.seek(at)
            assert f.read(length) == data[at:at + length]
            assert f.tell() == min(n, at + length)
            assert f.pread(at, length) == data[at:at + length]
        f.seek(0)
        assert f.read() == data


def test_package_imports_without_cryptography_and_a_zone_names_it():
    """``import hadoop_tpu_torch.crypto`` works where ``cryptography``
    is missing; building a cipher there raises an ``ImportError`` that
    names the package (no other cipher is tried)."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'cryptography':\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import hadoop_tpu_torch.crypto as c\n"
        "import hadoop_tpu_torch.dfs.client.filesystem\n"
        "try:\n"
        "    c.streams._crypt(b'k' * 16, b'i' * 16, 0, b'x')\n"
        "except ImportError as e:\n"
        "    print('ERR', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "ERR" in out.stdout and "'cryptography'" in out.stdout


# ----------------------------------------------------------- key files

def test_key_files_cross_between_packages(tmp_path):
    """A keystore written by either package's ``FileKeyProvider`` is read
    by the other's, rolled versions and EDEKs included."""
    for writer, reader in ((keys, jkeys), (jkeys, keys)):
        path = str(tmp_path / f"{writer.__name__}.json")
        w = writer.FileKeyProvider(path)
        v0 = w.create_key("zk", 128)
        v1 = w.roll_key("zk")
        w.create_key("other", 256)
        ekv = w.generate_encrypted_key("zk")
        r = reader.FileKeyProvider(path)
        assert r.get_keys() == ["other", "zk"]
        assert r.get_current_key("zk").version == v1.version == "zk@1"
        assert r.get_key_version("zk", "zk@0").material == v0.material
        assert len(r.get_current_key("other").material) == 32
        dek = w.decrypt_encrypted_key(ekv)
        assert r.decrypt_encrypted_key(reader.EncryptedKeyVersion(
            ekv.key_name, ekv.key_version, ekv.iv, ekv.edek)) == dek
        assert oct(os.stat(path).st_mode & 0o777) == "0o600"
        r.delete_key("other")
        assert writer.FileKeyProvider(path).get_keys() == ["zk"]
    with pytest.raises(KeyError):
        keys.FileKeyProvider(str(tmp_path / "none.json")).get_current_key(
            "zk")
    wire = keys.EncryptedKeyVersion("a", "a@0", b"i", b"e").to_wire()
    assert wire == jkeys.EncryptedKeyVersion("a", "a@0", b"i",
                                             b"e").to_wire()


# ------------------------------------------------------------- the KMS

@pytest.fixture(scope="module")
def kms(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("kms")
    conf = JConfiguration(load_defaults=False)
    conf.set("kms.key.provider.path", str(tmp / "keys.json"))
    srv = KMSServer(conf)
    srv.init(conf)
    srv.start()
    yield srv
    srv.stop()


def _clients(port):
    return {"KMSKeyProvider": KMSKeyProvider(f"127.0.0.1:{port}"),
            "KMSClientProvider": keys.make_provider(
                f"kms://http@127.0.0.1:{port}")}


@pytest.mark.parametrize("client", ["KMSKeyProvider", "KMSClientProvider"])
def test_kms_clients_against_the_reference_server(kms, client):
    """Key lifecycle and the EEK pair through each port client; an EDEK
    the port generates is decrypted by the reference's client and the
    other way round."""
    p = _clients(kms.port)[client]
    ref = JKMSKeyProvider(f"127.0.0.1:{kms.port}")
    name = f"life-{client}"
    kv = p.create_key(name, 128)
    assert kv.name == name and len(kv.material) == 16
    assert name in p.get_keys()
    assert p.get_current_key(name).material == kv.material
    rolled = p.roll_key(name)
    assert rolled.version != kv.version
    assert ref.get_current_key(name).material == rolled.material
    ekv = p.generate_encrypted_key(name)
    dek = p.decrypt_encrypted_key(ekv)
    assert len(dek) == 16 and ekv.edek != dek
    assert ref.decrypt_encrypted_key(ekv) == dek
    jekv = ref.generate_encrypted_key(name)
    assert p.decrypt_encrypted_key(jekv) == ref.decrypt_encrypted_key(jekv)
    p.delete_key(name)
    assert name not in ref.get_keys()


def test_kms_acl_refusals_are_permission_errors(tmp_path):
    conf = JConfiguration(load_defaults=False)
    conf.set("kms.key.provider.path", str(tmp_path / "k.json"))
    conf.set("kms.acl.CREATE", "admin")
    conf.set("kms.acl.DECRYPT_EEK", "worker")
    srv = KMSServer(conf)
    srv.init(conf)
    srv.start()
    try:
        admin = KMSKeyProvider(f"127.0.0.1:{srv.port}", user="admin")
        worker = KMSKeyProvider(f"127.0.0.1:{srv.port}", user="worker")
        with pytest.raises(PermissionError):
            worker.create_key("x")
        admin.create_key("x")
        ekv = admin.generate_encrypted_key("x")
        with pytest.raises(PermissionError):
            admin.decrypt_encrypted_key(ekv)
        assert len(worker.decrypt_encrypted_key(ekv)) == 16
        with pytest.raises(IOError, match="KMS 500.*no such key"):
            worker.get_current_key("missing-key")
    finally:
        srv.stop()


@pytest.mark.parametrize("uri,want", [
    ("kms://127.0.0.1:9600", ("127.0.0.1:9600", "/kms")),
    ("kms://127.0.0.1:9600/", ("127.0.0.1:9600", "/kms")),
    ("kms://http@kms.example:9600/kms", ("kms.example:9600", "/kms")),
    ("kms://http@kms.example:9600", ("kms.example:9600", "/kms")),
    ("kms://http@kms.example:9600/ctx/kms", ("kms.example:9600",
                                             "/ctx/kms")),
])
def test_kms_uri_forms(uri, want):
    assert kms_endpoint(uri) == want


@pytest.mark.parametrize("uri", ["kms://https@h:1/kms", "http://h:1/kms",
                                 "kms://http@/kms"])
def test_kms_uri_refusals(uri):
    with pytest.raises(ValueError):
        kms_endpoint(uri)


# ------------------------------------------------------------ the zones

@pytest.fixture(scope="module")
def zone(tmp_path_factory, kms):
    """A reference ``MiniDFSCluster`` (three DataNodes, 256 KiB blocks)
    whose NameNode knows the KMS, with the zone ``/secure`` on key
    ``zone-key`` and its striped subdirectory ``/secure/ec``."""
    JKMSKeyProvider(f"127.0.0.1:{kms.port}").create_key("zone-key", 128)
    conf = fast_conf()
    conf.set(KMS_URI_KEY, f"kms://127.0.0.1:{kms.port}")
    conf.set("dfs.blocksize", str(256 * 1024))
    with MiniDFSCluster(num_datanodes=3, conf=conf,
                        base_dir=str(tmp_path_factory.mktemp("ez"))) as c:
        c.wait_active()
        jfs = c.get_filesystem()
        jfs.mkdirs("/secure")
        jfs.create_encryption_zone("/secure", "zone-key")
        jfs.mkdirs("/secure/ec")
        jfs.client.set_ec_policy("/secure/ec", "XOR-2-1-64k")
        yield c


def _pconf(cluster, kms_uri=None, **overrides):
    conf = Configuration()
    for k, v in cluster.conf.to_dict().items():
        if k != KMS_URI_KEY:
            conf.set(k, v)
    if kms_uri is not None:
        conf.set(KMS_URI_KEY, kms_uri)
    for k, v in overrides.items():
        conf.set(k, v)
    return conf


URI_FORMS = {"reference": "kms://127.0.0.1:{port}",
             "hadoop": "kms://http@127.0.0.1:{port}/kms"}

READ_PATHS = {
    "tcp": {"dfs.client.read.shortcircuit": "false"},
    "short_circuit": {},
    "hedged": {"dfs.client.read.shortcircuit": "false",
               "dfs.client.hedged.read.threadpool.size": "2",
               "dfs.client.hedged.read.threshold": "0.001s"},
    "striped": {},
}


@pytest.mark.parametrize("path_kind", sorted(READ_PATHS))
@pytest.mark.parametrize("form", sorted(URI_FORMS))
def test_zone_files_cross_between_clients(zone, kms, form, path_kind):
    """Files written in the zone by each client are read by the other
    byte for byte, whole, after a seek, and by ``pread`` at unaligned
    offsets; the DataNodes hold ciphertext; the file's EDEK is the
    reference NameNode's."""
    uri = URI_FORMS[form].format(port=kms.port)
    pfs = DistributedFileSystem([zone.nn_addr],
                                _pconf(zone, uri, **READ_PATHS[path_kind]))
    jfs = zone.get_filesystem()
    d = "/secure/ec" if path_kind == "striped" else "/secure"
    stem = f"{d}/{form}-{path_kind}"
    files = {f"{stem}-port.bin": (pfs, _bytes(600 * 1024 + 4321, 11)),
             f"{stem}-ref.bin": (jfs, _bytes(300 * 1024 + 7, 12))}
    try:
        for path, (wfs, data) in files.items():
            with wfs.create(path) as out:
                for at in range(0, len(data), 97_531):
                    out.write(data[at:at + 97_531])
        for path, (_, data) in files.items():
            info = pfs.get_encryption_info(path)
            assert info is not None and info["key"] == "zone-key"
            assert info == jfs.get_encryption_info(path)
            assert jfs.read_all(path) == data
            assert pfs.read_all(path) == data
            with pfs.open(path) as f:
                assert f.length == len(data)
                f.seek(31_337)
                assert f.read(100_003) == data[31_337:131_340]
                assert f.tell() == 131_340
                for at, n in ((1, 15), (65_535, 3), (262_141, 70_000),
                              (len(data) - 9, 9)):
                    assert f.pread(at, n) == data[at:at + n]
                if path_kind == "short_circuit":
                    assert f.inner._short_circuit_ok
                if path_kind == "hedged":
                    assert f.inner._hedged_enabled
        if path_kind == "striped":
            assert pfs.get_ec_policy(d) == "XOR-2-1-64k"
        raw = b""
        for blk in glob.glob(os.path.join(zone.base_dir, "data*", "**",
                                          "blk_*"), recursive=True):
            if not blk.endswith(".meta"):
                with open(blk, "rb") as fh:
                    raw += fh.read()
        for _, data in files.values():
            assert data[1000:1064] not in raw
    finally:
        pfs.close()


def test_client_without_kms_gets_permission_error(zone):
    """A port client with no KMS sees the zone's metadata but opens and
    creates no file in it; outside the zone it reads and writes plain."""
    jfs = zone.get_filesystem()
    jfs.write_all("/secure/blind.txt", b"attack at dawn")
    blind = DistributedFileSystem([zone.nn_addr], _pconf(zone))
    try:
        assert blind.get_file_status("/secure/blind.txt").length == 14
        with pytest.raises(PermissionError, match="no KMS"):
            blind.open("/secure/blind.txt")
        with pytest.raises(PermissionError, match="no KMS"):
            blind.create("/secure/new.txt")
        assert not blind.exists("/secure/new.txt")
        blind.write_all("/plain.txt", b"not secret")
        assert jfs.read_all("/plain.txt") == b"not secret"
        assert blind.list_encryption_zones() == \
            jfs.list_encryption_zones()
    finally:
        blind.close()


def test_reference_client_cannot_dial_the_hadoop_uri_form(zone, kms):
    """Queue C 17: the reference's client reads everything after
    ``kms://`` as ``host:port``, so Hadoop's form fails to dial; the
    port reads it (``test_zone_files_cross_between_clients[hadoop-*]``)
    and both read the reference's bare form."""
    jfs = zone.get_filesystem()
    jfs.write_all("/secure/c17.txt", b"c17 bytes")
    jconf = JConfiguration(other=zone.conf)
    jconf.set(KMS_URI_KEY, URI_FORMS["hadoop"].format(port=kms.port))
    ref = JDistributedFileSystem([zone.nn_addr], jconf)
    try:
        with pytest.raises(urllib.error.URLError):
            ref.read_all("/secure/c17.txt")
    finally:
        ref.close()
    pfs = DistributedFileSystem([zone.nn_addr], _pconf(
        zone, URI_FORMS["hadoop"].format(port=kms.port)))
    try:
        assert pfs.read_all("/secure/c17.txt") == b"c17 bytes"
    finally:
        pfs.close()


# ---------------------------------------- a replica and a trainer in a zone

_model = {}


def _tiny():
    if not _model:
        jcfg = jconfig.get_config("tiny")
        jparams = jdecoder.init_params(jax.random.PRNGKey(0), jcfg)
        cfg = config.get_config("tiny")
        params = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
        _model.update(jcfg=jcfg, jparams=jparams, cfg=cfg, params=params)
    return _model


def _reference_greedy(prompt, max_new):
    import jax.numpy as jnp
    m = _tiny()
    fwd = jax.jit(lambda p, t: jdecoder.forward(p, t, m["jcfg"]))
    seq = list(prompt)
    for _ in range(max_new):
        padded = seq + [0] * (48 - len(seq))
        logits = fwd(m["jparams"], jnp.asarray([padded]))
        seq.append(int(jnp.argmax(logits[0, len(seq) - 1])))
    return seq[len(prompt):]


def test_replica_serves_a_checkpoint_from_a_zone(zone, kms):
    """The port writes the tiny checkpoint into the zone; the reference's
    client sees ciphertext-backed files it decrypts to the same leaves;
    ``load_serving_params`` through the zone gives the reference's first
    logits; ``replica_main`` on the command line (Hadoop's URI form)
    decodes the reference's greedy tokens and drains to exit 0."""
    import json
    import signal
    from hadoop_tpu.parallel import checkpoint as jckpt
    m = _tiny()
    uri = URI_FORMS["hadoop"].format(port=kms.port)
    pfs = DistributedFileSystem([zone.nn_addr], _pconf(zone, uri))
    try:
        save_checkpoint(pfs, "/secure/models/tiny", 2,
                        {"params": m["params"]})
        manifest = "/secure/models/tiny/step_000000000002/manifest.json"
        assert pfs.get_encryption_info(manifest) is not None
        back, step = jckpt.load_checkpoint(
            zone.get_filesystem(), "/secure/models/tiny",
            {"params": m["jparams"]})
        assert step == 2
        for a, b in zip(jax.tree_util.tree_leaves(back["params"]),
                        jax.tree_util.tree_leaves(m["jparams"])):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        params, step = loader.load_serving_params(
            pfs, "/secure/models/tiny", m["cfg"], device="cpu")
        tokens = np.random.default_rng(1).integers(0, m["cfg"].vocab_size,
                                                   (2, 16))
        got = decoder.forward(params, tokens, m["cfg"],
                              device="cpu").numpy()
        want = np.asarray(jdecoder.forward(m["jparams"], tokens, m["jcfg"]))
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    finally:
        pfs.close()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.Popen(
        [sys.executable, "-m", "hadoop_tpu_torch.serving.service",
         "--checkpoint", f"{zone.default_fs}/secure/models/tiny",
         "--preset", "tiny", "--device", "cpu",
         "-D", "serving.kv.block.size=4", "-D", "serving.max.context=48",
         "-D", f"{KMS_URI_KEY}={uri}"],
        cwd=REPO, env=env, stderr=subprocess.PIPE, text=True)
    try:
        port = None
        for _ in range(400):
            line = proc.stderr.readline()
            assert line, "the replica exited before serving"
            if " up on :" in line:
                port = int(line.split(" up on :")[1].split()[0])
                break
        assert port is not None
        import http.client
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/v1/generate?user.name=alice",
                     body=json.dumps({"tokens": [5, 9, 2, 7],
                                      "max_new_tokens": 6}).encode(),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        out = json.loads(resp.read())
        conn.close()
        assert resp.status == 200, out
        assert out["tokens"] == _reference_greedy([5, 9, 2, 7], 6)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
        proc.stderr.close()
    assert rc == 0


def test_trainer_in_a_zone_resumes_on_its_curve(zone, kms):
    """A port ``Trainer`` reads its tokens (``seek`` + ``read`` on the
    crypto stream) and writes its checkpoints inside the zone; a fresh
    ``Trainer`` restores and continues the uninterrupted curve within
    rtol 1e-6, and the token file is ciphertext for a client without
    the KMS."""
    uri = URI_FORMS["reference"].format(port=kms.port)
    pfs = DistributedFileSystem([zone.nn_addr], _pconf(zone, uri))
    try:
        toks = np.random.default_rng(0).integers(0, 256, 60_000,
                                                 dtype=np.uint16)
        pfs.write_all("/secure/data/tokens.bin", toks.tobytes())
        assert pfs.read_all("/secure/data/tokens.bin") == toks.tobytes()

        def trainer(ckpt_dir):
            return Trainer(config.get_config("tiny"), MeshPlan(), pfs,
                           "/secure/data/tokens.bin", ckpt_dir, batch=4,
                           lr=1e-2, device="cpu", ckpt_interval=0)

        whole = trainer("/secure/ckpt-whole")
        curve = whole.train(4)
        whole.close()
        first = trainer("/secure/ckpt-resume")
        np.testing.assert_allclose(first.train(2), curve[:2], rtol=1e-6)
        first.save()
        first.close()
        info = pfs.get_encryption_info(
            "/secure/ckpt-resume/step_000000000002/manifest.json")
        assert info is not None and base64.b64decode(info["edek"])
        again = trainer("/secure/ckpt-resume")
        assert again.try_restore() and again.step == 2
        np.testing.assert_allclose(again.train(2), curve[2:], rtol=1e-6)
        again.close()
    finally:
        pfs.close()
