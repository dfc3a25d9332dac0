"""The port's SASL RPC and secured DFS client against the JAX package's
``ipc.Server``, ``MiniKdc`` and secured ``MiniDFSCluster``.

Mirrors ``tests/test_security.py``: SASL RPC at QoP authentication,
integrity and privacy, with no plaintext on a privacy channel, a wrong
password rejected, TOKEN authentication with a delegation token (SASL
and the simple header); block tokens gating the TCP data plane and the
short-circuit fd grants, also on a striped file; encrypted data
transfer; the fully secured cluster (SASL privacy RPC, keytab login,
encrypted transfer) read and written by the port, with the reference's
client reading the same bytes. ``cryptography`` blocked from import
still lets the port's DFS client and SASL module import, and a privacy
QoP then fails naming the package. Every comparison is exact.
"""

import getpass
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.dfs.protocol.blocktoken import BlockTokenSecretManager
from hadoop_tpu.ipc import Server
from hadoop_tpu.security.ugi import SecretManager
from hadoop_tpu.testing.minicluster import MiniDFSCluster, fast_conf
from hadoop_tpu.testing.minikdc import MiniKdc
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.dfs.client import DistributedFileSystem, shortcircuit
from hadoop_tpu_torch.dfs.protocol import datatransfer as dt
from hadoop_tpu_torch.dfs.protocol.records import Block, DatanodeInfo
from hadoop_tpu_torch.ipc import Client
from hadoop_tpu_torch.ipc.errors import FatalRpcError
from hadoop_tpu_torch.security import sasl
from hadoop_tpu_torch.security.ugi import (AccessControlError, Token,
                                           UserGroupInformation)

REPO = Path(__file__).resolve().parents[1]
DT_KIND = "HTPU_DELEGATION_TOKEN"


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


@pytest.fixture(autouse=True)
def _keep_login_user():
    """``login_from_keytab`` makes its principal the process's login
    user, as in the reference: put the OS user back after each test."""
    before = UserGroupInformation._login_user
    yield
    UserGroupInformation._login_user = before


class _Echo:
    def echo(self, x):
        return x

    def whoami(self):
        from hadoop_tpu.security.ugi import current_user
        u = current_user()
        return {"user": u.user_name, "auth": u.auth_method}


@pytest.fixture(scope="module")
def kdc(tmp_path_factory):
    k = MiniKdc(str(tmp_path_factory.mktemp("kdc")))
    k.create_principal("alice", b"alice-pw")
    return k


@pytest.fixture(scope="module", params=["authentication", "integrity",
                                        "privacy"])
def sasl_server(request, kdc, tmp_path_factory):
    """A reference server that requires SASL at one QoP, with the KDC's
    keytab and a delegation-token secret manager."""
    conf = JConfiguration(load_defaults=False)
    conf.set("hadoop.security.authentication", "sasl")
    conf.set("hadoop.rpc.protection", request.param)
    conf.set("hadoop.security.server.keytab", kdc.create_keytab(
        str(tmp_path_factory.mktemp("srv") / "server.keytab")))
    srv = Server(conf, num_handlers=2, name=f"sasl-{request.param}",
                 secret_manager=SecretManager(DT_KIND))
    srv.register_protocol("Echo", _Echo())
    srv.start()
    srv.qop = request.param
    yield srv
    srv.stop()


def _client(qop, **kw):
    conf = Configuration()
    conf.set("hadoop.security.authentication", "sasl")
    conf.set("hadoop.rpc.protection", qop)
    return Client(conf, **kw)


def test_sasl_rpc_at_each_qop(sasl_server, kdc):
    ugi = UserGroupInformation.login_from_keytab("alice",
                                                 kdc.keytab_for("alice"))
    assert UserGroupInformation.get_login_user() is ugi
    client = _client(sasl_server.qop)
    addr = ("127.0.0.1", sasl_server.port)
    try:
        payload = {"n": 42, "blob": b"\x00\x01" * 512}
        assert client.call(addr, "Echo", "echo", (payload,),
                           user=ugi) == payload
        assert client.call(addr, "Echo", "whoami", user=ugi) == \
            {"user": "alice", "auth": UserGroupInformation.AUTH_KERBEROS}
        conn = next(iter(client._conns.values()))
        assert (conn.cipher is None) == (sasl_server.qop == "authentication")
        # the same authenticated connection serves the next call
        assert client.call(addr, "Echo", "echo", (7,), user=ugi) == 7
        assert len(client._conns) == 1
    finally:
        client.stop()


def test_client_keytab_conf_authenticates(sasl_server, kdc, tmp_path):
    """No keytab login: ``hadoop.security.client.keytab`` gives the
    principal's password."""
    client = _client(sasl_server.qop)
    client.conf.set("hadoop.security.client.keytab",
                    kdc.create_keytab(str(tmp_path / "c.keytab"), "alice"))
    try:
        who = client.call(("127.0.0.1", sasl_server.port), "Echo", "whoami",
                          user=UserGroupInformation.create_remote_user(
                              "alice"))
        assert who["user"] == "alice"
    finally:
        client.stop()


def test_wrong_password_is_rejected(sasl_server):
    ugi = UserGroupInformation.create_remote_user("alice")
    ugi.sasl_password = b"not-the-password"
    client = _client(sasl_server.qop)
    try:
        with pytest.raises((FatalRpcError, AccessControlError),
                           match="auth"):
            client.call(("127.0.0.1", sasl_server.port), "Echo", "echo",
                        (1,), user=ugi)
    finally:
        client.stop()
    nobody = UserGroupInformation.create_remote_user("nobody")
    client = _client(sasl_server.qop)
    try:
        with pytest.raises(FatalRpcError, match="no credentials"):
            client.call(("127.0.0.1", sasl_server.port), "Echo", "echo",
                        (1,), user=nobody)
    finally:
        client.stop()


def test_delegation_token_authenticates_over_sasl(sasl_server):
    """TOKEN: only the identifier is sent; the server recomputes the
    password from its master key and the caller is the token's owner."""
    jtoken = sasl_server.secret_manager.create_token("bob")
    bob = UserGroupInformation.create_remote_user("bob")
    bob.add_token(Token.from_wire(jtoken.to_wire()))
    assert bob.tokens[DT_KIND].identifier_fields()["owner"] == "bob"
    client = _client(sasl_server.qop, token_kind=DT_KIND)
    try:
        assert client.call(("127.0.0.1", sasl_server.port), "Echo",
                           "whoami", user=bob) == \
            {"user": "bob", "auth": UserGroupInformation.AUTH_TOKEN}
    finally:
        client.stop()
    # a token signed by another manager is refused
    forged = SecretManager(DT_KIND).create_token("bob")
    eve = UserGroupInformation.create_remote_user("bob")
    eve.add_token(Token.from_wire(forged.to_wire()))
    client = _client(sasl_server.qop, token_kind=DT_KIND)
    try:
        with pytest.raises((FatalRpcError, AccessControlError)):
            client.call(("127.0.0.1", sasl_server.port), "Echo", "echo",
                        (1,), user=eve)
    finally:
        client.stop()


def test_delegation_token_in_the_simple_header():
    sm = SecretManager(DT_KIND)
    srv = Server(JConfiguration(load_defaults=False), num_handlers=2,
                 name="token-simple", secret_manager=sm)
    srv.register_protocol("Echo", _Echo())
    srv.start()
    carol = UserGroupInformation.create_remote_user("carol")
    carol.add_token(Token.from_wire(sm.create_token("carol").to_wire()))
    client = Client(Configuration(), token_kind=DT_KIND)
    try:
        assert client.call(("127.0.0.1", srv.port), "Echo", "whoami",
                           user=carol) == \
            {"user": "carol", "auth": UserGroupInformation.AUTH_TOKEN}
    finally:
        client.stop()
        srv.stop()


def test_privacy_puts_no_plaintext_on_the_wire(kdc, tmp_path, monkeypatch):
    """Every byte either side reads under privacy: a marker sent in a
    request and echoed back never appears."""
    conf = JConfiguration(load_defaults=False)
    conf.set("hadoop.security.authentication", "sasl")
    conf.set("hadoop.rpc.protection", "privacy")
    conf.set("hadoop.security.server.keytab",
             kdc.create_keytab(str(tmp_path / "s.keytab")))
    srv = Server(conf, num_handlers=2, name="sasl-sniff")
    srv.register_protocol("Echo", _Echo())
    srv.start()
    ugi = UserGroupInformation.login_from_keytab("alice",
                                                 kdc.keytab_for("alice"))
    client = _client("privacy")
    marker = b"TOP-SECRET-MARKER-0123456789"
    captured = []
    recv, recv_into = socket.socket.recv, socket.socket.recv_into

    def sniff_recv(sock, *a, **kw):
        data = recv(sock, *a, **kw)
        captured.append(bytes(data))
        return data

    def sniff_recv_into(sock, buf, *a, **kw):
        n = recv_into(sock, buf, *a, **kw)
        captured.append(bytes(memoryview(buf)[:n]))
        return n

    try:
        monkeypatch.setattr(socket.socket, "recv", sniff_recv)
        monkeypatch.setattr(socket.socket, "recv_into", sniff_recv_into)
        assert client.call(("127.0.0.1", srv.port), "Echo", "echo",
                           (marker,), user=ugi) == marker
    finally:
        monkeypatch.undo()
        client.stop()
        srv.stop()
    joined = b"".join(captured)
    assert joined and marker not in joined


def test_sasl_and_dfs_client_import_without_cryptography():
    """With ``cryptography`` blocked from import, the DFS client and the
    SASL module import and authenticate at QoP authentication; privacy
    fails naming the package."""
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'cryptography' or "
        "name.startswith('cryptography.'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import hadoop_tpu_torch.dfs.client, hadoop_tpu_torch.security.sasl\n"
        "import hadoop_tpu_torch.dfs.protocol.datatransfer\n"
        "import hadoop_tpu_torch.ipc.retry\n"
        "from hadoop_tpu_torch.security import sasl\n"
        "s = sasl.SaslClientSession(sasl.MECH_SCRAM, user='a', "
        "password=b'p')\n"
        "assert s.initiate()['qop'] == 'authentication'\n"
        "try:\n"
        "    sasl.SaslClientSession(sasl.MECH_SCRAM, user='a', "
        "password=b'p', qop='privacy')\n"
        "except PermissionError as e:\n"
        "    assert 'cryptography' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('privacy without cryptography was accepted')\n"
        "bad = [m for m in sys.modules if m.startswith('cryptography') "
        "or m == 'jax' or m == 'hadoop_tpu' or "
        "m.startswith('hadoop_tpu.')]\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


# ----------------------------------------------------------- block tokens

def _port_fs(cluster, **overrides):
    conf = Configuration()
    for k, v in cluster.conf.to_dict().items():
        conf.set(k, v)
    for k, v in overrides.items():
        conf.set(k, v)
    return DistributedFileSystem([cluster.nn_addr], conf)


@pytest.fixture(scope="module")
def token_cluster(tmp_path_factory):
    conf = fast_conf()
    conf.set("dfs.block.access.token.enable", "true")
    with MiniDFSCluster(num_datanodes=5, conf=conf,
                        base_dir=str(tmp_path_factory.mktemp("tok"))) as c:
        c.wait_active()
        yield c


def test_block_tokens_gate_the_tcp_data_plane(token_cluster):
    c = token_cluster
    pfs = _port_fs(c, **{"dfs.client.read.shortcircuit": "false"})
    try:
        payload = _bytes(300_000, 1)
        pfs.write_all("/tok/tcp.bin", payload)      # write tokens too
        assert pfs.read_all("/tok/tcp.bin") == payload
        assert c.get_filesystem().read_all("/tok/tcp.bin") == payload
        blk = pfs.client.get_block_locations("/tok/tcp.bin")["blocks"][0]
        assert blk.get("tok") is not None
        dn = DatanodeInfo.from_wire(blk["locs"][0])
        with pytest.raises(IOError, match="token"):
            dt.read_block_range(dn.xfer_addr(), blk["b"], 0, 1024)
        assert dt.read_block_range(dn.xfer_addr(), blk["b"], 0, 1024,
                                   token=blk["tok"]) == payload[:1024]
    finally:
        pfs.close()


def test_block_tokens_gate_short_circuit_grants(token_cluster):
    c = token_cluster
    pfs = _port_fs(c)
    try:
        payload = _bytes(300_000, 2)
        pfs.write_all("/tok/sc.bin", payload)
        cache = shortcircuit.ShortCircuitCache.get()
        hits0 = cache.hits
        assert pfs.read_all("/tok/sc.bin") == payload
        assert cache.hits > hits0                     # the tokened grant
        locs = pfs.client.get_block_locations("/tok/sc.bin")["blocks"][0]
        blk = Block.from_wire(locs["b"])
        holder = locs["locs"][0]["u"]
        dn = next(d for d in c.datanodes if d.uuid == holder)
        path = dn.domain_server.path
        with pytest.raises(shortcircuit.ShortCircuitUnavailable,
                           match="token"):
            cache._request_fds(path, blk, None)
        forged = BlockTokenSecretManager().generate_token("mallory",
                                                          blk.block_id)
        with pytest.raises(shortcircuit.ShortCircuitUnavailable,
                           match="key|signature|token"):
            cache._request_fds(path, blk, forged)
        other = Block(blk.block_id + 999, blk.gen_stamp, 1)
        with pytest.raises(shortcircuit.ShortCircuitUnavailable,
                           match="block"):
            cache._request_fds(path, other, locs["tok"])
    finally:
        pfs.close()


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_block_tokens_with_erasure_coding(token_cluster, writer):
    """A striped group's token reads every unit; the file crosses both
    ways."""
    c = token_cluster
    pfs = _port_fs(c, **{"dfs.client.read.shortcircuit": "false"})
    jfs = c.get_filesystem()
    try:
        pfs.mkdirs("/tok/ec")
        pfs.set_ec_policy("/tok/ec", "RS-3-2-64k")
        payload = _bytes(500_000, 3)
        (pfs if writer == "port" else jfs).write_all(
            f"/tok/ec/{writer}.bin", payload)
        assert pfs.read_all(f"/tok/ec/{writer}.bin") == payload
        assert jfs.read_all(f"/tok/ec/{writer}.bin") == payload
    finally:
        pfs.close()


# ----------------------------------------------- encryption, full security

@pytest.fixture(scope="module")
def secure_cluster(tmp_path_factory):
    """SASL privacy on every RPC, a keytab per side, block tokens and
    encrypted data transfer."""
    base = tmp_path_factory.mktemp("secure")
    kdc = MiniKdc(str(base / "kdc"))
    me = getpass.getuser()
    kdc.create_principal(me)
    conf = fast_conf()
    conf.set("dfs.replication", "2")
    conf.set("hadoop.security.authentication", "sasl")
    conf.set("hadoop.rpc.protection", "privacy")
    conf.set("hadoop.security.server.keytab",
             kdc.create_keytab(str(base / "server.keytab")))
    conf.set("hadoop.security.client.keytab",
             kdc.create_keytab(str(base / "client.keytab"), me))
    conf.set("dfs.block.access.token.enable", "true")
    conf.set("dfs.encrypt.data.transfer", "true")
    with MiniDFSCluster(num_datanodes=2, conf=conf,
                        base_dir=str(base / "dfs")) as c:
        c.wait_active()
        yield c


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_secured_cluster_cross_read_with_encrypted_transfer(secure_cluster,
                                                            writer):
    c = secure_cluster
    pfs = _port_fs(c, **{"dfs.client.read.shortcircuit": "false"})
    jfs = c.get_filesystem()
    try:
        assert isinstance(dt.default_security(), dt.TransferSecurity)
        payload = _bytes(300_000, 4)
        path = f"/secure/{writer}.bin"
        (pfs if writer == "port" else jfs).write_all(path, payload)
        assert pfs.read_all(path) == payload
        assert jfs.read_all(path) == payload
        assert pfs.get_file_status(path).length == len(payload)
        with pfs.open(path) as f:
            assert f.pread(1000, 64) == payload[1000:1064]
        # the data sockets are wrapped, the RPC connection is private
        conn = next(iter(pfs.client._rpc_client._conns.values()))
        assert isinstance(conn.cipher, sasl.WireCipher)
        blk = pfs.client.get_block_locations(path)["blocks"][0]
        dn = DatanodeInfo.from_wire(blk["locs"][0])
        sock = dt.connect(dn.xfer_addr(), timeout=5.0)
        try:
            assert isinstance(sock, sasl.CipherSocket)
        finally:
            sock.close()
    finally:
        pfs.close()
    assert dt.default_security() is None


def test_encrypted_transfer_refuses_a_plaintext_peer(secure_cluster):
    c = secure_cluster
    pfs = _port_fs(c)
    try:
        pfs.write_all("/secure/plain.bin", _bytes(4096, 5))
        blk = pfs.client.get_block_locations("/secure/plain.bin")[
            "blocks"][0]
        dn = DatanodeInfo.from_wire(blk["locs"][0])
        sock = dt.connect(dn.xfer_addr(), timeout=5.0,
                          security=_NoSecurity())
        try:
            dt.send_frame(sock, {"op": dt.OP_READ_BLOCK, "b": blk["b"],
                                 "offset": 0, "length": 4096,
                                 "tok": blk["tok"]})
            reply = dt.recv_frame(sock)
            assert not reply.get("ok")
            assert "protection is required" in reply.get("em", "")
        finally:
            sock.close()
    finally:
        pfs.close()


class _NoSecurity:
    """A dial security that leaves the socket plaintext."""

    def dial(self, sock):
        return sock
