"""WebHDFS: the REST face of the DFS.

The port's copy of ``hadoop_tpu/dfs/webhdfs.py``, on the same wire and
disk formats.

Parity with the reference's WebHDFS (ref: hadoop-hdfs
namenode/web/resources/NamenodeWebHdfsMethods.java:124, client
hadoop-hdfs-client web/WebHdfsFileSystem.java, spec
src/site/markdown/WebHDFS.md): `/webhdfs/v1/<path>?op=...` with the
standard operations and JSON response shapes. Rides the daemon's admin
HttpServer; data for OPEN/CREATE is streamed through the NameNode's
embedded DFS client (the reference redirects to a DataNode HTTP port —
here the bulk plane stays DataTransferProtocol and HTTP is a
convenience/interop face, so proxying keeps DataNodes HTTP-free).

GET  op=GETFILESTATUS | LISTSTATUS | GETCONTENTSUMMARY | OPEN |
     GETXATTRS | GETACLSTATUS | GETSTORAGEPOLICY | GETECPOLICY
PUT  op=MKDIRS | RENAME | CREATE | SETPERMISSION | SETOWNER |
     SETREPLICATION | CREATESNAPSHOT | SETXATTR | SETSTORAGEPOLICY
POST op=APPEND (unsupported), CONCAT, TRUNCATE
DELETE op=DELETE | DELETESNAPSHOT
"""

from __future__ import annotations

import logging
from typing import Dict, Tuple

log = logging.getLogger(__name__)

PREFIX = "/webhdfs/v1"


def iter_as_caller(it):
    """Re-enter the CURRENT caller's UGI around every step of a lazy
    stream: the HTTP server consumes response generators after the
    handler's do_as scope has been reset, so without this an OPEN body
    would read blocks as the daemon's own (super)user — bypassing the
    permission check the handler just enforced.

    Plain function wrapping an inner generator ON PURPOSE: a generator
    function's body (including the current_user() capture) would not
    run until the first next() — after do_as reset the contextvar —
    and would capture the daemon's login user instead of the caller's.
    """
    from hadoop_tpu_torch.security.ugi import current_user
    ugi = current_user()  # evaluated NOW, inside the handler's do_as

    def run():
        while True:
            try:
                chunk = ugi.do_as(next, it)
            except StopIteration:
                return
            yield chunk
    return run()


def _status_json(st: Dict) -> Dict:
    """FileStatus wire dict → WebHDFS FileStatus JSON shape."""
    return {
        "pathSuffix": st["p"].rsplit("/", 1)[-1],
        "type": "DIRECTORY" if st["d"] else "FILE",
        "length": st.get("len", 0),
        "owner": st.get("o", ""),
        "group": st.get("g", ""),
        "permission": oct(st.get("perm", 0o644))[2:],
        "replication": st.get("rep", 0),
        "blockSize": st.get("bs", 0),
        "modificationTime": int(st.get("mt", 0) * 1000),
        "accessTime": int(st.get("at", 0) * 1000),
        "ecPolicy": st.get("ec", ""),
    }


class WebHdfsHandler:
    """Registered on the NameNode's HttpServer under /webhdfs/v1."""

    def __init__(self, namenode):
        self.nn_daemon = namenode
        self._client = None

    def _dfs(self):
        """Lazy loopback DFS client for OPEN/CREATE streaming."""
        if self._client is None:
            from hadoop_tpu_torch.dfs.client.dfsclient import DFSClient
            self._client = DFSClient(("127.0.0.1", self.nn_daemon.port),
                                     self.nn_daemon.config)
        return self._client

    def close(self) -> None:
        if self._client is not None:
            self._client.close()

    def __call__(self, query: Dict, body: bytes) -> Tuple[int, object]:
        # Execute AS the remote caller (ref: NamenodeWebHdfsMethods'
        # ugi.doAs around every op) — without this, every REST request
        # ran as the NameNode process user and bypassed permission
        # enforcement.
        from hadoop_tpu_torch.security.http_auth import ugi_for_query
        return ugi_for_query(query).do_as(self._handle, query, body)

    def _handle(self, query: Dict, body: bytes) -> Tuple[int, object]:
        full = query["__path__"]
        path = full[len(PREFIX):] or "/"
        method = query["__method__"]
        op = query.get("op", "").upper()
        fsn = self.nn_daemon.fsn
        # HA gate, mirroring the RPC plane: mutations need the active;
        # reads are fine on active or observer.
        state = self.nn_daemon.ha_state
        if method != "GET" and state != "active":
            return 403, {"RemoteException": {
                "exception": "StandbyException",
                "message": f"mutations not allowed in state {state}"}}
        if method == "GET" and state not in ("active", "observer"):
            return 403, {"RemoteException": {
                "exception": "StandbyException",
                "message": "reads not served by a standby"}}

        if method == "GET":
            if op == "GETFILESTATUS":
                info = fsn.get_file_info(path)
                if info is None:
                    raise FileNotFoundError(path)
                return 200, {"FileStatus": _status_json(info)}
            if op == "LISTSTATUS":
                return 200, {"FileStatuses": {"FileStatus": [
                    _status_json(d) for d in fsn.listing(path)]}}
            if op == "GETCONTENTSUMMARY":
                cs = fsn.content_summary(path)
                return 200, {"ContentSummary": {
                    "directoryCount": cs["dirs"], "fileCount": cs["files"],
                    "length": cs["length"]}}
            if op == "OPEN":
                offset = int(query.get("offset", 0))
                length = int(query.get("length", -1))
                # authorize EAGERLY, while still inside the handler's
                # do_as and before the 200 status line goes out — the
                # streamed body runs too late to turn a denial into an
                # error response
                from hadoop_tpu_torch.dfs.namenode.permissions import READ
                fsn.check_access(path, target=READ)

                def stream(path=path, offset=offset, length=length):
                    # chunked: the daemon never holds the whole file
                    with self._dfs().open(path) as f:
                        if offset:
                            f.seek(offset)
                        left = length if length >= 0 else None
                        while left is None or left > 0:
                            want = 1 << 20 if left is None \
                                else min(1 << 20, left)
                            data = f.read(want)
                            if not data:
                                break
                            if left is not None:
                                left -= len(data)
                            yield data
                return 200, iter_as_caller(stream())
            if op == "GETXATTRS":
                attrs = fsn.get_xattrs(path)
                return 200, {"XAttrs": [
                    {"name": k, "value": v.decode("utf-8", "replace")}
                    for k, v in sorted(attrs.items())]}
            if op == "GETACLSTATUS":
                return 200, {"AclStatus": {"entries": fsn.get_acl(path)}}
            if op == "GETSTORAGEPOLICY":
                return 200, {"BlockStoragePolicy": {
                    "name": fsn.get_storage_policy(path)}}
            if op == "GETECPOLICY":
                return 200, {"ECPolicy": {"name": fsn.get_ec_policy(path)}}

        elif method == "PUT":
            if op == "MKDIRS":
                return 200, {"boolean": fsn.mkdirs(path)}
            if op == "RENAME":
                return 200, {"boolean": fsn.rename(
                    path, query["destination"])}
            if op == "CREATE":
                overwrite = query.get("overwrite", "false") == "true"
                with self._dfs().create(path, overwrite=overwrite) as f:
                    if isinstance(body, (bytes, bytearray)):
                        f.write(body)
                    else:  # large upload: bounded reader, chunked copy
                        while True:
                            chunk = body.read(1 << 20)
                            if not chunk:
                                break
                            f.write(chunk)
                return 201, {"boolean": True}
            if op == "SETPERMISSION":
                fsn.set_permission(path, int(query["permission"], 8))
                return 200, {}
            if op == "SETOWNER":
                fsn.set_owner(path, query.get("owner", ""),
                              query.get("group", ""))
                return 200, {}
            if op == "SETREPLICATION":
                return 200, {"boolean": fsn.set_replication(
                    path, int(query["replication"]))}
            if op == "CREATESNAPSHOT":
                return 200, {"Path": fsn.create_snapshot(
                    path, query.get("snapshotname", "s0"))}
            if op == "SETXATTR":
                fsn.set_xattr(path, query["xattr.name"],
                              query.get("xattr.value", "").encode())
                return 200, {}
            if op == "SETSTORAGEPOLICY":
                fsn.set_storage_policy(path, query["storagepolicy"])
                return 200, {}

        elif method == "POST":
            if op == "CONCAT":
                fsn.concat(path, query["sources"].split(","))
                return 200, {}
            if op == "TRUNCATE":
                return 200, {"boolean": fsn.truncate(
                    path, int(query["newlength"]))}

        elif method == "DELETE":
            if op == "DELETE":
                recursive = query.get("recursive", "false") == "true"
                return 200, {"boolean": fsn.delete(path, recursive)}
            if op == "DELETESNAPSHOT":
                fsn.delete_snapshot(path, query["snapshotname"])
                return 200, {}

        return 400, {"RemoteException": {
            "exception": "UnsupportedOperationException",
            "message": f"op {op!r} for {method} is not supported"}}
