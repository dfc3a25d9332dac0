"""NameNode audit log, failure edge — the RPC-facade auditor.

The port's copy of ``hadoop_tpu/dfs/namenode/audit.py``, on the same
wire and disk formats.

The audit plane is ``hadoop_tpu_torch.audit`` (fsnamesystem.py): success
lines are emitted by the namespace op call sites themselves
(``log_audit_event`` — ugi/ip/cmd/src/dst/callerContext/status/
trace_id, tab-separated k=v, dynamometer-replayable, rotated with
whatever handlers the deployment attached). What those call sites can
never see is the FAILED edge: an op that raised logs nothing, so the
auditor asking "who hammered the namespace with doomed deletes all
night" has no evidence.

This module closes that edge at the RPC seam: a transparent facade
over ``ClientProtocol`` that lets every successful call pass silently
(its fsn call site already logged) and emits exactly one
``status=failed(ExceptionType)`` line — same logger, same format, cmd
named by the RPC method — when the call raises. ``allowed=false`` for
permission denials, the one failure class an auditor reads differently
(ref: FSNamesystem.logAuditEvent's unsuccessful-op calls).

Everything rides the one conf toggle ``namenode.audit.enable``
(default on, like the seed's always-on success lines); off disables
the whole plane and skips installing the facade.
"""

from __future__ import annotations

ENABLE_KEY = "namenode.audit.enable"

# methods whose first (or mapped) string args are the audited paths
_TWO_PATH = {"rename": (0, 1), "rename_snapshot": (0, 2),
             "concat": (0, 1)}
# chatty bookkeeping RPCs whose failures are retry noise, not audit
# signal (lease renewals fire every ~30 s per client)
_SKIP = {"renew_lease", "msync", "get_service_status"}


def _path_args(method: str, args: tuple) -> tuple:
    si, di = _TWO_PATH.get(method, (0, None))
    src = args[si] if len(args) > si and isinstance(args[si], str) \
        else None
    dst = None
    if di is not None and len(args) > di and isinstance(args[di], str):
        dst = args[di]
    return src, dst


class AuditedClientProtocol:
    """Failure-auditing facade: same RPC surface (the server resolves
    methods with ``getattr``, which ``__getattr__`` satisfies), one
    audit line per raising call."""

    def __init__(self, inner):
        self._inner = inner

    def __getattr__(self, name: str):
        fn = getattr(self._inner, name)
        if name.startswith("_") or not callable(fn):
            return fn

        def audited(*args, **kwargs):
            try:
                return fn(*args, **kwargs)
            except BaseException as e:
                _emit_failure(name, args, e)
                raise

        audited.__name__ = name
        # preserve decorator markers (@idempotent) client retry
        # policies introspect
        audited.__dict__.update(getattr(fn, "__dict__", {}))
        # cache so getattr-per-call doesn't rebuild the wrapper
        object.__setattr__(self, name, audited)
        return audited


def _emit_failure(method: str, args: tuple,
                  error: BaseException) -> None:
    if method in _SKIP:
        return
    from hadoop_tpu_torch.dfs.namenode.fsnamesystem import log_audit_event
    src, dst = _path_args(method, args)
    allowed = not isinstance(error, PermissionError)
    log_audit_event(allowed, method, src if src is not None else "null",
                    dst, status=f"failed({type(error).__name__})")


def maybe_audited(proto, conf):
    """Wrap ``proto`` unless ``namenode.audit.enable`` is off."""
    if conf.get_bool(ENABLE_KEY, True):
        return AuditedClientProtocol(proto)
    return proto


# re-exported for callers configuring the plane directly
def audit_enabled(conf) -> bool:
    return conf.get_bool(ENABLE_KEY, True)
