"""Impersonation (proxy-user) authorization for the port's RPC server.

The port's copy of ``hadoop_tpu/security/proxyusers.py``. A connection
whose proven (real) user acts as another (effective) user passes
:meth:`ProxyUsers.authorize` against ``hadoop.proxyuser.<real>.users``,
``.groups`` and ``.hosts`` (comma lists, ``*`` for any): the effective
user or one of its groups must be allowed, and so must the client's
address. A real user with no such keys may impersonate no one; an unset
``hosts`` allows no host.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional

from hadoop_tpu_torch.security.ugi import (AccessControlError,
                                           UserGroupInformation)


def _split(val: Optional[str]) -> Optional[set]:
    if val is None:
        return None
    return {v.strip() for v in val.split(",") if v.strip()}


class ProxyUsers:
    PREFIX = "hadoop.proxyuser."

    def __init__(self, conf=None):
        self._lock = threading.Lock()
        self._acl: Dict[str, Dict[str, Optional[set]]] = {}
        if conf is not None:
            self.refresh(conf)

    def refresh(self, conf) -> None:
        """Read the ACL from ``conf`` (a ``ConfLike``) again."""
        acl: Dict[str, Dict[str, Optional[set]]] = {}
        for key, val in conf.to_dict().items():
            if not key.startswith(self.PREFIX):
                continue
            rest = key[len(self.PREFIX):]
            if "." not in rest:
                continue
            real, attr = rest.rsplit(".", 1)
            if attr not in ("users", "groups", "hosts"):
                continue
            acl.setdefault(real, {})[attr] = _split(val)
        with self._lock:
            self._acl = acl

    @staticmethod
    def _matches(allowed: Optional[set], candidates: Iterable[str]) -> bool:
        if allowed is None:
            return False
        if "*" in allowed:
            return True
        return any(c in allowed for c in candidates)

    def authorize(self, effective: UserGroupInformation,
                  remote_addr: Optional[str] = None) -> None:
        """``AccessControlError`` unless ``effective.real_user`` may act
        as ``effective`` from ``remote_addr``; no proxy chain passes."""
        real = effective.real_user
        if real is None or real.user_name == effective.user_name:
            return
        with self._lock:
            entry = self._acl.get(real.user_name)
        if not entry:
            raise AccessControlError(
                f"user {real.user_name} is not configured as a proxy user "
                f"(no hadoop.proxyuser.{real.user_name}.* ACL)")
        user_ok = self._matches(entry.get("users"), [effective.user_name])
        group_ok = self._matches(entry.get("groups"), effective.groups)
        if not (user_ok or group_ok):
            raise AccessControlError(
                f"user {real.user_name} is not allowed to impersonate "
                f"{effective.user_name}")
        hosts = entry.get("hosts")
        if hosts is None or ("*" not in hosts and
                             (remote_addr is None or
                              remote_addr not in hosts)):
            raise AccessControlError(
                f"proxying by {real.user_name} not allowed from host "
                f"{remote_addr}")
