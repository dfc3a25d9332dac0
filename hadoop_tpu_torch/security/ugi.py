"""The caller's identity on an RPC connection.

A minimal copy of ``hadoop_tpu/security/ugi.py``: what the port's RPC
client puts in a connection header (the effective user, the real user
under impersonation, the auth method). The login user is the process's
OS user; ``do_as`` runs a callable as another user, whom
:func:`current_user` then returns, as in the reference. Only SIMPLE
authentication: delegation tokens and SASL are not ported (ROADMAP
Queue A 9 part 2).
"""

from __future__ import annotations

import contextvars
import getpass
import threading
from typing import Optional

_current: contextvars.ContextVar[Optional["UserGroupInformation"]] = \
    contextvars.ContextVar("htpu_torch_current_ugi", default=None)


class UserGroupInformation:
    AUTH_SIMPLE = "SIMPLE"

    _login_user: Optional["UserGroupInformation"] = None
    _lock = threading.Lock()

    def __init__(self, user_name: str,
                 real_user: Optional["UserGroupInformation"] = None):
        self.user_name = user_name
        self.real_user = real_user
        self.auth_method = self.AUTH_SIMPLE

    @classmethod
    def get_login_user(cls) -> "UserGroupInformation":
        with cls._lock:
            if cls._login_user is None:
                cls._login_user = cls(getpass.getuser())
            return cls._login_user

    @classmethod
    def create_remote_user(cls, name: str) -> "UserGroupInformation":
        return cls(name)

    @classmethod
    def create_proxy_user(cls, name: str, real: "UserGroupInformation"
                          ) -> "UserGroupInformation":
        return cls(name, real_user=real)

    def do_as(self, fn, *args, **kwargs):
        """Run ``fn`` with this user as the current caller."""
        token = _current.set(self)
        try:
            return fn(*args, **kwargs)
        finally:
            _current.reset(token)


def current_user() -> UserGroupInformation:
    ugi = _current.get()
    return ugi if ugi is not None else UserGroupInformation.get_login_user()
