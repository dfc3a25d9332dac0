"""The RPC exception model of the port's client.

The port's copy of ``hadoop_tpu/ipc/errors.py``. A server's exception
crosses the wire as (class name, message); the client raises it again as
the class registered under that name, else a builtin exception of that
name, else :class:`RemoteError`.

The framework's own errors (standby, retriable, too busy, access
control) are registered under their bare class names as well: a
reference server names them by its own module path
(``<package>.ipc.errors.StandbyError``), and :func:`resolve_exception`
tries the last dotted component when the full name is not registered,
so they come back as the port's classes.
"""

from __future__ import annotations

import builtins
from typing import Dict, Optional, Type

from hadoop_tpu_torch.security.ugi import AccessControlError


class RpcError(IOError):
    """Base of the transport's failures (connection refused, reset, ...)."""


class RpcTimeoutError(RpcError):
    pass


class ConnectFailedError(RpcError):
    """Connection set-up failed: the request was never sent, so a retry is
    safe even for a method that is not idempotent."""


class ServerTooBusyError(RpcError):
    """The server's call queue is full: back off and retry."""


class FatalRpcError(RpcError):
    """The server failed the connection (bad header, auth failure)."""


class RemoteError(IOError):
    """An exception of the remote handler with no local class."""

    def __init__(self, class_name: str, message: str):
        super().__init__(f"{class_name}: {message}")
        self.class_name = class_name
        self.remote_message = message


class StandbyError(IOError):
    """The operation reached a standby node."""


class RetriableError(IOError):
    """A transient server condition: retry on the same node."""


_registry: Dict[str, Type[BaseException]] = {}


def register_exception(cls: Type[BaseException],
                       name: Optional[str] = None) -> Type[BaseException]:
    """Register an exception class for reconstruction from the wire (a
    decorator too). The wire name is the qualified dotted name unless
    ``name`` gives another."""
    _registry[name or f"{cls.__module__}.{cls.__qualname__}"] = cls
    return cls


def wire_name(e: BaseException) -> str:
    cls = type(e)
    name = f"{cls.__module__}.{cls.__qualname__}"
    if name not in _registry and cls.__module__ == "builtins":
        return cls.__qualname__
    return name


def is_remote(e: BaseException) -> bool:
    """True when a remote handler raised ``e`` (not the transport): retry
    policies must not take a remote ``OSError`` for a network failure."""
    return bool(getattr(e, "_rpc_remote", False))


def resolve_exception(class_name: str, message: str) -> BaseException:
    cls = _registry.get(class_name) or \
        _registry.get(class_name.rsplit(".", 1)[-1])
    if cls is None and "." not in class_name:
        cls = getattr(builtins, class_name, None)
        if not (isinstance(cls, type) and issubclass(cls, BaseException)):
            cls = None
    if cls is None:
        e: BaseException = RemoteError(class_name, message)
    else:
        try:
            e = cls(message)
        except Exception:  # noqa: BLE001 — a class whose constructor
            # takes other arguments still reaches the caller
            e = RemoteError(class_name, message)
    try:
        e._rpc_remote = True
    except AttributeError:
        pass
    return e


for _cls in (StandbyError, RetriableError, ServerTooBusyError,
             AccessControlError):
    register_exception(_cls)
    register_exception(_cls, _cls.__name__)
