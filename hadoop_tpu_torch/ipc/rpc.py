"""Proxies: client-side stubs whose method calls are RPC round trips.

The port's copy of ``hadoop_tpu/ipc/rpc.py``. A protocol is a name, or a
class whose name is the wire protocol name and whose ``@idempotent``
methods may be sent again after a failure that could have followed a
partial send. ``RpcProxy`` retries a call up to ``MAX_RETRIES`` times,
with ``backoff_delay`` between tries, when:

- the connection never opened (``ConnectFailedError``: nothing was
  sent), whatever the method;
- the server was too busy or said to retry (``ServerTooBusyError``,
  ``RetriableError``), whatever the method;
- the transport failed or timed out after the send, for an idempotent
  method only.

A remote application error is raised at once. The call's ``rc`` field
carries the retry count, as the reference's retry layer sends it.
``max_retries=0`` turns these retries off for a proxy that a
``retry.RetryInvocationHandler`` drives (the DFS client's NameNode
proxy): that handler then sets the count through ``_set_retry_count``.
"""

from __future__ import annotations

import random
import time
from typing import Optional, Tuple, Type

from hadoop_tpu_torch.conf import ConfLike
from hadoop_tpu_torch.ipc.client import Client, default_client
from hadoop_tpu_torch.ipc.errors import (ConnectFailedError, RetriableError,
                                         RpcError, ServerTooBusyError,
                                         is_remote)
from hadoop_tpu_torch.security.ugi import UserGroupInformation

MAX_RETRIES = 3
RETRY_BASE_S = 0.1
RETRY_MAX_S = 2.0

RETRY_RNG = random.Random()


def backoff_delay(base_s: float, attempt: int, max_s: float = 30.0,
                  rng=None) -> float:
    """Exponential backoff with jitter: ``base_s * 2**attempt``, capped at
    ``max_s``, times a factor in [0.5, 1.5), so clients never retry in
    lockstep (the reference's ``util/misc.py`` ``backoff_delay``)."""
    rng = RETRY_RNG if rng is None else rng
    return min(max_s, base_s * (2 ** attempt)) * (0.5 + rng.random())


def idempotent(fn):
    """Mark a protocol method safe to send again after a possible partial
    send."""
    fn._rpc_idempotent = True
    return fn


def _retryable(e: BaseException, idempotent_call: bool) -> bool:
    if isinstance(e, (ConnectFailedError, ServerTooBusyError,
                      RetriableError)):
        return True
    return idempotent_call and isinstance(e, RpcError) and not is_remote(e)


class RpcProxy:
    """Stub for one (address, protocol): attribute access yields calls."""

    def __init__(self, protocol_name: str, protocol_class: Optional[Type],
                 address: Tuple[str, int], client: Client,
                 timeout: Optional[float] = None,
                 user: Optional[UserGroupInformation] = None,
                 max_retries: int = MAX_RETRIES):
        self._protocol = protocol_name
        self._protocol_class = protocol_class
        self._address = address
        self._client = client
        self._timeout = timeout
        self._user = user
        self._max_retries = max_retries
        self._retry_count = 0

    def _is_idempotent(self, method_name: str) -> bool:
        fn = getattr(self._protocol_class, method_name, None)
        return bool(getattr(fn, "_rpc_idempotent", False))

    def _set_retry_count(self, n: int) -> None:
        self._retry_count = n

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        idem = self._is_idempotent(name)

        def invoke(*args, **kwargs):
            for attempt in range(self._max_retries + 1):
                try:
                    return self._client.call(
                        self._address, self._protocol, name, args, kwargs,
                        timeout=self._timeout,
                        retry_count=self._retry_count + attempt,
                        user=self._user)
                except (RpcError, RetriableError) as e:
                    if attempt == self._max_retries or \
                            not _retryable(e, idem):
                        raise
                time.sleep(backoff_delay(RETRY_BASE_S, attempt,
                                         max_s=RETRY_MAX_S))

        invoke.__name__ = name
        # cached on the instance: __getattr__ fires only on a miss
        object.__setattr__(self, name, invoke)
        return invoke


def get_proxy(protocol, address: Tuple[str, int],
              conf: Optional[ConfLike] = None,
              client: Optional[Client] = None,
              timeout: Optional[float] = None,
              user: Optional[UserGroupInformation] = None,
              max_retries: int = MAX_RETRIES) -> RpcProxy:
    """A stub for ``protocol`` (a name, or a class whose name is used and
    whose ``@idempotent`` methods may be retried) at ``address``, on
    ``client`` or the process's shared one. ``conf`` is accepted for the
    reference's signature."""
    if isinstance(protocol, type):
        cls: Optional[Type] = protocol
        name = protocol.__name__
    else:
        cls, name = None, protocol
    return RpcProxy(name, cls, address, client or default_client(),
                    timeout=timeout, user=user, max_retries=max_retries)


def wait_for_proxy(protocol, address: Tuple[str, int],
                   conf: Optional[ConfLike] = None,
                   timeout_s: float = 30.0,
                   probe_method: str = "get_service_status") -> RpcProxy:
    """Keep connecting until the server at ``address`` answers."""
    deadline = time.monotonic() + timeout_s
    last: Optional[BaseException] = None
    attempt = 0
    while time.monotonic() < deadline:
        proxy = get_proxy(protocol, address, conf)
        try:
            getattr(proxy, probe_method)()
            return proxy
        except (RpcError, OSError) as e:
            if is_remote(e):
                return proxy     # up, but the probe method is unknown
            last = e
            time.sleep(backoff_delay(0.2, attempt, max_s=2.0))
            attempt += 1
        except Exception:  # noqa: BLE001 — a remote error of another
            # class: the server is up
            return proxy
    raise RpcError(f"server at {address} not reachable in {timeout_s}s: "
                   f"{last}")


def stop_proxy(proxy: RpcProxy) -> None:
    """Connections are shared and closed by ``Client.stop()``."""
