"""Retry policies and failover proxy providers.

The port's copy of ``hadoop_tpu/ipc/retry.py``: a policy decides FAIL,
RETRY or FAILOVER_AND_RETRY for each exception, knowing whether the
method is idempotent; :class:`RetryInvocationHandler` wraps a
:class:`StaticFailoverProxyProvider` and does the sleeps and the
failovers.
The DFS client's NameNode proxy is built on these
(``failover_on_network_exception`` over the NameNode addresses); the
reference's other policies have no caller in the port. The jitter
comes from the RPC layer's ``RETRY_RNG``.
"""

from __future__ import annotations

import logging
import time
from typing import Callable, List, Sequence, Tuple

from hadoop_tpu_torch.ipc.errors import (ConnectFailedError, RetriableError,
                                         RpcError, RpcTimeoutError,
                                         ServerTooBusyError, StandbyError,
                                         is_remote)
from hadoop_tpu_torch.ipc.rpc import RETRY_RNG

log = logging.getLogger(__name__)


class RetryAction:
    FAIL = "fail"
    RETRY = "retry"
    FAILOVER_AND_RETRY = "failover"

    def __init__(self, action: str, delay_s: float = 0.0, reason: str = ""):
        self.action = action
        self.delay_s = delay_s
        self.reason = reason


class RetryPolicy:
    def should_retry(self, e: BaseException, retries: int, failovers: int,
                     idempotent: bool) -> RetryAction:
        raise NotImplementedError


class _TryOnceThenFail(RetryPolicy):
    def should_retry(self, e, retries, failovers, idempotent):
        return RetryAction(RetryAction.FAIL, reason="try once")


class FailoverOnNetworkExceptionRetry(RetryPolicy):
    """The HA clients' policy: a standby answer fails over; a connection
    that never opened fails over whatever the method (nothing was
    sent); a busy or retriable server is retried with backoff; a broken
    connection fails over an idempotent method and fails any other; a
    remote application error goes to the fallback (fail, by default)."""

    def __init__(self, fallback: RetryPolicy = None, max_failovers: int = 15,
                 max_retries: int = 10, delay_s: float = 0.5,
                 max_delay_s: float = 15.0):
        self.fallback = fallback or _TryOnceThenFail()
        self.max_failovers = max_failovers
        self.max_retries = max_retries
        self.delay_s = delay_s
        self.max_delay_s = max_delay_s

    def _failover_delay(self, failovers: int) -> float:
        if failovers == 0:
            return 0.0
        return min(self.max_delay_s, self.delay_s * (2 ** failovers)
                   * (0.5 + RETRY_RNG.random()))

    def should_retry(self, e, retries, failovers, idempotent):
        if failovers >= self.max_failovers:
            return RetryAction(
                RetryAction.FAIL,
                reason=f"exceeded {self.max_failovers} failovers")
        if retries >= self.max_retries:
            return RetryAction(RetryAction.FAIL,
                               reason=f"exceeded {self.max_retries} retries")
        if isinstance(e, StandbyError):
            return RetryAction(RetryAction.FAILOVER_AND_RETRY,
                               self._failover_delay(failovers))
        if isinstance(e, ConnectFailedError):
            return RetryAction(RetryAction.FAILOVER_AND_RETRY,
                               self._failover_delay(failovers))
        if isinstance(e, (ServerTooBusyError, RetriableError)):
            return RetryAction(RetryAction.RETRY,
                               self._failover_delay(retries + 1))
        if is_remote(e):
            # deterministic: retrying or failing over only adds latency
            return self.fallback.should_retry(e, retries, failovers,
                                              idempotent)
        if isinstance(e, (RpcError, ConnectionError, OSError)) and \
                not isinstance(e, RpcTimeoutError):
            if idempotent:
                return RetryAction(RetryAction.FAILOVER_AND_RETRY,
                                   self._failover_delay(failovers))
            return RetryAction(RetryAction.FAIL,
                               reason="non-idempotent op on broken "
                                      "connection")
        if isinstance(e, RpcTimeoutError) and idempotent:
            return RetryAction(RetryAction.RETRY, self.delay_s)
        return self.fallback.should_retry(e, retries, failovers, idempotent)


class RetryPolicies:
    TRY_ONCE_THEN_FAIL: RetryPolicy = _TryOnceThenFail()

    @staticmethod
    def failover_on_network_exception(max_failovers: int = 15,
                                      max_retries: int = 10,
                                      delay_s: float = 0.5) -> RetryPolicy:
        return FailoverOnNetworkExceptionRetry(
            max_failovers=max_failovers, max_retries=max_retries,
            delay_s=delay_s)


class StaticFailoverProxyProvider:
    """Yields a proxy to the current address; ``perform_failover`` moves
    round robin to the next one."""

    def __init__(self, proxy_factory: Callable[[Tuple[str, int]], object],
                 addresses: Sequence[Tuple[str, int]]):
        if not addresses:
            raise ValueError("no addresses")
        self._factory = proxy_factory
        self._addresses: List[Tuple[str, int]] = list(addresses)
        self._idx = 0
        self._proxy = None

    @property
    def current_address(self) -> Tuple[str, int]:
        return self._addresses[self._idx]

    def get_proxy(self):
        if self._proxy is None:
            self._proxy = self._factory(self._addresses[self._idx])
        return self._proxy

    def perform_failover(self, current) -> None:
        self._idx = (self._idx + 1) % len(self._addresses)
        self._proxy = None
        log.info("Failing over to %s", self._addresses[self._idx])


class RetryInvocationHandler:
    """Calls through the provider's proxy and lets the policy decide
    what follows a failure. Idempotency comes from the proxy's
    ``_is_idempotent(method)`` (the port's ``RpcProxy`` has it), unless
    ``idempotent`` (a method name -> bool callable) is given; the retry
    count reaches the wire through the proxy's ``_set_retry_count``."""

    def __init__(self, provider: StaticFailoverProxyProvider,
                 policy: RetryPolicy,
                 idempotent: Callable[[str], bool] = None):
        self.provider = provider
        self.policy = policy
        self._idempotent = idempotent

    def invoke(self, method_name: str, *args, **kwargs):
        retries = 0
        failovers = 0
        while True:
            proxy = self.provider.get_proxy()
            if self._idempotent is not None:
                idem = bool(self._idempotent(method_name))
            else:
                idem = bool(getattr(proxy, "_is_idempotent",
                                    lambda m: False)(method_name))
            try:
                set_rc = getattr(proxy, "_set_retry_count", None)
                if set_rc:
                    set_rc(retries)
                return getattr(proxy, method_name)(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — the policy decides
                action = self.policy.should_retry(e, retries, failovers,
                                                  idem)
                if action.action == RetryAction.FAIL:
                    raise
                if action.delay_s > 0:
                    time.sleep(action.delay_s)
                if action.action == RetryAction.FAILOVER_AND_RETRY:
                    self.provider.perform_failover(proxy)
                    failovers += 1
                retries += 1
                log.debug("Retrying %s (retries=%d failovers=%d) after %s",
                          method_name, retries, failovers, type(e).__name__)

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return lambda *a, **kw: self.invoke(name, *a, **kw)
