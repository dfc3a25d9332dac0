"""The service lifecycle the port's daemons ride.

The port's copy of ``hadoop_tpu/service/service.py``: NOTINITED ->
INITED -> STARTED -> STOPPED over a checked transition table, an
idempotent ``stop()`` legal from any state, the first failure kept
(``failure_cause``) and the service stopped on it, lifecycle listeners,
and composite services whose children init and start in the order they
were added and stop in reverse. Subclasses override ``service_init``,
``service_start`` and ``service_stop``; the public ``init``/``start``/
``stop`` do the state checks. The registry server and the fleet doctor
are such services, and the command line's ``_run_daemon`` drives them.
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from typing import Callable, List, Optional

from hadoop_tpu_torch.conf import ConfLike

log = logging.getLogger(__name__)


class ServiceState(enum.IntEnum):
    NOTINITED = 0
    INITED = 1
    STARTED = 2
    STOPPED = 3


# the legal transitions; stop() is legal from any state
_VALID = {
    ServiceState.NOTINITED: {ServiceState.INITED, ServiceState.STOPPED},
    ServiceState.INITED: {ServiceState.STARTED, ServiceState.STOPPED},
    ServiceState.STARTED: {ServiceState.STOPPED},
    ServiceState.STOPPED: {ServiceState.STOPPED},
}


class ServiceStateException(RuntimeError):
    pass


class LifecycleEvent:
    def __init__(self, state: ServiceState):
        self.state = state
        self.time = time.time()


class Service:
    """The interface; :class:`AbstractService` implements it."""

    def init(self, conf: ConfLike) -> None: ...
    def start(self) -> None: ...
    def stop(self) -> None: ...

    @property
    def state(self) -> ServiceState: ...

    @property
    def name(self) -> str: ...


class AbstractService(Service):
    """State checks and failure capture around the ``service_*`` hooks."""

    def __init__(self, name: Optional[str] = None):
        self._name = name or type(self).__name__
        self._state = ServiceState.NOTINITED
        self._state_lock = threading.RLock()
        self._conf: Optional[ConfLike] = None
        self._failure: Optional[BaseException] = None
        self._failure_state: Optional[ServiceState] = None
        self._listeners: List[Callable[["AbstractService",
                                        ServiceState], None]] = []
        self._lifecycle_history: List[LifecycleEvent] = []
        self._start_time = 0.0

    @property
    def name(self) -> str:
        return self._name

    @property
    def state(self) -> ServiceState:
        return self._state

    @property
    def config(self) -> Optional[ConfLike]:
        return self._conf

    @property
    def failure_cause(self) -> Optional[BaseException]:
        return self._failure

    def is_in_state(self, s: ServiceState) -> bool:
        return self._state == s

    def _enter(self, new_state: ServiceState) -> bool:
        """False when already in ``new_state`` (a no-op re-entry)."""
        with self._state_lock:
            if self._state == new_state:
                return False
            if new_state not in _VALID[self._state]:
                raise ServiceStateException(
                    f"{self._name}: cannot enter {new_state.name} from "
                    f"{self._state.name}")
            self._state = new_state
            self._lifecycle_history.append(LifecycleEvent(new_state))
            return True

    def init(self, conf: ConfLike) -> None:
        if self._state == ServiceState.INITED:
            return
        self._conf = conf
        if not self._enter(ServiceState.INITED):
            return
        try:
            self.service_init(conf)
        except BaseException as e:
            self._note_failure(e)
            self.stop()
            raise
        self._notify(ServiceState.INITED)

    def start(self) -> None:
        if self._state == ServiceState.STARTED:
            return
        if not self._enter(ServiceState.STARTED):
            return
        self._start_time = time.time()
        try:
            self.service_start()
        except BaseException as e:
            self._note_failure(e)
            self.stop()
            raise
        log.debug("Service %s started", self._name)
        self._notify(ServiceState.STARTED)

    def stop(self) -> None:
        with self._state_lock:
            if self._state == ServiceState.STOPPED:
                return
            self._state = ServiceState.STOPPED
            self._lifecycle_history.append(
                LifecycleEvent(ServiceState.STOPPED))
        try:
            self.service_stop()
        except BaseException as e:
            self._note_failure(e)
            raise
        finally:
            self._notify(ServiceState.STOPPED)

    def close(self) -> None:
        self.stop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()
        return False

    def _note_failure(self, e: BaseException) -> None:
        if self._failure is None:
            self._failure = e
            self._failure_state = self._state
        log.error("Service %s failed in state %s: %s", self._name,
                  self._state.name, e)

    def register_listener(self, cb: Callable[["AbstractService",
                                              ServiceState], None]) -> None:
        self._listeners.append(cb)

    def _notify(self, state: ServiceState) -> None:
        for cb in list(self._listeners):
            try:
                cb(self, state)
            except Exception:  # noqa: BLE001 — a listener's failure is
                # its own; the lifecycle goes on
                log.exception("Listener failure on %s", self._name)

    def service_init(self, conf: ConfLike) -> None:
        pass

    def service_start(self) -> None:
        pass

    def service_stop(self) -> None:
        pass

    def __repr__(self) -> str:
        return f"{self._name}[{self._state.name}]"


class CompositeService(AbstractService):
    """Children init and start in add order and stop in reverse; the
    first child error on stop is raised after every child stopped."""

    def __init__(self, name: Optional[str] = None):
        super().__init__(name)
        self._services: List[Service] = []

    def add_service(self, svc: Service) -> Service:
        self._services.append(svc)
        return svc

    def add_if_service(self, obj) -> bool:
        if isinstance(obj, Service):
            self.add_service(obj)
            return True
        return False

    def get_services(self) -> List[Service]:
        return list(self._services)

    def service_init(self, conf: ConfLike) -> None:
        for s in list(self._services):
            s.init(conf)

    def service_start(self) -> None:
        for s in list(self._services):
            s.start()

    def service_stop(self) -> None:
        first_error: Optional[BaseException] = None
        for s in reversed(list(self._services)):
            try:
                s.stop()
            except BaseException as e:
                log.exception("Error stopping child %s",
                              getattr(s, "name", s))
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error
