"""Multi-process RPC server: SO_REUSEPORT workers past the GIL ceiling.

The port's copy of ``hadoop_tpu/ipc/mpserver.py``: each worker runs the
port's ``ipc.Server`` with ``ipc.server.reuseport`` on.

The reference's server scales with handler THREADS inside one JVM
(ref: ipc/Server.java:2897 Handler pool + :1247 Reader scaling) — a
CPython server is GIL-bound no matter how many handler threads it
spawns, so one busy process caps around ~18K calls/s on this host.
This module scales the way CPython can: N worker PROCESSES each run a
complete ``ipc.Server`` bound to the SAME port with ``SO_REUSEPORT``;
the kernel hashes incoming connections across the listeners, so the
handler pool effectively multiplies by the worker count with zero
coordination on the hot path.

State model: the protocol factory runs IN EACH WORKER, so a protocol
served this way must be stateless, share state through an external
substrate (DFS, a database, the owning daemon over loopback RPC), or
shard its namespace so any worker can serve any call. That is the same
contract the reference's HA/observer reads already obey — mutating
singleton daemons (the NN) keep the threaded server; fan-out read
planes (observer reads, shuffle-style serving, gateways) use this one.

Fork-safety: workers are forked before the caller initializes CUDA
(a forked child cannot use its parent's CUDA context); each worker
re-executes the factory, so sockets/threads of the parent's protocol
objects are never inherited mid-life.
"""

from __future__ import annotations

import logging
import multiprocessing as mp
import importlib
import signal
import socket
import time
from typing import Callable, Dict, Optional, Tuple

from hadoop_tpu_torch.conf import Configuration

log = logging.getLogger(__name__)


def load_factory(ref: str) -> Callable:
    """The callable a ``module:name`` reference names (``name`` may be
    dotted)."""
    mod, _, name = ref.partition(":")
    obj = importlib.import_module(mod)
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _worker_main(conf_dict: Dict[str, str], bind: Tuple[str, int],
                 factory_path: str, num_handlers: int, num_readers: int,
                 name: str, ready, idx: int) -> None:
    """Child entry: build protocols via the factory, serve forever."""
    from hadoop_tpu_torch.ipc.server import Server

    conf = Configuration(load_defaults=False)
    for k, v in conf_dict.items():
        conf.set(k, v)
    conf.set("ipc.server.reuseport", "true")
    srv = Server(conf, bind=bind, num_handlers=num_handlers,
                 num_readers=num_readers, name=f"{name}-w{idx}")
    factory = load_factory(factory_path)
    for proto_name, impl in factory(conf).items():
        srv.register_protocol(proto_name, impl)
    srv.start()
    ready.send(srv.port)
    ready.close()
    try:
        signal.pause()
    except KeyboardInterrupt:
        pass
    finally:
        srv.stop()


class MultiProcessServer:
    """N SO_REUSEPORT worker processes serving one RPC port.

    ``factory`` is the dotted path of a callable ``(conf) -> {protocol
    name: impl}`` — a PATH, not an object, because each worker builds
    its own impls after fork (no pickling of live state).
    """

    def __init__(self, conf: Optional[Configuration] = None,
                 factory: str = "", num_workers: int = 4,
                 num_handlers: int = 4,
                 bind: Tuple[str, int] = ("127.0.0.1", 0),
                 name: str = "mprpc"):
        self.conf = conf or Configuration(load_defaults=False)
        self.factory = factory
        self.num_workers = max(1, num_workers)
        self.num_handlers = num_handlers
        self.name = name
        self.port = 0
        self._bind = bind
        self._procs: list = []

    def start(self) -> None:
        host, port = self._bind
        probe = None
        if port == 0:
            # reserve an ephemeral port with REUSEPORT so every worker
            # can bind it; the probe socket never listens and closes as
            # soon as the workers are up
            probe = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            probe.bind((host, 0))
            port = probe.getsockname()[1]
        self.port = port

        ctx = mp.get_context("fork")
        conf_dict = dict(self.conf.to_dict())
        pipes = []
        for i in range(self.num_workers):
            r, w = ctx.Pipe(duplex=False)
            p = ctx.Process(
                target=_worker_main,
                args=(conf_dict, (host, port), self.factory,
                      self.num_handlers, 1, self.name, w, i),
                daemon=True)
            p.start()
            w.close()
            pipes.append(r)
            self._procs.append(p)
        deadline = time.monotonic() + 30.0
        for r in pipes:
            if not r.poll(max(0.1, deadline - time.monotonic())):
                self.stop()
                raise IOError("mp rpc worker failed to start")
            try:
                got = r.recv()
            except EOFError:
                # worker died before reporting (factory import error,
                # bind failure) — its pipe EOF reads as "readable"
                self.stop()
                raise IOError("mp rpc worker died during startup "
                              "(see worker stderr)") from None
            if got != port:
                self.stop()
                raise IOError(f"worker bound {got}, wanted {port}")
            r.close()
        if probe is not None:
            probe.close()  # only the workers' listeners remain
        log.info("MultiProcessServer %s on :%d (%d workers x %d handlers)",
                 self.name, port, self.num_workers, self.num_handlers)

    def stop(self) -> None:
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(timeout=5.0)
        self._procs = []

    def alive_workers(self) -> int:
        return sum(1 for p in self._procs if p.is_alive())
