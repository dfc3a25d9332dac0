"""The serving replica as a deployable unit, and its command line.

    python -m hadoop_tpu_torch.serving.service --checkpoint DIR \\
        --preset flagship-1b [--port N] [--host H] [--name SVC] \\
        [--device cpu] [-D key=value ...]

The counterpart of ``hadoop_tpu/serving/service.py``'s ``ServingReplica``
and ``replica_main``: load the newest checkpoint under ``--checkpoint``
(``serving/loader.py``), build the engine (its two step shapes are CUDA
graphs on the card) with the QoS fair admission queue in front of it
(``serving.qos.enabled``, on by default), put the door
(``serving/server.py``) in front of that, optionally publish a record in
a service registry and refresh it, and on SIGTERM or SIGINT (or
``POST /v1/admin/drain``) drain: refuse new work, finish what is in
flight, unregister, exit 0. ``-D key=value`` sets a conf key (the door's
``serving.http.auth.secret``, the engine sizes ``serving.max.batch``,
``serving.kv.block.size``, ``serving.kv.num.blocks``,
``serving.max.context``, ``serving.prefill.chunk``, ...).

The device is the card unless ``--device`` names another (``cpu`` for
tests); without a CUDA device and without ``--device`` it raises.

A ``file://`` URI or a bare path opens the port's ``LocalFileSystem``;
any other scheme needs a ``FileSystemLike`` passed in as ``fs=`` by an
in-process caller (the port carries no DFS client), and the command line
exits 2 for one. ``registry=`` takes any ``RegistryLike`` (``hadoop_tpu``'s
``RegistryClient`` fits); ``--registry HOST:PORT`` needs an RPC client the
port does not have and exits 2. Features the port has not ported are
refused with ``NotImplementedError`` naming their ROADMAP item (the
command line exits 2), never ignored: ``serving.parity=relaxed`` and
``serving.kv.hbm.bytes`` (Queue A 4), ``serving.speculate.k``,
``serving.kv.host.bytes``, ``serving.kv.dfs.enable`` and a prefill or
decode ``serving.role`` (A 3), ``serving.longctx.enabled`` (A 7) and a
MoE preset (A 5). The YARN packaging (``serving_service_spec``,
``autoscaler_service_spec``) is Queue A 9.
"""

from __future__ import annotations

import logging
import signal
import socket
import sys
import threading
import time
import uuid
from typing import List, Optional, Tuple
from urllib.parse import urlparse

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.device import resolve_device
from hadoop_tpu_torch.fs import FileSystemLike, LocalFileSystem
from hadoop_tpu_torch.models.config import get_config
from hadoop_tpu_torch.registry import (HEARTBEAT_ATTR, RegistryLike,
                                       ServiceRecord, record_ttl,
                                       replica_path)
from hadoop_tpu_torch.serving.engine import DecodeEngine
from hadoop_tpu_torch.serving.loader import (IO_WORKERS_KEY,
                                             load_serving_params,
                                             serving_read_defaults)
from hadoop_tpu_torch.serving.metrics import ServingMetrics
from hadoop_tpu_torch.serving.qos import (DecayCostScheduler,
                                          FairAdmissionQueue, QoSGate)
from hadoop_tpu_torch.serving.server import ServingServer

log = logging.getLogger(__name__)


def _refuse(what: str, item: str) -> None:
    raise NotImplementedError(f"{what} is not ported to hadoop_tpu_torch "
                              f"yet (ROADMAP Queue A {item})")


def refuse_unported(conf: ConfLike, cfg) -> None:
    """Raise ``NotImplementedError`` for every conf key (or preset) that
    asks for a serving feature the port does not have."""
    if conf.get("serving.parity", "bitwise") != "bitwise":
        _refuse("serving.parity=relaxed (the int8 weight plane)", "4")
    if conf.get_int("serving.kv.hbm.bytes", 0):
        _refuse("serving.kv.hbm.bytes (HBM-budget sizing)", "4")
    if conf.get_int("serving.speculate.k", 0):
        _refuse("serving.speculate.k (speculative decoding)", "3")
    if conf.get_int("serving.kv.host.bytes", 0):
        _refuse("serving.kv.host.bytes (the host-RAM KV tier)", "3")
    role = conf.get("serving.role", "mixed")
    if role not in ("prefill", "decode", "mixed"):
        raise ValueError(f"serving.role must be prefill/decode/mixed, "
                         f"got {role!r}")
    if role != "mixed":
        _refuse(f"serving.role={role} (prefill/decode disaggregation)", "3")
    if conf.get_bool("serving.kv.dfs.enable", False):
        _refuse("serving.kv.dfs.enable (the DFS KV tier)", "3")
    if conf.get_bool("serving.longctx.enabled", False):
        _refuse("serving.longctx.enabled (the long-context plane)", "7")
    if cfg.is_moe:
        _refuse("a MoE preset (expert-parallel serving)", "5")


def checkpoint_location(checkpoint: str, fs: Optional[FileSystemLike]
                        ) -> Tuple[FileSystemLike, str]:
    """(filesystem, directory) of a checkpoint URI: a ``file://`` URI or
    bare path on ``fs`` or the local disk; another scheme only on the
    ``fs`` the caller passes."""
    parsed = urlparse(checkpoint)
    if parsed.scheme in ("", "file"):
        return fs or LocalFileSystem(), parsed.path
    if fs is None:
        _refuse(f"opening {parsed.scheme}:// checkpoints from the command "
                f"line (the port carries no DFS client: an in-process "
                f"caller passes its filesystem as fs=)", "9")
    return fs, parsed.path


class ServingReplica:
    """Engine + HTTP door + registry record, wired for one process."""

    def __init__(self, conf: ConfLike, *, name: str, checkpoint: str,
                 preset: str, registry: Optional[RegistryLike] = None,
                 bind: Tuple[str, int] = ("127.0.0.1", 0),
                 instance: Optional[str] = None,
                 fs: Optional[FileSystemLike] = None, device=None):
        self.conf = conf
        self.name = name
        self.instance = instance or \
            f"{socket.gethostname()}-{uuid.uuid4().hex[:8]}"
        serving_read_defaults(conf)
        cfg = get_config(preset)
        refuse_unported(conf, cfg)
        self.device = resolve_device(device)
        fs, ckpt_dir = checkpoint_location(checkpoint, fs)
        t0 = time.monotonic()
        params, step = load_serving_params(
            fs, ckpt_dir, cfg, io_workers=conf.get_int(IO_WORKERS_KEY, 4),
            device=self.device)
        self.load_seconds = round(time.monotonic() - t0, 3)
        self.step = step
        metrics = ServingMetrics()
        # door QoS: the decay scheduler and the fair admission queue
        # exist before the engine (the queue is its pending queue), the
        # gate after it (the shed decision reads live queue depth)
        self.qos_enabled = conf.get_bool("serving.qos.enabled", True)
        qos_queue = qos_sched = None
        if self.qos_enabled:
            qos_sched = DecayCostScheduler(
                conf.get_int("serving.qos.levels", 4), conf)
            qos_queue = FairAdmissionQueue(qos_sched)
        self.engine = DecodeEngine(
            params, cfg,
            max_batch=conf.get_int("serving.max.batch", 0) or 4,
            block_size=conf.get_int("serving.kv.block.size", 16),
            num_blocks=conf.get_int("serving.kv.num.blocks", 0) or None,
            max_context=conf.get_int("serving.max.context", 0) or None,
            prefill_chunk=conf.get_int("serving.prefill.chunk", 16),
            prefix_cache=conf.get_bool("serving.prefix_cache.enabled",
                                       True),
            device=self.device, admission_queue=qos_queue,
            metrics=metrics)
        qos_gate = QoSGate(conf, self.engine, metrics=metrics,
                           scheduler=qos_sched) if self.qos_enabled \
            else None
        self.server = ServingServer(self.engine, conf, bind=bind,
                                    qos=qos_gate,
                                    # /v1/admin/drain retires the whole
                                    # replica, not just the door
                                    drain_cb=self.drain_and_stop)
        # advertise a reachable address: the bind host when concrete,
        # the hostname when bound to the wildcard
        self.advertise_host = bind[0] if bind[0] not in ("", "0.0.0.0") \
            else socket.gethostname()
        self.reg = registry
        self.record: Optional[ServiceRecord] = None
        self._stopped = threading.Event()
        self._drain_lock = threading.Lock()
        # set when drain_and_stop has fully finished; _stopped only
        # means it began. The process's main loop exits on this one.
        self.drained = threading.Event()

    def start(self) -> None:
        self.engine.start()
        self.server.start()
        if self.reg is not None:
            self._record_ttl = record_ttl(self.conf)
            eng = self.engine
            plane = eng.weight_plane()
            self.record = ServiceRecord(
                replica_path(self.name, self.instance),
                endpoints={"http":
                           f"{self.advertise_host}:{self.server.port}"},
                attributes={"state": "serving",
                            "slots": str(eng.max_batch),
                            "step": str(self.step),
                            # liveness stamp: routers skip the record
                            # once it ages past the TTL
                            HEARTBEAT_ATTR: f"{time.time():.3f}",
                            "load_seconds": str(self.load_seconds),
                            "weight_dtype": plane["dtype"],
                            "weight_bytes": str(eng.weight_bytes),
                            "quantize_seconds": "0.0",
                            "experts": str(plane["experts"]),
                            "expert_shards": str(plane["expert_shards"]),
                            "expert_bytes": str(plane["expert_bytes"]),
                            "role": "mixed",
                            "kv_host_bytes": "0",
                            "kv_block_bytes": str(eng.block_nbytes),
                            "kv_block_size": str(eng.block_size),
                            "kv_hbm_blocks": str(eng.pool.num_usable),
                            "longctx": "0",
                            "longctx_max_tokens": "0",
                            "kv_dfs": "0"})
            # the heartbeat below refreshes the record (stamp + live
            # load): it is the renewal, so no auto_renew twin
            self.reg.register(self.record, ttl_s=self._record_ttl,
                              auto_renew=False)
            threading.Thread(target=self._heartbeat_loop, daemon=True,
                             name=f"replica-heartbeat-{self.instance}"
                             ).start()
        log.info("serving replica %s/%s up on :%d (checkpoint step %d)",
                 self.name, self.instance, self.server.port, self.step)

    def _heartbeat_loop(self) -> None:
        """Refresh the registry record at a third of its TTL: the stamp
        keeps staleness checks green, the re-register keeps the lease
        alive (and recreates the record after a registry restart), and
        the live load rides along."""
        period = max(0.2, self._record_ttl / 3.0)
        while not self._stopped.wait(period):
            self.record.attributes.update({
                HEARTBEAT_ATTR: f"{time.time():.3f}",
                "queue_depth": str(self.engine.queue_depth),
                "active": str(self.engine.num_active)})
            try:
                self.reg.register(self.record, ttl_s=self._record_ttl,
                                  auto_renew=False)
            except Exception as e:  # noqa: BLE001 — the registry client
                # is the caller's, its errors are its own types; a dead
                # registry must not kill the replica, the next beat
                # retries
                log.warning("registry heartbeat failed: %s", e)

    def drain_and_stop(self, timeout: float = 60.0) -> None:
        """Flip the record to draining, drain the door and the engine,
        unregister, stop. A second caller (SIGTERM racing
        ``/v1/admin/drain``) waits for the first one's drain."""
        with self._drain_lock:
            mine = not self._stopped.is_set()
            self._stopped.set()
        if not mine:
            self.drained.wait(timeout)
            return
        try:
            if self.reg is not None and self.record is not None:
                # routers holding a cached copy see 'draining' on their
                # next refresh even if the lease outlives us briefly
                self.record.attributes["state"] = "draining"
                try:
                    self.reg.register(self.record, ttl_s=10.0,
                                      auto_renew=False)
                except Exception as e:  # noqa: BLE001 — see above
                    log.warning("draining-state publish failed: %s", e)
            self.server.drain(timeout=timeout)
            if self.reg is not None:
                if self.record is not None:
                    try:
                        self.reg.unregister(self.record.path)
                    except Exception as e:  # noqa: BLE001 — see above
                        log.warning("unregister on drain failed: %s", e)
                self.reg.close()
            self.server.stop()
        finally:
            self.drained.set()


def replica_main(argv: List[str], conf: Optional[ConfLike] = None) -> int:
    """Entry point of one replica process (see the module docstring).
    Returns 0 after a drain, 2 for a bad or unported option."""
    conf = conf or Configuration()
    args = dict(name="serving", checkpoint=None, preset="tiny",
                registry=None, port=0, host="127.0.0.1", role=None,
                device=None)
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--replica":
            i += 1
            continue
        if a == "-D" and i + 1 < len(argv) and "=" in argv[i + 1]:
            key, _, val = argv[i + 1].partition("=")
            conf.set(key, val)
            i += 2
            continue
        if a.startswith("-D") and "=" in a:
            key, _, val = a[2:].partition("=")
            conf.set(key, val)
            i += 1
            continue
        key = a.lstrip("-").replace("-", "_")
        if key in args and i + 1 < len(argv):
            args[key] = argv[i + 1]
            i += 2
        else:
            print(f"unknown serve option {a}", file=sys.stderr)
            return 2
    if not args["checkpoint"]:
        print("usage: python -m hadoop_tpu_torch.serving.service "
              "--checkpoint URI --preset NAME [--name SVC] [--port N] "
              "[--host H] [--device DEV] [-D key=value ...]",
              file=sys.stderr)
        return 2
    if args["registry"]:
        print("--registry: the port carries no registry RPC client "
              "(ROADMAP Queue A 9); an in-process caller passes its "
              "client as ServingReplica(registry=...)", file=sys.stderr)
        return 2
    if args["role"]:
        conf.set("serving.role", str(args["role"]))
    try:
        replica = ServingReplica(
            conf, name=str(args["name"]),
            checkpoint=str(args["checkpoint"]), preset=str(args["preset"]),
            bind=(str(args["host"]), int(args["port"])),
            device=args["device"])
    except NotImplementedError as e:
        print(f"serve: {e}", file=sys.stderr)
        return 2
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    replica.start()
    try:
        while not stop.wait(0.5):
            if replica.drained.is_set():
                break        # retired through /v1/admin/drain
    finally:
        replica.drain_and_stop()
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(replica_main(sys.argv[1:]))
