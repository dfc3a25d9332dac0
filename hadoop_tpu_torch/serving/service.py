"""The serving replica as a deployable unit, its command line and its
YARN service spec.

    python -m hadoop_tpu_torch.serving.service --checkpoint DIR \\
        --preset flagship-1b [--port N] [--host H] [--name SVC] \\
        [--registry HOST:PORT] [--role R] [--device cpu] [-D key=value ...]

The counterpart of ``hadoop_tpu/serving/service.py``'s ``ServingReplica``
and ``replica_main``: load the newest checkpoint under ``--checkpoint``
(``serving/loader.py``), build the engine (its two step shapes are CUDA
graphs on the card) with the QoS fair admission queue in front of it
(``serving.qos.enabled``, on by default), put the door
(``serving/server.py``, on the chassis with its standard endpoints) in
front of that, optionally publish a record in a service registry and
refresh it, and on SIGTERM or SIGINT (or ``POST /v1/admin/drain``)
drain: refuse new work, finish what is in flight, unregister, exit 0.
The door's decay-cost accounting is ``/ws/v1/top``'s source
``serving.<name>.tenants`` while the replica runs. ``-D key=value``
sets a conf key (the door's ``serving.http.auth.secret``, the engine
sizes ``serving.max.batch``,
``serving.kv.block.size``, ``serving.kv.num.blocks``,
``serving.max.context``, ``serving.prefill.chunk``, the KV tiers'
``serving.kv.host.bytes``, ``serving.kv.dfs.enable``, ``serving.kv.dfs.dir``,
``serving.kv.dfs.min-refs``, ``serving.kv.codec``,
``serving.kv.fetch.window``, ``serving.kv.drain.persist``, speculation's
``serving.speculate.k`` and ``serving.speculate.ngram``, the weight
plane's ``serving.parity``, ``serving.weights.*``, ``serving.kv.hbm.bytes``
and ``serving.max.lanes``, MoE's ``serving.moe.capacity.factor``,
``serving.moe.shards`` and ``serving.moe.a2a.codec``, ...).

``serving.parity=relaxed`` loads through ``weightplane.quantized_load``:
each checkpoint leaf is quantized to int8 on the device as it streams
in, and the engine sizes its KV pool (and its lanes, when
``serving.max.batch`` is unset) against the measured resident bytes
when ``serving.kv.hbm.bytes`` is set.

``serving.role`` (or ``--role``) is ``mixed`` (the default), ``prefill``
or ``decode``, as the reference's: any explicit role turns the DFS KV
tier on unless ``serving.kv.dfs.enable`` says otherwise, and a prefill
replica refuses to start without it. The store is the filesystem the
checkpoint is read from (the ``fs=`` an in-process caller passes, or
the one the checkpoint URI names), and the registry record carries ``role``,
``kv_host_bytes`` and ``kv_dfs`` for a router's prefill offload.

The device is the card unless ``--device`` names another (``cpu`` for
tests); without a CUDA device and without ``--device`` it raises.

Without an ``fs=`` from an in-process caller, the checkpoint URI picks
the port's filesystem (``fs.get_filesystem``, with the replica's conf):
a ``file://`` URI or a bare path the local disk, an
``htpu://host:port/dir`` URI the port's DFS client on that NameNode
(SASL, block tokens and data-transfer encryption as the conf says),
which the replica closes when it stops. Another scheme is refused with
``ValueError``, a conf with ``dfs.encryption.key.provider.uri`` with
``NotImplementedError`` (ROADMAP Queue A 9 part 2); the command line
exits 2 for both. ``registry=`` takes any
``RegistryLike``; ``--registry HOST:PORT`` opens the port's
``RegistryClient`` on the reference's registry server. Features the
port has not ported are refused with ``NotImplementedError`` naming
their ROADMAP item (the command line exits 2), never ignored: more than
one expert shard (A 6). ``serving.longctx.enabled`` attaches the
long-context plane (``serving/longctx``) under
``serving.parity=relaxed`` and raises the reference's ``ValueError``
without it.

:func:`serving_service_spec` packages N replicas as a YARN long-running
service for the reference's service AM (``yarn.py``), which restarts an
exited replica; ``autoscaler_service_spec`` waits for the autoscaler
(ROADMAP Queue A 9 part 2).
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
from hadoop_tpu_torch.fs import FileSystemLike, get_filesystem
from hadoop_tpu_torch.models.config import get_config
from hadoop_tpu_torch.obs.top import (register_top_source,
                                      unregister_top_source)
from hadoop_tpu_torch.registry import (HEARTBEAT_ATTR, RegistryClient,
                                       RegistryLike, ServiceRecord,
                                       record_ttl, replica_path)
from hadoop_tpu_torch.serving.engine import DecodeEngine
from hadoop_tpu_torch.serving.longctx import (ENABLED_KEY,
                                              longctx_plane_from_conf)
from hadoop_tpu_torch.serving.loader import (IO_WORKERS_KEY,
                                             load_serving_params,
                                             serving_read_defaults)
from hadoop_tpu_torch.serving.metrics import ServingMetrics
from hadoop_tpu_torch.serving.qos import (DecayCostScheduler,
                                          FairAdmissionQueue, QoSGate)
from hadoop_tpu_torch.serving.server import ServingServer
from hadoop_tpu_torch.serving.weightplane import (quantized_load,
                                                  weightplane_from_conf)
from hadoop_tpu_torch.yarn import (RESTART_ALWAYS, Component, Resource,
                                   ServiceSpec)

log = logging.getLogger(__name__)


def serving_service_spec(name: str, *, checkpoint: str, preset: str,
                         replicas: int = 2,
                         registry_addr: Optional[str] = None,
                         resource: Optional[Resource] = None,
                         extra_args: Optional[List[str]] = None,
                         ) -> ServiceSpec:
    """YARN service spec: N identical replica containers."""
    cmd = [sys.executable, "-m", "hadoop_tpu_torch.serving.service",
           "--replica", "--name", name,
           "--checkpoint", checkpoint, "--preset", preset,
           # containers land on any host: bind the wildcard, so the
           # replica advertises its hostname, not a loopback address
           "--host", "0.0.0.0"]
    if registry_addr:
        cmd += ["--registry", registry_addr]
    cmd += list(extra_args or [])
    return ServiceSpec(name, [
        Component("replica", replicas, cmd,
                  resource=resource or Resource(1024, 1),
                  restart_policy=RESTART_ALWAYS),
    ])


def checkpoint_location(checkpoint: str, fs: Optional[FileSystemLike],
                        conf: Optional[ConfLike] = None
                        ) -> Tuple[FileSystemLike, str]:
    """(filesystem, directory) of a checkpoint URI: on ``fs`` when the
    caller passes one, else on the port's filesystem for the URI's
    scheme (``fs.get_filesystem``)."""
    path = urlparse(checkpoint).path
    if fs is not None:
        return fs, path
    return get_filesystem(checkpoint, conf), path


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
        self.device = resolve_device(device)
        # a filesystem the replica opens itself it also closes
        opens_fs = fs is None
        fs, ckpt_dir = checkpoint_location(checkpoint, fs, conf)
        self._own_fs = fs if opens_fs else None
        # the weight plane: serving.parity picks the tier. bitwise (the
        # default) loads the checkpoint's own dtypes; relaxed quantizes
        # each leaf as it streams in
        weights = weightplane_from_conf(conf)
        t0 = time.monotonic()
        self.quantize_seconds = 0.0
        if weights.relaxed:
            params, step, wreport = quantized_load(
                fs, ckpt_dir, cfg, weights,
                io_workers=conf.get_int(IO_WORKERS_KEY, 4),
                device=self.device)
            self.quantize_seconds = wreport["quantize_seconds"]
        else:
            params, step = load_serving_params(
                fs, ckpt_dir, cfg,
                io_workers=conf.get_int(IO_WORKERS_KEY, 4),
                device=self.device)
        self.load_seconds = round(time.monotonic() - t0, 3)
        self.step = step
        # the tiered KV cache: the host ring's byte budget, and the DFS
        # prefix store on the filesystem the checkpoint came from; a
        # prefill-role replica needs the store to hand its KV over
        self.role = conf.get("serving.role", "mixed")
        if self.role not in ("prefill", "decode", "mixed"):
            raise ValueError(f"serving.role must be prefill/decode/"
                             f"mixed, got {self.role!r}")
        self.kv_host_bytes = conf.get_int("serving.kv.host.bytes", 0)
        # any explicitly role'd replica defaults the DFS tier on: the
        # handoff needs the prefill side writing and the decode side
        # reading the same store
        kv_dfs = conf.get_bool("serving.kv.dfs.enable",
                               self.role != "mixed")
        if self.role == "prefill" and not kv_dfs:
            raise ValueError("a prefill-role replica needs the DFS KV "
                             "tier (serving.kv.dfs.enable)")
        self.kv_dfs_enabled = kv_dfs
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
            # unset: 4, or lanes from the budget when
            # serving.kv.hbm.bytes is set
            max_batch=conf.get_int("serving.max.batch", 0) or None,
            block_size=conf.get_int("serving.kv.block.size", 16),
            num_blocks=conf.get_int("serving.kv.num.blocks", 0) or None,
            max_context=conf.get_int("serving.max.context", 0) or None,
            prefill_chunk=conf.get_int("serving.prefill.chunk", 16),
            prefix_cache=conf.get_bool("serving.prefix_cache.enabled",
                                       True),
            kv_host_bytes=self.kv_host_bytes,
            kv_store_fs=fs if kv_dfs else None,
            kv_store_dir=conf.get("serving.kv.dfs.dir", "/kvcache"),
            kv_dfs_min_refs=conf.get_int("serving.kv.dfs.min-refs", 1),
            kv_codec=conf.get("serving.kv.codec", "raw"),
            kv_fetch_window=conf.get_int("serving.kv.fetch.window", 4),
            speculate_k=conf.get_int("serving.speculate.k", 0),
            speculate_ngram=conf.get_int("serving.speculate.ngram", 3),
            drain_persist=conf.get_bool("serving.kv.drain.persist", True),
            # a fixed HBM budget: the KV pool (and the lanes, capped by
            # serving.max.lanes) sized against the measured weight bytes
            hbm_bytes=conf.get_int("serving.kv.hbm.bytes", 0),
            max_lanes=conf.get_int("serving.max.lanes", 16),
            quantize_seconds=self.quantize_seconds,
            # MoE: the capacity-factor override (0 = the config's), the
            # expert shard count (0 = auto) and the a2a payload codec
            moe_capacity_factor=conf.get_float(
                "serving.moe.capacity.factor", 0.0),
            moe_shards=conf.get_int("serving.moe.shards", 0),
            moe_a2a_codec=conf.get("serving.moe.a2a.codec", "int8"),
            device=self.device, admission_queue=qos_queue,
            metrics=metrics)
        qos_gate = QoSGate(conf, self.engine, metrics=metrics,
                           scheduler=qos_sched) if self.qos_enabled \
            else None
        # the long-context plane (serving/longctx): CP prefill, streamed
        # tier ingest and working-set decode for prompts of at least
        # serving.longctx.min.tokens; relaxed tier only (the CP softmax
        # reassociation is not bitwise)
        self.longctx_enabled = conf.get_bool(ENABLED_KEY, False)
        if self.longctx_enabled and weights.relaxed:
            self.engine.attach_longctx(
                longctx_plane_from_conf(conf, cfg, self.engine))
        elif self.longctx_enabled:
            raise ValueError(
                "serving.longctx.enabled requires serving.parity="
                "relaxed (context-parallel prefill reassociates the "
                "softmax — not bitwise vs the single-device step)")
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
        # the door's tenant accounting as /ws/v1/top's source, while up
        self._top_source: Optional[str] = None
        self._stopped = threading.Event()
        self._drain_lock = threading.Lock()
        # set when drain_and_stop has fully finished; _stopped only
        # means it began. The process's main loop exits on this one.
        self.drained = threading.Event()

    def start(self) -> None:
        self.engine.start()
        self.server.start()
        if self.server.qos is not None:
            self._top_source = f"serving.{self.name}.tenants"
            register_top_source(self._top_source,
                                self.server.qos.sched.snapshot)
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
                            "quantize_seconds":
                                str(self.quantize_seconds),
                            "experts": str(plane["experts"]),
                            "expert_shards": str(plane["expert_shards"]),
                            "expert_bytes": str(plane["expert_bytes"]),
                            "role": self.role,
                            "kv_host_bytes": str(self.kv_host_bytes),
                            "kv_block_bytes": str(eng.block_nbytes),
                            "kv_block_size": str(eng.block_size),
                            "kv_hbm_blocks": str(eng.pool.num_usable),
                            "longctx": "1" if self.longctx_enabled
                                       else "0",
                            # the plane's pinned prompt budget: a router
                            # treats a longctx replica as unbounded only
                            # up to it
                            "longctx_max_tokens": str(
                                eng.longctx_stats().get("max_tokens", 0)),
                            "kv_dfs": "1" if self.kv_dfs_enabled
                                      else "0"})
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
            if self._top_source is not None:
                unregister_top_source(self._top_source)
            close = getattr(self._own_fs, "close", None)
            if close is not None:
                close()
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
              "[--host H] [--registry HOST:PORT] [--role R] "
              "[--device DEV] [-D key=value ...]", file=sys.stderr)
        return 2
    if args["role"]:
        conf.set("serving.role", str(args["role"]))
    registry = None
    if args["registry"]:
        host, _, port = str(args["registry"]).rpartition(":")
        registry = RegistryClient((host or "127.0.0.1", int(port)), conf)
    try:
        replica = ServingReplica(
            conf, name=str(args["name"]),
            checkpoint=str(args["checkpoint"]), preset=str(args["preset"]),
            registry=registry, bind=(str(args["host"]), int(args["port"])),
            device=args["device"])
    except (NotImplementedError, ValueError) as e:
        print(f"serve: {e}", file=sys.stderr)
        if registry is not None:
            registry.close()
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
