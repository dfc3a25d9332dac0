"""The fleet doctor: discovery, trace assembly, slow-node detection.

The port's copy of ``hadoop_tpu/obs/doctor.py``. One service with its
own chassis door that:

1. **assembles traces**: pulls every daemon's ``/ws/v1/traces[/slow]``
   into a ``FleetTraceStore`` each poll and serves merged trees at
   ``/ws/v1/fleet/traces/<id>`` (hex or decimal) with a per-daemon
   critical path; a miss pulls that one id from every endpoint;
2. **detects slow nodes**: every DataNode's ``/ws/v1/peers`` (pipeline
   acks a peer, its own read service), every replica's ``/prom``
   (decode-step and TTFT means over the poll's window, by diffing the
   cumulative sum and count) and every trainer rank's
   ``/ws/v1/trainer`` (step-wall means), each signal through its own
   ``SlowNodeDetector`` (median/MAD with report-window hysteresis);
   the report is ``/ws/v1/fleet/doctor``, each flagged node with its
   ``/ws/v1/stacks`` link;
3. **keeps the SLO scoreboard** (``obs/slo.py``) over the replicas'
   class-labeled families: ``/ws/v1/fleet/slo``, and the report's
   ``slo``;
4. **acts**: pushes the flagged DataNodes to every NameNode of
   ``dfs.namenode.rpc-address`` (``DatanodeProtocol.report_slow_peers``
   over the port's RPC client, with the TTL ``obs.doctor.slow.ttl``;
   once more, empty, when the set empties), and names the flagged
   replicas (:meth:`FleetDoctor.sick_replicas`) for an autoscaler's
   scale-in victim.

Discovery (:meth:`FleetDoctor.discover`): ``obs.doctor.endpoints``
(``name=host:port,...``), the NameNode's ``/ws/v1/datanodes`` roster at
``obs.doctor.namenode.http``, and the registry at ``obs.doctor.registry``
through the port's ``RegistryClient``: replicas under
``obs.doctor.service`` (``/services`` by default) and trainer ranks under
``obs.doctor.trainer.service`` (``/trainer-jobs``), a record whose
heartbeat aged past the TTL skipped. Every GET is bounded by
``obs.doctor.scrape.timeout``; a dead daemon is a status row. The poll
runs every ``obs.doctor.interval`` (jittered), and ``poll_once()`` runs
one synchronously. :func:`doctor_main` is ``doctor`` of the port's
command line.
"""

from __future__ import annotations

import json
import logging
import math
import threading
import time
from typing import Dict, List, Optional, Tuple

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.http import http_get
from hadoop_tpu_torch.http.server import HttpServer
from hadoop_tpu_torch.obs.assemble import (Endpoint, FleetTraceStore,
                                           parse_endpoint_list)
from hadoop_tpu_torch.obs.detect import SlowNodeDetector, median
from hadoop_tpu_torch.obs.slo import SloScoreboard
from hadoop_tpu_torch.obs.trainer import DEFAULT_SERVICE
from hadoop_tpu_torch.registry import (RegistryClient, record_is_stale,
                                       record_ttl)
from hadoop_tpu_torch.serving.autoscale.signals import parse_prom
from hadoop_tpu_torch.service import AbstractService
from hadoop_tpu_torch.tracing import parse_trace_id_candidates
from hadoop_tpu_torch.util.misc import Daemon, backoff_delay, parse_addr_list

log = logging.getLogger(__name__)

INTERVAL_KEY = "obs.doctor.interval"
ENDPOINTS_KEY = "obs.doctor.endpoints"
REGISTRY_KEY = "obs.doctor.registry"
SERVICE_KEY = "obs.doctor.service"
TRAINER_SERVICE_KEY = "obs.doctor.trainer.service"
NN_HTTP_KEY = "obs.doctor.namenode.http"
PUSH_NN_KEY = "obs.doctor.push.namenode"
SLOW_TTL_KEY = "obs.doctor.slow.ttl"

STEP_FAMILY = "htpu_decode_step_seconds"
TTFT_FAMILY = "htpu_time_to_first_token_seconds"

# trainer roster rows retained after a rank dies (ok=False history —
# a dead rank must not vanish from the fleet view mid-diagnosis), hard
# bound so an elastic job minting ranks can't grow the report forever
MAX_TRAINER_ROWS = 128


class FleetDoctor(AbstractService):
    """Aggregation service + its own chassis HTTP door."""

    def __init__(self, conf: ConfLike):
        super().__init__("FleetDoctor")
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._report: Dict = {"generated_at": 0.0}   # guarded-by: _lock
        self._endpoints: List[Endpoint] = []         # guarded-by: _lock
        self._reg_client = None
        self._nn_proxy = None
        self._rpc_client = None
        self.http = None
        # replica /prom window state: endpoint key ->
        # {family: (sum, count)} cumulative at the previous poll
        self._prom_prev: Dict[str, Dict[str, Tuple[float, float]]] = {}
        # trainer /ws/v1/trainer window state: endpoint key ->
        # (step_wall_sum, step_wall_count) cumulative at previous poll
        self._trainer_prev: Dict[str, Tuple[float, float]] = {}
        # rank roster: endpoint key -> row (ok flips False when a rank
        # stops answering — contributed history stays visible)
        self._trainer_status: Dict[str, Dict] = {}   # guarded-by: _lock
        # static daemon endpoints proven non-trainers (live daemon, no
        # /ws/v1/trainer servlet): never probed again until they depart
        # discovery — probing them every poll would cost a scrape each
        self._not_trainer: set = set()
        self._trainer_polls = 0

    # ----------------------------------------------------------- lifecycle

    def service_init(self, conf: ConfLike) -> None:
        self.interval = conf.get_time_seconds(INTERVAL_KEY, 5.0)
        self.timeout = conf.get_time_seconds(
            "obs.doctor.scrape.timeout", 2.0)
        self.store = FleetTraceStore(conf)
        self.slow_ttl = conf.get_time_seconds(
            SLOW_TTL_KEY, max(30.0, self.interval * 10))
        det = dict(
            history=conf.get_int("obs.doctor.slow.history", 5),
            min_windows=conf.get_int("obs.doctor.slow.min-windows", 3),
            min_peers=conf.get_int("obs.doctor.slow.min-peers", 3),
            mad_k=conf.get_float("obs.doctor.slow.mad-k", 3.0),
            ratio=conf.get_float("obs.doctor.slow.ratio", 1.5),
            abs_floor=conf.get_float("obs.doctor.slow.floor.ms",
                                     1.0) / 1e3)
        # one detector per signal: a node slow on pipeline acks and a
        # node slow on its own disk are different diagnoses
        self.detectors: Dict[str, SlowNodeDetector] = {
            "dn.pipeline_ack": SlowNodeDetector(**det),
            "dn.read_service": SlowNodeDetector(**det),
            "replica.decode_step": SlowNodeDetector(**det),
            "replica.ttft": SlowNodeDetector(**det),
            # training flight recorder: per-rank step-wall means from
            # /ws/v1/trainer, same median/MAD + hysteresis machinery —
            # the sensory input doctor-driven elastic training needs
            "trainer.step_wall": SlowNodeDetector(**det),
        }
        self._static = [Endpoint(n, h, p, "daemon") for n, h, p in
                        parse_endpoint_list(conf.get(ENDPOINTS_KEY, ""))]
        self._pushed_slow: set = set()   # last flagged set sent to NN
        self._nn_http = None
        nn_http = conf.get(NN_HTTP_KEY, "")
        if nn_http:
            host, _, port = nn_http.rpartition(":")
            self._nn_http = Endpoint("namenode", host or "127.0.0.1",
                                     int(port), "namenode")
        self._registry_addr = None
        reg = conf.get(REGISTRY_KEY, "")
        if reg:
            host, _, port = reg.rpartition(":")
            self._registry_addr = (host or "127.0.0.1", int(port))
        self._service_prefix = conf.get(SERVICE_KEY, "")
        self._trainer_prefix = conf.get(TRAINER_SERVICE_KEY,
                                        DEFAULT_SERVICE)
        self.push_nn = conf.get_bool(PUSH_NN_KEY, True)
        self.http = HttpServer(
            conf, bind=("127.0.0.1", conf.get_int("obs.doctor.port", 0)),
            daemon_name="fleet-doctor")
        # fleet SLO scoreboard: class-labeled door accounting diffed
        # per poll into availability / p99 attainment / budget burn
        self.slo = SloScoreboard(conf)
        self.http.add_handler("/ws/v1/fleet/doctor", self._h_doctor)
        self.http.add_handler("/ws/v1/fleet/slo", self._h_slo)
        self.http.add_handler("/ws/v1/fleet/traces", self._h_traces)

    def service_start(self) -> None:
        self.http.start()
        Daemon(self._poll_loop, "fleet-doctor-poll").start()
        log.info("fleet doctor on :%d (interval %.1fs)",
                 self.http.port, self.interval)

    def service_stop(self) -> None:
        self._stop.set()
        if self.http is not None:
            self.http.stop()
        if self._reg_client is not None:
            self._reg_client.close()
        if self._rpc_client is not None:
            self._rpc_client.stop()

    @property
    def port(self) -> int:
        return self.http.port

    # ----------------------------------------------------------- discovery

    def discover(self) -> List[Endpoint]:
        """Static conf + NameNode roster + registry replicas. Failures
        shrink the list, never raise — the doctor keeps doctoring the
        daemons it CAN see."""
        eps: Dict[str, Endpoint] = {e.key: e for e in self._static}
        if self._nn_http is not None:
            eps[self._nn_http.key] = self._nn_http
            try:
                roster = json.loads(http_get(
                    self._nn_http.host, self._nn_http.port,
                    "/ws/v1/datanodes", self.timeout))
                for dn in roster.get("datanodes", []):
                    if dn.get("state") != "live" or \
                            not dn.get("info_port"):
                        continue
                    ep = Endpoint(dn["uuid"], dn.get("host", "127.0.0.1"),
                                  dn["info_port"], "datanode")
                    eps[ep.key] = ep
            except (OSError, ValueError, KeyError) as e:
                log.debug("datanode roster pull failed: %s", e)
        if self._registry_addr is not None:
            ttl = record_ttl(self.config)
            # replicas + the trainer-job roster (obs/trainer.py ranks
            # publish heartbeat-stamped records): corpse records —
            # a publisher that died without deregistering, awaiting
            # the registry sweep — are SKIPPED by the record_is_stale
            # precedent (scraping one costs bounded timeouts EVERY
            # poll and can push a poll past its interval); a skipped
            # rank's contributed history stays in the fleet view with
            # ok=False via _observe_trainers
            for prefix, kind in (
                    (self._service_prefix or "/services", "replica"),
                    (self._trainer_prefix, "trainer")):
                try:
                    for rec in self._registry().list(prefix):
                        if record_is_stale(rec, ttl):
                            continue
                        try:
                            host, _, port = \
                                rec.endpoints["http"].rpartition(":")
                        except (KeyError, AttributeError):
                            continue
                        ep = Endpoint(rec.path, host or "127.0.0.1",
                                      int(port), kind)
                        eps[ep.key] = ep
                except Exception as e:  # noqa: BLE001 — registry
                    # outage: the doctor keeps serving what it can
                    # still see; the next jittered poll retries
                    log.debug("registry discovery failed: %s", e)
        return list(eps.values())

    def _registry(self):
        if self._reg_client is None:
            self._reg_client = RegistryClient(self._registry_addr,
                                              self.config)
        return self._reg_client

    # ---------------------------------------------------------------- poll

    def _poll_loop(self) -> None:
        # jittered cadence (fleet hygiene: N doctors/scrapers must not
        # align their pulls), same law as every poll loop in this tree
        while not self._stop.wait(backoff_delay(self.interval, 0,
                                                max_s=self.interval * 2)):
            try:
                self.poll_once()
            except Exception:
                log.exception("doctor poll failed")

    def poll_once(self) -> Dict:
        """One full pass: discover -> scrape traces -> scrape signals ->
        detect -> publish report (and push slow DNs to the NN).
        Callable synchronously — tests and the smoke pump this."""
        endpoints = self.discover()
        with self._lock:
            self._endpoints = endpoints
        self.store.scrape(endpoints)
        dn_eps = [e for e in endpoints if e.kind == "datanode"]
        rep_eps = [e for e in endpoints if e.kind == "replica"]
        # trainer candidates: roster records (kind trainer) plus static
        # obs.doctor.endpoints entries (kind daemon) — a static entry
        # that is not a trainer 404s a probe, is remembered as a
        # non-trainer, and never makes a roster row
        tr_eps = [e for e in endpoints
                  if e.kind in ("trainer", "daemon")]
        self._observe_datanodes(dn_eps)
        self._observe_replicas(rep_eps)
        self._observe_trainers(tr_eps)
        report = self._compile(endpoints)
        with self._lock:
            self._report = report
        flagged_dns = sorted(report["datanodes"]["flagged"])
        # push when anything is flagged (refreshing the NN's TTL) AND
        # once more when the set empties — set_slow_nodes is a full
        # report, so the empty push clears a recovered node IMMEDIATELY
        # instead of letting it ride out the TTL. (A failed empty push
        # is covered by the TTL fail-open.)
        if self.push_nn and (flagged_dns or self._pushed_slow):
            self._push_slow_nodes(flagged_dns)
        self._pushed_slow = set(flagged_dns)
        return report

    def _observe_datanodes(self, dn_eps: List[Endpoint]) -> None:
        """Aggregate every DN's view of every peer: a target's signal is
        the MEDIAN of what its upstream reporters measured (one broken
        reporter cannot frame a healthy target), then MAD across
        targets."""
        reported: Dict[str, List[float]] = {}
        self_read: Dict[str, float] = {}
        for ep in dn_eps:
            try:
                rep = json.loads(http_get(ep.host, ep.port,
                                          "/ws/v1/peers", self.timeout))
            except (OSError, ValueError):
                continue                      # churn: skip this reporter
            for target, s in (rep.get("peers") or {}).items():
                if s and s.get("n"):
                    reported.setdefault(target, []).append(
                        float(s["mean"]))
            own = (rep.get("self") or {}).get("read")
            if own and own.get("n"):
                self_read[rep.get("node", ep.name)] = float(own["mean"])
        if reported:
            self.detectors["dn.pipeline_ack"].observe(
                {t: median(v) for t, v in reported.items()})
        if self_read:
            self.detectors["dn.read_service"].observe(self_read)

    def _observe_replicas(self, rep_eps: List[Endpoint]) -> None:
        """Per-stage replica latencies from /prom, windowed by diffing
        cumulative sum/count per endpoint (counter reset => restart =>
        whole history is this window)."""
        step_means: Dict[str, float] = {}
        ttft_means: Dict[str, float] = {}
        seen = set()
        for ep in rep_eps:
            seen.add(ep.key)
            try:
                fams = parse_prom(http_get(ep.host, ep.port, "/prom",
                                           self.timeout).decode())
            except (OSError, ValueError):
                continue
            # the SLO scoreboard diffs the same scrape (class-labeled
            # htpu_slo_* families) with its own per-endpoint baselines
            self.slo.observe(ep.key, fams)
            prev = self._prom_prev.setdefault(ep.key, {})
            for family, sink in ((STEP_FAMILY, step_means),
                                 (TTFT_FAMILY, ttft_means)):
                total = sum(v for _, v in fams.get(f"{family}_sum", []))
                count = sum(v for _, v in fams.get(f"{family}_count",
                                                   []))
                p_sum, p_count = prev.get(family, (0.0, 0.0))
                if count < p_count:
                    p_sum, p_count = 0.0, 0.0
                d_count = count - p_count
                if d_count > 0 and math.isfinite(total):
                    sink[ep.name] = (total - p_sum) / d_count
                prev[family] = (total, count)
        # prune window state for departed replicas (elastic fleets mint
        # a port per replica — the FleetScraper precedent)
        for key in [k for k in self._prom_prev if k not in seen]:
            del self._prom_prev[key]
        # close the scoreboard's poll window (same departed-endpoint
        # pruning; merges this poll's per-class deltas + recomputes)
        self.slo.commit(seen)
        if step_means:
            self.detectors["replica.decode_step"].observe(step_means)
        if ttft_means:
            self.detectors["replica.ttft"].observe(ttft_means)

    def _observe_trainers(self, tr_eps: List[Endpoint]) -> None:
        """Per-rank step-wall means from ``/ws/v1/trainer``, windowed
        by diffing the cumulative sum/count between polls (counter
        reset => rank restarted => whole history is this window — the
        FleetScraper discipline). A rank that stops answering keeps its
        roster row with ``ok=False`` (its detector history ages out
        through the hysteresis window); an endpoint discovery no longer
        lists at all has its inter-poll window state pruned."""
        means: Dict[str, float] = {}
        candidate_keys = set()
        scraped_ok = set()
        now = time.time()
        self._trainer_polls += 1
        with self._lock:
            known_keys = set(self._trainer_status)
        for ep in tr_eps:
            candidate_keys.add(ep.key)
            if ep.key in self._not_trainer:
                continue     # proven non-trainer daemon: no probe
            if ep.kind == "daemon" and ep.key not in known_keys and \
                    self._trainer_polls % 4 != 1:
                # unknown static daemon that has never answered: probe
                # on a 1-in-4 cadence so a DEAD non-trainer entry
                # can't burn a scrape timeout every poll (the same
                # per-poll-cost discipline as the corpse skip); a
                # late-starting static trainer is found within 4 polls
                continue
            try:
                rep = json.loads(http_get(ep.host, ep.port,
                                          "/ws/v1/trainer",
                                          self.timeout))
            except IOError as e:
                if "HTTP 404" in str(e):
                    # a LIVE daemon without the servlet is a permanent
                    # non-trainer (until discovery drops it)
                    self._not_trainer.add(ep.key)
                continue        # dead rank, or unreachable
            except ValueError:
                continue
            sw = rep.get("step_wall") or {}
            total = float(sw.get("sum", 0.0) or 0.0)
            count = float(sw.get("count", 0) or 0)
            p_sum, p_count = self._trainer_prev.get(ep.key, (0.0, 0.0))
            if count < p_count:
                p_sum, p_count = 0.0, 0.0
            d_count = count - p_count
            if d_count > 0 and math.isfinite(total):
                means[ep.name] = (total - p_sum) / d_count
            self._trainer_prev[ep.key] = (total, count)
            scraped_ok.add(ep.key)
            row = {"endpoint": ep.to_dict(), "ok": True,
                   "rank": rep.get("rank"), "job": rep.get("job"),
                   "steps": rep.get("steps"),
                   "step_wall": sw, "last_seen": now}
            with self._lock:
                self._trainer_status[ep.key] = row
        # prune window state only for endpoints discovery dropped (the
        # _prom_prev precedent); a still-listed-but-dead rank keeps its
        # cumulative baseline for the restart-reset check above
        for key in [k for k in self._trainer_prev
                    if k not in candidate_keys]:
            del self._trainer_prev[key]
        self._not_trainer &= candidate_keys
        with self._lock:
            for key, row in self._trainer_status.items():
                if key not in scraped_ok and row.get("ok"):
                    row = dict(row)
                    row["ok"] = False
                    self._trainer_status[key] = row
            # bounded roster: oldest dead rows age out first
            while len(self._trainer_status) > MAX_TRAINER_ROWS:
                victim = min(
                    self._trainer_status,
                    key=lambda k: (self._trainer_status[k].get("ok"),
                                   self._trainer_status[k].get(
                                       "last_seen", 0.0)))
                del self._trainer_status[victim]
        if means:
            self.detectors["trainer.step_wall"].observe(means)

    # -------------------------------------------------------------- report

    def _compile(self, endpoints: List[Endpoint]) -> Dict:
        by_name = {e.name: e for e in endpoints}

        def section(kinds: Tuple[str, ...]) -> Dict:
            flagged: Dict[str, Dict] = {}
            for signal in kinds:
                for node, ev in self.detectors[signal].report().items():
                    entry = flagged.setdefault(
                        node, {"node": node, "signals": {}})
                    entry["signals"][signal] = ev
                    ep = by_name.get(node)
                    if ep is not None:
                        entry["endpoint"] = ep.to_dict()
                        # the diagnosis handoff: a flagged node's live
                        # thread dump is one click away
                        entry["stacks"] = (f"http://{ep.host}:{ep.port}"
                                           f"/ws/v1/stacks")
            return {"flagged": flagged}

        trainers = section(("trainer.step_wall",))
        with self._lock:
            trainers["ranks"] = {k: dict(v) for k, v in
                                 self._trainer_status.items()}
        return {
            "generated_at": time.time(),
            "interval_s": self.interval,
            "endpoints": self.store.status(),
            "datanodes": section(("dn.pipeline_ack", "dn.read_service")),
            "replicas": section(("replica.decode_step", "replica.ttft")),
            "trainers": trainers,
            # per-class SLO attainment + error-budget burn verdicts —
            # the autoscaler reads burn off this same pull
            "slo": self.slo.report(),
            "traces_held": len(self.store.trace_ids()),
        }

    def report(self) -> Dict:
        with self._lock:
            return dict(self._report)

    def sick_replicas(self) -> List[str]:
        """Endpoint names (registry paths) of flagged replicas — the
        autoscaler's scale-in victim hint."""
        with self._lock:
            rep = self._report
        return sorted((rep.get("replicas") or {})
                      .get("flagged", {}).keys())

    # ----------------------------------------------------------- NN push

    def _push_slow_nodes(self, uuids: List[str]) -> None:
        """DatanodeProtocol.report_slow_peers to EVERY configured
        NameNode — the DN precedent (one BPServiceActor per NN): in an
        HA pair the doctor cannot know which node is active, and a
        standby silently accepting the report while the active never
        hears it would defeat placement deprioritization with no error
        anywhere. Pipeline placement then avoids these uuids until the
        TTL lapses (a doctor outage fails open: flags decay)."""
        delivered = 0
        for addr, proxy in self._nn_proxies():
            try:
                proxy.report_slow_peers(uuids, self.slow_ttl)
                delivered += 1
            except Exception as e:  # noqa: BLE001 — an unreachable NN
                # must not kill the doctor or starve its HA twin; the
                # next poll re-pushes (the TTL is several intervals
                # wide exactly so one miss is harmless)
                log.debug("slow-node push to %s failed: %s", addr, e)
                self._nn_proxy = None     # rebuild proxies next push
        if not delivered:
            log.debug("slow-node push reached no NameNode")

    def _nn_proxies(self):
        if self._nn_proxy is None:
            from hadoop_tpu_torch.dfs.client.filesystem import (
                NN_RPC_ADDRESS_DEFAULT, NN_RPC_ADDRESS_KEY)
            from hadoop_tpu_torch.ipc import Client, get_proxy
            addrs = parse_addr_list(self.config.get(
                NN_RPC_ADDRESS_KEY, NN_RPC_ADDRESS_DEFAULT))
            if self._rpc_client is None:
                self._rpc_client = Client(self.config)
            self._nn_proxy = [
                (addr, get_proxy("DatanodeProtocol", addr,
                                 client=self._rpc_client))
                for addr in addrs]
        return self._nn_proxy

    # ------------------------------------------------------------ servlets

    def _h_doctor(self, query, body):
        return 200, self.report()

    def _h_slo(self, query, body):
        """The fleet SLO scoreboard on its own: per-class p99
        attainment vs conf'd targets, availability, and multi-window
        error-budget burn over the doctor's poll cadence."""
        return 200, self.slo.report()

    def _h_traces(self, query, body):
        """``/ws/v1/fleet/traces`` lists held ids;
        ``/ws/v1/fleet/traces/<id>`` (hex or decimal) assembles one —
        with a targeted fleet pull on a miss, so a trace retained only
        in some daemon's flight recorder still resolves."""
        path = query.get("__path__", "")
        suffix = path[len("/ws/v1/fleet/traces"):].strip("/")
        if not suffix:
            return 200, {
                "traces": [f"{t:016x}" for t in self.store.trace_ids()],
                "endpoints": self.store.status()}
        cands = parse_trace_id_candidates(suffix)
        if not cands:
            return 400, {"RemoteException": {
                "exception": "IllegalArgumentException",
                "message": f"bad trace id {suffix!r}"}}
        assembled = next((a for a in map(self.store.assemble, cands)
                          if a is not None), None)
        if assembled is None:
            with self._lock:
                endpoints = list(self._endpoints)
            if not endpoints:
                endpoints = self.discover()
            for tid in cands:
                self.store.fetch_trace(tid, endpoints)
                assembled = self.store.assemble(tid)
                if assembled is not None:
                    break
        if assembled is None:
            return 404, {"RemoteException": {
                "exception": "FileNotFoundException",
                "message": f"trace {suffix} not found on any daemon"}}
        return 200, assembled


def doctor_main(argv: List[str],
                conf: Optional[ConfLike] = None) -> int:
    """``doctor`` of the command line: run the fleet doctor as a
    daemon (``--registry``, ``--service``, ``--namenode-http``,
    ``--endpoints``, ``--port``, ``--interval`` set their conf keys);
    2 for an unknown option."""
    import sys
    conf = conf or Configuration()
    args = dict(registry=None, service=None, namenode_http=None,
                endpoints=None, port=None, interval=None)
    i = 0
    while i < len(argv):
        key = argv[i].lstrip("-").replace("-", "_")
        if key in args and i + 1 < len(argv):
            args[key] = argv[i + 1]
            i += 2
        else:
            print(f"unknown doctor option {argv[i]}", file=sys.stderr)
            return 2
    for key, conf_key in (("registry", REGISTRY_KEY),
                          ("service", SERVICE_KEY),
                          ("namenode_http", NN_HTTP_KEY),
                          ("endpoints", ENDPOINTS_KEY),
                          ("port", "obs.doctor.port"),
                          ("interval", INTERVAL_KEY)):
        if args[key] is not None:
            conf.set(conf_key, str(args[key]))
    from hadoop_tpu_torch.cli.main import _run_daemon
    return _run_daemon(FleetDoctor(conf), conf)
