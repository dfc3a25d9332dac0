"""The client-side router over a service's serving replicas.

The port's copy of ``hadoop_tpu/serving/router.py``. Replicas register
ephemeral records under ``/services/serving/<service>/<instance>``
(``registry.replica_path``, re-exported here with ``REGISTRY_PREFIX``);
the router lists them through the port's ``RegistryClient`` (a cache of
``cache_ttl_s``, 2 s; a record whose heartbeat stamp aged past the
record TTL, or whose ``state`` is not ``serving``, is skipped; through
a registry outage the live part of the cache still serves).

A pick (``_pick``):

1. drops the replicas this request already failed on;
2. keeps those of the wanted role and ``mixed`` (the whole set when none
   match), and with ``prefer_dfs`` those that can read the DFS KV tier
   (``kv_dfs`` not "0"), again only if any;
3. with an affinity key (the digest of the prompt's first
   ``serving.router.affinity.prefix.tokens`` tokens, :func:`affinity_key`)
   takes the key's rendezvous owner (:func:`rendezvous_owner`) unless its
   outstanding requests exceed the lightest candidate's by more than
   ``serving.router.affinity.max.imbalance`` (``affinity_routed`` counts
   these picks);
4. else samples two candidates with the module-level ``random`` and
   takes the one with fewer outstanding requests.

``generate`` first offers a prompt of at least
``serving.router.prefill.min.tokens`` tokens to the least loaded
``prefill``-role replica whose advertised KV pool can hold it
(``_kv_fit``; a skipped one counts in ``prefill_capacity_skips``), as
``POST /v1/prefill`` bounded by ``serving.router.prefill.timeout``, and
only when a decode-side replica can read the shipped KV back; a handoff
that answers counts in ``prefill_offloaded``, and any failure just
leaves the decode replica to prefill cold. Then it posts
``/v1/generate`` under the retry policy (exponential backoff,
``serving.router.max.retries``): a connection error, a 503 (draining), a
429 (shed; its ``Retry-After`` a floor once every replica has failed)
or another 5xx retries on another replica; a 4xx raises
:class:`ReplicaRequestError` at once. The request runs in a
``serving.router.generate`` span whose context rides to the replica in
``X-Htpu-Trace``. ``generate_stream`` routes and retries the
connection's set-up only and yields the replica's JSON lines.
"""

from __future__ import annotations

import hashlib
import http.client
import json
import logging
import random
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

from hadoop_tpu_torch.conf import ConfLike, Configuration
from hadoop_tpu_torch.ipc.errors import RetriableError
from hadoop_tpu_torch.ipc.retry import RetryAction, RetryPolicies, RetryPolicy
from hadoop_tpu_torch.registry import (REGISTRY_PREFIX,  # noqa: F401
                                       RegistryClient, ServiceRecord,
                                       record_is_stale, record_ttl,
                                       replica_path)
from hadoop_tpu_torch.tracing import (TRACE_HEADER, current_context,
                                      global_tracer)

log = logging.getLogger(__name__)


def affinity_key(tokens, prefix_tokens: int = 64) -> str:
    """The routing key: the digest of the prompt's first
    ``prefix_tokens`` tokens."""
    head = ",".join(str(t) for t in tokens[:prefix_tokens])
    return hashlib.sha256(head.encode()).hexdigest()


def rendezvous_owner(key: str, paths):
    """The highest-random-weight owner of ``key`` among ``paths``: only
    a departed owner's keys move when the set changes."""
    return max(paths, key=lambda p: hashlib.sha256(
        f"{key}|{p}".encode()).digest())


class NoReplicasError(RetriableError):
    pass


class ReplicaRequestError(Exception):
    """A replica's 4xx: the same request fails anywhere, so it is
    neither an ``OSError`` nor retriable, and fails fast."""

    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class ServingRouter:
    """Resolve, balance and retry over one service's replicas."""

    def __init__(self, registry_addr: Tuple[str, int], service: str,
                 conf: Optional[ConfLike] = None,
                 policy: Optional[RetryPolicy] = None,
                 cache_ttl_s: float = 2.0):
        self.conf = conf or Configuration()
        self.service = service
        self.reg = RegistryClient(registry_addr, self.conf)
        self.policy = policy or RetryPolicies.exponential_backoff(
            max_retries=self.conf.get_int("serving.router.max.retries", 6),
            base_delay_s=0.05, max_delay_s=2.0)
        self._cache_ttl = cache_ttl_s
        self._cache: List[ServiceRecord] = []   # guarded-by: _lock
        self._cache_at = 0.0                    # guarded-by: _lock
        self._outstanding: Dict[str, int] = {}  # guarded-by: _lock
        self._lock = threading.Lock()
        self.affinity_enabled = self.conf.get_bool(
            "serving.router.affinity.enabled", True)
        self.affinity_prefix = self.conf.get_int(
            "serving.router.affinity.prefix.tokens", 64)
        self.affinity_max_imbalance = self.conf.get_int(
            "serving.router.affinity.max.imbalance", 4)
        self.affinity_routed = 0
        self.prefill_min_tokens = self.conf.get_int(
            "serving.router.prefill.min.tokens", 32)
        self.prefill_timeout = self.conf.get_time_seconds(
            "serving.router.prefill.timeout", 20.0)
        self.prefill_offloaded = 0
        self.prefill_capacity_skips = 0
        self.record_ttl = record_ttl(self.conf)

    # ------------------------------------------------------------ discovery

    def replicas(self, refresh: bool = False) -> List[ServiceRecord]:
        """Live replicas in the ``serving`` state (cached briefly)."""
        now = time.monotonic()
        with self._lock:
            if not refresh and self._cache and \
                    now - self._cache_at < self._cache_ttl:
                return [r for r in self._cache
                        if not record_is_stale(r, self.record_ttl)]
        try:
            recs = [r for r in self.reg.list(
                        f"{REGISTRY_PREFIX}/{self.service}")
                    if "http" in r.endpoints
                    and r.attributes.get("state", "serving") == "serving"
                    and not record_is_stale(r, self.record_ttl)]
        except (OSError, IOError) as e:
            # the registry is briefly out: the live part of the cache
            # answers; with nothing live the failure is retriable
            with self._lock:
                live = [r for r in self._cache
                        if not record_is_stale(r, self.record_ttl)]
                if live:
                    log.debug("registry lookup failed (%s); serving "
                              "stale replica cache", e)
                    return live
            raise NoReplicasError(f"registry unreachable: {e}")
        with self._lock:
            self._cache = recs
            self._cache_at = now
        return list(recs)

    def _affinity_key(self, payload: Dict) -> Optional[str]:
        tokens = payload.get("tokens")
        if (not self.affinity_enabled or not isinstance(tokens, list)
                or not tokens):
            return None
        return affinity_key(tokens, self.affinity_prefix)

    @staticmethod
    def _rec_role(rec: ServiceRecord) -> str:
        return rec.attributes.get("role", "mixed")

    @staticmethod
    def _kv_fit(rec: ServiceRecord, n_tokens: int) -> bool:
        """Can the replica's prefill admission hold ``n_tokens``: its
        advertised pool (``kv_hbm_blocks`` x ``kv_block_size`` tokens,
        the prompt plus the handoff's one generated token); a
        long-context replica with the DFS tier up to its
        ``longctx_max_tokens``. A record without the attributes stays
        eligible."""
        a = rec.attributes
        if a.get("longctx") == "1" and a.get("kv_dfs") != "0":
            try:
                return n_tokens <= int(a["longctx_max_tokens"])
            except (KeyError, ValueError):
                return True
        try:
            block_size = int(a["kv_block_size"])
            pool_blocks = int(a["kv_hbm_blocks"])
        except (KeyError, ValueError):
            return True
        if block_size <= 0:
            return True
        return -(-(n_tokens + 1) // block_size) <= pool_blocks

    def _pick(self, exclude: set, affinity: Optional[str] = None,
              role: Optional[str] = None,
              prefer_dfs: bool = False) -> ServiceRecord:
        cands = [r for r in self.replicas() if r.path not in exclude]
        if not cands:
            cands = [r for r in self.replicas(refresh=True)
                     if r.path not in exclude]
        if role is not None:
            roled = [r for r in cands
                     if self._rec_role(r) in (role, "mixed")]
            if roled:
                cands = roled
        if prefer_dfs:
            dfsable = [r for r in cands
                       if r.attributes.get("kv_dfs") != "0"]
            if dfsable:
                cands = dfsable
        if not cands:
            raise NoReplicasError(f"no live replicas for {self.service}")
        if len(cands) == 1:
            return cands[0]
        with self._lock:
            loads = {r.path: self._outstanding.get(r.path, 0)
                     for r in cands}
        if affinity is not None:
            owner = rendezvous_owner(affinity, [r.path for r in cands])
            target = next(r for r in cands if r.path == owner)
            if loads[target.path] - min(loads.values()) <= \
                    self.affinity_max_imbalance:
                self.affinity_routed += 1
                return target
        # power of two choices: the module-level generator, as the
        # reference's, so a seeded test draws the same pairs
        a, b = random.sample(cands, 2)
        return a if loads[a.path] <= loads[b.path] else b

    # -------------------------------------------------------------- request

    def generate(self, payload: Dict, user: Optional[str] = None) -> Dict:
        """POST ``/v1/generate`` on a balanced replica; the decoded JSON
        answer."""
        with global_tracer().span("serving.router.generate") as rsp:
            rsp.add_kv("prompt_tokens",
                       str(len(payload.get("tokens") or [])))
            offloaded = self._maybe_offload_prefill(payload, user)
            return self._with_retry(
                lambda rec: self._post(rec, payload, user),
                self._affinity_key(payload), role="decode",
                prefer_dfs=offloaded)

    def generate_stream(self, payload: Dict,
                        user: Optional[str] = None) -> Iterator[Dict]:
        """Stream one JSON line a dict. The replica choice and the retry
        cover the connection's set-up only: a stream that dies midway
        reaches the caller."""
        payload = dict(payload, stream=True)
        with global_tracer().span("serving.router.generate_stream"):
            offloaded = self._maybe_offload_prefill(payload, user)
            resp, conn, rec = self._with_retry(
                lambda rec: self._post(rec, payload, user, stream=True)
                + (rec,), self._affinity_key(payload), role="decode",
                prefer_dfs=offloaded)
        # the stream weighs on its replica for its whole life
        with self._lock:
            self._outstanding[rec.path] = \
                self._outstanding.get(rec.path, 0) + 1
        try:
            for raw in resp:
                line = raw.strip()
                if line:
                    yield json.loads(line)
        finally:
            conn.close()
            with self._lock:
                n = self._outstanding.get(rec.path, 1)
                self._outstanding[rec.path] = max(0, n - 1)

    def _maybe_offload_prefill(self, payload: Dict,
                               user: Optional[str]) -> bool:
        """The prefill handoff; True when the KV shipped."""
        tokens = payload.get("tokens")
        if (not isinstance(tokens, list) or
                len(tokens) < self.prefill_min_tokens):
            return False
        try:
            recs = self.replicas()
        except NoReplicasError:
            return False        # discovery is _with_retry's to retry
        pres = [r for r in recs if self._rec_role(r) == "prefill"]
        fit = []
        for r in pres:
            if self._kv_fit(r, len(tokens)):
                fit.append(r)
            else:
                self.prefill_capacity_skips += 1
                log.warning(
                    "prefill offload: %s advertises too little KV "
                    "capacity for a %d-token prompt; skipping it "
                    "(prefill_capacity_skips=%d)", r.path, len(tokens),
                    self.prefill_capacity_skips)
        pres = fit
        if not pres:
            return False
        # no decode-side replica could read the shipped KV back
        dec = [r for r in recs if self._rec_role(r) != "prefill"]
        if dec and all(r.attributes.get("kv_dfs") == "0" for r in dec):
            return False
        with self._lock:
            loads = {r.path: self._outstanding.get(r.path, 0)
                     for r in pres}
        rec = min(pres, key=lambda r: loads[r.path])
        with self._lock:
            self._outstanding[rec.path] = \
                self._outstanding.get(rec.path, 0) + 1
        shipped = False
        try:
            with global_tracer().span(
                    "serving.router.prefill_offload") as sp:
                sp.add_kv("replica", rec.path)
                sp.add_kv("prompt_tokens", str(len(tokens)))
                try:
                    out = self._post(rec, {"tokens": tokens,
                                           "timeout": self.prefill_timeout},
                                     user, api_path="/v1/prefill",
                                     timeout=self.prefill_timeout)
                    sp.add_kv("persisted_tokens",
                              str(out.get("persisted_tokens", 0)))
                    self.prefill_offloaded += 1
                    shipped = True
                except Exception as e:  # noqa: BLE001 — any handoff
                    # failure leaves the decode replica to prefill cold
                    sp.add_kv("failed", str(e))
                    log.debug("prefill offload to %s failed (%s); "
                              "decoding cold", rec.path, e)
        finally:
            with self._lock:
                n = self._outstanding.get(rec.path, 1)
                self._outstanding[rec.path] = max(0, n - 1)
        return shipped

    def _with_retry(self, fn, affinity: Optional[str] = None,
                    role: Optional[str] = None,
                    prefer_dfs: bool = False):
        retries = failovers = 0
        exclude: set = set()
        shed_floor = 0.0      # the largest Retry-After of this round
        while True:
            try:
                rec = self._pick(exclude, affinity, role=role,
                                 prefer_dfs=prefer_dfs)
            except NoReplicasError as e:
                action = self.policy.should_retry(e, retries, failovers,
                                                  True)
                if action.action == RetryAction.FAIL:
                    raise
                retries += 1
                # every candidate failed or shed: wait at least the
                # strongest Retry-After (capped), then try them all again
                time.sleep(max(action.delay_s, 0.05, min(shed_floor, 5.0)))
                shed_floor = 0.0
                exclude.clear()
                continue
            with self._lock:
                self._outstanding[rec.path] = \
                    self._outstanding.get(rec.path, 0) + 1
            try:
                return fn(rec)
            except (ConnectionError, OSError, RetriableError) as e:
                exclude.add(rec.path)
                shed_floor = max(shed_floor,
                                 getattr(e, "retry_after_s", 0.0))
                action = self.policy.should_retry(e, retries, failovers,
                                                  True)
                log.debug("replica %s failed (%s); %s", rec.path, e,
                          action.action)
                if action.action == RetryAction.FAIL:
                    raise
                if action.action == RetryAction.FAILOVER_AND_RETRY:
                    failovers += 1
                retries += 1
                if action.delay_s > 0:
                    time.sleep(action.delay_s)
            finally:
                with self._lock:
                    n = self._outstanding.get(rec.path, 1)
                    self._outstanding[rec.path] = max(0, n - 1)

    def _post(self, rec: ServiceRecord, payload: Dict,
              user: Optional[str], stream: bool = False,
              api_path: str = "/v1/generate", timeout: float = 300.0):
        host, _, port = rec.endpoints["http"].rpartition(":")
        path = api_path
        if user:
            path += f"?user.name={user}"
        conn = http.client.HTTPConnection(host, int(port), timeout=timeout)
        try:
            headers = {"Content-Type": "application/json"}
            ctx = current_context()
            if ctx is not None:
                headers[TRACE_HEADER] = ctx.to_header()
            conn.request("POST", path, body=json.dumps(payload).encode(),
                         headers=headers)
            resp = conn.getresponse()
            if resp.status == 503:
                raise RetriableError(f"replica {rec.path} draining")
            if resp.status == 429:
                # shed here; another replica may have room
                body = resp.read().decode(errors="replace")
                err = RetriableError(f"replica {rec.path} shedding: {body}")
                try:
                    err.retry_after_s = float(
                        resp.getheader("Retry-After") or 0.0)
                except ValueError:
                    err.retry_after_s = 0.0
                raise err
            if 400 <= resp.status < 500:
                body = resp.read().decode(errors="replace")
                raise ReplicaRequestError(
                    resp.status, f"replica {rec.path}: {body}")
            if resp.status != 200:
                body = resp.read().decode(errors="replace")
                raise RetriableError(
                    f"replica {rec.path} -> {resp.status}: {body}")
            if stream:
                return resp, conn   # the caller reads and closes
            data = json.loads(resp.read())
        except Exception:
            conn.close()
            raise
        conn.close()
        return data

    def close(self) -> None:
        self.reg.close()
