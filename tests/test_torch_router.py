"""The port's serving router (``hadoop_tpu_torch.serving.router``) against
the JAX package's.

- ``affinity_key``, ``rendezvous_owner`` and ``_kv_fit`` give the
  reference's answers.
- Over one registry (the port's ``RegistryServer``), the two routers
  seeded alike (the module-level ``random``, as the reference draws its
  power-of-two pairs) pick the same replicas, request for request,
  through roles, ``prefer_dfs``, exclusions, load imbalance and
  affinity, with the same ``affinity_routed``.
- Through scripted replica doors (HTTP: 200, a 503 drain, a 429 shed, a
  400, a prefill replica too small for a prompt), one request sequence
  reaches the same doors in the same order through either router, with
  the same answers, ``affinity_routed``, ``prefill_offloaded`` and
  ``prefill_capacity_skips``; a 4xx fails fast.
- Through the port's router on the port's replicas (tiny, CPU), tokens
  equal ``_reference_greedy`` (a full JAX forward each step), a long
  prompt is prefilled on the prefill replica and decoded from the DFS
  tier, and a drained replica's 503 sends the request elsewhere.
"""

import json
import random
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.serving import router as jrouter
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.fs import LocalFileSystem
from hadoop_tpu_torch.http.server import HttpServer
from hadoop_tpu_torch.models import config, params_from_numpy
from hadoop_tpu_torch.registry import (RegistryClient, RegistryServer,
                                       ServiceRecord)
from hadoop_tpu_torch.serving import router
from hadoop_tpu_torch.serving.engine import DecodeEngine
from hadoop_tpu_torch.serving.server import ServingServer

SERVICE = "svc"
_REF_P = 48
_model = {}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def reg():
    conf = Configuration(load_defaults=False)
    srv = RegistryServer(conf)
    srv.init(conf)
    srv.start()
    client = RegistryClient(("127.0.0.1", srv.port), conf)
    yield srv, client
    client.close()
    srv.stop()


def _register(client, name, port, **attrs):
    attrs.setdefault("state", "serving")
    client.register(ServiceRecord(
        router.replica_path(SERVICE, name), {"http": f"127.0.0.1:{port}"},
        {k: str(v) for k, v in attrs.items()}), ttl_s=60.0,
        auto_renew=False)


def _routers(srv, kv=None):
    """(port router, reference router) over ``srv``, no cache."""
    out = []
    for conf_cls, mod in ((Configuration, router), (JConfiguration, jrouter)):
        conf = conf_cls(load_defaults=False)
        for k, v in (kv or {}).items():
            conf.set(k, str(v))
        out.append(mod.ServingRouter(("127.0.0.1", srv.port), SERVICE, conf,
                                     cache_ttl_s=0.0))
    return out


def _counters(r):
    return (r.affinity_routed, r.prefill_offloaded, r.prefill_capacity_skips)


# ------------------------------------------------------------ pure parts

@pytest.mark.parametrize("seed", range(4))
def test_affinity_key_and_rendezvous_owner_equal_the_reference(seed):
    rng = random.Random(seed)
    for _ in range(50):
        tokens = [rng.randrange(32768) for _ in range(rng.randrange(1, 120))]
        prefix = rng.choice([1, 8, 64, 200])
        key = router.affinity_key(tokens, prefix)
        assert key == jrouter.affinity_key(tokens, prefix)
        paths = [router.replica_path("s", f"r{i}")
                 for i in range(rng.randrange(1, 9))]
        assert router.rendezvous_owner(key, paths) == \
            jrouter.rendezvous_owner(key, paths)
    assert router.REGISTRY_PREFIX == jrouter.REGISTRY_PREFIX
    assert router.replica_path("a", "b") == jrouter.replica_path("a", "b")


@pytest.mark.parametrize("attrs,n", [
    ({}, 10 ** 6),
    ({"kv_block_size": "16", "kv_hbm_blocks": "4"}, 63),
    ({"kv_block_size": "16", "kv_hbm_blocks": "4"}, 64),
    ({"kv_block_size": "16", "kv_hbm_blocks": "4"}, 47),
    ({"kv_block_size": "0", "kv_hbm_blocks": "4"}, 500),
    ({"kv_block_size": "x", "kv_hbm_blocks": "4"}, 500),
    ({"longctx": "1", "longctx_max_tokens": "8192"}, 8192),
    ({"longctx": "1", "longctx_max_tokens": "8192"}, 8193),
    ({"longctx": "1", "kv_dfs": "0", "kv_block_size": "16",
      "kv_hbm_blocks": "2"}, 40),
    ({"longctx": "1"}, 10 ** 7),
])
def test_kv_fit_equals_the_reference(attrs, n):
    rec = ServiceRecord("/p", {}, dict(attrs))
    assert router.ServingRouter._kv_fit(rec, n) == \
        jrouter.ServingRouter._kv_fit(rec, n)


# ------------------------------------------------- picks under one seed

_FLEET = [("d0", dict(role="decode")), ("d1", dict(role="decode")),
          ("m0", dict(role="mixed", kv_dfs="0")), ("m1", {}),
          ("p0", dict(role="prefill")),
          ("gone", dict(state="draining"))]


def _script(seed):
    rng = random.Random(seed + 100)
    ops = []
    for i in range(60):
        kind = rng.random()
        if kind < 0.25:
            path = router.replica_path(SERVICE, rng.choice(_FLEET)[0])
            ops.append(("load", path, rng.choice([-1, 1, 3, 6])))
            continue
        tokens = None
        if kind < 0.7:
            head = rng.randrange(5)
            tokens = [head] * 64 + [rng.randrange(100) for _ in range(4)]
        exclude = {router.replica_path(SERVICE, n) for n, _ in _FLEET
                   if rng.random() < 0.15}
        ops.append(("pick", exclude, tokens,
                    rng.choice([None, "decode", "prefill"]),
                    rng.random() < 0.3))
    return ops


def _run_picks(r, ops, seed):
    random.seed(seed)
    out = []
    for op in ops:
        if op[0] == "load":
            r._outstanding[op[1]] = max(
                0, r._outstanding.get(op[1], 0) + op[2])
            continue
        _, exclude, tokens, role, dfs = op
        aff = None if tokens is None else r._affinity_key(
            {"tokens": tokens})
        try:
            out.append(r._pick(set(exclude), aff, role=role,
                               prefer_dfs=dfs).path)
        except Exception as e:  # noqa: BLE001 — compared by name
            out.append(type(e).__name__)
    return out, _counters(r)


@pytest.mark.parametrize("seed", range(3))
def test_picks_equal_the_references_under_one_seed(reg, seed):
    srv, client = reg
    for i, (name, attrs) in enumerate(_FLEET):
        _register(client, name, 1000 + i, **attrs)
    ops = _script(seed)
    port, ref = _routers(srv)
    try:
        got = _run_picks(port, ops, seed)
        want = _run_picks(ref, ops, seed)
        assert got == want
        picks = got[0]
        assert router.replica_path(SERVICE, "gone") not in picks
        assert got[1][0] > 0                       # affinity was taken
        assert len(set(picks)) >= 4                # and p2c spread
    finally:
        port.close()
        ref.close()


# ----------------------------------------------- scripted replica doors

class _Door:
    """A replica door answering ``status`` (with a JSON body naming it),
    recording every request it takes into ``log``."""

    def __init__(self, name, log, status=200, retry_after=None):
        self.name, self.log = name, log
        self.status, self.retry_after = status, retry_after
        self.http = HttpServer(Configuration(load_defaults=False),
                               daemon_name=name)
        self.http.add_handler("/v1/generate", self._generate)
        self.http.add_handler("/v1/prefill", self._prefill)
        self.http.start()
        self.port = self.http.port

    def _answer(self, api, body):
        req = json.loads(body or b"{}")
        self.log.append((self.name, api, len(req.get("tokens") or [])))
        if self.status != 200:
            headers = {"Retry-After": str(self.retry_after)} \
                if self.retry_after is not None else {}
            return self.status, {"error": self.name}, headers
        return None, req

    def _generate(self, query, body):
        out = self._answer("generate", body)
        if out[0] is not None:
            return out
        return 200, {"tokens": [len(out[1]["tokens"])], "who": self.name}

    def _prefill(self, query, body):
        out = self._answer("prefill", body)
        if out[0] is not None:
            return out
        return 200, {"persisted_tokens": len(out[1]["tokens"]) // 4 * 4}

    def stop(self):
        self.http.stop()


_DOORS = [("dec0", 200, dict(role="decode")),
          ("dec1", 200, dict(role="decode")),
          ("mix0", 200, dict(role="mixed")),
          ("drain", 503, dict(role="decode")),
          ("shed", 429, dict(role="mixed")),
          ("pre0", 200, dict(role="prefill", kv_block_size=4,
                             kv_hbm_blocks=100)),
          ("tiny", 200, dict(role="prefill", kv_block_size=4,
                             kv_hbm_blocks=5))]


def _requests(seed):
    rng = random.Random(seed)
    reqs = []
    for i in range(24):
        n = rng.choice([3, 8, 40, 70, 300])
        head = rng.randrange(4)
        reqs.append([head] * min(n, 64) + [rng.randrange(50)
                                           for _ in range(max(0, n - 64))])
    return reqs


def _run_requests(r, reqs, seed, log):
    random.seed(seed)
    del log[:]
    answers = []
    for tokens in reqs:
        try:
            answers.append(r.generate({"tokens": tokens,
                                       "max_new_tokens": 2})["who"])
        except Exception as e:  # noqa: BLE001 — compared by name
            answers.append(type(e).__name__)
    return answers, list(log), _counters(r)


@pytest.mark.parametrize("seed", range(2))
def test_scripted_doors_see_the_references_sequence(reg, seed):
    srv, client = reg
    log = []
    doors = [_Door(name, log, status, retry_after=0)
             for name, status, _ in _DOORS]
    try:
        for door, (_, _, attrs) in zip(doors, _DOORS):
            _register(client, door.name, door.port, kv_dfs=1, **attrs)
        port, ref = _routers(srv, {"serving.router.prefill.min.tokens": 32,
                                   "serving.router.max.retries": 8})
        reqs = _requests(seed)
        try:
            got = _run_requests(port, reqs, seed, log)
            want = _run_requests(ref, reqs, seed, log)
        finally:
            port.close()
            ref.close()
        assert got == want
        answers, hits, (aff, offloaded, skips) = got
        assert all(a in ("dec0", "dec1", "mix0") for a in answers)
        assert offloaded == sum(1 for t in reqs if len(t) >= 32)
        assert skips == sum(1 for t in reqs if len(t) >= 32)
        assert aff > 0
        assert {h[0] for h in hits} >= {"drain", "shed", "pre0"}
        assert not any(h[0] == "tiny" for h in hits)
    finally:
        for d in doors:
            d.stop()


def test_a_4xx_fails_fast_and_a_lone_drain_exhausts_the_retries(reg):
    srv, client = reg
    log = []
    bad = _Door("bad", log, status=400)
    try:
        _register(client, "bad", bad.port)
        port, ref = _routers(srv, {"serving.router.max.retries": 2})
        try:
            for r, mod in ((port, router), (ref, jrouter)):
                with pytest.raises(mod.ReplicaRequestError) as ei:
                    r.generate({"tokens": [1, 2], "max_new_tokens": 1})
                assert ei.value.status == 400
            assert [h[0] for h in log] == ["bad", "bad"]   # no retry
            bad.status = 503
            del log[:]
            for r in (port, ref):
                with pytest.raises(Exception, match="no live replicas|"
                                   "draining"):
                    r.generate({"tokens": [1, 2], "max_new_tokens": 1})
            per_router = len(log) // 2
            assert per_router >= 2 and len(log) == 2 * per_router
        finally:
            port.close()
            ref.close()
    finally:
        bad.stop()


def test_the_router_span_parents_the_door_request(reg):
    """``X-Htpu-Trace`` carries the ``serving.router.generate`` span's
    context to the door."""
    from hadoop_tpu_torch.tracing import SpanContext, global_tracer
    srv, client = reg
    seen, headers = [], []
    door = HttpServer(Configuration(load_defaults=False))
    door.add_handler("/v1/generate", lambda q, b: (
        headers.append(q["__trace__"]) or (200, {"tokens": [1]})))
    door.start()
    global_tracer().add_receiver(seen.append)
    try:
        _register(client, "one", door.port)
        port, _ = _routers(srv)
        port.generate({"tokens": [1], "max_new_tokens": 1})
        port.close()
        (span,) = [s for s in seen if s.name == "serving.router.generate"]
        ctx = SpanContext.from_header(headers[0])
        assert (ctx.trace_id, ctx.span_id) == (span.trace_id, span.span_id)
    finally:
        global_tracer().remove_receiver(seen.append)
        door.stop()


# ------------------------------------------- the port's replicas, tiny

def _tiny():
    if not _model:
        jcfg = jconfig.get_config("tiny")
        jparams = jdecoder.init_params(jax.random.PRNGKey(0), jcfg)
        cfg = config.get_config("tiny")
        params = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
        fwd = jax.jit(lambda p, t: jdecoder.forward(p, t, jcfg))
        _model.update(jcfg=jcfg, jparams=jparams, cfg=cfg, params=params,
                      fwd=fwd)
    return _model


def _reference_greedy(prompt, max_new):
    """Full JAX forward recompute each step, padded to one length."""
    m = _tiny()
    seq = list(prompt)
    for _ in range(max_new):
        padded = seq + [0] * (_REF_P - len(seq))
        logits = m["fwd"](m["jparams"], jnp.asarray([padded]))
        seq.append(int(jnp.argmax(logits[0, len(seq) - 1])))
    return seq[len(prompt):]


def test_port_router_on_port_replicas(reg, tmp_path):
    """Three port doors (prefill, decode, mixed) on one DFS KV store: a
    long prompt is prefilled on the prefill replica and decoded from the
    store with the reference's greedy tokens; short prompts land on
    their rendezvous owners; a drained door's 503 sends the next request
    to the other replica, and every answer keeps the reference's
    tokens."""
    srv, client = reg
    m = _tiny()
    engines, servers = {}, {}
    conf = Configuration(load_defaults=False)
    conf.set("serving.router.prefill.min.tokens", "12")
    try:
        for role in ("prefill", "decode", "mixed"):
            eng = DecodeEngine(m["params"], m["cfg"], device="cpu",
                               max_batch=2, block_size=4, max_context=48,
                               prefill_chunk=4,
                               kv_store_fs=LocalFileSystem(),
                               kv_store_dir=f"{tmp_path}/kvcache")
            door = ServingServer(eng, Configuration(load_defaults=False))
            eng.start()
            door.start()
            engines[role], servers[role] = eng, door
            _register(client, role, door.port, role=role, kv_dfs=1,
                      kv_block_size=4,
                      kv_hbm_blocks=eng.pool.num_usable)
        r = router.ServingRouter(("127.0.0.1", srv.port), SERVICE, conf,
                                 cache_ttl_s=0.0)
        try:
            prompt = list(range(7, 21))
            out = r.generate({"tokens": prompt, "max_new_tokens": 6})
            assert out["tokens"] == _reference_greedy(prompt, 6)
            assert r.prefill_offloaded == 1
            decoded_on = [role for role in ("decode", "mixed")
                          if engines[role].kvstore.hits["dfs"] > 0]
            assert len(decoded_on) == 1
            assert engines["decode"].tokens_generated + \
                engines["mixed"].tokens_generated >= 6
            # short prompts: each on its affinity owner
            owners = {}
            for head in range(3):
                p = [head + 1] * 5
                key = router.affinity_key(p, 64)
                owners[head] = router.rendezvous_owner(
                    key, [router.replica_path(SERVICE, n)
                          for n in ("decode", "mixed")])
                before = {n: engines[n].tokens_generated
                          for n in ("decode", "mixed")}
                out = r.generate({"tokens": p, "max_new_tokens": 3})
                assert out["tokens"] == _reference_greedy(p, 3)
                moved = [n for n in before
                         if engines[n].tokens_generated > before[n]]
                assert [router.replica_path(SERVICE, n) for n in moved] \
                    == [owners[head]]
            assert r.prefill_offloaded == 1
            # drain the mixed door: requests go to the decode replica
            threading.Thread(target=servers["mixed"].drain,
                             kwargs={"timeout": 30}).start()
            servers["mixed"]._draining.wait(10)
            before = engines["decode"].tokens_generated
            for head in range(3):
                p = [head + 1] * 5
                out = r.generate({"tokens": p, "max_new_tokens": 3})
                assert out["tokens"] == _reference_greedy(p, 3)
            assert engines["decode"].tokens_generated - before == 9
        finally:
            r.close()
    finally:
        for door in servers.values():
            door.stop()
