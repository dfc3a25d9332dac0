"""The PyTorch port's tiered KV cache against the JAX package's, on the CPU.

The block files, chain digests and salts are the reference's byte for
byte (float32 and bfloat16, ``raw`` and ``int8``), so one store serves
both packages: a store that either package's engine writes, the other's
engine maps back (``hits_dfs`` > 0) with the same tokens, on a local
directory and on a ``MiniDFSCluster`` through the filesystem seam, and a
``prefill_to_store`` handoff crosses the packages both ways. On one
scripted request sequence driven by ``step()`` the tier statistics equal
the reference engine's; demote → promote round trips are bit-exact; the
door answers ``/v1/prefill``, publishes the reference's role records and
``/prom`` tier families, and a ``hadoop_tpu`` router offloads a long
prompt to a port prefill replica. Tiny preset, float32, the same
weights; tokens are held to a full-recompute greedy loop over the JAX
``forward``.
"""

import http.client
import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.fs import LocalFileSystem as JLocalFileSystem
from hadoop_tpu.metrics import metrics_system as jmetrics_system
from hadoop_tpu.metrics.prom import render_prom as jrender_prom
from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.serving import engine as jengine
from hadoop_tpu.serving import kvstore as jkv
from hadoop_tpu.serving.metrics import ServingMetrics as JServingMetrics
from hadoop_tpu.testing.minicluster import MiniDFSCluster
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.fs import LocalFileSystem
from hadoop_tpu_torch.metrics import metrics_system, render_prom
from hadoop_tpu_torch.models import config, params_from_numpy
from hadoop_tpu_torch.serving import kvstore as kv
from hadoop_tpu_torch.serving import service
from hadoop_tpu_torch.serving.engine import DecodeEngine, SamplingParams
from hadoop_tpu_torch.serving.kvstore import codec
from hadoop_tpu_torch.serving.metrics import ServingMetrics
from hadoop_tpu_torch.serving.server import ServingServer

_REF_P = 48
_model = {}
HEAD = [5, 9, 2, 7, 1, 8, 3, 6, 4, 2, 9, 1]           # 3 full blocks of 4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to one thread: the tier-1 run shares the CPU between
    several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny():
    """(jax cfg, jax params, port cfg, port params, jitted jax forward)."""
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


_ENGINE_KW = dict(max_batch=2, block_size=4, max_context=32,
                  prefill_chunk=4)


def _port(**kw):
    m = _tiny()
    return DecodeEngine(m["params"], m["cfg"], device="cpu",
                        **{**_ENGINE_KW, **kw})


def _ref(**kw):
    m = _tiny()
    return jengine.DecodeEngine(m["jparams"], m["jcfg"],
                                **{**_ENGINE_KW, **kw})


def _run(eng, prompt, max_new=6, cls=SamplingParams):
    req = eng.submit(prompt, cls(max_new_tokens=max_new))
    while not req.done.is_set():
        eng.step()
    return req.wait(0), req


# ------------------------------------------------------------------ codec

def _payload(dtype, seed=0, shape=(2, 4, 3, 8)):
    """(reference arrays, port arrays) of one block, the same values."""
    rng = np.random.default_rng(seed)
    k = (rng.standard_normal(shape) * 3).astype(np.float32)
    v = (rng.standard_normal(shape) * 0.1).astype(np.float32)
    if dtype == "bfloat16":
        rk, rv = k.astype(ml_dtypes.bfloat16), v.astype(ml_dtypes.bfloat16)
        return (rk, rv), (rk.view(np.uint16), rv.view(np.uint16))
    return (k, v), (k, v)


def _bits(a):
    a = np.ascontiguousarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["raw", "int8"])
def test_codec_bytes_equal_the_reference_and_decode_across(dtype, name):
    (rk, rv), (pk, pv) = _payload(dtype)
    want = jkv.encode_block(rk, rv, name)
    got = kv.encode_block(pk, pv, name, dtype=dtype)
    assert got == want
    shape = rk.shape
    # the port reads the reference's file, the reference the port's
    k1, v1, hdr = kv.decode_block(want, shape=shape, dtype=dtype)
    k2, v2, _ = jkv.decode_block(got, shape=shape, dtype=rk.dtype)
    assert hdr["codec"] == name and hdr["dtype"] == dtype
    np.testing.assert_array_equal(k1, _bits(k2))
    np.testing.assert_array_equal(v1, _bits(v2))
    if name == "raw":
        np.testing.assert_array_equal(k1, pk)


@pytest.mark.parametrize("case", ["shape", "dtype", "truncated",
                                  "codec", "version"])
def test_codec_mismatch_is_loud(case):
    k = np.zeros((2, 4, 2, 4), np.float32)
    data = kv.encode_block(k, k, "raw")
    with pytest.raises(ValueError, match={"shape": "shape",
                                          "dtype": "dtype"}.get(case)):
        if case == "shape":
            kv.decode_block(data, shape=(2, 4, 2, 8), dtype=np.float32)
        elif case == "dtype":
            kv.decode_block(data, shape=(2, 4, 2, 4), dtype="bfloat16")
        elif case == "truncated":
            kv.decode_block(data[:-3], shape=(2, 4, 2, 4), dtype=np.float32)
        elif case == "codec":
            kv.encode_block(k, k, "zstd")
        else:
            kv.decode_block(data.replace(b'"v":1', b'"v":2'))


def test_bfloat16_rounding_equals_ml_dtypes():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(100_000).astype(np.float32)
                        * 1e3, np.array([np.inf, -np.inf, 0.0, -0.0,
                                         3.4e38, 1e-40], np.float32)])
    np.testing.assert_array_equal(
        codec.from_float32(x, "bfloat16"),
        x.astype(ml_dtypes.bfloat16).view(np.uint16))
    bits = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(
        codec.to_float32(bits, "bfloat16"),
        bits.view(ml_dtypes.bfloat16).astype(np.float32))


# ---------------------------------------------------------------- digests

@pytest.mark.parametrize("chunk", [(1, 2, 3, 4), (0,), (31999, 7, 7, 7)])
def test_chain_digest_equals_the_reference(chunk):
    for parent in (b"", b"salt", bytes(range(32))):
        assert kv.chain_digest(parent, chunk) == \
            jkv.chain_digest(parent, chunk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_salt_equals_the_reference(dtype):
    jdt = {"float32": np.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = jkv.TieredKVCache(jkv.BlockPool(4, 16), layers=18, kv_heads=8,
                             head_dim=128, dtype=jdt).chain_salt
    for spelled in (dtype, tdt):
        got = kv.TieredKVCache(kv.BlockPool(4, 16), layers=18, kv_heads=8,
                               head_dim=128, dtype=spelled)
        assert got.chain_salt == want == got.radix.root_digest


def test_radix_digests_matches_and_evictions_equal_the_reference():
    port, ref = kv.PrefixCache(2, salt=b"s"), jkv.PrefixCache(2, salt=b"s")
    for cache in (port, ref):
        assert cache.insert([1, 2, 3, 4], [10, 11]) == 2
        assert cache.insert([1, 2, 7, 8, 9, 9], [10, 12, 13]) == 2
    for blk in (10, 11, 12, 13):
        assert port.node_for_block(blk).digest == \
            ref.node_for_block(blk).digest
    assert [n.block for n in port.match_nodes([1, 2, 7, 8, 9, 9, 5])] == \
        [n.block for n in ref.match_nodes([1, 2, 7, 8, 9, 9, 5])]
    assert sorted(n.block for n in port.nodes()) == [10, 11, 12, 13]
    seen = {"port": [], "ref": []}
    got = port.evict(4, lambda b: 0, on_evict=lambda n: seen["port"].append(
        n.digest))
    want = ref.evict(4, lambda b: 0, on_evict=lambda n: seen["ref"].append(
        n.digest))
    assert got == want and seen["port"] == seen["ref"]
    assert len(port) == 0


# -------------------------------------------------------------- host ring

def test_host_ring_wraps_evicting_the_oldest():
    shape = (1, 2, 1, 2)
    tier = kv.HostTier(shape, np.float32, budget_bytes=3 * 2 * 4 * 4)
    assert tier.capacity == 3
    mk = lambda i: (np.full(shape, i, np.float32),
                    np.full(shape, -i, np.float32))
    for i in range(4):                       # 4 puts into 3 slots
        assert tier.put(bytes([i]), *mk(i))
    assert tier.get(bytes([0])) is None      # oldest fell off the ring
    for i in (1, 2, 3):
        k, v = tier.get(bytes([i]))
        assert float(k[0, 0, 0, 0]) == i and float(v[0, 0, 0, 0]) == -i
    assert len(tier) == 3
    k, _ = tier.get(bytes([2]))
    k[:] = 99                                # get() hands back copies
    assert float(tier.get(bytes([2]))[0][0, 0, 0, 0]) == 2
    assert kv.HostTier(shape, np.float32, budget_bytes=1).put(
        b"x", *mk(0)) is False               # budget below one block


@pytest.mark.parametrize("dtype,factor", [("float32", 3.8),
                                          ("bfloat16", 1.9)])
def test_host_ring_int8_capacity_and_payloads_equal_the_reference(dtype,
                                                                  factor):
    """int8 holds ~4× the f32 blocks (~2× bf16) in the same budget, and
    what it hands back is the reference ring's, bit for bit."""
    shape, budget = (2, 8, 2, 8), 256 * 1024
    jdt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}[dtype]
    raw = kv.HostTier(shape, dtype, budget_bytes=budget)
    q = kv.HostTier(shape, dtype, budget_bytes=budget, codec="int8")
    jq = jkv.HostTier(shape, jdt, budget_bytes=budget, codec="int8")
    assert q.capacity == jq.capacity >= factor * raw.capacity
    assert raw.capacity == jkv.HostTier(shape, jdt,
                                        budget_bytes=budget).capacity
    for i in range(3):
        (rk, rv), (pk, pv) = _payload(dtype, seed=i, shape=shape)
        q.put(bytes([i]), pk, pv)
        jq.put(bytes([i]), rk, rv)
    z = np.zeros(shape, codec.storage_dtype(dtype))
    q.put(b"z", z, z)
    for d in (b"\x00", b"\x01", b"\x02"):
        (gk, gv), (wk, wv) = q.get(d), jq.get(d)
        np.testing.assert_array_equal(gk, _bits(wk))
        np.testing.assert_array_equal(gv, _bits(wv))
    assert not q.get(b"z")[0].any()          # zeros decode to zeros
    assert {d for d, *_ in q.items()} == {b"\x00", b"\x01", b"\x02", b"z"}


def test_tiered_int8_demote_promote_allclose():
    shape = (2, 4, 2, 4)
    rng = np.random.default_rng(1)
    payload = (rng.normal(size=shape).astype(np.float32),
               rng.normal(size=shape).astype(np.float32))
    tiered = kv.TieredKVCache(kv.BlockPool(8, 4), layers=2, kv_heads=2,
                              head_dim=4, dtype=np.float32,
                              host_bytes=1 << 20, codec="int8",
                              extract=lambda blk: payload)
    tiered.radix.insert(list(range(4)), [3])
    node = tiered.radix.node_for_block(3)
    tiered.demote(node)
    got = tiered.host.get(node.digest)
    np.testing.assert_allclose(got[0], payload[0], atol=2.5 / 127 * np.abs(
        payload[0]).max())
    assert tiered.demotions == 1


# ---------------------------------------------- the engine against the ref

_PA = HEAD + [11, 12]
_PB = [77, 66, 55, 44, 33, 22, 88, 99, 12, 13, 14, 15, 1, 2]
_PC = [31, 41, 59, 26, 53, 58, 97, 93, 23, 84, 62, 64, 1, 2]
# pa turns hot and persists, pb and pc flood it out of HBM (demoting it
# through the ring), pb comes back from HBM and the ring, pa from the DFS
SEQUENCE = [_PA, _PA, _PB, _PC, _PB, _PA]


def _tier_families(text):
    out = set()
    for line in text.splitlines():
        if line.startswith(("htpu_kv_hits", "htpu_kv_demotions",
                            "htpu_kv_promotions", "htpu_kv_dfs_persists",
                            "htpu_kv_fetch_seconds")):
            name, _, labels = line.split(" ")[0].partition("{")
            out.add((name, tuple(sorted(
                p for p in labels.rstrip("}").split(",")
                if p and not p.startswith("source=")))))
    return out


def test_tier_stats_equal_the_reference_on_a_scripted_sequence(tmp_path):
    """Both engines: a pool of 7 pages, a host ring of 2 blocks, a DFS
    store with min-refs 1. A hot prefix persists, floods demote it, the
    ring wraps, and its re-admission recovers blocks from host and DFS;
    every tier counter and the tokens equal the reference's, and the
    /prom tier families are the reference's."""
    cfg = _tiny()["cfg"]                   # K and V of one f32 page
    block = 2 * cfg.n_layers * 4 * cfg.n_kv_heads * cfg.head_dim * 4
    kw = dict(num_blocks=8, kv_host_bytes=2 * block, kv_dfs_min_refs=1)
    port = _port(kv_store_fs=LocalFileSystem(),
                 kv_store_dir=f"{tmp_path}/port", metrics=ServingMetrics(),
                 **kw)
    ref = _ref(kv_store_fs=JLocalFileSystem(),
               kv_store_dir=f"{tmp_path}/ref", metrics=JServingMetrics(),
               **kw)
    assert port.kvstore.host.capacity == ref.kvstore.host.capacity == 2
    for i, prompt in enumerate(SEQUENCE):
        got, _ = _run(port, prompt)
        want, _ = _run(ref, prompt, cls=jengine.SamplingParams)
        assert got == want == _reference_greedy(prompt, 6), i
        assert port.kvstore.flush(30.0) and ref.kvstore.flush(30.0)
        assert port.kvstore.stats() == ref.kvstore.stats(), i
    stats = port.kvstore.stats()
    for key in ("hits_hbm", "hits_host", "hits_dfs", "demotions",
                "promotions", "dfs_persists"):
        assert stats[key] > 0, key
    assert port.cache_stats() == ref.cache_stats()
    assert _tier_families(render_prom(metrics_system())) >= \
        _tier_families(jrender_prom(jmetrics_system())) != set()


def test_demote_promote_round_trip_is_bit_exact():
    """A prompt whose cached blocks were evicted HBM → host ring and
    recovered at re-admission decodes exactly as cold, from host hits."""
    pa = _PA
    ref = _reference_greedy(pa, 6)
    eng = _port(num_blocks=8, kv_host_bytes=1 << 30)
    assert _run(eng, pa)[0] == ref
    for flood in (_PB, _PC):
        _run(eng, flood)
    assert eng.kvstore.demotions >= 3
    assert eng.prefix_cache.match(pa) == []
    got, req = _run(eng, pa)
    assert got == ref
    assert eng.kvstore.hits["host"] >= 3
    assert req.prefix_tokens_reused >= 12


def test_only_zero_ref_pages_demote_under_active_decode():
    eng = _port(num_blocks=8, kv_host_bytes=1 << 30)
    a = eng.submit([1, 2, 3, 4], SamplingParams(max_new_tokens=20))
    b = eng.submit([9, 9, 9, 9], SamplingParams(max_new_tokens=16))
    while not (a.done.is_set() and b.done.is_set()):
        eng.step()
        for req in eng._slots:
            if req is not None:
                assert all(eng.pool.refcount(blk) >= 1
                           for blk in req._blocks)
    assert a.wait(0) == _reference_greedy([1, 2, 3, 4], 20)
    assert b.wait(0) == _reference_greedy([9, 9, 9, 9], 16)


def test_fetch_and_eviction_interleave_safely():
    """Each re-admission recovers its head from the ring while its own
    allocation evicts (and demotes) the other prompt's cache."""
    pa, pb = _PA, _PB
    ra, rb = _reference_greedy(pa, 6), _reference_greedy(pb, 6)
    eng = _port(max_batch=1, num_blocks=8, kv_host_bytes=1 << 30)
    for _ in range(4):
        assert _run(eng, pa)[0] == ra
        assert _run(eng, pb)[0] == rb
    assert eng.kvstore.hits["host"] >= 6
    assert eng.kvstore.demotions >= 6


def test_dfs_min_refs_threshold(tmp_path):
    eng = _port(kv_store_fs=LocalFileSystem(), kv_store_dir=f"{tmp_path}/kv",
                kv_dfs_min_refs=2)
    pa = HEAD[:8] + [11]                           # 2 full blocks
    for expect in (0, 0, 2):         # cold, hits=1, hits=2 -> persist
        _run(eng, pa, max_new=4)
        assert eng.kvstore.flush(30.0)
        assert eng.kvstore.stats()["dfs_persists"] == expect


# ------------------------------------------------- one store, two packages

def _shared_store_both_ways(port_fs, ref_fs, root):
    """The reference engine persists one hot prefix and the port's fresh
    engine maps it from the store; the port persists another and the
    reference engine, which never saw it, maps it."""
    pa, pb = _PA, _PB
    ref = _ref(kv_store_fs=ref_fs, kv_store_dir=root)
    for _ in range(2):                             # cold, then hot
        _run(ref, pa, cls=jengine.SamplingParams)
    assert ref.kvstore.flush(30.0)
    assert ref.kvstore.stats()["dfs_persists"] == 3
    port = _port(kv_store_fs=port_fs, kv_store_dir=root)
    got, req = _run(port, pa)
    assert got == _reference_greedy(pa, 6)
    assert port.kvstore.hits["dfs"] == 3 and req.prefix_tokens_reused == 12

    writer = _port(kv_store_fs=port_fs, kv_store_dir=root)
    for _ in range(2):
        _run(writer, pb)
    assert writer.kvstore.flush(30.0)
    assert writer.kvstore.stats()["dfs_persists"] == 3
    got, req = _run(ref, pb, cls=jengine.SamplingParams)
    assert got == _reference_greedy(pb, 6)
    assert ref.kvstore.hits["dfs"] == 3 and req.prefix_tokens_reused == 12


def test_store_on_a_local_dir_is_shared_across_the_packages(tmp_path):
    _shared_store_both_ways(LocalFileSystem(), JLocalFileSystem(),
                            f"{tmp_path}/kvcache")


def test_store_on_a_minidfs_is_shared_across_the_packages():
    with MiniDFSCluster(num_datanodes=1) as cluster:
        fs = cluster.get_filesystem()
        _shared_store_both_ways(fs, fs, "/kvcache")


def test_prefill_to_store_handoff_crosses_the_packages(tmp_path):
    """prefill_to_store on one package's engine, decode on the other's:
    the decode maps the whole full-block span from the store and emits
    the tokens of a single-replica decode, both ways."""
    root = f"{tmp_path}/kvcache"
    pa, pb = list(range(7, 21)), list(range(30, 44))    # 3 full blocks
    ref = _ref(kv_store_fs=JLocalFileSystem(), kv_store_dir=root,
               max_context=48)
    port = _port(kv_store_fs=LocalFileSystem(), kv_store_dir=root,
                 max_context=48)
    assert ref.prefill_to_store(pa) == 12
    got, req = _run(port, pa, max_new=8)
    assert got == _reference_greedy(pa, 8)
    assert port.kvstore.hits["dfs"] == 3 and req.prefix_tokens_reused == 12
    assert port.prefill_to_store(pb) == 12
    got, req = _run(ref, pb, max_new=8, cls=jengine.SamplingParams)
    assert got == _reference_greedy(pb, 8)
    assert ref.kvstore.hits["dfs"] == 3
    with pytest.raises(ValueError, match="DFS"):
        _port().prefill_to_store(pa)


def test_drain_persist_is_hit_by_a_fresh_engine(tmp_path):
    """stop(drain=True) ships every resident prefix (HBM radix and host
    ring) to the store; a fresh engine maps them instead of prefilling."""
    root = f"{tmp_path}/kvcache"
    pa = HEAD + [11, 12]
    eng = _port(kv_store_fs=LocalFileSystem(), kv_store_dir=root,
                kv_host_bytes=1 << 20, kv_dfs_min_refs=5)
    eng.start()
    assert eng.submit(pa, SamplingParams(max_new_tokens=6)).wait(30) == \
        _reference_greedy(pa, 6)
    assert eng.kvstore.stats()["dfs_persists"] == 0   # never hot enough
    eng.stop(drain=True, timeout=30)
    assert eng.kvstore.stats()["dfs_persists"] >= 3
    fresh = _port(kv_store_fs=LocalFileSystem(), kv_store_dir=root)
    got, req = _run(fresh, pa)
    assert got == _reference_greedy(pa, 6)
    assert fresh.kvstore.hits["dfs"] == 3


# ------------------------------------------------------------------- door

def _post(port, path, payload):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request("POST", path, body=json.dumps(payload).encode())
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"{}")
    finally:
        conn.close()


def test_prefill_door_persists_and_400_without_a_dfs_tier(tmp_path):
    conf = Configuration(load_defaults=False)
    eng = _port(kv_store_fs=LocalFileSystem(), kv_store_dir=f"{tmp_path}/kv",
                max_context=48, metrics=ServingMetrics())
    plain = _port(max_context=48)
    servers = [ServingServer(eng, conf), ServingServer(plain, conf)]
    for e, s in zip((eng, plain), servers):
        e.start()
        s.start()
    try:
        status, body = _post(servers[0].port, "/v1/prefill",
                             {"tokens": list(range(7, 21))})
        assert status == 200, body
        assert body == {"persisted_tokens": 12, "prompt_tokens": 14}
        status, body = _post(servers[1].port, "/v1/prefill",
                             {"tokens": [1, 2, 3]})
        assert status == 400, body
    finally:
        for s in servers:
            s.stop()


_RECORD_KEYS = ("role", "kv_host_bytes", "kv_dfs", "kv_block_bytes",
                "kv_block_size", "kv_hbm_blocks", "slots", "state")


@pytest.mark.parametrize("role,host", [("prefill", "0"),
                                       ("decode", "1048576"),
                                       ("mixed", "0")])
def test_role_records_equal_the_reference(tmp_path, role, host):
    """The registry record of a port replica and a reference replica with
    the same conf carry the same role and tier fields."""
    from hadoop_tpu.parallel.checkpoint import save_checkpoint as jsave
    from hadoop_tpu.registry import RegistryClient, RegistryServer
    from hadoop_tpu.serving.service import ServingReplica as JReplica
    m = _tiny()
    jsave(JLocalFileSystem(), f"{tmp_path}/ckpt", 1,
          {"params": m["jparams"]})
    keys = {"serving.role": role, "serving.kv.host.bytes": host,
            "serving.kv.block.size": "4", "serving.max.context": "32",
            "serving.kv.dfs.dir": f"{tmp_path}/kv"}
    jconf = JConfiguration(load_defaults=False)
    conf = Configuration(load_defaults=False)
    for key, value in keys.items():
        jconf.set(key, value)
        conf.set(key, value)
    reg_srv = RegistryServer(jconf)
    reg_srv.init(jconf)
    reg_srv.start()
    replicas = []
    try:
        addr = ("127.0.0.1", reg_srv.port)
        replicas.append(service.ServingReplica(
            conf, name="port", checkpoint=f"file://{tmp_path}/ckpt",
            preset="tiny", registry=RegistryClient(addr, jconf),
            instance="p0", device="cpu"))
        replicas.append(JReplica(
            jconf, name="ref", checkpoint=f"file://{tmp_path}/ckpt",
            preset="tiny", registry_addr=addr, instance="r0"))
        for r in replicas:
            r.start()
        got, want = (r.record.attributes for r in replicas)
        assert {k: got[k] for k in _RECORD_KEYS} == \
            {k: want[k] for k in _RECORD_KEYS}
        assert got["role"] == role
        assert got["kv_dfs"] == ("0" if role == "mixed" else "1")
    finally:
        for r in replicas:
            r.drain_and_stop(timeout=15)
        reg_srv.stop()


def test_reference_router_offloads_a_long_prompt_to_a_port_prefill_replica(
        tmp_path):
    """A ``hadoop_tpu`` router ships a long prompt to the port's prefill
    replica, then decodes it on the port's decode replica, which maps the
    handoff from the store; a short prompt skips the handoff."""
    from hadoop_tpu.registry import (RegistryClient, RegistryServer,
                                     ServiceRecord)
    from hadoop_tpu.serving.router import ServingRouter, replica_path
    conf = JConfiguration(load_defaults=False)
    conf.set("serving.router.prefill.min.tokens", "12")
    reg_srv = RegistryServer(conf)
    reg_srv.init(conf)
    reg_srv.start()
    engines, servers = [], []
    try:
        for _ in range(2):
            eng = _port(kv_store_fs=LocalFileSystem(),
                        kv_store_dir=f"{tmp_path}/kvcache", max_context=48)
            srv = ServingServer(eng, Configuration(load_defaults=False))
            eng.start()
            srv.start()
            engines.append(eng)
            servers.append(srv)
        addr = ("127.0.0.1", reg_srv.port)
        rc = RegistryClient(addr, conf)
        for i, role in enumerate(("prefill", "decode")):
            rc.register(ServiceRecord(
                replica_path("disagg", f"r{i}"),
                {"http": f"127.0.0.1:{servers[i].port}"},
                {"state": "serving", "role": role}),
                ttl_s=30.0, auto_renew=False)
        router = ServingRouter(addr, "disagg", conf, cache_ttl_s=0.0)
        prompt = list(range(7, 21))
        out = router.generate({"tokens": prompt, "max_new_tokens": 6})
        assert out["tokens"] == _reference_greedy(prompt, 6)
        assert router.prefill_offloaded == 1
        assert engines[1].kvstore.hits["dfs"] == 3
        assert engines[1].tokens_generated >= 6
        out = router.generate({"tokens": [3, 4, 5], "max_new_tokens": 4})
        assert out["tokens"] == _reference_greedy([3, 4, 5], 4)
        assert router.prefill_offloaded == 1
        router.close()
        rc.close()
    finally:
        for srv in servers:
            srv.stop()
        reg_srv.stop()


def test_health_carries_the_tier_and_speculation_blocks(tmp_path):
    eng = _port(kv_store_fs=LocalFileSystem(), kv_store_dir=f"{tmp_path}/kv",
                kv_host_bytes=1 << 20, speculate_k=2)
    ref = _ref(kv_store_fs=JLocalFileSystem(), kv_store_dir=f"{tmp_path}/j",
               kv_host_bytes=1 << 20, speculate_k=2)
    srv = ServingServer(eng, Configuration(load_defaults=False))
    srv.start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", srv.port, timeout=60)
        conn.request("GET", "/v1/health")
        health = json.loads(conn.getresponse().read())
        conn.close()
    finally:
        srv.stop()
    cache = health["prefix_cache"]
    want = ref.cache_stats()
    assert cache["tiers"] == want["tiers"]
    assert cache["speculate"] == want["speculate"]
    assert cache["tiers"]["host_enabled"] and cache["tiers"]["dfs_enabled"]


# ------------------------------------------------- chain ingest and fetch

def _bare(fetch_window=4, host_bytes=0):
    return kv.TieredKVCache(kv.BlockPool(4, 4), layers=1, kv_heads=1,
                            head_dim=2, dtype=np.float32,
                            host_bytes=host_bytes, fetch_window=fetch_window)


def _chain_payload(i):
    k = np.full((1, 4, 1, 2), float(i), np.float32)
    return k, -k


def test_ingest_chain_round_trips_and_keys_as_the_reference():
    tiered = _bare(host_bytes=1 << 20)
    ref = jkv.TieredKVCache(jkv.BlockPool(4, 4), layers=1, kv_heads=1,
                            head_dim=2, dtype=np.float32,
                            host_bytes=1 << 20)
    tokens = list(range(40))                      # 10 full blocks
    assert tiered.ingest_chain(tokens, (_chain_payload(i)
                                        for i in range(10))) == 10
    ref.ingest_chain(tokens, (_chain_payload(i) for i in range(10)))
    assert tiered.stats()["chain_ingested"] == 10
    hits = tiered.read_chain(tokens, 10)
    assert [h.digest for h in hits] == \
        [h.digest for h in ref.read_chain(tokens, 10)]
    for i, h in enumerate(hits):
        np.testing.assert_array_equal(h.k, _chain_payload(i)[0])
    assert tiered.hits["host"] == 10
    assert tiered.read_chain([9] * 40, 10) == []


class _CountingDFS:
    def __init__(self, store):
        self.store = store
        self.reads = 0

    def get(self, digest):
        self.reads += 1
        return self.store.get(digest)


@pytest.mark.parametrize("window,rounds", [(50, 20), (1, 1000)])
def test_fetch_window_reads_a_chain_in_window_round_trips(window, rounds):
    chain = 1000
    tokens = list(range(chain * 4))
    tiered = _bare(fetch_window=window)
    store, digest = {}, tiered.chain_salt
    for i in range(chain):
        digest = kv.chain_digest(digest, tuple(tokens[i * 4:(i + 1) * 4]))
        store[digest] = _chain_payload(1)
    tiered.dfs = _CountingDFS(store)
    reads = []
    real = tiered._dfs_read_window
    tiered._dfs_read_window = lambda d, i: reads.append(i) or real(d, i)
    assert len(tiered.read_chain(tokens, chain)) == chain
    assert len(reads) == rounds and tiered.dfs.reads == chain


def test_conf_keys_reach_the_tiers(tmp_path):
    eng = _port(kv_host_bytes=1 << 20, kv_fetch_window=17, kv_codec="int8")
    assert eng.kvstore.fetch_window == 17
    assert eng.kvstore.stats()["fetch_window"] == 17
    assert eng.kvstore.host.codec == "int8"
    with pytest.raises(ValueError, match="codec"):
        _port(kv_codec="zstd")
