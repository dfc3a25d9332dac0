"""The PyTorch port's long-context plane and working-set decoder against
the JAX package's, on the CPU.

The cases of ``tests/test_longctx.py`` that cover the plane and the
decoder, run across the two packages on the same numpy-seeded float32
weights (``params_from_numpy``): the port's greedy tokens must equal the
reference plane's and decoders' (the JAX side on the virtual CPU mesh,
its flash partials at ``interpret=True``), a repeated single-device
forward's, and each other's on the pipelined and the legacy path. The
JAX side runs once per module (``ref``); the port's cases each run their
own engine and plane.
"""

import jax
import numpy as np
import pytest
import torch

import hadoop_tpu.ops.flash as jflash
from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.serving import engine as jengine
from hadoop_tpu.serving import longctx as jlongctx
from hadoop_tpu.serving import weightplane as jwp
from hadoop_tpu.serving.longctx import decode as jdecode
from hadoop_tpu.serving.metrics import ServingMetrics as JServingMetrics
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.models import config, decoder, params_from_numpy
from hadoop_tpu_torch.obs.hbm import hbm_ledger
from hadoop_tpu_torch.serving import longctx, weightplane
from hadoop_tpu_torch.serving.engine import DecodeEngine, SamplingParams
from hadoop_tpu_torch.serving.longctx import decode
from hadoop_tpu_torch.serving.metrics import ServingMetrics
from hadoop_tpu_torch.serving.server import ServingServer

PROMPT, SHORT = 150, 20
ENGINE_KW = dict(max_batch=2, block_size=8, max_context=64,
                 prefill_chunk=8, device="cpu")
PLANE_KW = dict(min_tokens=100, max_tokens=256, sp=4, window_blocks=3,
                tail_tokens=64)
WP = dict(tier="relaxed", quant_embed=True, quant_head=True)
_model = {}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to one thread: the tier-1 run shares the CPU between
    several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny():
    """(jax cfg, jax params, port cfg, port params), tiny at max_seq 512
    as the reference's tests take it."""
    if not _model:
        jcfg = jconfig.get_config("tiny", max_seq=512)
        jparams = jdecoder.init_params(jax.random.PRNGKey(0), jcfg)
        cfg = config.get_config("tiny", max_seq=512)
        params = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
        _model.update(jcfg=jcfg, jparams=jparams, cfg=cfg, params=params)
    return _model


def _prompt(n, seed=1):
    return np.random.default_rng(seed).integers(0, 256, size=n).tolist()


def _greedy(params, cfg, prompt, n):
    """The port's single-device forward, recomputed for every token."""
    ctx, out = list(prompt), []
    for _ in range(n):
        lg = decoder.forward(params, [ctx], cfg, device="cpu")[0, -1]
        out.append(int(torch.argmax(lg)))
        ctx.append(out[-1])
    return out


def _engine(**kw):
    m = _tiny()
    kw = {**ENGINE_KW, "kv_host_bytes": 1 << 22,
          "metrics": ServingMetrics(), **kw}
    return DecodeEngine(m["params"], m["cfg"], **kw)


def _plane(eng, params=None, **kw):
    m = _tiny()
    kw = {**PLANE_KW, "block_size": eng.block_size, "metrics": eng.metrics,
          "devices": ["cpu"], **kw}
    return longctx.LongContextPlane(
        m["params"] if params is None else params, m["cfg"], eng.kvstore,
        **kw)


def _prefill_chain(params, cfg, eng, prompt):
    """CP prefill at sp 1 and the chain streamed into ``eng``'s tiers:
    the decoder cases' shared setup."""
    pre = longctx.ContextParallelPrefiller(params, cfg, block_size=8,
                                           pad_tokens=160, sp=1,
                                           devices=["cpu"])
    res = pre.cp_prefill(prompt)
    eng.kvstore.ingest_chain(prompt, ((k.numpy(), v.numpy())
                                      for k, v in res.blocks))
    return res


def _decode(params, cfg, eng, prompt, res, sampling, **kw):
    dec = decode.WorkingSetDecoder(params, cfg, eng.kvstore, block_size=8,
                                   window_blocks=3, tail_tokens=64, **kw)
    out = []
    dec.paged_decode(prompt, int(np.argmax(res.last_logits)), sampling,
                     tail_k=res.tail_k, tail_v=res.tail_v,
                     deliver=out.append, seed=11,
                     rng=np.random.default_rng(11))
    return out, dec


# ------------------------------------------------- the reference, once

def _jprefill_chain(jparams, jcfg, jeng, prompt):
    pre = jlongctx.ContextParallelPrefiller(jparams, jcfg, block_size=8,
                                            pad_tokens=160, sp=1)
    res = pre.cp_prefill(prompt)
    jeng.kvstore.ingest_chain(prompt, res.blocks)
    return res


def _jdecode(jparams, jcfg, jeng, prompt, res, sampling, **kw):
    dec = jdecode.WorkingSetDecoder(jparams, jcfg, jeng.kvstore,
                                    block_size=8, window_blocks=3,
                                    tail_tokens=64, **kw)
    out = []
    dec.paged_decode(prompt, int(np.argmax(res.last_logits)), sampling,
                     tail_k=res.tail_k, tail_v=res.tail_v,
                     deliver=out.append, seed=11,
                     rng=np.random.default_rng(11))
    return out


@pytest.fixture(scope="module")
def ref():
    """The JAX package's tokens: its plane end to end at sp 4 (its flash
    partials in interpret mode), and its decoders on an sp 1 chain,
    greedy on both paths and stochastic on the host sampler, and on the
    int8 plane."""
    m = _tiny()
    jcfg, jparams = m["jcfg"], m["jparams"]
    real = jflash.flash_attention_partial
    jflash.flash_attention_partial = \
        lambda q, k, v, scale, causal, interpret=False: real(
            q, k, v, scale, causal, True)
    out = {}
    try:
        jeng = jengine.DecodeEngine(jparams, jcfg, max_batch=2,
                                    block_size=8, max_context=64,
                                    prefill_chunk=8, kv_host_bytes=1 << 22,
                                    metrics=JServingMetrics())
        plane = jlongctx.LongContextPlane(
            jparams, jcfg, jeng.kvstore, block_size=8,
            metrics=jeng.metrics, **PLANE_KW)
        jeng.attach_longctx(plane)
        prompt = _prompt(PROMPT)
        out["plane"] = jeng.submit(
            prompt, jengine.SamplingParams(max_new_tokens=6)).wait(300)
        jeng.stop()
        jeng = jengine.DecodeEngine(jparams, jcfg, max_batch=2,
                                    block_size=8, max_context=64,
                                    kv_host_bytes=1 << 22,
                                    metrics=JServingMetrics())
        res = _jprefill_chain(jparams, jcfg, jeng, prompt)
        greedy = jengine.SamplingParams(max_new_tokens=6)
        sampled = jengine.SamplingParams(max_new_tokens=6,
                                         temperature=0.8, top_k=5)
        out["legacy"] = _jdecode(jparams, jcfg, jeng, prompt, res, greedy,
                                 pipeline=False)
        out["fused"] = _jdecode(jparams, jcfg, jeng, prompt, res, greedy)
        out["sampled"] = _jdecode(jparams, jcfg, jeng, prompt, res,
                                  sampled, sampler="host")
        jeng.stop()
        qparams, _ = jwp.quantize_params(jparams, jcfg,
                                         jwp.WeightPlaneConfig(**WP))
        jeng = jengine.DecodeEngine(jparams, jcfg, max_batch=2,
                                    block_size=8, max_context=64,
                                    kv_host_bytes=1 << 22,
                                    metrics=JServingMetrics())
        res = _jprefill_chain(qparams, jcfg, jeng, prompt)
        out["int8"] = _jdecode(qparams, jcfg, jeng, prompt, res,
                               jengine.SamplingParams(max_new_tokens=4))
        jeng.stop()
    finally:
        jflash.flash_attention_partial = real
    return out


# ------------------------------------------------------------ end to end

def test_longctx_end_to_end_matches_single_device_and_jax(ref):
    """The whole lane: submit through the engine, CP prefill at sp 4,
    the KV streamed to the host ring, working-set decode: greedy tokens
    equal a repeated single-device forward's and the JAX plane's."""
    m = _tiny()
    eng = _engine()
    plane = _plane(eng)
    eng.attach_longctx(plane)
    try:
        prompt = _prompt(PROMPT)
        toks = eng.submit(prompt, SamplingParams(max_new_tokens=6)).wait(180)
        assert toks == _greedy(m["params"], m["cfg"], prompt, 6)
        assert toks == ref["plane"]
        assert eng.steps == 0          # the plane served it, not the step
        st = plane.stats()
        assert st["requests"] == 1
        assert st["blocks_streamed"] == len(prompt) // 8
        kv = eng.kvstore.stats()
        assert kv["chain_ingested"] == len(prompt) // 8
        assert kv["hits_host"] >= len(prompt) // 8
        cfg = m["cfg"]
        full_ctx_bytes = (len(prompt) * 2 * cfg.n_layers * cfg.n_kv_heads
                          * cfg.head_dim * 4)
        assert plane.decoder.hbm_working_set_bytes < full_ctx_bytes
        assert st["window_fetches"] > 0
    finally:
        eng.stop()


def test_streamed_chain_feeds_the_radix_path():
    """A short prompt that prefixes a served long one maps the streamed
    chain through the engine's radix admission (cold promotions): one
    digest scheme, two consumers."""
    m = _tiny()
    eng = _engine()
    eng.attach_longctx(_plane(eng))
    try:
        prompt = _prompt(PROMPT)
        eng.submit(prompt, SamplingParams(max_new_tokens=2)).wait(180)
        short = prompt[:24]
        req = eng.submit(short, SamplingParams(max_new_tokens=3))
        while not req.done.is_set():
            eng.step()
        assert req.wait(0) == _greedy(m["params"], m["cfg"], short, 3)
        assert eng.kvstore.promotions > 0
    finally:
        eng.stop()


def test_short_prompts_keep_the_fused_step():
    """Below min_tokens a request rides the fused step as before (one
    shape each); at or above it the plane serves without the step."""
    m = _tiny()
    eng = _engine(kv_host_bytes=1 << 20)
    eng.attach_longctx(_plane(eng, min_tokens=100))
    try:
        short = _prompt(SHORT)
        req = eng.submit(short, SamplingParams(max_new_tokens=3))
        while not req.done.is_set():
            eng.step()
        assert req.wait(0) == _greedy(m["params"], m["cfg"], short, 3)
        assert (eng.decode_compiles, eng.prefill_compiles) == (1, 1)
        eng.submit(_prompt(120), SamplingParams(max_new_tokens=2)).wait(180)
        assert (eng.decode_compiles, eng.prefill_compiles) == (1, 1)
    finally:
        eng.stop()


def test_engine_drain_finishes_longctx_request():
    eng = _engine(kv_host_bytes=1 << 20)
    eng.attach_longctx(_plane(eng))
    req = eng.submit(_prompt(120), SamplingParams(max_new_tokens=2))
    eng.stop(drain=True, timeout=180.0)
    assert req.done.is_set()
    assert req.state == "FINISHED"
    assert len(req.out_tokens) == 2


# ---------------------------------------------------- the two decoders

def test_pipelined_decode_is_token_identical_to_legacy(ref):
    """The pipelined path against the legacy loop on one chain and tail:
    the same greedy tokens on the device and host samplers, the same
    stochastic tokens on the host sampler (one numpy stream), each equal
    to the JAX decoders'. And the budgets: dispatches per token at most
    2 per window + 1, one transfer per (layer, slab) on the pipelined
    path against one per (layer, window) on the legacy loop."""
    m = _tiny()
    params, cfg = m["params"], m["cfg"]
    eng = _engine()
    try:
        prompt = _prompt(PROMPT)
        res = _prefill_chain(params, cfg, eng, prompt)
        greedy = SamplingParams(max_new_tokens=6)
        legacy, dl = _decode(params, cfg, eng, prompt, res, greedy,
                             pipeline=False)
        fused, df = _decode(params, cfg, eng, prompt, res, greedy)
        host, _ = _decode(params, cfg, eng, prompt, res, greedy,
                          sampler="host")
        assert fused == legacy == host and len(fused) == 5
        assert legacy == ref["legacy"] and fused == ref["fused"]
        sp = SamplingParams(max_new_tokens=6, temperature=0.8, top_k=5)
        a, _ = _decode(params, cfg, eng, prompt, res, sp, pipeline=False)
        b, _ = _decode(params, cfg, eng, prompt, res, sp, sampler="host")
        assert a == b == ref["sampled"]
        chain = (len(prompt) // 8) * 8
        n_win = -(-chain // df.win)
        assert df.dispatches_per_token <= 2 * n_win + 1
        assert df.dispatches < dl.dispatches
        n_slabs = -(-chain // (df.fetch_windows * df.win))
        assert df.dispatches == 5 * (cfg.n_layers * n_slabs
                                     + cfg.n_layers + 1)
        assert df.window_fetches == cfg.n_layers * n_slabs * 5
        assert dl.window_fetches == cfg.n_layers * n_win * 5
        assert df.window_fetches < dl.window_fetches
    finally:
        eng.stop()


def test_fused_family_runs_one_shape_across_tokens():
    """The fixed shapes: a multi-token decode, across two decoder
    instances and both samplers, runs each of fstart/fadvance/fwin/
    ffinish/fhead at one input shape (the reference's one trace per
    family)."""
    m = _tiny()
    params, cfg = m["params"], m["cfg"]
    eng = _engine()
    try:
        prompt = _prompt(PROMPT)
        res = _prefill_chain(params, cfg, eng, prompt)
        greedy = SamplingParams(max_new_tokens=5)
        _, dec = _decode(params, cfg, eng, prompt, res, greedy)
        _decode(params, cfg, eng, prompt, res, greedy, sampler="host")
        tc = decode.trace_counts()
        for piece in ("fstart", "fadvance", "fwin", "ffinish", "fhead"):
            assert tc[f"{piece}@{dec.family}"] == 1, (piece, tc)
        assert decode.dispatch_counts()[f"fwin@{dec.family}"] >= \
            dec.window_fetches
    finally:
        eng.stop()


def test_int8_longctx_serves_and_guard_accepts(ref):
    """The int8 plane served straight off the quantized tree: greedy
    tokens equal a forward over its dequantized reconstruction and the
    JAX int8 decoder's, the weight A-B guard accepts it and rejects a
    zeroed payload, and the legacy loop refuses it."""
    m = _tiny()
    params, cfg = m["params"], m["cfg"]
    wp = weightplane.WeightPlaneConfig(**WP)
    qparams, rep = weightplane.quantize_params(params, cfg, wp)
    assert rep["leaves_quantized"] > 0
    assert weightplane.run_weight_ab(cfg, params, qparams, wp=wp,
                                     device="cpu")["accepted"]
    eng = _engine()
    plane = _plane(eng, params=qparams, sp=1)
    try:
        prompt = _prompt(PROMPT)
        toks = plane.longctx_submit(
            prompt, SamplingParams(max_new_tokens=4)).wait(180)
        assert toks == _greedy(weightplane.dequantize_params(qparams, cfg),
                               cfg, prompt, 4)
        res = _prefill_chain(qparams, cfg, eng, prompt)
        dec_toks, _ = _decode(qparams, cfg, eng, prompt, res,
                              SamplingParams(max_new_tokens=4))
        assert [toks[0]] + dec_toks == [toks[0]] + ref["int8"]
        st = plane.stats()
        assert st["int8_weights"] is True
        assert st["dequantized_view_bytes"] == 0
    finally:
        plane.stop()
        eng.stop()
    broken = dict(qparams)
    broken["layers"] = dict(qparams["layers"])
    wq = qparams["layers"]["wq"]
    broken["layers"]["wq"] = {"q": torch.zeros_like(wq["q"]), "s": wq["s"]}
    assert not weightplane.run_weight_ab(cfg, params, broken, wp=wp,
                                         device="cpu")["accepted"]
    with pytest.raises(ValueError, match="pipeline"):
        decode.WorkingSetDecoder(qparams, cfg, eng.kvstore, block_size=8,
                                 pipeline=False)


# ---------------------------------------------------------- accounting

def test_hbm_ledger_reflects_decode_double_buffer():
    """The ledger's window component is both slabs of the double buffer
    (2 windows at the default slab depth), the device sampler registers
    its state, /v1/health carries the same split, and stop() unregisters
    every owner. The legacy loop keeps one window and no sampler."""
    m = _tiny()
    eng = _engine(kv_host_bytes=1 << 20)
    plane = _plane(eng, sp=1)
    eng.attach_longctx(plane)
    try:
        dec = plane.decoder
        assert dec.fetch_windows == m["cfg"].n_layers
        assert dec.hbm_window_bytes == 2 * dec.win * dec._per_tok_bytes
        assert dec.hbm_working_set_bytes == (
            dec.hbm_window_bytes + dec.tail_cap * dec._per_tok_bytes
            + dec.sampler_state_bytes)
        comps = hbm_ledger().report()["components"]
        assert comps["longctx_window"] == dec.hbm_window_bytes
        assert comps["longctx_tail"] == dec.tail_cap * dec._per_tok_bytes
        assert comps["longctx_sampler"] == dec.sampler_state_bytes > 0
        srv = ServingServer(eng, Configuration(load_defaults=False))
        _, health = srv._health({}, b"")
        assert health["hbm"]["components"]["longctx_window"] == \
            dec.hbm_window_bytes
        dl = decode.WorkingSetDecoder(m["params"], m["cfg"], eng.kvstore,
                                      block_size=8, window_blocks=3,
                                      tail_tokens=64, pipeline=False)
        assert dl.hbm_window_bytes == dl.win * dl._per_tok_bytes
        assert dl.sampler_state_bytes == 0
    finally:
        eng.stop()
    comps = hbm_ledger().report()["components"]
    assert "longctx_window" not in comps
    assert "longctx_sampler" not in comps


def test_decoder_accounting_matches_jax():
    """Window, slab, tail and working-set bytes and the slab depth equal
    the reference decoder's on the same layout (the sampler's device
    state differs by design: the port keeps the int64 token, the
    reference a key and an int32)."""
    m = _tiny()
    eng = _engine()
    jeng = jengine.DecodeEngine(m["jparams"], m["jcfg"], max_batch=2,
                                block_size=8, max_context=64,
                                kv_host_bytes=1 << 22)
    try:
        for kw in (dict(), dict(pipeline=False), dict(fetch_windows=2)):
            a = decode.WorkingSetDecoder(m["params"], m["cfg"], eng.kvstore,
                                         block_size=8, window_blocks=3,
                                         tail_tokens=64, **kw)
            b = jdecode.WorkingSetDecoder(m["jparams"], m["jcfg"],
                                          jeng.kvstore, block_size=8,
                                          window_blocks=3, tail_tokens=64,
                                          **kw)
            for name in ("win", "tail_cap", "fetch_windows",
                         "_per_tok_bytes", "slab_bytes", "hbm_window_bytes"):
                assert getattr(a, name) == getattr(b, name), (kw, name)
            assert a.hbm_working_set_bytes - a.sampler_state_bytes == \
                b.hbm_working_set_bytes - b.sampler_state_bytes
    finally:
        eng.stop()
        jeng.stop()


def test_host_sample_matches_jax():
    """The host sampler draws what the reference's draws from one numpy
    stream: greedy, top-k and plain temperature."""
    logits = np.random.default_rng(3).standard_normal(256).astype(
        np.float32)
    for temp, topk in ((0.0, 0), (0.8, 5), (1.3, 0)):
        a = [decode._host_sample(logits, temp, topk,
                                 np.random.default_rng(7)) for _ in range(3)]
        b = [jdecode._host_sample(logits, temp, topk,
                                  np.random.default_rng(7)) for _ in range(3)]
        assert a == b


# ------------------------------------------------------------- the conf

def test_plane_from_conf_reads_decode_pipeline_keys():
    m = _tiny()
    eng = _engine(kv_host_bytes=1 << 20)
    try:
        conf = Configuration(load_defaults=False)
        conf.set("serving.parity", "relaxed")
        conf.set("serving.longctx.min.tokens", "100")
        conf.set("serving.longctx.chips", "1")
        conf.set("serving.longctx.decode.pipeline", "false")
        conf.set("serving.longctx.decode.sampler", "host")
        plane = longctx.longctx_plane_from_conf(conf, m["cfg"], eng)
        assert plane.decoder.pipeline is False
        assert plane.decoder.sampler == "host"
        plane.stop()
        conf.set("serving.longctx.decode.pipeline", "true")
        conf.set("serving.longctx.decode.fetch.windows", "2")
        plane = longctx.longctx_plane_from_conf(conf, m["cfg"], eng)
        assert plane.decoder.pipeline is True
        assert plane.decoder.fetch_windows == 2
        # the reference's defaults
        assert (plane.min_tokens, plane.decoder.win // eng.block_size,
                plane.decoder.tail_cap) == (100, 4, 256)
        plane.stop()
        conf.set("serving.longctx.decode.sampler", "bogus")
        with pytest.raises(ValueError, match="sampler"):
            longctx.longctx_plane_from_conf(conf, m["cfg"], eng)
    finally:
        eng.stop()


def test_longctx_submit_validation():
    """Requests the plane can never serve fail at submit (the door's
    400), not as a wedged worker."""
    eng = _engine(kv_host_bytes=1 << 20)
    eng.attach_longctx(_plane(eng, sp=1, tail_tokens=16))
    try:
        with pytest.raises(ValueError, match="max.tokens"):
            eng.submit(_prompt(300), SamplingParams(max_new_tokens=2))
        with pytest.raises(ValueError, match="tail"):
            eng.submit(_prompt(120), SamplingParams(max_new_tokens=32))
    finally:
        eng.stop()


def test_host_ring_too_small_for_chain_is_loud():
    m = _tiny()
    cfg = m["cfg"]
    eng = _engine(kv_host_bytes=4 * 2 * cfg.n_layers * 8 * cfg.n_kv_heads
                  * cfg.head_dim * 4)
    eng.attach_longctx(_plane(eng, sp=1))
    try:
        with pytest.raises(ValueError, match="host-ring"):
            eng.submit(_prompt(130), SamplingParams(max_new_tokens=2))
    finally:
        eng.stop()


def test_plane_requires_cold_tier():
    eng = _engine(kv_host_bytes=0)
    try:
        with pytest.raises(ValueError, match="cold"):
            _plane(eng)
    finally:
        eng.stop()


def test_plane_from_conf_requires_relaxed_parity():
    """Under the bitwise default the plane cannot be built; under
    relaxed parity it takes the conf's keys."""
    m = _tiny()
    eng = _engine(kv_host_bytes=1 << 20)
    try:
        conf = Configuration(load_defaults=False)
        with pytest.raises(ValueError, match="relaxed"):
            longctx.longctx_plane_from_conf(conf, m["cfg"], eng)
        conf.set("serving.parity", "relaxed")
        conf.set("serving.longctx.min.tokens", "100")
        conf.set("serving.longctx.chips", "2")
        plane = longctx.longctx_plane_from_conf(conf, m["cfg"], eng)
        assert plane.min_tokens == 100
        assert plane.prefiller.sp == 2
        plane.stop()
    finally:
        eng.stop()


def test_health_exposes_longctx_stats():
    """/v1/health's longctx block: the port's keys are the reference
    plane's; a replica without a plane reports it absent."""
    m = _tiny()
    eng = _engine(kv_host_bytes=1 << 20)
    eng.attach_longctx(_plane(eng, sp=1))
    srv = ServingServer(eng, Configuration(load_defaults=False))
    jeng = jengine.DecodeEngine(m["jparams"], m["jcfg"], max_batch=2,
                                block_size=8, max_context=64,
                                kv_host_bytes=1 << 20)
    jplane = jlongctx.LongContextPlane(m["jparams"], m["jcfg"], jeng.kvstore,
                                       block_size=8, **{**PLANE_KW, "sp": 1})
    try:
        status, health = srv._health({}, b"")
        assert status == 200
        assert health["longctx"]["enabled"] is True
        assert health["longctx"]["chips"] == 1
        assert set(health["longctx"]) == set(jplane.stats())
    finally:
        jplane.stop()
        jeng.stop()
        eng.stop()
    plain = DecodeEngine(m["params"], m["cfg"], max_batch=2, block_size=8,
                         max_context=64, device="cpu")
    assert plain.longctx_stats() == {"enabled": False}
    plain.stop()


def test_longctx_metrics_reach_prom():
    """The plane wires the htpu_longctx_* series the door's /prom
    renders: requests, blocks streamed, window fetches, the chips
    gauge and the prefill histogram."""
    from hadoop_tpu_torch.metrics import metrics_system, render_prom
    eng = _engine()
    eng.attach_longctx(_plane(eng, sp=2))
    m = eng.metrics
    names = ("longctx_requests", "longctx_blocks_streamed",
             "longctx_window_fetches")
    before = [getattr(m, n).value() for n in names]
    try:
        eng.submit(_prompt(120), SamplingParams(max_new_tokens=3)).wait(180)
        text = render_prom(metrics_system())
        delta = [getattr(m, n).value() - b for n, b in zip(names, before)]
        assert delta == [1, 120 // 8, eng.longctx_stats()["window_fetches"]]
        assert delta[2] > 0 and m.longctx_chips.value() == 2
        for series in ("htpu_longctx_requests", "htpu_longctx_chips",
                       "htpu_longctx_window_fetches",
                       "htpu_longctx_blocks_streamed",
                       "htpu_longctx_prefill_seconds"):
            assert series in text, series
    finally:
        eng.stop()


def test_ulysses_is_refused_with_queue_a6():
    """No longer refused: ``serving.longctx.sp.mode=ulysses`` builds a
    plane whose prefill runs Ulysses over the folded ranks, and a long
    prompt submitted through the engine decodes the tokens of a repeated
    single-device forward, as the ring's plane does."""
    m = _tiny()
    eng = _engine()
    try:
        conf = Configuration(load_defaults=False)
        conf.set("serving.parity", "relaxed")
        conf.set("serving.longctx.min.tokens", "100")
        conf.set("serving.longctx.max.tokens", "256")
        conf.set("serving.longctx.chips", "2")
        conf.set("serving.longctx.sp.mode", "ulysses")
        plane = longctx.longctx_plane_from_conf(conf, m["cfg"], eng)
        assert plane.prefiller.sp_mode == "ulysses"
        eng.attach_longctx(plane)
        prompt = _prompt(120)
        toks = eng.submit(prompt, SamplingParams(max_new_tokens=4)).wait(180)
        assert toks == _greedy(m["params"], m["cfg"], prompt, 4)
        assert plane.stats()["requests"] == 1 and eng.steps == 0
    finally:
        eng.stop()
