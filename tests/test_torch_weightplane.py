"""The PyTorch port's serving weight plane against the JAX package's, on
the CPU.

The int8 group codec must give the reference's bytes exactly (the q
payload and the scale bits) on float32 and bf16 leaves, in every layout
the plane stores; the in-graph matmuls equal the reference's in float32
(rtol 1e-6); quantize-at-load over a ``MiniDFSCluster`` checkpoint gives
the reference's report and ``quantize_params``' tree; ``hbm_bytes``
sizing and ``weight_plane()`` equal the reference engine's; and the
int8 engine's greedy tokens equal ``hadoop_tpu``'s ``DecodeEngine`` on
the same quantized plane (tiny, with embed and head quantized, and tied
tiny-gpt2).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.parallel import checkpoint as jckpt
from hadoop_tpu.serving import engine as jengine
from hadoop_tpu.serving import weightplane as jwp
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.models import config, params_from_numpy
from hadoop_tpu_torch.parallel.lowp import quant
from hadoop_tpu_torch.serving import weightplane as wp
from hadoop_tpu_torch.serving.engine import DecodeEngine, SamplingParams

RTOL = 1e-6


def _close(got, want):
    """float32 agreement: |got - want| within RTOL of max |want| (the
    two packages sum the products in another order)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


RELAXED = dict(tier="relaxed", group=16)


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to one thread: the tier-1 run shares the CPU between
    several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _torch(a: np.ndarray) -> torch.Tensor:
    """A numpy leaf as a torch tensor, bf16 through its 16-bit patterns."""
    a = np.array(a)
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_qtensor_equal(got, want):
    assert got["q"].dtype == torch.int8 and got["s"].dtype == torch.float32
    np.testing.assert_array_equal(got["q"].numpy(), np.asarray(want["q"]))
    np.testing.assert_array_equal(got["s"].numpy().view(np.int32),
                                  np.asarray(want["s"]).view(np.int32))


_models = {}


def _model(preset, q_embed=False, q_head=False):
    """(jax cfg, jax quantized params, port cfg, port quantized params)."""
    key = (preset, q_embed, q_head)
    if key not in _models:
        jcfg = jconfig.get_config(preset)
        jparams = jdecoder.init_params(jax.random.PRNGKey(0), jcfg)
        jq, _ = jwp.quantize_params(jparams, jcfg, jwp.WeightPlaneConfig(
            quant_embed=q_embed, quant_head=q_head, **RELAXED))
        cfg = config.get_config(preset)
        _models[key] = (jcfg, jq, cfg,
                        params_from_numpy(_np(jq), cfg, device="cpu"))
    return _models[key]


# -------------------------------------------------------------- the codec

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("group", [16, 64])
@pytest.mark.parametrize("shape,transpose", [
    ((128, 64), True),             # a matmul weight [D, N]
    ((96, 128), False),            # the embedding [V, D]
    ((3, 64, 128), True),          # a layer stack [L, D, N]
    ((2, 4, 64, 32), True),        # an expert stack [L, E, D, F]
], ids=["matmul", "embed", "stacked", "experts"])
def test_quantize_weight_bytes_equal_the_reference(dtype, group, shape,
                                                   transpose):
    rng = np.random.default_rng(len(shape) * group)
    a = (rng.standard_normal(shape) *
         rng.choice([1e-4, 1.0, 50.0], size=shape)).astype(np.float32)
    a.reshape(-1)[:group] = 0.0            # an all-zeros stretch
    a = a.astype(getattr(ml_dtypes, dtype) if dtype == "bfloat16"
                 else np.float32)
    want = jwp.quantize_weight(a, group, transpose=transpose)
    got = wp.quantize_weight(_torch(a), group, transpose=transpose)
    _assert_qtensor_equal(got, want)
    back = wp.dequantize_weight(got, transpose=transpose)
    np.testing.assert_array_equal(
        back.numpy(), jwp.dequantize_weight(want, transpose=transpose))


def test_zeros_group_and_group_mismatch():
    q = wp.quantize_weight(torch.zeros(64, 32), 16, transpose=True)
    assert not q["q"].any() and (q["s"] > 0).all()
    assert not wp.dequantize_weight(q, transpose=True).any()
    with pytest.raises(ValueError, match="does not divide"):
        wp.quantize_weight(torch.ones(48, 8), 32, transpose=True)
    with pytest.raises(ValueError, match="does not divide"):
        jwp.quantize_weight(np.ones((48, 8), np.float32), 32, transpose=True)
    with pytest.raises(ValueError, match="scale plane"):
        wp.dequantize_weight({"q": q["q"], "s": q["s"][:1]}, transpose=True)


def test_quantize_array_equals_the_reference_and_fp8_is_refused():
    """The codec equals the reference's in int8 and (since the relaxed
    tier's slice, ROADMAP Queue A 8(b)) in fp8, byte for byte; an
    unknown codec is refused."""
    from hadoop_tpu.parallel.lowp import quant as jquant
    x = np.random.default_rng(3).standard_normal(1000).astype(np.float32)
    q, s = quant.quantize_array(torch.from_numpy(x), group=64)
    jq, js = jquant.quantize_array(x, group=64)
    np.testing.assert_array_equal(q.numpy(), jq)
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(
        quant.dequantize_array(q, s, (1000,), torch.float32).numpy(),
        jquant.dequantize_array(jq, js, (1000,), np.float32))
    q8, s8 = quant.quantize_array(torch.from_numpy(x), codec="fp8",
                                  group=64)
    jq8, js8 = jquant.quantize_array(x, codec="fp8", group=64)
    np.testing.assert_array_equal(q8.view(torch.uint8).numpy(),
                                  jq8.view(np.uint8))
    np.testing.assert_array_equal(s8.numpy(), js8)
    with pytest.raises(ValueError):
        quant.quantize_array(torch.from_numpy(x), codec="int4")


def test_qdot_qrows_qhead_qedot_equal_the_reference():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    jq = jwp.quantize_weight(w, 16, transpose=True)
    q = wp.quantize_weight(torch.from_numpy(w), 16, transpose=True)
    _close(wp.qdot(torch.from_numpy(x), q).numpy(),
           jwp.qdot(jnp.asarray(x), jq))
    emb = rng.standard_normal((40, 64)).astype(np.float32)
    jqe = jwp.quantize_weight(emb, 16, transpose=False)
    qe = wp.quantize_weight(torch.from_numpy(emb), 16, transpose=False)
    toks = np.array([[1, 39, 0], [7, 7, 2]])
    np.testing.assert_array_equal(
        wp.qrows(qe, torch.from_numpy(toks), torch.float32).numpy(),
        jwp.qrows(jqe, jnp.asarray(toks), jnp.float32))
    for preset in ("tiny", "tiny-gpt2"):       # untied head, tied embed
        jcfg, jparams, cfg, params = _model(preset, True, True)
        h = rng.standard_normal((4, 64)).astype(np.float32)
        _close(wp.qhead(params, torch.from_numpy(h), cfg).numpy(),
               jwp.qhead(jparams, jnp.asarray(h), jcfg))
    stack = rng.standard_normal((4, 64, 32)).astype(np.float32)
    jqs = jwp.quantize_weight(stack, 16, transpose=True)
    qs = wp.quantize_weight(torch.from_numpy(stack), 16, transpose=True)
    xe = rng.standard_normal((4, 6, 64)).astype(np.float32)
    _close(wp.qedot(torch.from_numpy(xe), qs).numpy(),
           jwp.qedot(jnp.asarray(xe), jqs))
    sl = wp.qslice(qs, 2)
    assert torch.equal(sl["q"], qs["q"][2]) and torch.equal(sl["s"],
                                                            qs["s"][2])


# ------------------------------------------------------ policy and trees

@pytest.mark.parametrize("preset,flags", [
    ("tiny", {}), ("tiny", dict(quant_embed=True, quant_head=True)),
    ("tiny-gpt2", dict(quant_embed=True, quant_head=True)),
    ("tiny-moe", {})], ids=["tiny", "tiny-embed-head", "gpt2-tied", "moe"])
def test_quantize_params_and_describe_equal_the_reference(preset, flags):
    jcfg = jconfig.get_config(preset)
    jparams = jdecoder.init_params(jax.random.PRNGKey(1), jcfg)
    cfg = config.get_config(preset)
    params = params_from_numpy(_np(jparams), cfg, device="cpu")
    jq, jrep = jwp.quantize_params(
        jparams, jcfg, jwp.WeightPlaneConfig(tier="relaxed", **flags))
    q, rep = wp.quantize_params(
        params, cfg, wp.WeightPlaneConfig(tier="relaxed", **flags))
    for r in (rep, jrep):
        r.pop("quantize_seconds")
    assert rep == jrep
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jq)[0])
    got = params_from_numpy(_np(jq), cfg, device="cpu")
    for k, v in flat_j.items():
        node = q
        for part in k:
            node = node[part.key]
        want = np.asarray(v)
        if want.dtype == np.float32:
            np.testing.assert_array_equal(node.numpy().view(np.int32),
                                          want.view(np.int32))
        else:
            np.testing.assert_array_equal(node.view(torch.int16).numpy()
                                          if node.dtype == torch.bfloat16
                                          else node.numpy(),
                                          want.view(np.int16)
                                          if want.dtype == ml_dtypes.bfloat16
                                          else want)
    assert wp.describe_tree(q) == jwp.describe_tree(jq)
    assert wp.describe_tree(params) == jwp.describe_tree(jparams)
    assert wp.expert_weight_bytes(q, cfg) == jwp.expert_weight_bytes(jq, jcfg)
    deq = wp.dequantize_params(q, cfg)
    jdeq = jwp.dequantize_params(jq, jcfg)
    for k, v in jax.tree_util.tree_flatten_with_path(jdeq)[0]:
        node = deq
        for part in k:
            node = node[part.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(v))
    assert wp.is_quantized_tree(got) and not wp.is_quantized_tree(params)


def test_conf_tiers_and_refusals():
    conf = Configuration(load_defaults=False)
    assert wp.weightplane_from_conf(conf) == wp.BITWISE_WEIGHTS
    for key, value in (("serving.parity", "relaxed"),
                       ("serving.weights.group", "32"),
                       ("serving.weights.embed", "true"),
                       ("serving.weights.guard.rel-tol", "0.5")):
        conf.set(key, value)
    got = wp.weightplane_from_conf(conf)
    assert (got.tier, got.group, got.quant_embed, got.guard_rel_tol) == \
        ("relaxed", 32, True, 0.5) and got.relaxed
    for bad in (dict(tier="fast"), dict(codec="fp8"), dict(group=0)):
        with pytest.raises(ValueError):
            wp.WeightPlaneConfig(**bad)
    cfg = config.get_config("tiny-gpt2")
    with pytest.raises(ValueError, match="tied"):
        wp.quantize_params({}, cfg, wp.WeightPlaneConfig(
            tier="relaxed", quant_head=True))
    with pytest.raises(ValueError, match="relaxed"):
        wp.quantize_params({}, cfg, wp.BITWISE_WEIGHTS)


@pytest.mark.parametrize("n_experts,requested,devices", [
    (8, 0, 1), (8, 0, 4), (8, 0, 3), (6, 0, 4), (8, 2, 4), (0, 0, 8)])
def test_expert_shard_count_equals_the_reference(n_experts, requested,
                                                 devices):
    assert wp.expert_shard_count(n_experts, requested, devices) == \
        jwp.expert_shard_count(n_experts, requested, devices)
    for bad in ((8, 3, 4), (8, 8, 4)):
        with pytest.raises(ValueError):
            wp.expert_shard_count(*bad)


def test_weight_ab_report_equals_the_reference():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((2, 7, 30)).astype(np.float32)
    for b in (a + 0.01 * rng.standard_normal(a.shape).astype(np.float32),
              a + 5.0 * rng.standard_normal(a.shape).astype(np.float32),
              np.where(a > 2, np.nan, a), a[:, :3]):
        assert wp.weight_ab_report(torch.from_numpy(a), b) == \
            jwp.weight_ab_report(a, b)
    _, jq, cfg, q = _model("tiny")
    params = params_from_numpy(_np(jdecoder.init_params(
        jax.random.PRNGKey(0), jconfig.get_config("tiny"))), cfg,
        device="cpu")
    rep = wp.run_weight_ab(cfg, params, q, device="cpu", seq=24)
    # the same teacher-forced batch through both planes, judged as above
    tokens = torch.randint(0, cfg.vocab_size, (8, 24),
                           generator=torch.Generator().manual_seed(0))
    from hadoop_tpu_torch.models.decoder import forward
    want = wp.weight_ab_report(
        forward(params, tokens, cfg, device="cpu"),
        forward(wp.dequantize_params(q, cfg), tokens, cfg, device="cpu"))
    assert rep == dict(want, batch=8, seq=24)
    assert rep["positions"] == 8 * 24 and rep["max_rel"] <= 0.25
    assert rep["greedy_agree"] >= 0.9


# ------------------------------------------------------------- the loader

@pytest.fixture(scope="module")
def dfs(tmp_path_factory):
    from hadoop_tpu.testing.minicluster import MiniDFSCluster
    cluster = MiniDFSCluster(num_datanodes=1,
                             base_dir=str(tmp_path_factory.mktemp("dfs")))
    cluster.start()
    yield cluster.get_filesystem()
    cluster.shutdown()


@pytest.mark.parametrize("preset", ["tiny", "tiny-moe"])
def test_quantized_load_over_minidfs_equals_the_reference(dfs, preset):
    jcfg = jconfig.get_config(preset)
    jparams = jdecoder.init_params(jax.random.PRNGKey(2), jcfg)
    base = f"/wp/{preset}"
    jckpt.save_checkpoint(dfs, base, 3, {"params": jparams})
    jw = jwp.WeightPlaneConfig(tier="relaxed", group=16, quant_embed=True)
    cfg = config.get_config(preset)
    pw = wp.WeightPlaneConfig(tier="relaxed", group=16, quant_embed=True)
    jq, jstep, jrep = jwp.quantized_load(dfs, base, jcfg, jw, io_workers=2)
    q, step, rep = wp.quantized_load(dfs, base, cfg, pw, io_workers=2,
                                     device="cpu")
    for r in (rep, jrep):
        for k in ("quantize_seconds", "load_seconds"):
            r.pop(k)
    assert (step, rep) == (jstep, jrep)
    want, _ = wp.quantize_params(params_from_numpy(_np(jparams), cfg,
                                                   device="cpu"), cfg, pw)
    flat = lambda t: {k: v for k, v in _walk(t)}   # noqa: E731
    got, ref = flat(q), flat(want)
    assert got.keys() == ref.keys()
    for k in ref:
        assert got[k].dtype == ref[k].dtype and torch.equal(got[k], ref[k]), k


def _walk(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, f"{prefix}/{k}")
        else:
            yield f"{prefix}/{k}", v


# ------------------------------------------------------------- the engine

@pytest.mark.parametrize("preset,q_embed,q_head", [
    ("tiny", False, False), ("tiny", True, True), ("tiny-gpt2", True, True)],
    ids=["tiny", "tiny-embed-head", "tiny-gpt2-tied"])
def test_int8_engine_tokens_equal_the_reference_engine(preset, q_embed,
                                                       q_head):
    jcfg, jq, cfg, q = _model(preset, q_embed, q_head)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 11, 23, 3, 17)]
    kw = dict(max_batch=3, block_size=4, prefill_chunk=8)
    want = jengine.DecodeEngine(jq, jcfg, **kw).generate(
        prompts, jengine.SamplingParams(max_new_tokens=10))
    eng = DecodeEngine(q, cfg, device="cpu", **kw)
    assert eng.generate(prompts, SamplingParams(max_new_tokens=10)) == want
    assert eng.decode_compiles == 1 and eng.prefill_compiles == 1


def test_hbm_sizing_and_weight_plane_equal_the_reference():
    """At one budget: the reference's num_blocks and lanes for the int8
    plane and the float one, the int8 plane buying more lanes x context,
    and weight_plane() equal key for key."""
    jcfg, jq, cfg, q = _model("tiny")
    jparams = jdecoder.init_params(jax.random.PRNGKey(0), jcfg)
    params = params_from_numpy(_np(jparams), cfg, device="cpu")
    kw = dict(block_size=4, max_context=64, hbm_bytes=1_200_000,
              max_lanes=64, quantize_seconds=0.25)
    planes = {}
    for name, jt, t in (("f32", jparams, params), ("int8", jq, q)):
        ref = jengine.DecodeEngine(jt, jcfg, **kw)
        eng = DecodeEngine(t, cfg, device="cpu", **kw)
        assert eng.pool.num_blocks == ref.pool.num_blocks
        assert eng.max_batch == ref.max_batch
        assert eng.weight_plane() == ref.weight_plane()
        planes[name] = eng.weight_plane()
        eng.stop()
    assert planes["int8"]["lanes_x_context"] > \
        planes["f32"]["lanes_x_context"]
    assert planes["int8"]["parity"] == "relaxed"
    with pytest.raises(ValueError, match="below one"):
        DecodeEngine(params, cfg, device="cpu", block_size=4,
                     hbm_bytes=400_000)
    with pytest.raises(ValueError, match="below one"):
        jengine.DecodeEngine(jparams, jcfg, block_size=4, hbm_bytes=400_000)


def test_hbm_ledger_counts_the_int8_weights():
    from hadoop_tpu_torch.obs.hbm import hbm_ledger
    _, _, cfg, q = _model("tiny")
    eng = DecodeEngine(q, cfg, device="cpu", block_size=4)
    comps = hbm_ledger().report()["components"]
    assert comps["weights"] >= wp.resident_weight_bytes(q)
    eng.stop()


@pytest.mark.parametrize("preset,q_embed,q_head", [
    ("tiny", False, False), ("tiny", True, True), ("tiny-moe", False, False)],
    ids=["tiny", "tiny-embed-head", "tiny-moe"])
def test_engine_dequantizes_each_weight_once_per_step(monkeypatch, preset,
                                                      q_embed, q_head):
    """The fused step (lanes + a prompt chunk, two row groups) and the
    decode-only step dequantize each int8 matmul weight of each layer
    once (``weightplane.dequant``), a quantized head once, each MoE
    expert stack once; the tokens stay the reference engine's."""
    jcfg, jq, cfg, q = _model(preset, q_embed, q_head)
    names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    weights = {}
    for name in names:
        for li in range(cfg.n_layers):
            weights[q["layers"][name]["q"][li].data_ptr()] = (name, li)
    if q_head:
        head = q["embed"] if cfg.tie_embeddings else q["lm_head"]
        weights[head["q"].data_ptr()] = ("head", 0)
    calls = []
    real = wp.dequant

    def counting(qw, dtype):
        calls.append(weights.get(qw["q"].data_ptr(), "rows"))
        return real(qw, dtype)

    monkeypatch.setattr(wp, "dequant", counting)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).tolist() for n in (11, 5)]
    kw = dict(max_batch=3, block_size=4, prefill_chunk=8)
    eng = DecodeEngine(q, cfg, device="cpu", **kw)
    reqs = [eng.submit(p, SamplingParams(max_new_tokens=6))
            for p in prompts]
    fused = 0
    while not all(r.done.is_set() for r in reqs):
        calls.clear()
        fused += eng.num_prefilling > 0
        eng.step()
        per_weight = [c for c in calls if c != "rows"]
        assert sorted(per_weight) == sorted(weights.values())
        assert calls.count("rows") <= 2 * q_embed     # one per row group
    assert fused >= 2
    want = jengine.DecodeEngine(jq, jcfg, **kw).generate(
        prompts, jengine.SamplingParams(max_new_tokens=6))
    assert [r.wait(0) for r in reqs] == want


def test_dequant_kernel_wrapper_one_launch(monkeypatch):
    """On a (seemingly) CUDA payload ``dequant`` launches the kernel once
    for the whole leaf (the C entry counts in long long), with its scales;
    the kernel is stood in for by its arithmetic, so the result must be
    ``_dequant``'s bit for bit. An output dtype the kernel was not built
    for is refused before any launch."""
    class LooksCuda(torch.Tensor):
        @property
        def is_cuda(self):
            return True

    def kernel(name, q, s, out, n, gs, dtype):
        assert name == "htpu_dequant_int8" and n == q.numel()
        launched.append(n)
        w = q.as_subclass(torch.Tensor).float().view(-1) * \
            s.as_subclass(torch.Tensor).view(-1).repeat_interleave(gs)
        out.view(-1)[:] = w.to(out.dtype)

    launched = []
    monkeypatch.setattr(wp._build, "launch", kernel)
    rng = np.random.default_rng(9)
    q = torch.from_numpy(rng.integers(-127, 128, (2, 7, 4, 16)).astype(
        np.int8))
    s = torch.from_numpy(rng.random((2, 7, 4)).astype(np.float32))
    qw = {"q": q.as_subclass(LooksCuda), "s": s.as_subclass(LooksCuda)}
    for dtype in (torch.bfloat16, torch.float32):
        launched.clear()
        got = wp.dequant(qw, dtype)
        assert launched == [2 * 7 * 4 * 16]
        want = wp._dequant(q, s, dtype)
        assert got.dtype == dtype and torch.equal(got, want)
    launched.clear()
    with pytest.raises(ValueError, match="output dtype among"):
        wp.dequant(qw, torch.float16)
    assert launched == []
