"""The PyTorch port's MoE layer and MoE serving against the JAX package's,
on the CPU.

``route``'s dispatch and combine tensors equal the reference's; the
tiny-moe forward is within 1e-5 of it; and the engine's greedy tokens
equal ``hadoop_tpu``'s ``DecodeEngine`` on the same weights, in the
bitwise tier and in the relaxed one (int8 expert stacks, the a2a codec
round trip), at the preset's capacity factor and at 0.5, where tokens
drop while a prompt chunk rides with the decode lanes, and with
speculation. The reference engine is pinned to one expert shard (the
test process has eight virtual CPU devices, and the port serves on
one).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.models import moe as jmoe
from hadoop_tpu.serving import engine as jengine
from hadoop_tpu.serving import weightplane as jwp
from hadoop_tpu_torch.models import config, decoder, moe, params_from_numpy
from hadoop_tpu_torch.obs.hbm import hbm_ledger
from hadoop_tpu_torch.parallel import spmd
from hadoop_tpu_torch.serving import engine
from hadoop_tpu_torch.serving.engine import DecodeEngine, SamplingParams

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to one thread: the tier-1 run shares the CPU between
    several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_models = {}


def _model(relaxed=False):
    """(jax cfg, jax params, port cfg, port params) of tiny-moe; relaxed:
    both on the reference's quantized plane (group 16)."""
    if relaxed not in _models:
        jcfg = jconfig.get_config("tiny-moe")
        jparams = jdecoder.init_params(jax.random.PRNGKey(0), jcfg)
        if relaxed:
            jparams, _ = jwp.quantize_params(jparams, jcfg,
                                             jwp.WeightPlaneConfig(
                                                 tier="relaxed", group=16))
        cfg = config.get_config("tiny-moe")
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   cfg, device="cpu")
        _models[relaxed] = (jcfg, jparams, cfg, params)
    return _models[relaxed]


# ---------------------------------------------------------------- routing

@pytest.mark.parametrize("tokens,factor", [(6, 1.25), (24, 1.25), (24, 0.5),
                                           (40, 4.0), (12, 0.25)])
def test_route_equals_the_reference(tokens, factor):
    jcfg = jconfig.get_config("tiny-moe", capacity_factor=factor)
    cfg = config.get_config("tiny-moe", capacity_factor=factor)
    rng = np.random.default_rng(tokens)
    x = rng.standard_normal((tokens, 64)).astype(np.float32)
    w = rng.standard_normal((64, 4)).astype(np.float32)
    jd, jc = jmoe.route(jnp.asarray(x), jnp.asarray(w), jcfg)
    d, c = moe.route(torch.from_numpy(x), torch.from_numpy(w), cfg)
    assert d.shape == tuple(jd.shape) == (tokens, 4,
                                          moe.capacity(tokens, cfg))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_allclose(c.numpy(), np.asarray(jc), rtol=TOL,
                               atol=TOL)
    assert moe.capacity(tokens, cfg) == jmoe.capacity(tokens, jcfg)
    if factor <= 0.5:     # past capacity: some (token, choice) pairs drop
        assert d.sum() < tokens * cfg.top_k


def test_forward_and_layout_match_the_reference():
    jcfg, jparams, cfg, params = _model()
    shapes = decoder.init_params(cfg, torch.Generator(), device="meta")
    assert {k: tuple(v.shape) for k, v in shapes["layers"].items()} == \
        {k: tuple(v.shape) for k, v in jparams["layers"].items()}
    toks = np.random.default_rng(0).integers(0, 256, (2, 24))
    got = decoder.forward(params, toks, cfg, device="cpu").numpy()
    want = np.asarray(jdecoder.forward(jparams, jnp.asarray(toks), jcfg))
    assert np.abs(got - want).max() <= TOL


def test_moe_mlp_equals_the_reference_and_refuses_an_ep_axis():
    jcfg, jparams, cfg, params = _model()
    lp = {k: v[0] for k, v in params["layers"].items()}
    jlp = {k: v[0] for k, v in jparams["layers"].items()}
    h = np.random.default_rng(1).standard_normal((3, 7, 64)).astype(
        np.float32)
    got = moe.moe_mlp(torch.from_numpy(h), lp, cfg).numpy()
    want = np.asarray(jmoe.moe_mlp(jnp.asarray(h), jlp, jcfg,
                                   jdecoder.SINGLE))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    # an ep axis is a process group (tests/test_torch_ep.py): the ranks
    # folded on one device are refused
    with pytest.raises(ValueError, match="process group"):
        moe.moe_mlp(torch.from_numpy(h), lp, cfg,
                    decoder.ParallelCtx(ep=spmd.folded("ep", 2)))


# ----------------------------------------------------------------- engine

PROMPTS = [5, 11, 23, 3, 17, 9]


def _prompts():
    rng = np.random.default_rng(1)
    return [rng.integers(0, 256, n).tolist() for n in PROMPTS]


@pytest.mark.parametrize("relaxed,kw", [
    (False, {}),
    (False, dict(moe_capacity_factor=0.5)),
    (True, dict(moe_capacity_factor=0.5)),
    (True, dict(moe_capacity_factor=0.5, moe_a2a_codec="none")),
    (False, dict(moe_capacity_factor=0.5, speculate_k=2)),
    (True, dict(speculate_k=2)),
], ids=["bitwise", "bitwise-drops", "relaxed-drops", "relaxed-no-codec",
        "bitwise-drops-speculate", "relaxed-speculate"])
def test_engine_tokens_equal_the_reference_engine(relaxed, kw,
                                                  monkeypatch):
    """Six prompts through three lanes and a chunk of 8: chunks ride
    with decoding lanes, so in a fused step the lanes and the chunk are
    routed together; at factor 0.5 tokens drop (counted below) and the
    tokens still equal the reference engine's, which routes the same
    rows in the same order."""
    jcfg, jparams, cfg, params = _model(relaxed)
    ekw = dict(max_batch=3, block_size=4, prefill_chunk=8, **kw)
    want = jengine.DecodeEngine(jparams, jcfg, moe_shards=1, **ekw).generate(
        _prompts(), jengine.SamplingParams(max_new_tokens=12))
    dropped, fused_rows = [], []
    real_route = engine.route

    def counting_route(x, w, mcfg):
        d, c = real_route(x, w, mcfg)
        dropped.append(int(x.shape[0] * mcfg.top_k - d.sum()))
        fused_rows.append(x.shape[0])
        return d, c

    monkeypatch.setattr(engine, "route", counting_route)
    eng = DecodeEngine(params, cfg, device="cpu", **ekw)
    got = eng.generate(_prompts(), SamplingParams(max_new_tokens=12))
    assert got == want
    assert eng.decode_compiles == 1 and eng.prefill_compiles == 1
    # both step shapes ran: lanes alone, and lanes with a chunk routed
    # together as one batch
    rows = 3 * (kw.get("speculate_k", 0) + 1)
    assert {rows, rows + 8} <= set(fused_rows)
    if kw.get("moe_capacity_factor") == 0.5:
        assert sum(dropped) > 0
    ref_plane = jengine.DecodeEngine(jparams, jcfg, moe_shards=1,
                                     **ekw).weight_plane()
    assert eng.weight_plane() == ref_plane


def test_engine_ledgers_the_expert_stacks_and_sizes_like_the_reference():
    jcfg, jparams, cfg, params = _model(relaxed=True)
    kw = dict(block_size=4, max_context=64, hbm_bytes=2_000_000,
              max_lanes=8)
    ref = jengine.DecodeEngine(jparams, jcfg, moe_shards=1, **kw)
    eng = DecodeEngine(params, cfg, device="cpu", **kw)
    assert (eng.pool.num_blocks, eng.max_batch) == \
        (ref.pool.num_blocks, ref.max_batch)
    assert eng.weight_plane() == ref.weight_plane()
    comps = hbm_ledger().report()["components"]
    assert comps["moe_experts"] >= eng.expert_bytes > 0
    assert eng.weight_plane()["expert_bytes"] == eng.expert_bytes
    eng.stop()
    after = hbm_ledger().report()["components"].get("moe_experts", 0)
    assert after == comps["moe_experts"] - eng.expert_bytes


def test_scratch_page_writes_resolve_to_the_last_writer():
    """Inactive rows all scatter into block 0, so several rows of a step
    may write one slot; on CUDA which of them lands is a race, and a MoE
    step's routing couples rows (the inactive rows that read block 0
    take expert slots). A MoE group therefore writes each slot with its
    last writer's row: every row of a shared slot carries the same
    source, the one a serial scatter (the reference's) keeps; a row
    alone in its slot writes itself. A dense model's rows never meet, and
    its groups scatter as they are."""
    _, _, cfg, params = _model()
    eng = DecodeEngine(params, cfg, device="cpu", max_batch=3,
                       block_size=4, prefill_chunk=8)
    table = torch.zeros(1, eng.blocks_per_seq, dtype=torch.int64)
    table[0, :4] = torch.tensor([5, 6, 7, 8])
    positions = torch.arange(5, 13)          # blocks 1..3 of the table
    active = positions < 8                   # rows 3.. inactive: block 0
    g = eng._group(torch.arange(8), positions, active, table,
                   one_context=True)
    assert g["blk"].tolist() == [6, 6, 6, 0, 0, 0, 0, 0]
    assert g["off"].tolist() == [1, 2, 3, 0, 1, 2, 3, 0]
    # rows 3 and 7 share block 0's slot 0: both write row 7
    assert g["src"].tolist() == [0, 1, 2, 7, 4, 5, 6, 7]
    dense = config.get_config("tiny")
    dparams = decoder.init_params(dense, torch.Generator().manual_seed(0),
                                  device="cpu")
    deng = DecodeEngine(dparams, dense, device="cpu", max_batch=3,
                        block_size=4, prefill_chunk=8)
    assert deng._group(torch.arange(8), positions, active, table,
                       one_context=True)["src"] is None
