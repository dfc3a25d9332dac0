"""The port's tensor-parallel and expert-sharded serving against the JAX
package's, on the CPU.

One gloo world of four ranks (``spmd.launch``) serves every job of
``dist_plans.serve_plans``: ``tiny`` at tp 2 (×dp 2: the two copies run
the same steps) through batched admission, fused chunked prefill, prefix
reuse and a preemption (``tests/test_serving.py:346``'s scenario, with
more requests queued behind it), with speculation at k 2 and a sampled
request, from shards loaded off a checkpoint, and through the host KV
tier (a page gathered over tp, demoted and replayed); ``tiny-gpt2`` at
tp 2 with non-zero biases, where ``b_out`` is added once after the tp
sum; ``tiny-moe`` over 2 and 4 expert shards (tokens dropping at factor
0.5), on the int8 plane over 4 shards, and under tp 2. Each job's greedy
tokens equal ``hadoop_tpu``'s ``DecodeEngine`` with the same plan or
expert shards on its virtual 8-device mesh, on the same weights, and the
port's single-device engine; every rank's step outputs and device step
state are bit-equal, step by step. ``tiny`` and ``tiny-moe`` in bf16 at
tp 2 (the engine's float32 partials against GSPMD's bf16 ones) follow
the reference's model rows within BF16_TOL and its engine's tokens up
to a near-tie. The refusals are the reference's, and ``attach_longctx``
on a multi-rank engine names its ROADMAP item. A driver that raises
before a step releases its followers; a rank that raises inside a step,
follower or driver, fails its world (a world of two of its own) without
any rank waiting on a collective.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.parallel.mesh import MeshPlan as JMeshPlan
from hadoop_tpu.serving import engine as jengine
from hadoop_tpu.serving import weightplane as jwp
from hadoop_tpu_torch.fs import LocalFileSystem
from hadoop_tpu_torch.models import config, params_from_numpy
from hadoop_tpu_torch.parallel import spmd
from hadoop_tpu_torch.parallel.checkpoint import save_checkpoint
from hadoop_tpu_torch.parallel.mesh import MeshPlan
from hadoop_tpu_torch.serving import weightplane
from hadoop_tpu_torch.serving.engine import DecodeEngine
from hadoop_tpu_torch.tools import dist_plans

WORLD = 4
TP = {"tp": 2, "dp": 2}
HEAD = [5, 9, 2, 7, 1, 8, 3, 6]                   # 2 full blocks of 4
# A prefills, B maps A's head and is preempted under pool pressure, two
# more wait for lanes (batched admission; chunks of 4 ride with decode)
SCRIPT = [{"op": "submit", "prompts": [HEAD + [1, 2]], "max_new": 14},
          {"op": "until_first", "req": 0},
          {"op": "submit", "prompts": [HEAD + [3, 4]], "max_new": 10},
          {"op": "submit", "prompts": [[11, 12, 13],
                                       [20, 21, 22, 23, 24, 25]],
           "max_new": 6},
          {"op": "drain"}]
SMALL_POOL = dict(max_batch=2, block_size=4, max_context=32, num_blocks=8,
                  prefill_chunk=4)
SAMPLED = {"op": "submit", "prompts": [[7, 7, 7, 7, 7]], "max_new": 6,
           "temperature": 0.9, "top_k": 8}
BATCH = [{"op": "submit", "prompts": [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3],
                                      [2, 7, 1, 8], [9, 9, 8, 2, 4, 4],
                                      [1, 6, 1, 8, 0, 3, 3]],
          "max_new": 8},
         {"op": "drain"}]
MOE_KW = dict(max_batch=3, block_size=4, prefill_chunk=8)
BF16 = {"dtype": "bfloat16"}
TIERS = [{"op": "submit", "prompts": [list(range(30, 43))], "max_new": 4},
         {"op": "drain"}, {"op": "extract", "req": 0},
         {"op": "evict_all"},
         {"op": "submit", "prompts": [list(range(30, 43))], "max_new": 4},
         {"op": "drain"}]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_weights = {}


def _numpy_tree(preset, **overrides):
    """The reference's initial weights as numpy; ``tiny-gpt2`` with
    non-zero biases (the zeros of the init would hide a bias added
    twice)."""
    key = (preset, tuple(sorted(overrides.items())))
    if key not in _weights:
        jcfg = jconfig.get_config(preset, **overrides)
        tree = jax.tree_util.tree_map(np.asarray, jdecoder.init_params(
            jax.random.PRNGKey(0), jcfg))
        if preset == "tiny-gpt2":
            rng = np.random.default_rng(7)
            for k in ("b_in", "b_out", "attn_norm_b", "mlp_norm_b"):
                leaf = tree["layers"][k]
                tree["layers"][k] = (0.5 * rng.standard_normal(
                    leaf.shape)).astype(leaf.dtype)
        _weights[key] = tree
    return _weights[key]


def _jax_params(preset, relaxed=False, overrides=None):
    overrides = overrides or {}
    jcfg = jconfig.get_config(preset, **overrides)
    jp = jax.tree_util.tree_map(jnp.asarray, _numpy_tree(preset,
                                                         **overrides))
    if relaxed:
        jp, _ = jwp.quantize_params(jp, jcfg, jwp.WeightPlaneConfig(
            tier="relaxed", group=16))
    return jp, jcfg


def _port_params(preset, relaxed=False, overrides=None):
    overrides = overrides or {}
    cfg = config.get_config(preset, **overrides)
    p = params_from_numpy(_numpy_tree(preset, **overrides), cfg,
                          device="cpu")
    if relaxed:
        p, _ = weightplane.quantize_params(p, cfg, weightplane.
                                           WeightPlaneConfig(tier="relaxed",
                                                             group=16))
    return p, cfg


# (id, preset, placement, engine kwargs, script, options)
JOBS = [
    ("tiny_tp2", "tiny", {"plan": TP}, SMALL_POOL, SCRIPT,
     {"digests": True}),
    ("tiny_tp2_speculate", "tiny", {"plan": TP},
     dict(SMALL_POOL, speculate_k=2), SCRIPT[:-1] + [SAMPLED, SCRIPT[-1]],
     {"digests": True}),
    ("tiny_tp2_ckpt", "tiny", {"plan": TP}, MOE_KW, BATCH, {"ckpt": True}),
    ("tiny_tp2_tiers", "tiny", {"plan": TP},
     dict(SMALL_POOL, num_blocks=16, kv_host_bytes=1 << 20), TIERS, {}),
    ("gpt2_tp2", "tiny-gpt2", {"plan": TP}, dict(MOE_KW, hbm_bytes=2_000_000),
     BATCH, {"probe": True}),
    ("moe_shards2", "tiny-moe", {"group": 4},
     dict(MOE_KW, moe_shards=2), BATCH, {"digests": True}),
    ("moe_shards4", "tiny-moe", {"group": 4},
     dict(MOE_KW, moe_shards=4, moe_capacity_factor=0.5), BATCH,
     {"digests": True}),
    ("moe_int8_shards4", "tiny-moe", {"group": 4},
     dict(MOE_KW, moe_shards=4), BATCH, {"relaxed": True}),
    ("moe_tp2", "tiny-moe", {"plan": TP}, MOE_KW, BATCH, {}),
    ("tiny_bf16_tp2", "tiny", {"plan": TP}, MOE_KW, BATCH,
     {"overrides": BF16, "probe": True}),
    ("moe_bf16_tp2", "tiny-moe", {"plan": TP}, MOE_KW, BATCH,
     {"overrides": dict(BF16, capacity_factor=4.0), "probe": True}),
    ("fault", "tiny", {"plan": TP}, MOE_KW, BATCH,
     {"fault": {"at_step": 3}}),
    ("longctx", "tiny", {"plan": TP}, MOE_KW, [], {"longctx": True}),
]


def _job(jid, preset, where, kw, ops, opts, ckpt_dir):
    over = opts.get("overrides", {})
    job = dict(preset=preset, overrides=over, device="cpu", engine=kw,
               ops=ops, **where)
    if opts.get("ckpt"):
        job["ckpt"] = ckpt_dir
    else:
        job["weights"] = _numpy_tree(preset, **over)
    if opts.get("relaxed"):
        job["relaxed"] = {"group": 16}
    for key in ("digests", "probe", "fault", "longctx"):
        if key in opts:
            job[key] = opts[key]
    return job


def _jsampling(op):
    return jengine.SamplingParams(max_new_tokens=op["max_new"],
                                  temperature=op.get("temperature", 0.0),
                                  top_k=op.get("top_k", 0))


def _jax_run(preset, where, kw, ops, relaxed=False, overrides=None):
    """The reference engine through the same script (greedy requests):
    the same tp plan on its virtual mesh, or the same expert shards over
    its local chips. Returns its tokens, weight plane and pool size."""
    jp, jcfg = _jax_params(preset, relaxed, overrides)
    kw = {k: v for k, v in kw.items() if k != "speculate_k"}
    plan = JMeshPlan(**where["plan"]) if "plan" in where else None
    eng = jengine.DecodeEngine(jp, jcfg, plan=plan, **kw)
    reqs = []
    for op in ops:
        if op is SAMPLED:
            continue
        if op["op"] == "submit":
            reqs += [eng.submit(p, _jsampling(op)) for p in op["prompts"]]
        elif op["op"] == "until_first":
            r = reqs[op["req"]]
            while not r.out_tokens and not r.done.is_set():
                eng.step()
        elif op["op"] == "drain":
            while not all(r.done.is_set() for r in reqs):
                eng.step()
    return {"tokens": [r.wait(0) for r in reqs],
            "prompts": [r.prompt for r in reqs],
            "weight_plane": eng.weight_plane(),
            "num_blocks": eng.pool.num_blocks}


def _jax_rows(preset, overrides, prompts, tokens):
    """The reference model's logits rows (``forward`` on the same
    weights, float32) behind each request's ``tokens`` after its prompt,
    the requests in one padded batch (causal: the padding after a
    sequence changes none of its rows; no MoE capacity drops at the
    factor the bf16 job sets)."""
    jp, jcfg = _jax_params(preset, overrides=overrides)
    seqs = [list(p) + list(t[:-1]) for p, t in zip(prompts, tokens)]
    width = max(map(len, seqs))
    batch = jnp.asarray([q + [0] * (width - len(q)) for q in seqs],
                        jnp.int32)
    logits = np.asarray(jdecoder.forward(jp, batch, jcfg).astype(
        jnp.float32))
    return [logits[i, len(p) - 1:len(q)]
            for i, (p, q) in enumerate(zip(prompts, seqs))]


def _single(preset, kw, ops, relaxed=False, probe=False, overrides=None):
    """The port's single-device engine through the same script (the
    driver's own code): its record, with the engine's counts."""
    p, cfg = _port_params(preset, relaxed, overrides)
    eng = DecodeEngine(p, cfg, device="cpu", **dict(kw, moe_shards=1))
    pr = dist_plans.StepProbe(eng) if probe else None
    rec = {"step_ms": [], "fused": [], "launches": [], "traffic": []}
    dist_plans._drive(eng, {"ops": ops}, rec, False)
    if pr is not None:
        rec["first_logits"] = [pr.first[i] for i in rec["ids"]]
    rec.update(steps=eng.steps, spec_proposed=eng.spec_proposed,
               weight_plane=eng.weight_plane(),
               num_blocks=eng.pool.num_blocks)
    return rec


def _spec(jid):
    return next(j for j in JOBS if j[0] == jid)


TOKEN_JOBS = ["tiny_tp2", "tiny_tp2_speculate", "tiny_tp2_ckpt", "gpt2_tp2",
              "moe_shards2", "moe_shards4", "moe_int8_shards4", "moe_tp2"]
BF16_JOBS = ["tiny_bf16_tp2", "moe_bf16_tp2"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """Every job on one gloo world of four ranks ({id: every rank's
    record}) and, meanwhile in this process, the reference engine's and
    the single-device engine's runs of the same scripts."""
    ckpt = str(tmp_path_factory.mktemp("tp_ckpt") / "tiny")
    save_checkpoint(LocalFileSystem(), ckpt, 3, _port_params("tiny")[0])
    jobs = [_job(*j, ckpt) for j in JOBS]
    box = {}

    def world():
        try:
            box["recs"] = spmd.launch(dist_plans.serve_plans, WORLD,
                                      backend="gloo", args=(jobs,),
                                      timeout=300)
        except BaseException as e:   # re-raised below
            box["error"] = e
    thread = threading.Thread(target=world)
    thread.start()
    try:
        refs, singles = {}, {}
        for jid in TOKEN_JOBS + BF16_JOBS:
            _, preset, where, kw, ops, opts = _spec(jid)
            # speculation leaves greedy tokens as they are: one reference
            key = "tiny_tp2" if jid == "tiny_tp2_speculate" else jid
            if key not in refs:
                refs[key] = _jax_run(preset, where, kw, ops,
                                     opts.get("relaxed", False),
                                     opts.get("overrides"))
            refs[jid] = refs[key]
        for jid, preset, _, kw, ops, opts in JOBS:
            singles[jid] = _single(preset, kw, ops,
                                   opts.get("relaxed", False),
                                   opts.get("probe", False),
                                   opts.get("overrides"))
    finally:
        thread.join()
    if "error" in box:
        raise box["error"]
    return {"runs": {j[0]: [r[i] for r in box["recs"]]
                     for i, j in enumerate(JOBS)},
            "refs": refs, "singles": singles}


@pytest.fixture(scope="module")
def runs(results):
    return results["runs"]


@pytest.mark.parametrize("jid", TOKEN_JOBS)
def test_tokens_equal_the_reference_and_the_single_device_engine(results,
                                                                 jid):
    recs = results["runs"][jid]
    ref, single = results["refs"][jid], results["singles"][jid]
    drv = recs[0]
    assert drv["error"] is None and drv["mesh"]["driver"]
    assert drv["mesh"]["path"] == "eager" and drv["mesh"]["ranks"] == 4
    assert [r["mesh"]["driver"] for r in recs] == [True] + [False] * 3
    assert drv["tokens"] == single["tokens"]
    assert drv["tokens"][:len(ref["tokens"])] == ref["tokens"]
    # sizing and reports are the reference's global figures
    assert drv["weight_plane"] == ref["weight_plane"]
    assert drv["num_blocks"] == ref["num_blocks"] == single["num_blocks"]
    assert dict(single["weight_plane"], expert_shards=drv["mesh"][
        "expert_shards"]) == drv["weight_plane"]
    # every rank followed every step
    assert all(r["followed_steps"] == single["steps"] for r in recs[1:])


def test_scenario_reuses_a_prefix_preempts_and_speculates(results):
    drv = results["runs"]["tiny_tp2"][0]
    assert drv["reused"][1] >= 8 and max(drv["preemptions"]) >= 1
    assert any(drv["fused"]) and not all(drv["fused"])
    spec = results["runs"]["tiny_tp2_speculate"][0]
    single = results["singles"]["tiny_tp2_speculate"]
    assert single["spec_proposed"] > 0
    # the sampled request: the single-device engine's draw, on every rank
    assert spec["tokens"][-1] == single["tokens"][-1]


@pytest.mark.parametrize("jid", ["tiny_tp2", "tiny_tp2_speculate",
                                 "moe_shards2", "moe_shards4"])
def test_every_rank_holds_the_same_step_outputs_and_state(runs, jid):
    """A digest of each step's packed output and of the device step
    state after it, on every rank: bit-equal, step for step."""
    recs = runs[jid]
    assert len(recs[0]["digests"]) == len(recs[0]["step_ms"]) > 5
    assert all(r["digests"] == recs[0]["digests"] for r in recs[1:])


def test_tp_placement_and_the_bias_added_once(results):
    """gpt2 at tp 2: the first-token logits equal the single device's
    (``b_out`` once after the tp sum, the biases non-zero)."""
    runs, single = results["runs"], results["singles"]["gpt2_tp2"]
    for got, want in zip(runs["gpt2_tp2"][0]["first_logits"],
                         single["first_logits"]):
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    moe = runs["moe_tp2"][0]["mesh"]
    assert moe["tp"] == 2 and moe["dp"] == 2 and moe["expert_shards"] == 4


def test_a_page_gathers_over_tp_and_replays_from_the_host_tier(results):
    single = results["singles"]["tiny_tp2_tiers"]
    drv = results["runs"]["tiny_tp2_tiers"][0]
    assert drv["evicted"] > 0
    for got, want in zip(drv["extracted"], single["extracted"]):
        # the tp sums reassociate float32 adds: equal to rounding
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert drv["tokens"][0] == drv["tokens"][1] == single["tokens"][0]
    assert drv["reused"][1] >= 8          # the replay mapped host pages


# bf16 at tp 2: the tp engine sums float32 partials and rounds once; the
# reference's GSPMD sums bf16 partials. Both are held to the reference
# model's rows within the card's gate (chip_smoke.py's TP_SERVING).
BF16_TOL = 2e-2


@pytest.mark.parametrize("jid", BF16_JOBS)
def test_bf16_tp_follows_the_reference(results, jid):
    """Each prompt's first-token logits within BF16_TOL (of the row's
    largest logit) of ``hadoop_tpu``'s forward on the same bf16 weights,
    and the greedy tokens equal the reference ``DecodeEngine``'s with the
    same plan up to the first token that its model decided by a top-2
    gap under BF16_TOL."""
    _, preset, _, _, _, opts = _spec(jid)
    drv, ref = results["runs"][jid][0], results["refs"][jid]
    single = results["singles"][jid]
    assert drv["error"] is None and drv["mesh"]["tp"] == 2
    assert drv["tokens"] == single["tokens"]
    rel, agreed = [], []
    for got, want, first, rows in zip(
            drv["tokens"], ref["tokens"], drv["first_logits"],
            _jax_rows(preset, opts["overrides"], ref["prompts"],
                      ref["tokens"])):
        rel.append(float(np.abs(first - rows[0]).max()
                         / np.abs(rows[0]).max()))
        top = np.sort(rows, axis=-1)[:, -2:]
        gaps = (top[:, 1] - top[:, 0]) / np.abs(rows).max(-1)
        close = next((j for j, g in enumerate(gaps) if g < BF16_TOL),
                     len(want))
        n = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                 len(want))
        agreed.append(n)
        assert n >= close, (got, want, gaps)
    print(jid, rel, agreed)
    assert max(rel) <= BF16_TOL, rel


def test_a_driver_that_raises_releases_its_followers(runs):
    recs = runs["fault"]
    assert "injected driver fault" in recs[0]["error"]
    assert all(r["followed_steps"] == 3 for r in recs[1:])


@pytest.mark.parametrize("rank", [1, 0])
def test_a_rank_that_fails_mid_step_fails_the_world(rank):
    """A rank that raises inside a step (after the embedding's
    collective), follower or driver: every rank reports an error at once
    (none waits in a collective until it is killed or times out)."""
    job = _job("mid_step", "tiny", {"plan": {"tp": 2}}, MOE_KW, BATCH,
               {"fault": {"at_step": 2, "rank": rank, "mid_step": True}},
               None)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as err:
        spmd.launch(dist_plans.serve_plans, 2, backend="gloo",
                    args=([job],), timeout=120)
    msg = str(err.value)
    assert f"injected fault mid-step on rank {rank}" in msg
    assert "rank 0:" in msg and "rank 1:" in msg
    assert time.monotonic() - t0 < 60


def test_refusals_are_the_references(runs):
    cfg = config.get_config("tiny")
    params, _ = _port_params("tiny")
    jp, jcfg = _jax_params("tiny")
    for kw in ({"pp": 2}, {"sp": 2}, {"ep": 2}):
        with pytest.raises(ValueError) as ref:
            jengine.DecodeEngine(jp, jcfg, plan=JMeshPlan(**kw))
        with pytest.raises(ValueError) as got:
            DecodeEngine(params, cfg, device="cpu", plan=MeshPlan(**kw))
        assert str(got.value).split(";")[0] == str(ref.value).split(";")[0]
    q, _ = _port_params("tiny", relaxed=True)
    jq, _ = _jax_params("tiny", relaxed=True)
    with pytest.raises(NotImplementedError) as ref:
        jengine.DecodeEngine(jq, jcfg, plan=JMeshPlan(tp=2))
    with pytest.raises(NotImplementedError) as got:
        DecodeEngine(q, cfg, device="cpu", plan=MeshPlan(tp=2))
    assert str(got.value) == str(ref.value)
    assert "Queue A 6 item 5" in runs["longctx"][0]["longctx_error"]
    assert runs["longctx"][-1]["foreign"] == []


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("relaxed", [False, True])
def test_a_ranks_expert_stacks_are_the_references_shard(shards, relaxed):
    """``shard_expert_stacks(params, shards, i)``: the expert stacks (the
    int8 payload and its scales together) as the reference's placement
    puts them on its i-th chip; the dense leaves whole."""
    jp, jcfg = _jax_params("tiny-moe", relaxed)
    placed = jengine._shard_expert_stacks(jp, shards)
    p, _ = _port_params("tiny-moe", relaxed)
    for i in range(shards):
        mine = weightplane.shard_expert_stacks(p, shards, i)
        for k in ("w_gate", "w_up", "w_down"):
            for part in (("q", "s") if relaxed else (None,)):
                got = mine["layers"][k] if part is None \
                    else mine["layers"][k][part]
                ref = placed["layers"][k] if part is None \
                    else placed["layers"][k][part]
                want = next(s.data for s in ref.addressable_shards
                            if s.device == ref.sharding.mesh.devices[i])
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert mine["layers"]["wq"] is p["layers"]["wq"]
        assert mine["embed"] is p["embed"]
