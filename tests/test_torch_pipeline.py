"""The port's pipeline plans against the JAX package's.

The pipeline plans of ``tests/test_parallel.py`` cut to four ranks:
1F1B and GPipe as pp2 x tp2 and dp2 x pp2, pp4 at M 4, Megatron-SP with
pp, the ring with pp, interleaved 1F1B (dp2 x pp2 x vpp2 at M 4, also at
8 layers: two layers a chunk) and against plain 1F1B on the same
plan, ZeRO-1 with pp, and gpt2 (tied embeddings: stage 0 and the last
stage each hold part of one leaf's gradient) through a pp plan. The
port trains each on one gloo world of four ranks on the CPU from the
JAX package's weights; the JAX package trains the same plan on the
virtual 8-device mesh. Losses are held at the reference's rtol 1e-4
and every gathered parameter at ``_assert_tree_close``'s 2e-4, against
JAX's plan and against the port's single-device step (gpt2 against
JAX's plan only: both count a tp plan's row-parallel bias tp times).
The clocks themselves are checked without a world: each microbatch
through each virtual stage once, forward and backward, one tick per hop.
"""

import jax
import numpy as np
import pytest
import torch

from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.parallel import MeshPlan as JMeshPlan
from hadoop_tpu.parallel import pipeline as jpipeline
from hadoop_tpu.parallel import train as jtrain
from hadoop_tpu_torch.models import config
from hadoop_tpu_torch.models.convert import params_from_numpy
from hadoop_tpu_torch.parallel import mesh, pipeline, spmd
from hadoop_tpu_torch.parallel.mesh import MeshPlan
from hadoop_tpu_torch.parallel.train import make_train_step, zero1_layout
from hadoop_tpu_torch.tools import dist_plans
from torch_plans import (LR, WORLD, assert_plan_matches,
                         assert_tree_close, assert_tree_close_at, jax_run,
                         job, single)

LOSS_RTOL = 1e-4            # tests/test_parallel.py:143
EIGHT = {"n_layers": 8}     # two layers a chunk at pp2 x vpp2
ADAMW = {"optimizer": "adamw", "steps": 3}

# (id, preset, overrides, plan kwargs, M, schedule, run options)
PLANS = [
    ("pp4_1f1b", "tiny", {}, {"pp": 4}, 4, "1f1b", {}),
    ("pp2_tp2_1f1b", "tiny", {}, {"pp": 2, "tp": 2}, 2, "1f1b", {}),
    ("pp2_tp2_gpipe", "tiny", {}, {"pp": 2, "tp": 2}, 2, "gpipe", {}),
    ("dp2_pp2_1f1b", "tiny", {}, {"dp": 2, "pp": 2}, 2, "1f1b", {}),
    ("dp2_pp2_gpipe", "tiny", {}, {"dp": 2, "pp": 2}, 2, "gpipe", {}),
    ("pp2_tp2_megatron_sp", "tiny", {}, {"pp": 2, "tp": 2,
                                         "megatron_sp": True}, 2, "1f1b",
     {}),
    ("pp2_sp2_ring", "tiny", {}, {"pp": 2, "sp": 2}, 2, "1f1b", {}),
    ("dp2_pp2_vpp2_interleaved", "tiny", {}, {"dp": 2, "pp": 2, "vpp": 2},
     4, "interleaved", {}),
    ("dp2_pp2_vpp2_8_layers", "tiny", EIGHT, {"dp": 2, "pp": 2, "vpp": 2},
     4, "1f1b", {}),
    ("gpt2_pp2_tp2", "tiny-gpt2", {}, {"pp": 2, "tp": 2}, 2, "1f1b", {}),
]
JAX_ONLY = ("tiny-gpt2",)
# port-only legs: plain 1F1B beside the interleaved plan, GPipe and 1F1B
# under full remat, AdamW replicated and ZeRO-1 with pp
EXTRA = [
    ("dp2_pp2_1f1b_m4", "tiny", {}, {"dp": 2, "pp": 2}, 4, "1f1b", {}),
    ("pp2_tp2_gpipe_remat", "tiny", {}, {"pp": 2, "tp": 2}, 2, "gpipe",
     {"remat": "full"}),
    ("pp2_tp2_1f1b_remat", "tiny", {}, {"pp": 2, "tp": 2}, 2, "1f1b",
     {"remat": "full"}),
    ("dp2_pp2_adamw", "tiny", {}, {"dp": 2, "pp": 2}, 2, "1f1b", ADAMW),
    ("dp2_pp2_zero1", "tiny", {}, {"dp": 2, "pp": 2}, 2, "1f1b",
     dict(ADAMW, zero1=True)),
]


@pytest.fixture(scope="module")
def port_runs():
    """Every plan on one gloo world of four ranks: each plan's records on
    every rank."""
    jobs = [job(preset, over, [dict({"plan": plan, "lr": LR,
                                     "n_microbatches": m,
                                     "pipeline_schedule": sched}, **opts)])
            for _, preset, over, plan, m, sched, opts in PLANS + EXTRA]
    recs = spmd.launch(dist_plans.train_plans, WORLD, backend="gloo",
                       args=(jobs,), timeout=600)
    return {p[0]: [r[i] for r in recs]
            for i, p in enumerate(PLANS + EXTRA)}


def _plan(pid):
    return next(p for p in PLANS + EXTRA if p[0] == pid)


@pytest.mark.parametrize("pid", [p[0] for p in PLANS])
def test_plan_matches_jax_and_the_single_device_step(port_runs, pid):
    """Two SGD steps: losses (rtol 1e-4), grad norms and every gathered
    parameter (2e-4) against JAX's same plan and the port's single
    device; the ranks agree on the losses."""
    _, preset, over, plan, m, sched, _ = _plan(pid)
    ranks = port_runs[pid]
    got = ranks[0]
    assert all(r["losses"] == got["losses"] for r in ranks)
    assert got["losses"][-1] < got["losses"][0]
    assert_plan_matches(got, jax_run(preset, over, plan, n_microbatches=m,
                                     schedule=sched), loss_rtol=LOSS_RTOL)
    if preset not in JAX_ONLY:
        assert_plan_matches(got, single(preset, over), loss_rtol=LOSS_RTOL)


def test_interleaved_matches_plain_1f1b(port_runs):
    """The reference's own check: both manual schedules on one plan."""
    inter = port_runs["dp2_pp2_vpp2_interleaved"][0]
    plain = port_runs["dp2_pp2_1f1b_m4"][0]
    np.testing.assert_allclose(inter["losses"], plain["losses"],
                               rtol=LOSS_RTOL)
    assert_tree_close(inter["params"], plain["params"])
    assert_plan_matches(plain, single("tiny", {}), loss_rtol=LOSS_RTOL)


@pytest.mark.parametrize("sched", ["gpipe", "1f1b"])
def test_remat_is_the_same_step(port_runs, sched):
    """Full remat recomputes each layer inside the backward (inside
    1F1B's stage recompute too; its forward half runs without a graph),
    the tp collectives included: the same step as without."""
    a = port_runs[f"pp2_tp2_{sched}_remat"][0]
    b = port_runs[f"pp2_tp2_{sched}"][0]
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-6)
    assert_tree_close(a["params"], b["params"], tol=1e-6)


def test_zero1_with_pp_matches_replicated_adamw(port_runs):
    """ZeRO-1 under dp2 x pp2 (the pp sum reduce-scattered into the dp
    slices) against replicated AdamW on the same plan at the
    reference's rtol 1e-5 / atol 1e-6 (``test_parallel.py:97-107``),
    and against JAX's ZeRO-1 on the same plan at 2e-4."""
    z, r = port_runs["dp2_pp2_zero1"][0], port_runs["dp2_pp2_adamw"][0]
    np.testing.assert_allclose(z["losses"], r["losses"], rtol=1e-5)
    np.testing.assert_allclose(z["grad_norms"], r["grad_norms"], rtol=1e-5)
    assert_tree_close_at(z["params"], r["params"], rtol=1e-5, atol=1e-6)
    assert_plan_matches(z, jax_run("tiny", {}, {"dp": 2, "pp": 2}, steps=3,
                                   optimizer="adamw", zero1=True,
                                   n_microbatches=2), loss_rtol=LOSS_RTOL)


@pytest.mark.parametrize("pid", [p[0] for p in PLANS + EXTRA])
def test_each_rank_keeps_its_stage_and_the_stash_bound(port_runs, pid):
    """Each rank's stage is its pp coordinate, and its schedule stashed
    at most as many stage inputs at once as its clock says: min(M, 2(P
    - s) - 1) under 1F1B (at most 2P - 1), the clock's own count under
    the interleaved one (at most 2V), and all M under GPipe."""
    _, _, _, plan, m, sched, _ = _plan(pid)
    p_size, v = plan["pp"], plan.get("vpp", 1)
    clock = pipeline.make_clock(sched, m, p_size, v)
    for rank, rec in enumerate(port_runs[pid]):
        coords = np.unravel_index(rank, tuple(
            MeshPlan(**plan).sizes.values()))
        stage = int(coords[1])
        assert rec["stage"] == stage
        want = _stash_peak(clock, stage)
        assert rec["stash_peak"] == [want] * len(rec["losses"])
        if sched == "gpipe":
            assert want == m
        elif v == 1:
            assert want == min(m, 2 * (p_size - stage) - 1) <= 2 * p_size - 1
        else:
            assert want <= 2 * v * p_size


def _stash_peak(clock, s):
    live, peak = set(), 0
    for t in range(clock.n_ticks):
        f, b = clock.fwd(s, t), clock.bwd(s, t)
        if f is not None:
            live.add(f)
            peak = max(peak, len(live))
        if b is not None:
            live.remove(b)
    return peak


@pytest.mark.parametrize("sched, m, p_size, v", [
    ("1f1b", 4, 4, 1), ("1f1b", 1, 2, 1), ("1f1b", 3, 2, 1),
    ("gpipe", 4, 4, 1), ("gpipe", 3, 2, 1), ("interleaved", 4, 2, 2),
    ("interleaved", 2, 2, 2), ("interleaved", 6, 3, 2),
    ("interleaved", 8, 4, 2), ("interleaved", 4, 2, 3),
    ("1f1b", 4, 2, 2)])
def test_clock_runs_each_microbatch_through_each_stage_once(sched, m,
                                                            p_size, v):
    """Each (microbatch, virtual stage) forward and backward exactly once
    on its rank; a forward one tick after the previous stage's (the hop
    in between), a backward one tick after the next stage's, never
    before its own forward; the ticks the reference's clocks give."""
    clock = pipeline.make_clock(sched, m, p_size, v)
    n_v = v * p_size
    fwd, bwd = {}, {}
    for t in range(clock.n_ticks):
        for s in range(p_size):
            for coords, seen in ((clock.fwd(s, t), fwd),
                                 (clock.bwd(s, t), bwd)):
                if coords is not None:
                    key = (coords[0], coords[1] * p_size + s)
                    assert key not in seen
                    seen[key] = t
    every = {(mb, q) for mb in range(m) for q in range(n_v)}
    assert set(fwd) == set(bwd) == every
    for mb, q in every:
        if q:
            assert fwd[mb, q] == fwd[mb, q - 1] + 1
        if q < n_v - 1:
            assert bwd[mb, q] == bwd[mb, q + 1] + 1
        assert bwd[mb, q] >= fwd[mb, q]
    want = {"1f1b": m + 2 * p_size - 2, "gpipe": 2 * (m + p_size - 1)}
    assert clock.n_ticks == (want[sched] if v == 1 and sched in want else
                             (m // p_size + 2) * n_v + p_size - 1)


@pytest.mark.parametrize("n_layers, p_size, v", [
    (4, 2, 2), (8, 2, 2), (12, 3, 2), (16, 2, 4), (8, 4, 2), (6, 1, 3)])
def test_interleaved_layer_permutation_matches_jax(n_layers, p_size, v):
    assert pipeline.interleaved_layer_permutation(n_layers, p_size, v) == \
        jpipeline.interleaved_layer_permutation(n_layers, p_size, v)


def test_layer_order_round_trips_and_matches_jax():
    """``physical_layer_order`` lays the stack out as JAX's does, and
    ``logical_layer_order`` undoes it."""
    cfg = config.get_config("tiny", **EIGHT)
    jcfg = jconfig.get_config("tiny", **EIGHT)
    tree = jax.tree_util.tree_map(
        np.asarray, jdecoder.init_params(jax.random.PRNGKey(0), jcfg))
    plan, jplan = MeshPlan(pp=2, vpp=2), JMeshPlan(pp=2, vpp=2)
    params = params_from_numpy(tree, cfg, device="cpu")
    phys = mesh.physical_layer_order(params, cfg, plan)
    want = jtrain.physical_layer_order(tree, jcfg, jplan)
    for key in tree["layers"]:
        np.testing.assert_array_equal(phys["layers"][key].numpy(),
                                      np.asarray(want["layers"][key]))
    back = mesh.logical_layer_order(phys, cfg, plan)
    for key in tree["layers"]:
        assert torch.equal(back["layers"][key], params["layers"][key])
    assert mesh.physical_layer_order(params, cfg, MeshPlan(pp=2)) is params


def test_interleaved_refuses_microbatches_not_divisible_by_pp():
    """M % pp != 0 raises the reference's ValueError, at build time."""
    cfg = config.get_config("tiny")
    with pytest.raises(ValueError, match="divisible by pp"):
        make_train_step(cfg, MeshPlan(pp=2, vpp=2), n_microbatches=1,
                        device="cpu")
    with pytest.raises(ValueError, match="divisible by pp"):
        make_train_step(cfg, MeshPlan(pp=2), n_microbatches=3,
                        pipeline_schedule="interleaved", device="cpu")
    with pytest.raises(ValueError, match="pipeline_schedule"):
        make_train_step(cfg, MeshPlan(pp=2), n_microbatches=2,
                        pipeline_schedule="zb-h1", device="cpu")


@pytest.mark.parametrize("plan", [{"dp": 2, "pp": 2}, {"pp": 2, "tp": 2},
                                  {"dp": 2, "pp": 2, "tp": 2}])
def test_zero1_layout_with_pp_matches_jax(plan):
    cfg, jcfg = config.get_config("tiny"), jconfig.get_config("tiny")
    axes, shapes, _, sizes = zero1_layout(cfg, MeshPlan(**plan))
    jaxes, jshapes, _, jsizes = jtrain.zero1_layout(jcfg, JMeshPlan(**plan))
    is_tuple = lambda x: isinstance(x, tuple)  # noqa: E731
    assert axes == jax.tree_util.tree_map(lambda a: a, jaxes,
                                          is_leaf=is_tuple)
    assert shapes == jax.tree_util.tree_map(lambda s: s, jshapes,
                                            is_leaf=is_tuple)
    assert sizes == jsizes
