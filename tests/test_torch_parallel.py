"""The port's parallel training plans against the JAX package's.

The plans of ``tests/test_parallel.py`` that need no pipeline and no
expert axis: dp x tp, tp with Megatron sequence parallelism, sp as ring
and as Ulysses, each composed with dp and with tp, and ZeRO-1 with and
without model parallelism. The port trains each on four gloo ranks on
the CPU (one world, started once by ``spmd.launch``; the ranks import
the port and torch only) from the JAX package's ``init_params`` weights
carried by ``params_from_numpy``, on the reference's batch (8 x 32) and
learning rate; the JAX package trains the same plan on the virtual
8-device mesh, and the port's single-device step trains the whole batch.
Losses and every gathered parameter are held against both at
``_assert_tree_close``'s 2e-4 (``tests/test_parallel.py``).

gpt2's row-parallel biases: the JAX package adds the replicated bias to
every tp rank's partial product, so its tp plans count it tp times
(after two steps its ``b_out`` is 6.8e-4 from its own single-device
step's). The port matches the reference (ROADMAP Queue C records the
fault), so the gpt2 plans are held against JAX's same plan only.

AdamW's first updates are g / (|g| + eps), which turns rounding noise in
a near-zero gradient into a full-size step, so an elementwise comparison
of AdamW plans depends on the data (on the reference's batch here every
element agrees at 2e-4; on another seed dp2 x tp2 had 4 of 1.3e5
elements over it). The ZeRO-1 plans are held to the reference's own
check, against replicated AdamW on the same plan, and beside it to JAX's
ZeRO-1 and the single-device step at 2e-4.
"""

import dataclasses

import jax
import numpy as np
import pytest

from hadoop_tpu.models import config as jconfig
from hadoop_tpu.parallel import MeshPlan as JMeshPlan
from hadoop_tpu.parallel import mesh as jmesh
from hadoop_tpu.parallel import train as jtrain
from hadoop_tpu_torch.models import config
from hadoop_tpu_torch.parallel import mesh, spmd
from hadoop_tpu_torch.parallel.train import zero1_layout
from hadoop_tpu_torch.tools import dist_plans
from torch_plans import (BATCH, LR, SEQ, TOL, WORLD, assert_tree_close,
                         assert_tree_close_at, assert_tree_equal, jax_run,
                         job, single)

HEADS8 = {"n_heads": 8, "n_kv_heads": 4}   # Ulysses x tp needs kv % 4

# (id, preset, overrides, plan kwargs, run options)
PLANS = [
    ("dp2_tp2", "tiny", {}, {"dp": 2, "tp": 2}, {}),
    ("dp2_tp2_sp", "tiny", {}, {"dp": 2, "tp": 2, "megatron_sp": True}, {}),
    ("dp2_sp2_ring", "tiny", {}, {"dp": 2, "sp": 2}, {}),
    ("dp2_sp2_ulysses", "tiny", {}, {"dp": 2, "sp": 2,
                                     "sp_mode": "ulysses"}, {}),
    ("tp2_sp2_ring", "tiny", {}, {"tp": 2, "sp": 2}, {}),
    ("tp2_sp2_ulysses", "tiny", HEADS8, {"tp": 2, "sp": 2,
                                         "sp_mode": "ulysses"}, {}),
    ("gpt2_dp2_tp2_sp", "tiny-gpt2", {}, {"dp": 2, "tp": 2,
                                         "megatron_sp": True}, {}),
    ("gpt2_tp2_sp2_ring", "tiny-gpt2", {}, {"tp": 2, "sp": 2}, {}),
    ("moe_dp2_sp2_ring", "tiny-moe", {}, {"dp": 2, "sp": 2}, {}),
]
# held against JAX's same plan only: gpt2's tp plans count the row-parallel
# bias tp times (above); a MoE rank routes its own tokens at the capacity
# of their count, as each rank of the reference's shard_map does, so its
# drops are not the whole batch's
JAX_ONLY = ("tiny-gpt2", "tiny-moe")
SGD_IDS = [p[0] for p in PLANS]
ADAMW = {"optimizer": "adamw", "steps": 3}
# port-only legs: remat, overlap off, AdamW replicated and ZeRO-1
EXTRA = [
    ("dp2_tp2_sp_remat", "tiny", {}, {"dp": 2, "tp": 2, "megatron_sp": True},
     {"remat": "full"}),
    ("dp2_tp2_sp_overlap_off", "tiny", {}, {"dp": 2, "tp": 2,
                                           "megatron_sp": True},
     {"overlap": False}),
    ("dp4_adamw", "tiny", {}, {"dp": 4}, ADAMW),
    ("dp4_zero1", "tiny", {}, {"dp": 4}, dict(ADAMW, zero1=True)),
    ("dp4_zero1_overlap_off", "tiny", {}, {"dp": 4},
     dict(ADAMW, zero1=True, overlap=False)),
    ("dp2_tp2_adamw", "tiny", {}, {"dp": 2, "tp": 2}, ADAMW),
    ("dp2_tp2_zero1", "tiny", {}, {"dp": 2, "tp": 2},
     dict(ADAMW, zero1=True)),
]


@pytest.fixture(scope="module")
def port_runs():
    """Every plan (PLANS and EXTRA) on one gloo world of four ranks."""
    jobs, ids = [], []
    for pid, preset, over, plan, opts in PLANS + EXTRA:
        jobs.append(job(preset, over, [dict({"plan": plan, "lr": LR},
                                            **opts)]))
        ids.append(pid)
    recs = spmd.launch(dist_plans.train_plans, WORLD, backend="gloo",
                       args=(jobs,),
                       timeout=600)[0]
    return dict(zip(ids, recs))


@pytest.mark.parametrize("pid", SGD_IDS)
def test_plan_matches_jax_and_the_single_device_step(port_runs, pid):
    """Two SGD steps: losses and every gathered parameter against JAX's
    same plan on the virtual mesh and against the port's single-device
    step."""
    _, preset, over, plan, _ = next(p for p in PLANS if p[0] == pid)
    got = port_runs[pid]
    j_losses, j_norms, j_params = jax_run(preset, over, plan)
    np.testing.assert_allclose(got["losses"], j_losses, rtol=TOL)
    np.testing.assert_allclose(got["grad_norms"], j_norms, rtol=TOL)
    assert_tree_close(got["params"], j_params)
    assert got["losses"][-1] < got["losses"][0]
    if preset in JAX_ONLY:
        return
    s_losses, s_norms, s_params = single(preset, over)
    np.testing.assert_allclose(got["losses"], s_losses, rtol=TOL)
    np.testing.assert_allclose(got["grad_norms"], s_norms, rtol=TOL)
    assert_tree_close(got["params"], s_params)


def test_remat_replays_the_collectives_in_order(port_runs):
    """Full remat recomputes each layer, its Megatron gathers included,
    in the backward: the same step as without."""
    assert_tree_close(port_runs["dp2_tp2_sp_remat"]["params"],
                       port_runs["dp2_tp2_sp"]["params"], tol=1e-6)
    np.testing.assert_allclose(port_runs["dp2_tp2_sp_remat"]["losses"],
                               port_runs["dp2_tp2_sp"]["losses"], rtol=1e-6)


@pytest.mark.parametrize("on, off", [("dp2_tp2_sp", "dp2_tp2_sp_overlap_off"),
                                     ("dp4_zero1", "dp4_zero1_overlap_off")])
def test_overlap_on_and_off_give_the_same_bits(port_runs, on, off):
    """Chunked tp reduces, bucketed gradient sums and the ZeRO-1
    reduce-scatter and bucketed gather against one collective per leaf
    and whole reduces: the same losses, norms and parameters, bit for
    bit."""
    a, b = port_runs[on], port_runs[off]
    assert a["losses"] == b["losses"] and a["grad_norms"] == b["grad_norms"]
    assert_tree_equal(a["params"], b["params"])


@pytest.mark.parametrize("zero1, replicated, plan", [
    ("dp4_zero1", "dp4_adamw", {"dp": 4}),
    ("dp2_tp2_zero1", "dp2_tp2_adamw", {"dp": 2, "tp": 2})])
def test_zero1_matches_replicated_adamw(port_runs, zero1, replicated, plan):
    """ZeRO-1's sliced moments give replicated AdamW's step at the
    reference's tolerances (the norm, summed slice by slice, may move an
    ulp); three AdamW steps' losses, gradient norms and every gathered
    parameter agree with JAX's ZeRO-1 on the same plan and with the
    port's single-device step."""
    z, r = port_runs[zero1], port_runs[replicated]
    np.testing.assert_allclose(z["losses"], r["losses"], rtol=1e-5)
    np.testing.assert_allclose(z["grad_norms"], r["grad_norms"], rtol=1e-5)
    assert_tree_close_at(z["params"], r["params"], rtol=1e-5, atol=1e-6)
    j_losses, j_norms, j_params = jax_run("tiny", {}, plan, steps=3,
                                           optimizer="adamw", zero1=True)
    s_losses, s_norms, s_params = single("tiny", {}, steps=3,
                                          optimizer="adamw")
    for losses, norms, params in ((j_losses, j_norms, j_params),
                                  (s_losses, s_norms, s_params)):
        np.testing.assert_allclose(z["losses"], losses, rtol=TOL)
        np.testing.assert_allclose(z["grad_norms"], norms, rtol=TOL)
        assert_tree_close(z["params"], params)


def test_ulysses_matches_ring(port_runs):
    ring, uly = port_runs["dp2_sp2_ring"], port_runs["dp2_sp2_ulysses"]
    np.testing.assert_allclose(uly["losses"], ring["losses"], rtol=1e-5)
    assert_tree_close(uly["params"], ring["params"])


@pytest.mark.parametrize("preset", ["tiny", "tiny-gpt2", "tiny-moe"])
def test_param_specs_match_jax(preset):
    cfg, jcfg = config.get_config(preset), jconfig.get_config(preset)
    plan = dict(dp=2, tp=2, ep=2) if cfg.is_moe else dict(dp=2, tp=2)
    want = jax.tree_util.tree_map(
        lambda s: tuple(s), jmesh.param_specs(jcfg, JMeshPlan(**plan)),
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert mesh.param_specs(cfg, mesh.MeshPlan(**plan)) == want


@pytest.mark.parametrize("plan", [{"dp": 8}, {"dp": 2, "tp": 2},
                                  {"dp": 2, "sp": 2, "tp": 2}])
def test_zero1_layout_matches_jax(plan):
    cfg, jcfg = config.get_config("tiny"), jconfig.get_config("tiny")
    axes, shapes, specs, sizes = zero1_layout(cfg, mesh.MeshPlan(**plan))
    jaxes, jshapes, jspecs, jsizes = jtrain.zero1_layout(
        jcfg, JMeshPlan(**plan))
    is_tuple = lambda x: isinstance(x, tuple)  # noqa: E731
    assert axes == jax.tree_util.tree_map(lambda a: a, jaxes,
                                          is_leaf=is_tuple)
    assert shapes == jax.tree_util.tree_map(lambda s: s, jshapes,
                                            is_leaf=is_tuple)
    assert specs == jax.tree_util.tree_map(
        lambda s: tuple(a for a in s if a is not None), jspecs,
        is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec))
    assert sizes == jsizes


def test_validate_matches_jax():
    """The same plan/config mismatches raise in both packages."""
    cfg, jcfg = config.get_config("tiny"), jconfig.get_config("tiny")
    cases = [(dict(dp=2, tp=3), BATCH, SEQ),
             (dict(dp=2, tp=2, sp=2, sp_mode="ulysses"), BATCH, SEQ),
             (dict(sp=8, sp_mode="ulysses"), BATCH, 64),
             (dict(dp=3), BATCH, SEQ), (dict(sp=3), BATCH, SEQ),
             (dict(dp=2, tp=2), BATCH, SEQ), (dict(sp=2), BATCH, SEQ)]
    for kw, b, s in cases:
        outcomes = []
        for cls, c in ((mesh.MeshPlan, cfg), (JMeshPlan, jcfg)):
            try:
                cls(**kw).validate(c, b, s)
                outcomes.append(None)
            except ValueError as e:
                outcomes.append(str(e).split(" (plan=")[0])
        assert outcomes[0] == outcomes[1], kw
    assert dataclasses.asdict(mesh.MeshPlan(dp=2, tp=2)) == \
        dataclasses.asdict(JMeshPlan(dp=2, tp=2))
    assert mesh.MeshPlan(ep=2).batch_axes == ("dp", "ep")
    assert mesh.MeshPlan(tp=2, megatron_sp=True).data_axes == \
        ("dp", "sp", "tp")
