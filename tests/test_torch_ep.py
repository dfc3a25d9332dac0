"""The port's expert-parallel MoE plans against the JAX package's.

``tests/test_parallel.py``'s MoE plan cut to four ranks: dp2 x ep2,
ep2 x tp2 and ep4 on ``tiny-moe`` at capacity factor 4.0, where no
token is dropped (a rank routes its own tokens, at the capacity of
their count, so at a lower factor its drops are not the whole batch's;
``test_parallel.py:183-190`` uses 4.0 for that reason). Each plan's
losses (rtol 1e-4) and every gathered parameter (2e-4) are held against
JAX's same plan on the virtual 8-device mesh and against the port's
single-device step; the preset's factor 1.25 against JAX's same plan
(the same per-rank drops); ep2 x tp2 with Megatron-SP and ZeRO-1 over
(dp, ep) against the single device and replicated AdamW.
"""

import jax
import numpy as np
import pytest
import torch

from hadoop_tpu.models import config as jconfig
from hadoop_tpu.parallel import MeshPlan as JMeshPlan
from hadoop_tpu.parallel import train as jtrain
from hadoop_tpu_torch.models import config, decoder, moe
from hadoop_tpu_torch.parallel import spmd
from hadoop_tpu_torch.parallel.mesh import MeshPlan
from hadoop_tpu_torch.parallel.train import zero1_layout
from hadoop_tpu_torch.tools import dist_plans
from torch_plans import (LR, WORLD, assert_plan_matches,
                         assert_tree_close_at, jax_run, job, single)

LOSS_RTOL = 1e-4
NO_DROPS = {"capacity_factor": 4.0}
ADAMW = {"optimizer": "adamw", "steps": 3}

# (id, overrides, plan kwargs, run options)
PLANS = [
    ("dp2_ep2", NO_DROPS, {"dp": 2, "ep": 2}, {}),
    ("ep2_tp2", NO_DROPS, {"ep": 2, "tp": 2}, {}),
    ("ep4", NO_DROPS, {"ep": 4}, {}),
    ("dp2_ep2_drops", {}, {"dp": 2, "ep": 2}, {}),
]
EXTRA = [
    ("ep2_tp2_megatron_sp", NO_DROPS, {"ep": 2, "tp": 2,
                                       "megatron_sp": True}, {}),
    ("dp2_ep2_adamw", NO_DROPS, {"dp": 2, "ep": 2}, ADAMW),
    ("dp2_ep2_zero1", NO_DROPS, {"dp": 2, "ep": 2}, dict(ADAMW, zero1=True)),
]


@pytest.fixture(scope="module")
def port_runs():
    """Every plan on one gloo world of four ranks (rank 0's records)."""
    jobs = [job("tiny-moe", over, [dict({"plan": plan, "lr": LR}, **opts)])
            for _, over, plan, opts in PLANS + EXTRA]
    recs = spmd.launch(dist_plans.train_plans, WORLD, backend="gloo",
                       args=(jobs,), timeout=600)[0]
    return {p[0]: rec for p, rec in zip(PLANS + EXTRA, recs)}


@pytest.mark.parametrize("pid", [p[0] for p in PLANS])
def test_plan_matches_jax_and_the_single_device_step(port_runs, pid):
    _, over, plan, _ = next(p for p in PLANS if p[0] == pid)
    got = port_runs[pid]
    assert got["losses"][-1] < got["losses"][0]
    assert_plan_matches(got, jax_run("tiny-moe", over, plan),
                        loss_rtol=LOSS_RTOL)
    if over is NO_DROPS:
        assert got["dropped_share"] == [0.0, 0.0]
        assert_plan_matches(got, single("tiny-moe", over),
                            loss_rtol=LOSS_RTOL)
    else:
        assert all(0.0 <= d < 0.5 for d in got["dropped_share"])


def test_moe_under_megatron_sp_is_the_single_device_step(port_runs):
    """The router's gradient sums over tp once: through the tp data
    axis under Megatron-SP, through ``copy_to`` under plain tp."""
    assert_plan_matches(port_runs["ep2_tp2_megatron_sp"],
                        single("tiny-moe", NO_DROPS), loss_rtol=LOSS_RTOL)


def test_zero1_over_dp_and_ep_matches_replicated_adamw(port_runs):
    """ZeRO-1 slices a non-expert leaf's moments over (dp, ep) and an
    expert leaf's over dp: replicated AdamW's step at the reference's
    tolerances."""
    z, r = port_runs["dp2_ep2_zero1"], port_runs["dp2_ep2_adamw"]
    np.testing.assert_allclose(z["losses"], r["losses"], rtol=1e-5)
    np.testing.assert_allclose(z["grad_norms"], r["grad_norms"], rtol=1e-5)
    assert_tree_close_at(z["params"], r["params"], rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("plan", [{"dp": 2, "ep": 2}, {"ep": 2, "tp": 2},
                                  {"dp": 2, "ep": 4}])
def test_zero1_layout_with_ep_matches_jax(plan):
    cfg, jcfg = config.get_config("tiny-moe"), jconfig.get_config("tiny-moe")
    axes, shapes, _, sizes = zero1_layout(cfg, MeshPlan(**plan))
    jaxes, jshapes, _, jsizes = jtrain.zero1_layout(jcfg, JMeshPlan(**plan))
    is_tuple = lambda x: isinstance(x, tuple)  # noqa: E731
    assert axes == jax.tree_util.tree_map(lambda a: a, jaxes,
                                          is_leaf=is_tuple)
    assert shapes == jax.tree_util.tree_map(lambda s: s, jshapes,
                                            is_leaf=is_tuple)
    assert sizes == jsizes


def test_expert_axis_is_a_process_group_and_drops_are_counted():
    """The ctx takes an ep axis only as a process group; ``moe.drops``
    records each routing's choices and those kept, and nothing while it
    is None."""
    with pytest.raises(ValueError, match="process group"):
        decoder.ParallelCtx(ep=spmd.folded("ep", 2))
    cfg = config.get_config("tiny-moe", capacity_factor=0.5)
    gen = torch.Generator().manual_seed(0)
    params = decoder.init_params(cfg, gen, device="cpu")
    lp = {k: v[0] for k, v in params["layers"].items()}
    h = torch.randn(2, 16, cfg.d_model, generator=gen)
    moe.drops = []
    try:
        moe.moe_mlp(h, lp, cfg)
        (choices, kept), = moe.drops
    finally:
        moe.drops = None
    dispatch, _ = moe.route(h.reshape(32, -1), lp["router"], cfg)
    assert choices == 32 * cfg.top_k
    assert float(kept) == float(dispatch.sum()) < choices
    moe.moe_mlp(h, lp, cfg)
    assert moe.drops is None
