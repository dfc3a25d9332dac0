"""The port's host-side reshard functions against the JAX package's.

``hadoop_tpu_torch/parallel/elastic/reshard.py`` on random numpy arrays
against ``hadoop_tpu/parallel/elastic/reshard.py``, bit for bit, in the
cases of ``tests/test_elastic.py``: replicated leaves, padded slices,
dp8 → dp6, a leaf sharded across dp, a tuple axis, a shape mismatch
refused, the same-plan passthrough, ZeRO-1 ⇄ plain, and the manifest
plan block. Plain functions: no world, no trainer.
"""

import dataclasses

import numpy as np
import pytest
from jax.sharding import PartitionSpec as P

from hadoop_tpu.parallel import MeshPlan as JMeshPlan
from hadoop_tpu.parallel.elastic import reshard as jreshard
from hadoop_tpu.parallel.optimizer import AdamWState as JAdamWState
from hadoop_tpu_torch.models import config
from hadoop_tpu_torch.parallel.elastic import reshard
from hadoop_tpu_torch.parallel.mesh import MeshPlan, param_specs
from hadoop_tpu_torch.parallel.optimizer import AdamWState
from hadoop_tpu_torch.parallel.train import zero1_layout


def _plans(**kw):
    return MeshPlan(**kw), JMeshPlan(**kw)


def _jspec(spec):
    return P(*spec)


def _rand(seed, shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# (id, spec, global shape, plan A kwargs, plan B kwargs)
CASES = [
    ("replicated_dp8", (), (12, 4), {"dp": 8}, {"dp": 4}),
    ("padded_dp8", (), (10,), {"dp": 8}, {"dp": 2}),
    ("dp8_to_dp6", (), (12, 5), {"dp": 8}, {"dp": 6}),
    ("sharded_across_dp", ("tp", None), (8, 6), {"dp": 4, "tp": 2},
     {"dp": 2, "tp": 2}),
    ("tuple_axis", (("pp", "tp"),), (8, 4), {"dp": 2, "pp": 2, "tp": 2},
     {"pp": 2, "tp": 2}),
    ("layer_stack", ("pp", None, "tp"), (4, 6, 8), {"dp": 2, "tp": 2},
     {"dp": 4}),
    ("ep_batch_axis", ("pp", "ep", None, "tp"), (2, 4, 6, 4),
     {"dp": 2, "ep": 2}, {"ep": 2, "tp": 2}),
]


@pytest.mark.parametrize("name,spec,shape,a,b", CASES,
                         ids=[c[0] for c in CASES])
def test_zero1_conversions_are_the_references(name, spec, shape, a, b):
    (pa, ja), (pb, jb) = _plans(**a), _plans(**b)
    g = _rand(len(name), shape)
    state = reshard.global_to_zero1_state(g, spec, pa)
    want = jreshard.global_to_zero1_state(g, _jspec(spec), ja)
    assert state.shape == want.shape and state.dtype == want.dtype
    np.testing.assert_array_equal(state, want)
    back = reshard.zero1_state_to_global(state, spec, shape, pa)
    np.testing.assert_array_equal(
        back, jreshard.zero1_state_to_global(want, _jspec(spec), shape, ja))
    np.testing.assert_array_equal(back, g)
    moved = reshard.reshard_zero1_leaf(state, spec, shape, pa, pb)
    np.testing.assert_array_equal(moved, jreshard.reshard_zero1_leaf(
        want, _jspec(spec), shape, ja, jb))
    np.testing.assert_array_equal(
        reshard.zero1_state_to_global(moved, spec, shape, pb), g)


def test_padding_tail_stays_zero():
    pa, ja = _plans(dp=8)
    g = np.arange(10, dtype=np.float32)
    state = reshard.global_to_zero1_state(g, (), pa)
    assert state.shape == (8, 2) and state.sum() == g.sum()
    np.testing.assert_array_equal(state, jreshard.global_to_zero1_state(
        g, P(), ja))


@pytest.mark.parametrize("spec,shape,kw", [
    ((), (13, 7), {"dp": 8}), (("tp", None), (8, 6), {"dp": 4, "tp": 2}),
    ((("pp", "tp"),), (8, 4), {"dp": 2, "pp": 2, "tp": 2})],
    ids=["replicated", "sharded", "tuple_axis"])
def test_leaf_geometry_is_the_references(spec, shape, kw):
    pa, ja = _plans(**kw)
    got = reshard._leaf_geometry(spec, shape, pa)
    want = jreshard._leaf_geometry(_jspec(spec), shape, ja)
    assert got[0] == want[0] and got[1] == want[1]
    assert got[2:] == want[2:]
    assert reshard._plan_sizes(pa) == jreshard._plan_sizes(ja)
    assert reshard._sharded_dims(spec) == jreshard._sharded_dims(
        _jspec(spec))
    for coords in np.ndindex(*got[2]):
        assert reshard._block_slices(coords, got[0], shape, got[1]) == \
            jreshard._block_slices(coords, want[0], shape, want[1])
    assert reshard.zero1_state_shape(spec, shape, pa) == \
        jreshard.global_to_zero1_state(np.zeros(shape, np.float32),
                                       _jspec(spec), ja).shape


def test_shape_mismatch_refused_as_the_reference():
    pa, ja = _plans(dp=8)
    bad = np.zeros((4, 2), np.float32)
    with pytest.raises(ValueError, match="does not match plan layout"):
        reshard.zero1_state_to_global(bad, (), (12,), pa)
    with pytest.raises(ValueError, match="does not match plan layout"):
        jreshard.zero1_state_to_global(bad, P(), (12,), ja)
    with pytest.raises(ValueError, match="not divisible"):
        reshard.global_to_zero1_state(np.zeros((3, 4), np.float32),
                                      ("tp", None), MeshPlan(tp=2))


def _opt_pair(seed, shapes, specs, plan, jplan, zero1):
    """The same moments as a port and a reference AdamWState (ZeRO-1
    layout with ``zero1``)."""
    mu, jmu, nu, jnu = {}, {}, {}, {}
    for i, (k, shape) in enumerate(shapes.items()):
        g = _rand(seed + i, shape)
        h = _rand(seed + 100 + i, shape)
        if zero1:
            g = reshard.global_to_zero1_state(g, specs[k], plan)
            h = reshard.global_to_zero1_state(h, specs[k], plan)
        mu[k], jmu[k], nu[k], jnu[k] = g, g.copy(), h, h.copy()
    return (AdamWState(np.int32(3), mu, nu),
            JAdamWState(np.int32(3), jmu, jnu))


@pytest.mark.parametrize("za,zb", [(True, True), (True, False),
                                   (False, True), (False, False)],
                         ids=["z1_z1", "z1_plain", "plain_z1",
                              "plain_plain"])
def test_reshard_opt_state_is_the_references(za, zb):
    shapes = {"w": (8, 6), "b": (6,), "s": (4, 6, 8)}
    specs = {"w": ("tp", None), "b": (), "s": ("pp", None, "tp")}
    jspecs = {k: _jspec(v) for k, v in specs.items()}
    (pa, ja), (pb, jb) = _plans(dp=4, tp=2), _plans(dp=2, tp=2)
    opt, jopt = _opt_pair(7, shapes, specs, pa, ja, za)
    got = reshard.reshard_opt_state(opt, shapes, specs, pa, pb,
                                    zero1_a=za, zero1_b=zb)
    want = jreshard.reshard_opt_state(
        jopt, {k: np.zeros(s, np.float32) for k, s in shapes.items()},
        jspecs, ja, jb, zero1_a=za, zero1_b=zb)
    assert int(got.count) == int(want.count)
    for k in shapes:
        np.testing.assert_array_equal(got.mu[k], want.mu[k])
        np.testing.assert_array_equal(got.nu[k], want.nu[k])


def test_same_plan_is_the_untouched_passthrough():
    pa, _ = _plans(dp=4)
    state = reshard.global_to_zero1_state(np.ones(8, np.float32), (), pa)
    opt = AdamWState(7, {"w": state}, {"w": state})
    assert reshard.reshard_opt_state(opt, {"w": (8,)}, {"w": ()}, pa, pa,
                                     zero1_a=True, zero1_b=True) is opt
    with pytest.raises(ValueError, match="pipeline stage count"):
        reshard.reshard_opt_state(opt, {"w": (8,)}, {"w": ()}, pa,
                                  MeshPlan(dp=2, pp=2), zero1_a=True,
                                  zero1_b=True)


def test_zero1_layout_is_the_state_layout():
    """The train step's ZeRO-1 layout (each rank one (K,) row) has the
    global shape the reshard functions read and write, for every leaf
    of a model under a tp plan and an ep plan."""
    for preset, kw in (("tiny", {"dp": 2, "tp": 2}),
                       ("tiny-moe", {"dp": 2, "ep": 2})):
        cfg = config.get_config(preset)
        plan = MeshPlan(**kw)
        _, shape_tree, _, _ = zero1_layout(cfg, plan)
        specs = param_specs(cfg, plan)
        from hadoop_tpu_torch.models.decoder import init_params
        from hadoop_tpu_torch.parallel.optimizer import tree_leaves
        shapes = init_params(cfg, None, device="meta")
        for want, spec, p in zip(tree_leaves(shape_tree), tree_leaves(
                specs), tree_leaves(shapes)):
            got = reshard.global_to_zero1_state(
                np.zeros(tuple(p.shape), np.float32), spec, plan).shape
            assert got == tuple(want), (spec, p.shape)


def test_manifest_block_is_the_references():
    for kw, z1 in (({}, False), ({"dp": 2, "tp": 2}, True),
                   ({"dp": 2, "pp": 2, "vpp": 2}, False)):
        pa, ja = _plans(**kw)
        meta = reshard.manifest_meta(pa, zero1=z1)
        assert meta == jreshard.manifest_meta(ja, zero1=z1)
        assert reshard.plan_from_meta(meta) == pa
        assert dataclasses.asdict(jreshard.plan_from_meta(meta)) == \
            dataclasses.asdict(pa)
    with pytest.raises(ValueError, match="unknown checkpoint meta"):
        reshard.plan_from_meta(dict(meta, format="htpu-ckpt-plan-99"))
    assert reshard.MANIFEST_FORMAT == jreshard.MANIFEST_FORMAT
