"""The port's Trainer on a mesh against the JAX package's, on the CPU.

One gloo world of four ranks for the file (``spmd.launch`` with
``spawn``; the rank program is ``dist_plans.trainer_ops``) runs the
port's side; the JAX package's ``Trainer`` runs on the virtual mesh in
this process. ``tiny`` in float32 at ``max_seq`` 32, batch 8, one token
file made from a numpy seed, on one directory that both packages reach
through their own ``LocalFileSystem``. Checked:

- a ZeRO-1 dp2×tp2 checkpoint of the reference restores in the port,
  and one of the port in the reference: assembled leaves and data
  cursor bit-equal, the next losses within ``TOL`` of the other
  package's uninterrupted run;
- the saved ZeRO-1 layout: moments set from ``arange`` and saved by the
  port read back through the reference's ``zero1_state_to_global`` as
  they were set;
- the port's own resumes (dp2×tp2, ZeRO-1 dp4, dp2×pp2×vpp2, each with
  an interval save in flight when the run crashes) continue the curve
  bit for bit;
- a trainer's leaf-by-leaf initialisation is ``init_sharded`` of the
  full tree, bit for bit (those plans and ZeRO-1 dp2×tp2);
- cross-plan restores (dp2×tp2 → dp4, ZeRO-1 dp4 → ZeRO-1 dp2×tp2, and
  the port's ZeRO-1 dp4 in the reference at dp2): the moments bit-equal
  to the reference's ``reshard_opt_state`` on the same loaded arrays;
- an interleaved plan's checkpoint holds logical layer order: it
  assembles equal to the same state's pp2 checkpoint and to the live
  parameters gathered in logical order;
- the loader places a rank's shards (``shard_params`` of the full load);
- the comm ledger's per-site bytes a step are the reference's traced
  profile for dp2×tp2 (with and without ZeRO-1), ZeRO-1 dp4 and
  dp2×pp2, and the wire bytes on dp are the ledger's plus the scalars.
"""

import jax
import numpy as np
import pytest
import torch

from hadoop_tpu.fs.filesystem import LocalFileSystem as JLocalFileSystem
from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.obs import comm as jcomm
from hadoop_tpu.parallel import MeshPlan as JMeshPlan
from hadoop_tpu.parallel import checkpoint as jckpt
from hadoop_tpu.parallel.elastic import reshard as jreshard
from hadoop_tpu.parallel.mesh import param_specs as jparam_specs
from hadoop_tpu.parallel.optimizer import AdamWState as JAdamWState
from hadoop_tpu.parallel.trainer import Trainer as JTrainer
from hadoop_tpu_torch.fs import LocalFileSystem
from hadoop_tpu_torch.models import config
from hadoop_tpu_torch.models.decoder import init_params
from hadoop_tpu_torch.parallel import checkpoint as ckpt
from hadoop_tpu_torch.parallel import spmd
from hadoop_tpu_torch.parallel.mesh import (AXES, Mesh, MeshPlan,
                                            param_specs, shard_params)
from hadoop_tpu_torch.serving import loader
from hadoop_tpu_torch.tools import dist_plans

BATCH, LR, WORLD = 8, 1e-2, 4
OVER = {"max_seq": 32}
TOL = 2e-4                  # tests/torch_plans.py
DP2_TP2 = {"dp": 2, "tp": 2}
DP4 = {"dp": 4}
DP2_PP2 = {"dp": 2, "pp": 2}
VPP = {"dp": 2, "pp": 2, "vpp": 2}
# the own-resume plans: (id, plan, zero1)
RESUMES = [("dp2_tp2", DP2_TP2, False), ("z1_dp4", DP4, True),
           ("vpp", VPP, False)]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("mesh")
    toks = np.random.default_rng(0).integers(0, 256, 60_000,
                                             dtype=np.uint16)
    JLocalFileSystem().write_all(f"{path}/toks.bin", toks.tobytes())
    return str(path)


def _jtrainer(root, kw, ckpt_dir, zero1):
    return JTrainer(jconfig.get_config("tiny", **OVER), JMeshPlan(**kw),
                    JLocalFileSystem(), f"{root}/toks.bin",
                    f"{root}/{ckpt_dir}", batch=BATCH, lr=LR, zero1=zero1,
                    ckpt_interval=0)


@pytest.fixture(scope="module")
def reference(root):
    """The reference's side before the world: its ZeRO-1 dp2×tp2 run
    (a checkpoint at step 2, then two more steps) and one step of each
    ledger plan, each with the comm profile of its steps."""
    runtime = jcomm.comm_runtime()
    out = {}
    runtime.reset_for_tests()
    t = _jtrainer(root, DP2_TP2, "ref_z1", True)
    first = t.train(2)
    t.save()
    out["z1_dp2_tp2"] = {"losses": first + t.train(2),
                         "comm": runtime.profile("trainer.step")}
    t.close()
    for key, kw, zero1 in (("dp2_tp2", DP2_TP2, False),
                           ("z1_dp4", DP4, True),
                           ("z1_dp2_pp2", DP2_PP2, True)):
        runtime.reset_for_tests()
        t = _jtrainer(root, kw, f"ref_{key}", zero1)
        out[key] = {"losses": t.train(1),
                    "comm": runtime.profile("trainer.step")}
        t.close()
    runtime.reset_for_tests()
    return out


def _ops(root):
    """The port's side, in order (see the module doc)."""
    def make(name, plan, ckpt_dir, zero1=False, check_init=False, **kw):
        return {"op": "make", "name": name, "plan": plan,
                "ckpt": f"{root}/{ckpt_dir}", "check_init": check_init,
                "kw": dict(kw, zero1=zero1)}

    def op(kind, name, **kw):
        return dict(kw, op=kind, name=name)

    ops = [make("xa", DP2_TP2, "ref_z1", True), op("restore", "xa"),
           op("save", "xa", dir=f"{root}/ref_z1_resaved"),
           op("train", "xa", steps=2), op("crash", "xa"),
           make("pb", DP2_TP2, "port_z1", True, check_init=True),
           op("train", "pb", steps=2),
           op("save", "pb"), op("train", "pb", steps=2), op("crash", "pb")]
    for key, plan, zero1 in RESUMES:
        ops += [make(f"{key}_u", plan, f"{key}_u", zero1, check_init=True),
                op("train", f"{key}_u", steps=4), op("crash", f"{key}_u"),
                make(f"{key}_c", plan, f"own_{key}", zero1,
                     ckpt_interval=2),
                op("train", f"{key}_c", steps=3), op("crash", f"{key}_c"),
                make(f"{key}_r", plan, f"own_{key}", zero1,
                     ckpt_interval=0),
                op("restore", f"{key}_r"), op("train", f"{key}_r", steps=2)]
        if key == "vpp":
            ops += [op("save", "vpp_r", dir=f"{root}/own_vpp_end"),
                    op("gather", "vpp_r")]
        ops.append(op("crash", f"{key}_r"))
    for name, plan, src, zero1, dst in (
            ("e_dp4", DP4, "own_dp2_tp2", False, "cross_dp4"),
            ("e_z1", DP2_TP2, "own_z1_dp4", True, "cross_z1_dp2_tp2")):
        ops += [make(name, plan, src, zero1), op("restore", name),
                op("save", name, dir=f"{root}/{dst}"),
                op("train", name, steps=1), op("crash", name)]
    for name, plan, zero1, dst in (("lz", DP4, True, "layout_z1_dp4"),
                                   ("lt", DP2_TP2, True, "layout_z1_dp2_tp2"),
                                   ("fv", VPP, False, "order_vpp"),
                                   ("fp", DP2_PP2, False, "order_pp2")):
        ops += [make(name, plan, dst, zero1), op("fill", name),
                op("save", name), op("crash", name)]
    ops += [make("h", DP2_PP2, "ledger_z1_pp2", True),
            op("train", "h", steps=1), op("crash", "h")]
    return ops


@pytest.fixture(scope="module")
def world(root, reference):
    """Every rank's records, by (op, name) in order of the ops."""
    job = {"preset": "tiny", "overrides": OVER, "data": f"{root}/toks.bin",
           "device": "cpu", "seed": 0,
           "trainer": {"batch": BATCH, "lr": LR}, "ops": _ops(root)}
    recs = spmd.launch(dist_plans.trainer_ops, WORLD, backend="gloo",
                       args=([job],), timeout=600)
    return [list(per_rank) for per_rank in zip(*(r[0] for r in recs))]


def _rec(world, op, name, which=0):
    """Every rank's record of ``name``'s ``which``-th ``op``."""
    found = [r for r in world if (r[0]["op"], r[0]["name"]) == (op, name)]
    assert len(found) > which, (op, name)
    return found[which]


def _train(world, name, which=0):
    return _rec(world, "train", name, which)


def _assembled(path):
    """{leaf name: global numpy array} of the newest checkpoint under
    ``path``, put together from its shard files alone."""
    fs = JLocalFileSystem()
    step = jckpt.latest_step(fs, path)
    manifest = jckpt.read_manifest(fs, path, step)
    out = {}
    for name, entry in manifest["leaves"].items():
        dtype = np.dtype(entry["dtype"])
        arr = np.zeros(entry["shape"], dtype)
        seen = np.zeros(entry["shape"], bool)
        for sh in entry["shards"]:
            raw = fs.read_all(f"{path}/step_{step:012d}/{sh['file']}")
            idx = tuple(slice(a, b) for a, b in sh["index"])
            assert not seen[idx].any(), f"{name}: element written twice"
            arr[idx] = np.frombuffer(raw, dtype).reshape(arr[idx].shape)
            seen[idx] = True
        assert seen.all(), f"{name}: elements missing"
        out[name] = arr
    return step, manifest, out


def _jtree(flat, prefix, like):
    """A reference pytree shaped like ``like`` from ``_assembled``
    leaves under ``prefix``."""
    return jax.tree_util.tree_map_with_path(
        lambda path, _: flat[prefix + jax.tree_util.keystr(path)], like)


def _jparams_like():
    return jax.eval_shape(lambda: jdecoder.init_params(
        jax.random.PRNGKey(0), jconfig.get_config("tiny", **OVER)))


def _assert_same(a, b):
    assert a.keys() == b.keys()
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


# ----------------------------------------------------- across the packages

def test_reference_checkpoint_restores_in_the_port(root, reference, world):
    restored = _rec(world, "restore", "xa")
    assert all(r["restored"] and r["step"] == 2 for r in restored)
    assert {r["pos"] for r in restored} == {2 * BATCH * (OVER["max_seq"]
                                                         + 1)}
    step, _, want = _assembled(f"{root}/ref_z1")
    got_step, manifest, got = _assembled(f"{root}/ref_z1_resaved")
    assert step == got_step == 2
    assert manifest["meta"]["zero1"] and manifest["meta"]["plan"] == \
        jreshard.manifest_meta(JMeshPlan(**DP2_TP2), zero1=True)["plan"]
    _assert_same(got, want)
    losses = _train(world, "xa")
    assert all(r["losses"] == losses[0]["losses"] for r in losses)
    np.testing.assert_allclose(losses[0]["losses"],
                               reference["z1_dp2_tp2"]["losses"][2:],
                               rtol=TOL)


def test_port_checkpoint_restores_in_the_reference(root, world):
    port = _train(world, "pb", 0)[0]["losses"] + \
        _train(world, "pb", 1)[0]["losses"]
    step, _, saved = _assembled(f"{root}/port_z1")
    assert step == 2
    t = _jtrainer(root, DP2_TP2, "port_z1", True)
    assert t.try_restore() and t.step == 2
    live = {"params": t.params, "opt": t.opt}
    for path, leaf in jax.tree_util.tree_leaves_with_path(live):
        name = jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(jax.device_get(leaf)),
                                      saved[name], err_msg=name)
    assert t.data.state()["pos"] == _rec(world, "save", "pb")[0]["pos"]
    np.testing.assert_allclose(t.train(2), port[2:], rtol=TOL)
    t.close()


# ----------------------------------------------------------- the layout

@pytest.mark.parametrize("key,kw", [("z1_dp4", DP4),
                                    ("z1_dp2_tp2", DP2_TP2)])
def test_saved_zero1_layout_is_the_references(root, world, key, kw):
    """Every element distinct: the parameters from ``arange``, mu the
    same and nu their negatives, each rank holding its row as the
    optimizer cuts it; the reference reads the state back as set."""
    cfg = config.get_config("tiny", **OVER)
    full, _, _ = dist_plans.fill_values(
        cfg, MeshPlan(), Mesh(MeshPlan(), 0, dict.fromkeys(AXES, 0), {}))
    _, manifest, flat = _assembled(f"{root}/layout_{key}")
    jplan = JMeshPlan(**kw)
    specs = jparam_specs(jconfig.get_config("tiny", **OVER), jplan)
    want = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
            jax.tree_util.tree_leaves_with_path(
                jax.tree_util.tree_map(lambda t: t.numpy(), full))}
    spec_of = {jax.tree_util.keystr(p): s for p, s in
               jax.tree_util.tree_leaves_with_path(
                   specs, is_leaf=lambda s: isinstance(
                       s, jax.sharding.PartitionSpec))}
    for name, g in want.items():
        np.testing.assert_array_equal(flat[f"['params']{name}"], g)
        for which, sign in (("mu", 1.0), ("nu", -1.0)):
            state = flat[f"['opt'].{which}{name}"]
            back = jreshard.zero1_state_to_global(state, spec_of[name],
                                                  g.shape, jplan)
            np.testing.assert_array_equal(back, sign * g,
                                          err_msg=f"{which}{name}")


# ------------------------------------------------------ the port's resume

@pytest.mark.parametrize("key", [r[0] for r in RESUMES])
def test_own_resume_continues_the_curve_exactly(world, key):
    full = _train(world, f"{key}_u")
    crashed = _train(world, f"{key}_c")
    resumed = _train(world, f"{key}_r")
    restored = _rec(world, "restore", f"{key}_r")
    assert all(r["restored"] and r["step"] == 2 for r in restored)
    for rank in range(WORLD):
        assert full[rank]["losses"] == full[0]["losses"]
        assert crashed[rank]["losses"] == full[0]["losses"][:3]
        assert resumed[rank]["losses"] == full[0]["losses"][2:]
    assert all(np.isfinite(full[0]["losses"]))


@pytest.mark.parametrize("name", [f"{r[0]}_u" for r in RESUMES] + ["pb"])
def test_leafwise_init_is_init_sharded_of_the_full_tree(world, name):
    """A mesh trainer draws its parameters leaf by leaf and keeps its
    shard of each as it is drawn: its state is, bit for bit,
    ``init_sharded`` of the full tree drawn from the same seed."""
    assert all(r["init_equal"] for r in _rec(world, "make", name))


# ------------------------------------------------------ cross-plan restore

@pytest.mark.parametrize("name,src,dst,a,b,za,zb", [
    ("e_dp4", "own_dp2_tp2", "cross_dp4", DP2_TP2, DP4, False, False),
    ("e_z1", "own_z1_dp4", "cross_z1_dp2_tp2", DP4, DP2_TP2, True, True)],
    ids=["dp2_tp2_to_dp4", "z1_dp4_to_z1_dp2_tp2"])
def test_cross_plan_restore_is_the_references(root, world, name, src, dst,
                                              a, b, za, zb):
    assert all(r["restored"] and r["step"] == 2
               for r in _rec(world, "restore", name))
    _, _, saved = _assembled(f"{root}/{src}")
    _, manifest, got = _assembled(f"{root}/{dst}")
    assert manifest["meta"] == jreshard.manifest_meta(JMeshPlan(**b),
                                                      zero1=zb)
    jcfg = jconfig.get_config("tiny", **OVER)
    like = _jparams_like()
    opt = JAdamWState(saved["['opt'].count"],
                      _jtree(saved, "['opt'].mu", like),
                      _jtree(saved, "['opt'].nu", like))
    want = jreshard.reshard_opt_state(
        opt, like, jparam_specs(jcfg, JMeshPlan(**b)), JMeshPlan(**a),
        JMeshPlan(**b), zero1_a=za, zero1_b=zb)
    for which in ("mu", "nu"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(
                getattr(want, which)):
            key = f"['opt'].{which}{jax.tree_util.keystr(path)}"
            np.testing.assert_array_equal(got[key], leaf, err_msg=key)
    for key in saved:
        if key.startswith("['params']") or key in ("['data_pos']",
                                                   "['opt'].count"):
            np.testing.assert_array_equal(got[key], saved[key],
                                          err_msg=key)
    losses = _train(world, name)
    assert all(np.isfinite(r["losses"]).all() for r in losses)
    source = "dp2_tp2" if a == DP2_TP2 else "z1_dp4"
    np.testing.assert_allclose(losses[0]["losses"],
                               _train(world, f"{source}_u")[0]["losses"][2:3],
                               rtol=TOL)


def test_reference_restores_the_ports_zero1_dp4_at_dp2(root, world):
    """The reference's cross-plan restore of a port checkpoint
    (tests/test_elastic.py's dp4 → dp2): its moments are its own
    reshard_opt_state of the loaded arrays."""
    _, _, saved = _assembled(f"{root}/own_z1_dp4")
    t = _jtrainer(root, {"dp": 2}, "own_z1_dp4", True)
    assert t.try_restore() and t.step == 2
    jcfg = jconfig.get_config("tiny", **OVER)
    like = _jparams_like()
    opt = JAdamWState(saved["['opt'].count"],
                      _jtree(saved, "['opt'].mu", like),
                      _jtree(saved, "['opt'].nu", like))
    want = jreshard.reshard_opt_state(
        opt, like, jparam_specs(jcfg, JMeshPlan(dp=2)), JMeshPlan(dp=4),
        JMeshPlan(dp=2), zero1_a=True, zero1_b=True)
    for a, b in zip(jax.tree_util.tree_leaves(want.mu),
                    jax.tree_util.tree_leaves(t.opt.mu)):
        np.testing.assert_array_equal(np.asarray(jax.device_get(b)), a)
    for path, leaf in jax.tree_util.tree_leaves_with_path(t.params):
        name = "['params']" + jax.tree_util.keystr(path)
        np.testing.assert_array_equal(np.asarray(jax.device_get(leaf)),
                                      saved[name], err_msg=name)
    t.close()


# -------------------------------------------------------------- vpp order

def test_vpp_checkpoint_holds_logical_layer_order(root, world):
    _, _, vpp = _assembled(f"{root}/order_vpp")
    _, _, pp2 = _assembled(f"{root}/order_pp2")
    vpp.pop("['data_pos']"), pp2.pop("['data_pos']")
    _assert_same(vpp, pp2)
    # and a trained vpp state's checkpoint is its live parameters put
    # back in logical order
    _, _, end = _assembled(f"{root}/own_vpp_end")
    live = _rec(world, "gather", "vpp_r")[0]["params"]
    for path, leaf in jax.tree_util.tree_leaves_with_path(live):
        name = "['params']" + jax.tree_util.keystr(path)
        np.testing.assert_array_equal(end[name], leaf, err_msg=name)


def test_reference_reads_the_ports_vpp_checkpoint(root, world):
    """The reference's interleaved trainer restores the port's vpp
    checkpoint (written from ``fill_values``) and holds, in logical
    order, the values that were set: the parameters and mu, nu their
    negatives."""
    from hadoop_tpu.parallel.train import logical_layer_order
    cfg = config.get_config("tiny", **OVER)
    full, _, _ = dist_plans.fill_values(
        cfg, MeshPlan(), Mesh(MeshPlan(), 0, dict.fromkeys(AXES, 0), {}))
    t = _jtrainer(root, VPP, "order_vpp", False)
    assert t.try_restore() and t.step == 0
    for tree, sign in ((t.params, 1.0), (t.opt.mu, 1.0), (t.opt.nu, -1.0)):
        got = logical_layer_order(tree, t.cfg, t.plan)
        for path, leaf in jax.tree_util.tree_leaves_with_path(got):
            want = full
            for key in path:
                want = want[key.key]
            np.testing.assert_array_equal(
                np.asarray(jax.device_get(leaf)), sign * want.numpy(),
                err_msg=jax.tree_util.keystr(path))
    t.close()


# ------------------------------------------------------------------ loader

@pytest.mark.parametrize("kw", [DP2_TP2, {"pp": 2, "tp": 2}, DP4],
                         ids=["dp2_tp2", "pp2_tp2", "dp4"])
def test_loader_places_this_ranks_shards(tmp_path, kw):
    """``load_serving_params(mesh=, specs=)`` on every rank of a plan is
    ``shard_params`` of the full load (the meshes are the ranks' layouts
    alone: the load runs no collective)."""
    cfg = config.get_config("tiny", **OVER)
    fs = LocalFileSystem()
    params = init_params(cfg, torch.Generator().manual_seed(3),
                         device="cpu")
    ckpt.save_checkpoint(fs, str(tmp_path), 4, {"params": params})
    full, step = loader.load_serving_params(fs, str(tmp_path), cfg,
                                            device="cpu")
    plan = MeshPlan(**kw)
    shape = tuple(plan.sizes[a] for a in AXES)
    for rank in range(plan.n_devices):
        coords = dict(zip(AXES, (int(c) for c in
                                 np.unravel_index(rank, shape))))
        mesh = Mesh(plan, rank, coords, {})
        got, got_step = loader.load_serving_params(
            fs, str(tmp_path), cfg, mesh=mesh,
            specs=param_specs(cfg, plan), device="cpu")
        want = shard_params(full, plan, mesh)
        assert got_step == step == 4
        for (name, a), (_, b) in zip(ckpt.leaf_paths(got),
                                     ckpt.leaf_paths(want)):
            assert torch.equal(a, b), (rank, name)


# ------------------------------------------------------------- comm ledger

def _grad_sum_bytes(kw, zero1):
    """The bytes a rank's gradient sums hand to the wire on dp: every
    local gradient (float32), or under ZeRO-1 its [Z, K] padded rows."""
    cfg = config.get_config("tiny", **OVER)
    plan = MeshPlan(**kw)
    shapes = ckpt.leaf_paths(init_params(cfg, None, device="meta"))
    specs = ckpt.spec_paths(param_specs(cfg, plan))
    total = 0
    for name, p in shapes:
        local = int(np.prod(ckpt.local_shape(p.shape, specs[name],
                                             plan.sizes)))
        total += 4 * (plan.dp * -(-local // plan.dp) if zero1 else local)
    return total


@pytest.mark.parametrize("key,port,kw,zero1", [
    ("dp2_tp2", "dp2_tp2_u", DP2_TP2, False),
    ("z1_dp2_tp2", "pb", DP2_TP2, True),
    ("z1_dp4", "z1_dp4_u", DP4, True),
    ("z1_dp2_pp2", "h", DP2_PP2, True)])
def test_comm_ledger_is_the_references_profile(reference, world, key, port,
                                               kw, zero1):
    """Per site, a step's payload and reference bytes are the reference's
    traced profile. Executions differ by design: the reference cuts each
    tp reduce into ``parallel.overlap.tp.chunks`` (4) collectives and
    splits the ZeRO-1 gather's buckets by the axes a slice varies over,
    where the port runs one reduce and one bucket per (axes, dtype).
    Against ``spmd.traffic`` on dp: the gradient sums (no site, as in the
    reference), the ZeRO-1 gather's row (the ledger holds the reference's
    [Z, K] buffer) and the scalars."""
    want = dict(reference[key]["comm"])
    assert want, f"the reference recorded no site for {key}"
    recs = _train(world, port)
    for r in recs:
        got = r["comm"]
        assert set(got) == set(want), (got, want)
        for site, (payload, ref, _) in want.items():
            assert got[site][:2] == [payload, ref], site
        if "tp.psum" in got:
            assert got["tp.psum"][2] * 4 == want["tp.psum"][2]
        z = kw["dp"]
        ledger_dp = got.get("zero1.gather", [0])[0] // z
        grads = _grad_sum_bytes(kw, zero1)
        for wire in r["traffic"]:
            assert 0 <= wire["dp"] - grads - ledger_dp <= 64, (wire, got)
            if "tp.psum" in got:
                assert wire["tp"] >= got["tp.psum"][0]
        assert r["comm_report"]["steps"] == {
            "trainer.step": len(r["losses"])}


def test_ranks_import_only_the_port(world):
    assert all(r["foreign"] == [] for r in _rec(world, "modules", None))


# ------------------------------------------------- the ranks' coordination

def _rank_snap(rank):
    return ckpt.snapshot_tree({"w": torch.full((2,), float(rank))},
                              lambda name, t: ((4,), [([[2 * rank,
                                                          2 * rank + 2]],
                                                        None)]))


def test_a_missing_part_fails_the_save_at_the_next_fence(tmp_path,
                                                         monkeypatch):
    """Rank 0 publishes only when every rank's part file is there: one
    that never comes fails the save after ``PART_TIMEOUT_S``, a rank
    that marks its write failed fails it at once; either failure
    surfaces at the writer's next fence, and the manifest-less directory
    stays invisible. With both parts the manifest lists both ranks'
    shards."""
    fs, base = LocalFileSystem(), str(tmp_path)
    monkeypatch.setattr(ckpt, "PART_TIMEOUT_S", 0.2)
    writer = ckpt.AsyncCheckpointWriter()
    writer.submit(lambda: ckpt.write_snapshot(fs, base, 1, _rank_snap(0),
                                              rank=0, world=2, token="a"))
    with pytest.raises(IOError, match=r"ranks \[1\]"):
        writer.wait()
    assert ckpt.list_checkpoints(fs, base) == []

    class Failing(LocalFileSystem):
        def write_all(self, path, data):
            if "shard" in path:
                raise IOError("injected")
            super().write_all(path, data)

    with pytest.raises(IOError, match="injected"):
        ckpt.write_snapshot(Failing(), base, 2, _rank_snap(1), rank=1,
                            world=2, token="b")
    monkeypatch.setattr(ckpt, "PART_TIMEOUT_S", 60.0)
    writer.submit(lambda: ckpt.write_snapshot(fs, base, 2, _rank_snap(0),
                                              rank=0, world=2, token="b"))
    with pytest.raises(IOError, match="rank 1 failed"):
        writer.wait()
    assert ckpt.list_checkpoints(fs, base) == []

    ckpt.write_snapshot(fs, base, 3, _rank_snap(1), rank=1, world=2,
                        token="c")
    ckpt.write_snapshot(fs, base, 3, _rank_snap(0), rank=0, world=2,
                        token="c")
    assert ckpt.list_checkpoints(fs, base) == [3]
    manifest = ckpt.read_manifest(fs, base, 3)
    assert [sh["index"] for sh in manifest["leaves"]["['w']"]["shards"]] \
        == [[[0, 2]], [[2, 4]]]
    got, _ = ckpt.load_checkpoint(fs, base, {"w": torch.zeros(4)},
                                  device="cpu")
    assert got["w"].tolist() == [0.0, 0.0, 1.0, 1.0]
    # the orphans of the failed attempts are older than step 3: swept
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "step_000000000003"]


def test_comm_runtime_window_sites_and_timing_key():
    """A step window's records define its profile; a site outside the
    bounded set counts as "other"; a record outside a window or inside
    an autograd backward is dropped; ``obs.comm.timing`` false keeps the
    profile but advances no counter. The reference's ledger on the same
    records gives the same report."""
    from hadoop_tpu.conf import Configuration as JConfiguration
    from hadoop_tpu_torch.conf import Configuration
    from hadoop_tpu_torch.obs.comm import COMM_SITES, CommRuntime
    assert COMM_SITES == jcomm.COMM_SITES
    rt, ref = CommRuntime(), jcomm.CommRuntime()
    rt.record("tp.psum", 8, 8)                # outside any window
    x = torch.ones(3, requires_grad=True)

    class Backward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t * 2

        @staticmethod
        def backward(ctx, g):
            rt.record("tp.psum", 1000, 1000)  # a transpose: dropped
            return g * 2

    for runtime in (rt, ref):
        with runtime.step("trainer.step"):
            runtime.record("tp.psum", 16, 16)
            runtime.record("tp.psum", 16, 16)
            runtime.record("weird.site", 4, 4)
            if runtime is rt:
                Backward.apply(x).sum().backward()
    assert rt.profile("trainer.step") == ref.profile("trainer.step") == {
        "tp.psum": (32, 32, 2), "other": (4, 4, 1)}
    assert rt.report() == ref.report()
    conf, jconf = Configuration(), JConfiguration(load_defaults=False)
    conf.set("obs.comm.timing", "false")
    jconf.set("obs.comm.timing", "false")
    rt.configure(conf)
    ref.configure(jconf)
    for runtime in (rt, ref):
        with runtime.step("trainer.step"):
            runtime.record("cp.ring", 64, 64)
    assert rt.profile("trainer.step") == {"cp.ring": (64, 64, 1)}
    assert rt.report() == ref.report()
    assert rt.report()["steps"] == {"trainer.step": 1}
