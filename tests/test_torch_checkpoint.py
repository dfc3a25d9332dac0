"""The PyTorch port's checkpoints, token stream, serving loader and HBM
ledger against the JAX package's, on the CPU, through a real
``MiniDFSCluster`` filesystem (the port takes it through its duck-typed
seam, ``hadoop_tpu_torch.fs``).

Checkpoints must be the reference's byte for byte, in float32 and
bfloat16, and load both ways bit for bit; batches must equal the
reference's; the loader must give exactly ``params_from_numpy``'s
tensors and, through the engine, the reference engine's greedy tokens.
"""

import dataclasses
import threading
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_tpu.conf import Configuration
from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.parallel import MeshPlan as JMeshPlan, make_mesh
from hadoop_tpu.parallel import checkpoint as jckpt
from hadoop_tpu.parallel import data as jdata
from hadoop_tpu.parallel import optimizer as joptimizer
from hadoop_tpu.parallel import train as jtrain
from hadoop_tpu.parallel.elastic import reshard as jreshard
from hadoop_tpu.serving import engine as jengine
from hadoop_tpu.testing.minicluster import MiniDFSCluster
from hadoop_tpu_torch.fs import LocalFileSystem
from hadoop_tpu_torch.models import config, params_from_numpy
from hadoop_tpu_torch.obs.hbm import HbmLedger, hbm_ledger, tree_nbytes
from hadoop_tpu_torch.parallel import MeshPlan, Trainer, TokenDataset
from hadoop_tpu_torch.parallel import checkpoint as ckpt
from hadoop_tpu_torch.parallel.optimizer import AdamWState, tree_map
from hadoop_tpu_torch.serving import loader
from hadoop_tpu_torch.serving.engine import DecodeEngine, SamplingParams

BATCH = 8


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to one thread: the tier-1 run shares the CPU between
    several test workers, some of them timing-sensitive."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cluster():
    with MiniDFSCluster(num_datanodes=3) as c:
        yield c


@pytest.fixture(scope="module")
def fs(cluster):
    return cluster.get_filesystem()


@pytest.fixture(scope="module")
def token_file(fs):
    toks = np.random.default_rng(0).integers(0, 256, 200_000,
                                             dtype=np.uint16)
    fs.mkdirs("/tdata")
    fs.write_all("/tdata/tokens.bin", toks.tobytes())
    return "/tdata/tokens.bin"


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bits as numpy (bfloat16 through a 16-bit view)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def _state(dtype):
    """The same trainer state in both packages: the reference's tiny
    params, moments drawn with numpy, step count 3 and a cursor past
    2**31 (its two int31 halves)."""
    jcfg = jconfig.get_config("tiny", dtype=dtype)
    cfg = config.get_config("tiny", dtype=dtype)
    jparams = _numpy(jdecoder.init_params(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(1)
    mu, nu = (jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), jparams)
        for _ in range(2))
    pos = 3_000_000_123
    data_pos = np.asarray([pos >> 31, pos & 0x7FFFFFFF], np.int32)
    jtree = {"params": jparams,
             "opt": joptimizer.AdamWState(np.asarray(3, np.int32), mu, nu),
             "data_pos": data_pos}
    to_t = lambda tree: tree_map(torch.from_numpy, tree)  # noqa: E731
    ptree = {"params": params_from_numpy(jparams, cfg, device="cpu"),
             "opt": AdamWState(3, to_t(mu), to_t(nu)),
             "data_pos": torch.from_numpy(data_pos)}
    return jcfg, cfg, jtree, ptree


def _files(fs, d):
    return {st.path.rsplit("/", 1)[-1]: fs.read_all(st.path)
            for st in fs.list_status(d)}


# ------------------------------------------------------------- the format

def test_leaf_names_are_keystr_names():
    tree = {"b": [1, (2, 3)], "a": {"y": 4, "x": 5},
            "opt": AdamWState(6, {"w": 7}, {"w": 8})}
    jnames = [jax.tree_util.keystr(p)
              for p, _ in jax.tree_util.tree_leaves_with_path(tree)]
    assert [n for n, _ in ckpt.leaf_paths(tree)] == jnames
    assert [v for _, v in ckpt.leaf_paths(tree)] == \
        jax.tree_util.tree_leaves(tree)
    doubled = ckpt.map_with_path(lambda n, v: (n, 2 * v), tree)
    assert doubled["opt"] == AdamWState(("['opt'].count", 12),
                                        {"w": ("['opt'].mu['w']", 14)},
                                        {"w": ("['opt'].nu['w']", 16)})
    assert doubled["b"] == [("['b'][0]", 2),
                            (("['b'][1][0]", 4), ("['b'][1][1]", 6))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_same_state_same_bytes_and_loads_both_ways(fs, dtype):
    """The port's checkpoint directory equals the reference's file for
    file and byte for byte; each package loads the other's bit for bit."""
    jcfg, cfg, jtree, ptree = _state(dtype)
    jckpt.save_checkpoint(fs, f"/bytes/{dtype}/ref", 3, jtree,
                          meta=jreshard.manifest_meta(JMeshPlan(),
                                                      zero1=False))
    ckpt.save_checkpoint(fs, f"/bytes/{dtype}/port", 3, ptree,
                         meta=ckpt.manifest_meta(MeshPlan(), zero1=False))
    ref = _files(fs, f"/bytes/{dtype}/ref/step_000000000003")
    got = _files(fs, f"/bytes/{dtype}/port/step_000000000003")
    assert sorted(got) == sorted(ref)
    # data_pos, count, params, mu and nu, and the manifest
    assert len(got) == 2 + 3 * len(jax.tree_util.tree_leaves(
        jtree["params"])) + 1
    for name in ref:
        assert got[name] == ref[name], name

    # the reference's checkpoint into the port
    like = tree_map(lambda t: t, ptree["params"])
    loaded, step = ckpt.load_checkpoint(
        fs, f"/bytes/{dtype}/ref", dict(ptree, params=like), device="cpu",
        io_workers=3)
    assert step == 3 and loaded["opt"].count == 3
    assert isinstance(loaded["opt"].count, int)
    for (name, a), (_, b) in zip(ckpt.leaf_paths(loaded),
                                 ckpt.leaf_paths(ptree)):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    # the port's checkpoint into the reference
    back, _ = jckpt.load_checkpoint(fs, f"/bytes/{dtype}/port", jtree)
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(back),
                            jax.tree_util.tree_leaves(jtree)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(_jbits(a), _jbits(b),
                                      err_msg=jax.tree_util.keystr(path))


def _reference_plan_checkpoint(fs, path, plan, zero1):
    """A checkpoint the reference writes under ``plan`` on the virtual CPU
    mesh, with its manifest's plan block; returns the global arrays."""
    jcfg = jconfig.get_config("tiny")
    mesh = make_mesh(plan)
    params, opt = jtrain.init_sharded(jax.random.PRNGKey(0), jcfg, plan,
                                      mesh, zero1=zero1)
    tree = {"params": params, "opt": opt,
            "data_pos": jnp.asarray([0, 4321], jnp.int32)}
    jckpt.save_checkpoint(fs, path, 5, tree,
                          meta=jreshard.manifest_meta(plan, zero1=zero1))
    return _numpy(jax.device_get(tree))


def test_multi_device_checkpoint_loads_and_resumes(fs, token_file):
    """A dp2×tp2 checkpoint (zero1 off) stores tp-sharded leaves as
    several shards; the port assembles them into the global arrays, and
    its Trainer resumes from it through the "reshard" outcome."""
    plan = JMeshPlan(dp=2, tp=2)
    want = _reference_plan_checkpoint(fs, "/plans/dp2tp2", plan, False)
    manifest = ckpt.read_manifest(fs, "/plans/dp2tp2", 5)
    assert max(len(e["shards"]) for e in manifest["leaves"].values()) > 1
    assert ckpt.resolve_restore(manifest, MeshPlan(), False)[0] == "reshard"

    t = Trainer(config.get_config("tiny"), MeshPlan(), fs, token_file,
                "/plans/dp2tp2", batch=BATCH, lr=1e-2, ckpt_interval=0,
                device="cpu")
    assert t.try_restore() and t.step == 5
    assert t.data.state()["pos"] == 4321
    want = dict(ckpt.leaf_paths(want))     # the reference's AdamWState
    #                                       is a NamedTuple as well
    for name, a in ckpt.leaf_paths({"params": t.params, "opt": t.opt}):
        np.testing.assert_array_equal(np.asarray(a), want[name],
                                      err_msg=name)
    losses = t.train(1)
    assert t.step == 6 and np.isfinite(losses).all()
    t.close()


def test_zero1_checkpoint_is_refused(fs, token_file):
    """Since the mesh slice a ZeRO-1 checkpoint restores (the name stays
    from when it was refused): the reference's dp2 ZeRO-1 state, with
    moments drawn with numpy, goes through the "reshard" outcome into
    the port's one-device trainer, its moments equal the reference's
    ``reshard_opt_state`` of the loaded slices, and it trains on."""
    jplan = JMeshPlan(dp=2)
    jcfg = jconfig.get_config("tiny")
    jparams = _numpy(jdecoder.init_params(jax.random.PRNGKey(0), jcfg))
    specs = jtrain.param_specs(jcfg, jplan)
    rng = np.random.default_rng(5)
    mu, nu = (jax.tree_util.tree_map(
        lambda p, spec: jreshard.global_to_zero1_state(
            rng.standard_normal(p.shape).astype(np.float32), spec, jplan),
        jparams, specs) for _ in range(2))
    opt = joptimizer.AdamWState(np.asarray(5, np.int32), mu, nu)
    jckpt.save_checkpoint(fs, "/plans/z1", 5, {
        "params": jparams, "opt": opt,
        "data_pos": np.asarray([0, 4321], np.int32)},
        meta=jreshard.manifest_meta(jplan, zero1=True))
    want = jreshard.reshard_opt_state(opt, jparams, specs, jplan,
                                      JMeshPlan(), zero1_a=True,
                                      zero1_b=False)
    t = Trainer(config.get_config("tiny"), MeshPlan(), fs, token_file,
                "/plans/z1", batch=BATCH, ckpt_interval=0, device="cpu")
    manifest = ckpt.read_manifest(fs, "/plans/z1", 5)
    assert ckpt.resolve_restore(manifest, MeshPlan(), False)[0] == "reshard"
    assert t.try_restore() and t.step == 5
    assert t.data.state()["pos"] == 4321 and t.opt.count == 5
    got = dict(ckpt.leaf_paths({"params": t.params, "opt": t.opt}))
    for name, a in ckpt.leaf_paths({"params": jparams, "opt": want}):
        np.testing.assert_array_equal(np.asarray(got[name]), a,
                                      err_msg=name)
    assert np.isfinite(t.train(1)).all() and t.step == 6
    t.close()


def test_checkpoint_of_other_shapes_is_refused(fs, token_file):
    """A checkpoint of another model raises ValueError naming the leaves
    that do not fit, whether it was written under this plan or another
    (the reference raises ValueError for a mismatched leaf as well)."""
    _, _, _, ptree = _state("float32")
    ckpt.save_checkpoint(fs, "/plans/other", 2, ptree,
                         meta=ckpt.manifest_meta(MeshPlan(), zero1=False))
    ckpt.save_checkpoint(fs, "/plans/other-dp2", 2, ptree,
                         meta=ckpt.manifest_meta(MeshPlan(dp=2),
                                                 zero1=False))
    cfg = config.get_config("tiny", d_ff=96)
    for path in ("/plans/other", "/plans/other-dp2"):
        t = Trainer(cfg, MeshPlan(), fs, token_file, path, batch=BATCH,
                    ckpt_interval=0, device="cpu")
        with pytest.raises(ValueError, match="w_down"):
            t.try_restore()
        t.close()


def _resolve(resolve, manifest, plan):
    """(mode, saved plan as a dict, saved zero1, warned), or ("refused",
    why) for a pipeline-stage change."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            mode, saved, zero1 = resolve(manifest, plan, False)
        except ValueError as e:
            return "refused", "pipeline stage count" in str(e)
    return (mode, saved and dataclasses.asdict(saved), zero1,
            [w.category for w in caught])


@pytest.mark.parametrize("jplan,mode", [
    (JMeshPlan(), "same-plan"), (JMeshPlan(dp=2, tp=2), "reshard"),
    (None, "legacy"), (JMeshPlan(dp=2, pp=2), "refused")],
    ids=["same-plan", "reshard", "legacy", "pp"])
def test_restore_outcomes_match_the_reference(jplan, mode):
    """resolve_restore classifies a manifest as the reference's does:
    same-plan, reshard, legacy (with a DeprecationWarning), and a
    pipeline-stage change refused; the plan blocks are equal."""
    manifest = {"leaves": {}}
    if jplan is not None:
        manifest["meta"] = jreshard.manifest_meta(jplan, zero1=False)
        assert ckpt.manifest_meta(MeshPlan(**dataclasses.asdict(jplan)),
                                  zero1=False) == manifest["meta"]
    want = _resolve(jreshard.resolve_restore, manifest, JMeshPlan())
    assert _resolve(ckpt.resolve_restore, manifest, MeshPlan()) == want
    assert want[0] == mode


# ------------------------------------------------- retention, the writer

def test_retention_keeps_keep_and_sweeps_manifestless_dirs(fs):
    _, _, _, ptree = _state("float32")
    for step in range(1, 6):
        ckpt.save_checkpoint(fs, "/keep", step, ptree, keep=2)
    assert ckpt.list_checkpoints(fs, "/keep") == [4, 5]
    # a crashed publish (shards, no manifest) is invisible ...
    fs.mkdirs("/keep/step_000000000009")
    fs.write_all("/keep/step_000000000009/shard_000000.bin", b"\x00" * 64)
    fs.mkdirs("/keep/step_000000000099._tmp")
    assert ckpt.latest_step(fs, "/keep") == 5
    # ... and swept by the next save's retention
    ckpt.save_checkpoint(fs, "/keep", 6, ptree, keep=2)
    assert ckpt.list_checkpoints(fs, "/keep") == [5, 6]
    assert not fs.exists("/keep/step_000000000009")
    assert not fs.exists("/keep/step_000000000099._tmp")


def test_writer_runs_in_background_and_fences():
    w = ckpt.AsyncCheckpointWriter()
    gate, done = threading.Event(), threading.Event()

    def job():
        gate.wait(10.0)
        done.set()

    w.submit(job)
    assert w.in_flight and not done.is_set()
    gate.set()
    w.wait()
    assert done.is_set() and not w.in_flight


def test_writer_error_surfaces_exactly_once_at_fence():
    w = ckpt.AsyncCheckpointWriter()

    def boom():
        raise IOError("dfs fell over")

    w.submit(boom)
    with pytest.raises(IOError, match="dfs fell over"):
        w.wait()
    w.wait()                    # cleared: does not raise twice


def test_writer_submit_fences_previous_and_keeps_order():
    w = ckpt.AsyncCheckpointWriter()
    order = []
    gate = threading.Event()

    def first():
        gate.wait(10.0)
        order.append(1)

    w.submit(first)
    release = threading.Timer(0.05, gate.set)
    release.start()
    w.submit(lambda: order.append(2))    # fences job 1 first
    w.wait()
    release.join(5.0)
    assert order == [1, 2]


def test_snapshot_is_unchanged_by_a_later_in_place_step():
    _, _, _, ptree = _state("bfloat16")
    snap = ckpt.snapshot_tree(ptree)
    before = [ckpt.assemble_snapshot_leaf(e).copy() for e in snap]
    with torch.no_grad():
        tree_map(lambda t: t.add_(1), ptree["params"])
        tree_map(lambda t: t.mul_(3), ptree["opt"].mu)
        ptree["data_pos"].add_(5)
    assert [ckpt.assemble_snapshot_leaf(e).tobytes() for e in snap] == \
        [b.tobytes() for b in before]
    now = ckpt.snapshot_tree(ptree)
    assert any(ckpt.assemble_snapshot_leaf(a).tobytes() != b.tobytes()
               for a, b in zip(now, before) if a["name"].startswith(
                   "['params']"))


# ------------------------------------------------------------- the stream

@pytest.fixture(scope="module")
def token_dir(fs):
    """Three token files (one shorter than a batch) beside a marker and a
    hidden file that the stream skips."""
    rng = np.random.default_rng(2)
    fs.mkdirs("/tdir")
    for name, n in (("b.bin", 700), ("a.bin", 1500), ("c.bin", 90)):
        fs.write_all(f"/tdir/{name}",
                     rng.integers(0, 60000, n, dtype=np.uint16).tobytes())
    fs.write_all("/tdir/_SUCCESS", b"")
    fs.write_all("/tdir/.a.bin.crc", b"\x01\x02")
    return "/tdir"


@pytest.mark.parametrize("which", ["file", "dir"])
@pytest.mark.parametrize("read_mb", [0, 8])
def test_token_dataset_matches_reference(fs, token_file, token_dir, which,
                                         read_mb):
    """Batch for batch, through file boundaries and the wrap-around; a
    restore from ``state()`` mid-stream continues both alike."""
    path = token_file if which == "file" else token_dir
    kw = dict(batch=4, seq=31, read_mb=read_mb)
    ref = jdata.TokenDataset(fs, path, **kw)
    got = TokenDataset(fs, path, **kw)
    assert got.files == ref.files and got.total_tokens == ref.total_tokens
    n = 3 * (-(-ref.total_tokens // (4 * 32))) if which == "dir" else 5
    for i in range(n):
        np.testing.assert_array_equal(got.next_batch(), ref.next_batch(),
                                      err_msg=str(i))
        assert got.state() == ref.state()
    state = got.state()
    fresh, fresh_ref = TokenDataset(fs, path, **kw), \
        jdata.TokenDataset(fs, path, **kw)
    fresh.restore(state)
    fresh_ref.restore(state)
    for _ in range(3):
        batch = fresh.next_batch()
        np.testing.assert_array_equal(batch, fresh_ref.next_batch())
        np.testing.assert_array_equal(batch, got.next_batch())


def test_local_filesystem_serves_the_stream_and_checkpoints(tmp_path):
    """The port's own LocalFileSystem copy carries the same stream and a
    checkpoint round trip."""
    lfs = LocalFileSystem()
    toks = np.arange(1000, dtype=np.uint16)
    lfs.write_all(f"{tmp_path}/d/t.bin", toks.tobytes())
    ds = TokenDataset(lfs, f"{tmp_path}/d", batch=2, seq=9)
    np.testing.assert_array_equal(ds.next_batch(),
                                  np.arange(20).reshape(2, 10))
    tree = {"w": torch.arange(6.0).reshape(2, 3), "n": 4}
    ckpt.save_checkpoint(lfs, f"{tmp_path}/ck", 1, tree)
    back, step = ckpt.load_checkpoint(lfs, f"{tmp_path}/ck", tree,
                                      device="cpu")
    assert step == 1 and back["n"] == 4
    assert torch.equal(back["w"], tree["w"])
    assert lfs.rename(f"{tmp_path}/ck", f"{tmp_path}/ck2")
    assert lfs.exists(f"{tmp_path}/ck2/step_000000000001/manifest.json")


# ------------------------------------------------------------- the loader

class _CountingFS:
    """Delegating filesystem that records the files read whole."""

    def __init__(self, inner):
        self._inner = inner
        self.reads = []

    def read_all(self, path):
        self.reads.append(path)
        return self._inner.read_all(path)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.mark.parametrize("dtype,wrapped", [("bfloat16", True),
                                           ("bfloat16", False),
                                           ("float32", True)])
def test_loader_gives_params_from_numpy_bit_for_bit(fs, dtype, wrapped):
    jcfg, cfg, jtree, _ = _state(dtype)
    path = f"/serve/{dtype}-{'wrapped' if wrapped else 'bare'}"
    jckpt.save_checkpoint(fs, path, 7, jtree if wrapped else jtree["params"])
    counting = _CountingFS(fs)
    params, step = loader.load_serving_params(counting, path, cfg,
                                              device="cpu", io_workers=3)
    assert step == 7
    want = params_from_numpy(jtree["params"], cfg, device="cpu")
    names = [n for n, _ in ckpt.leaf_paths(want)]
    assert [n for n, _ in ckpt.leaf_paths(params)] == names
    for (name, a), (_, b) in zip(ckpt.leaf_paths(params),
                                 ckpt.leaf_paths(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    # only the manifest and the parameters' shards were read
    manifest = ckpt.read_manifest(fs, path, 7)
    param_files = {sh["file"] for name, e in manifest["leaves"].items()
                   if "['opt']" not in name and "data_pos" not in name
                   for sh in e["shards"]}
    read = {p.rsplit("/", 1)[-1] for p in counting.reads}
    assert read - {"manifest.json"} == param_files


def test_loader_refuses_a_checkpoint_of_another_config(fs):
    jcfg, cfg, jtree, _ = _state("float32")
    jckpt.save_checkpoint(fs, "/serve/f32-other", 1, jtree)
    with pytest.raises(ValueError, match="bfloat16"):
        loader.load_serving_params(
            fs, "/serve/f32-other", config.get_config("tiny",
                                                      dtype="bfloat16"),
            device="cpu")
    with pytest.raises(FileNotFoundError):
        loader.load_serving_params(fs, "/serve/none", cfg, device="cpu")


def test_loaded_params_decode_as_the_reference_engine(fs):
    """One greedy generate through loaded parameters equals the reference
    engine's on the same checkpoint (float32 tiny)."""
    jcfg, cfg, jtree, _ = _state("float32")
    jckpt.save_checkpoint(fs, "/serve/greedy", 2, jtree)
    params, _ = loader.load_serving_params(fs, "/serve/greedy", cfg,
                                           device="cpu")
    jparams, _ = jckpt.load_checkpoint(fs, "/serve/greedy",
                                       {"params": jtree["params"]})
    kw = dict(max_batch=2, block_size=4, max_context=32)
    prompts = [[5, 9, 2, 7], [1, 2, 3]]
    got = DecodeEngine(params, cfg, device="cpu", **kw).generate(
        prompts, SamplingParams(max_new_tokens=8))
    want = jengine.DecodeEngine(jparams["params"], jcfg, **kw).generate(
        prompts, jengine.SamplingParams(max_new_tokens=8))
    assert got == want


def test_serving_read_defaults_keys():
    conf = Configuration(load_defaults=False)
    conf.set(loader.HEDGED_THRESHOLD_KEY, "2.0")
    loader.serving_read_defaults(conf)
    assert conf.get(loader.HEDGED_POOL_KEY) == "4"
    assert conf.get(loader.HEDGED_THRESHOLD_KEY) == "2.0"
    assert loader.IO_WORKERS_KEY == "serving.loader.io.workers"


# ----------------------------------------------------------- the ledger

def test_hbm_ledger_accounts_owners_and_errors():
    led = HbmLedger()
    led.register("a.w", "weights", lambda: 100)
    led.register("a.kv", "kv_pool", lambda: 50)
    led.register("b.w", "weights", lambda: 7)
    led.register("c.x", "no-such-component", lambda: 3)
    led.register("d.bad", "params", lambda: 1 // 0)
    report = led.report()
    assert report["components"] == {"weights": 107, "kv_pool": 50,
                                    "other": 3}
    assert report["total_bytes"] == 160 and report["errors"] == 1
    assert report["providers"] == 5
    assert report["device"] is None          # no CUDA device here
    led.unregister_prefix("a.")
    led.unregister("d.bad")
    assert led.report()["components"] == {"weights": 7, "other": 3}
    assert led.report()["errors"] == 0
    assert tree_nbytes({"a": torch.zeros(3, 4), "b": [torch.zeros(
        2, dtype=torch.bfloat16), 5]}) == 48 + 4


def _delta(before, after):
    return {k: after.get(k, 0) - before.get(k, 0)
            for k in set(before) | set(after) if after.get(k, 0) !=
            before.get(k, 0)}


def test_trainer_and_engine_register_their_bytes(fs, token_file):
    led = hbm_ledger()
    before = led.component_bytes()[0]
    t = Trainer(config.get_config("tiny"), MeshPlan(), fs, token_file,
                "/ledger", batch=BATCH, ckpt_interval=0, device="cpu")
    params_bytes = sum(p.nbytes for _, p in ckpt.leaf_paths(t.params))
    assert _delta(before, led.component_bytes()[0]) == {
        "params": params_bytes, "opt_state": 2 * params_bytes}
    t.close()
    assert _delta(before, led.component_bytes()[0]) == {}

    jcfg, cfg, jtree, ptree = _state("float32")
    eng = DecodeEngine(ptree["params"], cfg, device="cpu", max_batch=2,
                       block_size=4, max_context=32)
    assert _delta(before, led.component_bytes()[0]) == {
        "weights": params_bytes,
        "kv_pool": eng._kp.nbytes + eng._vp.nbytes}
    eng.stop()
    assert _delta(before, led.component_bytes()[0]) == {}
