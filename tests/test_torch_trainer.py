"""The PyTorch port's Trainer against the JAX package's, on the CPU,
through a real ``MiniDFSCluster`` filesystem (the mesh's own file is
``tests/test_torch_trainer_mesh.py``).

A run started in one package and resumed in the other continues the
loss curve within rtol 5e-4 (the curve tolerance of
tests/test_torch_train.py); the port's own resume, with and without a
write in flight, within rtol 1e-6 (the reference's own gate,
tests/test_trainer_dfs.py).
"""

import warnings

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hadoop_tpu.models import config as jconfig
from hadoop_tpu.parallel import MeshPlan as JMeshPlan
from hadoop_tpu.parallel import checkpoint as jckpt
from hadoop_tpu.parallel.elastic import reshard as jreshard
from hadoop_tpu.parallel.trainer import Trainer as JTrainer
from hadoop_tpu.testing.minicluster import MiniDFSCluster
from hadoop_tpu_torch.fs import LocalFileSystem
from hadoop_tpu_torch.models import config
from hadoop_tpu_torch.obs.trainer import anatomy_delta
from hadoop_tpu_torch.parallel import MeshPlan, Trainer
from hadoop_tpu_torch.parallel import checkpoint as ckpt
from hadoop_tpu_torch.parallel import optimizer, spmd
from hadoop_tpu_torch.parallel.elastic import ElasticConfig
from hadoop_tpu_torch.parallel.lowp import RELAXED_PARITY
from hadoop_tpu_torch.parallel.mesh import (AXES, Mesh, param_specs,
                                            shard_params)
from hadoop_tpu_torch.parallel.overlap import OverlapConfig
from hadoop_tpu_torch.serving import loader
from hadoop_tpu_torch.tools import dist_plans

BATCH = 8
LR = 1e-2


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
    fs.mkdirs("/pdata")
    fs.write_all("/pdata/tokens.bin", toks.tobytes())
    return "/pdata/tokens.bin"


def _port(fs, token_file, ckpt_dir, **kw):
    kw.setdefault("ckpt_interval", 0)
    return Trainer(config.get_config("tiny"), MeshPlan(), fs, token_file,
                   ckpt_dir, batch=BATCH, lr=LR, device="cpu", **kw)


def _reference(fs, token_file, ckpt_dir):
    return JTrainer(jconfig.get_config("tiny"), JMeshPlan(), fs, token_file,
                    ckpt_dir, batch=BATCH, lr=LR, ckpt_interval=0)


@pytest.fixture(scope="module")
def port_curve(fs, token_file):
    """The port's uninterrupted six steps."""
    t = _port(fs, token_file, "/pckpt/curve")
    losses = t.train(6)
    t.close()
    return losses


# ----------------------------------------------------- across the packages

def test_reference_run_resumes_in_port(fs, token_file):
    ref = _reference(fs, token_file, "/pckpt/ref2port")
    ref.train(3)
    ref.save()
    uninterrupted = ref.train(3)
    t = _port(fs, token_file, "/pckpt/ref2port")
    assert t.try_restore() and t.step == 3
    assert t.data.state() == {"pos": 3 * BATCH * 129}
    np.testing.assert_allclose(t.train(3), uninterrupted, rtol=5e-4)
    t.close()


def test_port_run_resumes_in_reference(fs, token_file, port_curve):
    t = _port(fs, token_file, "/pckpt/port2ref")
    np.testing.assert_allclose(t.train(3), port_curve[:3], rtol=1e-6)
    t.save()
    t.close()
    with warnings.catch_warnings():
        warnings.simplefilter("error", DeprecationWarning)
        mode, _, _ = jreshard.resolve_restore(
            jckpt.read_manifest(fs, "/pckpt/port2ref", 3), JMeshPlan(),
            False)
        assert mode == "same-plan"
        ref = _reference(fs, token_file, "/pckpt/port2ref")
        assert ref.try_restore() and ref.step == 3
    np.testing.assert_allclose(ref.train(3), port_curve[3:], rtol=5e-4)


# --------------------------------------- through the port's DFS client

@pytest.fixture(scope="module")
def pfs(cluster):
    """The port's own DFS client on the same cluster."""
    from hadoop_tpu_torch.conf import Configuration
    from hadoop_tpu_torch.dfs.client import DistributedFileSystem
    conf = Configuration()
    for k, v in cluster.conf.to_dict().items():
        conf.set(k, v)
    fs = DistributedFileSystem([cluster.nn_addr], conf)
    yield fs
    fs.close()


def _assert_bit_equal(got, want):
    names = [n for n, _ in ckpt.leaf_paths(want)]
    assert [n for n, _ in ckpt.leaf_paths(got)] == names
    for (name, a), (_, b) in zip(ckpt.leaf_paths(got),
                                 ckpt.leaf_paths(want)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a.detach().cpu().numpy(),
                                      b.detach().cpu().numpy(),
                                      err_msg=name)


def _jparams_numpy(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def test_reference_trainer_checkpoint_serves_through_the_port_client(
        fs, pfs, token_file):
    """The reference's ``Trainer`` writes on the DFS with its own client;
    the port's ``load_serving_params`` reads it through the port's
    client, every leaf bit-equal to the reference trainer's parameters."""
    from hadoop_tpu_torch.models import params_from_numpy
    ref = _reference(fs, token_file, "/pckpt/ref-via-port-client")
    ref.train(2)
    ref.save()
    params, step = loader.load_serving_params(
        pfs, "/pckpt/ref-via-port-client", config.get_config("tiny"),
        device="cpu", io_workers=3)
    assert step == 2
    _assert_bit_equal(params, params_from_numpy(
        _jparams_numpy(ref.params), config.get_config("tiny"),
        device="cpu"))


def test_port_trainer_writes_through_the_port_client(fs, pfs, token_file):
    """A port ``Trainer`` reads its tokens and writes its checkpoint
    through the port's client; the reference loads it with its own
    client, every parameter bit-equal, and resumes from it."""
    from hadoop_tpu.models import decoder as jdecoder
    from hadoop_tpu_torch.models import params_from_numpy
    import jax
    t = _port(pfs, token_file, "/pckpt/port-client")
    t.train(2)
    t.save()
    t.close()
    jcfg = jconfig.get_config("tiny")
    like = {"params": jdecoder.init_params(jax.random.PRNGKey(1), jcfg)}
    back, step = jckpt.load_checkpoint(fs, "/pckpt/port-client", like)
    assert step == 2
    _assert_bit_equal(params_from_numpy(
        _jparams_numpy(back["params"]), config.get_config("tiny"),
        device="cpu"), t.params)
    ref = _reference(fs, token_file, "/pckpt/port-client")
    assert ref.try_restore() and ref.step == 2


# ------------------------------------------------------ the port's resume

class _FailingFS:
    """Delegating filesystem whose write_all starts raising after
    ``allow`` more calls once armed: the writer killed mid-write."""

    def __init__(self, inner):
        self._inner = inner
        self._armed = False
        self._allow = 0

    def arm(self, allow: int) -> None:
        self._armed, self._allow = True, allow

    def write_all(self, path, data):
        if self._armed:
            if self._allow <= 0:
                raise IOError("injected mid-write crash")
            self._allow -= 1
        return self._inner.write_all(path, data)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def _explicit_save(fs, token_file, curve):
    a = _port(fs, token_file, "/pckpt/explicit")
    np.testing.assert_allclose(a.train(3), curve[:3], rtol=1e-6)
    a.save()
    return "/pckpt/explicit", 3


def _interval_save_in_flight(fs, token_file, curve):
    """The interval save fires at step 3 with the next batch already
    prefetched; it must record the cursor of the last consumed batch."""
    a = _port(fs, token_file, "/pckpt/interval", ckpt_interval=3)
    before = a.step_metrics.anatomy()
    a.train(4)
    window = anatomy_delta(before, a.step_metrics.anatomy())
    assert window["ckpt"]["write"]["num_ops"] == 1
    return "/pckpt/interval", 3


def _interval_write_crashes(fs, token_file, curve):
    """The step-4 interval save's write dies mid-write: train() raises at
    its exit fence and the restore lands on step 2."""
    a = _port(fs, token_file, "/pckpt/crash", ckpt_interval=2)
    a.train(2)
    failing = _FailingFS(fs)
    a.fs = failing
    failing.arm(allow=1)
    with pytest.raises(IOError, match="injected"):
        a.train(2)
    assert a.losses == pytest.approx(curve[:4], rel=1e-6)
    return "/pckpt/crash", 2


@pytest.mark.parametrize("crash", [_explicit_save, _interval_save_in_flight,
                                   _interval_write_crashes],
                         ids=lambda f: f.__name__.strip("_"))
def test_port_resume_continues_the_curve_exactly(fs, token_file, port_curve,
                                                 crash):
    path, step = crash(fs, token_file, port_curve)
    b = _port(fs, token_file, path)
    assert b.try_restore() and b.step == step
    np.testing.assert_allclose(b.train(6 - step), port_curve[step:],
                               rtol=1e-6)
    assert b.loss_by_step == dict(zip(range(step + 1, 7), b.losses))
    b.close()


def test_cursor_survives_past_int32(fs, token_file):
    big = 3_000_000_123
    t = _port(fs, token_file, "/pckpt/big")
    t.data.total_tokens = big + 500_000      # a dataset at LM scale
    t.data._pos = big
    t.step = 7
    t.save()
    t2 = _port(fs, token_file, "/pckpt/big")
    t2.data.total_tokens = big + 500_000
    assert t2.try_restore() and t2.data.state()["pos"] == big
    manifest = ckpt.read_manifest(fs, "/pckpt/big", 7)
    assert manifest["leaves"]["['data_pos']"]["shape"] == [2]
    t.close()
    t2.close()


def test_step_anatomy_and_ranges(fs, token_file):
    """The step anatomy counts what ran, and a profile that records every
    thread sees the three ranges (the write's is on the writer thread)."""
    t = _port(fs, token_file, "/pckpt/anatomy", ckpt_interval=2)
    # the metrics source is the process's: earlier trainers counted too
    before = t.step_metrics.anatomy()
    every_thread = torch._C._profiler._ExperimentalConfig(
        profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=every_thread) as prof:
        t.train(4)
    names = {e.name for e in prof.events()}
    assert {"trainer.step", "trainer.ckpt.snapshot",
            "trainer.ckpt.write"} <= names
    a = anatomy_delta(before, t.step_metrics.anatomy())
    assert a["steps"] == 4
    assert a["data_wait"]["count"] == a["step_wall"]["count"] == 4
    assert a["ckpt"]["snapshot"]["num_ops"] == 2
    assert a["ckpt"]["write"]["num_ops"] == 2
    assert ckpt.list_checkpoints(fs, "/pckpt/anatomy") == [2, 4]
    t.close()


# ---------------------------------------------- what the mesh slice lifts

@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """The port's Trainer on dp2 and on tp2, two steps each, on a world
    of two gloo ranks (``dist_plans.trainer_ops``), from this file's
    token stream on the local disk: rank 0's losses by plan."""
    root = str(tmp_path_factory.mktemp("two_ranks"))
    toks = np.random.default_rng(0).integers(0, 256, 200_000,
                                             dtype=np.uint16)
    LocalFileSystem().write_all(f"{root}/tokens.bin", toks.tobytes())
    ops = []
    for name, plan in (("dp2", {"dp": 2}), ("tp2", {"tp": 2})):
        ops += [{"op": "make", "name": name, "plan": plan,
                 "ckpt": f"{root}/{name}", "kw": {"ckpt_interval": 0}},
                {"op": "train", "name": name, "steps": 2}]
    recs = spmd.launch(dist_plans.trainer_ops, 2, backend="gloo", args=(
        [{"preset": "tiny", "data": f"{root}/tokens.bin", "device": "cpu",
          "trainer": {"batch": BATCH, "lr": LR}, "ops": ops}],), timeout=300)
    return {r["name"]: r["losses"] for r in recs[0][0]
            if r["op"] == "train"}


@pytest.mark.parametrize("kw", [
    dict(plan=MeshPlan(dp=2)), dict(plan=MeshPlan(tp=2)), dict(zero1=True),
    dict(n_microbatches=2), dict(pipeline_schedule="interleaved"),
    dict(overlap=OverlapConfig(bucket_mb=1)), dict(parity=RELAXED_PARITY),
    dict(elastic=ElasticConfig(enabled=True, poll_steps=1)),
    dict(doctor_poll=lambda: {"trainers": {}})],
    ids=lambda kw: next(iter(kw)))
def test_trainer_refuses_what_queue_a6_brings(fs, token_file, port_curve,
                                              request, kw):
    """What ROADMAP Queue A 6 items 1 and 3 lifted now trains (the name
    stays from when all of it raised): a plan of two ranks within the
    curve tolerance of the one-device run
    (``tests/test_torch_trainer_mesh.py`` holds the mesh against the
    reference), and ZeRO-1, microbatches, a pipeline schedule, an
    overlap config, the relaxed parity tier (item 4: on one device it
    has no collective to quantize; ``tests/test_torch_relaxed.py`` holds
    it on a mesh), an enabled elastic plane polling a clear doctor feed
    every step, or a doctor poll without one, on one device exactly on
    its curve (``tests/test_torch_elastic.py`` holds the plane against
    the reference)."""
    plan = kw.pop("plan", MeshPlan())
    if plan != MeshPlan():
        losses = request.getfixturevalue("two_ranks")[
            "dp2" if plan.dp == 2 else "tp2"]
        np.testing.assert_allclose(losses, port_curve[:2], rtol=2e-4)
        return
    polls = []
    if "elastic" in kw:       # a clear feed: no rank flagged or dead
        kw["doctor_poll"] = lambda: polls.append(1) or {"trainers": {
            "flagged": {}, "ranks": {"rank-0": {"ok": True}}}}
    t = _port(fs, token_file, "/pckpt/lifted", **kw)
    np.testing.assert_allclose(t.train(2), port_curve[:2], rtol=1e-6)
    if "elastic" in kw:
        assert len(polls) == 2 and t.elastic.events == []
        assert t.plan == MeshPlan() and t.step == 2
    else:
        assert t.elastic is None
    if "parity" in kw:
        assert t._build_kwargs["parity"] is RELAXED_PARITY
    t.close()


def test_refusals_name_their_queue_item(fs, token_file):
    """The streaming ``leaf_transform`` onto a mesh raises with the
    reference's reason (it cannot compose with sharded placement), from
    the checkpoint load and from the serving loader. ``apply_plan``
    (the elastic plane, item 3, which raised here before) now rebuilds
    the trainer and restores the newest save bit for bit on one device.
    The sharded placement the other cases refused before the mesh slice
    now loads: on a one-rank layout it gives the plain load's tensors,
    and on a rank of dp2×tp2 that rank's shards (``shard_params``)."""
    t = _port(fs, token_file, "/pckpt/refuse")
    t.train(1)
    t.save()
    saved = [x.clone() for x in optimizer.tree_leaves(t.params)] + [
        x.clone() for m in (t.opt.mu, t.opt.nu)
        for x in optimizer.tree_leaves(m)]
    t.train(1)
    assert t.apply_plan(MeshPlan()) and t.step == 1 and t.mesh is None
    now = optimizer.tree_leaves(t.params) + [
        x for m in (t.opt.mu, t.opt.nu) for x in optimizer.tree_leaves(m)]
    assert len(now) == len(saved)
    assert all(torch.equal(a, b) for a, b in zip(now, saved))
    like = {"params": t.params}
    one = Mesh(MeshPlan(), 0, dict.fromkeys(AXES, 0), {})
    specs = param_specs(t.cfg, MeshPlan())
    with pytest.raises(NotImplementedError, match="cannot compose with "
                       "sharded placement"):
        ckpt.load_checkpoint(fs, "/pckpt/refuse", like, device="cpu",
                             mesh=one, specs={"params": specs},
                             leaf_transform=lambda n, a: a)
    with pytest.raises(NotImplementedError, match="cannot compose with "
                       "sharded placement"):
        loader.load_serving_params(fs, "/pckpt/refuse", t.cfg,
                                   device="cpu", mesh=one, specs=specs,
                                   leaf_transform=lambda n, a: a)
    with pytest.raises(ValueError, match="go together"):
        ckpt.load_checkpoint(fs, "/pckpt/refuse", like, device="cpu",
                             mesh=one)
    plain, _ = ckpt.load_checkpoint(fs, "/pckpt/refuse", like, device="cpu")
    placed, _ = ckpt.load_checkpoint(fs, "/pckpt/refuse", like,
                                     device="cpu", mesh=one,
                                     specs={"params": specs})
    for (name, a), (_, b) in zip(ckpt.leaf_paths(placed),
                                 ckpt.leaf_paths(plain)):
        assert torch.equal(a, b), name
    plan = MeshPlan(dp=2, tp=2)
    rank3 = Mesh(plan, 3, dict(dict.fromkeys(AXES, 0), dp=1, tp=1), {})
    got, _ = loader.load_serving_params(fs, "/pckpt/refuse", t.cfg,
                                        device="cpu", mesh=rank3,
                                        specs=param_specs(t.cfg, plan))
    want = shard_params(plain["params"], plan, rank3)
    for (name, a), (_, b) in zip(ckpt.leaf_paths(got),
                                 ckpt.leaf_paths(want)):
        assert torch.equal(a, b), name
    t.close()


def test_entry_points_refuse_a_missing_gpu(fs, token_file):
    """Without CUDA and without device="cpu", the trainer, the checkpoint
    load and the loader raise instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(config.get_config("tiny"), MeshPlan(), fs, token_file,
                "/pckpt/gpu", batch=BATCH)
    t = _port(fs, token_file, "/pckpt/gpu")
    t.save()
    with pytest.raises(RuntimeError, match="CUDA"):
        ckpt.load_checkpoint(fs, "/pckpt/gpu", {"params": t.params})
    with pytest.raises(RuntimeError, match="CUDA"):
        loader.load_serving_params(fs, "/pckpt/gpu", t.cfg)
    t.close()
