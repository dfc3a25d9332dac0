"""MoE training in the PyTorch port against the JAX package's, on the CPU.

``tiny-moe`` in float32 through the port's ``make_train_step`` against
``hadoop_tpu.parallel.train.make_train_step(cfg, MeshPlan(), mesh)`` from
the same weights (the reference's ``init_sharded``, crossed through
``params_from_numpy``) and the same numpy-seeded batch, BATCH 8 × SEQ 32
as tests/test_parallel.py: 3 steps, SGD (lr 1e-2) and AdamW (lr 1e-3),
remat off and full, at capacity factor 4.0 (no token can drop) and at
the preset's 1.25 (the test asserts that tokens drop). Tolerances:
losses rtol 1e-4 (tests/test_parallel.py:188), parameters as its
``_assert_tree_close`` (rtol and atol 2e-4). AdamW at lr 1e-3: a
parameter whose gradient is near AdamW's eps (an expert that few tokens
reach) takes a first-step update g / (|g| + eps) that float32 sums in
another order move by a few percent of lr; at lr 1e-2 that alone is
3e-4 (seen on ``w_up``), past the parameter tolerance, where the losses
agree to 4e-7.

Then the storage path: the port's ``Trainer`` on ``tiny-moe`` writes
checkpoints byte for byte the reference's writer's for the same state,
resumes a crashed run bit-equal to the uninterrupted one, and
``load_serving_params`` feeds a ``DecodeEngine`` the reference loader
and engine's greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.parallel import MeshPlan as JMeshPlan, make_mesh
from hadoop_tpu.parallel import checkpoint as jckpt
from hadoop_tpu.parallel import optimizer as joptimizer
from hadoop_tpu.parallel import train as jtrain
from hadoop_tpu.parallel.elastic import reshard as jreshard
from hadoop_tpu.serving import engine as jengine
from hadoop_tpu.serving import loader as jloader
from hadoop_tpu.testing.minicluster import MiniDFSCluster
from hadoop_tpu_torch.models import config, decoder, moe, params_from_numpy
from hadoop_tpu_torch.obs.hbm import hbm_ledger
from hadoop_tpu_torch.parallel import MeshPlan, Trainer, adamw_init
from hadoop_tpu_torch.parallel import checkpoint as ckpt
from hadoop_tpu_torch.parallel import train as ptrain
from hadoop_tpu_torch.parallel.optimizer import tree_map
from hadoop_tpu_torch.serving import loader
from hadoop_tpu_torch.serving.engine import DecodeEngine, SamplingParams

BATCH, SEQ, STEPS = 8, 32, 3
LR = {"sgd": 1e-2, "adamw": 1e-3}
FACTORS = [4.0, 1.25]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to one thread: the tier-1 run shares the CPU between
    several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tokens():
    tokens = np.random.default_rng(7).integers(
        0, 256, (BATCH, SEQ)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _assert_tree_close(port, ref, rtol=2e-4, atol=2e-4):
    for key, value in port.items():
        if isinstance(value, dict):
            _assert_tree_close(value, ref[key], rtol, atol)
        else:
            np.testing.assert_allclose(value.detach().numpy(), ref[key],
                                       rtol=rtol, atol=atol, err_msg=key)


_refs = {}


def _reference(factor, optimizer):
    """The reference's 3 steps from ``init_sharded(PRNGKey(0))``: the
    initial weights as numpy, the losses, the final parameters."""
    key = (factor, optimizer)
    if key not in _refs:
        jcfg = jconfig.get_config("tiny-moe", capacity_factor=factor)
        plan = JMeshPlan()
        mesh = make_mesh(plan)
        step = jtrain.make_train_step(jcfg, plan, mesh, lr=LR[optimizer],
                                      donate=False, optimizer=optimizer)
        params, opt = jtrain.init_sharded(jax.random.PRNGKey(0), jcfg, plan,
                                          mesh)
        init = jax.tree_util.tree_map(np.asarray, params)
        tokens, targets = _tokens()
        losses = []
        for _ in range(STEPS):
            params, opt, m = step(params, opt, jnp.asarray(tokens),
                                  jnp.asarray(targets))
            losses.append(float(m["loss"]))
        _refs[key] = (init, losses,
                      jax.tree_util.tree_map(np.asarray, params))
    return _refs[key]


@pytest.mark.parametrize("remat", [False, "full"])
@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
@pytest.mark.parametrize("factor", FACTORS)
def test_moe_train_steps_match_jax(factor, optimizer, remat, monkeypatch):
    init, want_losses, want = _reference(factor, optimizer)
    cfg = config.get_config("tiny-moe", capacity_factor=factor)
    params = params_from_numpy(init, cfg, device="cpu")
    opt = adamw_init(params)
    kept, routed = [], []
    real_route = moe.route

    def counting_route(x, w, mcfg):
        d, c = real_route(x, w, mcfg)
        kept.append(int(d.sum()))
        routed.append(x.shape[0] * mcfg.top_k)
        return d, c

    monkeypatch.setattr(moe, "route", counting_route)
    step = ptrain.make_train_step(cfg, MeshPlan(), lr=LR[optimizer],
                                  optimizer=optimizer, remat=remat,
                                  device="cpu")
    tokens, targets = (torch.from_numpy(x) for x in _tokens())
    losses = []
    for _ in range(STEPS):
        params, opt, m = step(params, opt, tokens, targets)
        losses.append(m["loss"].item())
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4)
    _assert_tree_close(params, want)
    assert losses[-1] < losses[0]
    assert opt.count == STEPS
    # every layer routes once a forward, again in the recompute under
    # full remat; at capacity 4.0 no token drops, at 1.25 some do
    passes = 2 if remat else 1
    assert len(routed) == STEPS * cfg.n_layers * passes
    dropped = sum(routed) - sum(kept)
    assert (dropped == 0) if factor == 4.0 else (dropped > 0)


def test_router_gradient_matches_jax():
    """One step's gradient of the ``router`` leaf: through the
    renormalised top-k gates only, in both packages."""
    from hadoop_tpu.models.decoder import SINGLE
    init, _, _ = _reference(1.25, "sgd")
    jcfg = jconfig.get_config("tiny-moe")
    tokens, targets = _tokens()

    def jloss(p):
        h = jdecoder.forward_hidden(p, jnp.asarray(tokens), jcfg)
        return jtrain._loss_from_h(p, h, jnp.asarray(targets), jcfg, SINGLE)

    want = np.asarray(jax.grad(jloss)(jax.tree_util.tree_map(
        jnp.asarray, init))["layers"]["router"])
    cfg = config.get_config("tiny-moe")
    params = tree_map(lambda t: t.requires_grad_(),
                      params_from_numpy(init, cfg, device="cpu"))
    # the dispatch one-hots carry no gradient; the combine weights do
    x = torch.randn(16, cfg.d_model)
    dispatch, combine = moe.route(x, params["layers"]["router"][0], cfg)
    assert not dispatch.requires_grad and combine.requires_grad
    h = decoder.forward_hidden(params, torch.from_numpy(tokens).long(), cfg)
    loss = ptrain._loss_from_h(params, h, torch.from_numpy(targets).long(),
                               cfg)
    got, = torch.autograd.grad(loss, params["layers"]["router"])
    assert np.abs(want).max() > 1e-4
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


# ------------------------------------------------- Trainer, checkpoints

def test_hbm_ledger_counts_the_expert_stacks(fs, token_file):
    """The trainer's params and opt_state components in the HBM ledger
    hold the router and the expert stacks with the rest: the parameter
    tree's bytes, and two float32 moments of it."""
    led = hbm_ledger()
    before = led.component_bytes()[0]
    t = _trainer(fs, token_file, "/moeckpt/ledger")
    layers = t.params["layers"]
    experts = sum(layers[k].nbytes for k in ("router", "w_gate", "w_up",
                                             "w_down"))
    total = sum(p.nbytes for _, p in ckpt.leaf_paths(t.params))
    assert experts > total // 2
    after = led.component_bytes()[0]
    assert {k: after.get(k, 0) - before.get(k, 0)
            for k in ("params", "opt_state")} == {
        "params": total, "opt_state": 2 * total}
    t.close()
    assert led.component_bytes()[0] == before


@pytest.fixture(scope="module")
def fs():
    with MiniDFSCluster(num_datanodes=3) as c:
        yield c.get_filesystem()


@pytest.fixture(scope="module")
def token_file(fs):
    toks = np.random.default_rng(0).integers(0, 256, 60_000,
                                             dtype=np.uint16)
    fs.mkdirs("/moedata")
    fs.write_all("/moedata/tokens.bin", toks.tobytes())
    return "/moedata/tokens.bin"


def _trainer(fs, token_file, ckpt_dir, **kw):
    kw.setdefault("ckpt_interval", 0)
    return Trainer(config.get_config("tiny-moe"), MeshPlan(), fs, token_file,
                   ckpt_dir, batch=4, lr=1e-3, device="cpu", **kw)


def _files(fs, d):
    return {st.path.rsplit("/", 1)[-1]: fs.read_all(st.path)
            for st in fs.list_status(d)}


def test_trainer_checkpoint_is_the_reference_writers_bytes(fs, token_file):
    """Two steps through the port's Trainer, then its save against the
    reference's ``save_checkpoint`` of the same state: the same files,
    byte for byte (the router and the 4-D expert stacks among them), and
    the reference reads them back bit for bit."""
    t = _trainer(fs, token_file, "/moeckpt/port")
    t.train(2)
    t.save()
    numpy = lambda tree: tree_map(lambda x: x.detach().numpy(),  # noqa
                                  tree)
    pos = t.data.state()["pos"] % t.data.total_tokens
    jtree = {"params": numpy(t.params),
             "opt": joptimizer.AdamWState(np.asarray(t.opt.count, np.int32),
                                          numpy(t.opt.mu), numpy(t.opt.nu)),
             "data_pos": np.asarray(divmod(pos, 1 << 31), np.int32)}
    jckpt.save_checkpoint(fs, "/moeckpt/ref", 2, jtree,
                          meta=jreshard.manifest_meta(JMeshPlan(),
                                                      zero1=False))
    got = _files(fs, "/moeckpt/port/step_000000000002")
    ref = _files(fs, "/moeckpt/ref/step_000000000002")
    assert sorted(got) == sorted(ref)
    for name in ref:
        assert got[name] == ref[name], name
    manifest = ckpt.read_manifest(fs, "/moeckpt/port", 2)
    leaves = manifest["leaves"]
    assert leaves["['params']['layers']['router']"]["shape"] == [2, 64, 4]
    assert leaves["['opt'].mu['layers']['w_gate']"]["shape"] == \
        [2, 4, 64, 128]
    assert leaves["['opt'].nu['layers']['w_down']"]["shape"] == \
        [2, 4, 128, 64]
    back, step = jckpt.load_checkpoint(fs, "/moeckpt/port", jtree)
    assert step == 2
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    t.close()


def test_trainer_resume_is_bit_equal_and_serves(fs, token_file):
    """Six uninterrupted steps; a run that crashes after its interval save
    at step 3 and a fresh Trainer that restores and trains 3 more: the
    resumed losses equal the uninterrupted ones bit for bit. The last
    checkpoint then loads through both packages' loaders, and the port's
    engine gives the reference engine's greedy tokens."""
    u = _trainer(fs, token_file, "/moeckpt/curve")
    want = u.train(6)
    u.close()
    a = _trainer(fs, token_file, "/moeckpt/resume", ckpt_interval=3)
    assert a.train(3) == want[:3]
    a.close()
    b = _trainer(fs, token_file, "/moeckpt/resume")
    assert b.try_restore() and b.step == 3
    assert b.train(3) == want[3:]
    b.save()
    b.close()

    cfg, jcfg = config.get_config("tiny-moe"), jconfig.get_config("tiny-moe")
    params, step = loader.load_serving_params(fs, "/moeckpt/resume", cfg,
                                              device="cpu")
    jparams, jstep = jloader.load_serving_params(fs, "/moeckpt/resume",
                                                 jcfg)
    assert step == jstep == 6
    for x, y in zip(ckpt.leaf_paths(params), ckpt.leaf_paths(b.params)):
        assert torch.equal(x[1], y[1]), x[0]
    kw = dict(max_batch=2, block_size=4, max_context=64)
    prompts = [[5, 9, 2, 7], [1, 2, 3], [200, 17, 64, 3, 99], [8]]
    got = DecodeEngine(params, cfg, device="cpu", **kw).generate(
        prompts, SamplingParams(max_new_tokens=8))
    ref = jengine.DecodeEngine(jparams, jcfg, moe_shards=1, **kw).generate(
        prompts, jengine.SamplingParams(max_new_tokens=8))
    assert got == ref
