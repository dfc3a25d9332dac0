"""The PyTorch port's training step against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both; weights come from
the JAX package's ``init_sharded`` and cross through
``params_from_numpy``. Tolerances: 1e-5 for the cross-entropy and its
gradient (float32, one softmax) and for AdamW (float32 elementwise, sums
in another order); 2e-4 for a whole train step, the reference's own for
plan parity (tests/test_parallel.py); 5e-4 relative for a 20-step loss
curve (the multi-GPU acceptance of __graft_entry__.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_tpu.models import config as jconfig
from hadoop_tpu.ops import cross_entropy as jce
from hadoop_tpu.parallel import MeshPlan as JMeshPlan, make_mesh
from hadoop_tpu.parallel import optimizer as joptimizer
from hadoop_tpu.parallel import train as jtrain
from hadoop_tpu_torch import init_train_state, make_train_step
from hadoop_tpu_torch.models import config, params_from_numpy
from hadoop_tpu_torch.ops import cross_entropy, flash
from hadoop_tpu_torch.parallel import MeshPlan, adamw_init, adamw_update
from hadoop_tpu_torch.parallel import optimizer
from hadoop_tpu_torch.parallel.optimizer import tree_leaves

BATCH, SEQ = 8, 32


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to one thread: the tier-1 run shares the CPU between
    several test workers, some of them timing-sensitive."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tokens(vocab, batch=BATCH, seq=SEQ, seed=7):
    tokens = np.random.default_rng(seed).integers(
        0, vocab, (batch, seq)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _close(got, want, tol, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=msg)


def _assert_tree_close(port, ref, tol):
    for key, value in port.items():
        if isinstance(value, dict):
            _assert_tree_close(value, ref[key], tol)
        else:
            _close(value.detach().numpy(), ref[key], tol, key)


class _Reference:
    """The JAX package's single-device step on ``tiny``, with the weights
    both runs start from."""

    def __init__(self, optimizer, lr):
        self.cfg = jconfig.get_config("tiny")
        plan = JMeshPlan()
        mesh = make_mesh(plan)
        self.step = jtrain.make_train_step(self.cfg, plan, mesh, lr=lr,
                                           donate=False, optimizer=optimizer)
        self.params, self.opt = jtrain.init_sharded(
            jax.random.PRNGKey(0), self.cfg, plan, mesh)
        self.numpy_params = jax.tree_util.tree_map(np.asarray, self.params)

    def run(self, n_steps, tokens, targets):
        params, opt, losses = self.params, self.opt, []
        for _ in range(n_steps):
            params, opt, m = self.step(params, opt, jnp.asarray(tokens),
                                       jnp.asarray(targets))
            losses.append(float(m["loss"]))
        return losses, jax.tree_util.tree_map(np.asarray, params), m

    def port_state(self):
        cfg = config.get_config("tiny")
        params = params_from_numpy(self.numpy_params, cfg, device="cpu")
        return cfg, params, adamw_init(params)


@pytest.fixture(scope="module")
def reference_steps():
    """One reference step per optimizer (lr 1e-2), and a 20-step AdamW
    loss curve (lr 1e-3)."""
    tokens, targets = _tokens(256)
    out = {}
    for optimizer in ("sgd", "adamw"):
        ref = _Reference(optimizer, 1e-2)
        out[optimizer] = (ref, ref.run(1, tokens, targets))
    curve = _Reference("adamw", 1e-3)
    out["curve"] = (curve, curve.run(20, tokens, targets))
    return out


@pytest.mark.parametrize("remat", [False, "full", "dots"])
@pytest.mark.parametrize("optimizer", ["sgd", "adamw"])
def test_train_step_matches_jax(reference_steps, optimizer, remat):
    ref, (losses, want, metrics) = reference_steps[optimizer]
    cfg, params, opt = ref.port_state()
    tokens, targets = _tokens(cfg.vocab_size)
    step = make_train_step(cfg, MeshPlan(), lr=1e-2, optimizer=optimizer,
                           remat=remat, device="cpu")
    params, opt, m = step(params, opt, torch.from_numpy(tokens),
                          torch.from_numpy(targets))
    _close(m["loss"].item(), losses[0], 2e-4, "loss")
    _close(m["grad_norm"].item(), float(metrics["grad_norm"]), 2e-4)
    _assert_tree_close(params, want, 2e-4)
    assert opt.count == 1
    assert flash.launches_bwd_dq == flash.launches_bwd_dkv == 0


def test_adamw_loss_curve_matches_jax(reference_steps):
    ref, (losses, want, _) = reference_steps["curve"]
    cfg, params, opt = ref.port_state()
    tokens, targets = _tokens(cfg.vocab_size)
    step = make_train_step(cfg, lr=1e-3, device="cpu")
    got = []
    for _ in range(20):
        params, opt, m = step(params, opt, tokens, targets)
        got.append(m["loss"].item())
    np.testing.assert_allclose(got, losses, rtol=5e-4)
    assert got[-1] < got[0]
    assert opt.count == 20


def test_flash_and_plain_attention_train_alike():
    """A tiny override with head dim 64 and S 128, so ``supported`` holds:
    the step through FlashAttention (its plain versions on the CPU)
    against the step through the einsum-softmax attention."""
    cfg = config.get_config("tiny", d_model=256, n_heads=4, n_kv_heads=2)
    tokens, targets = _tokens(cfg.vocab_size, batch=2, seq=128)
    results = []
    for impl in ("flash", "ref"):
        params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                       device="cpu")
        step = make_train_step(cfg, lr=1e-2, optimizer="sgd",
                               attn_impl=impl, device="cpu")
        for _ in range(2):
            params, opt, m = step(params, opt, tokens, targets)
        results.append((m["loss"].item(), params))
    (loss_a, pa), (loss_b, pb) = results
    _close(loss_a, loss_b, 1e-5, "loss")
    for a, b in zip(tree_leaves(pa), tree_leaves(pb)):
        _close(a.numpy(), b.numpy(), 1e-5)


@pytest.mark.parametrize("remat,passes", [(False, 1), ("full", 2),
                                          ("dots", 2)])
def test_remat_recomputes_the_flash_forward(monkeypatch, remat, passes):
    """Under "full" and "dots" every layer's flash forward runs again in
    the backward (the kernel is not a dot), so a step calls it twice per
    layer, as the 36 launches per flagship step on the GPU; without remat
    once."""
    cfg = config.get_config("tiny", d_model=256, n_heads=4, n_kv_heads=2)
    tokens, targets = _tokens(cfg.vocab_size, batch=1, seq=128)
    calls = []
    plain = flash.flash_attention_ref
    monkeypatch.setattr(flash, "flash_attention_ref",
                        lambda *a: calls.append(1) or plain(*a))
    params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                   device="cpu")
    step = make_train_step(cfg, remat=remat, attn_impl="flash",
                           device="cpu")
    step(params, opt, tokens, targets)
    assert len(calls) == passes * cfg.n_layers


def test_train_step_refusals():
    """Every plan is ported (dp, tp, ZeRO-1: tests/test_torch_parallel.py;
    pp, vpp: test_torch_pipeline.py; ep: test_torch_ep.py) and a plan of
    more than one rank needs its mesh; the interleaved schedule refuses
    M % pp != 0 and an unknown schedule raises; microbatches at pp 1 run
    the flat step."""
    cfg = config.get_config("tiny")
    for plan, kw in [(MeshPlan(dp=2), {}), (MeshPlan(tp=2), {}),
                     (MeshPlan(pp=2), {"n_microbatches": 2}),
                     (MeshPlan(pp=2, vpp=2), {"n_microbatches": 2})]:
        with pytest.raises(ValueError, match="mesh"):
            make_train_step(cfg, plan, device="cpu", **kw)
    with pytest.raises(ValueError, match="divisible by pp"):
        make_train_step(cfg, MeshPlan(pp=2, vpp=2), device="cpu")
    with pytest.raises(ValueError, match="pipeline_schedule"):
        make_train_step(cfg, pipeline_schedule="zb", device="cpu")
    make_train_step(cfg, MeshPlan(), zero1=True, device="cpu")
    # two microbatches on one device: the flat step, the same numbers
    tokens, targets = _tokens(cfg.vocab_size, batch=2, seq=16)
    got = []
    for m in (1, 2):
        params, opt = init_train_state(cfg, torch.Generator().manual_seed(0),
                                       device="cpu")
        step = make_train_step(cfg, n_microbatches=m, optimizer="sgd",
                               device="cpu")
        got.append(float(step(params, opt, tokens, targets)[2]["loss"]))
    assert got[0] == got[1]
    make_train_step(config.get_config("tiny-moe"), device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(config.get_config("tiny-moe"), MeshPlan(ep=2),
                        device="cpu")
    with pytest.raises(ValueError):
        make_train_step(cfg, remat="everything", device="cpu")
    with pytest.raises(ValueError):
        make_train_step(cfg, optimizer="lion", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_train_step(cfg)
        with pytest.raises(RuntimeError, match="CUDA"):
            init_train_state(cfg, torch.Generator())


def test_mesh_plan_matches_jax():
    for kw in [{}, {"dp": 2, "tp": 4}, {"pp": 2, "vpp": 2},
               {"tp": 2, "megatron_sp": True}, {"sp": 2, "tp": 2}]:
        assert MeshPlan(**kw).n_devices == JMeshPlan(**kw).n_devices
        assert dataclasses.asdict(MeshPlan(**kw)) == \
            dataclasses.asdict(JMeshPlan(**kw))
    for kw in [{"megatron_sp": True}, {"vpp": 2}, {"sp": 2, "ep": 2},
               {"sp": 2, "tp": 2, "megatron_sp": True}]:
        with pytest.raises(ValueError):
            JMeshPlan(**kw)
        with pytest.raises(ValueError):
            MeshPlan(**kw)


def test_cross_entropy_matches_jax():
    logits, targets = _randn(0, 2, 16, 50), np.random.default_rng(1).integers(
        0, 50, (2, 16))
    t_logits = torch.from_numpy(logits).requires_grad_()
    got = cross_entropy.softmax_cross_entropy(t_logits,
                                              torch.from_numpy(targets))
    got.backward()
    want, want_grad = jax.value_and_grad(jce.softmax_cross_entropy)(
        jnp.asarray(logits), jnp.asarray(targets))
    _close(got.item(), float(want), 1e-5)
    _close(t_logits.grad.numpy(), want_grad, 1e-5)


@pytest.mark.parametrize("seq,chunk", [(32, 8), (24, 16)])   # 24: fallback
def test_chunked_cross_entropy_matches_jax(seq, chunk):
    h, head = _randn(2, 2, seq, 16), _randn(3, 16, 40) * 0.5
    targets = np.random.default_rng(4).integers(0, 40, (2, seq))
    th = torch.from_numpy(h).requires_grad_()
    thead = torch.from_numpy(head).requires_grad_()
    got = cross_entropy.chunked_lm_cross_entropy(
        th, thead, torch.from_numpy(targets), chunk)
    got.backward()
    want, (gh, ghead) = jax.value_and_grad(
        jce.chunked_lm_cross_entropy, argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(head), jnp.asarray(targets), chunk)
    _close(got.item(), float(want), 1e-5)
    _close(th.grad.numpy(), gh, 1e-5)
    _close(thead.grad.numpy(), ghead, 1e-5)
    plain = cross_entropy.softmax_cross_entropy(
        torch.from_numpy(h) @ torch.from_numpy(head),
        torch.from_numpy(targets))
    _close(got.item(), plain.item(), 1e-5)


def test_adamw_update_matches_jax():
    """Several steps on a tree with a matrix (decayed), a vector (not) and
    a gradient large enough to be clipped."""
    tree = {"w": _randn(5, 6, 4), "b": _randn(6, 4), "layers": {
        "u": _randn(7, 3, 2, 5)}}
    params = {"w": torch.from_numpy(tree["w"].copy()),
              "b": torch.from_numpy(tree["b"].copy()),
              "layers": {"u": torch.from_numpy(tree["layers"]["u"].copy())}}
    state = adamw_init(params)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    jstate = joptimizer.adamw_init(jparams)
    for i in range(4):
        g = jax.tree_util.tree_map(
            lambda x, s=i: _randn(10 + s, *x.shape) * (3.0 if s == 1 else
                                                       0.1), tree)
        tg = jax.tree_util.tree_map(torch.from_numpy, g)
        params, state, gnorm = adamw_update(params, tg, state, 1e-2)
        jparams, jstate, jgnorm = joptimizer.adamw_update(
            jparams, jax.tree_util.tree_map(jnp.asarray, g), jstate, 1e-2)
        _close(gnorm.item(), float(jgnorm), 1e-5)
        _assert_tree_close(params, jparams, 1e-5)
        _assert_tree_close(state.mu, jstate.mu, 1e-5)
        _assert_tree_close(state.nu, jstate.nu, 1e-5)
        assert state.count == int(jstate.count) == i + 1


def test_adamw_on_cpu_is_the_plain_version_uncounted():
    """On CPU tensors the update and the norm are their plain versions
    and count no launch; the kernels' wrappers refuse CPU tensors (never
    a CPU launch) and what the kernel does not take."""
    params = {"w": torch.from_numpy(_randn(20, 3, 4)),
              "b": torch.from_numpy(_randn(21, 4))}
    grads = {"w": torch.from_numpy(_randn(22, 3, 4)),
             "b": torch.from_numpy(_randn(23, 4))}
    state = adamw_init(params)
    before = (optimizer.launches, optimizer.launches_grad_sq)
    assert torch.equal(optimizer.grad_sq(grads), optimizer.grad_sq_ref(grads))
    adamw_update(params, grads, state, 1e-2)
    assert (optimizer.launches, optimizer.launches_grad_sq) == before
    p, g = params["w"], grads["w"]
    m, n = state.mu["w"], state.nu["w"]
    scale = torch.tensor(1.0)
    hyper = optimizer._hyper(1, 1e-2, 0.9, 0.95, 1e-8, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        optimizer._launch_adamw(p, g, m, n, scale, hyper, True)
    with pytest.raises(ValueError, match="CUDA"):
        optimizer._launch_grad_sq([g])
    assert list(hyper) == ["b1", "one_minus_b1", "b2", "one_minus_b2",
                           "bc1", "bc2", "eps", "weight_decay", "lr"]


def test_adamw_pieces_are_views_that_cover_each_leaf(monkeypatch):
    """The kernels count elements in int, so a leaf goes in pieces of at
    most ``_CHUNK`` elements: views of it, in order, covering it once."""
    monkeypatch.setattr(optimizer, "_CHUNK", 5)
    a = torch.arange(12.0).view(3, 4)
    b = torch.arange(12.0, 24.0).view(4, 3)
    pieces = list(optimizer._pieces(a, b))
    assert [len(pa) for pa, _ in pieces] == [5, 5, 2]
    assert torch.equal(torch.cat([pa for pa, _ in pieces]), a.view(-1))
    assert torch.equal(torch.cat([pb for _, pb in pieces]), b.view(-1))
    pieces[1][0][0] = -1.0                          # a view, not a copy
    assert a.view(-1)[5] == -1.0
