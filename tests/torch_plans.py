"""Shared by the port's parallel-plan tests (``test_torch_parallel.py``,
``test_torch_pipeline.py``, ``test_torch_ep.py``): the JAX package's
weights and batch for a preset, one plan trained by the JAX package on
the virtual 8-device mesh (``tests/test_parallel.py``'s ``_run_plan``),
the port's single-device step on the whole batch, and the tree
comparisons.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.parallel import MeshPlan as JMeshPlan
from hadoop_tpu.parallel import make_mesh as jmake_mesh
from hadoop_tpu.parallel import train as jtrain
from hadoop_tpu_torch.models import config
from hadoop_tpu_torch.models.convert import params_from_numpy
from hadoop_tpu_torch.parallel.optimizer import adamw_init
from hadoop_tpu_torch.parallel.train import make_train_step

BATCH, SEQ, WORLD, LR = 8, 32, 4, 1e-2
TOL = 2e-4


def jax_model(preset, overrides):
    """(JAX config, numpy weights of ``init_params(PRNGKey(0))``, tokens,
    targets) as ``tests/test_parallel.py`` makes them."""
    jcfg = jconfig.get_config(preset, **overrides)
    tree = jax.tree_util.tree_map(
        np.asarray, jdecoder.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = jax.random.randint(jax.random.PRNGKey(7), (BATCH, SEQ), 0,
                                jcfg.vocab_size, dtype=jnp.int32)
    tokens = np.asarray(tokens).astype(np.int64)
    return jcfg, tree, tokens, np.roll(tokens, -1, axis=1)


def job(preset, overrides, plans):
    """A ``dist_plans.train_plans`` job on the JAX package's weights and
    batch, on the CPU."""
    _, tree, tokens, targets = jax_model(preset, overrides)
    return {"preset": preset, "overrides": overrides, "weights": tree,
            "tokens": tokens, "targets": targets, "device": "cpu",
            "plans": plans}


def jax_run(preset, overrides, plan_kw, steps=2, optimizer="sgd",
            zero1=False, n_microbatches=1, schedule="1f1b"):
    """``tests/test_parallel.py``'s ``_run_plan`` on the same weights and
    batch: (losses, grad norms, gathered numpy tree in checkpoint layer
    order)."""
    jcfg, _, tokens, targets = jax_model(preset, overrides)
    plan = JMeshPlan(**plan_kw)
    m = jmake_mesh(plan)
    plan.validate(jcfg, BATCH, SEQ, n_microbatches)
    step = jtrain.make_train_step(jcfg, plan, m, lr=LR, donate=False,
                                  optimizer=optimizer, zero1=zero1,
                                  n_microbatches=n_microbatches,
                                  pipeline_schedule=schedule)
    params, opt = jtrain.init_sharded(jax.random.PRNGKey(0), jcfg, plan, m,
                                      zero1=zero1)
    ds = jtrain.make_data_sharding(m)
    tok = jax.device_put(jnp.asarray(tokens, jnp.int32), ds)
    tgt = jax.device_put(jnp.asarray(targets, jnp.int32), ds)
    losses, norms = [], []
    for _ in range(steps):
        params, opt, met = step(params, opt, tok, tgt)
        losses.append(float(met["loss"]))
        norms.append(float(met["grad_norm"]))
    params = jtrain.logical_layer_order(params, jcfg, plan)
    return losses, norms, jax.tree_util.tree_map(np.asarray,
                                                 jax.device_get(params))


_SINGLE = {}


def single(preset, overrides, steps=2, optimizer="sgd"):
    """The port's single-device step on the whole batch: (losses, grad
    norms, numpy tree)."""
    key = (preset, tuple(sorted(overrides.items())), steps, optimizer)
    if key not in _SINGLE:
        _, tree, tokens, targets = jax_model(preset, overrides)
        cfg = config.get_config(preset, **overrides)
        params = params_from_numpy(tree, cfg, device="cpu")
        opt = adamw_init(params)
        step = make_train_step(cfg, lr=LR, optimizer=optimizer, device="cpu")
        losses, norms = [], []
        for _ in range(steps):
            params, opt, met = step(params, opt, torch.from_numpy(tokens),
                                    torch.from_numpy(targets))
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
        _SINGLE[key] = (losses, norms, numpy_tree(params))
    return _SINGLE[key]


def numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: numpy_tree(v) for k, v in tree.items()}
    return tree.detach().float().numpy()


def assert_tree_close(got, want, tol=TOL, path=""):
    """Every leaf of ``want`` (the same keys in ``got``) at rtol = atol =
    ``tol``."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_close(got[k], want[k], tol, f"{path}/{k}")
        return
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol,
                               err_msg=f"mismatch at {path}")


def assert_tree_close_at(got, want, rtol, atol, path=""):
    if isinstance(want, dict):
        for k in want:
            assert_tree_close_at(got[k], want[k], rtol, atol, f"{path}/{k}")
        return
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=f"mismatch at {path}")


def assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}/{k}")
        return
    assert np.array_equal(got, want), path


def assert_plan_matches(got, want, loss_rtol=TOL, tol=TOL):
    """A plan's record (``dist_plans``) against another run's (losses,
    grad norms, tree): losses at ``loss_rtol``, grad norms and every
    gathered leaf at ``tol``."""
    losses, norms, params = want
    np.testing.assert_allclose(got["losses"], losses, rtol=loss_rtol)
    np.testing.assert_allclose(got["grad_norms"], norms, rtol=tol)
    assert_tree_close(got["params"], params, tol)
