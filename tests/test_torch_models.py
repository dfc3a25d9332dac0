"""The PyTorch port's model core against the JAX package's, on the CPU.

Weights come from the JAX package's ``init_params`` and cross through
``params_from_numpy``. Logits are compared in float32 at atol/rtol 1e-4
(18 or fewer float32 layers of matmuls summed in another order), with
equal argmax. Also here: the port's isolation from JAX and its refusal
to run on a device nobody asked for.
"""

import dataclasses
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu_torch import DecodeEngine
from hadoop_tpu_torch.models import config, params_from_numpy
from hadoop_tpu_torch.models import decoder
from hadoop_tpu_torch.ops import rope_frequencies

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to one thread: the tier-1 run shares the CPU between
    several test workers, some of them timing-sensitive."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# flagship-1b cut to 2 layers and d_model 512; 4/2 heads keep head_dim 128
_TRIMMED = dict(n_layers=2, d_model=512, n_heads=4, n_kv_heads=2,
                dtype="float32")


def _both(preset, **overrides):
    jcfg = jconfig.get_config(preset, **overrides)
    cfg = config.get_config(preset, **overrides)
    jparams = jdecoder.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_numpy(tree, cfg, device="cpu")


def test_presets_equal_field_for_field():
    assert set(config.PRESETS) == set(jconfig.PRESETS)
    for name, cfg in config.PRESETS.items():
        assert dataclasses.asdict(cfg) == \
            dataclasses.asdict(jconfig.PRESETS[name]), name
        assert cfg.head_dim == jconfig.PRESETS[name].head_dim


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_from_numpy_round_trips_bit_exact(dtype):
    jcfg = jconfig.get_config("tiny-gpt2", dtype=dtype)
    cfg = config.get_config("tiny-gpt2", dtype=dtype)
    tree = jax.tree_util.tree_map(
        np.asarray, jdecoder.init_params(jax.random.PRNGKey(3), jcfg))
    got = params_from_numpy(tree, cfg, device="cpu")
    flat_np = jax.tree_util.tree_leaves_with_path(tree)
    assert len(flat_np) == len(jax.tree_util.tree_leaves(got))
    for path, arr in flat_np:
        t = got
        for key in path:
            t = t[key.key]
        assert t.dtype == cfg.torch_dtype and tuple(t.shape) == arr.shape
        bits = np.int16 if dtype == "bfloat16" else np.int32
        tview = torch.int16 if dtype == "bfloat16" else torch.int32
        np.testing.assert_array_equal(t.view(tview).numpy(), arr.view(bits))
    with pytest.raises(ValueError):      # a leaf of another dtype
        params_from_numpy(tree, config.get_config(
            "tiny-gpt2", dtype="float32" if dtype == "bfloat16"
            else "bfloat16"), device="cpu")


@pytest.mark.parametrize("preset", ["tiny", "tiny-gpt2"])
def test_init_params_layout_matches_jax(preset):
    """Same leaf names, shapes and dtypes; fan-in scaled weights."""
    cfg = config.get_config(preset)
    got = decoder.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    want = jdecoder.init_params(jax.random.PRNGKey(0),
                                jconfig.get_config(preset))
    shapes = jax.tree_util.tree_map(lambda a: (a.shape, str(a.dtype)), want)
    assert jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).replace("torch.", "")),
        got) == shapes
    std = got["layers"]["wq"].std().item() * cfg.d_model ** 0.5
    assert 0.9 < std < 1.1


@pytest.mark.parametrize("preset,overrides,seq", [
    ("tiny", {}, 16),
    ("tiny-gpt2", {}, 16),
    ("flagship-1b", _TRIMMED, 128),
])
def test_forward_matches_jax(preset, overrides, seq):
    jcfg, jparams, cfg, params = _both(preset, **overrides)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, seq))
    want = np.asarray(jdecoder.forward(jparams, jnp.asarray(tokens), jcfg))
    got = decoder.forward(params, tokens, cfg, device="cpu").numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_forward_flash_path_on_cpu_matches_plain():
    """attn_impl="flash" reaches the kernel's wrapper, which computes its
    plain version for CPU tensors: same logits as the einsum path."""
    _, _, cfg, params = _both("flagship-1b", **_TRIMMED)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 128))
    flash_logits = decoder.forward(params, tokens, cfg, device="cpu",
                                   attn_impl="flash")
    ref_logits = decoder.forward(params, tokens, cfg, device="cpu",
                                 attn_impl="ref")
    torch.testing.assert_close(flash_logits, ref_logits, atol=1e-4,
                               rtol=1e-4)


def test_causality():
    """Changing a future token must not change earlier logits."""
    cfg = config.get_config("tiny")
    params = decoder.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (1, 16)))
    logits_a = decoder.forward(params, tokens, cfg, device="cpu")
    tokens_b = tokens.clone()
    tokens_b[0, 10] = (tokens[0, 10] + 1) % cfg.vocab_size
    logits_b = decoder.forward(params, tokens_b, cfg, device="cpu")
    torch.testing.assert_close(logits_a[0, :10], logits_b[0, :10],
                               rtol=1e-5, atol=1e-5)
    assert not torch.allclose(logits_a[0, 10:], logits_b[0, 10:])


def _run_layers_sliced(x, layers, cfg, cos, sin, attn_impl="auto",
                       remat=False):
    """The layer loop as it was before ``layer_slices``: ``w[i]`` of each
    stacked leaf in each layer."""
    body = decoder._layer_fn(remat)
    for i in range(cfg.n_layers):
        x = body(x, {name: w[i] for name, w in layers.items()}, cfg, cos,
                 sin, attn_impl)
    return x


def _layer_grads(run, params, tokens, cfg, remat):
    """The layer stack's output and the gradients of its stacked leaves,
    through ``run``."""
    leaves = {name: w.detach().requires_grad_()
              for name, w in params["layers"].items()}
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta)
    h = decoder.embed_tokens(params, tokens, cfg)
    out = run(h, leaves, cfg, cos, sin, "auto", remat)
    loss = out.float().square().mean()
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return out, dict(zip(leaves, grads)), leaves, loss


@pytest.mark.parametrize("remat", [False, "full", "dots"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_unbound_layers_give_the_gradients_of_per_layer_slices(dtype,
                                                               remat):
    """Each stacked leaf unbound once gives the same output and the same
    gradients, value for value, as ``w[i]`` taken in each layer: every
    gradient element has one non-zero term either way, and the terms the
    per-layer slices add are exact zeros."""
    cfg = config.get_config("tiny", dtype=dtype)
    params = decoder.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 16)))
    out, grads, _, _ = _layer_grads(decoder.run_layers, params, tokens, cfg,
                                    remat)
    want_out, want, _, _ = _layer_grads(_run_layers_sliced, params, tokens,
                                        cfg, remat)
    assert torch.equal(out, want_out)
    for name, g in grads.items():
        assert g.dtype == cfg.torch_dtype
        assert torch.equal(g, want[name]), name


def test_no_select_backward_on_a_stacked_leaf():
    """Without remat, the only node that feeds a stacked leaf's gradient
    is one ``UnbindBackward0`` (a single stack of its layers' slices), not
    one ``SelectBackward0`` per layer, each a zero-filled full-size
    gradient to add up."""
    cfg = config.get_config("tiny")
    params = decoder.init_params(cfg, torch.Generator().manual_seed(0),
                                 device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 16)))
    _, _, leaves, loss = _layer_grads(decoder.run_layers, params, tokens,
                                      cfg, False)
    feeders = {name: [] for name in leaves}
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            if nxt.name() == "torch::autograd::AccumulateGrad":
                for name, w in leaves.items():
                    if nxt.variable is w:
                        feeders[name].append(node.name())
            todo.append(nxt)
    assert feeders == {name: ["UnbindBackward0"] for name in leaves}
    with pytest.raises(ValueError, match="layers"):
        decoder.layer_slices(params["layers"], cfg.n_layers + 1)


def test_entry_points_refuse_a_missing_gpu():
    """Without CUDA and without device="cpu", every entry point raises;
    and parameters on another device than the one asked for are refused."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = config.get_config("tiny")
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        decoder.init_params(cfg, gen)
    params = decoder.init_params(cfg, gen, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        decoder.forward(params, [[1, 2, 3]], cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeEngine(params, cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        params_from_numpy({"embed": np.zeros((2, 2), np.float32)}, cfg)
    with pytest.raises(ValueError):
        decoder.forward(params, [[1, 2, 3]], cfg, device="meta")


def test_moe_trains_on_one_device_and_refuses_expert_parallelism(tmp_path):
    """Both training entry points take tiny-moe on ``MeshPlan()`` (ROADMAP
    Queue A 5); the train step takes an expert-parallel plan on its mesh
    (``tests/test_torch_ep.py``), and so does ``Trainer`` since the mesh
    slice (the name stays from when it refused): it validates the plan
    against the config and asks for the process group it runs on
    (``tests/test_torch_trainer_mesh.py`` trains plans on one)."""
    from hadoop_tpu_torch.fs import LocalFileSystem
    from hadoop_tpu_torch.parallel import Trainer, make_train_step
    from hadoop_tpu_torch.parallel.mesh import MeshPlan
    cfg = config.get_config("tiny-moe")
    fs, data = LocalFileSystem(), str(tmp_path / "tokens.bin")
    fs.write_all(data, np.arange(4 * (cfg.max_seq + 1),
                                 dtype=np.uint16).tobytes())
    step = make_train_step(cfg, MeshPlan(), device="cpu")
    t = Trainer(cfg, MeshPlan(), fs, data, str(tmp_path / "ckpt"), batch=1,
                device="cpu")
    assert t.params["layers"]["router"].shape == (2, 64, 4)
    assert t.opt.mu["layers"]["w_gate"].shape == (2, 4, 64, 128)
    _, _, m = step(t.params, t.opt, *(torch.zeros(1, 8, dtype=torch.long),) * 2)
    assert torch.isfinite(m["loss"])
    t.close()
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(cfg, MeshPlan(ep=2), device="cpu")
    with pytest.raises(ValueError, match="batch %% dp\\*ep"):
        Trainer(cfg, MeshPlan(ep=2), fs, data, str(tmp_path / "ep"),
                batch=1, device="cpu")
    with pytest.raises(RuntimeError, match="torch.distributed"):
        Trainer(cfg, MeshPlan(ep=2), fs, data, str(tmp_path / "ep"),
                batch=2, device="cpu")


def test_port_imports_no_jax_and_no_jax_package():
    """In a fresh interpreter (this one has JAX loaded by conftest), the
    port and chip_smoke's module-level imports load no jax and no
    hadoop_tpu module."""
    code = (
        "import sys\n"
        "import chip_smoke\n"
        "import hadoop_tpu_torch, hadoop_tpu_torch.models.convert\n"
        "import hadoop_tpu_torch.ops.flash, hadoop_tpu_torch.ops._build\n"
        "import hadoop_tpu_torch.serving.engine\n"
        "import hadoop_tpu_torch.ops.cross_entropy\n"
        "import hadoop_tpu_torch.parallel.train\n"
        "import hadoop_tpu_torch.tools.profile_flagship\n"
        "import hadoop_tpu_torch.tools.ab_flash\n"
        "import hadoop_tpu_torch.tools.moe_graph_eager\n"
        "import hadoop_tpu_torch.serving.longctx\n"
        "import hadoop_tpu_torch.parallel.ring_attention\n"
        "import hadoop_tpu_torch.fs, hadoop_tpu_torch.parallel.data\n"
        "import hadoop_tpu_torch.parallel.checkpoint\n"
        "import hadoop_tpu_torch.parallel.trainer\n"
        "import hadoop_tpu_torch.serving.loader\n"
        "import hadoop_tpu_torch.obs.hbm, hadoop_tpu_torch.obs.trainer\n"
        "import hadoop_tpu_torch.conf, hadoop_tpu_torch.tracing\n"
        "import hadoop_tpu_torch.metrics, hadoop_tpu_torch.obs.slo\n"
        "import hadoop_tpu_torch.registry, hadoop_tpu_torch.http.server\n"
        "import hadoop_tpu_torch.security.http_auth\n"
        "import hadoop_tpu_torch.serving.metrics\n"
        "import hadoop_tpu_torch.serving.qos\n"
        "import hadoop_tpu_torch.serving.server\n"
        "import hadoop_tpu_torch.serving.service\n"
        "import hadoop_tpu_torch.serving.speculate\n"
        "import hadoop_tpu_torch.serving.kvstore.tiered\n"
        "import hadoop_tpu_torch.serving.weightplane\n"
        "import hadoop_tpu_torch.models.moe\n"
        "import hadoop_tpu_torch.io.erasurecode\n"
        "import hadoop_tpu_torch.ops.ec_device\n"
        "import hadoop_tpu_torch.parallel.lowp.quant\n"
        "import hadoop_tpu_torch.parallel.spmd, hadoop_tpu_torch.parallel.mesh\n"
        "import hadoop_tpu_torch.parallel.pipeline\n"
        "import hadoop_tpu_torch.parallel.ulysses\n"
        "import hadoop_tpu_torch.parallel.overlap\n"
        "import hadoop_tpu_torch.ops.collective_matmul\n"
        "import hadoop_tpu_torch.tools.dist_plans\n"
        "import hadoop_tpu_torch.parallel.collectives\n"
        "import hadoop_tpu_torch.mapreduce.device_shuffle\n"
        "import hadoop_tpu_torch.parallel.elastic.controller\n"
        "import hadoop_tpu_torch.parallel.lowp.guard\n"
        "import hadoop_tpu_torch.parallel.lowp.syncpolicy\n"
        "import hadoop_tpu_torch.tools.ab_wire\n"
        "import hadoop_tpu_torch.obs.top, hadoop_tpu_torch.io.wire\n"
        "import hadoop_tpu_torch.ipc.rpc, hadoop_tpu_torch.yarn\n"
        "import hadoop_tpu_torch.security.ugi\n"
        "import hadoop_tpu_torch.security.sasl, hadoop_tpu_torch.ipc.retry\n"
        "import hadoop_tpu_torch.util.crc\n"
        "import hadoop_tpu_torch.dfs.client.filesystem\n"
        "import hadoop_tpu_torch.dfs.client.dfsclient\n"
        "import hadoop_tpu_torch.dfs.client.streams\n"
        "import hadoop_tpu_torch.dfs.client.striped\n"
        "import hadoop_tpu_torch.dfs.client.shortcircuit\n"
        "import hadoop_tpu_torch.dfs.protocol.records\n"
        "import hadoop_tpu_torch.dfs.protocol.datatransfer\n"
        "import hadoop_tpu_torch.dfs.protocol.blocktoken\n"
        "bad = [m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib')) or m == 'hadoop_tpu' or "
        "m.startswith('hadoop_tpu.')]\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_port_sources_name_no_jax():
    """No port source imports jax or names a module of the JAX package."""
    files = sorted((REPO / "hadoop_tpu_torch").rglob("*.py")) + sorted(
        (REPO / "hadoop_tpu_torch").rglob("*.cu")) + sorted(
        (REPO / "hadoop_tpu_torch").rglob("*.cuh")) + sorted(
        (REPO / "hadoop_tpu_torch").rglob("*.cc")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    for new in ("ops/csrc/flash_bwd.cu", "ops/csrc/sm90.cuh",
                "ops/csrc/adamw.cu",
                "ops/csrc/flash_fwd_sm90.cuh", "ops/cross_entropy.py",
                "parallel/mesh.py", "parallel/optimizer.py",
                "parallel/train.py", "parallel/ring_attention.py",
                "serving/longctx/plan.py", "serving/longctx/prefill.py",
                "serving/longctx/guard.py", "fs.py", "parallel/data.py",
                "parallel/checkpoint.py", "parallel/trainer.py",
                "serving/loader.py", "obs/hbm.py", "obs/trainer.py",
                "conf.py", "tracing.py", "metrics.py", "obs/slo.py",
                "registry.py", "http/server.py", "security/http_auth.py",
                "serving/metrics.py", "serving/qos.py", "serving/server.py",
                "serving/service.py", "serving/speculate.py",
                "serving/kvstore/radix.py", "serving/kvstore/codec.py",
                "serving/kvstore/hosttier.py", "serving/kvstore/dfstier.py",
                "serving/kvstore/tiered.py", "serving/weightplane.py",
                "models/moe.py", "parallel/lowp/quant.py",
                "io/erasurecode.py", "ops/ec_device.py",
                "ops/csrc/ec_gf256.cu", "parallel/spmd.py",
                "parallel/ulysses.py", "parallel/overlap.py",
                "ops/collective_matmul.py", "tools/dist_plans.py",
                "parallel/pipeline.py", "parallel/collectives.py",
                "mapreduce/device_shuffle.py",
                "parallel/elastic/controller.py", "parallel/lowp/guard.py",
                "parallel/lowp/syncpolicy.py", "tools/ab_wire.py",
                "obs/top.py", "io/wire.py", "ipc/__init__.py",
                "ipc/errors.py", "ipc/client.py", "ipc/rpc.py",
                "security/ugi.py", "yarn.py", "security/sasl.py",
                "ipc/retry.py", "util/crc.py", "dfs/client/filesystem.py",
                "dfs/client/dfsclient.py", "dfs/client/streams.py",
                "dfs/client/striped.py", "dfs/client/shortcircuit.py",
                "dfs/protocol/records.py", "dfs/protocol/datatransfer.py",
                "dfs/protocol/blocktoken.py", "native/crc32c.cc"):
        assert REPO / "hadoop_tpu_torch" / new in files, new
    bad = re.compile(r"^\s*(import|from)\s+jax\b|hadoop_tpu\.", re.M)
    for path in files:
        hits = bad.findall(path.read_text())
        assert not hits, f"{path}: {hits}"


def test_chip_smoke_defines_each_name_once():
    """A later top-level definition of a name in chip_smoke.py would
    replace an earlier phase's helper for every caller."""
    import ast
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [node.name for node in tree.body
             if isinstance(node, (ast.FunctionDef, ast.ClassDef))]
    twice = sorted({n for n in names if names.count(n) > 1})
    assert not twice, twice
