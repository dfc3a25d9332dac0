"""The PyTorch port's context-parallel prefill against the JAX package's,
on the CPU.

The port runs the sp ranks of a ring on one device (rank axis folded
into the batch, a hop is a roll); the JAX package runs them under
``shard_map`` on the virtual CPU mesh. Inputs come from numpy seeds,
weights from the JAX package's ``init_params`` through
``params_from_numpy``. Tolerances: 2e-5 for ring attention, the
reference's own (tests/test_flash.py); 1e-4 for logits, hidden states
and K/V after a float32 layer stack (tests/test_torch_models.py's).
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import hadoop_tpu.ops.flash as jflash
from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.parallel.ring_attention import ring_attention as jring
from hadoop_tpu.serving import longctx as jlongctx
from hadoop_tpu.serving import weightplane as jwp
from hadoop_tpu_torch.models import config, decoder, params_from_numpy
from hadoop_tpu_torch.ops import attention, flash
from hadoop_tpu_torch.parallel import ring_attention as ra
from hadoop_tpu_torch.parallel import spmd, ulysses
from hadoop_tpu_torch.serving import longctx
from hadoop_tpu_torch.models import moe
from hadoop_tpu_torch.serving import weightplane

TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to one thread: the tier-1 run shares the CPU between
    several test workers, some of them timing-sensitive."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _models(preset, **overrides):
    jcfg = jconfig.get_config(preset, **overrides)
    cfg = config.get_config(preset, **overrides)
    jparams = jdecoder.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return jcfg, jparams, cfg, params_from_numpy(tree, cfg, device="cpu")


@pytest.fixture(scope="module")
def tiny():
    return _models("tiny", max_seq=512)


def _prompt(n, vocab=256, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, n).tolist()


def _fold(x, sp):
    """[B, S, H, D] -> [sp*B, S/sp, H, D], rank r's shard on rows
    r*B..(r+1)*B-1."""
    b, s = x.shape[:2]
    return x.reshape(b, sp, s // sp, *x.shape[2:]).transpose(0, 1).reshape(
        sp * b, s // sp, *x.shape[2:])


def _unfold(x, sp):
    n, sl = x.shape[:2]
    return x.reshape(sp, n // sp, sl, *x.shape[2:]).transpose(0, 1).reshape(
        n // sp, sp * sl, *x.shape[2:])


# --------------------------------------------------------------- the ring

@pytest.mark.parametrize("sp", [1, 2, 4])
def test_ring_attention_matches_jax_both_paths(sp, monkeypatch):
    """Port impl="ref" against JAX impl="ref" on an sp-device CPU mesh;
    port impl="flash" (the partial's plain version) against JAX's fused
    path with interpret-mode Pallas partials (as tests/test_flash.py
    runs it); both against the port's single causal attention."""
    rng = np.random.default_rng(sp)
    B, S, HQ, HKV, D = 2, 512, 4, 2, 64
    q = rng.standard_normal((B, S, HQ, D)).astype(np.float32)
    k = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, HKV, D)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))

    def run_jax(impl):
        def body(q, k, v):
            return jring(q, k, v, "sp", sp, impl=impl)
        return np.asarray(jax.jit(jax.shard_map(
            body, mesh=mesh, in_specs=(P(None, "sp"),) * 3,
            out_specs=P(None, "sp")))(q, k, v))

    want_ref = run_jax("ref")
    real = jflash.flash_attention_partial
    monkeypatch.setattr(jflash, "flash_attention_partial",
                        lambda q, k, v, scale, causal, interpret=False:
                        real(q, k, v, scale, causal, True))
    want_flash = run_jax("flash")
    tq, tk, tv = (_fold(torch.from_numpy(x), sp) for x in (q, k, v))
    single = attention.causal_attention(*(torch.from_numpy(x)
                                          for x in (q, k, v)))
    for impl, want in (("ref", want_ref), ("flash", want_flash)):
        got = _unfold(ra.ring_attention(tq, tk, tv, sp, impl=impl), sp)
        np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=2e-5,
                                   err_msg=impl)
        torch.testing.assert_close(got, single, atol=2e-5, rtol=2e-5)


def test_ring_auto_on_cpu_is_the_chunk_path_and_counts_nothing():
    q, k, v = (torch.from_numpy(np.random.default_rng(i).standard_normal(
        (4, 128, h, 64)).astype(np.float32)) for i, h in enumerate((4, 2, 2)))
    before = (flash.launches, flash.launches_partial)
    auto = ra.ring_attention(q, k, v, 4)
    assert torch.equal(auto, ra.ring_attention(q, k, v, 4, impl="ref"))
    ra.ring_attention(q, k, v, 4, impl="flash")
    assert (flash.launches, flash.launches_partial) == before
    with pytest.raises(ValueError):
        ra.ring_attention(q, k, v, 3)          # 4 rows do not fold 3 ranks
    with pytest.raises(ValueError):
        ra.ring_attention(q, k, v, 4, impl="ulysses")


# ----------------------------------------------------------- the decoder

@pytest.mark.parametrize("preset,sp", [("tiny", 2), ("tiny-gpt2", 4)])
def test_run_layers_kv_under_a_ring_matches_jax(preset, sp):
    """embed (per-rank learned positions for gpt2) + run_layers_kv with
    per-rank RoPE + final norm under a ring ctx, against the JAX
    package's shard_map'd CP body on the same weights; and the ring ctx
    against the port's own single-device run_layers_kv."""
    jcfg, jparams, cfg, params = _models(preset)
    s = cfg.max_seq
    tokens = np.asarray(_prompt(s, cfg.vocab_size, seed=3), np.int32)
    jpre = jlongctx.ContextParallelPrefiller(jparams, jcfg, block_size=8,
                                             pad_tokens=s, sp=sp)
    jh, jks, jvs = (np.asarray(x) for x in jpre._fn(jparams,
                                                    jnp.asarray(tokens)))
    ctx = decoder.ParallelCtx(ring="sp", ring_size=sp)
    cos, sin = decoder.rope_frequencies(cfg.head_dim, cfg.max_seq,
                                        cfg.rope_theta)
    toks = torch.from_numpy(tokens).long()
    h = decoder.embed_tokens(params, toks.view(sp, -1), cfg, ctx)
    h, (ks, vs) = decoder.run_layers_kv(h, params["layers"], cfg, cos, sin,
                                        ctx)
    h = decoder.final_hidden(params, h, cfg)
    assert ks.shape == (cfg.n_layers, sp, s // sp, cfg.n_kv_heads,
                        cfg.head_dim)
    np.testing.assert_allclose(h.reshape(s, -1).numpy(), jh, atol=TOL,
                               rtol=TOL)
    for got, want in ((ks, jks), (vs, jvs)):
        np.testing.assert_allclose(got.reshape(cfg.n_layers, s, *got.shape[3:])
                                   .numpy(), want, atol=TOL, rtol=TOL)
    # the single-device stack gives the same K/V and hidden states
    h1, (k1, _) = decoder.run_layers_kv(
        decoder.embed_tokens(params, toks[None], cfg), params["layers"],
        cfg, cos, sin)
    np.testing.assert_allclose(k1[:, 0].numpy(), jks, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(decoder.final_hidden(params, h1, cfg)[0]
                               .numpy(), jh, atol=TOL, rtol=TOL)


def test_parallel_ctx_carries_the_ring_only():
    """The ctx carries the ring (folded, or a process group), its
    strategy (ring or Ulysses) and tp and ep process groups
    (``tests/test_torch_ep.py``); the reference's ``ep_axis`` name is
    not a field, and naming it is a TypeError."""
    assert decoder.SINGLE.ring is None and decoder.SINGLE.ring_size == 1
    assert decoder.SINGLE.ring_axis is None and decoder.SINGLE.tp_size == 1
    with pytest.raises(TypeError):
        decoder.ParallelCtx(ep_axis="ep")
    uly = decoder.ParallelCtx(ring="sp", ring_size=2, sp_mode="ulysses")
    assert uly.ring_axis.folded and uly.ring_axis.size == 2
    with pytest.raises(ValueError):
        decoder.ParallelCtx(ring="sp", ring_size=2, sp_mode="diagonal")
    with pytest.raises(ValueError):
        decoder.ParallelCtx(ring_size=2)
    with pytest.raises(ValueError):          # a group that is not the ring
        decoder.ParallelCtx(ring="sp", ring_size=4,
                            ring_group=spmd.folded("sp", 2))
    with pytest.raises(ValueError, match="process group"):
        decoder.ParallelCtx(tp=spmd.folded("tp", 2))
    with pytest.raises(ValueError):
        decoder.ParallelCtx(megatron_sp=True)


@pytest.mark.parametrize("sp", [2, 4])
def test_ulysses_attention_matches_causal_and_ring(sp):
    """Ulysses over folded ranks: the causal attention of the whole
    sequence, and the ring's output, on the same shards."""
    rng = np.random.default_rng(sp)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 64, h, 16)).astype(
        np.float32)) for h in (8, 4, 4))
    want = attention.causal_attention(q, k, v)
    axis = spmd.folded("sp", sp)
    got = ulysses.ulysses_attention(_fold(q, sp), _fold(k, sp),
                                    _fold(v, sp), axis)
    np.testing.assert_allclose(_unfold(got, sp).numpy(), want.numpy(),
                               atol=2e-5, rtol=2e-5)
    ring = ra.ring_attention(_fold(q, sp), _fold(k, sp), _fold(v, sp), axis)
    np.testing.assert_allclose(got.numpy(), ring.numpy(), atol=2e-5,
                               rtol=2e-5)
    with pytest.raises(ValueError, match="divisible"):
        ulysses.ulysses_attention(_fold(q, sp), _fold(k[:, :, :1], sp),
                                  _fold(v[:, :, :1], sp), axis)


# ----------------------------------------------------------- the prefill

@pytest.mark.parametrize("sp", [1, 2, 4])
def test_cp_prefill_matches_jax(tiny, sp):
    """Last logits, every streamed full block and the tail against the
    JAX package's cp_prefill on the same weights; the exact A-B guard
    accepts."""
    jcfg, jparams, cfg, params = tiny
    prompt = _prompt(150)
    jres = jlongctx.ContextParallelPrefiller(
        jparams, jcfg, block_size=8, pad_tokens=160, sp=sp).cp_prefill(prompt)
    pre = longctx.ContextParallelPrefiller(params, cfg, block_size=8,
                                           pad_tokens=160, sp=sp,
                                           devices=["cpu"])
    res = pre.cp_prefill(prompt)
    assert (res.n_full_blocks, res.chips, res.prompt_tokens) == (18, sp, 150)
    np.testing.assert_allclose(res.last_logits, jres.last_logits,
                               atol=TOL, rtol=TOL)
    got, want = list(res.blocks), list(jres.blocks)
    assert len(got) == len(want) == 18
    for (gk, gv), (wk, wv) in zip(got, want):
        np.testing.assert_allclose(gk.numpy(), wk, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(gv.numpy(), wv, atol=TOL, rtol=TOL)
    assert res.tail_k.shape == (cfg.n_layers, 6, 2, 16)
    np.testing.assert_allclose(res.tail_k.numpy(), jres.tail_k, atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(res.tail_v.numpy(), jres.tail_v, atol=TOL,
                               rtol=TOL)
    report = longctx.run_prefill_ab(params, cfg, prompt, pre, mode="exact")
    assert report["accepted"] and report["argmax_agree"]
    assert pre.prefill_compiles == 1 and pre.head_compiles == 1


def test_ulysses_cp_prefill_matches_jax(tiny):
    """Ulysses at sp 2 on tiny (``tests/test_longctx.py``'s ulysses case):
    last logits, every streamed block and the tail against the JAX
    package's Ulysses cp_prefill; the exact A-B guard accepts; the K/V
    equal the ring's, the layout the prefill streams."""
    jcfg, jparams, cfg, params = tiny
    prompt = _prompt(150)
    jres = jlongctx.ContextParallelPrefiller(
        jparams, jcfg, block_size=8, pad_tokens=160, sp=2,
        sp_mode="ulysses").cp_prefill(prompt)
    assert jres.sp_mode == "ulysses"
    kw = dict(block_size=8, pad_tokens=160, sp=2, devices=["cpu"])
    pre = longctx.ContextParallelPrefiller(params, cfg, sp_mode="ulysses",
                                           **kw)
    res = pre.cp_prefill(prompt)
    ring = longctx.ContextParallelPrefiller(params, cfg, **kw).cp_prefill(
        prompt)
    assert (res.sp_mode, res.n_full_blocks, res.chips) == ("ulysses", 18, 2)
    np.testing.assert_allclose(res.last_logits, jres.last_logits,
                               atol=TOL, rtol=TOL)
    got, want, rng = list(res.blocks), list(jres.blocks), list(ring.blocks)
    assert len(got) == len(want) == len(rng) == 18
    for (gk, gv), (wk, wv), (rk, rv) in zip(got, want, rng):
        np.testing.assert_allclose(gk.numpy(), wk, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(gv.numpy(), wv, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(gk.numpy(), rk.numpy(), atol=TOL,
                                   rtol=TOL)
    for got_t, want_t in ((res.tail_k, jres.tail_k),
                          (res.tail_v, jres.tail_v)):
        np.testing.assert_allclose(got_t.numpy(), want_t, atol=TOL,
                                   rtol=TOL)
    report = longctx.run_prefill_ab(params, cfg, prompt, pre, mode="exact")
    assert report["accepted"] and report["argmax_agree"]
    assert report["sp_mode"] == "ulysses"


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("plane", ["tiny-int8", "tiny-int8-embed-head",
                                   "tiny-moe"])
def test_cp_prefill_on_int8_and_moe_matches_jax(plane, sp):
    """The weight plane's int8 tree (every local matmul through qdot, the
    head through qhead) and a MoE config (each rank routing its own
    tokens) through cp_prefill, against the JAX package's on the same
    tree: last logits, every streamed block and the tail; the exact A-B
    guard against the forward over the dequantized tree accepts."""
    preset = "tiny-moe" if plane == "tiny-moe" else "tiny"
    jcfg, jparams, cfg, params = _models(preset, max_seq=512)
    ref_params = params
    if plane.startswith("tiny-int8"):
        q_both = plane.endswith("embed-head")
        jparams, _ = jwp.quantize_params(jparams, jcfg, jwp.WeightPlaneConfig(
            tier="relaxed", group=16, quant_embed=q_both, quant_head=q_both))
        params = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          jparams),
                                   cfg, device="cpu")
        ref_params = weightplane.dequantize_params(params, cfg)
        assert weightplane.is_quantized_tree(params)
    prompt = _prompt(150)
    jres = jlongctx.ContextParallelPrefiller(
        jparams, jcfg, block_size=8, pad_tokens=160, sp=sp).cp_prefill(prompt)
    pre = longctx.ContextParallelPrefiller(params, cfg, block_size=8,
                                           pad_tokens=160, sp=sp,
                                           devices=["cpu"])
    assert pre.ctx.relaxed_qweights == plane.startswith("tiny-int8")
    res = pre.cp_prefill(prompt)
    np.testing.assert_allclose(res.last_logits, jres.last_logits,
                               atol=TOL, rtol=TOL)
    got, want = list(res.blocks), list(jres.blocks)
    assert len(got) == len(want) == 18
    for (gk, gv), (wk, wv) in zip(got, want):
        np.testing.assert_allclose(gk.numpy(), wk, atol=TOL, rtol=TOL)
        np.testing.assert_allclose(gv.numpy(), wv, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(res.tail_k.numpy(), jres.tail_k, atol=TOL,
                               rtol=TOL)
    np.testing.assert_allclose(res.tail_v.numpy(), jres.tail_v, atol=TOL,
                               rtol=TOL)
    if plane != "tiny-moe":
        # (a MoE rank routes its own tokens at its own capacity, so its
        # drops are not the single-device forward's: there the JAX
        # package's cp_prefill above is the comparison)
        report = longctx.run_prefill_ab(ref_params, cfg, prompt, pre,
                                        mode="exact")
        assert report["accepted"] and report["argmax_agree"]
    assert pre.prefill_compiles == 1 and pre.head_compiles == 1


def test_cp_prefill_kernel_path_equals_chunk_path_on_cpu(tiny, monkeypatch):
    """The ring's fused path (the partials' plain versions on the CPU,
    forced here; "auto" takes it on the GPU) against the chunk path
    through the whole prefill, and one pinned shape for several
    lengths."""
    _, _, cfg, params = tiny
    pre = longctx.ContextParallelPrefiller(params, cfg, block_size=8,
                                           pad_tokens=200, sp=4,
                                           devices=["cpu"])
    prompts = [_prompt(n, seed=n) for n in (110, 197)]
    chunk = [pre.cp_prefill(p) for p in prompts]
    orig = ra.ring_attention
    monkeypatch.setattr(ra, "ring_attention",
                        lambda q, k, v, ring_size, impl="auto":
                        orig(q, k, v, ring_size, impl="flash"))
    for p, b in zip(prompts, chunk):
        a = pre.cp_prefill(p)
        np.testing.assert_allclose(a.last_logits, b.last_logits, atol=TOL,
                                   rtol=TOL)
        for (ak, av), (bk, bv) in zip(a.blocks, b.blocks):
            torch.testing.assert_close(ak, bk, atol=TOL, rtol=TOL)
            torch.testing.assert_close(av, bv, atol=TOL, rtol=TOL)
    assert pre.pad_tokens == 224
    assert pre.prefill_compiles == 1 and pre.head_compiles == 1


@pytest.mark.parametrize("max_seq,pad,sp,block", [
    (512, 160, 4, 8),      # rounds up
    (500, 500, 4, 8),      # rounding up overshoots max_seq: rounds DOWN
    (128, 128, 3, 16),     # down, to 96
    (40, 40, 4, 16),       # below one quantum: refused
    (128, 256, 2, 8),      # above max_seq: refused
])
def test_pad_budget_rounding_matches_jax(tiny, max_seq, pad, sp, block):
    jcfg, jparams, cfg, params = tiny
    jcfg = jconfig.get_config("tiny", max_seq=max_seq)
    cfg = config.get_config("tiny", max_seq=max_seq)
    kw = dict(block_size=block, pad_tokens=pad, sp=sp)
    try:
        want = jlongctx.ContextParallelPrefiller(jparams, jcfg,
                                                 **kw).pad_tokens
    except ValueError:
        with pytest.raises(ValueError):
            longctx.ContextParallelPrefiller(params, cfg, devices=["cpu"],
                                             **kw)
        return
    got = longctx.ContextParallelPrefiller(params, cfg, devices=["cpu"], **kw)
    assert got.pad_tokens == want
    with pytest.raises(ValueError):
        got.cp_prefill(_prompt(want + 1))


def test_guard_rejects_broken_ring_hop(tiny, monkeypatch):
    """A corrupted ring (rank 1's attention output scaled by 1.5) is
    rejected by the exact guard (the port of
    tests/test_longctx.py::test_guard_rejects_broken_ring_hop)."""
    _, _, cfg, params = tiny
    orig = ra.ring_attention

    def broken(q, k, v, ring_size, impl="auto"):
        out = orig(q, k, v, ring_size, impl)
        scale = torch.ones(ring_size, 1, 1, 1, 1)
        scale[1] = 1.5
        return (out.reshape(ring_size, -1, *out.shape[1:]) * scale
                ).reshape(out.shape)

    monkeypatch.setattr(ra, "ring_attention", broken)
    pre = longctx.ContextParallelPrefiller(params, cfg, block_size=8,
                                           pad_tokens=160, sp=4,
                                           devices=["cpu"])
    with pytest.raises(longctx.ParityGuardError):
        longctx.run_prefill_ab(params, cfg, _prompt(150), pre, mode="exact")


def test_longctx_ab_report_matches_jax():
    rng = np.random.default_rng(5)
    ref = rng.standard_normal(64).astype(np.float32)
    for got, mode in ((ref + 1e-5, "exact"), (ref * 1.01, "relaxed"),
                      (ref + 1e-2, "exact")):
        try:
            want = jlongctx.longctx_ab_report(ref, got, mode=mode)
        except AssertionError:
            with pytest.raises(longctx.ParityGuardError):
                longctx.longctx_ab_report(ref, got, mode=mode)
            continue
        assert longctx.longctx_ab_report(ref, got, mode=mode) == want
    with pytest.raises(ValueError):
        longctx.longctx_ab_report(ref, ref, mode="loose")


# ------------------------------------------------------------------- plan

class _Dev:
    def __init__(self, i, coords):
        self.id = i
        self.coords = coords


@pytest.mark.parametrize("shape", [(2, 4), (2, 2, 2), (2, 3, 4)])
def test_ring_order_matches_jax(shape):
    """Devices without ``coords`` (every torch device) keep id order, as
    the reference orders them."""
    n = int(np.prod(shape))
    perm = np.random.default_rng(3).permutation(n)
    want = [d.id for d in jlongctx.ring_order([_Dev(int(i), None)
                                               for i in perm])]
    got = longctx.ring_order([torch.device("cuda", int(i)) for i in perm])
    assert [d.index for d in got] == want == list(range(n))
    assert longctx.ring_order([torch.device("cuda", 1), torch.device(
        "cpu")]) == [torch.device("cpu"), torch.device("cuda", 1)]


def test_choose_sp_mode(tiny):
    _, _, cfg, _ = tiny
    assert longctx.choose_sp_mode(cfg, 4, "ring") == "ring"
    # tiny has 2 kv heads: ulysses over 4 ranks falls back, as in JAX
    assert longctx.choose_sp_mode(cfg, 4, "ulysses") == \
        jlongctx.choose_sp_mode(cfg, 4, "ulysses") == "ring"
    assert longctx.choose_sp_mode(cfg, 2, "ulysses") == \
        jlongctx.choose_sp_mode(cfg, 2, "ulysses") == "ulysses"
    with pytest.raises(ValueError):
        longctx.choose_sp_mode(cfg, 2, "diagonal")


# --------------------------------------------------------- what must raise

def test_refusals(tiny):
    """A ring over distinct devices and an expert axis folded on one
    device raise (an ep axis is a process group: tests/test_torch_ep.py);
    Ulysses, int8 trees and MoE configs are ported (the cp_prefill
    tests); without a GPU the prefill's default device and the partial
    kernel raise."""
    _, _, cfg, params = tiny
    kw = dict(block_size=8, pad_tokens=160, sp=2)
    pre = longctx.ContextParallelPrefiller(params, cfg, sp_mode="ulysses",
                                           devices=["cpu"], **kw)
    assert pre.sp_mode == pre.ctx.sp_mode == "ulysses"
    with pytest.raises(NotImplementedError, match="Queue A 6"):
        longctx.cp_mesh(2, [torch.device("cuda", 0),
                            torch.device("cuda", 1)])
    ring = longctx.cp_mesh(4, ["cpu"])
    assert (ring.size, ring.device) == (4, torch.device("cpu"))
    qtree = dict(params, embed={"q": torch.zeros(2, dtype=torch.int8),
                                "s": torch.ones(2)})
    assert weightplane.is_quantized_tree(qtree)
    assert not weightplane.is_quantized_tree(params)
    with pytest.raises(TypeError):
        decoder.ParallelCtx(ep_axis="x")
    with pytest.raises(ValueError, match="process group"):
        moe.moe_mlp(torch.zeros(1, 2, 64), {}, config.get_config(
            "tiny-moe"), decoder.ParallelCtx(ep=spmd.folded("ep", 2)))
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        longctx.ContextParallelPrefiller(params, cfg, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        longctx.cp_mesh(2)
    q = torch.zeros(1, 128, 2, 64)
    with pytest.raises(ValueError):
        flash._launch_partial(q, q, q, 1.0)
