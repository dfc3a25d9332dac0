"""The PyTorch port's serving engine against the JAX package's, on the CPU.

The KV store copies repeat the reference's pool and radix scenarios.
The engine is held to exact greedy equality, token for token, with the
JAX ``DecodeEngine`` and with a full-recompute greedy loop over the JAX
``forward`` on the same weights, in float32, for batched,
mid-decode-admission and pool-pressure-preemption workloads.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.serving import engine as jengine
from hadoop_tpu_torch.models import config, decoder, params_from_numpy
from hadoop_tpu_torch.serving import engine
from hadoop_tpu_torch.serving.engine import DecodeEngine, SamplingParams
from hadoop_tpu_torch.serving.kvstore import BlockPool, PrefixCache

_REF_P = 48
_models = {}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to one thread: the tier-1 run shares the CPU between
    several test workers, some of them timing-sensitive."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(preset):
    """(jax cfg, jax params, port cfg, port params, jitted jax forward)."""
    if preset not in _models:
        jcfg = jconfig.get_config(preset)
        jparams = jdecoder.init_params(jax.random.PRNGKey(0), jcfg)
        cfg = config.get_config(preset)
        params = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
        fwd = jax.jit(lambda p, t: jdecoder.forward(p, t, jcfg))
        _models[preset] = (jcfg, jparams, cfg, params, fwd)
    return _models[preset]


def _reference_greedy(preset, prompt, max_new):
    """Full JAX forward recompute each step, padded to one length."""
    _, jparams, _, _, fwd = _model(preset)
    seq = list(prompt)
    for _ in range(max_new):
        padded = seq + [0] * (_REF_P - len(seq))
        logits = fwd(jparams, jnp.asarray([padded]))
        seq.append(int(jnp.argmax(logits[0, len(seq) - 1])))
    return seq[len(prompt):]


# -------------------------------------------------------------- block pool

def test_block_pool_alloc_free():
    pool = BlockPool(num_blocks=8, block_size=4)
    assert pool.num_usable == 7          # block 0 is scratch
    a = pool.alloc(3)
    b = pool.alloc(4)
    assert a is not None and b is not None
    assert BlockPool.SCRATCH not in a + b
    assert len(set(a + b)) == 7          # no page handed out twice
    assert pool.alloc(1) is None         # all-or-nothing exhaustion
    pool.free(a)
    assert pool.num_free == 3
    c = pool.alloc(3)
    assert sorted(c) == sorted(a)        # freed pages recycle
    with pytest.raises(ValueError):
        pool.free([BlockPool.SCRATCH])


def test_block_pool_refcounts_protect_shared_pages():
    pool = BlockPool(num_blocks=6, block_size=4)
    blocks = pool.alloc(2)
    assert all(pool.refcount(b) == 1 for b in blocks)
    pool.incref(blocks)                  # a second request maps them
    with pytest.raises(ValueError):      # still shared: free must refuse
        pool.free(blocks)
    assert pool.decref(blocks) == []     # first unmap: nothing hits zero
    zeros = pool.decref(blocks)          # second unmap: both unreferenced
    assert sorted(zeros) == sorted(blocks)
    pool.free(zeros)                     # only now may they recycle
    assert pool.num_free == 5
    with pytest.raises(ValueError):      # double-decref is a bug
        pool.decref(blocks)
    with pytest.raises(ValueError):
        pool.incref([BlockPool.SCRATCH])


def test_prefix_cache_radix_match_insert_evict():
    cache = PrefixCache(block_size=2)
    ref = {10: 0, 11: 0, 12: 0, 13: 0}
    assert cache.match([1, 2, 3, 4]) == []
    assert cache.insert([1, 2, 3, 4], [10, 11]) == 2
    assert cache.match([1, 2, 3, 4, 5]) == [10, 11]   # partial tail cut
    assert cache.match([1, 2, 9, 9]) == [10]          # diverges mid-way
    assert cache.match([9, 2, 3, 4]) == []            # prefix is the key
    assert cache.insert([1, 2, 3, 4], [12, 13]) == 0  # dedup: first wins
    assert cache.match([1, 2, 3, 4]) == [10, 11]
    assert cache.insert([1, 2, 7, 8], [10, 12]) == 1  # sibling branch
    assert len(cache) == 3
    assert cache.evict(1, ref.get) == [11]            # LRU leaf
    ref[12] = 1                                       # a request maps 12
    assert cache.evict(2, ref.get) == []   # leaf pinned, parent has kids
    ref[12] = 0
    assert cache.evict(2, ref.get) == [12, 10]        # leaf, then parent
    assert len(cache) == 0


# ------------------------------------------------------------------ engine

def _batched(eng, sp_cls):
    prompts = [[1, 2, 3], [5, 6, 7, 8, 9, 10, 11], [200]]
    return eng.generate(prompts, sp_cls(max_new_tokens=6)), \
        [(p, 6) for p in prompts]


def _mid_decode_admission(eng, sp_cls):
    a = eng.submit([7, 8, 9], sp_cls(max_new_tokens=10))
    eng.step()
    eng.step()
    assert eng.occupancy_log[-1] == 1
    b = eng.submit([42, 43], sp_cls(max_new_tokens=5))
    while not (a.done.is_set() and b.done.is_set()):
        eng.step()
    assert max(eng.occupancy_log) == 2, "B never joined the batch"
    return [a.wait(0), b.wait(0)], [([7, 8, 9], 10), ([42, 43], 5)]


def _preemption(eng, sp_cls):
    a = eng.submit([1, 2, 3, 4], sp_cls(max_new_tokens=20))
    b = eng.submit([9, 9, 9, 9], sp_cls(max_new_tokens=16))
    while not (a.done.is_set() and b.done.is_set()):
        eng.step()
    assert b.preemptions >= 1, "pool pressure never evicted the youngest"
    cached = len(eng.prefix_cache)
    assert eng.pool.num_free + cached == eng.pool.num_usable
    return [a.wait(0), b.wait(0)], [([1, 2, 3, 4], 20), ([9, 9, 9, 9], 16)]


_WORKLOADS = {
    "batched": (_batched, dict(max_batch=4, block_size=4, max_context=32)),
    "mid_decode_admission": (_mid_decode_admission,
                             dict(max_batch=4, block_size=4,
                                  max_context=48)),
    # usable pages: 7; A peaks at 6 pages and B at 5, so the younger
    # (B) must yield
    "preemption": (_preemption, dict(max_batch=2, block_size=4,
                                     max_context=32, num_blocks=8)),
}


@pytest.mark.parametrize("preset", ["tiny", "tiny-gpt2"])
@pytest.mark.parametrize("workload", sorted(_WORKLOADS))
def test_engine_matches_jax_engine_and_reference(preset, workload):
    jcfg, jparams, cfg, params, _ = _model(preset)
    run, kw = _WORKLOADS[workload]
    got, asked = run(DecodeEngine(params, cfg, device="cpu", **kw),
                     SamplingParams)
    want, _ = run(jengine.DecodeEngine(jparams, jcfg, **kw),
                  jengine.SamplingParams)
    assert got == want
    assert got == [_reference_greedy(preset, p, n) for p, n in asked]


def test_warm_prefix_cache_stays_exact_match():
    _, _, cfg, params, _ = _model("tiny")
    head = [5, 9, 2, 7, 1, 8, 3, 6, 4, 2, 9, 1, 7, 3, 8, 5]   # 4 blocks
    pa, pb = head + [11, 12], head + [13]
    eng = DecodeEngine(params, cfg, max_batch=2, block_size=4,
                       max_context=48, prefill_chunk=4, device="cpu")
    assert eng.generate([pa], SamplingParams(max_new_tokens=8))[0] == \
        _reference_greedy("tiny", pa, 8)
    assert len(eng.prefix_cache) >= 4           # head blocks resident
    b = eng.submit(pb, SamplingParams(max_new_tokens=8))
    while not b.done.is_set():
        eng.step()
    assert b.wait(0) == _reference_greedy("tiny", pb, 8)
    assert b.prefix_tokens_reused == 16         # the whole head
    assert eng.cache_stats()["hit_rate"] > 0
    assert eng.decode_compiles == 1 and eng.prefill_compiles == 1


def test_step_shapes_stay_two_and_top_k_one_is_greedy():
    _, _, cfg, params, _ = _model("tiny")
    eng = DecodeEngine(params, cfg, max_batch=3, block_size=4,
                       max_context=32, device="cpu")
    eng.generate([[1], [2, 3, 4, 5]], SamplingParams(max_new_tokens=3))
    greedy = eng.submit([11, 12, 13], SamplingParams(max_new_tokens=6))
    topk1 = eng.submit([11, 12, 13], SamplingParams(
        max_new_tokens=6, temperature=1.0, top_k=1))
    free = eng.submit([50, 51], SamplingParams(max_new_tokens=6,
                                               temperature=1.2))
    while not all(r.done.is_set() for r in (greedy, topk1, free)):
        eng.step()
    ref = _reference_greedy("tiny", [11, 12, 13], 6)
    assert greedy.wait(0) == ref and topk1.wait(0) == ref
    assert all(0 <= t < cfg.vocab_size for t in free.wait(0))
    assert eng.decode_compiles == 1 and eng.prefill_compiles == 1


def _device_tensors(eng):
    """The tensors a captured step graph reads and writes, with their
    addresses."""
    held = dict(eng._dstate, chunk=eng._chunk_in, kp=eng._kp, vp=eng._vp)
    return {name: (t, t.data_ptr()) for name, t in held.items()}


def _assert_same_tensors(eng, held):
    now = dict(eng._dstate, chunk=eng._chunk_in, kp=eng._kp, vp=eng._vp)
    for name, (t, ptr) in held.items():
        assert now[name] is t and t.data_ptr() == ptr, name


def test_step_state_is_written_in_place():
    """The step writes its device state in place and reads its chunk
    from one static buffer, the tensors a captured CUDA graph goes on
    reading: the same tensors at the same addresses after every step,
    decode-only and fused. On the CPU nothing is captured."""
    _, _, cfg, params, _ = _model("tiny")
    eng = DecodeEngine(params, cfg, max_batch=2, block_size=4,
                       max_context=32, prefill_chunk=4, device="cpu")
    held = _device_tensors(eng)
    prompts = [[3, 17, 42, 99, 5, 6], [8, 8]]
    out = eng.generate(prompts, SamplingParams(max_new_tokens=6))
    assert out == [_reference_greedy("tiny", p, 6) for p in prompts]
    _assert_same_tensors(eng, held)
    assert eng.decode_compiles == 1 and eng.prefill_compiles == 1
    assert eng._graphs == {}
    assert not bool(eng._dstate["active"].any())      # every lane retired


def test_failed_step_resets_the_state_in_place():
    """A step that raises fails the requests in flight; the pools and the
    lanes are cleared in place (a captured graph keeps its tensors) and
    the engine serves the next request exactly."""
    _, _, cfg, params, _ = _model("tiny")
    eng = DecodeEngine(params, cfg, max_batch=2, block_size=4,
                       max_context=32, device="cpu")
    held = _device_tensors(eng)
    real, calls = eng._step_impl, []

    def flaky(fused):
        calls.append(fused)
        if len(calls) == 2:
            raise RuntimeError("injected step failure")
        return real(fused)

    eng._step_impl = flaky
    eng.start()
    try:
        first = eng.submit([3, 17, 42], SamplingParams(max_new_tokens=5))
        with pytest.raises(RuntimeError, match="injected"):
            first.wait(60)
        second = eng.submit([3, 17, 42], SamplingParams(max_new_tokens=5))
        assert second.wait(60) == _reference_greedy("tiny", [3, 17, 42], 5)
    finally:
        eng.stop(drain=True)
    _assert_same_tensors(eng, held)


def test_a_request_submitted_after_a_failure_is_not_failed():
    """The failure handler fails the requests it holds when the step
    fails, not one a client submits once the first FAILED wakes it: that
    request joined no failed step and is served by the next iteration.
    The client's submit runs inside the handler's first FAILED, so the
    interleaving is forced, not left to the scheduler."""
    _, _, cfg, params, _ = _model("tiny")
    eng = DecodeEngine(params, cfg, max_batch=2, block_size=4,
                       max_context=32, device="cpu")
    real, calls = eng._step_impl, []

    def flaky(fused):
        calls.append(fused)
        if len(calls) == 1:
            raise RuntimeError("injected step failure")
        return real(fused)

    finish, late = eng._finish_request, []

    def woken(req, state=engine.FINISHED, error=None):
        finish(req, state, error)
        if state == engine.FAILED and not late:
            late.append(eng.submit([3, 17, 42],
                                   SamplingParams(max_new_tokens=5)))

    eng._step_impl, eng._finish_request = flaky, woken
    eng.start()
    try:
        first = eng.submit([5, 6, 7], SamplingParams(max_new_tokens=5))
        with pytest.raises(RuntimeError, match="injected"):
            first.wait(60)
        assert late[0].wait(60) == _reference_greedy("tiny", [3, 17, 42], 5)
        assert late[0].state == engine.FINISHED
    finally:
        eng.stop(drain=True)


def test_stop_token_and_submit_rejections():
    _, _, cfg, params, _ = _model("tiny")
    ref = _reference_greedy("tiny", [3, 17, 42], 8)
    eng = DecodeEngine(params, cfg, max_batch=2, block_size=4,
                       max_context=16, device="cpu")
    out = eng.generate([[3, 17, 42]], SamplingParams(
        max_new_tokens=8, stop_token=ref[2]))[0]
    assert out == ref[:ref.index(ref[2]) + 1]
    eng = DecodeEngine(params, cfg, max_batch=2, block_size=4,
                       max_context=16, num_blocks=3, device="cpu")
    with pytest.raises(ValueError):
        eng.submit(list(range(20)), SamplingParams(max_new_tokens=1))
    with pytest.raises(ValueError):     # pool can never hold it
        eng.submit([1, 2], SamplingParams(max_new_tokens=12))
    with pytest.raises(ValueError):
        eng.submit([], SamplingParams())
    with pytest.raises(ValueError):
        eng.submit([1], SamplingParams(max_new_tokens=0))
    assert eng.queue_depth == 0


def test_scheduler_thread_serves_and_drains():
    _, _, cfg, params, _ = _model("tiny-gpt2")
    eng = DecodeEngine(params, cfg, max_batch=2, block_size=4,
                       max_context=32, device="cpu")
    eng.start()
    try:
        reqs = [eng.submit(p, SamplingParams(max_new_tokens=5))
                for p in ([3, 17, 42, 99, 5], [8, 8], [1, 2, 3])]
        outs = [r.wait(60) for r in reqs]
    finally:
        eng.stop(drain=True)
    assert outs == [_reference_greedy("tiny-gpt2", r.prompt, 5)
                    for r in reqs]
    late = eng.submit([1], SamplingParams(max_new_tokens=2))
    eng.stop()                           # a stopped engine fails leftovers
    with pytest.raises(RuntimeError):
        late.wait(0)


def test_mask_and_scale_matches_jax():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((6, 50)).astype(np.float32)
    temps = np.array([0.0, 0.5, 1.0, 1.3, 2.0, 0.8], np.float32)
    topks = np.array([0, 1, 5, 50, 0, 7], np.int32)
    got = engine._mask_and_scale(torch.from_numpy(logits),
                                 torch.from_numpy(temps),
                                 torch.from_numpy(topks).long())
    want = jengine._mask_and_scale(jnp.asarray(logits), jnp.asarray(temps),
                                   jnp.asarray(topks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sampled_tokens_lie_in_the_top_k_set():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((64, 50)).astype(
        np.float32))
    temps = torch.full((64,), 1.5)
    temps[:8] = 0.0                                  # greedy rows
    topks = torch.full((64,), 5, dtype=torch.long)
    top5 = torch.topk(logits, 5, dim=-1).indices
    seen = set()
    for seed in range(10):
        out = engine._sample(logits, temps, topks,
                             torch.Generator().manual_seed(seed))
        assert torch.equal(out[:8], logits[:8].argmax(-1))
        assert bool((top5 == out[:, None]).any(-1).all())
        seen.update(out[8:].tolist())
    assert len(seen) > 5                             # it does sample


def test_unported_features_are_refused(monkeypatch):
    """What the engine refuses is the reference's own refusals: a plan
    with pp, sp or ep above 1, an int8 tree with a plan, more expert
    shards than the engine's ranks (tests/test_torch_tp_serving.py
    serves the tp plans and the expert shards the reference accepts).
    An engine in one process is one rank, whatever the host holds: on a
    host reporting four GPUs a MoE engine resolves its expert shards
    against its one device. hbm_bytes sizing, MoE and the int8 plane
    are ported (tests/test_torch_weightplane.py, test_torch_moe.py), and
    so is the long-context plane (tests/test_torch_longctx_decode.py):
    ``attach_longctx`` takes one and routes prompts of its
    ``min_tokens`` to it."""
    from hadoop_tpu_torch.parallel.mesh import MeshPlan
    _, jparams, cfg, params, _ = _model("tiny")
    for plan in (MeshPlan(pp=2), MeshPlan(sp=2), MeshPlan(ep=2)):
        with pytest.raises(ValueError, match="serving shards over tp "
                           r"\(and dp\) only"):
            DecodeEngine(params, cfg, device="cpu", plan=plan)
    moe_cfg = config.get_config("tiny-moe")
    moe_params = decoder.init_params(moe_cfg, torch.Generator(),
                                     device="cpu")
    with pytest.raises(ValueError, match="exceeds the replica's 1 local"):
        DecodeEngine(moe_params, moe_cfg, device="cpu", moe_shards=2)
    monkeypatch.setattr(engine, "resolve_device",
                        lambda device: torch.device("cuda", 0))
    monkeypatch.setattr(engine, "check_on", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="exceeds the replica's 1 local"):
        DecodeEngine(moe_params, moe_cfg, moe_shards=2)
    resolved = []
    real = engine.expert_shard_count
    monkeypatch.setattr(engine, "expert_shard_count", lambda *a: resolved.
                        append((a, real(*a))) or resolved[-1][1])
    try:        # past the resolution a CPU build cannot allocate on cuda
        DecodeEngine(moe_params, moe_cfg, moe_shards=0)
    except (AssertionError, RuntimeError):
        pass
    assert resolved == [((4, 0, 1), 1)]
    monkeypatch.undo()
    with pytest.raises(ValueError):
        DecodeEngine(moe_params, moe_cfg, device="cpu",
                     moe_a2a_codec="fp8")
    assert DecodeEngine(moe_params, moe_cfg, device="cpu").expert_shards \
        == 1
    eng = DecodeEngine(params, cfg, device="cpu")

    class Plane:
        min_tokens, idle, on_done = 10, True, None

        def longctx_submit(self, prompt, sampling, trace_ctx, tenant):
            return ("plane", len(prompt))

    plane = Plane()
    eng.attach_longctx(plane)
    assert plane.on_done is not None
    assert eng.submit(list(range(10))) == ("plane", 10)
    assert eng.submit(list(range(9))).prompt == list(range(9))
