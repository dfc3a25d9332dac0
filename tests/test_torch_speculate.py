"""The PyTorch port's speculative decoding against the JAX package's, on
the CPU.

The n-gram proposer's drafts equal the reference's on seeded histories.
Greedy tokens through the speculation lane equal, token for token, the
JAX engine's with speculation, the port's with speculation off and a
full-recompute greedy loop over the JAX ``forward`` (tiny preset,
float32, the same weights), with the same proposed and accepted counts.
The verify rule's output law equals the target's (a chi-square test on a
fixed small distribution), and its transform is the reference's:
``_mask_and_scale`` bit for bit, the removal of a rejected draft on the
same entries, softmax and the renormalisation within a few float32 ulps
(XLA's ``exp`` and sums round otherwise than torch's). Multi-token bursts respect ``max_new_tokens`` and
``stop_token``, rejected drafts never reach the radix, and an idle
speculation lane uploads nothing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chisquare

from hadoop_tpu.metrics import metrics_system as jmetrics_system
from hadoop_tpu.metrics.prom import render_prom as jrender_prom
from hadoop_tpu.models import config as jconfig
from hadoop_tpu.models import decoder as jdecoder
from hadoop_tpu.serving import engine as jengine
from hadoop_tpu.serving.metrics import ServingMetrics as JServingMetrics
from hadoop_tpu.serving.speculate import NgramProposer as JNgramProposer
from hadoop_tpu_torch.metrics import metrics_system, render_prom
from hadoop_tpu_torch.models import config, params_from_numpy
from hadoop_tpu_torch.serving import engine
from hadoop_tpu_torch.serving.engine import DecodeEngine, SamplingParams
from hadoop_tpu_torch.serving.metrics import ServingMetrics
from hadoop_tpu_torch.serving.speculate import NgramProposer

_REF_P = 64
_model = {}


@pytest.fixture(autouse=True, scope="module")
def _few_torch_threads():
    """Keep torch to one thread: the tier-1 run shares the CPU between
    several test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny():
    """(jax cfg, jax params, port cfg, port params, jitted jax forward)."""
    if not _model:
        jcfg = jconfig.get_config("tiny")
        jparams = jdecoder.init_params(jax.random.PRNGKey(0), jcfg)
        cfg = config.get_config("tiny")
        params = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jparams), cfg, device="cpu")
        fwd = jax.jit(lambda p, t: jdecoder.forward(p, t, jcfg))
        _model.update(jcfg=jcfg, jparams=jparams, cfg=cfg, params=params,
                      fwd=fwd)
    return _model


def _reference_greedy(prompt, max_new):
    """Full JAX forward recompute each step, padded to one length."""
    m = _tiny()
    seq = list(prompt)
    for _ in range(max_new):
        padded = seq + [0] * (_REF_P - len(seq))
        logits = m["fwd"](m["jparams"], jnp.asarray([padded]))
        seq.append(int(jnp.argmax(logits[0, len(seq) - 1])))
    return seq[len(prompt):]


def _engine(**kw):
    m = _tiny()
    base = dict(max_batch=2, block_size=4, max_context=64, prefill_chunk=8)
    return DecodeEngine(m["params"], m["cfg"], device="cpu", **{**base, **kw})


def _drive(eng, reqs):
    if not isinstance(reqs, list):
        reqs = [reqs]
    while not all(r.done.is_set() for r in reqs):
        eng.step()
    return [r.wait(0) for r in reqs]


def _motif_prompt(rng, motif_len=2, plen=16):
    m = rng.integers(0, _tiny()["cfg"].vocab_size, size=motif_len).tolist()
    return (m * (-(-plen // motif_len)))[:plen]


# ------------------------------------------------------------- proposer

@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("max_n", [1, 3])
def test_proposer_equals_the_reference_on_seeded_histories(seed, max_n):
    """Drafts for every k after every appended token of a seeded stream
    over a small vocabulary (so n-grams recur) equal the reference's."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 5, size=40).tolist()
    port = NgramProposer(tokens[:8], max_n=max_n)
    ref = JNgramProposer(tokens[:8], max_n=max_n)
    for tok in tokens[8:]:
        for k in range(7):
            assert port.propose(k) == ref.propose(k)
        port.append(tok)
        ref.append(tok)
    assert len(port) == len(ref) == len(tokens)


@pytest.mark.parametrize("history,max_n,k,want", [
    ([1, 2, 3, 1, 2, 3, 1, 2], 3, 6, [3, 1, 2, 3, 1, 2]),  # chains cycles
    ([7, 8, 9], 3, 4, []),            # the tip never matches itself
    ([5, 5], 3, 3, [5, 5, 5]),        # 1-gram fallback
    ([], 3, 3, []),
    ([1, 2], 3, 0, []),
    ([2, 7, 1, 2, 9, 4, 1, 2], 3, 1, [9]),   # longer context wins
])
def test_proposer_cases_of_the_reference(history, max_n, k, want):
    assert NgramProposer(history, max_n=max_n).propose(k) == want
    assert JNgramProposer(history, max_n=max_n).propose(k) == want


def test_proposer_refuses_a_bad_range():
    with pytest.raises(ValueError):
        NgramProposer([1], max_n=1, min_n=2)


# ------------------------------------------------------ greedy equality

def test_greedy_with_speculation_equals_reference_engine_off_and_greedy():
    """The tentpole pin: the port with speculate_k=4 emits the reference
    engine's tokens with speculate_k=4, the port's with speculation off
    and the full-recompute greedy; proposed and accepted counts equal the
    reference's; accepted drafts save steps; two shapes, one each."""
    m = _tiny()
    prompt = _motif_prompt(np.random.default_rng(3))
    ref = _reference_greedy(prompt, 24)
    eng = _engine(speculate_k=4)
    got = _drive(eng, eng.submit(prompt, SamplingParams(max_new_tokens=24)))
    jeng = jengine.DecodeEngine(m["jparams"], m["jcfg"], max_batch=2,
                                block_size=4, max_context=64,
                                prefill_chunk=8, speculate_k=4)
    want = _drive(jeng, jeng.submit(
        prompt, jengine.SamplingParams(max_new_tokens=24)))
    off = _engine()
    got_off = _drive(off, off.submit(prompt,
                                     SamplingParams(max_new_tokens=24)))
    assert got == want == got_off == [ref]
    assert eng.spec_proposed > 0 and eng.spec_accepted > 0
    assert (eng.spec_proposed, eng.spec_accepted) == \
        (jeng.spec_proposed, jeng.spec_accepted)
    assert eng.steps == jeng.steps < off.steps
    assert eng.decode_compiles == 1 and eng.prefill_compiles == 1
    assert eng._row_counts == {"decode": {2 * 5}, "fused": {2 * 5 + 8}}
    stats = eng.cache_stats()["speculate"]
    assert stats == jeng.cache_stats()["speculate"]


def test_speculation_off_keeps_the_step():
    """speculate_k=0: the lanes are one row each ([B] and [B + C] rows)
    and the readback is [B, 4]; nothing is proposed or uploaded."""
    eng = _engine()
    prompt = _motif_prompt(np.random.default_rng(3))
    assert _drive(eng, eng.submit(prompt, SamplingParams(
        max_new_tokens=8)))[0] == _reference_greedy(prompt, 8)
    assert eng._row_counts == {"decode": {2}, "fused": {2 + 8}}
    assert eng._launch_step(False).numel() == 2 * 4
    assert eng.spec_proposed == eng.spec_uploads == 0


@pytest.mark.parametrize("max_new", [1, 2, 3, 5])
def test_speculation_never_overshoots_max_new(max_new):
    """k above the remaining budget: a lane delivers at most
    ``max_new_tokens`` tokens, the reference's tokens."""
    prompt = _motif_prompt(np.random.default_rng(3))
    eng = _engine(speculate_k=4)
    got = _drive(eng, eng.submit(prompt, SamplingParams(
        max_new_tokens=max_new)))[0]
    assert got == _reference_greedy(prompt, max_new)
    assert len(got) == max_new


@pytest.mark.parametrize("k", [0, 4])
def test_speculation_stops_exactly_at_the_stop_token(k):
    """A stop_token hit mid-burst cuts delivery at the stop, never past
    it, with speculation on or off."""
    prompt = _motif_prompt(np.random.default_rng(3))
    ref = _reference_greedy(prompt, 24)
    stop = ref[len(ref) // 2]
    want = ref[:ref.index(stop) + 1]
    eng = _engine(speculate_k=k)
    got = _drive(eng, eng.submit(prompt, SamplingParams(
        max_new_tokens=24, stop_token=stop)))[0]
    assert got == want
    assert got[-1] == stop and stop not in got[:-1]


def test_rejected_drafts_never_enter_the_radix():
    """Pool pressure preempts a speculating request; every radix insert
    is a block-aligned prefix of a request's delivered stream, pages are
    released exactly once, and the tokens are the reference's."""
    rng = np.random.default_rng(3)
    pa = _motif_prompt(rng, plen=12)
    pb = _motif_prompt(rng, plen=12)
    eng = _engine(max_context=48, num_blocks=10, speculate_k=4,
                  metrics=ServingMetrics())
    inserts = []
    real_insert = eng.prefix_cache.insert

    def spy(tokens, blocks):
        inserts.append(list(tokens))
        return real_insert(tokens, blocks)

    eng.prefix_cache.insert = spy
    ra = eng.submit(pa, SamplingParams(max_new_tokens=24))
    rb = eng.submit(pb, SamplingParams(max_new_tokens=20))
    outs = _drive(eng, [ra, rb])
    assert outs == [_reference_greedy(pa, 24), _reference_greedy(pb, 20)]
    assert ra.preemptions + rb.preemptions >= 1
    streams = [pa + outs[0], pb + outs[1]]
    for tokens in inserts:
        assert len(tokens) % eng.block_size == 0
        assert any(tokens == s[:len(tokens)] for s in streams), tokens
    assert eng.pool.num_free + len(eng.prefix_cache) == \
        eng.pool.num_usable
    assert all(eng.pool.refcount(b) == 0
               for b in range(1, eng.pool.num_blocks))


def test_sampled_and_greedy_lanes_mix():
    """top_k=1 at temperature 1 is a point-mass target: rejection
    sampling degenerates to argmax equality, so that lane emits the
    greedy reference through the speculation path; a free sampled lane
    in the same batch stays in the vocabulary and keeps its budget."""
    prompt = _motif_prompt(np.random.default_rng(4))
    ref = _reference_greedy(prompt, 12)
    eng = _engine(max_batch=3, speculate_k=3)
    topk1 = eng.submit(prompt, SamplingParams(
        max_new_tokens=12, temperature=1.0, top_k=1))
    free = eng.submit(prompt[:6], SamplingParams(
        max_new_tokens=12, temperature=1.3))
    greedy = eng.submit(prompt, SamplingParams(max_new_tokens=12))
    outs = _drive(eng, [topk1, free, greedy])
    assert outs[0] == ref and outs[2] == ref
    assert len(outs[1]) == 12
    assert all(0 <= t < _tiny()["cfg"].vocab_size for t in outs[1])


# --------------------------------------------------------- verify rule

_LAW_LOGITS = np.array([[1.2, 0.3, -0.5, 2.0, 0.0, -1.0],
                        [0.1, 1.5, 0.7, -0.2, 0.9, 0.4]], np.float32)


def _target(logits, temp, top_k):
    scaled = engine._mask_and_scale(
        torch.from_numpy(logits), torch.full((logits.shape[0],), temp),
        torch.full((logits.shape[0],), top_k))
    p = torch.softmax(scaled, -1).double().numpy()
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("draft,temp,top_k", [
    (3, 0.8, 0),      # the target's mode
    (5, 0.8, 0),      # an unlikely draft
    (1, 1.3, 4),      # top-k masks part of the vocabulary
    (5, 1.0, 3),      # a draft outside the top-k: always rejected
])
def test_verify_output_law_is_the_target(draft, temp, top_k):
    """The speculative-sampling identity: a lane's first token follows the
    target whatever the draft, and after an accepted draft the bonus token
    follows the next row's target (chi-square, fixed seed)."""
    n = 40000
    logits = torch.from_numpy(np.broadcast_to(
        _LAW_LOGITS, (n,) + _LAW_LOGITS.shape).copy())
    drafts = torch.full((n, 1), draft)
    gen = torch.Generator().manual_seed(7)
    out, accept = engine._verify(logits, drafts, torch.ones(n, dtype=torch.long),
                                 torch.full((n,), temp),
                                 torch.full((n,), top_k), gen)
    p = _target(_LAW_LOGITS, temp, top_k)
    first = np.bincount(out[:, 0].numpy(), minlength=6)
    support = p[0] > 0
    assert first[~support].sum() == 0
    assert chisquare(first[support], n * p[0][support]).pvalue > 1e-3
    acc = accept.numpy() == 1
    assert np.isclose(acc.mean(), p[0][draft], atol=0.01)
    if acc.sum() > 1000:
        bonus = np.bincount(out[acc, 1].numpy(), minlength=6)
        sup1 = p[1] > 0
        assert chisquare(bonus[sup1],
                         acc.sum() * p[1][sup1]).pvalue > 1e-3


def test_verify_greedy_lanes_accept_by_argmax():
    logits = torch.from_numpy(np.stack([_LAW_LOGITS, _LAW_LOGITS]))
    drafts = torch.tensor([[3], [0]])       # the argmax, then another
    out, accept = engine._verify(logits, drafts, torch.tensor([1, 1]),
                                 torch.zeros(2), torch.zeros(2, dtype=torch.long),
                                 torch.Generator().manual_seed(0))
    assert accept.tolist() == [1, 0]
    assert out.tolist() == [[3, 1], [3, 3]]


def test_verify_transform_equals_the_reference():
    """``_mask_and_scale`` is the reference's bit for bit, softmax over
    it within a few float32 ulps, and the removal of a rejected draft
    (the reference's inline jnp, engine.py 887-890) zeroes the same
    entries, its renormalisation within 2 ulps on the same
    probabilities."""
    rng = np.random.default_rng(0)
    logits = (rng.normal(size=(8, 3, 50)) * 4).astype(np.float32)
    temps = rng.uniform(0.2, 1.5, size=(8, 3)).astype(np.float32)
    temps[0] = 0.0                                   # a greedy lane
    topks = rng.integers(0, 20, size=(8, 3))
    got = engine._mask_and_scale(torch.from_numpy(logits),
                                 torch.from_numpy(temps),
                                 torch.from_numpy(topks))
    want = jengine._mask_and_scale(jnp.asarray(logits), jnp.asarray(temps),
                                   jnp.asarray(topks))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    probs = torch.softmax(got, -1).numpy()
    np.testing.assert_allclose(
        probs, np.asarray(jax.nn.softmax(want, axis=-1)),
        rtol=4e-6, atol=1e-6)

    p_a = probs[:, 1]
    d_a = rng.integers(0, 50, size=8)
    rejected = rng.random(8) < 0.5
    got = engine._remove_draft(torch.from_numpy(p_a), torch.from_numpy(d_a),
                               torch.from_numpy(rejected)).numpy()
    jp, jd, jr = jnp.asarray(p_a), jnp.asarray(d_a), jnp.asarray(rejected)
    adj = jnp.where(jr[:, None] & (jnp.arange(50)[None, :] == jd[:, None]),
                    0.0, jp)
    adj = np.asarray(adj / jnp.maximum(adj.sum(-1, keepdims=True), 1e-30))
    # the removed entries are exactly zero in both; the renormalising sum
    # reduces in another order in XLA, so the rest agree to 2 ulps
    np.testing.assert_array_equal(got == 0, adj == 0)
    np.testing.assert_allclose(got, adj, rtol=2.4e-7, atol=0)


# ------------------------------------------------------- device state

def test_uploads_only_on_steps_with_proposals():
    """The draft buffer crosses host→device once per step that carries
    proposals and never on one that does not (a prompt without repeats
    has steps of both kinds, a motif prompt proposes from its first
    decode step)."""
    for prompt in (list(range(1, 9)),
                   _motif_prompt(np.random.default_rng(3))):
        eng = _engine(speculate_k=4)
        seen = {"proposing": 0, "idle": 0, "idle_uploads": 0}
        real = eng._run_step

        def counted():
            before = eng.spec_uploads
            proposing = bool(eng._draft_lens.any())
            out = real()
            seen["proposing" if proposing else "idle"] += 1
            if not proposing:
                seen["idle_uploads"] += eng.spec_uploads - before
            return out

        eng._run_step = counted
        _drive(eng, eng.submit(prompt, SamplingParams(max_new_tokens=12)))
        assert seen["idle"] > 0 and seen["proposing"] > 0, seen
        assert seen["idle_uploads"] == 0
        assert eng.spec_uploads == seen["proposing"]


def test_spec_families_on_prom_equal_the_reference():
    """spec_proposed/spec_accepted and the accepted-length histogram
    publish as the reference's families, one TYPE line each."""
    m = _tiny()
    prompt = _motif_prompt(np.random.default_rng(3))
    eng = _engine(speculate_k=4, metrics=ServingMetrics())
    _drive(eng, eng.submit(prompt, SamplingParams(max_new_tokens=24)))
    jeng = jengine.DecodeEngine(m["jparams"], m["jcfg"], max_batch=2,
                                block_size=4, max_context=64,
                                prefill_chunk=8, speculate_k=4,
                                metrics=JServingMetrics())
    _drive(jeng, jeng.submit(prompt,
                             jengine.SamplingParams(max_new_tokens=24)))
    text = render_prom(metrics_system())
    want = jrender_prom(jmetrics_system())
    for name in ("htpu_spec_proposed", "htpu_spec_accepted"):
        assert name in text and name in want
        got_line = [ln for ln in text.splitlines()
                    if ln.startswith(name + "{")]
        want_line = [ln for ln in want.splitlines()
                     if ln.startswith(name + "{")]
        assert [ln.split(" ")[-1] for ln in got_line] == \
            [ln.split(" ")[-1] for ln in want_line]
    assert text.count("# TYPE htpu_spec_accept_len histogram") == 1
    assert sorted(ln.split(" ")[0] for ln in text.splitlines()
                  if ln.startswith("htpu_spec_accept_len")) == \
        sorted(ln.split(" ")[0] for ln in want.splitlines()
               if ln.startswith("htpu_spec_accept_len"))
