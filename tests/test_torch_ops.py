"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both. Tolerances:
1e-6 for the elementwise ops and norms (float32, one reduction),
1e-5 for attention (a softmax over a float32 einsum), and 2e-5 for the
flash kernel's plain version against the Pallas kernel in interpret
mode, the reference's own tolerance (tests/test_flash.py); 5e-4 for the
backward's plain version against the Pallas backward, the reference's
own gradient tolerance there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hadoop_tpu.ops import activations as jact
from hadoop_tpu.ops import attention as jattn
from hadoop_tpu.ops import flash as jflash
from hadoop_tpu.ops import norms as jnorms
from hadoop_tpu.ops import rope as jrope
from hadoop_tpu_torch.ops import activations, attention, flash, norms, rope


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


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=tol,
                               rtol=tol)


def test_norms_match_jax():
    x, w, b = _randn(0, 3, 5, 64), _randn(1, 64), _randn(2, 64)
    tx, tw, tb = map(torch.from_numpy, (x, w, b))
    _close(norms.rms_norm(tx, tw, 1e-5),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), 1e-6)
    _close(norms.layer_norm(tx, tw, tb, 1e-5),
           jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(b), 1e-5), 1e-6)


def test_rope_with_positions_matches_jax():
    cos, sin = rope.rope_frequencies(16, 64, 10000.0)
    jcos, jsin = jrope.rope_frequencies(16, 64, 10000.0)
    _close(cos, jcos, 1e-6)
    _close(sin, jsin, 1e-6)
    x = _randn(3, 2, 8, 3, 16)
    pos = np.random.default_rng(4).permutation(64)[:8]
    got = rope.apply_rope(torch.from_numpy(x), cos, sin,
                          torch.from_numpy(pos))
    want = jrope.apply_rope(jnp.asarray(x), jcos, jsin, jnp.asarray(pos))
    _close(got, want, 1e-6)
    _close(rope.apply_rope(torch.from_numpy(x), cos, sin),
           jrope.apply_rope(jnp.asarray(x), jcos, jsin), 1e-6)


def test_activations_match_jax():
    g, u = _randn(5, 4, 32), _randn(6, 4, 32)
    _close(activations.swiglu(torch.from_numpy(g), torch.from_numpy(u)),
           jact.swiglu(jnp.asarray(g), jnp.asarray(u)), 1e-6)
    _close(activations.gelu(torch.from_numpy(g)),
           jact.gelu(jnp.asarray(g)), 1e-6)


@pytest.mark.parametrize("sq,skv,hq,hkv,q_off,kv_off", [
    (8, 8, 4, 2, 0, 0),
    (4, 12, 4, 1, 8, 0),        # queries at the tail of a longer context
    (6, 10, 2, 2, 7, 3),
])
def test_causal_attention_offsets_match_jax(sq, skv, hq, hkv, q_off, kv_off):
    q, k, v = _randn(7, 2, sq, hq, 16), _randn(8, 2, skv, hkv, 16), \
        _randn(9, 2, skv, hkv, 16)
    got = attention.causal_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        q_offset=q_off, kv_offset=kv_off)
    want = jattn.causal_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), q_offset=q_off,
                                  kv_offset=kv_off, impl="ref")
    _close(got, want, 1e-5)


@pytest.mark.parametrize("b,s,hq,hkv,d,bq,bk", [
    (1, 256, 2, 2, 64, 128, 128),
    (2, 256, 4, 2, 64, 128, 128),
    (1, 384, 4, 1, 64, 128, 128),
    (1, 256, 2, 2, 128, 256, 128),
    (1, 128, 2, 1, 64, 128, 128),
])
def test_flash_ref_matches_pallas_forward(b, s, hq, hkv, d, bq, bk):
    """O and LSE of the plain version against the Pallas kernel run in
    interpret mode (head-major layout there, [B,S,H,D] here)."""
    q, k, v = _randn(10, b, s, hq, d), _randn(11, b, s, hkv, d), \
        _randn(12, b, s, hkv, d)
    scale = d ** -0.5
    o, lse = flash.flash_attention_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), scale)
    jo, jlse = jflash._fwd(
        *(jnp.swapaxes(jnp.asarray(x), 1, 2) for x in (q, k, v)),
        scale, bq, bk, True)
    _close(o, jnp.swapaxes(jo, 1, 2), 2e-5)
    _close(lse, jlse[..., 0], 2e-5)


def test_supported_and_pick_block_match_jax():
    for b, s, hq, hkv, d in [(1, 512, 16, 8, 128), (2, 256, 4, 3, 64),
                             (1, 96, 2, 1, 64), (1, 128, 2, 2, 96),
                             (1, 64, 2, 1, 64), (4, 2048, 16, 8, 256)]:
        for skv in (s, s * 2):
            for offs in [(0, 0), (1, 0), (0, 5)]:
                args = ((b, s, hq, d), (b, skv, hkv, d)) + offs
                assert flash.supported(*args) == jflash.supported(*args)
    for seq in (1, 3, 96, 128, 384, 512, 640, 2048):
        for pref in (64, 128, 512):
            assert flash._pick_block(seq, pref) == \
                jflash._pick_block(seq, pref)


def test_flash_grads_flow_on_cpu_uncounted():
    """With grad mode on and an input requiring grad, ``flash_attention``
    goes through ``FlashAttention``, whose backward on CPU tensors is the
    plain version: gradients flow and no kernel launch is counted. The
    bare ``flash_forward`` records no graph."""
    q, k, v = (torch.from_numpy(_randn(20 + i, 1, 128, h, 64))
               for i, h in enumerate((2, 1, 1)))
    counts = (flash.launches, flash.launches_bwd_dq, flash.launches_bwd_dkv)
    qg = q.clone().requires_grad_()
    out = flash.flash_attention(qg, k, v)
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert qg.grad is not None and torch.isfinite(qg.grad).all()
    o, lse = flash.flash_forward(qg, k, v)
    assert o.grad_fn is None and lse.grad_fn is None
    with torch.no_grad():
        assert flash.flash_attention(qg, k, v).grad_fn is None
    assert (flash.launches, flash.launches_bwd_dq,
            flash.launches_bwd_dkv) == counts


@pytest.mark.parametrize("b,s,hq,hkv,d,bq,bk", [
    (1, 256, 2, 2, 64, 128, 128),
    (2, 256, 4, 2, 64, 128, 128),
    (1, 256, 2, 2, 128, 128, 256),
    (1, 384, 4, 1, 64, 128, 128),       # MQA
])
def test_flash_bwd_ref_matches_pallas_backward(b, s, hq, hkv, d, bq, bk):
    """dq, dk, dv of the plain version against the Pallas backward kernels
    in interpret mode, on the same q, k, v, o, lse and dO (head-major
    there, [B,S,H,D] here)."""
    q, k, v, do = _randn(30, b, s, hq, d), _randn(31, b, s, hkv, d), \
        _randn(32, b, s, hkv, d), _randn(33, b, s, hq, d)
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.swapaxes(jnp.asarray(x), 1, 2)
                       for x in (q, k, v, do))
    jo, jlse = jflash._fwd(jq, jk, jv, scale, bq, bk, True)
    want = jflash._bwd(scale, bq, bk, True, (jq, jk, jv, jo, jlse),
                       (jdo, None))
    got = flash.flash_attention_bwd_ref(
        *(torch.from_numpy(x) for x in (q, k, v)),
        torch.from_numpy(np.array(jnp.swapaxes(jo, 1, 2))),
        torch.from_numpy(np.array(jlse[..., 0])), torch.from_numpy(do),
        scale)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(jnp.swapaxes(w, 1, 2)),
                                   atol=5e-4, rtol=5e-4,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("hq,hkv", [(4, 2), (2, 2)])
def test_flash_function_grads_match_plain_attention(hq, hkv):
    """Gradients through ``FlashAttention`` (forward and backward plain
    versions on the CPU) against autograd through the einsum-softmax
    attention, with a non-trivial cotangent."""
    q, k, v = (torch.from_numpy(_randn(40 + i, 2, 128, h, 64))
               for i, h in enumerate((hq, hkv, hkv)))
    grads = []
    for impl in ("flash", "ref"):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = attention.causal_attention(*leaves, impl=impl)
        (out * torch.cos(out)).sum().backward()
        grads.append([x.grad for x in leaves])
    for name, a, b in zip("qkv", *grads):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5,
                                   msg=f"d{name}")


def test_flash_wrapper_on_cpu_is_the_plain_version_uncounted():
    q, k, v = (torch.from_numpy(_randn(13 + i, 1, 128, h, 64))
               for i, h in enumerate((4, 2, 2)))
    before = flash.launches
    o, lse = flash.flash_forward(q, k, v)
    ro, rlse = flash.flash_attention_ref(q, k, v, 64 ** -0.5)
    assert torch.equal(o, ro) and torch.equal(lse, rlse)
    assert flash.launches == before              # no kernel launched
    with pytest.raises(ValueError):              # never a CPU launch
        flash._launch(q, k, v, 1.0)


def test_causal_attention_dispatch():
    """"auto" keeps CPU tensors on the plain path; a forced "flash" on
    unsupported shapes raises instead of falling back."""
    q = torch.from_numpy(_randn(16, 1, 128, 2, 64))
    k = torch.from_numpy(_randn(17, 1, 128, 1, 64))
    auto = attention.causal_attention(q, k, k)
    forced = attention.causal_attention(q, k, k, impl="flash")
    torch.testing.assert_close(auto, forced, atol=1e-5, rtol=1e-5)
    with pytest.raises(ValueError):
        attention.causal_attention(q[:, :96], k[:, :96], k[:, :96],
                                   impl="flash")
    with pytest.raises(ValueError):
        attention.causal_attention(q, k, k, q_offset=1, impl="flash")
