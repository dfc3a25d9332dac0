"""The PyTorch port's ops against the JAX package's, on the CPU.

Inputs are made with numpy from a seed and fed to both. Tolerances:
1e-6 for the elementwise ops and norms (float32, one reduction),
1e-5 for attention (a softmax over a float32 einsum), and 2e-5 for the
flash kernel's plain version against the Pallas kernel in interpret
mode, the reference's own tolerance (tests/test_flash.py); 5e-4 for the
backward's plain version against the Pallas backward, the reference's
own gradient tolerance there.
"""

import ctypes
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from hadoop_tpu.ops import activations as jact
from hadoop_tpu.ops import attention as jattn
from hadoop_tpu.ops import flash as jflash
from hadoop_tpu.ops import norms as jnorms
from hadoop_tpu.ops import rope as jrope
from hadoop_tpu_torch.ops import (_build, activations, attention, flash,
                                  norms, rope)


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


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
@pytest.mark.parametrize("shape", [(3, 5, 64), (2, 4, 256)])
def test_rms_norm_plain_forward_backward_match_jax_vjp(dtype, tol, shape):
    """The RMSNorm kernels' plain versions (``rms_norm_ref_fwd``, and
    ``rms_norm_ref_bwd`` from the forward's 1/rms) against ``jax.vjp`` of
    the reference's ``rms_norm``: y, dx and dw, in float32 and bf16 (one
    bf16 rounding: the reference casts once at the end too). On the CPU
    ``rms_norm``'s autograd gives the same gradients."""
    import jax
    x, dy = _randn(11, *shape), _randn(12, *shape)
    w = 1 + 0.1 * _randn(13, shape[-1])
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    jx, jw, jdy = (jnp.asarray(a, jdt) for a in (x, w, dy))
    jy, vjp = jax.vjp(lambda a, b: jnorms.rms_norm(a, b, 1e-5), jx, jw)
    jdx, jdw = vjp(jdy)
    tx, tw, tdy = (torch.from_numpy(a).to(tdt) for a in (x, w, dy))
    y, r = norms.rms_norm_ref_fwd(tx, tw, 1e-5)
    dx, dw = norms.rms_norm_ref_bwd(tdy, tx, tw, r)
    assert r.shape == shape[:-1] and r.dtype == torch.float32
    for got, want in ((y, jy), (dx, jdx), (dw, jdw)):
        assert got.dtype == tdt
        _close(got.float(), np.asarray(want, np.float32), tol)
    ax, aw = tx.clone().requires_grad_(), tw.clone().requires_grad_()
    norms.rms_norm(ax, aw, 1e-5).backward(tdy)
    _close(ax.grad.float(), dx.float(), tol)
    _close(aw.grad.float(), dw.float(), tol)


def test_rms_norm_function_routes_cuda_tensors_to_the_kernels(monkeypatch):
    """A (seemingly) CUDA tensor takes ``RMSNorm``: the forward and
    backward kernels' launches (stood in for by their plain versions
    here) give what autograd through the plain formula gives, for a
    non-contiguous x and a weight unbound from a stacked leaf; a CPU
    tensor launches nothing."""
    launched = []

    def fwd(x, weight, eps):
        launched.append("fwd")
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        y, r = norms.rms_norm_ref_fwd(x2, weight, eps)
        return y.view(x.shape), x2, r

    def bwd(dy, x2, weight, r):
        launched.append("bwd")
        return norms.rms_norm_ref_bwd(dy.reshape(x2.shape), x2, weight, r)

    monkeypatch.setattr(norms, "_launch_fwd", fwd)
    monkeypatch.setattr(norms, "_launch_bwd", bwd)
    base = torch.from_numpy(_randn(21, 6, 64, 3)).transpose(1, 2)
    stack = (1 + 0.1 * torch.from_numpy(_randn(22, 2, 64)))
    dy = torch.from_numpy(_randn(23, 6, 3, 64))
    grads = []
    for cuda in (True, False):
        x = base.clone().requires_grad_()
        w = stack.clone().requires_grad_()
        xin = x.as_subclass(_LooksCuda) if cuda else x
        y = norms.rms_norm(xin, w.unbind(0)[1], 1e-5)
        y.as_subclass(torch.Tensor).backward(dy)
        grads.append((y.as_subclass(torch.Tensor).detach(), x.grad, w.grad))
    assert launched == ["fwd", "bwd"]
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("x_dtype,w_dtype,d,match", [
    ("bfloat16", "float32", 64, "a weight of x's dtype"),
    ("float16", "int8", 64, "a weight of x's dtype"),
    ("float32", "float32", 8196, "at most 8192"),
    ("bfloat16", "bfloat16", 8200, "at most 8192"),
    ("float32", "float32", 62, "multiple of 4"),
])
def test_rms_norm_kernel_refuses_what_it_was_not_built_for(monkeypatch,
                                                          x_dtype, w_dtype,
                                                          d, match):
    """On a (seemingly) CUDA tensor ``rms_norm`` takes the kernels, which
    take x and w of one dtype and rows of at most 8192 (a multiple of 16
    bytes): anything else raises before a launch, never falls back to the
    plain formula. The widest rows of each dtype are taken."""
    launched = []
    monkeypatch.setattr(norms._build, "launch",
                        lambda *a: launched.append(a[0]))
    x = torch.zeros(2, d, dtype=getattr(torch, x_dtype))
    w = torch.ones(d, dtype=getattr(torch, w_dtype))
    with pytest.raises(ValueError, match=match):
        norms.rms_norm(x.as_subclass(_LooksCuda), w, 1e-5)
    assert launched == []
    for dtype in ("float32", "bfloat16"):
        x = torch.zeros(2, 8192, dtype=getattr(torch, dtype))
        norms._check(x.as_subclass(_LooksCuda), torch.ones(8192, dtype=x.dtype))


# the kernels' tolerance in float32 against the plain version, relative to
# max |value| (chip_smoke.py's RMS_F32_TOL: a few float32 ulps of the
# largest term, the sums taken in another order)
RMS_F32_TOL = 1e-6


def _fma(a, b, c):
    """fmaf in float32: the exact product and sum in float64, rounded."""
    return (a.double() * b.double() + c.double()).float()


def _emulate_rms_bwd(dy, x, w, r, blocks, per, vec):
    """rmsnorm.cu's backward in float32 torch ops, in the kernel's order:
    thread t of 256 owns the 16-byte vectors t, t + 256, ... of a row
    (``vec`` elements each) and sums g·x over them in order by fmaf; a
    butterfly within each warp; the eight warps' sums added in warp order.
    dw: each block's fmaf running sum over its rows in order, then the
    finish: warp v sums partials v, v + 8, ... in float64, the warps'
    sums added in order. [rows, d] float32 → (dx, dw) float32."""
    rows, d = x.shape
    nvec = d // vec
    nv = 1
    while nv * 256 < nvec:
        nv *= 2
    # element order of each thread: its vectors in order, then lanes
    cols = torch.full((256, nv * vec), -1, dtype=torch.long)
    for t in range(256):
        for k in range(nv):
            v = t + 256 * k
            if v < nvec:
                cols[t, k * vec:(k + 1) * vec] = torch.arange(v * vec,
                                                              (v + 1) * vec)
    g = dy * w
    dot = torch.zeros(rows, 256)
    for e in range(nv * vec):
        c = cols[:, e]
        live = c >= 0
        cc = c.clamp(min=0)
        step = _fma(g[:, cc], x[:, cc], dot)
        dot = torch.where(live, step, dot)
    lanes = dot.view(rows, 8, 32)
    idx = torch.arange(32)
    for off in (16, 8, 4, 2, 1):
        lanes = lanes + lanes[..., idx ^ off]
    total = lanes[:, 0, 0]
    for v in range(1, 8):
        total = total + lanes[:, v, 0]
    mean = total / d
    c = ((r * r) * r) * mean
    dx = r[:, None] * g - x * c[:, None]
    parts = torch.zeros(blocks, d)
    for b in range(blocks):
        acc = torch.zeros(d)
        for row in range(b * per, min(rows, (b + 1) * per)):
            acc = _fma(dy[row], x[row] * r[row], acc)
        parts[b] = acc
    sums = []
    for v in range(8):          # in order, as the kernel: no pairwise sum
        acc = torch.zeros(d, dtype=torch.float64)
        for b in range(v, blocks, 8):
            acc = acc + parts[b].double()
        sums.append(acc)
    dw = sums[0]
    for v in range(1, 8):
        dw = dw + sums[v]
    return dx, dw.float()


def _rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("layout", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [2048, 4096])
def test_rms_bwd_kernel_order_matches_plain_and_jax(d, layout):
    """The backward kernel's reduction order (emulated above, in float32
    on the CPU; ``layout`` sets the vector width, 4 or 8 elements, and
    rounds the inputs to bf16 for the bfloat16 path) against the plain
    version and ``jax.vjp`` of the reference's ``rms_norm``, on the same
    float32 inputs: dx and dw within RMS_F32_TOL of max |value|, at the
    widths of flagship-1b and mixtral-8x7b, over several row shares."""
    import jax
    rows = 96
    vec = 4 if layout == "float32" else 8
    tdt = getattr(torch, layout)
    x, dy = (torch.from_numpy(_randn(s, rows, d)).to(tdt).float()
             for s in (31, 32))
    w = (1 + 0.1 * torch.from_numpy(_randn(33, d))).to(tdt).float()
    blocks, per = norms._bwd_grid(rows, 5)
    assert (blocks, per) == (10, 10)
    _, r = norms.rms_norm_ref_fwd(x, w, 1e-5)
    dx, dw = _emulate_rms_bwd(dy, x, w, r, blocks, per, vec)
    dxr, dwr = norms.rms_norm_ref_bwd(dy, x, w, r)
    assert _rel(dx, dxr) <= RMS_F32_TOL
    assert _rel(dw, dwr) <= RMS_F32_TOL
    _, vjp = jax.vjp(lambda a, b: jnorms.rms_norm(a, b, 1e-5),
                     jnp.asarray(x.numpy()), jnp.asarray(w.numpy()))
    jdx, jdw = vjp(jnp.asarray(dy.numpy()))
    assert _rel(dx, jdx) <= RMS_F32_TOL
    assert _rel(dw, jdw) <= RMS_F32_TOL


@pytest.mark.parametrize("rows,sms", [(1, 132), (7, 132), (263, 132),
                                      (264, 132), (265, 132), (4096, 132),
                                      (8192, 132), (8191, 132), (100, 3),
                                      (1000, 114)])
def test_rms_bwd_grid_covers_every_row_once(rows, sms):
    """``_bwd_grid``: at most two blocks an SM and one a row, shares of
    consecutive rows that cover every row once with no empty block, and
    the share the kernel computes (ceil(rows / blocks)) is the grid's."""
    blocks, per = norms._bwd_grid(rows, sms)
    assert 1 <= blocks <= min(rows, 2 * sms)
    assert blocks * per >= rows and (blocks - 1) * per < rows
    assert -(-rows // blocks) == per


def test_rms_bwd_grid_at_the_main_path_shapes():
    """flagship-1b's [4, 2048] and mixtral-8x7b's [1, 4096] training rows
    on an H100's 132 SMs: 256 blocks of 32 and of 16 rows, one wave of two
    blocks an SM."""
    assert norms._bwd_grid(4 * 2048, 132) == (256, 32)
    assert norms._bwd_grid(4096, 132) == (256, 16)

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
    # the wgmma kernels' edge shapes: n_rep 4 with an odd count of
    # 128-row tiles, and Hq = Hkv with a single tile
    (1, 384, 8, 2, 128, 128, 128),
    (2, 128, 4, 4, 128, 128, 128),
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


def test_kernel_built_is_what_the_kernels_take():
    """``kernel_built`` holds for the dtypes and head dims the kernels
    are built for, where ``supported`` (the reference's copy) holds for
    any dtype and any D % 64 == 0."""
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 128, 192, 256):
            assert flash.kernel_built(dtype, d)
        for d in (32, 96, 320, 384, 512):
            assert not flash.kernel_built(dtype, d)
    for dtype in (torch.float16, torch.float64, torch.int8):
        assert not flash.kernel_built(dtype, 128)
    assert flash.supported((1, 128, 2, 320), (1, 128, 1, 320), 0, 0)
    assert jflash.supported((1, 128, 2, 320), (1, 128, 1, 320), 0, 0)


class _LooksCuda(torch.Tensor):
    """A CPU tensor whose ``is_cuda`` says True: "auto" decides as it
    does on the card, and the arithmetic runs on the CPU."""

    @property
    def is_cuda(self):
        return True


def _looks_cuda(seed, shape, dtype):
    return torch.from_numpy(_randn(seed, *shape)).to(dtype).as_subclass(
        _LooksCuda)


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.float16, 64, False),      # a float16 config
    (torch.float32, 320, False),     # D % 64 == 0, but no kernel built
    (torch.bfloat16, 384, False),
    (torch.bfloat16, 64, True),      # control: the kernel's own case
])
def test_auto_takes_the_plain_path_where_no_kernel_is_built(
        monkeypatch, dtype, d, kernel):
    """On a (seemingly) CUDA tensor whose shapes ``supported`` accepts,
    "auto" calls the flash kernel only for a dtype and head dim it was
    built for; otherwise it returns the plain path's result, as the
    reference does off the TPU, where the kernel's checks would raise."""
    calls = []
    monkeypatch.setattr(flash, "flash_attention",
                        lambda *a: calls.append(1) or a[0])
    q, k, v = (_looks_cuda(80 + i, (1, 128, h, d), dtype)
               for i, h in enumerate((4, 2, 2)))
    assert flash.supported(q.shape, k.shape, 0, 0)
    got = attention.causal_attention(q, k, v)
    assert len(calls) == int(kernel)
    if not kernel:
        plain = attention.causal_attention(
            *(x.as_subclass(torch.Tensor) for x in (q, k, v)), impl="ref")
        assert got.dtype == dtype
        assert torch.equal(got.as_subclass(torch.Tensor), plain)


@pytest.mark.parametrize("dtype,d,kernel", [
    (torch.float16, 64, False), (torch.float32, 320, False),
    (torch.bfloat16, 64, True)])
def test_ring_auto_takes_the_chunk_path_where_no_kernel_is_built(
        monkeypatch, dtype, d, kernel):
    """Ring attention's "auto" asks the same: the fused partial only for
    a dtype and head dim the kernels were built for."""
    from hadoop_tpu_torch.parallel import ring_attention as ra

    calls = []
    partial = flash.flash_attention_partial
    monkeypatch.setattr(flash, "flash_attention_partial",
                        lambda *a: calls.append(1) or partial(*a))
    q, k, v = (_looks_cuda(90 + i, (2, 128, h, d), dtype)
               for i, h in enumerate((4, 2, 2)))
    got = ra.ring_attention(q, k, v, 2)
    assert bool(calls) == kernel
    if not kernel:
        plain = ra.ring_attention(
            *(x.as_subclass(torch.Tensor) for x in (q, k, v)), 2, impl="ref")
        assert torch.equal(got.as_subclass(torch.Tensor), plain)


# --------------------------------------------------------- ring partials

@pytest.mark.parametrize("causal,sq,skv,dtype,tol", [
    (True, 256, 256, "float32", 2e-5),     # the diagonal chunk
    (False, 256, 256, "float32", 2e-5),    # a fully visible chunk
    (False, 128, 384, "float32", 2e-5),    # Sq != Skv
    (False, 384, 128, "float32", 2e-5),
    (False, 256, 256, "bfloat16", 2e-2),
])
def test_flash_partial_ref_matches_pallas_partial(causal, sq, skv, dtype,
                                                  tol):
    """O and lse of the partial's plain version against the Pallas
    partial run in interpret mode, as tests/test_flash.py runs it
    (Skv <= 512: one key block there, so P is rounded against the row
    max on both sides). bf16: both round P and O to bf16."""
    q, k, v = _randn(50, 2, sq, 4, 64), _randn(51, 2, skv, 2, 64), \
        _randn(52, 2, skv, 2, 64)
    jq, jk, jv = (jnp.asarray(x, dtype) for x in (q, k, v))
    want_o, want_l = jflash.flash_attention_partial(jq, jk, jv, 0.125,
                                                    causal, True)
    tq, tk, tv = (torch.from_numpy(np.array(x.astype(jnp.float32)))
                  .to(getattr(torch, dtype)) for x in (jq, jk, jv))
    o, lse = flash.flash_attention_partial(tq, tk, tv, 0.125, causal)
    assert o.dtype == lse.dtype == torch.float32
    assert o.shape == (2, sq, 4, 64) and lse.shape == (2, sq, 4)
    _close(o, want_o, tol)
    _close(lse, want_l, tol)


def test_partial_supported_matches_jax():
    for q_shape, k_shape in [((4, 2048, 32, 128), (4, 2048, 8, 128)),
                             ((2, 256, 8, 128), (2, 512, 2, 128)),
                             ((1, 96, 2, 64), (1, 128, 1, 64)),
                             ((1, 128, 2, 64), (1, 64, 1, 64)),
                             ((1, 128, 4, 64), (1, 128, 3, 64)),
                             ((1, 128, 2, 96), (1, 128, 1, 96))]:
        assert flash.partial_supported(q_shape, k_shape) == \
            jflash.partial_supported(q_shape, k_shape)


def test_partial_wrapper_on_cpu_is_the_plain_version_uncounted():
    """On CPU tensors the wrapper computes the plain version and counts
    no launch; the kernel path refuses CPU tensors; its gradient is
    that of the plain version (the reference's custom VJP)."""
    q, k, v = (torch.from_numpy(_randn(60 + i, 1, 128, h, 64))
               for i, h in enumerate((4, 2, 2)))
    before = (flash.launches, flash.launches_partial)
    for causal in (True, False):
        o, lse = flash.flash_attention_partial(q, k, v, 0.125, causal)
        ro, rlse = flash.flash_attention_partial_ref(q, k, v, 0.125, causal)
        assert torch.equal(o, ro) and torch.equal(lse, rlse)
    # the causal partial is the causal forward, cast and transposed
    fo, flse = flash.flash_forward(q, k, v, 0.125)
    o, lse = flash.flash_attention_partial(q, k, v, 0.125, True)
    assert torch.equal(o, fo.float()) and torch.equal(lse, flse.transpose(1, 2))
    assert (flash.launches, flash.launches_partial) == before
    with pytest.raises(ValueError):
        flash._launch_partial(q, k, v, 1.0)
    for causal in (True, False):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        refs = [t.clone().requires_grad_() for t in (q, k, v)]
        o, lse = flash.flash_attention_partial(*leaves, 0.125, causal)
        ro, rlse = flash.flash_attention_partial_ref(*refs, 0.125, causal)
        w = torch.from_numpy(_randn(80, *o.shape))
        wl = torch.from_numpy(_randn(81, *lse.shape))
        ((o * w).sum() + (lse * wl).sum()).backward()
        ((ro * w).sum() + (rlse * wl).sum()).backward()
        for got, want in zip(leaves, refs):
            assert torch.equal(got.grad, want.grad)


def test_partial_ref_rounds_o_to_the_input_dtype():
    """bf16: O is rounded to bf16 before the float32 cast, as the TPU
    kernel writes it."""
    q, k, v = (torch.from_numpy(_randn(70 + i, 1, 128, 2, 64))
               .to(torch.bfloat16) for i in range(3))
    o, _ = flash.flash_attention_partial_ref(q, k, v, 0.125, False)
    assert torch.equal(o, o.to(torch.bfloat16).float())


def _chunk_case(seed, sq, sk, q_off, kv_off):
    q, k, v = _randn(seed, 2, sq, 4, 16), _randn(seed + 1, 2, sk, 4, 16), \
        _randn(seed + 2, 2, sk, 4, 16)
    qp, kp = np.arange(sq) + q_off, np.arange(sk) + kv_off
    want = jattn.chunk_attention(*(jnp.asarray(x) for x in (q, k, v)), 0.25,
                                 jnp.asarray(qp), jnp.asarray(kp))
    tq, tk, tv, tqp, tkp = (torch.from_numpy(x) for x in (q, k, v, qp, kp))
    got = attention.chunk_attention(tq, tk, tv, 0.25, tqp, tkp)
    return got, want


@pytest.mark.parametrize("sq,sk,q_off,kv_off", [
    (8, 8, 0, 0),        # the diagonal
    (8, 12, 16, 0),      # fully visible
    (6, 10, 3, 0),       # partly visible: some rows see nothing
    (8, 8, 0, 8),        # all future: every row -inf
])
def test_chunk_and_merge_attention_match_jax(sq, sk, q_off, kv_off):
    (o1, l1), (jo1, jl1) = _chunk_case(80, sq, sk, q_off, kv_off)
    _close(o1, jo1, 1e-6)
    _close(l1, jl1, 1e-6)
    (o2, l2), (jo2, jl2) = _chunk_case(90, sq, sk, q_off, 0)
    got = attention.merge_attention(o1, l1, o2, l2)
    want = jattn.merge_attention(jo1, jl1, jo2, jl2)
    for g, w in zip(got, want):
        _close(g, w, 1e-6)
    if kv_off > q_off:                    # the -inf chunk is the identity
        assert torch.isneginf(l1).all() and not o1.any()
        assert torch.equal(got[0], o2) and torch.equal(got[1], l2)
        both = attention.merge_attention(o1, l1, o1, l1)
        assert torch.isneginf(both[1]).all() and not both[0].any()


def test_chunk_attention_per_row_positions():
    """[B, S] positions (ring ranks folded into the batch) equal one call
    per batch row with [S] positions."""
    q, k, v = (torch.from_numpy(_randn(100 + i, 2, 8, 2, 16))
               for i in range(3))
    qp = torch.arange(8) + torch.tensor([[0], [8]])
    kp = torch.arange(8) + torch.tensor([[8], [4]])
    o, lse = attention.chunk_attention(q, k, v, 0.25, qp, kp)
    for r in range(2):
        ro, rl = attention.chunk_attention(q[r:r + 1], k[r:r + 1],
                                           v[r:r + 1], 0.25, qp[r], kp[r])
        torch.testing.assert_close(o[r:r + 1], ro, atol=0, rtol=0)
        torch.testing.assert_close(lse[r:r + 1], rl, atol=0, rtol=0)


def test_rope_per_rank_positions_match_jax():
    """[R, S] positions on x [R*B, S, H, D]: each rank's rows rotate by
    that rank's absolute positions, as the reference does per shard."""
    cos, sin = rope.rope_frequencies(16, 64, 10000.0)
    jcos, jsin = jrope.rope_frequencies(16, 64, 10000.0)
    r, b, s = 4, 2, 8
    x = _randn(110, r * b, s, 3, 16)
    pos = np.arange(r)[:, None] * s + np.arange(s)
    got = rope.apply_rope(torch.from_numpy(x), cos, sin,
                          torch.from_numpy(pos))
    for rank in range(r):
        rows = slice(rank * b, (rank + 1) * b)
        want = jrope.apply_rope(jnp.asarray(x[rows]), jcos, jsin,
                                jnp.asarray(pos[rank]))
        _close(got[rows], want, 1e-6)


# ------------------------------------------------ the kernels' build and ABI

def test_build_target_hashes_headers_and_flags(tmp_path, monkeypatch):
    """A build is named by its source, every csrc header and the flags:
    an edited header names a new build, so the library built from the old
    header is never served. Nothing is compiled."""
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("constexpr int kN = 1;\n")
    monkeypatch.setattr(_build, "_CSRC", tmp_path)
    first = _build._target("k")
    assert first.parent == _build.BUILD_DIR
    (tmp_path / "k.cuh").write_text("constexpr int kN = 2;\n")
    edited = _build._target("k")
    assert edited != first
    (tmp_path / "k.cuh").write_text("constexpr int kN = 1;\n")
    assert _build._target("k") == first          # content, not time
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-G"])
    assert _build._target("k") not in (first, edited)


def _c_entries():
    """Each function of the ``extern "C"`` blocks of ops/csrc/*.cu: (file
    stem, name) -> the kinds of its parameters in order (ptr, int, int64,
    float, stream)."""
    entries = {}
    for path in sorted(_build._CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", path.read_text())
        block = text[text.index('extern "C" {'):]
        for ret, name, params in re.findall(
                r"^([\w][\w\s\*]*?)\s*\b(htpu_\w+)\s*\(([^)]*)\)\s*\{",
                block, re.M):
            kinds = []
            for param in params.split(","):
                ptype, pname = param.strip().rsplit(None, 1)
                ptype += "*" * pname.count("*")
                kinds.append("stream" if pname == "stream" else
                             "ptr" if "*" in ptype else
                             {"int": "int", "long long": "int64",
                              "float": "float"}[ptype])
            entries[(path.stem, name)] = (ret.strip(), kinds)
    return entries


def test_c_entry_signatures_match_ctypes():
    """ctypes passes arguments by the ``argtypes`` it is given: an entry
    whose C parameters differ from ``SIGNATURES`` (a pointer, int, float
    or the stream more or fewer, or out of order) would read corrupted
    arguments with no error. Every C entry is held here."""
    entries = _c_entries()
    assert ("flash_fwd", "htpu_flash_fwd_partial") in entries
    seen = set()
    for (lib, name), (ret, kinds) in entries.items():
        if name == "htpu_cuda_error_string":        # bound in _build.launch
            assert kinds == ["int"] and "char" in ret, (lib, kinds, ret)
            continue
        assert name in _build.SIGNATURES, f"{lib}: {name} has no signature"
        want_lib, n_ptr, ints, n_float, stream = _build.SIGNATURES[name]
        ints = (["int"] * ints if isinstance(ints, int) else
                [{ctypes.c_int: "int", ctypes.c_longlong: "int64"}[t]
                 for t in ints])
        assert ret == "int", (name, ret)
        assert lib == want_lib, (name, lib, want_lib)
        assert kinds == (["ptr"] * n_ptr + ints + ["float"] * n_float
                         + ["stream"] * stream), (name, kinds)
        seen.add(name)
    assert seen == set(_build.SIGNATURES)
