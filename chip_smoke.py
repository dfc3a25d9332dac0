#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``hadoop_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds
it against its plain PyTorch version, runs the flagship-1b forward
through it, and serves flagship-1b requests through ``DecodeEngine``.
Weights are random, made from a seeded ``torch.Generator``. Each phase
prints one JSON line; the card's name and power limit (as
``nvidia-smi`` reports them) follow the build line; the line before
the last lists every ported kernel with its launches on the main path,
its error and its times; the last line is ``{"ok": true, "device":
...}``. Any failed check raises, so the script exits non-zero and
prints no result. It needs a CUDA device and exits non-zero without one.

Peak rates for the bound (``bound_ms``): NVIDIA H100 SXM data sheet,
3.35 TB/s device memory, 989 TFLOP/s dense bf16 on the tensor cores and
67 TFLOP/s float32 outside them (the kernel's float32 path keeps full
float32, so the float32 peak is the one that applies).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch
import torch.nn.functional as F

from hadoop_tpu_torch import (DecodeEngine, SamplingParams, forward,
                              get_config, init_params)
from hadoop_tpu_torch.ops import _build, flash

MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SEED = 0

# (B, S, Hq, Hkv, D, dtypes): flagship-1b's forward shape first
KERNEL_SHAPES = [
    (1, 512, 16, 8, 128, (torch.bfloat16, torch.float32)),
    (4, 2048, 16, 8, 128, (torch.bfloat16, torch.float32)),
    (2, 256, 4, 2, 64, (torch.float32,)),
    (1, 384, 4, 1, 64, (torch.float32,)),
    (1, 128, 2, 1, 64, (torch.float32,)),
]
# max abs error of the kernel against flash_attention_ref: (O, LSE).
# bf16 rounds P to bf16 before P.V at other places than the plain version
# (per 64-key tile against the running max, not once against the row max)
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
TIE_REL = 1e-4          # near-tie rule for greedy token comparisons


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flash_bound(b, s, hq, hkv, d, dtype):
    """(bound_ms, bound_by): each input read once and each output written
    once over the memory rate, against the causal work (QK^T and PV over
    the S(S+1)/2 visible pairs) over the peak rate for the dtype."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * b * s * (2 * hq + 2 * hkv) * d + 4 * b * hq * s
    flops = 4 * d * b * hq * s * (s + 1) / 2
    t_mem, t_ops = nbytes / MEM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return max(t_mem, t_ops) * 1e3, "bytes" if t_mem >= t_ops else "operations"


# ------------------------------------------------------------------ phases

def phase_build():
    t0 = time.monotonic()
    _build.build(["flash_fwd"])
    _build.load("flash_fwd")
    seconds = time.monotonic() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    ptxas = [ln.strip() for ln in _build.build_logs.get("flash_fwd", "")
             .splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "kernel": "flash_fwd", "seconds": seconds,
          "ptxas": ptxas})
    print(smi, flush=True)
    return smi


def phase_kernel():
    """Kernel against its plain version at every listed shape; returns
    the flagship bf16 record for the kernels line."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flagship = None
    for b, s, hq, hkv, d, dtypes in KERNEL_SHAPES:
        for dtype in dtypes:
            q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
            k = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
            v = torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
            scale = d ** -0.5
            o, lse = flash.flash_forward(q, k, v, scale)
            o_ref, lse_ref = flash.flash_attention_ref(q, k, v, scale)
            torch.cuda.synchronize()
            err_o = (o.float() - o_ref.float()).abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            tol_o, tol_lse = TOLERANCE[dtype]
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            rec = {
                "phase": "kernel", "name": "flash_fwd",
                "shape": [b, s, hq, hkv, d], "dtype": str(dtype),
                "max_abs_err": err_o, "max_abs_err_lse": err_lse,
                "tol": [tol_o, tol_lse],
                "ms": cuda_ms(lambda: flash.flash_forward(q, k, v, scale),
                              20),
                "plain_ms": cuda_ms(
                    lambda: flash.flash_attention_ref(q, k, v, scale), 5),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, scale=scale,
                    enable_gqa=True), 20),
            }
            rec["bound_ms"], rec["bound_by"] = flash_bound(b, s, hq, hkv, d,
                                                           dtype)
            emit(rec)
            require(err_o <= tol_o and err_lse <= tol_lse,
                    f"flash_fwd disagrees with its plain version at "
                    f"{rec['shape']} {dtype}: O {err_o}, LSE {err_lse}")
            if flagship is None:
                flagship = rec
            del q, k, v, o, lse, o_ref, lse_ref
    return flagship


def make_params():
    """flagship-1b at full width: float32 weights from a seeded generator
    and their bf16 cast (what init_params gives for the bf16 config)."""
    cfg32 = get_config("flagship-1b", dtype="float32")
    cfg16 = get_config("flagship-1b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p32 = init_params(cfg32, gen)

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.to(torch.bfloat16)
                for k, v in tree.items()}

    return cfg32, p32, cfg16, cast(p32)


def phase_forward(cfg32, p32, cfg16, p16):
    """flagship-1b forward at [1, 512], kernel path against plain
    attention, bf16 then float32. Returns the main path's launches."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    tokens = torch.randint(0, cfg16.vocab_size, (1, 512), generator=gen,
                           device="cuda")
    main_launches = None
    for cfg, params in ((cfg16, p16), (cfg32, p32)):
        torch.cuda.synchronize()
        flash.launches = 0                    # the main path's run
        logits = forward(params, tokens, cfg)
        torch.cuda.synchronize()
        launches = flash.launches
        require(launches == cfg.n_layers,
                f"{cfg.dtype} forward launched flash_fwd {launches} times, "
                f"expected {cfg.n_layers}")
        if main_launches is None:
            main_launches = launches
        plain = forward(params, tokens, cfg, attn_impl="ref")
        require(bool(torch.isfinite(logits).all()), "non-finite logits")
        top1 = (logits.argmax(-1) == plain.argmax(-1)).float().mean().item()
        diff = (logits.float() - plain.float()).abs().max().item()
        if cfg.dtype == "float32":
            require(torch.allclose(logits, plain, atol=1e-3, rtol=1e-3),
                    f"float32 logits kernel vs plain: max diff {diff}")
        before = flash.launches
        ms = cuda_ms(lambda: forward(params, tokens, cfg), 5)
        require(flash.launches - before == 6 * cfg.n_layers,
                "a timed forward did not launch the kernel once per layer")
        emit({"phase": "forward", "model": "flagship-1b", "dtype": cfg.dtype,
              "tokens": [1, 512], "launches": launches,
              "max_abs_diff_vs_plain": diff, "top1_agreement": top1,
              "ms": ms,
              "plain_ms": cuda_ms(lambda: forward(params, tokens, cfg,
                                                  attn_impl="ref"), 5)})
    return main_launches


def _prompts(vocab):
    gen = torch.Generator().manual_seed(SEED + 2)
    prompts = [torch.randint(0, vocab, (n,), generator=gen).tolist()
               for n in (8, 37, 120, 300)]
    # the sampled request shares 192 tokens (12 blocks of 16) with the
    # 300-token prompt, so its admission maps them from the prefix cache
    sampled = prompts[3][:192] + torch.randint(
        0, vocab, (20,), generator=gen).tolist()
    return prompts, sampled


def _reference_greedy(params, cfg, prompt, max_new):
    """Greedy loop over the port's forward (kernel path), padded to a
    multiple of 128 (causal: padding cannot reach earlier positions).
    Returns the tokens and each step's logits row."""
    seq, rows = list(prompt), []
    for _ in range(max_new):
        n = -(-len(seq) // 128) * 128
        logits = forward(params, [seq + [0] * (n - len(seq))], cfg)
        row = logits[0, len(seq) - 1].float()
        rows.append(row)
        seq.append(int(row.argmax()))
    return seq[len(prompt):], rows


def phase_serving(cfg32, p32, cfg16, p16):
    prompts, sampled_prompt = _prompts(cfg32.vocab_size)
    new = 32
    greedy = SamplingParams(max_new_tokens=new)
    sampling = SamplingParams(max_new_tokens=new, temperature=0.8, top_k=50)
    kw = dict(max_batch=4, block_size=16, max_context=1024, prefill_chunk=64)

    # float32, driven step by step: greedy tokens against the forward loop
    eng = DecodeEngine(p32, cfg32, **kw)
    t0 = time.monotonic()
    outs = eng.generate(prompts, greedy)
    extra = eng.generate([sampled_prompt], sampling)[0]
    f32_seconds = time.monotonic() - t0
    require(len(extra) == new and all(0 <= t < cfg32.vocab_size
                                      for t in extra), "bad sampled tokens")
    ties, compared = [], 0
    for i, (prompt, got) in enumerate(zip(prompts, outs)):
        ref, rows = _reference_greedy(p32, cfg32, prompt, new)
        for j, (a, b) in enumerate(zip(got, ref)):
            if a == b:
                compared += 1
                continue
            la, lb = rows[j][a].item(), rows[j][b].item()
            rel = abs(la - lb) / max(abs(la), abs(lb), 1e-30)
            require(rel < TIE_REL,
                    f"prompt {i} token {j}: engine {a} vs forward {b}, "
                    f"reference logits {la} vs {lb} (rel {rel})")
            ties.append({"prompt": i, "index": j, "engine": a,
                         "forward": b, "rel": rel})
            break                         # stream not compared further
    emit({"phase": "serving", "dtype": "float32", "requests": 5,
          "greedy_tokens_equal": compared, "near_ties": ties,
          "steps": eng.steps, "seconds": f32_seconds,
          "decode_shapes": eng.decode_compiles,
          "fused_shapes": eng.prefill_compiles})
    require(eng.decode_compiles == 1 and eng.prefill_compiles == 1,
            "the engine stepped at more than two shapes")
    del eng

    # bf16 through the scheduler thread, as a replica runs it
    eng = DecodeEngine(p16, cfg16, **kw)
    eng.start()
    try:
        t0 = time.monotonic()
        reqs = [eng.submit(p, greedy) for p in prompts]
        for r in reqs:
            r.wait(600)
        last = eng.submit(sampled_prompt, sampling)
        last.wait(600)
        wall = time.monotonic() - t0
    finally:
        eng.stop(drain=True)
    reqs.append(last)
    tokens = sum(len(r.out_tokens) for r in reqs)
    require(tokens == 5 * new, f"bf16 engine emitted {tokens} tokens")
    require(last.prefix_tokens_reused > 0, "no prefix reuse")
    ttft = sorted(r.first_token_at - r.submitted_at for r in reqs)
    emit({"phase": "serving", "dtype": "bfloat16", "requests": 5,
          "tokens": tokens, "seconds": wall, "tokens_per_s": tokens / wall,
          "ttft_s": ttft, "steps": eng.steps,
          "step_ms": wall / eng.steps * 1e3,
          "prefix_tokens_reused": last.prefix_tokens_reused,
          "cache": eng.cache_stats()})


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    record = phase_kernel()
    cfg32, p32, cfg16, p16 = make_params()
    launches = phase_forward(cfg32, p32, cfg16, p16)
    phase_serving(cfg32, p32, cfg16, p16)
    emit({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "hadoop_tpu_torch/ops/csrc/flash_fwd.cu",
        "replaces": "hadoop_tpu/ops/flash.py:79",
        "launches": launches, "max_abs_err": record["max_abs_err"],
        "ms": record["ms"], "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"], "bound_by": record["bound_by"],
        "library_ms": record["library_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
