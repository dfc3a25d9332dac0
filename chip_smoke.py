#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``hadoop_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout (failing
on any ptxas spill, wgmma serialization or ignored setmaxnreg) and holds
each against its plain PyTorch version (the flash forward, the two flash
backward kernels, also through the autograd Function, the non-causal
ring partial, and AdamW's update and squared norm on flagship-1b's
leaves; bf16 at D 64/128 takes the wgmma kernels, float32 and D 192/256
the FMA ones); runs ring attention at sp 4 on one device against the
causal kernel over the whole sequence; trains flagship-1b at
``bench.py``'s configuration (bf16, batch 4, seq 2048, full remat,
AdamW) for 7 steps through ``make_train_step``, then through
``Trainer`` over a token file on the local disk (an uninterrupted run,
and a crashed run resumed from its checkpoint, whose losses must equal
it), and serves the last checkpoint through ``load_serving_params``,
then over HTTP through ``ServingReplica`` (16 requests from 8 client
threads, their tokens against in-process ``generate``; auth, health,
``/prom``, a drain with a request in flight); runs the flagship-1b forward, also in float16 (which no flash kernel
takes: "auto" runs the plain attention); serves flagship-1b requests through ``DecodeEngine``
(each step shape a CUDA graph), holding the graphs' tokens against the
engine's eager step; checks two float32 SGD steps of the kernel path
against plain attention and against the layer loop that slices each
stacked leaf per layer (bit for bit); runs
the context-parallel prefill of flagship-1b in float32 through the
exact A-B guard (sp 4 and sp 2); and prefills three prompts of
llama3-8b (8192, 8100 and 8000 tokens) at full width and depth with
``ContextParallelPrefiller`` (sp 4 ranks on the one card), holding every
layer's ring attention against the causal kernel on the same inputs,
and its logits and every layer's K/V against the single-device forward.
Weights are random, made from a seeded ``torch.Generator``. Each phase
prints one JSON line; the card's name and power limit (as
``nvidia-smi`` reports them) follow the build lines; the line before the
last lists every ported kernel with its launches on its main path (the
forward for ``flash_fwd``, the 7 training steps for the backward
kernels and ``adamw``/``grad_sq``, one 8192-token llama3-8b CP prefill
for ``flash_fwd_partial``) and on this slice's (``launches_trainer``:
the trainer phase's 12 steps), its error and its times; the last line is
``{"ok": true, "device":
...}``. Any failed check raises, so the script exits non-zero and
prints no result. It needs a CUDA device and exits non-zero without
one. One phase runs alone from Python, after the build, e.g.
``python3 -c 'import chip_smoke as c; c.phase_build(); c.phase_ring()'``.

Peak rates for the bound (``bound_ms``): NVIDIA H100 SXM data sheet,
3.35 TB/s device memory, 989 TFLOP/s dense bf16 on the tensor cores and
67 TFLOP/s float32 outside them (the kernel's float32 path keeps full
float32, so the float32 peak is the one that applies; AdamW's arithmetic
is float32 outside them too).
"""

from __future__ import annotations

import contextlib
import http.client
import json
import math
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import hadoop_tpu_torch.parallel.ring_attention as ring_module
from hadoop_tpu_torch import (DecodeEngine, SamplingParams, forward,
                              get_config, init_params, init_train_state,
                              make_train_step)
import hadoop_tpu_torch.models.decoder as decoder_module
from hadoop_tpu_torch.models.decoder import (final_hidden, forward_hidden,
                                             head_matrix, run_layers_kv)
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.ops import _build, flash, rope_frequencies
from hadoop_tpu_torch.fs import LocalFileSystem
from hadoop_tpu_torch.obs.hbm import device_memory_stats, hbm_ledger
from hadoop_tpu_torch.parallel import MeshPlan, Trainer, adamw_init
from hadoop_tpu_torch.parallel import optimizer
from hadoop_tpu_torch.parallel.checkpoint import list_checkpoints
from hadoop_tpu_torch.parallel.optimizer import tree_leaves, tree_map
from hadoop_tpu_torch.parallel.ring_attention import ring_attention
from hadoop_tpu_torch.serving.loader import load_serving_params
from hadoop_tpu_torch.serving.longctx import (ContextParallelPrefiller,
                                              run_prefill_ab)
from hadoop_tpu_torch.serving.service import ServingReplica
from hadoop_tpu_torch.tracing import global_tracer
from hadoop_tpu_torch.tools.profile_flagship import decoding_engine, trace

MEM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
SEED = 0

# (B, S, Hq, Hkv, D, dtypes, q scale): flagship-1b's forward shape first,
# then its training shape; bf16 at D 64 and 128 takes the wgmma kernels,
# float32 and bf16 at D 192/256 the FMA kernels (D 256 takes 32-row tiles
# in the backward). The last three hold the wgmma kernels at D 128 where
# they could go wrong: Hq/Hkv 1 with a single 128-row tile, Hq/Hkv 4 with
# an odd count of 128-row tiles (the backward's 128-row tiles meet two
# partly masked 64-row tiles each, so an off-by-one tile shows there, as
# at (1, 384, 4, 1, 64)), and q scaled by 8 (scores of large range: the
# forward's running max moves between key tiles, so the register
# accumulators are rescaled; in the backward P is near 1 on a few keys,
# where a wrong lse or exp2 scaling shows). Both phases run every case.
KERNEL_SHAPES = [
    (1, 512, 16, 8, 128, (torch.bfloat16, torch.float32), 1),
    (4, 2048, 16, 8, 128, (torch.bfloat16, torch.float32), 1),
    (2, 256, 4, 2, 64, (torch.bfloat16, torch.float32), 1),
    (1, 384, 4, 1, 64, (torch.bfloat16, torch.float32), 1),
    (1, 128, 2, 1, 64, (torch.float32,), 1),
    (1, 256, 4, 2, 192, (torch.float32,), 1),
    (1, 256, 4, 2, 256, (torch.bfloat16, torch.float32), 1),
    (2, 128, 4, 4, 128, (torch.bfloat16,), 1),
    (1, 384, 8, 2, 128, (torch.bfloat16,), 1),
    (1, 1024, 8, 2, 128, (torch.bfloat16,), 8),
]
# max abs error of the kernel against flash_attention_ref: (O, LSE).
# bf16 rounds P to bf16 before P.V at other places than the plain version
# (per key tile against the running max, not once against the row max:
# 128-key tiles in the wgmma kernel, 64 in the FMA kernel)
TOLERANCE = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
# max abs error of dq, dk, dv against flash_attention_bwd_ref, relative to
# the reference's max |grad|. float32: the same products summed in another
# order (some 1e-6 expected). bf16: the outputs are rounded to bf16 once (an
# ulp is up to 2**-7 of a value), and a P or dS value near a rounding
# boundary may round the other way, because Q K^T and dO V^T are summed in
# another order before P and dS are rounded to bf16.
BWD_TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# float32 SGD steps, kernel path against plain attention: per parameter
# leaf, max |update difference| over max |update|. The kernels and the
# plain attention sum in another order, and the embedding's backward
# (index_add) sums in nondeterministic order: some 1e-5 for the matrices.
# The norm weights' gradients are sums over every token with heavy
# cancellation, which magnifies that relative error (up to 9.1e-4 seen
# on an H100).
PARITY_TOL = 1e-2
TRAIN = dict(batch=4, seq=2048, warmup=2, timed=5, lr=3e-4, remat="full")
# (B, Sq, Skv, Hq, Hkv, D, q scale) of the non-causal partial: llama3-8b's
# per-rank ring shape at sp 4 (8192 tokens, the 4 ranks folded into the
# batch) first, then flagship-1b's at sp 4 ([2048]), one Sq < Skv case and
# one at D 64; then Hq/Hkv 1 with one 128-row tile, Hq/Hkv 4 with Sq > Skv
# and an odd count of tiles, Sq < Skv the other way round, and q scaled by
# 8 (scores of large range); each in bf16 and float32
PARTIAL_SHAPES = [(4, 2048, 2048, 32, 8, 128, 1), (4, 512, 512, 16, 8, 128, 1),
                  (2, 256, 512, 8, 2, 128, 1), (2, 256, 256, 4, 2, 64, 1),
                  (2, 128, 128, 4, 4, 128, 1), (1, 384, 128, 8, 2, 128, 1),
                  (1, 128, 384, 8, 2, 128, 1), (1, 512, 1024, 8, 2, 128, 8)]
# the partial against its plain version: max |dO| over max |O|, and max
# |d lse|. bf16: P is rounded per key tile against the running max in
# the kernel, once against the row max in the plain version (as for the
# forward); float32: the same products summed in another order
PARTIAL_TOLERANCE = {torch.bfloat16: (2e-2, 1e-2),
                     torch.float32: (1e-4, 1e-4)}
# ring attention at sp 4 against the causal kernel over the whole
# sequence, (B, S, Hq, Hkv, D, dtype); every layer's ring attention in
# the llama3-8b CP prefill is held the same way. Rank 0's rows must be
# equal bit for bit: its diagonal runs the same kernel tiles, and every
# later chunk merges into them with weight exactly 1 and 0. The later
# rows, the ones the non-causal partials and the merge reach, are held
# row by row: max |dO| over max |O| of that row. bf16: each partial's O
# is rounded to bf16 before the float32 merge and once more after it,
# where the single kernel rounds once (half an ulp is up to 2**-8 of a
# value), and P is rounded against other running maxima: up to about two
# ulps of the row's max, 2**-6. Seen on an H100: 2**-7 at most, here and
# at every layer of the three llama3-8b prompts. A dropped or
# mis-weighted 64-key tile moves a row by some sqrt(64 / keys), 9% at
# 8192 keys.
RING_CASES = [(1, 8192, 32, 8, 128, torch.bfloat16),
              (1, 1024, 4, 2, 64, torch.float32)]
RING_ROW_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
RING_SP = 4
# llama3-8b CP prefill: sp 4 ranks, 16-token blocks; three prompts of
# random tokens, each from its own seed: 8192 tokens (no padding; the
# main path's counted and timed run), 8100 (padding and a 4-token tail
# block) and 8000 (padding, no tail). Rank 0's K/V must equal the
# single-device forward's bit for bit (the same GEMMs and kernel tiles).
# The logits and every layer's K/V from position S/sp on are held
# against the single-device forward (the causal kernel at S 8192) by way
# of a calibration: the same forward with plain attention, which lies
# 1.8e-2 to 2.4e-2 of max |ref| from the kernel forward on this metric
# (bf16 noise through 32 layers; each value is a few ulps of the
# largest). The CP prefill may lie at most ``cal_factor`` times as far as
# the calibration, value by value (logits, and K and V per layer). Seen
# on an H100 over the three prompts: 0.75 to 1.33 times.
LONGCTX = dict(model="llama3-8b", sp=4, block=16, tokens=(8192, 8100, 8000),
               cal_factor=2.0, timed=3)
EXACT_SP = (4, 2)       # flagship-1b float32 through run_prefill_ab(exact)
TIE_REL = 1e-4          # near-tie rule for greedy token comparisons
# adamw.cu against its plain version on flagship-1b's leaves (bf16, random
# gradients and moments, step 3, the clip active). The kernel rounds every
# float32 operation once in the reference's order; PyTorch's CUDA ops,
# which the plain version runs, contract m + (1 - b1)·g into an fma and
# divide by a Python scalar as a multiply by its reciprocal. So a moment
# may differ by an ulp or two of float32 (max |d| over max |ref| at most
# ADAMW_MOMENT_TOL), and a parameter by one ulp of bf16 where the two
# float32 values lie on either side of a rounding boundary (an ulp at the
# larger of the parameter's magnitudes before and after the step: where
# the step nearly cancels it, the two results may straddle zero): at most
# ADAMW_P_SHARE of the elements. The squared norm sums in another order
# (the kernel's fixed tree against PyTorch's): GRAD_SQ_TOL relative.
ADAMW = dict(count=3, lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
             grad_scale=1e-3)
ADAMW_MOMENT_TOL = 1e-6
ADAMW_P_SHARE = 1e-4
GRAD_SQ_TOL = 1e-5
ADAMW_FLOPS = 17        # float32 operations per element of the update
# The float16 flagship-1b forward through "auto" (plain attention: no
# kernel is built for float16) against the float32 kernel forward: max
# |d logits| over max |logits|. float16 keeps 11 significant bits, so each
# rounded op adds up to 2**-11 of its value, over 18 layers of about ten
# rounded ops each.
FP16_TOL = 2e-2
# The f32 SGD parity losses of PR 5's run on the H100 (PERF.md), for the
# record: the unbound layers leave them as they were.
PR5_PARITY_LOSSES = [10.879134178161621, 9.858037948608398]
SERVE_KW = dict(max_batch=4, block_size=16, max_context=1024,
                prefill_chunk=64)
# The trainer phase: flagship-1b through Trainer at TRAIN's shape, on the
# port's LocalFileSystem in a temporary directory. A token file of 4.5
# batches (so the stream wraps within the run), an uninterrupted run of
# ``steps``, a run that crashes after ``crash_at`` (its interval save at
# that step on the background writer, fenced at train()'s exit) and one
# that resumes from it, trains to ``steps`` and saves with ``keep`` 1. The
# resumed losses must equal the uninterrupted run's within ``loss_rtol``
# (the reference's gate, tests/test_trainer_dfs.py). The loader phase
# serves the last checkpoint: greedy tokens for ``prompts`` prompts of
# ``max_new`` tokens, against an engine on the resumed trainer's
# parameters.
TRAINER = dict(steps=6, crash_at=3, file_batches=4.5, loss_rtol=1e-6,
               prompts=2, max_new=16, io_workers=4)
# The door phase: ServingReplica (QoS on, an auth secret) on the step-6
# checkpoint, flagship-1b bf16 at SERVE_KW's sizes on 127.0.0.1:0. Its
# ``requests`` greedy requests of ``max_new`` tokens (_door_prompts: the
# serving phase's five, then more of the same mixed lengths) go out from
# ``clients`` threads, each its own tenant, one request streamed; the
# profiled window sends one request from each client; the poller round
# repeats the requests with a thread reading /v1/health every
# ``poll_s`` seconds beside them.
DOOR = dict(requests=16, clients=8, max_new=64, secret="chip-smoke",
            poll_s=0.005)


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


def _bound(nbytes, flops, dtype):
    """(bound_ms, bound_by, flops): bytes over the memory rate against
    operations over the peak rate for the dtype, whichever is longer."""
    t_mem, t_ops = nbytes / MEM_BYTES_PER_S, flops / PEAK_FLOPS[dtype]
    return (max(t_mem, t_ops) * 1e3,
            "bytes" if t_mem >= t_ops else "operations", flops)


def add_rates(rec, bound):
    """Put a timed record's bound beside its time: bound_ms, bound_by,
    achieved TFLOP/s and the share of the bound (bound_ms / ms)."""
    rec["bound_ms"], rec["bound_by"], flops = bound
    rec["tflops"] = flops / (rec["ms"] * 1e-3) / 1e12
    rec["bound_share"] = rec["bound_ms"] / rec["ms"]
    return rec


def flash_bound(b, s, hq, hkv, d, dtype):
    """(bound_ms, bound_by, flops): each input read once and each output
    written once over the memory rate, against the causal work (QK^T and
    PV over the S(S+1)/2 visible pairs) over the peak rate for the
    dtype."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * b * s * (2 * hq + 2 * hkv) * d + 4 * b * hq * s
    return _bound(nbytes, 4 * d * b * hq * s * (s + 1) / 2, dtype)


def bwd_bound(b, s, hq, hkv, d, dtype, kernel):
    """(bound_ms, bound_by, flops) of one backward kernel: inputs read once and
    outputs written once (dkv: q, k, v, dO, lse, delta → dK, dV; dq: q, k,
    v, O, dO, lse → dQ, delta) against 8·D FLOPs (dkv: QKᵀ, dO·Vᵀ, Pᵀ·dO,
    dSᵀ·Q) or 6·D (dq: QKᵀ, dO·Vᵀ, dS·K) per visible (q, k) pair and
    query head."""
    elt = torch.finfo(dtype).bits // 8
    q_bytes, kv_bytes = elt * b * s * hq * d, elt * b * s * hkv * d
    row_bytes = 4 * b * hq * s
    pairs = b * hq * s * (s + 1) / 2
    if kernel == "dkv":
        nbytes, flops = 2 * q_bytes + 4 * kv_bytes + 2 * row_bytes, 8 * d * pairs
    else:
        nbytes, flops = 4 * q_bytes + 2 * kv_bytes + 2 * row_bytes, 6 * d * pairs
    return _bound(nbytes, flops, dtype)


def partial_bound(b, sq, skv, hq, hkv, d, dtype):
    """(bound_ms, bound_by, flops) of the non-causal partial: q, k, v read
    once, O (float32) and lse written once, against 4·D FLOPs (QKᵀ and
    PV) per (q, k) pair and query head."""
    elt = torch.finfo(dtype).bits // 8
    nbytes = elt * b * d * (sq * hq + 2 * skv * hkv) + 4 * b * sq * hq * (d + 1)
    return _bound(nbytes, 4 * b * hq * sq * skv * d, dtype)


def counts():
    return (flash.launches, flash.launches_bwd_dq, flash.launches_bwd_dkv,
            flash.launches_partial)


def optimizer_counts():
    return optimizer.launches, optimizer.launches_grad_sq


def zero_counts():
    flash.launches = flash.launches_bwd_dq = flash.launches_bwd_dkv = 0
    flash.launches_partial = 0
    optimizer.launches = optimizer.launches_grad_sq = 0


# ------------------------------------------------------------------ phases

KERNEL_SOURCES = ["flash_fwd", "flash_bwd", "adamw"]


def ptxas_report(log):
    """Per kernel entry of one nvcc -Xptxas -v log: registers, spill
    bytes and static shared memory; and the ptxas lines that report wgmma
    serialization, spills or an ignored setmaxnreg."""
    entries, name, bad = [], None, []
    for line in log.splitlines():
        hit = re.search(r"(?:Compiling entry function|Function properties "
                        r"for) '?([\w$]+)'?", line)
        if hit:
            if hit.group(1) != name:
                name = hit.group(1)
                entries.append({"kernel": name})
            continue
        if re.search(r"wgmma.*serializ|setmaxnreg ignored", line, re.I):
            bad.append(line.strip())
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill and entries:
            entries[-1]["spill_bytes"] = [int(spill.group(1)),
                                          int(spill.group(2))]
            if any(entries[-1]["spill_bytes"]):
                bad.append(f"{entries[-1]['kernel']}: {line.strip()}")
        regs = re.search(r"Used (\d+) registers", line)
        if regs and entries:
            entries[-1]["registers"] = int(regs.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            entries[-1]["static_smem"] = int(smem.group(1)) if smem else 0
    return entries, bad


def phase_build():
    t0 = time.monotonic()
    _build.build(KERNEL_SOURCES)        # one nvcc per source, in parallel
    for name in KERNEL_SOURCES:
        _build.load(name)
    seconds = time.monotonic() - t0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    problems = []
    for name in KERNEL_SOURCES:
        entries, bad = ptxas_report(_build.build_logs.get(name, ""))
        problems += bad
        emit({"phase": "build", "library": name, "seconds": seconds,
              "kernels": entries, "ptxas_problems": bad})
    # dynamic shared memory per block of the kernels each (D, dtype) takes
    for name in ("flash_fwd", "flash_bwd"):
        smem = _build.entry(f"htpu_{name}_smem")
        emit({"phase": "build", "library": name, "dynamic_smem_bytes": {
            f"{dt} D{d}": smem(d, code) for dt, code in (("float32", 0),
                                                        ("bfloat16", 1))
            for d in flash._HEAD_DIMS}})
    print(smi, flush=True)
    require(not problems, f"ptxas reports: {problems}")
    return smi


def phase_kernel():
    """Kernel against its plain version at every listed shape; returns
    the flagship bf16 record for the kernels line."""
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flagship = None
    for b, s, hq, hkv, d, dtypes, q_mul in KERNEL_SHAPES:
        for dtype in dtypes:
            q = (q_mul * torch.randn(b, s, hq, d, generator=gen,
                                     device="cuda")).to(dtype)
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
                "q_scale": q_mul,
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
            add_rates(rec, flash_bound(b, s, hq, hkv, d, dtype))
            emit(rec)
            require(err_o <= tol_o and err_lse <= tol_lse,
                    f"flash_fwd disagrees with its plain version at "
                    f"{rec['shape']} {dtype}: O {err_o}, LSE {err_lse}")
            if flagship is None:
                flagship = rec
            del q, k, v, o, lse, o_ref, lse_ref
    return flagship


def sdpa_backward_ms(q, k, v, do, scale):
    """SDPA's backward alone (forward + backward minus forward), a
    yardstick only: the port never calls it."""
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2)

    def fwd():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              scale=scale, enable_gqa=True)

    both = cuda_ms(lambda: torch.autograd.grad(fwd(), (qt, kt, vt), dot), 10)
    return both - cuda_ms(fwd, 10)


def phase_backward():
    """Both backward kernels against their plain version at every listed
    shape, and once through ``FlashAttention`` with autograd; returns the
    record at the flagship training shape in bf16."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    training = None
    for b, s, hq, hkv, d, dtypes, q_mul in KERNEL_SHAPES:
        for dtype in dtypes:
            q, do = ((m * torch.randn(b, s, hq, d, generator=gen,
                                      device="cuda")).to(dtype)
                     for m in (q_mul, 1))
            k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda")
                    .to(dtype) for _ in range(2))
            scale = d ** -0.5
            o, lse = flash.flash_forward(q, k, v, scale)
            got = flash.flash_backward(q, k, v, o, lse, do, scale)
            want = flash.flash_attention_bwd_ref(q, k, v, o, lse, do, scale)
            torch.cuda.synchronize()
            err = {n: (g.float() - w.float()).abs().max().item()
                   for n, g, w in zip(("dq", "dk", "dv"), got, want)}
            rel = {n: err[n] / w.float().abs().max().item()
                   for n, w in zip(("dq", "dk", "dv"), want)}
            tol = BWD_TOLERANCE[dtype]
            _, delta = flash._launch_bwd_dq(q, k, v, o, lse, do, scale)
            rec = {"phase": "backward", "shape": [b, s, hq, hkv, d],
                   "dtype": str(dtype), "q_scale": q_mul,
                   "max_abs_err": err,
                   "rel_err": rel, "tol": tol,
                   "plain_ms": cuda_ms(lambda: flash.flash_attention_bwd_ref(
                       q, k, v, o, lse, do, scale), 3),
                   "library_ms": sdpa_backward_ms(q, k, v, do, scale)}
            for name, fn in (
                    ("dq", lambda: flash._launch_bwd_dq(
                        q, k, v, o, lse, do, scale)),
                    ("dkv", lambda: flash._launch_bwd_dkv(
                        q, k, v, lse, delta, do, scale))):
                rec[name] = add_rates({"ms": cuda_ms(fn, 10)}, bwd_bound(
                    b, s, hq, hkv, d, dtype, name))
            rec["dq"]["max_abs_err"] = err["dq"]
            rec["dkv"]["max_abs_err"] = max(err["dk"], err["dv"])
            emit(rec)
            require(all(r <= tol for r in rel.values()),
                    f"flash backward disagrees with its plain version at "
                    f"{rec['shape']} {dtype}: {rel} (tolerance {tol})")
            if (b, s, dtype) == (TRAIN["batch"], TRAIN["seq"],
                                 torch.bfloat16):
                check_function(q, k, v, do, scale, o, got)
                emit({"phase": "gqa_rounding", "shape": rec["shape"],
                      "rel_diff": gqa_rounding(q, k, v, o, lse, do, scale,
                                               got)})
                training = rec
            del q, k, v, do, o, lse, got, want, delta
    require(training is not None, "no backward record at the training shape")
    return training


def gqa_rounding(q, k, v, o, lse, do, scale, grads):
    """How far the kernels' dK/dV (each KV head's query-head group summed
    in float32, rounded once) lie from the reference's order (each query
    head's dK/dV rounded to the input dtype, then summed): max |diff| over
    max |dK| and |dV|. The plain version on K/V repeated per query head
    gives the per-head rounded gradients."""
    b, s, hkv, d = k.shape
    n_rep = q.shape[2] // hkv
    per_head = flash.flash_attention_bwd_ref(
        q, k.repeat_interleave(n_rep, dim=2),
        v.repeat_interleave(n_rep, dim=2), o, lse, do, scale)[1:]
    out = {}
    for name, got, heads in zip(("dk", "dv"), grads[1:], per_head):
        ref_order = heads.float().reshape(b, s, hkv, n_rep, d).sum(3) \
            .to(got.dtype).float()
        out[name] = ((got.float() - ref_order).abs().max()
                     / ref_order.abs().max()).item()
    return out


def check_function(q, k, v, do, scale, o, grads):
    """``flash_attention`` on inputs that require grad goes through
    ``FlashAttention``: one launch of each kernel, and the same output
    and gradients as the bare kernels."""
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    before = counts()
    out = flash.flash_attention(*leaves, scale)
    auto = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    delta = tuple(a - b for a, b in zip(counts(), before))[:3]
    require(delta == (1, 1, 1),
            f"FlashAttention launched (fwd, dq, dkv) {delta} times")
    require(torch.equal(out, o) and all(
        torch.equal(a, g) for a, g in zip(auto, grads)),
        "FlashAttention's output or gradients differ from the kernels'")
    emit({"phase": "autograd_function", "launches": list(delta),
          "equal_to_kernels": True})


def phase_train():
    """flagship-1b at bench.py's training configuration, through
    ``make_train_step``: 2 warm-up and 5 timed steps on one seeded batch.
    Returns the launches of the whole run (fwd, dq, dkv, adamw,
    grad_sq)."""
    cfg = get_config("flagship-1b")
    params, opt = init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in tree_leaves(params))
    batch, seq = TRAIN["batch"], TRAIN["seq"]
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(SEED + 3))
    targets = torch.roll(tokens, -1, dims=1)
    step = make_train_step(cfg, MeshPlan(), lr=TRAIN["lr"],
                           remat=TRAIN["remat"])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms, per_step = [], [], []
    zero_counts()                             # the main path's run
    for _ in range(TRAIN["warmup"] + TRAIN["timed"]):
        before = counts()[:3] + optimizer_counts()
        start.record()
        params, opt, metrics = step(params, opt, tokens, targets)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(metrics["loss"].item())
        per_step.append([a - b for a, b in zip(
            counts()[:3] + optimizer_counts(), before)])
    launches = counts()[:3] + optimizer_counts()
    peak = torch.cuda.max_memory_allocated()
    grad_norm = metrics["grad_norm"].item()
    timed_ms = sum(step_ms[TRAIN["warmup"]:]) / TRAIN["timed"]
    tokens_per_s = batch * seq / (timed_ms / 1e3)
    emit({"phase": "train", "model": "flagship-1b", "dtype": cfg.dtype,
          "tokens": [batch, seq], "remat": TRAIN["remat"],
          "optimizer": "adamw", "lr": TRAIN["lr"], "params": n_params,
          "losses": losses, "grad_norm": grad_norm, "step_ms": step_ms,
          "timed_step_ms": timed_ms, "tokens_per_s": tokens_per_s,
          "mfu": _mfu(cfg, n_params, tokens_per_s, seq),
          "peak_memory_bytes": peak,
          "launches_per_step_fwd_dq_dkv_adamw_grad_sq": per_step})
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    require(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
            f"first loss {losses[0]}, ln(V) {math.log(cfg.vocab_size)}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    n_leaves = len(tree_leaves(params))
    want = [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers, n_leaves,
            n_leaves + 1]
    require(all(c == want for c in per_step),
            f"launches per step (fwd, dq, dkv, adamw, grad_sq) {per_step}, "
            f"expected {want}")
    del params, opt, step
    return launches, {"timed_step_ms": timed_ms,
                      "tokens_per_s": tokens_per_s}


def _mfu(cfg, n_params, tokens_per_s, seq):
    """bench.py's utilisation: 6N + attention FLOPs per token over peak."""
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * seq * \
        cfg.d_model // 2
    return tokens_per_s * flops_per_token / PEAK_FLOPS[torch.bfloat16]


def _counted_steps(trainer, log):
    """Wrap ``trainer``'s step so each call appends its launches (fwd, dq,
    dkv, adamw, grad_sq) and a pair of CUDA events around it to ``log``;
    the run itself is unchanged."""
    step = trainer.step_fn

    def counted(*args):
        before = counts()[:3] + optimizer_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args)
        end.record()
        log.append(([a - b for a, b in zip(counts()[:3] + optimizer_counts(),
                                           before)], start, end))
        return out

    trainer.step_fn = counted


def _anatomy(trainer):
    """The trainer's step anatomy: means in ms, and counts."""
    m = trainer.step_metrics
    rec = {}
    for name in ("data_wait", "step_wall", "ckpt_snapshot", "ckpt_write",
                 "ckpt_fence"):
        snap = getattr(m, name).snapshot()
        rec[name] = {"count": snap["num_ops"],
                     "mean_ms": snap["avg_time"] * 1e3,
                     "max_ms": snap["max_time"] * 1e3}
    return rec


def _ledger_bytes():
    comps = hbm_ledger().report()["components"]
    return {"params": comps.get("params", 0),
            "opt_state": comps.get("opt_state", 0),
            "memory_allocated": torch.cuda.memory_allocated()}


def phase_trainer(train_rec, fs, root):
    """flagship-1b through ``Trainer`` (this slice's main path), on ``fs``
    under the directory ``root``: the uninterrupted run, the crashed run
    and the resumed one, each step's launches held to the train phase's
    counts, the resumed losses to the uninterrupted ones. Returns the
    launches of the three runs (fwd, dq, dkv, adamw, grad_sq) and the
    resumed trainer's parameters on the host."""
    cfg = get_config("flagship-1b")
    batch, seq = TRAIN["batch"], TRAIN["seq"]
    n_params = sum(
        p.numel() for p in tree_leaves(init_params(cfg, torch.Generator(),
                                                   device="meta")))
    elt = torch.finfo(cfg.torch_dtype).bits // 8
    # parameters, two float32 moments, count and data_pos
    ckpt_bytes = n_params * (elt + 4 + 4) + 4 + 8
    # two checkpoints coexist while the step-6 save is written; the
    # snapshot of one lies in host memory
    free_disk = shutil.disk_usage(root).free
    require(free_disk > 2.2 * ckpt_bytes,
            f"{free_disk} B free under {root}: two checkpoints of "
            f"{ckpt_bytes} B do not fit")
    mem_avail = int(re.search(r"MemAvailable:\s+(\d+) kB", open(
        "/proc/meminfo").read()).group(1)) * 1024
    require(mem_avail > 2 * ckpt_bytes,
            f"{mem_avail} B of host memory available for snapshots of "
            f"{ckpt_bytes} B")
    n_tokens = int(TRAINER["file_batches"] * batch * (seq + 1))
    tokens = torch.randint(0, cfg.vocab_size, (n_tokens,),
                           generator=torch.Generator().manual_seed(SEED + 4))
    data = f"{root}/tokens.bin"
    fs.write_all(data, tokens.numpy().astype(np.uint16).tobytes())

    def trainer(path, **kw):
        return Trainer(cfg, MeshPlan(), fs, data, f"{root}/{path}",
                       batch=batch, lr=TRAIN["lr"], remat=TRAIN["remat"],
                       seed=SEED, **kw)

    steps, crash_at = TRAINER["steps"], TRAINER["crash_at"]
    per_step = []
    zero_counts()                             # the main path's run
    u = trainer("uninterrupted", ckpt_interval=0)
    _counted_steps(u, per_step)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    losses = u.train(steps)
    train_wall = time.monotonic() - t0
    step_ms = [s.elapsed_time(e) for _, s, e in per_step]
    timed_ms = sum(step_ms[1:]) / (steps - 1)
    u_anatomy = _anatomy(u)
    u.close()
    del u

    a = trainer("resumed", ckpt_interval=crash_at, keep=1)
    _counted_steps(a, per_step)
    t0 = time.monotonic()
    crashed = a.train(crash_at)             # the exit fence included
    crashed_wall = time.monotonic() - t0
    require(list_checkpoints(fs, f"{root}/resumed") == [crash_at],
            "the interval save is not durable at train()'s exit")
    a_anatomy = _anatomy(a)
    a.close()
    del a                                     # as a crash leaves it

    b = trainer("resumed", ckpt_interval=0, keep=1)
    _counted_steps(b, per_step)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    restored = b.try_restore()
    torch.cuda.synchronize()
    restore_ms = (time.monotonic() - t0) * 1e3
    require(restored and b.step == crash_at,
            f"try_restore: {restored}, step {b.step}")
    resumed = b.train(steps - crash_at)
    ledger = _ledger_bytes()
    t0 = time.monotonic()
    b.save()
    save_ms = (time.monotonic() - t0) * 1e3
    launches = counts()[:3] + optimizer_counts()
    b_anatomy = _anatomy(b)
    require(list_checkpoints(fs, f"{root}/resumed") == [steps],
            "retention kept more than the newest checkpoint")
    step_dir = f"{root}/resumed/step_{steps:012d}"
    sizes = {st.path.rsplit("/", 1)[-1]: st.length
             for st in fs.list_status(step_dir)}
    shard_bytes = sum(n for f, n in sizes.items() if f != "manifest.json")
    host = tree_map(lambda t: t.cpu(), b.params)
    b.close()
    del b

    tokens_per_s = batch * seq / (timed_ms / 1e3)
    want_losses = losses[crash_at:]
    rel = [abs(g - w) / abs(w) for g, w in zip(resumed, want_losses)]
    n_leaves = len(tree_leaves(host))
    want = [2 * cfg.n_layers, cfg.n_layers, cfg.n_layers, n_leaves,
            n_leaves + 1]
    emit({"phase": "trainer", "model": "flagship-1b", "dtype": cfg.dtype,
          "tokens": [batch, seq], "remat": TRAIN["remat"],
          "optimizer": "adamw", "params": n_params,
          "data_tokens": n_tokens,
          "losses_uninterrupted": losses, "losses_crashed": crashed,
          "losses_resumed": resumed, "resumed_rel_err": rel,
          "resumed_bit_equal": resumed == want_losses,
          "step_ms": step_ms, "timed_step_ms": timed_ms,
          "tokens_per_s": tokens_per_s,
          "mfu": _mfu(cfg, n_params, tokens_per_s, seq),
          "train_wall_ms_per_step": train_wall * 1e3 / steps,
          "crashed_train_wall_ms": crashed_wall * 1e3,
          "bare_train_phase": {"timed_step_ms": train_rec["timed_step_ms"],
                               "tokens_per_s": train_rec["tokens_per_s"],
                               "mfu": _mfu(cfg, n_params,
                                           train_rec["tokens_per_s"], seq)},
          "anatomy": {"uninterrupted": u_anatomy, "crashed": a_anatomy,
                      "resumed": b_anatomy},
          "restore_ms": restore_ms, "explicit_save_ms": save_ms,
          "checkpoint_shard_bytes": shard_bytes,
          "checkpoint_manifest_bytes": sizes.get("manifest.json"),
          "checkpoint_files": len(sizes), "hbm_ledger_bytes": ledger,
          "free_disk_bytes": free_disk, "host_mem_available_bytes":
              mem_avail,
          "launches_per_step_fwd_dq_dkv_adamw_grad_sq":
              [c for c, _, _ in per_step]})
    require(len(losses) == steps and len(crashed) == crash_at and
            len(resumed) == steps - crash_at, "steps lost")
    require(all(math.isfinite(x) for x in losses + crashed + resumed),
            "non-finite loss")
    require(max(abs(g - w) / abs(w) for g, w in zip(crashed, losses)) <=
            TRAINER["loss_rtol"], "the crashed run left the curve")
    require(max(rel) <= TRAINER["loss_rtol"],
            f"resumed losses {resumed} vs {want_losses}")
    require(all(c == want for c, _, _ in per_step),
            f"launches per step (fwd, dq, dkv, adamw, grad_sq), expected "
            f"{want}")
    require(len(per_step) == 2 * steps, f"{len(per_step)} steps counted")
    require(shard_bytes == ckpt_bytes,
            f"checkpoint shards {shard_bytes} B, expected {ckpt_bytes}")
    require(ledger["params"] == elt * n_params and
            ledger["opt_state"] == 8 * n_params, f"ledger {ledger}")
    return launches, host


def phase_loader(fs, root, host):
    """The step-6 checkpoint through ``load_serving_params`` into a bf16
    ``DecodeEngine``: the parameters bit-equal to the resumed trainer's,
    and the greedy tokens of two prompts equal to an engine's on those
    parameters."""
    cfg = get_config("flagship-1b")
    torch.cuda.synchronize()
    t0 = time.monotonic()
    params, step = load_serving_params(fs, f"{root}/resumed", cfg,
                                       io_workers=TRAINER["io_workers"])
    torch.cuda.synchronize()
    load_ms = (time.monotonic() - t0) * 1e3
    require(step == TRAINER["steps"], f"loaded step {step}")
    unequal = [i for i, (a, b) in enumerate(zip(tree_leaves(params),
                                                tree_leaves(host)))
               if a.dtype != b.dtype or not torch.equal(a.cpu(), b)]
    prompts = _prompts(cfg.vocab_size)[0][1:1 + TRAINER["prompts"]]
    greedy = SamplingParams(max_new_tokens=TRAINER["max_new"])
    tokens = []
    for tree in (params, tree_map(lambda t: t.cuda(), host)):
        eng = DecodeEngine(tree, cfg, **SERVE_KW)
        tokens.append(eng.generate(prompts, greedy))
        eng.stop()
    emit({"phase": "loader", "model": "flagship-1b", "step": step,
          "load_ms": load_ms, "io_workers": TRAINER["io_workers"],
          "params_bit_equal": not unequal,
          "prompt_tokens": [len(p) for p in prompts],
          "tokens_loaded": tokens[0], "tokens_in_memory": tokens[1],
          "tokens_equal": tokens[0] == tokens[1]})
    require(not unequal, f"leaves {unequal} differ from the trainer's")
    require(tokens[0] == tokens[1], "greedy tokens differ")


def _door_prompts(vocab):
    """DOOR["requests"] prompts: the serving phase's four and its
    prefix-sharing one, then more at the same lengths (8, 37, 120, 300)."""
    prompts, sampled = _prompts(vocab)
    gen = torch.Generator().manual_seed(SEED + 12)
    lengths = [8, 37, 120, 300] * DOOR["requests"]
    more = [torch.randint(0, vocab, (n,), generator=gen).tolist()
            for n in lengths[:DOOR["requests"] - 5]]
    return prompts + [sampled] + more


def _http(port, method, path, payload=None):
    """(status, body bytes) of one request to the door on 127.0.0.1."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request(method, path, body=None if payload is None
                     else json.dumps(payload).encode())
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def _door_round(port, prompts, stream=()):
    """Send ``prompts`` through the door from DOOR["clients"] threads
    (client c sends prompts c, c + clients, ... in turn, as tenant
    ``client<c>``), the indices in ``stream`` streamed. Returns the tokens
    per prompt, the streamed lines per streamed index and the wall
    seconds from the first send to the last answer."""
    tokens, lines = [None] * len(prompts), {}
    errors = []

    def client(c):
        for i in range(c, len(prompts), DOOR["clients"]):
            body = {"tokens": prompts[i], "max_new_tokens": DOOR["max_new"],
                    "stream": i in stream}
            status, out = _http(port, "POST",
                                f"/v1/generate?user.name=client{c}", body)
            if status != 200:
                errors.append((i, status, out[:200]))
                continue
            if i in stream:
                lines[i] = [json.loads(x) for x in out.splitlines() if x]
                tokens[i] = lines[i][-1].get("tokens")
            else:
                tokens[i] = json.loads(out)["tokens"]

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(DOOR["clients"])]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.monotonic() - t0
    require(not errors and not any(t.is_alive() for t in threads),
            f"door requests failed: {errors}")
    return tokens, lines, wall


def _device_window(fn):
    """Run ``fn`` under ``torch.profiler`` (every thread: the door's
    kernels are launched from the engine's scheduler thread). Returns the
    wall ms, the summed device ms of the CUDA kernels and the idle share."""
    cfg = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 experimental_config=cfg) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    device_ms = sum(
        e.self_device_time_total for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
        and not getattr(e, "is_user_annotation", False)) / 1e3
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "idle_share": 1.0 - device_ms / wall_ms}


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def phase_door(fs, root):
    """The step-6 checkpoint served over HTTP by ``ServingReplica`` (this
    slice's main path): auth (401 without a credential), DOOR["requests"]
    greedy requests from DOOR["clients"] threads, one streamed, whose
    tokens must equal the same requests through in-process ``generate``
    on the replica's parameters; /v1/health and /prom; both step shapes
    captured once; a profiled window's idle share; a round beside a
    /v1/health poller (the HBM ledger reads the allocator's stats from
    the handler thread) against one without; then a drain with a request
    in flight: 503 for new work, the held request finished, and
    ``drain_complete``. TTFT is the engine's ``serving.first_token``
    span (submit to the first token on the host, queue wait included)."""
    cfg = get_config("flagship-1b")
    conf = Configuration()
    for key, value in (("serving.http.auth.secret", DOOR["secret"]),
                       ("serving.max.batch", SERVE_KW["max_batch"]),
                       ("serving.kv.block.size", SERVE_KW["block_size"]),
                       ("serving.max.context", SERVE_KW["max_context"]),
                       ("serving.prefill.chunk", SERVE_KW["prefill_chunk"]),
                       ("serving.loader.io.workers", TRAINER["io_workers"])):
        conf.set(key, value)
    replica = ServingReplica(conf, name="chip-smoke", preset="flagship-1b",
                             checkpoint=f"{root}/resumed", fs=fs)
    eng = replica.engine
    prompts = _door_prompts(cfg.vocab_size)
    ttfts, collecting = [], [False]

    def on_span(span):
        if collecting[0] and span.name == "serving.first_token":
            ttfts.append(float(span.kv["ttft_s"]))

    tracer = global_tracer()
    tracer.add_receiver(on_span)
    replica.start()
    port = replica.server.port
    try:
        unauth, _ = _http(port, "POST", "/v1/generate",
                          {"tokens": [1, 2], "max_new_tokens": 2})
        # both step shapes captured before the clock starts
        warm, _ = _http(port, "POST", "/v1/generate?user.name=warm",
                        {"tokens": [1], "max_new_tokens": 2})
        require(unauth == 401 and warm == 200,
                f"door answered {unauth} without a credential, {warm} "
                f"with one")
        collecting[0] = True
        tokens, lines, wall = _door_round(port, prompts, stream={3})
        collecting[0] = False
        door_ttft = list(ttfts)
        n_tokens = sum(len(t) for t in tokens)
        streamed = lines[3]
        health_status, health = _http(port, "GET", "/v1/health")
        health = json.loads(health)
        prom_status, prom = _http(port, "GET", "/prom")
        window = _device_window(lambda: _door_round(
            port, prompts[:DOOR["clients"]]))

        def step_ms(fn):
            eng.metrics.decode_step.snapshot(reset=True)
            fn()
            snap = eng.metrics.decode_step.snapshot(reset=True)
            return snap["decode_step_avg_time"] * 1e3

        polls, stop = [], threading.Event()

        def poller():
            while not stop.wait(DOOR["poll_s"]):
                t0 = time.perf_counter()
                status, _ = _http(port, "GET", "/v1/health")
                polls.append((status, time.perf_counter() - t0))

        t0 = time.perf_counter()
        for _ in range(200):
            device_memory_stats()
        stats_ms = (time.perf_counter() - t0) / 200 * 1e3
        quiet_ms = step_ms(lambda: _door_round(port, prompts))
        th = threading.Thread(target=poller)
        th.start()
        try:
            polled_ms = step_ms(lambda: _door_round(port, prompts))
        finally:
            stop.set()
            th.join(timeout=60)

        # drain with a request in flight: the captured step finishes it
        held = eng.submit(prompts[4], SamplingParams(
            max_new_tokens=DOOR["max_new"]))
        drainer = threading.Thread(target=replica.server.drain,
                                   kwargs={"timeout": 300})
        drainer.start()
        while not replica.server._draining.is_set():
            time.sleep(0.001)
        refused, _ = _http(port, "POST", "/v1/generate?user.name=late",
                           {"tokens": [1, 2], "max_new_tokens": 2})
        drainer.join(timeout=300)
        _, after = _http(port, "GET", "/v1/health")
        after = json.loads(after)
        held_tokens = held.wait(0) if held.done.is_set() else None
        compiles = (eng.decode_compiles, eng.prefill_compiles,
                    len(eng._graphs))
    finally:
        tracer.remove_receiver(on_span)
        replica.drain_and_stop(timeout=300)

    # the same requests through in-process generate on the same weights
    ref_tokens, ref = _serve_steps(
        eng.params, cfg, [(p, SamplingParams(max_new_tokens=DOOR["max_new"]))
                          for p in prompts], graphs=True)
    equal = [a == b for a, b in zip(tokens, ref_tokens)]
    emit({"phase": "door", "model": "flagship-1b", "dtype": cfg.dtype,
          "requests": len(prompts), "clients": DOOR["clients"],
          "max_new": DOOR["max_new"],
          "prompt_tokens": [len(p) for p in prompts],
          "load_seconds": replica.load_seconds,
          "unauthenticated_status": unauth,
          "tokens_equal_per_request": equal,
          "streamed_lines": len(streamed),
          "door": {"seconds": wall, "tokens": n_tokens,
                   "tokens_per_s": n_tokens / wall,
                   "ttft_p50_s": _pct(door_ttft, 0.5),
                   "ttft_p99_s": _pct(door_ttft, 0.99),
                   "ttft_s": door_ttft},
          "in_process_generate": {
              "seconds": ref["seconds"], "tokens": ref["tokens"],
              "tokens_per_s": ref["tokens_per_s"],
              "ttft_p50_s": _pct(ref["ttft_s"], 0.5),
              "ttft_p99_s": _pct(ref["ttft_s"], 0.99),
              "steps": ref["steps"], "step_ms": ref["step_ms"]},
          "profiled_window": dict(window, requests=DOOR["clients"]),
          "decode_step_ms": {"quiet": quiet_ms,
                             "health_poller": polled_ms},
          "health_polls": len(polls),
          "device_memory_stats_ms": stats_ms,
          "health_poll_ms_mean": sum(t for _, t in polls) * 1e3
          / max(1, len(polls)),
          "health_status": health_status, "prom_status": prom_status,
          "hbm": health["hbm"], "prefix_cache": health["prefix_cache"],
          "qos": health.get("qos"),
          "compiles_decode_fused_graphs": list(compiles),
          "drain": {"refused_status": refused, "status": after["status"],
                    "drain_complete": after["drain_complete"],
                    "held_request_finished": held_tokens is not None}})
    require(all(equal), f"door tokens differ from in-process generate: "
            f"{equal}")
    require(all(t is not None and len(t) == DOOR["max_new"]
                for t in tokens), "a door request came back short")
    require([x.get("token") for x in streamed[:-1]] == tokens[3]
            and streamed[-1].get("done") is True,
            "the streamed lines do not carry the request's tokens")
    require(len(door_ttft) == len(prompts),
            f"{len(door_ttft)} first-token spans for {len(prompts)} "
            f"requests")
    require(health_status == 200 and health["status"] == "serving"
            and health["hbm"]["device"] is not None,
            f"/v1/health: {health_status} {health.get('status')}")
    require(prom_status == 200 and
            b"htpu_time_to_first_token_seconds_bucket" in prom and
            b"htpu_tokens_out_total" in prom, "/prom lacks the families")
    require(all(st == 200 for st, _ in polls) and polls,
            "the /v1/health poller failed")
    require(compiles == (1, 1, 2),
            f"decode/fused shapes and graphs {compiles}, expected 1, 1, 2")
    require(refused == 503 and after["status"] == "draining"
            and after["drain_complete"] is True,
            f"drain: {refused}, {after['status']}, "
            f"{after['drain_complete']}")
    require(held_tokens == ref_tokens[4],
            "the request held through the drain did not finish with the "
            "in-process tokens")


def make_params():
    """flagship-1b at full width: float32 weights from a seeded generator
    and their bf16 cast (what init_params gives for the bf16 config)."""
    cfg32 = get_config("flagship-1b", dtype="float32")
    cfg16 = get_config("flagship-1b")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    p32 = init_params(cfg32, gen)
    return cfg32, p32, cfg16, _cast(p32, torch.bfloat16)


def _cast(tree, dtype):
    return tree_map(lambda w: w.to(dtype), tree)


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


def phase_forward_fp16(cfg32, p32):
    """flagship-1b in float16 at [1, 512] through ``forward``'s "auto":
    no flash kernel is built for float16, so every layer takes the plain
    attention (no launch), as the reference does off the TPU; the logits
    held against the float32 kernel forward on the same weights."""
    cfg = get_config("flagship-1b", dtype="float16")
    params = _cast(p32, torch.float16)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(SEED + 1))
    torch.cuda.synchronize()
    before = counts()
    logits = forward(params, tokens, cfg)
    torch.cuda.synchronize()
    launches = [a - b for a, b in zip(counts(), before)]
    want = forward(p32, tokens, get_config("flagship-1b", dtype="float32"))
    rel = _max_rel(logits, want)
    top1 = (logits.argmax(-1) == want.argmax(-1)).float().mean().item()
    emit({"phase": "forward_fp16", "model": "flagship-1b",
          "dtype": cfg.dtype, "tokens": [1, 512],
          "launches_fwd_dq_dkv_partial": launches,
          "rel_err_vs_float32": rel, "tol": FP16_TOL,
          "top1_agreement": top1, "finite": bool(torch.isfinite(logits).all()),
          "ms": cuda_ms(lambda: forward(params, tokens, cfg), 5)})
    require(launches == [0, 0, 0, 0], f"the float16 forward launched "
            f"(fwd, dq, dkv, partial) {launches}")
    require(bool(torch.isfinite(logits).all()), "non-finite float16 logits")
    require(rel <= FP16_TOL, f"float16 logits vs float32: {rel}")
    del params, logits, want


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


def _serve_steps(params, cfg, requests, graphs: bool):
    """Serve ``requests`` [(prompt, sampling)] through ``DecodeEngine.step``
    (submitted together, stepped until done): through the engine's CUDA
    graphs, or its eager step (``graphs=False``). Both step shapes run
    once before the clock starts (a 1-token prompt, 2 tokens), so the
    graphs are captured by then. Returns the tokens and a record."""
    eng = DecodeEngine(params, cfg, **SERVE_KW)
    if not graphs:
        eng._launch_step = eng._step_eager
    eng.generate([[1]], SamplingParams(max_new_tokens=2))
    steps0 = eng.steps
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [eng.submit(p, sp) for p, sp in requests]
    while not all(r.done.is_set() for r in reqs):
        eng.step()
    wall = time.monotonic() - t0
    tokens = [r.wait(0) for r in reqs]
    steps = eng.steps - steps0
    n = sum(len(t) for t in tokens)
    rec = {"steps": steps, "seconds": wall, "step_ms": wall / steps * 1e3,
           "tokens": n, "tokens_per_s": n / wall,
           "ttft_s": [r.first_token_at - r.submitted_at for r in reqs],
           "graphs_captured": len(eng._graphs),
           "decode_shapes": eng.decode_compiles,
           "fused_shapes": eng.prefill_compiles}
    del eng
    return tokens, rec


def phase_serving(cfg32, p32, cfg16, p16):
    prompts, sampled_prompt = _prompts(cfg32.vocab_size)
    new = 32
    greedy = SamplingParams(max_new_tokens=new)
    sampling = SamplingParams(max_new_tokens=new, temperature=0.8, top_k=50)

    # float32, driven step by step: greedy tokens against the forward loop
    eng = DecodeEngine(p32, cfg32, **SERVE_KW)
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
    eng = DecodeEngine(p16, cfg16, **SERVE_KW)
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
          "cache": eng.cache_stats(),
          "graphs_captured": len(eng._graphs)})
    require(len(eng._graphs) == 2 and eng.decode_compiles == 1
            and eng.prefill_compiles == 1,
            f"the scheduler thread's engine captured {len(eng._graphs)} "
            f"graphs at {eng.decode_compiles} + {eng.prefill_compiles} "
            f"shapes")
    del eng

    # bf16, the same 5 requests stepped through the CUDA graphs and
    # through the eager step: the same tokens, greedy and sampled (the
    # sampler's generator is registered with each graph)
    requests = [(p, greedy) for p in prompts] + [(sampled_prompt, sampling)]
    runs = {mode: _serve_steps(p16, cfg16, requests, mode == "graph")
            for mode in ("graph", "eager")}
    equal = [a == b for a, b in zip(runs["graph"][0], runs["eager"][0])]
    # launches per decode-only step: 4 lanes decoding, 10 steps traced
    gen = torch.Generator().manual_seed(SEED + 11)
    lanes = torch.randint(0, cfg16.vocab_size, (4, 100), generator=gen)
    profiles = {}
    for mode in ("graph", "eager"):
        eng = decoding_engine(p16, cfg16, lanes.tolist(), mode == "graph")
        rec = trace(eng.step, 10, f"engine decode step flagship-1b bf16, 4 "
                    f"lanes, {mode}")
        profiles[mode] = {k: rec[k] for k in (
            "wall_ms", "device_ms", "idle_share", "kernel_launches",
            "host_launch_calls")}
        del eng
    emit({"phase": "serving_graphs", "dtype": "bfloat16", "requests": 5,
          "tokens_equal_per_request": equal,
          "graph": runs["graph"][1], "eager": runs["eager"][1],
          "decode_step_profile": profiles})
    require(all(equal), f"graph-replayed tokens differ from the eager "
            f"step's: {equal}")
    require(runs["graph"][1]["graphs_captured"] == 2
            and runs["eager"][1]["graphs_captured"] == 0,
            "the graph run did not capture both shapes, or the eager run "
            "captured")
    require(all(r[1]["decode_shapes"] == 1 and r[1]["fused_shapes"] == 1
                for r in runs.values()), "more than two step shapes")


def phase_parity(cfg32, p32):
    """Two float32 SGD steps (lr 1e-2) at [1, 512] from the same weights
    and tokens: the kernel path (forward and both backward kernels)
    against plain attention."""
    tokens = torch.randint(0, cfg32.vocab_size, (1, 512), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(SEED + 4))
    targets = torch.roll(tokens, -1, dims=1)
    runs = {}
    for impl in ("auto", "ref", "sliced"):
        params = tree_map(torch.clone, p32)
        opt = adamw_init(params)
        step = make_train_step(cfg32, lr=1e-2, optimizer="sgd",
                               attn_impl="auto" if impl == "sliced" else impl)
        zero_counts()
        losses = []
        with _sliced_layers(impl == "sliced"):
            for _ in range(2):
                params, opt, metrics = step(params, opt, tokens, targets)
                losses.append(metrics["loss"].item())
        runs[impl] = (losses, params, counts()[:3])
        del opt
    (lk, pk, ck), (lr_, pr, cr) = runs["auto"], runs["ref"]
    ls, ps, _ = runs.pop("sliced")
    sliced_equal = ls == lk and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(ps), tree_leaves(pk)))
    del ps
    want = (2 * cfg32.n_layers,) * 3
    require(ck == want and cr == (0, 0, 0),
            f"launches (fwd, dq, dkv): kernel path {ck}, plain path {cr}")
    leaf_err = {}
    for key, a, b, p0 in zip(tree_leaves(_names(p32)), tree_leaves(pk),
                             tree_leaves(pr), tree_leaves(p32)):
        upd_k, upd_r = a - p0, b - p0
        leaf_err[key] = ((upd_k - upd_r).abs().max()
                         / upd_r.abs().max()).item()
    emit({"phase": "parity", "dtype": "float32", "tokens": [1, 512],
          "optimizer": "sgd", "losses_kernel": lk, "losses_plain": lr_,
          "update_rel_err": leaf_err, "tol": PARITY_TOL,
          "unbound_equal_to_per_layer_slices": sliced_equal,
          "losses_kernel_pr5": PR5_PARITY_LOSSES,
          "losses_kernel_equal_pr5": lk == PR5_PARITY_LOSSES})
    require(sliced_equal, "the unbound layers' SGD steps differ from the "
            "per-layer slices' (losses or parameters)")
    require(all(math.isclose(a, b, rel_tol=1e-4) for a, b in zip(lk, lr_)),
            f"losses kernel {lk} vs plain {lr_}")
    require(all(e <= PARITY_TOL for e in leaf_err.values()),
            f"updates kernel vs plain: {leaf_err}")


@contextlib.contextmanager
def _sliced_layers(on: bool):
    """While open (and ``on``), the decoder's layer loop takes ``w[i]`` of
    each stacked leaf in each layer, as it did before it unbound each leaf
    once: the same values, gradients summed from per-layer slices."""
    if not on:
        yield
        return
    unbound = decoder_module.run_layers

    def sliced(x, layers, cfg, cos, sin, attn_impl="auto", remat=False):
        body = decoder_module._layer_fn(remat)
        for i in range(cfg.n_layers):
            x = body(x, {name: w[i] for name, w in layers.items()}, cfg,
                     cos, sin, attn_impl)
        return x

    decoder_module.run_layers = sliced
    try:
        yield
    finally:
        decoder_module.run_layers = unbound


def _names(tree, prefix=""):
    """A tree like ``tree`` whose leaves are their dotted names."""
    return {key: _names(value, prefix + key + ".")
            if isinstance(value, dict) else prefix + key
            for key, value in tree.items()}


def phase_partial():
    """The non-causal partial against its plain version at every listed
    shape and dtype, timed against SDPA (non-causal, a yardstick for O
    only) and its bound; the causal partial against ``flash_forward``
    bit for bit. Returns the llama3-8b-shape bf16 record."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    main_shape = None
    for b, sq, skv, hq, hkv, d, q_mul in PARTIAL_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            q = (q_mul * torch.randn(b, sq, hq, d, generator=gen,
                                     device="cuda")).to(dtype)
            k, v = (torch.randn(b, skv, hkv, d, generator=gen, device="cuda")
                    .to(dtype) for _ in range(2))
            scale = d ** -0.5
            o, lse = flash.flash_attention_partial(q, k, v, scale, False)
            o_ref, lse_ref = flash.flash_attention_partial_ref(
                q, k, v, scale, False)
            torch.cuda.synchronize()
            err_o = (o - o_ref).abs().max().item()
            rel_o = err_o / o_ref.abs().max().item()
            err_lse = (lse - lse_ref).abs().max().item()
            tol_o, tol_lse = PARTIAL_TOLERANCE[dtype]
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            rec = {
                "phase": "partial", "name": "flash_fwd_partial",
                "shape": [b, sq, skv, hq, hkv, d], "dtype": str(dtype),
                "q_scale": q_mul, "max_abs_err": err_o, "rel_err": rel_o,
                "max_abs_err_lse": err_lse, "tol": [tol_o, tol_lse],
                "ms": cuda_ms(lambda: flash.flash_attention_partial(
                    q, k, v, scale, False), 10),
                "plain_ms": cuda_ms(lambda: flash.flash_attention_partial_ref(
                    q, k, v, scale, False), 3),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=False, scale=scale,
                    enable_gqa=True), 10),
            }
            add_rates(rec, partial_bound(b, sq, skv, hq, hkv, d, dtype))
            if sq == skv:
                po, plse = flash.flash_attention_partial(q, k, v, scale, True)
                fo, flse = flash.flash_forward(q, k, v, scale)
                rec["causal_bit_equal"] = bool(
                    torch.equal(po, fo.float())
                    and torch.equal(plse, flse.transpose(1, 2)))
                require(rec["causal_bit_equal"],
                        f"causal partial differs from flash_forward at "
                        f"{rec['shape']} {dtype}")
            emit(rec)
            require(rel_o <= tol_o and err_lse <= tol_lse,
                    f"flash_fwd_partial disagrees with its plain version at "
                    f"{rec['shape']} {dtype}: O {rel_o} of max |O|, "
                    f"LSE {err_lse}")
            if main_shape is None:
                main_shape = rec
            del q, k, v, o, lse, o_ref, lse_ref
    return main_shape


def _ulps(a, b, before):
    """Per element, |a - b| in ulps of their dtype at the largest of |a|,
    |b| and |before| (the value the update started from: where the
    update nearly cancels it, two results a rounding apart straddle
    zero, and an ulp of the result itself would be meaningless)."""
    top = torch.maximum(torch.maximum(a.float().abs(), b.float().abs()),
                        before.float().abs())
    _, exp = torch.frexp(top)
    nmant = round(-math.log2(torch.finfo(a.dtype).eps))   # mantissa bits
    ulp = torch.ldexp(torch.ones_like(top), exp - 1 - nmant)
    return (a.float() - b.float()).abs() / ulp


def phase_adamw():
    """adamw.cu's update and squared norm against their plain versions
    on flagship-1b's leaves (bf16; random gradients and moments from a
    seed; step ``ADAMW["count"]``), timed against the plain versions and,
    as a yardstick, ``torch.optim.AdamW(fused=True)`` over the same
    leaves (decay groups split by ndim; its moments in bf16 and no clip);
    the squared norm against ``torch.nn.utils.get_total_norm(grads, 2.0)``
    squared. Returns the records of the two kernels for the kernels
    line."""
    cfg = get_config("flagship-1b")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    params = init_params(cfg, gen)

    def rand(p, mul, square=False):
        x = torch.randn(p.shape, generator=gen, device="cuda")
        return (x.square() if square else x) * mul

    grads = tree_map(lambda p: rand(p, ADAMW["grad_scale"]).to(p.dtype),
                     params)
    mu = tree_map(lambda p: rand(p, 1e-4), params)
    nu = tree_map(lambda p: rand(p, 1e-8, square=True), params)
    leaves, gleaves = tree_leaves(params), tree_leaves(grads)
    n = sum(p.numel() for p in leaves)

    gsq = optimizer._launch_grad_sq(gleaves)
    gsq_ref = optimizer.grad_sq_ref(grads)
    gsq_rel = abs(gsq.item() - gsq_ref.item()) / gsq_ref.item()
    scale = torch.clamp(1.0 / torch.clamp(torch.sqrt(gsq), min=1e-12),
                        max=1.0)
    hyper = optimizer._hyper(ADAMW["count"], ADAMW["lr"], ADAMW["b1"],
                             ADAMW["b2"], ADAMW["eps"],
                             ADAMW["weight_decay"])
    sides = {}
    for side in ("kernel", "plain"):
        state = [tree_leaves(tree_map(torch.clone, t))
                 for t in (params, mu, nu)]
        update = optimizer._launch_adamw if side == "kernel" else \
            optimizer.adamw_leaf_ref
        for p, g, m, v in zip(*state[:1], gleaves, *state[1:]):
            update(p, g, m, v, scale, hyper, p.ndim >= 2)
        sides[side] = state
    torch.cuda.synchronize()
    (pk, mk, nk), (pr, mr, nr) = sides["kernel"], sides["plain"]
    p_diff = sum(int((a != b).sum()) for a, b in zip(pk, pr))
    p_ulps = max(_ulps(a, b, p0).max().item()
                 for a, b, p0 in zip(pk, pr, leaves))
    p_err = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(pk, pr))
    moment_rel = max(((a - b).abs().max() / b.abs().max()).item()
                     for a, b in zip(mk + nk, mr + nr))
    del sides, pr, mr, nr

    def run(update):
        for p, g, m, v in zip(pk, gleaves, mk, nk):
            update(p, g, m, v, scale, hyper, p.ndim >= 2)

    lib_params = [p.detach().clone().requires_grad_() for p in leaves]
    for p, g in zip(lib_params, gleaves):
        p.grad = g
    lib = torch.optim.AdamW(
        [{"params": [p for p in lib_params if p.ndim >= 2],
          "weight_decay": ADAMW["weight_decay"]},
         {"params": [p for p in lib_params if p.ndim < 2],
          "weight_decay": 0.0}],
        lr=ADAMW["lr"], betas=(ADAMW["b1"], ADAMW["b2"]), eps=ADAMW["eps"],
        fused=True)
    upd_bytes = sum(p.numel() * (2 * p.element_size() + g.element_size()
                                 + 16) for p, g in zip(leaves, gleaves))

    def lib_grad_sq():
        return torch.nn.utils.get_total_norm(gleaves, 2.0).square()

    lib_gsq = lib_grad_sq().item()
    sq_bytes = sum(g.numel() * g.element_size() for g in gleaves) + 4
    records = {
        "adamw": add_rates({
            "ms": cuda_ms(lambda: run(optimizer._launch_adamw), 5),
            "plain_ms": cuda_ms(lambda: run(optimizer.adamw_leaf_ref), 2),
            "library_ms": cuda_ms(lib.step, 5),
            "max_abs_err": p_err},
            _bound(upd_bytes, ADAMW_FLOPS * n, torch.float32)),
        "grad_sq": add_rates({
            "ms": cuda_ms(lambda: optimizer._launch_grad_sq(gleaves), 10),
            "plain_ms": cuda_ms(lambda: optimizer.grad_sq_ref(grads), 3),
            "library_ms": cuda_ms(lib_grad_sq, 10),
            "max_abs_err": abs(gsq.item() - gsq_ref.item())},
            _bound(sq_bytes, 2 * n, torch.float32)),
    }
    emit({"phase": "adamw", "model": "flagship-1b", "params": n,
          "leaves": len(leaves), "dtype": cfg.dtype,
          "p_elements_differing": p_diff, "p_share_differing": p_diff / n,
          "p_max_ulps": p_ulps, "p_share_tol": ADAMW_P_SHARE,
          "moment_rel_err": moment_rel, "moment_tol": ADAMW_MOMENT_TOL,
          "grad_sq_rel_err": gsq_rel, "grad_sq_tol": GRAD_SQ_TOL,
          "library_grad_sq_rel_err": abs(lib_gsq - gsq_ref.item())
          / gsq_ref.item(),
          **records})
    require(p_ulps <= 1 and p_diff / n <= ADAMW_P_SHARE,
            f"adamw.cu parameters vs plain: {p_diff} elements differ, up to "
            f"{p_ulps} ulps")
    require(moment_rel <= ADAMW_MOMENT_TOL,
            f"adamw.cu moments vs plain: {moment_rel}")
    require(gsq_rel <= GRAD_SQ_TOL, f"grad_sq vs plain: {gsq_rel}")
    del params, grads, mu, nu, lib, lib_params, pk, mk, nk
    torch.cuda.empty_cache()
    return records


def _fold(x, sp):
    """[B, S, H, D] -> [sp*B, S/sp, H, D], rank r's shard on rows
    r*B..(r+1)*B-1."""
    b, s, h, d = x.shape
    return x.reshape(b, sp, s // sp, h, d).transpose(0, 1).reshape(
        sp * b, s // sp, h, d)


def _unfold(x, sp):
    n, sl, h, d = x.shape
    return x.reshape(sp, n // sp, sl, h, d).transpose(0, 1).reshape(
        n // sp, sp * sl, h, d)


def _ring_err(got, want, sp):
    """The ring's output ``got`` against the causal kernel's ``want``
    over the whole sequence, both [B, S, H, D]: whether rank 0's rows are
    equal bit for bit, and the largest per-row max |dO| over max |O| on
    the later rows."""
    local = want.shape[1] // sp
    g, w = got[:, local:].float(), want[:, local:].float()
    rel = (g - w).abs().amax(dim=(2, 3)) / w.abs().amax(dim=(2, 3))
    return torch.equal(got[:, :local], want[:, :local]), rel.max().item()


def phase_ring():
    """``ring_attention`` at sp 4 on one device (the kernel path: 1
    causal and 3 non-causal partial launches per call) against the
    causal kernel over the whole sequence."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    for b, s, hq, hkv, d, dtype in RING_CASES:
        q = torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
        k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda")
                .to(dtype) for _ in range(2))
        want, _ = flash.flash_forward(q, k, v)
        rq, rk, rv = (_fold(x, RING_SP) for x in (q, k, v))
        before = counts()
        got = _unfold(ring_attention(rq, rk, rv, RING_SP), RING_SP)
        torch.cuda.synchronize()
        delta = [a - c for a, c in zip(counts(), before)]
        rank0_equal, rel = _ring_err(got, want, RING_SP)
        tol = RING_ROW_TOL[dtype]
        rec = {"phase": "ring", "shape": [b, s, hq, hkv, d], "sp": RING_SP,
               "dtype": str(dtype), "rank0_bit_equal": rank0_equal,
               "row_rel_err": rel, "tol": tol,
               "launches_causal_partial": [delta[0], delta[3]],
               "ms": cuda_ms(lambda: ring_attention(rq, rk, rv, RING_SP), 5),
               "single_causal_ms": cuda_ms(
                   lambda: flash.flash_forward(q, k, v), 5)}
        # the ring's causal diagonal alone, at its folded shape
        qt, kt, vt = (x.transpose(1, 2) for x in (rq, rk, rv))
        diag = {"shape": [RING_SP * b, s // RING_SP, hq, hkv, d],
                "ms": cuda_ms(lambda: flash.flash_forward(rq, rk, rv), 10),
                "plain_ms": cuda_ms(lambda: flash.flash_attention_ref(
                    rq, rk, rv, d ** -0.5), 3),
                "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True), 10)}
        add_rates(diag, flash_bound(*diag["shape"], dtype))
        rec["diagonal"] = diag
        emit(rec)
        require(delta == [1, 0, 0, RING_SP - 1],
                f"ring attention launched (fwd, dq, dkv, partial) {delta}")
        require(rank0_equal and rel <= tol,
                f"ring attention vs causal kernel at {[b, s, hq, hkv, d]} "
                f"{dtype}: rank 0 equal {rank0_equal}, later rows {rel} "
                f"(tolerance {tol})")
        del q, k, v, rq, rk, rv, got, want


def phase_longctx_exact(cfg32, p32):
    """flagship-1b in float32 at [2048]: the CP prefill at sp 4 and sp 2
    through the exact A-B guard (atol 5e-4, argmax identical), the
    reference's own contract."""
    tokens = torch.randint(0, cfg32.vocab_size, (2048,), device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(SEED + 8)).tolist()
    for sp in EXACT_SP:
        pre = ContextParallelPrefiller(p32, cfg32, block_size=16,
                                       pad_tokens=2048, sp=sp)
        before = counts()
        report = run_prefill_ab(p32, cfg32, tokens, pre, mode="exact")
        delta = [a - c for a, c in zip(counts(), before)]
        report.update(phase="longctx_exact", model="flagship-1b",
                      dtype="float32", launches_causal_partial=[
                          delta[0], delta[3]])
        emit(report)
        # the reference forward launches n_layers causal kernels too
        require(delta[3] == (sp - 1) * cfg32.n_layers
                and delta[0] == 2 * cfg32.n_layers,
                f"sp {sp}: launches (fwd, dq, dkv, partial) {delta}")


def _max_rel(got, ref):
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


def _rel_per_layer(got, ref):
    """Per layer (dim 0): max |got - ref| over max |ref|."""
    err = (got.float() - ref.float()).abs().amax(dim=(1, 2, 3))
    return (err / ref.float().abs().amax(dim=(1, 2, 3))).tolist()


def _streamed_kv(res):
    """The prefill's K/V stream as one host tensor each, [L, n, Hkv,
    Dh]: the full blocks in chain order, then the tail; and the number
    of full blocks."""
    blocks = list(res.blocks)
    out = []
    for i, tail in enumerate((res.tail_k, res.tail_v)):
        out.append(torch.cat([blk[i] for blk in blocks]
                             + ([tail] if tail is not None else []), dim=1))
    return out, len(blocks)


@contextlib.contextmanager
def _probe_ring(sp, errs):
    """While open, every ``ring_attention`` call of the decoder also runs
    the causal kernel over the same q, k, v gathered into one sequence,
    and appends ``_ring_err`` of the ring's output against it to
    ``errs``: each layer's attention held on its own inputs, apart from
    the drift of the layers before it."""
    ring_call = ring_module.ring_attention

    def probed(q, k, v, ring_size, impl="auto"):
        out = ring_call(q, k, v, ring_size, impl=impl)
        want, _ = flash.flash_forward(*(_unfold(x, sp) for x in (q, k, v)))
        errs.append(_ring_err(_unfold(out, sp), want, sp))
        return out

    ring_module.ring_attention = probed
    try:
        yield
    finally:
        ring_module.ring_attention = ring_call


def _reference(params, cfg, full, n, head, cos, sin):
    """The single-device forward over ``full`` (the prompt is its first
    ``n`` tokens; causal, so those rows are the prompt's own), as
    ``run_layers_kv`` (``forward_hidden``'s layers, also returning K/V):
    for the kernel forward ("auto") and for plain attention ("ref", the
    calibration), row n-1's logits and every layer's K and V [L, n, Hkv,
    Dh] on the host."""
    out = {}
    with torch.no_grad():
        for impl in ("auto", "ref"):
            h, (ks, vs) = run_layers_kv(params["embed"][full[None]],
                                        params["layers"], cfg, cos, sin,
                                        attn_impl=impl)
            out[impl] = ((final_hidden(params, h[0, n - 1], cfg) @ head)
                         .float().cpu(), ks[:, 0, :n].cpu(),
                         vs[:, 0, :n].cpu())
            del h, ks, vs
    torch.cuda.empty_cache()
    return out


def phase_longctx():
    """llama3-8b at full width and depth and its published context: CP
    prefill (sp 4 on this card, block 16) of three prompts against the
    single-device forward (the causal kernel at S 8192). Returns the
    main path's launches (causal, partial) of the 8192-token prefill."""
    cfg = get_config(LONGCTX["model"])
    sp = LONGCTX["sp"]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in tree_leaves(params))
    head = head_matrix(params, cfg)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device="cuda")
    pre = ContextParallelPrefiller(params, cfg, block_size=LONGCTX["block"],
                                   pad_tokens=cfg.max_seq, sp=sp)
    local = pre.pad_tokens // sp
    want_launches = (cfg.n_layers, 0, 0, (sp - 1) * cfg.n_layers)
    main_launches = None
    for i, n in enumerate(LONGCTX["tokens"]):
        full = torch.randint(0, cfg.vocab_size, (cfg.max_seq,),
                             generator=torch.Generator(device="cuda")
                             .manual_seed(SEED + 9 + i), device="cuda")
        ref = _reference(params, cfg, full, n, head, cos, sin)
        prompt = full[:n].tolist()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts()                          # the main path's run
        res = pre.cp_prefill(prompt)
        torch.cuda.synchronize()
        launches = counts()
        peak = torch.cuda.max_memory_allocated()
        got_kv, n_blocks = _streamed_kv(res)
        got = torch.from_numpy(res.last_logits)
        tail = 0 if res.tail_k is None else res.tail_k.shape[1]
        del res
        attn = []
        with _probe_ring(sp, attn):
            pre.cp_prefill(prompt)
        # the CP prefill and the calibration against the kernel forward:
        # logits, then K and V per layer from position S/sp on
        kernel, plain = ref["auto"], ref["ref"]
        err = [[_max_rel(got, kernel[0])]]
        cal = [[_max_rel(plain[0], kernel[0])]]
        for j in (1, 2):
            if got_kv[j - 1].shape != kernel[j].shape:
                raise SmokeFailure(f"streamed K/V {tuple(got_kv[j - 1].shape)}"
                                   f", expected {tuple(kernel[j].shape)}")
            err.append(_rel_per_layer(got_kv[j - 1][:, local:],
                                      kernel[j][:, local:]))
            cal.append(_rel_per_layer(plain[j][:, local:],
                                      kernel[j][:, local:]))
        ratio = max(e / c if c else (0.0 if e == 0 else math.inf)
                    for es, cs in zip(err, cal) for e, c in zip(es, cs))
        rank0_equal = all(torch.equal(g[:, :local], w[:, :local])
                          for g, w in zip(got_kv, kernel[1:]))
        rec = {"phase": "longctx", "model": LONGCTX["model"],
               "dtype": cfg.dtype, "params": n_params, "prompt_tokens": n,
               "pad_tokens": pre.pad_tokens, "sp": sp,
               "block_size": LONGCTX["block"], "full_blocks": n_blocks,
               "tail_tokens": tail,
               "attention_rank0_bit_equal": all(e[0] for e in attn),
               "attention_row_rel_err_per_layer": [e[1] for e in attn],
               "attention_tol": RING_ROW_TOL[torch.bfloat16],
               "rank0_kv_bit_equal": rank0_equal,
               "logits_rel_err": err[0][0],
               "logits_rel_err_calibration": cal[0][0],
               "argmax_agree": int(got.argmax()) == int(kernel[0].argmax()),
               "k_rel_err_max": max(err[1]), "v_rel_err_max": max(err[2]),
               "k_rel_err_per_layer": err[1], "v_rel_err_per_layer": err[2],
               "k_rel_err_calibration_per_layer": cal[1],
               "v_rel_err_calibration_per_layer": cal[2],
               "calibration_ratio_max": ratio,
               "cal_factor": LONGCTX["cal_factor"],
               "launches_fwd_dq_dkv_partial": list(launches),
               "peak_memory_bytes": peak,
               "shapes": [pre.prefill_compiles, pre.head_compiles]}
        if i == 0:
            ms = cuda_ms(lambda: pre.cp_prefill(prompt), LONGCTX["timed"])
            rec.update(ms=ms, tokens_per_s=n / (ms / 1e3),
                       single_device_forward_ms=cuda_ms(
                           lambda: final_hidden(params, forward_hidden(
                               params, full[None], cfg)[0, -1], cfg) @ head,
                           2))
            main_launches = (launches[0], launches[3])
        emit(rec)
        require(tuple(launches) == want_launches,
                f"CP prefill launches (fwd, dq, dkv, partial) {launches}, "
                f"expected {want_launches}")
        require(len(attn) == cfg.n_layers and rec["attention_rank0_bit_equal"]
                and max(rec["attention_row_rel_err_per_layer"])
                <= RING_ROW_TOL[torch.bfloat16],
                f"CP prefill of {n} tokens: ring attention vs the causal "
                f"kernel on the same inputs: {attn}")
        require(rank0_equal, "rank 0's K/V differ from the single-device "
                "forward's")
        require(ratio <= LONGCTX["cal_factor"],
                f"CP prefill of {n} tokens vs the single-device forward: up "
                f"to {ratio} times the calibration's distance")
        require(bool(torch.isfinite(got).all()), "non-finite CP logits")
        require(n_blocks == n // LONGCTX["block"] and
                tail == n % LONGCTX["block"], "wrong block count")
        del ref, got_kv
    require(pre.prefill_compiles == 1 and pre.head_compiles == 1,
            "the CP prefill ran at more than one shape")
    del params, pre
    return main_launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    record = phase_kernel()
    bwd = phase_backward()
    partial = phase_partial()
    adamw = phase_adamw()
    phase_ring()
    (_, train_dq, train_dkv, train_adamw, train_grad_sq), train_rec = \
        phase_train()
    fs, root = LocalFileSystem(), tempfile.mkdtemp(prefix="htpu-trainer-")
    try:
        trainer_launches, host = phase_trainer(train_rec, fs, root)
        phase_loader(fs, root, host)
        del host
        phase_door(fs, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg32, p32, cfg16, p16 = make_params()
    fwd_launches = phase_forward(cfg32, p32, cfg16, p16)
    phase_forward_fp16(cfg32, p32)
    phase_serving(cfg32, p32, cfg16, p16)
    phase_parity(cfg32, p32)
    phase_longctx_exact(cfg32, p32)
    del cfg32, p32, cfg16, p16          # free flagship-1b for llama3-8b
    torch.cuda.empty_cache()
    _, cp_partial = phase_longctx()
    source_fwd = "hadoop_tpu_torch/ops/csrc/flash_fwd.cu"
    source_bwd = "hadoop_tpu_torch/ops/csrc/flash_bwd.cu"
    # launches: on each kernel's path of an earlier slice (the forward,
    # the train phase's 7 steps, one CP prefill); launches_trainer: on
    # this slice's, the trainer phase's 12 steps through Trainer
    by_trainer = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                           "adamw", "grad_sq"), trainer_launches))
    emit({"kernels": [dict(rec, launches_trainer=by_trainer.get(
        rec["name"], 0)) for rec in [{
        "name": "flash_fwd", "route": "cuda", "source": source_fwd,
        "replaces": "hadoop_tpu/ops/flash.py:79",
        "launches": fwd_launches, "max_abs_err": record["max_abs_err"],
        "ms": record["ms"], "plain_ms": record["plain_ms"],
        "bound_ms": record["bound_ms"], "bound_by": record["bound_by"],
        "library_ms": record["library_ms"]}] + [{
            "name": f"flash_bwd_{name}", "route": "cuda",
            "source": source_bwd, "replaces": f"hadoop_tpu/ops/flash.py:{line}",
            "launches": n, "max_abs_err": bwd[name]["max_abs_err"],
            "ms": bwd[name]["ms"], "plain_ms": bwd["plain_ms"],
            "bound_ms": bwd[name]["bound_ms"],
            "bound_by": bwd[name]["bound_by"],
            "library_ms": bwd["library_ms"]}
        for name, line, n in (("dkv", 188, train_dkv),
                              ("dq", 240, train_dq))] + [{
            "name": "flash_fwd_partial", "route": "cuda",
            "source": source_fwd, "replaces": "hadoop_tpu/ops/flash.py:438",
            "launches": cp_partial,
            "max_abs_err": partial["max_abs_err"], "ms": partial["ms"],
            "plain_ms": partial["plain_ms"], "bound_ms": partial["bound_ms"],
            "bound_by": partial["bound_by"],
            "library_ms": partial["library_ms"]}] + [{
            "name": name, "route": "cuda",
            "source": "hadoop_tpu_torch/ops/csrc/adamw.cu",
            "replaces": f"hadoop_tpu/parallel/optimizer.py:{line}",
            "launches": n, "max_abs_err": adamw[name]["max_abs_err"],
            "ms": adamw[name]["ms"], "plain_ms": adamw[name]["plain_ms"],
            "bound_ms": adamw[name]["bound_ms"],
            "bound_by": adamw[name]["bound_by"],
            "library_ms": adamw[name]["library_ms"]}
        for name, line, n in (("adamw", 62, train_adamw),
                              ("grad_sq", 56, train_grad_sq))]]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
