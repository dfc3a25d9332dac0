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
``/prom``, a drain with a request in flight), then through the KV tiers
behind the engine (phase ``kvtiers``: demotions to a host-RAM ring and
persists to a DFS store on the local disk under waves of shared-head
traffic, replays from the ring and from the store on a second engine, a
``prefill_to_store`` handoff, a drain persist, TTFT from each tier and an
int8 ring, every replay's tokens equal to the first run's), then as a
fleet (phase ``fleet_front``, see FLEET_FRONT: the port's registry
server, three replicas with roles prefill, decode and mixed, the port's
router with its prefill handoff, prefix affinity and drain retries, and
the port's fleet doctor assembling a router-to-door trace); runs the
flagship-1b forward, also in
float16 (which no flash kernel takes: "auto" runs the plain attention);
serves flagship-1b requests through ``DecodeEngine`` (each step shape a
CUDA graph), holding the graphs' tokens against the engine's eager step,
and with speculative decoding (phase ``speculate``: n-gram drafts
verified in the captured step, float32 and bf16, on against off on
self-similar prompts); checks two float32 SGD steps of the kernel path
against plain attention and against the layer loop that slices each
stacked leaf per layer (bit for bit); runs
the context-parallel prefill of flagship-1b in float32 through the
exact A-B guard (sp 4 and sp 2); and prefills three prompts of
llama3-8b (8192, 8100 and 8000 tokens) at full width and 8 of its 32
layers with
``ContextParallelPrefiller`` (sp 4 ranks on the one card), holding every
layer's ring attention against the causal kernel on the same inputs,
and its logits and every layer's K/V against the single-device forward;
then decodes long prompts through the long-context plane attached to a
``DecodeEngine`` as ``ServingReplica`` attaches it (phase
``longctx_decode``: llama3-8b bf16 and its int8 plane, an 8192-token
prompt through CP prefill, the page-locked host ring and 32 tokens of
working-set decode, each token's logits against the single-device
forward, the legacy loop's tokens against the pipelined path's; and
flagship-1b in float32, the plane's tokens against the fused step's).
Two kernels that are repairs, not TPU kernels, are held against their
plain versions first: the int8 dequantize (phase ``dequant``, bit for
bit) and RMSNorm's forward and backward (phase ``rmsnorm``, bf16,
float16 and float32; the backward timed at both trained models' rows,
its pass and its dw finish apart); the train phase pins their launches
per step too.
Then the device Reed-Solomon coder (phase ``ec``): ``ec_gf256.cu`` on
one 128 MiB-per-unit block group for each RS policy, through
``encode_cells`` and ``decode_cells`` after each erasure pattern, bit
for bit against its plain version and the numpy host coder, its time
beside its own integer and table-load counts and on all-zero words (no
shared-memory bank conflicts). Last, MoE
training: mixtral-8x7b at full width, 2 of its 32 layers, [1, 4096]
tokens, through ``make_train_step`` (phase ``moe_train``: the flash
kernels at its shape first, 6 steps with their launches pinned, one
profiled) and through ``Trainer`` (phase ``moe_trainer``: crash, resume
and the loader into a ``DecodeEngine``, on a filesystem in memory).
Ulysses context parallelism (phase ``ulysses``): the three llama3-8b
prompts through ``ContextParallelPrefiller(sp_mode="ulysses")`` beside
the ring's, and the long-context plane with
``serving.longctx.sp.mode=ulysses``. The parallel training plans
(phases ``dist_parity`` and ``dist_train``, run after ``dist_shapes``,
before the ring phase, while this process holds least of the card),
at full width on four
ranks started by ``spmd.launch``, each a process on this one card in a
gloo world (NCCL takes no two ranks on one GPU; the collectives and
pipeline hops travel through host memory): flagship-1b as dp2×tp2, with
Megatron-SP, dp2×sp2 as ring and as Ulysses, ZeRO-1 dp4, and the
pipelines pp4 1F1B, dp2×pp2×vpp2 interleaved (4 layers), pp2×tp2 GPipe
with Megatron-SP and ZeRO-1 dp2×pp2 (2 layers, as the plans without a
pipeline); mixtral-8x7b as
dp2×ep2 and ep2×tp2 (1 layer): one float32 step against the
single-device step at the same depth, then two bf16 AdamW steps with
their launches pinned per rank and stage and the pipelines' stashed
stage inputs bounded; ``dist_shapes`` times the flash kernels at those
ranks' shapes. The four-rank phases (``tp_serving``, ``dist_parity``,
``dist_train``, ``trainer_mesh``, ``relaxed``) share one world
(``phase_dist_world``: the single-device references first, then the
world's five stages, then each phase's gates; ``stages=`` runs a
subset on a world of its own). The last, the relaxed parity tier (see
RELAXED): the eager codec's device time against its bytes bound, then
the loss-curve A-B of three legs (dp2×tp2 int8, ZeRO-1 dp4 fp8, a
stale sync schedule) with their ledger ratio and dp wire cut held at
≥ 2×, launches equal to the bitwise arm's and the card's codec equal to
the CPU's byte for byte. First, serving on four ranks (phase
``tp_serving``, see TP_SERVING): ``DecodeEngine`` under a tensor-parallel
plan and over expert shards, one rank driving and three following,
flagship-1b float32 at tp 2 and tp 4 (tokens equal the single-device
engine's, every rank's steps bit-equal), llama3-70b at full width and 8
layers at tp 4, mixtral-8x7b at 2 layers over 4 expert shards, under
tp 2 and on the int8 plane (first-token logits within 2e-2 of the
single-device engine's), with TTFT, step ms, tokens/s, peak memory and
the wire bytes a step; a control leg (mixtral under tp 2 with a tp
partial dropped) must read outside 2e-2. Then ``Trainer`` on a mesh (phase ``trainer_mesh``, see
TRAINER_MESH): four ranks with checkpoints written by every rank under
one manifest, a dp2×tp2 crash and bit-equal resume, a ZeRO-1 dp4
checkpoint restored into dp2×tp2 through the reshard, an interleaved
plan's checkpoint in logical layer order; per plan and rank the step,
checkpoint and restore ms, bytes written, peak memory and the comm
ledger's bytes beside the wire's; and, in the same world, the elastic
plane (see ELASTIC): a ZeRO-1 dp4 run whose scripted doctor flags rank 2
(a demote and its protective checkpoint), then marks it dead (an evict:
the other three ranks shrink to dp3, reshard-restore the protective
snapshot and re-run the lost steps), held against a dp4 twin restored
from the same snapshot. The fleet plane rides three of these phases
(see FLEET): a ``TrainerTelemetry`` door beside the trainer phase's
uninterrupted ``Trainer`` (``/ws/v1/trainer``, ``/prom``, ``/health``,
``/ws/v1/stacks`` read after its steps, whose launches stay pinned),
the replica's chassis in phase ``door`` (each request's root span in
``/ws/v1/traces`` by its trace id in hex and in decimal, the flight
recorder, ``/conf`` redaction, ``/ws/v1/top``, ``/health``, the port's
conf registry on ``/ws/v1/conf`` and one ``FleetScraper`` scrape of the
replica's own record, as the autoscaler reads it) and a door
on every rank's trainers in ``trainer_mesh`` (each read's comm block
equal to that rank's ledger report; the elastic block carrying the
evict and the shrink); one ``{"fleet": ...}`` line before the kernels
line gives the reads' ms, the seconds the doors added and the front
half's numbers (``front``: TTFT p50 through the router and direct, the
milliseconds the router adds before a door sees a request, the doctor's
polls, the phase's wall seconds). The device shuffle (phase ``shuffle``, see
SHUFFLE) runs on a folded axis of four ranks on the card: TeraSort and
WordCount at Hadoop's own record sizes, a hash exchange and an
overflowing one, each checked exactly. Weights are random, made from a
seeded ``torch.Generator``. The build phase also builds the DFS
client's native CRC32C (``hadoop_tpu_torch/native/crc32c.cc``) with the
host C++ compiler, holds it against the pure-Python backend on 4 MiB of
seeded bytes with an unaligned tail and on a corrupted chunk, times it
on the host CPU (its line's ``host_cpu_gb_per_s``: a host figure, not
the card's) and imports the DFS client's modules, which must load
nothing of JAX or the JAX package (see CRC); then the ``crypto_ctr`` line
times the encryption-zone streams on the host CPU, or says
``available: false`` where the ``cryptography`` package is missing (see
CRYPTO). The port's DFS daemons run in the script's process: phase
``dfs_daemons`` (see DFS_DAEMONS: a NameNode and ten DataNodes under a
flagship-1b trainer, loader, EC file and KV tier) and then phase
``dfs_ha`` (see DFS_HA: JournalNodes, an HA pair and an observer; the
active NameNode stopped mid-save, a resume with a JournalNode down, the
stopped NameNode's rejoin and the observer's reads). Each phase
prints one JSON line; the card's name and power limit (as
``nvidia-smi`` reports them) follow the build lines; the line before the
last lists every ported kernel with its launches on its main path (the
forward for ``flash_fwd``, the 7 training steps for the backward
kernels and ``adamw``/``grad_sq``, one 8192-token llama3-8b CP prefill
for ``flash_fwd_partial``, the ec phase's encode and decode calls for
``ec_gf256``) and on later slices' (``launches_trainer``: the trainer
phase's 12 steps; ``launches_moe_train``, ``launches_moe_trainer``: the
MoE phases' 6 and 12; ``launches_ulysses``: one 8192-token Ulysses
prefill; ``launches_dist``: rank 0's in dist_train's eleven plans of
two steps; ``launches_trainer_mesh``: rank 0's over trainer_mesh's
steps; ``launches_tp_serving``: rank 0's over tp_serving's legs;
``launches_relaxed``: rank 0's over the relaxed stage;
``launches_dfs_daemons``, ``launches_dfs_ha``: the DFS phases'), its
error and its times; the last line is
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
import gc
import hashlib
import http.client
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import hadoop_tpu_torch.parallel.ring_attention as ring_module
from hadoop_tpu_torch.parallel import spmd
from hadoop_tpu_torch.tools import dist_plans
from hadoop_tpu_torch import (DecodeEngine, SamplingParams, forward,
                              get_config, init_params, init_train_state,
                              make_train_step)
import hadoop_tpu_torch.models.decoder as decoder_module
from hadoop_tpu_torch.models.decoder import (final_hidden, forward_hidden,
                                             head_matrix, layer_forward,
                                             layer_slices, run_layers_kv)
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.io.erasurecode import (_cauchy_parity_matrix,
                                             _gf_invert, _gf_matmul)
import hadoop_tpu_torch.models.moe as moe_module
from hadoop_tpu_torch.models.moe import capacity as moe_capacity
from hadoop_tpu_torch.ops import _build, ec_device, flash, norms
from hadoop_tpu_torch.tools.ab_ec_rmsnorm import graph_ms
from hadoop_tpu_torch.ops import rope_frequencies
from hadoop_tpu_torch.fs import FileStatus, LocalFileSystem
from hadoop_tpu_torch.testing.minicluster import (MiniDFSCluster,
                                                   MiniQJMHACluster, fast_conf)
from hadoop_tpu_torch.cli import oiv
from hadoop_tpu_torch.cli.dfsadmin import DFSAdmin
from hadoop_tpu_torch.dfs.qjournal import JournalNode
from hadoop_tpu_torch.ipc import Client, get_proxy
from hadoop_tpu_torch.obs.hbm import device_memory_stats, hbm_ledger
from hadoop_tpu_torch.obs.trainer import TrainerTelemetry, anatomy_delta
from hadoop_tpu_torch.parallel import MeshPlan, Trainer, adamw_init
from hadoop_tpu_torch.parallel.collectives import hash_partitioner
from hadoop_tpu_torch.parallel import overlap
from hadoop_tpu_torch.parallel.lowp import ParityConfig
from hadoop_tpu_torch.parallel.mesh import param_specs
from hadoop_tpu_torch.parallel.lowp import quant as lowp_quant
from hadoop_tpu_torch.parallel.lowp.guard import loss_curve_report
from hadoop_tpu_torch.mapreduce.device_shuffle import (device_group_reduce,
                                                       device_shuffle,
                                                       device_terasort)
from hadoop_tpu_torch.parallel import optimizer
from hadoop_tpu_torch.parallel.checkpoint import list_checkpoints
from hadoop_tpu_torch.parallel.optimizer import (AdamWState, tree_leaves,
                                                 tree_map)
from hadoop_tpu_torch.parallel.ring_attention import ring_attention
from hadoop_tpu_torch.serving.kvstore import DFSTier
from hadoop_tpu_torch.serving.loader import load_serving_params
from hadoop_tpu_torch.serving.longctx import (ContextParallelPrefiller,
                                              WorkingSetDecoder,
                                              longctx_plane_from_conf,
                                              run_prefill_ab)
from hadoop_tpu_torch.serving.longctx import decode as decode_module
from hadoop_tpu_torch.serving import engine as engine_module
from hadoop_tpu_torch.serving import weightplane
from hadoop_tpu_torch.serving.service import ServingReplica
from hadoop_tpu_torch.obs.doctor import FleetDoctor
from hadoop_tpu_torch.registry import RegistryClient, RegistryServer
from hadoop_tpu_torch.serving.router import (ServingRouter, affinity_key,
                                             rendezvous_owner, replica_path)
from hadoop_tpu_torch.tracing import global_tracer
from hadoop_tpu_torch.tools.profile_flagship import (MOE_RANGES,
                                                     TRAIN_RANGES,
                                                     decoding_engine,
                                                     moe_train_config,
                                                     trace, train_profile)

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
# 8 (scores of large range); last a rank of dist_train's dp2 x sp2 ring
# (flagship-1b, [4, 2048]); each in bf16 and float32
PARTIAL_SHAPES = [(4, 2048, 2048, 32, 8, 128, 1), (4, 512, 512, 16, 8, 128, 1),
                  (2, 256, 512, 8, 2, 128, 1), (2, 256, 256, 4, 2, 64, 1),
                  (2, 128, 128, 4, 4, 128, 1), (1, 384, 128, 8, 2, 128, 1),
                  (1, 128, 384, 8, 2, 128, 1), (1, 512, 1024, 8, 2, 128, 8),
                  (2, 1024, 1024, 16, 8, 128, 1)]
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
# llama3-8b CP prefill: full width, ``layers`` of its 32 layers (the cut
# keeps the script's margin under its time limit; every check below is
# per layer or on the logits); sp 4 ranks, 16-token blocks; three
# prompts of random tokens, each from its own seed: 8192 tokens (no padding; the
# main path's counted and timed run), 8100 (padding and a 4-token tail
# block) and 8000 (padding, no tail). Rank 0's K/V must equal the
# single-device forward's bit for bit (the same GEMMs and kernel tiles).
# The logits and every layer's K/V from position S/sp on are held
# against the single-device forward (the causal kernel at S 8192) by way
# of a calibration: the same forward with plain attention, which lies
# 1.8e-2 to 2.4e-2 of max |ref| from the kernel forward on this metric
# (bf16 noise, seen through all 32 layers; each value is a few ulps of
# the largest). The CP prefill may lie at most ``cal_factor`` times as far as
# the calibration, value by value (logits, and K and V per layer). Seen
# on an H100 over the three prompts at 32 layers: 0.75 to 1.33 times.
LONGCTX = dict(model="llama3-8b", layers=8, sp=4, block=16,
               tokens=(8192, 8100, 8000), cal_factor=2.0, timed=3)
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
# the fleet plane's reads in phases trainer and door and stage
# trainer_mesh: their ms and the wall seconds the doors added (the
# "fleet" line)
FLEET = {}
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
# The speculate phase: flagship-1b at SERVE_KW's sizes with speculate_k
# ``k`` and n-grams up to ``ngram``, in float32 and bf16, each with
# speculation on and off in turn. ``requests`` prompts, each a distinct
# ``head``-token head and a ``template``-token template repeated to
# 96-288 tokens (templated answers and code, what n-gram drafting
# serves); the first ``greedy`` greedy, the rest sampled at
# ``temperature`` and ``top_k``; ``max_new`` tokens each. A float32
# greedy request may leave speculation-off's tokens only at a near-tie
# (top-2 gap under TIE_REL of |max logit| in the teacher-forced forward),
# and at most ``f32_ties`` of them may; in bf16 the largest gap between a
# greedy token's logit and the forward's maximum, speculation on, must
# stay within ``bf16_cal`` times the gap of speculation off.
SPECULATE = dict(k=4, ngram=3, requests=16, greedy=12, head=8, template=24,
                 max_new=64, temperature=0.8, top_k=40, f32_ties=1,
                 bf16_cal=2.0)
# The kvtiers phase: the step-6 checkpoint (flagship-1b bf16) at SERVE_KW's
# sizes and the default pool (257 pages of 1,179,648 B), a host ring of
# ``host_bytes`` (113 raw pages) and a DFS store on the local disk with
# min-refs 1. ``heads`` shared heads of ``head`` tokens, each with
# ``prompts // heads`` tails of 64-108 tokens, ``max_new`` tokens each, in
# waves of ``wave``; then ``replay`` of them again (host), on a second
# engine with no ring (DFS), a ``handoff``-token prefill_to_store, a drain
# persist, TTFT of one ``ttft_prompt``-token prompt from each tier, the
# page movers and the DFS tier timed per page over ``timed_pages``, an
# int8 pass, and a prefill-role replica handing a prompt to a decode-role
# replica through the door.
KVTIERS = dict(host_bytes=128 << 20, prompts=32, heads=8, head=192,
               tails=(64, 108), max_new=32, wave=8, replay=8, handoff=600,
               ttft_prompt=300, timed_pages=32)
# The fleet_front phase: the serving fleet's front half on the card. The
# port's RegistryServer on port 0; three ServingReplicas of the step-6
# checkpoint (flagship-1b bf16 at SERVE_KW's sizes), roles prefill, decode
# and mixed, on one DFS KV tier directory, each registered through its own
# RegistryClient under ``service``; the port's ServingRouter in front
# (prompts of at least ``offload_min`` tokens are offered to the prefill
# replica first) and the port's FleetDoctor beside them. KVTIERS'
# ``ttft_prompt``-token prompt goes through the router's prefill handoff;
# ``groups`` groups of ``per_group`` prompts, each group sharing a
# ``prefix``-token head (a tail of ``tail`` tokens, ``max_new`` tokens
# out), are streamed through the router, and a second such set straight
# to each prompt's rendezvous owner (TTFT: the client's wait for the first
# streamed line); one ``eager_prompt``-token prompt through the router and
# one straight to the decode replica on its eager step (kernel launches a
# step); ``polls`` doctor polls; ``drained`` requests after a drain of the
# mixed replica.
FLEET_FRONT = dict(service="fleet-front", groups=4, per_group=3, prefix=64,
                   tail=(8, 24), max_new=16, offload_min=256,
                   eager_prompt=48, eager_tokens=8, polls=2, drained=4)
# The weight plane (serving.parity=relaxed): int8 matmul weights with one
# f32 scale per group of ``group`` elements along the contraction dim,
# the embedding, head, norms and router left in the model's dtype.
WEIGHTS_INT8 = weightplane.WeightPlaneConfig(tier="relaxed", group=64)
# The weightplane phase: the step-6 checkpoint (flagship-1b bf16) through
# quantized_load; its A/B guard against the bf16 parameters; the int8
# engine at SERVE_KW's sizes through its graphs and its eager step on
# ``prompts`` greedy requests of ``max_new`` tokens; float32 int8 greedy
# tokens against the plain greedy loop over dequantize_params (near-ties
# as the serving phase's, TIE_REL); decode-only and fused step times int8
# against bf16 on the door's requests; sizing at ``budget`` bytes with
# ``max_lanes``; ``door`` requests through ServingReplica with
# serving.parity=relaxed against the in-process int8 engine's tokens.
WEIGHTPLANE = dict(prompts=5, max_new=32, budget=int(2.5e9), max_lanes=64,
                   door=8, alloc_slack=0.01)
# The dfs_daemons phase: the port's own MiniDFSCluster (its NameNode and
# ``datanodes`` DataNodes, in a temporary directory on the host) at the
# reference's defaults for replication (3), ``dfs.blocksize`` (128 MiB),
# checksums (CRC32C) and the reconstruction timeout (30 s), with the
# test intervals of ``fast_conf`` and the NameNode's redundancy pass run
# by the phase (``redundancy_s`` is the background monitor's period, out
# of the way). flagship-1b at full width with its depth cut to
# ``layers`` (time and disk: ≈ 2.29 GB a checkpoint, three replicas of
# it): Trainer on htpu:// for ``steps`` steps with an interval save at
# ``save_at`` that a second Trainer resumes from; against an
# uninterrupted run on file://, whose explicit save and restore time the
# same checkpoint there. Then one DataNode holding the first shard dies
# (the loader serves the checkpoint, the NameNode brings every block back
# to 3 live replicas within ``timeout_s``), the NameNode restarts from its
# fsimage and edits, ``ec_policy`` stripes ``ec_units`` units of
# ``ec_unit`` seeded bytes (the parity units held to the card's encode, a
# read with data units 0-2 down, the unit still missing after two come
# back rebuilt by the port's EC worker and held to the card's decode),
# and an engine's KV pages go to the DFS tier at min-refs 1 for a second
# engine with no host ring to replay KVTIERS["replay"] prompts from
# (``max_new`` tokens each). ``ec_unit`` is 8 MiB, not 64: the client's
# degraded read fetches one 64 KiB cell a connection and decodes each
# missing cell apart, 3.4 MB/s for 6 × 64 MiB on the card's host (118 s;
# PERF.md §6).
DFS_DAEMONS = dict(datanodes=10, layers=2, steps=3, save_at=2,
                   timeout_s=120.0, redundancy_s="1h", ec_policy="RS-6-3-64k",
                   ec_units=6, ec_unit=8 << 20, max_new=16)
# The dfs_ha phase: the port's MiniQJMHACluster in the script's process
# (``journalnodes`` JournalNodes; two NameNodes over their quorum journal
# with automatic failover through the JournalNodes' lease; one observer;
# ``datanodes`` DataNodes; replication 3, 128 MiB blocks, the HA
# intervals of MiniQJMHACluster: tailing 0.2 s, the lease 1.5 s, health
# checks 0.3 s; ``block_bytes`` the reference's default) under
# flagship-1b at DFS_DAEMONS' depth, steps and save_at, on its token
# file. Gate 1: Trainer on the nameservice to the interval save at
# ``save_at``; once the save's first shard file has appeared, the active
# NameNode is stopped while its answer to that file's first
# ``add_block`` is held in flight (before the manifest is there); the
# port's client retries the call on the new active, which answers with
# the same block (ROADMAP C 26: the reference's client fails the write
# there), and the save completes through the client's failover
# (``save_with_failover_s`` runs from that add_block); a second
# Trainer, started with JournalNode 0 down, restores at ``save_at`` (the
# leaves bit-equal to the first trainer's) and trains to ``steps``, its
# losses those of dfs_daemons' file:// run; it saves nothing (the save
# without a failover is dfs_daemons', on the same bytes).
# Gate 2: the stopped NameNode restarts as standby, tails to the active's
# txid and checkpoints; the port's oiv dump of that image lists
# /flagship as the active does; dfsadmin -getServiceState reads one
# active and one standby. Gate 3: load_serving_params through a client
# with observer reads on loads the checkpoint the failover landed in, its
# leaves bit-equal to the trainer's and one prompt's greedy tokens
# equal. ``timeout_s`` bounds each wait.
DFS_HA = dict(journalnodes=3, datanodes=3, block_bytes=128 << 20,
              timeout_s=120.0)
# The moe phase: mixtral-8x7b at full width and all 32 layers from an int8
# plane built on the card (group 64), DecodeEngine with ``hbm_bytes``,
# ``max_lanes``, block 16, ``max_context`` and chunk 64, speculation off;
# ``requests`` greedy requests of ``max_new`` tokens on prompts of
# ``prompt_lengths``, at capacity factor ``no_drop`` (n_experts / top_k:
# C >= T, no token can drop) and again at the preset's 1.25. The
# layer-streamed plain forward over the dequantized plane runs in float32
# (the reference) and in bf16 (its calibration: ``cal`` is the largest
# |bf16 - float32| logit over the compared rows); each emitted token's
# gap to the float32 reference's maximum must stay within
# ``cal_factor`` times ``cal``. Graph against eager on one request of
# ``eager_new`` tokens.
MOE = dict(model="mixtral-8x7b", hbm_bytes=int(70e9), max_lanes=8,
           block=16, max_context=4096, chunk=64, requests=16, max_new=64,
           prompt_lengths=(24, 40, 57, 71, 96, 120, 33, 64), no_drop=4.0,
           cal_factor=2.0, eager_new=16)
# The moe_train phase: mixtral-8x7b at full width (d_model 4096, 32/8
# heads of 128, d_ff 14336, 8 experts, top-2, vocab 32000, bf16, capacity
# factor 1.25), cut to 2 of its 32 layers and to 4096 tokens of the
# published 32768 context (profile_flagship's MOE_TRAIN_MODEL), on
# [``batch``, ``seq``] tokens, full remat, AdamW at ``lr``. First the
# flash kernels at its attention shape (1, 4096, 32, 8, 128) bf16 against
# their plain versions with the kernel and backward phases' tolerances;
# then ``steps`` make_train_step steps on one seeded batch, each step's
# launches pinned, and ``profiled`` more traced by profile_flagship (the
# step's ranges and the MoE MLP's "moe.route" and "moe.experts"). The
# moe_trainer phase runs the same model through Trainer as the trainer
# phase runs flagship-1b (TRAINER's steps, crash_at and loss_rtol; a
# token file of ``file_batches`` batches), on a filesystem in memory: a
# checkpoint of this model is 3.16e10 B (its largest file, one float32
# moment of w_gate, 3.76e9 B), and the script keeps its writes to disk
# under 45 GiB, of which the trainer phase's two flagship-1b checkpoints
# take 1.97e10 B. So it writes one checkpoint, the crashed run's interval
# save, which the resumed run restores and load_serving_params serves
# into a DecodeEngine (SERVE_KW's sizes) against one on the crashed
# trainer's parameters: the greedy tokens of ``prompts`` of the moe
# phase's prompts, ``max_new`` each.
MOE_TRAIN = dict(batch=1, seq=4096, steps=6, lr=3e-4, profiled=1, prompts=4,
                 max_new=16, file_batches=4.5, io_workers=4)
# The ec phase: one striped block group of hadoop_tpu's default
# dfs.blocksize (``unit_bytes`` per unit; hadoop_tpu/conf/registry.py) of
# seeded random bytes for each RS policy of hadoop_tpu/io/erasurecode.py
# (RS(3,2), RS(6,3), RS(10,4)), through encode_cells and decode_cells
# (the main path: one launch each), the data restored after each erasure
# pattern of EC_PATTERNS; then the kernel's parity against the plain
# version's and the numpy host coder's (``_gf_matmul`` over column slices
# in ``host_threads`` threads), byte for byte, and the same at odd
# ``odd``-byte cells. GB/s of data: the kernel (CUDA events, ``timed``
# launches), the plain version (one call), the host coder (encode on the
# whole group; decode on the first ``host_slice`` bytes of each unit).
# Phases dist_parity and dist_train: the parallel plans of
# parallel/train.py on four ranks, each a process started by spmd.launch
# (spawn) on this one card. NCCL refuses a communicator whose ranks share
# a GPU, so the ranks join a gloo world and every collective and every
# pipeline hop of a CUDA tensor travels through host memory
# (parallel/spmd.py): the kernels and shapes are each rank's, the times
# are four ranks on one card, not a multi-GPU deployment's, and no
# pipeline bubble a deployment would see. DIST_PLANS gives each plan its
# model and depth (full width always): flagship-1b at 4 of its 18 layers
# for pp 4 and pp*vpp 4, which 4 divides (18 divides by neither), and at
# 2 for every other plan (the plans ran at 6 and 8 layers until the
# tp_serving phase needed their time, and at 4 until the dfs_daemons
# phase did: at 4 layers the two phases took 113.4 and 90.9 s of host
# transport and setup on an H100 80GB HBM3 whose whole script ran 1295
# s); mixtral-8x7b at 1 layer (a dp2 x ep2
# rank holds ~1.0e9 parameters, ~1.2e10 B with AdamW, so four ranks fit
# the card and not at 2 layers; ep2 x tp2 would fit 2, but the plans' two
# phases ran 587 s at 2 and 3 steps, too long beside the script's other
# ~650 s). dist_parity: float32, one step from the seed-0
# weights on the train phase's [4, 2048] batch (SGD at lr 1e-2; ZeRO-1
# AdamW at TRAIN's lr), MoE at capacity factor `parity_factor` (a rank
# routes its own tokens at the capacity of their count; at 4.0 nothing
# drops, so its routing is the whole batch's), loss and grad norm at
# rtol `parity_tol` against the single-device step at the same depth,
# and at `sample` flat indices of every leaf, gathered: the updated
# values (max |d| over max |value| <= parity_tol) and the updates, max
# |d| over max |update|: for SGD <= PARITY_TOL, the parity phase's rule;
# for AdamW <= `adamw_update_tol`; or, where an update is too small for
# its leaf's float32 values to show that share of it, <= its floor: the
# spacing at the leaf's largest value over its largest update, one
# rounding apart (mixtral's mlp_norm_w, ~1 + 1e-5 after one SGD step at
# lr 1e-2, read exactly one spacing, 1.2e-2 of its update, on an H100
# 80GB HBM3). A first AdamW step moves each element
# by lr * (g/(|g| + eps) [+ wd * p]), so an element whose clipped
# gradient is near eps turns the sums' reordering into a visible share of
# lr: the sound reading was 1.35e-2 (final_norm_w, on an H100 80GB HBM3),
# while an update left out reads 1.0 by this rule. The phase also reads
# that control (the state left unchanged) and fails unless every leaf's
# control exceeds the limit, and it records, for each leaf's worst
# element, |g|/eps as the single device's update implies it.
# dist_train: the same plans in bf16 with AdamW (MoE at the preset's
# capacity factor), `train_steps` steps each (3 until the pipeline and
# ep plans came: 2 keeps the script inside its time), per rank the step time
# (CUDA events), the flash launches per step (exact, by plan, stage and
# schedule), peak memory, the bytes each axis put on the wire, the stage,
# the most stage inputs its schedule stashed at once (at most 2P - 1
# under 1F1B, 2V under the interleaved one) and the share of token-expert
# choices dropped at capacity; losses within `loss_rtol` of the
# single-device bf16 step's at the same depth (bf16 sums in other
# orders: 2.6e-4 at most at 4 layers). A MoE plan's drops are its ranks'
# (each routes its own tokens at the capacity of their count) and not
# the single device's, so only its first loss, from the same weights, is
# held; the later ones train another function (6.2e-2 apart at step 2 on
# an H100 80GB HBM3, dropped shares 0.21 a rank against 0.028) and are
# recorded.
DIST = dict(world=4, backend="gloo", sample=4096,
            sgd_lr=1e-2, parity_tol=5e-4, adamw_update_tol=0.1,
            adamw_eps=1e-8, adamw_wd=0.1, parity_factor=4.0,
            train_steps=2, loss_rtol=1e-2)
# (name, model, layers, mesh, pipeline options); a "zero1" plan trains
# with ZeRO-1 AdamW
DIST_PLANS = [
    ("dp2_tp2", "flagship-1b", 2, {"dp": 2, "tp": 2}, {}),
    ("dp2_tp2_megatron_sp", "flagship-1b", 2,
     {"dp": 2, "tp": 2, "megatron_sp": True}, {}),
    ("dp2_sp2_ring", "flagship-1b", 2, {"dp": 2, "sp": 2}, {}),
    ("dp2_sp2_ulysses", "flagship-1b", 2,
     {"dp": 2, "sp": 2, "sp_mode": "ulysses"}, {}),
    ("zero1_dp4", "flagship-1b", 2, {"dp": 4}, {}),
    ("pp4_1f1b", "flagship-1b", 4, {"pp": 4}, {"n_microbatches": 4}),
    ("dp2_pp2_vpp2_interleaved", "flagship-1b", 4,
     {"dp": 2, "pp": 2, "vpp": 2},
     {"n_microbatches": 2, "pipeline_schedule": "interleaved"}),
    ("pp2_tp2_megatron_sp_gpipe", "flagship-1b", 2,
     {"pp": 2, "tp": 2, "megatron_sp": True},
     {"n_microbatches": 2, "pipeline_schedule": "gpipe"}),
    ("zero1_dp2_pp2", "flagship-1b", 2, {"dp": 2, "pp": 2},
     {"n_microbatches": 2}),
    ("dp2_ep2", "mixtral-8x7b", 1, {"dp": 2, "ep": 2}, {}),
    ("ep2_tp2", "mixtral-8x7b", 1, {"ep": 2, "tp": 2}, {}),
]
# The flash kernels at the new main-path shapes (B, S, Hq, Hkv, D) of
# PR 14 and this slice, bf16: the Ulysses prefill of llama3-8b at sp 4
# folded, the tp2 and Ulysses dp2 x sp2 training ranks (and a pp2 x tp2
# GPipe microbatch), the ring's diagonal in ring training (forward only:
# the ring's backward is the plain partial's), a ZeRO-1 dp4 rank (and a
# one-row pipeline microbatch), the mixtral dp2 x ep2 and ep2 x tp2
# ranks.
DIST_SHAPES = [("ulysses_prefill", (4, 8192, 8, 2, 128), False),
               ("tp2_ulysses_train", (2, 2048, 8, 4, 128), True),
               ("ring_train_diagonal", (2, 1024, 16, 8, 128), False),
               ("zero1_dp4_train", (1, 2048, 16, 8, 128), True),
               ("mixtral_dp2_ep2_train", (1, 2048, 32, 8, 128), True),
               ("mixtral_ep2_tp2_train", (2, 2048, 16, 4, 128), True),
               ("elastic_dp4_train", (3, 2048, 16, 8, 128), True),
               ("elastic_dp3_train", (4, 2048, 16, 8, 128), True)]
# The trainer_mesh phase: Trainer on four gloo ranks sharing the card
# (spmd.launch, dist_plans.trainer_ops), flagship-1b at full width, bf16
# AdamW, TRAIN's [4, 2048] global batch, full remat, checkpoints on the
# port's LocalFileSystem under the phase's own temporary root. dp2×tp2
# at ``layers``: ``steps`` uninterrupted, a run with ``interval`` saves
# that crashes after ``crash_at`` (as the trainer phase's) and one that
# resumes from step ``interval``; ZeRO-1 dp4 at ``layers``: ``z1_steps``,
# a save, one more step, and a dp2×tp2 trainer (no ZeRO-1) restoring the
# save through "reshard" and taking that step; dp2×pp2×vpp2 interleaved
# (M 2) at ``vpp_layers`` (which pp·vpp divides): ``vpp_steps``, a save,
# one more step, and a fresh trainer restoring and taking it. A token
# file of ``file_batches`` batches; samples of ``sample`` flat indices a
# leaf. ``layers`` and ``vpp_layers`` are dist_train's depths for those
# plans, whose launches a rank-step must equal (6 and 8 until the
# tp_serving phase needed the time; ``layers`` 4 until the dfs_daemons
# phase did).
TRAINER_MESH = dict(layers=2, vpp_layers=4, steps=4, crash_at=3,
                    interval=2, z1_steps=2, vpp_steps=2, file_batches=4.5,
                    sample=4096)
# The elastic leg of the trainer_mesh world (the reference's
# benchmarks/flight_smoke.py elastic leg at flagship-1b width): ZeRO-1
# dp4 at ``layers`` and global batch [``batch``, 2048] (12 divides by 4
# and by 3), bf16 AdamW, full remat, interval saves every ``interval``
# steps, ``steps`` steps in all. The scripted doctor
# (``dist_plans.scripted_doctor``) flags rank 2 from step ``flag_at``
# (a demote at the second flagged poll, step ``flag_at`` + 1: the
# protective checkpoint) and marks it dead from step ``dead_at`` (the
# evict: dp3 over ranks 0, 1, 3 reshard-restores the protective snapshot
# and re-runs the lost steps). The twin: a dp4 trainer restoring the
# same snapshot (hard-linked into a directory of its own, where it is
# the newest), for the steps after it. ``step_rtol``: each step after
# the reshard against the twin's (the reference dryrun's acceptance,
# __graft_entry__.py); ``guard_rel_tol``: loss_curve_report's, as the
# reference's smoke. At 2 layers (6 until the tp_serving phase needed the
# time, 4 until the dfs_daemons phase did).
ELASTIC = dict(layers=2, batch=12, steps=8, interval=4, flag_at=4,
               dead_at=6, file_batches=10.5, step_rtol=5e-4,
               guard_rel_tol=0.25,
               config=dict(enabled=True, poll_steps=1, min_dp=1,
                           demote_windows=2, evict_windows=4,
                           dead_windows=1, cooldown_polls=2))
# The shuffle phase: the device shuffle on a folded axis of ``ranks``
# ranks on the one card, at the sizes of Hadoop's own examples:
# TeraSort's 100-byte records (hadoop-mapreduce-examples terasort; here
# an int32 key in [0, ``key_bound``) and a uint8[``payload``] value whose
# first 4 bytes carry the record's index) and WordCount's (word id, 1)
# pairs (int32, int32; the ids drawn Zipf(``zipf``) over ``vocab`` ids),
# ``records`` of each, at capacity factor ``factor``; one hash exchange
# of the TeraSort records and one of the WordCount records at
# ``overflow_factor`` (which overflows). ``peak_limit``: the most device
# memory the phase may take; ``timed``: calls timed after a warm-up.
SHUFFLE = dict(ranks=4, records=1 << 25, key_bound=1 << 30, payload=96,
               vocab=1 << 20, zipf=1.1, factor=2.0, overflow_factor=0.5,
               peak_limit=4e10, timed=3)
EC = dict(unit_bytes=134217728, schemas=((3, 2), (6, 3), (10, 4)),
          odd=1021, timed=10, host_slice=16 << 20, host_threads=8)
# lost units per schema: two data units and one parity unit, data units
# 0, 2 and 5 (tests/test_erasure_coding.py:234-262, cut to m losses), and
# for RS(10,4) four data units
EC_PATTERNS = {(3, 2): ((1, 4), (0, 2)),
               (6, 3): ((1, 4, 8), (0, 2, 5)),
               (10, 4): ((1, 4, 12), (0, 2, 5), (2, 5, 8, 9))}
# the 32-bit integer units' rate, for the EC kernel's own operation count:
# 64 a clock on each of the 132 SMs (NVIDIA Hopper architecture white
# paper) at the 1980 MHz boost clock (H100 SXM data sheet); and shared
# memory's, for its table loads: 32 banks of 4 bytes a clock on each SM
INT32_OPS_PER_S = 64 * 132 * 1.98e9
SHARED_BYTES_PER_S = 128 * 132 * 1.98e9


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


_T0 = time.monotonic()


def emit(obj) -> None:
    """Print one JSON line; a phase's line carries ``at_s``, the seconds
    since the script started (the script must end within its limit)."""
    if "phase" in obj:
        obj = dict(obj, at_s=time.monotonic() - _T0)
    print(json.dumps(obj), flush=True)


def free_device() -> None:
    """Return what dropped tensors held to the card: collect the reference
    cycles that keep an engine (and its captured graphs) alive, drop the
    cuBLAS workspaces PyTorch keeps for every (handle, stream) it has
    seen (each engine and decoder captures on a stream of its own: 32 MiB
    each, never freed otherwise), then empty the allocator's cache. The
    moe phase fills the card to within a few GB, and what earlier phases
    leave there changes which GEMM algorithms its eager step gets."""
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()


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


def norm_counts():
    return norms.launches_fwd, norms.launches_bwd


def train_counts():
    """A training run's launches: (fwd, dq, dkv, adamw, grad_sq,
    rms_norm_fwd, rms_norm_bwd)."""
    return counts()[:3] + optimizer_counts() + norm_counts()


def train_counts_want(cfg, n_leaves):
    """One full-remat training step's launches, as ``train_counts`` lists
    them: the causal kernel in the forward and its recompute, one dQ and
    one dK/dV per layer, AdamW per leaf, the squared norm per leaf plus
    its finish; RMSNorm's forward 2 per layer in the forward and again in
    the recompute plus the final norm's (4L + 1), and its backward (pass
    and dw finish) for each of the 2L + 1 norms."""
    L = cfg.n_layers
    return [2 * L, L, L, n_leaves, n_leaves + 1, 4 * L + 1, 2 * (2 * L + 1)]


def zero_counts():
    flash.launches = flash.launches_bwd_dq = flash.launches_bwd_dkv = 0
    flash.launches_partial = 0
    optimizer.launches = optimizer.launches_grad_sq = 0
    norms.launches_fwd = norms.launches_bwd = 0
    weightplane.launches_dequant = 0


# ------------------------------------------------------------------ phases

KERNEL_SOURCES = ["flash_fwd", "flash_bwd", "adamw", "dequant", "rmsnorm",
                  "ec_gf256"]


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


# The DFS client's modules: imported by the build phase, which then
# checks that nothing of JAX or the JAX package came with them.
DFS_MODULES = ("hadoop_tpu_torch.dfs.client",
               "hadoop_tpu_torch.dfs.client.dfsclient",
               "hadoop_tpu_torch.dfs.client.filesystem",
               "hadoop_tpu_torch.dfs.client.streams",
               "hadoop_tpu_torch.dfs.client.striped",
               "hadoop_tpu_torch.dfs.client.shortcircuit",
               "hadoop_tpu_torch.dfs.protocol",
               "hadoop_tpu_torch.dfs.protocol.records",
               "hadoop_tpu_torch.dfs.protocol.datatransfer",
               "hadoop_tpu_torch.dfs.protocol.blocktoken",
               "hadoop_tpu_torch.security.sasl",
               "hadoop_tpu_torch.ipc.retry", "hadoop_tpu_torch.util.crc")
# The DFS client's native CRC32C on the host: ``python_bytes`` seeded
# bytes with an unaligned tail held against the pure-Python backend (and
# a chunk corrupted in the middle), ``timed_bytes`` timed ``iters``
# times for the host CPU's rate.
CRC = dict(python_bytes=(4 << 20) + 1021, timed_bytes=64 << 20, iters=5,
           seed=21)
# The crypto_ctr line (host CPU): ``nbytes`` of seeded bytes through the
# cipher alone in memory (one ``_crypt`` call), then through the port's
# CryptoOutputStream into a local file in ``write`` byte writes,
# then back through CryptoInputStream in reads of the ``reads`` sizes
# (odd, so most start inside an AES block) and ``preads`` positioned
# reads at unaligned offsets; the plaintext must come back byte for byte
# and the file must differ from it. Without the ``cryptography`` package
# the line says ``available: false`` (encryption zones cannot be opened
# on that host) and nothing else runs.
CRYPTO = dict(nbytes=256 << 20, write=(4 << 20) + 3, reads=(1_000_003, 7,
              (8 << 20) + 5, 15), preads=64, seed=23, key_bits=128)


def _crc32c_host():
    """Build the native CRC32C from ``hadoop_tpu_torch/native/crc32c.cc``
    with the host compiler (failing if the build fails or the native
    backend is not live), hold it against the pure-Python backend, time
    it on the host CPU, and import the DFS client's modules."""
    import importlib
    from hadoop_tpu_torch.util import crc as crc_module
    t0 = time.monotonic()
    crc_module.build()
    seconds = time.monotonic() - t0
    require(crc_module.native_available(),
            "the native CRC32C built but is not the live backend")
    data = np.random.default_rng(CRC["seed"]).integers(
        0, 256, CRC["python_bytes"], dtype=np.uint8).tobytes()
    checksum = crc_module.DataChecksum(512)
    sums = checksum.checksums_for(data)
    bad = bytearray(data)
    flip = len(data) // 2 + 77
    bad[flip] ^= 0x5A
    errors = {}
    for backend in ("native", "python"):
        ctx = crc_module.python_backend() if backend == "python" \
            else contextlib.nullcontext()
        with ctx:
            got = (crc_module.crc32c(data), crc_module.crc32c(
                memoryview(data)[3:], 0x1234), checksum.checksums_for(data))
            try:
                checksum.verify(bytes(bad), sums, base_pos=4096)
                errors[backend] = None
            except crc_module.ChecksumError as e:
                errors[backend] = (e.pos, str(e))
        if backend == "native":
            native = got
    require(native == got, "native CRC32C disagrees with the pure-Python "
            "backend")
    require(errors["native"] == errors["python"] and errors["native"] and
            errors["native"][0] == 4096 + flip // 512 * 512,
            f"DataChecksum.verify of a corrupted chunk: {errors}")
    big = np.random.default_rng(CRC["seed"] + 1).integers(
        0, 256, CRC["timed_bytes"], dtype=np.uint8).tobytes()
    big_sums = checksum.checksums_for(big)
    rates = {}
    for name, fn in (("crc32c", lambda: crc_module.crc32c(big)),
                     ("checksums_for", lambda: checksum.checksums_for(big)),
                     ("verify", lambda: checksum.verify(big, big_sums))):
        fn()
        t = time.perf_counter()
        for _ in range(CRC["iters"]):
            fn()
        rates[name] = CRC["iters"] * len(big) / (
            time.perf_counter() - t) / 1e9
    for name in DFS_MODULES:
        importlib.import_module(name)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "hadoop_tpu"))
    require(not leaked, f"the DFS client's imports loaded {leaked}")
    emit({"phase": "build", "library": "crc32c", "seconds": seconds,
          "source": "hadoop_tpu_torch/native/crc32c.cc",
          "built": str(crc_module.target().name), "native": True,
          "python_bytes_checked": len(data),
          "corrupt_chunk_pos": errors["native"][0],
          "host_cpu_gb_per_s": rates, "host_cpu_bytes": len(big),
          "dfs_modules_imported": len(DFS_MODULES)})


def _crypto_ctr_host():
    """The crypto_ctr line: the port's AES-CTR streams on the host CPU
    (see CRYPTO), with the seconds their decrypt rate adds to reading
    flagship-1b's checkpoint bytes (bf16 parameters, counted on the meta
    device)."""
    import importlib.util
    if importlib.util.find_spec("cryptography") is None:
        emit({"crypto_ctr": {"available": False, "host": "cpu",
                             "package": "cryptography"}})
        return
    from hadoop_tpu_torch.crypto.streams import (CryptoInputStream,
                                                 CryptoOutputStream, _crypt)
    t_step = time.monotonic()
    rng = np.random.default_rng(CRYPTO["seed"])
    key = rng.integers(0, 256, CRYPTO["key_bits"] // 8,
                       dtype=np.uint8).tobytes()
    iv = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    data = rng.integers(0, 256, CRYPTO["nbytes"], dtype=np.uint8).tobytes()
    view = memoryview(data)
    _crypt(key, iv, 0, data[:4096])         # loads the OpenSSL backend
    t0 = time.perf_counter()
    whole = _crypt(key, iv, 0, data)        # the cipher alone, in memory
    cipher_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory(prefix="chip-smoke-ctr-") as tmp:
        path = f"{tmp}/zone.bin"
        t0 = time.perf_counter()
        with CryptoOutputStream(open(path, "wb"), key, iv) as out:
            for at in range(0, len(data), CRYPTO["write"]):
                out.write(view[at:at + CRYPTO["write"]])
        write_s = time.perf_counter() - t0
        with open(path, "rb") as f:
            raw_head = f.read(1 << 20)
        require(os.path.getsize(path) == len(data) and
                raw_head != data[:1 << 20] and
                raw_head == whole[:1 << 20],
                "the encrypted file is not the stream's ciphertext")
        parts, sizes = [], CRYPTO["reads"]
        t0 = time.perf_counter()
        with CryptoInputStream(open(path, "rb"), key, iv) as f:
            i = 0
            while True:
                chunk = f.read(sizes[i % len(sizes)])
                if not chunk:
                    break
                parts.append(chunk)
                i += 1
        read_s = time.perf_counter() - t0
        back = b"".join(parts)
        at_rng = np.random.default_rng(CRYPTO["seed"] + 1)
        with CryptoInputStream(open(path, "rb"), key, iv) as f:
            preads_ok = all(
                f.pread(int(at), int(n)) == data[int(at):int(at) + int(n)]
                for at, n in zip(at_rng.integers(0, len(data) - 70_000,
                                                 CRYPTO["preads"]),
                                 at_rng.integers(1, 70_000,
                                                 CRYPTO["preads"])))
    require(back == data, "CryptoInputStream did not return the plaintext")
    require(preads_ok, "a positioned CryptoInputStream read disagrees")
    cfg = get_config("flagship-1b")
    ckpt_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(
        init_params(cfg, torch.Generator(), device="meta")))
    write_gb_s = len(data) / write_s / 1e9
    read_gb_s = len(data) / read_s / 1e9
    emit({"crypto_ctr": {
        "available": True, "host": "cpu", "bytes": len(data),
        "write_chunk": CRYPTO["write"], "read_chunks": list(sizes),
        "preads": CRYPTO["preads"], "write_s": write_s, "read_s": read_s,
        "encrypt_gb_per_s": write_gb_s, "decrypt_gb_per_s": read_gb_s,
        "cipher_only_gb_per_s": len(data) / cipher_s / 1e9,
        "plaintext_equal": True,
        "flagship_1b_checkpoint_bytes": ckpt_bytes,
        "flagship_1b_decrypt_s": ckpt_bytes / (read_gb_s * 1e9),
        "seconds": time.monotonic() - t_step}})


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
    _crc32c_host()
    _crypto_ctr_host()
    print(smi, flush=True)
    require(not problems, f"ptxas reports: {problems}")
    return smi


def fwd_record(q, k, v):
    """The flash forward on q, k, v against its plain version: max |dO|
    and |d lse|, the tolerance for the dtype, ms beside the plain version
    and SDPA, and the rates against its bound."""
    b, s, hq, d = q.shape
    scale = d ** -0.5
    o, lse = flash.flash_forward(q, k, v, scale)
    o_ref, lse_ref = flash.flash_attention_ref(q, k, v, scale)
    torch.cuda.synchronize()
    rec = {"max_abs_err": (o.float() - o_ref.float()).abs().max().item(),
           "max_abs_err_lse": (lse - lse_ref).abs().max().item(),
           "tol": list(TOLERANCE[q.dtype])}
    del o, lse, o_ref, lse_ref
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    rec.update(
        ms=cuda_ms(lambda: flash.flash_forward(q, k, v, scale), 20),
        plain_ms=cuda_ms(lambda: flash.flash_attention_ref(q, k, v, scale),
                         5),
        library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, scale=scale, enable_gqa=True), 20))
    return add_rates(rec, flash_bound(b, s, hq, k.shape[2], d, q.dtype))


def fwd_ok(rec):
    tol_o, tol_lse = rec["tol"]
    return rec["max_abs_err"] <= tol_o and rec["max_abs_err_lse"] <= tol_lse


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
            rec = {"phase": "kernel", "name": "flash_fwd",
                   "shape": [b, s, hq, hkv, d], "dtype": str(dtype),
                   "q_scale": q_mul, **fwd_record(q, k, v)}
            emit(rec)
            require(fwd_ok(rec),
                    f"flash_fwd disagrees with its plain version at "
                    f"{rec['shape']} {dtype}: O {rec['max_abs_err']}, LSE "
                    f"{rec['max_abs_err_lse']}")
            if flagship is None:
                flagship = rec
            del q, k, v
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


def bwd_record(q, k, v, do):
    """Both backward kernels on q, k, v, dO (O and lse from the forward
    kernel) against their plain version: max |d grad| and its share of
    max |grad| per gradient, the tolerance for the dtype, the plain
    version's and SDPA's backward ms, and per kernel its ms and rates.
    Returns the record and (o, lse, (dq, dk, dv))."""
    b, s, hq, d = q.shape
    hkv, dtype, scale = k.shape[2], q.dtype, d ** -0.5
    o, lse = flash.flash_forward(q, k, v, scale)
    got = flash.flash_backward(q, k, v, o, lse, do, scale)
    want = flash.flash_attention_bwd_ref(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    err = {n: (g.float() - w.float()).abs().max().item()
           for n, g, w in zip(("dq", "dk", "dv"), got, want)}
    rel = {n: err[n] / w.float().abs().max().item()
           for n, w in zip(("dq", "dk", "dv"), want)}
    del want
    _, delta = flash._launch_bwd_dq(q, k, v, o, lse, do, scale)
    rec = {"max_abs_err": err, "rel_err": rel, "tol": BWD_TOLERANCE[dtype],
           "plain_ms": cuda_ms(lambda: flash.flash_attention_bwd_ref(
               q, k, v, o, lse, do, scale), 3),
           "library_ms": sdpa_backward_ms(q, k, v, do, scale)}
    for name, fn in (
            ("dq", lambda: flash._launch_bwd_dq(q, k, v, o, lse, do, scale)),
            ("dkv", lambda: flash._launch_bwd_dkv(q, k, v, lse, delta, do,
                                                  scale))):
        rec[name] = add_rates({"ms": cuda_ms(fn, 10)}, bwd_bound(
            b, s, hq, hkv, d, dtype, name))
    rec["dq"]["max_abs_err"] = err["dq"]
    rec["dkv"]["max_abs_err"] = max(err["dk"], err["dv"])
    return rec, (o, lse, got)


def bwd_ok(rec):
    return all(r <= rec["tol"] for r in rec["rel_err"].values())


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
            got, (o, lse, grads) = bwd_record(q, k, v, do)
            rec = {"phase": "backward", "shape": [b, s, hq, hkv, d],
                   "dtype": str(dtype), "q_scale": q_mul, **got}
            emit(rec)
            require(bwd_ok(rec),
                    f"flash backward disagrees with its plain version at "
                    f"{rec['shape']} {dtype}: {rec['rel_err']} (tolerance "
                    f"{rec['tol']})")
            if (b, s, dtype) == (TRAIN["batch"], TRAIN["seq"],
                                 torch.bfloat16):
                scale = d ** -0.5
                check_function(q, k, v, do, scale, o, grads)
                emit({"phase": "gqa_rounding", "shape": rec["shape"],
                      "rel_diff": gqa_rounding(q, k, v, o, lse, do, scale,
                                               grads)})
                training = rec
            del q, k, v, do, o, lse, grads
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
        before = train_counts()
        start.record()
        params, opt, metrics = step(params, opt, tokens, targets)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(metrics["loss"].item())
        per_step.append([a - b for a, b in zip(train_counts(), before)])
    launches = train_counts()
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
          "launches_per_step_fwd_dq_dkv_adamw_grad_sq_normf_normb":
              per_step})
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    require(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
            f"first loss {losses[0]}, ln(V) {math.log(cfg.vocab_size)}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    want = train_counts_want(cfg, len(tree_leaves(params)))
    require(all(c == want for c in per_step),
            f"launches per step (fwd, dq, dkv, adamw, grad_sq, rms_norm "
            f"fwd, rms_norm bwd) {per_step}, expected {want}")
    del params, opt, step
    return launches, {"timed_step_ms": timed_ms,
                      "tokens_per_s": tokens_per_s}


def _mfu(cfg, n_params, tokens_per_s, seq):
    """bench.py's utilisation: 6N + attention FLOPs per token over peak."""
    flops_per_token = 6 * n_params + 12 * cfg.n_layers * seq * \
        cfg.d_model // 2
    return tokens_per_s * flops_per_token / PEAK_FLOPS[torch.bfloat16]


def _counted_steps(trainer, log):
    """Wrap ``trainer``'s step so each call appends its launches
    (``train_counts``) and a pair of CUDA events around it to ``log``;
    the run itself is unchanged."""
    step = trainer.step_fn

    def counted(*args):
        before = train_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = step(*args)
        end.record()
        log.append(([a - b for a, b in zip(train_counts(), before)], start,
                    end))
        return out

    trainer.step_fn = counted


def _anatomy(trainer, before):
    """The trainer's step anatomy since ``before`` (its
    ``step_metrics.anatomy()`` when it was made: the metrics source is the
    process's): counts, and means in ms."""
    a = anatomy_delta(before, trainer.step_metrics.anatomy())
    rec = {name: {"count": a[name]["count"],
                  "mean_ms": a[name]["sum"] / max(1, a[name]["count"]) * 1e3}
           for name in ("data_wait", "step_wall")}
    for name, r in a["ckpt"].items():
        rec[f"ckpt_{name}"] = {"count": r["num_ops"],
                               "mean_ms": r["avg_time"] * 1e3}
    return rec


def _get_ms(port, path, want=200):
    """(body, ms) of one GET to a door on 127.0.0.1; fails the run on any
    other status."""
    t0 = time.perf_counter()
    status, body = _http(port, "GET", path)
    ms = (time.perf_counter() - t0) * 1e3
    require(status == want, f"GET {path}: {status} {body[:200]!r}")
    return body, ms


def _prom_count(text, family, rank):
    """The ``_count`` of ``family``'s series with ``rank`` on /prom."""
    m = re.search(rf'^{family}_count{{[^}}]*rank="{rank}"[^}}]*}} (\S+)$',
                  text, re.M)
    require(m is not None, f"/prom lacks {family}_count for rank {rank}")
    return float(m.group(1))


def _trainer_door_reads(door, before, steps):
    """The trainer phase's reads of ``door`` after ``steps`` steps since
    the ``/ws/v1/trainer`` body ``before``: the step counts, the HBM
    ledger's components and the /prom histogram's count, gated; returns
    each read's ms."""
    ms = {}
    body, ms["trainer"] = _get_ms(door.port, "/ws/v1/trainer")
    body = json.loads(body)
    ledger = hbm_ledger().report()["components"]
    prom, ms["prom"] = _get_ms(door.port, "/prom")
    health, ms["health"] = _get_ms(door.port, "/health")
    stacks, ms["stacks"] = _get_ms(door.port, "/ws/v1/stacks")
    prom_count = _prom_count(prom.decode(), "htpu_trainer_step_wall_seconds",
                             0)
    require(body["steps"] - before["steps"] == steps and
            body["step_wall"]["count"] - before["step_wall"]["count"]
            == steps and body["job"] == "chip-smoke",
            f"/ws/v1/trainer: {body['steps']} steps, step_wall "
            f"{body['step_wall']} after {steps} (before {before['steps']})")
    require(prom_count == body["step_wall"]["count"],
            f"/prom counts {prom_count} steps, /ws/v1/trainer "
            f"{body['step_wall']['count']}")
    require(body["hbm"]["components"] == ledger,
            f"/ws/v1/trainer hbm {body['hbm']['components']}, ledger "
            f"{ledger}")
    require(json.loads(health) == {"status": "alive",
                                   "daemon": "trainer-rank0"} and
            json.loads(stacks)["num_threads"] >= 1, "/health, /ws/v1/stacks")
    return ms


def _ledger_bytes():
    comps = hbm_ledger().report()["components"]
    return {"params": comps.get("params", 0),
            "opt_state": comps.get("opt_state", 0),
            "memory_allocated": torch.cuda.memory_allocated()}


def _mem_available():
    """The host's available memory in bytes (/proc/meminfo)."""
    return int(re.search(r"MemAvailable:\s+(\d+) kB", open(
        "/proc/meminfo").read()).group(1)) * 1024


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
    mem_avail = _mem_available()
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
    u_before = u.step_metrics.anatomy()
    _counted_steps(u, per_step)
    # the fleet plane: a telemetry door open through the uninterrupted
    # run, whose launches a step stay pinned below
    t_door = time.monotonic()
    door = TrainerTelemetry(Configuration(), rank=0, job="chip-smoke",
                            metrics=u.step_metrics)
    try:
        door_before = json.loads(_get_ms(door.port, "/ws/v1/trainer")[0])
        door_s = time.monotonic() - t_door
        torch.cuda.synchronize()
        t0 = time.monotonic()
        losses = u.train(steps)
        train_wall = time.monotonic() - t0
        t_door = time.monotonic()
        FLEET["trainer_ms"] = _trainer_door_reads(door, door_before, steps)
    finally:
        door.close()
    FLEET["trainer_added_s"] = door_s + time.monotonic() - t_door
    step_ms = [s.elapsed_time(e) for _, s, e in per_step]
    timed_ms = sum(step_ms[1:]) / (steps - 1)
    u_anatomy = _anatomy(u, u_before)
    u.close()
    del u

    a = trainer("resumed", ckpt_interval=crash_at, keep=1)
    a_before = a.step_metrics.anatomy()
    _counted_steps(a, per_step)
    t0 = time.monotonic()
    crashed = a.train(crash_at)             # the exit fence included
    crashed_wall = time.monotonic() - t0
    require(list_checkpoints(fs, f"{root}/resumed") == [crash_at],
            "the interval save is not durable at train()'s exit")
    a_anatomy = _anatomy(a, a_before)
    a.close()
    del a                                     # as a crash leaves it

    b = trainer("resumed", ckpt_interval=0, keep=1)
    b_before = b.step_metrics.anatomy()
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
    launches = train_counts()
    b_anatomy = _anatomy(b, b_before)
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
    want = train_counts_want(cfg, len(tree_leaves(host)))
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
          "launches_per_step_fwd_dq_dkv_adamw_grad_sq_normf_normb":
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
            f"launches per step (fwd, dq, dkv, adamw, grad_sq, rms_norm "
            f"fwd, rms_norm bwd), expected {want}")
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


def _replica_chassis_reads(port, traces, n):
    """The replica's chassis after a round of ``n`` requests whose root
    spans had ``traces`` as trace ids: each found in ``/ws/v1/traces``
    by its id in hex and in decimal, the flight recorder, ``/conf`` with
    the auth secret redacted, ``/ws/v1/top`` with the door's tenants and
    ``/health``. Returns the reads' ms (the trace reads' mean and max)."""
    require(len(traces) == n, f"{len(traces)} root spans for {n} requests")
    trace_ms = []
    for tid in traces:
        for form in (f"{tid:016x}", str(tid)):
            body, ms = _get_ms(port, f"/ws/v1/traces?trace_id={form}")
            trace_ms.append(ms)
            spans = json.loads(body)["spans"]
            require(any(sp["name"] == "serving.request" and
                        sp["trace_id"] == tid and sp["parent_id"] is None
                        for sp in spans),
                    f"/ws/v1/traces?trace_id={form}: no root span")
    ms = {"traces_mean": sum(trace_ms) / len(trace_ms),
          "traces_max": max(trace_ms), "trace_reads": len(trace_ms)}
    slow, ms["traces_slow"] = _get_ms(port, "/ws/v1/traces/slow")
    conf, ms["conf"] = _get_ms(port, "/conf")
    top, ms["top"] = _get_ms(port, "/ws/v1/top")
    health, ms["health"] = _get_ms(port, "/health")
    stacks, ms["stacks"] = _get_ms(port, "/ws/v1/stacks")
    tenants = json.loads(top)["sources"]["serving.chip-smoke.tenants"]
    require("traces" in json.loads(slow), "/ws/v1/traces/slow")
    require(json.loads(conf)["serving.http.auth.secret"] == "<redacted>",
            "/conf shows the auth secret")
    require({f"client{c}" for c in range(DOOR["clients"])} <=
            {e["key"] for e in tenants["window"]},
            f"/ws/v1/top tenants {tenants}")
    require(json.loads(health)["status"] == "alive" and
            json.loads(stacks)["num_threads"] >= 1, "/health, /ws/v1/stacks")
    return ms


class _RecordKeeper:
    """A ``RegistryLike`` that keeps the records in process: no registry
    server runs beside the card, so the replica's own record is what the
    scraper reads."""

    def __init__(self):
        self.by_path = {}

    @property
    def records(self):
        return list(self.by_path.values())

    def register(self, record, ttl_s=10.0, auto_renew=True):
        self.by_path[record.path] = record

    def unregister(self, path):
        self.by_path.pop(path, None)

    def close(self):
        pass


def _conf_and_scrape_reads(port, conf, records):
    """``/ws/v1/conf`` on the replica: every key of the port's registry,
    the keys this phase sets with ``source: "set"``, the auth secret
    redacted, ``?diff=1`` the set rows only; then one ``FleetScraper``
    scrape of the replica's record (``/v1/health`` and ``/prom``): one
    sample, serving, slots > 0, utilization in [0, 1]. Returns the reads'
    ms."""
    from hadoop_tpu_torch.conf import registry as conf_registry
    from hadoop_tpu_torch.serving.autoscale import FleetScraper
    ms = {}
    body, ms["ws_conf"] = _get_ms(port, "/ws/v1/conf")
    table = json.loads(body)
    rows = {r["key"]: r for r in table["keys"]}
    live = conf.to_dict()
    require(table["registry_keys"] == len(conf_registry.KEYS) == len(rows),
            f"/ws/v1/conf: {table['registry_keys']} keys, registry "
            f"{len(conf_registry.KEYS)}")
    set_keys = {k for k in live if k in conf_registry.KEYS}
    require(set_keys and all(rows[k]["source"] == "set" for k in set_keys)
            and all(r["source"] == "default" for k, r in rows.items()
                    if k not in live),
            "/ws/v1/conf: the phase's keys do not read source set")
    require(rows["serving.http.auth.secret"]["effective"] == "<redacted>",
            "/ws/v1/conf shows the auth secret")
    require(rows["serving.max.batch"]["effective"] ==
            str(SERVE_KW["max_batch"]), "/ws/v1/conf: serving.max.batch")
    body, ms["ws_conf_diff"] = _get_ms(port, "/ws/v1/conf?diff=1")
    diff = json.loads(body)
    require({r["key"] for r in diff["keys"]} == set_keys and
            all(r["source"] == "set" for r in diff["keys"]),
            "/ws/v1/conf?diff=1 is not the set rows")
    require(len(records) == 1, f"{len(records)} replica records")
    t0 = time.perf_counter()
    snap = FleetScraper(conf).scrape(records)
    ms["scrape"] = (time.perf_counter() - t0) * 1e3
    (sample,) = snap.samples
    util = snap.utilization("decode")
    require(sample.ok and not sample.draining and sample.slots > 0 and
            0.0 <= util <= 1.0 and snap.scrape_failures == 0,
            f"FleetScraper: ok={sample.ok} error={sample.error!r} "
            f"draining={sample.draining} slots={sample.slots} util={util}")
    ms["scrape_sample"] = {"slots": sample.slots, "active": sample.active,
                           "queue_depth": sample.queue_depth,
                           "utilization": util,
                           "ttft_samples": snap.ttft_samples,
                           "ttft_p99_s": snap.ttft_p99_s}
    ms["registry_keys"] = len(rows)
    ms["keys_set"] = len(set_keys)
    return ms


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
    registry = _RecordKeeper()
    replica = ServingReplica(conf, name="chip-smoke", preset="flagship-1b",
                             checkpoint=f"{root}/resumed", fs=fs,
                             registry=registry)
    eng = replica.engine
    prompts = _door_prompts(cfg.vocab_size)
    ttfts, collecting, traces = [], [False], []

    def on_span(span):
        if collecting[0] and span.name == "serving.first_token":
            ttfts.append(float(span.kv["ttft_s"]))
        if collecting[0] and span.name == "serving.request":
            traces.append(span.trace_id)

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
        t_fleet = time.monotonic()
        FLEET["door_ms"] = _replica_chassis_reads(port, traces,
                                                  len(prompts))
        FLEET["door_ms"].update(_conf_and_scrape_reads(
            port, conf, registry.records))
        FLEET["door_added_s"] = time.monotonic() - t_fleet
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


def _kv_prompts(vocab):
    """KVTIERS["prompts"] prompts over KVTIERS["heads"] shared heads, each
    with its own tail (prompt i on head i % heads)."""
    K = KVTIERS
    gen = torch.Generator().manual_seed(SEED + 31)
    heads = [torch.randint(0, vocab, (K["head"],), generator=gen).tolist()
             for _ in range(K["heads"])]
    lo, hi = K["tails"]
    return [heads[i % K["heads"]] + torch.randint(
        0, vocab, (lo + (i * 7) % (hi - lo + 1),), generator=gen).tolist()
        for i in range(K["prompts"])]


def _kv_waves(eng, prompts, max_new):
    """Serve ``prompts`` in waves of KVTIERS["wave"] (each wave stepped
    until done). Returns the tokens per prompt."""
    out = []
    for w in range(0, len(prompts), KVTIERS["wave"]):
        out += eng.generate(prompts[w:w + KVTIERS["wave"]],
                            SamplingParams(max_new_tokens=max_new))
    return out


def _ttft(eng, prompt, max_new=4):
    """(tokens, seconds from submit to the first token on the host) of one
    request stepped alone."""
    req = eng.submit(prompt, SamplingParams(max_new_tokens=max_new))
    while not req.done.is_set():
        eng.step()
    return req.wait(0), req.first_token_at - req.submitted_at


def _evict_all(eng):
    """Evict every cached page of an idle engine through the radix's
    eviction with the engine's demotion hook (what ``_try_alloc`` does
    when the pool runs dry), so the pages go to the host ring."""
    with eng._sched_lock:
        freed = eng.prefix_cache.evict(len(eng.prefix_cache),
                                       eng.pool.refcount,
                                       on_evict=eng.kvstore.demote)
        eng.pool.free(freed)
    return len(freed)


def _tier_delta(eng, before, key):
    return eng.kvstore.stats()[key] - before[key]


def phase_kvtiers(fs, root):
    """The host-RAM and DFS KV tiers behind the engine, on the step-6
    checkpoint (flagship-1b bf16; see KVTIERS): demotions under waves of
    shared-head traffic, replays from the ring and from the store on a
    second engine (tokens equal the first run's), a prefill_to_store
    handoff (592 of 600 tokens durable, decoded to an engine without
    tiers' tokens), a drain persist hit by a fresh engine, TTFT of one
    prompt from each tier, the page movers and the DFS tier per page, and
    an int8 pass. Prefill/decode roles through the door are phase
    fleet_front's."""
    K = KVTIERS
    cfg = get_config("flagship-1b")
    params, _ = load_serving_params(fs, f"{root}/resumed", cfg,
                                    io_workers=TRAINER["io_workers"])
    store = LocalFileSystem()
    kvdir = f"{root}/kvcache"
    tiers = dict(kv_store_fs=store, kv_store_dir=kvdir, kv_dfs_min_refs=1)
    prompts = _kv_prompts(cfg.vocab_size)
    eng = DecodeEngine(params, cfg, kv_host_bytes=K["host_bytes"], **tiers,
                       **SERVE_KW)
    ring = eng.kvstore.host.capacity
    require(ring == K["host_bytes"] // eng.block_nbytes,
            f"ring of {ring} pages of {eng.block_nbytes} B")
    eng.generate([[1]], SamplingParams(max_new_tokens=2))
    t0 = time.monotonic()
    first = _kv_waves(eng, prompts, K["max_new"])
    waves_s = time.monotonic() - t0
    after_waves = eng.kvstore.stats()
    replay = prompts[:K["replay"]]
    got = eng.generate(replay, SamplingParams(max_new_tokens=K["max_new"]))
    host_hits = _tier_delta(eng, after_waves, "hits_host")
    require(after_waves["demotions"] > 0 and host_hits > 0,
            f"demotions {after_waves['demotions']}, host hits {host_hits}")
    require(got == first[:K["replay"]], "tokens replayed through the host "
            "ring differ from the first run's")
    require(eng.kvstore.flush(300.0), "the DFS writer did not drain")

    # a second engine on the same store: cold HBM, no ring
    eng2 = DecodeEngine(params, cfg, **tiers, **SERVE_KW)
    eng2.generate([[1]], SamplingParams(max_new_tokens=2))
    got2 = eng2.generate(replay, SamplingParams(max_new_tokens=K["max_new"]))
    dfs_hits = eng2.kvstore.stats()["hits_dfs"]
    require(dfs_hits > 0 and got2 == first[:K["replay"]],
            f"DFS replay: {dfs_hits} hits, tokens equal "
            f"{got2 == first[:K['replay']]}")

    # the prefill half of disaggregation, then its decode elsewhere
    gen = torch.Generator().manual_seed(SEED + 32)
    long = torch.randint(0, cfg.vocab_size, (K["handoff"],),
                         generator=gen).tolist()
    t0 = time.monotonic()
    persisted = eng.prefill_to_store(long)
    handoff_s = time.monotonic() - t0
    before = eng2.kvstore.stats()
    handed = eng2.generate([long], SamplingParams(
        max_new_tokens=K["max_new"]))[0]
    handoff_hits = _tier_delta(eng2, before, "hits_dfs")
    plain = DecodeEngine(params, cfg, prefix_cache=False, **SERVE_KW)
    alone = plain.generate([long], SamplingParams(
        max_new_tokens=K["max_new"]))[0]
    del plain
    require(persisted == K["handoff"] // 16 * 16 and handed == alone
            and handoff_hits == persisted // 16,
            f"handoff: {persisted} tokens durable, {handoff_hits} DFS hits, "
            f"tokens equal {handed == alone}")

    # drain: resident prefixes persisted at stop(drain=True)
    drained = [torch.randint(0, cfg.vocab_size, (256,),
                             generator=gen).tolist() for _ in range(4)]
    eng3 = DecodeEngine(params, cfg, kv_host_bytes=K["host_bytes"], **tiers,
                        **SERVE_KW)
    eng3.start()
    reqs = [eng3.submit(p, SamplingParams(max_new_tokens=K["max_new"]))
            for p in drained]
    want = [r.wait(600) for r in reqs]
    persists0 = eng3.kvstore.stats()["dfs_persists"]
    eng3.stop(drain=True, timeout=300)
    drain_persists = eng3.kvstore.stats()["dfs_persists"] - persists0
    del eng3
    fresh = DecodeEngine(params, cfg, **tiers, **SERVE_KW)
    got3 = fresh.generate(drained, SamplingParams(
        max_new_tokens=K["max_new"]))
    drain_hits = fresh.kvstore.stats()["hits_dfs"]
    del fresh
    require(drain_persists > 0 and drain_hits > 0 and got3 == want,
            f"drain: {drain_persists} persisted, {drain_hits} DFS hits, "
            f"tokens equal {got3 == want}")

    # TTFT of one prompt from each tier (the DFS tier on eng2)
    prompt = torch.randint(0, cfg.vocab_size, (K["ttft_prompt"],),
                           generator=gen).tolist()
    ttft, toks = {}, {}
    toks["cold"], ttft["cold"] = _ttft(eng, prompt)
    toks["hbm"], ttft["hbm"] = _ttft(eng, prompt)
    require(eng.kvstore.flush(300.0), "the DFS writer did not drain")
    _evict_all(eng)
    toks["host"], ttft["host"] = _ttft(eng, prompt)
    toks["dfs"], ttft["dfs"] = _ttft(eng2, prompt)
    require(all(t == toks["cold"] for t in toks.values()),
            f"TTFT prompt tokens differ by tier: {toks}")

    # the page movers and the DFS tier, per page
    pages = eng.prefix_cache.match(prompt)[:K["timed_pages"]]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    payloads = [eng._extract_block(b) for b in pages]
    extract_ms = (time.perf_counter() - t0) * 1e3 / len(pages)
    t0 = time.perf_counter()
    for b, (k, v) in zip(pages, payloads):
        eng._inject_block(b, k, v)
    torch.cuda.synchronize()
    inject_ms = (time.perf_counter() - t0) * 1e3 / len(pages)
    dfs = DFSTier(store, f"{root}/kvtimed", shape=eng.kvstore.block_shape,
                  dtype="bfloat16")
    digests = [bytes([i % 256, i // 256]) * 16 for i in range(len(pages))]
    t0 = time.perf_counter()
    require(all(dfs.put(d, k, v) for d, (k, v) in zip(digests, payloads)),
            "a DFS tier put failed")
    put_ms = (time.perf_counter() - t0) * 1e3 / len(pages)
    t0 = time.perf_counter()
    back = [dfs.get(d) for d in digests]
    get_ms = (time.perf_counter() - t0) * 1e3 / len(pages)
    require(all(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
                for a, b in zip(payloads, back)),
            "DFS tier pages came back changed")
    stats = eng.kvstore.stats()
    pool_blocks, block_bytes = eng.pool.num_blocks, eng.block_nbytes
    del eng, eng2

    # int8: the same waves and replay through an int8 ring
    eng = DecodeEngine(params, cfg, kv_host_bytes=K["host_bytes"],
                       kv_codec="int8", **SERVE_KW)
    eng.generate([[1]], SamplingParams(max_new_tokens=2))
    _kv_waves(eng, prompts, K["max_new"])
    before = eng.kvstore.stats()
    got8 = eng.generate(replay, SamplingParams(max_new_tokens=K["max_new"]))
    int8 = {"host_capacity_blocks": eng.kvstore.host.capacity,
            "hits_host": _tier_delta(eng, before, "hits_host"),
            "host_resident_bytes": len(eng.kvstore.host)
            * eng.kvstore.host.block_bytes,
            "tokens_agree": sum(a == b for x, y in zip(got8, first)
                                for a, b in zip(x, y)),
            "tokens": sum(len(x) for x in got8)}
    del eng

    emit({"phase": "kvtiers", "dtype": "bfloat16",
          "pool_blocks": pool_blocks, "block_bytes": block_bytes,
          "host_capacity_blocks": ring, "waves_seconds": waves_s,
          "after_waves": after_waves, "replay_host_hits": host_hits,
          "replay_dfs_hits": dfs_hits, "handoff_persisted_tokens": persisted,
          "handoff_seconds": handoff_s, "handoff_dfs_hits": handoff_hits,
          "drain_persists": drain_persists, "drain_dfs_hits": drain_hits,
          "ttft_s": ttft, "extract_ms_per_page": extract_ms,
          "inject_ms_per_page": inject_ms, "dfs_put_ms_per_page": put_ms,
          "dfs_get_ms_per_page": get_ms, "tiers": stats, "int8": int8})
    require(int8["hits_host"] > 0, "the int8 ring served no hit")


def _count_submits(eng):
    """A request counter on ``eng``: a box whose item 0 counts the
    requests its door submits from now on."""
    box = [0]
    inner = eng.submit

    def submit(*args, **kw):
        box[0] += 1
        return inner(*args, **kw)

    eng.submit = submit
    return box


def _stream_ttft(lines):
    """Read a streamed answer: (seconds to its first line, the last
    line's tokens)."""
    t0 = time.perf_counter()
    first = last = None
    for line in lines:
        if first is None:
            first = time.perf_counter() - t0
        last = line
    require(last is not None and last.get("done") is True,
            f"a stream ended without its last line: {last}")
    return first, last.get("tokens")


def _door_stream(port, payload):
    """Stream one /v1/generate answer straight from a door, one JSON
    line at a time."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        conn.request("POST", "/v1/generate", body=json.dumps(
            dict(payload, stream=True)).encode())
        resp = conn.getresponse()
        require(resp.status == 200, f"door :{port} answered {resp.status}")
        for raw in resp:
            if raw.strip():
                yield json.loads(raw)
    finally:
        conn.close()


def _group_prompts(vocab, seed):
    """FLEET_FRONT's groups: ``per_group`` prompts a group, each its
    group's ``prefix``-token head and a tail of its own."""
    F = FLEET_FRONT
    gen = torch.Generator().manual_seed(seed)
    out = []
    for _ in range(F["groups"]):
        head = torch.randint(0, vocab, (F["prefix"],), generator=gen).tolist()
        for _ in range(F["per_group"]):
            n = int(torch.randint(F["tail"][0], F["tail"][1] + 1, (1,),
                                  generator=gen))
            out.append(head + torch.randint(0, vocab, (n,),
                                            generator=gen).tolist())
    return out


def _owned_prompts(vocab, seed, n, length, owner, paths):
    """``n`` prompts of ``length`` tokens whose rendezvous owner among
    ``paths`` is ``owner``."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    while len(out) < n:
        p = torch.randint(0, vocab, (length,), generator=gen).tolist()
        if rendezvous_owner(affinity_key(p, FLEET_FRONT["prefix"]),
                            paths) == owner:
            out.append(p)
    return out


def _tree_names(node, parents=()):
    """(name, ancestor names) of every span under an assembled node."""
    yield node["name"], parents
    for child in node["children"]:
        yield from _tree_names(child, parents + (node["name"],))


def phase_fleet_front(fs, root):
    """The serving fleet's front half (see FLEET_FRONT): the port's
    registry server, router and doctor around three port replicas on the
    step-6 checkpoint. Gates: the router's prefill handoff (persisted
    tokens, DFS hits on the replica that decodes, the prefill replica's
    own tokens); each affinity request on its rendezvous owner (the
    replicas' request counters), the routed tokens equal to the other
    replica's; the front half's kernel launches a step equal to a direct
    request's; the doctor listing the three replicas and assembling a
    router -> door trace; a drained replica costing no failed request."""
    F, K = FLEET_FRONT, KVTIERS
    t_phase = time.monotonic()
    free_device()
    vocab = get_config("flagship-1b").vocab_size
    reg_conf = Configuration()
    registry = RegistryServer(reg_conf)
    registry.init(reg_conf)
    registry.start()
    addr = ("127.0.0.1", registry.port)
    replicas, counters, spans = {}, {}, {}
    router = doctor = None

    def on_span(span):
        if span.name.startswith("serving.router.") or \
                span.name == "serving.request":
            spans.setdefault(span.trace_id, {})[span.name] = span.to_dict()

    tracer = global_tracer()
    tracer.add_receiver(on_span)
    try:
        for role in ("prefill", "decode", "mixed"):
            conf = Configuration()
            for key, value in (("serving.role", role),
                               ("serving.kv.dfs.enable", "true"),
                               ("serving.kv.dfs.dir", f"{root}/kvfleet"),
                               ("serving.max.batch", SERVE_KW["max_batch"]),
                               ("serving.kv.block.size",
                                SERVE_KW["block_size"]),
                               ("serving.max.context",
                                SERVE_KW["max_context"]),
                               ("serving.prefill.chunk",
                                SERVE_KW["prefill_chunk"]),
                               ("serving.loader.io.workers",
                                TRAINER["io_workers"])):
                conf.set(key, value)
            replicas[role] = ServingReplica(
                conf, name=F["service"], preset="flagship-1b",
                checkpoint=f"{root}/resumed", fs=fs, instance=role,
                registry=RegistryClient(addr, conf))
            replicas[role].start()
            counters[role] = _count_submits(replicas[role].engine)
        paths = {r: replica_path(F["service"], r) for r in replicas}
        roles = {p: r for r, p in paths.items()}
        ports = {r: replicas[r].server.port for r in replicas}
        generate = [paths["decode"], paths["mixed"]]
        for r in ("decode", "mixed"):         # both step shapes captured
            status, _ = _http(ports[r], "POST", "/v1/generate",
                              {"tokens": [1], "max_new_tokens": 2})
            require(status == 200, f"{r} replica warm-up: {status}")
        rconf = Configuration()
        rconf.set("serving.router.prefill.min.tokens", F["offload_min"])
        router = ServingRouter(addr, F["service"], rconf)
        require(sorted(r.path for r in router.replicas()) ==
                sorted(paths.values()), "the router does not list the "
                "three replicas")

        # the prefill -> decode handoff through the router
        gen = torch.Generator().manual_seed(SEED + 33)
        prompt = torch.randint(0, vocab, (K["ttft_prompt"],),
                               generator=gen).tolist()
        ask = {"tokens": prompt, "max_new_tokens": K["max_new"]}
        hits0 = {r: replicas[r].engine.kvstore.stats()["hits_dfs"]
                 for r in ("decode", "mixed")}
        sub0 = {r: counters[r][0] for r in counters}
        t0 = time.perf_counter()
        decoded = router.generate(ask)["tokens"]
        handoff_s = time.perf_counter() - t0
        # the prefill replica's counter counts the handoff's prefill
        (decoded_on,) = [r for r in ("decode", "mixed")
                         if counters[r][0] > sub0[r]]
        hits = replicas[decoded_on].engine.kvstore.stats()["hits_dfs"] \
            - hits0[decoded_on]
        (handoff_trace,) = [t for t, by in spans.items()
                            if "serving.router.prefill_offload" in by]
        offload = spans[handoff_trace]["serving.router.prefill_offload"]
        persisted = int(offload["kv"].get("persisted_tokens", -1))
        status, body = _http(ports["prefill"], "POST", "/v1/generate", ask)
        require(status == 200, f"prefill replica answered {status}")
        own = json.loads(body)["tokens"]
        require(router.prefill_offloaded == 1 and decoded_on != "prefill"
                and persisted == K["ttft_prompt"] // 16 * 16 and hits > 0
                and decoded == own,
                f"router handoff: offloaded {router.prefill_offloaded}, "
                f"decoded on {decoded_on}, {persisted} persisted, {hits} "
                f"DFS hits, tokens equal {decoded == own}")

        # affinity: groups through the router, a second set straight to
        # each prompt's owner
        aff0 = router.affinity_routed
        routed, direct = [], []
        for p in _group_prompts(vocab, SEED + 60):
            owner = rendezvous_owner(affinity_key(p, F["prefix"]), generate)
            sub0 = {r: counters[r][0] for r in counters}
            ttft, toks = _stream_ttft(router.generate_stream(
                {"tokens": p, "max_new_tokens": F["max_new"]}))
            landed = [paths[r] for r in counters if counters[r][0] > sub0[r]]
            routed.append({"prompt": p, "owner": owner, "landed": landed,
                           "ttft_s": ttft, "tokens": toks})
        affinity_routed = router.affinity_routed - aff0
        for p in _group_prompts(vocab, SEED + 61):
            owner = rendezvous_owner(affinity_key(p, F["prefix"]), generate)
            ttft, toks = _stream_ttft(_door_stream(
                ports[roles[owner]],
                {"tokens": p, "max_new_tokens": F["max_new"]}))
            direct.append({"ttft_s": ttft, "tokens": toks})
        cross = []
        for rec in routed[::F["per_group"]]:
            other = next(r for r in generate if r != rec["owner"])
            status, body = _http(ports[roles[other]], "POST", "/v1/generate",
                                 {"tokens": rec["prompt"],
                                  "max_new_tokens": F["max_new"]})
            require(status == 200, f"{other} answered {status}")
            cross.append(json.loads(body)["tokens"] == rec["tokens"])
        require(all(r["landed"] == [r["owner"]] for r in routed) and
                affinity_routed == len(routed),
                f"affinity: {[(r['owner'], r['landed']) for r in routed]}, "
                f"affinity_routed {affinity_routed}")
        require(all(len(r["tokens"]) == F["max_new"] for r in routed + direct)
                and all(cross),
                f"affinity tokens: lengths {[len(r['tokens']) for r in routed]}"
                f", equal on the other replica {cross}")
        router_added_ms = []
        for t, by in spans.items():
            front = by.get("serving.router.generate_stream")
            door = by.get("serving.request")
            if front is not None and door is not None:
                router_added_ms.append((door["start"] - front["start"]) * 1e3)
        require(len(router_added_ms) == len(routed),
                f"{len(router_added_ms)} router -> door span pairs for "
                f"{len(routed)} routed requests")

        # launches a step: the decode replica on its eager step, one
        # prompt of a shape through the router, one straight to its door
        eng = replicas["decode"].engine
        via, straight = _owned_prompts(vocab, SEED + 62, 2, F["eager_prompt"],
                                       paths["decode"], generate)
        launched = {}
        eng._launch_step = eng._step_eager
        try:
            for how, p in (("routed", via), ("direct", straight)):
                before = (flash.launches, norms.launches_fwd, eng.steps,
                          counters["decode"][0])
                ask = {"tokens": p, "max_new_tokens": F["eager_tokens"]}
                if how == "routed":
                    out = router.generate(ask)["tokens"]
                else:
                    status, body = _http(ports["decode"], "POST",
                                         "/v1/generate", ask)
                    require(status == 200, f"decode answered {status}")
                    out = json.loads(body)["tokens"]
                steps = eng.steps - before[2]
                launched[how] = {
                    "steps": steps, "tokens": len(out),
                    "requests": counters["decode"][0] - before[3],
                    "flash_fwd": flash.launches - before[0],
                    "rms_norm_fwd": norms.launches_fwd - before[1]}
        finally:
            del eng._launch_step
        per_step = {how: {k: v / max(1, rec["steps"]) for k, v in rec.items()
                          if k in ("flash_fwd", "rms_norm_fwd")}
                    for how, rec in launched.items()}
        require(launched["routed"] == launched["direct"] and
                launched["direct"]["rms_norm_fwd"] > 0 and
                launched["direct"]["requests"] == 1,
                f"kernel launches routed {launched['routed']} against "
                f"direct {launched['direct']}")

        # the doctor: discovery through the registry, two polls, a trace
        dconf = Configuration()
        dconf.set("obs.doctor.registry", f"127.0.0.1:{registry.port}")
        dconf.set("obs.doctor.interval", "3600")
        doctor = FleetDoctor(dconf)
        doctor.init(dconf)
        doctor.start()
        poll_ms = []
        for _ in range(F["polls"]):
            t0 = time.perf_counter()
            doctor.poll_once()
            poll_ms.append((time.perf_counter() - t0) * 1e3)
        body, report_ms = _get_ms(doctor.port, "/ws/v1/fleet/doctor")
        report = json.loads(body)
        listed = sorted(st["endpoint"]["name"]
                        for st in report["endpoints"].values()
                        if st["endpoint"]["kind"] == "replica" and st["ok"])
        require(listed == sorted(paths.values()),
                f"/ws/v1/fleet/doctor lists {listed}")
        body, trace_ms = _get_ms(doctor.port, f"/ws/v1/fleet/traces/"
                                 f"{handoff_trace:016x}")
        tree = json.loads(body)
        names = [nm for r in tree["tree"] for nm in _tree_names(r)]
        require(any(n == "serving.request" and
                    "serving.router.generate" in up for n, up in names) and
                any(n == "serving.router.prefill_offload"
                    for n, _ in names),
                f"the assembled trace: {sorted({n for n, _ in names})}")

        # drain the mixed replica: the next requests all land on decode
        status, _ = _http(ports["mixed"], "POST", "/v1/admin/drain")
        require(status == 202, f"/v1/admin/drain answered {status}")
        deadline = time.monotonic() + 60
        while not replicas["mixed"].server._draining.is_set():
            require(time.monotonic() < deadline, "the drain did not begin")
            time.sleep(0.01)
        drained = _owned_prompts(vocab, SEED + 63, F["drained"] // 2, 40,
                                 paths["mixed"], generate) + \
            _owned_prompts(vocab, SEED + 64, F["drained"] // 2, 40,
                           paths["decode"], generate)
        drain_rows = []
        for p in drained:
            sub0 = counters["decode"][0]
            t0 = time.perf_counter()
            out = router.generate({"tokens": p,
                                   "max_new_tokens": F["max_new"]})["tokens"]
            drain_rows.append({"ms": (time.perf_counter() - t0) * 1e3,
                               "tokens": len(out),
                               "on_decode": counters["decode"][0] - sub0})
        require(all(r["tokens"] == F["max_new"] and r["on_decode"] == 1
                    for r in drain_rows),
                f"requests after the drain: {drain_rows}")
        require(replicas["mixed"].drained.wait(300),
                "the drained replica did not finish its drain")
        gone = [r.path for r in router.replicas(refresh=True)]
        require(paths["mixed"] not in gone,
                f"the drained replica is still listed: {gone}")
    finally:
        tracer.remove_receiver(on_span)
        if doctor is not None:
            doctor.stop()
        if router is not None:
            router.close()
        for r in replicas.values():
            r.drain_and_stop(timeout=300)
        registry.stop()
    wall_s = time.monotonic() - t_phase
    ttft_routed = [r["ttft_s"] for r in routed]
    ttft_direct = [r["ttft_s"] for r in direct]
    front = {"ttft_p50_routed_ms": _pct(ttft_routed, 0.5) * 1e3,
             "ttft_p50_direct_ms": _pct(ttft_direct, 0.5) * 1e3,
             "router_added_ms_p50": _pct(router_added_ms, 0.5),
             "router_added_ms_max": max(router_added_ms),
             "doctor_poll_ms": poll_ms, "doctor_report_ms": report_ms,
             "doctor_trace_ms": trace_ms, "wall_s": wall_s}
    FLEET["front"] = front
    emit({"phase": "fleet_front", "model": "flagship-1b", "dtype": "bfloat16",
          "replicas": {r: {"port": ports[r], "load_seconds":
                           replicas[r].load_seconds} for r in replicas},
          "handoff": {"persisted_tokens": persisted, "decoded_on": decoded_on,
                      "decode_dfs_hits": hits, "tokens_equal": decoded == own,
                      "seconds": handoff_s},
          "affinity": {"requests": len(routed),
                       "affinity_routed": affinity_routed,
                       "on_owner": sum(r["landed"] == [r["owner"]]
                                       for r in routed),
                       "by_replica": {p: sum(r["owner"] == p for r in routed)
                                      for p in generate},
                       "tokens_equal_on_other": cross},
          "ttft_ms": {"routed": [t * 1e3 for t in ttft_routed],
                      "direct": [t * 1e3 for t in ttft_direct]},
          "router_added_ms": router_added_ms,
          "launches": launched, "launches_per_step": per_step,
          "doctor": {"listed": listed, "poll_ms": poll_ms,
                     "trace_spans": tree["num_spans"],
                     "critical_path": tree["critical_path"]},
          "drain": drain_rows, **front})


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


def _greedy_f32_gate(eng_tokens, params, cfg, prompts, new):
    """The serving phase's float32 rule: each greedy request's tokens
    equal the plain greedy loop over ``params`` but at a near-tie (the
    two logits within TIE_REL), after which the stream is not compared.
    Returns (tokens compared equal, ties)."""
    ties, compared = [], 0
    for i, (prompt, got) in enumerate(zip(prompts, eng_tokens)):
        ref, rows = _reference_greedy(params, cfg, prompt, new)
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
            break
    return compared, ties


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
    compared, ties = _greedy_f32_gate(outs, p32, cfg32, prompts, new)
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


def _spec_prompts(vocab):
    """SPECULATE["requests"] self-similar prompts: a distinct head, then
    one shared template repeated to 96-288 tokens."""
    S = SPECULATE
    gen = torch.Generator().manual_seed(SEED + 21)
    template = torch.randint(0, vocab, (S["template"],),
                             generator=gen).tolist()
    prompts = []
    for i in range(S["requests"]):
        head = torch.randint(0, vocab, (S["head"],), generator=gen).tolist()
        n = 96 + (i * 64) % 193
        prompts.append(head + (template * (-(-n // S["template"])))[:n])
    return prompts


def _spec_run(params, cfg, prompts, samplings, k):
    """Serve ``prompts`` through ``DecodeEngine.step`` with speculate_k
    ``k`` at SERVE_KW's sizes (``_timed_run``). Returns the tokens and a
    record."""
    eng = DecodeEngine(params, cfg, speculate_k=k,
                       speculate_ngram=SPECULATE["ngram"], **SERVE_KW)
    out = _timed_run(eng, prompts, samplings)
    out[1]["k"] = k
    del eng
    return out


def _timed_run(eng, prompts, samplings, warm=True):
    """Serve ``prompts`` through ``eng.step`` (submitted together, stepped
    until done), after a warm-up that captures both step shapes (``warm``).
    Per step: the shape, the wall ms of ``step()``, the device ms of the
    graph replay (CUDA events around the launch), whether the step
    carried proposals and the draft uploads it made. Returns the tokens
    and a record."""
    if warm:
        eng.generate([[1]], SamplingParams(max_new_tokens=2))
    real_launch, real_run = eng._launch_step, eng._run_step
    launches, steps = [], []

    def launch(fused):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_launch(fused)
        end.record()
        launches.append((fused, start, end))
        return out

    def run():
        proposing = bool(eng._draft_lens.any())
        uploads = eng.spec_uploads
        n = real_run()
        steps.append((proposing, eng.spec_uploads - uploads))
        return n

    eng._launch_step, eng._run_step = launch, run
    proposed0, accepted0 = eng.spec_proposed, eng.spec_accepted
    walls = []
    torch.cuda.synchronize()
    t0 = time.monotonic()
    reqs = [eng.submit(p, sp) for p, sp in zip(prompts, samplings)]
    while not all(r.done.is_set() for r in reqs):
        n = len(launches)
        s0 = time.perf_counter()
        eng.step()
        if len(launches) > n:
            walls.append((launches[-1][0], (time.perf_counter() - s0) * 1e3))
    wall = time.monotonic() - t0
    torch.cuda.synchronize()
    eng._launch_step, eng._run_step = real_launch, real_run
    tokens = [r.wait(0) for r in reqs]
    n_tokens = sum(len(t) for t in tokens)
    by_shape = {}
    for name, fused in (("decode", False), ("fused", True)):
        dev = [a.elapsed_time(b) for f, a, b in launches if f == fused]
        host = [w for f, w in walls if f == fused]
        by_shape[name] = {"steps": len(host),
                          "wall_ms": sum(host) / max(1, len(host)),
                          "device_ms": sum(dev) / max(1, len(dev))}
    proposing = sum(1 for p, _ in steps if p)
    proposed = eng.spec_proposed - proposed0
    accepted = eng.spec_accepted - accepted0
    rec = {"steps": len(steps), "seconds": wall, "tokens": n_tokens,
           "tokens_per_s": n_tokens / wall, "proposed": proposed,
           "accepted": accepted,
           "accept_rate": accepted / proposed if proposed else 0.0,
           "step": by_shape, "graphs_captured": len(eng._graphs),
           "decode_shapes": eng.decode_compiles,
           "fused_shapes": eng.prefill_compiles,
           "proposing_steps": proposing,
           "draft_uploads": sum(u for _, u in steps),
           "draft_uploads_per_step": sum(u for _, u in steps) / len(steps),
           "uploads_on_steps_without_proposals":
               sum(u for p, u in steps if not p)}
    return tokens, rec


def _teacher_rows(params, cfg, prompt, out):
    """float32 logits rows of the port's forward over ``prompt + out``:
    row j is the distribution ``out[j]`` was drawn from."""
    seq = prompt + out[:-1]
    n = -(-len(seq) // 128) * 128
    logits = forward(params, [seq + [0] * (n - len(seq))], cfg)
    return logits[0, len(prompt) - 1:len(seq)].float()


def phase_speculate(cfg32, p32, cfg16, p16):
    """Speculative decoding through the engine's captured step, in float32
    and bf16, speculation off and on in turn on the same requests (see
    SPECULATE). Gates: both step shapes captured once; no draft upload on
    a step without proposals; drafts proposed and accepted; float32
    greedy tokens equal speculation-off's but at near-ties; bf16 greedy
    tokens calibrated against the forward (SPECULATE["bf16_cal"]);
    sampled tokens inside their row's top-k."""
    S = SPECULATE
    prompts = _spec_prompts(cfg32.vocab_size)
    greedy = SamplingParams(max_new_tokens=S["max_new"])
    sampled = SamplingParams(max_new_tokens=S["max_new"],
                             temperature=S["temperature"], top_k=S["top_k"])
    samplings = [greedy] * S["greedy"] + \
        [sampled] * (S["requests"] - S["greedy"])
    for cfg, params in ((cfg32, p32), (cfg16, p16)):
        dtype = str(cfg.torch_dtype).replace("torch.", "")
        runs = {name: _spec_run(params, cfg, prompts, samplings, k)
                for name, k in (("off", 0), ("on", S["k"]))}
        rows = {name: [_teacher_rows(params, cfg, p, t)
                       for p, t in zip(prompts, runs[name][0])]
                for name in runs}
        gaps = {}
        for name in runs:
            gaps[name] = max(
                float((r.max(-1).values - r[torch.arange(len(t)),
                                             torch.tensor(t)]).max())
                for r, t in zip(rows[name][:S["greedy"]],
                                runs[name][0][:S["greedy"]]))
        differ = []
        for i in range(S["greedy"]):
            a, b = runs["on"][0][i], runs["off"][0][i]
            if a == b:
                continue
            j = next(j for j, (x, y) in enumerate(zip(a, b)) if x != y)
            top2 = rows["off"][i][j].topk(2).values
            differ.append({"request": i, "position": j, "on": a[j],
                           "off": b[j],
                           "top2_gap_rel": float((top2[0] - top2[1])
                                                 / top2[0].abs())})
        # sampled tokens: inside the row's top-k of the forward's logits,
        # up to the calibration (float32: TIE_REL of |max logit|)
        outside = 0
        for name in runs:
            for r, t in zip(rows[name][S["greedy"]:],
                            runs[name][0][S["greedy"]:]):
                kth = r.topk(S["top_k"], dim=-1).values[:, -1]
                tol = (gaps["off"] if dtype == "bfloat16"
                       else TIE_REL * float(r.abs().max()))
                outside += int((r[torch.arange(len(t)), torch.tensor(t)]
                                < kth - tol).sum())
        emit({"phase": "speculate", "dtype": dtype, "off": runs["off"][1],
              "on": runs["on"][1],
              "greedy_equal": S["greedy"] - len(differ), "differ": differ,
              "calibration_gap": gaps,
              "sampled_outside_top_k": outside})
        for name, (_, rec) in runs.items():
            require(rec["graphs_captured"] == 2 and rec["decode_shapes"] == 1
                    and rec["fused_shapes"] == 1,
                    f"{dtype} {name}: {rec['graphs_captured']} graphs at "
                    f"{rec['decode_shapes']} + {rec['fused_shapes']} shapes")
            require(rec["uploads_on_steps_without_proposals"] == 0,
                    f"{dtype} {name}: drafts uploaded on a step without "
                    f"proposals")
        require(runs["on"][1]["proposed"] > 0
                and runs["on"][1]["accepted"] > 0,
                f"{dtype}: the self-similar prompts earned no accepted "
                f"draft")
        require(runs["off"][1]["proposed"] == 0, "speculation off proposed")
        require(outside == 0, f"{dtype}: {outside} sampled tokens outside "
                f"their row's top-{S['top_k']}")
        if dtype == "float32":
            require(len(differ) <= S["f32_ties"]
                    and all(d["top2_gap_rel"] < TIE_REL for d in differ),
                    f"float32 greedy tokens left speculation-off's: "
                    f"{differ}")
        else:
            require(gaps["on"] <= S["bf16_cal"] * gaps["off"],
                    f"bf16 greedy calibration gap {gaps['on']} with "
                    f"speculation against {gaps['off']} without")


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

    def sliced(x, layers, cfg, cos, sin, attn_impl="auto", remat=False,
               ctx=decoder_module.SINGLE):
        body = decoder_module._layer_fn(remat)
        for i in range(cfg.n_layers):
            x = body(x, {name: w[i] for name, w in layers.items()}, cfg,
                     cos, sin, attn_impl, ctx)
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
    as a yardstick of another function (no library time: no PyTorch call
    computes this one), ``torch.optim.AdamW(fused=True)`` over the same
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
            # no PyTorch call computes this update: the fused AdamW keeps
            # its moments in the parameters' dtype (bf16: 14 B a
            # parameter against 22) and clips nothing; timed beside it as
            # a yardstick of another function
            "library_ms": None,
            "fused_adamw_bf16_moments_ms": cuda_ms(lib.step, 5),
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
    _adamw_zero1_slices()
    return records


def _adamw_zero1_slices():
    """adamw.cu and the squared norm at the elastic leg's shapes: one
    rank's (K,) ZeRO-1 slice of every flagship-1b leaf (ELASTIC's depth)
    at dp4 and at dp3 (K padded where dp does not divide the leaf),
    against their plain versions, held as phase_adamw holds them."""
    from hadoop_tpu_torch.parallel.train import zero1_layout
    cfg = get_config("flagship-1b", n_layers=ELASTIC["layers"])
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    like = tree_leaves(init_params(cfg, None, device="meta"))
    hyper = optimizer._hyper(ADAMW["count"], ADAMW["lr"], ADAMW["b1"],
                             ADAMW["b2"], ADAMW["eps"],
                             ADAMW["weight_decay"])
    for dp in (4, 3):
        ks = [shape[-1] for shape in tree_leaves(
            zero1_layout(cfg, MeshPlan(dp=dp))[1])]
        p0 = [torch.randn(k, generator=gen, device="cuda").to(cfg.torch_dtype)
              for k in ks]
        g = [(torch.randn(k, generator=gen, device="cuda")
              * ADAMW["grad_scale"]).to(cfg.torch_dtype) for k in ks]
        m0 = [torch.randn(k, generator=gen, device="cuda") * 1e-4
              for k in ks]
        v0 = [torch.randn(k, generator=gen, device="cuda").square() * 1e-8
              for k in ks]
        gsq = optimizer._launch_grad_sq(g)
        gsq_ref = optimizer.grad_sq_ref(dict(enumerate(g)))
        gsq_rel = abs(gsq.item() - gsq_ref.item()) / gsq_ref.item()
        scale = torch.clamp(1.0 / torch.clamp(torch.sqrt(gsq), min=1e-12),
                            max=1.0)
        sides = {}
        for side, update in (("kernel", optimizer._launch_adamw),
                             ("plain", optimizer.adamw_leaf_ref)):
            state = [[x.clone() for x in t] for t in (p0, m0, v0)]
            for p, gg, m, v, leaf in zip(*state[:1], g, *state[1:], like):
                update(p, gg, m, v, scale, hyper, leaf.ndim >= 2)
            sides[side] = state
        torch.cuda.synchronize()
        (pk, mk, nk), (pr, mr, nr) = sides["kernel"], sides["plain"]
        n = sum(ks)
        p_diff = sum(int((a != b).sum()) for a, b in zip(pk, pr))
        p_ulps = max(_ulps(a, b, x).max().item()
                     for a, b, x in zip(pk, pr, p0))
        moment_rel = max(((a - b).abs().max() / b.abs().max()).item()
                         for a, b in zip(mk + nk, mr + nr))
        emit({"phase": "adamw", "part": "zero1_slices", "dp": dp,
              "layers": cfg.n_layers, "leaves": len(ks),
              "slice_elements": n, "p_elements_differing": p_diff,
              "p_max_ulps": p_ulps, "moment_rel_err": moment_rel,
              "grad_sq_rel_err": gsq_rel})
        require(p_ulps <= 1 and p_diff / n <= ADAMW_P_SHARE and
                moment_rel <= ADAMW_MOMENT_TOL and gsq_rel <= GRAD_SQ_TOL,
                f"adamw.cu at the ZeRO-1 dp{dp} slices: {p_diff} elements "
                f"differ (up to {p_ulps} ulps), moments {moment_rel}, "
                f"grad_sq {gsq_rel}")
        del sides, pk, mk, nk, pr, mr, nr, p0, g, m0, v0
    torch.cuda.empty_cache()


# The int8 dequantize (dequant.cu) against its plain version
# (weightplane._dequant), bit for bit, on one layer's leaves of
# flagship-1b, llama3-8b and mixtral-8x7b at group 64 ([N, G, gs]; the
# expert stacks [E, N, G, gs]), in bf16 and float32; its timed shape is
# llama3-8b's w_gate, the largest dense leaf the longctx_decode phase's
# int8 run dequantizes per layer per token.
DEQUANT_SHAPES = {
    "flagship-1b": {"wq": (2048, 32, 64), "wk": (1024, 32, 64),
                    "w_gate": (5632, 32, 64), "w_down": (2048, 88, 64)},
    "llama3-8b": {"wq": (4096, 64, 64), "w_gate": (14336, 64, 64),
                  "w_down": (4096, 224, 64)},
    "mixtral-8x7b": {"wk": (1024, 64, 64), "w_gate": (8, 14336, 64, 64),
                     "w_down": (8, 4096, 224, 64)},
}
DEQUANT_TIMED = ("llama3-8b", "w_gate")
# rmsnorm.cu against its plain versions (norms.rms_norm_ref_fwd/_bwd):
# float32 within RMS_F32_TOL of max |value| (the kernels sum the squares,
# g·x and dw in another order), bf16 and float16 (the float16 forward's
# norms) within one rounding at the largest value (the kernels and the
# plain version round the same float32 values once, which differ by those
# sums). Rows of 8192 are the widest the kernels take (d_model 8192 at
# float32: eight vectors a thread). Timed shapes: the forward at the
# llama3-8b prefill's rows, the backward at flagship-1b's and
# mixtral-8x7b's training rows (its pass and its dw finish apart too).
# [3, 2048, 2048] is the rows of an elastic ZeRO-1 dp4 rank at batch 12
# ([4, 2048, 2048] its dp3 rank's, and the train phase's).
RMS_SHAPES = [(4, 2048, 2048), (3, 2048, 2048), (1, 8192, 4096),
              (1, 4096, 4096), (1, 1024, 8192)]
RMS_DTYPES = (torch.bfloat16, torch.float16, torch.float32)
RMS_F32_TOL = 1e-6
RMS_TIMED = {"fwd": (1, 8192, 4096), "bwd": (4, 2048, 2048),
             "bwd_mixtral": (1, 4096, 4096)}


def phase_dequant():
    """dequant.cu bit-equal to ``_dequant`` on every DEQUANT_SHAPES leaf
    in bf16 and float32 (random int8 payload and scales from a seed); ms
    against its bound (int8 read, one float32 scale per 64, the output
    written), the plain version, per bf16 leaf. Returns the timed leaf's
    record for the kernels line (no PyTorch call computes it: no library
    time)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 20)
    leaves, timed = [], None
    for model, shapes in DEQUANT_SHAPES.items():
        for name, shape in shapes.items():
            q = torch.randint(-127, 128, shape, generator=gen,
                              device="cuda", dtype=torch.int8)
            s = torch.rand(shape[:-1], generator=gen, device="cuda") * 0.05
            for dtype in (torch.bfloat16, torch.float32):
                got = weightplane._launch_dequant(q, s, dtype)
                want = weightplane._dequant(q, s, dtype)
                bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
                rec = {"model": model, "leaf": name, "shape": list(shape),
                       "dtype": str(dtype).replace("torch.", ""),
                       "bit_equal": torch.equal(got.view(bits),
                                                want.view(bits)),
                       "max_abs_err": (got.float() - want.float()).abs()
                       .max().item()}
                del got, want
                if dtype == torch.bfloat16:
                    n = q.numel()
                    rec.update(add_rates({
                        "ms": cuda_ms(lambda: weightplane._launch_dequant(
                            q, s, dtype), 10),
                        "plain_ms": cuda_ms(lambda: weightplane._dequant(
                            q, s, dtype), 3),
                        "library_ms": None},
                        _bound(n + 4 * s.numel() + 2 * n, 2 * n,
                               torch.float32)))
                    if (model, name) == DEQUANT_TIMED:
                        timed = rec
                leaves.append(rec)
            del q, s
    torch.cuda.empty_cache()
    emit({"phase": "dequant", "group": 64, "leaves": leaves})
    bad = [(r["model"], r["leaf"], r["dtype"]) for r in leaves
           if not r["bit_equal"]]
    require(not bad, f"dequant.cu differs from _dequant on {bad}")
    return timed


def _one_rounding(got, want):
    """Is max |got - want| at most one ulp of want's dtype (bf16 or
    float16) at max |want|?"""
    top = want.float().abs().max()
    bits = {torch.bfloat16: 7, torch.float16: 10}[want.dtype]
    ulp = 2.0 ** (math.floor(math.log2(top.item())) - bits)
    return (got.float() - want.float()).abs().max().item() <= ulp


def _rms_bwd_record(x, dy, w, x2, r, rr, dx, dxr):
    """The backward's timed record at x's shape (bf16): ms of both
    launches as device time alone (CUDA graph replays, ``graph_ms``: an
    eager loop of them is bound by their host launches, ``eager_ms``)
    against the bytes bound (dy and x read, dx written, w read and dw
    written, the 1/rms read), the plain version and the autograd backward
    of ``torch.nn.functional.rms_norm`` (eager); and each launch alone on
    the grid ``_launch_bwd`` takes (``kernel_ms`` the pass, ``finish_ms``
    the dw finish, from graph replays; ``eager_kernel_ms``,
    ``eager_finish_ms``)."""
    d, elt = x.shape[-1], x.element_size()
    rows, wb = x.numel() // d, w.numel() * w.element_size()
    xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    yl = F.rms_norm(xl, (d,), wl, 1e-5)
    blocks, per = norms._bwd_grid(rows, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    dy2, code = dy.reshape(rows, d), norms._DTYPES[x.dtype]
    dx_t, dw_t = torch.empty_like(x2), torch.empty_like(w)
    partials = torch.empty(blocks, d, dtype=torch.float32, device=x.device)
    calls = {
        "": lambda: norms._launch_bwd(dy, x2, w, r),
        "kernel_": lambda: _build.launch(
            "htpu_rms_norm_bwd", dy2, x2, w, r, dx_t, partials, rows, d,
            blocks, code),
        "finish_": lambda: _build.launch(
            "htpu_rms_norm_dw", partials, dw_t, blocks, d, code)}
    times = {}
    for key, fn in calls.items():
        times[f"{key}ms"] = graph_ms(fn, 20)
        times[f"eager_{key}ms"] = cuda_ms(fn, 20)
    rec = add_rates({
        "shape": list(x.shape),
        **times,
        "plain_ms": cuda_ms(
            lambda: norms.rms_norm_ref_bwd(dy, x, w, rr), 5),
        "library_ms": cuda_ms(lambda: torch.autograd.grad(
            yl, (xl, wl), dy, retain_graph=True), 20),
        "max_abs_err": (dx.float() - dxr.float()).abs().max().item()},
        _bound(3 * elt * x.numel() + 2 * wb + 4 * rows, 8 * x.numel(),
               torch.float32))
    rec["grid"] = [blocks, per]
    return rec


def phase_rmsnorm():
    """rmsnorm.cu's forward (y, 1/rms) and backward (dx, dw) against their
    plain versions at RMS_SHAPES in RMS_DTYPES (x, dy random, w near
    1, from a seed), once through the autograd Function (the same bits
    as the launches) and the backward twice (the same bits again); ms
    against the bytes bound, the plain version and
    ``torch.nn.functional.rms_norm`` (forward; its autograd backward).
    Returns the records of the kernels for the kernels line (the
    backward's at flagship-1b's rows, ``bwd``, and mixtral-8x7b's,
    ``bwd_mixtral``)."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 21)
    cases, records = [], {}
    for shape in RMS_SHAPES:
        for dtype in RMS_DTYPES:
            d = shape[-1]
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            dy = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
                 ).to(dtype)
            y, x2, r = norms._launch_fwd(x, w, 1e-5)
            dx, dw = norms._launch_bwd(dy, x2, w, r)
            dx = dx.view(shape)
            yr, rr = norms.rms_norm_ref_fwd(x, w, 1e-5)
            dxr, dwr = norms.rms_norm_ref_bwd(dy, x, w, rr)
            xa, wa = x.clone().requires_grad_(), w.clone().requires_grad_()
            ya = norms.rms_norm(xa, wa, 1e-5)
            ya.backward(dy)
            dx2, dw2 = norms._launch_bwd(dy, x2, w, r)
            rec = {"shape": list(shape),
                   "dtype": str(dtype).replace("torch.", ""),
                   "function_equal": bool(torch.equal(ya, y) and torch.equal(
                       xa.grad, dx) and torch.equal(wa.grad, dw)),
                   "repeat_equal": bool(torch.equal(dx2.view(shape), dx)
                                        and torch.equal(dw2, dw))}
            del dx2, dw2
            ok = rec["function_equal"] and rec["repeat_equal"]
            for name, got, want in (("y", y, yr), ("r", r.view(rr.shape), rr),
                                    ("dx", dx, dxr), ("dw", dw, dwr)):
                rel = ((got.float() - want.float()).abs().max()
                       / want.float().abs().max()).item()
                rec[f"{name}_rel_err"] = rel
                if dtype == torch.float32 or name == "r":
                    ok = ok and rel <= RMS_F32_TOL
                else:
                    rec[f"{name}_one_rounding"] = _one_rounding(got, want)
                    ok = ok and rec[f"{name}_one_rounding"]
            rec["ok"] = ok
            rows, elt = x.numel() // d, x.element_size()
            wb = w.numel() * w.element_size()
            if dtype == torch.bfloat16 and tuple(shape) == RMS_TIMED["fwd"]:
                records["fwd"] = add_rates({
                    "shape": list(shape),
                    "ms": cuda_ms(lambda: norms._launch_fwd(x, w, 1e-5), 20),
                    "plain_ms": cuda_ms(
                        lambda: norms.rms_norm_ref_fwd(x, w, 1e-5), 5),
                    "library_ms": cuda_ms(lambda: F.rms_norm(
                        x, (d,), w, 1e-5), 20),
                    "max_abs_err": (y.float() - yr.float()).abs().max()
                    .item()},
                    _bound(2 * elt * x.numel() + wb + 4 * rows,
                           4 * x.numel(), torch.float32))
            for key in ("bwd", "bwd_mixtral"):
                if dtype == torch.bfloat16 and tuple(shape) == RMS_TIMED[key]:
                    records[key] = _rms_bwd_record(x, dy, w, x2, r, rr, dx,
                                                   dxr)
            cases.append(rec)
            del x, dy, w, y, x2, r, dx, dw, yr, rr, dxr, dwr, xa, wa, ya
    torch.cuda.empty_cache()
    emit({"phase": "rmsnorm", "f32_tol": RMS_F32_TOL, "cases": cases,
          **records})
    bad = [(c["shape"], c["dtype"]) for c in cases if not c["ok"]]
    require(not bad, f"rmsnorm.cu differs from its plain version on {bad}")
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


def _cp_errors(got, got_kv, ref, local):
    """A CP prefill and the calibration against the kernel forward:
    logits, then K and V per layer from position ``local`` on; and the
    largest ratio of an error to its calibration."""
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
    return err, cal, ratio


def _ulysses_prefill(upre, prompt, ref, local, cfg, ring_ms):
    """Phase ``ulysses``: the Ulysses CP prefill of ``prompt`` (its sp
    ranks folded on this card: the all-to-alls are permutes of the
    stacked ranks, one causal kernel launch a layer over all of them)
    against the single-device forward by the ring's calibration rule;
    timed beside the ring's ms when ``ring_ms`` is given. Returns its
    launches (fwd, dq, dkv, partial)."""
    n = len(prompt)
    sp = upre.sp
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()                              # the main path's run
    res = upre.cp_prefill(prompt)
    torch.cuda.synchronize()
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    got_kv, n_blocks = _streamed_kv(res)
    got = torch.from_numpy(res.last_logits)
    del res
    err, cal, ratio = _cp_errors(got, got_kv, ref, local)
    kernel = ref["auto"]
    rec = {"phase": "ulysses", "model": LONGCTX["model"], "dtype": cfg.dtype,
           "reduced": _depth_cut(LONGCTX["model"], cfg),
           "prompt_tokens": n, "pad_tokens": upre.pad_tokens, "sp": sp,
           "sp_mode": upre.sp_mode, "block_size": LONGCTX["block"],
           "full_blocks": n_blocks,
           "kernel_shape": [sp, upre.pad_tokens, cfg.n_heads // sp,
                            cfg.n_kv_heads // sp, cfg.head_dim],
           "kv_bit_equal_to_single_device": all(
               torch.equal(g, w) for g, w in zip(got_kv, kernel[1:])),
           "logits_rel_err": err[0][0],
           "logits_rel_err_calibration": cal[0][0],
           "argmax_agree": int(got.argmax()) == int(kernel[0].argmax()),
           "k_rel_err_max": max(err[1]), "v_rel_err_max": max(err[2]),
           "calibration_ratio_max": ratio,
           "cal_factor": LONGCTX["cal_factor"],
           "launches_fwd_dq_dkv_partial": list(launches),
           "peak_memory_bytes": peak,
           "shapes": [upre.prefill_compiles, upre.head_compiles]}
    if ring_ms is not None:
        ms = cuda_ms(lambda: upre.cp_prefill(prompt), LONGCTX["timed"])
        rec.update(ms=ms, tokens_per_s=n / (ms / 1e3), ring_ms_same_run=ring_ms)
    emit(rec)
    want = (cfg.n_layers, 0, 0, 0)
    require(tuple(launches) == want,
            f"Ulysses prefill launches (fwd, dq, dkv, partial) {launches}, "
            f"expected {want}")
    require(ratio <= LONGCTX["cal_factor"],
            f"Ulysses prefill of {n} tokens vs the single-device forward: "
            f"up to {ratio} times the calibration's distance")
    require(bool(torch.isfinite(got).all()), "non-finite Ulysses logits")
    require(n_blocks == n // LONGCTX["block"], "wrong block count")
    return launches


def _depth_cut(model, cfg):
    """A record's ``reduced``: the depth ``cfg`` runs of ``model``'s."""
    return f"depth {cfg.n_layers} of {get_config(model).n_layers} layers"


def phase_longctx(int8: bool = False, bf16_ms=None):
    """llama3-8b at full width, LONGCTX's depth, and its published
    context: CP
    prefill (sp 4 on this card, block 16) of three prompts against the
    single-device forward (the causal kernel at S 8192). With ``int8``
    (phase ``longctx_int8``) the prefiller holds the weight plane's int8
    tree (group 64: every local matmul through ``qdot``, the head through
    ``qhead``) and the single-device forward runs over its
    ``dequantize_params`` reconstruction, for the 8192-token prompt.
    The bf16 run also prefills each prompt through Ulysses (phase
    ``ulysses``, ``_ulysses_prefill``) against the same references.
    Returns the main path's launches (causal, partial) of the 8192-token
    prefill, its ms (``bf16_ms``: the bf16 prefill's, recorded beside
    the int8 one's) and the Ulysses prefill's launches (causal,
    partial)."""
    cfg = get_config(LONGCTX["model"], n_layers=LONGCTX["layers"])
    sp = LONGCTX["sp"]
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    n_params = sum(p.numel() for p in tree_leaves(params))
    plane = {}
    cp_params = params
    if int8:
        plane["weight_bytes_bf16"] = weightplane.resident_weight_bytes(
            params)
        cp_params, report = weightplane.quantize_params(
            params, cfg, WEIGHTS_INT8)
        del params
        torch.cuda.empty_cache()
        params = weightplane.dequantize_params(cp_params, cfg)
        plane.update(weight_bytes=report["weight_bytes"],
                     quantize_seconds=report["quantize_seconds"],
                     group=WEIGHTS_INT8.group)
    head = head_matrix(params, cfg)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device="cuda")
    pre = ContextParallelPrefiller(cp_params, cfg,
                                   block_size=LONGCTX["block"],
                                   pad_tokens=cfg.max_seq, sp=sp)
    upre = None if int8 else ContextParallelPrefiller(
        cp_params, cfg, block_size=LONGCTX["block"],
        pad_tokens=cfg.max_seq, sp=sp, sp_mode="ulysses")
    local = pre.pad_tokens // sp
    want_launches = (cfg.n_layers, 0, 0, (sp - 1) * cfg.n_layers)
    main_launches = main_ms = uly_launches = None
    prompts = LONGCTX["tokens"][:1] if int8 else LONGCTX["tokens"]
    for i, n in enumerate(prompts):
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
        kernel = ref["auto"]
        err, cal, ratio = _cp_errors(got, got_kv, ref, local)
        rank0_equal = all(torch.equal(g[:, :local], w[:, :local])
                          for g, w in zip(got_kv, kernel[1:]))
        rec = {"phase": "longctx_int8" if int8 else "longctx",
               **plane, "model": LONGCTX["model"],
               "reduced": _depth_cut(LONGCTX["model"], cfg),
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
                       bf16_ms_same_run=bf16_ms,
                       single_device_forward_ms=cuda_ms(
                           lambda: final_hidden(params, forward_hidden(
                               params, full[None], cfg)[0, -1], cfg) @ head,
                           2))
            main_launches, main_ms = (launches[0], launches[3]), ms
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
        del got_kv
        if upre is not None:
            launches = _ulysses_prefill(upre, prompt, ref, local, cfg,
                                        main_ms if i == 0 else None)
            if i == 0:
                uly_launches = (launches[0], launches[3])
        del ref
    require(pre.prefill_compiles == 1 and pre.head_compiles == 1,
            "the CP prefill ran at more than one shape")
    require(upre is None or (upre.prefill_compiles, upre.head_compiles)
            == (1, 1), "the Ulysses prefill ran at more than one shape")
    del params, cp_params, pre, upre
    free_device()
    return main_launches, main_ms, uly_launches


# ------------------------------------------------- long-context decode

# Phase longctx_decode: the long-context plane (serving/longctx) attached
# to a DecodeEngine the way ServingReplica attaches it
# (longctx_plane_from_conf under serving.parity=relaxed). llama3-8b at
# full width and LONGCTX's depth, ``layers`` of 32 (bf16, random weights from seed 0; then its int8
# plane, group 64): an 8192-token prompt through engine.submit → CP
# prefill at sp 4, block 16 → the chain ingested into the page-locked
# host ring → working-set decode of `new` greedy tokens on the pipelined
# path with the device sampler. The config's max_seq is 8192 + 128: the
# rope table covers the generated positions past the published 8192 (and
# the reference's padding to a multiple of 128). Each decoded token's
# logits (a host-sampler decoder on the same chain, whose tokens must
# equal the device sampler's) are held against the single-device forward
# over prompt + generated tokens, teacher-forced, by the longctx phase's
# calibration: the same forward with plain attention; at most
# `cal_factor` times its distance, value by value per token. The legacy
# loop decodes `legacy_new` tokens on the same chain: its tokens equal
# the pipelined path's but at a near-tie (TIE_REL). flagship-1b in
# float32: a 1536-token prompt (min.tokens 1024) through the plane
# against the same prompt through the fused step of an engine with
# max_context 2048: equal tokens, a difference only at a near-tie of the
# float32 greedy loop (the serving phase's rule).
LONGCTX_DECODE = dict(model="llama3-8b", layers=LONGCTX["layers"], sp=4,
                      block=16, tokens=8192,
                      min_tokens=4096, new=32, legacy_new=8,
                      window_blocks=4, tail=256,
                      cal_factor=2.0, flagship_prompt=1536,
                      flagship_min_tokens=1024, flagship_context=2048,
                      flagship_new=16)


def _longctx_engine(params, cfg, chain_tokens, max_context, **keys):
    """A one-lane DecodeEngine (block 16) with a page-locked host ring for
    a chain of ``chain_tokens`` plus the pool's churn slack, and the
    long-context plane from the conf keys, as ServingReplica wires it."""
    bs = LONGCTX_DECODE["block"]
    block_bytes = (2 * cfg.n_layers * bs * cfg.n_kv_heads * cfg.head_dim
                   * cfg.torch_dtype.itemsize)
    ring = (chain_tokens // bs + max_context // bs + 8) * block_bytes
    eng = DecodeEngine(params, cfg, max_batch=1, block_size=bs,
                       max_context=max_context, prefill_chunk=64,
                       kv_host_bytes=ring)
    conf = Configuration(load_defaults=False)
    conf.set("serving.parity", "relaxed")
    conf.set("serving.longctx.enabled", "true")
    conf.set("serving.longctx.chips", str(LONGCTX_DECODE["sp"]))
    conf.set("serving.longctx.decode.window.blocks",
             str(LONGCTX_DECODE["window_blocks"]))
    conf.set("serving.longctx.decode.tail.tokens",
             str(LONGCTX_DECODE["tail"]))
    for key, value in keys.items():
        conf.set(key, str(value))
    eng.attach_longctx(longctx_plane_from_conf(conf, cfg, eng))
    require(eng.kvstore.host is not None and
            torch.from_numpy(eng.kvstore.host._k).is_pinned(),
            "the host ring is not page-locked")
    return eng


def _plane_run(eng, prompt, new):
    """One request through ``eng.submit`` (routed to the plane), counted:
    the tokens and a record of TTFT, the decode's host-clock split,
    dispatches and slab transfers per token, launches, and the working
    set against the bytes its buffers requested of the allocator
    (``requested_bytes`` of ``torch.cuda.memory_stats``: a cached block
    handed out whole may be larger than the request)."""
    plane = eng._relaxed_longctx
    dec = plane.decoder
    d0, f0, t0 = dec.dispatches, dec.window_fetches, dec.tokens_decoded
    torch.cuda.synchronize()
    zero_counts()                              # the main path's run
    req = eng.submit(prompt, SamplingParams(max_new_tokens=new))
    toks = req.wait(1800)
    torch.cuda.synchronize()
    n = dec.tokens_decoded - t0
    n_slabs = -(-(len(prompt) // dec.block_size * dec.block_size)
                // (dec.fetch_windows * dec.win))
    timing = dec.last_timing
    rec = {"prompt_tokens": len(prompt), "tokens": len(toks),
           "ttft_s": req.first_token_at - req.submitted_at,
           "decode_chain_s": timing["chain_s"],
           "decode_pack_s": timing["pack_s"],
           "ms_per_token": timing["tokens_s"] * 1e3 / timing["tokens"],
           "tokens_per_s": timing["tokens"] / timing["tokens_s"],
           "dispatches_per_token": (dec.dispatches - d0) / n,
           "dispatch_budget": dec.cfg.n_layers * n_slabs
           + dec.cfg.n_layers + 1,
           "slab_transfers_per_token": (dec.window_fetches - f0) / n,
           "slabs_per_layer": n_slabs,
           "slab_bytes": dec.slab_bytes,
           "hbm_window_bytes": dec.hbm_window_bytes,
           "hbm_tail_bytes": dec.tail_cap * dec._per_tok_bytes,
           "sampler_state_bytes": dec.sampler_state_bytes,
           "hbm_working_set_bytes": dec.hbm_working_set_bytes,
           "allocator_requested_bytes": dec.last_alloc_bytes,
           "launches_fwd_partial": [flash.launches, flash.launches_partial],
           "launches_rms_norm_fwd": norms.launches_fwd,
           "launches_dequant": weightplane.launches_dequant,
           "stats": {k: v for k, v in plane.stats().items()
                     if k not in ("decode_traces", "decode_dispatch_counts")},
           "kv_tiers": eng.kvstore.stats()}
    require(rec["dispatches_per_token"] == rec["dispatch_budget"],
            f"dispatches per token {rec['dispatches_per_token']}, budget "
            f"{rec['dispatch_budget']}")
    require(rec["slab_transfers_per_token"] == dec.cfg.n_layers * n_slabs,
            f"slab transfers per token {rec['slab_transfers_per_token']}")
    require(rec["allocator_requested_bytes"] == rec["hbm_working_set_bytes"],
            f"working set {rec['hbm_working_set_bytes']} B against the "
            f"{rec['allocator_requested_bytes']} B requested of the "
            f"allocator")
    return toks, rec


def _decoder_logits(eng, prompt, first, new, **kw):
    """A host-sampler decoder on ``eng``'s tiers (the plane's chain) from
    ``first``: its tokens and each decoded token's logits [V]."""
    plane = eng._relaxed_longctx
    dec = WorkingSetDecoder(plane.decoder.params, plane.decoder.cfg,
                            eng.kvstore, block_size=eng.block_size,
                            window_blocks=LONGCTX_DECODE["window_blocks"],
                            tail_tokens=LONGCTX_DECODE["tail"],
                            sampler="host", **kw)
    rows, out = [], []
    real = decode_module._host_sample

    def sample(logits, temperature, top_k, rng):
        rows.append(torch.from_numpy(np.array(logits)))
        return real(logits, temperature, top_k, rng)

    decode_module._host_sample = sample
    try:
        dec.paged_decode(prompt, first, SamplingParams(max_new_tokens=new),
                         deliver=out.append, seed=0)
    finally:
        decode_module._host_sample = real
    return [first] + out, rows


def _teacher_forced(params, cfg, prompt, toks):
    """The single-device forward over prompt + toks[:-1], padded to a
    multiple of 128 (causal: the padding reaches no earlier row), for the
    kernel forward ("auto") and plain attention ("ref"): the logits rows
    that produced toks[1:], float32 on the host."""
    full = prompt + toks[:-1]
    n = -(-len(full) // 128) * 128
    x = torch.tensor([full + [0] * (n - len(full))], device="cuda")
    head = head_matrix(params, cfg)
    s = len(prompt)
    out = {}
    with torch.no_grad():
        for impl in ("auto", "ref"):
            h = forward_hidden(params, x, cfg, attn_impl=impl)
            out[impl] = (final_hidden(params, h[0, s:s + len(toks) - 1], cfg)
                         @ head).float().cpu()
            del h
            torch.cuda.empty_cache()
    return out


def _near_tie(rows, j, a, b):
    la, lb = rows[j][a].item(), rows[j][b].item()
    return abs(la - lb) / max(abs(la), abs(lb), 1e-30) < TIE_REL


def _tokens_agree(got, want, rows):
    """got equals want, or first differs at a near-tie of ``rows`` (the
    logits row behind each decoded token: row j for token j + 1)."""
    for j, (a, b) in enumerate(zip(got, want)):
        if a != b:
            return j > 0 and _near_tie(rows, j - 1, a, b)
    return True


def _llama_decode_part(params, ref_params, cfg, prompt, label):
    """The plane's run on ``params`` (bf16 or the int8 plane), its
    logits against ``ref_params``' teacher-forced forward, the legacy
    loop's tokens. Returns the record."""
    new = LONGCTX_DECODE["new"]
    eng = _longctx_engine(params, cfg, len(prompt), 256, **{
        "serving.longctx.min.tokens": LONGCTX_DECODE["min_tokens"],
        "serving.longctx.max.tokens": LONGCTX_DECODE["tokens"]})
    toks, rec = _plane_run(eng, prompt, new)
    host_toks, rows = _decoder_logits(eng, prompt, toks[0], new)
    legacy = None
    if label == "bf16":
        legacy, legacy_rows = _decoder_logits(
            eng, prompt, toks[0], LONGCTX_DECODE["legacy_new"] + 1,
            pipeline=False)
        rec["legacy_tokens_equal"] = legacy == toks[:len(legacy)]
        rec["legacy_vs_pipelined_logits_rel"] = max(
            _max_rel(a, b) for a, b in zip(legacy_rows, rows))
        require(_tokens_agree(legacy, toks, rows),
                f"legacy tokens {legacy} against pipelined {toks}")
    eng.stop()
    del eng
    free_device()
    ref = _teacher_forced(ref_params, cfg, prompt, toks)
    err = [_max_rel(g, k) for g, k in zip(rows, ref["auto"])]
    cal = [_max_rel(p, k) for p, k in zip(ref["ref"], ref["auto"])]
    ratio = max(e / c if c else (0.0 if e == 0 else math.inf)
                for e, c in zip(err, cal))
    argmax = sum(int(int(r.argmax()) == t)
                 for r, t in zip(ref["auto"], toks[1:]))
    rec["rows"] = rows
    rec.update(part=label, host_sampler_tokens_equal=host_toks == toks,
               logits_rel_err=err, logits_rel_err_calibration=cal,
               calibration_ratio_max=ratio,
               cal_factor=LONGCTX_DECODE["cal_factor"],
               reference_argmax_equal=argmax, tokens_out=toks,
               logits_finite=all(bool(torch.isfinite(r).all())
                                 for r in rows))
    require(host_toks == toks, f"host-sampler tokens {host_toks} differ "
            f"from the device sampler's {toks}")
    require(rec["logits_finite"] and len(rows) == new - 1,
            "decoded logits missing or not finite")
    require(ratio <= LONGCTX_DECODE["cal_factor"],
            f"{label} decode logits up to {ratio} times the calibration's "
            f"distance from the single-device forward")
    return rec


def _ulysses_plane(params, cfg, prompt, ring_toks, ring_rows):
    """Phase ``ulysses`` through the plane: ``serving.longctx.sp.mode=
    ulysses`` on the replica conf, the prompt through ``engine.submit``:
    its greedy tokens against the ring plane's (equal, or first apart at
    a near-tie of the ring run's logits), no partial launch."""
    new = LONGCTX_DECODE["new"]
    eng = _longctx_engine(params, cfg, len(prompt), 256, **{
        "serving.longctx.min.tokens": LONGCTX_DECODE["min_tokens"],
        "serving.longctx.max.tokens": LONGCTX_DECODE["tokens"],
        "serving.longctx.sp.mode": "ulysses"})
    require(eng._relaxed_longctx.prefiller.sp_mode == "ulysses",
            "the conf key did not select Ulysses")
    toks, rec = _plane_run(eng, prompt, new)
    eng.stop()
    del eng
    free_device()
    emit({"phase": "ulysses", "part": "plane", "model":
          LONGCTX_DECODE["model"], "dtype": cfg.dtype,
          "reduced": _depth_cut(LONGCTX_DECODE["model"], cfg),
          "sp": LONGCTX_DECODE["sp"], "tokens_equal_ring": toks == ring_toks,
          "tokens_out": toks, **rec})
    require(_tokens_agree(toks, ring_toks, ring_rows),
            f"Ulysses plane tokens {toks} against the ring's {ring_toks}")
    require(rec["launches_fwd_partial"][1] == 0,
            f"the Ulysses plane launched the partial: "
            f"{rec['launches_fwd_partial']}")


def phase_longctx_decode():
    """llama3-8b's bf16 and int8 planes through the long-context lane (see
    LONGCTX_DECODE). Returns the launches of the bf16 run (RMSNorm
    forward) and of the int8 run (dequantize)."""
    cfg = get_config(LONGCTX_DECODE["model"],
                     n_layers=LONGCTX_DECODE["layers"],
                     max_seq=LONGCTX_DECODE["tokens"] + 128)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    prompt = torch.randint(0, cfg.vocab_size, (LONGCTX_DECODE["tokens"],),
                           generator=torch.Generator().manual_seed(SEED + 30)
                           ).tolist()
    rec = _llama_decode_part(params, params, cfg, prompt, "bf16")
    rows = rec.pop("rows")
    emit({"phase": "longctx_decode", "model": LONGCTX_DECODE["model"],
          "reduced": _depth_cut(LONGCTX_DECODE["model"], cfg),
          "dtype": cfg.dtype, "sp": LONGCTX_DECODE["sp"],
          "block_size": LONGCTX_DECODE["block"], **rec})
    rms_launches = rec["launches_rms_norm_fwd"]
    _ulysses_plane(params, cfg, prompt, rec["tokens_out"], rows)
    qparams, report = weightplane.quantize_params(params, cfg, WEIGHTS_INT8)
    del params
    free_device()
    ref_params = weightplane.dequantize_params(qparams, cfg)
    rec = _llama_decode_part(qparams, ref_params, cfg, prompt, "int8")
    del rec["rows"]
    emit({"phase": "longctx_decode", "model": LONGCTX_DECODE["model"],
          "reduced": _depth_cut(LONGCTX_DECODE["model"], cfg),
          "dtype": "int8", "group": WEIGHTS_INT8.group,
          "weight_bytes": report["weight_bytes"],
          "sp": LONGCTX_DECODE["sp"], "block_size": LONGCTX_DECODE["block"],
          **rec})
    dequant_launches = rec["launches_dequant"]
    del qparams, ref_params
    free_device()
    return rms_launches, dequant_launches


def phase_longctx_decode_flagship(cfg32, p32):
    """flagship-1b in float32: the plane's greedy tokens for a 1536-token
    prompt against the fused step's for the same prompt."""
    c = LONGCTX_DECODE
    prompt = torch.randint(0, cfg32.vocab_size, (c["flagship_prompt"],),
                           generator=torch.Generator().manual_seed(SEED + 31)
                           ).tolist()
    plain = DecodeEngine(p32, cfg32, max_batch=1, block_size=c["block"],
                         max_context=c["flagship_context"], prefill_chunk=64)
    want = plain.generate([prompt], SamplingParams(
        max_new_tokens=c["flagship_new"]))[0]
    del plain
    free_device()
    eng = _longctx_engine(p32, cfg32, len(prompt), c["flagship_context"], **{
        "serving.longctx.min.tokens": c["flagship_min_tokens"]})
    got, rec = _plane_run(eng, prompt, c["flagship_new"])
    eng.stop()
    del eng
    free_device()
    ties = []
    if got != want:
        # each must equal the float32 greedy loop but at a near-tie
        # (_greedy_f32_gate raises otherwise), and one of them met one
        for toks in (want, got):
            ties += _greedy_f32_gate([toks], p32, cfg32, [prompt],
                                     c["flagship_new"])[1]
    emit({"phase": "longctx_decode", "part": "flagship-1b-f32",
          "model": "flagship-1b", "dtype": cfg32.dtype, "engine_tokens": want,
          "plane_tokens": got, "equal": got == want, "ties": ties, **rec})
    require(got == want or ties, f"plane tokens {got} differ from the fused "
            f"step's {want} away from a near-tie")


# ------------------------------------------------------- the weight plane

def _reckon_weight_bytes(cfg, group):
    """The int8 plane's resident bytes from the config's shapes alone:
    each layer matmul's elements at 1 B plus one f32 scale per ``group``
    of them, every other leaf (embed, head, router, norms) at the
    model's dtype."""
    shapes = init_params(cfg, torch.Generator(), device="meta")
    item = torch.empty((), dtype=cfg.torch_dtype).element_size()
    total = 0
    for name, leaf in shapes["layers"].items():
        if name in weightplane.LAYER_MATMULS:
            total += leaf.numel() + leaf.numel() // group * 4
        else:
            total += leaf.numel() * item
    for name, leaf in shapes.items():
        if name != "layers":
            total += leaf.numel() * item
    return total


def phase_weightplane(fs, root):
    """flagship-1b's step-6 checkpoint on the int8 weight plane
    (WEIGHTS_INT8; see WEIGHTPLANE): quantize-at-load, the A/B guard,
    graph against eager, float32 exactness against the dequantized
    forward, step times and sizing against bf16, and the door."""
    W = WEIGHTPLANE
    cfg = get_config("flagship-1b")
    free_device()          # nothing an earlier phase dropped frees below
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    qparams, step, report = weightplane.quantized_load(
        fs, f"{root}/resumed", cfg, WEIGHTS_INT8,
        io_workers=TRAINER["io_workers"])
    torch.cuda.synchronize()
    delta = torch.cuda.memory_allocated() - before
    want_bytes = _reckon_weight_bytes(cfg, WEIGHTS_INT8.group)
    params, _ = load_serving_params(fs, f"{root}/resumed", cfg,
                                    io_workers=TRAINER["io_workers"])
    ab = weightplane.run_weight_ab(cfg, params, qparams, wp=WEIGHTS_INT8)
    emit({"phase": "weightplane", "part": "load", "step": step,
          "report": report, "weight_bytes_reckoned": want_bytes,
          "allocator_delta_bytes": delta,
          "weight_bytes_bf16": weightplane.resident_weight_bytes(params),
          "ab": ab})
    require(step == TRAINER["steps"], f"loaded step {step}")
    require(report["weight_bytes"] == want_bytes,
            f"int8 weight bytes {report['weight_bytes']}, reckoned "
            f"{want_bytes}")
    require(abs(delta - want_bytes) <= W["alloc_slack"] * want_bytes,
            f"the allocator grew by {delta} B for {want_bytes} B of "
            f"weights")
    require(all(math.isfinite(ab[k]) for k in ("max_abs", "max_rel"))
            and ab["max_rel"] <= WEIGHTS_INT8.guard_rel_tol,
            f"weight A/B guard: {ab}")

    # the int8 engine through its graphs and its eager step
    prompts, _ = _prompts(cfg.vocab_size)
    prompts = prompts[:W["prompts"]]
    greedy = SamplingParams(max_new_tokens=W["max_new"])
    requests = [(p, greedy) for p in prompts]
    runs = {mode: _serve_steps(qparams, cfg, requests, mode == "graph")
            for mode in ("graph", "eager")}
    free_device()
    equal = [a == b for a, b in zip(runs["graph"][0], runs["eager"][0])]
    emit({"phase": "weightplane", "part": "graphs",
          "tokens_equal_per_request": equal, "graph": runs["graph"][1],
          "eager": runs["eager"][1]})
    require(all(equal), f"int8 graph tokens differ from eager: {equal}")
    require(runs["graph"][1]["graphs_captured"] == 2
            and all(r[1]["decode_shapes"] == 1 and r[1]["fused_shapes"] == 1
                    for r in runs.values()),
            "the int8 engine captured or stepped at more than two shapes")

    # float32 int8: the engine's greedy tokens against the plain greedy
    # loop over the reconstruction
    cfg32 = get_config("flagship-1b", dtype="float32")
    q32, _ = weightplane.quantize_params(_cast(params, torch.float32), cfg32,
                                         WEIGHTS_INT8)
    eng = DecodeEngine(q32, cfg32, **SERVE_KW)
    outs = eng.generate(prompts, greedy)
    del eng
    free_device()
    compared, ties = _greedy_f32_gate(
        outs, weightplane.dequantize_params(q32, cfg32), cfg32, prompts,
        W["max_new"])
    emit({"phase": "weightplane", "part": "float32", "requests": len(outs),
          "greedy_tokens_equal": compared, "near_ties": ties})
    del q32
    free_device()

    # step times, int8 against bf16, on the door's requests
    door_prompts = _door_prompts(cfg.vocab_size)
    door_greedy = [SamplingParams(max_new_tokens=DOOR["max_new"])] * len(
        door_prompts)
    timed = {}
    for name, tree in (("bf16", params), ("int8", qparams)):
        eng = DecodeEngine(tree, cfg, **SERVE_KW)
        timed[name] = _timed_run(eng, door_prompts, door_greedy)[1]
        del eng
        free_device()
    # sizing at one budget
    sizing = {}
    for name, tree in (("bf16", params), ("int8", qparams)):
        eng = DecodeEngine(tree, cfg, block_size=SERVE_KW["block_size"],
                           max_context=SERVE_KW["max_context"],
                           prefill_chunk=SERVE_KW["prefill_chunk"],
                           hbm_bytes=W["budget"], max_lanes=W["max_lanes"])
        plane = eng.weight_plane()
        sizing[name] = {k: plane[k] for k in (
            "weight_bytes", "lanes", "kv_capacity_tokens",
            "lanes_x_context")}
        sizing[name]["num_blocks"] = eng.pool.num_blocks
        del eng
    emit({"phase": "weightplane", "part": "steps", "timed": timed,
          "sizing_budget_bytes": W["budget"], "sizing": sizing})
    for name, rec in timed.items():
        require(rec["graphs_captured"] == 2 and rec["decode_shapes"] == 1
                and rec["fused_shapes"] == 1,
                f"{name}: more than one capture per step shape")
    require(sizing["int8"]["lanes_x_context"]
            > sizing["bf16"]["lanes_x_context"],
            f"the int8 plane bought no capacity: {sizing}")

    # the door with serving.parity=relaxed against the in-process engine
    conf = Configuration()
    for key, value in (("serving.http.auth.secret", DOOR["secret"]),
                       ("serving.parity", "relaxed"),
                       ("serving.weights.group", WEIGHTS_INT8.group),
                       ("serving.max.batch", SERVE_KW["max_batch"]),
                       ("serving.kv.block.size", SERVE_KW["block_size"]),
                       ("serving.max.context", SERVE_KW["max_context"]),
                       ("serving.prefill.chunk", SERVE_KW["prefill_chunk"]),
                       ("serving.loader.io.workers", TRAINER["io_workers"])):
        conf.set(key, value)
    replica = ServingReplica(conf, name="chip-smoke-int8",
                             preset="flagship-1b",
                             checkpoint=f"{root}/resumed", fs=fs)
    replica.start()
    try:
        door, _, wall = _door_round(replica.server.port,
                                    door_prompts[:W["door"]])
        status, body = _http(replica.server.port, "GET", "/v1/health")
        health = json.loads(body)["weights"]
    finally:
        replica.drain_and_stop()
    eng = DecodeEngine(qparams, cfg, **SERVE_KW)
    local = eng.generate(door_prompts[:W["door"]],
                         SamplingParams(max_new_tokens=DOOR["max_new"]))
    del eng
    emit({"phase": "weightplane", "part": "door", "requests": len(door),
          "seconds": wall, "tokens_equal": door == local,
          "health_weights": health})
    require(status == 200 and health["parity"] == "relaxed"
            and health["weight_bytes"] == want_bytes,
            f"door health weights {health}")
    require(door == local, "door tokens differ from the in-process int8 "
            "engine's")
    del params, qparams
    free_device()


# ------------------------------------------------------------ DFS daemons

def _sha_tree(fs, path):
    """{file: sha256} of every file under ``path``, read through ``fs``."""
    out = {}
    for st in fs.list_status(path):
        if st.is_dir:
            out.update(_sha_tree(fs, st.path))
        else:
            out[st.path] = hashlib.sha256(fs.read_all(st.path)).hexdigest()
    return out


def _tree_bytes(fs, path):
    return sum(_tree_bytes(fs, st.path) if st.is_dir else st.length
               for st in fs.list_status(path))


def _dn_index(cluster, uuid):
    return next(i for i, dn in enumerate(cluster.datanodes)
                if dn is not None and dn.uuid == uuid)


def _until(cond, timeout_s, pump=None, what=""):
    """Seconds until ``cond()`` holds, calling ``pump`` between looks;
    fails the run past ``timeout_s``."""
    t0 = time.monotonic()
    while not cond():
        require(time.monotonic() - t0 < timeout_s,
                f"{what}: not within {timeout_s} s")
        if pump is not None:
            pump()
        time.sleep(0.05)
    return time.monotonic() - t0


def _replicas_ok(cluster, fs, files, want, dead):
    """Every block of ``files`` has ``want`` replicas on DataNodes that
    run and are not the ``dead`` uuid."""
    live = {dn.uuid for dn in cluster.datanodes
            if dn is not None and dn.uuid != dead}
    for path in files:
        for b in fs.client.get_block_locations(path)["blocks"]:
            info = cluster.namenode.fsn.bm.get(b["b"]["id"])
            if len(set(info.locations) & live) < want:
                return False
    return True


def _unit_bytes(cluster, uuid, block_id):
    """The raw bytes of replica ``block_id`` on DataNode ``uuid``."""
    dn = cluster.datanodes[_dn_index(cluster, uuid)]
    rep = dn.store.get_replica(block_id)
    require(rep is not None, f"no replica {block_id} on {uuid}")
    data_path, _, _, n = dn.store.open_for_read(rep.to_block())
    with open(data_path, "rb") as f:
        return f.read(n)


def phase_dfs_daemons(smi):
    """The port's NameNode and DataNodes on the host under the card's
    work (DFS_DAEMONS): flagship-1b (2 layers) trained, checkpointed and
    resumed on htpu://, served by the loader with a DataNode down, its
    checkpoint re-replicated and read back across a NameNode restart; an
    RS(6,3) file's parity and rebuilt unit held to ec_gf256.cu; the DFS KV
    tier. Returns the phase's launches by kernel and its record."""
    D = DFS_DAEMONS
    cfg = get_config("flagship-1b", n_layers=D["layers"])
    batch, seq = TRAIN["batch"], TRAIN["seq"]
    leaves = tree_leaves(init_params(cfg, torch.Generator(), device="meta"))
    n_params = sum(p.numel() for p in leaves)
    elt = torch.finfo(cfg.torch_dtype).bits // 8
    ckpt_bytes = n_params * (elt + 4 + 4) + 4 + 8
    tmp = tempfile.mkdtemp(prefix="htpu-dfs-")
    # three replicas of two checkpoints, one more while re-replicating,
    # the file:// twin, the striped file at 1.5x
    need = 8 * ckpt_bytes + 2 * D["ec_units"] * D["ec_unit"]
    free_disk = shutil.disk_usage(tmp).free
    require(free_disk > need, f"{free_disk} B free under {tmp}: the phase "
            f"needs {need} B")
    mem_avail = _mem_available()
    require(mem_avail > 3 * ckpt_bytes,
            f"{mem_avail} B of host memory available for snapshots of "
            f"{ckpt_bytes} B")
    conf = fast_conf()
    conf.set("dfs.blocksize", str(128 << 20))          # the default
    conf.set("dfs.namenode.redundancy.interval", D["redundancy_s"])
    # the reference's default, which fast_conf shortens to 4 s: a unit's
    # rebuild outlasting it is scheduled again over itself
    conf.set("dfs.namenode.reconstruction.pending.timeout", "30s")
    sock = f"{tmp}/ds-_PORT.sock"
    if len(sock) < 100:                      # AF_UNIX paths are short
        conf.set("dfs.domain.socket.path", sock)
    n_tokens = int(TRAINER["file_batches"] * batch * (seq + 1))
    tokens = torch.randint(0, cfg.vocab_size, (n_tokens,),
                           generator=torch.Generator().manual_seed(SEED + 60))
    token_bytes = tokens.numpy().astype(np.uint16).tobytes()
    local, lroot = LocalFileSystem(), f"{tmp}/local"
    rec = {"phase": "dfs_daemons", "model": "flagship-1b",
           "layers": cfg.n_layers, "reduced": f"depth {cfg.n_layers} of "
           f"{get_config('flagship-1b').n_layers} layers",
           "datanodes": D["datanodes"], "params": n_params,
           "checkpoint_bytes_reckoned": ckpt_bytes}
    launches = {}
    zero_counts()
    ec_device.launches = 0
    try:
        with MiniDFSCluster(num_datanodes=D["datanodes"], conf=conf,
                            base_dir=f"{tmp}/dfs") as cluster:
            fs = cluster.get_filesystem()
            hroot = "/flagship"
            gate_s, t0 = {}, time.monotonic()
            host, train = _dfs_train_gate(cfg, fs, hroot, local, lroot,
                                          token_bytes, len(leaves))
            rec.update(train)
            gate_s["train"], t0 = time.monotonic() - t0, time.monotonic()
            params, loader = _dfs_loader_gate(cluster, fs, hroot, cfg, host)
            del host
            rec.update(loader)
            gate_s["loader"], t0 = time.monotonic() - t0, time.monotonic()
            rec.update(_dfs_restart_gate(cluster, fs, hroot))
            gate_s["restart"], t0 = time.monotonic() - t0, time.monotonic()
            rec.update(_dfs_ec_gate(cluster, fs))
            gate_s["ec"], t0 = time.monotonic() - t0, time.monotonic()
            rec.update(_dfs_kv_gate(fs, params, cfg))
            gate_s["kv"] = time.monotonic() - t0
            rec["gate_s"] = gate_s
            del params
            launches = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                 "adamw", "grad_sq", "rms_norm_fwd",
                                 "rms_norm_bwd"), train_counts()),
                            ec_gf256=ec_device.launches)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["launches"] = launches
    rec["device"] = smi
    require(launches.get("ec_gf256", 0) >= 2,
            f"ec_gf256.cu launched {launches.get('ec_gf256')} times")
    rec["note"] = ("host numbers with the card in the loop: one process "
                   "holds the NameNode, the DataNodes, the client and the "
                   "model; no DFS benchmark")
    emit({"dfs": rec})
    free_device()
    return launches, rec


def _dfs_train_gate(cfg, fs, hroot, local, lroot, token_bytes, n_leaves):
    """Gate 1: an uninterrupted run on file:// (its explicit save and a
    restore timed there), then Trainer on htpu:// to the interval save at
    ``save_at``, and a second Trainer that resumes from it for the last
    step and saves: losses within TRAINER's loss_rtol, each step's
    launches as the train phase's at this depth."""
    D = DFS_DAEMONS
    batch, steps, save_at = TRAIN["batch"], D["steps"], D["save_at"]
    local.write_all(f"{lroot}/tokens.bin", token_bytes)
    fs.write_all(f"{hroot}/tokens.bin", token_bytes)

    def trainer(store, root, **kw):
        return Trainer(cfg, MeshPlan(), store, f"{root}/tokens.bin",
                       f"{root}/trainer", batch=batch, lr=TRAIN["lr"],
                       remat=TRAIN["remat"], seed=SEED, **kw)

    per_step = []
    u = trainer(local, lroot, ckpt_interval=0, keep=1)
    _counted_steps(u, per_step)
    want_losses = u.train(steps)
    file_save_s = _timed(lambda: u.save())
    u.close()
    del u
    r = trainer(local, lroot, ckpt_interval=0, keep=1)
    file_restore_s = _timed(r.try_restore)
    require(r.step == steps, f"file:// restore at step {r.step}")
    r.close()
    del r

    a = trainer(fs, hroot, ckpt_interval=save_at, keep=1)
    _counted_steps(a, per_step)
    crashed = a.train(save_at)          # the interval save fenced at exit
    require(list_checkpoints(fs, f"{hroot}/trainer") == [save_at],
            "the interval save is not durable on htpu:// at train()'s exit")
    a.close()
    del a
    b = trainer(fs, hroot, ckpt_interval=0, keep=1)
    _counted_steps(b, per_step)
    restore_s = _timed(b.try_restore)
    require(b.step == save_at, f"htpu:// restore at step {b.step}")
    resumed = b.train(steps - save_at)
    save_s = _timed(lambda: b.save())
    require(list_checkpoints(fs, f"{hroot}/trainer") == [steps],
            "retention kept more than the newest checkpoint")
    host = tree_map(lambda t: t.cpu(), b.params)
    b.close()
    del b
    ckpt = _tree_bytes(fs, f"{hroot}/trainer/step_{steps:012d}")
    got = crashed + resumed
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want_losses)]
    want = train_counts_want(cfg, n_leaves)
    require(all(math.isfinite(x) for x in got + want_losses),
            "non-finite loss")
    require(max(rel) <= TRAINER["loss_rtol"],
            f"htpu:// losses {got} against file:// {want_losses}")
    require(all(c == want for c, _, _ in per_step) and
            len(per_step) == 2 * steps,
            f"launches per step (fwd, dq, dkv, adamw, grad_sq, rms_norm fwd, "
            f"rms_norm bwd), expected {want}: "
            f"{[c for c, _, _ in per_step]}")
    mb = ckpt / 1e6
    return host, {"losses_file": want_losses, "losses_htpu": got,
                  "loss_rel_err": rel, "checkpoint_bytes": ckpt,
                  "save_s": save_s, "save_mb_per_s": mb / save_s,
                  "restore_s": restore_s,
                  "restore_mb_per_s": mb / restore_s,
                  "file_save_s": file_save_s,
                  "file_save_mb_per_s": mb / file_save_s,
                  "file_restore_s": file_restore_s,
                  "file_restore_mb_per_s": mb / file_restore_s,
                  "launches_per_step": want}


def _timed(fn):
    """Wall seconds of ``fn()`` between two device syncs; fails the run
    when it returns False (a restore that found nothing)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    require(out is not False, f"{fn} returned False")
    return time.monotonic() - t0


def _dfs_loader_gate(cluster, fs, hroot, cfg, host):
    """Gate 2: a DataNode holding the first shard dies; the loader serves
    the checkpoint (its leaves bit-equal to ``host``, the resumed
    trainer's parameters, and greedy tokens equal to an engine's on
    those), and the NameNode brings every block back to 3 live replicas.
    Returns the loaded parameters and the record."""
    D = DFS_DAEMONS
    step_dir = f"{hroot}/trainer/step_{D['steps']:012d}"
    files = sorted(st.path for st in fs.list_status(step_dir))
    shard = next(p for p in files if not p.endswith("manifest.json"))
    holder = fs.client.get_block_locations(shard)["blocks"][0]["locs"][0]
    victim = _dn_index(cluster, holder["u"])
    cluster.kill_datanode(victim)
    dead = holder["u"]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    params, step = load_serving_params(fs, f"{hroot}/trainer", cfg,
                                       io_workers=TRAINER["io_workers"])
    torch.cuda.synchronize()
    load_s = time.monotonic() - t0
    require(step == D["steps"], f"loaded step {step}")
    unequal = [i for i, (x, y) in enumerate(zip(tree_leaves(params),
                                                tree_leaves(host)))
               if x.dtype != y.dtype or not torch.equal(x.cpu(), y)]
    require(not unequal, f"loaded leaves {unequal} differ from the "
            f"trainer's")
    prompts = _prompts(cfg.vocab_size)[0][1:1 + TRAINER["prompts"]]
    greedy = SamplingParams(max_new_tokens=D["max_new"])
    tokens = []
    dev = tree_leaves(params)[0].device
    for tree in (params, tree_map(lambda t: t.to(dev), host)):
        eng = DecodeEngine(tree, cfg, **SERVE_KW)
        tokens.append(eng.generate(prompts, greedy))
        eng.stop()
        del eng
    require(tokens[0] == tokens[1], "greedy tokens of the checkpoint "
            "loaded from htpu:// differ from the trainer's parameters'")
    # from the first redundancy pass: the DataNode's dead interval has
    # passed during the load
    rereplicate_s = _until(
        lambda: _replicas_ok(cluster, fs, files, 3, dead), D["timeout_s"],
        pump=cluster.namenode.redundancy_pass,
        what="re-replication of the checkpoint")
    cluster.restart_datanode(victim)
    cluster.wait_active()
    return params, {"load_s": load_s, "killed_datanode": victim,
                    "tokens_loaded": tokens[0],
                    "rereplicate_s": rereplicate_s}


def _dfs_restart_gate(cluster, fs, hroot):
    """Gate 3: the NameNode restarts from its fsimage and edits; the
    checkpoint lists again and reads back with the same hashes."""
    base = f"{hroot}/trainer"
    before = _sha_tree(fs, base)
    t0 = time.monotonic()
    cluster.restart_namenode()
    cluster.wait_active()
    restart_s = time.monotonic() - t0
    require(list_checkpoints(fs, base) == [DFS_DAEMONS["steps"]],
            "the checkpoint does not list after the NameNode's restart")
    after = _sha_tree(fs, base)
    require(after == before, "the checkpoint's bytes changed across the "
            "NameNode's restart")
    return {"namenode_restart_s": restart_s, "checkpoint_files": len(after)}


def _dfs_ec_gate(cluster, fs):
    """Gate 4: RS(6,3) on a directory, ``ec_units`` units of seeded bytes
    written through the port's striped client; the parity units' raw
    bytes on the DataNodes equal ec_gf256.cu's encode of the same cells;
    the file reads bit-equal with the DataNodes of data units 0-2 down;
    two come back, the NameNode schedules the unit still missing onto the
    free DataNode, the port's EC worker rebuilds it, and the rebuilt
    unit equals ec_gf256.cu's decode of the same stripes."""
    from hadoop_tpu_torch.io.erasurecode import get_policy
    D = DFS_DAEMONS
    policy = get_policy(D["ec_policy"])
    k, m, cell, unit = policy.k, policy.m, policy.cell_size, D["ec_unit"]
    require(k == D["ec_units"], f"{D['ec_policy']} has {k} data units")
    data = torch.randint(0, 256, (k * unit,), dtype=torch.uint8,
                         generator=torch.Generator().manual_seed(SEED + 61)
                         ).numpy()
    cells = [np.ascontiguousarray(u).tobytes() for u in
             data.reshape(-1, k, cell).transpose(1, 0, 2)]
    data = data.tobytes()
    fs.mkdirs("/ec")
    fs.client.set_ec_policy("/ec", D["ec_policy"])
    t0 = time.monotonic()
    fs.write_all("/ec/f.bin", data)
    write_s = time.monotonic() - t0
    gid = fs.client.get_block_locations("/ec/f.bin")["blocks"][0]["b"]["id"]
    info = cluster.namenode.fsn.bm.get(gid)
    _until(lambda: len(info.live_units()) == k + m, D["timeout_s"],
           what="the group's units reported")
    by_idx = {idx: uuid for uuid, idx in info.unit_map.items()}
    raw = [_unit_bytes(cluster, by_idx[i], gid + i) for i in range(k + m)]
    require(raw[:k] == cells, "a data unit on its DataNode is not the "
            "file's cells")
    t0 = time.monotonic()
    parity = ec_device.encode_cells(k, m, cells)
    encode_s = time.monotonic() - t0
    require(parity == raw[k:], "the parity units on the DataNodes differ "
            "from ec_gf256.cu's encode of the same cells")
    down = [_dn_index(cluster, by_idx[i]) for i in range(3)]
    free = [i for i, dn in enumerate(cluster.datanodes)
            if dn is not None and dn.uuid not in info.unit_map]
    require(len(free) == 1, f"free DataNodes {free}")
    for i in down:
        cluster.kill_datanode(i)
    reader = cluster.get_filesystem()
    t0 = time.monotonic()
    require(reader.read_all("/ec/f.bin") == data,
            "the striped file read with units 0-2 down differs")
    degraded_s = time.monotonic() - t0
    for i in down[:2]:
        cluster.restart_datanode(i)
    _until(lambda: {0, 1} <= info.live_units(), D["timeout_s"],
           what="units 0 and 1 reported again")
    free_uuid = cluster.datanodes[free[0]].uuid
    rebuild_s = _until(
        lambda: info.unit_map.get(free_uuid) == 2 and
        2 in info.live_units(), D["timeout_s"],
        pump=cluster.namenode.redundancy_pass,
        what="unit 2 rebuilt on the free DataNode")
    rebuilt = _unit_bytes(cluster, free_uuid, gid + 2)
    decoded = ec_device.decode_cells(k, m, [None] * 3 + raw[3:])
    require(decoded == cells and rebuilt == decoded[2],
            "the rebuilt unit differs from ec_gf256.cu's decode")
    cluster.restart_datanode(down[2])
    cluster.wait_active()
    mb = len(data) / 1e6
    return {"ec_policy": D["ec_policy"], "ec_bytes": len(data),
            "ec_write_s": write_s, "ec_write_mb_per_s": mb / write_s,
            "ec_encode_cells_s": encode_s, "ec_degraded_read_s": degraded_s,
            "ec_degraded_read_mb_per_s": mb / degraded_s,
            "ec_reconstruct_s": rebuild_s}


def _dfs_kv_gate(fs, params, cfg):
    """Gate 5: an engine keeps its KV pages on the port's DFS at min-refs
    1 and persists them; a second engine with no host ring replays
    KVTIERS["replay"] prompts from the DFS tier, with the first's
    tokens."""
    K = KVTIERS
    tiers = dict(kv_store_fs=fs, kv_store_dir="/kvcache", kv_dfs_min_refs=1)
    prompts = _kv_prompts(cfg.vocab_size)[:K["replay"]]
    greedy = SamplingParams(max_new_tokens=K["max_new"])
    eng = DecodeEngine(params, cfg, **tiers, **SERVE_KW)
    first = eng.generate(prompts, greedy)
    persisted = eng.persist_cache(timeout=DFS_DAEMONS["timeout_s"])
    require(eng.kvstore.flush(DFS_DAEMONS["timeout_s"]),
            "the DFS writer did not drain")
    persists = eng.kvstore.stats()["dfs_persists"]
    eng.stop()
    del eng
    eng = DecodeEngine(params, cfg, **tiers, **SERVE_KW)
    got = eng.generate(prompts, greedy)
    hits = eng.kvstore.stats()["hits_dfs"]
    eng.stop()
    del eng
    require(persists > 0 and hits > 0 and got == first,
            f"DFS KV tier: {persists} persisted, {hits} hits, tokens equal "
            f"{got == first}")
    return {"kv_persist_enqueued": persisted, "kv_dfs_persists": persists,
            "kv_hits_dfs": hits}


def phase_dfs_ha(smi, dfs):
    """The port's HA DFS on the host under the card's work (DFS_HA):
    flagship-1b (DFS_DAEMONS' depth) trained on the HA nameservice, its
    interval save carried through the active NameNode's death, resumed
    with a JournalNode down; the dead NameNode rejoins as standby and
    checkpoints; the checkpoint served through observer reads. ``dfs``:
    the dfs_daemons phase's record (its file:// losses, its save time).
    Returns the phase's launches by kernel."""
    D, H = DFS_DAEMONS, DFS_HA
    cfg = get_config("flagship-1b", n_layers=D["layers"])
    batch, seq = TRAIN["batch"], TRAIN["seq"]
    leaves = tree_leaves(init_params(cfg, torch.Generator(), device="meta"))
    n_params = sum(p.numel() for p in leaves)
    elt = torch.finfo(cfg.torch_dtype).bits // 8
    ckpt_bytes = n_params * (elt + 4 + 4) + 4 + 8
    tmp = tempfile.mkdtemp(prefix="htpu-dfsha-")
    # three replicas of two checkpoints, one more while the second lands
    need = 9 * ckpt_bytes
    free_disk = shutil.disk_usage(tmp).free
    require(free_disk > need, f"{free_disk} B free under {tmp}: the phase "
            f"needs {need} B")
    conf = fast_conf()
    conf.set("dfs.blocksize", str(H["block_bytes"]))
    conf.set("dfs.namenode.reconstruction.pending.timeout", "30s")
    n_tokens = int(TRAINER["file_batches"] * batch * (seq + 1))
    tokens = torch.randint(0, cfg.vocab_size, (n_tokens,),
                           generator=torch.Generator().manual_seed(SEED + 60))
    token_bytes = tokens.numpy().astype(np.uint16).tobytes()
    rec = {"phase": "dfs_ha", "model": "flagship-1b",
           "layers": cfg.n_layers, "reduced": f"depth {cfg.n_layers} of "
           f"{get_config('flagship-1b').n_layers} layers",
           "journalnodes": H["journalnodes"], "namenodes": 2, "observers": 1,
           "datanodes": H["datanodes"], "params": n_params,
           "checkpoint_bytes_reckoned": ckpt_bytes,
           "dfs_daemons_save_s": dfs["save_s"],
           "dfs_daemons_restore_s": dfs["restore_s"]}
    zero_counts()
    try:
        with MiniQJMHACluster(num_journalnodes=H["journalnodes"],
                              num_namenodes=2, num_observers=1,
                              num_datanodes=H["datanodes"], conf=conf,
                              base_dir=f"{tmp}/ha") as cluster:
            t0 = time.monotonic()
            cluster.wait_active(H["timeout_s"])
            rec["first_active_s"] = time.monotonic() - t0
            fs = cluster.get_filesystem()
            hroot, gate_s = "/flagship", {}
            t0 = time.monotonic()
            host, train = _ha_failover_gate(cluster, cfg, fs, hroot,
                                            token_bytes, len(leaves),
                                            dfs["losses_file"])
            rec.update(train)
            gate_s["failover"], t0 = time.monotonic() - t0, time.monotonic()
            rec.update(_ha_rejoin_gate(cluster, fs, hroot,
                                       train["killed_namenode"]))
            gate_s["rejoin"], t0 = time.monotonic() - t0, time.monotonic()
            rec.update(_ha_observer_gate(cluster, hroot, cfg, host))
            gate_s["observer"] = time.monotonic() - t0
            rec["gate_s"] = gate_s
            del host
            launches = dict(zip(("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                                 "adamw", "grad_sq", "rms_norm_fwd",
                                 "rms_norm_bwd"), train_counts()))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rec["launches"] = launches
    rec["device"] = smi
    rec["note"] = ("host numbers with the card in the loop: one process "
                   "holds the JournalNodes, the NameNodes, the DataNodes, "
                   "the client and the model; the stopped NameNode stops "
                   "as MiniQJMHACluster.kill_active stops it (its lease "
                   "released), with its answer to the save's first "
                   "add_block in flight; no DFS benchmark")
    emit({"dfs_ha": rec})
    free_device()
    return launches


def _ha_kill_mid_save(cluster, step_dir, stop, seen):
    """The kill of gate 1: the active NameNode's answer to the save's
    first ``add_block`` (the first shard file has appeared: its create
    was answered) is held until the NameNode has stopped, so the stop
    meets that call in flight and its answer is lost with the
    connection; the port's client retries it on the new active (ROADMAP
    C 26). Records whether the manifest was there, stops the active and
    times the stop until a new active answers an RPC. Returns the
    thread that waits for the held call."""
    nn = cluster.namenodes[cluster.active_index()]
    fsn, held = nn.fsn, threading.Event()
    real, stopped = fsn.add_block, threading.Event()

    def add_block(path, *args, **kwargs):
        out = real(path, *args, **kwargs)
        if path.startswith(step_dir + "/") and not held.is_set():
            seen["shard"] = path.rsplit("/", 1)[1]
            seen["block_id"] = out.block.block_id
            with fsn.lock.read():
                seen["manifest_at_kill"] = fsn.fsdir.exists(
                    f"{step_dir}/manifest.json")
            seen["save_t"] = time.monotonic()
            held.set()
            stopped.wait(DFS_HA["timeout_s"])
        return out

    def kill():
        while not held.wait(0.01):
            if stop.is_set():
                return
        seen["kill_t"] = time.monotonic()
        try:
            seen["killed"] = cluster.kill_active()
        finally:
            stopped.set()
        client = Client(cluster.conf)
        try:
            while time.monotonic() - seen["kill_t"] < DFS_HA["timeout_s"]:
                new = cluster.active_index()
                if new is not None:
                    proxy = get_proxy(
                        "ClientProtocol",
                        ("127.0.0.1", cluster.namenodes[new].port),
                        client=client)
                    try:
                        proxy.get_file_info("/")
                    except OSError:
                        pass
                    else:
                        seen["failover_s"] = time.monotonic() - \
                            seen["kill_t"]
                        seen["new_active"] = new
                        return
                time.sleep(0.01)
        finally:
            client.stop()

    fsn.add_block = add_block
    return threading.Thread(target=kill, name="dfs-ha-kill")


def _ha_failover_gate(cluster, cfg, fs, hroot, token_bytes, n_leaves,
                      want_losses):
    """Gate 1: Trainer on the nameservice to the interval save at
    ``save_at``, the active NameNode stopped mid-save, the save complete
    through the client's failover; a second Trainer started with
    JournalNode 0 down restores it (bit-equal to the first trainer's
    parameters) and trains to ``steps``: losses equal to ``want_losses``
    (dfs_daemons' file:// run), each step's launches as the train
    phase's at this depth. Returns the first trainer's parameters at
    ``save_at`` (host copies) and the record."""
    D = DFS_DAEMONS
    batch, steps, save_at = TRAIN["batch"], D["steps"], D["save_at"]
    fs.write_all(f"{hroot}/tokens.bin", token_bytes)

    def trainer(**kw):
        return Trainer(cfg, MeshPlan(), fs, f"{hroot}/tokens.bin",
                       f"{hroot}/trainer", batch=batch, lr=TRAIN["lr"],
                       remat=TRAIN["remat"], seed=SEED, **kw)

    seen, stop = {}, threading.Event()
    step_dir = f"{hroot}/trainer/step_{save_at:012d}"
    watcher = _ha_kill_mid_save(cluster, step_dir, stop, seen)
    per_step = []
    a = trainer(ckpt_interval=save_at, keep=1)
    _counted_steps(a, per_step)
    watcher.start()
    try:
        crashed = a.train(save_at)      # the interval save fenced at exit
        saved_t = time.monotonic()
    finally:
        stop.set()
        watcher.join()
    host = tree_map(lambda t: t.cpu(), a.params)
    a.close()
    del a
    require("killed" in seen, "the active NameNode was not stopped during "
            "the interval save")
    require(not seen["manifest_at_kill"], "the save's manifest was written "
            "before the active NameNode was stopped")
    require("failover_s" in seen, f"no new active NameNode within "
            f"{DFS_HA['timeout_s']} s")
    survivor = cluster.namenodes[seen["new_active"]].fsn
    with survivor.lock.read():
        first = survivor.fsdir.get_inode(f"{step_dir}/{seen['shard']}")
        first_ids = [b.block_id for b in first.blocks[:1]]
    require(first_ids == [seen["block_id"]], f"the new active's "
            f"{seen['shard']} starts with blocks {first_ids}, not the "
            f"block {seen['block_id']} whose allocation the stop met")
    require(list_checkpoints(fs, f"{hroot}/trainer") == [save_at],
            "the interval save is not durable on the nameservice at "
            "train()'s exit")
    jn0 = cluster.journalnodes[0]
    jn0_port, jn0_dir = jn0.port, jn0.storage_dir
    jn0.stop()
    b = trainer(ckpt_interval=0, keep=1)
    _counted_steps(b, per_step)
    restore_s = _timed(b.try_restore)
    require(b.step == save_at, f"restore with a JournalNode down at step "
            f"{b.step}")
    unequal = [i for i, (x, y) in enumerate(zip(tree_leaves(b.params),
                                                tree_leaves(host)))
               if not torch.equal(x.cpu(), y)]
    require(not unequal, f"leaves {unequal} restored from the save the "
            f"failover landed in differ from the trainer's")
    resumed = b.train(steps - save_at)
    b.close()
    del b
    jconf = Configuration(other=cluster.conf)
    jconf.set("dfs.journalnode.rpc-port", jn0_port)
    jn0 = JournalNode(jconf, storage_dir=jn0_dir)
    jn0.init(jconf)
    jn0.start()
    cluster.journalnodes[0] = jn0
    got = crashed + resumed
    rel = [abs(g - w) / abs(w) for g, w in zip(got, want_losses)]
    want = train_counts_want(cfg, n_leaves)
    require(all(math.isfinite(x) for x in got), "non-finite loss")
    require(len(got) == len(want_losses) and
            max(rel) <= TRAINER["loss_rtol"],
            f"losses across the failover {got} against file:// "
            f"{want_losses}")
    require(all(c == want for c, _, _ in per_step) and
            len(per_step) == steps,
            f"launches per step (fwd, dq, dkv, adamw, grad_sq, rms_norm fwd, "
            f"rms_norm bwd), expected {want}: "
            f"{[c for c, _, _ in per_step]}")
    ckpt = _tree_bytes(fs, f"{hroot}/trainer/step_{save_at:012d}")
    mb = ckpt / 1e6
    return host, {"losses_ha": got, "losses_file": want_losses,
                  "loss_rel_err": rel, "checkpoint_bytes": ckpt,
                  "killed_namenode": seen["killed"],
                  "killed_during": f"add_block of {seen['shard']}",
                  "new_active": seen["new_active"],
                  "failover_s": seen["failover_s"],
                  "save_with_failover_s": saved_t - seen["save_t"],
                  "save_with_failover_mb_per_s": mb / (saved_t -
                                                       seen["save_t"]),
                  "kill_to_saved_s": saved_t - seen["kill_t"],
                  "restore_one_jn_down_s": restore_s,
                  "restore_mb_per_s": mb / restore_s,
                  "launches_per_step": want}


def _ha_tree(fs, path):
    """{path: (type, length)} of ``path`` and everything under it, as
    the port's oiv names them (a directory's length None)."""
    st = fs.get_file_status(path)
    out = {path: ("DIRECTORY", None) if st.is_dir else ("FILE", st.length)}
    if st.is_dir:
        for child in fs.list_status(path):
            out.update(_ha_tree(fs, child.path))
    return out


def _ha_rejoin_gate(cluster, fs, hroot, killed):
    """Gate 2: the stopped NameNode restarts as standby and tails to the
    active's txid; its StandbyCheckpointer writes an image whose oiv dump
    lists ``hroot`` as the active does; dfsadmin -getServiceState reads
    one active and one standby."""
    active = cluster.namenodes[cluster.active_index()]
    target = active.fsn.editlog.last_txid
    t0 = time.monotonic()
    cluster.restart_namenode(killed)
    nn = cluster.namenodes[killed]
    restart_s = time.monotonic() - t0
    require(nn.ha_state == "standby", f"the restarted NameNode is "
            f"{nn.ha_state}")
    # from the restart's start: the load replays the quorum's committed
    # edits, the tailer the rest
    catch_up_s = restart_s + _until(lambda: nn.applied_txid() >= target,
                                    DFS_HA["timeout_s"],
                                    what="the restarted NameNode's tailing")
    require(nn.applied_txid() == target and nn.ha_state == "standby",
            f"the rejoined NameNode at txid {nn.applied_txid()} of "
            f"{target}, {nn.ha_state}")
    t0 = time.monotonic()
    image = nn.checkpointer.do_checkpoint()
    checkpoint_s = time.monotonic() - t0
    require(os.path.basename(image) == f"fsimage_{target:019d}",
            f"the standby's image {image} is not at txid {target}")
    out = io.StringIO()
    oiv.dump_image(nn.name_dir, out=out)
    lines = [json.loads(line) for line in out.getvalue().splitlines()]
    require(lines[0].get("image_txid") == target,
            f"oiv read the image at {lines[0]}")
    dumped = {d["path"]: (d["type"], d.get("length")) for d in lines[1:]
              if d["path"] == hroot or d["path"].startswith(hroot + "/")}
    walked = _ha_tree(fs, hroot)
    require(dumped == walked, f"oiv lists {len(dumped)} paths under "
            f"{hroot}, the active {len(walked)}; differing: "
            f"{sorted(set(dumped.items()) ^ set(walked.items()))[:4]}")
    states = []
    for i in range(2):
        buf = io.StringIO()
        admin = DFSAdmin(Configuration(other=cluster.conf), out=buf)
        try:
            rc = admin.run(["-getServiceState",
                            f"127.0.0.1:{cluster.namenodes[i].port}"])
        finally:
            admin.close()
        require(rc == 0, f"dfsadmin -getServiceState exited {rc}")
        states.append(buf.getvalue().strip())
    require(sorted(states) == ["active", "standby"],
            f"dfsadmin reads {states}")
    return {"namenode_restart_s": restart_s, "catch_up_s": catch_up_s,
            "caught_up_txid": target, "standby_checkpoint_s": checkpoint_s,
            "image_paths": len(dumped), "service_states": states}


def _ha_observer_gate(cluster, hroot, cfg, host):
    """Gate 3: load_serving_params through a client with observer reads
    on loads the checkpoint the failover landed in: the observer serves
    every block lookup of the load and the active none; the leaves are
    bit-equal to ``host`` (the trainer's), one prompt's greedy tokens
    from a DecodeEngine on them equal an engine's on ``host``."""
    D = DFS_DAEMONS
    observer = cluster.namenodes[2]
    active = cluster.namenodes[cluster.active_index()]
    require(observer.ha_state == "observer",
            f"NameNode 2 is {observer.ha_state}")
    ofs = cluster.get_filesystem(observer_reads=True)
    # each NameNode's block lookups during the load (the client falls
    # back to the active on any observer failure)
    lookups = {"observer": [], "active": []}
    for role, nn in (("observer", observer), ("active", active)):
        def counted(path, *args, _real=nn.fsn.get_block_locations,
                    _seen=lookups[role], **kwargs):
            _seen.append(path)
            return _real(path, *args, **kwargs)
        nn.fsn.get_block_locations = counted
    torch.cuda.synchronize()
    t0 = time.monotonic()
    try:
        params, step = load_serving_params(
            ofs, f"{hroot}/trainer", cfg, io_workers=TRAINER["io_workers"])
        torch.cuda.synchronize()
    finally:
        for nn in (observer, active):
            del nn.fsn.get_block_locations
    load_s = time.monotonic() - t0
    require(step == D["save_at"], f"loaded step {step}")
    # the load reads the manifest and one shard file a parameter leaf
    # (the optimizer's files stay unread)
    step_dir = f"{hroot}/trainer/step_{step:012d}"
    files = {st.path for st in ofs.list_status(step_dir) if not st.is_dir}
    read = files & set(lookups["observer"])
    want = len(tree_leaves(host)) + 1
    require(not lookups["active"] and len(read) >= want,
            f"block lookups of the load: {len(lookups['observer'])} on the "
            f"observer ({len(read)} of the checkpoint's files, the load "
            f"reads {want}), {len(lookups['active'])} on the active")
    unequal = [i for i, (x, y) in enumerate(zip(tree_leaves(params),
                                                tree_leaves(host)))
               if x.dtype != y.dtype or not torch.equal(x.cpu(), y)]
    require(not unequal, f"leaves {unequal} loaded through the observer "
            f"differ from the trainer's")
    prompts = _prompts(cfg.vocab_size)[0][1:2]
    greedy = SamplingParams(max_new_tokens=D["max_new"])
    tokens = []
    dev = tree_leaves(params)[0].device
    for tree in (params, tree_map(lambda t: t.to(dev), host)):
        eng = DecodeEngine(tree, cfg, **SERVE_KW)
        tokens.append(eng.generate(prompts, greedy))
        eng.stop()
        del eng
    del params
    require(tokens[0] == tokens[1], "greedy tokens of the checkpoint read "
            "through the observer differ from the trainer's parameters'")
    return {"observer_load_s": load_s, "tokens_observer": tokens[0],
            "observer_block_lookups": len(lookups["observer"]),
            "active_block_lookups": len(lookups["active"]),
            "checkpoint_files_looked_up": len(read),
            "checkpoint_files": len(files)}


# -------------------------------------------------------------------- MoE

def build_int8_model(cfg, group, seed):
    """``cfg``'s int8 weight plane built on the card one layer slice at a
    time, with no float copy of the model: each matmul leaf's slice drawn
    with init_params' fan-in scaling from a seeded CUDA generator, cast to
    the model's dtype, quantized by ``weightplane.quantize_weight`` and
    written into preallocated int8 and f32 stacks; the other leaves
    (embed, head, router, norms) drawn whole in the model's dtype."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = cfg.torch_dtype
    shapes = init_params(cfg, torch.Generator(), device="meta")

    def draw(shape, fan_in):
        w = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device="cuda")
        return (w * fan_in ** -0.5).to(dt)

    def leaf(name, meta):
        """A norm weight (ones) or a [.., fan_in, N] matrix."""
        if name.endswith("norm_w"):
            return torch.ones(meta.shape, dtype=dt, device="cuda")
        return draw(meta.shape, meta.shape[-2])

    layers = {}
    for name, meta in shapes["layers"].items():
        if name not in weightplane.LAYER_MATMULS:
            layers[name] = leaf(name, meta)
            continue
        L, *lead, din, dout = meta.shape
        q = torch.empty((L, *lead, dout, din // group, group),
                        dtype=torch.int8, device="cuda")
        s = torch.empty((L, *lead, dout, din // group), dtype=torch.float32,
                        device="cuda")
        for i in range(L):
            qw = weightplane.quantize_weight(draw(meta.shape[1:], din), group,
                                             transpose=True)
            q[i].copy_(qw["q"])
            s[i].copy_(qw["s"])
            del qw
        layers[name] = {"q": q, "s": s}
    params = {"layers": layers}
    for name, meta in shapes.items():
        if name == "embed":
            params[name] = draw(meta.shape, meta.shape[-1])
        elif name != "layers":
            params[name] = leaf(name, meta)
    torch.cuda.synchronize()
    return params


def _moe_prompts(vocab):
    gen = torch.Generator().manual_seed(SEED + 31)
    lengths = MOE["prompt_lengths"] * MOE["requests"]
    return [torch.randint(0, vocab, (n,), generator=gen).tolist()
            for n in lengths[:MOE["requests"]]]


def _moe_engine(params, cfg, factor, **kw):
    return DecodeEngine(params, cfg, hbm_bytes=MOE["hbm_bytes"],
                        max_lanes=MOE["max_lanes"], block_size=MOE["block"],
                        max_context=MOE["max_context"],
                        prefill_chunk=MOE["chunk"],
                        moe_capacity_factor=factor, **kw)


@torch.no_grad()
def _moe_reference_rows(qparams, cfg, seqs, firsts):
    """The layer-streamed plain forward over the dequantized plane, in
    float32 and in the model's dtype, teacher-forced over each sequence of
    ``seqs``: per layer, that layer's leaves dequantized (``dequantize_
    weight``), each sequence's hidden state through ``layer_forward``
    (plain attention, ``moe_mlp`` routing the sequence's tokens at the
    config's capacity factor), the layer freed. Returns, per sequence,
    the float32 logits rows from position ``firsts[i]`` on, in both
    dtypes."""
    dtypes = (torch.float32, cfg.torch_dtype)
    cfgs = [get_config(MOE["model"], dtype="float32",
                       capacity_factor=MOE["no_drop"]),
            get_config(MOE["model"], capacity_factor=MOE["no_drop"])]
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq, cfg.rope_theta,
                                device="cuda")
    hs = [[qparams["embed"][torch.tensor(s, device="cuda")][None].to(dt)
           for s in seqs] for dt in dtypes]
    for lp in layer_slices(qparams["layers"], cfg.n_layers):
        f32 = {k: weightplane.dequantize_weight(v, transpose=True)
               if weightplane.is_qtensor(v) else v.float()
               for k, v in lp.items()}
        for d, (dt, c) in enumerate(zip(dtypes, cfgs)):
            w = {k: v.to(dt) for k, v in f32.items()}
            hs[d] = [layer_forward(h, w, c, cos, sin, attn_impl="ref")
                     for h in hs[d]]
            del w
        del f32
    out = []
    for d, (dt, c) in enumerate(zip(dtypes, cfgs)):
        top = {k: v.to(dt) for k, v in qparams.items() if k != "layers"}
        out.append([(final_hidden(top, h[0, f:], c)
                     @ head_matrix(top, c)).float()
                    for h, f in zip(hs[d], firsts)])
    return out


def _dequant_share(eng):
    """One eager decode-only step under torch.profiler: the device ms of
    the weight plane's dequantize (dequant.cu's kernel, by name), the
    step's, and the share."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._step_eager(False)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    deq = [e for e in kernels if "dequant_kernel" in e.key]
    deq_ms = sum(e.self_device_time_total for e in deq) / 1e3
    step_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return {"dequantize_device_ms": deq_ms, "step_device_ms": step_ms,
            "dequantize_kernels": sum(e.count for e in deq),
            "share": deq_ms / step_ms if step_ms else None}


def phase_moe():
    """mixtral-8x7b served at full width and depth from an int8 plane on
    this card (see MOE): the plane's measured bytes against the reckoning,
    the engine's sizing, 16 greedy requests through the captured steps at
    the no-drop capacity factor and at the preset's, graph against eager,
    the tokens against the layer-streamed reference, the dequantize's
    share of a decode step."""
    cfg = get_config(MOE["model"])
    free_device()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    qparams = build_int8_model(cfg, WEIGHTS_INT8.group, SEED + 30)
    build_s = time.monotonic() - t0
    build_peak = torch.cuda.max_memory_allocated()
    want_bytes = _reckon_weight_bytes(cfg, WEIGHTS_INT8.group)
    prompts = _moe_prompts(cfg.vocab_size)
    greedy = [SamplingParams(max_new_tokens=MOE["max_new"])] * len(prompts)
    runs = {}
    for factor in (MOE["no_drop"], cfg.capacity_factor):
        torch.cuda.reset_peak_memory_stats()
        eng = _moe_engine(qparams, cfg, factor)
        plane = eng.weight_plane()
        tokens, rec = _timed_run(eng, prompts, greedy)
        rec.update(plane=plane, num_blocks=eng.pool.num_blocks,
                   peak_memory_bytes=torch.cuda.max_memory_allocated(),
                   hbm_ledger=hbm_ledger().report()["components"])
        eng.stop()
        del eng
        free_device()
        runs[factor] = (tokens, rec)
        emit({"phase": "moe", "part": "serve", "model": MOE["model"],
              "capacity_factor": factor, "build_seconds": build_s,
              "build_peak_bytes": build_peak,
              "weight_bytes_reckoned": want_bytes, **rec})
        require(plane["weight_bytes"] == want_bytes,
                f"mixtral int8 weight bytes {plane['weight_bytes']}, "
                f"reckoned {want_bytes}")
        require(rec["graphs_captured"] == 2 and rec["decode_shapes"] == 1
                and rec["fused_shapes"] == 1,
                f"factor {factor}: more than one capture per step shape")
        require(all(len(t) == MOE["max_new"] for t in tokens)
                and all(0 <= x < cfg.vocab_size for t in tokens for x in t),
                f"factor {factor}: bad tokens")

    # graph against eager on one request (no prefix cache: the second run
    # prefills as the first did), as the engine serves; then one eager
    # decode step profiled
    eng = _moe_engine(qparams, cfg, MOE["no_drop"], prefix_cache=False)
    one = [prompts[0]], [SamplingParams(max_new_tokens=MOE["eager_new"])]
    finite = []
    real_sample = engine_module._sample

    def sample(logits, temps, topks, generator):
        finite.append(bool(torch.isfinite(logits).all()))
        return real_sample(logits, temps, topks, generator)

    graph_tokens = _timed_run(eng, *one)[0]
    eng._launch_step = eng._step_eager
    engine_module._sample = sample
    try:
        eager_tokens = _timed_run(eng, *one, warm=False)[0]
    finally:
        engine_module._sample = real_sample
    req = eng.submit(prompts[1], SamplingParams(max_new_tokens=8))
    while req._prefill_pos is not None or not eng._active.any():
        eng.step()
    share = _dequant_share(eng)
    eng.stop()
    del eng
    free_device()

    # the tokens of the no-drop run against the layer-streamed reference
    tokens = runs[MOE["no_drop"]][0]
    seqs = [p + t[:-1] for p, t in zip(prompts, tokens)]
    ref32, ref16 = _moe_reference_rows(qparams, cfg, seqs,
                                       [len(p) - 1 for p in prompts])
    cal = max(float((a - b).abs().max()) for a, b in zip(ref32, ref16))
    gaps, argmax_equal = [], 0
    for rows, t in zip(ref32, tokens):
        idx = torch.tensor(t, device=rows.device)
        gap = rows.max(-1).values - rows[torch.arange(len(t)), idx]
        gaps.append(float(gap.max()))
        argmax_equal += int((rows.argmax(-1) == idx).sum())
    emit({"phase": "moe", "part": "check", "graph_equal_eager":
          graph_tokens == eager_tokens, "graph_tokens": graph_tokens,
          "eager_tokens": eager_tokens,
          "eager_logits_finite": all(finite),
          "eager_samples": len(finite), "dequantize": share,
          "reference_argmax_equal": argmax_equal,
          "tokens_compared": sum(len(t) for t in tokens),
          "gap_max": max(gaps), "calibration": cal,
          "cal_factor": MOE["cal_factor"],
          "reference_finite": all(bool(torch.isfinite(r).all())
                                  for r in ref32 + ref16)})
    require(graph_tokens == eager_tokens,
            f"graph tokens {graph_tokens} differ from eager {eager_tokens}")
    require(finite and all(finite), "non-finite engine logits")
    require(max(gaps) <= MOE["cal_factor"] * cal,
            f"emitted tokens lie up to {max(gaps)} below the reference's "
            f"maximum, past {MOE['cal_factor']} x the bf16 calibration "
            f"{cal}")
    del qparams, ref32, ref16
    free_device()


# ------------------------------------------------------- MoE training

def _flash_case(b, s, hq, hkv, d, dtype):
    """The flash forward, dQ and dK/dV kernels at one shape against their
    plain versions, as the kernel and backward phases hold them. Returns
    the records {"fwd", "bwd"}."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 41)
    q, do = (torch.randn(b, s, hq, d, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, s, hkv, d, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    out = {"fwd": fwd_record(q, k, v), "bwd": bwd_record(q, k, v, do)[0]}
    del q, k, v, do
    free_device()
    require(fwd_ok(out["fwd"]) and bwd_ok(out["bwd"]),
            f"flash kernels disagree with their plain versions at "
            f"{[b, s, hq, hkv, d]} {dtype}: {out}")
    return out


def _moe_step_flops(cfg, t):
    """(all, f32 combine) model FLOPs of one full-remat training step on
    ``t`` tokens: each layer's forward runs twice and its backward costs
    two forwards; the head's forward once and its backward two. A layer's
    forward: the q/k/v/o projections, causal attention over the
    t(t+1)/2 visible pairs, the router, the dispatch and combine einsums
    over the E·C capacity slots, and the experts' three GEMMs on them.
    The combine (float32) is 2·t·E·C·D of it."""
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff
    C = moe_capacity(t, cfg)
    dkv = cfg.n_kv_heads * cfg.head_dim
    attn = 2 * t * D * (2 * D + 2 * dkv) + \
        4 * cfg.n_heads * cfg.head_dim * t * (t + 1) / 2
    combine = 2 * t * E * C * D
    layer = attn + 2 * t * D * E + 2 * combine + 3 * 2 * E * C * D * F
    return (cfg.n_layers * 4 * layer + 3 * 2 * t * D * cfg.vocab_size,
            cfg.n_layers * 4 * combine)


def _reckon_moe_peak(cfg, t):
    """Device bytes the step should peak at, reckoned before the run: the
    parameters, two float32 moments and the gradients; the expert stacks'
    gradients once more (each layer's slices are stacked into the leaf's
    gradient while they are alive); and one layer's routing tensors in
    the recompute (the int64 slot one-hot [t, K, E, C + 1], three float32
    [t, K, E, C] products and the float32 [t, E, C] dispatch and
    combine)."""
    shapes = init_params(cfg, torch.Generator(), device="meta")
    n = sum(p.numel() for p in tree_leaves(shapes))
    elt = torch.finfo(cfg.torch_dtype).bits // 8
    experts = sum(shapes["layers"][k].numel()
                  for k in ("w_gate", "w_up", "w_down"))
    K, E, C = cfg.top_k, cfg.n_experts, moe_capacity(t, cfg)
    route = t * K * E * (C + 1) * 8 + 3 * t * K * E * C * 4 + \
        2 * t * E * C * 4
    return {"state": n * (2 * elt + 8), "expert_grads_stacked":
            experts * elt, "routing_one_layer": route,
            "total": n * (2 * elt + 8) + experts * elt + route}


def phase_moe_train():
    """mixtral-8x7b (MOE_TRAIN) through ``make_train_step``: the flash
    kernels at its shape, then 6 steps on one seeded batch (finite losses,
    the last below the first, each step's launches pinned), step ms from
    CUDA events, tokens/s and peak memory beside the reckoning, and one
    profiled step. Returns the launches of the 6 steps (train_counts)."""
    free_device()
    cfg = moe_train_config()
    b, t = MOE_TRAIN["batch"], MOE_TRAIN["seq"]
    kernels = _flash_case(b, t, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                          cfg.torch_dtype)
    reckoned = _reckon_moe_peak(cfg, b * t)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    params, opt = init_train_state(cfg, gen)
    n_params = sum(p.numel() for p in tree_leaves(params))
    tokens = torch.randint(0, cfg.vocab_size, (b, t), device="cuda",
                           generator=gen)
    targets = torch.roll(tokens, -1, dims=1)
    step = make_train_step(cfg, MeshPlan(), lr=MOE_TRAIN["lr"],
                           remat="full")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    losses, step_ms, per_step = [], [], []
    zero_counts()                             # the main path's run
    for _ in range(MOE_TRAIN["steps"]):
        before = train_counts()
        start.record()
        params, opt, metrics = step(params, opt, tokens, targets)
        end.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(metrics["loss"].item())
        per_step.append([a - b for a, b in zip(train_counts(), before)])
    launches = train_counts()
    peak = torch.cuda.max_memory_allocated()
    timed_ms = sum(step_ms[1:]) / (len(step_ms) - 1)
    flops, combine_flops = _moe_step_flops(cfg, b * t)
    prof = train_profile(cfg, params, opt, tokens, MOE_TRAIN["profiled"],
                         "train step mixtral-8x7b 2 layers bf16 [1,4096] "
                         "remat full adamw", TRAIN_RANGES + MOE_RANGES)
    ranges = prof["ranges"]
    want = train_counts_want(cfg, len(tree_leaves(params)))
    emit({"phase": "moe_train", "model": "mixtral-8x7b", "dtype": cfg.dtype,
          "reduced": {"n_layers": [cfg.n_layers, 32],
                      "context": [t, 32768]},
          "tokens": [b, t], "remat": "full", "optimizer": "adamw",
          "lr": MOE_TRAIN["lr"], "params": n_params,
          "capacity": moe_capacity(b * t, cfg),
          "capacity_factor": cfg.capacity_factor,
          "flash": {"shape": [b, t, cfg.n_heads, cfg.n_kv_heads,
                              cfg.head_dim], **kernels},
          "losses": losses, "grad_norm": metrics["grad_norm"].item(),
          "step_ms": step_ms, "timed_step_ms": timed_ms,
          "tokens_per_s": b * t / (timed_ms / 1e3),
          "model_flops_per_step": flops,
          "f32_combine_flops_per_step": combine_flops,
          "tflops": flops / (timed_ms * 1e-3) / 1e12,
          "peak_memory_bytes": peak, "peak_reckoned_bytes": reckoned,
          "profiled_device_ms": prof["device_ms"],
          "profiled_idle_share": prof["idle_share"],
          "range_kernel_ms": {k: ranges[k].get("kernel_ms")
                              for k in TRAIN_RANGES + MOE_RANGES},
          "route_share": ranges["moe.route"]["kernel_ms"]
          / prof["device_ms"],
          "launches_per_step_fwd_dq_dkv_adamw_grad_sq_normf_normb":
              per_step, "launches_per_step_expected": want})
    require(all(math.isfinite(x) for x in losses), f"losses {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    require(all(c == want for c in per_step),
            f"launches per step (fwd, dq, dkv, adamw, grad_sq, rms_norm "
            f"fwd, rms_norm bwd) {per_step}, expected {want}")
    del params, opt, step, metrics
    free_device()
    return launches


def _pinned_bytes(nbytes):
    """Page-locked bytes the caching host allocator hands out for blocks
    of these sizes: each rounded up to a power of two."""
    return sum(1 << (n - 1).bit_length() for n in nbytes)


class MemoryFileSystem:
    """A filesystem in this process's memory, with the nine methods of
    ``hadoop_tpu_torch.fs.FileSystemLike``: where the moe_trainer phase
    keeps its token file and checkpoint (see MOE_TRAIN)."""

    def __init__(self):
        self.files = {}
        self.dirs = {""}

    def mkdirs(self, path):
        parts = path.rstrip("/").split("/")
        self.dirs.update("/".join(parts[:i]) for i in range(len(parts) + 1))
        return True

    def write_all(self, path, data, overwrite=True):
        self.mkdirs(path.rsplit("/", 1)[0])
        self.files[path] = bytes(data)

    def read_all(self, path):
        if path not in self.files:
            raise FileNotFoundError(path)
        return self.files[path]

    def open(self, path):
        return io.BytesIO(self.read_all(path))

    def exists(self, path):
        path = path.rstrip("/")
        return path in self.files or path in self.dirs

    def get_file_status(self, path):
        path = path.rstrip("/")
        if path in self.files:
            return FileStatus(path, False, len(self.files[path]))
        if path in self.dirs:
            return FileStatus(path, True)
        raise FileNotFoundError(path)

    def list_status(self, path):
        st = self.get_file_status(path)
        if not st.is_dir:
            return [st]
        head = st.path + "/"
        names = {p[len(head):].split("/", 1)[0]
                 for p in list(self.files) + list(self.dirs)
                 if p.startswith(head) and p != head}
        return [self.get_file_status(head + n) for n in sorted(names)]

    def delete(self, path, recursive=False):
        path = path.rstrip("/")
        under = [p for p in self.files if p.startswith(path + "/")]
        if not self.exists(path):
            return False
        if under and not recursive:
            raise OSError(f"{path} is non-empty")
        for p in under + [path]:
            self.files.pop(p, None)
        self.dirs = {d for d in self.dirs
                     if d != path and not d.startswith(path + "/")}
        return True

    def rename(self, src, dst):
        self.files[dst] = self.files.pop(src)
        return True


def phase_moe_trainer():
    """The moe_train model through ``Trainer`` as the trainer phase runs
    flagship-1b, on an in-memory filesystem (MOE_TRAIN says why): the
    uninterrupted run, the run that crashes after its interval save and
    the fresh Trainer that resumes from it (losses within TRAINER's
    loss_rtol, launches pinned per step); the checkpoint's bytes, write,
    fence and restore times; then ``load_serving_params`` on that
    checkpoint into a ``DecodeEngine`` against an engine on the crashed
    trainer's parameters as it saved them. Returns the launches of the
    three runs (train_counts)."""
    free_device()
    torch._C._host_emptyCache()          # earlier phases' page-locked cache
    cfg = moe_train_config()
    batch, seq = MOE_TRAIN["batch"], MOE_TRAIN["seq"]
    shapes = init_params(cfg, torch.Generator(), device="meta")
    n_params = sum(p.numel() for p in tree_leaves(shapes))
    elt = torch.finfo(cfg.torch_dtype).bits // 8
    ckpt_bytes = n_params * (elt + 4 + 4) + 4 + 8
    leaf_bytes = [p.numel() * k for p in tree_leaves(shapes)
                  for k in (elt, 4, 4)]
    # the checkpoint, its page-locked snapshot, and a write's or a
    # restore's copies of the largest leaf
    host_need = ckpt_bytes + _pinned_bytes(leaf_bytes) + 2 * max(leaf_bytes)
    mem_avail = _mem_available()
    require(mem_avail > host_need,
            f"{mem_avail} B of host memory available, {host_need} B needed "
            f"for a checkpoint of {ckpt_bytes} B in memory")
    fs, root = MemoryFileSystem(), "/moe"
    n_tokens = int(MOE_TRAIN["file_batches"] * batch * (seq + 1))
    data = f"{root}/tokens.bin"
    fs.write_all(data, torch.randint(
        0, cfg.vocab_size, (n_tokens,),
        generator=torch.Generator().manual_seed(SEED + 42)).numpy()
        .astype(np.uint16).tobytes())

    def trainer(path, **kw):
        return Trainer(cfg, MeshPlan(), fs, data, f"{root}/{path}",
                       batch=batch, lr=MOE_TRAIN["lr"], remat="full",
                       seed=SEED, **kw)

    steps, crash_at = TRAINER["steps"], TRAINER["crash_at"]
    per_step = []
    zero_counts()                             # the main path's run
    u = trainer("uninterrupted", ckpt_interval=0)
    u_before = u.step_metrics.anatomy()
    _counted_steps(u, per_step)
    losses = u.train(steps)
    torch.cuda.synchronize()
    step_ms = [st.elapsed_time(e) for _, st, e in per_step]
    u_anatomy = _anatomy(u, u_before)
    u.close()
    del u
    free_device()

    a = trainer("resumed", ckpt_interval=crash_at, keep=1)
    a_before = a.step_metrics.anatomy()
    _counted_steps(a, per_step)
    t0 = time.monotonic()
    crashed = a.train(crash_at)             # the exit fence included
    crashed_wall = time.monotonic() - t0
    require(list_checkpoints(fs, f"{root}/resumed") == [crash_at],
            "the interval save is not durable at train()'s exit")
    host = tree_map(lambda x: x.cpu(), a.params)
    a_anatomy = _anatomy(a, a_before)
    a.close()
    del a                                     # as a crash leaves it
    free_device()
    torch._C._host_emptyCache()               # the snapshot's pages
    step_dir = f"{root}/resumed/step_{crash_at:012d}"
    sizes = {st.path.rsplit("/", 1)[-1]: st.length
             for st in fs.list_status(step_dir)}
    shard_bytes = sum(n for f, n in sizes.items() if f != "manifest.json")
    largest_shard = max(sizes.values())

    b = trainer("resumed", ckpt_interval=0, keep=1)
    b_before = b.step_metrics.anatomy()
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
    launches = train_counts()
    b_anatomy = _anatomy(b, b_before)
    b.close()
    del b
    free_device()

    torch.cuda.synchronize()
    t0 = time.monotonic()
    params, step = load_serving_params(fs, f"{root}/resumed", cfg,
                                       io_workers=MOE_TRAIN["io_workers"])
    torch.cuda.synchronize()
    load_ms = (time.monotonic() - t0) * 1e3
    unequal = [i for i, (x, y) in enumerate(zip(tree_leaves(params),
                                                tree_leaves(host)))
               if x.dtype != y.dtype or not torch.equal(x.cpu(), y)]
    del fs
    prompts = _moe_prompts(cfg.vocab_size)[:MOE_TRAIN["prompts"]]
    greedy = SamplingParams(max_new_tokens=MOE_TRAIN["max_new"])
    served = []
    for tree in (params, tree_map(lambda x: x.cuda(), host)):
        eng = DecodeEngine(tree, cfg, **SERVE_KW)
        served.append(eng.generate(prompts, greedy))
        eng.stop()
        del eng, tree
    del params, host
    free_device()

    rel = [abs(g - w) / abs(w) for g, w in zip(resumed, losses[crash_at:])]
    want = train_counts_want(cfg, len(tree_leaves(shapes)))
    emit({"phase": "moe_trainer", "model": "mixtral-8x7b", "dtype": cfg.dtype,
          "reduced": {"n_layers": [cfg.n_layers, 32],
                      "context": [seq, 32768]},
          "filesystem": "in memory", "tokens": [batch, seq],
          "remat": "full", "optimizer": "adamw", "params": n_params,
          "data_tokens": n_tokens,
          "losses_uninterrupted": losses, "losses_crashed": crashed,
          "losses_resumed": resumed, "resumed_rel_err": rel,
          "resumed_bit_equal": resumed == losses[crash_at:],
          "step_ms": step_ms,
          "tokens_per_s": batch * seq / (sum(step_ms[1:]) / (steps - 1)
                                         / 1e3),
          "crashed_train_wall_ms": crashed_wall * 1e3,
          "anatomy": {"uninterrupted": u_anatomy, "crashed": a_anatomy,
                      "resumed": b_anatomy},
          "restore_ms": restore_ms,
          "checkpoint_shard_bytes": shard_bytes,
          "checkpoint_largest_file_bytes": largest_shard,
          "checkpoint_manifest_bytes": sizes.get("manifest.json"),
          "checkpoint_files": len(sizes), "hbm_ledger_bytes": ledger,
          "host_mem_available_bytes": mem_avail,
          "host_bytes_needed": host_need,
          "loader": {"step": step, "load_ms": load_ms,
                     "params_bit_equal": not unequal,
                     "prompt_tokens": [len(p) for p in prompts],
                     "tokens_loaded": served[0],
                     "tokens_in_memory": served[1]},
          "launches_per_step_fwd_dq_dkv_adamw_grad_sq_normf_normb":
              [c for c, _, _ in per_step]})
    require(len(losses) == steps and len(crashed) == crash_at and
            len(resumed) == steps - crash_at, "steps lost")
    require(all(math.isfinite(x) for x in losses + crashed + resumed),
            "non-finite loss")
    require(max(abs(g - w) / abs(w) for g, w in zip(crashed, losses)) <=
            TRAINER["loss_rtol"], "the crashed run left the curve")
    require(max(rel) <= TRAINER["loss_rtol"],
            f"resumed losses {resumed} vs {losses[crash_at:]}")
    require(all(c == want for c, _, _ in per_step),
            f"launches per step (fwd, dq, dkv, adamw, grad_sq, rms_norm "
            f"fwd, rms_norm bwd), expected {want}")
    require(len(per_step) == 2 * steps, f"{len(per_step)} steps counted")
    require(shard_bytes == ckpt_bytes,
            f"checkpoint shards {shard_bytes} B, expected {ckpt_bytes}")
    require(largest_shard > 2 ** 31, f"largest shard {largest_shard} B")
    require(ledger["params"] == elt * n_params and
            ledger["opt_state"] == 8 * n_params, f"ledger {ledger}")
    require(step == crash_at and not unequal,
            f"loaded step {step}; leaves {unequal} differ from the "
            "crashed trainer's")
    require(served[0] == served[1], "greedy tokens differ")
    return launches


# --------------------------------------------------------- EC coding

def _host_coder(mat, cells, threads):
    """The numpy host coder (``_gf_matmul``) over ``threads`` column
    slices of ``cells`` [k, n] uint8 at once (numpy's gathers and XORs
    run outside the GIL); the same bytes as one call."""
    n = cells.shape[1]
    edges = [n * i // threads for i in range(threads + 1)]
    with ThreadPoolExecutor(threads) as ex:
        parts = list(ex.map(lambda i: _gf_matmul(
            mat, cells[:, edges[i]:edges[i + 1]]), range(threads)))
    return np.concatenate(parts, axis=1)


def _ec_design(k, r):
    """ec_gf256.cu's own count per word column for an [r, k] matrix:
    (integer operations, shared-memory bytes). Each of the 4k data bytes
    costs a byte extract, an address and one XOR per group of four rows
    (G = ceil(r/4)), and its table entry, S words (S = G, 4 for G = 3);
    each group's 4x4 byte transpose, eight byte permutes per four words."""
    g = -(-r // 4)
    return 4 * k * (2 + g) + 8 * g, 4 * k * 4 * ec_device._entry_words(r)


def _ec_bound(k, r, w):
    """(bound_ms, bound_by, ops) of applying an [r, k] matrix to W word
    columns: each data word read once and each output word written once
    at the memory rate, the floor of any implementation (no PyTorch call
    and no table rate bounds GF(256) work lower); beside it the kernel's
    own integer operations (``_ec_design``)."""
    nbytes = (k + r) * 4 * w
    return (nbytes / MEM_BYTES_PER_S * 1e3, "bytes", _ec_design(k, r)[0] * w)


def phase_ec():
    """ec_gf256.cu on one block group per RS policy (EC): encode_cells and
    decode_cells as a user calls them (launches counted), the data
    restored after each pattern of EC_PATTERNS; then the kernel against
    its plain version and the host coder, bit for bit, and timed; odd
    1021-byte cells. Returns the RS(6,3) encode's record for the kernels
    line."""
    unit, threads = EC["unit_bytes"], EC["host_threads"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 50)
    schemas, main_launches, record = [], 0, None
    for k, m in EC["schemas"]:
        words = torch.randint(-2 ** 31, 2 ** 31, (k, unit // 4),
                              generator=gen, device="cuda",
                              dtype=torch.int32)
        host = words.cpu().numpy().view(np.uint8)             # [k, unit]
        cells = [host[i].tobytes() for i in range(k)]
        # the main path: the user's entry points, one launch each
        ec_device.launches = 0
        t0 = time.monotonic()
        parity = ec_device.encode_cells(k, m, cells)
        encode_s = time.monotonic() - t0
        restored = {}
        for lost in EC_PATTERNS[(k, m)]:
            shards = [None if u in lost else c
                      for u, c in enumerate(cells + parity)]
            t0 = time.monotonic()
            restored[str(lost)] = (ec_device.decode_cells(k, m, shards)
                                   == cells, time.monotonic() - t0)
        launches = ec_device.launches
        main_launches += launches
        del shards

        # the kernel against its plain version and the host coder
        mat = _cauchy_parity_matrix(k, m)
        enc = ec_device.device_encoder(k, m)
        got = enc(words)
        plain = ec_device.apply_matrix_ref(enc.consts, words)
        t0 = time.monotonic()
        host_parity = _host_coder(mat, host, threads)
        host_encode_s = time.monotonic() - t0
        got_bytes = got.cpu().numpy().view(np.uint8)
        rec = add_rates({
            "ms": cuda_ms(lambda: enc(words), EC["timed"]),
            "plain_ms": cuda_ms(lambda: ec_device.apply_matrix_ref(
                enc.consts, words), 1),
            "library_ms": None,
            "max_abs_err": 0 if torch.equal(got, plain) else None},
            _ec_bound(k, m, unit // 4))
        rec["int_tops"] = rec.pop("tflops")     # 10^12 integer ops / s
        ops, lds = _ec_design(k, m)
        rec["design_ops_ms"] = ops * (unit // 4) / INT32_OPS_PER_S * 1e3
        # the table loads with no bank conflict, and the kernel's time on
        # all-zero words, where every lane of a warp reads one entry (a
        # broadcast): random bytes' extra time is the banks' conflicts
        rec["design_lds_ms"] = lds * (unit // 4) / SHARED_BYTES_PER_S * 1e3
        zeros = torch.zeros_like(words)
        rec["ms_zero_words"] = cuda_ms(lambda: enc(zeros), EC["timed"])
        del zeros
        full = torch.cat([words, got])
        decodes = {}
        for lost in EC_PATTERNS[(k, m)]:
            fn, rows = ec_device.device_decode(
                k, m, [u for u in range(k + m) if u not in lost])
            surv = full[rows]
            back = fn(surv)
            inv = _gf_invert(np.vstack([np.eye(k, dtype=np.uint8),
                                        mat])[rows])
            cut = EC["host_slice"]
            slices = surv[:, :cut // 4].cpu().numpy().view(np.uint8)
            t0 = time.monotonic()
            host_back = _host_coder(inv, slices, threads)
            host_s = time.monotonic() - t0
            decodes[str(lost)] = {
                "kernel_equal_data": torch.equal(back, words),
                "plain_equal_kernel": torch.equal(
                    ec_device.apply_matrix_ref(fn.consts, surv), back),
                "host_equal_data_slice": np.array_equal(
                    host_back, host[:, :cut]),
                "ms": cuda_ms(lambda: fn(surv), EC["timed"]),
                "host_gb_per_s": k * cut / host_s / 1e9}
            del surv, back
        rec.update(schema=[k, m], unit_bytes=unit,
                   data_bytes=k * unit,
                   launches_main_path=launches,
                   encode_cells_s=encode_s,
                   decode_cells=restored,
                   parity_equal_plain=torch.equal(got, plain),
                   parity_equal_host=np.array_equal(got_bytes, host_parity),
                   encode_cells_equal_host=[c == h.tobytes() for c, h in
                                            zip(parity, host_parity)],
                   gb_per_s=k * unit / rec["ms"] / 1e6,
                   plain_gb_per_s=k * unit / rec["plain_ms"] / 1e6,
                   host_gb_per_s=k * unit / host_encode_s / 1e9,
                   decode=decodes,
                   decode_gb_per_s={p: k * unit / d["ms"] / 1e6
                                    for p, d in decodes.items()})
        del words, got, plain, full, host, cells, parity, host_parity
        free_device()
        schemas.append(rec)
        if (k, m) == (6, 3):
            record = rec

    # odd 1021-byte cells through the entry points, device and CPU
    odd = []
    rng = np.random.default_rng(SEED + 51)
    for k, m in EC["schemas"]:
        cells = [rng.integers(0, 256, EC["odd"], dtype=np.uint8).tobytes()
                 for _ in range(k)]
        parity = ec_device.encode_cells(k, m, cells)
        host_parity = _gf_matmul(_cauchy_parity_matrix(k, m), np.stack(
            [np.frombuffer(c, np.uint8) for c in cells]))
        restored = []
        for lost in EC_PATTERNS[(k, m)]:
            shards = [None if u in lost else c
                      for u, c in enumerate(cells + parity)]
            restored.append(ec_device.decode_cells(k, m, shards) == cells)
        odd.append({"schema": [k, m], "cell_bytes": EC["odd"],
                    "equal_host": parity == [r.tobytes()
                                             for r in host_parity],
                    "equal_plain": parity == ec_device.encode_cells(
                        k, m, cells, device="cpu"),
                    "restored": restored})
    emit({"phase": "ec", "schemas": schemas, "odd": odd,
          "int32_ops_per_s": INT32_OPS_PER_S,
          "shared_bytes_per_s": SHARED_BYTES_PER_S})
    for rec in schemas:
        tag = f"RS{tuple(rec['schema'])}"
        require(rec["parity_equal_plain"] and rec["parity_equal_host"]
                and all(rec["encode_cells_equal_host"]),
                f"{tag}: the kernel's parity differs from the plain "
                "version's or the host coder's")
        require(all(ok for ok, _ in rec["decode_cells"].values()),
                f"{tag}: decode_cells did not restore the data "
                f"{rec['decode_cells']}")
        require(all(d["kernel_equal_data"] and d["plain_equal_kernel"]
                    and d["host_equal_data_slice"]
                    for d in rec["decode"].values()),
                f"{tag}: a decode differs {rec['decode']}")
        require(rec["launches_main_path"] == 1 + len(rec["decode_cells"]),
                f"{tag}: {rec['launches_main_path']} launches for one "
                "encode and each decode")
    require(all(o["equal_host"] and o["equal_plain"] and all(o["restored"])
                for o in odd), f"odd cells: {odd}")
    record["launches"] = main_launches
    return record


def _shuffle_bytes(n, key_bytes, value_bytes, rows, sort):
    """The device bytes a shuffle moves on its records, by step (each
    buffer written or read once; ``rows``: the padded rows, n_dev · cap
    a rank, over every rank): the zeroed send buffers, the scatter of
    the records into them, the exchange (a transpose copy on a folded
    axis), and with ``sort`` the gather of the received rows in key
    order. The partition and the index sorts over the keys are left
    out (a few bytes a record)."""
    rec = key_bytes + value_bytes + 1                 # key, value, mask
    out = {"zero_fill": rows * rec, "scatter": 2 * n * rec,
           "exchange": 2 * rows * rec}
    if sort:
        out["sort_gather"] = 2 * rows * rec
    return out


def _shuffle_record(run, n, record_bytes, ms, peak, moved, extra):
    """One run's line: ms, GB/s of record bytes, the share of the bytes
    floor (one read and one write of every record at the memory rate),
    peak memory and the passes over the records the reckoning counts."""
    floor_ms = 2 * n * record_bytes / MEM_BYTES_PER_S * 1e3
    rec = {"phase": "shuffle", "run": run, "ranks": SHUFFLE["ranks"],
           "records": n, "record_bytes": record_bytes, "ms": ms,
           "gb_per_s": n * record_bytes / (ms * 1e-3) / 1e9,
           "floor_ms": floor_ms, "floor_share": floor_ms / ms,
           "peak_bytes": peak, "bytes_reckoned": moved,
           "passes_reckoned": sum(moved.values()) / (2 * n * record_bytes),
           "costliest_step": max(moved, key=moved.get)}
    rec.update(extra)
    return rec


def _shuffle_peak(fn):
    """(result, peak bytes allocated): one call from a reset peak, its
    result kept for the checks (``cuda_ms`` times the run after them,
    with the allocator's cache warm)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated()


def phase_shuffle():
    """The device shuffle (this slice's path, see SHUFFLE) on a folded
    axis of four ranks: TeraSort, WordCount, a hash exchange and an
    overflowing one, each checked exactly on the card."""
    free_device()
    sh = SHUFFLE
    r, n, width = sh["ranks"], sh["records"], sh["payload"]
    axis = spmd.folded("shuffle", r)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 60)
    # the reckoned peak of the TeraSort, before it runs: the input, two
    # payload buffers at twice the records (capacity factor 2; send and
    # receive, then receive and sorted), three of keys and masks, and
    # four of int64 indices over the padded rows
    rows = 2 * n
    reckoned = n * (4 + width) + 2 * rows * width + 3 * rows * 5 + \
        4 * rows * 8
    keys = torch.randint(0, sh["key_bound"], (n,), generator=gen,
                         device="cuda", dtype=torch.int32)
    payload = torch.randint(0, 256, (n, width), generator=gen,
                            device="cuda", dtype=torch.uint8)
    payload[:, :4] = torch.arange(n, device="cuda", dtype=torch.int32
                                  ).view(torch.uint8).view(n, 4)

    def terasort():
        return device_terasort(axis, keys, payload,
                               capacity_factor=sh["factor"])
    res, peak = _shuffle_peak(terasort)
    per = res.keys.shape[0] // r
    k2, m2 = res.keys.view(r, per), res.valid.view(r, per)
    counts = m2.sum(1)
    ordered = bool(((k2[:, 1:] >= k2[:, :-1]) | ~m2[:, 1:]).all())
    ends = [(int(k2[i, c - 1]), int(k2[i, 0])) if c else None
            for i, c in enumerate(counts.tolist())]
    across = all(ends[i][0] <= ends[i + 1][1] for i in range(r - 1)
                 if ends[i] and ends[i + 1])
    got_k, got_v = res.keys[res.valid], res.values[res.valid]
    dropped = int(res.dropped.sum())
    del res, k2, m2
    idx = got_v[:, :4].contiguous().view(torch.int32).view(-1).long()
    in_range = bool((idx >= 0).all() and (idx < n).all())
    seen = torch.zeros(n, dtype=torch.bool, device="cuda")
    if in_range:
        seen[idx] = True
    perm = in_range and got_k.shape[0] == n and bool(seen.all())
    rows_equal = perm and torch.equal(keys[idx], got_k) and \
        torch.equal(payload[idx], got_v)
    np_sorted = np.array_equal(got_k.cpu().numpy(),
                               np.sort(keys.cpu().numpy()))
    del idx, seen, got_k, got_v
    ms = cuda_ms(terasort, SHUFFLE["timed"])
    # which kernels the time goes to (printed as its own line)
    trace(terasort, 1, "shuffle_terasort")
    rec = _shuffle_record(
        "terasort", n, 4 + width, ms, peak,
        _shuffle_bytes(n, 4, width, rows, True),
        {"capacity_factor": sh["factor"], "valid_per_rank": counts.tolist(),
         "dropped": dropped, "runs_sorted": ordered,
         "ranks_in_order": across, "indices_a_permutation": perm,
         "rows_equal_input": rows_equal, "equals_numpy_sort": np_sorted,
         "peak_reckoned": reckoned, "peak_limit": sh["peak_limit"]})
    emit(rec)
    require(dropped == 0 and int(counts.sum()) == n,
            f"terasort: {dropped} records dropped")
    require(ordered and across, "terasort: a rank's run is not sorted, or "
            "the ranks are out of order")
    require(perm and rows_equal and np_sorted,
            "terasort: the records are not the input's, sorted")
    require(peak < sh["peak_limit"], f"terasort peak {peak} B")

    # the hash exchange of the same records, unsorted

    def exchange():
        return device_shuffle(axis, keys, payload,
                              capacity_factor=sh["factor"],
                              sort_output=False)
    res, peak = _shuffle_peak(exchange)
    per = res.keys.shape[0] // r
    owner = hash_partitioner(r)(res.keys).view(r, per)
    valid = res.valid.view(r, per)
    placed = bool(((owner == torch.arange(r, device="cuda")[:, None])
                   | ~valid).all())
    n_valid, dropped = int(valid.sum()), int(res.dropped.sum())
    del res, owner, valid
    ms = cuda_ms(exchange, SHUFFLE["timed"])
    emit(_shuffle_record(
        "hash_exchange", n, 4 + width, ms, peak,
        _shuffle_bytes(n, 4, width, rows, False),
        {"capacity_factor": sh["factor"], "valid": n_valid,
         "dropped": dropped, "rows_on_their_hash_rank": placed}))
    require(placed and n_valid == n and dropped == 0,
            f"hash exchange: {n_valid} valid, {dropped} dropped, rows on "
            f"their rank: {placed}")
    del keys, payload
    free_device()

    # WordCount: Zipf word ids, each with a count of 1
    vocab = sh["vocab"]
    cdf = torch.arange(1, vocab + 1, device="cuda",
                       dtype=torch.float64).pow(-sh["zipf"]).cumsum(0)
    cdf /= cdf[-1].clone()
    ids = torch.searchsorted(cdf, torch.rand(
        n, generator=gen, device="cuda", dtype=torch.float64)).clamp_(
            max=vocab - 1).to(torch.int32)
    ones = torch.ones(n, device="cuda", dtype=torch.int32)

    def wordcount():
        return device_group_reduce(axis, ids, ones, op="sum",
                                   capacity_factor=sh["factor"])
    res, peak = _shuffle_peak(wordcount)
    words, counts_got = res.keys[res.valid], res.values[res.valid]
    dropped = int(res.dropped.sum())
    once = int(torch.unique(words).numel()) == int(words.numel())
    want = np.bincount(ids.cpu().numpy(), minlength=vocab)
    got = np.zeros(vocab, np.int64)
    got[words.cpu().numpy()] = counts_got.cpu().numpy()
    counts_equal = np.array_equal(got, want)
    n_words = int(words.numel())
    del res, words, counts_got
    ms = cuda_ms(wordcount, SHUFFLE["timed"])
    emit(_shuffle_record(
        "wordcount", n, 8, ms, peak, _shuffle_bytes(n, 4, 4, rows, True),
        {"capacity_factor": sh["factor"], "zipf": sh["zipf"],
         "vocab": vocab, "distinct_words": n_words,
         "top_word_share": float(want.max() / n), "dropped": dropped,
         "each_word_once": once, "counts_equal_numpy_bincount":
         counts_equal}))
    require(dropped == 0 and once and counts_equal,
            f"wordcount: {dropped} dropped, each word once: {once}, counts "
            f"equal: {counts_equal}")

    # an exchange that overflows: every record is still accounted for
    res = device_shuffle(axis, ids, ones,
                         capacity_factor=sh["overflow_factor"])
    n_valid, dropped = int(res.valid.sum()), int(res.dropped.sum())
    emit({"phase": "shuffle", "run": "overflow", "records": n,
          "capacity_factor": sh["overflow_factor"], "valid": n_valid,
          "dropped": dropped})
    require(dropped > 0 and n_valid + dropped == n,
            f"overflow: {n_valid} valid + {dropped} dropped of {n}")
    del res, ids, ones, cdf
    free_device()


def phase_dist_shapes():
    """The flash forward (and both backward kernels where the path
    differentiates through them) at DIST_SHAPES against their plain
    versions, timed beside them and SDPA, with their bounds."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    for name, (b, s, hq, hkv, d), backward in DIST_SHAPES:
        q, k, v, do = (torch.randn(b, s, h, d, generator=gen, device="cuda")
                       .to(torch.bfloat16) for h in (hq, hkv, hkv, hq))
        rec = {"phase": "dist_shapes", "name": name,
               "shape": [b, s, hq, hkv, d], "dtype": "bfloat16",
               "fwd": fwd_record(q, k, v)}
        if backward:
            rec["bwd"] = bwd_record(q, k, v, do)[0]
        emit(rec)
        require(fwd_ok(rec["fwd"]) and (not backward or bwd_ok(rec["bwd"])),
                f"flash kernels disagree with their plain versions at "
                f"{name} {rec['shape']}")
        del q, k, v, do
        free_device()


# The tp_serving phase: DecodeEngine on four gloo ranks sharing the card
# (spmd.launch, dist_plans.serve_plans; every collective through host
# memory, the eager step), each leg against the port's single-device
# engine on the same weights, run eagerly in this process first and
# freed. (a) flagship-1b float32 at full depth at tp 2 (×dp 2: two
# copies run the same steps; speculation k 2) and at tp 4: two prompts
# share a ``head``-token head (the radix maps its pages), a small pool
# forces a preemption, one request samples. (b) llama3-70b at full
# width, bf16, ``depth`` of 80 layers, tp 4. (c) mixtral-8x7b at full
# width, bf16, 2 of 32 layers (the moe_train cut): 4 expert shards over
# the four ranks, MoE under tp 2 (×dp 2), and the int8 plane over 4
# shards. (b) and (c): ``prompts`` prompts of ``prompt_len`` tokens,
# ``max_new`` greedy tokens each; each prompt's first-token logits within
# ``tol`` (max |d| / max |ref|) of the single device's, and the tokens
# equal up to the first the single device decided by a top-2 gap under
# ``tol`` of its row's largest logit.
TP_SERVING = dict(tol=2e-2, seed=SEED + 50, block_size=16, device="cuda")
TP_FLAGSHIP = dict(model="flagship-1b", head=64, tails=(16, 24), other=40,
                   sampled=100, max_new=16, temperature=0.8, top_k=50,
                   engine=dict(max_batch=2, num_blocks=9, prefill_chunk=16,
                               max_context=256))
TP_LARGE = dict(prompts=4, prompt_len=512, max_new=32,
                engine=dict(max_batch=4, prefill_chunk=128,
                            max_context=640))
# (leg, model, layers, placement, int8, engine options)
TP_LEGS = [
    ("flagship_tp2_speculate", "flagship-1b", None, {"plan": {"tp": 2,
                                                           "dp": 2}},
     False, {"speculate_k": 2}),
    ("flagship_tp4", "flagship-1b", None, {"plan": {"tp": 4}}, False, {}),
    ("llama3_70b_tp4", "llama3-70b", 8, {"plan": {"tp": 4}}, False, {}),
    ("mixtral_shards4", "mixtral-8x7b", 2, {"group": 4}, False,
     {"moe_shards": 4}),
    ("mixtral_tp2", "mixtral-8x7b", 2, {"plan": {"tp": 2, "dp": 2}}, False,
     {}),
    ("mixtral_int8_shards4", "mixtral-8x7b", 2, {"group": 4}, True,
     {"moe_shards": 4}),
]
TP_CAVEAT = ("four ranks on one card, host transport, not a multi-GPU "
             "number")
# The control: ``of``'s job with each rank's attention output left out of
# the other ranks' sum (every rank adds only its own partial). Its
# first-token logits must fall outside ``tol`` of the single device's: how
# far a wrong engine reads beside the legs that pass.
TP_CONTROL = dict(leg="mixtral_tp2_dropped_partial", of="mixtral_tp2")


def _tp_flagship_ops(vocab):
    """Leg (a)'s script: A prefills; B (A's head, another tail) joins
    after A's first token and is preempted when the pool runs dry; C and
    a sampled request wait for a lane."""
    f = TP_FLAGSHIP
    gen = torch.Generator().manual_seed(SEED + 51)

    def draw(n):
        return torch.randint(0, vocab, (n,), generator=gen).tolist()
    head = draw(f["head"])
    a, b = (head + draw(n) for n in f["tails"])
    return [{"op": "submit", "prompts": [a], "max_new": f["max_new"]},
            {"op": "until_first", "req": 0},
            {"op": "submit", "prompts": [b, draw(f["other"])],
             "max_new": f["max_new"]},
            {"op": "submit", "prompts": [draw(f["sampled"])],
             "max_new": f["max_new"], "temperature": f["temperature"],
             "top_k": f["top_k"]},
            {"op": "drain"}]


def _tp_large_ops(vocab):
    gen = torch.Generator().manual_seed(SEED + 52)
    t = TP_LARGE
    return [{"op": "submit", "max_new": t["max_new"],
             "prompts": [torch.randint(0, vocab, (t["prompt_len"],),
                                       generator=gen).tolist()
                         for _ in range(t["prompts"])]},
            {"op": "drain"}]


def _tp_leg_config(model, layers, flagship):
    over = {"dtype": "float32"} if flagship else {"n_layers": layers}
    return over, get_config(model, **over)


def _tp_single(model, over, cfg, int8_from, kw, ops):
    """The single-device engine's eager run of ``ops`` (the driver's own
    code, ``StepProbe`` on it): its record, and the float tree it drew
    (for the int8 plane's reference) unless it was the int8 run."""
    dev = TP_SERVING["device"]
    if int8_from is None:
        params = init_params(cfg, torch.Generator(device=dev).manual_seed(
            TP_SERVING["seed"]), device=dev)
        run_params = params
    else:
        params = None
        run_params, _ = weightplane.quantize_params(
            int8_from, cfg, weightplane.WeightPlaneConfig(tier="relaxed"))
    eng = DecodeEngine(run_params, cfg, block_size=TP_SERVING["block_size"],
                       device=dev, **kw)
    eng._launch_step = eng._step_eager
    probe = dist_plans.StepProbe(eng)
    rec = {"step_ms": [], "fused": [], "launches": [], "traffic": []}
    t0 = time.monotonic()
    dist_plans._drive(eng, {"ops": ops}, rec, dev == "cuda")
    rec["serve_s"] = time.monotonic() - t0
    rec["first_logits"] = [probe.first[i] for i in rec["ids"]]
    rec["gaps"] = [probe.gaps[i] for i in rec["ids"]]
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() \
        if dev == "cuda" else None
    eng.stop()
    del eng, probe, run_params
    free_device()
    return rec, params


def _tp_references():
    """Every leg's single-device run, by (model, int8), and the scripts."""
    refs, ops = {}, {}
    for leg, model, layers, _, int8, extra in TP_LEGS:
        flagship = model == TP_FLAGSHIP["model"]
        over, cfg = _tp_leg_config(model, layers, flagship)
        ops[leg] = (_tp_flagship_ops if flagship else _tp_large_ops)(
            cfg.vocab_size)
        if (model, int8) in refs:
            continue
        kw = dict(TP_FLAGSHIP["engine"] if flagship else TP_LARGE["engine"])
        if TP_SERVING["device"] == "cuda":
            torch.cuda.reset_peak_memory_stats()
        rec, params = _tp_single(model, over, cfg, None, kw, ops[leg])
        refs[model, False] = rec
        if any(m == model and q for _, m, _, _, q, _ in TP_LEGS):
            if TP_SERVING["device"] == "cuda":
                torch.cuda.reset_peak_memory_stats()
            refs[model, True], _ = _tp_single(model, over, cfg, params, kw,
                                              ops[leg])
        del params
        free_device()
    return refs, ops


def _agree(got, want, gaps, tie):
    """How far ``got`` follows ``want``: the first index where they
    differ (or their length), and whether every earlier token is equal
    where the single device's top-2 gap was at least ``tie``."""
    n = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    close = next((j for j, g in enumerate(gaps) if g < tie), len(gaps))
    return n, n >= min(close, len(want))


def _tp_record(leg, model, layers, where, int8, speculate, ranks, ref,
               ops):
    """One leg's line and gates, against its single-device run ``ref``."""
    drv = ranks[0]
    cfg = get_config(model, **_tp_leg_config(
        model, layers, model == TP_FLAGSHIP["model"])[0])
    decode = [ms for ms, f in zip(drv["step_ms"], drv["fused"]) if not f]
    fused = [ms for ms, f in zip(drv["step_ms"], drv["fused"]) if f]
    n_tok = sum(len(t) for t in drv["tokens"])
    wire = {}
    for step in drv["traffic"]:
        for axis, b in step.items():
            wire[axis] = wire.get(axis, 0) + b / len(drv["traffic"])
    groups = [2 if f else 1 for f in drv["fused"]]
    rms_want = [(2 * cfg.n_layers + 1) * g for g in groups]
    deq_want = [7 * cfg.n_layers if int8 else 0] * len(groups)
    rec = {"phase": "tp_serving", "leg": leg, "model": model,
           "layers": cfg.n_layers, "dtype": cfg.dtype, "int8": int8,
           "placement": where, "mesh": drv["mesh"], "caveat": TP_CAVEAT,
           "transport": "gloo, collectives through host memory",
           "tokens": drv["tokens"], "tokens_single_device": ref["tokens"],
           "preemptions": drv["preemptions"],
           "prefix_tokens_reused": drv["reused"],
           "ttft_ms": drv["ttft_ms"],
           "ttft_ms_single_device": ref["ttft_ms"],
           "decode_step_ms": decode, "fused_step_ms": fused,
           "decode_step_ms_mean": sum(decode) / max(1, len(decode)),
           "decode_step_ms_single_device": [
               ms for ms, f in zip(ref["step_ms"], ref["fused"]) if not f],
           "tokens_per_s": n_tok / (drv["serve_ms"] / 1e3),
           "tokens_per_s_single_device": n_tok / ref["serve_s"],
           "serve_s_per_rank": [r["serve_ms"] / 1e3 for r in ranks],
           "setup_s_per_rank": [r["setup_ms"] / 1e3 for r in ranks],
           "peak_memory_bytes_per_rank": [r["peak_bytes"] for r in ranks],
           "peak_memory_bytes_single_device": ref["peak_bytes"],
           "wire_bytes_per_step_by_axis": wire,
           "launches_per_step": drv["launches"],
           "rms_norm_fwd_want": rms_want, "dequant_want": deq_want,
           "weight_plane": drv["weight_plane"]}
    require(all(r["error"] is None for r in ranks) and
            [r["mesh"]["driver"] for r in ranks] == [True] + [False] * 3
            and all(r["followed_steps"] == len(drv["step_ms"])
                    for r in ranks[1:]),
            f"{leg}: a rank failed or did not follow every step: "
            f"{[r['error'] for r in ranks]}")
    require([n for n, _ in drv["launches"]] == rms_want and
            [n for _, n in drv["launches"]] == deq_want,
            f"{leg}: RMSNorm / dequantize launches a step "
            f"{drv['launches']}, expected {rms_want} / {deq_want}")
    if model == TP_FLAGSHIP["model"]:
        temps = [o.get("temperature", 0.0) for o in ops
                 if o["op"] == "submit" for _ in o["prompts"]]
        greedy = [i for i, t in enumerate(temps) if t <= 0]
        agree = [_agree(drv["tokens"][i], ref["tokens"][i],
                        ref["gaps"][i], TIE_REL) for i in greedy]
        rec["tokens_agree"] = [n for n, _ in agree]
        rec["ranks_digests_equal"] = all(r["digests"] == drv["digests"]
                                         for r in ranks[1:])
        emit(rec)
        require(all(ok for _, ok in agree),
                f"{leg}: greedy tokens {drv['tokens']} against the single "
                f"device's {ref['tokens']} (a difference only at a "
                f"near-tie of {TIE_REL})")
        require(rec["ranks_digests_equal"] and len(drv["digests"]) ==
                len(drv["step_ms"]),
                f"{leg}: the ranks' step outputs or step state differ")
        # speculation's accepted drafts finish A sooner: its run may
        # never run the pool dry
        require((max(drv["preemptions"]) >= 1 or speculate) and
                max(drv["reused"]) >= TP_FLAGSHIP["head"],
                f"{leg}: no preemption or no mapped head: "
                f"{drv['preemptions']}, {drv['reused']}")
        return
    tol = TP_SERVING["tol"]
    rel = [float(np.abs(g - w).max() / np.abs(w).max())
           for g, w in zip(drv["first_logits"], ref["first_logits"])]
    agree = [_agree(g, w, gaps, tol) for g, w, gaps in
             zip(drv["tokens"], ref["tokens"], ref["gaps"])]
    rec.update(first_logits_rel=rel, tol=tol,
               tokens_agree=[n for n, _ in agree],
               tokens_max_new=TP_LARGE["max_new"],
               single_device_first_gap_under_tol=[
                   next((j for j, g in enumerate(gaps) if g < tol), None)
                   for gaps in ref["gaps"]])
    emit(rec)
    require(all(np.isfinite(x).all() for x in drv["first_logits"]) and
            max(rel) <= tol,
            f"{leg}: first-token logits {rel} of the single device's max")
    require(all(ok for _, ok in agree),
            f"{leg}: tokens {drv['tokens']} leave the single device's "
            f"{ref['tokens']} before its first top-2 gap under {tol}")


def _tp_prepare():
    """tp_serving's single-device references (run here, then freed), its
    scripts and the world's jobs."""
    t0 = time.monotonic()
    free_device()
    refs, ops = _tp_references()
    jobs = []
    for leg, model, layers, where, int8, extra in TP_LEGS:
        flagship = model == TP_FLAGSHIP["model"]
        over, _ = _tp_leg_config(model, layers, flagship)
        kw = dict(TP_FLAGSHIP["engine"] if flagship else TP_LARGE["engine"],
                  block_size=TP_SERVING["block_size"], **extra)
        job = dict(preset=model, overrides=over, seed=TP_SERVING["seed"],
                   device=TP_SERVING["device"], engine=kw, ops=ops[leg],
                   **where)
        if int8:
            job["relaxed"] = {}
        job["digests" if flagship else "probe"] = True
        jobs.append(job)
    of = [leg[0] for leg in TP_LEGS].index(TP_CONTROL["of"])
    jobs.append(dict(jobs[of], control="drop_tp_partial"))
    return {"refs": refs, "ops": ops, "jobs": jobs,
            "ref_s": time.monotonic() - t0}


def _tp_control(prep, ranks):
    """The control leg's record and gate (see TP_CONTROL)."""
    leg = next(x for x in TP_LEGS if x[0] == TP_CONTROL["of"])
    ref = prep["refs"][leg[1], leg[4]]
    tol = TP_SERVING["tol"]
    rel = [float(np.abs(g - w).max() / np.abs(w).max())
           for g, w in zip(ranks[0]["first_logits"], ref["first_logits"])]
    emit({"phase": "tp_serving", "leg": TP_CONTROL["leg"],
          "control": "every rank's attention output left out of the "
                     "others' tp sum", "model": leg[1],
          "placement": leg[3], "first_logits_rel": rel, "tol": tol,
          "min_over_tol": min(rel) / tol})
    require(min(rel) > tol,
            f"{TP_CONTROL['leg']}: a dropped partial reads {rel}, within "
            f"the gate's {tol}")


def _tp_split_rounding():
    """How often a bf16 product on the card changes where the engine cuts
    it, at mixtral-8x7b's widths, the fused step's rows (a 128-row chunk
    and 4 lanes) and random values: the share of output elements unequal
    to the uncut product's, for a column-parallel product at tp 2
    (``w_gate``'s columns halved), a row-parallel one at tp 2 (``w_down``'s
    rows halved, float32 partials summed and rounded once) and the
    4-shard leg's expert product (2 of 8 experts). The legs' distance
    from one device starts here; no gate."""
    cfg = get_config("mixtral-8x7b")
    d, f, t = cfg.d_model, cfg.d_ff, TP_LARGE["engine"]["prefill_chunk"] + 4
    dev = TP_SERVING["device"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 53)

    def draw(*shape):
        return (0.02 * torch.randn(shape, generator=gen, device=dev)
                ).bfloat16()

    def share(a, b):
        return float((a != b).float().mean())
    x, w = draw(t, d), draw(d, f)
    cols = share((x @ w)[:, :f // 2], x @ w[:, :f // 2].contiguous())
    h, w2 = draw(t, f), draw(f, d)
    parts = h[:, :f // 2].float() @ w2[:f // 2].float() \
        + h[:, f // 2:].float() @ w2[f // 2:].float()
    rows = share(parts.bfloat16(), h @ w2)
    del x, w, h, w2, parts
    xe = draw(cfg.n_experts, moe_capacity(t, cfg), d)
    we = draw(cfg.n_experts, d, f)
    experts = share(torch.bmm(xe, we)[:2], torch.bmm(xe[:2], we[:2]))
    del xe, we
    free_device()
    return {"rows": t, "columns_tp2": cols, "rows_tp2_f32_partials": rows,
            "experts_2_of_8": experts}


def _tp_check(prep, recs, world_s):
    """Every leg's gates and records (``recs``: each rank's records);
    returns rank 0's RMSNorm forward and dequantize launches over the
    legs' steps."""
    total = {"rms_norm_fwd": 0, "dequant_int8": 0}
    for i, (leg, model, layers, where, int8, extra) in enumerate(TP_LEGS):
        ranks = [r[i] for r in recs]
        _tp_record(leg, model, layers, where, int8, "speculate_k" in extra,
                   ranks, prep["refs"][model, int8], prep["ops"][leg])
        for rms, deq in ranks[0]["launches"]:
            total["rms_norm_fwd"] += rms
            total["dequant_int8"] += deq
    _tp_control(prep, [r[len(TP_LEGS)] for r in recs])
    emit({"phase": "tp_serving", "summary": True,
          "seconds": {"references": prep["ref_s"], "world": world_s},
          "split_products_unequal_share": _tp_split_rounding(),
          "foreign_modules": recs[0][-1]["foreign"],
          "launches_rank0": total})
    require(recs[0][-1]["foreign"] == [],
            f"the ranks imported {recs[0][-1]['foreign']}")
    return total


# The relaxed stage (the relaxed parity tier, ``parallel/lowp``): the
# loss-curve A-B (``run_loss_ab`` through ``dist_plans.relaxed_plans``)
# on four gloo ranks sharing the card, at flagship-1b's full width and
# ``layers`` deep (2: at 4 the stage took 104 s, past its share of the
# script's limit), TRAIN's [4, 2048] batch, AdamW, full remat, in
# float32: the tier's >= 2x byte contract is the reference's for 4-byte
# payloads (a 2-byte bf16 bucket carries 2 / (1 + 4 / group) = 1.99x at
# best, by the reference's own accounting). Legs (name, mesh, options,
# ParityConfig keywords, the leg whose bitwise curve it reuses):
# dp2 x tp2 with every consumer on (int8, tp_chunks 4); ZeRO-1 dp4 in
# fp8 (its gradient scatter on the int8 wire, as the reference's falls
# back; the gather in fp8); dp2 x tp2 at periodic:2 stale. The first two
# also hold the first relaxed step's gradient buckets' int8 and fp8
# codecs on the card against the CPU's, byte for byte. ``ratio_min``:
# the ledger's first-step reference over payload bytes; ``cut_min``: the
# dp axis's wire bytes (the gradient buckets and ZeRO-1 gather ride it),
# bitwise arm over relaxed. ``bucket_mib`` and ``codec_iters``: the
# eager codec's timing before the world (one 4 MiB bucket, and the
# buckets of a full-depth flagship-1b dp2 x tp2 rank's step).
RELAXED = dict(model="flagship-1b", layers=2, dtype="float32", steps=4,
               ratio_min=2.0, cut_min=2.0, bucket_mib=4, codec_iters=10)
RELAXED_LEGS = [
    ("dp2_tp2_int8", {"dp": 2, "tp": 2}, {}, {"codec": "int8"}, None),
    ("zero1_dp4_fp8", {"dp": 4}, {"zero1": True}, {"codec": "fp8"}, None),
    ("dp2_tp2_periodic2_stale", {"dp": 2, "tp": 2}, {},
     {"relaxed_sync": "periodic:2", "relaxed_sync_mode": "stale"}, 0),
]
RELAXED_CAVEAT = ("four ranks on one card, gloo, every collective through "
                  "host memory: host wall a step (the loss read ends it), "
                  "not a multi-GPU deployment's")


def _relaxed_cfg():
    return get_config(RELAXED["model"], n_layers=RELAXED["layers"],
                      dtype=RELAXED["dtype"])


def _codec_ms(x, codec):
    """Device ms of one eager quantize-and-dequantize of ``x`` (the
    relaxed collectives' codec, without the wire)."""
    def run():
        rows = lowp_quant._pad_rows(x, 1024)
        qmax = 127 if codec == "int8" else lowp_quant._F8_MAX
        scales = lowp_quant._wire_scales(rows.abs().amax(dim=1), qmax)
        q = lowp_quant._quant_rows(rows, scales, qmax) if codec == "int8" \
            else lowp_quant._to_f8(rows, scales)
        return q.float() * scales[:, None]
    return cuda_ms(run, RELAXED["codec_iters"])


def _codec_bound_ms(n):
    """Bytes the codec must move for ``n`` f32 elements: read them, write
    the 1-byte values and the scales, read both back, write the result."""
    g = -(-n // 1024)
    return (4 * n + n + 4 * g + n + 4 * g + 4 * n) / MEM_BYTES_PER_S * 1e3


def _step_buckets(cfg, plan):
    """A rank's gradient bucket sizes (elements) under ``plan``'s relaxed
    step: its shards grouped by spec axes, packed into 4 MiB buckets in
    flatten order (``overlap``'s rule)."""
    specs = param_specs(cfg, plan)
    shapes = init_params(cfg, torch.Generator(), device="meta")
    groups = {}
    for leaf, spec in zip(tree_leaves(shapes), tree_leaves(specs)):
        n = leaf.numel()
        for a in spec:
            if a is not None:
                n //= plan.sizes[a]
        groups.setdefault(tuple(sorted(a for a in spec if a)), []).append(n)
    out = []
    for sizes in groups.values():
        for bucket in overlap._pack_buckets(sizes, 4, RELAXED["bucket_mib"]
                                            << 20):
            out.append(sum(sizes[i] for i in bucket))
    return out


def _relaxed_codec_timing(smi):
    """The eager codec's device time against its bytes bound: one 4 MiB
    bucket, and every bucket of a flagship-1b dp2 x tp2 rank's step."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 70)
    one = torch.randn((RELAXED["bucket_mib"] << 20) // 4, device="cuda",
                      generator=gen)
    cfg = get_config(RELAXED["model"], dtype="float32")
    sizes = _step_buckets(cfg, MeshPlan(dp=2, tp=2))
    step = [torch.randn(n, device="cuda", generator=gen) for n in sizes]
    rec = {"phase": "relaxed_codec", "card": smi, "bucket_elements":
           one.numel(), "step_buckets": len(sizes),
           "step_elements": sum(sizes), "model": RELAXED["model"],
           "step_layers": cfg.n_layers,
           "bound_ms_bucket": _codec_bound_ms(one.numel()),
           "bound_ms_step": sum(_codec_bound_ms(n) for n in sizes)}
    for codec in ("int8", "fp8"):
        rec[f"{codec}_ms_bucket"] = _codec_ms(one, codec)
        rec[f"{codec}_ms_step"] = sum(_codec_ms(x, codec) for x in step)
        rec[f"{codec}_bound_share_step"] = rec["bound_ms_step"] / \
            rec[f"{codec}_ms_step"]
    emit(rec)
    del one, step
    free_device()
    return rec


def _relaxed_prepare(smi):
    """The codec timing (this process), then the stage's jobs."""
    codec = _relaxed_codec_timing(smi)
    cfg = _relaxed_cfg()
    tokens = _train_tokens(cfg).cpu().numpy()
    jobs = []
    for name, plan, opts, pkw, reuse in RELAXED_LEGS:
        job = dict({"plan": plan, "preset": RELAXED["model"],
                    "overrides": {"n_layers": RELAXED["layers"],
                                  "dtype": RELAXED["dtype"]},
                    "steps": RELAXED["steps"], "lr": TRAIN["lr"],
                    "remat": TRAIN["remat"], "seed": SEED,
                    "tokens": tokens, "device": "cuda",
                    "parity": ParityConfig(tier="relaxed", **pkw)}, **opts)
        if reuse is None:
            job["codec_check"] = True
        else:
            job["bitwise_from"] = reuse
        jobs.append(job)
    return {"jobs": jobs, "codec": codec, "cfg": cfg, "smi": smi}


def _per_step(probe, steps):
    return {k: v / steps for k, v in probe.items()}


def _relaxed_check(ctx, recs, seconds):
    """The relaxed stage's records and holds; returns rank 0's launches
    over the stage, by kernel name."""
    cfg, steps = ctx["cfg"], RELAXED["steps"]
    for i, (name, plan, opts, pkw, reuse) in enumerate(RELAXED_LEGS):
        ranks = [r[i] for r in recs]
        rep, arms = ranks[0], [r["rank"] for r in ranks]
        bit_arms = [recs[r][i if reuse is None else reuse]["rank"]["bitwise"]
                    for r in range(len(recs))]
        want = _dist_want(cfg, plan, {})
        cut = [b["traffic"].get("dp", 0) / max(a["relaxed"]["traffic"].get(
            "dp", 0), 1) for a, b in zip(arms, bit_arms)]
        per = rep["comm"]["per_site"]
        rec = {"phase": "relaxed", "leg": name, "mesh": plan, **opts,
               "model": RELAXED["model"], "layers": RELAXED["layers"],
               "dtype": RELAXED["dtype"], "optimizer": "adamw",
               "tokens": [TRAIN["batch"], TRAIN["seq"]],
               "remat": TRAIN["remat"], "parity": pkw, "card": ctx["smi"],
               "transport": RELAXED_CAVEAT, "seconds": seconds,
               "bitwise_losses": rep["bitwise_losses"],
               "relaxed_losses": rep["relaxed_losses"],
               "report": {k: rep.get(k) for k in (
                   "accepted", "reason", "rel_tol", "max_rel_div",
                   "mean_rel_div", "final_rel_div", "raw_max_rel_div")},
               "ledger_first_step": rep["comm"],
               "wire_bytes_bitwise_by_axis": [b["traffic"]
                                              for b in bit_arms],
               "wire_bytes_relaxed_by_axis": [a["relaxed"]["traffic"]
                                              for a in arms],
               "dp_wire_cut": cut,
               "step_ms_bitwise_per_rank": [[t * 1e3 for t in b["step_s"]]
                                            for b in bit_arms],
               "step_ms_relaxed_per_rank": [[t * 1e3 for t in
                                             a["relaxed"]["step_s"]]
                                            for a in arms],
               "peak_memory_bytes_per_rank": [a.get("peak_bytes")
                                              for a in arms],
               "launches_per_step_rank0": {
                   "bitwise": _per_step(bit_arms[0]["probe"], steps),
                   "relaxed": _per_step(arms[0]["relaxed"]["probe"],
                                        steps)},
               "codec_check": [a.get("codec_check") for a in arms]}
        emit(rec)
        require(all(np.isfinite(rep["bitwise_losses"] +
                                rep["relaxed_losses"])),
                f"relaxed {name}: a loss is not finite")
        require(all(r["relaxed_losses"] == rep["relaxed_losses"]
                    for r in ranks), f"relaxed {name}: the ranks differ")
        for a, b in zip(arms, bit_arms):
            got = [a["relaxed"]["probe"][k] for k in dist_plans.COUNTERS]
            require(got == [b["probe"][k] for k in dist_plans.COUNTERS] and
                    got[:4] == [steps * n for n in want],
                    f"relaxed {name}: launches {a['relaxed']['probe']} "
                    f"(bitwise arm {b['probe']}, flash a step {want})")
        if reuse is None:
            require(rep["comm"]["ratio"] >= RELAXED["ratio_min"],
                    f"relaxed {name}: ledger ratio {rep['comm']['ratio']}")
            require(min(cut) >= RELAXED["cut_min"],
                    f"relaxed {name}: dp wire cut {cut}")
            require(all(c["buckets"] > 0 and c["mismatched"] == 0
                        for c in rec["codec_check"]),
                    f"relaxed {name}: card codec against the CPU's "
                    f"{rec['codec_check']}")
        else:
            modes = ("sync", "stale") * (RELAXED["layers"] // 2)
            full = recs[0][reuse]["comm"]["per_site"]["tp.psum"]
            require(per["tp.psum"]["executions"] == full["executions"] // 2
                    and per["tp.psum"]["reference_bytes"] ==
                    full["reference_bytes"] and per["tp.stale"][
                        "executions"] == 2 * modes.count("stale"),
                    f"relaxed {name}: scheduled-off sites {per} against "
                    f"the full schedule's tp.psum {full}")
    return recs[0][-1]["rank"]["launches_total"]


# The four-rank phases share one world: its processes start, reach the
# card and warm up once (``dist_plans.stages``). A stage's single-device
# references run first, in this process (then freed), then the world's
# stages, then each stage's gates, in DIST_STAGES' order. trainer_mesh
# holds its launches to dist_train's, so it needs that stage.
DIST_STAGES = ("tp_serving", "dist_parity", "dist_train", "trainer_mesh",
               "relaxed")
DIST_WORLD_TIMEOUT = 1500


def phase_dist_world(stages=DIST_STAGES, smi=""):
    """The ``stages`` of DIST_STAGES on one world of four ranks. Returns
    rank 0's launches by kernel name, by stage (tp_serving's, dist_train's,
    trainer_mesh's and relaxed's). One stage alone: ``phase_dist_world(
    ("tp_serving",))``; ``smi``: the card's nvidia-smi line, which the
    relaxed stage's records carry."""
    stages = [s for s in DIST_STAGES if s in stages]
    if "trainer_mesh" in stages and "dist_train" not in stages:
        raise ValueError("trainer_mesh's launches are held to dist_train's")
    phase_t0 = time.monotonic()
    free_device()
    root = tempfile.mkdtemp(prefix="htpu-trainer-mesh-")
    try:
        program, checks = [], []
        for stage in stages:
            if stage == "tp_serving":
                tp = _tp_prepare()
                program.append(("serve_plans", (tp["jobs"],)))
                checks.append(lambda recs, s, tp=tp: _tp_check(tp, recs, s))
            elif stage == "relaxed":
                rx = _relaxed_prepare(smi)
                program.append(("relaxed_plans", (rx["jobs"],)))
                checks.append(lambda recs, s, rx=rx:
                              _relaxed_check(rx, recs, s))
            elif stage in ("dist_parity", "dist_train"):
                parity = stage == "dist_parity"
                refs = _parity_refs() if parity else {
                    group: _train_reference(*group)
                    for group in _dist_groups()}
                jobs, names = _dist_jobs(parity, DIST["sample"] if parity
                                         else None,
                                         1 if parity else DIST["train_steps"])
                program.append(("train_plans", (jobs,)))
                check = _parity_check if parity else _train_check
                checks.append(lambda recs, s, refs=refs, names=names,
                              check=check: check(refs, _by_plan(recs, names),
                                                 {"world_stage": s}))
            else:
                ctx = _trainer_mesh_prepare(root)
                jobs = _trainer_mesh_jobs(root, ctx["data"])
                program.append(("trainer_ops", (jobs,)))
                checks.append(lambda recs, s, ctx=ctx, n=len(jobs):
                              _trainer_mesh_check(
                                  ctx, _mesh_regroup(recs, n), root,
                                  launches["dist_train"][1],
                                  {"world_stage": s}, phase_t0))
        free_device()
        refs_s = time.monotonic() - phase_t0
        t0 = time.monotonic()
        out = spmd.launch(dist_plans.stages, DIST["world"],
                          backend=DIST["backend"], args=(program,),
                          timeout=DIST_WORLD_TIMEOUT)
        world_s = time.monotonic() - t0
        stage_s = [max(r[i][1] for r in out) for i in range(len(stages))]
        launches = {}
        for i, (stage, check) in enumerate(zip(stages, checks)):
            launches[stage] = check([r[i][0] for r in out], stage_s[i])
        emit({"phase": "dist_world", "stages": stages,
              "seconds": {"references": refs_s, "world": world_s,
                          "stages": stage_s,
                          "phase": time.monotonic() - phase_t0}})
        if "dist_train" in launches:
            launches["dist_train"] = launches["dist_train"][0]
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _dist_groups():
    """DIST_PLANS by (model, layers), in order of first appearance."""
    groups = {}
    for plan in DIST_PLANS:
        groups.setdefault(plan[1:3], []).append(plan)
    return groups


def _dist_overrides(model, layers, parity):
    """The config overrides of a group: its depth, and for the parity
    phase float32 and (MoE) the no-drop capacity factor."""
    over = {"n_layers": layers}
    if parity:
        over["dtype"] = "float32"
        if get_config(model).is_moe:
            over["capacity_factor"] = DIST["parity_factor"]
    return over


def _dist_job(model, over, tokens, sample, plans):
    return {"preset": model, "overrides": over, "seed": SEED,
            "device": "cuda", "sample": sample,
            "tokens": tokens.cpu().numpy(),
            "targets": torch.roll(tokens, -1, dims=1).cpu().numpy(),
            "plans": plans}


def _dist_spec(name, kw, opts, steps, parity):
    """A ``dist_plans`` plan of DIST_PLANS: AdamW (ZeRO-1 for a "zero1"
    plan), except SGD for the parity phase's other plans."""
    zero1 = name.startswith("zero1")
    opt = {"optimizer": "adamw", "zero1": zero1, "lr": TRAIN["lr"]}
    if parity and not zero1:
        opt = {"optimizer": "sgd", "lr": DIST["sgd_lr"]}
    return dict({"plan": kw, "steps": steps, "remat": TRAIN["remat"]},
                **opts, **opt)


def _by_plan(recs, names):
    """``train_plans``' records of every rank, by plan name."""
    return {name: [r[i] for r in recs] for i, name in enumerate(names)}


def _dist_jobs(parity, sample, steps):
    """``train_plans``' jobs for DIST_PLANS, one a group, and the plans'
    names in the order of their records."""
    jobs, names = [], []
    for (model, layers), plans in _dist_groups().items():
        over = _dist_overrides(model, layers, parity)
        cfg = get_config(model, **over)
        jobs.append(_dist_job(model, over, _train_tokens(cfg), sample, [
            _dist_spec(name, kw, opts, steps, parity)
            for name, _, _, kw, opts in plans]))
        names += [p[0] for p in plans]
    return jobs, names


def _train_tokens(cfg):
    """The train phase's batch (in the model's vocabulary)."""
    return torch.randint(0, cfg.vocab_size, (TRAIN["batch"], TRAIN["seq"]),
                         device="cuda", generator=torch.Generator(
                             device="cuda").manual_seed(SEED + 3))


def _leaf_rel(got, want, base=None):
    """Per sampled leaf: max |got - want| over max |want| (both minus
    ``base`` when given: the updates)."""
    out = {}
    for key, g, w, b in zip(tree_leaves(_names(want)), tree_leaves(got),
                            tree_leaves(want), tree_leaves(
                                base if base is not None else want)):
        if base is not None:
            g, w = g - b, w - b
        out[key] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
    return out


def _update_floor(want, base):
    """Per sampled leaf: the float32 spacing at its largest updated value
    over its largest update, the finest update difference the updated
    values can show (two roundings of p - lr·g a spacing apart read
    this much)."""
    out = {}
    for key, w, b in zip(tree_leaves(_names(want)), tree_leaves(want),
                         tree_leaves(base)):
        ulp = float(np.spacing(np.float32(np.abs(w).max())))
        out[key] = ulp / max(float(np.abs(w - b).max()), 1e-30)
    return out


def _adamw_worst(got, want, base, ndims, lr):
    """Per sampled leaf, at the element where the plan's update is
    furthest from the single device's: both updates and |g|/eps, g the
    clipped gradient the single device's first AdamW update implies
    (|a|/(1-|a|), a = -update/lr - wd*p0 on decayed leaves:
    g/(|g| + eps) at step 1)."""
    out = {}
    for key, g, w, b in zip(tree_leaves(_names(want)), tree_leaves(got),
                            tree_leaves(want), tree_leaves(base)):
        dg, dw = g.astype(np.float64) - b, w.astype(np.float64) - b
        i = int(np.abs(dg - dw).argmax())
        a = -dw[i] / lr - (DIST["adamw_wd"] * b[i] if ndims[key] >= 2
                           else 0.0)
        a = min(abs(a), 1.0 - 1e-12)
        out[key] = {"index": i, "update_plan": float(dg[i]),
                    "update_single": float(dw[i]),
                    "grad_over_eps": float(a / (1.0 - a))}
    return out


def _parity_reference(model, layers, optimizers):
    """The single-device float32 step at a group's depth, for each
    optimizer: (loss, grad norm, sampled tree), the sampled seed-0
    weights and each leaf's ndim."""
    cfg = get_config(model, **_dist_overrides(model, layers, True))
    tokens = _train_tokens(cfg)
    ref = {}
    for opt in optimizers:
        params = init_params(cfg, torch.Generator(device="cuda")
                             .manual_seed(SEED))
        p0 = dist_plans.sample_tree(params, DIST["sample"])
        ndims = {key: p.ndim for key, p in zip(tree_leaves(_names(params)),
                                              tree_leaves(params))}
        state = adamw_init(params) if opt == "adamw" else \
            AdamWState(0, {}, {})         # SGD reads no moments
        lr = TRAIN["lr"] if opt == "adamw" else DIST["sgd_lr"]
        step = make_train_step(cfg, MeshPlan(), lr=lr, optimizer=opt,
                               remat=TRAIN["remat"])
        params, state, m = step(params, state, tokens,
                                torch.roll(tokens, -1, dims=1))
        ref[opt] = (m["loss"].item(), m["grad_norm"].item(),
                    dist_plans.sample_tree(params, DIST["sample"]))
        del params, state, step, m
        free_device()
    return ref, p0, ndims


def _parity_refs():
    """dist_parity's single-device references, by group."""
    refs = {}
    for (model, layers), plans in _dist_groups().items():
        opts = ["sgd"] + (["adamw"] if any(p[0].startswith("zero1")
                                           for p in plans) else [])
        refs[model, layers] = _parity_reference(model, layers, opts)
    return refs


def _parity_check(refs, recs, seconds):
    """dist_parity's gates and records (``recs``: by plan, every rank's
    record)."""
    for name, model, layers, kw, opts in DIST_PLANS:
        ranks = recs[name]
        opt = ranks[0]["plan"]["optimizer"]
        ref, p0, ndims = refs[model, layers]
        loss, gnorm, want = ref[opt]
        got = ranks[0]["params"]
        value_rel = _leaf_rel(got, want)
        update_rel = _leaf_rel(got, want, base=p0)
        update_tol = PARITY_TOL if opt == "sgd" else DIST["adamw_update_tol"]
        floor = _update_floor(want, p0)
        control = _leaf_rel(p0, want, base=p0)
        rec = {"phase": "dist_parity", "plan": name, "model": model,
               "mesh": kw, **opts, "optimizer": opt, "dtype": "float32",
               "layers": layers,
               "overrides": _dist_overrides(model, layers, True),
               "tokens": [TRAIN["batch"], TRAIN["seq"]],
               "transport": "gloo, collectives and hops through host "
                            "memory",
               "seconds": seconds,
               "loss": [r["losses"][0] for r in ranks], "loss_single": loss,
               "grad_norm": [r["grad_norms"][0] for r in ranks],
               "grad_norm_single": gnorm,
               "value_rel_err": value_rel, "update_rel_err": update_rel,
               "tol": DIST["parity_tol"], "update_tol": update_tol,
               "update_floor": floor,
               "control_update_rel_err": control,
               "dropped_share_per_rank": [r["dropped_share"]
                                          for r in ranks],
               "step_ms_per_rank": [r["step_ms"][0] for r in ranks],
               "setup_ms_per_rank": [r["setup_ms"] for r in ranks],
               "gather_ms_per_rank": [r["gather_ms"] for r in ranks],
               "peak_memory_bytes_per_rank": [r["peak_bytes"] for r in ranks]}
        if opt == "adamw":
            rec["worst_update"] = _adamw_worst(got, want, p0, ndims,
                                               TRAIN["lr"])
        emit(rec)
        require(all(math.isclose(x, loss, rel_tol=DIST["parity_tol"])
                    for x in rec["loss"]) and all(
            math.isclose(x, gnorm, rel_tol=DIST["parity_tol"])
            for x in rec["grad_norm"]),
            f"{name}: loss {rec['loss']} / grad norm {rec['grad_norm']} "
            f"against the single device's {loss} / {gnorm}")
        require(max(value_rel.values()) <= DIST["parity_tol"],
                f"{name}: updated leaves against the single device's: "
                f"{value_rel}")
        require(all(e <= max(update_tol, floor[k])
                    for k, e in update_rel.items()),
                f"{name}: updates against the single device's: "
                f"{update_rel} (float32 floor {floor})")
        require(min(control.values()) > update_tol,
                f"{name}: the unchanged state passes the update check: "
                f"{control}")
        require(all(d == 0.0 for r in ranks for d in r["dropped_share"]),
                f"{name}: tokens dropped at capacity factor "
                f"{DIST['parity_factor']}: {rec['dropped_share_per_rank']}")


def _dist_want(cfg, kw, opts):
    """A full-remat step's flash launches per rank of a DIST_PLANS plan
    (fwd, partial, dq, dkv, the first four of ``dist_plans.COUNTERS``),
    the same on every stage (each holds L/pp layers). Flat: the causal
    kernel in the forward and its recompute and one dQ and dK/dV per
    layer; on the ring, the diagonal's causal partial and sp - 1
    non-causal partials per layer, twice, and no backward kernel (the
    ring's backward differentiates the plain partial). Pipelined, per
    microbatch and local layer: GPipe's forward with its graph and the
    remat recompute; 1F1B's and the interleaved clock's forward, the
    stage recompute of the backward half and the remat recompute inside
    it; one dQ and dK/dV each."""
    L = cfg.n_layers // kw.get("pp", 1)
    if kw.get("sp", 1) > 1 and kw.get("sp_mode", "ring") == "ring":
        return [2 * L, 2 * L * (kw["sp"] - 1), 0, 0]
    if kw.get("pp", 1) == 1:
        return [2 * L, 0, L, L]
    ml = opts["n_microbatches"] * L
    passes = 2 if opts.get("pipeline_schedule") == "gpipe" else 3
    return [passes * ml, 0, ml, ml]


def _stash_bound(kw, opts):
    """The most stage inputs a pipeline schedule may hold at once: 2P - 1
    under 1F1B, 2V (V = vpp·P) under the interleaved clock; GPipe holds
    every microbatch's graph (M); None without pp."""
    p = kw.get("pp", 1)
    if p == 1:
        return None
    if opts.get("pipeline_schedule") == "gpipe":
        return opts["n_microbatches"]
    if kw.get("vpp", 1) > 1 or opts.get("pipeline_schedule") == \
            "interleaved":
        return 2 * kw.get("vpp", 1) * p
    return 2 * p - 1


def _train_reference(model, layers):
    """The single-device bf16 AdamW steps at a group's depth: losses, ms
    (CUDA events) and, for MoE, the dropped share of each step."""
    cfg = get_config(model, **_dist_overrides(model, layers, False))
    tokens = _train_tokens(cfg)
    params, state = init_train_state(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    step = make_train_step(cfg, MeshPlan(), lr=TRAIN["lr"],
                           remat=TRAIN["remat"])
    out = {"losses": [], "ms": [], "dropped_share": []}
    for _ in range(DIST["train_steps"]):
        moe_module.drops = [] if cfg.is_moe else None
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        params, state, m = step(params, state, tokens,
                                torch.roll(tokens, -1, dims=1))
        ev[1].record()
        out["losses"].append(m["loss"].item())
        out["ms"].append(ev[0].elapsed_time(ev[1]))
        if moe_module.drops:
            kept = float(sum(k for _, k in moe_module.drops))
            out["dropped_share"].append(
                1.0 - kept / sum(n for n, _ in moe_module.drops))
    moe_module.drops = None
    del params, state, step, m
    free_device()
    return out


def _train_check(refs, recs, seconds):
    """dist_train's gates and records; returns rank 0's launches over all
    plans' steps, by kernel name (``dist_plans.COUNTERS``), and each
    plan's launches per step on every rank."""
    total = dict.fromkeys(dist_plans.COUNTERS, 0)
    by_plan = {}
    for name, model, layers, kw, opts in DIST_PLANS:
        ranks = recs[name]
        cfg = get_config(model, n_layers=layers)
        want = _dist_want(cfg, kw, opts)
        bound = _stash_bound(kw, opts)
        ref = refs[model, layers]
        losses = ranks[0]["losses"]
        single = ref["losses"][:len(losses)]
        div = [abs(a - b) / abs(b) for a, b in zip(losses, single)]
        held = div[:1] if cfg.is_moe else div
        rec = {"phase": "dist_train", "plan": name, "model": model,
               "mesh": kw, **opts, "optimizer": "adamw",
               "zero1": name.startswith("zero1"),
               "dtype": cfg.dtype, "layers": layers,
               "tokens": [TRAIN["batch"], TRAIN["seq"]],
               "remat": TRAIN["remat"],
               "transport": "gloo, collectives and hops through host "
                            "memory",
               "seconds": seconds, "losses": losses,
               "losses_single_device": single, "loss_rel_divergence": div,
               "step_ms_single_device": ref["ms"],
               "loss_rtol": DIST["loss_rtol"], "losses_held": len(held),
               "step_ms_per_rank": [r["step_ms"] for r in ranks],
               "setup_ms_per_rank": [r["setup_ms"] for r in ranks],
               "launches_per_step": {"counters": dist_plans.COUNTERS,
                                     "per_rank": [r["launches"]
                                                  for r in ranks]},
               "launches_want": want,
               "stage_per_rank": [r["stage"] for r in ranks],
               "stash_peak_per_rank": [r["stash_peak"] for r in ranks],
               "stash_bound": bound,
               "dropped_share_per_rank": [r["dropped_share"]
                                          for r in ranks],
               "dropped_share_single_device": ref["dropped_share"],
               "peak_memory_bytes_per_rank": [r["peak_bytes"] for r in ranks],
               "wire_bytes_per_step_by_axis": [r["traffic"] for r in ranks]}
        emit(rec)
        require(all(per[:4] == want for r in ranks for per in r["launches"]),
                f"{name}: flash launches per step per rank "
                f"{rec['launches_per_step']}, expected {want} (fwd, "
                f"partial, dq, dkv)")
        require(bound is None or all(
            0 < n <= bound for r in ranks for n in r["stash_peak"]),
            f"{name}: stage inputs stashed {rec['stash_peak_per_rank']}, "
            f"bound {bound}")
        require(all(r["losses"] == losses for r in ranks),
                f"{name}: the ranks' losses differ")
        require(max(held) <= DIST["loss_rtol"],
                f"{name}: losses {losses} against the single device's "
                f"{single}")
        for per in ranks[0]["launches"]:
            for key, n in zip(dist_plans.COUNTERS, per):
                total[key] += n
        by_plan[name] = [r["launches"] for r in ranks]
    return total, by_plan


def _leaf_paths(tree, prefix=""):
    """The "/a/b" path of every leaf of nested dicts, in ``tree_leaves``
    order (``dist_plans.sample_tree``'s sample key)."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _leaf_paths(tree[k], f"{prefix}/{k}")]
    return [prefix]


def _mesh_ckpt_bytes(cfg):
    """One checkpoint's bytes: parameters, two float32 moments (a ZeRO-1
    slice's padding aside), count and data_pos."""
    n = sum(p.numel() for p in tree_leaves(init_params(
        cfg, torch.Generator(), device="meta")))
    return n * (torch.finfo(cfg.torch_dtype).bits // 8 + 8) + 4 + 8, n


def _step_dir(path):
    steps = list_checkpoints(LocalFileSystem(), path)
    return f"{path}/step_{steps[-1]:012d}"


def _rank_file_bytes(step_dir, world):
    """Bytes of each rank's shard files in a checkpoint directory."""
    sizes = [0] * world
    for st in LocalFileSystem().list_status(step_dir):
        name = st.path.rsplit("/", 1)[-1]
        m = re.match(r"shard_r(\d+)_", name)
        if m:
            sizes[int(m.group(1))] += st.length
    return sizes


def _assembled_leaf(base, step, manifest, name):
    """One leaf of a checkpoint at its global shape, as a float32 numpy
    array (``read_global_leaf``)."""
    from hadoop_tpu_torch.parallel.checkpoint import read_global_leaf
    return read_global_leaf(LocalFileSystem(), base, step, name,
                            manifest).float().numpy()


def _sampled(arr, path, n):
    """``dist_plans.sample_tree``'s sample of one global array."""
    return arr.reshape(-1)[dist_plans._sample_index(path, arr.size, n)]


def _mesh_records(recs, op, name, which=0):
    """Every rank's record of ``name``'s ``which``-th ``op``."""
    found = [r for r in recs if (r[0]["op"], r[0]["name"]) == (op, name)]
    return found[which]


def _trainer_mesh_prepare(root):
    """The phase's token files under ``root``, after checking that its
    checkpoints fit the disk and its snapshots the host memory."""
    cfg = get_config("flagship-1b", n_layers=TRAINER_MESH["layers"])
    cfg_vpp = get_config("flagship-1b", n_layers=TRAINER_MESH["vpp_layers"])
    batch, seq = TRAIN["batch"], TRAIN["seq"]
    nbytes, n = _mesh_ckpt_bytes(cfg)
    nbytes_vpp, n_vpp = _mesh_ckpt_bytes(cfg_vpp)
    # one checkpoint on disk at a time (each plan's root goes when its
    # checks are done); the ranks' snapshots of one lie in host memory
    free_disk = shutil.disk_usage(root).free
    require(free_disk > 1.2 * nbytes_vpp,
            f"{free_disk} B free under {root}: a checkpoint of "
            f"{nbytes_vpp} B does not fit")
    mem_avail = _mem_available()
    require(mem_avail > 2 * nbytes_vpp,
            f"{mem_avail} B of host memory available for snapshots of "
            f"{nbytes_vpp} B")
    n_tokens = int(TRAINER_MESH["file_batches"] * batch * (seq + 1))
    tokens = torch.randint(0, cfg.vocab_size, (n_tokens,),
                           generator=torch.Generator().manual_seed(
                               SEED + 5))
    data = f"{root}/tokens.bin"
    LocalFileSystem().write_all(
        data, tokens.numpy().astype(np.uint16).tobytes())
    el = ELASTIC
    n_el = int(el["file_batches"] * el["batch"] * (seq + 1))
    LocalFileSystem().write_all(f"{root}/elastic.bin", torch.randint(
        0, cfg.vocab_size, (n_el,), generator=torch.Generator(
        ).manual_seed(SEED + 6)).numpy().astype(np.uint16).tobytes())
    require(free_disk > 3.2 * nbytes,
            f"{free_disk} B free under {root}: the elastic leg keeps "
            f"three checkpoints of {nbytes} B")
    return {"cfg": cfg, "cfg_vpp": cfg_vpp, "bytes": nbytes,
            "bytes_vpp": nbytes_vpp, "params": [n, n_vpp], "data": data,
            "free_disk": free_disk, "mem_avail": mem_avail}


def _trainer_mesh_check(ctx, recs, root, dist_launches, seconds, phase_t0):
    """The phase's gates and records (``recs``: per job, per op, every
    rank's record); returns rank 0's launches, by kernel name."""
    launches = dict.fromkeys(dist_plans.COUNTERS, 0)
    for job, plans in (
            (recs[0], (("c", "dp2_tp2"),
                       ("tp", "dp2_tp2"), ("z", "zero1_dp4"),
                       ("x", "dp2_tp2"))),
            (recs[1], (("v", "dp2_pp2_vpp2_interleaved"),
                       ("w", "dp2_pp2_vpp2_interleaved")))):
        _mesh_launches(job, plans, dist_launches, launches)
    _mesh_resume(recs[0], root, ctx["bytes"], seconds)
    _mesh_reshard(recs[0], root, ctx["cfg"], ctx["bytes"])
    _mesh_vpp(recs[1], root, ctx["bytes_vpp"])
    _mesh_elastic(recs[2], root, dist_launches, launches)
    _mesh_doors(recs)
    require(all(r["foreign"] == [] for r in
                _mesh_records(recs[2], "modules", None)),
            "a rank imported jax or hadoop_tpu")
    emit({"phase": "trainer_mesh", "summary": True,
          "model": "flagship-1b", "layers": [ctx["cfg"].n_layers,
                                             ctx["cfg_vpp"].n_layers],
          "params": ctx["params"],
          "checkpoint_bytes": [ctx["bytes"], ctx["bytes_vpp"]],
          "free_disk_bytes": ctx["free_disk"],
          "host_mem_available_bytes": ctx["mem_avail"],
          "launches_rank0": launches,
          "seconds": dict(seconds, phase=time.monotonic() - phase_t0)})
    return launches


def _mesh_doors(jobs):
    """Every rank's reads of its own ``/ws/v1/trainer`` after each
    "train" op (``dist_plans._scrape_trainer``): the comm block equal to
    that rank's ledger report, the step count at least the op's. Into
    FLEET: the reads' ms, and rank 0's seconds in its doors (opening,
    reads, closing)."""
    ms, added_ms = [], 0.0
    for job in jobs:
        for per_op in job:
            added_ms += per_op[0].get("door_ms", 0.0) + \
                per_op[0].get("door", {}).get("scrape_ms", 0.0)
            if per_op[0]["op"] != "train":
                continue
            for rank, rec in enumerate(per_op):
                door = rec["door"]
                ms.append(door["scrape_ms"])
                require(door["comm"] == rec["comm_report"],
                        f"trainer_mesh {rec['name']} rank {rank}: the door's "
                        f"comm block is not the rank's ledger report")
                require(door["steps"] >= rec["anatomy"]["steps"] ==
                        len(rec["launches"]),
                        f"trainer_mesh {rec['name']} rank {rank}: door "
                        f"{door['steps']} steps, op {len(rec['launches'])}")
    FLEET["trainer_mesh_ms"] = {"reads": len(ms), "mean": sum(ms) / len(ms),
                                "max": max(ms)}
    FLEET["trainer_mesh_added_s"] = added_ms / 1e3


def _mesh_regroup(recs, n_jobs):
    """``trainer_ops``' records of every rank, per job, per op."""
    return [[list(per_op) for per_op in zip(*(r[j] for r in recs))]
            for j in range(n_jobs)]


def _trainer_mesh_jobs(root, data):
    """``trainer_ops``' jobs of the phase."""
    tm = TRAINER_MESH
    tp, dp4 = {"dp": 2, "tp": 2}, {"dp": 4}
    vpp = {"dp": 2, "pp": 2, "vpp": 2}

    def make(name, plan, ckpt, **kw):
        return {"op": "make", "name": name, "plan": plan,
                "ckpt": f"{root}/{ckpt}", "kw": kw}

    def op(kind, name, **kw):
        return dict(kw, op=kind, name=name)

    n = tm["sample"]
    # "c" is the uninterrupted curve too: its steps past the crash point
    # run with no save, so the checkpoint on disk is the one in flight
    # when the crash came
    flat = [make("c", tp, "tp", ckpt_interval=tm["interval"], keep=1),
            op("train", "c", steps=tm["crash_at"]),
            op("train", "c", steps=tm["steps"] - tm["crash_at"],
               ckpt_interval=0), op("crash", "c"),
            make("tp", tp, "tp", ckpt_interval=0, keep=1),
            op("restore", "tp"),
            op("train", "tp", steps=tm["steps"] - tm["interval"]),
            op("crash", "tp"),
            make("z", dp4, "z1", zero1=True, ckpt_interval=0, keep=1),
            op("train", "z", steps=tm["z1_steps"]), op("save", "z"),
            op("gather", "z", sample=n), op("train", "z", steps=1),
            op("crash", "z"),
            make("x", tp, "z1", ckpt_interval=0, keep=1),
            op("restore", "x"), op("gather", "x", sample=n),
            op("gather", "x", which="mu", sample=n),
            op("gather", "x", which="nu", sample=n),
            op("train", "x", steps=1), op("crash", "x")]
    interleaved = [
        make("v", vpp, "vpp", ckpt_interval=0, keep=1, n_microbatches=2,
             pipeline_schedule="interleaved"),
        op("train", "v", steps=tm["vpp_steps"]), op("save", "v"),
        op("gather", "v", sample=n), op("train", "v", steps=1),
        op("crash", "v"),
        make("w", vpp, "vpp", ckpt_interval=0, keep=1, n_microbatches=2,
             pipeline_schedule="interleaved"),
        op("restore", "w"), op("train", "w", steps=1), op("crash", "w")]
    jobs = [{"preset": "flagship-1b", "overrides": {"n_layers": layers},
             "data": data, "device": "cuda", "seed": SEED,
             "telemetry": True,
             "trainer": {"batch": TRAIN["batch"], "lr": TRAIN["lr"],
                         "remat": TRAIN["remat"]}, "ops": ops}
            for layers, ops in ((tm["layers"], flat),
                                (tm["vpp_layers"], interleaved))]
    jobs.append(_elastic_job(root))
    return jobs


def _elastic_job(root):
    """The elastic leg's job (see ELASTIC): the elastic trainer, then its
    twin restoring the protective snapshot, linked into a directory of
    its own."""
    el = ELASTIC
    feed = {"n": DIST["world"], "job": "chip-smoke-elastic",
            "flag": [[2, el["flag_at"]]], "dead": [[2, el["dead_at"]]]}
    protective = el["flag_at"] + 1
    base = {"op": "make", "plan": {"dp": 4}, "ckpt": f"{root}/elastic"}
    return {
        "preset": "flagship-1b", "overrides": {"n_layers": el["layers"]},
        "data": f"{root}/elastic.bin", "device": "cuda", "seed": SEED,
        "telemetry": True,
        "trainer": {"batch": el["batch"], "lr": TRAIN["lr"],
                    "remat": TRAIN["remat"]},
        "ops": [dict(base, name="e", feed=feed, kw={
                    "zero1": True, "ckpt_interval": el["interval"],
                    "keep": 3, "elastic": el["config"]}),
                {"op": "train", "name": "e", "steps": el["steps"]},
                {"op": "crash", "name": "e"},
                {"op": "link", "name": None, "src": f"{root}/elastic",
                 "step": protective, "dst": f"{root}/twin"},
                dict(base, name="twin", ckpt=f"{root}/twin",
                     kw={"zero1": True, "ckpt_interval": 0, "keep": 3}),
                {"op": "restore", "name": "twin"},
                {"op": "train", "name": "twin",
                 "steps": el["steps"] - protective},
                {"op": "crash", "name": "twin"}]}


def _mesh_elastic(job, root, dist_launches, total):
    """The elastic leg (see ELASTIC): one demote, one evict and one
    restoring resume on every surviving rank, ending at dp3 at the
    target step with fewer lost steps than a restart from the last
    interval save; the loss curve accepted by ``loss_curve_report``
    against the twin's and each step after the reshard within
    ``step_rtol`` of it; the flash launches of every rank-step exact at
    both rank shapes; the evicted rank stops at the evict."""
    el = ELASTIC
    runs = _mesh_records(job, "train", "e")
    twin = _mesh_records(job, "train", "twin")
    restored = _mesh_records(job, "restore", "twin")
    survivors, evicted = [0, 1, 3], 2
    lead = runs[0]
    events = lead["events"]
    kinds = [e["decision"] for e in events]
    evict = next((e for e in events if e["decision"] == "evict"), {})
    resume = next((e for e in events if e["decision"] == "resume"), {})
    protective = el["flag_at"] + 1
    evict_at = evict.get("step", -1)
    baseline = evict_at - (evict_at // el["interval"]) * el["interval"]
    twin_curve = [lead["loss_by_step"][s] for s in range(1, protective + 1)
                  ] + twin[0]["losses"]
    curve = [lead["loss_by_step"][s] for s in range(1, el["steps"] + 1)]
    guard = loss_curve_report(twin_curve, curve,
                              rel_tol=el["guard_rel_tol"])
    after = [abs(a - b) / abs(b) for a, b in zip(curve[protective:],
                                                  twin_curve[protective:])]
    # flash launches a rank-step (dist_plans.COUNTERS' first four): the
    # forward and its full-remat recompute, no partial, dQ and dK/dV,
    # one a layer each
    want_flash = [2 * el["layers"], 0, el["layers"], el["layers"]]
    flash_at = {}
    for rank, rec in enumerate(runs + twin):
        for dp, per in zip(rec["step_dp"], rec["launches"]):
            flash_at.setdefault(dp, set()).add(tuple(per[:4]))
    zero1 = dist_launches["zero1_dp4"][0][0]
    for per in lead["launches"] + twin[0]["launches"]:
        for key, n in zip(dist_plans.COUNTERS, per):
            total[key] += n
    shape = {4: [el["batch"] // 4, TRAIN["seq"], 16, 8, 128],
             3: [el["batch"] // 3, TRAIN["seq"], 16, 8, 128]}
    step_ms = {dp: [ms for r in survivors for d, ms in
                    zip(runs[r]["step_dp"], runs[r]["step_ms"]) if d == dp]
               for dp in (4, 3)}
    ck = {r: runs[r]["anatomy"].get("ckpt", runs[r]["anatomy"])
          for r in range(DIST["world"])}
    emit({"phase": "trainer_mesh", "plan": "elastic_zero1_dp4_to_dp3",
          "model": "flagship-1b", "layers": el["layers"],
          "dtype": "bfloat16", "tokens": [el["batch"], TRAIN["seq"]],
          "remat": TRAIN["remat"], "optimizer": "adamw", "zero1": True,
          "config": el["config"], "events": events,
          "evicted_rank_events": runs[evicted]["events"],
          "plan_final": lead["plan"], "step_final": lead["step"],
          "lost_steps": resume.get("lost_steps"),
          "lost_steps_baseline": baseline,
          "resume_seconds_per_rank": [runs[r]["resume_seconds"]
                                      for r in survivors],
          "losses_elastic": curve, "losses_twin": twin_curve,
          "step_rel_err_after_reshard": after,
          "step_rtol": el["step_rtol"], "guard": guard,
          "rank_shapes": shape, "flash_launches_per_rank_step": {
              dp: sorted(v) for dp, v in flash_at.items()},
          "launches_zero1_dp4_dist_train": zero1,
          "step_ms_per_rank_step": {dp: v for dp, v in step_ms.items()},
          "twin_restore_ms_per_rank": [r["ms"] for r in restored],
          "ckpt_ms_per_rank": {r: {k: {"count": v["num_ops"],
                                       "mean_ms": v["avg_time"] * 1e3}
                                   for k, v in c.items()}
                               for r, c in ck.items()},
          "checkpoints_on_disk": list_checkpoints(LocalFileSystem(),
                                                  f"{root}/elastic"),
          "peak_memory_bytes_per_rank": [r.get("peak_bytes", 0)
                                         for r in runs],
          "evicted_rank_steps": len(runs[evicted]["launches"])})
    require(all(runs[r]["events"] == events for r in survivors),
            "the surviving ranks took different decisions")
    require(kinds == ["demote", "evict", "resume"] and resume.get(
        "restored"), f"elastic decisions {kinds}")
    _mesh_elastic_doors(runs, evicted)
    require(lead["plan"]["dp"] == 3 and all(
        runs[r]["step"] == el["steps"] for r in survivors),
        f"elastic run ended at {lead['plan']} step {lead['step']}")
    require(resume.get("lost_steps", baseline) < baseline,
            f"lost {resume.get('lost_steps')} steps, a restart "
            f"{baseline}")
    require(evict_at // el["interval"] * el["interval"] in
            list_checkpoints(LocalFileSystem(), f"{root}/elastic"),
            "the restart baseline's interval checkpoint is missing")
    require(bool(guard.get("accepted")), f"loss-curve guard: {guard}")
    require(all(e <= el["step_rtol"] for e in after),
            f"steps after the reshard against the twin: {after}")
    require(all(r["restored"] and r["step"] == protective
                for r in restored), "the twin did not restore")
    require(set(flash_at) == {3, 4} and all(
        v == {tuple(want_flash)} for v in flash_at.values()),
        f"flash launches a rank-step {flash_at}, want {want_flash}")
    ev = runs[evicted]
    require(ev["left_mesh"] and ev["step"] == evict_at and
            len(ev["launches"]) == evict_at and
            ev["events"][-1]["decision"] == "leave",
            f"the evicted rank ran on: step {ev['step']}, "
            f"{len(ev['launches'])} steps")
    for run in ("elastic", "twin"):
        shutil.rmtree(f"{root}/{run}", ignore_errors=True)


def _mesh_elastic_doors(runs, evicted):
    """Each rank's door carries its controller's decisions: the evict of
    ``evicted`` and, on the survivors, the shrink to dp3."""
    for rank, rec in enumerate(runs):
        block = rec["door"]["elastic"]
        decisions = [e["decision"] for e in block["events"]]
        require(block["evicted_ranks"] == [f"rank-{evicted}"] and
                "evict" in decisions,
                f"rank {rank}'s door elastic block: {decisions}, "
                f"{block['evicted_ranks']}")
        require(rank == evicted or (block["plan"]["dp"] == 3 and
                                    "resume" in decisions),
                f"rank {rank}'s door plan {block['plan']}")


def _mesh_launches(job, plans, dist_launches, total):
    """Each rank-step's launches against dist_train's for the plan (its
    first step on the same rank); rank 0's summed into ``total``."""
    for name, plan in plans:
        want = dist_launches[plan]
        for recs in (r for r in job if r[0]["op"] == "train" and
                     r[0]["name"] == name):
            for rank, rec in enumerate(recs):
                require(all(per == want[rank][0] for per in
                            rec["launches"]),
                        f"trainer_mesh {name}: launches {rec['launches']} "
                        f"on rank {rank}, dist_train's {plan}: "
                        f"{want[rank][0]} ({dist_plans.COUNTERS})")
            for per in recs[0]["launches"]:
                for key, n in zip(dist_plans.COUNTERS, per):
                    total[key] += n


def _mesh_plan_record(plan, recs_by_op, extra):
    """One plan's line: per trainer and rank, step ms (CUDA events),
    restore ms, the checkpoint anatomy (snapshot, write, fence ms), peak
    memory, and per step the comm ledger's bytes by site beside the wire
    bytes by axis."""
    world = range(DIST["world"])
    trainers = {}
    for op, recs in recs_by_op:
        t = trainers.setdefault(recs[0]["name"], {})
        t.setdefault("peak_memory_bytes_per_rank", [0] * DIST["world"])
        for i in world:
            t["peak_memory_bytes_per_rank"][i] = max(
                t["peak_memory_bytes_per_rank"][i],
                recs[i].get("peak_bytes", 0))
        if op == "restore":
            t["restore_ms_per_rank"] = [r["ms"] for r in recs]
        if op == "train":
            t.setdefault("step_ms_per_rank", [[] for _ in world])
            for i in world:
                t["step_ms_per_rank"][i] += recs[i].get("step_ms", [])
            t["comm_bytes_per_step_by_site_per_rank"] = [
                r["comm"] for r in recs]
            t["wire_bytes_per_step_by_axis_per_rank"] = [
                r["traffic"] for r in recs]
        if op in ("train", "save"):
            ck = recs[0]["anatomy"]
            ck = ck.get("ckpt", ck)
            if any(v["num_ops"] for v in ck.values()):
                t["ckpt_ms_per_rank"] = [
                    {k: {"count": v["num_ops"],
                         "mean_ms": v["avg_time"] * 1e3}
                     for k, v in r["anatomy"].get("ckpt",
                                                  r["anatomy"]).items()}
                    for r in recs]
    rec = {"phase": "trainer_mesh", "plan": plan, "model": "flagship-1b",
           "dtype": "bfloat16", "tokens": [TRAIN["batch"], TRAIN["seq"]],
           "remat": TRAIN["remat"], "optimizer": "adamw",
           "transport": "gloo, collectives and hops through host memory",
           "trainers": trainers}
    rec.update(extra)
    return rec


def _ops_of(job, *names):
    return [(r[0]["op"], r) for r in job if r[0]["name"] in names]


def _mesh_resume(job, root, ckpt_bytes, seconds):
    """dp2×tp2: the uninterrupted curve (the crashed run's steps, then
    its steps past the crash point with no save) the same on every rank,
    the resumed steps bit-equal to it."""
    tm = TRAINER_MESH
    crashed = _mesh_records(job, "train", "c")
    past = _mesh_records(job, "train", "c", 1)
    full = [{"losses": a["losses"] + b["losses"]}
            for a, b in zip(crashed, past)]
    resumed = _mesh_records(job, "train", "tp")
    restored = _mesh_records(job, "restore", "tp")
    step_dir = _step_dir(f"{root}/tp")
    written = _rank_file_bytes(step_dir, DIST["world"])
    losses = full[0]["losses"]
    emit(_mesh_plan_record("dp2_tp2", _ops_of(job, "c", "tp"), {
        "losses_uninterrupted": losses,
        "losses_crashed": crashed[0]["losses"],
        "losses_resumed": resumed[0]["losses"],
        "resumed_bit_equal": all(r["losses"] == losses[tm["interval"]:]
                                 for r in resumed),
        "checkpoint_bytes_written_per_rank": written,
        "checkpoint_bytes": ckpt_bytes, "seconds": seconds}))
    require(all(r["restored"] and r["step"] == tm["interval"]
                for r in restored), "the resume found no step-2 checkpoint")
    require(all(math.isfinite(x) for x in losses), "non-finite loss")
    require(len(losses) == tm["steps"] and
            all(r["losses"] == losses for r in full),
            "the ranks' losses left the curve")
    require(all(r["losses"] == losses[tm["interval"]:] for r in resumed),
            f"resumed losses {[r['losses'] for r in resumed]} against "
            f"{losses[tm['interval']:]}")
    require(sum(written) == ckpt_bytes,
            f"checkpoint shards {written} B, expected {ckpt_bytes} in all")
    shutil.rmtree(f"{root}/tp", ignore_errors=True)


def _mesh_reshard(job, root, cfg, ckpt_bytes):
    """ZeRO-1 dp4 → dp2×tp2: the parameters bit-equal to the saved ones,
    the moments to ``zero1_state_to_global`` of the saved slices (on
    samples), the next step within dist_parity's tolerance of the ZeRO-1
    run's own."""
    from hadoop_tpu_torch.parallel.checkpoint import read_manifest
    from hadoop_tpu_torch.parallel.elastic.reshard import \
        zero1_state_to_global
    from hadoop_tpu_torch.parallel.mesh import param_specs
    n = TRAINER_MESH["sample"]
    z_train = [r for op, r in _ops_of(job, "z") if op == "train"]
    step3_z1 = z_train[1][0]["losses"][0]
    step3_x = _mesh_records(job, "train", "x")
    saved = _mesh_records(job, "gather", "z")[0]["params"]
    got = _mesh_records(job, "gather", "x")[0]["params"]
    step_dir = _step_dir(f"{root}/z1")
    written = _rank_file_bytes(step_dir, DIST["world"])
    step = int(step_dir.rsplit("_", 1)[-1])
    manifest = read_manifest(LocalFileSystem(), f"{root}/z1", step)
    param_err = max(float(np.abs(a - b).max()) for a, b in zip(
        tree_leaves(got), tree_leaves(saved)))
    specs = param_specs(cfg, MeshPlan(dp=4))
    moment_err = 0.0
    for which in ("mu", "nu"):
        mine = _mesh_records(job, "gather", "x", 1 + (which == "nu"))[0][
            which]
        for path, spec, leaf in zip(_leaf_paths(mine), tree_leaves(specs),
                                    tree_leaves(mine)):
            key = "".join(f"[{k!r}]" for k in path.split("/")[1:])
            g = zero1_state_to_global(
                _assembled_leaf(f"{root}/z1", step, manifest,
                                f"['opt'].{which}{key}"),
                spec, manifest["leaves"][f"['params']{key}"]["shape"],
                MeshPlan(dp=4))
            moment_err = max(moment_err, float(np.abs(
                _sampled(g, path, n) - leaf).max()))
            del g
    rel = abs(step3_x[0]["losses"][0] - step3_z1) / abs(step3_z1)
    emit(_mesh_plan_record("zero1_dp4_to_dp2_tp2", _ops_of(job, "z", "x"), {
        "losses_zero1_dp4": [x for r in z_train for x in r[0]["losses"]],
        "loss_step3_restored_dp2_tp2": step3_x[0]["losses"][0],
        "loss_rel_err": rel, "loss_rtol": DIST["parity_tol"],
        "param_sample_max_abs_err": param_err,
        "moment_sample_max_abs_err": moment_err,
        "checkpoint_bytes_written_per_rank": written,
        "checkpoint_zero1_bytes": ckpt_bytes}))
    require(all(r["restored"] and r["step"] == TRAINER_MESH["z1_steps"]
                for r in _mesh_records(job, "restore", "x")),
            "the dp2×tp2 trainer did not restore the ZeRO-1 checkpoint")
    require(param_err == 0.0 and moment_err == 0.0,
            f"resharded state: parameters {param_err}, moments "
            f"{moment_err} from the saved ones")
    require(all(math.isfinite(r["losses"][0]) and
                r["losses"] == step3_x[0]["losses"] for r in step3_x),
            "the restored step's losses")
    require(rel <= DIST["parity_tol"],
            f"step 3 after the reshard {step3_x[0]['losses'][0]} against "
            f"the ZeRO-1 run's {step3_z1}")
    shutil.rmtree(f"{root}/z1", ignore_errors=True)


def _mesh_vpp(job, root, ckpt_bytes):
    """dp2×pp2×vpp2: the restored step bit-equal to the uninterrupted
    one, and the checkpoint's layer leaves the live parameters in
    logical order (on samples)."""
    from hadoop_tpu_torch.parallel.checkpoint import read_manifest
    n = TRAINER_MESH["sample"]
    v_train = [r for op, r in _ops_of(job, "v") if op == "train"]
    step3 = v_train[1]
    resumed = _mesh_records(job, "train", "w")
    live = _mesh_records(job, "gather", "v")[0]["params"]
    step_dir = _step_dir(f"{root}/vpp")
    written = _rank_file_bytes(step_dir, DIST["world"])
    step = int(step_dir.rsplit("_", 1)[-1])
    manifest = read_manifest(LocalFileSystem(), f"{root}/vpp", step)
    layer_err = 0.0
    for path, leaf in zip(_leaf_paths(live), tree_leaves(live)):
        if not path.startswith("/layers/"):
            continue
        key = "".join(f"[{k!r}]" for k in path.split("/")[1:])
        arr = _assembled_leaf(f"{root}/vpp", step, manifest,
                              f"['params']{key}")
        layer_err = max(layer_err, float(np.abs(
            _sampled(arr, path, n) - leaf).max()))
    emit(_mesh_plan_record("dp2_pp2_vpp2_interleaved",
                           _ops_of(job, "v", "w"), {
        "n_microbatches": 2, "losses": [x for r in v_train
                                        for x in r[0]["losses"]],
        "loss_step3_resumed": resumed[0]["losses"],
        "resumed_bit_equal": all(r["losses"] == s["losses"] for r, s in
                                 zip(resumed, step3)),
        "layers_logical_sample_max_abs_err": layer_err,
        "checkpoint_bytes_written_per_rank": written,
        "checkpoint_bytes": ckpt_bytes}))
    require(all(r["restored"] and r["step"] == TRAINER_MESH["vpp_steps"]
                for r in _mesh_records(job, "restore", "w")),
            "the vpp trainer did not restore")
    require(all(r["losses"] == s["losses"] for r, s in zip(resumed, step3)),
            f"vpp resumed step {[r['losses'] for r in resumed]} against "
            f"{[s['losses'] for s in step3]}")
    require(layer_err == 0.0, f"the checkpoint's layer leaves are not the "
            f"live parameters in logical order: {layer_err}")
    require(sum(written) == ckpt_bytes,
            f"checkpoint shards {written} B, expected {ckpt_bytes} in all")
    shutil.rmtree(f"{root}/vpp", ignore_errors=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_build()
    record = phase_kernel()
    bwd = phase_backward()
    partial = phase_partial()
    adamw = phase_adamw()
    dequant = phase_dequant()
    rms = phase_rmsnorm()
    ec = phase_ec()
    phase_shuffle()
    phase_dist_shapes()
    # the dist phases before the rest: four ranks' trees share the card
    # with this process, which holds least now
    by_stage = phase_dist_world(smi=smi)
    tp_launches, dist_launches, mesh_launches, relaxed_launches = (
        by_stage[s] for s in ("tp_serving", "dist_train", "trainer_mesh",
                              "relaxed"))
    phase_ring()
    (_, train_dq, train_dkv, train_adamw, train_grad_sq, _,
     train_norm_bwd), train_rec = phase_train()
    fs, root = LocalFileSystem(), tempfile.mkdtemp(prefix="htpu-trainer-")
    try:
        trainer_launches, host = phase_trainer(train_rec, fs, root)
        phase_loader(fs, root, host)
        del host
        phase_door(fs, root)
        phase_kvtiers(fs, root)
        phase_fleet_front(fs, root)
        phase_weightplane(fs, root)
        dfs_launches, dfs_rec = phase_dfs_daemons(smi)
        ha_launches = phase_dfs_ha(smi, dfs_rec)
        del dfs_rec
    finally:
        shutil.rmtree(root, ignore_errors=True)
    cfg32, p32, cfg16, p16 = make_params()
    fwd_launches = phase_forward(cfg32, p32, cfg16, p16)
    phase_forward_fp16(cfg32, p32)
    phase_serving(cfg32, p32, cfg16, p16)
    phase_speculate(cfg32, p32, cfg16, p16)
    phase_parity(cfg32, p32)
    phase_longctx_exact(cfg32, p32)
    phase_longctx_decode_flagship(cfg32, p32)
    del cfg32, p32, cfg16, p16          # free flagship-1b for llama3-8b
    free_device()
    (_, cp_partial), cp_ms, uly_launches = phase_longctx()
    int8_launches, _, _ = phase_longctx(int8=True, bf16_ms=cp_ms)
    norm_launches, dequant_launches = phase_longctx_decode()
    phase_moe()
    moe_train_launches = phase_moe_train()
    moe_trainer_launches = phase_moe_trainer()
    source_fwd = "hadoop_tpu_torch/ops/csrc/flash_fwd.cu"
    source_bwd = "hadoop_tpu_torch/ops/csrc/flash_bwd.cu"
    # launches: on each kernel's path of an earlier slice (the forward,
    # the train phase's 7 steps, one CP prefill); for this slice's
    # kernels: the longctx_decode phase's llama3-8b request (RMSNorm's
    # forward in the bf16 run, the dequantize in the int8 run: the CP
    # prefill's, then the decoder's warm-up and capture of its CUDA
    # graphs, whose replays launch them uncounted) and the train phase's
    # 7 steps (RMSNorm's backward); launches_trainer: the trainer phase's
    # 12 steps through Trainer; launches_longctx_int8: one 8192-token CP
    # prefill on the int8 plane; launches_moe_train: the moe_train phase's
    # 6 mixtral-8x7b steps; launches_moe_trainer: the moe_trainer phase's
    # 12 steps through Trainer; ec_gf256's launches: the ec phase's
    # encode_cells and decode_cells calls on its three block groups;
    # launches_ulysses: the 8192-token Ulysses prefill's; launches_dist:
    # rank 0's over dist_train's eleven plans of two steps;
    # launches_trainer_mesh: rank 0's over the trainer_mesh phase's steps
    # (the elastic leg's, its twin's and its re-run steps among them);
    # launches_tp_serving: rank 0's over the tp_serving phase's six legs
    # (RMSNorm's forward, and the dequantize of the int8 leg);
    # launches_relaxed: rank 0's over the relaxed stage (its legs' bitwise
    # and relaxed arms and the codec-check steps)
    FLEET["added_s"] = sum(v for k, v in FLEET.items()
                           if k.endswith("_added_s"))
    emit({"fleet": FLEET})
    train_names = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "adamw",
                   "grad_sq", "rms_norm_fwd", "rms_norm_bwd")
    by_trainer = dict(zip(train_names, trainer_launches))
    by_moe_train = dict(zip(train_names, moe_train_launches))
    by_moe_trainer = dict(zip(train_names, moe_trainer_launches))
    by_int8 = dict(zip(("flash_fwd", "flash_fwd_partial"), int8_launches))
    by_ulysses = dict(zip(("flash_fwd", "flash_fwd_partial"), uly_launches))
    emit({"kernels": [dict(rec, launches_trainer=by_trainer.get(
        rec["name"], 0), launches_longctx_int8=by_int8.get(rec["name"], 0),
        launches_moe_train=by_moe_train.get(rec["name"], 0),
        launches_moe_trainer=by_moe_trainer.get(rec["name"], 0),
        launches_ulysses=by_ulysses.get(rec["name"], 0),
        launches_dist=dist_launches.get(rec["name"], 0),
        launches_trainer_mesh=mesh_launches.get(rec["name"], 0),
        launches_tp_serving=tp_launches.get(rec["name"], 0),
        launches_relaxed=relaxed_launches.get(rec["name"], 0),
        launches_dfs_daemons=dfs_launches.get(rec["name"], 0),
        launches_dfs_ha=ha_launches.get(rec["name"], 0))
        for rec in [{
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
                              ("grad_sq", 56, train_grad_sq))] + [{
            "name": "dequant_int8", "route": "cuda",
            "source": "hadoop_tpu_torch/ops/csrc/dequant.cu",
            "replaces": "hadoop_tpu/serving/weightplane.py:461",
            "launches": dequant_launches,
            "max_abs_err": dequant["max_abs_err"], "ms": dequant["ms"],
            "plain_ms": dequant["plain_ms"], "bound_ms": dequant["bound_ms"],
            "bound_by": dequant["bound_by"], "library_ms": None}] + [{
            "name": f"rms_norm_{key}", "route": "cuda",
            "source": "hadoop_tpu_torch/ops/csrc/rmsnorm.cu",
            "replaces": "hadoop_tpu/ops/norms.py:12",
            "launches": n, "max_abs_err": rms[key]["max_abs_err"],
            "ms": rms[key]["ms"], "plain_ms": rms[key]["plain_ms"],
            "bound_ms": rms[key]["bound_ms"],
            "bound_by": rms[key]["bound_by"],
            "library_ms": rms[key]["library_ms"]}
        for key, n in (("fwd", norm_launches), ("bwd", train_norm_bwd))] + [{
            "name": "ec_gf256", "route": "cuda",
            "source": "hadoop_tpu_torch/ops/csrc/ec_gf256.cu",
            "replaces": "hadoop_tpu/ops/ec_device.py:63",
            "launches": ec["launches"], "max_abs_err": ec["max_abs_err"],
            "ms": ec["ms"], "plain_ms": ec["plain_ms"],
            "bound_ms": ec["bound_ms"], "bound_by": ec["bound_by"],
            "library_ms": None}]]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
