"""Where the time goes on the GPU: flagship-1b forward, decode and
training steps, and the llama3-8b context-parallel prefill.

    python -m hadoop_tpu_torch.tools.profile_flagship [--train | --train-moe |
        --longctx | --longctx-decode]

Traces, with ``torch.profiler``, (a) three flagship-1b bf16 forwards at
[1, 512] tokens and (b) ten decode-only ``DecodeEngine`` steps with four
running lanes (block 16, context 1024), as the engine runs them (each a
replay of its CUDA graph) and then op by op (the engine's eager twin);
with ``--train`` instead, three flagship-1b training steps at
``chip_smoke.py``'s configuration (bf16, batch 4, seq 2048, full remat,
AdamW), with each step's device time split by the step's own
``record_function`` ranges (forward, loss, optimizer; the backward runs
on autograd's thread, so it is split by autograd node) and the kernels
that took the most of each; with ``--train-moe`` instead, three
training steps of mixtral-8x7b at ``chip_smoke.py``'s moe_train
configuration (full width, 2 of its 32 layers, bf16, [1, 4096], full
remat, AdamW), split the same way and by the MoE MLP's ranges
"moe.route" (routing, dispatch and combine einsums: the combine's in
float32) and "moe.experts" (the experts' GEMMs), in the forward and its
recompute; with ``--longctx`` instead,
one ``ContextParallelPrefiller.cp_prefill`` of an 8192-token prompt on
llama3-8b (bf16, full width and depth, sp 4 ranks on the one card, block
16), after one untraced prefill; with ``--longctx-decode`` instead, one
token of the working-set decoder's pipelined path over an 8192-token
llama3-8b chain (bf16; the chain prefilled at sp 4 and ingested into a
page-locked host ring), after one untraced token, and then the
host-to-device rate of its slab copies from page-locked and from
pageable memory. For each it prints one JSON line:
host wall time per call, the summed device time of the CUDA kernels per
call (copies included; ``memcpy_htod_ms`` is their host-to-device
part), the device's idle share (1 - device / wall), the kernels the
device ran and the runtime-API launch calls the host made per call (a
graph replay is one launch call for all of its kernels; cuBLAS launches
through the driver API, which the trace does not list), the kernels
that took the most device time and every flash kernel with its launches
per call.
Weights are random from a fixed seed. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from hadoop_tpu_torch import (DecodeEngine, SamplingParams, forward,
                              get_config, init_params, init_train_state,
                              make_train_step)
from hadoop_tpu_torch.ops import flash
from hadoop_tpu_torch.serving.longctx import ContextParallelPrefiller


# the runtime calls by which the host starts work on the device
_LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
                 "cuGraphLaunch")
TRAIN_RANGES = ("forward", "loss", "backward", "optimizer")
MOE_RANGES = ("moe.route", "moe.experts")
# chip_smoke.py's moe_train model: mixtral-8x7b at full width, cut to 2 of
# its 32 layers and to 4096 tokens of context
MOE_TRAIN_MODEL = dict(name="mixtral-8x7b", n_layers=2, max_seq=4096)


def _kernels_under(evt):
    """Every device kernel launched under a profiled CPU event."""
    found = list(evt.kernels)
    for child in evt.cpu_children:
        found += _kernels_under(child)
    return found


_NODE = "autograd::engine::evaluate_function: "


def _tally(groups, calls: int, n: int):
    """The ``n`` groups of kernels [(name, kernels)] with the most device
    time: ms and kernel count per call."""
    rows = [(name, sum(k.duration for k in ks) / 1e3 / calls,
             len(ks) // calls) for name, ks in groups]
    return [{"name": name[:80], "ms": ms, "count": count}
            for name, ms, count in sorted(rows, key=lambda r: -r[1])[:n]]


def _by_range(prof, averages, names, calls: int):
    """Per ``record_function`` range of ``names``: its span on the device
    (ms per call, kineto's device-side copy of the range), and the
    kernels of the ops run under it (on any thread: a range entered in
    the backward's recompute counts too), in all (``kernel_ms``) and by
    kernel.
    The backward's ops run on autograd's device thread, outside the
    caller's range: they are tallied by autograd node, with the kernels
    each node's evaluation launched (the recomputed forward included)."""
    out = {name: {"device_span_ms": sum(
        e.self_device_time_total for e in averages
        if e.device_type == DeviceType.CUDA and e.key == name) / 1e3 / calls}
        for name in names}
    for name in names:
        kernels = [k for e in prof.events() if e.name == name
                   for k in _kernels_under(e)]
        by_kernel = {}
        for k in kernels:
            by_kernel.setdefault(k.name, []).append(k)
        out[name]["kernel_ms"] = sum(k.duration for k in kernels) / 1e3 \
            / calls
        out[name]["aten_kernels"] = _tally(by_kernel.items(), calls, 6)
    by_node = {}
    for e in prof.events():
        if e.name.startswith(_NODE):
            by_node.setdefault(e.name[len(_NODE):], []).extend(
                _kernels_under(e))
    out["backward_by_autograd_node"] = _tally(by_node.items(), calls, 12)
    return out


def trace(fn, calls: int, label: str, ranges=()) -> dict:
    """Profile ``calls`` calls of ``fn`` after one untraced call; print
    and return the JSON record described in the module docstring."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    averages = prof.key_averages()
    # device-side copies of record_function ranges are spans, not kernels
    kernels = [e for e in averages if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and e.key not in ranges]
    device_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    wall_ms = wall * 1e3 / calls
    device_ms = device_us / 1e3 / calls

    def rows(events):
        return [{"kernel": e.key[:80], "ms": e.self_device_time_total
                 / 1e3 / calls, "count": e.count // calls} for e in events]

    copies = [e for e in kernels if e.key.startswith("Memcpy HtoD")]
    record = {
        "profile": label, "calls": calls, "wall_ms": wall_ms,
        "device_ms": device_ms,
        "memcpy_htod_ms": sum(e.self_device_time_total for e in copies)
        / 1e3 / calls,
        "idle_share": 1.0 - device_ms / wall_ms if wall_ms else None,
        "kernel_launches": sum(e.count for e in kernels) // calls,
        "host_launch_calls": sum(
            e.count for e in averages if e.device_type == DeviceType.CPU
            and e.key.startswith(_LAUNCH_CALLS)) // calls,
        "top": rows(top),
        "flash": rows(e for e in kernels if "flash" in e.key),
    }
    if ranges:
        record["ranges"] = _by_range(prof, averages, ranges, calls)
    print(json.dumps(record), flush=True)
    return record


def moe_train_config():
    """The moe_train model's config (``MOE_TRAIN_MODEL``)."""
    kw = dict(MOE_TRAIN_MODEL)
    return get_config(kw.pop("name"), **kw)


def train_profile(cfg, params, opt, tokens, calls: int, label: str,
                  ranges=TRAIN_RANGES) -> dict:
    """Trace ``calls`` full-remat AdamW steps of ``cfg`` on ``tokens``
    (targets: the tokens shifted by one), after one untraced step; the
    parameters and moments are updated in place."""
    targets = torch.roll(tokens, -1, dims=1)
    step = make_train_step(cfg, remat="full")
    state = {"params": params, "opt": opt}

    def one():
        state["params"], state["opt"], _ = step(state["params"],
                                                state["opt"], tokens, targets)

    return trace(one, calls, label, ranges)


def _train(cfg, gen, batch, seq, label, ranges=TRAIN_RANGES) -> None:
    params, opt = init_train_state(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device="cuda")
    train_profile(cfg, params, opt, tokens, 3, f"train step {label} bf16 "
                  f"[{batch},{seq}] remat full adamw", ranges)


def _longctx(gen) -> None:
    cfg = get_config("llama3-8b")
    params = init_params(cfg, gen)
    prompt = torch.randint(0, cfg.vocab_size, (cfg.max_seq,), generator=gen,
                           device="cuda").tolist()
    pre = ContextParallelPrefiller(params, cfg, block_size=16,
                                   pad_tokens=cfg.max_seq, sp=4)
    flash.launches = flash.launches_partial = 0
    trace(lambda: pre.cp_prefill(prompt), 1,
           "cp_prefill llama3-8b bf16 8192 tokens sp 4 block 16")
    # the warm-up and the traced call: two prefills
    print(json.dumps({"flash_launches_per_prefill": {
        "causal": flash.launches // 2,
        "partial": flash.launches_partial // 2}}))


def _longctx_decode(gen) -> None:
    """One token of the working-set decoder's pipelined path on llama3-8b
    (bf16, an 8192-token chain in a page-locked host ring), traced; then
    the host-to-device rate of the slab copies alone (page-locked) and of
    the same bytes from pageable memory."""
    from hadoop_tpu_torch.serving.engine import SamplingParams as SP
    from hadoop_tpu_torch.serving.engine import _to_host
    from hadoop_tpu_torch.serving.longctx.decode import WorkingSetDecoder
    from hadoop_tpu_torch.serving.kvstore import BlockPool, TieredKVCache
    cfg = get_config("llama3-8b", max_seq=8192 + 128)
    params = init_params(cfg, gen)
    prompt = torch.randint(0, cfg.vocab_size, (8192,), generator=gen,
                           device="cuda").tolist()
    pre = ContextParallelPrefiller(params, cfg, block_size=16,
                                   pad_tokens=8192, sp=4)
    res = pre.cp_prefill(prompt)
    block_bytes = 2 * cfg.n_layers * 16 * cfg.n_kv_heads * cfg.head_dim * 2
    store = TieredKVCache(BlockPool(2, 16), layers=cfg.n_layers,
                          kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                          dtype=cfg.torch_dtype,
                          host_bytes=(512 + 8) * block_bytes, pin=True)
    store.ingest_chain(prompt, ((_to_host(k), _to_host(v))
                                for k, v in res.blocks))
    dec = WorkingSetDecoder(params, cfg, store, block_size=16,
                            window_blocks=4, tail_tokens=256)
    hits = store.read_chain(prompt, 512)
    kvh = dec._pack_chain(hits, 8192)
    st = dec._state()
    st["base"].fill_(8192)
    st["chain"].fill_(8192)
    bufs = st["bufs"]
    state = {"tok": int(res.last_logits.argmax()), "pos": 8192}

    def one():
        out = dec._token_fused(st, state["tok"], state["pos"], kvh,
                               state["pos"] - 8192, SP(), 0)
        state["tok"] = int(out)
        state["pos"] += 1

    rec = trace(one, 4, "longctx decode token llama3-8b bf16, chain 8192, "
                "pipelined (CUDA graphs), device sampler")
    slabs = [kvh[l, s] for l in range(kvh.shape[0])
             for s in range(kvh.shape[1])]
    nbytes = sum(t.numel() * t.element_size() for t in slabs)
    rates = {}
    for name, src in (("pinned", slabs),
                      ("pageable", [t.clone() for t in slabs[:16]])):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i, t in enumerate(src):
            bufs[i % 2].copy_(t, non_blocking=True)
        torch.cuda.synchronize()
        moved = nbytes * len(src) / len(slabs)
        rates[name] = moved / (time.perf_counter() - t0)
    print(json.dumps({"slab_bytes_per_token": nbytes,
                      "htod_bytes_per_s": rates,
                      "token_ms": rec["wall_ms"],
                      "memcpy_htod_ms_per_token": rec["memcpy_htod_ms"]}),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--train", action="store_true",
                      help="trace training steps instead of the forward "
                      "and decode steps")
    mode.add_argument("--train-moe", action="store_true",
                      help="trace mixtral-8x7b (2 layers) training steps "
                      "instead")
    mode.add_argument("--longctx", action="store_true",
                      help="trace one llama3-8b CP prefill instead")
    mode.add_argument("--longctx-decode", action="store_true",
                      help="trace one token of the llama3-8b working-set "
                      "decoder instead, and time the slab copies")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_flagship: no CUDA device", file=sys.stderr)
        return 2
    cfg = get_config("flagship-1b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if args.train or args.train_moe or args.longctx or args.longctx_decode:
        if args.train:
            _train(cfg, gen, 4, 2048, "flagship-1b")
        elif args.train_moe:
            _train(moe_train_config(), gen, 1, MOE_TRAIN_MODEL["max_seq"],
                   "mixtral-8x7b 2 layers", TRAIN_RANGES + MOE_RANGES)
        elif args.longctx:
            _longctx(gen)
        else:
            _longctx_decode(gen)
        print(json.dumps({"device": torch.cuda.get_device_name(0)}))
        return 0
    params = init_params(cfg, gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, 512), generator=gen,
                           device="cuda")
    with torch.no_grad():
        trace(lambda: forward(params, tokens, cfg), 3,
              "forward flagship-1b bf16 [1,512]")
    prompts = torch.randint(0, cfg.vocab_size, (4, 100),
                            generator=gen, device="cuda").tolist()
    for graphs in (True, False):
        eng = decoding_engine(params, cfg, prompts, graphs)
        trace(eng.step, 10, "engine decode step flagship-1b bf16, 4 lanes, "
              + ("CUDA graph" if graphs else "eager"))
        del eng
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


def decoding_engine(params, cfg, prompts, graphs: bool = True):
    """A flagship-1b ``DecodeEngine`` (4 lanes, block 16, context 1024,
    chunk 64) with every prompt prefilled and its lane decoding, budget
    200 tokens each; ``graphs=False`` steps through the engine's eager
    twin instead of its CUDA graphs."""
    eng = DecodeEngine(params, cfg, max_batch=4, block_size=16,
                       max_context=1024, prefill_chunk=64)
    if not graphs:
        eng._launch_step = eng._step_eager
    reqs = [eng.submit(p, SamplingParams(max_new_tokens=200))
            for p in prompts]
    while any(r._prefill_pos is not None or r.state == "QUEUED"
              for r in reqs):
        eng.step()                       # every lane decoding from here
    return eng


if __name__ == "__main__":
    sys.exit(main())
