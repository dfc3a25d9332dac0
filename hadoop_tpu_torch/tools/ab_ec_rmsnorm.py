"""A/B of the GF(256) coder and the RMSNorm backward against another copy
of their sources, in one process on one GPU.

    python -m hadoop_tpu_torch.tools.ab_ec_rmsnorm OTHER_CSRC_DIR \
        [--ec-bit-constants] [--other-rms-blocks-per-sm N]

Builds ``OTHER_CSRC_DIR/ec_gf256.cu`` and ``OTHER_CSRC_DIR/rmsnorm.cu``
into libraries of their own, prints what ptxas reports for them, and
then runs the checkout's kernels and the other ones in turns (other,
this, this, other), timed with CUDA events, one JSON line per case: bit
equality of the outputs, their largest difference over the largest
value, and the times. Cases: ``htpu_ec_gf256_apply`` on one block group
of 128 MiB units (the encode of RS(3,2), RS(6,3) and RS(10,4), RS(6,3)'s
encode on all-zero words, and the decode of RS(6,3) and RS(10,4) after
losing data units), and the RMSNorm backward in bf16 at flagship-1b's
and mixtral-8x7b's training rows, both launches and each alone, as
device time from CUDA graph replays.

``--ec-bit-constants``: the other copy's coder takes the [r, k, 8] bit
constants (``GFMatrix.consts``) where this checkout's takes the product
tables. ``--other-rms-blocks-per-sm N``: the other copy's backward runs
on min(rows, N·SMs) blocks, the grid its wrapper took (default: this
checkout's grid). A copy from an earlier commit serves as the other:
``git show <commit>:hadoop_tpu_torch/ops/csrc/ec_gf256.cu > DIR/
ec_gf256.cu``, the same for ``rmsnorm.cu``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from hadoop_tpu_torch.io.erasurecode import _cauchy_parity_matrix, _gf_invert
from hadoop_tpu_torch.ops import _build, ec_device, norms

ENTRIES = {"ec_gf256": ("htpu_ec_gf256_apply",),
           "rmsnorm": ("htpu_rms_norm_bwd", "htpu_rms_norm_dw")}
UNIT_WORDS = 134217728 // 4          # one 128 MiB unit of a block group
# (schema, lost units or None for the encode, all-zero words)
EC_CASES = [((3, 2), None, False), ((6, 3), None, False),
            ((10, 4), None, False), ((6, 3), None, True),
            ((6, 3), (0, 2, 5), False), ((10, 4), (2, 5, 8, 9), False)]
RMS_SHAPES = [(4, 2048, 2048), (1, 4096, 4096)]


def build_other(csrc: Path, lib: str):
    """The other copy's entries of ``lib``, bound as ``_build.entry``
    binds them."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"lib{lib}-ab-other.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(csrc / f"{lib}.cu")],
                          capture_output=True, text=True)
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln]
    print(json.dumps({"other": lib, "build_rc": proc.returncode,
                      "ptxas": report}), flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for the other copy of {lib}")
    so = ctypes.CDLL(str(out))
    return {name: _build.bind(getattr(so, name), name)
            for name in ENTRIES[lib]}


def cuda_ms(fn, iters: int = 20) -> float:
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


def graph_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` calls captured in one
    CUDA graph and replayed: no host launch cost between the kernels
    (``cuda_ms`` of a few-microsecond kernel times its host launches)."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = cuda_ms(graph.replay, 3) / iters
    del graph
    return ms


def compare(case, calls, mine, other, iters, timer=cuda_ms):
    """Run ``calls[side]`` with each copy's entries in turns (other, this,
    this, other), timed by ``timer``, and print one JSON line."""
    times = {"this": [], "other": []}
    outs = {}
    for side in ("other", "this", "this", "other"):
        _build.entries.update(other if side == "other" else mine)
        outs[side] = calls[side]()
        times[side].append(timer(calls[side], iters))
    _build.entries.update(mine)
    pairs = list(zip(outs["this"], outs["other"]))
    print(json.dumps({
        **case,
        "bit_equal": all(torch.equal(a, c) for a, c in pairs),
        "max_rel_diff": max(((a.float() - c.float()).abs().max()
                             / c.float().abs().max().clamp(min=1e-30))
                            .item() for a, c in pairs),
        "this_ms": times["this"], "other_ms": times["other"],
        "this_mean_ms": sum(times["this"]) / 2,
        "other_mean_ms": sum(times["other"]) / 2}), flush=True)


def _ec(words, arg, r):
    out = torch.empty(r, words.shape[1], dtype=torch.int32,
                      device=words.device)
    _build.launch("htpu_ec_gf256_apply", words, arg, out, words.shape[1],
                  words.shape[0], r)
    return (out,)


def ec_cases(gen, bit_constants: bool):
    """(case, calls) of the coder: the same words and matrix for both
    copies, each given its own form of the matrix."""
    for (k, m), lost, zero in EC_CASES:
        mat = _cauchy_parity_matrix(k, m)
        if lost is not None:
            full = np.vstack([np.eye(k, dtype=np.uint8), mat])
            mat = _gf_invert(full[[u for u in range(k + m)
                                   if u not in lost][:k]])
        fn = ec_device.GFMatrix(mat)
        words = (torch.zeros(k, UNIT_WORDS, dtype=torch.int32, device="cuda")
                 if zero else torch.randint(
                     -2 ** 31, 2 ** 31, (k, UNIT_WORDS), generator=gen,
                     device="cuda", dtype=torch.int32))
        tables = fn.tables_on(words.device)
        consts = torch.from_numpy(fn.consts).to(words.device)
        r = mat.shape[0]
        case = {"kind": "ec_decode" if lost else "ec_encode",
                "schema": [k, m], "lost": list(lost) if lost else None,
                "zero_words": zero, "unit_bytes": UNIT_WORDS * 4,
                "data_bytes": k * UNIT_WORDS * 4}
        yield case, {"this": lambda: _ec(words, tables, r),
                     "other": lambda: _ec(words, consts if bit_constants
                                          else tables, r)}


def rms_cases(gen, other_per_sm):
    """(case, calls) of the RMSNorm backward in bf16: both launches, the
    pass alone and the finish alone, each copy on its own grid (timed as
    device time, from CUDA graph replays)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape in RMS_SHAPES:
        d = shape[-1]
        rows = shape[0] * shape[1]
        x = torch.randn(rows, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        dy = torch.randn(rows, d, generator=gen, device="cuda").to(
            torch.bfloat16)
        w = (1 + 0.1 * torch.randn(d, generator=gen, device="cuda")).to(
            torch.bfloat16)
        _, _, r = norms._launch_fwd(x, w, 1e-5)
        grids = {"this": norms._bwd_grid(rows, sms)[0],
                 "other": (min(rows, other_per_sm * sms) if other_per_sm
                           else norms._bwd_grid(rows, sms)[0])}
        bufs = {side: (torch.empty_like(x), torch.empty_like(w),
                       torch.empty(b, d, dtype=torch.float32,
                                   device="cuda"))
                for side, b in grids.items()}

        def run(side, what):
            dx, dw, partials = bufs[side]
            blocks = grids[side]
            if what in ("both", "pass"):
                _build.launch("htpu_rms_norm_bwd", dy, x, w, r, dx, partials,
                              rows, d, blocks, 1)
            if what in ("both", "finish"):
                _build.launch("htpu_rms_norm_dw", partials, dw, blocks, d, 1)
            return (dx, dw) if what == "both" else (
                (dx,) if what == "pass" else (dw,))

        for what in ("both", "pass", "finish"):
            case = {"kind": f"rms_bwd_{what}", "shape": list(shape),
                    "grid": grids}
            yield case, {side: (lambda s=side, wh=what: run(s, wh))
                         for side in ("this", "other")}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path,
                    help="directory holding the other copy's sources")
    ap.add_argument("--ec-bit-constants", action="store_true",
                    help="the other coder takes [r, k, 8] bit constants")
    ap.add_argument("--other-rms-blocks-per-sm", type=int, default=0,
                    help="the other backward's blocks an SM (default: "
                    "this checkout's grid)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_ec_rmsnorm: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for lib, cases, iters, timer in (
            ("ec_gf256", ec_cases(gen, args.ec_bit_constants), 10, cuda_ms),
            ("rmsnorm", rms_cases(gen, args.other_rms_blocks_per_sm), 50,
             graph_ms)):
        for name in ENTRIES[lib]:
            _build.entry(name)                # this checkout's build
        mine = {name: _build.entries[name] for name in ENTRIES[lib]}
        other = build_other(args.other, lib)
        for case, calls in cases:
            compare(case, calls, mine, other, iters, timer)
        torch.cuda.empty_cache()
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
