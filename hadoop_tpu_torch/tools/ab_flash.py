"""A/B of the flash kernels against another copy of their sources, in
one process on one GPU.

    python -m hadoop_tpu_torch.tools.ab_flash OTHER_CSRC_DIR [--backward]

Builds ``OTHER_CSRC_DIR/flash_fwd.cu`` (with ``--backward``:
``flash_bwd.cu``), with the headers beside it, into a library of its
own, prints what ptxas reports for it (registers, spills, ``wgmma``
serialization), and then, at the main-path shapes, runs the checkout's
kernel and the other one through the same wrapper (``ops.flash``), says
whether the outputs are equal bit for bit (and how far apart, relative
to the largest value, when they are not), and times both in turns
(other, this, this, other) with CUDA events, one JSON line per kernel and
shape. The forward's shapes are its causal and partial main-path shapes;
the backward's the flagship training shape, where the dQ kernel (with
its delta) and the dK/dV kernel are timed apart, both dK/dV runs reading
the checkout's delta. The other copy must have the C entries of
``_build.SIGNATURES`` that it is called through: a copy of the sources
from an earlier commit serves, e.g. ``git show
<commit>:hadoop_tpu_torch/ops/csrc/flash_bwd.cu > DIR/flash_bwd.cu``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import subprocess
import sys
from pathlib import Path

import torch

from hadoop_tpu_torch.ops import _build, flash

# library -> the C entries the A/B calls
ENTRIES = {"flash_fwd": ("htpu_flash_fwd", "htpu_flash_fwd_partial"),
           "flash_bwd": ("htpu_flash_bwd_dq", "htpu_flash_bwd_dkv")}
# (kind, shape): the causal forward's serving, training, CP-diagonal and
# single-device llama3-8b shapes (B, S, Hq, Hkv, D), and the partial's
# llama3-8b ring shape (B, Sq, Skv, Hq, Hkv, D); bf16
SHAPES = [("causal", (1, 512, 16, 8, 128)), ("causal", (4, 2048, 16, 8, 128)),
          ("causal", (4, 2048, 32, 8, 128)), ("causal", (1, 8192, 32, 8, 128)),
          ("partial", (4, 2048, 2048, 32, 8, 128))]
# the backward's: flagship-1b's training shape (B, S, Hq, Hkv, D), bf16
BWD_SHAPES = [(4, 2048, 16, 8, 128)]


def build_other(csrc: Path, lib: str):
    """The other copy's entries of ``lib``, bound as ``_build.entry``
    binds them."""
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = _build.BUILD_DIR / f"lib{lib}-ab-other.so"
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                           str(csrc / f"{lib}.cu")],
                          capture_output=True, text=True)
    report = [ln.strip() for ln in (proc.stdout + proc.stderr).splitlines()
              if "registers" in ln or "spill" in ln or "C75" in ln]
    print(json.dumps({"other_build_rc": proc.returncode, "ptxas": report}),
          flush=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed for the other copy")
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


def compare(kind, shape, call, mine, other):
    """Run ``call`` with each copy's entries in turns (other, this, this,
    other) and print one JSON line: bit equality of the outputs, their
    largest difference over the largest value, and the times."""
    times = {"this": [], "other": []}
    outs = {}
    for side in ("other", "this", "this", "other"):
        _build.entries.update(other if side == "other" else mine)
        outs[side] = call()
        times[side].append(cuda_ms(call))
    _build.entries.update(mine)
    pairs = list(zip(outs["this"], outs["other"]))
    print(json.dumps({
        "kind": kind, "shape": list(shape),
        "bit_equal": all(torch.equal(a, c) for a, c in pairs),
        "max_rel_diff": max(((a.float() - c.float()).abs().max()
                             / c.float().abs().max()).item()
                            for a, c in pairs),
        "this_ms": times["this"], "other_ms": times["other"],
        "this_mean_ms": sum(times["this"]) / 2,
        "other_mean_ms": sum(times["other"]) / 2}), flush=True)


def _forward_cases(randn):
    """(kind, shape, call) of the forward's main-path shapes."""
    for kind, shape in SHAPES:
        if kind == "causal":
            b, s, hq, hkv, d = shape
            q, k, v = randn(b, s, hq, d), randn(b, s, hkv, d), \
                randn(b, s, hkv, d)
            yield kind, shape, functools.partial(flash._launch, q, k, v,
                                                 d ** -0.5)
        else:
            b, sq, skv, hq, hkv, d = shape
            q, k, v = randn(b, sq, hq, d), randn(b, skv, hkv, d), \
                randn(b, skv, hkv, d)
            yield kind, shape, functools.partial(flash._launch_partial, q,
                                                 k, v, d ** -0.5)


def _backward_cases(randn):
    """(kind, shape, call) of the dQ and dK/dV kernels at the backward's
    shapes; both dK/dV copies read the checkout's delta."""
    for shape in BWD_SHAPES:
        b, s, hq, hkv, d = shape
        q, do = randn(b, s, hq, d), randn(b, s, hq, d)
        k, v = randn(b, s, hkv, d), randn(b, s, hkv, d)
        scale = d ** -0.5
        o, lse = flash.flash_forward(q, k, v, scale)
        _, delta = flash._launch_bwd_dq(q, k, v, o, lse, do, scale)
        yield "dq", shape, functools.partial(flash._launch_bwd_dq, q, k, v,
                                             o, lse, do, scale)
        yield "dkv", shape, functools.partial(flash._launch_bwd_dkv, q, k,
                                              v, lse, delta, do, scale)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("other", type=Path,
                    help="directory holding the other copy's sources")
    ap.add_argument("--backward", action="store_true",
                    help="A/B flash_bwd.cu (dQ and dK/dV) instead of "
                    "flash_fwd.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ab_flash: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    lib = "flash_bwd" if args.backward else "flash_fwd"
    for name in ENTRIES[lib]:
        _build.entry(name)                    # this checkout's build
    mine = {name: _build.entries[name] for name in ENTRIES[lib]}
    other = build_other(args.other, lib)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    cases = _backward_cases(randn) if args.backward else _forward_cases(randn)
    for kind, shape, call in cases:
        compare(kind, shape, call, mine, other)
    print(json.dumps({"device": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
