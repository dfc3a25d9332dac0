"""A/B of ``spmd``'s host transport: page-locked against pageable host
buffers, on four gloo ranks sharing one GPU.

    python -m hadoop_tpu_torch.tools.ab_wire

Each rank sums float32 tensors of 256 MiB and 1 GiB over groups of two
and of four ranks (``spmd.psum_raw``: device to host, the gloo gather,
host to device, the sum in rank order) with the wire's host buffers
page-locked (``spmd._host_empty``, the default) and pageable, in turns
(pageable, page-locked, page-locked, pageable), three sums a case after
one warm-up; one JSON line a case with the host seconds a sum on rank
0. The sums' bits are the same either way. Needs a CUDA device.
"""

from __future__ import annotations

import json
import time

import torch
import torch.distributed as dist

from hadoop_tpu_torch.parallel import spmd

SIZES = (1 << 26, 1 << 28)       # float32 elements: 256 MiB, 1 GiB
REPEATS = 3


def _pageable(shape, dtype, like):
    return torch.empty(shape, dtype=dtype)


def _rank(rank: int, world: int):
    torch.cuda.set_device(0)
    axes = {"x2": spmd.new_groups("x2", [[0, 1], [2, 3]]),
            "x4": spmd.new_groups("x4", [list(range(world))])}
    pinned = spmd._host_empty
    out = []
    try:
        for mode in ("pageable", "page-locked", "page-locked", "pageable"):
            spmd._host_empty = _pageable if mode == "pageable" else pinned
            for n in SIZES:
                x = torch.randn(n, device="cuda")
                for name, axis in axes.items():
                    spmd.psum_raw(x, axis)
                    torch.cuda.synchronize()
                    dist.barrier()
                    t0 = time.perf_counter()
                    for _ in range(REPEATS):
                        spmd.psum_raw(x, axis)
                    torch.cuda.synchronize()
                    out.append({"host_buffers": mode, "bytes": n * 4,
                                "ranks": axis.size,
                                "s_a_sum": (time.perf_counter() - t0) /
                                REPEATS})
                del x
    finally:
        spmd._host_empty = pinned
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("ab_wire needs a CUDA device")
    for rec in spmd.launch(_rank, 4, backend="gloo", timeout=900)[0]:
        print(json.dumps(dict(rec, device=torch.cuda.get_device_name(0))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
