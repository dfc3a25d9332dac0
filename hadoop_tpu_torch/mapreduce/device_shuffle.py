"""Device-resident MapReduce: the shuffle and the reduce over an axis.

The counterpart of ``hadoop_tpu/mapreduce/device_shuffle.py``, layered
on ``hadoop_tpu_torch.parallel.collectives`` (whose ``spmd.Axis`` takes
the reference's ``(mesh, axis)`` pair: folded, every rank's rows
stacked on one device, or a process group):

- :func:`device_group_reduce`: the shuffle and reduce of a
  wordcount-class job; every key's values meet on one rank and are
  combined there.
- :func:`device_terasort`: sampled range partition, exchange and local
  sort give a globally sorted run, cut over the ranks.

Results are padded (``valid`` marks real rows, ``dropped`` counts each
rank's send-side overflow; see ``collectives.device_shuffle``). The
reference's ``jax.ops.segment_*`` reductions are ``index_add_`` (sum)
and ``scatter_reduce`` without the initial values (max, min) here;
integer results are the reference's bit for bit, float sums may add in
another order (on CUDA ``index_add_`` adds through atomics).
"""

from __future__ import annotations

import torch

from hadoop_tpu_torch.parallel import spmd
from hadoop_tpu_torch.parallel.collectives import (ShuffleResult,
                                                   device_shuffle,
                                                   device_sorted,
                                                   hash_partitioner,
                                                   range_partitioner,
                                                   sample_split_points)

__all__ = [
    "ShuffleResult", "device_shuffle", "device_sorted",
    "hash_partitioner", "range_partitioner", "sample_split_points",
    "device_group_reduce", "device_terasort",
]


def _identity(op: str, dtype: torch.dtype):
    """The value a masked row takes under ``op``."""
    if op == "sum":
        return 0
    if op not in ("max", "min"):
        raise ValueError(f"unsupported reduce op {op!r}")
    if dtype.is_floating_point:
        return -float("inf") if op == "max" else float("inf")
    info = torch.iinfo(dtype)
    return info.min if op == "max" else info.max


def _segment_reduce_sorted(keys, values, valid, op: str):
    """Combine the equal-key runs of one rank's SORTED, padded rows.
    Returns (keys, combined, first): row i holds the reduction of its
    key's whole run iff first[i] (the other rows hold 0)."""
    fill = _identity(op, values.dtype)
    n = keys.shape[0]
    first = torch.ones_like(valid)
    first[1:] = keys[1:] != keys[:-1]
    first &= valid
    seg = torch.cumsum(first, 0) - 1          # run index per row
    # rows before the first run (seg -1) go to a dropped row past the end
    seg = torch.where(seg < 0, n, seg)
    bcast = (-1,) + (1,) * (values.dim() - 1)
    x = torch.where(valid.reshape(bcast), values,
                    torch.tensor(fill, dtype=values.dtype,
                                 device=values.device))
    combined = torch.full((n + 1,) + tuple(values.shape[1:]), fill,
                          dtype=values.dtype, device=values.device)
    if op == "sum":
        combined.index_add_(0, seg, x)
    else:
        combined.scatter_reduce_(0, seg.reshape(bcast).expand_as(x), x,
                                 reduce="amax" if op == "max" else "amin",
                                 include_self=False)
    out = torch.where(first.reshape(bcast), combined[seg],
                      torch.zeros((), dtype=values.dtype,
                                  device=values.device))
    return keys, out, first


def device_group_reduce(axis: spmd.Axis, keys: torch.Tensor,
                        values: torch.Tensor, op: str = "sum",
                        capacity_factor: float = 2.0) -> ShuffleResult:
    """Group-by-key and combine across the axis, the numeric wordcount:
    the hash partition sends every occurrence of a key to one rank (the
    HashPartitioner's contract to reducers), which reduces each key's
    sorted run in place (``op``: "sum", "max" or "min"). Rows with
    ``valid`` set are (key, reduced value) pairs; every key appears on
    exactly one rank, once."""
    _identity(op, values.dtype)               # an unknown op raises first
    res = device_shuffle(axis, keys, values,
                         partition=hash_partitioner(axis.size),
                         capacity_factor=capacity_factor, sort_output=True)
    r = axis.size if axis.folded else 1
    per = res.keys.shape[0] // r
    parts = [_segment_reduce_sorted(res.keys[i * per:(i + 1) * per],
                                    res.values[i * per:(i + 1) * per],
                                    res.valid[i * per:(i + 1) * per], op)
             for i in range(r)]
    k, v, first = (torch.cat(x) for x in zip(*parts))
    return ShuffleResult(k, v, first, res.dropped)


def device_terasort(axis: spmd.Axis, keys: torch.Tensor,
                    values: torch.Tensor,
                    capacity_factor: float = 2.0) -> ShuffleResult:
    """Globally sort device-resident (key, value) records, the TeraSort
    pipeline (sample → TotalOrderPartitioner → sort) as collectives:
    each rank's valid run is sorted and every valid key on rank r is ≤
    every valid key on rank r+1."""
    return device_sorted(axis, keys, values,
                         capacity_factor=capacity_factor)
