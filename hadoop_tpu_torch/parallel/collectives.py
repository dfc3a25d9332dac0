"""Device-resident exchange primitives: the shuffle over a parallel axis.

The counterpart of ``hadoop_tpu/parallel/collectives.py``. When numeric
records already live on the device, the MapReduce shuffle (the
reference's ShuffleHandler serving map output, its Fetcher pulling it)
is one all-to-all over the ranks of an axis: records are bucketed by the
rank their key's partition names, the buckets are exchanged, and each
rank optionally sorts what it received.

The reference's ``(mesh, axis)`` pair is one ``spmd.Axis`` here:

- **folded**: the axis's ranks share one device and one process.
  ``keys`` is the rank-major stack of every rank's records (``[R*n]``,
  rank r's rows r*n..(r+1)*n-1), which is the reference's global array
  sharded over the axis, and a result's rank-major stack is the
  reference's global result, row for row.
- **group**: a process group; each process passes its own rank's
  records and gets its own rank's result.

As in the reference the shapes are static: each rank sends at most
``cap`` records to each peer, buckets are padded with the key dtype's
maximum, ``valid`` marks real rows and ``dropped`` counts each rank's
send-side overflow. Grouping is a stable sort of the destinations and a
``searchsorted`` of each destination's run; the records move once, into
their slot of the send buffer, and a record past its bucket's capacity
goes to one trash row past the end that is sliced off (an index clamped
into range would overwrite a bucket's slot 0). The exchange is
``spmd.all_to_all_raw`` on each rank's ``[1, n_dev, cap, ...]`` buffer
(split and concat on dim 1: the reference's untiled ``all_to_all`` on
``[n_dev, cap, ...]``), one per buffer.

PyTorch runs this eagerly: the reference's compiled-program cache
(``_PROGRAM_CACHE``) has no counterpart and is left out.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from hadoop_tpu_torch.parallel import spmd


class ShuffleResult(NamedTuple):
    """Each rank's post-exchange rows (``n_dev * cap`` a rank, padded;
    on a folded axis the ranks' rows stacked): ``valid`` marks real
    records, ``dropped`` counts each rank's records that overflowed a
    bucket on the send side (one int32 a rank)."""
    keys: torch.Tensor
    values: torch.Tensor
    valid: torch.Tensor
    dropped: torch.Tensor


def hash_partitioner(n_parts: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """key → partition by the reference's multiplicative hash, in uint32
    arithmetic carried in int64: the key's low 32 bits times
    0x9E3779B1 (the product may wrap int64; its low 32 bits are the
    uint32 product's), ``h ^= h >> 15``, ``h % n_parts``."""
    def part(keys: torch.Tensor) -> torch.Tensor:
        h = keys.to(torch.int64) & 0xFFFFFFFF
        h.mul_(0x9E3779B1).bitwise_and_(0xFFFFFFFF)
        h.bitwise_xor_(h >> 15)
        return h.remainder_(n_parts).to(torch.int32)
    return part


def range_partitioner(splits: torch.Tensor
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """key → partition by cut points (TeraSort's TotalOrderPartitioner):
    partition i gets keys in (splits[i-1], splits[i]]. ``splits`` has
    n_parts-1 entries, ascending."""
    def part(keys: torch.Tensor) -> torch.Tensor:
        dtype = torch.promote_types(splits.dtype, keys.dtype)
        return torch.searchsorted(splits.to(keys.device, dtype),
                                  keys.to(dtype), right=False).to(
                                      torch.int32)
    part.splits = splits
    return part


def _local(axis: spmd.Axis, keys: torch.Tensor) -> Tuple[int, int]:
    """(ranks this process holds, records a rank)."""
    r = axis.size if axis.folded else 1
    if keys.dim() != 1 or keys.shape[0] % r:
        raise ValueError(f"keys {tuple(keys.shape)} over {axis}: one dim, "
                         f"a multiple of {r} rows")
    return r, keys.shape[0] // r


def _bucketize(keys, values, dest, n_dev: int, cap: int, pad_key):
    """Each rank's records ([R, n] keys and destinations, [R, n, ...]
    values) in its [n_dev, cap] send buffer, grouped by destination in
    input order, with the mask and each rank's overflow count."""
    r, n = keys.shape
    dev = keys.device
    vshape = tuple(values.shape[2:])
    dest_s, order = torch.sort(dest, dim=1, stable=True)
    runs = torch.arange(n_dev, device=dev, dtype=dest_s.dtype)
    starts = torch.searchsorted(dest_s, runs.expand(r, n_dev).contiguous(),
                                right=False)
    slot = torch.arange(n, device=dev) - starts.gather(1, dest_s.long())
    ok = slot < cap
    dropped = (~ok).sum(1, dtype=torch.int32)
    width = n_dev * cap
    trash = r * width
    rows = torch.arange(r, device=dev).unsqueeze(1) * width
    at_s = torch.where(ok, rows + dest_s.long() * cap + slot, trash)
    del dest_s, slot, ok
    # each record's row of the send buffer, in input order: the records
    # move once, from where they are
    at = torch.empty_like(at_s).scatter_(1, order, at_s).reshape(-1)
    del at_s, order
    send_k = torch.full((trash + 1,), pad_key, dtype=keys.dtype, device=dev)
    send_k[at] = keys.reshape(-1)
    send_m = torch.zeros(trash + 1, dtype=torch.uint8, device=dev)
    send_m[at] = 1
    send_v = torch.zeros((trash + 1,) + vshape, dtype=values.dtype,
                         device=dev)
    send_v[at] = values.reshape((r * n,) + vshape)
    return (send_k[:trash].view(r, n_dev, cap),
            send_v[:trash].view((r, n_dev, cap) + vshape),
            send_m[:trash].view(r, n_dev, cap), dropped)


def device_shuffle(axis: spmd.Axis, keys: torch.Tensor,
                   values: torch.Tensor,
                   partition: Optional[Callable] = None,
                   capacity_factor: float = 2.0,
                   sort_output: bool = True) -> ShuffleResult:
    """All-to-all partitioned exchange of device-resident records over
    ``axis``: each record goes to the rank ``partition(key)`` names
    (default ``hash_partitioner(axis.size)``, applied to each rank's
    keys), then each rank optionally sorts its received rows, stably by
    key (pads carry the maximum key and sort to the tail).

    Returns a ShuffleResult of ``n_dev * cap`` rows a rank, ``cap =
    max(1, int(n * capacity_factor / n_dev))`` for ``n`` records a rank;
    ``dropped[r]`` is rank r's send-side overflow (0 for a well-sized
    factor; callers retry bigger on > 0)."""
    if keys.is_floating_point() or keys.is_complex() or \
            keys.dtype == torch.bool:
        raise TypeError("device_shuffle keys must be integers (numeric "
                        "record exchange; host shuffle covers the rest)")
    if values.shape[0] != keys.shape[0]:
        raise ValueError(f"values {tuple(values.shape)} against keys "
                         f"{tuple(keys.shape)}")
    r, n = _local(axis, keys)
    n_dev = axis.size
    cap = max(1, int(n * capacity_factor / n_dev))
    pad_key = torch.iinfo(keys.dtype).max
    if partition is None:
        partition = hash_partitioner(n_dev)
    k2 = keys.reshape(r, n)
    dest = torch.stack([partition(k) for k in k2.unbind(0)])
    dest = dest.clamp_(0, n_dev - 1)
    vshape = tuple(values.shape[1:])
    send_k, send_v, send_m, dropped = _bucketize(
        k2, values.reshape((r, n) + vshape), dest, n_dev, cap, pad_key)
    del dest
    # rank i's bucket j to rank j, arriving as its row i
    out_k, out_v, out_m = (spmd.all_to_all_raw(x, axis, 1, 1)
                           for x in (send_k, send_v, send_m))
    del send_k, send_v, send_m
    width = n_dev * cap
    out_k = out_k.reshape(r, width)
    out_m = out_m.reshape(r, width).bool()
    out_v = out_v.reshape((r * width,) + vshape)
    if sort_output:
        out_k, order = torch.sort(out_k, dim=1, stable=True)
        out_m = out_m.gather(1, order)
        rows = torch.arange(r, device=keys.device).unsqueeze(1) * width
        out_v = out_v[(order + rows).reshape(-1)]
    return ShuffleResult(out_k.reshape(-1), out_v, out_m.reshape(-1),
                         dropped)


def sample_split_points(axis: spmd.Axis, keys: torch.Tensor, n_parts: int,
                        n_samples: int = 1024) -> torch.Tensor:
    """Sampled range-partition cut points (TeraInputFormat's sampling
    for TotalOrderPartitioner): each rank contributes an evenly strided,
    sorted sample of its keys; the quantiles of every rank's samples,
    merged and sorted, are the n_parts-1 split points (the same on
    every rank)."""
    r, n = _local(axis, keys)
    n_dev = axis.size
    per_dev = max(1, n_samples // n_dev)
    stride = max(1, n // per_dev)
    sample = torch.sort(keys.view(r, n)[:, ::stride][:, :per_dev],
                        dim=1).values
    s = sample.shape[1]
    # the gathered samples once a rank (folded: stacked, rank 0's taken)
    every = spmd.all_gather_raw(sample.reshape(r * s), axis, 0)
    every = torch.sort(every[:n_dev * s]).values
    idx = (torch.arange(1, n_parts, device=keys.device) * every.shape[0]
           ) // n_parts
    return every[idx]


def device_sorted(axis: spmd.Axis, keys: torch.Tensor, values: torch.Tensor,
                  capacity_factor: float = 2.0) -> ShuffleResult:
    """Global sort of device-resident records, TeraSort as collectives:
    sample → range-partitioned exchange → local sort. After it each
    rank's valid run is sorted and every valid key on rank r is ≤ every
    valid key on rank r+1."""
    splits = sample_split_points(axis, keys, axis.size)
    return device_shuffle(axis, keys, values,
                          partition=range_partitioner(splits),
                          capacity_factor=capacity_factor, sort_output=True)
