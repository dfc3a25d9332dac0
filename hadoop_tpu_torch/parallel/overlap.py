"""Communication overlap: bucketed gradient collectives and the ZeRO-1
slice layout.

The counterpart of ``hadoop_tpu/parallel/overlap.py``:

- ``bucketed_psum``: leaves grouped by (reduce axes, dtype) and packed,
  in the tree's flatten order, into buckets of at most ``bucket_bytes``;
  each bucket is one flattened ``spmd.psum`` per axis. ``spmd``'s sums
  add in rank order elementwise, so buckets give the per-leaf result
  bit for bit: what changes is the number of collectives.
- ``bucketed_psum_scatter``: the ZeRO-1 form. A rank that updates only
  its slice of each leaf gets just that slice of the sum (the same bits
  as psum-then-slice).
- ``bucketed_gather_slices``: the updated slices back into whole leaves,
  one ``all_gather`` per bucket instead of one per leaf.
- The slice layout (``zero1_slice_meta``, ``zero1_slice_index``): a
  leaf's local shard flattened and padded to Z*K, Z the product of the
  sizes of the data axes its state is partitioned over; this rank's
  slice is the K elements at its mixed-radix index over those axes.

The ZeRO-1 gather records its bytes in the comm ledger
(``obs/comm.py``, ``zero1.gather``), as the reference's does. The
bucketed sums record nothing on the bitwise tier: the train step's are
the port's form of the sums the reference's autodiff inserts (its vma
transposes), which its ledger does not see either.

Under the relaxed parity tier (``parallel/lowp``) the three take
``relaxed`` (a ``RelaxedQuant``): a float bucket rides the wire as int8
(or fp8) with shared f32 scales (``lowp/quant.py``) and records its
wire bytes (``bucket.psum``, ``bucket.scatter``, ``zero1.gather``);
integer buckets stay exact, and so does the per-leaf fallback of the
scatter. A bucket's scale groups cover ``group`` consecutive elements of
its buffer, so under relaxed a bucket holds the reference's leaves in
the reference's order and cut: its groups are keyed also by ``vma``, a
tree of the axis names each leaf's value varies over in the
reference's tracking (the spec axes and the reduce or slice axes, at
any size), as its ``_vma_key``. The sum over several axes shares one
scale over all of them, with headroom for their product of ranks.

``OverlapConfig`` holds the reference's knobs (its
``parallel.overlap.*`` keys; the reference's ``overlap_from_conf`` has
no caller in either package); ``tp_chunks``
(``parallel.overlap.tp.chunks``) cuts the relaxed tier's tp reduce
(``ops/collective_matmul.py``). Leaves are ``spmd.Axis`` tuples, not
names.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Sequence, Tuple

import torch

from hadoop_tpu_torch.obs.comm import record_comm, static_nbytes
from hadoop_tpu_torch.parallel import spmd


@dataclasses.dataclass(frozen=True)
class OverlapConfig:
    """Static overlap knobs, fixed at train-step build time."""
    enabled: bool = True
    bucket_mb: int = 4
    tp_chunks: int = 4

    @property
    def bucket_bytes(self) -> int:
        return max(1, self.bucket_mb) * (1 << 20)


DEFAULT_OVERLAP = OverlapConfig()
OVERLAP_OFF = OverlapConfig(enabled=False)



# ------------------------------------------------------------------ trees

def flatten(tree) -> Tuple[List[Any], Callable[[List[Any]], Any]]:
    """The leaves of nested dicts in sorted-key order (the optimizer's
    ``tree_leaves`` order), and the function that rebuilds the tree from
    a list of new leaves."""
    paths: List[Tuple[str, ...]] = []
    leaves: List[Any] = []

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], path + (key,))
        else:
            paths.append(path)
            leaves.append(node)
    walk(tree, ())

    def rebuild(new: List[Any]):
        out: Dict[str, Any] = {}
        for path, leaf in zip(paths, new):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
        return out
    return leaves, rebuild


def _live(axes) -> Tuple[spmd.Axis, ...]:
    return tuple(a for a in axes if a is not None and a.size > 1)


def _key(axes) -> Tuple[str, ...]:
    return tuple(a.name for a in axes)


# ---------------------------------------------------------------- bucketing

def _pack_buckets(sizes: Sequence[int], itemsize: int,
                  bucket_bytes: int) -> List[List[int]]:
    """Greedy in-order packing of leaf positions into buckets; a leaf
    larger than ``bucket_bytes`` gets its own."""
    buckets: List[List[int]] = []
    cur: List[int] = []
    cur_bytes = 0
    for i, n in enumerate(sizes):
        nb = n * itemsize
        if cur and cur_bytes + nb > bucket_bytes:
            buckets.append(cur)
            cur, cur_bytes = [], 0
        cur.append(i)
        cur_bytes += nb
    if cur:
        buckets.append(cur)
    return buckets


def _vma_flat(vma, n: int) -> List[Tuple[str, ...]]:
    """The ``vma`` tree's leaves as sorted name tuples (all empty
    without one)."""
    if vma is None:
        return [()] * n
    return [tuple(sorted(v)) for v in flatten(vma)[0]]


def _groups(flat, axes_flat, vma_flat):
    """Leaf positions by (axes, dtype, vma), in first-seen order."""
    groups: Dict[Any, List[int]] = {}
    for i, (g, axes, v) in enumerate(zip(flat, axes_flat, vma_flat)):
        axes = _live(axes)
        if axes:
            groups.setdefault((_key(axes), g.dtype, v), []).append(i)
    return groups


def _quantized(relaxed, x: torch.Tensor) -> bool:
    return relaxed is not None and x.is_floating_point()


def _psum_axes(x: torch.Tensor, axes, inplace: bool = False
               ) -> torch.Tensor:
    for a in axes:
        x = spmd.psum_raw(x, a, inplace)
    return x


def bucketed_psum(tree, reduce_axes_tree, bucket_bytes: int,
                  relaxed=None, vma=None):
    """psum every leaf over its reduce axes (a tuple of ``spmd.Axis`` per
    leaf; empty: the leaf passes through), same-signature leaves packed
    into flattened buckets of at most ``bucket_bytes``; a leaf alone in
    its bucket is summed in place (the caller's gradient buffers are
    consumed). Bit for bit the per-leaf result. ``relaxed``: a float
    bucket's sum is ``psum_quantized`` (group scales)."""
    flat, rebuild = flatten(tree)
    axes_flat, _ = flatten(reduce_axes_tree)
    out = list(flat)
    for idxs in _groups(flat, axes_flat,
                        _vma_flat(vma, len(flat))).values():
        axes = _live(axes_flat[idxs[0]])
        quant = _quantized(relaxed, flat[idxs[0]])
        for bucket in _pack_buckets([flat[i].numel() for i in idxs],
                                    flat[idxs[0]].element_size(),
                                    bucket_bytes):
            members = [idxs[j] for j in bucket]
            if quant:
                from hadoop_tpu_torch.parallel.lowp.quant import \
                    psum_quantized
                buf = psum_quantized(torch.cat(
                    [flat[i].reshape(-1) for i in members]), axes, relaxed,
                    site="bucket.psum")
            elif len(members) == 1 and flat[members[0]].is_contiguous():
                out[members[0]] = _psum_axes(flat[members[0]], axes, True)
                continue
            else:
                buf = _psum_axes(torch.cat(
                    [flat[i].reshape(-1) for i in members]), axes)
            for i, part in zip(members, buf.split(
                    [flat[i].numel() for i in members])):
                out[i] = part.view(flat[i].shape)
    return rebuild(out)


# --------------------------------------------------------- ZeRO-1 layout

def zero1_slice_meta(numel: int, axes) -> Tuple[int, int]:
    """(Z, K) of one leaf's slice layout: ``numel`` padded to Z*K, Z the
    product of the sizes of the (live) axes partitioning its state."""
    z = 1
    for a in _live(axes):
        z *= a.size
    return z, -(-numel // z)


def zero1_slice_index(axes) -> int:
    """This rank's slice: mixed-radix (row-major) over the axes."""
    idx = 0
    for a in _live(axes):
        idx = idx * a.size + a.index
    return idx


def pad_flat(x: torch.Tensor, z: int, k: int) -> torch.Tensor:
    """x flattened and zero-padded to z*k elements."""
    flat = x.reshape(-1)
    pad = z * k - flat.numel()
    return torch.cat([flat, flat.new_zeros(pad)]) if pad else flat


def local_slice(x: torch.Tensor, axes) -> torch.Tensor:
    """This rank's (K,) slice of a whole leaf, padded."""
    z, k = zero1_slice_meta(x.numel(), axes)
    i = zero1_slice_index(axes)
    return pad_flat(x, z, k)[i * k:(i + 1) * k]


def bucketed_psum_scatter(tree, reduce_axes_tree, scatter_axes_tree,
                          bucket_bytes: int, relaxed=None, vma=None):
    """Each leaf summed over its reduce axes, as this rank's ZeRO-1 (K,)
    slice: leaves whose state is partitioned over exactly one axis (which
    they reduce over) go in buckets of [Z, K] rows, summed over the other
    axes and reduce-scattered over that one; the rest take psum and the
    local slice. The same bits as psum-then-slice. ``relaxed``: a float
    bucket takes ``psum_scatter_quantized`` (group scales; the fallback
    stays exact)."""
    flat, rebuild = flatten(tree)
    red_flat, _ = flatten(reduce_axes_tree)
    sc_flat, _ = flatten(scatter_axes_tree)
    vma_flat = _vma_flat(vma, len(flat))
    out: List[Any] = [None] * len(flat)
    groups: Dict[Any, List[int]] = {}
    for i, (g, red, sc) in enumerate(zip(flat, red_flat, sc_flat)):
        red, sc = _live(red), _live(sc)
        if len(sc) != 1 or sc[0].name not in _key(red):
            out[i] = local_slice(_psum_axes(g, red), sc)
            continue
        rest = tuple(a for a in red if a.name != sc[0].name)
        groups.setdefault((_key(rest), sc[0].name, g.dtype, vma_flat[i]),
                          []).append(i)
    for idxs in groups.values():
        red = _live(red_flat[idxs[0]])
        sc = _live(sc_flat[idxs[0]])[0]
        rest = tuple(a for a in red if a.name != sc.name)
        ks = [zero1_slice_meta(flat[i].numel(), (sc,))[1] for i in idxs]
        for bucket in _pack_buckets(ks, flat[idxs[0]].element_size() *
                                    sc.size, bucket_bytes):
            members = [(idxs[j], ks[j]) for j in bucket]
            buf = torch.cat([pad_flat(flat[i], sc.size, k).view(sc.size, k)
                             for i, k in members], dim=1)
            if _quantized(relaxed, buf):
                from hadoop_tpu_torch.parallel.lowp.quant import \
                    psum_scatter_quantized
                sl = psum_scatter_quantized(buf, sc, relaxed, rest_axes=rest,
                                            site="bucket.scatter")
            else:
                sl = spmd.psum_scatter_raw(_psum_axes(buf, rest), sc, 0)
            for (i, _), part in zip(members, sl.reshape(-1).split(
                    [k for _, k in members])):
                out[i] = part
    return rebuild(out)


def bucketed_gather_slices(slices, params_like, leaf_axes,
                           bucket_bytes: int, relaxed=None, vma=None):
    """Whole leaves from every rank's (K,) slices: same-axes slices
    concatenated into one row per bucket, gathered over the axes (the
    last first, so rows land in mixed-radix order), each leaf's [Z, k]
    block flattened and unpadded. Leaves with Z == 1 pass through
    reshaped. ``relaxed``: a float bucket's row crosses quantized at
    full range (``psum_of_scatter_quantized``). Every rank's leaves,
    its own slice included, become the dequantized copy, and the next
    update slices them: the reference's does the same, though its
    docstring says the updated slices stay exact (ROADMAP Queue C)."""
    flat_s, rebuild = flatten(slices)
    flat_p, _ = flatten(params_like)
    flat_a, _ = flatten(leaf_axes)
    vma_flat = _vma_flat(vma, len(flat_s))
    out: List[Any] = [None] * len(flat_s)
    groups: Dict[Any, List[int]] = {}
    for i, (sl, p, axes) in enumerate(zip(flat_s, flat_p, flat_a)):
        axes = _live(axes)
        if not axes:
            out[i] = sl[:p.numel()].view(p.shape)
            continue
        groups.setdefault((_key(axes), sl.dtype, vma_flat[i]),
                          []).append(i)
    for idxs in groups.values():
        axes = _live(flat_a[idxs[0]])
        z = zero1_slice_meta(1, axes)[0]
        ks = [flat_s[i].numel() for i in idxs]
        for bucket in _pack_buckets(ks, flat_s[idxs[0]].element_size() * z,
                                    bucket_bytes):
            members = [(idxs[j], ks[j]) for j in bucket]
            row = torch.cat([flat_s[i] for i, _ in members])
            if _quantized(relaxed, row):
                from hadoop_tpu_torch.parallel.lowp.quant import \
                    psum_of_scatter_quantized
                buf = psum_of_scatter_quantized(
                    row, z, zero1_slice_index(axes), axes, relaxed,
                    site="zero1.gather")[:, :row.numel()]
            else:
                # the reference's payload: its [Z, K] buffer (the wire
                # carries this rank's row)
                record_comm("zero1.gather", z * static_nbytes(row),
                            z * static_nbytes(row))
                buf = row[None]
                for a in reversed(axes):
                    buf = spmd.all_gather_raw(buf, a, 0)
            for (i, _), block in zip(members, buf.split(
                    [k for _, k in members], dim=1)):
                p = flat_p[i]
                out[i] = block.reshape(-1)[:p.numel()].view(p.shape)
    return rebuild(out)
