"""SPMD over named parallel axes: the collectives and their transposes.

The counterpart of the ``lax`` collectives that ``hadoop_tpu``'s layers
call inside ``shard_map`` (``psum``, tiled ``all_gather``,
``psum_scatter``, ``ppermute`` (and, as ``hop_raw``, its partial
permutations: a pipeline tick's point-to-point hops), ``all_to_all``,
``axis_index``) and of
the job ``hadoop_tpu/ops/vma.py``'s tracking does there: JAX knows
which mesh axes a value varies over and inserts the cotangent sums of a
replicated value used on rank-divergent paths; PyTorch does not, so the
port names each such site with ``copy_to`` (identity forward, psum
backward, Megatron's "f") and ``psum`` (psum forward, identity
backward, Megatron's "g").

An ``Axis`` has one of two kinds:

- **folded**: the axis's ranks share one device and one process. A
  value is the rank-major stack of every rank's value along dim 0
  (``[R*B, ...]``, rank r's rows r*B..(r+1)*B-1), as
  ``parallel/ring_attention.py`` has always held a ring, and a
  collective is a permute of that stack. Only the permutations
  (``ppermute``, ``all_to_all``) and the raw ``all_gather`` exist on
  it: they are what context parallelism and the device shuffle
  (``parallel/collectives.py``) need, and they agree with a group's.
- **group**: a ``torch.distributed`` process group; each process holds
  its own rank's value.

Sums are deterministic: ``psum`` gathers every rank's value and adds
them in rank order, ``psum_scatter`` exchanges pieces with
``all_to_all`` and adds them in rank order. A sum's bits therefore do
not depend on how its values are bucketed or chunked, nor on the
backend's reduction algorithm (``parallel/overlap.py`` and
``ops/collective_matmul.py`` rely on this for their on/off parity).

Transport: NCCL takes CUDA tensors. Any other backend (gloo) sees a
CUDA tensor's collective through host memory, in ``_to_wire`` /
``_from_wire`` and nowhere else, chosen by the backend the process
group was made with (``_DEVICE_BACKENDS``), never by catching a
failure. The host buffers of a CUDA tensor's wire are page-locked
(``_host_empty``; PyTorch's caching host allocator keeps them), so the
copies to and from the card run at the bus's rate
(``tools/ab_wire.py`` times both kinds). ``traffic`` counts the bytes
each process hands to the wire, per axis name.

``launch`` starts N ranks with ``spawn`` on a backend the caller names.
"""

from __future__ import annotations

import collections
import dataclasses
import datetime
import multiprocessing
import queue
import time
import traceback
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from hadoop_tpu_torch.util.misc import free_port

# backends whose collectives take CUDA tensors as they are
_DEVICE_BACKENDS = frozenset({"nccl"})

# the largest piece a psum gathers at once (bounds its transient memory)
_PIECE_BYTES = 1 << 26

# bytes this process handed to the wire, by axis name
traffic: collections.Counter = collections.Counter()

# wire dtypes gloo has no type for: they travel as their bytes (the
# gathers and exchanges below move values and add nothing on the wire)
_BYTE_WIRE = frozenset({torch.int16, torch.float8_e4m3fn})


@dataclasses.dataclass(frozen=True, eq=False)
class Axis:
    """One named parallel axis of ``size`` ranks: folded (``group`` None)
    or a process group (``ranks``: its global ranks in axis order;
    ``index``: this process's position on it; ``host``: CUDA tensors
    travel through host memory)."""
    name: str
    size: int
    group: Any = None
    ranks: Tuple[int, ...] = ()
    index: int = 0
    host: bool = False

    @property
    def folded(self) -> bool:
        return self.group is None

    def __repr__(self) -> str:
        kind = "folded" if self.folded else f"group {list(self.ranks)}"
        return f"Axis({self.name!r}, {self.size}, {kind})"


def folded(name: str, size: int) -> Axis:
    """An axis of ``size`` ranks held on one device, rank-major in dim 0."""
    if size < 1:
        raise ValueError(f"axis {name!r}: size {size}")
    return Axis(name, size)


def new_groups(name: str, rank_lists: Sequence[Sequence[int]],
               members_only: bool = False) -> Optional[Axis]:
    """Make one process group per list of global ranks and return the
    axis this process lies on, or None if it lies on none. Every process
    of the world calls this with the same lists, in the same order, as
    ``dist.new_group`` requires; with ``members_only``, only the
    processes on the lists do, and each makes only its own list's group
    (``use_local_synchronization``: PyTorch names such a group after its
    ranks and the number of groups its members hold, so the members must
    have made the same groups before)."""
    me = dist.get_rank()
    host = dist.get_backend() not in _DEVICE_BACKENDS
    mine = None
    for ranks in rank_lists:
        ranks = tuple(int(r) for r in ranks)
        if members_only:
            if me not in ranks:
                continue
            group = dist.new_group(list(ranks),
                                   use_local_synchronization=True)
        else:
            group = dist.new_group(list(ranks))
        if me in ranks:
            mine = Axis(name, len(ranks), group, ranks, ranks.index(me),
                        host)
    return mine


def _live(axis: Optional[Axis]) -> bool:
    return axis is not None and axis.size > 1


def _need_group(axis: Axis, what: str) -> None:
    if axis.folded:
        raise ValueError(f"{what} over {axis}: a folded axis has only the "
                         f"permutations (ppermute, all_to_all) and "
                         f"all_gather_raw")


def axis_index(axis: Optional[Axis]) -> int:
    """This process's position on a group axis (0 without one)."""
    if not _live(axis):
        return 0
    _need_group(axis, "axis_index")
    return axis.index


def local_ranks(axis: Optional[Axis], device) -> torch.Tensor:
    """The axis positions of the ranks this process holds, as a long
    tensor: ``arange(size)`` on a folded axis (its ranks are rank-major
    in dim 0), ``[index]`` on a group, ``[0]`` without an axis."""
    if axis is None:
        return torch.zeros(1, dtype=torch.long, device=device)
    if axis.folded:
        return torch.arange(axis.size, device=device)
    return torch.tensor([axis.index], device=device)


# ------------------------------------------------------------ the wire

def _host_empty(shape, dtype: torch.dtype, like: torch.Tensor
                ) -> torch.Tensor:
    """A host buffer for the wire of ``like``: page-locked when ``like``
    lies on the card."""
    return torch.empty(shape, dtype=dtype, pin_memory=like.is_cuda)


def _to_wire(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """The tensor the backend is handed: contiguous, in host memory when
    the backend does not take device tensors."""
    x = x.contiguous()
    traffic[axis.name] += x.numel() * x.element_size()
    if axis.host and x.is_cuda:
        buf = _host_empty(x.shape, x.dtype, x)
        buf.copy_(x)
        return buf
    return x


def _from_wire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    if y.dtype != like.dtype:                 # a byte view (_as_bytes)
        y = y.view(like.dtype)
    return y.to(like.device, non_blocking=True) if y.device != like.device \
        else y


def _as_bytes(w: torch.Tensor) -> torch.Tensor:
    return w.view(torch.uint8) if w.dtype in _BYTE_WIRE else w


def _ordered_sum(stack: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Sum over dim 0 in index order (float32 accumulation for narrower
    floats), cast to ``dtype``, in a buffer of its own (the stack is
    freed once the caller drops it)."""
    acc = stack[0].to(torch.float32 if stack.is_floating_point()
                      else stack.dtype, copy=True)
    for i in range(1, stack.shape[0]):
        acc += stack[i]
    return acc.to(dtype)


# ------------------------------------------------------- the raw forms

def _stack(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Every rank's value, stacked: [P, *x.shape] on every rank."""
    w = _as_bytes(_to_wire(x.reshape(-1), axis))
    out = torch.empty((axis.size * w.numel(),), dtype=w.dtype,
                      device=w.device, pin_memory=w.is_pinned())
    dist.all_gather_into_tensor(out, w, group=axis.group)
    return _from_wire(out, x).view(axis.size, *x.shape)


def psum_raw(x: torch.Tensor, axis: Optional[Axis],
             inplace: bool = False) -> torch.Tensor:
    """Sum of every rank's x, in rank order; no autograd. A tensor of
    more than ``_PIECE_BYTES`` goes in pieces of that size, so the
    gathered stack never holds more than ``size`` pieces (the sum is
    elementwise: the bits do not depend on the cut). ``inplace``: the
    sum overwrites x (contiguous), piece by piece, so a large gradient
    is not held twice."""
    if not _live(axis):
        return x
    _need_group(axis, "psum")
    step = max(1, _PIECE_BYTES // x.element_size())
    if x.numel() <= step and not inplace:
        return _ordered_sum(_stack(x, axis), x.dtype)
    flat = x.view(-1) if inplace else x.reshape(-1)
    out = flat if inplace else torch.empty_like(x).view(-1)
    for start in range(0, flat.numel(), step):
        out[start:start + step] = _ordered_sum(
            _stack(flat[start:start + step], axis), x.dtype)
    return out.view(x.shape)


def broadcast_raw(x: torch.Tensor, axis: Optional[Axis], src: int = 0
                  ) -> torch.Tensor:
    """Axis position ``src``'s x on every rank (the others pass a tensor
    of its shape, dtype and device, which is not written); no autograd.
    Only the sender hands bytes to the wire."""
    if not _live(axis):
        return x
    _need_group(axis, "broadcast")
    if axis.index == src:
        w = _to_wire(x, axis)
    else:
        w = _host_empty(x.shape, x.dtype, x) if axis.host else \
            torch.empty(x.shape, dtype=x.dtype, device=x.device)
    dist.broadcast(w, axis.ranks[src], group=axis.group)
    return x if axis.index == src else _from_wire(w, x)


def pmax_raw(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Elementwise maximum over the axis; no autograd."""
    if not _live(axis):
        return x
    _need_group(axis, "pmax")
    return _stack(x, axis).amax(0)


def all_gather_raw(x: torch.Tensor, axis: Optional[Axis], dim: int
                   ) -> torch.Tensor:
    """Tiled all_gather: every rank's x concatenated along ``dim`` in rank
    order; no autograd. On a folded axis every rank's value is already
    in the stack: ``dim`` is a dim of one rank's value, and the result
    is the gathered value once a rank, stacked."""
    if not _live(axis):
        return x
    if axis.folded:
        p = axis.size
        if x.shape[0] % p:
            raise ValueError(f"folded all_gather of {tuple(x.shape)} over "
                             f"{p} ranks")
        each = x.reshape(p, x.shape[0] // p, *x.shape[1:])
        one = torch.cat(list(each.unbind(0)), dim % x.dim())
        return one.unsqueeze(0).expand(p, *one.shape).reshape(
            p * one.shape[0], *one.shape[1:])
    dim = dim % x.dim()
    st = _stack(x, axis).movedim(0, dim)
    shape = list(x.shape)
    shape[dim] *= axis.size
    return st.reshape(shape)


def _exchange(pieces: torch.Tensor, axis: Axis) -> torch.Tensor:
    """[P, ...] pieces, piece j to rank j → [P, ...], row i from rank i."""
    w = _as_bytes(_to_wire(pieces, axis))
    out = torch.empty(w.shape, dtype=w.dtype, device=w.device,
                      pin_memory=w.is_pinned())
    dist.all_to_all_single(out, w, group=axis.group)
    return _from_wire(out, pieces)


def psum_scatter_raw(x: torch.Tensor, axis: Optional[Axis], dim: int
                     ) -> torch.Tensor:
    """Tiled psum_scatter: rank r gets piece r (along ``dim``) of the sum
    over ranks, added in rank order; no autograd."""
    if not _live(axis):
        return x
    _need_group(axis, "psum_scatter")
    dim = dim % x.dim()
    p = axis.size
    if x.shape[dim] % p:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split {p} ways")
    moved = x.movedim(dim, 0)
    pieces = moved.reshape(p, x.shape[dim] // p, *moved.shape[1:])
    got = _exchange(pieces, axis)
    return _ordered_sum(got, x.dtype).movedim(0, dim)


def all_to_all_raw(x: torch.Tensor, axis: Optional[Axis], split: int,
                   concat: int) -> torch.Tensor:
    """Tiled all_to_all: x split ``size`` ways along ``split``, piece j
    to rank j; the pieces received concatenated along ``concat`` in
    rank order, contiguous (the flash kernels take no other). On a
    folded axis the dims are those of one rank's value (dim 0 is its
    batch and may be neither); no autograd."""
    if not _live(axis):
        return x
    p = axis.size
    if axis.folded:
        b = x.shape[0] // p
        shape = (b, *x.shape[1:])             # one rank's value
        split, concat = split % len(shape), concat % len(shape)
        if 0 in (split, concat) or x.shape[0] % p or shape[split] % p:
            raise ValueError(f"folded all_to_all of {tuple(x.shape)} over "
                             f"{p} ranks: split {split}, concat {concat}")
        xs = x.reshape(p, *shape[:split], p, shape[split] // p,
                       *shape[split + 1:])        # [src, .., dst, n/p, ..]
        xs = xs.movedim(split + 1, 0)             # [dst, src, *piece]
        xs = xs.movedim(1, concat + 1)            # src beside concat dim
        out = list(shape)
        out[split] //= p
        out[concat] *= p
        return xs.reshape(p * b, *out[1:]).contiguous()
    split, concat = split % x.dim(), concat % x.dim()
    if x.shape[split] % p:
        raise ValueError(f"all_to_all: dim {split} of {tuple(x.shape)} "
                         f"does not split {p} ways")
    moved = x.movedim(split, 0)
    pieces = moved.reshape(p, x.shape[split] // p, *moved.shape[1:])
    got = _exchange(pieces, axis).movedim(1, split + 1)   # [src, *piece]
    out = list(x.shape)
    out[split] //= p
    out[concat] *= p
    return got.movedim(0, concat).reshape(out).contiguous()


def ppermute_raw(x: torch.Tensor, axis: Optional[Axis], shift: int = 1
                 ) -> torch.Tensor:
    """Rank i's x goes to rank (i + shift) mod size; no autograd. A group
    posts its send and its receive together (``hop_raw``), so no rank
    waits on another's send."""
    if not _live(axis):
        return x
    if axis.folded:
        p = axis.size
        return torch.roll(x.reshape(p, -1, *x.shape[1:]), shift,
                          dims=0).reshape(x.shape)
    return hop_raw(axis, [(x, shift, 0)], [(x, shift, 0)])[0]


def hop_raw(axis: Optional[Axis],
            sends: Sequence[Tuple[torch.Tensor, int, int]],
            recvs: Sequence[Tuple[torch.Tensor, int, int]]
            ) -> List[torch.Tensor]:
    """One tick of point-to-point hops on a group axis, the counterpart of
    ``lax.ppermute`` with a partial permutation: ``sends`` are
    ``(x, shift, tag)`` (x to the rank ``shift`` places on, mod size),
    ``recvs`` are ``(like, shift, tag)`` (a tensor shaped like ``like``
    from the rank ``shift`` places back). Every send and receive is
    posted before any is waited on, so ranks whose hops cross do not
    wait on each other; the peers must post the matching hops, with the
    same tags, in the same tick. Returns the received tensors in order;
    no autograd."""
    if not _live(axis):
        raise ValueError(f"hop over {axis}: it needs a group of > 1 ranks")
    _need_group(axis, "hop")
    p = axis.size
    reqs, wires, outs = [], [], []
    for x, shift, tag in sends:
        wires.append(_to_wire(x, axis))      # alive until the waits end
        reqs.append(dist.isend(wires[-1],
                               axis.ranks[(axis.index + shift) % p],
                               group=axis.group, tag=tag))
    for like, shift, tag in recvs:
        buf = _host_empty(like.shape, like.dtype, like) if axis.host \
            else torch.empty(like.shape, dtype=like.dtype,
                             device=like.device)
        reqs.append(dist.irecv(buf, axis.ranks[(axis.index - shift) % p],
                               group=axis.group, tag=tag))
        outs.append((buf, like))
    for r in reqs:
        r.wait()
    return [_from_wire(buf, like) for buf, like in outs]


# ------------------------------------------- the differentiable forms

class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return psum_raw(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return psum_raw(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return all_gather_raw(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return psum_scatter_raw(g, ctx.axis, ctx.dim), None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return psum_scatter_raw(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return all_gather_raw(g, ctx.axis, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split, concat):
        ctx.args = (axis, split, concat)
        return all_to_all_raw(x, axis, split, concat)

    @staticmethod
    def backward(ctx, g):
        axis, split, concat = ctx.args
        return all_to_all_raw(g, axis, concat, split), None, None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, shift):
        ctx.axis, ctx.shift = axis, shift
        return ppermute_raw(x, axis, shift)

    @staticmethod
    def backward(ctx, g):
        return ppermute_raw(g, ctx.axis, -ctx.shift), None, None


def psum(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Sum over a group axis; the backward is the identity (the result is
    the same on every rank and counts once: Megatron's "g")."""
    return _Psum.apply(x, axis) if _live(axis) else x


def copy_to(x: torch.Tensor, axis: Optional[Axis]) -> torch.Tensor:
    """Identity forward, psum backward (Megatron's "f"): marks a value
    that is the same on every rank of the axis where it enters
    rank-divergent work, so its gradient sums every rank's part."""
    return _CopyTo.apply(x, axis) if _live(axis) else x


def all_gather(x: torch.Tensor, axis: Optional[Axis], dim: int
               ) -> torch.Tensor:
    """Tiled all_gather along ``dim``; the backward is psum_scatter."""
    return _AllGather.apply(x, axis, dim) if _live(axis) else x


def psum_scatter(x: torch.Tensor, axis: Optional[Axis], dim: int
                 ) -> torch.Tensor:
    """Tiled psum_scatter along ``dim``; the backward is all_gather."""
    return _PsumScatter.apply(x, axis, dim) if _live(axis) else x


def all_to_all(x: torch.Tensor, axis: Optional[Axis], split: int,
               concat: int) -> torch.Tensor:
    """Tiled all_to_all; the backward is the inverse exchange."""
    return _AllToAll.apply(x, axis, split, concat) if _live(axis) else x


def ppermute(x: torch.Tensor, axis: Optional[Axis], shift: int = 1
             ) -> torch.Tensor:
    """Rank i's x to rank i + shift; the backward permutes back."""
    return _Ppermute.apply(x, axis, shift) if _live(axis) else x


# ------------------------------------------------------------ launcher

def _rank_main(fn, rank, world, port, backend, threads, timeout, args,
               results):
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        result = fn(rank, world, *args)
        results.put((rank, True, result))
    except BaseException:                    # report, then let the rank die
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(fn: Callable, world: int, *, backend: str,
           args: Sequence = (), threads: int = 1, timeout: float = 600.0
           ) -> List[Any]:
    """Run ``fn(rank, world, *args)`` on ``world`` ranks, each a process
    started with ``spawn`` (a fresh interpreter: it imports only what
    ``fn``'s module imports) and joined to one ``torch.distributed``
    world on ``backend`` over ``tcp://localhost``. ``fn`` must be a
    module-level function and return something picklable. Returns the
    results in rank order; raises ``RuntimeError`` with the failing
    ranks' tracebacks if any rank raised or died, or if ``timeout``
    seconds pass (a collective that waits longer fails in its rank); once
    a rank fails, the others get 30 s to report before all are killed."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    port = free_port("localhost")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, world, port, backend, threads,
                               timeout, tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    got, errors = {}, []
    try:
        deadline = time.monotonic() + timeout
        while len(got) + len(errors) < world:
            left = deadline - time.monotonic()
            if left <= 0:
                errors.append(f"timed out after {timeout} s")
                break
            try:
                rank, ok, value = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    errors.append("ranks died: " + ", ".join(
                        f"{procs.index(p)} (exit {p.exitcode})"
                        for p in dead))
                    break
                continue
            if ok:
                got[rank] = value
            else:                 # the others get a short while to report
                errors.append(f"rank {rank}:\n{value}")
                deadline = min(deadline, time.monotonic() + 30)
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 5)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("spmd.launch: " + "\n".join(errors))
    return [got[r] for r in range(world)]
