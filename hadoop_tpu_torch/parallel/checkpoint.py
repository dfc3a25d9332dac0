"""Training checkpoints on a filesystem, in the reference's format.

The counterpart of ``hadoop_tpu/parallel/checkpoint.py``; the manifest
plan block (``manifest_meta``, ``resolve_restore``, ...) lives in
``parallel/elastic/reshard.py``, as in the reference, and is re-exported
here. A checkpoint written here is the reference's, and either package
restores the other's:

    <dir>/step_<N>/shard_<i>.bin        one file per shard, in leaf order
    <dir>/step_<N>/manifest.json        leaf names, dtypes, shapes and the
                                        shard index map, written LAST

- **Leaf names** are the strings ``jax.tree_util.keystr`` gives, made
  here without JAX: a dict key ``k`` is ``[repr(k)]`` and dict keys are
  walked in sorted order; a NamedTuple field is ``.field``, in
  declaration order; a list or tuple item is ``[i]``. So the trainer's
  ``{"params", "opt": AdamWState(count, mu, nu), "data_pos"}`` names its
  leaves ``['data_pos']``, ``['opt'].count``, ``['opt'].mu['embed']``,
  ... ``['params']['lm_head']``, and shard files are numbered in that
  order.
- **dtypes** are numpy's names. numpy has no bfloat16 here, so a bf16
  leaf is written as its raw 16-bit patterns under the name
  ``"bfloat16"`` (the bytes JAX writes) and read back through a 16-bit
  view. A Python ``int`` leaf (``AdamWState.count``) is an int32 scalar
  on disk and an ``int`` again when loaded.
- **Shards**: on one device each leaf is one shard with index
  ``[[0, d], ...]``, and the checkpoint is the reference's byte for
  byte. A load assembles any number of shards into the global array.
- **meta** is ``{"format", "zero1", "plan": dataclasses.asdict(plan)}``;
  ``MeshPlan`` has the reference's fields in its order, and the manifest
  is ``json.dumps`` with default separators.

Publish protocol: shards go straight into the final directory and the
manifest goes last; its presence marks a complete checkpoint. A crash
mid-write leaves a manifest-less directory that readers never see and
the next save's retention sweep removes, which is what makes the write
safe on a background thread (``AsyncCheckpointWriter``).

**On a mesh** (one process per rank, ``parallel/mesh.py``) every rank
writes one checkpoint together:

- ``mesh_pieces`` gives each leaf's global shape and the pieces of this
  rank's local tensor with their global index. A leaf replicated over an
  axis is written by the rank at coordinate 0 of that axis only, so
  every global element is written once. A ZeRO-1 moment's spec names
  every leading dim of its ``(*spec sizes, *data sizes, K)`` layout, and
  the rank's ``(K,)`` slice is its row. Under an interleaved plan a
  layer leaf's physical stage block is cut along axis 0 into its logical
  chunks, each written at its logical index, so the file holds logical
  layer order (the reference collapses such a leaf to one full-array
  shard; the assembled leaves are equal).
- Rank r names its shard files ``shard_r<r>_<i>.bin`` and, when they are
  written, publishes a small part file listing them
  (``part_r<r>.<token>.json``, written under a temporary name and
  renamed). Rank 0's writer waits for every rank's part file, merges
  them into the manifest, writes it last and sweeps retention, alone.
  No collective runs on a writer thread: the ranks coordinate through
  the filesystem. A rank whose write fails leaves a ``.failed`` marker,
  and rank 0 fails the save at once; a part file that never comes fails
  it after ``PART_TIMEOUT_S``. Either failure surfaces at rank 0's next
  fence. The token is the save's, the same on every rank, so part files
  of an earlier attempt at the same step are never merged.
- ``load_checkpoint(..., mesh=, specs=)`` reads, per leaf, only the
  shard files that overlap this rank's block, and returns this rank's
  shards: ``shard_params`` of the assembled tree, and ZeRO-1 rows where
  the specs say so.

``snapshot_tree`` copies: the port's train step updates parameters and
moments in place, and on the CPU ``tensor.numpy()`` aliases the live
tensor. A CUDA tensor is copied into pinned host memory (a copy into
pageable memory is staged by the driver and far slower), and every copy
is complete when it returns.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from itertools import product
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hadoop_tpu_torch.device import resolve_device
from hadoop_tpu_torch.fs import FileSystemLike
from hadoop_tpu_torch.parallel.elastic.reshard import (  # noqa: F401
    MANIFEST_FORMAT, check_reshardable, manifest_meta, plan_from_meta,
    resolve_restore)
from hadoop_tpu_torch.parallel.mesh import ONE_RANK

log = logging.getLogger(__name__)

# how long rank 0 waits for the other ranks' part files of a save
PART_TIMEOUT_S = 600.0

# ------------------------------------------------------------- leaf names

def _is_namedtuple(node) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """``(name, leaf)`` for every leaf of nested dicts, NamedTuples, lists
    and tuples, in JAX's flattening order, named as ``keystr`` names
    them."""
    if isinstance(tree, dict):
        return [item for key in sorted(tree)
                for item in leaf_paths(tree[key], f"{prefix}[{key!r}]")]
    if _is_namedtuple(tree):
        return [item for field, value in zip(tree._fields, tree)
                for item in leaf_paths(value, f"{prefix}.{field}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, value in enumerate(tree)
                for item in leaf_paths(value, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """A tree of the same structure with ``fn(name, leaf)`` at each leaf."""
    if isinstance(tree, dict):
        return {key: map_with_path(fn, value, f"{prefix}[{key!r}]")
                for key, value in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, value, f"{prefix}.{field}")
                            for field, value in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, value, f"{prefix}[{i}]")
                          for i, value in enumerate(tree))
    return fn(prefix, tree)


# ---------------------------------------------------------------- dtypes

def _host_copy(leaf, part=None) -> Tuple[str, np.ndarray]:
    """(dtype name, an owned host array of the leaf's bits), of the
    leaf's ``part`` (a tuple of slices) when given. A CUDA tensor is
    copied into pinned memory without waiting: the caller synchronizes
    before it reads the array."""
    if isinstance(leaf, torch.Tensor):
        src = leaf.detach()
        if part is not None:
            src = src[part]
        if src.is_cuda:
            t = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
            t.copy_(src, non_blocking=True)
        else:
            t = src.clone()
        if t.dtype == torch.bfloat16:
            return "bfloat16", t.view(torch.int16).numpy()
        arr = t.numpy()
    elif _is_int(leaf):
        arr = np.asarray(leaf, np.int32)
    else:
        arr = np.array(leaf, copy=True)
    return str(arr.dtype), arr


def _bits_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a stored dtype's bits."""
    return np.dtype(np.int16) if name == "bfloat16" else np.dtype(name)


def _is_int(leaf) -> bool:
    return isinstance(leaf, int) and not isinstance(leaf, bool)


def _shape(leaf) -> Tuple[int, ...]:
    return () if _is_int(leaf) else tuple(leaf.shape)


def _dtype_name(leaf) -> str:
    """The stored dtype name of a ``like`` leaf."""
    if _is_int(leaf):
        return "int32"
    return str(leaf.dtype).replace("torch.", "")


def mismatched_leaves(manifest: Dict[str, Any], like) -> List[str]:
    """The leaves of ``like`` that the manifest lacks or stores at another
    shape or dtype, as ``"name: why"``; reads no shard."""
    bad = []
    for name, leaf in leaf_paths(like):
        entry = manifest["leaves"].get(name)
        if entry is None:
            bad.append(f"{name}: missing")
        elif (tuple(entry["shape"]), entry["dtype"]) != \
                (_shape(leaf), _dtype_name(leaf)):
            bad.append(f"{name}: {entry['dtype']}{entry['shape']}, expected "
                       f"{_dtype_name(leaf)}{list(_shape(leaf))}")
    return bad


# --------------------------------------------------------------- writing

def snapshot_tree(tree, pieces: Optional[Callable[[str, Any], Any]] = None
                  ) -> List[Dict[str, Any]]:
    """Host snapshot of ``tree``: per leaf, its name, dtype, global shape
    and OWNED copies of its shards. Once it returns, the live tensors may
    be updated in place while a background writer streams the copies
    out.

    Without ``pieces`` each leaf is one whole shard. ``pieces(name,
    leaf)`` (on a mesh: ``mesh_pieces``) returns None for that, or
    ``(global shape, [(index, part), ...])``: the parts of the local
    leaf to copy (tuples of slices) and their global indices; a leaf with
    no part is not in this rank's snapshot."""
    snap: List[Dict[str, Any]] = []
    for name, leaf in leaf_paths(tree):
        cut = pieces(name, leaf) if pieces is not None else None
        if cut is None:
            dtype, arr = _host_copy(leaf)
            snap.append({"name": name, "dtype": dtype,
                         "shape": list(arr.shape),
                         "shards": [([[0, d] for d in arr.shape], arr)]})
            continue
        gshape, parts = cut
        if not parts:
            continue
        shards = []
        for index, part in parts:
            dtype, arr = _host_copy(leaf, part)
            shards.append((index, arr.reshape([b - a for a, b in index])))
        snap.append({"name": name, "dtype": dtype, "shape": list(gshape),
                     "shards": shards})
    if any(isinstance(leaf, torch.Tensor) and leaf.is_cuda
           for _, leaf in leaf_paths(tree)):
        torch.cuda.synchronize()    # every copy has landed
    return snap


def write_snapshot(fs: FileSystemLike, base_dir: str, step: int,
                   snap: List[Dict[str, Any]], *, keep: int = 3,
                   meta: Optional[Dict[str, Any]] = None, rank: int = 0,
                   world: int = 1, token: str = "") -> str:
    """Write a host snapshot as one checkpoint (shards first, manifest
    last), then sweep retention. ``meta``: the plan block
    (``manifest_meta``) stored under ``manifest["meta"]``.

    With ``world`` > 1 every rank calls this with its own snapshot and
    the save's ``token`` (the same on every rank): see the module doc.
    Rank 0 returns once the manifest is written; the others once their
    part file is."""
    final_dir = f"{base_dir}/step_{step:012d}"
    if world > 1:
        return _write_rank_part(fs, base_dir, step, snap, keep, meta, rank,
                                world, token)
    fs.delete(final_dir, recursive=True)
    fs.mkdirs(final_dir)

    manifest: Dict[str, Any] = {"step": step, "leaves": {}, "shards": []}
    if meta is not None:
        manifest["meta"] = meta
    shard_idx = 0
    for entry in snap:
        mentry: Dict[str, Any] = {
            "dtype": entry["dtype"],
            "shape": entry["shape"],
            "shards": [],
        }
        for index, data in entry["shards"]:
            fname = f"shard_{shard_idx:06d}.bin"
            shard_idx += 1
            fs.write_all(f"{final_dir}/{fname}", data.tobytes())
            mentry["shards"].append({"file": fname, "index": index})
        manifest["leaves"][entry["name"]] = mentry
    fs.write_all(f"{final_dir}/manifest.json",
                 json.dumps(manifest).encode())
    _retain(fs, base_dir, keep)
    return final_dir


def _part_name(rank: int, token: str) -> str:
    return f"part_r{rank}.{token}"


def _write_rank_part(fs: FileSystemLike, base_dir: str, step: int,
                     snap: List[Dict[str, Any]], keep: int,
                     meta: Optional[Dict[str, Any]], rank: int, world: int,
                     token: str) -> str:
    """One rank's share of a checkpoint on a mesh: its shard files, then
    its part file; on rank 0, then the merged manifest and retention."""
    final_dir = f"{base_dir}/step_{step:012d}"
    part = f"{final_dir}/{_part_name(rank, token)}"
    try:
        fs.mkdirs(final_dir)
        leaves: Dict[str, Any] = {}
        n = 0
        for entry in snap:
            shards = []
            for index, data in entry["shards"]:
                fname = f"shard_r{rank}_{n:06d}.bin"
                n += 1
                fs.write_all(f"{final_dir}/{fname}", data.tobytes())
                shards.append({"file": fname, "index": index})
            leaves[entry["name"]] = {"dtype": entry["dtype"],
                                     "shape": entry["shape"],
                                     "shards": shards}
        # written whole under another name, then renamed: rank 0 never
        # reads half a part file
        fs.write_all(f"{part}.tmp", json.dumps(
            {"rank": rank, "leaves": leaves}).encode())
        fs.rename(f"{part}.tmp", f"{part}.json")
    except BaseException:
        try:                 # tell rank 0 at once (best effort)
            fs.write_all(f"{part}.failed", b"")
        except Exception:  # noqa: BLE001 — the write's own error wins
            pass
        raise
    if rank != 0:
        return final_dir
    parts = _await_parts(fs, final_dir, step, world, token)
    manifest: Dict[str, Any] = {"step": step, "leaves": {}, "shards": []}
    if meta is not None:
        manifest["meta"] = meta
    for got in parts:                      # rank order: rank 0 first
        for name, entry in got["leaves"].items():
            have = manifest["leaves"].get(name)
            if have is None:
                manifest["leaves"][name] = dict(entry)
                continue
            if (have["dtype"], have["shape"]) != (entry["dtype"],
                                                   entry["shape"]):
                raise IOError(
                    f"checkpoint step {step}: rank {got['rank']} holds "
                    f"{name} as {entry['dtype']}{entry['shape']}, rank 0 "
                    f"as {have['dtype']}{have['shape']}")
            have["shards"] = have["shards"] + entry["shards"]
    for r in range(world):
        fs.delete(f"{final_dir}/{_part_name(r, token)}.json")
    fs.write_all(f"{final_dir}/manifest.json",
                 json.dumps(manifest).encode())
    _retain(fs, base_dir, keep, newest=step)
    return final_dir


def _await_parts(fs: FileSystemLike, final_dir: str, step: int, world: int,
                 token: str) -> List[Dict[str, Any]]:
    """Every rank's part file of this save, in rank order; raises
    ``IOError`` when a rank marked its write failed, or when a part file
    has not come after ``PART_TIMEOUT_S``."""
    got: Dict[int, Dict[str, Any]] = {}
    deadline = time.monotonic() + PART_TIMEOUT_S
    while True:
        for r in range(world):
            base = f"{final_dir}/{_part_name(r, token)}"
            if r in got:
                continue
            if fs.exists(f"{base}.failed"):
                raise IOError(f"checkpoint step {step}: rank {r} failed "
                              f"its write")
            if fs.exists(f"{base}.json"):
                got[r] = json.loads(fs.read_all(f"{base}.json").decode())
        if len(got) == world:
            return [got[r] for r in range(world)]
        if time.monotonic() > deadline:
            missing = [r for r in range(world) if r not in got]
            raise IOError(f"checkpoint step {step}: no part file from "
                          f"ranks {missing} after {PART_TIMEOUT_S} s")
        time.sleep(0.02)


def assemble_snapshot_leaf(entry: Dict[str, Any]) -> np.ndarray:
    """One snapshot entry's full host array (its bits, for bfloat16),
    reassembled from shards."""
    out = np.empty(tuple(entry["shape"]), _bits_dtype(entry["dtype"]))
    for index, data in entry["shards"]:
        out[tuple(slice(a, b) for a, b in index)] = data
    return out


def save_checkpoint(fs: FileSystemLike, base_dir: str, step: int, tree, *,
                    keep: int = 3,
                    meta: Optional[Dict[str, Any]] = None) -> str:
    """Write one checkpoint of ``tree`` synchronously (snapshot_tree +
    write_snapshot), keeping the newest ``keep``. Returns its
    directory."""
    return write_snapshot(fs, base_dir, step, snapshot_tree(tree),
                          keep=keep, meta=meta)


class AsyncCheckpointWriter:
    """One background writer thread, at most one write in flight.

    ``submit`` fences the previous write (so checkpoints land in order
    and a slow filesystem never piles up host snapshots), then runs the
    job on a fresh daemon thread. A failed write surfaces at the NEXT
    fence (``wait()`` or the next ``submit``), exactly once; the job
    that failed left a manifest-less directory, so the previous complete
    checkpoint still wins.
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()

    def submit(self, fn: Callable[[], Any]) -> None:
        """Fence the previous write, then run ``fn`` in the background."""
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:  # noqa: BLE001 — deferred to wait()
                log.warning("async checkpoint write failed: %s", e)
                with self._lock:
                    self._error = e

        t = threading.Thread(target=run, daemon=True, name="ckpt-writer")
        with self._lock:
            self._thread = t
        t.start()

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until the in-flight write (if any) finishes; re-raise
        its error exactly once."""
        with self._lock:
            t = self._thread
        if t is not None:
            t.join(timeout)
            if t.is_alive():
                raise TimeoutError("checkpoint write still in flight")
            with self._lock:
                if self._thread is t:
                    self._thread = None
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise err

    @property
    def in_flight(self) -> bool:
        with self._lock:
            t = self._thread
        return t is not None and t.is_alive()


# ------------------------------------------------------ listing, retention

def _retain(fs: FileSystemLike, base_dir: str, keep: int,
            newest: Optional[int] = None) -> List[Tuple[str, str]]:
    """Retention sweep. Returns (and logs) every ``(path, reason)``
    removed: ``"retention"`` for a complete checkpoint aged past
    ``keep``, ``"crash-mid-write"`` for a manifest-less orphan. On a
    mesh (``newest``: the step just published) only orphans older than
    it are swept: the other ranks may already be writing a later
    save."""
    swept: List[Tuple[str, str]] = []
    steps = list_checkpoints(fs, base_dir)
    complete = {f"step_{s:012d}" for s in steps}
    for step in steps[:-keep] if keep > 0 else []:
        path = f"{base_dir}/step_{step:012d}"
        fs.delete(path, recursive=True)
        complete.discard(f"step_{step:012d}")
        swept.append((path, "retention"))
    # manifest-less orphans of crashed publishes (single writer: any
    # incomplete step directory other than the one just written is ours)
    try:
        entries = fs.list_status(base_dir)
    except (IOError, OSError, FileNotFoundError):
        entries = []
    for st in entries:
        name = st.path.rstrip("/").rsplit("/", 1)[-1]
        if name.startswith("step_") and name not in complete:
            if newest is not None and (not name[5:].isdigit() or
                                       int(name[5:]) >= newest):
                continue
            path = f"{base_dir}/{name}"
            fs.delete(path, recursive=True)
            swept.append((path, "crash-mid-write"))
    for path, reason in swept:
        log.info("checkpoint sweep: path=%s reason=%s keep=%d",
                 path, reason, keep)
    return swept


def list_checkpoints(fs: FileSystemLike, base_dir: str) -> List[int]:
    """Complete (manifest-bearing) checkpoint steps, ascending."""
    try:
        entries = fs.list_status(base_dir)
    except (IOError, OSError, FileNotFoundError):
        return []
    steps = []
    for st in entries:
        name = st.path.rstrip("/").rsplit("/", 1)[-1]
        if name.startswith("step_") and not name.endswith("._tmp"):
            if fs.exists(f"{base_dir}/{name}/manifest.json"):
                steps.append(int(name[len("step_"):]))
    return sorted(steps)


def latest_step(fs: FileSystemLike, base_dir: str) -> Optional[int]:
    steps = list_checkpoints(fs, base_dir)
    return steps[-1] if steps else None


def read_manifest(fs: FileSystemLike, base_dir: str, step: int
                  ) -> Dict[str, Any]:
    """One checkpoint's manifest."""
    path = f"{base_dir}/step_{step:012d}/manifest.json"
    return json.loads(fs.read_all(path).decode())


# --------------------------------------------------------- mesh layout

def spec_paths(specs, prefix: str = "") -> Dict[str, Any]:
    """``{leaf name: spec}`` of a specs tree: dicts and NamedTuples are
    walked as in ``leaf_paths``; any other value (a spec tuple, None) is
    a leaf."""
    if isinstance(specs, dict):
        return {name: spec for key in sorted(specs)
                for name, spec in spec_paths(specs[key],
                                             f"{prefix}[{key!r}]").items()}
    if _is_namedtuple(specs):
        return {name: spec for field, value in zip(specs._fields, specs)
                for name, spec in spec_paths(value,
                                             f"{prefix}.{field}").items()}
    return {prefix: specs}


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def _ways(entry, sizes: Dict[str, int]) -> int:
    n = 1
    for a in _names(entry):
        n *= sizes[a]
    return n


def global_shape(local_shape: Sequence[int], spec, sizes: Dict[str, int]
                 ) -> Tuple[int, ...]:
    """The global shape of a leaf whose local shape is ``local_shape``
    under ``spec`` (one entry per global dim: an axis, a tuple of axes or
    None; missing trailing entries are None). A spec longer than the
    local shape names leading dims the rank holds one row of: a ZeRO-1
    moment, ``(*spec axes, *data axes, None)`` over a ``(K,)`` slice."""
    spec = tuple(spec or ())
    extra = len(spec) - len(local_shape)
    if extra < 0:
        spec += (None,) * -extra
        extra = 0
    if any(e is None for e in spec[:extra]):
        raise ValueError(f"spec {spec} does not fit local shape "
                         f"{tuple(local_shape)}")
    return tuple(_ways(e, sizes) for e in spec[:extra]) + tuple(
        n * _ways(e, sizes) for n, e in zip(local_shape, spec[extra:]))


def local_shape(gshape: Sequence[int], spec, sizes: Dict[str, int]
                ) -> Tuple[int, ...]:
    """A rank's shard shape of a global array cut by ``spec`` (the
    inverse of ``global_shape`` for a spec with an entry per dim or
    fewer)."""
    spec = tuple(spec or ()) + (None,) * (len(gshape) - len(spec or ()))
    return tuple(n // _ways(e, sizes) for n, e in zip(gshape, spec))


def _block_runs(spec, gshape: Sequence[int], mesh, perm=None
                ) -> List[List[Tuple[int, int, int]]]:
    """This rank's block of a global array, per dim, as runs of
    ``(local offset, global start, length)``. ``perm`` (axis 0's
    physical → logical order, under an interleaved plan) maps the
    block's rows to logical rows, in runs of consecutive ones."""
    sizes = mesh.plan.sizes
    spec = tuple(spec or ()) + (None,) * (len(gshape) - len(spec or ()))
    runs = []
    for d, (n, entry) in enumerate(zip(gshape, spec)):
        ways = _ways(entry, sizes)
        c = 0
        for a in _names(entry):
            c = c * sizes[a] + mesh.index(a)
        start, stop = c * (n // ways), (c + 1) * (n // ways)
        if d == 0 and perm is not None:
            rows = [int(r) for r in perm[start:stop]]
            dim = []
            for off, r in enumerate(rows):
                if dim and dim[-1][1] + dim[-1][2] == r:
                    lo, g, k = dim[-1]
                    dim[-1] = (lo, g, k + 1)
                else:
                    dim.append((off, r, 1))
            runs.append(dim)
        else:
            runs.append([(0, start, stop - start)])
    return runs


def rank_block(arr: np.ndarray, spec, mesh, perm=None) -> np.ndarray:
    """This rank's block of a global host array under ``spec`` (a ZeRO-1
    moment's: its row, with the leading dims kept at 1). ``perm``: as in
    ``_block_runs``."""
    runs = _block_runs(spec, arr.shape, mesh, perm)
    out = np.empty([sum(k for _, _, k in dim) for dim in runs], arr.dtype)
    for combo in product(*runs):
        out[tuple(slice(lo, lo + k) for lo, _, k in combo)] = \
            arr[tuple(slice(g, g + k) for _, g, k in combo)]
    return out


def _writes(spec, mesh) -> bool:
    """Whether this rank writes a leaf: it is at coordinate 0 of every
    axis of more than one rank that the spec does not name (the leaf is
    replicated over those)."""
    named = {a for entry in (spec or ()) for a in _names(entry)}
    return all(mesh.index(a) == 0 for a, n in mesh.plan.sizes.items()
               if n > 1 and a not in named)


def mesh_pieces(spec, leaf, mesh, perm=None):
    """``snapshot_tree``'s pieces of one local leaf on ``mesh`` under
    ``spec``: ``(global shape, [(index, part), ...])``, no part when the
    rank does not write the leaf (``_writes``). ``perm``: as in
    ``_block_runs``."""
    local = _shape(leaf)
    gshape = global_shape(local, spec, mesh.plan.sizes)
    if not _writes(spec, mesh):
        return gshape, []
    runs = _block_runs(spec, gshape, mesh, perm)
    extra = len(gshape) - len(local)
    pieces = []
    for combo in product(*runs):
        index = [[g, g + k] for _, g, k in combo]
        if extra:            # a ZeRO-1 row: the whole local slice
            pieces.append((index, None))
            continue
        part = tuple(slice(lo, lo + k) for lo, _, k in combo)
        pieces.append((index, part))
    return gshape, pieces


# --------------------------------------------------------------- loading

def load_checkpoint(fs: FileSystemLike, base_dir: str, like, *,
                    step: Optional[int] = None, io_workers: int = 1,
                    device=None, mesh=None, specs=None,
                    leaf_transform: Optional[Callable[[str, torch.Tensor],
                                                      Any]] = None,
                    permute: Optional[Callable[[str], Any]] = None):
    """Load a checkpoint into the structure of ``like``, a tree of
    tensors (any device, ``"meta"`` included: only shapes are read) and
    ints. Returns ``(tree, step)``: each tensor leaf becomes a tensor of
    the checkpoint's dtype on ``device`` (default: the GPU), each int
    leaf an int. Raises ``ValueError`` when a leaf's shape differs from
    ``like``'s, ``KeyError`` when it is missing; every leaf is checked
    before a shard is read.

    ``io_workers > 1`` fetches the shard files of the requested leaves
    through a bounded thread pool; only the shards of leaves present in
    ``like`` are read (a serving load never reads optimizer shards).

    ``mesh`` and ``specs`` (a tree like ``like`` of spec tuples, as
    ``mesh.param_specs``; a ZeRO-1 moment's names its leading dims, see
    ``global_shape``) load this rank's shards: ``like`` holds the local
    leaves, each is checked against the global shape it implies, and
    only the shard files overlapping the rank's block are read. Without
    them the load is the one-rank case of the same path (``ONE_RANK``):
    whole leaves. ``permute(name)``: axis 0's physical → logical order
    of a leaf laid out for an interleaved plan (None: none).

    ``leaf_transform(name, tensor)`` switches the load to the
    reference's streaming mode: one leaf at a time (its shards fetched
    concurrently) is assembled on the host and handed to the transform
    as a CPU tensor; its result, a tensor or a dict of tensors (the
    weight plane's int8 payload and scales), is what lands on
    ``device``, and the assembled buffer is dropped at once, so host
    memory holds about the largest leaf, never the checkpoint. With
    sharded placement it raises, as the reference's does: the transform
    sees whole leaves on the host.
    """
    if leaf_transform is not None and (mesh is not None or
                                       specs is not None):
        raise NotImplementedError(
            "leaf_transform streams leaves through a host-side "
            "transform and cannot compose with sharded placement")
    if (mesh is None) != (specs is None):
        raise ValueError("mesh and specs go together")
    dev = resolve_device(device)
    if step is None:
        step = latest_step(fs, base_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {base_dir}")
    ckpt_dir = f"{base_dir}/step_{step:012d}"
    manifest = read_manifest(fs, base_dir, step)
    if leaf_transform is not None:
        return _load_streaming(fs, ckpt_dir, manifest, like, step, dev,
                               io_workers, leaf_transform)
    return _load_blocks(fs, ckpt_dir, manifest, like, specs,
                        mesh or ONE_RANK, dev, io_workers, permute), step


def read_global_leaf(fs: FileSystemLike, base_dir: str, step: int,
                     name: str, manifest: Optional[Dict[str, Any]] = None
                     ) -> torch.Tensor:
    """One leaf of a checkpoint at its global shape, put together from
    every shard file of it: a host tensor of the checkpoint's dtype.
    ``manifest``: the step's, when the caller has read it."""
    if manifest is None:
        manifest = read_manifest(fs, base_dir, step)
    ckpt_dir = f"{base_dir}/step_{step:012d}"
    entry = manifest["leaves"].get(name)
    if entry is None:
        raise KeyError(f"checkpoint {ckpt_dir} missing leaf {name}")
    return _assemble(entry, [fs.read_all(f"{ckpt_dir}/{sh['file']}")
                             for sh in entry["shards"]])


def _leaf_entry(manifest: Dict[str, Any], ckpt_dir: str, name: str,
                want: Tuple[int, ...]) -> Dict[str, Any]:
    """The manifest entry of leaf ``name``, checked against the global
    shape ``want``."""
    entry = manifest["leaves"].get(name)
    if entry is None:
        raise KeyError(f"checkpoint {ckpt_dir} missing leaf {name}")
    shape = tuple(entry["shape"])
    if shape != tuple(want):
        raise ValueError(f"shape mismatch for {name}: checkpoint "
                         f"{shape} vs expected {tuple(want)}")
    return entry


def _assemble(entry: Dict[str, Any], raws: List[bytes]) -> torch.Tensor:
    """One leaf from its shards' bytes, as a host tensor of the
    checkpoint's dtype (bf16 from its 16-bit patterns)."""
    dtype = _bits_dtype(entry["dtype"])
    out = np.empty(tuple(entry["shape"]), dtype)
    for sh, raw in zip(entry["shards"], raws):
        idx = tuple(slice(a, b) for a, b in sh["index"])
        sub_shape = tuple(b - a for a, b in sh["index"])
        out[idx] = np.frombuffer(raw, dtype).reshape(sub_shape)
    t = torch.from_numpy(out)
    if entry["dtype"] == "bfloat16":
        t = t.view(torch.bfloat16)
    return t


def _load_streaming(fs: FileSystemLike, ckpt_dir: str, manifest: Dict,
                    like, step: int, dev: torch.device, io_workers: int,
                    leaf_transform: Callable[[str, torch.Tensor], Any]):
    """The ``leaf_transform`` mode of :func:`load_checkpoint`: one leaf
    in flight (its shard files fetched concurrently), the transform's
    result placed on ``dev``, the host assembly dropped."""
    with ThreadPoolExecutor(max_workers=max(1, io_workers)) as ex:
        def build(name, leaf):
            entry = _leaf_entry(manifest, ckpt_dir, name, _shape(leaf))
            raws = list(ex.map(
                lambda sh: fs.read_all(f"{ckpt_dir}/{sh['file']}"),
                entry["shards"]))
            out = _assemble(entry, raws)
            del raws
            if _is_int(leaf):
                return int(out)
            res = leaf_transform(name, out)
            del out
            if isinstance(res, dict):
                return {k: v.to(dev) for k, v in res.items()}
            return res.to(dev)

        tree = map_with_path(build, like)
    return tree, step


def _load_blocks(fs: FileSystemLike, ckpt_dir: str, manifest: Dict,
                 like, specs, mesh, dev: torch.device, io_workers: int,
                 permute):
    """The load of ``load_checkpoint`` (without ``leaf_transform``): per
    leaf, the rank's block assembled from the shard files that overlap
    it; on one rank (``ONE_RANK``, no specs) the whole leaf. Every leaf is
    checked before a shard is read. ``io_workers > 1`` fetches the files
    of all the leaves through a bounded pool, each file's bytes freed as
    its leaf is assembled."""
    spec_of = spec_paths(specs) if specs is not None else {}
    sizes = mesh.plan.sizes
    todo = []          # (name, local shape, dtype name, block, work)
    for name, leaf in leaf_paths(like):
        spec = spec_of.get(name)
        local = _shape(leaf)
        entry = _leaf_entry(manifest, ckpt_dir, name,
                            global_shape(local, spec, sizes))
        runs = _block_runs(spec, entry["shape"], mesh,
                           permute(name) if permute else None)
        work = []
        for sh in entry["shards"]:
            cuts = []
            for combo in product(*runs):
                dst, src = [], []
                for (lo, g, k), (a, b) in zip(combo, sh["index"]):
                    x0, x1 = max(g, a), min(g + k, b)
                    if x0 >= x1:
                        break
                    dst.append(slice(lo + x0 - g, lo + x1 - g))
                    src.append(slice(x0 - a, x1 - a))
                else:
                    cuts.append((tuple(dst), tuple(src)))
            if cuts:
                work.append((sh, cuts))
        todo.append((name, local, entry["dtype"],
                     [sum(k for _, _, k in dim) for dim in runs], work))
    files = [sh["file"] for *_, work in todo for sh, _ in work]

    def read(f):
        return fs.read_all(f"{ckpt_dir}/{f}")

    out: Dict[str, Any] = {}
    with ThreadPoolExecutor(max_workers=max(1, io_workers)) as ex:
        raws = ex.map(read, files) if io_workers > 1 else map(read, files)
        for name, local, dtype_name, block, work in todo:
            dtype = _bits_dtype(dtype_name)
            arr = np.empty(block, dtype)
            for (sh, cuts), raw in zip(work, raws):
                data = np.frombuffer(raw, dtype).reshape(
                    [b - a for a, b in sh["index"]])
                for dst, src in cuts:
                    arr[dst] = data[src]
            t = torch.from_numpy(arr.reshape(local))
            if dtype_name == "bfloat16":
                t = t.view(torch.bfloat16)
            out[name] = t.to(dev)
    return map_with_path(lambda name, leaf: int(out[name]) if _is_int(leaf)
                         else out[name], like)
