"""Training checkpoints on a filesystem, in the reference's format.

The counterpart of ``hadoop_tpu/parallel/checkpoint.py`` and of the
manifest plan block of ``hadoop_tpu/parallel/elastic/reshard.py``. A
checkpoint written here is the reference's byte for byte, and either
package restores the other's:

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
- **Shards**: one device holds every leaf whole, so each leaf is one
  shard with index ``[[0, d], ...]``. A load assembles any number of
  shards into the global array, so a checkpoint the reference wrote
  under a multi-device plan (without ZeRO-1) loads here too.
- **meta** is ``{"format", "zero1", "plan": dataclasses.asdict(plan)}``;
  ``MeshPlan`` has the reference's fields in its order, and the manifest
  is ``json.dumps`` with default separators.

Publish protocol: shards go straight into the final directory and the
manifest goes last; its presence marks a complete checkpoint. A crash
mid-write leaves a manifest-less directory that readers never see and
the next save's retention sweep removes, which is what makes the write
safe on a background thread (``AsyncCheckpointWriter``).

``snapshot_tree`` copies: the port's train step updates parameters and
moments in place, and on the CPU ``tensor.numpy()`` aliases the live
tensor. A CUDA tensor is copied into pinned host memory (a copy into
pageable memory is staged by the driver and far slower), and every copy
is complete when it returns.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import threading
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from hadoop_tpu_torch.device import resolve_device
from hadoop_tpu_torch.fs import FileSystemLike
from hadoop_tpu_torch.parallel.mesh import MeshPlan

log = logging.getLogger(__name__)

# manifest["meta"]["format"] of plan-bearing checkpoints; readers refuse
# formats they do not know
MANIFEST_FORMAT = "htpu-ckpt-plan-1"


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

def _host_copy(leaf) -> Tuple[str, np.ndarray]:
    """(dtype name, an owned host array of the leaf's bits). A CUDA
    tensor's copy is issued into pinned memory without waiting: the
    caller synchronizes before it reads the array."""
    if isinstance(leaf, torch.Tensor):
        src = leaf.detach()
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

def snapshot_tree(tree) -> List[Dict[str, Any]]:
    """Host snapshot of ``tree``: per leaf, its name, dtype, shape and an
    OWNED copy of its data as one shard. Once it returns, the live
    tensors may be updated in place while a background writer streams
    the copies out."""
    snap: List[Dict[str, Any]] = []
    for name, leaf in leaf_paths(tree):
        dtype, arr = _host_copy(leaf)
        snap.append({"name": name, "dtype": dtype, "shape": list(arr.shape),
                     "shards": [([[0, d] for d in arr.shape], arr)]})
    if any(isinstance(leaf, torch.Tensor) and leaf.is_cuda
           for _, leaf in leaf_paths(tree)):
        torch.cuda.synchronize()    # every copy has landed
    return snap


def write_snapshot(fs: FileSystemLike, base_dir: str, step: int,
                   snap: List[Dict[str, Any]], *, keep: int = 3,
                   meta: Optional[Dict[str, Any]] = None) -> str:
    """Write a host snapshot as one checkpoint (shards first, manifest
    last), then sweep retention. ``meta``: the plan block
    (``manifest_meta``) stored under ``manifest["meta"]``."""
    final_dir = f"{base_dir}/step_{step:012d}"
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

def _retain(fs: FileSystemLike, base_dir: str, keep: int
            ) -> List[Tuple[str, str]]:
    """Retention sweep. Returns (and logs) every ``(path, reason)``
    removed: ``"retention"`` for a complete checkpoint aged past
    ``keep``, ``"crash-mid-write"`` for a manifest-less orphan."""
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


# --------------------------------------------------------------- loading

def load_checkpoint(fs: FileSystemLike, base_dir: str, like, *,
                    step: Optional[int] = None, io_workers: int = 1,
                    device=None, mesh=None, specs=None,
                    leaf_transform: Optional[Callable[[str, torch.Tensor],
                                                      Any]] = None):
    """Load a checkpoint into the structure of ``like``, a tree of
    tensors (any device, ``"meta"`` included: only shapes are read) and
    ints. Returns ``(tree, step)``: each tensor leaf becomes a tensor of
    the checkpoint's dtype on ``device`` (default: the GPU), each int
    leaf an int. Raises ``ValueError`` when a leaf's shape differs from
    ``like``'s, ``KeyError`` when it is missing.

    ``io_workers > 1`` fetches the shard files of the requested leaves
    through a bounded thread pool; only the shards of leaves present in
    ``like`` are read (a serving load never reads optimizer shards).

    ``leaf_transform(name, tensor)`` switches the load to the
    reference's streaming mode: one leaf at a time (its shards fetched
    concurrently) is assembled on the host and handed to the transform
    as a CPU tensor; its result, a tensor or a dict of tensors (the
    weight plane's int8 payload and scales), is what lands on
    ``device``, and the assembled buffer is dropped at once, so host
    memory holds about the largest leaf, never the checkpoint. Sharded
    placement (``mesh``/``specs``) is ROADMAP Queue A 6 and raises.
    """
    if mesh is not None or specs is not None:
        raise NotImplementedError(
            "sharded placement (mesh/specs): the port loads onto one "
            "device; multi-GPU placement is ROADMAP Queue A 6")
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

    raw_by_file: Dict[str, bytes] = {}
    if io_workers > 1:
        needed: List[str] = []
        for name, _ in leaf_paths(like):
            entry = manifest["leaves"].get(name)
            if entry is not None:
                needed.extend(sh["file"] for sh in entry["shards"])
        with ThreadPoolExecutor(max_workers=io_workers) as ex:
            raw_by_file = dict(zip(needed, ex.map(
                lambda f: fs.read_all(f"{ckpt_dir}/{f}"), needed)))

    def build(name, leaf):
        entry = _leaf_entry(manifest, ckpt_dir, name, leaf)
        # pop, don't get: the prefetched bytes free as each leaf is
        # assembled, so peak memory stays ~one checkpoint, not two
        raws = [raw_by_file.pop(sh["file"], None) or
                fs.read_all(f"{ckpt_dir}/{sh['file']}")
                for sh in entry["shards"]]
        out = _assemble(entry, raws)
        if _is_int(leaf):
            return int(out)
        return out.to(dev)

    return map_with_path(build, like), step


def _leaf_entry(manifest: Dict[str, Any], ckpt_dir: str, name: str, leaf
                ) -> Dict[str, Any]:
    """The manifest entry of leaf ``name``, checked against ``like``'s."""
    entry = manifest["leaves"].get(name)
    if entry is None:
        raise KeyError(f"checkpoint {ckpt_dir} missing leaf {name}")
    shape = tuple(entry["shape"])
    if _shape(leaf) != shape:
        raise ValueError(f"shape mismatch for {name}: checkpoint "
                         f"{shape} vs expected {_shape(leaf)}")
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
            entry = _leaf_entry(manifest, ckpt_dir, name, leaf)
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


# ----------------------------------------------------- manifest plan block

def manifest_meta(plan: MeshPlan, *, zero1: bool) -> Dict[str, Any]:
    """The plan-describing manifest block a checkpoint writer embeds."""
    return {"format": MANIFEST_FORMAT,
            "zero1": bool(zero1),
            "plan": dataclasses.asdict(plan)}


def plan_from_meta(meta: Dict[str, Any]) -> MeshPlan:
    if meta.get("format") != MANIFEST_FORMAT:
        raise ValueError(
            f"unknown checkpoint meta format {meta.get('format')!r} "
            f"(this reader understands {MANIFEST_FORMAT!r})")
    return MeshPlan(**meta["plan"])


def resolve_restore(manifest: Dict[str, Any], plan: MeshPlan,
                    zero1: bool) -> Tuple[str, Optional[MeshPlan], bool]:
    """Classify a restore against the manifest's plan block, as the
    reference does: ``(mode, saved_plan, saved_zero1)`` with mode

    - ``"same-plan"``: saved and target plans match exactly;
    - ``"reshard"``: the plans differ (the caller relays the leaves out);
    - ``"legacy"``: the manifest has no plan block; restored as
      same-plan, with a DeprecationWarning.
    """
    meta = manifest.get("meta")
    if not meta or "plan" not in meta:
        warnings.warn(
            "checkpoint manifest has no plan block (written before the "
            "elastic plane); restoring as same-plan — re-save to make "
            "this checkpoint reshardable", DeprecationWarning,
            stacklevel=2)
        return "legacy", None, zero1
    saved_plan = plan_from_meta(meta)
    saved_zero1 = bool(meta.get("zero1", False))
    if saved_plan == plan and saved_zero1 == zero1:
        return "same-plan", saved_plan, saved_zero1
    check_reshardable(saved_plan, plan)
    return "reshard", saved_plan, saved_zero1


def check_reshardable(plan_a: MeshPlan, plan_b: MeshPlan) -> None:
    """Refuse plan changes a restore cannot express (the reference's
    rule: the pipeline stage count may not change)."""
    if plan_a.pp != plan_b.pp or plan_a.vpp != plan_b.vpp:
        raise ValueError(
            "reshard-on-restore cannot change the pipeline stage count: "
            f"checkpoint written under pp={plan_a.pp} vpp={plan_a.vpp}, "
            f"target plan has pp={plan_b.pp} vpp={plan_b.vpp}. A pp "
            "resize re-stacks which layers share a stage, so no host "
            "relayout preserves the optimizer trajectory — restore under "
            "the saved pp, re-save, then change plans.")
