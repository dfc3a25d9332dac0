"""Rank programs for ``spmd.launch``: the collectives drill and the plan
runner.

``collectives(rank, world, seed)`` runs every ``spmd`` collective (and
the bucketed forms of ``parallel/overlap.py``) on inputs made from
``seed``, forward and backward, and returns this rank's results as
numpy arrays; on the folded kind it also runs the permutations over the
whole stack, for a caller to hold the two kinds against each other.

``train_plans(rank, world, jobs)`` trains each plan of each job in turn
on one world: the mesh, this rank's shards of one full
parameter tree (``job["weights"]``, a numpy tree, or ``job["seed"]``
for ``init_params`` on every rank; laid out for the plan's vpp by
``init_sharded``), ``n_steps`` steps on this rank's cut of
``job["tokens"]``/``job["targets"]``, then the trained tree in
checkpoint layer order (every element, or a fixed sample of flat
indices of each leaf, put together from the shards; or nothing). Per
plan it records losses, grad norms and, on a CUDA device, each step's
time (CUDA events), the kernels' launches per step (``COUNTERS``), peak
memory and the bytes each axis put on the wire; under pp, the rank's stage and the most stage inputs its schedule
stashed at once; for a MoE model, the share of token-expert choices
dropped at capacity; the host ms of the plan's set-up (mesh, shards,
step) and of its gather. Both import only the port and torch (and numpy).

    spmd.launch(dist_plans.train_plans, 4, backend="gloo", args=([job],))

``shuffle_cases(rank, world, cases)`` runs the device shuffle's entry
points on a group axis of the whole world.

``trainer_ops(rank, world, jobs)`` drives ``Trainer`` on one world: per
job (a model), a list of operations (make a trainer on a plan, restore, train, save,
crash, fill the state with distinct values, gather the parameters), each
returning this rank's record: losses, the step and data cursor, per step
the kernels' launches, the bytes each axis put on the wire and the comm
ledger's bytes by site, CUDA-event step times on a card, the checkpoint
anatomy and the bytes this rank wrote.

``stages(rank, world, stages)`` runs several of these programs in turn
on one world, so its processes start and warm up once.

``lowp_collectives(rank, world, cases)`` runs the relaxed tier's
quantized collectives, its sync-scheduled reduces and the MoE payload
exchange on this rank's input of each case (``lowp_case``), forward and
backward, with the comm ledger of each call.

``relaxed_plans(rank, world, jobs)`` runs the loss-curve A-B
(``lowp.guard.run_loss_ab``) of each job on one world and returns each
rank's report, with its kernels' launches, wire bytes and step times
an arm.

``serve_plans(rank, world, jobs)`` serves on one world: per job, a
``DecodeEngine`` on a tp plan or on a group of ranks that the expert
stacks split over, built on every rank from this rank's shards (drawn
leaf by leaf, cut from a numpy tree, or loaded from a checkpoint);
position 0 drives a script of operations and the others ``follow()``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import os
import sys
import time
import types
import weakref
import zlib
from typing import Any, Dict, List

import numpy as np
import torch
import torch.distributed as dist

from hadoop_tpu_torch.device import resolve_device
from hadoop_tpu_torch.fs import LocalFileSystem
from hadoop_tpu_torch.http import http_get
from hadoop_tpu_torch.mapreduce.device_shuffle import (device_group_reduce,
                                                       device_shuffle,
                                                       device_terasort,
                                                       hash_partitioner,
                                                       sample_split_points)
from hadoop_tpu_torch.models import config as config_mod
from hadoop_tpu_torch.models.convert import params_from_numpy
from hadoop_tpu_torch.models import moe
from hadoop_tpu_torch.models.decoder import ParallelCtx, init_params
from hadoop_tpu_torch.ops import collective_matmul, flash, norms
from hadoop_tpu_torch.parallel import optimizer, overlap, spmd
from hadoop_tpu_torch.parallel.elastic import ElasticConfig
from hadoop_tpu_torch.obs.comm import comm_runtime
from hadoop_tpu_torch.obs.trainer import TrainerTelemetry, anatomy_delta
from hadoop_tpu_torch.parallel.mesh import (MeshPlan, layer_order,
                                            make_mesh, param_specs,
                                            param_specs_for,
                                            physical_layer_order,
                                            shard_params, spec_axes)
from hadoop_tpu_torch.parallel.optimizer import tree_leaves, tree_map
from hadoop_tpu_torch.parallel.train import (init_sharded,
                                             make_data_sharding,
                                             make_train_step,
                                             shard_as_drawn)
from hadoop_tpu_torch.parallel.trainer import Trainer
from hadoop_tpu_torch.serving import weightplane
from hadoop_tpu_torch.serving.engine import DecodeEngine, SamplingParams
from hadoop_tpu_torch.serving.loader import load_serving_params

SHAPE = (2, 4, 4, 3)        # one rank's value in the collectives drill


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _grad(fn, x: torch.Tensor, w: torch.Tensor):
    """(fn(x), d sum(w * fn(x)) / dx)."""
    x = x.clone().requires_grad_()
    y = fn(x)
    (dx,) = torch.autograd.grad((y * w).sum(), x)
    return y.detach(), dx


def drill_inputs(seed: int, world: int):
    """The drill's inputs: every rank's x, stacked [world, *SHAPE]."""
    rng = np.random.default_rng(seed)
    return rng.standard_normal((world, *SHAPE)).astype(np.float32)


def collectives(rank: int, world: int, seed: int) -> Dict[str, Any]:
    torch.manual_seed(seed)
    grid = np.arange(world)
    axis = spmd.new_groups("x", [grid.tolist()])
    xs = torch.from_numpy(drill_inputs(seed, world))
    x = xs[rank]
    rng = np.random.default_rng(seed + 1)
    out: Dict[str, Any] = {}
    ops = {
        "psum": lambda t: spmd.copy_to(spmd.psum(t, axis), axis),
        "all_gather": lambda t: spmd.all_gather(t, axis, 1),
        "psum_scatter": lambda t: spmd.psum_scatter(t, axis, 2),
        "all_to_all": lambda t: spmd.all_to_all(t, axis, 2, 1),
        "ppermute": lambda t: spmd.ppermute(t, axis, 1),
        "ppermute_back": lambda t: spmd.ppermute(t, axis, -1),
    }
    for name, fn in ops.items():
        with torch.no_grad():
            shape = fn(x).shape
        ws = torch.from_numpy(rng.standard_normal(
            (world, *shape)).astype(np.float32))
        y, dx = _grad(fn, x, ws[rank])
        out[name] = (_np(y), _np(dx), _np(ws))
    # the copy_to / psum pair alone: identity backward, psum backward
    y, dx = _grad(lambda t: spmd.psum(t, axis), x, x + 1)
    out["psum_alone"] = (_np(y), _np(dx))
    y, dx = _grad(lambda t: spmd.copy_to(t, axis), x, x + 1)
    out["copy_to_alone"] = (_np(y), _np(dx))
    # one tick of pipeline hops: a partial permutation each way (the
    # first rank sends nothing back, the last nothing on), two tags
    sends = [(x * 2, 1, 0)] if rank < world - 1 else []
    sends += [(x * 3, -1, 1)] if rank > 0 else []
    recvs = [(x, 1, 0)] if rank > 0 else []
    recvs += [(x, -1, 1)] if rank < world - 1 else []
    out["hop"] = [_np(t) for t in spmd.hop_raw(axis, sends, recvs)]
    out["pmax"] = _np(spmd.pmax_raw(x, axis))
    out["axis_index"] = spmd.axis_index(axis)
    # the folded kind: the same permutations over the whole stack
    fold = spmd.folded("x", world)
    stack = xs.reshape(world * SHAPE[0], *SHAPE[1:])
    for name, fn in (("all_to_all", lambda t: spmd.all_to_all(t, fold, 2, 1)),
                     ("ppermute", lambda t: spmd.ppermute(t, fold, 1))):
        ws = torch.from_numpy(out[name][2])
        w = ws.reshape(world * ws.shape[1], *ws.shape[2:])
        y, dx = _grad(fn, stack, w)
        out["folded_" + name] = (_np(y), _np(dx))
    # bucketed sums, scatter and gather against their per-leaf forms
    tree = {"a": xs[rank, 0], "b": {"c": xs[rank, 1, :3], "d": x * 2}}
    axes = {"a": (axis,), "b": {"c": (axis,), "d": (axis,)}}
    per_leaf = tree_map(lambda t: spmd.psum_raw(t, axis), tree)
    for name, nbytes in (("bucketed", 64), ("bucketed_one", 1 << 20)):
        got = overlap.bucketed_psum(tree_map(torch.clone, tree), axes,
                                    nbytes)    # sums a lone leaf in place
        out[name] = [bool(torch.equal(g, p)) for g, p in
                     zip(tree_leaves(got), tree_leaves(per_leaf))]
    sl = overlap.bucketed_psum_scatter(tree, axes, axes, 64)
    out["scatter"] = [bool(torch.equal(s, overlap.local_slice(p, (axis,))))
                      for s, p in zip(tree_leaves(sl), tree_leaves(per_leaf))]
    back = overlap.bucketed_gather_slices(sl, tree, axes, 64)
    out["gather"] = [bool(torch.equal(b, p)) for b, p in
                     zip(tree_leaves(back), tree_leaves(per_leaf))]
    # the row-parallel reduce: psum (backward the identity), and the
    # sequence psum_scatter under Megatron-SP
    y = torch.from_numpy(rng.standard_normal((4, 8, 6)).astype(np.float32)
                         ) * (rank + 1)
    for sp in (False, True):
        ctx = ParallelCtx(tp=axis, megatron_sp=sp)
        fn = functools.partial(collective_matmul.reduce_row_parallel,
                               ctx=ctx)
        with torch.no_grad():
            shape = fn(y).shape
        ws = torch.from_numpy(rng.standard_normal(
            (world, *shape)).astype(np.float32))
        out[f"row_reduce_sp{int(sp)}"] = (_np(y),) + tuple(
            map(_np, _grad(fn, y, ws[rank]))) + (_np(ws),)
    # a psum cut in pieces against one whole
    big = torch.from_numpy(rng.standard_normal(1000).astype(np.float32)
                           ) * (rank + 1)
    whole = spmd.psum_raw(big, axis)
    spmd._PIECE_BYTES, saved = 256, spmd._PIECE_BYTES
    out["psum_pieces"] = bool(torch.equal(spmd.psum_raw(big, axis), whole))
    spmd._PIECE_BYTES = saved
    out["traffic"] = dict(spmd.traffic)
    out["foreign_modules"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                      "hadoop_tpu"))
    return out


# ------------------------------------------------------------ plan runner

def _sample_index(path: str, numel: int, n: int) -> np.ndarray:
    """The flat indices a sample of ``n`` takes from a leaf (fixed by its
    path; every index when ``n`` is 0)."""
    if not n:
        return np.arange(numel)
    return np.sort(np.random.default_rng(zlib.crc32(path.encode())).choice(
        numel, min(n, numel), replace=False))


def sample_tree(tree, n: int, keep: bool = True, _path: str = ""):
    """Float32 numpy copies of a fixed sample of ``n`` flat indices of
    each leaf (chosen by the leaf's path; every element when ``n`` is
    0); None in place of each leaf unless ``keep``."""
    if isinstance(tree, dict):
        return {k: sample_tree(v, n, keep, f"{_path}/{k}")
                for k, v in tree.items()}
    if not keep:
        return None
    if n:
        idx = _sample_index(_path, tree.numel(), n)
        tree = tree.reshape(-1)[torch.from_numpy(idx).to(tree.device)]
    return tree.float().cpu().numpy()


def gathered_sample(params, cfg, plan, mesh, n: int, keep: bool):
    """``sample_tree`` of the full tree, in checkpoint layer order, from
    this rank's shards: each rank takes the sampled elements its shard
    holds (zeros elsewhere) and a psum over the axes that shard the leaf
    puts the sample together, so no rank gathers a whole leaf."""
    order = layer_order(cfg.n_layers, plan, logical=True)

    def walk(tree, spec, path):
        if isinstance(tree, dict):
            return {k: walk(tree[k], spec[k], f"{path}/{k}") for k in tree}
        ways = [plan.sizes[a] if a else 1 for a in spec]
        ways += [1] * (tree.dim() - len(ways))
        full = tuple(d * k for d, k in zip(tree.shape, ways))
        idx = np.unravel_index(_sample_index(path, int(np.prod(full)), n),
                               full)
        if order is not None and path.startswith("/layers/"):
            idx = (order.numpy()[idx[0]],) + idx[1:]   # logical → physical
        mine = np.ones(idx[0].shape, dtype=bool)
        local = []
        for i, (d, name) in enumerate(zip(tree.shape, list(spec) +
                                          [None] * tree.dim())):
            if name is not None:
                mine &= idx[i] // d == mesh.index(name)
            local.append(torch.from_numpy(idx[i] % d).to(tree.device))
        vals = torch.where(torch.from_numpy(mine).to(tree.device),
                           tree[tuple(local)].float(), 0.0)
        for name in spec:
            if name is not None:
                vals = spmd.psum_raw(vals, mesh.axis(name))
        if not keep:
            return None
        vals = vals.cpu().numpy()
        return vals.reshape(full) if not n else vals
    return walk(params, param_specs_for(params, plan), "")


COUNTERS = ("flash_fwd", "flash_fwd_partial", "flash_bwd_dq",
            "flash_bwd_dkv", "adamw", "grad_sq", "rms_norm_fwd",
            "rms_norm_bwd")


def _counts() -> List[int]:
    """The launch counters of the port's kernels, in ``COUNTERS`` order."""
    return [flash.launches, flash.launches_partial, flash.launches_bwd_dq,
            flash.launches_bwd_dkv, optimizer.launches,
            optimizer.launches_grad_sq, norms.launches_fwd,
            norms.launches_bwd]


def train_plans(rank: int, world: int, jobs: List[Dict[str, Any]]
                ) -> List[Dict[str, Any]]:
    """Train each plan of each job on this world, in order; see the
    module doc. A job: ``preset`` (+ ``overrides``), ``weights`` or
    ``seed``, ``tokens``/``targets`` [B, S] numpy, ``device`` (the card
    unless it is "cpu"; raises without a card), ``sample`` (flat indices per leaf; 0 gathers every leaf
    whole, None none) and ``plans``: dicts of ``plan`` (MeshPlan kwargs),
    ``optimizer``, ``zero1``, ``overlap`` (bool), ``steps``, ``lr``,
    ``remat``, ``n_microbatches``, ``pipeline_schedule``, ``parity`` (a
    ``ParityConfig``). A job with ``poison_lowp`` makes every entry
    point of the relaxed tier raise while it runs. Returns one record
    per plan."""
    out = []
    for job in jobs:
        with _poisoned_lowp(job.get("poison_lowp", False)):
            out += _train_job(rank, job)
    return out


@contextlib.contextmanager
def _poisoned_lowp(on: bool):
    """With ``on``, the relaxed tier's entry points raise (what the
    bitwise tier must never reach)."""
    from hadoop_tpu_torch.parallel.lowp import quant, syncpolicy
    names = [(quant, n) for n in ("psum_quantized", "psum_scatter_quantized",
                                  "psum_of_scatter_quantized", "_record",
                                  "RelaxedQuant")] + \
        [(syncpolicy, "scheduled_row_reduce"),
         (collective_matmul, "chunked_matmul_reduce")]
    saved = [(m, n, getattr(m, n)) for m, n in names] if on else []

    def poisoned(*args, **kw):
        raise AssertionError("a relaxed-tier entry point ran on the "
                             "bitwise tier")
    for m, n, _ in saved:
        setattr(m, n, poisoned)
    try:
        yield
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def _train_job(rank: int, job: Dict[str, Any]) -> List[Dict[str, Any]]:
    cfg = config_mod.get_config(job["preset"], **job.get("overrides", {}))
    dev = resolve_device(job.get("device"))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    tokens = torch.from_numpy(job["tokens"])
    targets = torch.from_numpy(job["targets"])
    results = []
    for spec in job["plans"]:
        t_setup = time.perf_counter()
        plan = MeshPlan(**spec["plan"])
        n_micro = spec.get("n_microbatches", 1)
        plan.validate(cfg, tokens.shape[0], tokens.shape[1], n_micro)
        mesh = make_mesh(plan)
        zero1 = spec.get("zero1", False)
        opt_name = spec.get("optimizer", "sgd")
        # the ranks hold the full tree one at a time: on a card they
        # share, four full trees of a large model at once do not fit
        for turn in range(dist.get_world_size()):
            if turn == rank:
                if "weights" in job:
                    full = params_from_numpy(job["weights"], cfg, device=dev)
                else:
                    gen = torch.Generator(device=dev).manual_seed(
                        job["seed"])
                    full = init_params(cfg, gen, device=dev)
                params, opt = init_sharded(full, cfg, plan, mesh,
                                           zero1=zero1, optimizer=opt_name)
                del full
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            dist.barrier()
        step = make_train_step(
            cfg, plan, mesh, lr=spec.get("lr", 1e-2),
            optimizer=opt_name, zero1=zero1,
            remat=spec.get("remat", False), n_microbatches=n_micro,
            pipeline_schedule=spec.get("pipeline_schedule", "1f1b"),
            overlap=(overlap.DEFAULT_OVERLAP if spec.get("overlap", True)
                     else overlap.OVERLAP_OFF), parity=spec.get("parity"),
            device=dev)
        cut = make_data_sharding(mesh)
        tok, tgt = cut(tokens).to(dev), cut(targets).to(dev)
        rec: Dict[str, Any] = {"plan": spec, "losses": [], "grad_norms": [],
                               "step_ms": [], "launches": [], "traffic": [],
                               "stage": mesh.index("pp"), "stash_peak": [],
                               "dropped_share": [], "setup_ms":
                               (time.perf_counter() - t_setup) * 1e3}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        for _ in range(spec.get("steps", 2)):
            before, wire = _counts(), dict(spmd.traffic)
            moe.drops = [] if cfg.is_moe else None
            t0 = time.perf_counter()
            if dev.type == "cuda":
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
            params, opt, m = step(params, opt, tok, tgt)
            if dev.type == "cuda":
                ev[1].record()
                torch.cuda.synchronize()
                rec["step_ms"].append(ev[0].elapsed_time(ev[1]))
            else:
                rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            rec["losses"].append(float(m["loss"]))
            rec["grad_norms"].append(float(m["grad_norm"]))
            rec["launches"].append([a - b for a, b in
                                    zip(_counts(), before)])
            rec["traffic"].append({k: v - wire.get(k, 0)
                                   for k, v in spmd.traffic.items()})
            if step.stats is not None:
                rec["stash_peak"].append(step.stats["stash_peak"])
            if moe.drops:
                choices = sum(n for n, _ in moe.drops)
                kept = float(sum(k for _, k in moe.drops))
                rec["dropped_share"].append(1.0 - kept / choices)
            moe.drops = None
        rec["peak_bytes"] = torch.cuda.max_memory_allocated() \
            if dev.type == "cuda" else None
        t_gather = time.perf_counter()
        rec["params"] = None if job.get("sample", 0) is None else \
            gathered_sample(params, cfg, plan, mesh, job.get("sample", 0),
                            rank == 0)
        rec["gather_ms"] = (time.perf_counter() - t_gather) * 1e3
        del params, opt, step
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        results.append(rec)
    return results


# --------------------------------------------------------- trainer runner

def fill_values(cfg, plan: MeshPlan, layout):
    """A full parameter tree with a distinct value in every element
    (``arange`` over the leaves in flatten order, float32), this rank's
    shards of it and, per leaf, the axes its ZeRO-1 row is cut over."""
    shapes = init_params(cfg, None, device="meta")
    offset = 0

    def leaf(t):
        nonlocal offset
        out = torch.arange(offset, offset + t.numel(),
                           dtype=torch.float32).reshape(t.shape)
        offset += t.numel()
        return out
    full = tree_map(leaf, shapes)
    shards = shard_params(physical_layer_order(full, cfg, plan), plan,
                          layout)
    z1 = tree_map(lambda spec: tuple(
        a for a in (layout.axis(n) for n in optimizer.zero1_leaf_plan(
            spec_axes(spec), plan.batch_axes)) if a is not None),
        param_specs(cfg, plan))
    return full, shards, z1


def _fill(t: Trainer, cfg) -> None:
    """Set the trainer's state from ``fill_values``: the parameters, mu
    the same values and nu their negatives (ZeRO-1: each rank's row of
    them, cut as the optimizer cuts)."""
    _, shards, z1 = fill_values(cfg, t.plan, t.layout)
    with torch.no_grad():
        tree_map(lambda p, v: p.copy_(v), t.params, shards)
        for moments, sign in ((t.opt.mu, 1.0), (t.opt.nu, -1.0)):
            def put(m, v, axes):
                v = overlap.local_slice(v, axes) if t.zero1 else v
                m.copy_(sign * v.reshape(m.shape))
            tree_map(put, moments, shards, z1)


def _rank_bytes(path: str, rank: int) -> int:
    """The bytes of this rank's shard files in a checkpoint directory."""
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path) if f.startswith(f"shard_r{rank}_"))


def _count_steps(t: Trainer, log: List[Dict[str, Any]], cuda: bool) -> None:
    """Wrap the trainer's step call, whatever plan's ``step_fn`` an
    elastic rebuild installs, so each step appends its launches, wire
    bytes by axis, the plan's dp and (on a card) CUDA-event ms to
    ``log``. The wrapper holds the trainer weakly: a dropped trainer's
    state leaves the card at once."""
    ref = weakref.ref(t)

    def counted(*args):
        tr = ref()
        before, wire = _counts(), dict(spmd.traffic)
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        out = tr.step_fn(*args)
        rec = {"launches": [a - b for a, b in zip(_counts(), before)],
               "traffic": {k: v - wire.get(k, 0)
                           for k, v in spmd.traffic.items()},
               "dp": tr.plan.dp}
        if cuda:
            ev[1].record()
            rec["events"] = ev
        log.append(rec)
        return out
    t._step = counted


def _link_snapshot(src: str, step: int, dst: str) -> None:
    """Hard-link the snapshot of ``step`` under ``src`` into ``dst``, so a
    trainer on ``dst`` restores it as its newest."""
    name = f"step_{step:012d}"
    os.makedirs(f"{dst}/{name}")
    for f in os.listdir(f"{src}/{name}"):
        os.link(f"{src}/{name}/{f}", f"{dst}/{name}/{f}")


def partition_by_name(name: str, n_parts: int):
    """The partitions a shuffle case names (a rank program takes no
    closure): "hash" (``hash_partitioner``) or "mod" (key mod n)."""
    if name == "hash":
        return hash_partitioner(n_parts)
    if name == "mod":
        return lambda keys: torch.remainder(keys, n_parts).to(torch.int32)
    raise ValueError(f"unknown partition {name!r}")


def shuffle_cases(rank: int, world: int, cases: List[Dict[str, Any]]
                  ) -> List[Any]:
    """Run each shuffle case on a group axis of the whole world and return
    this rank's results as numpy arrays. A case: ``fn``
    ("device_shuffle", "device_group_reduce", "device_terasort" or
    "sample_split_points"), ``keys`` and ``values`` (numpy, every rank's
    rows in rank order: this rank takes its cut), ``kw`` (keyword
    arguments; ``partition`` by name, ``partition_by_name``). The last
    entry lists the foreign modules the rank imported: none."""
    axis = spmd.new_groups("x", [list(range(world))])
    out = []
    for case in cases:
        n = case["keys"].shape[0] // world
        keys = torch.from_numpy(case["keys"][rank * n:(rank + 1) * n])
        kw = dict(case.get("kw", {}))
        if "partition" in kw:
            kw["partition"] = partition_by_name(kw["partition"], world)
        if case["fn"] == "sample_split_points":
            out.append(_np(sample_split_points(axis, keys, **kw)))
            continue
        values = torch.from_numpy(case["values"][rank * n:(rank + 1) * n])
        fn = {"device_shuffle": device_shuffle,
              "device_group_reduce": device_group_reduce,
              "device_terasort": device_terasort}[case["fn"]]
        out.append({k: _np(v) for k, v in
                    fn(axis, keys, values, **kw)._asdict().items()})
    out.append(sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "hadoop_tpu")))
    return out


def scripted_doctor(step_of, feed: Dict[str, Any]):
    """A doctor poll scripted by the trainer's step (``step_of()``), in the
    ``trainers`` shape of ``/ws/v1/fleet/doctor``: ``feed["n"]`` ranks
    named ``rank-<r>``; a rank of ``feed["dead"]`` (``[rank, from
    step]`` pairs) reads ``ok: false`` from that step on, and one of
    ``feed["flag"]`` is flagged as a straggler from its step on, unless
    it is dead."""
    def poll() -> Dict[str, Any]:
        step = step_of()
        flagged, ranks = {}, {}
        for r in range(feed["n"]):
            dead = any(d == r and step >= at for d, at in feed.get("dead",
                                                                 ()))
            ranks[f"rank-{r}"] = {"ok": not dead, "rank": r,
                                  "job": feed.get("job", "elastic")}
            if not dead and any(f == r and step >= at
                                for f, at in feed.get("flag", ())):
                flagged[f"rank-{r}"] = {"node": f"rank-{r}",
                                        "signals": ["trainer.step_wall"]}
        return {"trainers": {"flagged": flagged, "ranks": ranks}}
    return poll


def elastic_events(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """A controller's events without their timing fields (``time``,
    ``resume_seconds``) and the config each carries."""
    return [{k: v for k, v in ev.items()
             if k not in ("time", "resume_seconds", "config")}
            for ev in events]


def trainer_ops(rank: int, world: int, jobs: List[Dict[str, Any]]
                ) -> List[List[Dict[str, Any]]]:
    """Run each job's ``ops`` in order on this rank; see the module doc.
    Returns one list of records a job. A job: ``preset`` (+ ``overrides``), ``data`` (a token file on the local
    filesystem), ``device`` (the card unless "cpu"), ``trainer`` (keyword
    arguments of every ``Trainer``: batch, lr, remat, ...), ``seed`` and
    ``ops``: dicts of ``op`` and ``name`` (the trainer's), and

    - "make": ``plan`` (MeshPlan kwargs), ``ckpt`` (its directory),
      ``kw`` (more Trainer kwargs; ``elastic``: ElasticConfig kwargs),
      ``feed`` (a ``scripted_doctor`` feed, the elastic trainer's
      doctor); with ``check_init``, whether the trainer's state is
      ``init_sharded`` of the full tree drawn from the same seed, bit
      for bit (``init_equal``);
    - "restore", "save" (``dir``: save under another directory),
      "crash" (close and drop it, as a crash leaves it), "fill"
      (``_fill``);
    - "link" (no trainer; rank 0): hard-link the snapshot of ``step``
      under ``src`` into the directory ``dst``, before a later "make"
      on it (whose collective orders the ranks after the link);
    - "train": ``steps`` (and ``ckpt_interval``, set first when given);
      an elastic trainer's record adds its events (``elastic_events``),
      its resumes' seconds, its plan, whether it left the mesh and its
      newest loss by step;
    - "gather": ``which`` ("params", "mu" or "nu"; the moments of a
      plan without ZeRO-1) in checkpoint layer order, a ``sample`` of
      flat indices per leaf or every element (rank 0 keeps them).

    A "train" or "save" record's ``anatomy`` is the step anatomy of that
    op alone (``anatomy_delta``: the metrics source is the process's).
    With ``telemetry`` in the job, each trainer gets a
    ``TrainerTelemetry`` door when it is made (its elastic controller's
    report as the elastic block) and closed when it crashes; after each
    "train" the rank reads its own ``/ws/v1/trainer`` and records it as
    ``door`` (``comm``, ``steps``, ``step_wall``, ``elastic`` and the
    read's ``scrape_ms``), beside ``comm_report``, the ledger's report
    read just after; "make" and "crash" records add ``door_ms``, the
    door's opening and closing.

    The last job's list ends with a record (op "modules") of the foreign
    modules the rank imported (``jax``, ``hadoop_tpu``): none."""
    out = [_trainer_job(rank, job) for job in jobs]
    out[-1].append({"op": "modules", "name": None, "foreign": sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib",
                                                      "hadoop_tpu"))})
    return out


def _trainer_job(rank: int, job: Dict[str, Any]) -> List[Dict[str, Any]]:
    cfg = config_mod.get_config(job["preset"], **job.get("overrides", {}))
    dev = resolve_device(job.get("device"))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
    fs = LocalFileSystem()
    live: Dict[str, Trainer] = {}
    doors: Dict[str, TrainerTelemetry] = {}
    logs: Dict[str, List[Dict[str, Any]]] = {}
    out = []
    for op in job["ops"]:
        kind, name = op["op"], op["name"]
        rec: Dict[str, Any] = {"op": kind, "name": name}
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        t = live.get(name)
        if kind == "make":
            kw = dict(job.get("trainer", {}), **op.get("kw", {}))
            if "elastic" in kw:
                kw["elastic"] = ElasticConfig(**kw["elastic"])
            if "feed" in op:
                kw["doctor_poll"] = scripted_doctor(
                    functools.partial(lambda n: live[n].step, name),
                    op["feed"])
            t = live[name] = Trainer(cfg, MeshPlan(**op["plan"]), fs,
                                     job["data"], op["ckpt"],
                                     seed=job.get("seed", 0), device=dev,
                                     **kw)
            logs[name] = []
            _count_steps(t, logs[name], cuda)
            if job.get("telemetry"):
                t_door = time.perf_counter()
                doors[name] = TrainerTelemetry(
                    rank=rank, job=name, metrics=t.step_metrics,
                    elastic=None if t.elastic is None else t.elastic.report)
                rec["door_ms"] = (time.perf_counter() - t_door) * 1e3
            if op.get("check_init"):
                gen = torch.Generator(device=dev).manual_seed(
                    job.get("seed", 0))
                want = init_sharded(init_params(cfg, gen, device=dev), cfg,
                                    t.plan, t.layout, zero1=t.zero1)
                got, ref = ([x for tree in (p, o.mu, o.nu)
                             for x in tree_leaves(tree)]
                            for p, o in ((t.params, t.opt), want))
                rec["init_equal"] = len(got) == len(ref) and all(
                    torch.equal(a, b) for a, b in zip(got, ref))
        elif kind == "restore":
            rec["restored"] = t.try_restore()
        elif kind == "apply_plan":
            rec["restored"] = t.apply_plan(MeshPlan(**op["plan"]))
        elif kind == "link":
            if rank == 0:
                _link_snapshot(op["src"], op["step"], op["dst"])
        elif kind == "train":
            if "ckpt_interval" in op:
                t.ckpt_interval = op["ckpt_interval"]
            del logs[name][:]
            comm_runtime().reset_for_tests()
            before = t.step_metrics.anatomy()
            rec["losses"] = t.train(op["steps"])
            if cuda:
                torch.cuda.synchronize()
            steps = logs[name]
            rec["launches"] = [s["launches"] for s in steps]
            rec["traffic"] = [s["traffic"] for s in steps]
            rec["step_dp"] = [s["dp"] for s in steps]
            if cuda:
                rec["step_ms"] = [s["events"][0].elapsed_time(
                    s["events"][1]) for s in steps]
            if t.elastic is not None:
                rec["events"] = elastic_events(t.elastic.events)
                rec["resume_seconds"] = [
                    e["resume_seconds"] for e in t.elastic.events
                    if e["decision"] == "resume"]
                rec["plan"] = dataclasses.asdict(t.plan)
                rec["left_mesh"] = t.left_mesh
                rec["loss_by_step"] = dict(t.loss_by_step)
            rec["comm"] = {site: list(v) for site, v in
                           comm_runtime().profile("trainer.step").items()}
            rec["anatomy"] = anatomy_delta(before, t.step_metrics.anatomy())
            if name in doors:
                rec["door"] = _scrape_trainer(doors[name].port)
            rec["comm_report"] = comm_runtime().report()
        elif kind == "save":
            if "dir" in op:
                t.ckpt_dir = op["dir"]
            before = t.step_metrics.anatomy()
            path = t.save()
            if t.mesh is not None:
                rec["bytes_written"] = _rank_bytes(path, rank)
            rec["anatomy"] = anatomy_delta(
                before, t.step_metrics.anatomy())["ckpt"]
        elif kind == "crash":
            if name in doors:
                t_door = time.perf_counter()
                doors.pop(name).close()
                rec["door_ms"] = (time.perf_counter() - t_door) * 1e3
            t.close()
            del live[name], logs[name]
            t = None
            # an elastic trainer and its controller refer to each other:
            # collect them now, so the state leaves the card
            gc.collect()
        elif kind == "fill":
            _fill(t, cfg)
        elif kind == "gather":
            which = op.get("which", "params")
            tree = t.params if which == "params" else getattr(t.opt, which)
            rec[which] = gathered_sample(tree, cfg, t.plan, t.layout,
                                         op.get("sample", 0), rank == 0)
        else:
            raise ValueError(f"unknown op {kind!r}")
        if cuda:
            torch.cuda.synchronize()
        rec["ms"] = (time.perf_counter() - t0) * 1e3
        if t is not None and kind != "crash":
            rec["step"] = t.step
            rec["pos"] = t.data.state()["pos"] % max(t.data.total_tokens, 1)
        if cuda:
            rec["peak_bytes"] = torch.cuda.max_memory_allocated()
        out.append(rec)
    for door in doors.values():
        door.close()
    for t in live.values():
        t.close()
    return out


def _scrape_trainer(port: int) -> Dict[str, Any]:
    """This rank's own ``/ws/v1/trainer``: the blocks a check reads, and
    the read's wall ms."""
    t0 = time.perf_counter()
    body = json.loads(http_get("127.0.0.1", port, "/ws/v1/trainer", 30.0))
    return {"scrape_ms": (time.perf_counter() - t0) * 1e3,
            "comm": body["comm"], "steps": body["steps"],
            "step_wall": body["step_wall"], "elastic": body.get("elastic")}


# ---------------------------------------------------------- serving runner

class StepProbe:
    """What an engine's steps computed, per request (greedy lanes, no
    speculation): the logits row behind its first token (``first``,
    float32 numpy) and, for each token it got, its logits row's top-2
    gap over the row's largest magnitude (``gaps``): the margin a token
    comparison may assume. It wraps the engine's ``_rows`` and
    ``_finish_prefill``, so it runs only on the eager step."""

    def __init__(self, eng: DecodeEngine):
        self.first: Dict[int, np.ndarray] = {}
        self.gaps: Dict[int, List[float]] = {}
        self._chunk = None
        rows, finish = eng._rows, eng._finish_prefill

        def probe_rows(groups):
            out = rows(groups)
            lanes = [r.id if r is not None and eng._active[i] else None
                     for i, r in enumerate(eng._slots)]
            for rid, g in zip(lanes, _gaps(out[0]).tolist()):
                if rid is not None:
                    self.gaps.setdefault(rid, []).append(g)
            if len(out) > 1:
                n = int(eng._chunk_in[eng.prefill_chunk + 2])
                self._chunk = out[1][n - 1]
            return out

        def probe_finish(req, tok):
            row = self._chunk
            self.first[req.id] = row.cpu().numpy()
            self.gaps.setdefault(req.id, []).append(
                float(_gaps(row[None])[0]))
            return finish(req, tok)

        eng._rows, eng._finish_prefill = probe_rows, probe_finish


def _gaps(logits: torch.Tensor) -> torch.Tensor:
    top = logits.topk(2, dim=-1).values
    return (top[:, 0] - top[:, 1]) / logits.abs().amax(-1).clamp_min(1e-30)


def _delivered(eng: DecodeEngine, packed: torch.Tensor) -> torch.Tensor:
    """What a step's packed readback delivers: each lane's emitted
    tokens, emit count, finished flag and accept length, zeros past what
    it emits (a lane that emits nothing sampled from rows that read the
    scratch page, whose racing writes differ from process to process),
    and the chunk's token."""
    g = eng.spec_k + 1
    lanes = packed[:eng.max_batch * (g + 3)].view(eng.max_batch, g + 3)
    n = lanes[:, g:g + 1]
    cols = torch.arange(g + 3, device=packed.device)[None, :]
    keep = (cols < n) | ((cols >= g) & (n > 0)) | (cols == g)
    return torch.cat([torch.where(keep, lanes, torch.zeros_like(lanes))
                      .reshape(-1), packed[eng.max_batch * (g + 3):]])


def _digest(*tensors: torch.Tensor) -> str:
    h = hashlib.sha1()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().view(-1).view(
            torch.uint8).numpy().tobytes())
    return h.hexdigest()


class InjectedFault(RuntimeError):
    """The fault a serving job injects (``fault``)."""


def _fail_mid_step(eng: DecodeEngine, rank: int, at_step: int) -> None:
    """Make this rank's step ``at_step`` raise inside its layers, after
    the embedding's collective and before the layers' sums."""
    attend = eng._attend

    def failing(*args):
        if eng.steps == at_step:
            raise InjectedFault(f"injected fault mid-step on rank {rank}")
        return attend(*args)
    eng._attend = failing


def _serve_params(rank: int, job: Dict[str, Any], cfg, plan, mesh, dev):
    """This rank's tree: loaded shards (``ckpt``), the numpy tree's
    (``weights``), or drawn from ``seed`` (leaf by leaf, each cut to this
    rank's shard at once under a tp plan; whole otherwise). ``relaxed``
    ({"group": g}): quantized on the weight plane. The ranks take turns,
    so one full leaf at a time sits on a shared card."""
    params = None
    for turn in range(dist.get_world_size()):
        if turn == rank:
            if "ckpt" in job:
                specs = param_specs(cfg, plan) if plan is not None else None
                params, _ = load_serving_params(
                    LocalFileSystem(), job["ckpt"], cfg, device=dev,
                    mesh=mesh if plan is not None else None, specs=specs)
            elif "weights" in job:
                params = params_from_numpy(job["weights"], cfg, device=dev)
            else:
                gen = torch.Generator(device=dev).manual_seed(job["seed"])
                keep = shard_as_drawn(cfg, plan, mesh) \
                    if plan is not None else None
                params = init_params(cfg, gen, device=dev, keep=keep)
            if "relaxed" in job:
                params, _ = weightplane.quantize_params(
                    params, cfg, weightplane.WeightPlaneConfig(
                        tier="relaxed", **job["relaxed"]))
            if dev.type == "cuda":
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
        dist.barrier()
    return params


def _requests(op: Dict[str, Any]):
    sp = SamplingParams(max_new_tokens=op["max_new"],
                        temperature=op.get("temperature", 0.0),
                        top_k=op.get("top_k", 0))
    return [(p, sp) for p in op["prompts"]]


def _drive(eng: DecodeEngine, job: Dict[str, Any], rec: Dict[str, Any],
           cuda: bool) -> None:
    """The driver's script: ``submit`` (prompts, max_new, temperature,
    top_k), ``until_first`` (step until request ``req`` has a token),
    ``drain`` (step until every request is done), ``extract`` (the
    payload of the first cached page of request ``req``'s prompt),
    ``evict_all`` (every cached page demoted to the host ring). Each
    step's wall ms and shape, and its RMSNorm and dequantize launches,
    go to ``rec``."""
    reqs = []
    fault = job.get("fault")

    def one_step():
        if fault and not fault.get("mid_step") and \
                eng.steps == fault["at_step"]:
            raise InjectedFault("injected driver fault")
        before = (norms.launches_fwd, weightplane.launches_dequant)
        wire = dict(spmd.traffic)
        t0 = time.perf_counter()
        eng.step()
        if cuda:
            torch.cuda.synchronize()
        rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["fused"].append(eng._chunk_fill > 0)
        rec["launches"].append([norms.launches_fwd - before[0],
                                weightplane.launches_dequant - before[1]])
        rec["traffic"].append({k: v - wire.get(k, 0)
                               for k, v in spmd.traffic.items()})

    for op in job["ops"]:
        kind = op["op"]
        if kind == "submit":
            reqs += [eng.submit(p, sp) for p, sp in _requests(op)]
        elif kind == "until_first":
            r = reqs[op["req"]]
            while not r.out_tokens and not r.done.is_set():
                one_step()
        elif kind == "drain":
            while not all(r.done.is_set() for r in reqs):
                one_step()
        elif kind == "extract":
            blk = eng.prefix_cache.match_nodes(
                reqs[op["req"]].prompt)[0].block
            rec["extracted"] = eng._extract_block(blk)
        elif kind == "evict_all":
            with eng._sched_lock:
                freed = eng.prefix_cache.evict(
                    len(eng.prefix_cache), eng.pool.refcount,
                    on_evict=eng.kvstore.demote)
                eng.pool.free(freed)
            rec["evicted"] = len(freed)
        else:
            raise ValueError(f"unknown op {kind!r}")
    rec["tokens"] = [r.wait(0) for r in reqs]
    rec["ttft_ms"] = [(r.first_token_at - r.submitted_at) * 1e3
                      for r in reqs]
    rec["preemptions"] = [r.preemptions for r in reqs]
    rec["reused"] = [r.prefix_tokens_reused for r in reqs]
    rec["ids"] = [r.id for r in reqs]


def serve_plans(rank: int, world: int, jobs: List[Dict[str, Any]]
                ) -> List[Dict[str, Any]]:
    """Serve each job on this world, in order; see the module doc. A job:
    ``preset`` (+ ``overrides``), ``seed`` / ``weights`` (numpy) /
    ``ckpt`` (a checkpoint directory on the local filesystem),
    ``relaxed`` (weight plane kwargs), ``device`` (the card unless
    "cpu"), ``plan`` (MeshPlan kwargs: a tp plan) or ``group`` (k: the
    ranks as MeshPlan(dp=k), the expert stacks' group), ``engine``
    (DecodeEngine kwargs), ``ops`` (the driver's script, ``_drive``),
    ``probe`` (``StepProbe`` on the driver), ``digests`` (per step, on
    every rank, a digest of the step's output and the device step
    state after it), ``fault`` ({"at_step": n}: the driver raises before
    that step and releases its followers; with ``"mid_step": True`` and
    ``"rank": r``, rank r raises inside that step and the world fails),
    ``control`` ("drop_tp_partial": each rank leaves the others' attention
    outputs out of its tp sum, a wrong engine for a gate to reject),
    ``longctx`` (try ``attach_longctx``). Returns one record
    a job: the driver's tokens, TTFTs, step ms, launches and wire bytes
    by axis a step; every rank's digests, placement and peak memory."""
    out = [_serve_job(rank, job) for job in jobs]
    out[-1]["foreign"] = sorted(m for m in sys.modules if m.split(".")[0]
                                in ("jax", "jaxlib", "hadoop_tpu"))
    return out


def _serve_job(rank: int, job: Dict[str, Any]) -> Dict[str, Any]:
    cfg = config_mod.get_config(job["preset"], **job.get("overrides", {}))
    dev = resolve_device(job.get("device"))
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if "plan" in job:
        plan = MeshPlan(**job["plan"])
        mesh = make_mesh(plan)
    else:
        plan, mesh = None, make_mesh(MeshPlan(dp=job["group"]))
    params = _serve_params(rank, job, cfg, plan, mesh, dev)
    eng = DecodeEngine(params, cfg, device=dev, plan=plan, mesh=mesh,
                       **job.get("engine", {}))
    del params
    rec: Dict[str, Any] = {"rank": rank, "mesh": eng.mesh_stats(),
                           "weight_plane": eng.weight_plane(),
                           "num_blocks": eng.pool.num_blocks,
                           "setup_ms": (time.perf_counter() - t0) * 1e3,
                           "step_ms": [], "fused": [], "launches": [],
                           "traffic": [], "digests": [], "error": None}
    if job.get("longctx"):
        try:
            eng.attach_longctx(types.SimpleNamespace(min_tokens=1))
        except NotImplementedError as e:
            rec["longctx_error"] = str(e)
    if job.get("digests"):
        impl = eng._step_impl

        def digested(fused):
            packed = impl(fused)
            rec["digests"].append(_digest(_delivered(eng, packed),
                                          *eng._dstate.values()))
            return packed
        eng._step_impl = digested
    fault = job.get("fault") or {}
    if fault.get("mid_step") and fault["rank"] == rank:
        _fail_mid_step(eng, rank, fault["at_step"])
    if job.get("control") == "drop_tp_partial":
        eng._tp_sum = lambda parts: parts
    probe = StepProbe(eng) if job.get("probe") and eng.mesh_stats()[
        "driver"] else None
    if cuda:
        torch.cuda.synchronize()
    t_serve = time.perf_counter()
    if eng.mesh_stats()["driver"]:
        try:
            _drive(eng, job, rec, cuda)
        except InjectedFault as e:
            if fault.get("mid_step"):
                raise
            rec["error"] = f"{type(e).__name__}: {e}"
        finally:
            eng.stop()
    else:
        eng.follow()
        rec["followed_steps"] = eng.steps
    rec["serve_ms"] = (time.perf_counter() - t_serve) * 1e3
    if probe is not None and "ids" in rec:
        rec["first_logits"] = [probe.first.get(i) for i in rec["ids"]]
        rec["gaps"] = [probe.gaps.get(i, []) for i in rec["ids"]]
    rec["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else None
    del eng, probe
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    dist.barrier()
    return rec


# ------------------------------------------------- the relaxed parity tier

def _lowp_axes(world: int) -> Dict[str, spmd.Axis]:
    """"x": every rank; "a" and "b": the (2, 2) grid's axes of a world
    of four (rank = 2a + b), as a mesh of four devices reshaped (2, 2)
    names them."""
    axes = {"x": spmd.new_groups("x", [list(range(world))])}
    if world == 4:
        axes["a"] = spmd.new_groups("a", [[0, 2], [1, 3]])
        axes["b"] = spmd.new_groups("b", [[0, 1], [2, 3]])
    return axes


def lowp_case(case: Dict[str, Any], x: torch.Tensor,
              axes: Dict[str, spmd.Axis]) -> torch.Tensor:
    """One case of ``lowp_collectives`` on this rank's ``x``: ``op``
    psum | scatter | gather | moe | skip | stale | project, with its
    ``axes`` (names), ``codec``, ``group``, ``scale``, ``dim``,
    ``megatron_sp``, ``corr``, ``w`` and ``chunked`` (the relaxed chunked
    tp matmul on exact reduces, or the one reduce)."""
    from hadoop_tpu_torch.parallel.lowp import quant, syncpolicy
    rq = quant.RelaxedQuant(codec=case.get("codec", "int8"),
                            group=case.get("group", 1024))
    ax = [axes[n] for n in case.get("axes", "x")]
    op = case["op"]
    if op == "psum":
        return quant.psum_quantized(x, ax, rq, scale=case["scale"])
    if op == "scatter":
        return quant.psum_scatter_quantized(
            x, ax[-1], rq, rest_axes=ax[:-1],
            scatter_dimension=case.get("dim", 0), scale=case["scale"])
    if op == "gather":
        return quant.psum_of_scatter_quantized(
            x, overlap.zero1_slice_meta(1, ax)[0],
            overlap.zero1_slice_index(ax), ax, rq)
    if op == "moe":
        leg = quant.moe_dispatch_quantized if case["leg"] == "dispatch" \
            else quant.moe_combine_quantized
        return leg(x, ax[0])
    ctx = ParallelCtx(tp=ax[0], megatron_sp=case.get("megatron_sp", False),
                      tp_overlap_chunks=4,
                      relaxed_chunk_matmul=case.get("chunked", False))
    if op == "project":
        w = torch.from_numpy(case["w"][ax[0].index])
        return collective_matmul.row_parallel_project(x, w, ctx)
    if op == "skip":
        return syncpolicy.skip_row_reduce(x, ctx)
    out, new = syncpolicy.stale_row_reduce(
        x, ctx, torch.from_numpy(case["corr"][ax[0].index]))
    return torch.cat([out.reshape(-1), new.reshape(-1)])


def lowp_collectives(rank: int, world: int, cases: List[Dict[str, Any]]
                     ) -> List[Dict[str, Any]]:
    """Each case (``lowp_case``; ``x``: every rank's input stacked on dim
    0, ``ct``: every rank's cotangent, or None) on this rank's slice:
    the forward's output, the input's gradient under ``ct`` and the comm
    ledger's report of the call."""
    from hadoop_tpu_torch.parallel.lowp.quant import capture_comm
    axes = _lowp_axes(world)
    out = []
    for case in cases:
        x = torch.from_numpy(case["x"][rank]).requires_grad_(
            case.get("ct") is not None)
        with capture_comm() as led:
            y = lowp_case(case, x, axes)
        rec = {"y": _np(y), "comm": led.report()}
        if case.get("ct") is not None:
            y.backward(torch.from_numpy(case["ct"][rank]))
            rec["grad"] = _np(x.grad)
        out.append(rec)
    return out


def relaxed_plans(rank: int, world: int, jobs: List[Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    """``lowp.guard.run_loss_ab`` for each job on one mesh of its plan; a
    job: ``plan`` (MeshPlan kwargs) and ``run_loss_ab``'s keywords
    (``bitwise_from``: the index of an earlier job whose bitwise curve
    this one reuses; ``codec_check``: first run one relaxed step from the
    same weights and data, which is the A-B's first, holding every
    gradient bucket's int8 and fp8 codec on its device against the same
    codec on the CPU). Each arm's entry of the report's ``rank`` has the
    kernels' launches (``COUNTERS``); on a card the entry adds the peak
    memory. Returns this rank's reports, and in the last one's ``rank``
    the launches over the whole program."""
    from hadoop_tpu_torch.parallel.lowp.guard import run_loss_ab
    out: List[Dict[str, Any]] = []
    meshes: Dict[Any, Any] = {}
    start = _counts()
    for job in jobs:
        job = dict(job)
        plan = MeshPlan(**job.pop("plan"))
        if plan not in meshes:
            meshes[plan] = make_mesh(plan) if plan.n_devices > 1 else None
        src = job.pop("bitwise_from", None)
        if src is not None:
            job["bitwise_losses"] = out[src]["bitwise_losses"]
        check = job.pop("codec_check", False)
        dev = resolve_device(job.get("device"))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        codec = _codec_step(plan, meshes[plan], job) if check else None
        rep = run_loss_ab(plan, mesh=meshes[plan], probe=lambda: dict(
            zip(COUNTERS, _counts())), **job)
        if codec is not None:
            rep["rank"]["codec_check"] = codec
        if dev.type == "cuda":
            rep["rank"]["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        out.append(rep)
        gc.collect()
    if out:
        out[-1]["rank"]["launches_total"] = dict(zip(COUNTERS, [
            a - b for a, b in zip(_counts(), start)]))
    return out


def _codec_step(plan: MeshPlan, mesh, job: Dict[str, Any]
                ) -> Dict[str, Any]:
    """One relaxed step of ``run_loss_ab``'s job (its first), every
    gradient bucket's int8 and fp8 codec (scales, values; the wire
    scales and headroom of its sum) held on its device against the CPU's,
    byte for byte. Returns the buckets and elements held and the
    mismatches."""
    from hadoop_tpu_torch.parallel.lowp import quant
    from hadoop_tpu_torch.parallel.lowp.guard import run_loss_ab
    seen = {"buckets": 0, "elements": 0, "mismatched": 0}
    group = job["parity"].group

    def codecs(rows, qmax):
        out = []
        for q in (qmax, quant._F8_MAX):
            scales = quant._wire_scales(rows.abs().amax(dim=1), q)
            vals = quant._quant_rows(rows, scales, q) if q == qmax else \
                quant._to_f8(rows, scales).view(torch.uint8)
            out += [scales.view(torch.int32), vals]
        return out

    def hold(x, axes):
        rows = quant._pad_rows(x.detach().float(), group)
        qmax = quant._wire_for(quant.RelaxedQuant.ranks(axes))[1]
        for a, b in zip(codecs(rows, qmax), codecs(rows.cpu(), qmax)):
            seen["mismatched"] += int((a.cpu() != b).sum())
        seen["buckets"] += 1
        seen["elements"] += x.numel()

    psum, scatter = quant.psum_quantized, quant.psum_scatter_quantized

    def held_psum(x, axes, rq, **kw):
        if kw.get("site", "").startswith("bucket"):
            hold(x, axes)
        return psum(x, axes, rq, **kw)

    def held_scatter(x, axis, rq, **kw):
        if kw.get("site", "").startswith("bucket"):
            hold(x, tuple(kw.get("rest_axes", ())) + (axis,))
        return scatter(x, axis, rq, **kw)
    quant.psum_quantized, quant.psum_scatter_quantized = held_psum, \
        held_scatter
    try:
        run_loss_ab(plan, mesh=mesh, **dict(job, steps=1,
                                            bitwise_losses=[0.0]))
    finally:
        quant.psum_quantized, quant.psum_scatter_quantized = psum, scatter
    return seen


PROGRAMS = {"collectives": collectives, "train_plans": train_plans,
            "shuffle_cases": shuffle_cases, "trainer_ops": trainer_ops,
            "serve_plans": serve_plans, "relaxed_plans": relaxed_plans,
            "lowp_collectives": lowp_collectives}


def stages(rank: int, world: int, stages: List[Any]) -> List[Any]:
    """Run each ``(program, args)`` of ``stages`` in order on this world
    (``program``: a name of ``PROGRAMS``); between two, the ranks free
    what the last one left on the card and meet. Returns, a stage, its
    result and this rank's seconds in it."""
    out = []
    for name, args in stages:
        t0 = time.perf_counter()
        result = PROGRAMS[name](rank, world, *args)
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        dist.barrier()
        out.append((result, time.perf_counter() - t0))
    return out
