"""The trainer: the train step on one device or a mesh, a token
stream read from a filesystem, and checkpoints written to it.

The counterpart of ``hadoop_tpu/parallel/trainer.py``'s ``Trainer``. It
runs the port's train step over a ``TokenDataset``, checkpoints
parameters, optimizer state and the data cursor on an interval (in the
reference's format, so either package resumes the other's run), and
resumes exactly after a crash: the same loss curve as an uninterrupted
run.

- **On a mesh** (a plan of more than one rank) each rank runs its own
  ``Trainer`` in its own process, after ``torch.distributed`` is up
  (``spmd.launch``, or any launcher): the rank comes from the process
  group and the mesh is ``make_mesh(plan)``. Every rank draws the
  parameters from ``seed`` leaf by leaf and keeps its shard of each as
  it is drawn (``shard_as_drawn``: ``init_sharded``'s shards, never the
  whole tree), reads the same global batch and trains on its cut
  (``make_data_sharding``); the loss is the same on every rank. ZeRO-1,
  microbatches, the pipeline schedules and the overlap config go to
  ``make_train_step`` as there.
- **Checkpoints on a mesh** are written by every rank under one
  manifest (``parallel/checkpoint.py``: each global element once, rank
  0 publishing), an interleaved plan's layers in logical order. A
  restore agrees on the step across ranks (rank 0 reads it and
  broadcasts, on the step loop's thread), then: the same plan loads this
  rank's shards directly, bit for bit; another plan (``"reshard"``)
  cuts the global parameters for this plan and converts the moments
  leaf by leaf through their global layout (``elastic/reshard.py``:
  ZeRO-1 slices ⇄ global moments), so no rank holds the whole state.
- A background thread prefetches batches (a bounded queue of 2): it
  reads, cuts and reshapes only, into pinned memory on a CUDA device;
  the step loop copies each batch to the device on the step's own
  stream.
- Each batch carries the dataset cursor as of its production, and a save
  records the cursor of the last batch a finished step consumed, so a
  save taken with batches in flight resumes exactly.
- Interval saves take the host snapshot in the loop and write on a
  background thread (``AsyncCheckpointWriter``), fenced at the next save,
  at a restore and at ``train()``'s exit.
- At most ``MAX_INFLIGHT`` losses stay on the device; older ones are read
  back, which bounds how far the host runs ahead of the device.
- The step, snapshot and write run under ``record_function`` ranges
  ``trainer.step``, ``trainer.ckpt.snapshot`` and ``trainer.ckpt.write``
  (the last on the writer thread, which a profile records with
  ``profile_all_threads``). ``step_metrics`` counts the step anatomy,
  the HBM ledger holds the parameters and the optimizer state, and each
  step runs inside the comm ledger's ``comm.step("trainer.step")``
  (``obs/comm.py``).

A MoE model trains here like a dense one: its router [L, D, E] and
expert stacks [L, E, D, F] / [L, E, F, D] are leaves of the parameters,
the moments and the checkpoints like any other.

**The elastic plane** (``elastic``, an enabled ``ElasticConfig``, with
``doctor_poll``): an ``ElasticController`` polls every
``poll_steps`` steps; on a mesh the grid's position 0 polls and
broadcasts the report on the step loop's thread, so every rank takes the
same decision at the same step. A demote's protective save is written by
every rank of the mesh. An eviction ends the step segment (the prefetch
thread drains, the cursor rewinds, the writer is fenced), and
``apply_plan`` rebuilds the trainer for the shrunken plan over the
surviving ranks, in rank order (they make the new groups among
themselves), then restores the newest snapshot through "reshard".
``train(n)`` then re-runs the lost steps: its target is absolute. An
evicted process leaves the mesh (``left_mesh``), makes no group and
runs no more steps. The mesh's own collectives (the
restore's step, the run's nonce, the poll's report) and a save's part
count go over the mesh's ranks, never the default group, and a save
names each rank by its mesh position. ``apply_plan`` alone (no
controller) rebuilds for a plan over the mesh's first ranks.

Initialisation draws from a ``torch.Generator`` seeded with ``seed``; the
reference draws from ``PRNGKey(0)``, a different stream, so the two
packages start from the same state only through a checkpoint.
``parity`` (a ``ParityConfig``, ``parallel/lowp``) builds the step under
that tier, and ``apply_plan``'s rebuild keeps it; a stale sync
schedule's corrections live in the step and start at zeros after a
restore.
"""

from __future__ import annotations

import logging
import queue
import secrets
import threading
import time
import weakref
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

from hadoop_tpu_torch.device import resolve_device
from hadoop_tpu_torch.fs import FileSystemLike
from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.models.decoder import init_params
from hadoop_tpu_torch.obs.comm import comm_runtime
from hadoop_tpu_torch.obs.hbm import hbm_ledger, tree_nbytes
from hadoop_tpu_torch.obs.trainer import TrainerStepMetrics
from hadoop_tpu_torch.parallel.checkpoint import (AsyncCheckpointWriter,
                                                  global_shape,
                                                  latest_step, leaf_paths,
                                                  load_checkpoint,
                                                  manifest_meta,
                                                  mesh_pieces,
                                                  rank_block,
                                                  read_global_leaf,
                                                  read_manifest,
                                                  resolve_restore,
                                                  snapshot_tree,
                                                  spec_paths,
                                                  write_snapshot)
from hadoop_tpu_torch.parallel.data import TokenDataset
from hadoop_tpu_torch.parallel.elastic import ElasticConfig
from hadoop_tpu_torch.parallel.elastic.controller import ElasticController
from hadoop_tpu_torch.parallel.elastic.reshard import (convert_moment,
                                                       zero1_state_shape)
from hadoop_tpu_torch.parallel.mesh import (ONE_RANK, MeshPlan, make_mesh,
                                            param_specs)
from hadoop_tpu_torch.parallel.optimizer import AdamWState, tree_map
from hadoop_tpu_torch.parallel.pipeline import interleaved_layer_permutation
from hadoop_tpu_torch.parallel.train import (make_data_sharding,
                                             make_train_step, shard_as_drawn,
                                             sharded_opt_state, zero1_layout)

log = logging.getLogger(__name__)

class Trainer:
    # losses older than this many steps are read back to the host
    MAX_INFLIGHT = 16

    def __init__(self, cfg: ModelConfig, plan: MeshPlan, fs: FileSystemLike,
                 data_path: str, ckpt_dir: str, *, batch: int,
                 lr: float = 3e-4, optimizer: str = "adamw",
                 zero1: bool = False, remat=False,
                 ckpt_interval: int = 100, keep: int = 3,
                 data_dtype: str = "uint16",
                 n_microbatches: Optional[int] = None,
                 pipeline_schedule: str = "1f1b",
                 overlap=None, parity=None,
                 async_ckpt: bool = True, rank: int = 0,
                 elastic: Optional[ElasticConfig] = None, doctor_poll=None,
                 seed: int = 0, device=None):
        self.cfg, self.fs = cfg, fs
        self.device = resolve_device(device)
        self.ckpt_dir = ckpt_dir
        self.ckpt_interval = ckpt_interval
        self.keep = keep
        self.batch = batch
        self.zero1 = zero1 and optimizer == "adamw"
        # what the step's build needs, kept for apply_plan's rebuild
        self._n_microbatches_arg = n_microbatches
        self._build_kwargs = dict(
            lr=lr, optimizer=optimizer, zero1=self.zero1, remat=remat,
            pipeline_schedule=pipeline_schedule, overlap=overlap,
            parity=parity)
        self._seed = seed
        self.async_ckpt = async_ckpt
        self._ckpt_writer = AsyncCheckpointWriter()
        self.data = TokenDataset(fs, data_path, batch=batch,
                                 seq=cfg.max_seq, dtype=data_dtype)
        self.left_mesh = False
        self._build_for_plan(plan)
        self.rank = dist.get_rank() if self.mesh else int(rank)
        # a save's token, the same on every rank: the run's nonce (the
        # grid's position 0's, broadcast while every rank builds its
        # trainer) and the save's number
        self._nonce, self._saves = "0", 0
        if self.mesh is not None:
            self._nonce = self.mesh.broadcast(
                secrets.token_hex(8) if self.mesh.rank == 0 else None)
        self.elastic = None
        if elastic is not None and elastic.enabled:
            poll = None if doctor_poll is None else \
                self._mesh_poll(doctor_poll)
            self.elastic = ElasticController(self, elastic, poll_fn=poll)
        self.step = 0
        self.losses: list = []
        # the newest loss per absolute step index
        self.loss_by_step: Dict[int, float] = {}
        m = TrainerStepMetrics(rank=self.rank)
        self.step_metrics = m
        self._comm = comm_runtime()
        # the ledger's providers hold a weak reference: a trainer that was
        # never closed must not pin its state in the process-wide ledger
        led = hbm_ledger()
        self._hbm_owner = f"trainer@{id(self)}."
        ref = weakref.ref(self)

        def _tree(attr):
            t = ref()
            return tree_nbytes(getattr(t, attr)) if t is not None else 0

        led.register(f"{self._hbm_owner}params", "params",
                     lambda: _tree("params"))
        led.register(f"{self._hbm_owner}opt", "opt_state",
                     lambda: _tree("opt"))
        # cursor of the last batch a finished step consumed, set only
        # while train() runs (the prefetch thread reads ahead of it)
        self._inflight_cursor: Optional[Dict] = None
        self._zombie_producer: Optional[threading.Thread] = None

    def _build_for_plan(self, plan: MeshPlan, ranks=None) -> None:
        """The mesh, the step, the data cut and fresh state for one plan
        (``ranks``: the world's ranks of the mesh, this process among
        them; None, the whole world when the plan has more than one
        rank). What ``apply_plan`` re-runs."""
        n_microbatches = self._n_microbatches_arg
        if n_microbatches is None:
            # pipeline plans need M > 1 (interleaved needs pp | M); a
            # plan without stages runs unsplit
            n_microbatches = max(1, plan.pp * plan.vpp)
        plan.validate(self.cfg, self.batch, self.cfg.max_seq,
                      n_microbatches=n_microbatches)
        self.plan = plan
        self.mesh = make_mesh(plan, ranks) \
            if plan.n_devices > 1 or ranks is not None else None
        self.layout = self.mesh or ONE_RANK
        # the save's part count: the mesh's ranks
        self.world = len(self.mesh.ranks) if self.mesh else 1
        self.step_fn = make_train_step(
            self.cfg, plan, self.mesh, n_microbatches=n_microbatches,
            device=self.device, **self._build_kwargs)
        # each leaf cut to this rank's shard as it is drawn: a model that
        # needs the plan to fit a card never stands whole on one
        gen = torch.Generator(device=self.device).manual_seed(self._seed)
        self.params = init_params(self.cfg, gen, self.device,
                                  keep=shard_as_drawn(self.cfg, plan,
                                                      self.layout))
        # moments in this plan's layout (ZeRO-1: (K,) rows) whatever the
        # optimizer, as the reference's state tree
        self.opt = sharded_opt_state(self.params, self.cfg, plan,
                                     zero1=self.zero1)
        self._cut = make_data_sharding(self.mesh) if self.mesh else None
        self._spec_of = spec_paths(self._target_spec_tree())

    def apply_plan(self, new_plan: MeshPlan) -> bool:
        """Rebuild this trainer for ``new_plan`` and resume from the newest
        snapshot through reshard-on-restore (the elastic controller's
        actuation; callable directly for a manual reshard). Not under a
        running ``train()``. On a mesh every process of it calls this:
        the ranks the controller evicted are left out and the others fill
        the new grid in rank order and make its groups among themselves;
        a process left out drops its state, leaves the mesh and returns
        False. Returns whether a checkpoint was restored; without one the
        state is freshly initialised and the step is 0."""
        self._ckpt_writer.wait()   # an in-flight write lands first
        old_step = self.step
        ranks = None
        if self.mesh is not None:
            gone = self.elastic.evicted_process_ranks \
                if self.elastic is not None else set()
            alive = [r for r in self.mesh.ranks if r not in gone]
            if len(alive) < new_plan.n_devices:
                raise ValueError(f"plan {new_plan} needs "
                                 f"{new_plan.n_devices} ranks, "
                                 f"{len(alive)} remain: {alive}")
            ranks = alive[:new_plan.n_devices]
            if self.rank not in ranks:
                self.left_mesh = True
                self.mesh = self.step_fn = self._cut = None
                self.params, self.opt = {}, AdamWState(0, {}, {})
                log.info("rank %d left the mesh at step %d (%s over ranks "
                         "%s)", self.rank, old_step, new_plan, ranks)
                return False
        self._build_for_plan(new_plan, ranks)
        restored = self.try_restore()
        if not restored:
            self.step = 0
            log.warning("apply_plan(%s): no checkpoint to restore; "
                        "reinitialised from step 0 (was step %d)",
                        new_plan, old_step)
        return restored

    def _mesh_poll(self, poll_fn):
        """The doctor poll on a mesh: the grid's position 0 polls and
        broadcasts the report (or its failure, raised on every rank), on
        the step loop's thread."""
        def poll():
            if self.mesh is None:
                return poll_fn()
            got = None
            if self.mesh.rank == 0:
                try:
                    got = ("report", poll_fn())
                except Exception as e:  # noqa: BLE001 — raised below
                    got = ("error", f"{type(e).__name__}: {e}")
            kind, value = self.mesh.broadcast(got)
            if kind == "error":
                raise IOError(f"doctor poll failed: {value}")
            return value
        return poll

    # ------------------------------------------------------------ layout

    def _target_spec_tree(self):
        """Placement specs of this plan's state tree: the parameters',
        the moments' (a ZeRO-1 moment's spec names its leading dims, spec
        axes then data axes), and replicated scalars."""
        specs = param_specs(self.cfg, self.plan)
        moments = specs
        if self.zero1:
            moments = tree_map(lambda names: tuple(names) + (None,),
                               zero1_layout(self.cfg, self.plan)[2])
        return {"params": specs, "opt": AdamWState((), moments, moments),
                "data_pos": ()}

    def _layer_perm(self, name: str):
        """Axis 0's physical → logical layer order of a leaf laid out for
        an interleaved plan (the parameters' layer stacks, and the
        moments' without ZeRO-1, whose slices stay plan-locked), else
        None."""
        if self.plan.vpp <= 1:
            return None
        prefixes = ["['params']['layers']"]
        if not self.zero1:
            prefixes += ["['opt'].mu['layers']", "['opt'].nu['layers']"]
        if not any(name.startswith(p) for p in prefixes):
            return None
        return interleaved_layer_permutation(self.cfg.n_layers,
                                             self.plan.pp, self.plan.vpp)

    def _pieces(self, name, leaf):
        return mesh_pieces(self._spec_of[name], leaf, self.mesh,
                           self._layer_perm(name))

    # -------------------------------------------------------- persistence

    def _state_tree(self):
        cursor = (self._inflight_cursor if self._inflight_cursor
                  is not None else self.data.state())
        pos = cursor["pos"] % max(self.data.total_tokens, 1)
        # the data cursor rides as two int31 halves: a stream past 2**31
        # tokens would overflow a single int32
        return {"params": self.params, "opt": self.opt,
                "data_pos": torch.tensor([pos >> 31, pos & 0x7FFFFFFF],
                                         dtype=torch.int32)}

    def save(self, wait: Optional[bool] = None) -> str:
        """Checkpoint the current state (on a mesh every rank calls it at
        the same point; rank 0 publishes).

        ``wait=False`` (the step loop's interval saves): block for the
        device→host snapshot and a fence on any previous write; the write
        itself runs on the background writer, fenced at the next save,
        restore or ``train()`` exit. ``wait=None`` or True: durable on
        return (on a mesh, on rank 0). ``async_ckpt=False`` makes every
        save synchronous."""
        if wait is None:
            wait = True
        m = self.step_metrics
        t_fence = time.monotonic()
        self._ckpt_writer.wait()   # surfaces a prior write's failure
        m.ckpt_fence.add(time.monotonic() - t_fence)
        tree = self._state_tree()
        with record_function("trainer.ckpt.snapshot"):
            t_snap = time.monotonic()
            snap = snapshot_tree(tree, self._pieces if self.mesh else None)
            m.ckpt_snapshot.add(time.monotonic() - t_snap)
        step, fs, ckpt_dir, keep = self.step, self.fs, self.ckpt_dir, \
            self.keep
        meta = manifest_meta(self.plan, zero1=self.zero1)
        where = dict(rank=self.layout.rank, world=self.world,
                     token=f"{self._nonce}.{self._saves}") \
            if self.mesh else {}
        self._saves += 1

        def write():
            with record_function("trainer.ckpt.write"):
                t_w = time.monotonic()
                path = write_snapshot(fs, ckpt_dir, step, snap, keep=keep,
                                      meta=meta, **where)
                m.ckpt_write.add(time.monotonic() - t_w)
            log.info("checkpoint step %d -> %s", step, path)

        if self.async_ckpt:
            self._ckpt_writer.submit(write)
            if wait:
                t_fence = time.monotonic()
                self._ckpt_writer.wait()
                m.ckpt_fence.add(time.monotonic() - t_fence)
        else:
            write()
        return f"{self.ckpt_dir}/step_{step:012d}"

    def wait_for_checkpoint(self) -> None:
        """Block until any in-flight checkpoint write completes (re-raising
        its failure, if it failed)."""
        self._ckpt_writer.wait()

    def close(self) -> None:
        """Retire this trainer from the process-wide HBM ledger."""
        hbm_ledger().unregister_prefix(self._hbm_owner)

    def try_restore(self) -> bool:
        """Resume from the newest complete checkpoint, if any (on a mesh
        every rank calls it at the same point: the grid's position 0
        names the step).

        The manifest's plan block decides the path, as in the reference:
        "same-plan" and "legacy" (no plan block; a DeprecationWarning)
        load this rank's shards directly; "reshard" (another plan, or
        the same one with ZeRO-1 switched) cuts the global parameters for
        this plan and converts the moments through their global layout.
        A leaf whose shape or dtype does not fit raises ValueError."""
        self._ckpt_writer.wait()  # a restore must see the newest save
        step = latest_step(self.fs, self.ckpt_dir)
        if self.mesh is not None:
            step = self.mesh.broadcast(step)
        if step is None:
            return False
        manifest = read_manifest(self.fs, self.ckpt_dir, step)
        mode, saved_plan, saved_zero1 = resolve_restore(
            manifest, self.plan, self.zero1)
        gshapes = tree_map(lambda t: tuple(t.shape), init_params(
            self.cfg, None, device="meta"))
        self._check_leaves(manifest, step, mode, saved_plan, saved_zero1,
                           gshapes)
        like = {"params": self.params, "opt": self.opt,
                "data_pos": torch.zeros(2, dtype=torch.int32)}
        if mode == "reshard":        # the moments come leaf by leaf below
            like["opt"] = AdamWState(self.opt.count, {}, {})
        tree, got = load_checkpoint(self.fs, self.ckpt_dir, like, step=step,
                                    device=self.device, mesh=self.layout,
                                    specs=self._target_spec_tree(),
                                    permute=self._layer_perm)
        opt = AdamWState(*tree["opt"])
        if mode == "reshard":
            opt = AdamWState(opt.count, *(
                self._resharded_moments(manifest, step, which, saved_plan,
                                        saved_zero1, gshapes)
                for which in ("mu", "nu")))
        self.params, self.opt = tree["params"], opt
        hi, lo = tree["data_pos"].tolist()
        self.data.restore({"pos": (hi << 31) | lo})
        self.step = got
        log.info("restored step %d (%s) from %s", got, mode, self.ckpt_dir)
        return True

    def _check_leaves(self, manifest, step: int, mode: str,
                      saved_plan: Optional[MeshPlan], saved_zero1: bool,
                      gshapes) -> None:
        """Raise ValueError, before a shard is read, when a leaf the
        restore needs is missing or stored at another global shape or
        dtype than this plan's (a saved plan's ZeRO-1 layout, for the
        moments of a reshard); the first three, in leaf order.
        ``gshapes``: the parameters' global shapes."""
        sizes = self.plan.sizes
        pspecs = param_specs(self.cfg, self.plan)

        def moment_shape(gshape, pspec):
            if mode != "reshard" or not saved_zero1:
                return gshape
            return zero1_state_shape(pspec, gshape, saved_plan)

        moments = spec_paths(tree_map(moment_shape, gshapes, pspecs)) \
            if mode == "reshard" else None
        bad = []
        for name, leaf in leaf_paths(self._state_tree()):
            if name.startswith("['opt'].mu") or name.startswith(
                    "['opt'].nu"):
                if moments is not None:
                    want = moments[name[len("['opt'].mu"):]]
                else:
                    want = global_shape(tuple(leaf.shape),
                                        self._spec_of[name], sizes)
            elif isinstance(leaf, int):
                want = ()
            else:
                want = global_shape(tuple(leaf.shape), self._spec_of[name],
                                    sizes)
            dtype = "int32" if isinstance(leaf, int) else \
                str(leaf.dtype).replace("torch.", "")
            entry = manifest["leaves"].get(name)
            if entry is None:
                bad.append(f"{name}: missing")
            elif (tuple(entry["shape"]), entry["dtype"]) != (tuple(want),
                                                             dtype):
                bad.append(f"{name}: {entry['dtype']}{entry['shape']}, "
                           f"expected {dtype}{list(want)}")
        if bad:
            raise ValueError(f"checkpoint step {step} does not match this "
                             f"trainer's state: {bad[:3]}")

    def _resharded_moments(self, manifest, step: int, which: str,
                           saved_plan: MeshPlan, saved_zero1: bool,
                           gshapes):
        """This rank's ``which`` ("mu" or "nu") moments for this plan
        from a checkpoint of ``saved_plan``, one leaf at a time: the
        saved leaf read whole, converted to this plan's layout as
        ``reshard_opt_state`` converts it (``convert_moment``: through
        the global param-shaped array), and this rank's block of it kept
        (a ZeRO-1 row, or the parameter's shard)."""
        pspecs = param_specs(self.cfg, self.plan)
        out_specs = self._target_spec_tree()["opt"].mu

        def leaf(local, gshape, pspec, ospec, path):
            name = f"['opt'].{which}{path}"
            saved = read_global_leaf(self.fs, self.ckpt_dir, step, name,
                                     manifest).numpy()
            moment = convert_moment(saved, gshape, pspec, saved_plan,
                                    self.plan, zero1_a=saved_zero1,
                                    zero1_b=self.zero1)
            block = rank_block(moment, ospec, self.layout,
                               self._layer_perm(name))
            return torch.from_numpy(block.reshape(local.shape)).to(
                self.device)

        def walk(local, gshape, pspec, ospec, path=""):
            if isinstance(local, dict):
                return {k: walk(local[k], gshape[k], pspec[k], ospec[k],
                                f"{path}[{k!r}]") for k in local}
            return leaf(local, gshape, pspec, ospec, path)

        return walk(getattr(self.opt, which), gshapes, pspecs, out_specs)

    # -------------------------------------------------------------- train

    def train(self, n_steps: int) -> list:
        """Run ``n_steps`` more steps; returns the losses of every step
        executed (also appended to ``losses`` and ``loss_by_step``).

        Under the elastic plane the target is absolute: an eviction ends
        the running segment, the controller reshards onto the shrunken
        plan, and the loop re-runs the steps lost since the restored
        snapshot, so the call returns at ``start + n_steps`` (the list
        holds the re-run steps too; ``loss_by_step`` the newest loss of
        each). A process that left the mesh runs no step."""
        if self.elastic is None:
            return self._train_segment(n_steps)
        target = self.step + n_steps
        out: list = []
        while self.step < target and not self.left_mesh:
            out.extend(self._train_segment(target - self.step))
            if self.elastic.pending:
                self.elastic.resume()
        return out

    def _step(self, *args):
        """One step of the current plan's ``step_fn`` (the loop's one call
        site: a rebuild replaces ``step_fn``, not this)."""
        return self.step_fn(*args)

    def _train_segment(self, n_steps: int) -> list:
        """One uninterrupted run of the step loop; it ends early only when
        the elastic controller marks an eviction pending."""
        zombie = self._zombie_producer
        if zombie is not None:
            if zombie.is_alive():
                raise RuntimeError(
                    "a previous train()'s prefetch thread is still stuck "
                    "in a dataset read; the dataset cannot be shared with "
                    "a new run")
            self._zombie_producer = None
            if self._inflight_cursor is not None:
                # the stuck thread has since died: rewind to the consumed
                # position it left unrestored
                if self.data.state() != self._inflight_cursor:
                    self.data.restore(self._inflight_cursor)
                self._inflight_cursor = None
        m = self.step_metrics
        out: list = []
        pending: deque = deque()   # (step, device loss), oldest first
        q: queue.Queue = queue.Queue(maxsize=2)
        abort = threading.Event()
        pin = self.device.type == "cuda"
        cut = self._cut

        def put(item) -> None:
            while not abort.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def produce():
            try:
                for _ in range(n_steps):
                    rows = self.data.next_batch()
                    pair = [torch.from_numpy(np.ascontiguousarray(x))
                            for x in (rows[:, :-1], rows[:, 1:])]
                    if cut is not None:      # this rank's rows and shard
                        pair = [cut(x).contiguous() for x in pair]
                    if pin:
                        pair = [x.pin_memory() for x in pair]
                    put((*pair, self.data.state()))
                    if abort.is_set():
                        return
            except BaseException as e:  # noqa: BLE001 — raised by the loop
                put(e)

        producer = threading.Thread(target=produce, daemon=True,
                                    name="trainer-prefetch")
        producer.start()
        step_failed = False
        try:
            for _ in range(n_steps):
                t_step = time.monotonic()
                item = q.get()
                data_wait = time.monotonic() - t_step
                if isinstance(item, BaseException):
                    raise item
                tokens, targets, cursor = item
                with record_function("trainer.step"):
                    # on the step's stream: the step reads the copies
                    # after they land
                    tokens = tokens.to(self.device, non_blocking=True)
                    targets = targets.to(self.device, non_blocking=True)
                    # the comm ledger's step window: the collective sites
                    # record this step's bytes under "trainer.step"
                    with self._comm.step("trainer.step"):
                        self.params, self.opt, metrics = self._step(
                            self.params, self.opt, tokens, targets)
                        self.step += 1
                        self._inflight_cursor = cursor
                        pending.append((self.step, metrics["loss"]))
                        while len(pending) > self.MAX_INFLIGHT:
                            s, dev = pending.popleft()
                            val = float(dev)
                            out.append(val)
                            self.losses.append(val)
                            self.loss_by_step[s] = val
                    if self.ckpt_interval and \
                            self.step % self.ckpt_interval == 0:
                        self.save(wait=False)
                m.steps.incr()
                m.data_wait.add(data_wait)
                m.data_wait_hist.add(data_wait)
                step_wall = time.monotonic() - t_step
                m.step_wall.add(step_wall)
                m.step_wall_hist.add(step_wall)
                if self.elastic is not None and \
                        self.step % self.elastic.cfg.poll_steps == 0 and \
                        self.elastic.on_step(self.step):
                    # an eviction is pending: end the segment, so the
                    # prefetch thread drains and the cursor rewinds before
                    # the mesh is rebuilt
                    break
        except BaseException:
            step_failed = True
            raise
        finally:
            abort.set()
            # drain the finished steps' losses even when a step raised
            while pending:
                s, dev = pending.popleft()
                try:
                    val = float(dev)
                except Exception:  # noqa: BLE001 — a failed step's loss
                    break
                out.append(val)
                self.losses.append(val)
                self.loss_by_step[s] = val
            producer.join(timeout=10.0)
            if producer.is_alive():
                # stuck in a read past its abort checks: it still owns the
                # dataset, so keep the in-flight cursor for save() and
                # make the next train() refuse until the thread dies
                log.warning("prefetch thread did not exit within 10s; "
                            "keeping the in-flight data cursor")
                self._zombie_producer = producer
            elif self._inflight_cursor is not None:
                # rewind the dataset to the consumed position, only when
                # the producer really read ahead (restore() drops the
                # read buffer)
                if self.data.state() != self._inflight_cursor:
                    self.data.restore(self._inflight_cursor)
                self._inflight_cursor = None
            # completion fence, after the drain, join and rewind: interval
            # checkpoints are durable when train() returns; a write failure
            # is raised here unless a step's exception is propagating
            try:
                self._ckpt_writer.wait()
            except Exception:
                if not step_failed:
                    raise
                log.exception("async checkpoint write failed during "
                              "train()")
        return out
