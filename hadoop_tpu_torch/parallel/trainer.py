"""Training driver on one device: the train step, a token stream read
from a filesystem, and checkpoints written to it.

The counterpart of ``hadoop_tpu/parallel/trainer.py``'s ``Trainer`` for
``MeshPlan()``. It runs the port's train step over a ``TokenDataset``,
checkpoints parameters, optimizer state and the data cursor on an
interval (in the reference's format, so either package resumes the
other's run), and resumes exactly after a crash: the same loss curve as
an uninterrupted run.

- A background thread prefetches batches (a bounded queue of 2): it
  reads and reshapes only, into pinned memory on a CUDA device; the step
  loop copies each batch to the device on the step's own stream.
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
  ``profile_all_threads``). ``step_metrics`` counts the step anatomy, and
  the HBM ledger holds the parameters and the optimizer state.

A MoE model trains here like a dense one: its router [L, D, E] and
expert stacks [L, E, D, F] / [L, E, F, D] are leaves of the parameters,
the moments and the checkpoints like any other.

Initialisation draws from a ``torch.Generator`` seeded with ``seed``; the
reference draws from ``PRNGKey(0)``, a different stream, so the two
packages start from the same state only through a checkpoint. The
train step takes plans of more than one rank (``parallel/train.py``);
the trainer, its checkpoints and its loader on such a mesh, ZeRO-1,
microbatching, pipelines, the overlap and parity passes and the elastic
plane are ROADMAP Queue A 6 and raise.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import weakref
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch
from torch.profiler import record_function

from hadoop_tpu_torch.device import resolve_device
from hadoop_tpu_torch.fs import FileSystemLike
from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.obs.hbm import hbm_ledger, tree_nbytes
from hadoop_tpu_torch.obs.trainer import TrainerStepMetrics
from hadoop_tpu_torch.parallel.checkpoint import (AsyncCheckpointWriter,
                                                  latest_step,
                                                  load_checkpoint,
                                                  manifest_meta,
                                                  mismatched_leaves,
                                                  read_manifest,
                                                  resolve_restore,
                                                  snapshot_tree,
                                                  write_snapshot)
from hadoop_tpu_torch.parallel.data import TokenDataset
from hadoop_tpu_torch.parallel.mesh import MeshPlan
from hadoop_tpu_torch.parallel.optimizer import AdamWState
from hadoop_tpu_torch.parallel.train import init_train_state, make_train_step

log = logging.getLogger(__name__)

_A6 = "ROADMAP Queue A 6 (multi-GPU parallelism)"


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
                 elastic=None, doctor_poll=None,
                 seed: int = 0, device=None):
        if plan != MeshPlan():
            raise NotImplementedError(
                f"plan {plan}: Trainer, its checkpoints and loader on a "
                f"mesh are {_A6}")
        refused = [name for name, off in (
            ("zero1", not zero1), ("n_microbatches", n_microbatches in
                                   (None, 1)),
            ("pipeline_schedule", pipeline_schedule == "1f1b"),
            ("overlap", overlap is None), ("parity", parity is None),
            ("elastic", elastic is None),
            ("doctor_poll", doctor_poll is None)) if not off]
        if refused:
            raise NotImplementedError(
                f"Trainer arguments {refused}: ZeRO-1, microbatching, "
                f"pipelines, the overlap and parity passes and the elastic "
                f"plane are {_A6}")
        self.cfg, self.plan, self.fs = cfg, plan, fs
        self.device = resolve_device(device)
        self.ckpt_dir = ckpt_dir
        self.ckpt_interval = ckpt_interval
        self.keep = keep
        self.batch = batch
        self.zero1 = False
        self.async_ckpt = async_ckpt
        self._ckpt_writer = AsyncCheckpointWriter()
        self.data = TokenDataset(fs, data_path, batch=batch,
                                 seq=cfg.max_seq, dtype=data_dtype)
        self.step_fn = make_train_step(cfg, plan, lr=lr, optimizer=optimizer,
                                       remat=remat, device=self.device)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params, self.opt = init_train_state(cfg, gen, self.device)
        self.step = 0
        self.losses: list = []
        # the newest loss per absolute step index
        self.loss_by_step: Dict[int, float] = {}
        self.rank = int(rank)
        m = TrainerStepMetrics(rank=self.rank)
        self.step_metrics = m
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

    def apply_plan(self, new_plan: MeshPlan) -> bool:
        raise NotImplementedError(f"apply_plan (elastic replanning): {_A6}")

    # -------------------------------------------------------- persistence

    def save(self, wait: Optional[bool] = None) -> str:
        """Checkpoint the current state.

        ``wait=False`` (the step loop's interval saves): block for the
        device→host snapshot and a fence on any previous write; the write
        itself runs on the background writer, fenced at the next save,
        restore or ``train()`` exit. ``wait=None`` or True: durable on
        return. ``async_ckpt=False`` makes every save synchronous."""
        if wait is None:
            wait = True
        m = self.step_metrics
        t_fence = time.monotonic()
        self._ckpt_writer.wait()   # surfaces a prior write's failure
        m.ckpt_fence.add(time.monotonic() - t_fence)
        # the data cursor rides as two int31 halves: a stream past 2**31
        # tokens would overflow a single int32
        cursor = (self._inflight_cursor if self._inflight_cursor
                  is not None else self.data.state())
        pos = cursor["pos"] % max(self.data.total_tokens, 1)
        tree = {"params": self.params, "opt": self.opt,
                "data_pos": torch.tensor([pos >> 31, pos & 0x7FFFFFFF],
                                         dtype=torch.int32)}
        with record_function("trainer.ckpt.snapshot"):
            t_snap = time.monotonic()
            snap = snapshot_tree(tree)
            m.ckpt_snapshot.add(time.monotonic() - t_snap)
        step, fs, ckpt_dir, keep = self.step, self.fs, self.ckpt_dir, \
            self.keep
        meta = manifest_meta(self.plan, zero1=self.zero1)

        def write():
            with record_function("trainer.ckpt.write"):
                t_w = time.monotonic()
                path = write_snapshot(fs, ckpt_dir, step, snap, keep=keep,
                                      meta=meta)
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
        """Resume from the newest complete checkpoint, if any.

        The manifest's plan block decides the path, as in the reference:
        "same-plan" and "legacy" (no plan block; a DeprecationWarning) load
        directly. A checkpoint written under another plan without ZeRO-1
        stores every leaf at its global shape, so its "reshard" is the
        host assembly of the shards. A ZeRO-1 checkpoint, or one whose
        leaves do not assemble to this trainer's shapes, is
        ROADMAP Queue A 6 and raises."""
        self._ckpt_writer.wait()  # a restore must see the newest save
        step = latest_step(self.fs, self.ckpt_dir)
        if step is None:
            return False
        manifest = read_manifest(self.fs, self.ckpt_dir, step)
        mode, saved_plan, saved_zero1 = resolve_restore(
            manifest, self.plan, self.zero1)
        if saved_zero1:
            raise NotImplementedError(
                f"checkpoint step {step} holds ZeRO-1 optimizer slices "
                f"(plan {saved_plan}); converting them to global moments "
                f"is {_A6}")
        like = {"params": self.params, "opt": self.opt,
                "data_pos": torch.zeros(2, dtype=torch.int32)}
        bad = mismatched_leaves(manifest, like)
        if bad and mode == "reshard":
            raise NotImplementedError(
                f"checkpoint step {step} (plan {saved_plan}) does not "
                f"assemble to this trainer's leaves ({bad[:3]}); "
                f"relayouts beyond host assembly are {_A6}")
        if bad:
            raise ValueError(f"checkpoint step {step} does not match this "
                             f"trainer's state: {bad[:3]}")
        tree, got = load_checkpoint(self.fs, self.ckpt_dir, like, step=step,
                                    device=self.device)
        self.params, self.opt = tree["params"], AdamWState(*tree["opt"])
        hi, lo = tree["data_pos"].tolist()
        self.data.restore({"pos": (hi << 31) | lo})
        self.step = got
        log.info("restored step %d (%s) from %s", got, mode, self.ckpt_dir)
        return True

    # -------------------------------------------------------------- train

    def train(self, n_steps: int) -> list:
        """Run ``n_steps`` more steps; returns the losses of every step
        executed (also appended to ``losses`` and ``loss_by_step``)."""
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
                    self.params, self.opt, metrics = self.step_fn(
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
