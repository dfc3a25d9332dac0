"""NameNode high availability: states, tailing, checkpointing, failover.

The port's copy of ``hadoop_tpu/dfs/namenode/ha.py``. A tailer, a
checkpointer or a failover controller works on either package's
JournalNodes; the images a standby writes are the fsimage the other
package's NameNode loads.

Parity with the reference's HA machinery (ref: server/namenode/ha/
EditLogTailer.java:73 + :324 doTailEdits, StandbyCheckpointer.java:64 +
:194 doCheckpoint, StandbyState/ActiveState/ObserverState;
ha/ZKFailoverController.java, HealthMonitor.java):

- **States**: ``active`` serves everything and writes the journal;
  ``standby`` rejects client ops (StandbyError → client fails over) while
  tailing the shared QJM log; ``observer`` additionally serves reads with
  state-id alignment (msync); ``fenced`` is a former active whose
  edit the quorum journal refused for a newer writer's epoch (ROADMAP
  C 24, a state the reference lacks): it answers as a standby, is
  unhealthy, and refuses every transition until it is restarted.
- **EditLogTailer**: standby/observer thread applying newly committed
  quorum edits to the local namesystem.
- **StandbyCheckpointer**: periodic fsimage save on the standby — the
  active never pauses to checkpoint.
- **FailoverController**: per-NN elector thread renewing the majority
  lease on the JournalNodes; grabbing it promotes the local NN (journal
  epoch fencing makes a deposed active harmless), losing it demotes.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional

from hadoop_tpu_torch.ipc.errors import StandbyError
from hadoop_tpu_torch.util.misc import Daemon

log = logging.getLogger(__name__)

ACTIVE = "active"
STANDBY = "standby"
OBSERVER = "observer"
FENCED = "fenced"


class EditLogTailer:
    """Ref: ha/EditLogTailer.java — keeps a non-active NN's namespace
    caught up by replaying committed quorum edits."""

    def __init__(self, fsn, interval_s: float = 1.0):
        self.fsn = fsn
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.last_applied_txid = 0

    def start(self, from_txid: int) -> None:
        self.stop()  # never two tailer threads over one namesystem
        self.last_applied_txid = from_txid
        self._stop.clear()
        self._thread = Daemon(self._run, "edit-log-tailer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def catch_up(self) -> int:
        """Synchronous final tail (used during transition to active).
        Returns the last applied txid."""
        self.do_tail()
        return self.last_applied_txid

    def do_tail(self) -> int:
        """One tailing pass. Ref: EditLogTailer.doTailEdits:324.

        The journal read happens BEFORE taking the namesystem write lock:
        for a quorum journal the read is an RPC fan-out with multi-second
        timeouts when a JN is down, and holding the write lock across it
        would stall observer reads for the whole timeout (the reference
        likewise streams edits outside the lock and applies under it)."""
        edits = list(self.fsn.editlog.journal.read_edits(
            self.last_applied_txid + 1))
        applied = 0
        if edits:
            with self.fsn.lock.write():
                for rec in edits:
                    if rec["t"] <= self.last_applied_txid:
                        continue  # lost race with a concurrent catch-up
                    self.fsn._apply_edit(rec)
                    self.last_applied_txid = rec["t"]
                    applied += 1
        if applied:
            log.debug("Tailed %d edits (through txid %d)", applied,
                      self.last_applied_txid)
        return applied

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.do_tail()
            except Exception:
                log.exception("Edit tailing pass failed")


class StandbyCheckpointer:
    """Ref: ha/StandbyCheckpointer.java — the standby saves images so the
    active never has to."""

    def __init__(self, fsn, tailer: EditLogTailer,
                 period_s: float = 3600.0, txns: int = 1_000_000):
        self.fsn = fsn
        self.tailer = tailer
        self.period_s = period_s
        self.txns = txns
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._last_ckpt_txid = 0

    def start(self) -> None:
        self.stop()
        self._stop.clear()
        self._last_ckpt_txid = self.tailer.last_applied_txid
        self._thread = Daemon(self._run, "standby-checkpointer")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _run(self) -> None:
        last_time = time.monotonic()
        while not self._stop.wait(min(self.period_s, 5.0)):
            try:
                behind = self.tailer.last_applied_txid - self._last_ckpt_txid
                if behind >= self.txns or (
                        behind > 0 and
                        time.monotonic() - last_time >= self.period_s):
                    self.do_checkpoint()
                    last_time = time.monotonic()
            except Exception:
                log.exception("Standby checkpoint failed")

    def do_checkpoint(self) -> str:
        """Ref: StandbyCheckpointer.doCheckpoint:194 — save the image at
        the tailed txid. (No upload step: every NN reads the same image
        directory convention; the image is node-local like the reference's,
        and a restarted peer replays the quorum journal past its own
        newest image.)"""
        with self.fsn.lock.write():
            txid = self.tailer.last_applied_txid
            path = self.fsn.image.save(self.fsn.fsdir, txid,
                                       self.fsn.image_extra())
        self.fsn.image.purge_old()
        self._last_ckpt_txid = txid
        log.info("Standby checkpoint at txid %d → %s", txid, path)
        return path


class FailoverController:
    """Automatic failover: elect via the JN majority lease, promote/demote
    the local NN. Ref: ha/ZKFailoverController.java + HealthMonitor — one
    in-process controller per NameNode instead of a sidecar daemon."""

    def __init__(self, namenode, lease, check_interval_s: float = 1.0):
        self.nn = namenode
        self.lease = lease
        self.check_interval_s = check_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = Daemon(self._run, f"failover-controller-{self.nn.nn_id}")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10.0)
            self._thread = None

    def _run(self) -> None:
        while not self._stop.wait(self.check_interval_s):
            try:
                self._one_round()
            except Exception:
                log.exception("Failover controller round failed")

    def _one_round(self) -> None:
        if self.nn.ha_state == OBSERVER:
            return  # observers never contend for the active lease
        healthy = self.nn.is_healthy()
        if not healthy:
            if self.nn.ha_state == ACTIVE:
                log.warning("Local NN unhealthy; releasing active lease")
                self.lease.release()
                self.nn.transition_to_standby()
            return
        if self.lease.try_acquire():
            if self.nn.ha_state != ACTIVE:
                log.info("Won active lease; promoting %s", self.nn.nn_id)
                self.nn.transition_to_active()
        else:
            if self.nn.ha_state == ACTIVE:
                log.warning("Lost active lease; demoting %s", self.nn.nn_id)
                self.nn.transition_to_standby()


def check_operation(ha_state: str, is_write: bool) -> None:
    """Gate an RPC by HA state (ref: NameNode.checkOperation /
    StandbyException paths)."""
    if ha_state == ACTIVE:
        return
    if ha_state == OBSERVER and not is_write:
        return
    raise StandbyError(
        f"Operation category {'WRITE' if is_write else 'READ'} is not "
        f"supported in state {ha_state}")
