"""The runtime comm ledger: the bytes each collective site moves a step.

The counterpart of ``hadoop_tpu/obs/comm.py``. The collective entry
points of the train step call ``record_comm(site, payload, reference)``
under a bounded ``site`` label (``COMM_SITES``):

- ``bucket.psum``, ``bucket.scatter``, ``zero1.gather``: the bucketed
  sums, their ZeRO-1 reduce-scatter and the ZeRO-1 gather of the
  updated slices (``parallel/overlap.py``);
- ``tp.psum``, ``tp.scatter``: the row-parallel reduce, psum or
  Megatron-SP's psum_scatter (``ops/collective_matmul.py``);
- ``tp.stale``: the deferred exact reduce of a stale-scheduled layer
  (``parallel/lowp/syncpolicy.py``), whose result the next step uses;
- ``cp.ring``: the ring attention's K/V hops (``parallel/ring_attention
  .py``); ``cp.all2all``: Ulysses' head transposes
  (``parallel/ulysses.py``);
- ``moe.dispatch``, ``moe.combine``: the expert-parallel all-to-alls of
  a MoE layer (``models/moe.py``).

A step loop (the ``Trainer``) wraps each step in ``CommRuntime.step
(key)``. On exit the ledger advances each site's cumulative counters by
the step's bytes and records the window's host wall into the site's
histogram: ``htpu_comm_seconds{site=...}``,
``htpu_comm_payload_bytes_total{site=...}``,
``htpu_comm_reference_bytes_total{site=...}`` and
``htpu_comm_executions_total{site=...}`` in the port's metrics system
(``hadoop_tpu_torch/metrics.py``, source "comm").

How the port counts, against the reference:

- The reference records once per TRACE, with static bytes (a scanned
  layer body scaled by its length), and each step adds that profile.
  The port runs every step eagerly, so the sites record at run time,
  each call once, and a step's profile is what that step recorded. For
  the same flat plan a step's per-site bytes equal the reference's
  traced profile: the sites sit where the reference's do and record the
  same payloads (``zero1.gather`` its [Z, K] buffer, the ring its K/V
  shards times the hops of its path).
- On the bitwise tier the train step's gradient sums record nothing:
  they are the port's form of the sums the reference's autodiff inserts
  (its vma transposes), which its ledger does not see. On the relaxed
  tier (``parallel/lowp``) they are quantized buckets and record their
  wire form at ``bucket.psum`` / ``bucket.scatter``, where the
  reference's would record if its sums reached the overlap pass.
- The relaxed tier records the wire form: the quantized ``bucket.*``,
  ``zero1.gather``, ``tp.*`` and ``moe.*`` payloads (values and f32
  scales) against the bytes of their float forms. A layer the sync
  schedule turns off records its tp site at ``payload 0, executions 0``
  against the full reference bytes; a stale layer's deferred reduce
  records at ``tp.stale``.
- A site records in the forward only. A record made inside an autograd
  backward (a collective's transpose, or the forward a ``remat``
  checkpoint recomputes there) is dropped, as the reference's trace
  records its forward sites once. A pipeline's stage recompute runs
  outside the backward and records, as each microbatch's forward does;
  the reference's trace of its scanned clock counts neither per
  microbatch, so under pp the two profiles differ.
- Executions differ on the bitwise tier: the reference cuts a tp reduce
  into ``parallel.overlap.tp.chunks`` (4) collectives and splits the
  ZeRO-1 gather's buckets by the axes a slice varies over; the port
  runs one reduce, and one bucket per (axes, dtype). On the relaxed
  tier the port cuts and buckets as the reference does (its values
  depend on the cut), so the executions agree.
- Records outside a ``step`` window on this thread are dropped.
- The port's ``moe.dispatch`` / ``moe.combine`` record on the exact tier
  too; the reference records them on its quantized tier only.

Against ``spmd.traffic`` (the bytes each process hands to the wire, by
axis): a step's traffic on an axis is the ledger's bytes of the sites on
that axis, except that the ledger counts ``zero1.gather`` as the
reference's [Z, K] buffer where the wire carries this rank's row
(payload / Z), plus what no site records: the gradient sums, the
backward's transposes and a remat recompute's sums, the loss and
grad-norm scalars, the vocab-parallel cross-entropy's reductions and
the pipeline's hops.

``obs.comm.timing`` (default on, ``configure``) gates the runtime
bookkeeping.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Tuple

import torch

# The bounded site label set: a record under any other site maps to
# "other", so no call site can mint an unbounded Prometheus series
COMM_SITES = ("bucket.psum", "bucket.scatter", "zero1.gather",
              "tp.psum", "tp.scatter", "tp.stale", "cp.ring",
              "cp.all2all", "moe.dispatch", "moe.combine", "other")


def static_nbytes(x) -> int:
    """Byte count of a tensor (or anything with a shape and a dtype)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    n = 1
    for d in x.shape:
        n *= int(d)
    return n * x.dtype.itemsize


class CommRuntime:
    """The process-wide runtime comm ledger (one per rank process)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._enabled = True
        # step key -> {site: (payload, reference, executions)}: the
        # newest step of that key
        self._profiles: Dict[str, Dict[str, Tuple[int, int, int]]] = {}
        self._steps: Dict[str, int] = {}         # guarded-by: _lock
        self._totals: Dict[str, List[int]] = {}  # guarded-by: _lock
        self._tls = threading.local()
        self._reg = None
        self._hists: Dict = {}
        self._payload: Dict = {}
        self._reference: Dict = {}
        self._execs: Dict = {}

    # ------------------------------------------------------------- config

    def configure(self, conf) -> None:
        if conf is not None:
            self._enabled = conf.get_bool("obs.comm.timing", True)

    # ------------------------------------------------------------- record

    def record(self, site: str, payload: int, reference: int,
               executions: int = 1) -> None:
        """One collective of a step, from its entry point: binds to the
        innermost ``step`` window on this thread; dropped outside one and
        inside an autograd backward (see the module doc)."""
        stack = getattr(self._tls, "stack", None)
        if stack and torch._C._current_graph_task_id() == -1:
            stack[-1].append((site, int(payload), int(reference),
                              int(executions)))

    # ------------------------------------------------------- step window

    @contextmanager
    def step(self, key: str):
        """Wrap ONE step: the records made inside define the step's
        per-site profile for ``key``, which advances the counters; the
        window's host wall goes into each site's histogram."""
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        records: List[Tuple[str, int, int, int]] = []
        stack.append(records)
        t0 = time.monotonic()
        try:
            yield
        except BaseException:
            # a step that raised completed neither its bytes nor its
            # window
            stack.pop()
            raise
        stack.pop()
        wall = time.monotonic() - t0
        prof: Dict[str, Tuple[int, int, int]] = {}
        for site, p, r, e in records:
            if site not in COMM_SITES:
                site = "other"
            pp, rr, ee = prof.get(site, (0, 0, 0))
            prof[site] = (pp + p, rr + r, ee + e)
        with self._lock:
            self._profiles[key] = prof
        if self._enabled:
            self._observe(key, prof, wall)

    def _observe(self, key: str, prof, wall: float) -> None:
        if not prof:
            return
        with self._lock:
            self._steps[key] = self._steps.get(key, 0) + 1
            for site, (p, r, e) in prof.items():
                tot = self._totals.setdefault(site, [0, 0, 0, 0])
                tot[0] += p
                tot[1] += r
                tot[2] += e
                tot[3] += 1
        hists, payload, reference, execs = self._metrics()
        for site, (p, r, e) in prof.items():
            payload[site].incr(p)
            reference[site].incr(r)
            execs[site].incr(e)
            hists[site].add(wall)

    # ------------------------------------------------------------ metrics

    def _metrics(self):
        """The htpu_comm families, made lazily and remade when the
        metrics system's "comm" source changes."""
        from hadoop_tpu_torch.metrics import metrics_system
        reg = metrics_system().source("comm")
        if reg is self._reg:
            return self._hists, self._payload, self._reference, \
                self._execs
        hists: Dict = {}
        payload: Dict = {}
        reference: Dict = {}
        execs: Dict = {}
        # label values from this literal tuple: the bounded set
        for s in ("bucket.psum", "bucket.scatter", "zero1.gather",
                  "tp.psum", "tp.scatter", "tp.stale", "cp.ring",
                  "cp.all2all", "moe.dispatch", "moe.combine", "other"):
            k = s.replace(".", "_")
            hists[s] = reg.histogram(
                "comm_seconds_" + k,
                "host wall of the step window carrying this collective "
                "site", prom_name="comm_seconds", prom_labels={"site": s})
            payload[s] = reg.counter(
                "comm_payload_bytes_" + k,
                "cumulative wire payload bytes this site moved",
                prom_name="comm_payload_bytes", prom_labels={"site": s})
            reference[s] = reg.counter(
                "comm_reference_bytes_" + k,
                "bytes the unquantized form of this site would move",
                prom_name="comm_reference_bytes", prom_labels={"site": s})
            execs[s] = reg.counter(
                "comm_executions_" + k,
                "collectives this site executed",
                prom_name="comm_executions", prom_labels={"site": s})
        self._reg, self._hists = reg, hists
        self._payload, self._reference = payload, reference
        self._execs = execs
        return hists, payload, reference, execs

    # ------------------------------------------------------------- report

    def report(self) -> Dict:
        """Cumulative per-site bytes, observation counts and per-key step
        counts (the reference's JSON shape)."""
        with self._lock:
            sites = {s: {"payload_bytes": t[0], "reference_bytes": t[1],
                         "executions": t[2], "observations": t[3]}
                     for s, t in self._totals.items()}
            steps = dict(self._steps)
        return {"enabled": self._enabled, "sites": sites, "steps": steps}

    def profile(self, key: str) -> Dict[str, Tuple[int, int, int]]:
        """The newest step's profile for one key: site -> (payload bytes,
        reference bytes, executions)."""
        with self._lock:
            return dict(self._profiles.get(key, {}))

    def reset_for_tests(self) -> None:
        with self._lock:
            self._profiles.clear()
            self._steps.clear()
            self._totals.clear()
        self._enabled = True
        self._reg = None
        self._hists = {}
        self._payload = {}
        self._reference = {}
        self._execs = {}


_RUNTIME = CommRuntime()


def comm_runtime() -> CommRuntime:
    return _RUNTIME


def record_comm(site: str, payload: int, reference: int,
                executions: int = 1) -> None:
    """The hook the collective entry points call (see the module doc)."""
    _RUNTIME.record(site, payload, reference, executions)
