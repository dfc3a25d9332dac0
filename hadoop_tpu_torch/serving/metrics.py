"""Serving metrics — the replica's observability face.

The counterpart of ``hadoop_tpu/serving/metrics.py``, whole: the same
source (``serving.engine``), metric names, descriptions and label sets,
registered into the port's process-wide ``metrics_system()`` and exposed
on the door's ``/jmx`` and ``/prom``. The families of the long-context
plane, which the port does not have yet, are registered and stay at
zero, so a scrape reads the same families from either package.
"""

from __future__ import annotations

from hadoop_tpu_torch.metrics import metrics_system

SOURCE = "serving.engine"


class ServingMetrics:
    """Queue depth / batch occupancy / TTFT / tokens/s / KV-pool usage.

    - ``queue_depth``        requests waiting for a slot or pages
    - ``batch_occupancy``    running requests in the fixed decode batch
    - ``kv_blocks_in_use``   allocated KV pages (and a 0..1 utilization)
    - ``time_to_first_token`` quantiles (s), submit → first token
    - ``decode_step``        per-step latency rate (num_ops = steps)
    - ``tokens_out``         generated tokens (monotonic; tokens/s is the
                             derivative any sink can take)
    - ``requests`` / ``preemptions`` lifetime counters
    - ``prefix_cache_hit_rate``  fraction of admitted prompt tokens
                             served from cached KV blocks (0..1)
    - ``prefix_cached_blocks``   resident reusable KV pages
    - ``prefix_tokens_reused`` / ``prefix_cache_evictions`` counters
    - ``chunk_occupancy``    fraction of the per-step prefill-chunk
                             budget actually used last step
    - ``prefill_backlog``    prompt tokens still awaiting prefill across
                             admitted requests (the stall gauge: how far
                             first tokens lag behind admission)
    - ``kv_hits_{hbm,host,dfs}`` per-tier KV block hit counters
    - ``kv_demotions`` / ``kv_promotions`` / ``kv_dfs_persists``
                             tier traffic (HBM→host spills, cold-tier
                             re-injections, DFS write-pipeline persists)
    - ``kv_fetch_seconds{tier=host|dfs}`` log-bucketed cold-fetch
                             latency histograms (one prom family)
    - ``spec_proposed`` / ``spec_accepted`` speculative-decoding draft
                             token counters (proposal vs verifier)
    - ``spec_accept_len``    log-bucketed accepted-draft-length
                             histogram per speculating lane-step
    - ``qos_admitted`` / ``qos_shed``  door QoS gate outcomes (sheds
                             are 429 + Retry-After responses)
    - ``qos_tenants``        tenants tracked by the decay scheduler
    - ``longctx_requests`` / ``longctx_blocks_streamed`` /
      ``longctx_window_fetches`` / ``longctx_chips`` /
      ``longctx_prefill_seconds``  long-context plane: prompts routed
                             to CP prefill, KV blocks streamed to the
                             cold tiers, decode window page-ins, CP
                             width, prefill wall time
    - ``weight_bytes``       measured resident model weight bytes
                             (``htpu_weight_bytes`` on ``/prom`` — the
                             weight-plane capacity signal: int8 resident
                             weights shrink it ~4x and the KV budget
                             grows by exactly the difference)
    """

    def __init__(self, source: str = SOURCE):
        reg = metrics_system().source(source)
        self.registry = reg
        self.queue_depth = reg.gauge(
            "queue_depth", "requests waiting for admission")
        self.batch_occupancy = reg.gauge(
            "batch_occupancy", "running requests in the decode batch")
        self.kv_blocks_in_use = reg.gauge(
            "kv_blocks_in_use", "allocated KV-cache pages")
        self.kv_block_utilization = reg.gauge(
            "kv_block_utilization", "fraction of the KV pool in use")
        self.ttft = reg.quantiles(
            "time_to_first_token", "submit to first token, seconds")
        # log-bucketed twins for the /prom exposition (quantiles/rates
        # stay for JMX parity — same samples, two shapes)
        self.ttft_hist = reg.histogram(
            "time_to_first_token_seconds", "submit to first token")
        self.decode_step = reg.rate(
            "decode_step", "one continuous-batching decode step")
        self.decode_step_hist = reg.histogram(
            "decode_step_seconds", "one continuous-batching decode step")
        self.tokens_out = reg.counter(
            "tokens_out", "tokens generated (all requests)")
        self.requests = reg.counter("requests", "requests submitted")
        self.preemptions = reg.counter(
            "preemptions", "requests evicted from the KV pool")
        self.prefix_cache_hit_rate = reg.gauge(
            "prefix_cache_hit_rate",
            "fraction of prompt tokens served from cached KV blocks")
        self.prefix_cached_blocks = reg.gauge(
            "prefix_cached_blocks", "resident reusable KV pages")
        self.prefix_tokens_reused = reg.counter(
            "prefix_tokens_reused",
            "prompt tokens whose prefill was skipped via the prefix cache")
        self.prefix_cache_evictions = reg.counter(
            "prefix_cache_evictions",
            "cached KV pages evicted (LRU) to feed live allocations")
        self.chunk_occupancy = reg.gauge(
            "chunk_occupancy",
            "fraction of the per-step prefill chunk budget used")
        self.prefill_backlog = reg.gauge(
            "prefill_backlog",
            "prompt tokens still awaiting prefill across admitted "
            "requests")
        # tiered KV cache: per-tier hit counters, demotion/promotion
        # traffic, and log-bucketed fetch latency published under ONE
        # prom family (kv_fetch_seconds{tier=...}) — a dashboard reads
        # the HBM→host→DFS waterfall off a single query
        self.kv_hits_hbm = reg.counter(
            "kv_hits_hbm", "KV blocks served from the HBM radix tier")
        self.kv_hits_host = reg.counter(
            "kv_hits_host",
            "KV blocks recovered from the host-RAM ring")
        self.kv_hits_dfs = reg.counter(
            "kv_hits_dfs",
            "KV blocks recovered from the DFS prefix store")
        self.kv_demotions = reg.counter(
            "kv_demotions",
            "zero-ref KV pages spilled HBM -> host ring at eviction")
        self.kv_promotions = reg.counter(
            "kv_promotions",
            "KV pages re-injected into HBM from a cold tier")
        self.kv_dfs_persists = reg.counter(
            "kv_dfs_persists",
            "KV pages persisted to the DFS prefix store")
        self.kv_fetch_hist = {
            tier: reg.histogram(
                f"kv_fetch_seconds_{tier}",
                "cold-tier KV block fetch latency",
                prom_name="kv_fetch_seconds",
                prom_labels={"tier": tier})
            for tier in ("host", "dfs")}
        # speculative decoding: draft tokens proposed by the n-gram
        # index vs accepted by the in-step verifier, plus a
        # log-bucketed per-lane accepted-length histogram (one prom
        # family — the acceptance-depth distribution in one query)
        self.spec_proposed = reg.counter(
            "spec_proposed",
            "draft tokens proposed to the speculation lane")
        self.spec_accepted = reg.counter(
            "spec_accepted",
            "draft tokens accepted by the in-step verifier")
        self.spec_accept_len = reg.histogram(
            "spec_accept_len",
            "accepted draft-prefix length per speculating lane-step")
        # door QoS: admissions vs sheds (429) and tracked tenants — the
        # autoscaler scrapes qos_shed off /prom as a scale-out signal
        # (a shedding fleet is past its SLO by definition)
        self.qos_admitted = reg.counter(
            "qos_admitted", "requests admitted through the QoS gate")
        self.qos_shed = reg.counter(
            "qos_shed",
            "requests shed (429 + Retry-After) at the serving door")
        self.qos_tenants = reg.gauge(
            "qos_tenants", "tenants tracked by the decay cost scheduler")
        # fleet SLO scoreboard (obs/slo): class-labeled request
        # accounting the doctor diffs per poll window. The class set
        # is the BOUNDED p0..p3 ladder (DecayCostScheduler level,
        # clamped — see obs/slo.py's SLO_CLASSES), written out inline
        # so the label set is visibly closed.
        self.slo_ttft_hist = {
            cls: reg.histogram(
                f"slo_ttft_seconds_{cls}",
                "submit to first token by tenant class",
                prom_name="slo_ttft_seconds",
                prom_labels={"class": cls})
            for cls in ("p0", "p1", "p2", "p3")}
        self.slo_token_hist = {
            cls: reg.histogram(
                f"slo_token_seconds_{cls}",
                "per-token decode seconds by tenant class",
                prom_name="slo_token_seconds",
                prom_labels={"class": cls})
            for cls in ("p0", "p1", "p2", "p3")}
        self.slo_requests = {
            (cls, outcome): reg.counter(
                f"slo_requests_{cls}_{outcome}",
                "door outcomes by tenant class",
                prom_name="slo_requests",
                prom_labels={"class": cls, "outcome": outcome})
            for cls in ("p0", "p1", "p2", "p3")
            for outcome in ("ok", "shed", "failed")}
        # the weight plane: measured resident weight bytes (int8
        # payloads + scale planes under serving.parity=relaxed, plain
        # dtype bytes bitwise) — the number the KV budget subtracts
        self.weight_bytes = reg.gauge(
            "weight_bytes", "resident model weight bytes on the chip")
        # the long-context plane (serving/longctx): monster prompts
        # routed to CP prefill, KV blocks streamed into the cold
        # tiers, decode window page-ins, CP width, and the prefill
        # wall-time histogram (htpu_longctx_* on /prom)
        self.longctx_requests = reg.counter(
            "longctx_requests",
            "prompts routed to the long-context CP prefill plane")
        self.longctx_blocks_streamed = reg.counter(
            "longctx_blocks_streamed",
            "prefilled KV blocks streamed into the cold tiers")
        self.longctx_window_fetches = reg.counter(
            "longctx_window_fetches",
            "decode working-set window page-ins (per layer, window)")
        self.longctx_chips = reg.gauge(
            "longctx_chips", "context-parallel width of the mesh")
        self.longctx_prefill_hist = reg.histogram(
            "longctx_prefill_seconds",
            "context-parallel prefill wall time per prompt")

    def snapshot(self):
        return self.registry.snapshot()
