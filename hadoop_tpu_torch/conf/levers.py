"""Tunable-lever annotations for the port's conf registry.

HAND-MAINTAINED (``conf/registry.py`` is generated and re-exports
``LEVERS``). The entries are the reference's (``hadoop_tpu/conf/
levers.py``), unchanged in value, for the keys that the port reads
(one note drops the reference's tracker tag); a key that the port comes
to read gets the reference's entry here. Each
entry marks a conf key as a lever, a knob an autotuner may turn, with
its search space and the guard that must hold after turning it::

    "conf.key": {
        "type":    "int" | "float" | "bool" | "str" | "time" | "size",
        # exactly one of:
        "range":   (lo, hi),          # inclusive numeric search bounds
        "choices": ("a", "b", ...),   # categorical
        # optional:
        "step":    n,                 # quantization of a numeric range
        "guard":   "loss_ab" | "logits_ab" | "capacity" | None,
        "note":    "one-line operator hint",
    }

Guards name the acceptance check to run before keeping a new value:
``loss_ab`` (a training A/B of the loss), ``logits_ab`` (a serving A/B
of logits and tokens against the bitwise-parity baseline), ``capacity``
(QoS shed rate and the TTFT SLO must not regress).
"""

from __future__ import annotations

from typing import Any, Dict

LEVERS: Dict[str, Dict[str, Any]] = {
    "parallel.parity": {
        "type": "str", "choices": ("bitwise", "relaxed"), "guard": "loss_ab",
        "note": "relaxed unlocks the lowp/overlap levers below",
    },
    "parallel.lowp.codec": {
        "type": "str", "choices": ("int8", "fp8", "bf16"), "guard": "loss_ab",
        "note": "gradient/weight compression codec for collectives",
    },
    "parallel.lowp.quant.group": {
        "type": "int", "range": (128, 8192), "step": 128, "guard": "loss_ab",
        "note": "quantization group size; smaller = tighter error, more overhead",
    },
    "parallel.lowp.sync.schedule": {
        "type": "str", "choices": ("full", "periodic", "topk", "layerwise"),
        "guard": "loss_ab",
        "note": "per-layer TP activation sync schedule",
    },
    "parallel.lowp.sync.mode": {
        "type": "str", "choices": ("skip", "stale", "lowp"), "guard": "loss_ab",
        "note": "what a layer does on its off-sync steps",
    },
    "serving.parity": {
        "type": "str", "choices": ("bitwise", "relaxed"), "guard": "logits_ab",
        "note": "relaxed unlocks weight quantization at load time",
    },
    "serving.weights.codec": {
        "type": "str", "choices": ("int8", "fp8", "bf16"),
        "guard": "logits_ab",
        "note": "HBM-resident weight codec under relaxed parity",
    },
    "serving.weights.group": {
        "type": "int", "range": (32, 512), "step": 32, "guard": "logits_ab",
        "note": "weight quantization group size",
    },
    "serving.moe.capacity.factor": {
        "type": "float", "range": (1.0, 4.0), "guard": "logits_ab",
        "note": "expert capacity padding over the even-split baseline; "
                "higher = fewer dropped tokens, more padded FLOPs",
    },
    "serving.moe.a2a.codec": {
        "type": "str", "choices": ("none", "int8"), "guard": "logits_ab",
        "note": "relaxed-tier expert all2all payload codec "
                "(dispatch/combine legs; none = f32 exchange)",
    },
    "serving.kv.hbm.bytes": {
        "type": "int", "range": (0, 1 << 36), "guard": "capacity",
        "note": "HBM KV budget; 0 = derive from device memory",
    },
    "serving.kv.fetch.window": {
        "type": "int", "range": (1, 64), "guard": "capacity",
        "note": "host->HBM KV paging window (blocks per fetch)",
    },
    "serving.longctx.decode.fetch.windows": {
        "type": "int", "range": (0, 8), "guard": "logits_ab",
        "note": "pipelined decode window prefetch depth; 0 = auto",
    },
    "serving.longctx.decode.pipeline": {
        "type": "bool", "choices": (False, True), "guard": "logits_ab",
        "note": "overlap window paging with decode compute",
    },
    "serving.max.lanes": {
        "type": "int", "range": (1, 256), "guard": "capacity",
        "note": "continuous-batching lane count",
    },
    "serving.speculate.k": {
        "type": "int", "range": (0, 8), "guard": "logits_ab",
        "note": "speculative decode draft length; 0 disables",
    },
    "serving.prefill.chunk": {
        "type": "int", "range": (1, 512), "guard": "capacity",
        "note": "chunked-prefill tokens per step per lane",
    },
    "serving.qos.levels": {
        "type": "int", "range": (1, 8), "guard": "capacity",
        "note": "priority levels in the admission queue",
    },
    "serving.qos.queue.max": {
        "type": "int", "range": (16, 4096), "guard": "capacity",
        "note": "admission queue depth before shedding",
    },
    "serving.qos.shed.queue.depth": {
        "type": "int", "range": (1, 1024), "guard": "capacity",
        "note": "per-level depth at which low-priority work sheds",
    },
    "serving.autoscale.util.high": {
        "type": "float", "range": (0.5, 0.99), "guard": "capacity",
        "note": "scale-out utilization threshold",
    },
    "serving.autoscale.util.low": {
        "type": "float", "range": (0.05, 0.5), "guard": "capacity",
        "note": "scale-in utilization threshold",
    },
    "serving.autoscale.cooldown": {
        "type": "time", "range": (5.0, 600.0), "guard": "capacity",
        "note": "seconds between scaling actions",
    },
    "serving.autoscale.slo.burn": {
        "type": "bool", "choices": (False, True), "guard": "capacity",
        "note": "let the doctor's error-budget burn verdict grow the "
                "decode pool (default off)",
    },
    # ---------------------------------------------- fleet SLO scoreboard
    "obs.slo.burn.fast": {
        "type": "float", "range": (2.0, 100.0), "guard": "capacity",
        "note": "fast-window burn-rate threshold (x budget)",
    },
    "obs.slo.burn.slow": {
        "type": "float", "range": (1.0, 20.0), "guard": "capacity",
        "note": "slow-window burn-rate threshold (x budget)",
    },
}

# one target triple a tenant class (obs/slo.py): turning them redraws
# the SLO itself, so the capacity guard and tight ranges
for _cls in ("p0", "p1", "p2", "p3"):
    LEVERS[f"obs.slo.{_cls}.ttft.p99.ms"] = {
        "type": "float", "range": (50.0, 60000.0), "guard": "capacity",
        "note": f"class {_cls} windowed TTFT p99 target, ms",
    }
    LEVERS[f"obs.slo.{_cls}.token.p99.ms"] = {
        "type": "float", "range": (10.0, 10000.0), "guard": "capacity",
        "note": f"class {_cls} windowed per-token p99 target, ms",
    }
    LEVERS[f"obs.slo.{_cls}.availability"] = {
        "type": "float", "range": (0.9, 0.9999), "guard": "capacity",
        "note": f"class {_cls} availability target (error budget "
                f"= 1 - target)",
    }
del _cls
