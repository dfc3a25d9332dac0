"""The relaxed parity tier: parity tiers for the communication stack.

The counterpart of ``hadoop_tpu/parallel/lowp``. ``parallel.parity``
names the contract a train step is built under:

- ``bitwise`` (the default): every collective moves exact values and no
  code of this package runs on the step's path.
- ``relaxed``: collectives may trade bits for bytes and schedule. The
  guard is statistical (:mod:`guard`: allclose guards on values and the
  loss-curve A-B of ``run_loss_ab``), not ``==``.

Under the relaxed tier four consumers turn on (Flash Communication,
arXiv:2412.04964; T3, arXiv:2401.16677; partially synchronized
activations, arXiv:2506.19645):

1. quantized gradient buckets: the overlap pass's bucketed sums and
   ZeRO-1 reduce-scatters ride the wire as int8 (or fp8) with shared
   f32 scales (``parallel/overlap.py``);
2. the quantized ZeRO-1 gather of the updated slices, at full int8
   range;
3. quantized tp reduces, one tensor scale per chunk
   (``ops/collective_matmul.py``), and the chunked tp matmul;
4. per-layer tp sync schedules (:mod:`syncpolicy`): a scheduled-off
   layer skips its reduce or consumes the previous step's correction.

The conf keys are the reference's (``parity_from_conf``):

  parallel.parity                   bitwise | relaxed   (default bitwise)
  parallel.lowp.codec               int8 | fp8          (default int8)
  parallel.lowp.quant.buckets       default true
  parallel.lowp.quant.zero1-gather  default true
  parallel.lowp.quant.tp            default true
  parallel.lowp.chunk-matmul        default true
  parallel.lowp.quant.group         default 1024 (elements per scale)
  parallel.lowp.sync.schedule       default full (full | none |
                                    periodic:<k> | layers:<spec>)
  parallel.lowp.sync.mode           default skip (skip | stale)
  parallel.lowp.sync.guard.rel-tol  default 2.0
  parallel.lowp.guard.steps         default 50
  parallel.lowp.guard.rel-tol       default 0.25

The codec (``quantize_array``, ``dequantize_array``, ``encode_payload``,
``decode_payload``) is exported lazily, as the reference's is.
"""

from __future__ import annotations

import dataclasses

PARITY_KEY = "parallel.parity"
TIERS = ("bitwise", "relaxed")
WIRE_CODECS = ("int8", "fp8")


@dataclasses.dataclass(frozen=True)
class ParityConfig:
    """Static parity-tier knobs, fixed when the train step is built.
    ``tier == "bitwise"`` turns every consumer off whatever the
    per-consumer flags say: they describe what the relaxed tier
    quantizes."""
    tier: str = "bitwise"
    codec: str = "int8"               # int8 | fp8
    quant_buckets: bool = True        # gradient bucket sums and scatters
    quant_zero1_gather: bool = True   # ZeRO-1 gather of the slices
    quant_tp: bool = True             # row-parallel tp reduces
    chunk_matmul: bool = True         # chunked tp matmul
    group: int = 1024                 # elements per shared scale
    relaxed_sync: str = "full"        # parallel.lowp.sync.schedule
    relaxed_sync_mode: str = "skip"   # parallel.lowp.sync.mode
    # the loss-curve tolerance of a run whose schedule turns a sync off
    # (a schedule shifts the trajectory; see syncpolicy.py)
    sync_guard_rel_tol: float = 2.0
    guard_steps: int = 50
    guard_rel_tol: float = 0.25

    def __post_init__(self):
        if self.tier not in TIERS:
            raise ValueError(f"{PARITY_KEY} must be one of {TIERS}, "
                             f"got {self.tier!r}")
        if self.codec not in WIRE_CODECS:
            raise ValueError(f"parallel.lowp.codec must be one of "
                             f"{WIRE_CODECS}, got {self.codec!r}")
        # the grammar at config time; the layer count is checked when the
        # train step resolves the schedule
        from hadoop_tpu_torch.parallel.lowp.syncpolicy import validate_spec
        validate_spec(self.relaxed_sync, self.relaxed_sync_mode)

    @property
    def relaxed(self) -> bool:
        return self.tier == "relaxed"


BITWISE_PARITY = ParityConfig()
RELAXED_PARITY = ParityConfig(tier="relaxed")


def parity_from_conf(conf) -> ParityConfig:
    """A ParityConfig from a Configuration (defaults above)."""
    if conf is None:
        return BITWISE_PARITY
    return ParityConfig(
        tier=conf.get(PARITY_KEY, "bitwise"),
        codec=conf.get("parallel.lowp.codec", "int8"),
        quant_buckets=conf.get_bool("parallel.lowp.quant.buckets", True),
        quant_zero1_gather=conf.get_bool(
            "parallel.lowp.quant.zero1-gather", True),
        quant_tp=conf.get_bool("parallel.lowp.quant.tp", True),
        chunk_matmul=conf.get_bool("parallel.lowp.chunk-matmul", True),
        group=conf.get_int("parallel.lowp.quant.group", 1024),
        relaxed_sync=conf.get("parallel.lowp.sync.schedule", "full"),
        relaxed_sync_mode=conf.get("parallel.lowp.sync.mode", "skip"),
        sync_guard_rel_tol=conf.get_float(
            "parallel.lowp.sync.guard.rel-tol", 2.0),
        guard_steps=conf.get_int("parallel.lowp.guard.steps", 50),
        guard_rel_tol=conf.get_float("parallel.lowp.guard.rel-tol", 0.25))


_QUANT_API = ("quantize_array", "dequantize_array", "encode_payload",
              "decode_payload")


def __getattr__(name: str):
    if name in _QUANT_API:
        from hadoop_tpu_torch.parallel.lowp import quant
        return getattr(quant, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["ParityConfig", "parity_from_conf", "BITWISE_PARITY",
           "RELAXED_PARITY", "PARITY_KEY", "TIERS", "WIRE_CODECS",
           *_QUANT_API]
