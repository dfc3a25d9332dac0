"""Long-context serving of the PyTorch port: prompts longer than
``serving.longctx.min.tokens`` as a lane of their own.

The counterpart of ``hadoop_tpu/serving/longctx``: the context-parallel
prefill (ring or Ulysses, ``serving.longctx.sp.mode``; the ranks share
one device, ``plan.Ring``), its
A-B guard, the working-set decoder (``decode.py``) that pages the
streamed KV chain back from the host/DFS tiers through a fixed device
window, and the plane (``plane.py``) that ties them into the engine's
request lifecycle (``DecodeEngine.attach_longctx``).
"""

from hadoop_tpu_torch.serving.longctx.decode import (WorkingSetDecoder,
                                                     trace_counts)
from hadoop_tpu_torch.serving.longctx.guard import (ParityGuardError,
                                                    longctx_ab_report,
                                                    run_prefill_ab)
from hadoop_tpu_torch.serving.longctx.plan import (Ring, choose_sp_mode,
                                                   cp_mesh, ring_order)
from hadoop_tpu_torch.serving.longctx.plane import (CHIPS_KEY, ENABLED_KEY,
                                                    MAX_TOKENS_KEY,
                                                    MIN_TOKENS_KEY,
                                                    SP_MODE_KEY, TAIL_KEY,
                                                    WINDOW_KEY,
                                                    LongContextPlane,
                                                    longctx_plane_from_conf)
from hadoop_tpu_torch.serving.longctx.prefill import (
    ContextParallelPrefiller, PrefillResult)

__all__ = [
    "LongContextPlane", "longctx_plane_from_conf",
    "ContextParallelPrefiller", "PrefillResult", "WorkingSetDecoder",
    "ParityGuardError", "run_prefill_ab", "longctx_ab_report", "Ring",
    "ring_order", "cp_mesh", "choose_sp_mode", "trace_counts",
    "ENABLED_KEY", "MIN_TOKENS_KEY", "MAX_TOKENS_KEY", "CHIPS_KEY",
    "SP_MODE_KEY", "WINDOW_KEY", "TAIL_KEY",
]
