"""Long-context serving of the PyTorch port: the context-parallel
prefill (ring flavour) and its A-B guard.

A prompt too long for one chunked prefill runs as a CP job: sequence
sharded over the ranks of a ring, ring attention per layer, every
layer's post-RoPE K/V streamed out in blocks. The ranks share one device
in this port (``plan.Ring``). Not ported yet: the plane that wires the
prefill into the engine (``plane.py``) and the working-set decoder
(``decode.py``), which need the host/DFS KV tiers (ROADMAP Queue A 3),
and ulysses (Queue A 7).
"""

from hadoop_tpu_torch.serving.longctx.guard import (ParityGuardError,
                                                    longctx_ab_report,
                                                    run_prefill_ab)
from hadoop_tpu_torch.serving.longctx.plan import (Ring, choose_sp_mode,
                                                   cp_mesh, ring_order)
from hadoop_tpu_torch.serving.longctx.prefill import (
    ContextParallelPrefiller, PrefillResult)

__all__ = [
    "ContextParallelPrefiller", "PrefillResult", "ParityGuardError",
    "run_prefill_ab", "longctx_ab_report", "Ring", "ring_order",
    "cp_mesh", "choose_sp_mode",
]
