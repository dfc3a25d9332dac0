"""Graph against eager greedy tokens of a MoE engine, with and without the
scratch page's last-writer rule.

In a MoE step the inactive rows and the chunk's padding scatter their K/V
into the scratch page (block 0), several rows to one slot, and routing
couples the step's rows (the inactive rows read block 0 and take expert
slots ahead of live ones). ``DecodeEngine._group`` therefore has each
shared slot written with its last writer's row. This A/B serves the same
requests through the captured graphs and eagerly, twice each, under:

- ``last writer``: the engine as it serves;
- ``race``: each group scattered as it is (PyTorch's CUDA ``index_put_``
  lets any of a slot's writers land);
- ``race, deterministic``: the same under
  ``torch.use_deterministic_algorithms`` (which sorts a scatter's
  indices and keeps the last writer) with
  ``torch.utils.deterministic.fill_uninitialized_memory`` off, so that
  filling uninitialized memory plays no part.

It uses ``chip_smoke.py``'s mixtral-8x7b int8 plane and engine settings
and prints one JSON line per variant. It needs one GPU and ~75 GB of
device memory; run it from the root of a checkout::

    python3 -m hadoop_tpu_torch.tools.moe_graph_eager
"""

from __future__ import annotations

import json
import time

import torch

from hadoop_tpu_torch.serving.engine import DecodeEngine, SamplingParams

REQUESTS = (0, 1, 2)        # chip_smoke's mixtral prompts served, one at a time
REPEATS = 2                 # graph runs and eager runs of each


def _variant(smoke, qparams, cfg, prompts, last_writer: bool,
             deterministic: bool) -> dict:
    real_group = DecodeEngine._group

    def racing_group(self, *args, **kwargs):
        g = real_group(self, *args, **kwargs)
        g["src"] = None
        return g

    DecodeEngine._group = real_group if last_writer else racing_group
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
        torch.utils.deterministic.fill_uninitialized_memory = False
    try:
        eng = smoke._moe_engine(qparams, cfg, smoke.MOE["no_drop"],
                                prefix_cache=False)
        graph_launch = eng._launch_step
        out = {}
        for n, i in enumerate(REQUESTS):
            one = [prompts[i]], [SamplingParams(
                max_new_tokens=smoke.MOE["eager_new"])]
            eng._launch_step = graph_launch
            graph = [smoke._timed_run(eng, *one, warm=n == 0 and r == 0)[0][0]
                     for r in range(REPEATS)]
            eng._launch_step = eng._step_eager
            eager = [smoke._timed_run(eng, *one, warm=False)[0][0]
                     for _ in range(REPEATS)]
            runs = graph + eager
            out[i] = {"graph": graph, "eager": eager,
                      "all_equal": all(r == runs[0] for r in runs)}
        eng.stop()
        del eng, graph_launch
    finally:
        DecodeEngine._group = real_group
        if deterministic:
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = True
    smoke.free_device()
    return out


def main() -> int:
    import chip_smoke as smoke      # the checkout's root is on sys.path

    if not torch.cuda.is_available():
        print("moe_graph_eager: no CUDA device")
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smoke.phase_build()
    cfg = smoke.get_config(smoke.MOE["model"])
    qparams = smoke.build_int8_model(cfg, smoke.WEIGHTS_INT8.group,
                                     smoke.SEED + 30)
    prompts = smoke._moe_prompts(cfg.vocab_size)
    t0 = time.monotonic()
    for label, last_writer, deterministic in (
            ("race", False, False), ("last writer", True, False),
            ("race, deterministic", False, True)):
        results = _variant(smoke, qparams, cfg, prompts, last_writer,
                           deterministic)
        print(json.dumps({"variant": label, "model": smoke.MOE["model"],
                          "seconds": time.monotonic() - t0,
                          "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
