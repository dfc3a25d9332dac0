"""The serving weight plane: per-tensor dtype/layout policy for resident
model weights.

The counterpart of ``hadoop_tpu/serving/weightplane.py``, whole. Under
``serving.parity=bitwise`` (the default) nothing here is reached: the
loader places the checkpoint's own leaves and the engine runs plain
matmuls. Under ``serving.parity=relaxed`` the matmul weights are int8
with one f32 scale per group of ``serving.weights.group`` elements along
the contraction dimension, dequantized inside each serving matmul, and
the engine sizes its KV pool against the measured resident bytes.

Layout, as the reference's: a weight ``w [.., D, N]`` that ``x @ w``
contracts over ``D`` is stored transposed-and-grouped,
``{"q": int8 [.., N, G, gs], "s": f32 [.., N, G]}`` with ``G * gs ==
D``; the embedding ``[V, D]`` (a row gather) groups along ``D`` without
the transpose. Leading ``[L]`` or ``[L, E]`` axes stay leading, so one
policy covers the layer stacks and the MoE expert stacks. The router,
norms, biases and ``pos_embed`` never quantize.

The quantizer is ``parallel/lowp/quant.py``'s ``quantize_array``, the
reference's rules bit for bit, on the leaf's own device: a loader that
quantizes on the GPU writes the bytes numpy would.

The in-graph entry points (``qdot``, ``qrows``, ``qhead``, ``qedot``)
keep the reference's order of operations: the int8 payload widened to
f32 and multiplied by its scales, the product cast to the activations'
dtype, then the matmul. Each reaches the dequantized operand through
``dequant``: on CUDA tensors one pass of the hand-written kernel
``ops/csrc/dequant.cu`` (int8 and scales in, the activations' dtype
out, ~3 B an element), on CPU tensors its plain version ``_dequant``;
the two agree bit for bit. XLA fuses the convert and scale into the
matmul's operand read; here the dequantized weight is written once and
read by the GEMM. ``launches_dequant`` counts the kernel's launches. The
engine dequantizes each dense weight once per layer per step through
``dequant`` and multiplies every row group against it.

Quantize-at-load streams: :func:`quantized_load` hands the checkpoint
loader a ``leaf_transform`` (:func:`make_load_quantizer`) that quantizes
each assembled leaf as it arrives and drops the float buffer, so the
float model never lies whole in host memory; ``peak_f32_bytes`` keeps
the reference's reckoning (2x the largest leaf).

Conf keys (read by :func:`weightplane_from_conf`), as the reference's:
``serving.parity`` (bitwise | relaxed), ``serving.weights.codec``
(int8), ``serving.weights.group`` (64), ``serving.weights.embed`` and
``serving.weights.head`` (false), ``serving.weights.guard.min-agree``
(0.95) and ``serving.weights.guard.rel-tol`` (0.25).
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from hadoop_tpu_torch.device import resolve_device
from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.obs.hbm import tree_nbytes
from hadoop_tpu_torch.ops import _build

WEIGHTS_PARITY_KEY = "serving.parity"
TIERS = ("bitwise", "relaxed")

# the per-layer matmul weights, each contracting x over its -2 axis; on
# a MoE config the three FFN names are the [L, E, ...] expert stacks
LAYER_MATMULS = frozenset({
    "wq", "wk", "wv", "wo",
    "w_gate", "w_up", "w_down",          # swiglu mlp / MoE expert stacks
    "w_in", "w_out",                     # gelu mlp (biases stay float)
})

# the expert FFN stacks of a MoE layer: ledgered as ``moe_experts``
EXPERT_STACKS = frozenset({"w_gate", "w_up", "w_down"})

_QKEYS = frozenset({"q", "s"})
_KEYSTR = re.compile(r"\['([^']+)'\]")


@dataclasses.dataclass(frozen=True)
class WeightPlaneConfig:
    """Static weight-plane policy, fixed at load time. ``tier ==
    "bitwise"`` disables everything; the flags say what the relaxed tier
    quantizes."""
    tier: str = "bitwise"
    codec: str = "int8"
    group: int = 64                  # elements per scale group
    quant_embed: bool = False
    quant_head: bool = False
    guard_min_agree: float = 0.95
    guard_rel_tol: float = 0.25

    def __post_init__(self):
        if self.tier not in TIERS:
            raise ValueError(f"{WEIGHTS_PARITY_KEY} must be one of "
                             f"{TIERS}, got {self.tier!r}")
        if self.codec != "int8":
            raise ValueError(f"serving.weights.codec: only 'int8' is "
                             f"wired, got {self.codec!r}")
        if self.group < 1:
            raise ValueError(f"serving.weights.group must be >= 1, "
                             f"got {self.group}")

    @property
    def relaxed(self) -> bool:
        return self.tier == "relaxed"


BITWISE_WEIGHTS = WeightPlaneConfig()


def weightplane_from_conf(conf) -> WeightPlaneConfig:
    """A WeightPlaneConfig from a configuration (defaults above)."""
    if conf is None:
        return BITWISE_WEIGHTS
    return WeightPlaneConfig(
        tier=conf.get(WEIGHTS_PARITY_KEY, "bitwise"),
        codec=conf.get("serving.weights.codec", "int8"),
        group=conf.get_int("serving.weights.group", 64),
        quant_embed=conf.get_bool("serving.weights.embed", False),
        quant_head=conf.get_bool("serving.weights.head", False),
        guard_min_agree=conf.get_float("serving.weights.guard.min-agree",
                                       0.95),
        guard_rel_tol=conf.get_float("serving.weights.guard.rel-tol",
                                     0.25))


# ------------------------------------------------------- the weight codec

def quantize_weight(arr: torch.Tensor, group: int, *,
                    transpose: bool) -> Dict[str, torch.Tensor]:
    """One weight leaf → ``{"q": int8 [..., G, gs], "s": f32 [..., G]}``
    on the leaf's device. ``transpose=True`` swaps the last two axes
    first, so the groups run along the contraction dimension of ``x @
    w``. A group that does not divide the contraction dimension raises."""
    # imported here: the decoder imports this module, and the parallel
    # package imports the decoder
    from hadoop_tpu_torch.parallel.lowp.quant import quantize_array
    a = arr.transpose(-1, -2) if transpose else arr
    gs = int(group)
    d = a.shape[-1] if a.dim() else 0
    if a.dim() < 1 or d % gs != 0:
        raise ValueError(
            f"serving.weights.group={gs} does not divide the "
            f"contraction dim {d} of a weight with shape "
            f"{tuple(arr.shape)} — pick a group that divides every "
            f"quantized contraction dimension")
    q, s = quantize_array(a.contiguous(), codec="int8", group=gs)
    lead = tuple(a.shape[:-1])
    return {"q": q.reshape(*lead, d // gs, gs), "s": s.reshape(*lead, d // gs)}


def dequantize_weight(qw: Dict[str, torch.Tensor], *, transpose: bool,
                      dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Inverse of :func:`quantize_weight` (the int8 reconstruction; a
    transposed weight comes back as a transposed view of its ``[.., N,
    D]`` reconstruction)."""
    from hadoop_tpu_torch.parallel.lowp.quant import dequantize_array
    q, s = qw["q"], qw["s"]
    *lead, g, gs = q.shape
    if tuple(s.shape) != tuple(lead) + (g,):
        raise ValueError(f"weight scale plane {tuple(s.shape)} does not "
                         f"match quantized payload {tuple(q.shape)} "
                         f"(expected {tuple(lead) + (g,)})")
    out = dequantize_array(q.reshape(-1, gs), s.reshape(-1),
                           tuple(lead) + (g * gs,), dtype)
    # transposed as a view: the layout qdot contracts against, so a
    # forward over the reconstruction multiplies exactly as qdot does
    return out.transpose(-1, -2) if transpose else out


def is_qtensor(leaf) -> bool:
    """Is this params-tree node a quantized weight (a ``{"q", "s"}``
    dict)?"""
    return isinstance(leaf, dict) and set(leaf.keys()) == _QKEYS


def is_quantized_tree(params) -> bool:
    """Does any leaf of ``params`` carry the quantized layout?"""
    if is_qtensor(params):
        return True
    if isinstance(params, dict):
        return any(is_quantized_tree(v) for v in params.values())
    return False


def resident_weight_bytes(params) -> int:
    """Measured resident bytes of a params tree: int8 payloads one byte
    an element, scale planes four."""
    return tree_nbytes(params)


def _dtype_name(dtype: torch.dtype) -> str:
    """numpy's name of a torch dtype ("float32", "bfloat16", "int8")."""
    return str(dtype).replace("torch.", "")


def describe_tree(params) -> Dict[str, Any]:
    """The weight plane's summary for /v1/health, the registry record and
    bench records: resident dtype, measured bytes, quantized-leaf count
    (leaves in the reference's key order)."""
    # imported here: the parallel package imports the decoder, which
    # imports this module
    from hadoop_tpu_torch.parallel.optimizer import tree_leaves
    leaves = tree_leaves(params)
    n_int8 = sum(1 for x in leaves if x.dtype == torch.int8)
    quantized = is_quantized_tree(params)
    if quantized:
        dtype = "int8"
    else:
        dtype = _dtype_name(leaves[0].dtype) if leaves else "none"
    return {"dtype": dtype, "quantized": quantized,
            "weight_bytes": resident_weight_bytes(params),
            "int8_leaves": n_int8, "leaves": len(leaves)}


# --------------------------------------------------------- policy + apply

def _resolve_flags(cfg: ModelConfig,
                   wp: WeightPlaneConfig) -> Tuple[bool, bool]:
    """(quant_embed, quant_head); a tied model has one matrix for both,
    so the flags must agree."""
    if cfg.tie_embeddings and wp.quant_head != wp.quant_embed:
        raise ValueError(
            "serving.weights.embed and serving.weights.head must match "
            "on a tied-embeddings model (one matrix serves both)")
    return wp.quant_embed, wp.quant_head


def _sync(t: torch.Tensor) -> None:
    """Wait for the device, so a timed quantization is finished work."""
    if t.device.type == "cuda":
        torch.cuda.synchronize(t.device)


def _quantize_one(key: str, arr: torch.Tensor, *, in_layers: bool,
                  wp: WeightPlaneConfig, report: Dict[str, Any]):
    """Apply the per-tensor policy to one leaf; returns the (possibly
    quantized) leaf and updates the running load report."""
    q_embed, q_head = report["_flags"]
    if in_layers and key in LAYER_MATMULS:
        transpose = True
    elif key == "embed" and q_embed:
        transpose = False
    elif key == "lm_head" and q_head:
        transpose = True
    else:
        return arr
    _sync(arr)
    t0 = time.monotonic()
    out = quantize_weight(arr, wp.group, transpose=transpose)
    _sync(out["q"])
    report["quantize_seconds"] += time.monotonic() - t0
    report["leaves_quantized"] += 1
    return out


def _fresh_report(cfg: ModelConfig,
                  wp: WeightPlaneConfig) -> Dict[str, Any]:
    if not wp.relaxed:
        # the bitwise tier never quantizes: reaching here is a wiring bug
        raise ValueError(
            f"{WEIGHTS_PARITY_KEY}={wp.tier!r} must be 'relaxed' to "
            f"quantize resident weights (the bitwise tier loads the "
            f"checkpoint's own dtypes untouched)")
    return {"tier": wp.tier, "codec": wp.codec, "group": wp.group,
            "quant_embed": wp.quant_embed, "quant_head": wp.quant_head,
            "leaves_quantized": 0, "quantize_seconds": 0.0,
            "total_f32_bytes": 0, "peak_f32_bytes": 0,
            "moe_experts": cfg.n_experts if cfg.is_moe else 0,
            "_flags": _resolve_flags(cfg, wp)}


def _finish_report(report: Dict[str, Any], params) -> Dict[str, Any]:
    report.pop("_flags", None)
    report["quantize_seconds"] = round(report["quantize_seconds"], 3)
    report["weight_bytes"] = resident_weight_bytes(params)
    if report.get("moe_experts"):
        report["expert_bytes"] = _expert_stack_bytes(params)
    return report


def _expert_stack_bytes(params) -> int:
    layers = params.get("layers", {}) if isinstance(params, dict) else {}
    return sum(resident_weight_bytes(layers[k])
               for k in EXPERT_STACKS if k in layers)


def expert_weight_bytes(params, cfg: ModelConfig) -> int:
    """Measured resident bytes of the expert FFN stacks (0 when dense)."""
    if not cfg.is_moe:
        return 0
    return _expert_stack_bytes(params)


def expert_shard_count(n_experts: int, requested: int,
                       n_devices: int) -> int:
    """Resolve ``serving.moe.shards``: the chips the expert dim splits
    across. 0 (auto) takes the largest count the devices allow that
    divides the experts; an explicit count that does not divide them or
    exceeds the devices raises."""
    if n_experts <= 0:
        return 1
    if requested:
        if requested > n_devices:
            raise ValueError(
                f"serving.moe.shards={requested} exceeds the replica's "
                f"{n_devices} local device(s)")
        if n_experts % requested:
            raise ValueError(
                f"serving.moe.shards={requested} does not divide "
                f"n_experts={n_experts} — expert shards must be equal")
        return int(requested)
    for d in range(min(n_devices, n_experts), 0, -1):
        if n_experts % d == 0:
            return d
    return 1


def shard_expert_stacks(params, shards: int, index: int):
    """Rank ``index``'s share of the expert FFN stacks of ``shards``: the
    reference's placement over its replica's chips
    (``hadoop_tpu/serving/engine.py`` ``_shard_expert_stacks``) for one
    of them. The leading layout is ``[L, E, ...]`` (float stacks) or
    ``[L, E, N, G, gs]`` / ``[L, E, N, G]`` (qtensor payload / scales):
    dim 1 is cut ``shards`` ways and piece ``index`` kept, as a
    contiguous copy, so payload and scales split together. Dense leaves
    (attention, norms, router) are the same tensors, whole."""
    if shards <= 1:
        return params

    def cut(x: torch.Tensor) -> torch.Tensor:
        if x.shape[1] % shards:
            raise ValueError(f"expert dim {x.shape[1]} does not split "
                             f"{shards} ways")
        n = x.shape[1] // shards
        return x.narrow(1, index * n, n).contiguous()

    layers = dict(params["layers"])
    for k in EXPERT_STACKS:
        if k not in layers:
            continue
        leaf = layers[k]
        layers[k] = {"q": cut(leaf["q"]), "s": cut(leaf["s"])} \
            if is_qtensor(leaf) else cut(leaf)
    out = dict(params)
    out["layers"] = layers
    return out


def quantize_params(params, cfg: ModelConfig,
                    wp: WeightPlaneConfig) -> Tuple[dict, Dict[str, Any]]:
    """A loaded params tree → its weight-plane form + the load report
    (the in-memory twin of :func:`quantized_load`: one per-leaf policy)."""
    report = _fresh_report(cfg, wp)
    out: Dict[str, Any] = {}
    for key, val in params.items():
        if key == "layers":
            out["layers"] = {
                lk: _quantize_one(lk, lv, in_layers=True, wp=wp,
                                  report=report)
                for lk, lv in val.items()}
        else:
            out[key] = _quantize_one(key, val, in_layers=False, wp=wp,
                                     report=report)
    return out, _finish_report(report, out)


def _leaf_key(name: str) -> Tuple[str, bool]:
    """(trailing key, under "layers") of a checkpoint keystr such as
    ``['params']['layers']['wq']``."""
    keys = _KEYSTR.findall(name)
    if not keys:
        return name, False
    return keys[-1], "layers" in keys[:-1]


def make_load_quantizer(cfg: ModelConfig, wp: WeightPlaneConfig, *,
                        device=None) -> Tuple[Callable, Dict[str, Any]]:
    """The streaming form of :func:`quantize_params`: a ``leaf_transform``
    for ``load_checkpoint`` that moves each assembled host leaf to
    ``device`` (default: the GPU) and quantizes it there, and the report
    it fills in. ``peak_f32_bytes`` is the reference's bound: the leaf
    plus its shard bytes, 2x the largest leaf."""
    dev = resolve_device(device)
    report = _fresh_report(cfg, wp)

    def transform(name: str, arr: torch.Tensor):
        key, in_layers = _leaf_key(name)
        f32 = arr.numel() * arr.element_size()
        report["total_f32_bytes"] += f32
        report["peak_f32_bytes"] = max(report["peak_f32_bytes"], 2 * f32)
        return _quantize_one(key, arr.to(dev), in_layers=in_layers, wp=wp,
                             report=report)

    return transform, report


def quantized_load(fs, base_dir: str, cfg: ModelConfig,
                   wp: WeightPlaneConfig, *, step: Optional[int] = None,
                   io_workers: int = 4, device=None):
    """Quantize-at-load from checkpoint shards on ``fs``: the loader
    streams one leaf at a time through the quantizer. Returns ``(params,
    step, report)``; the report carries ``quantize_seconds``, the
    measured ``weight_bytes``, the streaming peak and ``load_seconds``."""
    from hadoop_tpu_torch.serving.loader import load_serving_params
    transform, report = make_load_quantizer(cfg, wp, device=device)
    t0 = time.monotonic()
    params, step = load_serving_params(fs, base_dir, cfg, step=step,
                                       io_workers=io_workers,
                                       leaf_transform=transform,
                                       device=device)
    _finish_report(report, params)
    report["load_seconds"] = round(time.monotonic() - t0, 3)
    return params, step, report


def dequantize_params(qparams, cfg: ModelConfig) -> dict:
    """The reconstruction of a weight-plane tree in the config's dtype:
    what the engine's dequantizing matmuls contract against."""
    def walk(node, key: str):
        if is_qtensor(node):
            # every quantized leaf stores transposed but the embedding
            return dequantize_weight(node, transpose=key != "embed",
                                     dtype=cfg.torch_dtype)
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        return node

    return walk(qparams, "")


# ------------------------------------------------- in-graph entry points

_OUT_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launches_dequant = 0        # dequant.cu launches


def _dequant(q: torch.Tensor, s: torch.Tensor,
             dtype: torch.dtype) -> torch.Tensor:
    """``q [..., N, G, gs]`` times its scales ``s [..., N, G]`` in f32,
    cast to ``dtype``, as ``[..., N, G * gs]``: the plain version of the
    dequantize kernel (and the CPU's dequantize)."""
    w = q.float() * s[..., None]
    return w.reshape(*q.shape[:-2], -1).to(dtype)


def _launch_dequant(q: torch.Tensor, s: torch.Tensor,
                    dtype: torch.dtype) -> torch.Tensor:
    """``_dequant`` by the kernel, in one launch."""
    global launches_dequant
    *lead, g, gs = q.shape
    if not (q.is_cuda and s.device == q.device and q.dtype == torch.int8
            and s.dtype == torch.float32 and tuple(s.shape) == (*lead, g)
            and dtype in _OUT_DTYPES):
        raise ValueError(
            f"dequant kernel: q {q.dtype} {tuple(q.shape)} on {q.device}, "
            f"s {s.dtype} {tuple(s.shape)} on {s.device}, out {dtype}; it "
            f"takes int8 q [..., G, gs] and float32 s [..., G] on one CUDA "
            f"device and an output dtype among {list(_OUT_DTYPES)}")
    out = torch.empty(*lead, g * gs, dtype=dtype, device=q.device)
    _build.launch("htpu_dequant_int8", q.contiguous(), s.contiguous(), out,
                  q.numel(), gs, _OUT_DTYPES[dtype])
    launches_dequant += 1
    return out


def dequant(qw: Dict[str, torch.Tensor], dtype: torch.dtype
            ) -> torch.Tensor:
    """The dequantized operand ``[..., N, G * gs]`` of a quantized weight
    ``{"q": int8 [..., N, G, gs], "s": f32 [..., N, G]}`` in ``dtype``:
    the kernel for CUDA tensors, ``_dequant`` for CPU tensors (the same
    bits)."""
    if qw["q"].is_cuda:
        return _launch_dequant(qw["q"], qw["s"], dtype)
    return _dequant(qw["q"], qw["s"], dtype)


def qdot(x: torch.Tensor, qw: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Weight-only int8 matmul: ``x [..., D] @ w`` against ``{"q": int8
    [N, G, gs], "s": f32 [N, G]}``: dequantize in f32, cast to
    ``x.dtype``, multiply."""
    return x @ dequant(qw, x.dtype).t()


def qrows(qe: Dict[str, torch.Tensor], tokens: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """Quantized embedding gather: each token's int8 row and its scale
    groups, dequantized (``qe`` = {"q": [V, G, gs], "s": [V, G]})."""
    return dequant({"q": qe["q"][tokens], "s": qe["s"][tokens]}, dtype)


def qslice(qw: Dict[str, torch.Tensor], l) -> Dict[str, torch.Tensor]:
    """Layer ``l``'s slice of a layer-stacked quantized weight: payload
    and scales sliced together."""
    return {"q": qw["q"][l], "s": qw["s"][l]}


def qhead(params, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Quantized LM head: ``h @ head`` against the quantized ``lm_head``,
    or the quantized ``embed`` when embeddings are tied."""
    return qdot(h, params["embed"] if cfg.tie_embeddings
                else params["lm_head"])


def qedot(x: torch.Tensor, qw: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Expert-batched int8 matmul: ``x [E, C, D]`` against a quantized
    expert stack ``{"q": int8 [E, N, G, gs], "s": f32 [E, N, G]}``, each
    expert against its own scales."""
    return torch.bmm(x, dequant(qw, x.dtype).transpose(1, 2))


# -------------------------------------------------- logits/output guard

def weight_ab_report(logits_ref, logits_q, *, min_agree: float = 0.95,
                     rel_tol: float = 0.25) -> Dict[str, Any]:
    """Accept or reject the quantized plane from two teacher-forced logit
    tensors over identical inputs: both finite, greedy argmax agreement
    at least ``min_agree``, max |logit error| at most ``rel_tol`` of the
    reference logits' std. Returns the reference's plain-dict verdict."""
    a = _f64(logits_ref)
    b = _f64(logits_q)
    report: Dict[str, Any] = {"min_agree": min_agree, "rel_tol": rel_tol,
                              "positions": int(np.prod(a.shape[:-1]))}
    if a.shape != b.shape:
        report.update(accepted=False,
                      reason=f"logits shape {b.shape} != {a.shape}")
        return report
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        report.update(accepted=False, reason="non-finite logits")
        return report
    agree = float(np.mean(np.argmax(a, -1) == np.argmax(b, -1)))
    spread = float(max(a.std(), 1e-6))
    max_abs = float(np.abs(a - b).max())
    mean_abs = float(np.abs(a - b).mean())
    report.update(greedy_agree=round(agree, 4),
                  max_abs=round(max_abs, 6),
                  mean_abs=round(mean_abs, 6),
                  ref_std=round(spread, 6),
                  max_rel=round(max_abs / spread, 6))
    if agree < min_agree:
        report.update(accepted=False,
                      reason=f"greedy argmax agreement {agree:.4f} < "
                             f"{min_agree}")
        return report
    if max_abs / spread > rel_tol:
        report.update(accepted=False,
                      reason=f"max |logit err| {max_abs:.4f} is "
                             f"{max_abs / spread:.3f}x the reference "
                             f"spread (> {rel_tol})")
        return report
    report["accepted"] = True
    return report


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().double().cpu().numpy()
    return np.asarray(x, np.float64)


def run_weight_ab(cfg: ModelConfig, params, qparams, *, batch: int = 8,
                  seq: int = 48, seed: int = 0,
                  min_agree: Optional[float] = None,
                  rel_tol: Optional[float] = None,
                  wp: Optional[WeightPlaneConfig] = None,
                  device=None) -> Dict[str, Any]:
    """The logits A-B: a teacher-forced forward of one random token batch
    (from ``seed``) through ``params`` and through the dequantized
    ``qparams`` on ``device``, judged by :func:`weight_ab_report`. Never
    raises on a rejection: the report records it."""
    from hadoop_tpu_torch.models.decoder import forward
    wp = wp or BITWISE_WEIGHTS
    if min_agree is None:
        min_agree = wp.guard_min_agree
    if rel_tol is None:
        rel_tol = wp.guard_rel_tol
    seq = min(seq, cfg.max_seq)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(seed))
    logits_ref = forward(params, tokens, cfg, device=device)
    logits_q = forward(dequantize_params(qparams, cfg), tokens, cfg,
                       device=device)
    report = weight_ab_report(logits_ref.float(), logits_q.float(),
                              min_agree=min_agree, rel_tol=rel_tol)
    report["batch"], report["seq"] = batch, seq
    return report


__all__ = [
    "WEIGHTS_PARITY_KEY", "TIERS", "LAYER_MATMULS", "EXPERT_STACKS",
    "WeightPlaneConfig", "BITWISE_WEIGHTS", "weightplane_from_conf",
    "quantize_weight", "dequantize_weight", "is_qtensor",
    "is_quantized_tree", "resident_weight_bytes", "describe_tree",
    "quantize_params", "make_load_quantizer", "quantized_load",
    "dequantize_params", "dequant", "qdot", "qrows", "qhead", "qslice",
    "qedot",
    "expert_weight_bytes", "expert_shard_count",
    "weight_ab_report", "run_weight_ab",
]
