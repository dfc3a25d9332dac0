"""Mesh plans, the process groups of a mesh, and parameter sharding.

The counterpart of ``hadoop_tpu/parallel/mesh.py``. A ``MeshPlan`` names
the five parallel axes; ``make_mesh`` lays the world's ranks out as the
reference reshapes its devices, row-major over (dp, pp, tp, ep, sp), and
makes one ``torch.distributed`` process group per axis of size > 1
(``parallel/spmd.py``); ``plan.ctx`` hands the model the axes it
collects over. A mesh may take part of the world (``make_mesh``'s
``ranks``: the elastic plane's shrunken mesh over the healthy ranks).
``param_specs`` names, per dim of each leaf, the axis that shards it
(a tuple per leaf where the reference has a ``PartitionSpec``);
``shard_params`` cuts a full tree (from
``init_params`` or ``params_from_numpy``) into this rank's shards.
Under interleaved pipelines (vpp > 1) the stacked layer axis is
permuted first (``physical_layer_order``), so the contiguous pp cut
hands each rank its vpp model chunks; ``logical_layer_order`` (and
``layer_order``'s index) puts a whole tree back in checkpoint order.

Axis roles: ``dp`` data, ``pp`` pipeline (``parallel/pipeline.py``),
``tp`` tensor (Megatron sequence parallelism rides it), ``ep`` expert
(a MoE layer's all-to-all dispatch; a batch axis besides), ``sp``
context (ring or Ulysses attention).
"""

from __future__ import annotations

import dataclasses
import types
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.parallel import spmd
from hadoop_tpu_torch.parallel.pipeline import interleaved_layer_permutation
from hadoop_tpu_torch.parallel.ulysses import supports as _ulysses_supports

AXES = ("dp", "pp", "tp", "ep", "sp")


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    dp: int = 1
    pp: int = 1
    tp: int = 1
    ep: int = 1
    sp: int = 1
    megatron_sp: bool = False   # sequence parallelism on the tp axis
    sp_mode: str = "ring"       # context-parallel attention: ring | ulysses
    vpp: int = 1                # virtual stages per pp rank (interleaved
    #                             1F1B model chunks, Megatron-style)

    def __post_init__(self):
        if self.megatron_sp and self.tp == 1:
            raise ValueError("megatron_sp requires tp > 1")
        if self.vpp > 1 and self.pp == 1:
            raise ValueError("vpp (interleaved virtual stages) requires "
                             "pp > 1")
        if self.sp > 1 and self.megatron_sp:
            raise ValueError("sp composes with plain tp, not megatron_sp "
                             "(two different sequence shardings would "
                             "fight over the same dimension)")
        if self.sp > 1 and self.ep > 1:
            raise ValueError("sp x ep (MoE) is not supported yet")

    @property
    def n_devices(self) -> int:
        return self.dp * self.pp * self.tp * self.ep * self.sp

    @property
    def sizes(self) -> Dict[str, int]:
        return dict(zip(AXES, (self.dp, self.pp, self.tp, self.ep, self.sp)))

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """Mesh axes that shard the batch (grad-allreduce axes)."""
        return ("dp", "ep") if self.ep > 1 else ("dp",)

    @property
    def data_axes(self) -> Tuple[str, ...]:
        """Axes whose ranks see different tokens: a replicated leaf's
        gradient sums over these (tp only under Megatron-SP, where each
        tp rank holds a sequence shard between blocks)."""
        axes = self.batch_axes + ("sp",)
        return axes + ("tp",) if self.megatron_sp else axes

    def ctx(self, cfg: ModelConfig, mesh: "Mesh", tp_overlap_chunks: int = 1,
            relaxed_codec=None, relaxed_chunk_matmul: bool = False,
            relaxed_sync=None):
        """The ``ParallelCtx`` the model runs under on ``mesh``. The
        relaxed tier's knobs act only where a tp collective exists: a
        plan without tp keeps none of them, its sync schedule included
        (the reference's rule)."""
        from hadoop_tpu_torch.models.decoder import ParallelCtx
        sp = mesh.axis("sp")
        tp = mesh.axis("tp")
        return ParallelCtx(
            ring=None if sp is None else "sp",
            ring_size=self.sp if sp is not None else 1,
            ring_group=sp, sp_mode=self.sp_mode,
            tp=tp, megatron_sp=self.megatron_sp,
            ep=mesh.axis("ep") if cfg.is_moe else None,
            tp_overlap_chunks=tp_overlap_chunks if tp is not None else 1,
            relaxed_codec=relaxed_codec if tp is not None else None,
            relaxed_chunk_matmul=relaxed_chunk_matmul and tp is not None,
            relaxed_sync=(tuple(relaxed_sync) if relaxed_sync is not None
                          and tp is not None else None))

    def validate(self, cfg: ModelConfig, batch: int, seq: int,
                 n_microbatches: int = 1) -> None:
        checks = [
            (cfg.n_layers % self.pp == 0, "n_layers %% pp"),
            (cfg.vocab_size % self.tp == 0, "vocab %% tp"),
            (cfg.n_heads % self.tp == 0, "heads %% tp"),
            (cfg.n_kv_heads % self.tp == 0, "kv heads %% tp"),
            (cfg.d_ff % self.tp == 0, "d_ff %% tp"),
            (batch % (self.dp * self.ep) == 0, "batch %% dp*ep"),
            (seq % self.sp == 0, "seq %% sp"),
            (self.sp_mode != "ulysses" or self.sp == 1 or
             _ulysses_supports(cfg.n_heads // self.tp,
                               cfg.n_kv_heads // self.tp, self.sp),
             "heads %% sp (ulysses; after tp head split)"),
            (not self.megatron_sp or seq % self.tp == 0, "seq %% tp (sp)"),
            (not cfg.is_moe or cfg.n_experts % self.ep == 0, "experts %% ep"),
            (self.ep == 1 or cfg.is_moe, "ep needs a MoE config"),
            ((batch // (self.dp * self.ep)) % n_microbatches == 0,
             "local batch %% microbatches"),
        ]
        for ok, what in checks:
            if not ok:
                raise ValueError(f"plan/config mismatch: {what} "
                                 f"(plan={self}, cfg={cfg.family})")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place on a plan's mesh: its position in the grid
    (``rank``), its coordinate on each axis and the axis (a process
    group) of each axis of size > 1. ``ranks``: the world's ranks of the
    grid, in grid order; ``group``: an axis over all of them when they
    are part of the world (None: the default group)."""
    plan: MeshPlan
    rank: int
    coords: Dict[str, int]
    axes: Dict[str, spmd.Axis]
    ranks: Tuple[int, ...] = (0,)
    group: Optional[spmd.Axis] = None

    def axis(self, name: str) -> Optional[spmd.Axis]:
        return self.axes.get(name)

    def index(self, name: str) -> int:
        return self.coords[name]

    def broadcast(self, obj: Any) -> Any:
        """``obj`` as the grid's position 0 holds it, on every rank of
        the mesh (a collective over them)."""
        if len(self.ranks) == 1:
            return obj
        box = [obj]
        dist.broadcast_object_list(
            box, src=self.ranks[0],
            group=None if self.group is None else self.group.group)
        return box[0]


# the layout of a one-device plan: every coordinate 0, no axis
ONE_RANK = Mesh(MeshPlan(), 0, dict.fromkeys(AXES, 0), {})


def make_mesh(plan: MeshPlan, ranks: Optional[Sequence[int]] = None
              ) -> Mesh:
    """The mesh of ``plan`` over the world's ``ranks`` (default: the whole
    initialised ``torch.distributed`` world), which fill its grid in
    order; there must be ``plan.n_devices`` of them. Over the whole
    world every process calls it with the same plan (``dist.new_group``
    is collective over the world) and makes every group of every axis,
    in one order. Over part of the world only the processes among
    ``ranks`` call it: each makes its own line of each axis, in axis
    order, and one group of the whole mesh, with local synchronisation,
    so a mesh can shrink again without the processes that left it."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs torch.distributed initialised "
                           "(spmd.launch does it)")
    world = dist.get_world_size()
    ranks = tuple(range(world) if ranks is None else (int(r) for r in ranks))
    if len(ranks) != plan.n_devices:
        raise ValueError(f"plan needs {plan.n_devices} ranks, the mesh "
                         f"has {len(ranks)} of the world's {world}")
    me = dist.get_rank()
    if me not in ranks:
        raise ValueError(f"rank {me} is not among the mesh's ranks "
                         f"{list(ranks)}")
    part = len(ranks) < world
    shape = tuple(plan.sizes[a] for a in AXES)
    grid = np.array(ranks).reshape(shape)
    axes = {}
    for i, name in enumerate(AXES):
        if shape[i] == 1:
            continue
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        axes[name] = spmd.new_groups(name, lines.tolist(),
                                     members_only=part)
    group = spmd.new_groups("mesh", [ranks], members_only=True) \
        if part else None
    pos = ranks.index(me)
    coords = dict(zip(AXES, (int(c) for c in np.unravel_index(pos, shape))))
    return Mesh(plan, pos, coords, axes, ranks, group)


def param_specs(cfg: ModelConfig, plan: MeshPlan) -> Dict[str, Any]:
    """Per leaf of ``models.decoder.init_params``, the axis sharding each
    dim (None: not sharded), as the reference's PartitionSpecs."""
    layers: Dict[str, Tuple] = {
        "attn_norm_w": ("pp", None),
        "wq": ("pp", None, "tp"),
        "wk": ("pp", None, "tp"),
        "wv": ("pp", None, "tp"),
        "wo": ("pp", "tp", None),
        "mlp_norm_w": ("pp", None),
    }
    if not cfg.use_rmsnorm:
        layers["attn_norm_b"] = ("pp", None)
        layers["mlp_norm_b"] = ("pp", None)
    if cfg.is_moe:
        layers["router"] = ("pp", None, None)
        layers["w_gate"] = ("pp", "ep", None, "tp")
        layers["w_up"] = ("pp", "ep", None, "tp")
        layers["w_down"] = ("pp", "ep", "tp", None)
    elif cfg.use_swiglu:
        layers["w_gate"] = ("pp", None, "tp")
        layers["w_up"] = ("pp", None, "tp")
        layers["w_down"] = ("pp", "tp", None)
    else:
        layers["w_in"] = ("pp", None, "tp")
        layers["b_in"] = ("pp", "tp")
        layers["w_out"] = ("pp", "tp", None)
        layers["b_out"] = ("pp", None)

    specs: Dict[str, Any] = {
        "embed": ("tp", None),
        "layers": layers,
        "final_norm_w": (),
    }
    if not cfg.use_rmsnorm:
        specs["final_norm_b"] = ()
    if not cfg.use_rope:
        specs["pos_embed"] = ()
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "tp")
    return specs


def spec_axes(spec) -> Tuple[str, ...]:
    """The axes a spec names, in dim order."""
    return tuple(a for a in spec if a is not None)


def _map_specs(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_specs(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def shard_tensor(x: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's shard of one full leaf under ``spec``, as a contiguous
    copy: each dim the spec names is cut ``size`` ways and the piece at
    this rank's coordinate kept."""
    sizes = mesh.plan.sizes
    for dim, name in enumerate(spec):
        if name is None or sizes[name] == 1:
            continue
        n = x.shape[dim] // sizes[name]
        x = x.narrow(dim, mesh.index(name) * n, n)
    return x.contiguous()


def shard_params(params, plan: MeshPlan, mesh: Mesh):
    """This rank's shards of a full parameter tree (``shard_tensor`` of
    each leaf)."""
    return _map_specs(lambda x, spec: shard_tensor(x, spec, mesh), params,
                      param_specs_for(params, plan))


def layer_order(n_layers: int, plan: MeshPlan, logical: bool = False
                ) -> Optional[torch.Tensor]:
    """The index that lays a logically ordered layer stack out for the
    plan (``stack[order]``), or with ``logical`` the one that puts it
    back; None when vpp is 1 (no permutation)."""
    if plan.vpp <= 1:
        return None
    perm = interleaved_layer_permutation(n_layers, plan.pp, plan.vpp)
    return torch.from_numpy(np.argsort(perm) if logical else np.array(perm))


def _permute_layers(params, order):
    if order is None:
        return params
    out = dict(params)
    out["layers"] = {k: v[order.to(v.device)].contiguous()
                     for k, v in params["layers"].items()}
    return out


def physical_layer_order(params, cfg: ModelConfig, plan: MeshPlan):
    """The interleaved placement (vpp > 1): the stacked layer axis
    permuted so the contiguous pp cut of ``shard_params`` hands rank s
    its chunks {c·pp + s}. The tree itself when vpp is 1."""
    return _permute_layers(params, layer_order(cfg.n_layers, plan))


def logical_layer_order(params, cfg: ModelConfig, plan: MeshPlan):
    """The inverse of ``physical_layer_order``: a gathered tree back in
    checkpoint (single-device) layer order."""
    return _permute_layers(params, layer_order(cfg.n_layers, plan, True))


def param_specs_for(params, plan: MeshPlan):
    """``param_specs`` for the leaves ``params`` holds (the config is
    read off the tree: which optional leaves it has)."""
    layers = params["layers"]
    return param_specs(types.SimpleNamespace(
        use_rmsnorm="attn_norm_b" not in layers, is_moe="router" in layers,
        use_swiglu="w_gate" in layers, use_rope="pos_embed" not in params,
        tie_embeddings="lm_head" not in params), plan)
