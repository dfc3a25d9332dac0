"""The training step, on one device or on a mesh of process groups.

The counterpart of ``hadoop_tpu/parallel/train.py``'s
``make_train_step``, ``init_sharded``, ``make_data_sharding`` and
``zero1_layout``: forward through the decoder (``remat`` as there), the
chunked LM-head cross-entropy (vocab-parallel under tp), the backward —
through the flash-attention backward kernels on a CUDA device — and an
AdamW (or plain SGD) update, ZeRO-1 on request. PyTorch runs it
eagerly; the step updates the parameters and the optimizer state in
place. Its four parts run under ``torch.profiler.record_function``
ranges ("forward", "loss", "backward", "optimizer"), which a profile
shows beside the kernels (``tools/profile_flagship.py --train``;
``--train-moe`` also shows the MoE MLP's "moe.route" and "moe.experts").
A MoE model trains as the reference's single-device step does: no
auxiliary loss, the router learning only through the renormalised top-k
gates of ``combine``.

On a mesh (``parallel/mesh.py``: one process per rank; dp, tp with or
without Megatron-SP, sp as ring or Ulysses, ep, pp, and their
compositions) each rank runs the step on its shards and its slice of
the batch (``make_data_sharding``). The gradient rule of the reference:
each leaf's gradient is summed over every data axis (dp, ep, sp, and tp
under Megatron-SP: the axes whose ranks see different tokens), and over
pp when the plan has stages, that its spec does not name, and divided by
dp·ep·sp so the loss is a mean over the global batch. Inside the model,
``spmd.copy_to`` supplies the sums the reference's vma tracking inserts
for a value every tp rank holds. With pp > 1 the step runs a pipeline
schedule (``parallel/pipeline.py``: "1f1b", "gpipe", or "interleaved",
which vpp > 1 selects) over ``n_microbatches`` microbatches of the
local batch; at pp = 1 the step is the flat one whatever the count, as
the reference's ``flat_loss`` (only ``validate`` reads it there).

``parity`` (``parallel/lowp``, default bitwise) is the tier the step is
built under. Bitwise is the step as it always was: no code of ``lowp``
runs. Relaxed turns on the consumers its ``ParityConfig`` names: the
gradient sums (and ZeRO-1 reduce-scatters) of the overlap pass as
quantized buckets, the quantized ZeRO-1 gather, the quantized chunked tp
reduce and the chunked tp matmul, and the per-layer tp sync schedule.
They ride the overlap pass, so relaxed without it raises; a schedule
needs the flat layer stack (pp = 1), and a plan without tp has none. A
stale schedule's corrections, ``[n_stale, 2, B, S_eff, D]`` a rank (the
reference's global ``[pp, tp, n_stale, 2, B, S_eff, D]`` cut to this
rank), live in the step: zeros when the batch shape changes, never
checkpointed (a restart takes one skip step). The reference's gradient
sums on every plan this slice runs are inside its autodiff, where no
quantizer reaches (ROADMAP Queue C 9); the port's are the overlap pass's
explicit buckets, and its relaxed tier quantizes them, as the
reference's manual-schedule buckets are meant to be.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from hadoop_tpu_torch.device import check_on, resolve_device
from hadoop_tpu_torch.models.config import ModelConfig
from hadoop_tpu_torch.models.decoder import (SINGLE, _layer_fn,
                                             final_hidden, forward_hidden,
                                             head_matrix, init_params)
from hadoop_tpu_torch.ops.cross_entropy import chunked_lm_cross_entropy
from hadoop_tpu_torch.parallel import overlap as ov
from hadoop_tpu_torch.parallel import pipeline, spmd
from hadoop_tpu_torch.parallel.lowp import BITWISE_PARITY, ParityConfig
from hadoop_tpu_torch.parallel.mesh import (Mesh, MeshPlan, layer_order,
                                            param_specs,
                                            physical_layer_order,
                                            shard_params, shard_tensor,
                                            spec_axes)
from hadoop_tpu_torch.parallel.optimizer import (AdamWState, adamw_init,
                                                 adamw_update, grad_sq,
                                                 tree_leaves, tree_map,
                                                 zero1_init_local,
                                                 zero1_leaf_plan,
                                                 zero1_update)


def _loss_from_h(params, h, targets, cfg: ModelConfig, ctx=SINGLE,
                 chunk: int = 256):
    """LM loss from pre-head hidden states, chunked over the sequence so
    the full [B, S, V] logits never materialize; vocab-parallel under
    tp."""
    h = final_hidden(params, h, cfg, ctx)
    head = head_matrix(params, cfg, h.dtype)
    if ctx.tp is not None:
        return chunked_lm_cross_entropy(
            h, head, targets, chunk, axis=ctx.tp,
            vocab_shard_size=cfg.vocab_size // ctx.tp_size)
    return chunked_lm_cross_entropy(h, head, targets, chunk)


def _map_leaves(fn, tree, specs):
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, tree[k], specs[k]) for k in tree}
    return fn(tree, specs)


def zero1_layout(cfg: ModelConfig, plan: MeshPlan):
    """Per-leaf ZeRO-1 state layout, as the reference's: (data axes
    partitioning the state, global state shape ``(*spec axis sizes,
    *data axis sizes, K)``, the axes naming each of its leading dims,
    the axis sizes). A rank holds one (K,) slice of each."""
    shapes = tree_map(lambda t: tuple(t.shape),
                      init_params(cfg, None, device="meta"))
    specs = param_specs(cfg, plan)
    sizes = plan.sizes

    def leaf(shape, spec):
        sp_ax = spec_axes(spec)
        z_ax = zero1_leaf_plan(sp_ax, plan.batch_axes)
        numel = 1
        for n in shape:
            numel *= n
        denom = 1
        for a in sp_ax:
            denom *= sizes[a]
        z = 1
        for a in z_ax:
            z *= sizes[a]
        k = -(-max(1, numel // denom) // z)
        return (z_ax, tuple(sizes[a] for a in sp_ax) +
                tuple(sizes[a] for a in z_ax) + (k,), sp_ax + z_ax)

    layout = _map_leaves(leaf, shapes, specs)
    pick = lambda i: tree_map(lambda lo: lo[i], layout)  # noqa: E731
    return pick(0), pick(1), pick(2), sizes


def make_data_sharding(mesh: Mesh) -> Callable[[torch.Tensor], torch.Tensor]:
    """The cut of a global [B, S] batch this rank trains on: its rows
    over (dp, ep), dp major (contiguous blocks of B/(dp·ep)), and its sp
    sequence shard (the reference's ``P(("dp", "ep"), "sp")``)."""
    plan = mesh.plan

    def cut(x: torch.Tensor) -> torch.Tensor:
        b, s = x.shape[0] // (plan.dp * plan.ep), x.shape[1] // plan.sp
        i = mesh.index("dp") * plan.ep + mesh.index("ep")
        j = mesh.index("sp")
        return x[i * b:(i + 1) * b, j * s:(j + 1) * s]
    return cut


def _axes_of(mesh: Optional[Mesh], names) -> Tuple[spmd.Axis, ...]:
    if mesh is None:
        return ()
    return tuple(a for a in (mesh.axis(n) for n in names) if a is not None)


def make_train_step(cfg: ModelConfig, plan: Optional[MeshPlan] = None,
                    mesh: Optional[Mesh] = None, *,
                    lr: float = 3e-4, n_microbatches: int = 1,
                    pipeline_schedule: str = "1f1b",
                    remat=False, optimizer: str = "adamw",
                    zero1: bool = False,
                    overlap: Optional[ov.OverlapConfig] = None,
                    parity: Optional[ParityConfig] = None,
                    attn_impl: str = "auto", device=None):
    """The train step on ``device`` (default: the GPU; raises without one
    unless ``device="cpu"``), on ``mesh`` (``make_mesh(plan)``) when the
    plan has more than one rank.

    Returns ``step(params, opt_state, tokens, targets) -> (params,
    opt_state, {"loss", "grad_norm"})``: params and opt_state are this
    rank's shards (``init_sharded``); tokens and targets are this rank's
    [B_local, S_local] integers (``make_data_sharding``; the whole batch
    on one device); the returned trees are the ones passed in, updated
    in place; the metrics are 0-d float32 tensors on the device, the
    same on every rank (reading one waits for the step). ``optimizer``:
    "adamw", or "sgd" (p - lr·g, the reference's exact-parity mode).
    ``zero1``: AdamW with its moments sliced over the data axes.
    ``overlap`` (default on): bucketed gradient sums (reduce-scattered
    into the ZeRO-1 slices) and bucketed ZeRO-1 gathers; on and off
    give the same bits. ``attn_impl`` as in ``causal_attention``.
    ``n_microbatches`` and ``pipeline_schedule`` ("1f1b", "gpipe",
    "interleaved") drive a plan with pp > 1 (``parallel/pipeline.py``);
    after each step ``step.stats`` holds the schedule's stats (stage,
    ticks, the most stage inputs stashed at once). ``parity``: the
    parity tier (module doc; default bitwise).
    """
    plan = MeshPlan() if plan is None else plan
    overlap = ov.DEFAULT_OVERLAP if overlap is None else overlap
    parity = BITWISE_PARITY if parity is None else parity
    clock = pipeline.make_clock(pipeline_schedule, n_microbatches, plan.pp,
                                plan.vpp)
    if plan.pp == 1:                      # the flat step
        clock = None
    if plan.n_devices > 1 and (mesh is None or mesh.plan != plan):
        raise ValueError(f"plan {plan} needs its mesh (make_mesh(plan))")
    if optimizer not in ("adamw", "sgd"):
        raise ValueError(f"optimizer={optimizer!r} (choices: adamw, sgd)")
    zero1 = zero1 and optimizer == "adamw"
    _layer_fn(remat)                      # refuse an unknown mode now
    dev = resolve_device(device)
    rq_buckets = rq_gather = relaxed_codec = sched = vma = None
    if parity.relaxed:
        rq_buckets, rq_gather, relaxed_codec, sched = _relaxed_knobs(
            parity, cfg, plan, overlap)
    specs = param_specs(cfg, plan)
    if parity.relaxed:
        # the reference's bucket signature: the axes a leaf varies over
        vma = _map_leaves(lambda _, s: spec_axes(s), specs, specs)
    ctx = plan.ctx(cfg, mesh, tp_overlap_chunks=(
        overlap.tp_chunks if overlap.enabled else 1),
        relaxed_codec=relaxed_codec,
        relaxed_chunk_matmul=parity.relaxed and parity.chunk_matmul,
        relaxed_sync=sched) if mesh is not None else SINGLE
    n_stale = sum(m == "stale" for m in ctx.relaxed_sync or ())
    sync = {"shape": None, "state": None}
    loss_div = plan.dp * plan.ep * plan.sp
    # per leaf: the axes its gradient sums over (the data axes, and pp:
    # the stages hold different parts of a leaf they do not shard), the
    # axes its norm sums over (those that shard it), and the ZeRO-1 state
    # axes
    red_axes = _map_leaves(lambda _, s: _axes_of(mesh, [
        a for a in plan.data_axes + ("pp",) if a not in spec_axes(s)]),
        specs, specs)
    norm_axes = _map_leaves(lambda _, s: _axes_of(mesh, spec_axes(s)),
                            specs, specs)
    z1_axes = _map_leaves(lambda _, s: _axes_of(mesh, zero1_leaf_plan(
        spec_axes(s), plan.batch_axes)), specs, specs)
    metric_axes = _axes_of(mesh, ("pp", "dp", "ep", "sp"))

    def reduce_grads(grads, params):
        """Sums over the reduce axes (bucketed or per leaf); ZeRO-1 keeps
        only this rank's slices; then a pipeline's float32 accumulators
        over M, cast to the parameters' dtypes, and the mean-loss
        scale."""
        # no comm-ledger site on the bitwise tier: these sums are the
        # port's form of the ones the reference's autodiff inserts, which
        # its ledger does not see; the relaxed buckets record their wire
        if zero1 and overlap.enabled:
            grads = ov.bucketed_psum_scatter(grads, red_axes, z1_axes,
                                             overlap.bucket_bytes,
                                             relaxed=rq_buckets, vma=vma)
        elif overlap.enabled:
            grads = ov.bucketed_psum(grads, red_axes, overlap.bucket_bytes,
                                     relaxed=rq_buckets, vma=vma)
        else:
            grads = tree_map(lambda g, axes: ov._psum_axes(g, axes),
                             grads, red_axes)
            if zero1:
                grads = tree_map(ov.local_slice, grads, z1_axes)
        if clock is not None:
            grads = tree_map(lambda g, p: (g / clock.M).to(p.dtype),
                             grads, params)
        if loss_div > 1:     # in place (a narrower float divides in float32)
            tree_map(lambda g: g.div_(loss_div), grads)
        return grads

    def global_grad_sq(grads):
        """Squared global norm: each group of leaves sharded alike (or
        sliced alike, under ZeRO-1) summed locally, then over its axes."""
        axes_tree = tree_map(lambda a, b: a + b, norm_axes, z1_axes) \
            if zero1 else norm_axes
        groups: Dict[Tuple[str, ...], list] = {}
        for g, axes in zip(tree_leaves(grads), tree_leaves(axes_tree)):
            groups.setdefault(axes, []).append(g)
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for axes, gs in groups.items():
            part = grad_sq(dict(enumerate(gs)))
            for a in axes:
                part = spmd.psum_raw(part, a)
            total = total + part
        return total

    def stale_state(tokens):
        """The stale corrections for this batch shape (zeros when it
        changes)."""
        if sync["shape"] != tuple(tokens.shape):
            b, s = tokens.shape
            s_eff = s // plan.tp if plan.megatron_sp else s
            sync["state"] = torch.zeros(
                (n_stale, 2, b, s_eff, cfg.d_model), dtype=cfg.torch_dtype,
                device=dev)
            sync["shape"] = tuple(tokens.shape)
        return sync["state"]

    def flat_loss_and_grads(params, tokens, targets):
        # differentiate through aliases: the caller's tensors keep their
        # requires_grad flag, and the update below writes their storage
        alias = tree_map(lambda p: p.detach().requires_grad_(), params)
        with torch.enable_grad():
            with record_function("forward"):
                if n_stale:
                    h, sync["state"] = forward_hidden(
                        alias, tokens, cfg, attn_impl, remat, ctx,
                        stale_state(tokens))
                else:
                    h = forward_hidden(alias, tokens, cfg, attn_impl, remat,
                                       ctx)
            with record_function("loss"):
                loss = _loss_from_h(alias, h, targets, cfg, ctx)
            leaves = tree_leaves(alias)
            with record_function("backward"):
                flat = torch.autograd.grad(loss, leaves)
        grad_of = {id(a): g for a, g in zip(leaves, flat)}
        return loss.detach(), tree_map(lambda a: grad_of[id(a)], alias)

    def step(params, opt_state: AdamWState, tokens, targets
             ) -> Tuple[Dict[str, Any], AdamWState, Dict[str, torch.Tensor]]:
        check_on(params["embed"], dev, "params")
        tokens = torch.as_tensor(tokens, device=dev).long()
        targets = torch.as_tensor(targets, device=dev).long()
        if clock is None:
            loss, grads = flat_loss_and_grads(params, tokens, targets)
        else:
            with record_function("pipeline"):
                loss, grads, step.stats = pipeline.run_schedule(
                    params, tokens, targets, clock=clock, cfg=cfg, ctx=ctx,
                    pp=mesh.axis("pp"), remat=remat, attn_impl=attn_impl,
                    loss_from_h=_loss_from_h)
            loss = loss / clock.M
        with record_function("optimizer"):
            grads = reduce_grads(grads, params)
            for a in metric_axes:
                loss = spmd.psum_raw(loss, a)
            loss = loss / loss_div
            gsq = global_grad_sq(grads) if mesh is not None \
                else grad_sq(grads)
            if zero1:
                params, opt_state, gnorm = zero1_update(
                    params, grads, opt_state, lr, leaf_axes=z1_axes,
                    gsq=gsq,
                    gather_bucket_bytes=(overlap.bucket_bytes
                                         if overlap.enabled else 0),
                    gather_relaxed=rq_gather, gather_vma=vma)
            elif optimizer == "sgd":
                with torch.no_grad():
                    tree_map(lambda p, g: p.copy_(p.float() - lr * g.float()),
                             params, grads)
                opt_state = AdamWState(opt_state.count + 1, opt_state.mu,
                                       opt_state.nu)
                gnorm = torch.sqrt(gsq)
            else:
                params, opt_state, gnorm = adamw_update(
                    params, grads, opt_state, lr, gsq=gsq)
        return params, opt_state, {"loss": loss, "grad_norm": gnorm}

    step.stats = None
    return step


def _relaxed_knobs(parity: ParityConfig, cfg: ModelConfig, plan: MeshPlan,
                   overlap: ov.OverlapConfig):
    """The relaxed tier's quantizers (buckets, ZeRO-1 gather), its tp
    codec and its resolved sync schedule (None: every layer syncs), as
    the reference's step builds them."""
    if not overlap.enabled:
        # degrading to bitwise would label a run relaxed that is not
        raise ValueError(
            "parallel.parity=relaxed requires the overlap pass "
            "(parallel.overlap.enabled=true): every relaxed consumer "
            "rides its bucketed/chunked collectives")
    from hadoop_tpu_torch.parallel.lowp.quant import RelaxedQuant
    from hadoop_tpu_torch.parallel.lowp.syncpolicy import resolve_schedule
    rq = RelaxedQuant(codec=parity.codec, group=parity.group)
    sched = resolve_schedule(parity.relaxed_sync, cfg.n_layers,
                             off_mode=parity.relaxed_sync_mode) \
        if plan.tp > 1 else None
    if sched is not None and all(m == "sync" for m in sched):
        sched = None
    if sched is not None and plan.pp > 1:
        raise ValueError(
            "parallel.lowp.sync.schedule requires a flat layer "
            "stack (pp=1); pipeline plans run per-stage layer "
            "slices the global schedule cannot index")
    return (rq if parity.quant_buckets else None,
            rq if parity.quant_zero1_gather else None,
            parity.codec if parity.quant_tp else None, sched)


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device=None) -> Tuple[Dict[str, Any], AdamWState]:
    """Parameters from ``generator`` (as ``init_params``) and zero AdamW
    state, on ``device`` (default: the GPU)."""
    params = init_params(cfg, generator, device)
    return params, adamw_init(params)


def init_sharded(params, cfg: ModelConfig, plan: MeshPlan, mesh: Mesh,
                 zero1: bool = False, optimizer: str = "adamw"
                 ) -> Tuple[Dict[str, Any], AdamWState]:
    """This rank's shards of a full parameter tree (``init_params`` or
    ``params_from_numpy`` on every rank, from one seed; laid out by
    ``physical_layer_order`` first, as the reference's) and zero AdamW
    state for them (``sharded_opt_state``)."""
    shards = shard_params(physical_layer_order(params, cfg, plan), plan,
                          mesh)
    return shards, sharded_opt_state(shards, cfg, plan, zero1, optimizer)


def shard_as_drawn(cfg: ModelConfig, plan: MeshPlan, mesh: Mesh):
    """``init_params``'s ``keep``: each leaf, as it is drawn, laid out by
    ``physical_layer_order`` and cut to this rank's shard, so a rank
    holds one full leaf at most, never the tree. The shards are
    ``init_sharded``'s of the full tree, bit for bit."""
    specs = param_specs(cfg, plan)
    order = layer_order(cfg.n_layers, plan)

    def keep(path, x):
        spec = specs
        for key in path:
            spec = spec[key]
        if path[0] == "layers" and order is not None:
            x = x[order.to(x.device)]
        return shard_tensor(x, spec, mesh)
    return keep


def sharded_opt_state(shards, cfg: ModelConfig, plan: MeshPlan,
                      zero1: bool = False, optimizer: str = "adamw"
                      ) -> AdamWState:
    """Zero AdamW state for this rank's shards: moments shaped like the
    shards, or this rank's (K,) ZeRO-1 slices with ``zero1``; none for
    ``optimizer="sgd"``, which reads none."""
    if optimizer == "sgd":
        return AdamWState(0, {}, {})
    if not zero1:
        return adamw_init(shards)
    specs = param_specs(cfg, plan)
    sizes = plan.sizes

    def z(p, spec):
        n = 1
        for a in zero1_leaf_plan(spec_axes(spec), plan.batch_axes):
            n *= sizes[a]
        return zero1_init_local(p.shape, n, p.device)
    mu = _map_leaves(z, shards, specs)
    nu = _map_leaves(z, shards, specs)
    return AdamWState(0, mu, nu)
