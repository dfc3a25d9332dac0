"""Reshard-on-restore: one checkpoint serves any dp×tp plan.

The counterpart of ``hadoop_tpu/parallel/elastic/reshard.py``, on numpy
arrays as there. Checkpoints store parameters (and the moments of a
plan without ZeRO-1) at their global logical shapes, so those restore
into any plan by cutting. The plan-locked leaves are the ZeRO-1
moments: a state leaf is a ``(*spec axis sizes, *data axis sizes, K)``
array whose shape bakes in the plan that wrote it (the slice layout of
``parallel/overlap.py``). This module converts them through the global
param-shaped moment array:

    plan-A state ──(slice layout A)──▶ global moments
                 ──(slice layout B)──▶ plan-B state

The conversion is exact on the real region; the padding tail is zero
(gradients are zero-padded, so moments never leave zero there). Plain
AdamW moments are global moment arrays, so the same two maps convert
ZeRO-1 ⇄ plain restores. A change of the pipeline stage count is
refused (``check_reshardable``).

A port rank holds one ``(K,)`` row of a state leaf: the row at its
coordinates on the spec axes, then on the data axes
(``parallel/train.py`` ``zero1_layout``), which is its index into the
global layout here.

Specs are tuples with one entry per dim: an axis name, a tuple of axis
names, or None (the reference's ``PartitionSpec``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np

from hadoop_tpu_torch.parallel.mesh import AXES, MeshPlan

# manifest["meta"]["format"] of plan-bearing checkpoints; readers refuse
# formats they do not know
MANIFEST_FORMAT = "htpu-ckpt-plan-1"


# ------------------------------------------------------------- manifest

def manifest_meta(plan: MeshPlan, *, zero1: bool) -> Dict[str, Any]:
    """The plan-describing manifest block a checkpoint writer embeds."""
    return {"format": MANIFEST_FORMAT,
            "zero1": bool(zero1),
            "plan": dataclasses.asdict(plan)}


def plan_from_meta(meta: Dict[str, Any]) -> MeshPlan:
    if meta.get("format") != MANIFEST_FORMAT:
        raise ValueError(
            f"unknown checkpoint meta format {meta.get('format')!r} "
            f"(this reader understands {MANIFEST_FORMAT!r})")
    return MeshPlan(**meta["plan"])


def resolve_restore(manifest: Dict[str, Any], plan: MeshPlan,
                    zero1: bool) -> Tuple[str, Optional[MeshPlan], bool]:
    """Classify a restore against the manifest's plan block, as the
    reference does: ``(mode, saved_plan, saved_zero1)`` with mode

    - ``"same-plan"``: saved and target plans match exactly (the direct,
      bit-identical path);
    - ``"reshard"``: the plans differ (host-side relayout);
    - ``"legacy"``: the manifest has no plan block; restored as
      same-plan, with a DeprecationWarning.
    """
    meta = manifest.get("meta")
    if not meta or "plan" not in meta:
        warnings.warn(
            "checkpoint manifest has no plan block (written before the "
            "elastic plane); restoring as same-plan — re-save to make "
            "this checkpoint reshardable", DeprecationWarning,
            stacklevel=2)
        return "legacy", None, zero1
    saved_plan = plan_from_meta(meta)
    saved_zero1 = bool(meta.get("zero1", False))
    if saved_plan == plan and saved_zero1 == zero1:
        return "same-plan", saved_plan, saved_zero1
    check_reshardable(saved_plan, plan)
    return "reshard", saved_plan, saved_zero1


def check_reshardable(plan_a: MeshPlan, plan_b: MeshPlan) -> None:
    """Refuse plan changes a restore cannot express (the reference's
    rule: the pipeline stage count may not change)."""
    if plan_a.pp != plan_b.pp or plan_a.vpp != plan_b.vpp:
        raise ValueError(
            "reshard-on-restore cannot change the pipeline stage count: "
            f"checkpoint written under pp={plan_a.pp} vpp={plan_a.vpp}, "
            f"target plan has pp={plan_b.pp} vpp={plan_b.vpp}. A pp "
            "resize re-stacks which layers share a stage, so no host "
            "relayout preserves the optimizer trajectory — restore under "
            "the saved pp, re-save, then change plans.")


# ---------------------------------------------------- slice-layout math

def _plan_sizes(plan: MeshPlan) -> Dict[str, int]:
    return dict(zip(AXES, (plan.dp, plan.pp, plan.tp, plan.ep, plan.sp)))


def _sharded_dims(spec):
    """``[(dim, [axes...]), ...]`` for a spec's sharded dims, in order of
    appearance: the order of a ZeRO-1 state leaf's leading dims."""
    out = []
    for d, part in enumerate(spec):
        if part is None:
            continue
        axes = list(part) if isinstance(part, tuple) else [part]
        out.append((d, axes))
    return out


def _block_slices(coords, sharded, shape, sizes):
    """Global-array slices selecting the shard at spec coords
    (``coords`` ordered like the state leaf's leading dims)."""
    sl = [slice(None)] * len(shape)
    it = iter(coords)
    for d, axes in sharded:
        idx, n = 0, 1
        for a in axes:
            idx = idx * sizes[a] + next(it)
            n *= sizes[a]
        bl = shape[d] // n
        sl[d] = slice(idx * bl, (idx + 1) * bl)
    return tuple(sl)


def _leaf_geometry(spec, shape, plan: MeshPlan):
    """(sharded dims, axis sizes, spec axis sizes, z axis sizes, Z, K,
    local size) of one leaf under one plan: the host-side mirror of
    ``train.zero1_layout``."""
    sizes = _plan_sizes(plan)
    sharded = _sharded_dims(spec)
    spec_ax = [a for _, axes in sharded for a in axes]
    for d, axes in sharded:
        n = int(np.prod([sizes[a] for a in axes]))
        if shape[d] % n:
            raise ValueError(
                f"leaf dim {d} of shape {shape} not divisible by its "
                f"mesh axes {axes} (sizes {sizes})")
    spec_sizes = tuple(sizes[a] for a in spec_ax)
    z_ax = tuple(a for a in plan.batch_axes if a not in spec_ax)
    z_sizes = tuple(sizes[a] for a in z_ax)
    z = int(np.prod(z_sizes)) if z_sizes else 1
    denom = int(np.prod(spec_sizes)) if spec_sizes else 1
    local = max(1, int(np.prod(shape)) // denom) if shape else 1
    k = (local + z - 1) // z
    return sharded, sizes, spec_sizes, z_sizes, z, k, local


def zero1_state_shape(spec, global_shape, plan: MeshPlan
                      ) -> Tuple[int, ...]:
    """The shape of one ZeRO-1 moment leaf in ``plan``'s layout:
    ``(*spec axis sizes, *data axis sizes, K)``."""
    _, _, spec_sizes, z_sizes, _, k, _ = _leaf_geometry(
        spec, tuple(global_shape), plan)
    return spec_sizes + z_sizes + (k,)


def zero1_state_to_global(state, spec, global_shape,
                          plan: MeshPlan) -> np.ndarray:
    """One ZeRO-1 moment leaf (plan layout) → the global param-shaped
    float32 moment array. Exact: every slice segment is written back at
    the flattened offset its mixed-radix rank index assigned it."""
    state = np.asarray(state)
    global_shape = tuple(global_shape)
    sharded, sizes, spec_sizes, z_sizes, z, k, local = \
        _leaf_geometry(spec, global_shape, plan)
    want = zero1_state_shape(spec, global_shape, plan)
    if tuple(state.shape) != want:
        raise ValueError(
            f"zero1 state leaf shape {tuple(state.shape)} does not "
            f"match plan layout {want} (global {global_shape})")
    out = np.empty(global_shape, np.float32)
    for coords in np.ndindex(*spec_sizes):
        sl = _block_slices(coords, sharded, global_shape, sizes)
        block_shape = out[sl].shape
        # the (z..., K) segments concatenate, row-major over the data
        # axes, into the zero-padded flattened shard: drop the pad tail
        flat = state[coords].reshape(-1)[:local].astype(np.float32)
        out[sl] = flat.reshape(block_shape)
    return out


def global_to_zero1_state(garr, spec, plan: MeshPlan) -> np.ndarray:
    """The global param-shaped moment array → one ZeRO-1 moment leaf in
    ``plan``'s layout (the inverse of ``zero1_state_to_global``; the
    padding tail is zero, as training leaves it)."""
    garr = np.asarray(garr, np.float32)
    sharded, sizes, spec_sizes, z_sizes, z, k, local = \
        _leaf_geometry(spec, garr.shape, plan)
    out = np.zeros(spec_sizes + z_sizes + (k,), np.float32)
    for coords in np.ndindex(*spec_sizes):
        sl = _block_slices(coords, sharded, garr.shape, sizes)
        flat = garr[sl].reshape(-1)
        pad = z * k - flat.size
        if pad:
            flat = np.pad(flat, (0, pad))
        out[coords] = flat.reshape(z_sizes + (k,))
    return out


def reshard_zero1_leaf(state, spec, global_shape, plan_a: MeshPlan,
                       plan_b: MeshPlan) -> np.ndarray:
    """Plan-A moment leaf → plan-B moment leaf, through global layout."""
    return global_to_zero1_state(
        zero1_state_to_global(state, spec, global_shape, plan_a),
        spec, plan_b)


# --------------------------------------------------------- whole trees

def _tree_map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def convert_moment(m, gshape, spec, plan_a: MeshPlan, plan_b: MeshPlan, *,
                   zero1_a: bool, zero1_b: bool) -> np.ndarray:
    """One moment leaf from plan A's layout to plan B's (a leaf of
    ``reshard_opt_state``)."""
    gshape = tuple(gshape)
    if zero1_a:
        g = zero1_state_to_global(m, spec, gshape, plan_a)
    else:
        g = np.asarray(m, np.float32)
        if g.shape != gshape:
            raise ValueError(f"moment shape {g.shape} != param "
                             f"shape {gshape}")
    if zero1_b:
        return global_to_zero1_state(g, spec, plan_b)
    return g


def reshard_opt_state(opt, params_shapes, specs, plan_a: MeshPlan,
                      plan_b: MeshPlan, *, zero1_a: bool, zero1_b: bool):
    """Convert a host ``AdamWState`` between plan layouts.

    ``opt``: the loaded host optimizer state (mu/nu trees in plan A's
    layout); ``params_shapes``: a matching tree of GLOBAL parameter
    shapes (tuples or arrays: only ``np.shape`` is read); ``specs``:
    the ``mesh.param_specs`` tree. The same plan AND the same ZeRO-1
    flag return ``opt`` untouched: the bit-identical path."""
    check_reshardable(plan_a, plan_b)
    if plan_a == plan_b and zero1_a == zero1_b:
        return opt

    def leaf(m, shape_like, spec):
        gshape = shape_like if isinstance(shape_like, tuple) \
            else np.shape(shape_like)
        return convert_moment(m, gshape, spec, plan_a, plan_b,
                              zero1_a=zero1_a, zero1_b=zero1_b)

    mu = _tree_map(leaf, opt.mu, params_shapes, specs)
    nu = _tree_map(leaf, opt.nu, params_shapes, specs)
    return type(opt)(np.asarray(opt.count), mu, nu)
