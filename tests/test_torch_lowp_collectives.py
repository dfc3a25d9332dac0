"""The port's quantized collectives and sync-scheduled reduces
(``hadoop_tpu_torch/parallel/lowp``) against the JAX package's, on one
world of four gloo ranks on the CPU (``dist_plans.lowp_collectives``;
the ranks import the port and torch only). Each case gives every rank
the same input in both packages: the JAX package runs the function under
``shard_map`` on four devices of the conftest's virtual mesh (axis "x",
or the (2, 2) grid "a", "b"), the port on its ranks, and the outputs
must agree bit for bit:

- ``psum_quantized``, group and tensor scale, int8 and fp8, on one axis
  and on two (fp8 over two axes takes the int8 wire, as there);
- ``psum_scatter_quantized``, group scale on the ``[Z, K]`` layout (with
  a rest axis too) and tensor scale on dim 1;
- ``psum_of_scatter_quantized``, int8 and fp8;
- the MoE expert payload over an ep axis, both legs;
- ``skip_row_reduce`` and ``stale_row_reduce``, plain and Megatron-SP.

Beside: each backward is the exact collective's transpose, each call's
comm-ledger bytes are the reference's ``capture_comm`` report, site by
site, an int8 sum at the headroom's largest magnitude does not wrap, the
chunked tp matmul's forward is the one reduce's bit for bit, and in the
same world the relaxed step trains every other plan kind the port runs
(the ring and Ulysses with dp and with tp, GPipe with tp and
Megatron-SP, interleaved 1F1B, ZeRO-1 with tp and with pp, MoE over ep
and under tp, gpt2's biases, bf16, fp8 with a stale schedule under
remat) on
the bitwise step's curve, with its dp wire cut.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from hadoop_tpu.models.decoder import ParallelCtx as JCtx
from hadoop_tpu.parallel.lowp import quant as jquant
from hadoop_tpu.parallel.lowp import syncpolicy as jsync
from hadoop_tpu_torch.parallel import spmd
from hadoop_tpu_torch.parallel.lowp import RELAXED_PARITY, ParityConfig
from hadoop_tpu_torch.tools import dist_plans

WORLD = 4
SIZES = {"x": 4, "a": 2, "b": 2}


def _rng(i):
    return np.random.default_rng(100 + i)


def _mixed(rng, shape):
    """Values whose magnitudes differ by orders from group to group."""
    return (rng.normal(size=shape) * 10.0 ** rng.integers(
        -3, 3, size=shape)).astype(np.float32)


def _cases():
    """(id, case) pairs; every case's ``x`` holds all four ranks' inputs
    stacked on dim 0."""
    cases = []
    for codec in ("int8", "fp8"):
        for scale in ("group", "tensor"):
            for axes in ("x", "ab"):
                cases.append((f"psum_{codec}_{scale}_{axes}", dict(
                    op="psum", codec=codec, scale=scale, axes=axes,
                    group=64, x=_mixed(_rng(len(cases)), (4, 5, 77)),
                    ct=_rng(50 + len(cases)).normal(size=(4, 5, 77)).astype(
                        np.float32))))
    cases.append(("scatter_group_x", dict(
        op="scatter", scale="group", axes="x", group=64,
        x=_mixed(_rng(20), (4, 4, 300)),
        ct=_rng(21).normal(size=(4, 300)).astype(np.float32))))
    cases.append(("scatter_group_rest_ab", dict(
        op="scatter", scale="group", axes="ab", group=32, codec="fp8",
        x=_mixed(_rng(22), (4, 2, 100)))))
    cases.append(("scatter_tensor_dim1", dict(
        op="scatter", scale="tensor", axes="x", dim=1,
        x=_rng(23).normal(size=(4, 2, 8, 6)).astype(np.float32),
        ct=_rng(24).normal(size=(4, 2, 2, 6)).astype(np.float32))))
    for codec in ("int8", "fp8"):
        cases.append((f"gather_{codec}", dict(
            op="gather", codec=codec, axes="x", group=64,
            x=_mixed(_rng(30), (4, 150)),
            ct=_rng(31).normal(size=(4, 4, 192)).astype(np.float32))))
    cases.append(("gather_ab", dict(
        op="gather", axes="ab", group=16, x=_mixed(_rng(32), (4, 40)))))
    for leg, shape, ct in (("dispatch", (4, 8, 3, 5), (4, 2, 12, 5)),
                           ("combine", (4, 2, 12, 5), (4, 8, 3, 5))):
        cases.append((f"moe_{leg}", dict(
            op="moe", leg=leg, axes="x", x=_mixed(_rng(40), shape),
            ct=_rng(41).normal(size=ct).astype(np.float32))))
    for sp in (False, True):
        y = _rng(60).normal(size=(4, 2, 8, 6)).astype(np.float32)
        out = (4, 2, 2, 6) if sp else (4, 2, 8, 6)
        cases.append((f"skip_sp{int(sp)}", dict(
            op="skip", megatron_sp=sp, x=y,
            ct=_rng(61).normal(size=out).astype(np.float32))))
        cases.append((f"stale_sp{int(sp)}", dict(
            op="stale", megatron_sp=sp, x=y,
            corr=_rng(62).normal(size=out).astype(np.float32))))
    # the chunked tp matmul on exact reduces against the one reduce: the
    # rank's [B, S, K/4] input against its [K/4, N] rows of the weight
    xs = _rng(70).normal(size=(4, 2, 16, 8)).astype(np.float32)
    ws = _rng(71).normal(size=(4, 8, 24)).astype(np.float32)
    for sp in (False, True):
        ct = _rng(72).normal(size=(4, 2, 4 if sp else 16, 24)).astype(
            np.float32)
        for chunked in (False, True):
            cases.append((f"project_sp{int(sp)}_chunked{int(chunked)}",
                          dict(op="project", megatron_sp=sp, x=xs, w=ws,
                               chunked=chunked, ct=ct)))
    # the headroom's largest magnitude: every element at its group's
    # amax on every rank, so each rank sends +-qmax and the sum holds
    # N * qmax, the most the wire ever carries
    edge = np.tile(np.array([3.7, -3.7, 0.25, -1.0], np.float32), 64)
    for axes in ("x", "ab"):
        cases.append((f"psum_headroom_{axes}", dict(
            op="psum", scale="group", axes=axes, group=64,
            x=np.stack([edge] * 4))))
    return cases


CASES = _cases()
IDS = [c[0] for c in CASES]
STALE_FP8 = ParityConfig(tier="relaxed", codec="fp8",
                         relaxed_sync="periodic:2",
                         relaxed_sync_mode="stale")
# (id, preset, overrides, plan, options): three SGD steps, bitwise and
# relaxed, from one seed
SWEEP = [
    ("dp2_sp2_ring", "tiny", {}, {"dp": 2, "sp": 2}, {}),
    ("dp2_sp2_ulysses", "tiny", {}, {"dp": 2, "sp": 2,
                                     "sp_mode": "ulysses"}, {}),
    ("tp2_sp2_ring", "tiny", {}, {"tp": 2, "sp": 2}, {}),
    ("tp2_sp2_ulysses", "tiny", {"n_heads": 8, "n_kv_heads": 4},
     {"tp": 2, "sp": 2, "sp_mode": "ulysses"}, {}),
    ("pp2_tp2_sp_gpipe", "tiny", {}, {"pp": 2, "tp": 2,
                                      "megatron_sp": True},
     {"n_microbatches": 2, "pipeline_schedule": "gpipe"}),
    ("dp2_pp2_vpp2", "tiny", {}, {"dp": 2, "pp": 2, "vpp": 2},
     {"n_microbatches": 2, "pipeline_schedule": "interleaved"}),
    ("zero1_dp2_tp2", "tiny", {}, {"dp": 2, "tp": 2},
     {"zero1": True, "optimizer": "adamw"}),
    ("zero1_dp2_pp2", "tiny", {}, {"dp": 2, "pp": 2},
     {"zero1": True, "optimizer": "adamw", "n_microbatches": 2}),
    ("moe_dp2_ep2", "tiny-moe", {}, {"dp": 2, "ep": 2}, {}),
    ("moe_ep2_tp2", "tiny-moe", {}, {"ep": 2, "tp": 2}, {}),
    ("gpt2_dp2_tp2_sp", "tiny-gpt2", {}, {"dp": 2, "tp": 2,
                                         "megatron_sp": True}, {}),
    ("bf16_dp2_tp2", "tiny", {"dtype": "bfloat16"}, {"dp": 2, "tp": 2}, {}),
    ("stale_fp8_remat", "tiny", {}, {"dp": 2, "tp": 2,
                                     "megatron_sp": True},
     {"remat": "full", "parity": STALE_FP8}),
]


def _sweep_jobs():
    jobs = []
    for i, (_, preset, over, plan, opts) in enumerate(SWEEP):
        opts = dict(opts)
        relaxed = opts.pop("parity", RELAXED_PARITY)
        tok = _rng(80 + i).integers(0, 256, (8, 32)).astype(np.int64)
        jobs.append({"preset": preset, "overrides": dict(over, max_seq=32),
                     "seed": 0, "device": "cpu", "tokens": tok,
                     "targets": np.roll(tok, -1, axis=1), "sample": None,
                     "plans": [dict({"plan": plan, "steps": 3, "lr": 1e-2,
                                     "parity": parity}, **opts)
                               for parity in (None, relaxed)]})
    return jobs


@pytest.fixture(scope="module")
def world():
    recs = spmd.launch(dist_plans.stages, WORLD, backend="gloo", args=([
        ("lowp_collectives", ([c for _, c in CASES],)),
        ("train_plans", (_sweep_jobs(),))],), timeout=300)
    return {"cases": {cid: [r[0][0][i] for r in recs]
                      for i, cid in enumerate(IDS)},
            "sweep": {sid: recs[0][1][0][2 * i: 2 * i + 2]
                      for i, (sid, *_) in enumerate(SWEEP)}}


@pytest.fixture(scope="module")
def port(world):
    return world["cases"]


def _smap(f, axes, x):
    """``f`` on each device's slice of ``x`` (stacked on dim 0) under
    shard_map over ``axes``; the outputs stacked the same way."""
    devs = np.array(jax.devices()[:WORLD])
    if axes == "x":
        mesh, spec = Mesh(devs, ("x",)), P("x")
    else:
        mesh, spec = Mesh(devs.reshape(2, 2), ("a", "b")), P(("a", "b"))
    fn = jax.shard_map(lambda v: jax.tree_util.tree_map(
        lambda o: o[None], f(v[0])), mesh=mesh, in_specs=(spec,),
        out_specs=spec, check_vma=False)
    return jax.jit(fn)(jnp.asarray(x))


def _reference(case):
    """(outputs stacked by rank, the capture_comm report)."""
    names = tuple(case.get("axes", "x"))
    rq = jquant.RelaxedQuant(codec=case.get("codec", "int8"),
                             group=case.get("group", 1024),
                             mesh_axis_sizes=SIZES)
    op = case["op"]

    def f(v):
        if op == "psum":
            return jquant.psum_quantized(v, names, rq, scale=case["scale"])
        if op == "scatter":
            return jquant.psum_scatter_quantized(
                v, names[-1], rq, rest_axes=names[:-1],
                scatter_dimension=case.get("dim", 0), scale=case["scale"])
        if op == "gather":
            idx = jax.lax.axis_index(names[0])
            for a in names[1:]:
                idx = idx * SIZES[a] + jax.lax.axis_index(a)
            z = int(np.prod([SIZES[a] for a in names]))
            return jquant.psum_of_scatter_quantized(v, z, idx, names, rq)
        if op == "moe":
            split, concat = (0, 1) if case["leg"] == "dispatch" else (1, 0)
            return jquant._expert_payload_quantized(
                v, f"moe.{case['leg']}", "x", split_axis=split,
                concat_axis=concat)
        ctx = JCtx(tp_axis="x", tp_size=4,
                   megatron_sp=case.get("megatron_sp", False))
        if op == "skip":
            return jsync.skip_row_reduce(v, ctx)
        return v

    if op == "stale":
        ctx = JCtx(tp_axis="x", tp_size=4,
                   megatron_sp=case.get("megatron_sp", False))
        x = np.concatenate([case["x"].reshape(4, -1),
                            case["corr"].reshape(4, -1)], axis=1)
        ny = case["x"][0].size

        def g(v):
            y = v[:ny].reshape(case["x"].shape[1:])
            corr = v[ny:].reshape(case["corr"].shape[1:])
            out, new = jsync.stale_row_reduce(y, ctx, corr)
            return jnp.concatenate([out.reshape(-1), new.reshape(-1)])
        with jquant.capture_comm() as led:
            out = _smap(g, "x", x)
        return np.asarray(out), led.report()
    with jquant.capture_comm() as led:
        out = _smap(f, case.get("axes", "x"), case["x"])
    return np.asarray(out), led.report()


def _bits(a):
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("cid", [c for c in IDS
                                 if not c.startswith("project")])
def test_forward_and_ledger_match_reference(port, cid):
    case = dict(CASES)[cid]
    want, want_comm = _reference(case)
    got = np.stack([r["y"] for r in port[cid]])
    assert got.shape == want.shape
    np.testing.assert_array_equal(_bits(got), _bits(want))
    for r in port[cid]:
        assert r["comm"]["per_site"] == want_comm["per_site"]
        assert r["comm"]["payload_bytes"] == want_comm["payload_bytes"]
        assert r["comm"]["reference_bytes"] == want_comm["reference_bytes"]


def _transpose(case):
    """The exact collective's transpose of every rank's cotangent."""
    ct, op = case["ct"], case["op"]
    if op == "psum" or (op == "skip" and not case["megatron_sp"]):
        return ct
    if op == "scatter" and case["scale"] == "tensor":
        full = np.concatenate(list(ct), axis=case["dim"])
        return np.stack([full] * 4)
    if op == "scatter":
        return np.stack([ct] * 4)
    if op == "skip":
        return np.stack([np.concatenate(list(ct), axis=1)] * 4)
    if op == "gather":
        k = case["x"].shape[1]
        return np.stack([ct[r, r, :k] for r in range(4)])
    # moe: the inverse exchange of every rank's cotangent
    if case["leg"] == "dispatch":      # [E/4, 4C, D] -> [E, C, D]
        c = ct.shape[2] // 4
        return np.stack([np.concatenate(
            [ct[src][:, r * c:(r + 1) * c] for src in range(4)], axis=0)
            for r in range(4)])
    e = ct.shape[1] // 4                # [E, C, D] -> [E/4, 4C, D]
    return np.stack([np.concatenate(
        [ct[src][r * e:(r + 1) * e] for src in range(4)], axis=1)
        for r in range(4)])


@pytest.mark.parametrize("cid", [c[0] for c in CASES
                                 if c[1].get("ct") is not None
                                 and c[1]["op"] != "project"])
def test_backward_is_the_exact_collectives_transpose(port, cid):
    case = dict(CASES)[cid]
    got = np.stack([r["grad"] for r in port[cid]])
    np.testing.assert_array_equal(got, _transpose(case))
    assert np.abs(got).max() > 0


@pytest.mark.parametrize("axes", ["x", "ab"])
def test_int8_sum_at_the_headroom_does_not_wrap(port, axes):
    """Every rank at +-amax sends +-127 // 4 = 31 on the int8 wire; the
    sum, 124, fits, and the result is four times the input to the
    codec's resolution, signs kept."""
    case = dict(CASES)[f"psum_headroom_{axes}"]
    got = port[f"psum_headroom_{axes}"][0]["y"]
    edge = case["x"][0]
    np.testing.assert_allclose(got[np.abs(edge) == 3.7], 4 * edge[
        np.abs(edge) == 3.7], rtol=1e-6)
    assert np.all(np.sign(got[edge != 0]) == np.sign(edge[edge != 0]))
    assert port[f"psum_headroom_{axes}"][0]["comm"]["per_site"]["psum"][
        "payload_bytes"] == edge.size + 4 * (edge.size // 64)


@pytest.mark.parametrize("sp", [0, 1])
def test_chunked_matmul_forward_value_exact(port, sp):
    """The relaxed chunked tp matmul (tp_chunks 4, exact reduces) against
    the one reduce: the forward bit for bit (disjoint rows of the same
    products, summed in rank order), the input's gradient within 1e-6
    (the reference's own check of the weight gradient fails at 1e-5 on
    XLA's CPU reassociation, ROADMAP Queue C)."""
    one, chunked = (port[f"project_sp{sp}_chunked{c}"] for c in (0, 1))
    for a, b in zip(one, chunked):
        np.testing.assert_array_equal(_bits(a["y"]), _bits(b["y"]))
        np.testing.assert_allclose(b["grad"], a["grad"], rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize("sid", [s[0] for s in SWEEP])
def test_relaxed_step_trains_every_plan_kind(world, sid):
    """Three SGD steps of the relaxed step against the bitwise step from
    the same weights and data: finite, within 5% a step (the stale
    schedule's first step takes its layers' skip, and its curve lags: it
    is held to learn by the 50-step A-B), learning; on a plan with dp the
    gradient sums' wire is cut to about one byte an element (0.95 of the
    gradients' element size: 3.92× in float32, 1.96× in bf16)."""
    bit, rel = world["sweep"][sid]
    _, _, over, plan, opts = next(s for s in SWEEP if s[0] == sid)
    assert np.isfinite(rel["losses"]).all()
    np.testing.assert_allclose(rel["losses"], bit["losses"], rtol=5e-2)
    if "parity" not in opts:
        assert rel["losses"][-1] < rel["losses"][0]
    if plan.get("dp", 1) > 1:
        wire = [sum(t.get("dp", 0) for t in r["traffic"])
                for r in (bit, rel)]
        size = 2 if over.get("dtype") == "bfloat16" else 4
        assert wire[0] > 0.95 * size * wire[1], wire
