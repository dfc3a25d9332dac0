"""The port's SPMD collectives (``hadoop_tpu_torch/parallel/spmd.py``)
over gloo on the CPU.

One world of four ranks, started by ``spmd.launch`` (``spawn``: the
ranks import the port and torch, never JAX), runs the collectives drill
of ``hadoop_tpu_torch/tools/dist_plans.py``. Each collective's forward
and gradient (of sum(w_r * y_r) over the ranks) is held against the
same function computed in this one process on the stacked inputs by
torch autograd; the folded axis (ranks stacked on one device) against
the process group bit for bit; the bucketed forms against their
per-leaf forms bit for bit; the row-parallel reduce against its sum.
Tolerance 1e-6: float32, sums of four terms.
"""

import numpy as np
import pytest
import torch

from hadoop_tpu_torch.parallel import spmd
from hadoop_tpu_torch.tools import dist_plans

WORLD, SEED = 4, 3
TOL = 1e-6


@pytest.fixture(scope="module")
def drill():
    return spmd.launch(dist_plans.collectives, WORLD, backend="gloo",
                       args=(SEED,), timeout=300)


def _stacked():
    return torch.from_numpy(dist_plans.drill_inputs(SEED, WORLD))


def _one_process(name, xs):
    """Every rank's output of the collective ``name``, computed from the
    stacked inputs xs [P, ...] in one process."""
    p = xs.shape[0]
    if name == "psum":
        return torch.stack([xs.sum(0)] * p)
    if name == "all_gather":
        return torch.stack([torch.cat(list(xs), dim=1)] * p)
    if name == "psum_scatter":
        return torch.stack(xs.sum(0).chunk(p, dim=2))
    if name == "all_to_all":
        return torch.stack([torch.cat([x.chunk(p, dim=2)[r] for x in xs],
                                      dim=1) for r in range(p)])
    shift = 1 if name == "ppermute" else -1
    return torch.roll(xs, shift, dims=0)


@pytest.mark.parametrize("name", ["psum", "all_gather", "psum_scatter",
                                  "all_to_all", "ppermute", "ppermute_back"])
def test_collective_forward_and_gradient_match_one_process(drill, name):
    """Forward, and the gradient of sum_r sum(w_r * y_r): the transposes
    (psum under copy_to, psum_scatter, all_gather, the inverse exchange,
    the permutation back) against torch autograd in one process."""
    xs = _stacked().requires_grad_()
    ws = torch.from_numpy(drill[0][name][2])
    want = _one_process(name, xs)
    (dxs,) = torch.autograd.grad((want * ws).sum(), xs)
    for r in range(WORLD):
        y, dx, _ = drill[r][name]
        np.testing.assert_allclose(y, want[r].detach().numpy(), atol=TOL,
                                   rtol=TOL)
        np.testing.assert_allclose(dx, dxs[r].numpy(), atol=TOL, rtol=TOL)


def test_hop_is_a_partial_permutation_each_way(drill):
    """``hop_raw``'s one tick: each rank gets 2x its predecessor's value
    (tag 0) and 3x its successor's (tag 1), bit for bit; the first rank
    has no predecessor and the last no successor, so each gets one."""
    xs = _stacked().numpy()
    for r in range(WORLD):
        want = ([xs[r - 1] * 2] if r > 0 else []) + \
            ([xs[r + 1] * 3] if r < WORLD - 1 else [])
        got = drill[r]["hop"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def test_psum_adds_in_rank_order_and_backward_is_identity(drill):
    """psum's bits are the rank-order float32 sum on every rank; its
    gradient passes through unsummed (the result counts once), while
    copy_to's gradient is the sum over the ranks."""
    xs = _stacked()
    ordered = xs[0] + xs[1] + xs[2] + xs[3]
    for r in range(WORLD):
        y, dx = drill[r]["psum_alone"]
        assert np.array_equal(y, ordered.numpy())
        np.testing.assert_array_equal(dx, (xs[r] + 1).numpy())
        y, dx = drill[r]["copy_to_alone"]
        np.testing.assert_array_equal(y, xs[r].numpy())
        np.testing.assert_allclose(dx, (xs + 1).sum(0).numpy(), atol=TOL,
                                   rtol=TOL)


def test_pmax_and_axis_index(drill):
    xs = _stacked()
    for r in range(WORLD):
        np.testing.assert_array_equal(drill[r]["pmax"], xs.amax(0).numpy())
        assert drill[r]["axis_index"] == r


@pytest.mark.parametrize("name", ["all_to_all", "ppermute"])
def test_folded_axis_matches_the_group_bit_for_bit(drill, name):
    """The permutations on the ranks stacked in one tensor give the
    group's outputs and gradients, rank r on rows r*B..(r+1)*B-1."""
    y, dx = drill[0]["folded_" + name]
    b = dist_plans.SHAPE[0]
    for r in range(WORLD):
        gy, gdx, _ = drill[r][name]
        assert np.array_equal(y[r * b:(r + 1) * b], gy)
        assert np.array_equal(dx[r * b:(r + 1) * b], gdx)


@pytest.mark.parametrize("name", ["bucketed", "bucketed_one", "scatter",
                                  "gather"])
def test_bucketed_forms_give_the_per_leaf_bits(drill, name):
    """Buckets of 64 bytes (one leaf each, or several) and of 1 MiB (all
    leaves in one) sum to the per-leaf psum's bits; the reduce-scatter
    gives this rank's slice of it; the gathered slices give it back."""
    for r in range(WORLD):
        assert all(drill[r][name]), (r, drill[r][name])


def test_psum_in_pieces_gives_the_whole_bits(drill):
    assert all(d["psum_pieces"] for d in drill)


@pytest.mark.parametrize("megatron_sp", [0, 1])
def test_row_parallel_reduce_matches_one_process(drill, megatron_sp):
    """``reduce_row_parallel``: the rank-order sum over tp with the
    identity backward (Megatron's "g"), or under Megatron-SP rank r's
    sequence piece of the sum with the all_gather backward."""
    ys = torch.from_numpy(np.stack([d[f"row_reduce_sp{megatron_sp}"][0]
                                    for d in drill])).requires_grad_()
    ws = torch.from_numpy(drill[0][f"row_reduce_sp{megatron_sp}"][3])
    ordered = ys[0] + ys[1] + ys[2] + ys[3]
    if megatron_sp:
        want = torch.stack(ordered.chunk(WORLD, dim=1))
        (dys,) = torch.autograd.grad((want * ws).sum(), ys)
    else:
        want, dys = torch.stack([ordered] * WORLD), ws
    for r in range(WORLD):
        _, y, dy, _ = drill[r][f"row_reduce_sp{megatron_sp}"]
        assert np.array_equal(y, want[r].detach().numpy())
        np.testing.assert_allclose(dy, dys[r].numpy(), atol=TOL, rtol=TOL)


def test_traffic_counts_the_bytes_handed_to_the_wire(drill):
    assert all(d["traffic"]["x"] > 0 for d in drill)


def test_spawned_ranks_import_no_jax_and_no_jax_package(drill):
    assert all(d["foreign_modules"] == [] for d in drill)


def test_folded_axis_has_only_the_permutations():
    """A folded axis has the permutations and the raw all_gather (every
    rank's value is already in the stack: the gathered value once a
    rank, stacked), and refuses the sums and axis_index."""
    axis = spmd.folded("sp", 2)
    x = torch.arange(64.0).reshape(4, 2, 4, 2)
    ranks = x.reshape(2, 2, 2, 4, 2)
    one = torch.cat([ranks[0], ranks[1]], dim=1)
    assert torch.equal(spmd.all_gather_raw(x, axis, 1),
                       torch.cat([one, one]))
    for fn in (lambda: spmd.psum_raw(x, axis),
               lambda: spmd.psum_scatter_raw(x, axis, 1),
               lambda: spmd.axis_index(axis)):
        with pytest.raises(ValueError, match="folded"):
            fn()
    with pytest.raises(ValueError):
        spmd.all_to_all_raw(x, axis, 0, 2)       # dim 0 is each rank's batch
    assert spmd.local_ranks(axis, "cpu").tolist() == [0, 1]
    assert spmd.local_ranks(None, "cpu").tolist() == [0]
    # a size-1 axis and no axis are the identity
    one = spmd.folded("sp", 1)
    assert spmd.all_to_all(x, one, 2, 1) is x and spmd.psum(x, None) is x


def test_launch_reports_a_failing_rank():
    """A rank that raises fails the launch with its traceback."""
    job = {"preset": "tiny", "seed": 0, "device": "cpu",
           "tokens": np.zeros((4, 8), np.int64),
           "targets": np.zeros((4, 8), np.int64),
           "plans": [{"plan": {"dp": 4}}]}
    with pytest.raises(RuntimeError, match="needs 4 ranks"):
        spmd.launch(dist_plans.train_plans, 2, backend="gloo", args=([job],),
                    timeout=120)


def test_launch_takes_the_backend_from_its_caller():
    with pytest.raises(TypeError, match="backend"):
        spmd.launch(dist_plans.collectives, WORLD, args=(SEED,))


def test_plan_runner_runs_on_the_card_unless_asked_for_the_cpu(
        monkeypatch):
    """A job that names no device trains on the card: with none, it
    raises before it builds anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    job = {"preset": "tiny", "seed": 0,
           "tokens": np.zeros((4, 8), np.int64),
           "targets": np.zeros((4, 8), np.int64),
           "plans": [{"plan": {"dp": 4}}]}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist_plans.train_plans(0, 1, [job])
