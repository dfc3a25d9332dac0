"""The port's loss-curve and allclose guards
(``hadoop_tpu_torch/parallel/lowp/guard.py``) against the JAX package's
(``hadoop_tpu/parallel/lowp/guard.py``), on the CPU: the same inputs give
the same report, key for key and bit for bit, or the same
``ParityGuardError`` with the same text. The cases are the reference's
own (tests/test_lowp.py's guard math: close curves, a 2x divergence, a
NaN, a flat curve, a length mismatch, tree arity and shape mismatches)
and the smoothing's head (curves shorter than its window).
"""

import numpy as np
import pytest
import torch

from hadoop_tpu.parallel.lowp import guard as jguard
from hadoop_tpu_torch.parallel.lowp import guard

DOWN = [5.0 - 0.05 * i for i in range(50)]


def _curves():
    rng = np.random.default_rng(7)
    noisy = [x + float(e) for x, e in zip(DOWN, rng.normal(0, 0.3, 50))]
    return {
        "close": (DOWN, [x * 1.02 for x in DOWN], {}),
        "diverged": (DOWN, [x * 2.0 for x in DOWN], {}),
        "nan": (DOWN, DOWN[:-1] + [float("nan")], {}),
        "inf": (DOWN, [float("inf")] + DOWN[1:], {}),
        "flat": (DOWN, DOWN[:1] * 50, {"rel_tol": 10.0}),
        "length": (DOWN, DOWN[:10], {}),
        "empty": ([], [], {}),
        "noisy": (DOWN, noisy, {}),
        "noisy_raw": (DOWN, noisy, {"smooth_window": 1}),
        "three_steps": (DOWN[:3], [x * 1.1 for x in DOWN[:3]], {}),
        "four_rising": ([1.0, 1.1, 1.2, 1.3], [1.0, 1.2, 1.4, 1.6],
                        {"rel_tol": 0.1}),
        "one_step": ([2.0], [2.5], {}),
        "near_zero": ([0.0, 1e-9, 0.0], [1e-7, 0.0, 1e-8],
                      {"abs_floor": 1e-6}),
        "nine_flat": (DOWN[:9], DOWN[:1] * 9, {"rel_tol": 10.0}),
        "ten_flat": (DOWN[:10], DOWN[:1] * 10, {"rel_tol": 10.0}),
    }


@pytest.mark.parametrize("case", sorted(_curves()))
def test_loss_curve_report_is_the_references(case):
    b, r, kw = _curves()[case]
    want = jguard.loss_curve_report(b, r, **kw)
    got = guard.loss_curve_report(b, r, **kw)
    # dict for dict, NaN equal to NaN
    np.testing.assert_equal(got, want)
    if case in ("close", "noisy", "three_steps"):
        assert got["accepted"]
    if case in ("diverged", "nan", "flat", "length", "four_rising",
                "ten_flat"):
        assert not got["accepted"]


@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 6, 11])
@pytest.mark.parametrize("window", [0, 1, 2, 5])
def test_smooth_is_the_references(n, window):
    curve = np.random.default_rng(n).normal(3.0, 1.0, n)
    np.testing.assert_array_equal(guard._smooth(curve.copy(), window),
                                  jguard._smooth(curve.copy(), window))


def _trees():
    rng = np.random.default_rng(3)
    a = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    return {
        "equal": ([1.0, 2.0], [1.0, 2.0 + 1e-7], {}),
        "far": (np.ones(4), np.ones(4) * 1.5, {}),
        "arity": ([np.ones(2)], [np.ones(2), np.ones(2)], {}),
        "shape": ([np.ones(2)], [np.ones(3)], {}),
        "dict": ({"w": a, "b": b}, {"b": b + 1e-6, "w": a * (1 + 1e-6)},
                 {}),
        "dict_far": ({"w": a, "b": b}, {"b": b, "w": a + 0.01}, {}),
        "loose": (a, a + 0.01, {"rtol": 0.5, "atol": 0.02}),
        "nested": ({"x": [a, (b, 2.0)]}, {"x": [a, (b, 2.0)]}, {}),
        "zeros": (np.zeros(3), np.full(3, 1e-7), {}),
    }


def _torch_tree(tree):
    """The same tree with its numpy arrays as tensors: what the port's
    guard is handed."""
    if isinstance(tree, dict):
        return {k: _torch_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_torch_tree(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def _outcome(fn, *args, **kw):
    try:
        return ("report", fn(*args, **kw))
    except AssertionError as e:
        return (type(e).__name__, str(e))


@pytest.mark.parametrize("tensors", [False, True])
@pytest.mark.parametrize("case", sorted(_trees()))
def test_allclose_guard_is_the_references(case, tensors):
    ref, got, kw = _trees()[case]
    want = _outcome(jguard.allclose_guard, case, ref, got, **kw)
    if tensors:
        ref, got = _torch_tree(ref), _torch_tree(got)
    assert _outcome(guard.allclose_guard, case, ref, got, **kw) == want
    if case in ("far", "arity", "shape", "dict_far"):
        assert want[0] == "ParityGuardError"
    else:
        assert want[0] == "report"
