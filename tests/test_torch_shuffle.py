"""The port's device shuffle (``hadoop_tpu_torch/parallel/collectives.py``,
``hadoop_tpu_torch/mapreduce/device_shuffle.py``) against the JAX
package's on the conftest's 8-device CPU mesh.

The same numpy inputs, made from seeds, go through the reference on its
mesh, through the port on a folded axis of 8 (every rank's rows stacked
in this process) and through the port on a gloo group of 8 (one world
for the file, ``dist_plans.shuffle_cases``: each rank passes its cut and
returns its rows). Keys, values, ``valid`` and ``dropped`` are compared
row for row, padded rows included: integer-exact, and values that only
move (float payloads too) bit for bit. A float sum of a group reduce
adds in another order on a card (atomics), so it is held to rtol 1e-5,
atol 1e-5 (float32 sums of a few hundred terms of |x| < 4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from hadoop_tpu.mapreduce import device_shuffle as jshuffle
from hadoop_tpu.parallel import collectives as jcoll
from hadoop_tpu_torch.mapreduce import device_shuffle as shuffle
from hadoop_tpu_torch.parallel import collectives, spmd
from hadoop_tpu_torch.tools import dist_plans

WORLD = 8
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)
FIELDS = ("keys", "values", "valid", "dropped")


def _keys(seed, n, lo=-2**31, hi=2**31 - 1, dtype=np.int32):
    return np.random.default_rng(seed).integers(lo, hi, size=n).astype(dtype)


def _ints(seed, shape, lo=0, hi=100):
    return np.random.default_rng(seed).integers(lo, hi, size=shape).astype(
        np.int32)


def _skewed(seed, n):
    rng = np.random.default_rng(seed)
    return np.where(rng.random(n) < 0.9, 7,
                    rng.integers(0, 1000, size=n)).astype(np.int32)


# (id, fn, keys, values, kw); the reference takes the same kw, with the
# partition a function
N = WORLD * 512
CASES = [
    ("hash_vectors", "device_shuffle", _keys(1, N), _ints(2, (N, 3)),
     {"capacity_factor": 1.0}),
    ("hash_unsorted", "device_shuffle", _keys(3, N), _ints(4, N),
     {"capacity_factor": 3.0, "sort_output": False}),
    ("custom_partition", "device_shuffle", _keys(5, N, -1000, 1000),
     _ints(6, N), {"partition": "mod", "capacity_factor": 2.0}),
    ("float_payload", "device_shuffle", _keys(7, N, 0, 1000),
     np.random.default_rng(8).standard_normal((N, 16)).astype(np.float32),
     {"capacity_factor": 3.0}),
    # tests/test_device_shuffle.py:64: every record to one destination
    ("overflow", "device_shuffle", np.full(WORLD * 64, 42, np.int32),
     np.arange(WORLD * 64, dtype=np.int32), {"capacity_factor": 1.0}),
    # tests/test_device_shuffle.py:150: one record a rank, then 90% skew
    ("tiny_shards", "device_shuffle", np.arange(WORLD, dtype=np.int32),
     np.arange(WORLD, dtype=np.int32) * 10, {"capacity_factor": 8.0}),
    ("skew", "device_shuffle", _skewed(9, WORLD * 256),
     _ints(10, WORLD * 256, 0, 5), {"capacity_factor": 16.0}),
    ("terasort", "device_terasort", _keys(11, WORLD * 1024),
     np.arange(WORLD * 1024, dtype=np.int32), {"capacity_factor": 3.0}),
    ("terasort_payload", "device_terasort", _keys(12, N, 0, 2**30),
     np.random.default_rng(13).integers(0, 256, (N, 12)).astype(np.uint8),
     {"capacity_factor": 2.0}),
    ("reduce_sum", "device_group_reduce", _keys(14, WORLD * 256, 0, 50),
     _ints(15, WORLD * 256, 1, 10), {"op": "sum", "capacity_factor": 16.0}),
    ("reduce_max", "device_group_reduce", _keys(16, WORLD * 256, 0, 50),
     _ints(17, WORLD * 256, -50, 50), {"op": "max",
                                        "capacity_factor": 16.0}),
    ("reduce_min", "device_group_reduce", _keys(18, WORLD * 256, 0, 50),
     _ints(19, (WORLD * 256, 2), -50, 50), {"op": "min",
                                             "capacity_factor": 16.0}),
    ("reduce_float_sum", "device_group_reduce",
     _keys(20, WORLD * 256, 0, 300),
     np.random.default_rng(21).uniform(-4, 4, (WORLD * 256, 2)).astype(
         np.float32), {"op": "sum", "capacity_factor": 4.0}),
    ("split_points", "sample_split_points", _keys(22, N), None,
     {"n_parts": WORLD}),
    ("split_points_few", "sample_split_points", _keys(23, N), None,
     {"n_parts": 5, "n_samples": 64}),
]
IDS = [c[0] for c in CASES]


@pytest.fixture(scope="module")
def mesh():
    devs = np.array(jax.devices()[:WORLD])
    assert devs.size == WORLD, "conftest must force 8 CPU devices"
    return Mesh(devs, ("x",))


def _reference(mesh, fn, keys, values, kw):
    def shard(a):
        return jax.device_put(jnp.asarray(a), NamedSharding(mesh, P("x")))
    kw = dict(kw)
    if kw.get("partition") == "mod":
        kw["partition"] = lambda k: (k % WORLD).astype(jnp.int32)
    if fn == "sample_split_points":
        return np.asarray(jcoll.sample_split_points(mesh, "x", shard(keys),
                                                    **kw))
    res = getattr(jshuffle, fn)(mesh, "x", shard(keys), shard(values), **kw)
    return {f: np.asarray(getattr(res, f)) for f in FIELDS}


def _folded(fn, keys, values, kw):
    axis = spmd.folded("x", WORLD)
    kw = dict(kw)
    if "partition" in kw:
        kw["partition"] = dist_plans.partition_by_name(kw["partition"],
                                                       WORLD)
    if fn == "sample_split_points":
        return collectives.sample_split_points(
            axis, torch.from_numpy(keys), **kw).numpy()
    res = getattr(shuffle, fn)(axis, torch.from_numpy(keys),
                               torch.from_numpy(values), **kw)
    return {f: getattr(res, f).numpy() for f in FIELDS}


@pytest.fixture(scope="module")
def references(mesh):
    return {c[0]: _reference(mesh, *c[1:]) for c in CASES}


@pytest.fixture(scope="module")
def group():
    """Every case on a gloo group of 8: each rank's results, and the
    foreign modules the ranks imported."""
    cases = [{"fn": fn, "keys": k, "values": v, "kw": kw}
             for _, fn, k, v, kw in CASES]
    per_rank = spmd.launch(dist_plans.shuffle_cases, WORLD, backend="gloo",
                           args=(cases,), timeout=300)
    out = {}
    for i, (name, fn, *_rest) in enumerate(CASES):
        ranks = [r[i] for r in per_rank]
        if fn == "sample_split_points":
            assert all(np.array_equal(x, ranks[0]) for x in ranks)
            out[name] = ranks[0]
        else:
            out[name] = {f: np.concatenate([r[f] for r in ranks])
                         for f in FIELDS}
    return out, [r[-1] for r in per_rank]


def _assert_same(name, got, want):
    if not isinstance(want, dict):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        return
    for f in FIELDS:
        a, b = got[f], want[f]
        assert a.shape == b.shape and a.dtype == b.dtype, (
            f, a.shape, b.shape, a.dtype, b.dtype)
        if name == "reduce_float_sum" and f == "values":
            np.testing.assert_allclose(a, b, **FLOAT_TOL, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("kind", ["folded", "group"])
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_shuffle_matches_the_reference_row_for_row(references, group, case,
                                                   kind):
    name, fn, keys, values, kw = case
    got = _folded(fn, keys, values, kw) if kind == "folded" \
        else group[0][name]
    _assert_same(name, got, references[name])


def test_cases_exercise_what_they_name(references):
    """The inputs reach the paths their names claim: overflow drops and
    conserves, the skewed and well-sized cases drop nothing, the sort
    is global, the reduce reports each key once."""
    over = references["overflow"]
    assert over["dropped"].sum() > 0
    assert over["valid"].sum() + over["dropped"].sum() == WORLD * 64
    assert references["hash_vectors"]["dropped"].sum() > 0   # factor 1
    for name in ("hash_unsorted", "float_payload", "tiny_shards", "skew",
                 "terasort", "reduce_sum"):
        assert references[name]["dropped"].sum() == 0, name
    tera = references["terasort"]
    keys = tera["keys"][tera["valid"]]
    np.testing.assert_array_equal(keys, np.sort(CASES[IDS.index(
        "terasort")][2]))
    red = references["reduce_sum"]
    k = red["keys"][red["valid"]]
    assert len(k) == len(set(k.tolist()))


def test_ranks_import_only_the_port(group):
    assert all(mods == [] for mods in group[1])


@pytest.mark.parametrize("dtype", [np.int8, np.int16, np.int32, np.int64,
                                   np.uint8])
@pytest.mark.parametrize("n_parts", [1, 3, 7, 8])
def test_hash_partitioner_bit_for_bit(dtype, n_parts):
    """The uint32 hash carried in int64: negative keys, keys near 2**31
    and the dtype's extremes, as the reference computes them."""
    info = np.iinfo(dtype)
    edge = [info.min, info.min + 1, info.max - 1, info.max, 0, 1] + (
        [-1] if info.min < 0 else [])
    if np.dtype(dtype).itemsize >= 4:
        edge += [2**31 - 1, 2**31 - 2, -2**31, -2**31 + 1]
    if np.dtype(dtype).itemsize == 8:
        edge += [2**31, 2**32 - 1, 2**32, -2**32 - 1, 2**40 + 12345]
    keys = np.concatenate([
        np.array(edge, dtype),
        np.random.default_rng(n_parts).integers(info.min, info.max,
                                                4096, dtype=dtype)])
    with jax.enable_x64(dtype == np.int64):
        want = np.asarray(jcoll.hash_partitioner(n_parts)(jnp.asarray(keys)))
    got = collectives.hash_partitioner(n_parts)(torch.from_numpy(keys))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.bool])
def test_non_integer_keys_raise_type_error(dtype):
    keys = torch.zeros(WORLD * 4, dtype=dtype)
    with pytest.raises(TypeError, match="must be integers"):
        shuffle.device_shuffle(spmd.folded("x", WORLD), keys,
                               torch.zeros(WORLD * 4))
    with pytest.raises(TypeError, match="must be integers"):
        jshuffle.device_shuffle(
            Mesh(np.array(jax.devices()[:WORLD]), ("x",)), "x",
            jnp.zeros(WORLD * 4, jnp.float32), jnp.zeros(WORLD * 4))
