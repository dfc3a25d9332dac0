"""The port's relaxed-tier configuration and codec
(``hadoop_tpu_torch/parallel/lowp``) against the JAX package's, on the
CPU and without a world: ``ParityConfig`` / ``parity_from_conf`` over a
table of confs and their errors, the sync-schedule grammar of
``tests/test_lowp.py`` (malformed specs included), ``guard_rel_tol_for``,
the wire table ``_wire_for``, ``quantize_array`` / ``dequantize_array``
in int8 and fp8 (fp8 compared as bytes, on ties, subnormals and the ±240
edge), the float32 → ``float8_e4m3fn`` cast against ml_dtypes', and the
payload bytes of ``encode_payload`` read both ways.
"""

import dataclasses

import ml_dtypes
import numpy as np
import pytest
import torch

from hadoop_tpu.conf import Configuration as JConfiguration
from hadoop_tpu.parallel import lowp as jlowp
from hadoop_tpu.parallel.lowp import guard as jguard
from hadoop_tpu.parallel.lowp import quant as jquant
from hadoop_tpu.parallel.lowp import syncpolicy as jsync
from hadoop_tpu_torch.conf import Configuration
from hadoop_tpu_torch.parallel import lowp
from hadoop_tpu_torch.parallel.lowp import guard, quant, syncpolicy

CONFS = [
    {},
    {"parallel.parity": "relaxed"},
    {"parallel.parity": "relaxed", "parallel.lowp.codec": "fp8",
     "parallel.lowp.quant.buckets": "false",
     "parallel.lowp.quant.group": "256", "parallel.lowp.guard.steps": "20",
     "parallel.lowp.guard.rel-tol": "0.1"},
    {"parallel.parity": "relaxed", "parallel.lowp.quant.zero1-gather": "no",
     "parallel.lowp.quant.tp": "false", "parallel.lowp.chunk-matmul": "0",
     "parallel.lowp.sync.schedule": "periodic:2+layers:0=stale",
     "parallel.lowp.sync.mode": "stale",
     "parallel.lowp.sync.guard.rel-tol": "3.5"},
    {"parallel.parity": "bitwise", "parallel.lowp.sync.schedule": "none"},
    {"parallel.parity": "fast-and-loose"},
    {"parallel.lowp.codec": "int4"},
    {"parallel.lowp.sync.schedule": "periodic:zero"},
    {"parallel.lowp.sync.mode": "defer"},
]

SPECS = ["full", "none", "periodic:1", "periodic:2", "periodic:3",
         "periodic:2+layers:1=sync,2=stale", "layers:*=skip+layers:0=sync",
         "layers:0=sync+layers:*=skip", "layers:*=sync", " periodic:2 ",
         "layers: 1 = stale , 3=skip", "none+layers:2=sync",
         "", "sometimes", "periodic:", "periodic:x", "periodic:0",
         "layers:", "layers:1", "layers:1=never", "layers:x=skip",
         "layers:-1=skip", "full+none", "periodic:2+periodic:3",
         "layers:9=skip", "layers:4=skip", 7]


def _outcome(fn, *args, **kw):
    """A call's result, or its error's type and text."""
    try:
        return ("ok", fn(*args, **kw))
    except (ValueError, TypeError) as e:
        return (type(e).__name__, str(e))


def _conf(cls, items):
    c = cls(load_defaults=False)
    for k, v in items.items():
        c.set(k, v)
    return c


@pytest.mark.parametrize("items", CONFS)
def test_parity_from_conf_matches_reference(items):
    want = _outcome(jlowp.parity_from_conf, _conf(JConfiguration, items))
    got = _outcome(lowp.parity_from_conf, _conf(Configuration, items))
    assert got[0] == want[0]
    if want[0] == "ok":
        assert dataclasses.asdict(got[1]) == dataclasses.asdict(want[1])
        assert got[1].relaxed == want[1].relaxed
    else:
        assert got[1] == want[1]


def test_parity_defaults_and_constants_match_reference():
    assert lowp.parity_from_conf(None) == lowp.BITWISE_PARITY
    for name in ("PARITY_KEY", "TIERS", "WIRE_CODECS"):
        assert getattr(lowp, name) == getattr(jlowp, name)
    for mine, theirs in ((lowp.BITWISE_PARITY, jlowp.BITWISE_PARITY),
                         (lowp.RELAXED_PARITY, jlowp.RELAXED_PARITY)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    for kw in ({"tier": "x"}, {"codec": "int4"}, {"relaxed_sync": ""},
               {"relaxed_sync_mode": "sync"}):
        assert _outcome(lowp.ParityConfig, **kw) == \
            _outcome(jlowp.ParityConfig, **kw)
    assert _outcome(quant.RelaxedQuant, codec="int4") == \
        _outcome(jquant.RelaxedQuant, codec="int4")


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("mode", ["skip", "stale", "maybe"])
def test_sync_schedule_grammar_matches_reference(spec, mode):
    assert _outcome(syncpolicy.validate_spec, spec, mode) == \
        _outcome(jsync.validate_spec, spec, mode)
    for n in (1, 4, 7):
        assert _outcome(syncpolicy.resolve_schedule, spec, n, mode) == \
            _outcome(jsync.resolve_schedule, spec, n, mode)


@pytest.mark.parametrize("spec", ["full", "periodic:1", "layers:*=sync",
                                  "periodic:2", "none", "layers:3=stale",
                                  "periodic:2+layers:*=sync"])
@pytest.mark.parametrize("tp", [1, 2])
def test_guard_rel_tol_for_matches_reference(spec, tp):
    kw = dict(tier="relaxed", relaxed_sync=spec, guard_rel_tol=0.3,
              sync_guard_rel_tol=1.7)
    assert guard.guard_rel_tol_for(lowp.ParityConfig(**kw), 4, tp=tp) == \
        jguard.guard_rel_tol_for(jlowp.ParityConfig(**kw), 4, tp=tp)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8, 63, 64, 126, 127, 128, 1000,
                               32766, 32767, 32768, 100000])
def test_wire_table_matches_reference(n):
    want = _outcome(jquant._wire_for, n)
    got = _outcome(quant._wire_for, n)
    if want[0] != "ok":
        assert got == want
        return
    assert str(got[1][0]).replace("torch.", "") == np.dtype(want[1][0]).name
    assert got[1][1] == want[1][1]


def _f8_edges() -> np.ndarray:
    """Every e4m3fn value up to 240 (positive and negative), the
    midpoints between neighbours (the ties), points a quarter and three
    quarters of the way, and the subnormal range finely."""
    codes = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn)
    vals = np.unique(codes.astype(np.float32))
    vals = vals[np.isfinite(vals) & (np.abs(vals) <= 240.0)]
    mids = (vals[:-1] + vals[1:]) / 2
    quarter = vals[:-1] + (vals[1:] - vals[:-1]) / 4
    three = vals[:-1] + 3 * (vals[1:] - vals[:-1]) / 4
    sub = np.linspace(-2.0 ** -6, 2.0 ** -6, 4097, dtype=np.float32)
    return np.concatenate([vals, mids, quarter, three, sub]).astype(
        np.float32)


def test_fp8_cast_is_ml_dtypes_cast():
    """torch's float32 -> float8_e4m3fn cast equals ml_dtypes' byte for
    byte on every value the codec can produce (|x| <= 240), ties and
    subnormals included (the CUDA cast is held on the card)."""
    x = _f8_edges()
    want = x.astype(ml_dtypes.float8_e4m3fn).view(np.uint8)
    got = torch.from_numpy(x).to(torch.float8_e4m3fn).view(
        torch.uint8).numpy()
    np.testing.assert_array_equal(got, want)


def _codec_inputs():
    rng = np.random.default_rng(3)
    ties = np.array([2.5, -3.5, 0.5, -0.5, 126.5, 127.0, -127.0, 1.5],
                    np.float32)
    return {
        "normal": rng.normal(size=(7, 333)).astype(np.float32),
        "wide": (rng.normal(size=2049) *
                 10.0 ** rng.integers(-6, 6, size=2049)).astype(np.float32),
        "zeros_group": np.concatenate(
            [np.zeros(64, np.float32), rng.normal(size=100)]).astype(
                np.float32),
        "int8_ties": np.concatenate([ties, np.zeros(56, np.float32)]),
        "f8_edges": _f8_edges(),
        "denormal": np.full(70, 1e-39, np.float32),
    }


@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("case", sorted(_codec_inputs()))
@pytest.mark.parametrize("group", [64, 1024])
def test_quantize_array_is_bit_equal_to_reference(codec, case, group):
    x = _codec_inputs()[case]
    wq, ws = jquant.quantize_array(x, codec=codec, group=group)
    q, s = quant.quantize_array(torch.from_numpy(x), codec=codec,
                                group=group)
    got_q = q.view(torch.uint8).numpy() if codec == "fp8" else q.numpy()
    want_q = wq.view(np.uint8) if codec == "fp8" else wq
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(s.numpy().view(np.uint32),
                                  ws.view(np.uint32))
    back = quant.dequantize_array(q, s, x.shape, torch.float32).numpy()
    want = jquant.dequantize_array(wq, ws, x.shape, np.float32)
    np.testing.assert_array_equal(back.view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_payload_bytes_match_reference_and_read_both_ways(codec, dtype):
    x = np.random.default_rng(0).normal(size=(7, 33)).astype(np.float32)
    if dtype == "bfloat16":
        xj = x.astype(ml_dtypes.bfloat16)
        xt = torch.from_numpy(x).to(torch.bfloat16)
    else:
        xj, xt = x, torch.from_numpy(x)
    blob = quant.encode_payload(xt, codec=codec, group=64)
    assert blob == jquant.encode_payload(xj, codec=codec, group=64)
    assert quant.encode_payload(xj, codec=codec, group=64) == blob
    got, header = quant.decode_payload(blob, codec=codec, shape=(7, 33),
                                       dtype=dtype)
    want, jheader = jquant.decode_payload(blob)
    assert header == jheader and header["dtype"] == dtype
    assert str(got.dtype) == f"torch.{dtype}"
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_payload_header_mismatches_raise_as_the_reference():
    x = np.ones((4, 8), np.float32)
    blob = quant.encode_payload(x, codec="int8")
    for kw in ({"codec": "fp8"}, {"shape": (8, 4)}, {"dtype": "float64"}):
        got = _outcome(quant.decode_payload, blob, **kw)
        want = _outcome(jquant.decode_payload, blob, **kw)
        assert got == want and got[0] == "ValueError"
    for data in (blob[:-3], b"\x00\x01"):
        assert _outcome(quant.decode_payload, data) == \
            _outcome(jquant.decode_payload, data)
    assert _outcome(quant.encode_payload, x, codec="int4") == \
        _outcome(jquant.encode_payload, x, codec="int4")
