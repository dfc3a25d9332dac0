"""The port's wirepack codec against the JAX package's, byte for byte.

The port's RPC client speaks to the reference's daemons, so what its
``pack`` writes must be the reference's bytes, and each package's
``unpack`` must read what the other wrote (the reference's C codec,
where it is built, and its Python codec alike).
"""

import io
import math

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from hadoop_tpu.io import wire as jwire
from hadoop_tpu_torch.io import wire

_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-(2 ** 100), max_value=2 ** 100)
            | st.floats(allow_nan=False) | st.text(max_size=80)
            | st.binary(max_size=80))
_values = st.recursive(
    _scalars,
    lambda inner: st.lists(inner, max_size=20)
    | st.dictionaries(st.text(max_size=20), inner, max_size=20),
    max_leaves=60)


@settings(max_examples=300, deadline=None)
@given(_values)
def test_pack_gives_the_reference_bytes_and_both_read_both(value):
    got = wire.pack(value)
    assert got == jwire.pack(value)
    assert got == jwire.Encoder().encode(value).getvalue()
    assert wire.unpack(jwire.pack(value)) == value
    assert jwire.unpack(got) == value


@pytest.mark.parametrize("value", [
    0, 127, 128, -1, -32, -33, 2 ** 63 - 1, 2 ** 64, -(2 ** 70), "x" * 31,
    "x" * 32, list(range(15)), list(range(16)),
    {f"k{i}": i for i in range(15)}, {f"k{i}": i for i in range(16)},
    float("inf"), -0.0, "日本語"])
def test_boundary_tags_equal_the_reference(value):
    assert wire.pack(value) == jwire.pack(value)
    back = wire.unpack(wire.pack(value))
    assert back == value and (not isinstance(value, float)
                              or math.copysign(1, back)
                              == math.copysign(1, value))


def test_offsets_frames_and_errors_match():
    a, b = wire.pack([1, "two"]), wire.pack({"three": b"3"})
    assert wire.unpack_with_offset(a + b, 0) == \
        jwire.unpack_with_offset(a + b, 0)
    assert wire.unpack_with_offset(a + b, len(a)) == ({"three": b"3"},
                                                      len(a + b))
    buf = io.BytesIO()
    wire.write_frame(buf, a)
    jwire.write_frame(buf, b)
    buf.seek(0)
    assert jwire.read_frame(buf) == a and wire.read_frame(buf) == b
    with pytest.raises(wire.WireError):
        wire.pack({1: "x"})
    with pytest.raises(wire.WireError):
        wire.unpack(a[:-1])
    buf = io.BytesIO()
    wire.write_frame(buf, b"x" * 10)
    buf.seek(0)
    with pytest.raises(wire.WireError, match="exceeds limit"):
        wire.read_frame(buf, max_frame=4)


def test_objects_with_to_wire_encode_as_their_dict():
    from hadoop_tpu_torch.registry import ServiceRecord
    rec = ServiceRecord("/a", {"http": "h:1"}, {"k": "v"})
    assert wire.pack(rec) == jwire.pack(rec.to_wire())
