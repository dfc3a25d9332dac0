"""The port's CRC32C (``hadoop_tpu_torch/util/crc.py``), native and
pure-Python, against the JAX package's ``util/crc.py``: the same bits
for every length around the 512-byte chunk, with a carried-in crc and
on a ``memoryview`` at an odd offset; ``checksums_for`` byte for byte;
``verify`` raising ``ChecksumError`` at the reference's position and
with its text. Exact comparisons: checksums are bits."""

import contextlib
import struct

import numpy as np
import pytest

from hadoop_tpu.util import crc as jcrc
from hadoop_tpu_torch.util import crc

LENGTHS = [0, 1, 511, 512, 513, (1 << 20) + 7]


def _data(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def _backend(which):
    return crc.python_backend() if which == "python" \
        else contextlib.nullcontext()


def test_native_backend_is_built_and_live():
    crc.build()
    assert crc.target().exists()
    assert crc.native_available()
    with crc.python_backend():
        assert not crc.native_available()
    assert crc.native_available()


@pytest.mark.parametrize("which", ["native", "python"])
@pytest.mark.parametrize("n", LENGTHS)
def test_crc32c_equals_the_reference(which, n):
    data = _data(n, seed=n)
    with _backend(which):
        assert crc.crc32c(data) == jcrc.crc32c(data)
        # carried in: one call over the whole equals two chained calls
        assert crc.crc32c(data, 0x1234ABCD) == \
            jcrc.crc32c(data, 0x1234ABCD)
        half = n // 2
        assert crc.crc32c(data[half:], crc.crc32c(data[:half])) == \
            jcrc.crc32c(data)
        # a memoryview at an odd offset
        view = memoryview(b"\x7f" + data)[1:]
        assert crc.crc32c(view[:n]) == jcrc.crc32c(data)
        if n > 3:
            assert crc.crc32c(memoryview(data)[3:]) == jcrc.crc32c(data[3:])


@pytest.mark.parametrize("which", ["native", "python"])
@pytest.mark.parametrize("bpc", [512, 2048])
@pytest.mark.parametrize("n", LENGTHS)
def test_checksums_for_equals_the_reference(which, bpc, n):
    data = _data(n, seed=n + bpc)
    with _backend(which):
        got = crc.DataChecksum(bpc).checksums_for(data)
        assert got == jcrc.DataChecksum(bpc).checksums_for(data)
        assert crc.DataChecksum(bpc).checksums_for(
            memoryview(b"\0" + data)[1:]) == got
        crc.DataChecksum(bpc).verify(data, got)


@pytest.mark.parametrize("which", ["native", "python"])
@pytest.mark.parametrize("n,flip", [(513, 512), (5 * 512 + 100, 2 * 512 + 7),
                                    ((1 << 20) + 7, 1 << 19)])
def test_verify_raises_at_the_references_position(which, n, flip):
    """One flipped byte in a middle chunk: the same ``pos`` and the same
    message as the reference's, at a stream base offset."""
    data = _data(n, seed=3)
    sums = jcrc.DataChecksum().checksums_for(data)
    bad = bytearray(data)
    bad[flip] ^= 0x40
    with pytest.raises(jcrc.ChecksumError) as want:
        jcrc.DataChecksum().verify(bytes(bad), sums, base_pos=4096)
    with _backend(which), pytest.raises(crc.ChecksumError) as got:
        crc.DataChecksum().verify(bytes(bad), sums, base_pos=4096)
    assert got.value.pos == want.value.pos == 4096 + flip // 512 * 512
    assert str(got.value) == str(want.value)
    # too few sums is an error of its own
    with _backend(which), pytest.raises(crc.ChecksumError, match="need"):
        crc.DataChecksum().verify(data, sums[:-4])


def test_header_round_trips_as_the_references():
    for bpc in (512, 2048, 1 << 20):
        hdr = crc.DataChecksum(bpc).header()
        assert hdr == jcrc.DataChecksum(bpc).header()
        assert len(hdr) == crc.DataChecksum.HEADER_LEN == \
            jcrc.DataChecksum.HEADER_LEN
        back = crc.DataChecksum.from_header(hdr)
        assert (back.bytes_per_chunk, back.type) == (bpc, 2)
    null = crc.DataChecksum(512, crc.DataChecksum.TYPE_NULL)
    assert null.checksums_for(b"abc") == b"" and null.checksum_size == 0
    null.verify(b"abc", b"")
    assert struct.unpack(">BI", crc.DataChecksum().header()) == (2, 512)
    with pytest.raises(ValueError):
        crc.DataChecksum(0)
