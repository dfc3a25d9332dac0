"""The PyTorch port's device Reed-Solomon coder against the JAX
package's, on the CPU.

The port keeps its own copy of the GF(256) tables and matrices
(``hadoop_tpu_torch/io/erasurecode.py``): they must equal
``hadoop_tpu.io.erasurecode``'s arrays exactly. On CPU tensors the coder
is its kernel's plain version; its parity and its reconstructions must
equal ``RSRawCoder``'s and ``hadoop_tpu.ops.ec_device``'s byte for byte
(integer work: no tolerance), for the system policies' schemas, at odd
cell lengths, and under the erasure patterns of
tests/test_erasure_coding.py.
"""

import numpy as np
import pytest
import torch

from hadoop_tpu.io import erasurecode as jec
from hadoop_tpu.ops import ec_device as jdev
from hadoop_tpu_torch.io import erasurecode as pec
from hadoop_tpu_torch.ops import ec_device as pdev

SCHEMAS = [(3, 2), (6, 3), (10, 4)]
# cell lengths: word-aligned, odd (the reference's 1021), shorter than a
# word, and one word past a power of two
LENGTHS = [4096, 1021, 3, 4097]


def _cells(seed, k, n):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for _ in range(k)]


def _patterns(k, m):
    """Erasure patterns of at most m units: two data and one parity unit
    lost, and data units 0, 2 and 5 lost (tests/test_erasure_coding.py),
    cut to m losses and to the schema's units; and every parity unit
    lost."""
    out = []
    for lost in ((1, 4, k + 2), (0, 2, 5)):
        lost = tuple(u for u in lost if u < k + m)[:m]
        out.append(lost)
    out.append(tuple(range(k, k + m)))
    return out


def test_tables_and_matrices_equal_the_reference():
    for name in ("_EXP", "_LOG", "_MUL"):
        a, b = getattr(pec, name), getattr(jec, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), name
    for k, m in SCHEMAS + [(2, 1), (12, 4)]:
        gen = pec._cauchy_parity_matrix(k, m)
        assert np.array_equal(gen, jec._cauchy_parity_matrix(k, m))
        full = np.vstack([np.eye(k, dtype=np.uint8), gen])
        for lost in _patterns(k, m):
            rows = [u for u in range(k + m) if u not in lost][:k]
            inv = pec._gf_invert(full[rows])
            assert np.array_equal(inv, jec._gf_invert(full[rows]))
            assert np.array_equal(pec._gf_matmul(inv, full[rows]),
                                  np.eye(k, dtype=np.uint8))
        assert np.array_equal(pdev._bit_consts(gen).view(np.uint32),
                              jdev._bit_consts(gen))
    with pytest.raises(ValueError, match="singular"):
        pec._gf_invert(np.zeros((2, 2), np.uint8))


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("k,m", SCHEMAS)
def test_encode_equals_the_host_coder_and_the_reference(k, m, n):
    cells = _cells(k * 1000 + n, k, n)
    got = pdev.encode_cells(k, m, cells, device="cpu")
    assert got == jec.RSRawCoder(k, m).encode(cells)
    assert got == jdev.encode_cells(k, m, cells)
    mat = jec._cauchy_parity_matrix(k, m)
    host = pec._gf_matmul(mat, np.stack([np.frombuffer(c, np.uint8)
                                         for c in cells]))
    assert got == [row.tobytes() for row in host]


@pytest.mark.parametrize("n", [4096, 1021])
@pytest.mark.parametrize("k,m", SCHEMAS)
def test_decode_restores_the_data_under_each_pattern(k, m, n):
    cells = _cells(k * 2000 + n, k, n)
    shards = cells + jec.RSRawCoder(k, m).encode(cells)
    for lost in _patterns(k, m):
        hit = [None if u in lost else s for u, s in enumerate(shards)]
        assert pdev.decode_cells(k, m, hit, device="cpu") == cells, lost
        assert jdev.decode_cells(k, m, hit) == cells, lost
        # the reference's host decode of the same survivors
        assert jec.RSRawCoder(k, m).decode(hit)[:k] == cells, lost


def test_words_api_matches_the_reference_and_caches():
    """The [k, W] word functions on the CPU: the encoder's parity words
    equal the reference's jitted encoder's; each schema and each erasure
    pattern builds one matrix; the plain version counts no launch."""
    k, m, w = 6, 3, 257
    words = np.random.default_rng(3).integers(
        0, 2 ** 32, (k, w), dtype=np.uint64).astype(np.uint32)
    before = pdev.launches
    enc = pdev.device_encoder(k, m)
    got = enc(torch.from_numpy(words.view(np.int32)))
    assert got.dtype == torch.int32 and got.shape == (m, w)
    want = np.asarray(jdev.device_encoder(k, m)(words))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert pdev.device_encoder(k, m) is enc
    fn, rows = pdev.device_decode(k, m, [8, 0, 2, 3, 4, 6, 7])
    assert rows == [0, 2, 3, 4, 6, 7]
    assert pdev.device_decode(k, m, [0, 2, 3, 4, 6, 7, 8])[0] is fn
    full = np.vstack([words, want])
    back = fn(torch.from_numpy(full[rows].view(np.int32)))
    assert np.array_equal(back.numpy().view(np.uint32), words)
    assert pdev.launches == before


def test_refusals():
    """A wrong cell or slot count fails loudly; too few survivors raise;
    the kernel's wrapper refuses CPU tensors (never a CPU launch) and
    shapes it does not take; without CUDA and without device="cpu" the
    entry points raise."""
    cells = _cells(0, 6, 64)
    with pytest.raises(ValueError, match="need 6 data cells"):
        pdev.encode_cells(6, 3, cells[:5], device="cpu")
    with pytest.raises(ValueError, match="equal length"):
        pdev.encode_cells(6, 3, cells[:5] + [b"x"], device="cpu")
    with pytest.raises(ValueError, match="need 9 shard slots"):
        pdev.decode_cells(6, 3, cells, device="cpu")
    with pytest.raises(ValueError, match="need 6 surviving"):
        pdev.device_decode(6, 3, [0, 1, 2, 3, 4])
    tables = torch.from_numpy(pdev.device_encoder(6, 3).tables)
    words = torch.zeros(6, 16, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        pdev._launch_apply(tables, words, 3)
    with pytest.raises(ValueError, match=r"tables \[k, 256, S\]"):
        pdev._launch_apply(tables, words.as_subclass(_LooksCuda), 5)
    with pytest.raises(ValueError, match="words on meta"):
        pdev.device_encoder(6, 3)(words.to("meta"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pdev.encode_cells(6, 3, cells)
        with pytest.raises(RuntimeError, match="CUDA"):
            pdev.decode_cells(6, 3, cells + [None] * 3)


def test_plain_version_is_the_reference_arithmetic_at_word_extremes():
    """Words with every bit pattern of the top lane (negative int32
    values: arithmetic shifts) and every byte value: the plain version's
    int32 ops equal the reference's uint32 ones."""
    k, m = 3, 2
    lanes = np.arange(256, dtype=np.uint32)
    words = np.stack([lanes * 0x01010101, lanes << 24,
                      (255 - lanes) * 0x00010101 + 0x80000000]).astype(
        np.uint32)
    want = np.asarray(jdev.device_encoder(k, m)(words))
    consts = pdev.device_encoder(k, m).consts
    got = pdev.apply_matrix_ref(consts, torch.from_numpy(words.view(np.int32)))
    assert np.array_equal(got.numpy().view(np.uint32), want)


# ------------------------------------------- the kernel's product tables

class _LooksCuda(torch.Tensor):
    """A CPU tensor that reports itself as CUDA, to reach the kernel
    wrapper's checks without a card."""

    @property
    def is_cuda(self):
        return True


def _byte_perm(x, y, sel):
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays: byte n of the
    result is byte ``(sel >> 4n) & 7`` of the eight bytes of (y:x)."""
    src = (y.astype(np.uint64) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(x, dtype=np.uint32)
    for n in range(4):
        pick = (sel >> (4 * n)) & 7
        byte = (src >> np.uint64(8 * pick)) & np.uint64(0xFF)
        out |= byte.astype(np.uint32) << np.uint32(8 * n)
    return out


def _emulate_kernel(tables, words, r):
    """ec_gf256.cu's arithmetic in numpy: for each data unit and byte lane
    p, the byte (``__byte_perm(w, 0, 0x4440 | p)``) looks up its entry,
    whose word g is XORed into the lane accumulator (g, p); then the 4x4
    byte transpose of each group (the kernel's eight ``__byte_perm``)
    gives the output rows. [k, 256, S] uint32 tables × [k, W] uint32 →
    [r, W] uint32."""
    k, w = words.shape
    groups = -(-r // 4)
    acc = np.zeros((groups, 4, w), np.uint32)
    zero = np.zeros(w, np.uint32)
    for j in range(k):
        for p in range(4):
            entry = tables[j][_byte_perm(words[j], zero, 0x4440 | p)]
            for g in range(groups):
                acc[g, p] ^= entry[:, g]
    out = np.zeros((4 * groups, w), np.uint32)
    for g in range(groups):
        a = acc[g]
        t0 = _byte_perm(a[0], a[1], 0x5140)
        t1 = _byte_perm(a[0], a[1], 0x7362)
        t2 = _byte_perm(a[2], a[3], 0x5140)
        t3 = _byte_perm(a[2], a[3], 0x7362)
        out[4 * g:4 * g + 4] = [_byte_perm(t0, t2, 0x5410),
                                _byte_perm(t0, t2, 0x7632),
                                _byte_perm(t1, t3, 0x5410),
                                _byte_perm(t1, t3, 0x7632)]
    return out[:r]


def _table_matrices():
    """(id, [r, k] matrix): the three schemas' encode matrices, the
    decode matrices of each schema's ``_patterns``, and a 16×16 matrix
    (the largest the kernel takes: four row groups)."""
    out = []
    for k, m in SCHEMAS:
        gen = pec._cauchy_parity_matrix(k, m)
        out.append((f"encode-{k}-{m}", gen))
        full = np.vstack([np.eye(k, dtype=np.uint8), gen])
        for lost in _patterns(k, m):
            rows = [u for u in range(k + m) if u not in lost][:k]
            out.append((f"decode-{k}-{m}-{'-'.join(map(str, lost))}",
                        pec._gf_invert(full[rows])))
    out.append(("cauchy-16x16", pec._cauchy_parity_matrix(16, 16)))
    return out


@pytest.mark.parametrize("mat", [m for _, m in _table_matrices()],
                         ids=[i for i, _ in _table_matrices()])
def test_table_lookups_equal_the_reference_bit_for_bit(mat):
    """The product tables as the kernel reads them (its lookups and lane
    transpose, emulated) give the reference's ``_apply_matrix`` and the
    host coder's bytes exactly, on random words and on words at the
    extremes (0, 0xFFFFFFFF, 0x80000000, every byte value in each
    lane)."""
    r, k = mat.shape
    rng = np.random.default_rng(r * 100 + k)
    lanes = np.arange(256, dtype=np.uint32)
    extremes = np.concatenate([
        np.array([0, 0xFFFFFFFF, 0x80000000], np.uint32), lanes * 0x01010101,
        lanes << np.uint32(24), lanes])
    words = np.concatenate([
        rng.integers(0, 2 ** 32, (k, 61), dtype=np.uint64).astype(np.uint32),
        np.stack([np.roll(extremes, 7 * j) for j in range(k)])], axis=1)
    tables = pdev._tables(mat).view(np.uint32)
    assert tables.shape == (k, 256, pdev._entry_words(r))
    got = _emulate_kernel(tables, words, r)
    want = np.asarray(jdev._apply_matrix(jdev._bit_consts(mat), words))
    assert np.array_equal(got, want)
    host = pec._gf_matmul(mat, words.view(np.uint8).reshape(k, -1))
    assert np.array_equal(got.view(np.uint8).reshape(r, -1), host)


def test_tables_hold_the_products_lane_by_lane():
    """Entry [j, b], word g, byte q is gf_mul(M[4g + q, j], b), and 0 past
    the last row; S is 1, 2, 4, 4 words for 1-4, 5-8, 9-12, 13-16 rows; a
    GFMatrix keeps the tables beside the plain version's constants."""
    assert [pdev._entry_words(r) for r in (1, 4, 5, 8, 9, 12, 13, 16)] == \
        [1, 1, 2, 2, 4, 4, 4, 4]
    for r, k in ((3, 6), (10, 10), (5, 9), (16, 16), (1, 1)):
        mat = np.random.default_rng(r + k).integers(0, 256, (r, k),
                                                    dtype=np.uint8)
        tables = pdev._tables(mat).view(np.uint32)
        s = pdev._entry_words(r)
        assert tables.shape == (k, 256, s) and tables.dtype == np.uint32
        lanes = tables.view(np.uint8).reshape(k, 256, s, 4)
        for j in range(k):
            for g in range(s):
                for q in range(4):
                    i = 4 * g + q
                    want = (pec._MUL[mat[i, j]] if i < r
                            else np.zeros(256, np.uint8))
                    assert np.array_equal(lanes[j, :, g, q], want), (j, g, q)
    mat = pec._cauchy_parity_matrix(6, 3)
    fn = pdev.GFMatrix(mat)
    assert fn.rows == 3
    assert np.array_equal(fn.tables, pdev._tables(mat))
    assert np.array_equal(fn.consts, pdev._bit_consts(mat))
