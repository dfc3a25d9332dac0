"""Erasure coding on the host: GF(256) tables, the Cauchy generator,
matrix inversion, the numpy coder, the raw RS and XOR coders, the EC
policies and the striped block-id scheme.

The port's own copy of ``hadoop_tpu/io/erasurecode.py``: what
``ops/ec_device.py`` needs (``_build_tables``, ``_cauchy_parity_matrix``,
``_gf_invert``, ``_gf_matmul``) and what the DFS client's striped
streams need (``RSRawCoder``, ``XORRawCoder``, ``ECPolicy``,
``get_policy``, ``is_striped_id``, ``group_id_of``, ``unit_index_of``,
``unit_length``, ``pad_stripe_cells``), so the port imports nothing of
the JAX package. The same polynomial (0x11D) and the same Cauchy
matrix, so parity written by either package, or by the reference's
native coder, decodes with the other. The coders here are numpy only:
the striped client codes on the host, as the reference's does.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

_POLY = 0x11D


def _build_tables():
    exp = np.zeros(512, np.uint8)
    logt = np.zeros(256, np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        logt[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _POLY
    exp[255:510] = exp[:255]
    mul = np.zeros((256, 256), np.uint8)
    a = np.arange(256)
    for c in range(1, 256):
        mul[c, 1:] = exp[(logt[c] + logt[a[1:]]) % 255]
    return exp, logt, mul


_EXP, _LOG, _MUL = _build_tables()


def _gf_inv(a: int) -> int:
    return int(_EXP[255 - _LOG[a]])


def _cauchy_parity_matrix(k: int, m: int) -> np.ndarray:
    """m×k parity generator; any k rows of [I; C] are invertible."""
    mat = np.zeros((m, k), np.uint8)
    for i in range(m):
        for j in range(k):
            mat[i, j] = _gf_inv((k + i) ^ j)
    return mat


def _gf_matmul(mat: np.ndarray, cells: np.ndarray) -> np.ndarray:
    """(r×k GF matrix) × (k×n byte matrix) → r×n: the numpy host coder."""
    out = np.zeros((mat.shape[0], cells.shape[1]), np.uint8)
    for i in range(mat.shape[0]):
        row = np.zeros(cells.shape[1], np.uint8)
        for j in range(mat.shape[1]):
            c = int(mat[i, j])
            if c == 0:
                continue
            if c == 1:
                row ^= cells[j]
            else:
                row ^= _MUL[c][cells[j]]
        out[i] = row
    return out


def _gf_invert(a: np.ndarray) -> np.ndarray:
    """Invert an n×n GF(256) matrix (Gauss-Jordan)."""
    n = a.shape[0]
    work = a.astype(np.uint8).copy()
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        piv = next((r for r in range(col, n) if work[r, col]), None)
        if piv is None:
            raise ValueError("singular matrix")
        if piv != col:
            work[[piv, col]] = work[[col, piv]]
            inv[[piv, col]] = inv[[col, piv]]
        d = _gf_inv(int(work[col, col]))
        if d != 1:
            work[col] = _MUL[d][work[col]]
            inv[col] = _MUL[d][inv[col]]
        for r in range(n):
            if r == col or not work[r, col]:
                continue
            f = int(work[r, col])
            work[r] ^= _MUL[f][work[col]]
            inv[r] ^= _MUL[f][inv[col]]
    return inv


# ---------------------------------------------------------------- raw coders

class RawErasureCoder:
    """Cell-level encode/decode for one (k, m) schema."""

    def __init__(self, k: int, m: int):
        self.k = k
        self.m = m

    def encode(self, data_cells: Sequence[bytes]) -> List[bytes]:
        """k equal-length data cells -> m parity cells."""
        raise NotImplementedError

    def decode(self, shards: Sequence[Optional[bytes]]) -> List[bytes]:
        """k+m cells with None for the missing ones (at most m missing,
        all present cells equal length) -> the full k+m cells."""
        raise NotImplementedError


class RSRawCoder(RawErasureCoder):
    def encode(self, data_cells: Sequence[bytes]) -> List[bytes]:
        assert len(data_cells) == self.k
        mat = _cauchy_parity_matrix(self.k, self.m)
        data = np.stack([np.frombuffer(c, np.uint8) for c in data_cells])
        out = _gf_matmul(mat, data)
        return [out[i].tobytes() for i in range(self.m)]

    def decode(self, shards: Sequence[Optional[bytes]]) -> List[bytes]:
        n = self.k + self.m
        assert len(shards) == n
        present = [s is not None for s in shards]
        alive = sum(present)
        if alive < self.k:
            raise ValueError(
                f"RS({self.k},{self.m}): only {alive} shards present")
        pmat = _cauchy_parity_matrix(self.k, self.m)
        gen = np.vstack([np.eye(self.k, dtype=np.uint8), pmat])
        rows = [i for i in range(n) if present[i]][:self.k]
        inv = _gf_invert(gen[rows])
        src = np.stack([np.frombuffer(shards[i], np.uint8) for i in rows])
        data = _gf_matmul(inv, src)            # the k data cells
        parity = _gf_matmul(pmat, data)        # the m parity cells
        full = np.vstack([data, parity])
        return [shards[i] if present[i] else full[i].tobytes()
                for i in range(n)]


class XORRawCoder(RawErasureCoder):
    """Single parity (XOR); m must be 1."""

    def encode(self, data_cells: Sequence[bytes]) -> List[bytes]:
        assert len(data_cells) == self.k and self.m == 1
        acc = np.frombuffer(data_cells[0], np.uint8).copy()
        for c in data_cells[1:]:
            acc ^= np.frombuffer(c, np.uint8)
        return [acc.tobytes()]

    def decode(self, shards: Sequence[Optional[bytes]]) -> List[bytes]:
        missing = [i for i, s in enumerate(shards) if s is None]
        if len(missing) > 1:
            raise ValueError(f"XOR can repair 1 loss, {len(missing)} missing")
        if not missing:
            return list(shards)  # type: ignore[arg-type]
        acc = None
        for s in shards:
            if s is None:
                continue
            v = np.frombuffer(s, np.uint8)
            acc = v.copy() if acc is None else acc ^ v
        out = list(shards)
        out[missing[0]] = acc.tobytes()
        return out  # type: ignore[return-value]


# ------------------------------------------------------------------ policies

class ECPolicy:
    """A named (codec, k, m, cell size) schema."""

    __slots__ = ("name", "codec", "k", "m", "cell_size")

    def __init__(self, name: str, codec: str, k: int, m: int, cell_size: int):
        self.name = name
        self.codec = codec
        self.k = k
        self.m = m
        self.cell_size = cell_size

    @property
    def num_units(self) -> int:
        return self.k + self.m

    def new_coder(self) -> RawErasureCoder:
        if self.codec == "xor":
            return XORRawCoder(self.k, self.m)
        return RSRawCoder(self.k, self.m)

    def __repr__(self):
        return f"ECPolicy({self.name})"


_CELL_64K = 64 * 1024

SYSTEM_POLICIES: Dict[str, ECPolicy] = {
    p.name: p for p in (
        ECPolicy("RS-6-3-64k", "rs", 6, 3, _CELL_64K),
        ECPolicy("RS-3-2-64k", "rs", 3, 2, _CELL_64K),
        ECPolicy("RS-10-4-64k", "rs", 10, 4, _CELL_64K),
        ECPolicy("XOR-2-1-64k", "xor", 2, 1, _CELL_64K),
    )
}


def get_policy(name: str) -> ECPolicy:
    try:
        return SYSTEM_POLICIES[name]
    except KeyError:
        raise ValueError(
            f"unknown EC policy {name!r}; known: "
            f"{sorted(SYSTEM_POLICIES)}") from None


# -------------------------------------------------------- striped id scheme
# Block-group ids live in a reserved range with the low 4 bits zero; the
# storage unit at index i uses id group_id + i.

STRIPED_ID_BASE = 1 << 40
MAX_UNITS = 16


def is_striped_id(block_id: int) -> bool:
    return block_id >= STRIPED_ID_BASE


def group_id_of(block_id: int) -> int:
    return block_id & ~(MAX_UNITS - 1)


def unit_index_of(block_id: int) -> int:
    return block_id & (MAX_UNITS - 1)


def unit_length(logical_len: int, policy: ECPolicy, idx: int) -> int:
    """Bytes stored by unit ``idx`` of a group holding ``logical_len``
    data bytes: data cells fill row-major across the k data columns, a
    parity unit is as long as the longest data unit of each stripe."""
    k, cell = policy.k, policy.cell_size
    full, rem = divmod(logical_len, k * cell)
    base = full * cell
    if idx < k:
        return base + min(max(rem - idx * cell, 0), cell)
    return base + min(rem, cell)


def pad_stripe_cells(cells: List[bytes]) -> List[bytes]:
    """Zero-pad a (possibly partial) last stripe's data cells to equal
    length, the convention encoder and decoder share."""
    width = max(len(c) for c in cells)
    return [c if len(c) == width else c + b"\0" * (width - len(c))
            for c in cells]
