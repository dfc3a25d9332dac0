"""Device-resident Reed-Solomon coding: GF(256) over 32-bit words.

The counterpart of ``hadoop_tpu/ops/ec_device.py``. When striped data
already lies in device memory, encode and decode run on the card instead
of on the host coder. Same Cauchy matrix and same byte-wise math as the
host coders, so the parity is theirs bit for bit.

Words live in a ``torch.int32`` tensor [k, W], four bytes each (the
reference's uint32 words, the same bits). On a CUDA tensor a matrix is
applied by the hand-written kernel ``ops/csrc/ec_gf256.cu``, one launch
(``launches`` counts them), which looks its products up in tables built
here (``_tables``): for data unit j and byte value b, an entry of S
32-bit words whose word g holds gf_mul(M[4g + q][j], b) in byte q, so
one shared-memory load gives the products of b with four rows at once
(with all of them, up to sixteen).

On a CPU tensor the matrix is applied by the kernel's plain version
``apply_matrix_ref``, the reference's ``_apply_matrix`` in int32 torch
ops: a multiply by the constant ``c`` decomposes over the bits of the
data byte, gf_mul(c, b) = XOR over set bits s of b of gf_mul(c, 2**s),
so each term is ``((word >> s) & 0x01010101) * gf_mul(c, 2**s)`` (a 0/1
byte-lane mask times a byte constant: no carry crosses a lane) and an
output word is the XOR of ``8 * k`` such terms. Arithmetic ``>>`` on
int32 is safe there: for s ≤ 7 the mask reads only original bits, and
the lane-3 product wraps as uint32 would.

Decode inverts the k×k survivor matrix on the host (Gauss-Jordan on a
small uint8 matrix) and applies the recovery matrix with the same
kernel. Coders are cached per schema and per erasure pattern.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from hadoop_tpu_torch.device import resolve_device
from hadoop_tpu_torch.io.erasurecode import (_MUL, _cauchy_parity_matrix,
                                             _gf_invert)
from hadoop_tpu_torch.ops import _build

__all__ = ["device_encoder", "device_decode", "encode_cells",
           "decode_cells", "GFMatrix", "apply_matrix_ref"]

_LANES = 0x01010101
_MAX_UNITS = 16                  # ec_gf256.cu's largest k and r

launches = 0                     # ec_gf256.cu launches


def _bit_consts(mat: np.ndarray) -> np.ndarray:
    """[r, k] GF matrix → [r, k, 8] int32 bit-decomposition constants:
    K[i, j, s] = gf_mul(mat[i, j], 2**s), a byte."""
    r, k = mat.shape
    out = np.zeros((r, k, 8), np.int32)
    for i in range(r):
        for j in range(k):
            c = int(mat[i, j])
            for s in range(8):
                out[i, j, s] = int(_MUL[c, 1 << s])
    return out


def apply_matrix_ref(consts: np.ndarray, words: torch.Tensor
                     ) -> torch.Tensor:
    """The plain version: [r, k, 8] constants × [k, W] int32 words →
    [r, W] int32, one torch op per shift, mask, multiply and XOR."""
    rows = []
    for i in range(consts.shape[0]):
        acc = torch.zeros_like(words[0])
        for j in range(consts.shape[1]):
            w = words[j]
            for s in range(8):
                kc = int(consts[i, j, s])
                if kc:
                    acc ^= ((w >> s) & _LANES) * kc
        rows.append(acc)
    return torch.stack(rows)


def _entry_words(r: int) -> int:
    """Words of one table entry for r output rows: one per group of
    four rows, three groups padded to four (a 16-byte load)."""
    groups = -(-r // 4)
    return 4 if groups == 3 else groups


def _tables(mat: np.ndarray) -> np.ndarray:
    """[r, k] GF matrix → the kernel's product tables, [k, 256, S] int32:
    byte q of word g of entry [j, b] is gf_mul(mat[4g + q, j], b), 0 past
    the last row (S = ``_entry_words(r)``)."""
    r, k = mat.shape
    s = _entry_words(r)
    prod = np.zeros((4 * s, k, 256), np.uint8)
    prod[:r] = _MUL[mat.astype(np.intp)]               # [r, k, 256]
    # [group, byte q, k, b] → [k, b, group, byte q]: four bytes a word,
    # byte q the q-th in memory (little-endian, as the kernel reads it)
    lanes = prod.reshape(s, 4, k, 256).transpose(2, 3, 0, 1)
    return np.ascontiguousarray(lanes).view("<i4")[..., 0]


def _launch_apply(tables: torch.Tensor, words: torch.Tensor, r: int
                  ) -> torch.Tensor:
    """``apply_matrix_ref`` by the kernel, in one launch, for an [r, k]
    matrix; ``tables`` is its [k, 256, S] int32 product tables
    (``_tables``) on the words' device."""
    global launches
    k = words.shape[0] if words.dim() == 2 else 0
    if not (words.is_cuda and tables.device == words.device
            and words.dtype == torch.int32 and tables.dtype == torch.int32
            and 1 <= k <= _MAX_UNITS and 1 <= r <= _MAX_UNITS
            and tuple(tables.shape) == (k, 256, _entry_words(r))):
        raise ValueError(
            f"ec_gf256 kernel: words {words.dtype} {tuple(words.shape)} on "
            f"{words.device}, tables {tables.dtype} {tuple(tables.shape)} "
            f"on {tables.device} for {r} rows; it takes int32 words [k, W] "
            f"and int32 tables [k, 256, S] on one CUDA device, k and r in "
            f"1..{_MAX_UNITS}")
    words = words.contiguous()
    out = torch.empty(r, words.shape[1], dtype=torch.int32,
                      device=words.device)
    _build.launch("htpu_ec_gf256_apply", words, tables.contiguous(), out,
                  words.shape[1], k, r)
    launches += 1
    return out


class GFMatrix:
    """One GF(256) matrix as the coder applies it: ``[k, W]`` int32 words
    → ``[r, W]``. Its bit constants stay on the host for the plain
    version; its product tables are copied to each CUDA device once, for
    the kernel."""

    def __init__(self, mat: np.ndarray):
        self.rows = mat.shape[0]
        self.consts = _bit_consts(mat)
        self.tables = _tables(mat)
        self._on: Dict[torch.device, torch.Tensor] = {}

    def tables_on(self, device: torch.device) -> torch.Tensor:
        t = self._on.get(device)
        if t is None:
            t = self._on.setdefault(device, torch.from_numpy(
                self.tables).to(device))
        return t

    def __call__(self, words: torch.Tensor) -> torch.Tensor:
        if words.is_cuda:
            return _launch_apply(self.tables_on(words.device), words,
                                 self.rows)
        if words.device.type != "cpu":
            raise ValueError(f"words on {words.device}: the coder runs on "
                             "a CUDA device, or its plain version on the "
                             "CPU")
        return apply_matrix_ref(self.consts, words)


_ENCODERS: Dict[Tuple[int, int], GFMatrix] = {}


def device_encoder(k: int, m: int) -> GFMatrix:
    """``[k, W]`` int32 data words → ``[m, W]`` parity words for the
    RS(k, m) Cauchy code, cached per schema."""
    key = (k, m)
    fn = _ENCODERS.get(key)
    if fn is None:
        fn = _ENCODERS.setdefault(key,
                                  GFMatrix(_cauchy_parity_matrix(k, m)))
    return fn


def _as_words(cells: Sequence[bytes], device) -> Tuple[torch.Tensor, int]:
    """k same-length byte cells → [k, W] int32 on ``device`` (zero-padded
    to a multiple of 4 bytes) and the cell length."""
    n = len(cells[0])
    pad = (-n) % 4
    arr = np.zeros((len(cells), n + pad), np.uint8)
    for i, c in enumerate(cells):
        if len(c) != n:
            raise ValueError("cells must be equal length")
        arr[i, :n] = np.frombuffer(c, np.uint8)
    return torch.from_numpy(arr.view(np.int32)).to(device), n


def _cells(words: torch.Tensor, n: int) -> List[bytes]:
    host = words.cpu().numpy()
    return [host[i].tobytes()[:n] for i in range(host.shape[0])]


def encode_cells(k: int, m: int, cells: Sequence[bytes], *,
                 device=None) -> List[bytes]:
    """The ``RawErasureCoder.encode`` contract (k data cells in, m parity
    cells out) on ``device`` (default: the GPU). Bit-exact with the host
    coders."""
    if len(cells) != k:
        # fail loudly: a short list would index past the words
        raise ValueError(f"need {k} data cells, got {len(cells)}")
    words, n = _as_words(cells, resolve_device(device))
    return _cells(device_encoder(k, m)(words), n)


_DECODERS: Dict[Tuple[int, int, Tuple[int, ...]], GFMatrix] = {}


def device_decode(k: int, m: int, present: Sequence[int]
                  ) -> Tuple[GFMatrix, List[int]]:
    """Reconstruction for one erasure pattern: the matrix takes the
    ``[k, W]`` words of the first k surviving units (in the returned row
    order) and gives all k data units. ``present`` lists the surviving
    unit ids (0..k-1 data, k..k+m-1 parity), at least k of them. Cached
    per (schema, pattern)."""
    rows = tuple(sorted(present)[:k])
    if len(rows) < k:
        raise ValueError(f"need {k} surviving units, have {len(rows)}")
    key = (k, m, rows)
    fn = _DECODERS.get(key)
    if fn is None:
        full = np.vstack([np.eye(k, dtype=np.uint8),
                          _cauchy_parity_matrix(k, m)])
        sub = full[list(rows)]             # k×k, invertible (Cauchy MDS)
        fn = _DECODERS.setdefault(key, GFMatrix(_gf_invert(sub)))
    return fn, list(rows)


def decode_cells(k: int, m: int, shards: Sequence[bytes | None], *,
                 device=None) -> List[bytes]:
    """The ``RawErasureCoder.decode`` contract on ``device`` (default: the
    GPU): ``shards`` is the k+m unit list with ``None`` for erasures;
    returns the k data cells."""
    if len(shards) != k + m:
        raise ValueError(f"need {k + m} shard slots, got {len(shards)}")
    present = [i for i, s in enumerate(shards) if s is not None]
    fn, rows = device_decode(k, m, present)
    words, n = _as_words([shards[r] for r in rows], resolve_device(device))
    return _cells(fn(words), n)
