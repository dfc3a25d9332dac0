"""GF(256) arithmetic for Reed-Solomon coding: tables, the Cauchy
generator, matrix inversion and the numpy host coder.

The port's own copy of what ``ops/ec_device.py`` needs from
``hadoop_tpu/io/erasurecode.py`` (``_build_tables``, ``_cauchy_parity_matrix``,
``_gf_invert``, ``_gf_matmul``), so the port imports nothing of the JAX
package. The same polynomial (0x11D) and the same Cauchy matrix, so
parity written by either package, or by the native coder, decodes with
the other.
"""

from __future__ import annotations

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
