"""Block codecs for the host-RAM and DFS KV tiers.

The port's own copy of ``hadoop_tpu/serving/kvstore/codec.py``; a block
file written by either package decodes in the other. Two codecs:

- ``raw``  — dtype bytes verbatim; demote/promote round-trips are
  bit-exact and the decoded tokens match a cold prefill exactly.
- ``int8`` — symmetric per-layer int8 with float32 scales (amax/127
  over each layer's ``[block, heads, dim]`` slab, rounded half to even
  as ``np.rint`` does): ~2× (bf16) to ~4× (f32) smaller on the wire and
  on the DataNodes; decode is allclose rather than bit-exact.

The codec is a property of each stored block, not of the reader: the
file header records which codec wrote it, so a raw-configured replica
reads an int8 store and the other way round.

File layout: ``u32 BE header length || header JSON || k payload || v
payload``. The header pins shape and dtype; ``decode_block`` validates
both so a store written by an incompatible engine shape fails loudly
instead of silently corrupting a context.

**bfloat16 without ml_dtypes.** numpy has no bfloat16 here, so a bf16
payload travels as its 16-bit patterns in a ``uint16`` array, and the
dtype's name (``"bfloat16"``, numpy's spelling through ml_dtypes) rides
beside it: in the file header, and as the ``dtype`` argument of the
functions below. Widening to float32 is the exact bit shift, and
narrowing rounds to nearest even, as ml_dtypes' cast does.
"""

from __future__ import annotations

import json
import struct
from typing import Tuple

import numpy as np

CODECS = ("raw", "int8")
_MAGIC_VERSION = 1

BF16 = "bfloat16"


def dtype_name(dtype) -> str:
    """numpy's name of a dtype given as a name, a numpy dtype or a torch
    dtype (``torch.bfloat16`` → ``"bfloat16"``)."""
    if isinstance(dtype, str):
        name = dtype
    else:
        name = str(dtype)
        if name.startswith("torch."):
            name = name[len("torch."):]
        else:
            name = str(np.dtype(dtype))
    return BF16 if name == BF16 else str(np.dtype(name))


def storage_dtype(dtype) -> np.dtype:
    """The numpy dtype a payload of ``dtype`` is held in (bf16: uint16)."""
    name = dtype_name(dtype)
    return np.dtype(np.uint16) if name == BF16 else np.dtype(name)


def to_float32(x: np.ndarray, dtype) -> np.ndarray:
    """Exact float32 values of a payload held as ``storage_dtype``."""
    if dtype_name(dtype) == BF16:
        return (np.asarray(x, np.uint16).astype(np.uint32) << 16).view(
            np.float32)
    return np.asarray(x, np.float32)


def from_float32(xf: np.ndarray, dtype) -> np.ndarray:
    """float32 values cast to ``dtype``'s storage, rounding to nearest
    even (bf16: the bit patterns ml_dtypes' ``astype`` gives)."""
    name = dtype_name(dtype)
    if name != BF16:
        return np.asarray(xf, np.float32).astype(name)
    bits = np.ascontiguousarray(xf, np.float32).view(np.uint32)
    return ((bits + (0x7FFF + ((bits >> 16) & 1))) >> 16).astype(np.uint16)


def quant_int8(x: np.ndarray, dtype=None) -> Tuple[np.ndarray, np.ndarray]:
    """Symmetric per-layer int8: scales are float32 amax/127 over each
    layer's [block, heads, dim] slab (axis 0 is the layer). Shared by the
    file codec below and the host ring's resident form (hosttier.py).
    ``dtype`` names the payload's dtype (default: the array's own)."""
    xf = to_float32(x, dtype if dtype is not None else x.dtype)
    amax = np.max(np.abs(xf), axis=(1, 2, 3), keepdims=True)
    scales = np.maximum(amax, 1e-12) / 127.0
    q = np.clip(np.rint(xf / scales), -127, 127).astype(np.int8)
    return q, scales.reshape(-1).astype(np.float32)


def dequant_int8(q: np.ndarray, scales, dtype) -> np.ndarray:
    s = np.asarray(scales, np.float32).reshape(-1, 1, 1, 1)
    return from_float32(q.astype(np.float32) * s, dtype)


def encode_block(k: np.ndarray, v: np.ndarray, codec: str = "raw",
                 dtype=None) -> bytes:
    """Serialize one block's (K, V) payload (shape [L, bs, Hkv, Dh]).
    ``dtype`` names the payload's dtype when the arrays hold bf16 bits
    (default: the arrays' own dtype)."""
    if codec not in CODECS:
        raise ValueError(f"unknown KV block codec {codec!r} "
                         f"(serving.kv.codec must be one of {CODECS})")
    name = dtype_name(dtype if dtype is not None else k.dtype)
    header = {"v": _MAGIC_VERSION, "codec": codec,
              "dtype": name, "shape": list(k.shape)}
    if codec == "raw":
        store = storage_dtype(name)
        kb = np.ascontiguousarray(k, store).tobytes()
        vb = np.ascontiguousarray(v, store).tobytes()
    else:
        kq, ks = quant_int8(k, name)
        vq, vs = quant_int8(v, name)
        header["scales_k"] = [float(s) for s in ks]
        header["scales_v"] = [float(s) for s in vs]
        kb, vb = kq.tobytes(), vq.tobytes()
    hj = json.dumps(header, separators=(",", ":")).encode()
    return struct.pack(">I", len(hj)) + hj + kb + vb


def decode_block(data: bytes, *, shape=None, dtype=None
                 ) -> Tuple[np.ndarray, np.ndarray, dict]:
    """Inverse of ``encode_block``: (K, V, header), the payloads in the
    header dtype's storage (bf16 as uint16 bits). Validates ``shape`` and
    ``dtype`` when the caller pins them (the tier manager always does — a
    mismatched payload must be a loud miss, never a silent context
    corruption)."""
    if len(data) < 4:
        raise ValueError("truncated KV block (no header length)")
    (hlen,) = struct.unpack(">I", data[:4])
    header = json.loads(data[4:4 + hlen].decode())
    if header.get("v") != _MAGIC_VERSION:
        raise ValueError(f"KV block version {header.get('v')!r} "
                         f"(expected {_MAGIC_VERSION})")
    hshape = tuple(header["shape"])
    hname = dtype_name(header["dtype"])
    if shape is not None and hshape != tuple(shape):
        raise ValueError(f"KV block shape {hshape} != engine {shape}")
    if dtype is not None and hname != dtype_name(dtype):
        raise ValueError(f"KV block dtype {hname} != engine "
                         f"{dtype_name(dtype)}")
    n = int(np.prod(hshape))
    body = data[4 + hlen:]
    if header["codec"] == "raw":
        store = storage_dtype(hname)
        itemsize = store.itemsize
        if len(body) != 2 * n * itemsize:
            raise ValueError("truncated raw KV block payload")
        k = np.frombuffer(body[:n * itemsize], store).reshape(hshape)
        v = np.frombuffer(body[n * itemsize:], store).reshape(hshape)
    elif header["codec"] == "int8":
        if len(body) != 2 * n:
            raise ValueError("truncated int8 KV block payload")
        kq = np.frombuffer(body[:n], np.int8).reshape(hshape)
        vq = np.frombuffer(body[n:], np.int8).reshape(hshape)
        k = dequant_int8(kq, header["scales_k"], hname)
        v = dequant_int8(vq, header["scales_v"], hname)
    else:
        raise ValueError(f"unknown KV block codec {header['codec']!r}")
    return k, v, header
