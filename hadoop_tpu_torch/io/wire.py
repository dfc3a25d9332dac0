"""The control plane's binary wire format ("wirepack"), byte for byte the
reference's.

The port's copy of ``hadoop_tpu/io/wire.py`` for its RPC client: what a
port process sends to a reference daemon (the service registry, any
``ipc.Server``) must decode there, and the other way round.
Type-tagged values with LEB128 varints: None, bool, int (any size, as a
zigzag varint), float (f64), str, bytes, list, dict with str keys, and
any object with ``to_wire() -> dict``. Small ints, short strings and
small containers take one tag byte. The reference also has a C codec
that gives the same bytes; the port carries only this one.

``write_frame``/``read_frame`` prefix a frame with its u32 length.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

MAX_FRAME = 128 * 1024 * 1024


class WireError(Exception):
    pass


# ---- tag space ----------------------------------------------------------
# 0x00-0x7f : positive fixint 0..127
# 0x80-0x8f : fixmap, 0-15 entries
# 0x90-0x9f : fixarray, 0-15 items
# 0xa0-0xbf : fixstr, 0-31 bytes
# 0xc0 nil | 0xc2 false | 0xc3 true
# 0xc4 bin(varint len) | 0xc5 str(varint len)
# 0xc6 int(zigzag varint) | 0xc7 float64
# 0xc8 array(varint n) | 0xc9 map(varint n)
# 0xe0-0xff : negative fixint -32..-1

_NIL, _FALSE, _TRUE = 0xC0, 0xC2, 0xC3
_BIN, _STR, _INT, _F64, _ARR, _MAP = 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9


def _uvarint(buf: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.append(b | 0x80)
        else:
            buf.append(b)
            return


def _zigzag_big(n: int) -> int:
    return (n << 1) if n >= 0 else ((-n << 1) - 1)


def _unzigzag(u: int) -> int:
    return (u >> 1) ^ -(u & 1)


class Encoder:
    def __init__(self):
        self._buf = bytearray()

    def encode(self, obj: Any) -> "Encoder":
        self._enc(obj)
        return self

    def getvalue(self) -> bytes:
        return bytes(self._buf)

    def _enc(self, o: Any) -> None:
        buf = self._buf
        if o is None:
            buf.append(_NIL)
        elif o is True:
            buf.append(_TRUE)
        elif o is False:
            buf.append(_FALSE)
        elif isinstance(o, int):
            if 0 <= o <= 0x7F:
                buf.append(o)
            elif -32 <= o < 0:
                buf.append(0x100 + o)
            else:
                buf.append(_INT)
                _uvarint(buf, _zigzag_big(o))
        elif isinstance(o, float):
            buf.append(_F64)
            buf += struct.pack(">d", o)
        elif isinstance(o, str):
            b = o.encode("utf-8")
            if len(b) <= 31:
                buf.append(0xA0 | len(b))
            else:
                buf.append(_STR)
                _uvarint(buf, len(b))
            buf += b
        elif isinstance(o, (bytes, bytearray, memoryview)):
            buf.append(_BIN)
            _uvarint(buf, len(o))
            buf += o
        elif isinstance(o, (list, tuple)):
            n = len(o)
            if n <= 15:
                buf.append(0x90 | n)
            else:
                buf.append(_ARR)
                _uvarint(buf, n)
            for item in o:
                self._enc(item)
        elif isinstance(o, dict):
            n = len(o)
            if n <= 15:
                buf.append(0x80 | n)
            else:
                buf.append(_MAP)
                _uvarint(buf, n)
            for k, v in o.items():
                if not isinstance(k, str):
                    raise WireError(f"map keys must be str, got {type(k).__name__}")
                self._enc(k)
                self._enc(v)
        elif hasattr(o, "to_wire"):
            self._enc(o.to_wire())
        else:
            raise WireError(f"cannot encode {type(o).__name__}")


class Decoder:
    def __init__(self, data, offset: int = 0):
        self._d = memoryview(data)
        self._p = offset

    @property
    def offset(self) -> int:
        return self._p

    def _uvarint(self) -> int:
        d, p, shift, n = self._d, self._p, 0, 0
        while True:
            if p >= len(d):
                raise WireError("truncated varint")
            b = d[p]
            p += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                self._p = p
                return n
            shift += 7

    def decode(self) -> Any:
        d = self._d
        if self._p >= len(d):
            raise WireError("truncated input")
        tag = d[self._p]
        self._p += 1
        if tag <= 0x7F:
            return tag
        if tag >= 0xE0:
            return tag - 0x100
        if 0xA0 <= tag <= 0xBF:
            return str(self._take(tag & 0x1F), "utf-8") if tag & 0x1F else ""
        if 0x90 <= tag <= 0x9F:
            return [self.decode() for _ in range(tag & 0x0F)]
        if 0x80 <= tag <= 0x8F:
            return {self.decode(): self.decode() for _ in range(tag & 0x0F)}
        if tag == _NIL:
            return None
        if tag == _TRUE:
            return True
        if tag == _FALSE:
            return False
        if tag == _INT:
            return _unzigzag(self._uvarint())
        if tag == _F64:
            raw = self._take(8)
            return struct.unpack(">d", raw)[0]
        if tag == _STR:
            return str(self._take(self._uvarint()), "utf-8")
        if tag == _BIN:
            return bytes(self._take(self._uvarint()))
        if tag == _ARR:
            return [self.decode() for _ in range(self._uvarint())]
        if tag == _MAP:
            return {self.decode(): self.decode() for _ in range(self._uvarint())}
        raise WireError(f"bad tag 0x{tag:02x} at {self._p - 1}")

    def _take(self, n: int) -> memoryview:
        if self._p + n > len(self._d):
            raise WireError("truncated payload")
        out = self._d[self._p:self._p + n]
        self._p += n
        return out


def pack(obj: Any) -> bytes:
    return Encoder().encode(obj).getvalue()


def unpack(data, offset: int = 0) -> Any:
    return Decoder(data, offset).decode()


def unpack_with_offset(data, offset: int = 0) -> Tuple[Any, int]:
    dec = Decoder(data, offset)
    return dec.decode(), dec.offset


# ----------------------------------------------------------- stream framing

def write_frame(sock_or_file, payload: bytes) -> None:
    hdr = struct.pack(">I", len(payload))
    if hasattr(sock_or_file, "sendall"):
        sock_or_file.sendall(hdr + payload)
    else:
        sock_or_file.write(hdr + payload)


def read_exact(sock_or_file, n: int) -> bytes:
    recv_into = getattr(sock_or_file, "recv_into", None)
    if recv_into is not None:
        buf = bytearray(n)
        view = memoryview(buf)
        got = 0
        while got < n:
            m = recv_into(view[got:])
            if not m:
                raise EOFError(f"stream closed after {got}/{n} bytes")
            got += m
        return bytes(buf)
    chunks = []
    got = 0
    while got < n:
        chunk = sock_or_file.read(n - got)
        if not chunk:
            raise EOFError(f"stream closed after {got}/{n} bytes")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(sock_or_file, max_frame: int = MAX_FRAME) -> bytes:
    (n,) = struct.unpack(">I", read_exact(sock_or_file, 4))
    if n > max_frame:
        raise WireError(f"frame of {n} bytes exceeds limit {max_frame}")
    return read_exact(sock_or_file, n)
