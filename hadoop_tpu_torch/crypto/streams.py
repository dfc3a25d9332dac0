"""AES-CTR crypto streams: transparent encryption at rest.

The port's copy of ``hadoop_tpu/crypto/streams.py``. CTR mode gives
seekable, length-preserving encryption: the counter for byte offset N
is IV + N//16, so a positioned read decrypts without touching earlier
bytes, and a write or read that starts inside a block burns the block's
leading bytes of keystream first. The bytes are the reference's for the
same key, IV and offset.

The cipher is OpenSSL's AES through the ``cryptography`` package, the
only cipher used. It is imported where a cipher is built, not when this
module is imported, so the package imports on a host without it; a
stream opened there raises ``ImportError`` naming the package.
"""

from __future__ import annotations

from typing import Optional

AES_BLOCK = 16


def _aes_ctr(key: bytes, counter: bytes):
    try:
        from cryptography.hazmat.primitives.ciphers import (Cipher,
                                                            algorithms,
                                                            modes)
    except ImportError as e:
        raise ImportError(
            "encryption zones need the 'cryptography' package (AES-CTR), "
            "which is not installed on this host") from e
    return Cipher(algorithms.AES(key), modes.CTR(counter))


def _counter_iv(iv: bytes, offset: int) -> bytes:
    """IV advanced by offset//16 blocks, modulo 2**128."""
    ctr = int.from_bytes(iv, "big") + offset // AES_BLOCK
    return (ctr % (1 << 128)).to_bytes(16, "big")


def _crypt(key: bytes, iv: bytes, offset: int, data: bytes) -> bytes:
    """En- or decrypt ``data`` that sits at stream ``offset`` (CTR is its
    own inverse)."""
    pre = offset % AES_BLOCK
    enc = _aes_ctr(key, _counter_iv(iv, offset)).encryptor()
    if pre:
        enc.update(b"\0" * pre)  # burn the partial leading block
    return enc.update(data)


class CryptoOutputStream:
    """Encrypting wrapper over any stream with ``write`` and ``close``."""

    def __init__(self, inner, key: bytes, iv: bytes):
        self.inner = inner
        self.key = key
        self.iv = iv
        self._pos = 0

    def write(self, data: bytes) -> int:
        out = _crypt(self.key, self.iv, self._pos, data)
        self.inner.write(out)
        self._pos += len(data)
        return len(data)

    def flush(self) -> None:
        if hasattr(self.inner, "flush"):
            self.inner.flush()

    def tell(self) -> int:
        return self._pos

    def close(self) -> None:
        self.inner.close()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *rest):
        if exc_type is None:
            self.close()
        return False


class CryptoInputStream:
    """Decrypting wrapper that keeps ``seek``, ``tell`` and ``pread``."""

    def __init__(self, inner, key: bytes, iv: bytes):
        self.inner = inner
        self.key = key
        self.iv = iv

    def read(self, n: int = -1) -> bytes:
        pos = self.inner.tell()
        data = self.inner.read(n)
        return _crypt(self.key, self.iv, pos, data)

    def pread(self, position: int, length: int) -> bytes:
        if hasattr(self.inner, "pread"):
            raw = self.inner.pread(position, length)
        else:
            saved = self.inner.tell()
            self.inner.seek(position)
            raw = self.inner.read(length)
            self.inner.seek(saved)
        return _crypt(self.key, self.iv, position, raw)

    def seek(self, pos: int) -> None:
        self.inner.seek(pos)

    def tell(self) -> int:
        return self.inner.tell()

    @property
    def length(self) -> Optional[int]:
        return getattr(self.inner, "length", None)

    def close(self) -> None:
        self.inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
