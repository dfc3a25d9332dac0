"""Typed key/value configuration for the serving door, the RPC client
and the DFS client.

The part of ``hadoop_tpu/conf/configuration.py``'s ``Configuration``
they read: typed getters with the default at the call site (as in the
reference's ``conf.get_int(KEY, default)`` calls; sizes as ``64m``,
times as ``30s``), ``set``, ``set_if_unset`` and ``to_dict`` (what the
chassis's ``/conf`` shows). It loads no resource files and expands no
``${var}``.

They take any object with these methods (:class:`ConfLike`), so a
``hadoop_tpu`` ``Configuration`` passes in unchanged; the port never
imports or checks for its type.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Protocol

_TRUE = {"true", "yes", "on", "1"}
_FALSE = {"false", "no", "off", "0"}
_SIZE_SUFFIXES = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40,
                  "p": 1 << 50}
_TIME_SUFFIXES = {"ns": 1e-9, "us": 1e-6, "ms": 1e-3, "s": 1.0,
                  "m": 60.0, "h": 3600.0, "d": 86400.0}


class ConfLike(Protocol):
    """What the door asks of a configuration object."""

    def get(self, key: str, default: Optional[str] = None
            ) -> Optional[str]: ...

    def get_int(self, key: str, default: int = 0) -> int: ...

    def get_float(self, key: str, default: float = 0.0) -> float: ...

    def get_bool(self, key: str, default: bool = False) -> bool: ...

    def get_time_seconds(self, key: str, default: float = 0.0
                         ) -> float: ...

    def get_size_bytes(self, key: str, default: int = 0) -> int: ...

    def get_list(self, key: str, default: Optional[List[str]] = None
                 ) -> List[str]: ...

    def set(self, key: str, value: Any) -> None: ...

    def set_if_unset(self, key: str, value: Any) -> None: ...

    def to_dict(self) -> Dict[str, str]: ...


class Configuration:
    """Flat string properties with the reference's typed getters.
    ``load_defaults`` is accepted for the reference's signature; there
    are no default resources to load."""

    def __init__(self, load_defaults: bool = True):
        self._lock = threading.Lock()
        self._props: Dict[str, str] = {}

    def get(self, key: str, default: Optional[str] = None) -> Optional[str]:
        with self._lock:
            return self._props.get(key, default)

    def get_trimmed(self, key: str,
                    default: Optional[str] = None) -> Optional[str]:
        v = self.get(key, default)
        return v.strip() if isinstance(v, str) else v

    def set(self, key: str, value: Any) -> None:
        with self._lock:
            self._props[key] = str(value)

    def set_if_unset(self, key: str, value: Any) -> None:
        with self._lock:
            self._props.setdefault(key, str(value))

    def get_int(self, key: str, default: int = 0) -> int:
        v = self.get_trimmed(key)
        if v is None or v == "":
            return default
        try:
            return int(v, 16) if v.lower().startswith("0x") else int(v)
        except ValueError:
            raise ValueError(
                f"conf key {key!r}: invalid int value {v!r}") from None

    def get_float(self, key: str, default: float = 0.0) -> float:
        v = self.get_trimmed(key)
        return default if v is None or v == "" else float(v)

    def get_bool(self, key: str, default: bool = False) -> bool:
        v = self.get_trimmed(key)
        if v is None or v == "":
            return default
        if v.lower() in _TRUE:
            return True
        if v.lower() in _FALSE:
            return False
        raise ValueError(
            f"conf key {key!r}: invalid boolean value {v!r} (accepted: "
            f"{'/'.join(sorted(_TRUE))} or {'/'.join(sorted(_FALSE))})")

    def get_size_bytes(self, key: str, default: int = 0) -> int:
        """'64m' → 67108864."""
        v = self.get_trimmed(key)
        if v is None or v == "":
            return default
        vl = v.lower()
        if vl[-1] in _SIZE_SUFFIXES:
            return int(float(vl[:-1]) * _SIZE_SUFFIXES[vl[-1]])
        return int(v)

    def get_time_seconds(self, key: str, default: float = 0.0) -> float:
        """'30s' / '5m' / '100ms' → seconds."""
        v = self.get_trimmed(key)
        if v is None or v == "":
            return default
        vl = v.lower()
        for suf in sorted(_TIME_SUFFIXES, key=len, reverse=True):
            if vl.endswith(suf) and vl[:-len(suf)]:
                try:
                    return float(vl[:-len(suf)]) * _TIME_SUFFIXES[suf]
                except ValueError:
                    continue
        return float(vl)

    def get_list(self, key: str,
                 default: Optional[List[str]] = None) -> List[str]:
        v = self.get_trimmed(key)
        if v is None or v == "":
            return list(default) if default else []
        return [s.strip() for s in v.split(",") if s.strip()]

    def to_dict(self) -> Dict[str, str]:
        with self._lock:
            return dict(self._props)
