"""Server-side user→groups resolution.

The port's copy of ``hadoop_tpu/security/groups.py``, on the same wire
and disk formats.

Parity with the reference's group mapping layer (ref: hadoop-common
security/Groups.java + GroupMappingServiceProvider /
ShellBasedUnixGroupsMapping / StaticUserWebFilter's static mapping):
group membership is resolved ON THE SERVER from a trusted source —
never taken from the client's asserted UGI, which would let any caller
claim membership in the superuser group.

Sources, in order:
  1. ``hadoop.security.group.mapping.static.mapping`` — inline
     ``user1=g1,g2;user2=g3`` pairs (ref: the static mapping config
     used throughout the reference's tests).
  2. OS account database (``grp``/``pwd``) for users that exist
     locally — the ShellBasedUnixGroupsMapping analog.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List

STATIC_MAPPING_KEY = "hadoop.security.group.mapping.static.mapping"
CACHE_TTL_S = 300.0  # ref: hadoop.security.groups.cache.secs default


class Groups:
    def __init__(self, conf=None):
        self._static: Dict[str, List[str]] = {}
        raw = conf.get(STATIC_MAPPING_KEY, "") if conf is not None else ""
        for pair in raw.split(";"):
            user, _, gl = pair.strip().partition("=")
            if user and gl:
                self._static[user.strip()] = [
                    g.strip() for g in gl.split(",") if g.strip()]
        self._cache: Dict[str, tuple] = {}
        self._lock = threading.Lock()

    def groups_for(self, user: str) -> List[str]:
        static = self._static.get(user)
        if static is not None:
            return list(static)
        now = time.monotonic()
        with self._lock:
            hit = self._cache.get(user)
            if hit and now - hit[1] < CACHE_TTL_S:
                return list(hit[0])
        groups = self._os_groups(user)
        with self._lock:
            self._cache[user] = (groups, now)
        return list(groups)

    @staticmethod
    def _os_groups(user: str) -> List[str]:
        try:
            import grp
            import pwd
            pw = pwd.getpwnam(user)
            primary = grp.getgrgid(pw.pw_gid).gr_name
            out = [primary]
            for g in grp.getgrall():
                if user in g.gr_mem and g.gr_name != primary:
                    out.append(g.gr_name)
            return out
        except (KeyError, ImportError, OSError):
            return []
