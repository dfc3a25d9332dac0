"""Small host utilities the fleet daemons share.

The port's copy of the parts of ``hadoop_tpu/util/misc.py`` its daemons
use: :class:`Daemon` (a named daemon thread), :func:`parse_addr_list`
(``host:port,host:port``, strict about the port; the DFS client's
NameNode list, the doctor's, the autoscaler's command line),
:func:`free_port` (an ephemeral port, for ``spmd.launch``'s rendezvous)
and :func:`backoff_delay` (exponential backoff with jitter from the
process-wide :data:`RETRY_RNG`, which a test may seed; every retry of
the port's RPC layer and fleet daemons).
"""

from __future__ import annotations

import random
import socket
import threading
from typing import Callable, List, Tuple


class Daemon(threading.Thread):
    """Named daemon thread."""

    def __init__(self, target: Callable, name: str, args=(), kwargs=None):
        super().__init__(target=target, name=name, args=args,
                         kwargs=kwargs or {}, daemon=True)


def parse_addr_list(spec) -> List[Tuple[str, int]]:
    """A comma-separated ``host:port`` list as [(host, port)]; a missing
    or non-numeric port raises ``ValueError``, an empty host is
    127.0.0.1."""
    out = []
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        host, sep, port = part.rpartition(":")
        if not sep or not port.isdigit():
            raise ValueError(f"invalid host:port {part!r} in {spec!r}")
        out.append((host or "127.0.0.1", int(port)))
    return out


def free_port(host: str = "127.0.0.1") -> int:
    """An ephemeral port that was free when asked."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


# one generator for every retry's jitter, so a test can seed it
RETRY_RNG = random.Random()


def backoff_delay(base_s: float, attempt: int, max_s: float = 30.0,
                  rng=None) -> float:
    """Exponential backoff with jitter: ``base_s * 2**attempt``, capped at
    ``max_s``, times a factor in [0.5, 1.5), so a fleet of clients never
    retries in lockstep."""
    rng = RETRY_RNG if rng is None else rng
    return min(max_s, base_s * (2 ** attempt)) * (0.5 + rng.random())
