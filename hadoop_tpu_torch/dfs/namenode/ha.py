"""NameNode HA states and the RPC gate.

The port's copy of the states and ``check_operation`` of
``hadoop_tpu/dfs/namenode/ha.py``: ``active`` serves everything and
writes the journal; ``standby`` rejects client ops (``StandbyError``, so
a client fails over); ``observer`` serves reads as well. The port's
NameNode runs single and active. The tailer, the standby checkpointer
and the failover controller, with the quorum journal they ride, are
ROADMAP Queue A 10 part 2 (``PART2``).
"""

from __future__ import annotations

from hadoop_tpu_torch.ipc.errors import StandbyError

ACTIVE = "active"
STANDBY = "standby"
OBSERVER = "observer"

PART2 = "ROADMAP Queue A 10 part 2"


def refuse(what: str) -> NotImplementedError:
    """The error for an HA piece the port does not have yet."""
    return NotImplementedError(f"{what} is not in the port yet: {PART2}")


def check_operation(ha_state: str, is_write: bool) -> None:
    """Gate an RPC by HA state (ref: NameNode.checkOperation)."""
    if ha_state == ACTIVE:
        return
    if ha_state == OBSERVER and not is_write:
        return
    raise StandbyError(
        f"Operation category {'WRITE' if is_write else 'READ'} is not "
        f"supported in state {ha_state}")
