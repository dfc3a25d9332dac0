"""The elastic training plane (the counterpart of
``hadoop_tpu/parallel/elastic/``): doctor-driven eviction and
reshard-on-restore.

- :mod:`hadoop_tpu_torch.parallel.elastic.reshard`: the manifest's plan
  block and the host-side conversions of ZeRO-1 moments between plan
  layouts, so a snapshot written under one plan restores into another.
- :mod:`hadoop_tpu_torch.parallel.elastic.controller`: polls the fleet
  doctor's trainer verdicts and, on a flagged or dead rank, writes a
  protective checkpoint (DEMOTE), picks the largest healthy sub-mesh
  (EVICT) and has the trainer rebuild and reshard-restore onto it
  (RESUME), with hysteresis.

Configuration keys (``ElasticConfig`` round-trips through
``dataclasses.asdict``, so every decision event carries the knobs that
made it):

==============================  =======  ==================================
key                             default  meaning
==============================  =======  ==================================
``elastic.enabled``             false    turn the controller on
``elastic.poll.steps``          20       trainer steps between doctor polls
``elastic.min-dp``              1        never shrink dp below this
``elastic.demote.windows``      2        consecutive flagged polls before a
                                         DEMOTE (protective checkpoint)
``elastic.evict.windows``       4        consecutive flagged polls before a
                                         slow rank is EVICTED
``elastic.dead.windows``        2        consecutive dead polls before a
                                         lost rank is evicted
``elastic.cooldown.polls``      3        polls ignored after a resume
                                         (hysteresis against thrash)
==============================  =======  ==================================
"""

from __future__ import annotations

import dataclasses

ELASTIC_KEY = "elastic.enabled"


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    """Static elastic-plane knobs, fixed when the trainer is built."""
    enabled: bool = False
    poll_steps: int = 20          # elastic.poll.steps
    min_dp: int = 1               # elastic.min-dp
    demote_windows: int = 2       # elastic.demote.windows
    evict_windows: int = 4        # elastic.evict.windows
    dead_windows: int = 2         # elastic.dead.windows
    cooldown_polls: int = 3       # elastic.cooldown.polls

    def __post_init__(self):
        if self.poll_steps < 1:
            raise ValueError("elastic.poll.steps must be >= 1, got "
                             f"{self.poll_steps}")
        if self.min_dp < 1:
            raise ValueError(f"elastic.min-dp must be >= 1, got "
                             f"{self.min_dp}")
        if self.demote_windows < 1 or self.evict_windows < 1 or \
                self.dead_windows < 1:
            raise ValueError("elastic window thresholds must be >= 1")
        if self.evict_windows <= self.demote_windows:
            raise ValueError(
                "elastic.evict.windows must exceed elastic.demote.windows "
                "(a demote must get its protective checkpoint in before "
                f"the evict fires): demote={self.demote_windows} "
                f"evict={self.evict_windows}")
        if self.cooldown_polls < 0:
            raise ValueError("elastic.cooldown.polls must be >= 0")


DEFAULT_ELASTIC = ElasticConfig()


def elastic_from_conf(conf) -> ElasticConfig:
    """An ElasticConfig from a configuration (the defaults above; None
    gives ``DEFAULT_ELASTIC``)."""
    if conf is None:
        return DEFAULT_ELASTIC
    return ElasticConfig(
        enabled=conf.get_bool(ELASTIC_KEY, False),
        poll_steps=conf.get_int("elastic.poll.steps", 20),
        min_dp=conf.get_int("elastic.min-dp", 1),
        demote_windows=conf.get_int("elastic.demote.windows", 2),
        evict_windows=conf.get_int("elastic.evict.windows", 4),
        dead_windows=conf.get_int("elastic.dead.windows", 2),
        cooldown_polls=conf.get_int("elastic.cooldown.polls", 3))


__all__ = ["ElasticConfig", "DEFAULT_ELASTIC", "ELASTIC_KEY",
           "elastic_from_conf"]
