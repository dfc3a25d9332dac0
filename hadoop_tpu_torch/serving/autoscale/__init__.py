"""The SLO-driven autoscaler of a serving fleet.

The port's copy of ``hadoop_tpu/serving/autoscale``: the registry gives
the members (with heartbeat staleness), each replica's ``/v1/health``
and ``/prom`` give the signals (TTFT p99 over a sliding window, queue
depth, prefill backlog, utilization, QoS sheds), and a
``FleetActuator`` moves the fleet (YARN ``flex`` through the port's
``ServiceClient``, or advice only).

    signals.py     prom parsing, windowed histogram quantiles, the
                   per-poll FleetSnapshot
    controller.py  the Autoscaler: hysteresis and cooldown, cold-start-
                   aware growth, role-aware pools, drain-aware shrink
    __main__.py    the daemon, alone or as the YARN service component
                   ``serving.service.autoscaler_service_spec`` launches
"""

from hadoop_tpu_torch.serving.autoscale.controller import (
    AdviseOnlyActuator, Autoscaler, FleetActuator, ScaleDecision,
    YarnServiceActuator)
from hadoop_tpu_torch.serving.autoscale.signals import (FleetScraper,
                                                        FleetSnapshot,
                                                        ReplicaSample,
                                                        histogram_p99,
                                                        parse_prom)

__all__ = [
    "Autoscaler", "FleetActuator", "AdviseOnlyActuator",
    "YarnServiceActuator", "ScaleDecision",
    "FleetScraper", "FleetSnapshot", "ReplicaSample",
    "parse_prom", "histogram_p99",
]
