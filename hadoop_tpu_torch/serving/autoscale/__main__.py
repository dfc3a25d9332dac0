"""The autoscaler daemon.

    python -m hadoop_tpu_torch.serving.autoscale \
        --registry HOST:PORT --service NAME \
        [--rm HOST:PORT --app application_<ts>_<seq> [--component replica]] \
        [--http-port N] [--host H] [-D key=value ...]

The port's copy of ``hadoop_tpu/serving/autoscale/__main__.py``. Without
``--rm``/``--app`` the controller advises: it scrapes, decides, and
publishes what it would have done on ``/ws/v1/autoscaler`` and ``/prom``,
the dry run an operator watches before handing it the flex lever. With
them it flexes the service's component through the port's YARN
``ServiceClient``. The door is the port's chassis (``http/server.py``),
so ``/prom``, ``/jmx`` and the trace endpoints sit beside the status.
A usage error exits 2; SIGTERM or SIGINT stops it with 0.
"""

from __future__ import annotations

import logging
import signal
import sys
import threading
from typing import List, Optional

from hadoop_tpu_torch.conf import ConfLike, Configuration

log = logging.getLogger(__name__)

USAGE = ("usage: python -m hadoop_tpu_torch.serving.autoscale "
         "--registry HOST:PORT --service NAME [--rm HOST:PORT "
         "--app APP_ID [--component NAME]] [--http-port N] [--host H] "
         "[-D key=value ...]")


def autoscaler_main(argv: List[str],
                    conf: Optional[ConfLike] = None) -> int:
    from hadoop_tpu_torch.util.misc import parse_addr_list
    from hadoop_tpu_torch.http.server import HttpServer
    from hadoop_tpu_torch.serving.autoscale.controller import (
        Autoscaler, YarnServiceActuator)
    from hadoop_tpu_torch.yarn import ApplicationId

    conf = conf or Configuration()
    args = dict(registry=None, service="serving", rm=None, app=None,
                component="replica", http_port="0", host="127.0.0.1")
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "-D" and i + 1 < len(argv) and "=" in argv[i + 1]:
            key, _, val = argv[i + 1].partition("=")
            conf.set(key, val)
            i += 2
            continue
        if a.startswith("-D") and "=" in a:
            key, _, val = a[2:].partition("=")
            conf.set(key, val)
            i += 1
            continue
        key = a.lstrip("-").replace("-", "_")
        if key in args and i + 1 < len(argv):
            args[key] = argv[i + 1]
            i += 2
        else:
            print(f"unknown autoscale option {a}", file=sys.stderr)
            return 2
    if not args["registry"]:
        print(USAGE, file=sys.stderr)
        return 2
    try:
        registry_addr = parse_addr_list(args["registry"])[0]
        http_port = int(args["http_port"])
        rm_addr = parse_addr_list(args["rm"])[0] if args["rm"] else None
    except ValueError as e:
        print(f"autoscale: {e}", file=sys.stderr)
        return 2
    actuator = None
    if rm_addr is not None and args["app"]:
        try:  # application_<cluster_ts>_<seq>
            app_id = ApplicationId.parse(str(args["app"]))
        except ValueError:
            print(f"bad --app {args['app']!r} (want "
                  f"application_<ts>_<seq>)", file=sys.stderr)
            return 2
        actuator = YarnServiceActuator(
            rm_addr, app_id, component=str(args["component"]), conf=conf)
    scaler = Autoscaler(conf, registry_addr, str(args["service"]),
                        actuator=actuator)
    http = HttpServer(conf, (str(args["host"]), http_port),
                      daemon_name="autoscaler")
    http.add_handler("/ws/v1/autoscaler",
                     lambda q, b: (200, scaler.status()))
    http.start()
    scaler.start()
    log.info("autoscaler for %s up on :%d (%s mode)", args["service"],
             http.port, "flex" if actuator else "advise")
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    try:
        while not stop.wait(0.5):
            pass
    finally:
        scaler.stop()
        http.stop()
    return 0


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    sys.exit(autoscaler_main(sys.argv[1:]))
