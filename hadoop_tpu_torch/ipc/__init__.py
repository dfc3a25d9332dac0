"""The port's RPC plane: the client (``client``, ``rpc``) and the server
(``server``, with the call queues of ``callqueue``), on the reference's
``ipc`` wire."""

from hadoop_tpu_torch.ipc.client import Client
from hadoop_tpu_torch.ipc.errors import (RemoteError, RpcError,
                                         RpcTimeoutError, register_exception,
                                         resolve_exception)
from hadoop_tpu_torch.ipc.rpc import (get_proxy, idempotent, stop_proxy,
                                      wait_for_proxy)
from hadoop_tpu_torch.ipc.server import CallContext, Server, current_call

__all__ = ["Client", "get_proxy", "wait_for_proxy", "stop_proxy",
           "idempotent", "RemoteError", "RpcError", "RpcTimeoutError",
           "register_exception", "resolve_exception", "Server",
           "CallContext", "current_call"]
