"""The port's RPC client (the reference's ``ipc`` protocol, client side
only: the port runs no RPC server)."""

from hadoop_tpu_torch.ipc.client import Client
from hadoop_tpu_torch.ipc.errors import (RemoteError, RpcError,
                                         RpcTimeoutError, register_exception,
                                         resolve_exception)
from hadoop_tpu_torch.ipc.rpc import (get_proxy, idempotent, stop_proxy,
                                      wait_for_proxy)

__all__ = ["Client", "get_proxy", "wait_for_proxy", "stop_proxy",
           "idempotent", "RemoteError", "RpcError", "RpcTimeoutError",
           "register_exception", "resolve_exception"]
