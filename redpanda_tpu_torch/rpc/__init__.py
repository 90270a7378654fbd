"""Internal RPC stack (parity with src/v/rpc).

26-byte checksummed wire header, serde payloads, method-id dispatch with a
pluggable server protocol, reconnecting client transports, and a per-node
connection cache. Raft, the cluster control plane, and the coproc engine
speak this protocol between brokers.

(The JAX package's rpc/, copied.)
"""

from redpanda_tpu_torch.rpc.serde import (
    BOOL,
    BYTES,
    F64,
    I8,
    I16,
    I32,
    I64,
    STRING,
    U8,
    U16,
    U32,
    U64,
    Envelope,
    Map,
    Optional,
    S,
    Struct,
    Vector,
)
from redpanda_tpu_torch.rpc.server import Server, SimpleProtocol
from redpanda_tpu_torch.rpc.service import Client, MethodDef, ServiceDef, ServiceHandler
from redpanda_tpu_torch.rpc.transport import (
    BackoffPolicy,
    ConnectionCache,
    ReconnectTransport,
    RpcBackpressure,
    RpcError,
    Transport,
    TransportClosed,
)
from redpanda_tpu_torch.rpc.wire import Header, WireError

__all__ = [
    "BOOL", "BYTES", "F64", "I8", "I16", "I32", "I64", "STRING", "U8", "U16",
    "U32", "U64", "Envelope", "Map", "Optional", "S", "Struct", "Vector",
    "Server", "SimpleProtocol", "Client", "MethodDef", "ServiceDef",
    "ServiceHandler", "BackoffPolicy", "ConnectionCache", "ReconnectTransport",
    "RpcBackpressure", "RpcError", "Transport", "TransportClosed", "Header",
    "WireError",
]
