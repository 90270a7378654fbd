"""Kafka request authorization (the JAX package's
kafka/server/security_handlers.py, its ``authorize`` helper).

Parity with request_context.h authorized(): every data-path handler asks
through its request context whether the connection's principal may perform
an operation. The SASL handshake/authenticate and ACL CRUD handlers of the
reference's file come with SCRAM and the replicated security manager
(ROADMAP item 10d).
"""

from __future__ import annotations

from redpanda_tpu_torch.security.acl import (
    AclOperation,
    ResourceType,
    DEFAULT_CLUSTER_NAME,
)

__all__ = ["DEFAULT_CLUSTER_NAME", "authorize"]


def authorize(ctx, resource_type: ResourceType, name: str, op: AclOperation) -> bool:
    """True when the connection's principal may perform op; open when no
    authorizer is wired (single-node dev mode). The client's peer address
    feeds host-scoped ACL entries (request_context.h passes the connection
    address the same way)."""
    az = ctx.broker.authorizer
    if az is None:
        return True
    return az.authorized(
        resource_type, name, op,
        ctx.connection.authenticated_principal,
        host=ctx.connection.client_host,
    )
