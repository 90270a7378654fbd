"""Security layer (the JAX package's security/, its ACL half).

Parity with src/v/security acl.h/acl_store/authorizer.h:39: resource
patterns, operations, the ACL store and the authorizer every Kafka handler
consults. SCRAM, the credential store, the replicated ``SecurityManager``
and TLS come with ROADMAP item 10d; until then this package exports only
what ``acl.py`` defines.
"""

from redpanda_tpu_torch.security.acl import (
    AclBinding,
    AclBindingFilter,
    AclEntry,
    AclOperation,
    AclPermission,
    AclStore,
    Authorizer,
    PatternType,
    ResourcePattern,
    ResourceType,
)

__all__ = [
    "AclBinding",
    "AclBindingFilter",
    "AclEntry",
    "AclOperation",
    "AclPermission",
    "AclStore",
    "Authorizer",
    "PatternType",
    "ResourcePattern",
    "ResourceType",
]
