"""Kafka-model ACLs + authorizer (the JAX package's security/acl.py).

Parity with security/acl.h (resource patterns, operations, permission
types), acl_store, and authorizer.h:39 — the authorizer is consulted by
every kafka handler through the request context. Semantics follow Kafka:
DENY wins over ALLOW, absence of any matching ALLOW denies, superusers
bypass, and READ/WRITE/DELETE/ALTER imply DESCRIBE (ALTER_CONFIGS implies
DESCRIBE_CONFIGS).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class ResourceType(enum.IntEnum):
    # kafka wire values (AclBinding resourceType)
    any = 1
    topic = 2
    group = 3
    cluster = 4
    transactional_id = 5


class PatternType(enum.IntEnum):
    any = 1
    match = 2
    literal = 3
    prefixed = 4


class AclOperation(enum.IntEnum):
    any = 1
    all = 2
    read = 3
    write = 4
    create = 5
    delete = 6
    alter = 7
    describe = 8
    cluster_action = 9
    describe_configs = 10
    alter_configs = 11
    idempotent_write = 12


class AclPermission(enum.IntEnum):
    any = 1
    deny = 2
    allow = 3


WILDCARD = "*"
DEFAULT_CLUSTER_NAME = "kafka-cluster"


@dataclass(frozen=True)
class ResourcePattern:
    resource_type: ResourceType
    name: str
    pattern_type: PatternType = PatternType.literal

    def matches(self, resource_type: ResourceType, name: str) -> bool:
        if self.resource_type != resource_type:
            return False
        if self.pattern_type == PatternType.literal:
            return self.name == name or self.name == WILDCARD
        if self.pattern_type == PatternType.prefixed:
            return name.startswith(self.name)
        return False


@dataclass(frozen=True)
class AclEntry:
    principal: str  # "User:<name>" or "User:*"
    host: str  # "*" or exact
    operation: AclOperation
    permission: AclPermission

    def matches(self, principal: str, host: str, operation: AclOperation) -> bool:
        if self.principal not in (principal, "User:*", WILDCARD):
            return False
        if self.host not in (host, WILDCARD):
            return False
        if self.operation == AclOperation.all:
            return True
        if self.operation == operation:
            return True
        # implied describes
        if operation == AclOperation.describe and self.operation in (
            AclOperation.read, AclOperation.write, AclOperation.delete, AclOperation.alter,
        ):
            return True
        if operation == AclOperation.describe_configs and self.operation == AclOperation.alter_configs:
            return True
        return False


@dataclass(frozen=True)
class AclBinding:
    pattern: ResourcePattern
    entry: AclEntry

    def to_dict(self) -> dict:
        return {
            "rt": int(self.pattern.resource_type),
            "rn": self.pattern.name,
            "pt": int(self.pattern.pattern_type),
            "principal": self.entry.principal,
            "host": self.entry.host,
            "op": int(self.entry.operation),
            "perm": int(self.entry.permission),
        }

    @staticmethod
    def from_dict(d: dict) -> "AclBinding":
        return AclBinding(
            ResourcePattern(ResourceType(d["rt"]), d["rn"], PatternType(d["pt"])),
            AclEntry(d["principal"], d["host"], AclOperation(d["op"]), AclPermission(d["perm"])),
        )


@dataclass(frozen=True)
class AclBindingFilter:
    """Filter for describe/delete (acl.h acl_binding_filter): `any` wildcards."""

    resource_type: ResourceType = ResourceType.any
    name: str | None = None
    pattern_type: PatternType = PatternType.any
    principal: str | None = None
    host: str | None = None
    operation: AclOperation = AclOperation.any
    permission: AclPermission = AclPermission.any

    def matches(self, b: AclBinding) -> bool:
        if self.resource_type != ResourceType.any and b.pattern.resource_type != self.resource_type:
            return False
        if self.name is not None and b.pattern.name != self.name:
            return False
        if self.pattern_type not in (PatternType.any, PatternType.match) and b.pattern.pattern_type != self.pattern_type:
            return False
        if self.principal is not None and b.entry.principal != self.principal:
            return False
        if self.host is not None and b.entry.host != self.host:
            return False
        if self.operation != AclOperation.any and b.entry.operation != self.operation:
            return False
        if self.permission != AclPermission.any and b.entry.permission != self.permission:
            return False
        return True


class AclStore:
    def __init__(self) -> None:
        self._bindings: set[AclBinding] = set()

    def add(self, bindings: list[AclBinding]) -> None:
        self._bindings.update(bindings)

    def remove(self, filters: list[AclBindingFilter]) -> list[AclBinding]:
        removed = [b for b in self._bindings if any(f.matches(b) for f in filters)]
        self._bindings.difference_update(removed)
        return removed

    def describe(self, flt: AclBindingFilter) -> list[AclBinding]:
        return [b for b in self._bindings if flt.matches(b)]

    def all_bindings(self) -> list[AclBinding]:
        return list(self._bindings)


class Authorizer:
    """authorizer.h:39: deny > allow > implicit-deny, superuser bypass.

    An empty ACL store authorizes everything (the reference boots open until
    ACLs exist and kafka_enable_authorization is effectively off; tests and
    single-user dev clusters rely on this)."""

    def __init__(self, store: AclStore, superusers: set[str] | None = None, *, allow_empty: bool = True) -> None:
        self.store = store
        self.superusers = {f"User:{u}" if not u.startswith("User:") else u for u in (superusers or set())}
        self.allow_empty = allow_empty

    def authorized(
        self,
        resource_type: ResourceType,
        resource_name: str,
        operation: AclOperation,
        principal: str | None,
        host: str = WILDCARD,
    ) -> bool:
        principal = principal or "User:anonymous"
        if not principal.startswith("User:"):
            principal = f"User:{principal}"
        if principal in self.superusers:
            return True
        bindings = [
            b for b in self.store.all_bindings()
            if b.pattern.matches(resource_type, resource_name)
        ]
        if not bindings:
            return self.allow_empty and not self.store.all_bindings()
        matching = [b for b in bindings if b.entry.matches(principal, host, operation)]
        if any(b.entry.permission == AclPermission.deny for b in matching):
            return False
        return any(b.entry.permission == AclPermission.allow for b in matching)
