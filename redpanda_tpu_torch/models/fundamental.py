"""Domain identifiers (parity with model/fundamental.h).

``NTP`` = {namespace, topic, partition} — the identity of one partitioned
log replica, used as the routing key everywhere (storage dirs, shard table,
raft groups, coproc inputs). Reference: model/fundamental.h:183.
"""

from __future__ import annotations

from dataclasses import dataclass

Offset = int
Term = int
NodeId = int

DEFAULT_NAMESPACE = "kafka"
INTERNAL_NAMESPACE = "redpanda"
COPROC_INTERNAL_TOPIC = "coprocessor_internal_topic"


@dataclass(frozen=True, order=True)
class NTP:
    ns: str
    topic: str
    partition: int

    def path(self) -> str:
        """Directory path fragment: <ns>/<topic>/<partition>."""
        return f"{self.ns}/{self.topic}/{self.partition}"

    def __str__(self) -> str:
        return f"{{{self.ns}/{self.topic}/{self.partition}}}"

    @staticmethod
    def kafka(topic: str, partition: int) -> "NTP":
        return NTP(DEFAULT_NAMESPACE, topic, partition)


@dataclass(frozen=True)
class MaterializedNTP:
    """A coproc materialized topic: `<source>.$<script>$` convention
    (parity with model::materialized_ntp)."""

    source: NTP
    script: str

    @property
    def ntp(self) -> NTP:
        return NTP(self.source.ns, f"{self.source.topic}.${self.script}$", self.source.partition)

    @staticmethod
    def parse(ntp: NTP) -> "MaterializedNTP | None":
        t = ntp.topic
        if t.endswith("$") and ".$" in t:
            src, script = t[:-1].rsplit(".$", 1)
            return MaterializedNTP(NTP(ntp.ns, src, ntp.partition), script)
        return None
