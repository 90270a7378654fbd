"""Controller command set.

Parity with cluster/commands.h:31-177: every cluster mutation is a typed
command serialized into a record batch and replicated through raft group 0;
each node's controller STM applies the command batch-type-by-batch-type
(mux_state_machine). The command carries everything needed for a
deterministic apply on every node — including allocated raft group ids —
so replicas never need to ask the leader anything while applying.

Encoding: record key = serde {type i8, version i8}, record value = JSON
payload (the reference uses adl-reflection on C++ structs; a schemaless
value keeps this layer flexible while the key stays binary-stable).

(The JAX package's cluster/commands.py, copied.)
"""

from __future__ import annotations

import enum
import json
from dataclasses import dataclass, field
from typing import Any

from redpanda_tpu_torch.models.fundamental import NTP, NodeId
from redpanda_tpu_torch.models.record import RecordBatch, RecordBatchType, Record
from redpanda_tpu_torch.rpc import serde


class CommandType(enum.IntEnum):
    """cluster/commands.h command ids (one enum across all batch types)."""

    # topic_management_cmd batches
    create_topic = 0
    delete_topic = 1
    update_topic_properties = 2
    move_partition_replicas = 3
    finish_moving_partition_replicas = 4
    create_partition = 5
    create_non_replicable_topic = 6
    # user_management_cmd batches
    create_user = 10
    delete_user = 11
    update_user = 12
    # acl_management_cmd batches
    create_acls = 13
    delete_acls = 14
    # data_policy_management_cmd batches
    create_data_policy = 15
    delete_data_policy = 16
    # node_management_cmd batches
    register_node = 17
    decommission_node = 18
    recommission_node = 19
    finish_reallocations = 20


# Which record-batch type each command travels in (mux STM routing key).
BATCH_TYPE_FOR = {
    CommandType.create_topic: RecordBatchType.topic_management_cmd,
    CommandType.delete_topic: RecordBatchType.topic_management_cmd,
    CommandType.update_topic_properties: RecordBatchType.topic_management_cmd,
    CommandType.move_partition_replicas: RecordBatchType.topic_management_cmd,
    CommandType.finish_moving_partition_replicas: RecordBatchType.topic_management_cmd,
    CommandType.create_partition: RecordBatchType.topic_management_cmd,
    CommandType.create_non_replicable_topic: RecordBatchType.topic_management_cmd,
    CommandType.create_user: RecordBatchType.user_management_cmd,
    CommandType.delete_user: RecordBatchType.user_management_cmd,
    CommandType.update_user: RecordBatchType.user_management_cmd,
    CommandType.create_acls: RecordBatchType.acl_management_cmd,
    CommandType.delete_acls: RecordBatchType.acl_management_cmd,
    CommandType.create_data_policy: RecordBatchType.data_policy_management_cmd,
    CommandType.delete_data_policy: RecordBatchType.data_policy_management_cmd,
    CommandType.register_node: RecordBatchType.node_management_cmd,
    CommandType.decommission_node: RecordBatchType.node_management_cmd,
    CommandType.recommission_node: RecordBatchType.node_management_cmd,
    CommandType.finish_reallocations: RecordBatchType.node_management_cmd,
}

_KEY = serde.S(("type", serde.I8), ("version", serde.I8))


@dataclass
class Command:
    type: CommandType
    data: dict[str, Any] = field(default_factory=dict)

    def to_batch(self) -> RecordBatch:
        key = _KEY.encode({"type": int(self.type), "version": 0})
        value = json.dumps(self.data, separators=(",", ":")).encode()
        return RecordBatch.build(
            [Record(key=key, value=value)], type=BATCH_TYPE_FOR[self.type]
        )

    @staticmethod
    def from_record(rec: Record) -> "Command":
        k = _KEY.decode(rec.key)
        data = json.loads(rec.value.decode()) if rec.value else {}
        return Command(CommandType(k["type"]), data)


# ---------------------------------------------------------------- payloads
# Helper constructors so frontends build well-formed payloads.

def assignment_payload(ntp: NTP, group: int, replicas: list[NodeId]) -> dict:
    return {
        "ns": ntp.ns,
        "topic": ntp.topic,
        "partition": ntp.partition,
        "group": group,
        "replicas": list(replicas),
    }


def create_topic_cmd(config_map: dict, assignments: list[dict]) -> Command:
    return Command(
        CommandType.create_topic,
        {"config": config_map, "assignments": assignments},
    )


def delete_topic_cmd(ns: str, topic: str) -> Command:
    return Command(CommandType.delete_topic, {"ns": ns, "topic": topic})


def create_partition_cmd(ns: str, topic: str, assignments: list[dict]) -> Command:
    return Command(
        CommandType.create_partition,
        {"ns": ns, "topic": topic, "assignments": assignments},
    )


def update_topic_properties_cmd(ns: str, topic: str, overrides: dict) -> Command:
    return Command(
        CommandType.update_topic_properties,
        {"ns": ns, "topic": topic, "overrides": overrides},
    )


def move_partition_replicas_cmd(ntp: NTP, replicas: list[NodeId]) -> Command:
    return Command(
        CommandType.move_partition_replicas,
        {"ns": ntp.ns, "topic": ntp.topic, "partition": ntp.partition,
         "replicas": list(replicas)},
    )


def finish_moving_cmd(ntp: NTP, replicas: list[NodeId]) -> Command:
    return Command(
        CommandType.finish_moving_partition_replicas,
        {"ns": ntp.ns, "topic": ntp.topic, "partition": ntp.partition,
         "replicas": list(replicas)},
    )


def create_non_replicable_topic_cmd(
    source_ns: str, source_topic: str, name: str
) -> Command:
    """Coproc materialized topic (commands.h create_non_replicable_topic)."""
    return Command(
        CommandType.create_non_replicable_topic,
        {"source_ns": source_ns, "source_topic": source_topic, "name": name},
    )


def register_node_cmd(
    node_id: NodeId, host: str, port: int, kafka_host: str, kafka_port: int,
    admin_port: int = 0,
) -> Command:
    """``admin_port`` (0 = not advertised) lets peers dial this node's
    admin API for the cluster observability plane — trace fan-out and
    /metrics federation; old replicated log entries simply lack the key
    and decode to 0 (admin-unreachable, a partial-merge degradation)."""
    return Command(
        CommandType.register_node,
        {"node_id": node_id, "host": host, "port": port,
         "kafka_host": kafka_host, "kafka_port": kafka_port,
         "admin_port": admin_port},
    )


def create_data_policy_cmd(topic: str, name: str, spec_json: str) -> Command:
    """Per-topic fetch-path transform policy (commands.h:152-162
    create_data_policy_cmd; the v8 function name + script become a
    TransformSpec here)."""
    return Command(
        CommandType.create_data_policy,
        {"topic": topic, "name": name, "spec": spec_json},
    )


def delete_data_policy_cmd(topic: str) -> Command:
    return Command(CommandType.delete_data_policy, {"topic": topic})


def decommission_node_cmd(node_id: NodeId) -> Command:
    return Command(CommandType.decommission_node, {"node_id": node_id})


def recommission_node_cmd(node_id: NodeId) -> Command:
    return Command(CommandType.recommission_node, {"node_id": node_id})
