"""Kafka API message definitions.

Version-gated field tables for every API the broker serves — the runtime
analogue of the reference's kafka/protocol/schemata/*.json. Version ranges
match the reference snapshot's supported ranges where practical; flexible
versions are kept below the advertised max except where noted, since modern
clients negotiate down via ApiVersions.
"""

from __future__ import annotations

from redpanda_tpu_torch.kafka.protocol.schema import Api, Array, F, T

# ------------------------------------------------------------------ api keys
PRODUCE = 0
FETCH = 1
LIST_OFFSETS = 2
METADATA = 3
OFFSET_COMMIT = 8
OFFSET_FETCH = 9
FIND_COORDINATOR = 10
JOIN_GROUP = 11
HEARTBEAT = 12
LEAVE_GROUP = 13
SYNC_GROUP = 14
DESCRIBE_GROUPS = 15
LIST_GROUPS = 16
SASL_HANDSHAKE = 17
API_VERSIONS = 18
CREATE_TOPICS = 19
DELETE_TOPICS = 20
DELETE_RECORDS = 21
INIT_PRODUCER_ID = 22
ADD_PARTITIONS_TO_TXN = 24
ADD_OFFSETS_TO_TXN = 25
END_TXN = 26
TXN_OFFSET_COMMIT = 28
DESCRIBE_ACLS = 29
CREATE_ACLS = 30
DELETE_ACLS = 31
DESCRIBE_CONFIGS = 32
ALTER_CONFIGS = 33
DESCRIBE_LOG_DIRS = 35
SASL_AUTHENTICATE = 36
CREATE_PARTITIONS = 37
DELETE_GROUPS = 42
INCREMENTAL_ALTER_CONFIGS = 44


def _api(key, name, min_v, max_v, request, response, flexible_since=None) -> Api:
    return Api(key, name, min_v, max_v, tuple(request), tuple(response), flexible_since)


APIS: dict[int, Api] = {}


def _register(api: Api) -> Api:
    APIS[api.key] = api
    return APIS[api.key]


# ------------------------------------------------------------------ produce
produce = _register(_api(
    PRODUCE, "produce", 0, 8,
    request=[
        F("transactional_id", T.NULLABLE_STRING, min_v=3),
        F("acks", T.INT16),
        F("timeout_ms", T.INT32),
        F("topics", Array((
            F("name", T.STRING),
            F("partitions", Array((
                F("partition_index", T.INT32),
                F("records", T.RECORDS),
            ))),
        ))),
    ],
    response=[
        F("responses", Array((
            F("name", T.STRING),
            F("partitions", Array((
                F("partition_index", T.INT32),
                F("error_code", T.INT16),
                F("base_offset", T.INT64),
                F("log_append_time_ms", T.INT64, min_v=2, default=-1),
                F("log_start_offset", T.INT64, min_v=5),
                F("record_errors", Array((
                    F("batch_index", T.INT32),
                    F("batch_index_error_message", T.NULLABLE_STRING),
                )), min_v=8),
                F("error_message", T.NULLABLE_STRING, min_v=8),
            ))),
        ))),
        F("throttle_time_ms", T.INT32, min_v=1),
    ],
))

# ------------------------------------------------------------------ fetch
fetch = _register(_api(
    FETCH, "fetch", 0, 11,
    request=[
        F("replica_id", T.INT32, default=-1),
        F("max_wait_ms", T.INT32),
        F("min_bytes", T.INT32),
        F("max_bytes", T.INT32, min_v=3, default=0x7FFFFFFF),
        F("isolation_level", T.INT8, min_v=4),
        F("session_id", T.INT32, min_v=7),
        F("session_epoch", T.INT32, min_v=7, default=-1),
        F("topics", Array((
            F("name", T.STRING),
            F("partitions", Array((
                F("partition_index", T.INT32),
                F("current_leader_epoch", T.INT32, min_v=9, default=-1),
                F("fetch_offset", T.INT64),
                F("log_start_offset", T.INT64, min_v=5, default=-1),
                F("partition_max_bytes", T.INT32),
            ))),
        ))),
        F("forgotten_topics_data", Array((
            F("name", T.STRING),
            F("partitions", Array(T.INT32)),
        )), min_v=7),
        F("rack_id", T.STRING, min_v=11, default=""),
    ],
    response=[
        F("throttle_time_ms", T.INT32, min_v=1),
        F("error_code", T.INT16, min_v=7),
        F("session_id", T.INT32, min_v=7),
        F("responses", Array((
            F("name", T.STRING),
            F("partitions", Array((
                F("partition_index", T.INT32),
                F("error_code", T.INT16),
                F("high_watermark", T.INT64),
                F("last_stable_offset", T.INT64, min_v=4, default=-1),
                F("log_start_offset", T.INT64, min_v=5, default=-1),
                F("aborted_transactions", Array((
                    F("producer_id", T.INT64),
                    F("first_offset", T.INT64),
                ), nullable=True), min_v=4),
                F("preferred_read_replica", T.INT32, min_v=11, default=-1),
                F("records", T.RECORDS),
            ))),
        ))),
    ],
))

# ------------------------------------------------------------------ list_offsets
list_offsets = _register(_api(
    LIST_OFFSETS, "list_offsets", 0, 5,
    request=[
        F("replica_id", T.INT32, default=-1),
        F("isolation_level", T.INT8, min_v=2),
        F("topics", Array((
            F("name", T.STRING),
            F("partitions", Array((
                F("partition_index", T.INT32),
                F("current_leader_epoch", T.INT32, min_v=4, default=-1),
                F("timestamp", T.INT64),
                F("max_num_offsets", T.INT32, max_v=0, default=1),
            ))),
        ))),
    ],
    response=[
        F("throttle_time_ms", T.INT32, min_v=2),
        F("topics", Array((
            F("name", T.STRING),
            F("partitions", Array((
                F("partition_index", T.INT32),
                F("error_code", T.INT16),
                F("old_style_offsets", Array(T.INT64), max_v=0),
                F("timestamp", T.INT64, min_v=1, default=-1),
                F("offset", T.INT64, min_v=1, default=-1),
                F("leader_epoch", T.INT32, min_v=4, default=-1),
            ))),
        ))),
    ],
))

# ------------------------------------------------------------------ metadata
metadata = _register(_api(
    METADATA, "metadata", 0, 9, flexible_since=9,
    request=[
        F("topics", Array((
            F("name", T.STRING),
        ), nullable=True)),
        F("allow_auto_topic_creation", T.BOOL, min_v=4, default=True),
        F("include_cluster_authorized_operations", T.BOOL, min_v=8),
        F("include_topic_authorized_operations", T.BOOL, min_v=8),
    ],
    response=[
        F("throttle_time_ms", T.INT32, min_v=3),
        F("brokers", Array((
            F("node_id", T.INT32),
            F("host", T.STRING),
            F("port", T.INT32),
            F("rack", T.NULLABLE_STRING, min_v=1),
        ))),
        F("cluster_id", T.NULLABLE_STRING, min_v=2),
        F("controller_id", T.INT32, min_v=1, default=-1),
        F("topics", Array((
            F("error_code", T.INT16),
            F("name", T.STRING),
            F("is_internal", T.BOOL, min_v=1),
            F("partitions", Array((
                F("error_code", T.INT16),
                F("partition_index", T.INT32),
                F("leader_id", T.INT32),
                F("leader_epoch", T.INT32, min_v=7, default=-1),
                F("replica_nodes", Array(T.INT32)),
                F("isr_nodes", Array(T.INT32)),
                F("offline_replicas", Array(T.INT32), min_v=5),
            ))),
            F("topic_authorized_operations", T.INT32, min_v=8, default=-2147483648),
        ))),
        F("cluster_authorized_operations", T.INT32, min_v=8, default=-2147483648),
    ],
))

# ------------------------------------------------------------------ offset_commit
offset_commit = _register(_api(
    OFFSET_COMMIT, "offset_commit", 0, 8, flexible_since=8,
    request=[
        F("group_id", T.STRING),
        F("generation_id", T.INT32, min_v=1, default=-1),
        F("member_id", T.STRING, min_v=1, default=""),
        F("group_instance_id", T.NULLABLE_STRING, min_v=7),
        F("retention_time_ms", T.INT64, min_v=2, max_v=4, default=-1),
        F("topics", Array((
            F("name", T.STRING),
            F("partitions", Array((
                F("partition_index", T.INT32),
                F("committed_offset", T.INT64),
                F("commit_timestamp", T.INT64, min_v=1, max_v=1, default=-1),
                F("committed_leader_epoch", T.INT32, min_v=6, default=-1),
                F("committed_metadata", T.NULLABLE_STRING),
            ))),
        ))),
    ],
    response=[
        F("throttle_time_ms", T.INT32, min_v=3),
        F("topics", Array((
            F("name", T.STRING),
            F("partitions", Array((
                F("partition_index", T.INT32),
                F("error_code", T.INT16),
            ))),
        ))),
    ],
))

# ------------------------------------------------------------------ offset_fetch
offset_fetch = _register(_api(
    OFFSET_FETCH, "offset_fetch", 0, 6, flexible_since=6,
    request=[
        F("group_id", T.STRING),
        F("topics", Array((
            F("name", T.STRING),
            F("partition_indexes", Array(T.INT32)),
        ), nullable=True)),
    ],
    response=[
        F("throttle_time_ms", T.INT32, min_v=3),
        F("topics", Array((
            F("name", T.STRING),
            F("partitions", Array((
                F("partition_index", T.INT32),
                F("committed_offset", T.INT64),
                F("committed_leader_epoch", T.INT32, min_v=5, default=-1),
                F("metadata", T.NULLABLE_STRING),
                F("error_code", T.INT16),
            ))),
        ))),
        F("error_code", T.INT16, min_v=2),
    ],
))

# ------------------------------------------------------------------ find_coordinator
find_coordinator = _register(_api(
    FIND_COORDINATOR, "find_coordinator", 0, 3, flexible_since=3,
    request=[
        F("key", T.STRING),
        F("key_type", T.INT8, min_v=1),
    ],
    response=[
        F("throttle_time_ms", T.INT32, min_v=1),
        F("error_code", T.INT16),
        F("error_message", T.NULLABLE_STRING, min_v=1),
        F("node_id", T.INT32),
        F("host", T.STRING),
        F("port", T.INT32),
    ],
))

# ------------------------------------------------------------------ group membership
join_group = _register(_api(
    JOIN_GROUP, "join_group", 0, 6, flexible_since=6,
    request=[
        F("group_id", T.STRING),
        F("session_timeout_ms", T.INT32),
        F("rebalance_timeout_ms", T.INT32, min_v=1, default=-1),
        F("member_id", T.STRING),
        F("group_instance_id", T.NULLABLE_STRING, min_v=5),
        F("protocol_type", T.STRING),
        F("protocols", Array((
            F("name", T.STRING),
            F("metadata", T.BYTES),
        ))),
    ],
    response=[
        F("throttle_time_ms", T.INT32, min_v=2),
        F("error_code", T.INT16),
        F("generation_id", T.INT32, default=-1),
        F("protocol_name", T.STRING),
        F("leader", T.STRING),
        F("member_id", T.STRING),
        F("members", Array((
            F("member_id", T.STRING),
            F("group_instance_id", T.NULLABLE_STRING, min_v=5),
            F("metadata", T.BYTES),
        ))),
    ],
))

heartbeat = _register(_api(
    HEARTBEAT, "heartbeat", 0, 4, flexible_since=4,
    request=[
        F("group_id", T.STRING),
        F("generation_id", T.INT32),
        F("member_id", T.STRING),
        F("group_instance_id", T.NULLABLE_STRING, min_v=3),
    ],
    response=[
        F("throttle_time_ms", T.INT32, min_v=1),
        F("error_code", T.INT16),
    ],
))

leave_group = _register(_api(
    LEAVE_GROUP, "leave_group", 0, 4, flexible_since=4,
    request=[
        F("group_id", T.STRING),
        F("member_id", T.STRING, max_v=2),
        F("members", Array((
            F("member_id", T.STRING),
            F("group_instance_id", T.NULLABLE_STRING),
        )), min_v=3),
    ],
    response=[
        F("throttle_time_ms", T.INT32, min_v=1),
        F("error_code", T.INT16),
        F("members", Array((
            F("member_id", T.STRING),
            F("group_instance_id", T.NULLABLE_STRING),
            F("error_code", T.INT16),
        )), min_v=3),
    ],
))

sync_group = _register(_api(
    SYNC_GROUP, "sync_group", 0, 4, flexible_since=4,
    request=[
        F("group_id", T.STRING),
        F("generation_id", T.INT32),
        F("member_id", T.STRING),
        F("group_instance_id", T.NULLABLE_STRING, min_v=3),
        F("assignments", Array((
            F("member_id", T.STRING),
            F("assignment", T.BYTES),
        ))),
    ],
    response=[
        F("throttle_time_ms", T.INT32, min_v=1),
        F("error_code", T.INT16),
        F("assignment", T.BYTES),
    ],
))

describe_groups = _register(_api(
    DESCRIBE_GROUPS, "describe_groups", 0, 5, flexible_since=5,
    request=[
        F("groups", Array(T.STRING)),
        F("include_authorized_operations", T.BOOL, min_v=3),
    ],
    response=[
        F("throttle_time_ms", T.INT32, min_v=1),
        F("groups", Array((
            F("error_code", T.INT16),
            F("group_id", T.STRING),
            F("group_state", T.STRING),
            F("protocol_type", T.STRING),
            F("protocol_data", T.STRING),
            F("members", Array((
                F("member_id", T.STRING),
                F("group_instance_id", T.NULLABLE_STRING, min_v=4),
                F("client_id", T.STRING),
                F("client_host", T.STRING),
                F("member_metadata", T.BYTES),
                F("member_assignment", T.BYTES),
            ))),
            F("authorized_operations", T.INT32, min_v=3, default=-2147483648),
        ))),
    ],
))

list_groups = _register(_api(
    LIST_GROUPS, "list_groups", 0, 3, flexible_since=3,
    request=[],
    response=[
        F("throttle_time_ms", T.INT32, min_v=1),
        F("error_code", T.INT16),
        F("groups", Array((
            F("group_id", T.STRING),
            F("protocol_type", T.STRING),
        ))),
    ],
))

delete_groups = _register(_api(
    DELETE_GROUPS, "delete_groups", 0, 2, flexible_since=2,
    request=[
        F("groups_names", Array(T.STRING)),
    ],
    response=[
        F("throttle_time_ms", T.INT32),
        F("results", Array((
            F("group_id", T.STRING),
            F("error_code", T.INT16),
        ))),
    ],
))

# ------------------------------------------------------------------ sasl
sasl_handshake = _register(_api(
    SASL_HANDSHAKE, "sasl_handshake", 0, 1,
    request=[F("mechanism", T.STRING)],
    response=[
        F("error_code", T.INT16),
        F("mechanisms", Array(T.STRING)),
    ],
))

sasl_authenticate = _register(_api(
    SASL_AUTHENTICATE, "sasl_authenticate", 0, 1,
    request=[F("auth_bytes", T.BYTES)],
    response=[
        F("error_code", T.INT16),
        F("error_message", T.NULLABLE_STRING),
        F("auth_bytes", T.BYTES),
        F("session_lifetime_ms", T.INT64, min_v=1),
    ],
))

# ------------------------------------------------------------------ api_versions
api_versions = _register(_api(
    API_VERSIONS, "api_versions", 0, 3, flexible_since=3,
    request=[
        F("client_software_name", T.STRING, min_v=3),
        F("client_software_version", T.STRING, min_v=3),
    ],
    response=[
        F("error_code", T.INT16),
        F("api_keys", Array((
            F("api_key", T.INT16),
            F("min_version", T.INT16),
            F("max_version", T.INT16),
        ))),
        F("throttle_time_ms", T.INT32, min_v=1),
    ],
))

# ------------------------------------------------------------------ topic admin
create_topics = _register(_api(
    CREATE_TOPICS, "create_topics", 0, 5, flexible_since=5,
    request=[
        F("topics", Array((
            F("name", T.STRING),
            F("num_partitions", T.INT32),
            F("replication_factor", T.INT16),
            F("assignments", Array((
                F("partition_index", T.INT32),
                F("broker_ids", Array(T.INT32)),
            ))),
            F("configs", Array((
                F("name", T.STRING),
                F("value", T.NULLABLE_STRING),
            ))),
        ))),
        F("timeout_ms", T.INT32),
        F("validate_only", T.BOOL, min_v=1),
    ],
    response=[
        F("throttle_time_ms", T.INT32, min_v=2),
        F("topics", Array((
            F("name", T.STRING),
            F("error_code", T.INT16),
            F("error_message", T.NULLABLE_STRING, min_v=1),
            F("topic_config_error_code", T.INT16, min_v=5, tag=0),
            F("num_partitions", T.INT32, min_v=5, default=-1),
            F("replication_factor", T.INT16, min_v=5, default=-1),
            F("configs", Array((
                F("name", T.STRING),
                F("value", T.NULLABLE_STRING),
                F("read_only", T.BOOL),
                F("config_source", T.INT8, default=-1),
                F("is_sensitive", T.BOOL),
            ), nullable=True), min_v=5),
        ))),
    ],
))

delete_topics = _register(_api(
    DELETE_TOPICS, "delete_topics", 0, 4, flexible_since=4,
    request=[
        F("topic_names", Array(T.STRING)),
        F("timeout_ms", T.INT32),
    ],
    response=[
        F("throttle_time_ms", T.INT32, min_v=1),
        F("responses", Array((
            F("name", T.STRING),
            F("error_code", T.INT16),
        ))),
    ],
))

delete_records = _register(_api(
    DELETE_RECORDS, "delete_records", 0, 1,
    request=[
        F("topics", Array((
            F("name", T.STRING),
            F("partitions", Array((
                F("partition_index", T.INT32),
                F("offset", T.INT64),
            ))),
        ))),
        F("timeout_ms", T.INT32),
    ],
    response=[
        F("throttle_time_ms", T.INT32),
        F("topics", Array((
            F("name", T.STRING),
            F("partitions", Array((
                F("partition_index", T.INT32),
                F("low_watermark", T.INT64),
                F("error_code", T.INT16),
            ))),
        ))),
    ],
))

create_partitions = _register(_api(
    CREATE_PARTITIONS, "create_partitions", 0, 3, flexible_since=2,
    request=[
        F("topics", Array((
            F("name", T.STRING),
            F("count", T.INT32),
            F("assignments", Array((
                F("broker_ids", Array(T.INT32)),
            ), nullable=True)),
        ))),
        F("timeout_ms", T.INT32),
        F("validate_only", T.BOOL),
    ],
    response=[
        F("throttle_time_ms", T.INT32),
        F("results", Array((
            F("name", T.STRING),
            F("error_code", T.INT16),
            F("error_message", T.NULLABLE_STRING),
        ))),
    ],
))

# ------------------------------------------------------------------ configs
describe_configs = _register(_api(
    DESCRIBE_CONFIGS, "describe_configs", 0, 2,
    request=[
        F("resources", Array((
            F("resource_type", T.INT8),
            F("resource_name", T.STRING),
            F("configuration_keys", Array(T.STRING, nullable=True)),
        ))),
        F("include_synonyms", T.BOOL, min_v=1),
    ],
    response=[
        F("throttle_time_ms", T.INT32),
        F("results", Array((
            F("error_code", T.INT16),
            F("error_message", T.NULLABLE_STRING),
            F("resource_type", T.INT8),
            F("resource_name", T.STRING),
            F("configs", Array((
                F("name", T.STRING),
                F("value", T.NULLABLE_STRING),
                F("read_only", T.BOOL),
                F("is_default", T.BOOL, max_v=0),
                F("config_source", T.INT8, min_v=1, default=-1),
                F("is_sensitive", T.BOOL),
                F("synonyms", Array((
                    F("name", T.STRING),
                    F("value", T.NULLABLE_STRING),
                    F("source", T.INT8),
                )), min_v=1),
            ))),
        ))),
    ],
))

alter_configs = _register(_api(
    ALTER_CONFIGS, "alter_configs", 0, 1,
    request=[
        F("resources", Array((
            F("resource_type", T.INT8),
            F("resource_name", T.STRING),
            F("configs", Array((
                F("name", T.STRING),
                F("value", T.NULLABLE_STRING),
            ))),
        ))),
        F("validate_only", T.BOOL),
    ],
    response=[
        F("throttle_time_ms", T.INT32),
        F("responses", Array((
            F("error_code", T.INT16),
            F("error_message", T.NULLABLE_STRING),
            F("resource_type", T.INT8),
            F("resource_name", T.STRING),
        ))),
    ],
))

incremental_alter_configs = _register(_api(
    INCREMENTAL_ALTER_CONFIGS, "incremental_alter_configs", 0, 1, flexible_since=1,
    request=[
        F("resources", Array((
            F("resource_type", T.INT8),
            F("resource_name", T.STRING),
            F("configs", Array((
                F("name", T.STRING),
                F("config_operation", T.INT8),
                F("value", T.NULLABLE_STRING),
            ))),
        ))),
        F("validate_only", T.BOOL),
    ],
    response=[
        F("throttle_time_ms", T.INT32),
        F("responses", Array((
            F("error_code", T.INT16),
            F("error_message", T.NULLABLE_STRING),
            F("resource_type", T.INT8),
            F("resource_name", T.STRING),
        ))),
    ],
))

describe_log_dirs = _register(_api(
    DESCRIBE_LOG_DIRS, "describe_log_dirs", 0, 1,
    request=[
        F("topics", Array((
            F("topic", T.STRING),
            F("partitions", Array(T.INT32)),
        ), nullable=True)),
    ],
    response=[
        F("throttle_time_ms", T.INT32),
        F("results", Array((
            F("error_code", T.INT16),
            F("log_dir", T.STRING),
            F("topics", Array((
                F("name", T.STRING),
                F("partitions", Array((
                    F("partition_index", T.INT32),
                    F("partition_size", T.INT64),
                    F("offset_lag", T.INT64),
                    F("is_future_key", T.BOOL),
                ))),
            ))),
        ))),
    ],
))

# ------------------------------------------------------------------ acls
_ACL_FILTER_REQ = [
    F("resource_type_filter", T.INT8),
    F("resource_name_filter", T.NULLABLE_STRING),
    F("pattern_type_filter", T.INT8, min_v=1, default=3),
    F("principal_filter", T.NULLABLE_STRING),
    F("host_filter", T.NULLABLE_STRING),
    F("operation", T.INT8),
    F("permission_type", T.INT8),
]

describe_acls = _register(_api(
    DESCRIBE_ACLS, "describe_acls", 0, 1,
    request=list(_ACL_FILTER_REQ),
    response=[
        F("throttle_time_ms", T.INT32),
        F("error_code", T.INT16),
        F("error_message", T.NULLABLE_STRING),
        F("resources", Array((
            F("resource_type", T.INT8),
            F("resource_name", T.STRING),
            F("pattern_type", T.INT8, min_v=1, default=3),
            F("acls", Array((
                F("principal", T.STRING),
                F("host", T.STRING),
                F("operation", T.INT8),
                F("permission_type", T.INT8),
            ))),
        ))),
    ],
))

create_acls = _register(_api(
    CREATE_ACLS, "create_acls", 0, 1,
    request=[
        F("creations", Array((
            F("resource_type", T.INT8),
            F("resource_name", T.STRING),
            F("resource_pattern_type", T.INT8, min_v=1, default=3),
            F("principal", T.STRING),
            F("host", T.STRING),
            F("operation", T.INT8),
            F("permission_type", T.INT8),
        ))),
    ],
    response=[
        F("throttle_time_ms", T.INT32),
        F("results", Array((
            F("error_code", T.INT16),
            F("error_message", T.NULLABLE_STRING),
        ))),
    ],
))

delete_acls = _register(_api(
    DELETE_ACLS, "delete_acls", 0, 1,
    request=[
        F("filters", Array((
            F("resource_type_filter", T.INT8),
            F("resource_name_filter", T.NULLABLE_STRING),
            F("pattern_type_filter", T.INT8, min_v=1, default=3),
            F("principal_filter", T.NULLABLE_STRING),
            F("host_filter", T.NULLABLE_STRING),
            F("operation", T.INT8),
            F("permission_type", T.INT8),
        ))),
    ],
    response=[
        F("throttle_time_ms", T.INT32),
        F("filter_results", Array((
            F("error_code", T.INT16),
            F("error_message", T.NULLABLE_STRING),
            F("matching_acls", Array((
                F("error_code", T.INT16),
                F("error_message", T.NULLABLE_STRING),
                F("resource_type", T.INT8),
                F("resource_name", T.STRING),
                F("pattern_type", T.INT8, min_v=1, default=3),
                F("principal", T.STRING),
                F("host", T.STRING),
                F("operation", T.INT8),
                F("permission_type", T.INT8),
            ))),
        ))),
    ],
))

# ------------------------------------------------------------------ transactions
init_producer_id = _register(_api(
    INIT_PRODUCER_ID, "init_producer_id", 0, 2, flexible_since=2,
    request=[
        F("transactional_id", T.NULLABLE_STRING),
        F("transaction_timeout_ms", T.INT32),
    ],
    response=[
        F("throttle_time_ms", T.INT32),
        F("error_code", T.INT16),
        F("producer_id", T.INT64, default=-1),
        F("producer_epoch", T.INT16, default=-1),
    ],
))

add_partitions_to_txn = _register(_api(
    ADD_PARTITIONS_TO_TXN, "add_partitions_to_txn", 0, 3, flexible_since=3,
    request=[
        F("transactional_id", T.STRING),
        F("producer_id", T.INT64),
        F("producer_epoch", T.INT16),
        F("topics", Array((
            F("name", T.STRING),
            F("partitions", Array(T.INT32)),
        ))),
    ],
    response=[
        F("throttle_time_ms", T.INT32),
        F("results", Array((
            F("name", T.STRING),
            F("results", Array((
                F("partition_index", T.INT32),
                F("error_code", T.INT16),
            ))),
        ))),
    ],
))

add_offsets_to_txn = _register(_api(
    ADD_OFFSETS_TO_TXN, "add_offsets_to_txn", 0, 1,
    request=[
        F("transactional_id", T.STRING),
        F("producer_id", T.INT64),
        F("producer_epoch", T.INT16),
        F("group_id", T.STRING),
    ],
    response=[
        F("throttle_time_ms", T.INT32),
        F("error_code", T.INT16),
    ],
))

end_txn = _register(_api(
    END_TXN, "end_txn", 0, 3, flexible_since=3,
    request=[
        F("transactional_id", T.STRING),
        F("producer_id", T.INT64),
        F("producer_epoch", T.INT16),
        F("committed", T.BOOL),
    ],
    response=[
        F("throttle_time_ms", T.INT32),
        F("error_code", T.INT16),
    ],
))

txn_offset_commit = _register(_api(
    TXN_OFFSET_COMMIT, "txn_offset_commit", 0, 2,
    request=[
        F("transactional_id", T.STRING),
        F("group_id", T.STRING),
        F("producer_id", T.INT64),
        F("producer_epoch", T.INT16),
        F("topics", Array((
            F("name", T.STRING),
            F("partitions", Array((
                F("partition_index", T.INT32),
                F("committed_offset", T.INT64),
                F("committed_leader_epoch", T.INT32, min_v=2, default=-1),
                F("committed_metadata", T.NULLABLE_STRING),
            ))),
        ))),
    ],
    response=[
        F("throttle_time_ms", T.INT32),
        F("topics", Array((
            F("name", T.STRING),
            F("partitions", Array((
                F("partition_index", T.INT32),
                F("error_code", T.INT16),
            ))),
        ))),
    ],
))
