"""Kafka protocol error codes (parity with kafka/protocol/errors.h)."""

from __future__ import annotations

import enum


class ErrorCode(enum.IntEnum):
    unknown_server_error = -1
    none = 0
    offset_out_of_range = 1
    corrupt_message = 2
    unknown_topic_or_partition = 3
    invalid_fetch_size = 4
    leader_not_available = 5
    not_leader_for_partition = 6
    request_timed_out = 7
    broker_not_available = 8
    replica_not_available = 9
    message_too_large = 10
    stale_controller_epoch = 11
    offset_metadata_too_large = 12
    network_exception = 13
    coordinator_load_in_progress = 14
    coordinator_not_available = 15
    not_coordinator = 16
    invalid_topic_exception = 17
    record_list_too_large = 18
    not_enough_replicas = 19
    not_enough_replicas_after_append = 20
    invalid_required_acks = 21
    illegal_generation = 22
    inconsistent_group_protocol = 23
    invalid_group_id = 24
    unknown_member_id = 25
    invalid_session_timeout = 26
    rebalance_in_progress = 27
    invalid_commit_offset_size = 28
    topic_authorization_failed = 29
    group_authorization_failed = 30
    cluster_authorization_failed = 31
    invalid_timestamp = 32
    unsupported_sasl_mechanism = 33
    illegal_sasl_state = 34
    unsupported_version = 35
    topic_already_exists = 36
    invalid_partitions = 37
    invalid_replication_factor = 38
    invalid_replica_assignment = 39
    invalid_config = 40
    not_controller = 41
    invalid_request = 42
    unsupported_for_message_format = 43
    policy_violation = 44
    out_of_order_sequence_number = 45
    duplicate_sequence_number = 46
    invalid_producer_epoch = 47
    invalid_txn_state = 48
    invalid_producer_id_mapping = 49
    invalid_transaction_timeout = 50
    concurrent_transactions = 51
    transaction_coordinator_fenced = 52
    transactional_id_authorization_failed = 53
    security_disabled = 54
    operation_not_attempted = 55
    kafka_storage_error = 56
    log_dir_not_found = 57
    sasl_authentication_failed = 58
    unknown_producer_id = 59
    reassignment_in_progress = 60
    delegation_token_auth_disabled = 61
    delegation_token_not_found = 62
    delegation_token_owner_mismatch = 63
    delegation_token_request_not_allowed = 64
    delegation_token_authorization_failed = 65
    delegation_token_expired = 66
    invalid_principal_type = 67
    non_empty_group = 68
    group_id_not_found = 69
    fetch_session_id_not_found = 70
    invalid_fetch_session_epoch = 71
    listener_not_found = 72
    topic_deletion_disabled = 73
    fenced_leader_epoch = 74
    unknown_leader_epoch = 75
    unsupported_compression_type = 76
    stale_broker_epoch = 77
    offset_not_available = 78
    member_id_required = 79
    preferred_leader_not_available = 80
    group_max_size_reached = 81
    fenced_instance_id = 82
    invalid_record = 87
    unstable_offset_commit = 88
    # KIP-599; retriable — the broker-backpressure shed code the produce
    # admission gate answers with (resource_mgmt budget plane), paired
    # with a throttle_time_ms hint
    throttling_quota_exceeded = 89


class KafkaError(Exception):
    """Raised by handlers to short-circuit into an error response."""

    def __init__(self, code: ErrorCode, message: str = ""):
        super().__init__(f"{code.name}: {message}" if message else code.name)
        self.code = code
