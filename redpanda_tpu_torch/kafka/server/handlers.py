"""Kafka API handlers (the JAX package's kafka/server/handlers.py).

Parity with kafka/server/handlers/ (one file per API in the reference; here
one function per API, registered in ``build_dispatch_table`` — the analogue
of process_request's dispatch table, requests.cc:216).

Group/txn/sasl handlers are registered by their subsystems when those are
wired onto the broker (group coordinator, tx coordinator, security), so this
module only covers the data-plane + topic-admin APIs.

Two kernels sit on these paths, on the broker's device: every produce
request's v2 batches of one partition are CRC-checked in one call of the
process-wide ``CrcBackend`` (K6 on the card when it is the device backend),
and a fetch of a topic with a data policy runs the broker's
``PolicyEngine`` (K4 for 256 records or more).
"""

from __future__ import annotations

import asyncio
import time

from redpanda_tpu_torch.kafka.protocol import messages as m
from redpanda_tpu_torch.kafka.protocol.batch import decode_wire_batches, encode_wire_batches
from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode
from redpanda_tpu_torch.cluster.partition import ConsistencyLevel
from redpanda_tpu_torch.cluster.topic_table import TopicConfig
from redpanda_tpu_torch.observability.trace import tracer
from redpanda_tpu_torch.security.acl import AclOperation, ResourceType

E = ErrorCode


def _authorized(ctx, op: AclOperation, topic: str) -> bool:
    from redpanda_tpu_torch.kafka.server.security_handlers import authorize

    return authorize(ctx, ResourceType.topic, topic, op)


# KIP-430: ops enumerable per resource type in authorized_operations
# bitfields (bit index = the AclOperation wire code).
_TOPIC_OPS = (
    AclOperation.read, AclOperation.write, AclOperation.create,
    AclOperation.delete, AclOperation.alter, AclOperation.describe,
    AclOperation.describe_configs, AclOperation.alter_configs,
)
_CLUSTER_OPS = (
    AclOperation.create, AclOperation.cluster_action, AclOperation.alter,
    AclOperation.describe, AclOperation.describe_configs,
    AclOperation.alter_configs, AclOperation.idempotent_write,
)
_GROUP_OPS = (AclOperation.read, AclOperation.delete, AclOperation.describe)


def authorized_operations(ctx, resource_type: ResourceType, name: str) -> int:
    """Bitfield of operations the connection's principal may perform on
    the resource (KIP-430; metadata v8+, describe_groups v3+)."""
    from redpanda_tpu_torch.kafka.server.security_handlers import authorize

    ops = {
        ResourceType.topic: _TOPIC_OPS,
        ResourceType.cluster: _CLUSTER_OPS,
        ResourceType.group: _GROUP_OPS,
    }[resource_type]
    bits = 0
    for op in ops:
        if authorize(ctx, resource_type, name, op):
            bits |= 1 << int(op)
    return bits


def build_dispatch_table() -> dict:
    return {
        m.API_VERSIONS: handle_api_versions,
        m.METADATA: handle_metadata,
        m.PRODUCE: handle_produce,
        m.FETCH: handle_fetch,
        m.LIST_OFFSETS: handle_list_offsets,
        m.CREATE_TOPICS: handle_create_topics,
        m.DELETE_TOPICS: handle_delete_topics,
        m.CREATE_PARTITIONS: handle_create_partitions,
        m.DELETE_RECORDS: handle_delete_records,
        m.DESCRIBE_CONFIGS: handle_describe_configs,
        m.ALTER_CONFIGS: handle_alter_configs,
        m.INCREMENTAL_ALTER_CONFIGS: handle_incremental_alter_configs,
        m.DESCRIBE_LOG_DIRS: handle_describe_log_dirs,
    }


# ---------------------------------------------------------------- api_versions
async def handle_api_versions(ctx) -> dict:
    return {
        "error_code": 0,
        "api_keys": [
            {"api_key": a.key, "min_version": a.min_version, "max_version": a.max_version}
            for a in sorted(m.APIS.values(), key=lambda a: a.key)
        ],
        "throttle_time_ms": 0,
    }


# ---------------------------------------------------------------- metadata
async def handle_metadata(ctx) -> dict:
    broker = ctx.broker
    cfg = broker.config
    requested = ctx.request.get("topics")
    names: list[str]
    if requested is None or (ctx.api_version == 0 and not requested):
        # full listing is filtered to what the principal may describe
        # (metadata.cc filters unauthorized topics out, no error entries)
        names = sorted(
            n for n in broker.topic_table.topics()
            if _authorized(ctx, AclOperation.describe, n)
        )
    else:
        names = [t["name"] for t in requested]
        allow_auto = ctx.request.get("allow_auto_topic_creation", True)
        if cfg.auto_create_topics and allow_auto:
            for name in names:
                if (
                    not broker.topic_table.contains(name)
                    and _valid_topic_name(name)
                    and not broker.is_internal_topic(name)
                    # auto-create honors the same create ACL as CreateTopics
                    and _authorized(ctx, AclOperation.create, name)
                ):
                    try:
                        await broker.create_topic(
                            TopicConfig(
                                name,
                                cfg.default_partitions,
                                cfg.default_replication,
                            )
                        )
                    except ValueError:
                        pass  # concurrent create
    topics = []
    for name in names:
        if not _authorized(ctx, AclOperation.describe, name):
            topics.append({
                "error_code": int(E.topic_authorization_failed),
                "name": name,
                "partitions": [],
            })
            continue
        md = broker.topic_table.get(name)
        if md is None:
            code = (
                E.invalid_topic_exception
                if not _valid_topic_name(name)
                else E.unknown_topic_or_partition
            )
            topics.append({"error_code": int(code), "name": name, "partitions": []})
            continue
        mdc = getattr(broker, "metadata_cache", None)
        partitions = []
        for idx in sorted(md.assignments):
            pa = md.assignments[idx]
            # Clustered: leadership lives in the leaders table fed by raft
            # notifications + dissemination gossip (metadata_cache.h
            # aggregation); pa.leader only covers the standalone path.
            leader = mdc.get_leader(pa.ntp) if mdc is not None else pa.leader
            partitions.append(
                {
                    "error_code": 0,
                    "partition_index": idx,
                    "leader_id": leader if leader is not None else -1,
                    "replica_nodes": list(pa.replicas),
                    "isr_nodes": list(pa.replicas),
                    "offline_replicas": [],
                }
            )
        entry = {
            "error_code": 0,
            "name": name,
            "is_internal": broker.is_internal_topic(name),
            "partitions": partitions,
        }
        if ctx.api_version >= 8 and ctx.request.get("include_topic_authorized_operations"):
            entry["topic_authorized_operations"] = authorized_operations(
                ctx, ResourceType.topic, name
            )
        topics.append(entry)
    if getattr(broker, "metadata_cache", None) is not None and broker.metadata_cache.all_brokers():
        brokers = [
            {
                "node_id": b.node_id,
                "host": b.kafka_host,
                "port": b.kafka_port,
                "rack": None,
            }
            for b in broker.metadata_cache.all_brokers()
        ]
    else:
        brokers = [
            {
                "node_id": cfg.node_id,
                "host": cfg.advertised_host,
                "port": cfg.advertised_port,
                "rack": None,
            }
        ]
    # Clustered: report the REAL controller leader (admin clients route
    # CreateTopics there); only the standalone broker is its own controller.
    controller_id = cfg.node_id
    fn = getattr(broker, "controller_leader_fn", None)
    if fn is not None:
        leader = fn()
        controller_id = leader if leader is not None else -1
    resp = {
        "brokers": brokers,
        "cluster_id": cfg.cluster_id,
        "controller_id": controller_id,
        "topics": topics,
    }
    if ctx.api_version >= 8 and ctx.request.get("include_cluster_authorized_operations"):
        from redpanda_tpu_torch.kafka.server.security_handlers import DEFAULT_CLUSTER_NAME

        resp["cluster_authorized_operations"] = authorized_operations(
            ctx, ResourceType.cluster, DEFAULT_CLUSTER_NAME
        )
    return resp


def _valid_topic_name(name: str) -> bool:
    return (
        0 < len(name) <= 249
        and name not in (".", "..")
        and all(c.isalnum() or c in "._-" for c in name)
    )


# ---------------------------------------------------------------- produce
async def handle_produce(ctx) -> dict | None:
    # Request entry point: a fresh trace per produce; raft.replicate /
    # storage.append spans below join it via the ambient id. The latency
    # HISTOGRAM is recorded once at the dispatch layer (protocol._dispatch
    # → probes.kafka_produce_hist), which also covers decode/encode.
    with tracer.span(
        "kafka.produce", root=True, node=ctx.broker.config.node_id
    ) as sp:
        # carried out to the dispatch layer so the histogram record there
        # can attach a trace exemplar when this request breaches
        ctx.trace_id = sp.trace_id
        return await _do_handle_produce(ctx)


async def _do_handle_produce(ctx) -> dict | None:
    acks = ctx.request["acks"]
    if acks not in (-1, 0, 1):
        responses = [
            {
                "name": t["name"],
                "partitions": [
                    _produce_partition_error(p["partition_index"], E.invalid_required_acks)
                    for p in t["partitions"]
                ],
            }
            for t in ctx.request["topics"]
        ]
        return {"responses": responses}
    level = {
        -1: ConsistencyLevel.quorum_ack,
        0: ConsistencyLevel.no_ack,
        1: ConsistencyLevel.leader_ack,
    }[acks]
    if level == ConsistencyLevel.quorum_ack and ctx.broker.config.unsafe_relaxed_acks:
        # Consistency-testing knob ONLY (tools/consistency, chaostest
        # posture): deliberately break the acks=-1 contract so the
        # linearizability checker can prove it detects lost acked writes.
        level = ConsistencyLevel.leader_ack
    n_bytes = sum(
        len(p.get("records") or b"")
        for t in ctx.request["topics"]
        for p in t["partitions"]
    )
    # Admission (resource_mgmt budget plane): reserve the record bytes
    # from the kafka_produce account BEFORE anything replicates —
    # shed-before-ack means a shed request's records never reach a log
    # and can never be read; the client sees the retriable KIP-599
    # throttling code plus the occupancy-ramped throttle hint. Bytes
    # release when the replicate round (and so the inflight copy) is done.
    ctrl = getattr(ctx.broker, "produce_admission", None)
    reserved = 0
    if ctrl is not None:
        reserved, retry_ms = ctrl.try_admit(n_bytes)
        if n_bytes > 0 and reserved == 0:
            if acks == 0:
                return None  # no response on the wire, shed still counted
            responses = [
                {
                    "name": t["name"],
                    "partitions": [
                        _produce_partition_error(
                            p["partition_index"], E.throttling_quota_exceeded
                        )
                        for p in t["partitions"]
                    ],
                }
                for t in ctx.request["topics"]
            ]
            return {"responses": responses, "throttle_time_ms": retry_ms}
    try:
        responses = []
        for t in ctx.request["topics"]:
            if not _authorized(ctx, AclOperation.write, t["name"]):
                responses.append({
                    "name": t["name"],
                    "partitions": [
                        _produce_partition_error(p["partition_index"], E.topic_authorization_failed)
                        for p in t["partitions"]
                    ],
                })
                continue
            parts = await asyncio.gather(
                *(
                    _produce_one(ctx.broker, t["name"], p, level, ctx.api_version)
                    for p in t["partitions"]
                )
            )
            responses.append({"name": t["name"], "partitions": list(parts)})
    finally:
        if ctrl is not None:
            ctrl.release(reserved)
    throttle = ctx.broker.quota_manager.record_produce(ctx.header.client_id, n_bytes)
    if acks == 0:
        return None
    return {"responses": responses, "throttle_time_ms": throttle}


def _produce_partition_error(index: int, code: ErrorCode) -> dict:
    return {
        "partition_index": index,
        "error_code": int(code),
        "base_offset": -1,
        "log_append_time_ms": -1,
        "log_start_offset": -1,
    }


async def _produce_one(broker, topic: str, p: dict, level: int, api_version: int = 3) -> dict:
    index = p["partition_index"]
    partition = broker.get_partition(topic, index)
    if partition is None:
        return _produce_partition_error(index, E.unknown_topic_or_partition)
    if not partition.is_leader():
        return _produce_partition_error(index, E.not_leader_for_partition)
    records = p.get("records")
    if not records:
        return _produce_partition_error(index, E.invalid_record)
    if api_version < 3:
        # produce v0-2 carries a legacy magic-0/1 MessageSet: up-convert to
        # ONE v2 batch so the rest of the pipeline only sees modern batches
        # (kafka_batch_adapter.cc adapt_with_version; crc32 verified inside)
        from redpanda_tpu_torch.kafka.protocol.legacy import (
            LegacyBatchError,
            LegacyUnsupportedError,
            convert_message_set,
        )

        try:
            batches = [convert_message_set(records)]
        except LegacyUnsupportedError:
            return _produce_partition_error(index, E.unsupported_for_message_format)
        except LegacyBatchError:
            return _produce_partition_error(index, E.corrupt_message)
    else:
        try:
            # CRC validation goes through the measured adapter boundary
            # (ops/crc_backend.py): batched host SSE4.2 or device kernel,
            # whichever the process-wide probe picked.
            adapted = decode_wire_batches(records, verify_crc=False)
        except EOFError:
            return _produce_partition_error(index, E.corrupt_message)
        from redpanda_tpu_torch.ops.crc_backend import default_backend_async

        v2 = [a for a in adapted if a.v2_format]
        ok = (await default_backend_async(broker.device)).validate(
            [a.batch.crc_region() for a in v2],
            [a.batch.header.crc for a in v2],
        )
        ok_iter = iter(ok)
        for a in adapted:
            # kafka_batch_adapter.cc:93-121: per batch IN ORDER, reject legacy
            # magic first, then a bad CRC — the first offending batch decides
            # the error (validation itself is batched through the backend).
            if not a.v2_format:
                return _produce_partition_error(index, E.unsupported_for_message_format)
            if not next(ok_iter):
                return _produce_partition_error(index, E.corrupt_message)
        batches = [a.batch for a in adapted]
    if not batches:
        return _produce_partition_error(index, E.invalid_record)
    # idempotence / transaction gate (rm_stm on the produce path,
    # produce_topic_partition → rm_stm path in produce.cc:196): check +
    # append run atomically inside the stm
    if any(b.header.producer_id >= 0 for b in batches):
        stm = await broker.recovered_rm_stm(partition)
        code, result = await stm.replicate(batches, level)
        if code != E.none:
            return _produce_partition_error(index, code)
        if result is None:
            # every batch was an idempotent duplicate: ack, nothing appended
            return {
                "partition_index": index,
                "error_code": 0,
                "base_offset": -1,
                "log_append_time_ms": -1,
                "log_start_offset": partition.start_offset,
            }
    else:
        result = await partition.replicate(batches, level)
    return {
        "partition_index": index,
        "error_code": 0,
        "base_offset": result.base_offset,
        "log_append_time_ms": -1,
        "log_start_offset": partition.start_offset,
    }


# ---------------------------------------------------------------- fetch
async def handle_fetch(ctx) -> dict:
    # The span deliberately includes the long-poll wait (that IS the op's
    # latency) but is exempt from the slow-request log: an empty long poll
    # hitting max_wait_ms is intentional waiting, and would otherwise bury
    # genuinely slow work in the slow ring. Histogram: protocol._dispatch.
    with tracer.span(
        "kafka.fetch", root=True, no_slow=True,
        node=ctx.broker.config.node_id,
    ) as sp:
        ctx.trace_id = sp.trace_id
        return await _do_handle_fetch(ctx)


async def _do_handle_fetch(ctx) -> dict:
    from redpanda_tpu_torch.kafka.server.fetch_session_cache import resolve_session

    req = ctx.request
    # Incremental fetch sessions (KIP-227): the session supplies the full
    # partition set when the request only carries changes.
    session, topics, sess_err = resolve_session(ctx.broker.fetch_sessions, req)
    if sess_err != E.none:
        return {
            "throttle_time_ms": 0,
            "error_code": int(sess_err),
            "session_id": 0,
            "responses": [],
        }
    max_wait_ms = req.get("max_wait_ms", 0)
    min_bytes = max(req.get("min_bytes", 0), 0)
    max_bytes = req.get("max_bytes", 0x7FFFFFFF)
    deadline = time.monotonic() + max(max_wait_ms, 0) / 1000.0
    poll = ctx.broker.config.fetch_poll_interval_s
    while True:
        responses, total, any_error = await _fetch_once(ctx, topics, max_bytes)
        # respond immediately on any partition error (kafka semantics) or
        # once min_bytes is satisfied / the wait budget is spent
        if any_error or total >= min_bytes or time.monotonic() >= deadline:
            break
        # Long-poll gate: re-reading and re-encoding every poll tick is
        # wasted work — only rerun _fetch_once after some requested
        # partition's high watermark advances.
        hwms = _fetch_hwm_snapshot(ctx, topics)
        while time.monotonic() < deadline:
            await asyncio.sleep(min(poll, max(deadline - time.monotonic(), 0)))
            if _fetch_hwm_snapshot(ctx, topics) != hwms:
                break
    throttle = ctx.broker.quota_manager.record_fetch(ctx.header.client_id, total)
    if session is not None:
        responses = session.prune_response(responses)
    out = {"responses": responses, "throttle_time_ms": throttle}
    if ctx.api_version >= 7:
        out["error_code"] = 0
        out["session_id"] = session.session_id if session is not None else 0
    return out


def _fetch_hwm_snapshot(ctx, topics) -> tuple:
    out = []
    for t in topics:
        for p in t["partitions"]:
            part = ctx.broker.get_partition(t["name"], p["partition_index"])
            out.append(part.high_watermark if part is not None else -1)
    return tuple(out)


async def _fetch_once(ctx, topics, max_bytes: int) -> tuple[list, int, bool]:
    broker = ctx.broker
    responses = []
    total = 0
    any_error = False
    budget = max_bytes
    for t in topics:
        parts = []
        if not _authorized(ctx, AclOperation.read, t["name"]):
            responses.append({
                "name": t["name"],
                "partitions": [
                    _fetch_partition_error(p["partition_index"], E.topic_authorization_failed)
                    for p in t["partitions"]
                ],
            })
            any_error = True
            continue
        for p in t["partitions"]:
            index = p["partition_index"]
            partition = broker.get_partition(t["name"], index)
            if partition is None:
                parts.append(_fetch_partition_error(index, E.unknown_topic_or_partition))
                any_error = True
                continue
            if not partition.is_leader() or (
                hasattr(partition, "ready_for_reads") and not partition.ready_for_reads()
            ):
                # unsettled new leader: serving now could show a hw BELOW
                # data an earlier leader acked (raft §8 read barrier;
                # clients refresh metadata and retry)
                parts.append(_fetch_partition_error(index, E.not_leader_for_partition))
                any_error = True
                continue
            hwm = partition.high_watermark
            fetch_offset = p["fetch_offset"]
            if fetch_offset < partition.start_offset or fetch_offset > hwm:
                parts.append(_fetch_partition_error(index, E.offset_out_of_range, hwm=hwm))
                any_error = True
                continue
            # read_committed: clamp to the LSO and surface aborted ranges so
            # clients drop aborted records (rm_stm LSO + tx_range snapshots)
            read_committed = ctx.request.get("isolation_level", 0) == 1
            lso = partition.last_stable_offset
            max_read = hwm - 1
            aborted = None
            if read_committed:
                stm = await ctx.broker.recovered_rm_stm(partition)
                lso = stm.last_stable_offset
                max_read = lso - 1
            take = min(p.get("partition_max_bytes", budget), max(budget, 0))
            batches = (
                await partition.make_reader(fetch_offset, take, max_offset=max_read)
                if take > 0 and fetch_offset <= max_read
                else []
            )
            if read_committed and batches:
                aborted = [
                    {"producer_id": a.producer_id, "first_offset": a.first_offset}
                    for a in stm.aborted_ranges(fetch_offset, batches[-1].last_offset)
                ] or None
            # data policy: per-topic transform view on the fetch path
            # (v8_engine's seat, application.cc:597,1037)
            policy = broker.data_policies.get(t["name"])
            if policy is not None and batches:
                batches = broker.policy_engine.transform_batches(
                    policy.spec_json, batches
                )
            records = encode_wire_batches(batches) if batches else b""
            total += len(records)
            budget -= len(records)
            parts.append(
                {
                    "partition_index": index,
                    "error_code": 0,
                    "high_watermark": hwm,
                    "last_stable_offset": lso,
                    "log_start_offset": partition.start_offset,
                    "aborted_transactions": aborted,
                    "preferred_read_replica": -1,
                    "records": records or None,
                }
            )
        responses.append({"name": t["name"], "partitions": parts})
    return responses, total, any_error


def _fetch_partition_error(index: int, code: ErrorCode, hwm: int = -1) -> dict:
    return {
        "partition_index": index,
        "error_code": int(code),
        "high_watermark": hwm,
        "last_stable_offset": -1,
        "log_start_offset": -1,
        "aborted_transactions": None,
        "preferred_read_replica": -1,
        "records": None,
    }


# ---------------------------------------------------------------- list_offsets
async def handle_list_offsets(ctx) -> dict:
    broker = ctx.broker
    topics = []
    for t in ctx.request.get("topics") or []:
        parts = []
        if not _authorized(ctx, AclOperation.describe, t["name"]):
            topics.append({
                "name": t["name"],
                "partitions": [
                    {
                        "partition_index": p["partition_index"],
                        "error_code": int(E.topic_authorization_failed),
                        "timestamp": -1,
                        "offset": -1,
                    }
                    for p in t["partitions"]
                ],
            })
            continue
        for p in t["partitions"]:
            index = p["partition_index"]
            partition = broker.get_partition(t["name"], index)
            if partition is None:
                parts.append(
                    {
                        "partition_index": index,
                        "error_code": int(E.unknown_topic_or_partition),
                        "timestamp": -1,
                        "offset": -1,
                        "old_style_offsets": [],
                    }
                )
                continue
            if hasattr(partition, "ready_for_reads") and not partition.ready_for_reads():
                parts.append(
                    {
                        "partition_index": index,
                        "error_code": int(E.not_leader_for_partition),
                        "timestamp": -1,
                        "offset": -1,
                        "old_style_offsets": [],
                    }
                )
                continue
            ts = p["timestamp"]
            if ts == -1:  # latest
                offset = partition.high_watermark
            elif ts == -2:  # earliest
                offset = partition.start_offset
            else:
                q = await partition.timequery(ts)
                offset = q if q is not None else -1
            parts.append(
                {
                    "partition_index": index,
                    "error_code": 0,
                    "timestamp": -1,
                    "offset": offset,
                    "old_style_offsets": [offset] if offset >= 0 else [],
                }
            )
        topics.append({"name": t["name"], "partitions": parts})
    return {"topics": topics}


# ---------------------------------------------------------------- topic admin
async def handle_create_topics(ctx) -> dict:
    broker = ctx.broker
    validate_only = ctx.request.get("validate_only", False)
    results = []
    for t in ctx.request.get("topics") or []:
        name = t["name"]
        if not _authorized(ctx, AclOperation.create, name):
            results.append(_topic_result(name, E.topic_authorization_failed))
            continue
        if not _valid_topic_name(name):
            results.append(_topic_result(name, E.invalid_topic_exception))
            continue
        if broker.is_internal_topic(name):
            results.append(
                _topic_result(name, E.invalid_topic_exception, "reserved internal name")
            )
            continue
        if broker.topic_table.contains(name):
            results.append(_topic_result(name, E.topic_already_exists))
            continue
        num_partitions = t.get("num_partitions", -1)
        if num_partitions == -1:
            num_partitions = broker.config.default_partitions
        if num_partitions <= 0:
            results.append(_topic_result(name, E.invalid_partitions))
            continue
        replication = t.get("replication_factor", -1)
        if replication == -1:
            replication = broker.config.default_replication
        cfg = TopicConfig(name, num_partitions, replication)
        for c in t.get("configs") or []:
            _apply_topic_config(cfg, c["name"], c["value"])
        if not validate_only:
            try:
                await broker.create_topic(cfg)
            except ValueError:
                # lost a cross-broker create race after the contains() check
                results.append(_topic_result(name, E.topic_already_exists))
                continue
            except Exception as e:
                code = (
                    E.invalid_replication_factor
                    if "replication factor" in str(e)
                    else E.unknown_server_error
                )
                results.append(_topic_result(name, code, str(e)))
                continue
        results.append(_topic_result(name, E.none))
    return {"topics": results}


def _topic_result(name: str, code: ErrorCode, msg: str | None = None) -> dict:
    return {"name": name, "error_code": int(code), "error_message": msg}


def _apply_topic_config(cfg: TopicConfig, key: str, value: str | None) -> None:
    cfg.apply_override(key, value)


async def handle_delete_topics(ctx) -> dict:
    broker = ctx.broker
    responses = []
    for name in ctx.request.get("topic_names") or []:
        if not _authorized(ctx, AclOperation.delete, name):
            responses.append({"name": name, "error_code": int(E.topic_authorization_failed)})
            continue
        if not broker.topic_table.contains(name):
            responses.append({"name": name, "error_code": int(E.unknown_topic_or_partition)})
            continue
        await broker.delete_topic(name)
        responses.append({"name": name, "error_code": 0})
    return {"responses": responses}


async def handle_create_partitions(ctx) -> dict:
    broker = ctx.broker
    results = []
    for t in ctx.request.get("topics") or []:
        name = t["name"]
        if not _authorized(ctx, AclOperation.alter, name):
            results.append(_topic_result(name, E.topic_authorization_failed))
            continue
        md = broker.topic_table.get(name)
        if md is None:
            results.append(_topic_result(name, E.unknown_topic_or_partition))
            continue
        if t["count"] <= md.config.partition_count:
            results.append(
                _topic_result(
                    name, E.invalid_partitions, "partition count can only grow"
                )
            )
            continue
        if not ctx.request.get("validate_only", False):
            await broker.create_partitions(name, t["count"])
        results.append(_topic_result(name, E.none))
    return {"results": results}


async def handle_delete_records(ctx) -> dict:
    broker = ctx.broker
    topics = []
    for t in ctx.request.get("topics") or []:
        parts = []
        if not _authorized(ctx, AclOperation.delete, t["name"]):
            topics.append({
                "name": t["name"],
                "partitions": [
                    {
                        "partition_index": p["partition_index"],
                        "low_watermark": -1,
                        "error_code": int(E.topic_authorization_failed),
                    }
                    for p in t["partitions"]
                ],
            })
            continue
        for p in t["partitions"]:
            index = p["partition_index"]
            partition = broker.get_partition(t["name"], index)
            if partition is None:
                parts.append(
                    {
                        "partition_index": index,
                        "low_watermark": -1,
                        "error_code": int(E.unknown_topic_or_partition),
                    }
                )
                continue
            offset = p["offset"]
            if offset == -1:
                offset = partition.high_watermark
            if offset > partition.high_watermark:
                parts.append(
                    {
                        "partition_index": index,
                        "low_watermark": -1,
                        "error_code": int(E.offset_out_of_range),
                    }
                )
                continue
            await partition.prefix_truncate(offset)
            parts.append(
                {
                    "partition_index": index,
                    "low_watermark": partition.start_offset,
                    "error_code": 0,
                }
            )
        topics.append({"name": t["name"], "partitions": parts})
    return {"topics": topics}


# ---------------------------------------------------------------- configs
_RESOURCE_TOPIC = 2
_RESOURCE_BROKER = 4


async def handle_describe_configs(ctx) -> dict:
    broker = ctx.broker
    results = []
    for res in ctx.request.get("resources") or []:
        rtype, rname = res["resource_type"], res["resource_name"]
        keys = res.get("configuration_keys")
        if rtype == _RESOURCE_TOPIC and not _authorized(
            ctx, AclOperation.describe_configs, rname
        ):
            results.append(
                {
                    "error_code": int(E.topic_authorization_failed),
                    "error_message": "describe configs denied",
                    "resource_type": rtype,
                    "resource_name": rname,
                    "configs": [],
                }
            )
            continue
        if rtype == _RESOURCE_TOPIC:
            md = broker.topic_table.get(rname)
            if md is None:
                results.append(
                    {
                        "error_code": int(E.unknown_topic_or_partition),
                        "error_message": None,
                        "resource_type": rtype,
                        "resource_name": rname,
                        "configs": [],
                    }
                )
                continue
            cfg_map = md.config.config_map()
        elif rtype == _RESOURCE_BROKER:
            cfg_map = {
                "auto.create.topics.enable": str(broker.config.auto_create_topics).lower(),
                "num.partitions": str(broker.config.default_partitions),
                "default.replication.factor": str(broker.config.default_replication),
            }
        else:
            results.append(
                {
                    "error_code": int(E.invalid_request),
                    "error_message": "unsupported resource type",
                    "resource_type": rtype,
                    "resource_name": rname,
                    "configs": [],
                }
            )
            continue
        configs = [
            {
                "name": k,
                "value": v,
                "read_only": False,
                "is_default": True,
                "config_source": 5,  # DEFAULT_CONFIG
                "is_sensitive": False,
                "synonyms": [],
            }
            for k, v in cfg_map.items()
            if keys is None or k in keys
        ]
        results.append(
            {
                "error_code": 0,
                "error_message": None,
                "resource_type": rtype,
                "resource_name": rname,
                "configs": configs,
            }
        )
    return {"results": results}


async def handle_alter_configs(ctx) -> dict:
    broker = ctx.broker
    responses = []
    for res in ctx.request.get("resources") or []:
        rtype, rname = res["resource_type"], res["resource_name"]
        code = E.none
        if rtype == _RESOURCE_TOPIC and not _authorized(ctx, AclOperation.alter_configs, rname):
            code = E.topic_authorization_failed
        elif rtype == _RESOURCE_TOPIC:
            md = broker.topic_table.get(rname)
            if md is None:
                code = E.unknown_topic_or_partition
            elif not ctx.request.get("validate_only", False):
                for c in res.get("configs") or []:
                    _apply_topic_config(md.config, c["name"], c["value"])
                broker._persist_topic_config(md.config)
                broker.update_log_configs(rname)
        else:
            code = E.invalid_request
        responses.append(
            {
                "error_code": int(code),
                "error_message": None,
                "resource_type": rtype,
                "resource_name": rname,
            }
        )
    return {"responses": responses}


async def handle_incremental_alter_configs(ctx) -> dict:
    broker = ctx.broker
    responses = []
    for res in ctx.request.get("resources") or []:
        rtype, rname = res["resource_type"], res["resource_name"]
        code = E.none
        if rtype == _RESOURCE_TOPIC and not _authorized(ctx, AclOperation.alter_configs, rname):
            code = E.topic_authorization_failed
        elif rtype == _RESOURCE_TOPIC:
            md = broker.topic_table.get(rname)
            if md is None:
                code = E.unknown_topic_or_partition
            elif not ctx.request.get("validate_only", False):
                for c in res.get("configs") or []:
                    op = c.get("config_operation", 0)
                    if op == 0:  # SET
                        _apply_topic_config(md.config, c["name"], c["value"])
                    elif op == 1:  # DELETE
                        md.config.extra.pop(c["name"], None)
                broker._persist_topic_config(md.config)
                broker.update_log_configs(rname)
        else:
            code = E.invalid_request
        responses.append(
            {
                "error_code": int(code),
                "error_message": None,
                "resource_type": rtype,
                "resource_name": rname,
            }
        )
    return {"responses": responses}


async def handle_describe_log_dirs(ctx) -> dict:
    broker = ctx.broker
    requested = ctx.request.get("topics")
    wanted: dict[str, set[int]] | None = None
    if requested is not None:
        wanted = {t["topic"]: set(t["partitions"]) for t in requested}
    by_topic: dict[str, list[dict]] = {}
    for ntp, partition in broker.partition_manager.partitions().items():
        if wanted is not None and (
            ntp.topic not in wanted or ntp.partition not in wanted[ntp.topic]
        ):
            continue
        size = sum(seg.size_bytes for seg in partition.log.segments)
        by_topic.setdefault(ntp.topic, []).append(
            {
                "partition_index": ntp.partition,
                "partition_size": size,
                "offset_lag": 0,
                "is_future_key": False,
            }
        )
    return {
        "results": [
            {
                "error_code": 0,
                "log_dir": broker.config.data_dir,
                "topics": [
                    {"name": name, "partitions": parts}
                    for name, parts in sorted(by_topic.items())
                ],
            }
        ]
    }


# ---------------------------------------------------------------- coordinator
# ---------------------------------------------------------------- error makers
def _produce_error_maker(ctx, code: ErrorCode) -> dict:
    return {
        "responses": [
            {
                "name": t["name"],
                "partitions": [
                    _produce_partition_error(p["partition_index"], code)
                    for p in t["partitions"]
                ],
            }
            for t in ctx.request.get("topics") or []
        ]
    }


def _fetch_error_maker(ctx, code: ErrorCode) -> dict:
    return {
        "error_code": int(code),
        "responses": [
            {
                "name": t["name"],
                "partitions": [
                    _fetch_partition_error(p["partition_index"], code)
                    for p in t["partitions"]
                ],
            }
            for t in ctx.request.get("topics") or []
        ],
    }


def _create_topics_error_maker(ctx, code: ErrorCode) -> dict:
    return {
        "topics": [
            _topic_result(t["name"], code) for t in ctx.request.get("topics") or []
        ]
    }


def _delete_topics_error_maker(ctx, code: ErrorCode) -> dict:
    return {
        "responses": [
            {"name": n, "error_code": int(code)}
            for n in ctx.request.get("topic_names") or []
        ]
    }


def _metadata_error_maker(ctx, code: ErrorCode) -> dict:
    return {
        "brokers": [],
        "cluster_id": None,
        "controller_id": -1,
        "topics": [
            {"error_code": int(code), "name": t["name"], "partitions": []}
            for t in ctx.request.get("topics") or []
        ],
    }


def _list_offsets_error_maker(ctx, code: ErrorCode) -> dict:
    return {
        "topics": [
            {
                "name": t["name"],
                "partitions": [
                    {
                        "partition_index": p["partition_index"],
                        "error_code": int(code),
                        "timestamp": -1,
                        "offset": -1,
                    }
                    for p in t["partitions"]
                ],
            }
            for t in ctx.request.get("topics") or []
        ]
    }


ERROR_RESPONSE_MAKERS = {
    m.PRODUCE: _produce_error_maker,
    m.FETCH: _fetch_error_maker,
    m.CREATE_TOPICS: _create_topics_error_maker,
    m.DELETE_TOPICS: _delete_topics_error_maker,
    m.METADATA: _metadata_error_maker,
    m.LIST_OFFSETS: _list_offsets_error_maker,
}
