"""Kafka consumer-group API handlers.

Parity with kafka/server/handlers/{join,sync,heartbeat,leave}_group.cc,
offset_commit/offset_fetch.cc, find_coordinator.cc, describe/list/
delete_groups.cc — routed through the broker's GroupManager (the
group_router's shard hop collapses to the asyncio loop here; coordinator-
ship is still enforced via the group-topic partition leadership).

(The JAX package's kafka/server/group_handlers.py, copied.)
"""

from __future__ import annotations

from redpanda_tpu_torch.kafka.protocol import messages as m
from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode as E
from redpanda_tpu_torch.kafka.server.group import GroupState, OffsetCommit
from redpanda_tpu_torch.kafka.server.group_manager import GROUP_TOPIC, GroupManager
from redpanda_tpu_torch.kafka.server.security_handlers import authorize
from redpanda_tpu_torch.security.acl import AclOperation, ResourceType


def _gm(ctx) -> GroupManager:
    return ctx.broker.group_coordinator


def _group_authorized(ctx, op: AclOperation, group_id: str) -> bool:
    return authorize(ctx, ResourceType.group, group_id, op)


# ------------------------------------------------------------ find_coordinator
async def handle_find_coordinator(ctx) -> dict:
    key = ctx.request["key"]
    if ctx.request.get("key_type", 0) == 1:
        # transaction coordinator: single logical coordinator on this broker
        # (tx_gateway); same node answer applies
        pass
    gm = _gm(ctx)
    await gm.start()
    cfg = ctx.broker.config
    ntp = gm.coordinator_ntp(key)
    leader_node = None
    md = ctx.broker.topic_table.get(GROUP_TOPIC)
    if md is not None and ntp.partition in md.assignments:
        p = ctx.broker.get_partition(GROUP_TOPIC, ntp.partition)
        if p is not None and p.is_leader():
            leader_node = cfg.node_id
        else:
            # clustered: live leadership is in the metadata cache (leaders
            # table via raft notifications + gossip); pa.leader only covers
            # the standalone path
            mdc = getattr(ctx.broker, "metadata_cache", None)
            if mdc is not None:
                leader_node = mdc.get_leader(ntp)
            else:
                leader_node = md.assignments[ntp.partition].leader
    if leader_node is None:
        return {
            "error_code": int(E.coordinator_not_available),
            "error_message": "coordinator election pending",
            "node_id": -1, "host": "", "port": -1,
            "throttle_time_ms": 0,
        }
    if leader_node == cfg.node_id:
        host, port = cfg.advertised_host, cfg.advertised_port
    else:
        broker_info = (
            ctx.broker.metadata_cache.get_broker(leader_node)
            if getattr(ctx.broker, "metadata_cache", None)
            else None
        )
        if broker_info is None:
            return {
                "error_code": int(E.coordinator_not_available),
                "error_message": "coordinator address unknown",
                "node_id": -1, "host": "", "port": -1,
                "throttle_time_ms": 0,
            }
        host, port = broker_info.kafka_host, broker_info.kafka_port
    return {
        "error_code": 0,
        "error_message": None,
        "node_id": leader_node,
        "host": host,
        "port": port,
        "throttle_time_ms": 0,
    }


# ------------------------------------------------------------ join/sync/heartbeat/leave
async def handle_join_group(ctx) -> dict:
    r = ctx.request
    if not _group_authorized(ctx, AclOperation.read, r["group_id"]):
        return dict(_join_error(E.group_authorization_failed, r["member_id"]), throttle_time_ms=0)
    g = await _gm(ctx).get_or_create(r["group_id"])
    if g is None:
        return dict(_join_error(E.not_coordinator, r["member_id"]), throttle_time_ms=0)
    if r["session_timeout_ms"] < 10 or r["session_timeout_ms"] > 1800_000:
        return dict(_join_error(E.invalid_session_timeout, r["member_id"]), throttle_time_ms=0)
    resp = await g.join(
        member_id=r["member_id"],
        group_instance_id=r.get("group_instance_id"),
        client_id=ctx.header.client_id or "",
        client_host=ctx.connection.client_host,
        session_timeout_ms=r["session_timeout_ms"],
        rebalance_timeout_ms=r.get("rebalance_timeout_ms", -1),
        protocol_type=r["protocol_type"],
        protocols=[(p["name"], p["metadata"]) for p in r["protocols"]],
    )
    resp["throttle_time_ms"] = 0
    return resp


def _join_error(code: E, member_id: str = "") -> dict:
    return {
        "error_code": int(code),
        "generation_id": -1,
        "protocol_name": "",
        "leader": "",
        "member_id": member_id,
        "members": [],
    }


async def handle_sync_group(ctx) -> dict:
    r = ctx.request
    if not _group_authorized(ctx, AclOperation.read, r["group_id"]):
        return {"error_code": int(E.group_authorization_failed), "assignment": b"", "throttle_time_ms": 0}
    gm = _gm(ctx)
    g = gm.get(r["group_id"]) if gm.is_coordinator(r["group_id"]) else None
    if g is None:
        code = E.not_coordinator if not gm.is_coordinator(r["group_id"]) else E.unknown_member_id
        return {"error_code": int(code), "assignment": b"", "throttle_time_ms": 0}
    resp = await g.sync(
        r["member_id"], r["generation_id"], r.get("assignments") or []
    )
    resp["throttle_time_ms"] = 0
    return resp


async def handle_heartbeat(ctx) -> dict:
    r = ctx.request
    if not _group_authorized(ctx, AclOperation.read, r["group_id"]):
        return {"error_code": int(E.group_authorization_failed), "throttle_time_ms": 0}
    gm = _gm(ctx)
    if not gm.is_coordinator(r["group_id"]):
        return {"error_code": int(E.not_coordinator), "throttle_time_ms": 0}
    g = gm.get(r["group_id"])
    if g is None:
        return {"error_code": int(E.unknown_member_id), "throttle_time_ms": 0}
    return {"error_code": int(g.heartbeat(r["member_id"], r["generation_id"])), "throttle_time_ms": 0}


async def handle_leave_group(ctx) -> dict:
    r = ctx.request
    if not _group_authorized(ctx, AclOperation.read, r["group_id"]):
        return {"error_code": int(E.group_authorization_failed), "members": [], "throttle_time_ms": 0}
    gm = _gm(ctx)
    if not gm.is_coordinator(r["group_id"]):
        return {"error_code": int(E.not_coordinator), "members": [], "throttle_time_ms": 0}
    g = gm.get(r["group_id"])
    if g is None:
        return {"error_code": int(E.unknown_member_id), "members": [], "throttle_time_ms": 0}
    member_ids = (
        [mm["member_id"] for mm in r["members"]]
        if ctx.api_version >= 3
        else [r["member_id"]]
    )
    results = await g.leave(member_ids)
    if ctx.api_version >= 3:
        return {
            "error_code": 0,
            "members": [
                {"member_id": mid, "group_instance_id": None, "error_code": int(code)}
                for mid, code in results
            ],
            "throttle_time_ms": 0,
        }
    return {"error_code": int(results[0][1]), "members": [], "throttle_time_ms": 0}


# ------------------------------------------------------------ offsets
async def handle_offset_commit(ctx) -> dict:
    r = ctx.request
    gm = _gm(ctx)
    group_ok = _group_authorized(ctx, AclOperation.read, r["group_id"])
    commits: dict[tuple[str, int], OffsetCommit] = {}
    per_partition_code: dict[tuple[str, int], E] = {}
    for t in r.get("topics") or []:
        topic_ok = authorize(ctx, ResourceType.topic, t["name"], AclOperation.read)
        for p in t["partitions"]:
            key = (t["name"], p["partition_index"])
            if not group_ok:
                per_partition_code[key] = E.group_authorization_failed
            elif not topic_ok:
                per_partition_code[key] = E.topic_authorization_failed
            else:
                commits[key] = OffsetCommit(
                    p["committed_offset"],
                    p.get("committed_leader_epoch", -1),
                    p.get("committed_metadata"),
                )
    code = E.none
    if commits:
        code = await gm.commit_offsets(
            r["group_id"], r.get("member_id", ""), r.get("generation_id", -1), commits
        )
    return {
        "throttle_time_ms": 0,
        "topics": [
            {
                "name": t["name"],
                "partitions": [
                    {
                        "partition_index": p["partition_index"],
                        "error_code": int(
                            per_partition_code.get(
                                (t["name"], p["partition_index"]), code
                            )
                        ),
                    }
                    for p in t["partitions"]
                ],
            }
            for t in r.get("topics") or []
        ],
    }


async def handle_offset_fetch(ctx) -> dict:
    r = ctx.request
    gm = _gm(ctx)
    if not _group_authorized(ctx, AclOperation.describe, r["group_id"]):
        return {"throttle_time_ms": 0, "topics": [], "error_code": int(E.group_authorization_failed)}
    await gm.start()
    if not gm.is_coordinator(r["group_id"]):
        return {"throttle_time_ms": 0, "topics": [], "error_code": int(E.not_coordinator)}
    g = gm.get(r["group_id"])
    requested = r.get("topics")
    out_topics = []
    if requested is None:
        # all offsets for the group
        by_topic: dict[str, list] = {}
        if g is not None:
            for (topic, p), oc in sorted(g.offsets.items()):
                by_topic.setdefault(topic, []).append((p, oc))
        for topic, plist in by_topic.items():
            out_topics.append({
                "name": topic,
                "partitions": [
                    {
                        "partition_index": p,
                        "committed_offset": oc.offset,
                        "committed_leader_epoch": oc.leader_epoch,
                        "metadata": oc.metadata,
                        "error_code": 0,
                    }
                    for p, oc in plist
                ],
            })
    else:
        for t in requested:
            parts = []
            for p in t["partition_indexes"]:
                oc = g.fetch_offset(t["name"], p) if g is not None else None
                parts.append({
                    "partition_index": p,
                    "committed_offset": oc.offset if oc else -1,
                    "committed_leader_epoch": oc.leader_epoch if oc else -1,
                    "metadata": oc.metadata if oc else None,
                    "error_code": 0,
                })
            out_topics.append({"name": t["name"], "partitions": parts})
    return {"throttle_time_ms": 0, "topics": out_topics, "error_code": 0}


# ------------------------------------------------------------ admin
async def handle_describe_groups(ctx) -> dict:
    gm = _gm(ctx)
    groups = []
    for gid in ctx.request.get("groups") or []:
        if not _group_authorized(ctx, AclOperation.describe, gid):
            groups.append({
                "error_code": int(E.group_authorization_failed),
                "group_id": gid, "group_state": "", "protocol_type": "",
                "protocol_data": "", "members": [],
            })
            continue
        if not gm.is_coordinator(gid):
            groups.append({
                "error_code": int(E.not_coordinator),
                "group_id": gid, "group_state": "", "protocol_type": "",
                "protocol_data": "", "members": [],
            })
            continue
        g = gm.get(gid)
        if g is None:
            entry = {
                "error_code": 0,
                "group_id": gid, "group_state": GroupState.dead.value,
                "protocol_type": "", "protocol_data": "", "members": [],
            }
        else:
            entry = g.describe()
        if ctx.api_version >= 3 and ctx.request.get("include_authorized_operations"):
            # KIP-430 bitfield; only for groups the caller may describe
            from redpanda_tpu_torch.kafka.server.handlers import authorized_operations

            entry["authorized_operations"] = authorized_operations(
                ctx, ResourceType.group, gid
            )
        groups.append(entry)
    return {"throttle_time_ms": 0, "groups": groups}


async def handle_list_groups(ctx) -> dict:
    gm = _gm(ctx)
    await gm.start()
    return {
        "throttle_time_ms": 0,
        "error_code": 0,
        "groups": [
            {"group_id": g.group_id, "protocol_type": g.protocol_type or ""}
            for g in gm.groups.values()
            if _group_authorized(ctx, AclOperation.describe, g.group_id)
        ],
    }


async def handle_delete_groups(ctx) -> dict:
    gm = _gm(ctx)
    results = []
    for gid in ctx.request.get("groups_names") or []:
        if not _group_authorized(ctx, AclOperation.delete, gid):
            results.append({"group_id": gid, "error_code": int(E.group_authorization_failed)})
            continue
        if not gm.is_coordinator(gid):
            results.append({"group_id": gid, "error_code": int(E.not_coordinator)})
            continue
        code = await gm.delete_group(gid)
        results.append({"group_id": gid, "error_code": int(code)})
    return {"throttle_time_ms": 0, "results": results}


def register_group_handlers(handlers: dict) -> None:
    handlers[m.FIND_COORDINATOR] = handle_find_coordinator
    handlers[m.JOIN_GROUP] = handle_join_group
    handlers[m.SYNC_GROUP] = handle_sync_group
    handlers[m.HEARTBEAT] = handle_heartbeat
    handlers[m.LEAVE_GROUP] = handle_leave_group
    handlers[m.OFFSET_COMMIT] = handle_offset_commit
    handlers[m.OFFSET_FETCH] = handle_offset_fetch
    handlers[m.DESCRIBE_GROUPS] = handle_describe_groups
    handlers[m.LIST_GROUPS] = handle_list_groups
    handlers[m.DELETE_GROUPS] = handle_delete_groups
