"""Kafka transaction API handlers.

Parity with kafka/server/handlers/{init_producer_id, add_partitions_to_txn,
add_offsets_to_txn, end_txn, txn_offset_commit}.cc, dispatching into the
broker's TxCoordinator (tm_stm + tx_gateway_frontend + id_allocator).

(The JAX package's kafka/server/tx_handlers.py, copied.)
"""

from __future__ import annotations

from redpanda_tpu_torch.kafka.protocol import messages as m
from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode as E
from redpanda_tpu_torch.kafka.server.group import OffsetCommit
from redpanda_tpu_torch.kafka.server.security_handlers import authorize
from redpanda_tpu_torch.security.acl import AclOperation, ResourceType


def _txn_authorized(ctx, tx_id: str | None) -> bool:
    if not tx_id:
        # plain idempotence needs IDEMPOTENT_WRITE on the cluster
        from redpanda_tpu_torch.security.acl import DEFAULT_CLUSTER_NAME

        return authorize(
            ctx, ResourceType.cluster, DEFAULT_CLUSTER_NAME, AclOperation.idempotent_write
        )
    return authorize(ctx, ResourceType.transactional_id, tx_id, AclOperation.write)


async def handle_init_producer_id(ctx) -> dict:
    r = ctx.request
    tx_id = r.get("transactional_id")
    if not _txn_authorized(ctx, tx_id):
        code = (
            E.transactional_id_authorization_failed
            if tx_id
            else E.cluster_authorization_failed
        )
        return {"throttle_time_ms": 0, "error_code": int(code),
                "producer_id": -1, "producer_epoch": -1}
    timeout = r.get("transaction_timeout_ms", 60_000)
    if tx_id and timeout <= 0:
        return {"throttle_time_ms": 0, "error_code": int(E.invalid_transaction_timeout),
                "producer_id": -1, "producer_epoch": -1}
    code, pid, epoch = await ctx.broker.tx_coordinator.init_producer_id(tx_id, timeout)
    return {"throttle_time_ms": 0, "error_code": int(code),
            "producer_id": pid, "producer_epoch": epoch}


async def handle_add_partitions_to_txn(ctx) -> dict:
    r = ctx.request
    parts = [(t["name"], p) for t in r["topics"] for p in t["partitions"]]
    if not _txn_authorized(ctx, r["transactional_id"]):
        results = {tp: E.transactional_id_authorization_failed for tp in parts}
    else:
        results = {}
        allowed = []
        for topic, p in parts:
            if not authorize(ctx, ResourceType.topic, topic, AclOperation.write):
                results[(topic, p)] = E.topic_authorization_failed
            else:
                allowed.append((topic, p))
        results.update(
            await ctx.broker.tx_coordinator.add_partitions(
                r["transactional_id"], r["producer_id"], r["producer_epoch"], allowed
            )
        )
    return {
        "throttle_time_ms": 0,
        "results": [
            {
                "name": t["name"],
                "results": [
                    {"partition_index": p, "error_code": int(results.get((t["name"], p), E.none))}
                    for p in t["partitions"]
                ],
            }
            for t in r["topics"]
        ],
    }


async def handle_add_offsets_to_txn(ctx) -> dict:
    r = ctx.request
    if not _txn_authorized(ctx, r["transactional_id"]):
        return {"throttle_time_ms": 0, "error_code": int(E.transactional_id_authorization_failed)}
    if not authorize(ctx, ResourceType.group, r["group_id"], AclOperation.read):
        return {"throttle_time_ms": 0, "error_code": int(E.group_authorization_failed)}
    code = await ctx.broker.tx_coordinator.add_offsets(
        r["transactional_id"], r["producer_id"], r["producer_epoch"], r["group_id"]
    )
    return {"throttle_time_ms": 0, "error_code": int(code)}


async def handle_txn_offset_commit(ctx) -> dict:
    r = ctx.request
    commits: dict[tuple[str, int], OffsetCommit] = {}
    for t in r.get("topics") or []:
        for p in t["partitions"]:
            commits[(t["name"], p["partition_index"])] = OffsetCommit(
                p["committed_offset"], p.get("committed_leader_epoch", -1),
                p.get("committed_metadata"),
            )
    if not _txn_authorized(ctx, r["transactional_id"]):
        code = E.transactional_id_authorization_failed
    elif not authorize(ctx, ResourceType.group, r["group_id"], AclOperation.read):
        code = E.group_authorization_failed
    else:
        code = await ctx.broker.tx_coordinator.txn_offset_commit(
            r["transactional_id"], r["producer_id"], r["producer_epoch"],
            r["group_id"], commits,
        )
    return {
        "throttle_time_ms": 0,
        "topics": [
            {
                "name": t["name"],
                "partitions": [
                    {"partition_index": p["partition_index"], "error_code": int(code)}
                    for p in t["partitions"]
                ],
            }
            for t in r.get("topics") or []
        ],
    }


async def handle_end_txn(ctx) -> dict:
    r = ctx.request
    if not _txn_authorized(ctx, r["transactional_id"]):
        return {"throttle_time_ms": 0, "error_code": int(E.transactional_id_authorization_failed)}
    code = await ctx.broker.tx_coordinator.end_txn(
        r["transactional_id"], r["producer_id"], r["producer_epoch"], r["committed"]
    )
    return {"throttle_time_ms": 0, "error_code": int(code)}


def register_tx_handlers(handlers: dict) -> None:
    handlers[m.INIT_PRODUCER_ID] = handle_init_producer_id
    handlers[m.ADD_PARTITIONS_TO_TXN] = handle_add_partitions_to_txn
    handlers[m.ADD_OFFSETS_TO_TXN] = handle_add_offsets_to_txn
    handlers[m.TXN_OFFSET_COMMIT] = handle_txn_offset_commit
    handlers[m.END_TXN] = handle_end_txn
