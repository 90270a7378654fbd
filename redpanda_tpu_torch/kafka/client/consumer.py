"""Group-aware consumer.

Parity with kafka/client/consumer.h + assignment_plans (the reference's
embedded client implements the full join/sync/heartbeat/offset loop so
pandaproxy can expose group consumption). ConsumerProtocol metadata and
assignment blobs follow the standard Kafka "consumer" protocol encoding
(version, topic list, user-data / partition assignments) so third-party
members could interoperate.

(The JAX package's kafka/client/consumer.py, copied.)
"""

from __future__ import annotations

import asyncio
import logging
import struct

from redpanda_tpu_torch.kafka.protocol import messages as m
from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode, KafkaError

logger = logging.getLogger("rptpu.kafka.consumer")


# ---------------------------------------------------------------- protocol blobs
def encode_subscription(topics: list[str], user_data: bytes = b"") -> bytes:
    out = struct.pack(">hi", 0, len(topics))
    for t in topics:
        tb = t.encode()
        out += struct.pack(">h", len(tb)) + tb
    out += struct.pack(">i", len(user_data)) + user_data
    return out


def decode_subscription(blob: bytes) -> list[str]:
    (_version, n) = struct.unpack_from(">hi", blob, 0)
    pos = 6
    topics = []
    for _ in range(n):
        (ln,) = struct.unpack_from(">h", blob, pos)
        pos += 2
        topics.append(blob[pos : pos + ln].decode())
        pos += ln
    return topics


def encode_assignment(assignment: dict[str, list[int]]) -> bytes:
    out = struct.pack(">hi", 0, len(assignment))
    for t, parts in assignment.items():
        tb = t.encode()
        out += struct.pack(">h", len(tb)) + tb
        out += struct.pack(">i", len(parts))
        for p in parts:
            out += struct.pack(">i", p)
    out += struct.pack(">i", 0)  # user data
    return out


def decode_assignment(blob: bytes) -> dict[str, list[int]]:
    if not blob:
        return {}
    (_version, n) = struct.unpack_from(">hi", blob, 0)
    pos = 6
    out: dict[str, list[int]] = {}
    for _ in range(n):
        (ln,) = struct.unpack_from(">h", blob, pos)
        pos += 2
        t = blob[pos : pos + ln].decode()
        pos += ln
        (np,) = struct.unpack_from(">i", blob, pos)
        pos += 4
        parts = list(struct.unpack_from(f">{np}i", blob, pos))
        pos += 4 * np
        out[t] = parts
    return out


def range_assign(
    members: list[tuple[str, list[str]]], partitions_by_topic: dict[str, int]
) -> dict[str, dict[str, list[int]]]:
    """Range assignor (assignment_plans.cc range strategy): per topic,
    contiguous chunks to subscribed members sorted by member id."""
    out: dict[str, dict[str, list[int]]] = {mid: {} for mid, _ in members}
    for topic, n_parts in partitions_by_topic.items():
        subscribed = sorted(mid for mid, topics in members if topic in topics)
        if not subscribed:
            continue
        per = n_parts // len(subscribed)
        extra = n_parts % len(subscribed)
        at = 0
        for i, mid in enumerate(subscribed):
            take = per + (1 if i < extra else 0)
            if take:
                out[mid].setdefault(topic, []).extend(range(at, at + take))
            at += take
    return out


class GroupConsumer:
    """join → (leader assigns) → sync → heartbeat fiber → fetch/commit."""

    def __init__(
        self,
        client,  # KafkaClient
        group_id: str,
        topics: list[str],
        session_timeout_ms: int = 10_000,
        heartbeat_interval_s: float = 1.0,
    ) -> None:
        self.client = client
        self.group_id = group_id
        self.topics = topics
        self.session_timeout_ms = session_timeout_ms
        self.heartbeat_interval_s = heartbeat_interval_s
        self.member_id = ""
        self.generation = -1
        self.assignment: dict[str, list[int]] = {}
        self._coord = None  # BrokerConnection
        self._hb_task: asyncio.Task | None = None
        self._positions: dict[tuple[str, int], int] = {}
        self.rejoin_needed = False

    # ------------------------------------------------------------ membership
    async def _coordinator(self):
        if self._coord is None:
            # coordinator_not_available is a POLL signal, not a failure:
            # right after the group topic's creation (or a coordinator
            # node's death) the partition is mid-election. Standard client
            # behavior is retry-with-backoff until the deadline.
            deadline = asyncio.get_event_loop().time() + 15.0
            while True:
                conn = await self.client.any_connection()
                resp = await conn.request(
                    m.FIND_COORDINATOR, {"key": self.group_id, "key_type": 0}
                )
                code = resp["error_code"]
                if code == 0:
                    break
                if (
                    code != int(ErrorCode.coordinator_not_available)
                    or asyncio.get_event_loop().time() > deadline
                ):
                    raise KafkaError(ErrorCode(code), "find_coordinator")
                await asyncio.sleep(0.25)
            await self.client.refresh_metadata()
            if resp["node_id"] in self.client._brokers:
                self._coord = await self.client.connection_for(resp["node_id"])
            else:
                self._coord = conn
        return self._coord

    async def join(self) -> "GroupConsumer":
        coord = await self._coordinator()
        sub = encode_subscription(self.topics)
        while True:
            resp = await coord.request(m.JOIN_GROUP, {
                "group_id": self.group_id,
                "session_timeout_ms": self.session_timeout_ms,
                "rebalance_timeout_ms": self.session_timeout_ms,
                "member_id": self.member_id,
                "group_instance_id": None,
                "protocol_type": "consumer",
                "protocols": [{"name": "range", "metadata": sub}],
            })
            code = ErrorCode(resp["error_code"])
            if code == ErrorCode.unknown_member_id and self.member_id:
                self.member_id = ""
                continue
            if code != ErrorCode.none:
                raise KafkaError(code, "join_group")
            break
        self.member_id = resp["member_id"]
        self.generation = resp["generation_id"]
        assignments = []
        if resp["leader"] == self.member_id:
            member_subs = [
                (mm["member_id"], decode_subscription(mm["metadata"]))
                for mm in resp["members"]
            ]
            all_topics = sorted({t for _, ts in member_subs for t in ts})
            md = await self.client.refresh_metadata(all_topics)
            parts = {
                t["name"]: len(t.get("partitions") or [])
                for t in md["topics"]
                if t["error_code"] == 0
            }
            plan = range_assign(member_subs, parts)
            assignments = [
                {"member_id": mid, "assignment": encode_assignment(a)}
                for mid, a in plan.items()
            ]
        sresp = await coord.request(m.SYNC_GROUP, {
            "group_id": self.group_id,
            "generation_id": self.generation,
            "member_id": self.member_id,
            "group_instance_id": None,
            "assignments": assignments,
        })
        if sresp["error_code"] != 0:
            raise KafkaError(ErrorCode(sresp["error_code"]), "sync_group")
        self.assignment = decode_assignment(sresp["assignment"])
        self.rejoin_needed = False
        if self._hb_task is None or self._hb_task.done():
            self._hb_task = asyncio.create_task(self._heartbeat_loop())
        # restore committed positions (-1 = no commit yet → start at 0)
        for topic, plist in self.assignment.items():
            fetched = await self.fetch_committed(topic, plist)
            for p, off in fetched.items():
                self._positions[(topic, p)] = max(off, 0)
        return self

    async def _heartbeat_loop(self) -> None:
        while True:
            await asyncio.sleep(self.heartbeat_interval_s)
            try:
                coord = await self._coordinator()
                resp = await coord.request(m.HEARTBEAT, {
                    "group_id": self.group_id,
                    "generation_id": self.generation,
                    "member_id": self.member_id,
                    "group_instance_id": None,
                })
                code = ErrorCode(resp["error_code"])
                if code == ErrorCode.rebalance_in_progress:
                    self.rejoin_needed = True
                elif code in (ErrorCode.unknown_member_id, ErrorCode.illegal_generation):
                    self.rejoin_needed = True
                    return
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.debug("heartbeat failed", exc_info=True)

    async def poll(self, max_records: int = 500) -> dict[tuple[str, int], list]:
        """Fetch from every assigned partition at the current position."""
        if self.rejoin_needed:
            await self.join()
        out: dict[tuple[str, int], list] = {}
        for topic, plist in self.assignment.items():
            for p in plist:
                pos = self._positions.get((topic, p), 0)
                batches, hwm = await self.client.fetch(topic, p, pos, max_wait_ms=10)
                records = []
                for b in batches:
                    for i, r in enumerate(b.records()):
                        off = b.header.base_offset + r.offset_delta
                        if off >= pos:
                            records.append((off, r))
                if records:
                    out[(topic, p)] = records
                    self._positions[(topic, p)] = records[-1][0] + 1
        return out

    # ------------------------------------------------------------ offsets
    async def commit(self) -> None:
        topics: dict[str, list] = {}
        for (topic, p), pos in self._positions.items():
            topics.setdefault(topic, []).append({
                "partition_index": p,
                "committed_offset": pos,
                "committed_leader_epoch": -1,
                "committed_metadata": None,
            })
        if not topics:
            return
        coord = await self._coordinator()
        resp = await coord.request(m.OFFSET_COMMIT, {
            "group_id": self.group_id,
            "generation_id": self.generation,
            "member_id": self.member_id,
            "group_instance_id": None,
            "retention_time_ms": -1,
            "topics": [{"name": t, "partitions": ps} for t, ps in topics.items()],
        })
        for t in resp["topics"]:
            for p in t["partitions"]:
                if p["error_code"] != 0:
                    raise KafkaError(ErrorCode(p["error_code"]), f"offset_commit {t['name']}")

    async def fetch_committed(self, topic: str, partitions: list[int]) -> dict[int, int]:
        coord = await self._coordinator()
        resp = await coord.request(m.OFFSET_FETCH, {
            "group_id": self.group_id,
            "topics": [{"name": topic, "partition_indexes": partitions}],
        })
        out = {}
        for t in resp.get("topics") or []:
            for p in t["partitions"]:
                out[p["partition_index"]] = p["committed_offset"]
        return out

    async def leave(self) -> None:
        if self._hb_task is not None:
            self._hb_task.cancel()
            try:
                await self._hb_task
            except asyncio.CancelledError:
                pass
            self._hb_task = None
        if self.member_id:
            coord = await self._coordinator()
            await coord.request(m.LEAVE_GROUP, {
                "group_id": self.group_id,
                "member_id": self.member_id,
                "members": [{"member_id": self.member_id, "group_instance_id": None}],
            })
            self.member_id = ""
