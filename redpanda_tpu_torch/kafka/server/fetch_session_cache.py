"""Incremental fetch sessions (KIP-227).

Parity with kafka/server/fetch_session_cache.h: a consumer establishes a
session (epoch 0), the broker remembers its partition set + positions, and
subsequent requests (epoch n) carry only CHANGES — added/updated partitions
in `topics`, removals in `forgotten_topics_data`. Responses include only
partitions with new data, errors, or moved watermarks. This turns the
steady-state many-partition fetch from O(partitions) request/response bytes
into O(changed).

Session ids are random int31s; the cache is LRU-bounded.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field

from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode as E

INVALID_SESSION_ID = 0
# session_epoch sentinels (fetch_session.h / KIP-227)
INITIAL_EPOCH = 0
FINAL_EPOCH = -1


@dataclass
class FetchPartition:
    fetch_offset: int
    max_bytes: int
    # last values sent to the client, for change detection
    last_hwm: int = -1
    last_lso: int = -1
    last_start: int = -1


@dataclass
class FetchSession:
    session_id: int
    epoch: int = 1
    # insertion-ordered (topic, partition) -> FetchPartition
    partitions: dict[tuple[str, int], FetchPartition] = field(default_factory=dict)
    last_used: float = field(default_factory=time.monotonic)

    def apply_request(self, topics: list[dict], forgotten: list[dict]) -> None:
        for t in forgotten or []:
            for p in t.get("partitions") or []:
                self.partitions.pop((t["name"], p), None)
        for t in topics or []:
            for p in t.get("partitions") or []:
                key = (t["name"], p["partition_index"])
                cur = self.partitions.get(key)
                fp = FetchPartition(
                    fetch_offset=p["fetch_offset"],
                    max_bytes=p.get("partition_max_bytes", 1 << 20),
                )
                if cur is not None:
                    fp.last_hwm = cur.last_hwm
                    fp.last_lso = cur.last_lso
                    fp.last_start = cur.last_start
                self.partitions[key] = fp

    def to_topics(self) -> list[dict]:
        """The session's full partition set in fetch-request `topics` shape."""
        by_topic: dict[str, list[dict]] = {}
        for (topic, index), fp in self.partitions.items():
            by_topic.setdefault(topic, []).append(
                {
                    "partition_index": index,
                    "current_leader_epoch": -1,
                    "fetch_offset": fp.fetch_offset,
                    "log_start_offset": -1,
                    "partition_max_bytes": fp.max_bytes,
                }
            )
        return [{"name": t, "partitions": ps} for t, ps in by_topic.items()]

    def prune_response(self, responses: list[dict]) -> list[dict]:
        """Incremental response: keep only partitions with records, errors,
        or changed watermarks; remember what the client now knows."""
        out = []
        for t in responses:
            kept = []
            for p in t["partitions"]:
                key = (t["name"], p["partition_index"])
                fp = self.partitions.get(key)
                changed = (
                    p.get("error_code", 0) != 0
                    or p.get("records")
                    or fp is None
                    or p.get("high_watermark", -1) != fp.last_hwm
                    or p.get("last_stable_offset", -1) != fp.last_lso
                    or p.get("log_start_offset", -1) != fp.last_start
                )
                if fp is not None:
                    fp.last_hwm = p.get("high_watermark", -1)
                    fp.last_lso = p.get("last_stable_offset", -1)
                    fp.last_start = p.get("log_start_offset", -1)
                if changed:
                    kept.append(p)
            if kept:
                out.append({"name": t["name"], "partitions": kept})
        return out


class FetchSessionCache:
    def __init__(self, max_sessions: int = 1000):
        self.max_sessions = max_sessions
        self._sessions: dict[int, FetchSession] = {}

    def get(self, session_id: int) -> FetchSession | None:
        s = self._sessions.get(session_id)
        if s is not None:
            s.last_used = time.monotonic()
        return s

    def create(self) -> FetchSession:
        if len(self._sessions) >= self.max_sessions:
            victim = min(self._sessions.values(), key=lambda s: s.last_used)
            del self._sessions[victim.session_id]
        while True:
            sid = random.randint(1, 0x7FFFFFFF)
            if sid not in self._sessions:
                break
        s = FetchSession(sid)
        self._sessions[sid] = s
        return s

    def remove(self, session_id: int) -> None:
        self._sessions.pop(session_id, None)

    def __len__(self) -> int:
        return len(self._sessions)


def resolve_session(
    cache: FetchSessionCache, req: dict
) -> tuple[FetchSession | None, list[dict], E]:
    """Maps a fetch request onto its session (fetch_session_cache.h's
    maybe_get_session). Returns (session, effective_topics, error).

    - epoch -1: sessionless full fetch (also closes an existing session).
    - epoch  0: full fetch establishing a new session.
    - epoch >0: incremental fetch against an existing session.
    """
    epoch = req.get("session_epoch", FINAL_EPOCH)
    session_id = req.get("session_id", INVALID_SESSION_ID)
    topics = req.get("topics") or []
    if epoch == FINAL_EPOCH:
        if session_id != INVALID_SESSION_ID:
            cache.remove(session_id)
        return None, topics, E.none
    if epoch == INITIAL_EPOCH:
        if session_id != INVALID_SESSION_ID:
            cache.remove(session_id)
        session = cache.create()
        session.apply_request(topics, req.get("forgotten_topics_data") or [])
        return session, session.to_topics(), E.none
    session = cache.get(session_id)
    if session is None:
        return None, [], E.fetch_session_id_not_found
    if epoch != session.epoch:
        return None, [], E.invalid_fetch_session_epoch
    session.apply_request(topics, req.get("forgotten_topics_data") or [])
    session.epoch += 1
    return session, session.to_topics(), E.none
