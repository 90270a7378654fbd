"""Raft RPC service schema + server-side dispatch.

Parity with the service generated from raftgen.json (vote, append_entries,
heartbeat, install_snapshot, timeout_now, transfer_leadership) — the
reference renders these with tools/rpcgen.py; here they are declared with
the rpc serde tables. The heartbeat method is **batched**: one request per
destination node carries metadata for every raft group hosted there
(heartbeat_manager.cc:155-204).

(The JAX package's raft/service.py, copied.)
"""

from __future__ import annotations

from redpanda_tpu_torch import rpc
from redpanda_tpu_torch.rpc import serde

_VNODE = serde.S(("id", serde.I32), ("revision", serde.I64))

VOTE_REQUEST = serde.S(
    ("group", serde.I64),
    ("node", _VNODE),
    ("target", _VNODE),
    ("term", serde.I64),
    ("prev_log_index", serde.I64),
    ("prev_log_term", serde.I64),
    ("leadership_transfer", serde.BOOL),
    ("prevote", serde.BOOL),
)
VOTE_REPLY = serde.S(
    ("term", serde.I64),
    ("granted", serde.BOOL),
    ("log_ok", serde.BOOL),
)

APPEND_ENTRIES_REQUEST = serde.S(
    ("group", serde.I64),
    ("node", _VNODE),
    ("target", _VNODE),
    ("term", serde.I64),
    ("prev_log_index", serde.I64),
    ("prev_log_term", serde.I64),
    ("commit_index", serde.I64),
    # encoded internal-format record batches, possibly empty (heartbeat-like)
    ("batches", serde.BYTES),
    ("flush", serde.BOOL),
)
APPEND_ENTRIES_REPLY = serde.S(
    ("group", serde.I64),
    ("node", _VNODE),
    ("target", _VNODE),
    ("term", serde.I64),
    ("last_dirty_log_index", serde.I64),
    ("last_flushed_log_index", serde.I64),
    # 0=success 1=failure 2=group_unavailable (raft/types.h append_entries_reply)
    ("result", serde.I8),
)

_HEARTBEAT_META = serde.S(
    ("group", serde.I64),
    ("node", _VNODE),
    ("target", _VNODE),
    ("term", serde.I64),
    ("prev_log_index", serde.I64),
    ("prev_log_term", serde.I64),
    ("commit_index", serde.I64),
)
HEARTBEAT_REQUEST = serde.S(("heartbeats", serde.Vector(_HEARTBEAT_META)))
HEARTBEAT_REPLY = serde.S(("meta", serde.Vector(APPEND_ENTRIES_REPLY)))

INSTALL_SNAPSHOT_REQUEST = serde.S(
    ("group", serde.I64),
    ("node", _VNODE),
    ("target", _VNODE),
    ("term", serde.I64),
    ("last_included_index", serde.I64),
    ("last_included_term", serde.I64),
    ("file_offset", serde.I64),
    ("chunk", serde.BYTES),
    ("done", serde.BOOL),
)
INSTALL_SNAPSHOT_REPLY = serde.S(
    ("term", serde.I64),
    ("bytes_stored", serde.I64),
    ("success", serde.BOOL),
)

TIMEOUT_NOW_REQUEST = serde.S(
    ("group", serde.I64),
    ("node", _VNODE),
    ("target", _VNODE),
    ("term", serde.I64),
)
TIMEOUT_NOW_REPLY = serde.S(("term", serde.I64), ("result", serde.I8))

TRANSFER_LEADERSHIP_REQUEST = serde.S(
    ("group", serde.I64),
    ("target_id", serde.I32),  # -1: leader picks the best candidate
)
TRANSFER_LEADERSHIP_REPLY = serde.S(("success", serde.BOOL), ("result", serde.I8))

raftgen_service = rpc.ServiceDef(
    "raft",
    "raftgen",
    [
        rpc.MethodDef("vote", VOTE_REQUEST, VOTE_REPLY),
        rpc.MethodDef("append_entries", APPEND_ENTRIES_REQUEST, APPEND_ENTRIES_REPLY),
        rpc.MethodDef("heartbeat", HEARTBEAT_REQUEST, HEARTBEAT_REPLY),
        rpc.MethodDef("install_snapshot", INSTALL_SNAPSHOT_REQUEST, INSTALL_SNAPSHOT_REPLY),
        rpc.MethodDef("timeout_now", TIMEOUT_NOW_REQUEST, TIMEOUT_NOW_REPLY),
        rpc.MethodDef(
            "transfer_leadership", TRANSFER_LEADERSHIP_REQUEST, TRANSFER_LEADERSHIP_REPLY
        ),
    ],
)


class RaftService:
    """Routes raft RPCs to the consensus instance owning each group
    (raft/service.h — the sharded service looks groups up in the shard
    table; here the group manager holds them all)."""

    def __init__(self, group_manager) -> None:
        self._gm = group_manager

    def _group(self, group_id: int):
        return self._gm.consensus_for(group_id)

    async def vote(self, req: dict) -> dict:
        c = self._group(req["group"])
        if c is None:
            return {"term": -1, "granted": False, "log_ok": False}
        return await c.handle_vote(req)

    async def append_entries(self, req: dict) -> dict:
        c = self._group(req["group"])
        if c is None:
            return _unavailable_reply(req)
        return await c.handle_append_entries(req)

    async def heartbeat(self, req: dict) -> dict:
        replies = []
        for meta in req["heartbeats"]:
            c = self._group(meta["group"])
            if c is None:
                replies.append(_unavailable_reply(meta))
                continue
            replies.append(await c.handle_heartbeat(meta))
        return {"meta": replies}

    async def install_snapshot(self, req: dict) -> dict:
        c = self._group(req["group"])
        if c is None:
            return {"term": -1, "bytes_stored": 0, "success": False}
        return await c.handle_install_snapshot(req)

    async def timeout_now(self, req: dict) -> dict:
        c = self._group(req["group"])
        if c is None:
            return {"term": -1, "result": 2}
        return await c.handle_timeout_now(req)

    async def transfer_leadership(self, req: dict) -> dict:
        c = self._group(req["group"])
        if c is None:
            return {"success": False, "result": 2}
        ok = await c.do_transfer_leadership(req.get("target_id", -1))
        return {"success": ok, "result": 0 if ok else 1}


def _unavailable_reply(req: dict) -> dict:
    return {
        "group": req["group"],
        "node": req.get("target", {"id": -1, "revision": 0}),
        "target": req.get("node", {"id": -1, "revision": 0}),
        "term": -1,
        "last_dirty_log_index": -1,
        "last_flushed_log_index": -1,
        "result": 2,
    }
