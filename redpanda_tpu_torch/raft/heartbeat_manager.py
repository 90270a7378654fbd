"""Batched cross-group heartbeats.

Parity with raft/heartbeat_manager.cc:155-204: one heartbeat manager per
shard coalesces the heartbeats of ALL raft groups into a single RPC per
destination node per tick — the reason a node with thousands of partitions
doesn't send thousands of heartbeat RPCs. (The JAX package's
raft/heartbeat_manager.py, with the device of its ack tally explicit: the
card by default, or ``"cpu"``.)
"""

from __future__ import annotations

import asyncio
import logging
from collections import defaultdict

from redpanda_tpu_torch.device import resolve_device
from redpanda_tpu_torch.rpc.transport import RpcError, TransportClosed

logger = logging.getLogger("rptorch.raft.heartbeat")


class HeartbeatManager:
    def __init__(self, client_for, interval_ms: float = 60.0, device="cuda") -> None:
        self.device = resolve_device(device)
        self._client_for = client_for  # callable(node_id) -> raftgen Client
        self.interval_ms = interval_ms
        self._groups: dict[int, object] = {}  # group id -> Consensus
        self._task: asyncio.Task | None = None
        # last tick's per-group ack counts from the batched device-plane
        # tally (raft/device_plane.py; empty until
        # device_plane.configure(vote_tally=True)) — a debug/observability
        # view, not an acking input
        self.last_tick_acks: dict[int, int] = {}

    def register(self, consensus) -> None:
        self._groups[consensus.group] = consensus

    def deregister(self, group: int) -> None:
        self._groups.pop(group, None)

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop())

    async def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        while True:
            await asyncio.sleep(self.interval_ms / 1000.0)
            try:
                await self.send_heartbeats()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("heartbeat tick failed")

    async def send_heartbeats(self) -> None:
        # Gather per-destination batches across every leader group on this
        # node (heartbeat_manager.cc requests_for_range).
        by_node: dict[int, list[dict]] = defaultdict(list)
        for c in list(self._groups.values()):
            for meta in c.heartbeat_metadata():
                by_node[meta["target"]["id"]].append(meta)
        if not by_node:
            return
        acks = await asyncio.gather(
            *(self._send_one(nid, metas) for nid, metas in by_node.items())
        )
        self._tally_acks(acks)

    def _tally_acks(self, acks: list[dict]) -> None:
        """BASELINE config 5 (vote half): the per-tick cross-group ack
        tally as ONE batched reduction over a [replier, group] bit matrix
        instead of counting one reply message at a time. The plane's
        measured probe decides host-vs-device; counts are identical
        either way. Feeds the per-group quorum view (last_tick_acks) that
        debug surfaces read — replication acking itself stays on
        the per-reply path (process_heartbeat_reply)."""
        from redpanda_tpu_torch.raft import device_plane

        if not device_plane.vote_tally_enabled():
            return
        groups = sorted(self._groups)
        if not groups or not acks:
            return
        import numpy as np

        col = {g: i for i, g in enumerate(groups)}
        bits = np.zeros((len(acks), len(groups)), dtype=np.uint8)
        for row, per_node in enumerate(acks):
            for g, ok in (per_node or {}).items():
                if ok and g in col:
                    bits[row, col[g]] = 1
        tally = device_plane.default_plane(self.device).tally_votes(bits)
        self.last_tick_acks = {g: int(tally[col[g]]) for g in groups}

    async def _send_one(self, node_id: int, metas: list[dict]) -> dict:
        """Returns {group: replied_ok} for the ack tally."""
        try:
            reply = await self._client_for(node_id).heartbeat(
                {"heartbeats": metas}, timeout=self.interval_ms / 1000.0 * 4
            )
        except (RpcError, TransportClosed, OSError):
            # follower timeout detection is the election timer's job
            return {m["group"]: False for m in metas}
        acks: dict[int, bool] = {}
        for m in reply["meta"]:
            c = self._groups.get(m["group"])
            if c is not None:
                c.process_heartbeat_reply(m)
            acks[m["group"]] = m.get("result", 1) == 0
        return acks
