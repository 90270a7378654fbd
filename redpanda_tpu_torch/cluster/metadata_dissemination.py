"""Leadership gossip between brokers.

Parity with cluster/metadata_dissemination_service + handler
(metadata_dissemination_rpc.json): raft elections are per-group and only the
replicas learn the outcome directly, so the new leader's node broadcasts
{ntp, term, leader} updates to every other broker, and a joining broker
pulls a full snapshot. Keeps each node's partition_leaders_table converged
without routing every metadata query to the controller.

(The JAX package's cluster/metadata_dissemination.py, copied.)
"""

from __future__ import annotations

import asyncio
import json
import logging

from redpanda_tpu_torch import rpc
from redpanda_tpu_torch.cluster.leaders_table import PartitionLeadersTable
from redpanda_tpu_torch.cluster.members import MembersTable
from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.rpc import serde

logger = logging.getLogger("rptorch.cluster.md_dissemination")

UPDATE_LEADERSHIP_REQUEST = serde.S(("updates_json", serde.BYTES))
UPDATE_LEADERSHIP_REPLY = serde.S(("ok", serde.BOOL))
GET_LEADERSHIP_REQUEST = serde.S(("dummy", serde.I8))
GET_LEADERSHIP_REPLY = serde.S(("updates_json", serde.BYTES))

md_dissemination_service = rpc.ServiceDef(
    "cluster",
    "metadata_dissemination",
    [
        rpc.MethodDef("update_leadership", UPDATE_LEADERSHIP_REQUEST, UPDATE_LEADERSHIP_REPLY),
        rpc.MethodDef("get_leadership", GET_LEADERSHIP_REQUEST, GET_LEADERSHIP_REPLY),
    ],
)


def _encode_updates(updates: list[tuple[NTP, int | None, int]]) -> bytes:
    return json.dumps(
        [
            {"ns": n.ns, "t": n.topic, "p": n.partition, "leader": l, "term": t}
            for n, l, t in updates
        ]
    ).encode()


def _decode_updates(blob: bytes) -> list[tuple[NTP, int | None, int]]:
    return [
        (NTP(u["ns"], u["t"], u["p"]), u["leader"], u["term"])
        for u in json.loads(blob.decode())
    ]


class MetadataDisseminationService:
    """Both halves: the RPC handler (apply peer updates) and the
    broadcaster fiber (push local leadership changes to all peers)."""

    def __init__(
        self,
        self_node_id: int,
        leaders: PartitionLeadersTable,
        members: MembersTable,
        connection_cache: rpc.ConnectionCache,
        interval_s: float = 0.2,
    ) -> None:
        self.self_node_id = self_node_id
        self.leaders = leaders
        self.members = members
        self.connections = connection_cache
        self.interval_s = interval_s
        self._pending: list[tuple[NTP, int | None, int]] = []
        # node_id -> updates that peer has not acked yet (retried alone)
        self._deferred: dict[int, list] = {}
        self._task: asyncio.Task | None = None
        self._wake = asyncio.Event()

    # ------------------------------------------------------------ rpc handlers
    async def update_leadership(self, req: dict) -> dict:
        for ntp, leader, term in _decode_updates(req["updates_json"]):
            self.leaders.update(ntp, leader, term)
        return {"ok": True}

    async def get_leadership(self, req: dict) -> dict:
        snap = [
            (ntp, info.leader, info.term)
            for ntp, info in self.leaders.snapshot().items()
        ]
        return {"updates_json": _encode_updates(snap)}

    # ------------------------------------------------------------ broadcast side
    def notify_leadership(self, ntp: NTP, leader: int | None, term: int) -> None:
        """Hook for raft leadership notifications on this node: queue a
        gossip round (batched, like the reference's dissemination queue)."""
        self.leaders.update(ntp, leader, term)
        self._pending.append((ntp, leader, term))
        self._wake.set()

    async def start(self) -> "MetadataDisseminationService":
        self._task = asyncio.create_task(self._loop())
        return self

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
            if self._deferred:
                # a peer still owes us an ack: retry on a timer even with
                # no fresh elections to coalesce
                try:
                    await asyncio.wait_for(self._wake.wait(), timeout=2.0)
                except asyncio.TimeoutError:
                    pass
            else:
                await self._wake.wait()
            await asyncio.sleep(self.interval_s)  # coalesce a burst of elections
            self._wake.clear()
            updates, self._pending = self._pending, []
            # per-peer payload: fresh updates for everyone + whatever that
            # peer failed to ack before (a dropped gossip round would leave
            # it PERMANENTLY stale — elections are events, not a stream).
            # The term guard in the leaders table makes duplicates no-ops.
            peers = [
                b.node_id
                for b in self.members.all_brokers()
                if b.node_id != self.self_node_id
            ]
            batches: dict[int, list] = {}
            for node_id in peers:
                batch = self._deferred.pop(node_id, []) + updates
                if batch:
                    batches[node_id] = batch
            if not batches:
                continue
            # gather (not fire-and-forget: unreferenced tasks can be GC'd):
            # sends run concurrently and each has its own short rpc timeout
            results = await asyncio.gather(
                *(
                    self._send(node_id, _encode_updates(batch))
                    for node_id, batch in batches.items()
                )
            )
            for (node_id, batch), ok in zip(batches.items(), results):
                if not ok:
                    self._deferred[node_id] = batch  # ONLY this peer retries

    async def _send(self, node_id: int, blob: bytes) -> bool:
        try:
            client = rpc.Client(md_dissemination_service, self.connections.get(node_id))
            await client.update_leadership({"updates_json": blob}, timeout=2.0)
            return True
        except Exception:
            logger.debug("leadership gossip to node %d failed", node_id, exc_info=True)
            return False

    async def pull_initial(self, from_node: int) -> None:
        """Joining broker: seed the leaders table from a peer."""
        client = rpc.Client(md_dissemination_service, self.connections.get(from_node))
        reply = await client.get_leadership({"dummy": 0}, timeout=5.0)
        for ntp, leader, term in _decode_updates(reply["updates_json"]):
            self.leaders.update(ntp, leader, term)
