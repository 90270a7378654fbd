"""Cross-node transaction gateway: marker fan-out + staged-offset routing.

The reference's tx_gateway (tx_gateway.json, cluster/tx_gateway_frontend.cc)
lets the transaction coordinator finish a transaction whose data partitions
and consumer groups live on OTHER brokers: commit/abort control markers go
to each partition LEADER, and staged group offsets go to the GROUP
coordinator. Without it, EOS only works when everything is co-located on
one broker.

Two RPC methods on the internal mesh, plus a router the TxCoordinator uses:

- ``tx_marker``: write the control marker through the leader's rm_stm
  (rm_stm prepare/commit/abort batches, rm_stm.cc).
- ``tx_group_offsets``: fold a committed transaction's staged offsets into
  group state on the group coordinator (group_commit_tx semantics).

The router resolves leadership from the metadata cache and falls back to
local execution when the target is this broker — the single-node path has
zero RPC overhead and identical semantics.

(The JAX package's cluster/tx_gateway.py, copied.)
"""

from __future__ import annotations

import json
import logging

from redpanda_tpu_torch import rpc
from redpanda_tpu_torch.rpc import serde

logger = logging.getLogger("rptpu.cluster.txgw")

TX_MARKER_REQUEST = serde.S(
    ("topic", serde.STRING),
    ("partition", serde.I32),
    ("pid", serde.I64),
    ("epoch", serde.I32),
    ("commit", serde.I32),
)
TX_MARKER_REPLY = serde.S(("errc", serde.I32))  # kafka ErrorCode value
TX_GROUP_OFFSETS_REQUEST = serde.S(
    ("group_id", serde.STRING),
    ("commits_json", serde.BYTES),
)
TX_GROUP_OFFSETS_REPLY = serde.S(("errc", serde.I32))

tx_gateway_service = rpc.ServiceDef(
    "cluster",
    "tx_gateway",
    [
        rpc.MethodDef("tx_begin", TX_MARKER_REQUEST, TX_MARKER_REPLY),
        rpc.MethodDef("tx_marker", TX_MARKER_REQUEST, TX_MARKER_REPLY),
        rpc.MethodDef(
            "tx_group_offsets", TX_GROUP_OFFSETS_REQUEST, TX_GROUP_OFFSETS_REPLY
        ),
    ],
)

_UNKNOWN_SERVER_ERROR = -1
_NOT_LEADER = 6
_COORDINATOR_NOT_AVAILABLE = 15


def encode_commits(commits: dict) -> bytes:
    """dict[(topic, partition) -> OffsetCommit] -> wire JSON."""
    return json.dumps([
        {
            "topic": t,
            "partition": p,
            "offset": oc.offset,
            "leader_epoch": oc.leader_epoch,
            "metadata": oc.metadata,
        }
        for (t, p), oc in commits.items()
    ]).encode()


def decode_commits(blob: bytes) -> dict:
    from redpanda_tpu_torch.kafka.server.group import OffsetCommit

    return {
        (d["topic"], d["partition"]): OffsetCommit(
            d["offset"], d.get("leader_epoch", -1), d.get("metadata")
        )
        for d in json.loads(blob.decode())
    }


class TxGatewayService:
    """Server side, bound on every broker."""

    def __init__(self, broker) -> None:
        self.broker = broker

    def register(self, protocol: rpc.SimpleProtocol) -> None:
        protocol.register_service(rpc.ServiceHandler(tx_gateway_service, self))

    async def tx_begin(self, req: dict) -> dict:
        """rm_stm.begin_tx on the partition leader (AddPartitionsToTxn)."""
        p = self.broker.get_partition(req["topic"], req["partition"])
        if p is None or not p.is_leader():
            return {"errc": _NOT_LEADER}
        try:
            rm = await self.broker.recovered_rm_stm(p)
            return {"errc": int(rm.begin_tx(req["pid"], req["epoch"]))}
        except Exception:
            logger.exception("tx_begin failed for %s/%d", req["topic"], req["partition"])
            return {"errc": _UNKNOWN_SERVER_ERROR}

    async def tx_marker(self, req: dict) -> dict:
        p = self.broker.get_partition(req["topic"], req["partition"])
        if p is None or not p.is_leader():
            return {"errc": _NOT_LEADER}
        try:
            rm = await self.broker.recovered_rm_stm(p)
            code = await rm.end_tx(req["pid"], req["epoch"], bool(req["commit"]))
            return {"errc": int(code)}
        except Exception:
            logger.exception("tx_marker failed for %s/%d", req["topic"], req["partition"])
            return {"errc": _UNKNOWN_SERVER_ERROR}

    async def tx_group_offsets(self, req: dict) -> dict:
        gm = self.broker.group_coordinator
        group_id = req["group_id"]
        await gm.start()
        if not gm.is_coordinator(group_id):
            return {"errc": _COORDINATOR_NOT_AVAILABLE}
        try:
            commits = decode_commits(req["commits_json"])
            code = await gm.commit_offsets(group_id, "", -1, commits, trusted=True)
            return {"errc": int(code)}
        except Exception:
            logger.exception("tx_group_offsets failed for group %s", group_id)
            return {"errc": _UNKNOWN_SERVER_ERROR}


class TxRouter:
    """Coordinator-side routing: local fast path, RPC to the owner else.

    ``None`` router members (standalone broker) degrade to local-only —
    exactly the previous behavior."""

    def __init__(self, broker, metadata_cache=None, connections=None) -> None:
        self.broker = broker
        self.mdc = metadata_cache
        self.connections = connections

    def _leader_for(self, topic: str, partition: int):
        if self.mdc is None:
            return None
        from redpanda_tpu_torch.models.fundamental import NTP

        return self.mdc.get_leader(NTP.kafka(topic, partition))

    async def _route(
        self, method: str, topic: str, partition: int, pid: int, epoch: int,
        commit: bool = False,
    ) -> int:
        leader = self._leader_for(topic, partition)
        if leader is None or self.connections is None:
            return _NOT_LEADER
        client = rpc.Client(tx_gateway_service, self.connections.get(leader))
        reply = await getattr(client, method)(
            {
                "topic": topic,
                "partition": partition,
                "pid": pid,
                "epoch": epoch,
                "commit": int(commit),
            },
            timeout=10.0,
        )
        return reply["errc"]

    async def begin_tx(
        self, topic: str, partition: int, pid: int, epoch: int
    ) -> int:
        p = self.broker.get_partition(topic, partition)
        if p is not None and p.is_leader():
            rm = await self.broker.recovered_rm_stm(p)
            return int(rm.begin_tx(pid, epoch))
        return await self._route("tx_begin", topic, partition, pid, epoch)

    async def write_marker(
        self, topic: str, partition: int, pid: int, epoch: int, commit: bool
    ) -> int:
        """Returns a kafka ErrorCode VALUE; negative/6/15 are retriable by
        the coordinator's prepare_* re-drive loop."""
        p = self.broker.get_partition(topic, partition)
        if p is not None and p.is_leader():
            rm = await self.broker.recovered_rm_stm(p)
            return int(await rm.end_tx(pid, epoch, commit))
        return await self._route("tx_marker", topic, partition, pid, epoch, commit)

    async def commit_group_offsets(self, group_id: str, commits: dict) -> int:
        gm = self.broker.group_coordinator
        await gm.start()
        if gm.is_coordinator(group_id):
            return int(
                await gm.commit_offsets(group_id, "", -1, commits, trusted=True)
            )
        if self.mdc is None or self.connections is None:
            return _COORDINATOR_NOT_AVAILABLE
        from redpanda_tpu_torch.kafka.server.group_manager import GROUP_TOPIC

        leader = self._leader_for(GROUP_TOPIC, gm.partition_for(group_id))
        if leader is None:
            return _COORDINATOR_NOT_AVAILABLE
        client = rpc.Client(tx_gateway_service, self.connections.get(leader))
        reply = await client.tx_group_offsets(
            {"group_id": group_id, "commits_json": encode_commits(commits)},
            timeout=10.0,
        )
        return reply["errc"]
