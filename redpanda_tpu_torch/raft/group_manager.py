"""Raft group manager — creates/removes consensus groups on a node.

Parity with raft/group_manager.h:33: owns the shard's heartbeat manager and
the shared recovery throttle (application.cc:556-584), creates a
``Consensus`` per partition replica, routes the raftgen RPC service, and
dispatches leadership notifications to registered callbacks (the partition
leaders table, metadata dissemination). (The JAX package's
raft/group_manager.py; ``device`` — the card by default, raising without
one, or ``"cpu"`` — is passed to every ``Consensus`` and to the heartbeat
manager, where the raft device plane runs their CRC validation and ack
tally.)
"""

from __future__ import annotations

import asyncio
import logging

from redpanda_tpu_torch import rpc
from redpanda_tpu_torch.device import resolve_device
from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.raft.configuration import GroupConfiguration
from redpanda_tpu_torch.raft.consensus import Consensus, RaftTimings
from redpanda_tpu_torch.raft.heartbeat_manager import HeartbeatManager
from redpanda_tpu_torch.raft.service import RaftService, raftgen_service
from redpanda_tpu_torch.raft.types import VNode

logger = logging.getLogger("rptorch.raft.group_manager")


class GroupManager:
    def __init__(
        self,
        self_node: VNode,
        storage,  # StorageApi
        connection_cache: rpc.ConnectionCache,
        timings: RaftTimings | None = None,
        recovery_concurrency: int = 4,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.self_node = self_node
        self.storage = storage
        self.connections = connection_cache
        self.timings = timings or RaftTimings()
        self._groups: dict[int, Consensus] = {}
        self._leadership_callbacks: list = []
        self._recovery_throttle = asyncio.Semaphore(recovery_concurrency)
        self.heartbeats = HeartbeatManager(
            self.client_for, interval_ms=self.timings.heartbeat_interval_ms,
            device=self.device,
        )
        self.service = RaftService(self)

    # ------------------------------------------------------------ wiring
    def client_for(self, node_id: int) -> rpc.Client:
        # Resolve the transport through the cache EVERY call: when a node
        # rejoins on a new address, register() swaps the transport and a
        # cached client would keep dialing the dead one.
        return rpc.Client(raftgen_service, self.connections.get(node_id))

    def register_service(self, protocol: rpc.SimpleProtocol) -> None:
        protocol.register_service(rpc.ServiceHandler(raftgen_service, self.service))

    def register_leadership_notification(self, cb) -> None:
        """cb(consensus) fires on every leadership change on this node."""
        self._leadership_callbacks.append(cb)

    def _on_leadership(self, consensus: Consensus) -> None:
        for cb in self._leadership_callbacks:
            try:
                cb(consensus)
            except Exception:
                logger.exception("leadership callback failed")

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> "GroupManager":
        await self.heartbeats.start()
        return self

    async def stop(self) -> None:
        await self.heartbeats.stop()
        for c in list(self._groups.values()):
            await c.stop()
        self._groups.clear()

    # ------------------------------------------------------------ groups
    def consensus_for(self, group: int) -> Consensus | None:
        return self._groups.get(group)

    def groups(self) -> list[Consensus]:
        return list(self._groups.values())

    async def create_group(
        self,
        group: int,
        ntp: NTP,
        nodes: list[VNode],
        *,
        timings: RaftTimings | None = None,
        log_overrides=None,
    ) -> Consensus:
        assert group not in self._groups, f"group {group} already exists"
        log = await self.storage.log_mgr.manage(ntp, overrides=log_overrides)
        cfg = GroupConfiguration(voters=list(nodes))
        c = Consensus(
            group,
            ntp,
            self.self_node,
            cfg,
            log,
            self.storage.kvs,
            self.client_for,
            timings=timings or self.timings,
            leadership_cb=self._on_leadership,
            recovery_throttle=self._recovery_throttle,
            device=self.device,
        )
        await c.start()
        self._groups[group] = c
        self.heartbeats.register(c)
        return c

    async def remove_group(self, group: int, *, delete_log: bool = False) -> None:
        c = self._groups.pop(group, None)
        if c is None:
            return
        self.heartbeats.deregister(group)
        await c.stop()
        if delete_log:
            await self.storage.log_mgr.remove(c.ntp)
        else:
            await self.storage.log_mgr.shutdown(c.ntp)
