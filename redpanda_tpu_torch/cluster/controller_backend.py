"""Controller backend: per-node reconciliation of topic-table deltas.

Parity with cluster/controller_backend.cc:202-225: a fiber per node watches
the (replicated) topic table's delta stream and converges local state —
create the raft group + partition for assignments that include this node,
tear down removed ones, and drive replica movement (create on new nodes,
joint-consensus config change on the leader, delete on old nodes after
finish). Combined with partition_manager.manage / raft group_manager, this
is the only component that turns metadata into running replicas.

(The JAX package's cluster/controller_backend.py, copied.)
"""

from __future__ import annotations

import asyncio
import logging

from redpanda_tpu_torch.cluster.partition import Partition
from redpanda_tpu_torch.cluster.topic_table import DeltaType, TopicDelta, TopicTable
from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.raft.types import VNode

logger = logging.getLogger("rptorch.cluster.backend")


class ControllerBackend:
    def __init__(
        self,
        self_node: VNode,
        topic_table: TopicTable,
        group_manager,  # raft.GroupManager
        partition_manager,  # cluster.PartitionManager
        leaders_table=None,
        shard_table=None,
        finish_move=None,  # async callable(ntp, replicas) — routes to controller leader
    ) -> None:
        self.self_node = self_node
        self.topic_table = topic_table
        self.gm = group_manager
        self.pm = partition_manager
        self.leaders = leaders_table
        self.shards = shard_table
        self._finish_move = finish_move
        self._task: asyncio.Task | None = None
        self._move_tasks: dict[NTP, asyncio.Task] = {}
        self.gm.register_leadership_notification(self._on_leadership)

    def _on_leadership(self, consensus) -> None:
        if self.leaders is not None:
            self.leaders.update(consensus.ntp, consensus.leader_id, consensus.term)
        # a move issued before this group had a leader parks until an
        # election lands here — re-kick it (controller_backend re-runs its
        # reconciliation loop on leadership change for the same reason)
        if consensus.is_leader():
            pa = self._assignment(consensus.ntp)
            if pa is not None and pa.moving_to is not None:
                ntp, group, target = consensus.ntp, pa.group, list(pa.moving_to)
                if ntp not in self._move_tasks:
                    self._move_tasks[ntp] = asyncio.create_task(
                        self._drive_move(ntp, group, target)
                    )

    # ------------------------------------------------------------ lifecycle
    async def start(self) -> "ControllerBackend":
        # bootstrap: apply everything already in the table (stm replay on
        # restart lands deltas before we start — calculate_bootstrap_deltas
        # controller_backend.cc:217)
        for d in self.topic_table.drain_deltas():
            await self._reconcile(d)
        self._task = asyncio.create_task(self._loop())
        return self

    async def stop(self) -> None:
        for t in self._move_tasks.values():
            t.cancel()
        self._move_tasks.clear()
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

    async def _loop(self) -> None:
        while True:
            try:
                deltas = await self.topic_table.wait_for_deltas()
                for d in deltas:
                    try:
                        await self._reconcile(d)
                    except Exception:
                        logger.exception("reconcile failed for %s", d.ntp)
            except asyncio.CancelledError:
                return

    # ------------------------------------------------------------ reconcile
    def _assignment(self, ntp: NTP):
        md = self.topic_table.get(ntp.topic)
        if md is None:
            return None
        return md.assignments.get(ntp.partition)

    async def _reconcile(self, d: TopicDelta) -> None:
        me = self.self_node.id
        if d.type == DeltaType.added:
            pa = self._assignment(d.ntp) or d.assignment
            if pa is None or me not in pa.replicas:
                return
            await self._create_local(d.ntp, pa)
        elif d.type == DeltaType.removed:
            await self._remove_local(d.ntp)
        elif d.type == DeltaType.updated:
            pa = self._assignment(d.ntp)
            if pa is None:
                return
            if pa.moving_to is not None:
                await self._reconcile_move(d.ntp, pa)
            else:
                # move finished (or plain metadata update): drop our copy if
                # we are no longer a replica
                if me not in pa.replicas and self.pm.get(d.ntp) is not None:
                    await self._remove_local(d.ntp)

    def _log_overrides(self, ntp: NTP):
        md = self.topic_table.get(ntp.topic)
        if md is None:
            return None
        return md.config.log_overrides(self.gm.storage.log_mgr.config)

    async def _create_local(self, ntp: NTP, pa) -> None:
        if self.pm.get(ntp) is not None:
            return
        overrides = self._log_overrides(ntp)
        if pa.group < 0:
            # non-replicated (single-node direct log / materialized topic)
            await self.pm.manage(ntp, log_overrides=overrides)
            return
        if self.gm.consensus_for(pa.group) is None:
            voters = [VNode(r, 0) for r in pa.replicas]
            c = await self.gm.create_group(
                pa.group, ntp, voters, log_overrides=overrides
            )
            p = await Partition(ntp, c, c.log, kvs=self.pm.storage.kvs).start()
            self.pm.attach(ntp, p)

    async def _remove_local(self, ntp: NTP) -> None:
        t = self._move_tasks.pop(ntp, None)
        if t is not None:
            t.cancel()
        p = self.pm.get(ntp)
        if p is None:
            return
        consensus = getattr(p, "consensus", None)
        group = getattr(consensus, "group", None)
        if group is not None and self.gm.consensus_for(group) is not None:
            self.pm.detach(ntp)
            await self.gm.remove_group(group, delete_log=True)
        else:
            await self.pm.remove(ntp)
        if self.leaders is not None:
            self.leaders.remove(ntp)
        if self.shards is not None:
            self.shards.erase(ntp)

    async def _reconcile_move(self, ntp: NTP, pa) -> None:
        me = self.self_node.id
        target = pa.moving_to
        # 1. new replica: bootstrap the group locally with the OLD voter set;
        #    the leader's config change will add us and recovery catches us up
        if me in target and self.pm.get(ntp) is None:
            if self.gm.consensus_for(pa.group) is None:
                voters = [VNode(r, 0) for r in pa.replicas]
                c = await self.gm.create_group(
                    pa.group, ntp, voters, log_overrides=self._log_overrides(ntp)
                )
                p = await Partition(ntp, c, c.log, kvs=self.pm.storage.kvs).start()
                self.pm.attach(ntp, p)
        # 2. current leader: run the joint-consensus change + finish
        c = self.gm.consensus_for(pa.group)
        if c is not None and c.is_leader() and ntp not in self._move_tasks:
            self._move_tasks[ntp] = asyncio.create_task(
                self._drive_move(ntp, pa.group, list(target))
            )

    async def _drive_move(self, ntp: NTP, group: int, target: list[int]) -> None:
        """Retry until the move lands or this node stops leading: a single
        change_configuration can time out while the destination node is
        still bootstrapping the group, and nothing else re-kicks the move."""
        try:
            while True:
                c = self.gm.consensus_for(group)
                pa = self._assignment(ntp)
                if c is None or pa is None or pa.moving_to is None:
                    return  # move finished or partition gone
                if not c.is_leader():
                    return  # new leader's backend takes over via notification
                try:
                    cfg = c.config()
                    already = cfg.old_voters is None and sorted(
                        v.id for v in cfg.voters
                    ) == sorted(target)
                    if not already:
                        await c.change_configuration([VNode(r, 0) for r in target])
                    if self._finish_move is not None:
                        await self._finish_move(ntp, target)
                    return
                except asyncio.CancelledError:
                    raise
                except Exception:
                    logger.warning(
                        "replica move attempt failed for %s -> %s; retrying",
                        ntp, target, exc_info=True,
                    )
                    await asyncio.sleep(0.5)
        finally:
            self._move_tasks.pop(ntp, None)
