"""Metadata cache: the kafka layer's one-stop metadata view.

Parity with cluster/metadata_cache.h (wired application.cc:611-617):
aggregates topic_table (topics/assignments), members_table (brokers) and
partition_leaders_table (who leads what) behind the queries the kafka
handlers need. Pure facade — no state of its own.

(The JAX package's cluster/metadata_cache.py, copied.)
"""

from __future__ import annotations

from redpanda_tpu_torch.cluster.leaders_table import PartitionLeadersTable
from redpanda_tpu_torch.cluster.members import Broker, MembersTable
from redpanda_tpu_torch.cluster.topic_table import TopicMetadata, TopicTable
from redpanda_tpu_torch.models.fundamental import NTP, NodeId


class MetadataCache:
    def __init__(
        self,
        topic_table: TopicTable,
        members: MembersTable,
        leaders: PartitionLeadersTable,
    ) -> None:
        self.topic_table = topic_table
        self.members = members
        self.leaders = leaders

    # ------------------------------------------------------------ brokers
    def all_brokers(self) -> list[Broker]:
        return self.members.all_brokers()

    def get_broker(self, node_id: NodeId) -> Broker | None:
        return self.members.get(node_id)

    # ------------------------------------------------------------ topics
    def contains(self, topic: str) -> bool:
        return self.topic_table.contains(topic)

    def get_topic(self, topic: str) -> TopicMetadata | None:
        return self.topic_table.get(topic)

    def all_topics(self) -> dict[str, TopicMetadata]:
        return self.topic_table.topics()

    # ------------------------------------------------------------ leaders
    def get_leader(self, ntp: NTP) -> NodeId | None:
        leader = self.leaders.get_leader(ntp)
        if leader is not None:
            return leader
        md = self.topic_table.get(ntp.topic)
        if md and ntp.partition in md.assignments:
            pa = md.assignments[ntp.partition]
            if pa.leader is not None:
                return pa.leader
            if pa.group < 0:
                # materialized (non-replicable) partitions have no raft
                # leader; they are written and served by the SOURCE
                # partition's leader (materialized_partition fetch routing)
                from redpanda_tpu_torch.models.fundamental import MaterializedNTP

                m = MaterializedNTP.parse(ntp)
                if m is not None:
                    return self.get_leader(m.source)
        return None

    async def wait_for_leader(self, ntp: NTP, timeout: float = 5.0) -> NodeId:
        return await self.leaders.wait_for_leader(ntp, timeout)
