"""Embedded async Kafka client (parity with src/v/kafka/client; the JAX
package's kafka/client).

``KafkaClient`` and ``BrokerConnection`` are here; the group-aware consumer
and the transactional producer come with the group and transaction
coordinators (ROADMAP item 10b-ii).
"""

from redpanda_tpu_torch.kafka.client.client import KafkaClient, BrokerConnection

__all__ = ["KafkaClient", "BrokerConnection"]
