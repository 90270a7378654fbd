"""Embedded async Kafka client (parity with src/v/kafka/client; the JAX
package's kafka/client).

``KafkaClient`` and ``BrokerConnection`` are here; the group-aware consumer
is ``consumer.GroupConsumer`` and the idempotent and transactional producer
``producer.TransactionalProducer``, as in the reference.
"""

from redpanda_tpu_torch.kafka.client.client import KafkaClient, BrokerConnection

__all__ = ["KafkaClient", "BrokerConnection"]
