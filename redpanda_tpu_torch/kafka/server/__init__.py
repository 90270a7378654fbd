"""Kafka protocol server (parity with src/v/kafka/server; the JAX package's
kafka/server).

``KafkaServer`` serves the data-plane, topic-admin, consumer-group and
transaction APIs over the ``Broker`` aggregate (``broker.py``); the SASL/ACL
handlers come with ROADMAP item 10d.
"""

from redpanda_tpu_torch.kafka.server.protocol import KafkaServer

__all__ = ["KafkaServer"]
