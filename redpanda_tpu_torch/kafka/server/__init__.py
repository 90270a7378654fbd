"""Kafka protocol server (parity with src/v/kafka/server; the JAX package's
kafka/server).

``KafkaServer`` serves the data-plane and topic-admin APIs over the
``Broker`` aggregate (``broker.py``); the group and transaction
coordinators and the SASL/ACL handlers come with ROADMAP items 10b-ii and
10d.
"""

from redpanda_tpu_torch.kafka.server.protocol import KafkaServer

__all__ = ["KafkaServer"]
