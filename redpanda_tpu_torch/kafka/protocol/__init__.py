"""Kafka wire encoding: primitives, record-batch adapter, message schemas.

Parity with the reference's src/v/kafka/protocol — request_reader /
response_writer primitives, kafka_batch_adapter, and the request/response
structs codegenned from protocol/schemata/*.json (here: declarative Python
schemas interpreted at runtime instead of generated C++).
"""

from redpanda_tpu_torch.kafka.protocol.primitives import Reader, Writer
from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode

__all__ = ["Reader", "Writer", "ErrorCode"]
