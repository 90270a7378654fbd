from redpanda_tpu_torch.models.fundamental import NTP, MaterializedNTP, NodeId, Offset, Term
from redpanda_tpu_torch.models.record import (
    INTERNAL_HEADER_SIZE,
    Compression,
    Record,
    RecordBatch,
    RecordBatchHeader,
    RecordBatchType,
    RecordHeader,
    TimestampType,
)

__all__ = [
    "NTP",
    "MaterializedNTP",
    "Offset",
    "Term",
    "NodeId",
    "Record",
    "RecordHeader",
    "RecordBatch",
    "RecordBatchHeader",
    "RecordBatchType",
    "Compression",
    "TimestampType",
    "INTERNAL_HEADER_SIZE",
]
