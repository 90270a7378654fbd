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
from redpanda_tpu_torch.models.reader import (
    RecordBatchReader,
    make_generator_reader,
    make_memory_reader,
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
    "RecordBatchReader",
    "make_memory_reader",
    "make_generator_reader",
]
