from redpanda_tpu_torch.coproc.engine import (
    DisableResponseCode,
    EnableResponseCode,
    ErrorPolicy,
    ProcessBatchItem,
    ProcessBatchReply,
    ProcessBatchReplyItem,
    ProcessBatchRequest,
    TorchEngine,
)

__all__ = [
    "DisableResponseCode",
    "EnableResponseCode",
    "ErrorPolicy",
    "ProcessBatchItem",
    "ProcessBatchReply",
    "ProcessBatchReplyItem",
    "ProcessBatchRequest",
    "TorchEngine",
]
