from redpanda_tpu_torch.storage.log import DiskLog, LogConfig, AppendResult, LogOffsets
from redpanda_tpu_torch.storage.log_manager import LogManager, StorageApi
from redpanda_tpu_torch.storage.kvstore import KvStore, KeySpace
from redpanda_tpu_torch.storage.snapshot import SnapshotManager, write_snapshot, read_snapshot
from redpanda_tpu_torch.storage.mem_log import MemLog
from redpanda_tpu_torch.storage.recovery import (
    recover_segment,
    scan_valid_prefix_device,
    scan_valid_prefix_host,
)

__all__ = [
    "DiskLog",
    "LogConfig",
    "AppendResult",
    "LogOffsets",
    "LogManager",
    "StorageApi",
    "KvStore",
    "KeySpace",
    "SnapshotManager",
    "write_snapshot",
    "read_snapshot",
    "MemLog",
    "recover_segment",
    "scan_valid_prefix_device",
    "scan_valid_prefix_host",
]
