from redpanda_tpu_torch.compression.registry import compress, is_available, uncompress

__all__ = ["compress", "uncompress", "is_available"]
