from redpanda_tpu_torch.hashing.crc32c import Crc32c, crc32c, crc32c_extend, crc32c_many

__all__ = ["Crc32c", "crc32c", "crc32c_extend", "crc32c_many"]
