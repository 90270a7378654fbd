from redpanda_tpu_torch.hashing.crc32c import Crc32c, crc32c, crc32c_extend, crc32c_many
from redpanda_tpu_torch.hashing.jump import jump_consistent_hash
from redpanda_tpu_torch.hashing.xx import xxhash32, xxhash64

__all__ = [
    "Crc32c", "crc32c", "crc32c_extend", "crc32c_many", "jump_consistent_hash",
    "xxhash32", "xxhash64",
]
