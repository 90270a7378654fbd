from redpanda_tpu_torch.hashing.crc32c import Crc32c, crc32c, crc32c_extend

__all__ = ["Crc32c", "crc32c", "crc32c_extend"]
