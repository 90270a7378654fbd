from redpanda_tpu_torch.utils.vint import (
    encode_uvarint,
    decode_uvarint,
    encode_zigzag,
    decode_zigzag,
    uvarint_size,
    zigzag_size,
)
from redpanda_tpu_torch.utils.iobuf import IOBuf

__all__ = [
    "encode_uvarint",
    "decode_uvarint",
    "encode_zigzag",
    "decode_zigzag",
    "uvarint_size",
    "zigzag_size",
    "IOBuf",
]
