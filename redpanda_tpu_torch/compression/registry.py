"""Codec registry (parity with compression/compression.h:21, compression.cc:18-54).

Static dispatch over ``models.record.Compression``: zlib for gzip, the
zstandard package or the system libzstd for zstd, and lz4-frame and snappy
via ctypes on the system libraries.
"""

from __future__ import annotations

from redpanda_tpu_torch.compression import codecs as _codecs
from redpanda_tpu_torch.models.record import Compression


class CompressionError(Exception):
    pass


_TABLE = {
    Compression.gzip: (_codecs.gzip_compress, _codecs.gzip_uncompress),
    Compression.zstd: (_codecs.zstd_compress, _codecs.zstd_uncompress),
    Compression.lz4: (_codecs.lz4_compress, _codecs.lz4_uncompress),
    Compression.snappy: (_codecs.snappy_compress, _codecs.snappy_uncompress),
}


def _codec(codec) -> tuple | None:
    codec = Compression(codec)
    if codec == Compression.none:
        return None
    try:
        return _TABLE[codec]
    except KeyError:
        raise CompressionError(f"codec {codec.name} unsupported") from None


def compress(data: bytes, codec: Compression | int) -> bytes:
    fns = _codec(codec)
    return bytes(data) if fns is None else fns[0](bytes(data))


def uncompress(data: bytes, codec: Compression | int) -> bytes:
    fns = _codec(codec)
    return bytes(data) if fns is None else fns[1](bytes(data))


def is_available(codec: Compression | int) -> bool:
    """Can this process actually run the codec? gzip (stdlib zlib) always
    can; zstd needs the `zstandard` package or the system libzstd; lz4 and
    snappy need the system libraries. Callers that merely prefer a codec
    (the coproc output recompressor) use this to fall back instead of
    failing per batch."""
    codec = Compression(codec)
    if codec in (Compression.none, Compression.gzip):
        return True
    if codec == Compression.zstd:
        return _codecs.zstd_available()
    try:
        if codec == Compression.lz4:
            _codecs._lz4_handle()
        elif codec == Compression.snappy:
            _codecs._snappy_handle()
        else:
            return False
    except OSError:
        return False
    return True
