"""Individual codec implementations.

- gzip: stdlib zlib (parity with compression/internal/gzip_compressor).
- zstd at level 3: the `zstandard` package when it imports, else the
  system libzstd through ctypes (ZSTD_compressCCtx / the streaming
  decompressor), so a host without the package still reads and writes zstd
  batches; either way one compression and one decompression context per
  thread.
- lz4: LZ4 *frame* format via ctypes on the system liblz4
  (parity with compression/internal/lz4_frame_compressor).
- snappy: xerial/java-framed snappy via ctypes on the system libsnappy
  (parity with compression/internal/snappy_java_compressor — Kafka's snappy
  framing is the xerial stream format).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import struct
import threading
import zlib

try:
    import zstandard
except ImportError:  # the ctypes libzstd path below serves instead
    zstandard = None

# ------------------------------------------------------------------ gzip

def gzip_compress(data: bytes) -> bytes:
    co = zlib.compressobj(wbits=31)  # gzip container
    return co.compress(data) + co.flush()


def gzip_uncompress(data: bytes) -> bytes:
    return zlib.decompress(data, wbits=47)  # auto gzip/zlib


# ------------------------------------------------------------------ zstd
ZSTD_LEVEL = 3
# one compressor and decompressor per thread: a zstd context may not be
# used by two threads at once
_zstd_local = threading.local()


class _ZstdInBuffer(ctypes.Structure):
    _fields_ = [("src", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


class _ZstdOutBuffer(ctypes.Structure):
    _fields_ = [("dst", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def _load_zstd():
    path = ctypes.util.find_library("zstd") or "libzstd.so.1"
    lib = ctypes.CDLL(path)
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_isError.restype = ctypes.c_uint
    lib.ZSTD_isError.argtypes = [ctypes.c_size_t]
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_createCCtx.argtypes = []
    lib.ZSTD_freeCCtx.restype = ctypes.c_size_t
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    lib.ZSTD_compressCCtx.restype = ctypes.c_size_t
    lib.ZSTD_compressCCtx.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
        ctypes.c_int,
    ]
    lib.ZSTD_createDStream.restype = ctypes.c_void_p
    lib.ZSTD_createDStream.argtypes = []
    lib.ZSTD_freeDStream.restype = ctypes.c_size_t
    lib.ZSTD_freeDStream.argtypes = [ctypes.c_void_p]
    lib.ZSTD_initDStream.restype = ctypes.c_size_t
    lib.ZSTD_initDStream.argtypes = [ctypes.c_void_p]
    lib.ZSTD_decompressStream.restype = ctypes.c_size_t
    lib.ZSTD_decompressStream.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_ZstdOutBuffer), ctypes.POINTER(_ZstdInBuffer),
    ]
    return lib


_zstd_lib = None


def _zstd_handle():
    global _zstd_lib
    if _zstd_lib is None:
        _zstd_lib = _load_zstd()
    return _zstd_lib


def zstd_available() -> bool:
    if zstandard is not None:
        return True
    try:
        _zstd_handle()
    except OSError:
        return False
    return True


class _ZstdLibCtx:
    """This thread's libzstd compression context, decompression stream and
    output chunk, made once and reused. ZSTD_compress makes and frees a
    context of hundreds of KB on every call, and threads that seal at once
    then queue on the process's memory map. Freed when the thread ends."""

    def __init__(self, lib):
        self.lib = lib
        self.cctx = lib.ZSTD_createCCtx()
        self.dstream = lib.ZSTD_createDStream()
        if not self.cctx or not self.dstream:
            raise RuntimeError("ZSTD_createCCtx / ZSTD_createDStream failed")
        self.chunk = ctypes.create_string_buffer(256 * 1024)

    def __del__(self):
        if getattr(self, "cctx", None):
            self.lib.ZSTD_freeCCtx(self.cctx)
        if getattr(self, "dstream", None):
            self.lib.ZSTD_freeDStream(self.dstream)


def _zstd_lib_ctx() -> _ZstdLibCtx:
    ctx = getattr(_zstd_local, "lib_ctx", None)
    if ctx is None:
        ctx = _zstd_local.lib_ctx = _ZstdLibCtx(_zstd_handle())
    return ctx


def _zstd_ctx():
    """This thread's reusable (compressor, decompressor) (parity with the
    stream_zstd workspaces, one per thread)."""
    ctx = getattr(_zstd_local, "ctx", None)
    if ctx is None:
        ctx = _zstd_local.ctx = (zstandard.ZstdCompressor(level=ZSTD_LEVEL),
                                 zstandard.ZstdDecompressor())
    return ctx


def zstd_compress(data: bytes) -> bytes:
    if zstandard is not None:
        zc, _ = _zstd_ctx()
        return zc.compress(data)
    ctx = _zstd_lib_ctx()
    lib = ctx.lib
    bound = lib.ZSTD_compressBound(len(data))
    dst = ctypes.create_string_buffer(bound)
    # the bytes of ZSTD_compress at this level, from the reused context
    n = lib.ZSTD_compressCCtx(ctx.cctx, dst, bound, data, len(data), ZSTD_LEVEL)
    if lib.ZSTD_isError(n):
        raise RuntimeError("ZSTD_compressCCtx failed")
    return ctypes.string_at(dst, n)


def zstd_uncompress(data: bytes) -> bytes:
    # Streaming loop: handles frames without a content-size header (the
    # form streaming producers emit) with no fixed output cap.
    if zstandard is not None:
        _, zd = _zstd_ctx()
        return zd.decompressobj().decompress(data)
    ctx = _zstd_lib_ctx()
    lib, ds, chunk = ctx.lib, ctx.dstream, ctx.chunk
    if lib.ZSTD_isError(lib.ZSTD_initDStream(ds)):  # resets the reused stream
        raise RuntimeError("ZSTD_initDStream failed")
    src = ctypes.create_string_buffer(bytes(data), len(data))
    inb = _ZstdInBuffer(ctypes.cast(src, ctypes.c_void_p), len(data), 0)
    out = bytearray()
    while True:
        outb = _ZstdOutBuffer(ctypes.cast(chunk, ctypes.c_void_p), len(chunk), 0)
        rc = lib.ZSTD_decompressStream(ds, ctypes.byref(outb), ctypes.byref(inb))
        if lib.ZSTD_isError(rc):
            raise RuntimeError("ZSTD_decompressStream failed")
        out += ctypes.string_at(chunk, outb.pos)
        if inb.pos >= inb.size and outb.pos < outb.size:
            return bytes(out)


# ------------------------------------------------------------------ lz4 frame
_LZ4F_VERSION = 100


def _load_lz4():
    path = ctypes.util.find_library("lz4") or "liblz4.so.1"
    lib = ctypes.CDLL(path)
    lib.LZ4F_compressFrameBound.restype = ctypes.c_size_t
    lib.LZ4F_compressFrameBound.argtypes = [ctypes.c_size_t, ctypes.c_void_p]
    lib.LZ4F_compressFrame.restype = ctypes.c_size_t
    lib.LZ4F_compressFrame.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
    ]
    lib.LZ4F_isError.restype = ctypes.c_uint
    lib.LZ4F_isError.argtypes = [ctypes.c_size_t]
    lib.LZ4F_createDecompressionContext.restype = ctypes.c_size_t
    lib.LZ4F_createDecompressionContext.argtypes = [ctypes.POINTER(ctypes.c_void_p), ctypes.c_uint]
    lib.LZ4F_freeDecompressionContext.restype = ctypes.c_size_t
    lib.LZ4F_freeDecompressionContext.argtypes = [ctypes.c_void_p]
    lib.LZ4F_decompress.restype = ctypes.c_size_t
    lib.LZ4F_decompress.argtypes = [
        ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
        ctypes.c_void_p,
    ]
    return lib


_lz4_lib = None


def _lz4_handle():
    global _lz4_lib
    if _lz4_lib is None:
        _lz4_lib = _load_lz4()
    return _lz4_lib


class _Lz4Proxy:
    def __getattr__(self, name):
        return getattr(_lz4_handle(), name)


_lz4 = _Lz4Proxy()


def lz4_compress(data: bytes) -> bytes:
    bound = _lz4.LZ4F_compressFrameBound(len(data), None)
    dst = ctypes.create_string_buffer(bound)
    n = _lz4.LZ4F_compressFrame(dst, bound, data, len(data), None)
    if _lz4.LZ4F_isError(n):
        raise RuntimeError("LZ4F_compressFrame failed")
    return dst.raw[:n]


def lz4_uncompress(data: bytes) -> bytes:
    ctx = ctypes.c_void_p()
    err = _lz4.LZ4F_createDecompressionContext(ctypes.byref(ctx), _LZ4F_VERSION)
    if _lz4.LZ4F_isError(err):
        raise RuntimeError("LZ4F context creation failed")
    try:
        out = bytearray()
        src = ctypes.create_string_buffer(bytes(data), len(data))
        src_off = 0
        chunk = ctypes.create_string_buffer(256 * 1024)
        while src_off < len(data):
            dst_size = ctypes.c_size_t(len(chunk))
            src_size = ctypes.c_size_t(len(data) - src_off)
            rc = _lz4.LZ4F_decompress(
                ctx,
                chunk, ctypes.byref(dst_size),
                ctypes.byref(src, src_off), ctypes.byref(src_size),
                None,
            )
            if _lz4.LZ4F_isError(rc):
                raise RuntimeError("LZ4F_decompress failed")
            out += chunk.raw[: dst_size.value]
            src_off += src_size.value
            if rc == 0 and src_size.value == 0:
                break
        return bytes(out)
    finally:
        _lz4.LZ4F_freeDecompressionContext(ctx)


# ------------------------------------------------------------------ snappy (xerial-framed)
def _load_snappy():
    path = ctypes.util.find_library("snappy") or "libsnappy.so.1"
    lib = ctypes.CDLL(path)
    lib.snappy_compress.restype = ctypes.c_int
    lib.snappy_compress.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.snappy_uncompress.restype = ctypes.c_int
    lib.snappy_uncompress.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
    ]
    lib.snappy_max_compressed_length.restype = ctypes.c_size_t
    lib.snappy_max_compressed_length.argtypes = [ctypes.c_size_t]
    lib.snappy_uncompressed_length.restype = ctypes.c_int
    lib.snappy_uncompressed_length.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_size_t),
    ]
    return lib


_snappy_lib = None


def _snappy_handle():
    global _snappy_lib
    if _snappy_lib is None:
        _snappy_lib = _load_snappy()
    return _snappy_lib


class _SnappyProxy:
    def __getattr__(self, name):
        return getattr(_snappy_handle(), name)


_snappy = _SnappyProxy()

_XERIAL_MAGIC = b"\x82SNAPPY\x00"
_XERIAL_HEADER = _XERIAL_MAGIC + struct.pack(">ii", 1, 1)
_XERIAL_BLOCK = 32 * 1024


def _snappy_raw_compress(data: bytes) -> bytes:
    bound = _snappy.snappy_max_compressed_length(len(data))
    dst = ctypes.create_string_buffer(bound)
    n = ctypes.c_size_t(bound)
    rc = _snappy.snappy_compress(data, len(data), dst, ctypes.byref(n))
    if rc != 0:
        raise RuntimeError("snappy_compress failed")
    return dst.raw[: n.value]


def _snappy_raw_uncompress(data: bytes) -> bytes:
    buf = ctypes.create_string_buffer(bytes(data), len(data))
    n = ctypes.c_size_t()
    rc = _snappy.snappy_uncompressed_length(buf, len(data), ctypes.byref(n))
    if rc != 0:
        raise RuntimeError("snappy_uncompressed_length failed")
    dst = ctypes.create_string_buffer(n.value)
    out_n = ctypes.c_size_t(n.value)
    rc = _snappy.snappy_uncompress(buf, len(data), dst, ctypes.byref(out_n))
    if rc != 0:
        raise RuntimeError("snappy_uncompress failed")
    return dst.raw[: out_n.value]


def snappy_compress(data: bytes) -> bytes:
    out = bytearray(_XERIAL_HEADER)
    for i in range(0, max(len(data), 1), _XERIAL_BLOCK):
        block = data[i : i + _XERIAL_BLOCK]
        comp = _snappy_raw_compress(block)
        out += struct.pack(">i", len(comp)) + comp
    return bytes(out)


def snappy_uncompress(data: bytes) -> bytes:
    if data[: len(_XERIAL_MAGIC)] != _XERIAL_MAGIC:
        # raw snappy block (non-java producers)
        return _snappy_raw_uncompress(data)
    pos = len(_XERIAL_HEADER)
    out = bytearray()
    while pos < len(data):
        (blen,) = struct.unpack_from(">i", data, pos)
        pos += 4
        out += _snappy_raw_uncompress(data[pos : pos + blen])
        pos += blen
    return bytes(out)
