"""xxHash64 and xxHash32 (parity with hashing/xx.h).

Used for the coproc script checksum (``ScriptHandle.checksum``) and the rpc
payload checksum (rpc/wire.py). The machine with the card has no
``xxhash`` package, so the port computes the hashes itself: the reference
algorithm (xxHash 0.8's XXH64 and XXH32) over 64-bit and 32-bit words,
with every intermediate masked to its width. ``data`` is bytes-like or a
str (hashed as UTF-8); ``seed`` is taken modulo 2**64 (2**32 for xxHash32),
as the ``xxhash`` package takes it.

XXH64 over inputs of ``_NATIVE_MIN`` bytes or more runs in a small C
helper (native/xxhash64.cc, built with g++ at first use): in plain Python
it takes ~0.3 s a MiB, and every raft append crosses the wire behind one.
Where the helper cannot be built, the plain Python below serves.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading

_M64 = (1 << 64) - 1
_P64_1 = 0x9E3779B185EBCA87
_P64_2 = 0xC2B2AE3D27D4EB4F
_P64_3 = 0x165667B19E3779F9
_P64_4 = 0x85EBCA77C2B2AE63
_P64_5 = 0x27D4EB2F165667C5

_M32 = (1 << 32) - 1
_P32_1 = 0x9E3779B1
_P32_2 = 0x85EBCA77
_P32_3 = 0xC2B2AE3D
_P32_4 = 0x27D4EB2F
_P32_5 = 0x165667B1


def _bytes(data) -> bytes:
    return data.encode() if isinstance(data, str) else bytes(data)


def _rotl64(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round64(acc: int, lane: int) -> int:
    acc = (acc + lane * _P64_2) & _M64
    return (_rotl64(acc, 31) * _P64_1) & _M64


def _merge64(h: int, v: int) -> int:
    h ^= _round64(0, v)
    return (h * _P64_1 + _P64_4) & _M64


# below this the ctypes call costs more than the Python loop saves
_NATIVE_MIN = 256

_native_lock = threading.Lock()
_native_fn = None  # None: not tried yet; False: unavailable


def _native_xxh64():
    """The C helper's ``rp_xxh64``, built on first call, or False."""
    global _native_fn
    if _native_fn is None:
        with _native_lock:
            if _native_fn is None:
                from redpanda_tpu_torch.build import cached_build

                src = os.path.join(
                    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "native", "xxhash64.cc",
                )
                try:
                    path = cached_build(
                        "xxhash64", [src],
                        lambda out: ["g++", "-O3", "-std=c++17", "-fPIC",
                                     "-shared", "-o", out, src],
                    )
                    fn = ctypes.CDLL(path).rp_xxh64
                except (OSError, RuntimeError, AttributeError):
                    fn = False
                else:
                    fn.restype = ctypes.c_uint64
                    fn.argtypes = [ctypes.c_char_p, ctypes.c_size_t, ctypes.c_uint64]
                _native_fn = fn
    return _native_fn


def xxhash64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` as an unsigned int."""
    b = _bytes(data)
    n = len(b)
    seed &= _M64
    if n >= _NATIVE_MIN:
        fn = _native_xxh64()
        if fn:
            return fn(b, n, seed)
    return _xxhash64_py(b, n, seed)


def _xxhash64_py(b: bytes, n: int, seed: int) -> int:
    p = 0
    if n >= 32:
        v1 = (seed + _P64_1 + _P64_2) & _M64
        v2 = (seed + _P64_2) & _M64
        v3 = seed
        v4 = (seed - _P64_1) & _M64
        stripes = n // 32
        words = struct.unpack_from(f"<{4 * stripes}Q", b)
        for i in range(0, 4 * stripes, 4):
            v1 = _rotl64((v1 + words[i] * _P64_2) & _M64, 31) * _P64_1 & _M64
            v2 = _rotl64((v2 + words[i + 1] * _P64_2) & _M64, 31) * _P64_1 & _M64
            v3 = _rotl64((v3 + words[i + 2] * _P64_2) & _M64, 31) * _P64_1 & _M64
            v4 = _rotl64((v4 + words[i + 3] * _P64_2) & _M64, 31) * _P64_1 & _M64
        h = (_rotl64(v1, 1) + _rotl64(v2, 7) + _rotl64(v3, 12) + _rotl64(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = _merge64(h, v)
        p = 32 * stripes
    else:
        h = (seed + _P64_5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        (k,) = struct.unpack_from("<Q", b, p)
        h ^= _round64(0, k)
        h = (_rotl64(h, 27) * _P64_1 + _P64_4) & _M64
        p += 8
    if p + 4 <= n:
        (k,) = struct.unpack_from("<I", b, p)
        h ^= (k * _P64_1) & _M64
        h = (_rotl64(h, 23) * _P64_2 + _P64_3) & _M64
        p += 4
    while p < n:
        h ^= (b[p] * _P64_5) & _M64
        h = (_rotl64(h, 11) * _P64_1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P64_2) & _M64
    h ^= h >> 29
    h = (h * _P64_3) & _M64
    return h ^ (h >> 32)


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxhash32(data, seed: int = 0) -> int:
    """XXH32 of ``data`` as an unsigned int."""
    b = _bytes(data)
    n = len(b)
    seed &= _M32
    p = 0
    if n >= 16:
        v1 = (seed + _P32_1 + _P32_2) & _M32
        v2 = (seed + _P32_2) & _M32
        v3 = seed
        v4 = (seed - _P32_1) & _M32
        stripes = n // 16
        words = struct.unpack_from(f"<{4 * stripes}I", b)
        for i in range(0, 4 * stripes, 4):
            v1 = _rotl32((v1 + words[i] * _P32_2) & _M32, 13) * _P32_1 & _M32
            v2 = _rotl32((v2 + words[i + 1] * _P32_2) & _M32, 13) * _P32_1 & _M32
            v3 = _rotl32((v3 + words[i + 2] * _P32_2) & _M32, 13) * _P32_1 & _M32
            v4 = _rotl32((v4 + words[i + 3] * _P32_2) & _M32, 13) * _P32_1 & _M32
        h = (_rotl32(v1, 1) + _rotl32(v2, 7) + _rotl32(v3, 12) + _rotl32(v4, 18)) & _M32
        p = 16 * stripes
    else:
        h = (seed + _P32_5) & _M32
    h = (h + n) & _M32
    while p + 4 <= n:
        (k,) = struct.unpack_from("<I", b, p)
        h = (h + k * _P32_3) & _M32
        h = (_rotl32(h, 17) * _P32_4) & _M32
        p += 4
    while p < n:
        h = (h + b[p] * _P32_5) & _M32
        h = (_rotl32(h, 11) * _P32_1) & _M32
        p += 1
    h ^= h >> 15
    h = (h * _P32_2) & _M32
    h ^= h >> 13
    h = (h * _P32_3) & _M32
    return h ^ (h >> 16)
