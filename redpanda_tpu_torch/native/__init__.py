"""ctypes binding to the host C++ helpers (native/redpanda_native.cc).

The port builds its own copy of that source with ``g++`` into its build
directory (redpanda_tpu_torch/build.py) at first use and binds only the
symbols the port calls: CRC-32C (single buffer and row-batched), the record framing parse
(``rp_parse_many``), the fused explode + JSON find (``rp_explode_find``),
the span-table gathers (``rp_gather_*``), the per-path extractors
(``rp_extract_*``), the fused projector (``rp_project_rows``), the row
packer and unpacker (``rp_pack_rows``, ``rp_unpack_rows``) and the launch
framer (``rp_frame_many``). Argument conventions follow the JAX package's
binding of the same library, so both packages feed the C code identical
buffers.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from redpanda_tpu_torch.build import REPO_ROOT, cached_build

SOURCE = os.path.join(REPO_ROOT, "native", "redpanda_native.cc")

_P = ctypes.c_void_p
_I32 = ctypes.c_int32
_I64 = ctypes.c_int64
_SZ = ctypes.c_size_t


def _pack_paths(paths: list[str]):
    """Paths -> (blob, offsets, lens, k): the path-table layout
    rp_explode_find consumes."""
    k = len(paths)
    encoded = [p.encode() for p in paths]
    blob = b"".join(encoded)
    path_off = np.zeros(k, dtype=np.int32)
    path_len = np.fromiter((len(e) for e in encoded), np.int32, k)
    if k:
        np.cumsum(path_len[:-1], out=path_off[1:])
    return blob, path_off, path_len, k


def _c64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _c32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


class NativeLib:
    def __init__(self, dll: ctypes.CDLL):
        self._dll = dll
        sig = {
            "rp_crc32c_update": (ctypes.c_uint32, [ctypes.c_uint32, ctypes.c_char_p, _SZ]),
            "rp_crc32c": (ctypes.c_uint32, [ctypes.c_char_p, _SZ]),
            "rp_crc32c_many": (None, [_P, _SZ, _SZ, _P, _P]),
            "rp_unpack_rows": (_I64, [_P, _SZ, _P, _SZ, _P]),
            "rp_pack_rows": (_I32, [_P, _P, _P, _SZ, _P, _SZ]),
            "rp_parse_many": (_I64, [_P, _P, _P, _P, _I32, _P, _P]),
            "rp_explode_find": (
                _I64,
                [_P, _P, _P, _P, _I32, ctypes.c_char_p, _P, _P, _I32, _P, _P, _P, _P, _P],
            ),
            "rp_gather_str": (None, [_P, _P, _I64, _P, _P, _P, _I32, _P, _P]),
            "rp_gather_num": (None, [_P, _P, _I64, _P, _P, _P, _P, _P, _P]),
            "rp_extract_str": (
                _I64, [_P, _P, _P, _I64, ctypes.c_char_p, _I32, _I32, _P, _P]
            ),
            "rp_extract_num": (
                _I64, [_P, _P, _P, _I64, ctypes.c_char_p, _I32, _P, _P, _P]
            ),
            "rp_extract_exists": (
                _I64, [_P, _P, _P, _I64, ctypes.c_char_p, _I32, _P]
            ),
            "rp_project_rows": (
                _I64, [_P, _P, _I64, _P, _P, _P, _I32, _P, _I32, _I32, _P, _P]
            ),
            "rp_frame_many": (_I64, [_P, _SZ, _P, _P, _P, _P, _I64, _P, _P, _P, _P]),
        }
        for name, (restype, argtypes) in sig.items():
            fn = getattr(dll, name)
            fn.restype = restype
            fn.argtypes = argtypes

    # ------------------------------------------------------------ crc
    def crc32c_update(self, state: int, data: bytes) -> int:
        return self._dll.rp_crc32c_update(state & 0xFFFFFFFF, data, len(data))

    def crc32c(self, data: bytes) -> int:
        return self._dll.rp_crc32c(data, len(data))

    def crc32c_many(self, rows: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """CRC-32C of each row's first clip(length, 0, stride) bytes."""
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        lengths = _c32(lengths)
        n, stride = rows.shape
        if len(lengths) != n:
            raise ValueError("crc32c_many rows/lengths mismatch")
        out = np.empty(n, dtype=np.uint32)
        self._dll.rp_crc32c_many(rows.ctypes.data, stride, n, lengths.ctypes.data, out.ctypes.data)
        return out

    # ------------------------------------------------------------ framing
    def parse_many(self, joined, payload_off, payload_len, counts):
        """Record value offsets/lengths for many batch payloads in one
        crossing; offsets are absolute into ``joined``."""
        payload_off, payload_len, counts = _c64(payload_off), _c32(payload_len), _c32(counts)
        total = int(counts.sum())
        joined_arr = np.frombuffer(joined, dtype=np.uint8)
        val_off = np.empty(total, dtype=np.int64)
        val_len = np.empty(total, dtype=np.int32)
        parsed = self._dll.rp_parse_many(
            joined_arr.ctypes.data, payload_off.ctypes.data, payload_len.ctypes.data,
            counts.ctypes.data, len(counts), val_off.ctypes.data, val_len.ctypes.data,
        )
        if parsed != total:
            raise ValueError(f"record framing parse failed at record {parsed}/{total}")
        return val_off, val_len

    def explode_find(self, joined, payload_off, payload_len, counts, paths: list[str]):
        """Fused explode + find: record framing parse and the k-path JSON
        walk in one crossing. Returns (val_off, val_len, types, vs, ve)."""
        payload_off, payload_len, counts = _c64(payload_off), _c32(payload_len), _c32(counts)
        total = int(counts.sum())
        blob, path_off, path_len, k = _pack_paths(paths)
        joined_arr = np.frombuffer(joined, dtype=np.uint8)
        val_off = np.empty(total, dtype=np.int64)
        val_len = np.empty(total, dtype=np.int32)
        types = np.empty((total, k), dtype=np.int8)
        vs = np.empty((total, k), dtype=np.int64)
        ve = np.empty((total, k), dtype=np.int64)
        parsed = self._dll.rp_explode_find(
            joined_arr.ctypes.data, payload_off.ctypes.data, payload_len.ctypes.data,
            counts.ctypes.data, len(counts), blob, path_off.ctypes.data,
            path_len.ctypes.data, k, val_off.ctypes.data, val_len.ctypes.data,
            types.ctypes.data, vs.ctypes.data, ve.ctypes.data,
        )
        if parsed != total:
            raise ValueError(f"record framing parse failed at record {parsed}/{total}")
        return val_off, val_len, types, vs, ve

    def frame_many(self, rows, lens, keep, starts, ends):
        """Frame many [start, end) record ranges of padded rows in one
        crossing. Returns (dst, payload_off[r], payload_len[r], kept[r])."""
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        lens = _c32(lens)
        keep = np.ascontiguousarray(keep, dtype=np.uint8)
        starts, ends = _c64(starts), _c64(ends)
        n, stride = rows.shape
        n_ranges = len(starts)
        if len(ends) != n_ranges or len(lens) != n or len(keep) != n:
            raise ValueError("frame_many column length mismatch")
        # the C walk is unchecked: malformed ranges must fail here
        if n_ranges and (
            (starts > ends).any()
            or starts.min() < 0
            or ends.max() > n
            or int((ends - starts).sum()) > n
        ):
            raise ValueError("frame_many ranges out of bounds or overlapping")
        dst = np.empty(n * (stride + 16) + 16, dtype=np.uint8)
        out_off = np.empty(n_ranges, dtype=np.int64)
        out_len = np.empty(n_ranges, dtype=np.int64)
        out_kept = np.empty(n_ranges, dtype=np.int32)
        self._dll.rp_frame_many(
            rows.ctypes.data, stride, lens.ctypes.data, keep.ctypes.data,
            starts.ctypes.data, ends.ctypes.data, n_ranges, dst.ctypes.data,
            out_off.ctypes.data, out_len.ctypes.data, out_kept.ctypes.data,
        )
        return dst, out_off, out_len, out_kept

    def pack_rows_into(self, src, offsets, sizes, dst: np.ndarray) -> int:
        """rp_pack_rows into a caller-provided [n, stride] uint8 block: each
        row takes min(size, stride) source bytes and a zero-filled tail."""
        offsets, sizes = _c64(offsets), _c32(sizes)
        n, stride = dst.shape
        if len(offsets) != n or len(sizes) != n:
            raise ValueError("pack_rows_into offsets/sizes/dst mismatch")
        if dst.dtype != np.uint8 or not dst.flags["C_CONTIGUOUS"]:
            raise ValueError("pack_rows_into dst must be contiguous uint8")
        src_arr = np.frombuffer(src, dtype=np.uint8)
        eff = np.minimum(np.maximum(sizes, 0), stride)
        if n and (offsets.min() < 0 or int((offsets + eff).max()) > src_arr.nbytes):
            raise ValueError("pack span outside the source buffer")
        if n == 0:
            return 0
        return self._dll.rp_pack_rows(
            src_arr.ctypes.data, offsets.ctypes.data, sizes.ctypes.data,
            n, dst.ctypes.data, stride,
        )

    def unpack_rows(self, rows: np.ndarray, sizes: np.ndarray) -> bytes:
        """The first clip(size, 0, stride) bytes of every row, concatenated."""
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        sizes = _c32(sizes)
        n, stride = rows.shape
        if len(sizes) != n:
            raise ValueError("unpack_rows rows/sizes mismatch")
        dst = np.empty(int(np.clip(sizes, 0, stride).sum()), dtype=np.uint8)
        self._dll.rp_unpack_rows(rows.ctypes.data, stride, sizes.ctypes.data, n, dst.ctypes.data)
        return dst.tobytes()

    # ------------------------------------------------------------ columns
    def gather_str(self, joined, offsets, types_col, vs_col, ve_col, w: int):
        offsets = _c64(offsets)
        types_col = np.ascontiguousarray(types_col, dtype=np.int8)
        vs_col, ve_col = _c64(vs_col), _c64(ve_col)
        n = len(offsets)
        joined_arr = np.frombuffer(joined, dtype=np.uint8)
        out = np.empty((n, w), dtype=np.uint8)
        vlen = np.empty(n, dtype=np.int32)
        self._dll.rp_gather_str(
            joined_arr.ctypes.data, offsets.ctypes.data, n, types_col.ctypes.data,
            vs_col.ctypes.data, ve_col.ctypes.data, w, out.ctypes.data, vlen.ctypes.data,
        )
        return out, vlen

    def gather_num(self, joined, offsets, types_col, vs_col, ve_col):
        offsets = _c64(offsets)
        types_col = np.ascontiguousarray(types_col, dtype=np.int8)
        vs_col, ve_col = _c64(vs_col), _c64(ve_col)
        n = len(offsets)
        joined_arr = np.frombuffer(joined, dtype=np.uint8)
        f32 = np.empty(n, dtype=np.float32)
        i32 = np.empty(n, dtype=np.int32)
        flags = np.empty(n, dtype=np.uint8)
        self._dll.rp_gather_num(
            joined_arr.ctypes.data, offsets.ctypes.data, n, types_col.ctypes.data,
            vs_col.ctypes.data, ve_col.ctypes.data,
            f32.ctypes.data, i32.ctypes.data, flags.ctypes.data,
        )
        return f32, i32, flags

    def extract_str(self, joined, offsets, sizes, path: str, w: int):
        """String column ([n, w] raw bytes, [n] true length; -1 = missing)."""
        offsets, sizes = _c64(offsets), _c32(sizes)
        n = len(sizes)
        joined_arr = np.frombuffer(joined, dtype=np.uint8)
        out = np.empty((n, w), dtype=np.uint8)
        vlen = np.empty(n, dtype=np.int32)
        p = path.encode()
        self._dll.rp_extract_str(
            joined_arr.ctypes.data, offsets.ctypes.data, sizes.ctypes.data, n,
            p, len(p), w, out.ctypes.data, vlen.ctypes.data,
        )
        return out, vlen

    def extract_num(self, joined, offsets, sizes, path: str):
        """Numeric column ([n] f32, [n] i32, [n] lattice flags u8)."""
        offsets, sizes = _c64(offsets), _c32(sizes)
        n = len(sizes)
        joined_arr = np.frombuffer(joined, dtype=np.uint8)
        f32 = np.empty(n, dtype=np.float32)
        i32 = np.empty(n, dtype=np.int32)
        flags = np.empty(n, dtype=np.uint8)
        p = path.encode()
        self._dll.rp_extract_num(
            joined_arr.ctypes.data, offsets.ctypes.data, sizes.ctypes.data, n,
            p, len(p), f32.ctypes.data, i32.ctypes.data, flags.ctypes.data,
        )
        return f32, i32, flags

    def extract_exists(self, joined, offsets, sizes, path: str):
        """Presence column: [n] u8, 1 when the path resolves."""
        offsets, sizes = _c64(offsets), _c32(sizes)
        n = len(sizes)
        joined_arr = np.frombuffer(joined, dtype=np.uint8)
        out = np.empty(n, dtype=np.uint8)
        p = path.encode()
        self._dll.rp_extract_exists(
            joined_arr.ctypes.data, offsets.ctypes.data, sizes.ctypes.data, n,
            p, len(p), out.ctypes.data,
        )
        return out

    def project_rows(self, joined, offsets, types, vs, ve, descs, r_out: int):
        """Fused projection of Int/Float/Str fields from the span tables
        into packed rows; descs is [n_fields, 4] int32 {kind, span col, w,
        out off}. Returns (rows [n, r_out] u8, ok [n] bool)."""
        offsets = _c64(offsets)
        types = np.ascontiguousarray(types, dtype=np.int8)
        vs, ve = _c64(vs), _c64(ve)
        descs = _c32(descs)
        n, k = types.shape
        joined_arr = np.frombuffer(joined, dtype=np.uint8)
        rows = np.empty((n, r_out), dtype=np.uint8)
        ok = np.empty(n, dtype=np.bool_)  # the C side writes 0/1 bytes
        self._dll.rp_project_rows(
            joined_arr.ctypes.data, offsets.ctypes.data, n, types.ctypes.data,
            vs.ctypes.data, ve.ctypes.data, k, descs.ctypes.data, len(descs),
            r_out, rows.ctypes.data, ok.ctypes.data,
        )
        return rows, ok


_lock = threading.Lock()
_lib: NativeLib | None = None


def lib() -> NativeLib:
    """The bound library, built on first call; raises when it cannot be
    built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            path = cached_build(
                "redpanda_native",
                [SOURCE],
                lambda out: ["g++", "-O3", "-std=c++17", "-fPIC", "-shared",
                             "-o", out, SOURCE],
            )
            _lib = NativeLib(ctypes.CDLL(path))
        return _lib


def try_lib() -> NativeLib | None:
    """``lib()`` or None when no compiler or source is at hand (callers
    with an exact pure-Python path use this)."""
    try:
        return lib()
    except (OSError, RuntimeError, AttributeError):
        return None
