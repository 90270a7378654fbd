"""ctypes binding to the host C++ helpers (native/redpanda_native.cc).

The port builds its own copy of that source with ``g++`` into its build
directory (redpanda_tpu_torch/build.py) at first use and binds only the
symbols the port calls: CRC-32C (single buffer and row-batched), the record framing parse
(``rp_parse_record_values``, ``rp_parse_many``), the fused explode + JSON
find (``rp_explode_find``) and its structural-index twin over a table of
per-batch payload pointers (``rp_explode_find2``), the standalone k-path
walk (``rp_find_multi``) and one-value lookup (``rp_json_find``), the
span-table gathers (``rp_gather_*``), the per-path extractors
(``rp_extract_*``), the fused projector (``rp_project_rows``) and fused
extraction (``rp_extract_cols2``), the row packer and unpacker
(``rp_pack_rows``, ``rp_unpack_rows``) and the framers (``rp_frame_records``,
``rp_frame_many``, and the zero-copy ``rp_frame_gather`` /
``rp_frame_many_gather``). Argument conventions follow the JAX package's
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


def _gather_dst_cap(lens: np.ndarray, n: int) -> int:
    """Worst-case framed payload size for n records with value lengths
    ``lens``: value bytes plus <= 16 bytes of varint framing per record."""
    return int(np.maximum(lens, 0).sum()) + 16 * n + 16


def _take_scratch(out: np.ndarray | None, cap: int) -> np.ndarray:
    """The caller's scratch buffer when it fits (an arena hands the same
    buffer back launch after launch), else a fresh one."""
    if (
        out is not None
        and out.dtype == np.uint8
        and out.ndim == 1
        and out.nbytes >= cap
        and out.flags["C_CONTIGUOUS"]
    ):
        return out
    return np.empty(max(cap, 1), dtype=np.uint8)


def _check_gather_cols(src_arr, offsets, lens, n: int) -> None:
    """Every (offset, len) span must lie inside src: the C gather copies
    unchecked."""
    if n and (
        offsets.min() < 0
        or int((offsets + np.maximum(lens, 0)).max()) > src_arr.nbytes
    ):
        raise ValueError("gather (offset, len) span outside the source blob")


def _check_ranges(starts, ends, n: int, what: str) -> None:
    """[start, end) record ranges must be in bounds and not overlap: the C
    walks are unchecked."""
    if len(ends) != len(starts):
        raise ValueError("starts/ends length mismatch")
    if len(starts) and (
        (starts > ends).any()
        or starts.min() < 0
        or ends.max() > n
        or int((ends - starts).sum()) > n
    ):
        raise ValueError(f"{what} ranges out of bounds or overlapping")


def _payload_table(payloads: list[bytes]):
    """(char* table, lengths) of the per-batch payloads: the table holds
    the bytes objects themselves, so they stay alive while it does."""
    p_len = np.fromiter((len(p) for p in payloads), np.int32, len(payloads))
    return (ctypes.c_char_p * len(payloads))(*payloads), p_len


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
            "rp_parse_record_values": (_I32, [ctypes.c_char_p, _SZ, _I32, _P, _P]),
            "rp_parse_many": (_I64, [_P, _P, _P, _P, _I32, _P, _P]),
            "rp_explode_find": (
                _I64,
                [_P, _P, _P, _P, _I32, ctypes.c_char_p, _P, _P, _I32, _P, _P, _P, _P, _P],
            ),
            "rp_explode_find2": (
                _I64,
                [ctypes.POINTER(ctypes.c_char_p), _P, _P, _I32, _P, ctypes.c_char_p,
                 _P, _P, _I32, _P, _P, _P, _P, _P],
            ),
            "rp_extract_cols2": (
                None,
                [ctypes.POINTER(ctypes.c_char_p), _P, _P, _I32, _P, _P, _P, _P, _P, _I32,
                 _P, _I32, ctypes.POINTER(ctypes.c_void_p), _I64, _P, _I32, _I32, _P, _P],
            ),
            "rp_find_multi": (
                _I64, [_P, _P, _P, _I64, ctypes.c_char_p, _P, _P, _I32, _P, _P, _P]
            ),
            "rp_json_find": (_I32, [ctypes.c_char_p, _I64, ctypes.c_char_p, _I32, _P, _P]),
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
            "rp_frame_records": (_I64, [_P, _SZ, _P, _P, _I32, _P, _P]),
            "rp_frame_many": (_I64, [_P, _SZ, _P, _P, _P, _P, _I64, _P, _P, _P, _P]),
            "rp_frame_gather": (_I64, [_P, _P, _P, _P, _I64, _P, _P]),
            "rp_frame_many_gather": (_I64, [_P, _P, _P, _P, _P, _P, _I64, _P, _P, _P, _P]),
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

    def parse_record_values(self, payload: bytes, count: int):
        """Offsets/lengths of each record's value within one batch payload
        (length -1 for a null value)."""
        val_off = np.empty(count, dtype=np.int64)
        val_len = np.empty(count, dtype=np.int32)
        parsed = self._dll.rp_parse_record_values(
            payload, len(payload), count, val_off.ctypes.data, val_len.ctypes.data
        )
        if parsed != count:
            raise ValueError(f"record framing parse failed at record {parsed}/{count}")
        return val_off, val_len

    def explode_find_structural(self, payloads: list[bytes], counts, paths: list[str],
                                build_joined: bool):
        """Structural-index fused parse (rp_explode_find2): the payloads cross
        once as a table of pointers, with no join on the Python side.
        ``build_joined`` also emits their concatenation (built in the
        crossing) for plans whose harvest gathers from it. Returns (joined
        u8 array | None, val_off, val_len, types, vs, ve); val_off is
        absolute into the (possibly virtual) concatenation, as
        explode_find's."""
        counts = _c32(counts)
        ptrs, p_len = _payload_table(payloads)
        total = int(counts.sum())
        blob, path_off, path_len, k = _pack_paths(paths)
        joined = np.empty(max(int(p_len.sum()), 1), dtype=np.uint8) if build_joined else None
        val_off = np.empty(total, dtype=np.int64)
        val_len = np.empty(total, dtype=np.int32)
        types = np.empty((total, k), dtype=np.int8)
        vs = np.empty((total, k), dtype=np.int64)
        ve = np.empty((total, k), dtype=np.int64)
        parsed = self._dll.rp_explode_find2(
            ptrs, p_len.ctypes.data, counts.ctypes.data, len(payloads),
            joined.ctypes.data if joined is not None else None,
            blob, path_off.ctypes.data, path_len.ctypes.data, k,
            val_off.ctypes.data, val_len.ctypes.data,
            types.ctypes.data, vs.ctypes.data, ve.ctypes.data,
        )
        if parsed != total:
            # includes rp_explode_find2's -1 scratch-allocation sentinel
            raise ValueError(f"record framing parse failed at record {parsed}/{total}")
        if joined is not None and int(p_len.sum()) == 0:
            joined = joined[:0]
        return joined, val_off, val_len, types, vs, ve

    def extract_cols2(self, payloads: list[bytes], counts, val_off, val_len, types, vs, ve,
                      pred_descs, n_pad: int, proj_descs=None, r_out: int = 0):
        """Fused extraction (rp_extract_cols2): every predicate column, padded
        to ``n_pad`` rows, and (with ``proj_descs``) the packed projection
        rows, gathered from the span tables in one record-major crossing
        straight from the per-batch payloads. pred_descs is [n, 4] int32
        {kind: 0 num, 1 str, 2 exists; span col; w; 0}; proj_descs follows
        project_rows' layout. Returns (pred arrays in desc order -- num: f32,
        i32, flags; str: bytes [n_pad, w], vlen; exists: u8 --, proj rows |
        None, proj ok | None)."""
        counts = _c32(counts)
        ptrs, p_len = _payload_table(payloads)
        val_off, val_len = _c64(val_off), _c32(val_len)
        types = np.ascontiguousarray(types, dtype=np.int8)
        vs, ve = _c64(vs), _c64(ve)
        pred_descs = _c32(pred_descs)
        n = types.shape[0]
        if n_pad < n or len(val_off) != n or len(val_len) != n or int(counts.sum()) != n:
            raise ValueError(f"extract_cols2: {n} records do not fit the tables or n_pad {n_pad}")
        arrays: list[np.ndarray] = []
        for kind, _col, w, _ in pred_descs:
            if kind == 0:
                arrays += [np.empty(n_pad, np.float32), np.empty(n_pad, np.int32),
                           np.empty(n_pad, np.uint8)]
            elif kind == 1:
                arrays += [np.empty((n_pad, int(w)), np.uint8), np.empty(n_pad, np.int32)]
            else:
                arrays.append(np.empty(n_pad, np.uint8))
        pred_ptrs = (ctypes.c_void_p * max(len(arrays), 1))(*[a.ctypes.data for a in arrays])
        rows = ok = None
        n_proj, rows_ptr, ok_ptr, proj_ptr = 0, None, None, None
        if proj_descs is not None and len(proj_descs):
            proj_descs = _c32(proj_descs)
            rows = np.empty((n, r_out), dtype=np.uint8)
            ok = np.empty(n, dtype=np.bool_)  # the C side writes 0/1 bytes
            n_proj, rows_ptr, ok_ptr = len(proj_descs), rows.ctypes.data, ok.ctypes.data
            proj_ptr = proj_descs.ctypes.data
        self._dll.rp_extract_cols2(
            ptrs, p_len.ctypes.data, counts.ctypes.data, len(payloads),
            val_off.ctypes.data, val_len.ctypes.data,
            types.ctypes.data, vs.ctypes.data, ve.ctypes.data, types.shape[1],
            pred_descs.ctypes.data, len(pred_descs), pred_ptrs, n_pad,
            proj_ptr, n_proj, r_out, rows_ptr, ok_ptr,
        )
        return arrays, rows, ok

    def find_multi(self, joined, offsets, sizes, paths: list[str]):
        """One top-level JSON walk per record locating every single-segment
        path. Returns (types [n, k] i8, vs [n, k] i64, ve [n, k] i64); type 0
        is missing."""
        offsets, sizes = _c64(offsets), _c32(sizes)
        n = len(sizes)
        blob, path_off, path_len, k = _pack_paths(paths)
        joined_arr = np.frombuffer(joined, dtype=np.uint8)
        types = np.empty((n, k), dtype=np.int8)
        vs = np.empty((n, k), dtype=np.int64)
        ve = np.empty((n, k), dtype=np.int64)
        self._dll.rp_find_multi(
            joined_arr.ctypes.data, offsets.ctypes.data, sizes.ctypes.data, n,
            blob, path_off.ctypes.data, path_len.ctypes.data, k,
            types.ctypes.data, vs.ctypes.data, ve.ctypes.data,
        )
        return types, vs, ve

    def json_find(self, value: bytes, path: str) -> tuple[int, int, int]:
        """(type, value start, value end) of ``path`` in one JSON value; types
        0 missing, 1 str, 2 num, 3 true, 4 false, 5 null, 6 object, 7 array."""
        vs = ctypes.c_int64()
        ve = ctypes.c_int64()
        p = path.encode()
        t = self._dll.rp_json_find(value, len(value), p, len(p), ctypes.byref(vs), ctypes.byref(ve))
        return t, vs.value, ve.value

    def frame_records(self, rows, lens, keep) -> tuple[bytes, int]:
        """Frame the kept rows as one records payload: (payload, kept)."""
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        lens = _c32(lens)
        keep = np.ascontiguousarray(keep, dtype=np.uint8)
        n, stride = rows.shape
        if len(lens) != n or len(keep) != n:
            raise ValueError("frame_records column length mismatch")
        dst = np.empty(n * (stride + 16) + 16, dtype=np.uint8)
        kept = ctypes.c_int32()
        length = self._dll.rp_frame_records(
            rows.ctypes.data, stride, lens.ctypes.data, keep.ctypes.data,
            n, dst.ctypes.data, ctypes.byref(kept),
        )
        return dst[:length].tobytes(), kept.value

    def frame_many(self, rows, lens, keep, starts, ends, out=None):
        """Frame many [start, end) record ranges of padded rows in one
        crossing; ``out`` is optional reusable scratch (an arena's). Returns
        (dst, payload_off[r], payload_len[r], kept[r])."""
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        lens = _c32(lens)
        keep = np.ascontiguousarray(keep, dtype=np.uint8)
        starts, ends = _c64(starts), _c64(ends)
        n, stride = rows.shape
        if len(lens) != n or len(keep) != n:
            raise ValueError("frame_many column length mismatch")
        _check_ranges(starts, ends, n, "frame_many")
        dst = _take_scratch(out, n * (stride + 16) + 16)
        n_ranges = len(starts)
        out_off = np.empty(n_ranges, dtype=np.int64)
        out_len = np.empty(n_ranges, dtype=np.int64)
        out_kept = np.empty(n_ranges, dtype=np.int32)
        self._dll.rp_frame_many(
            rows.ctypes.data, stride, lens.ctypes.data, keep.ctypes.data,
            starts.ctypes.data, ends.ctypes.data, n_ranges, dst.ctypes.data,
            out_off.ctypes.data, out_len.ctypes.data, out_kept.ctypes.data,
        )
        return dst, out_off, out_len, out_kept

    def frame_gather(self, src, offsets, lens, keep, out=None) -> tuple[bytes, int]:
        """Zero-copy framing of one record range: kept records frame straight
        from ``src`` through (offset, len) columns. Returns (payload, kept)."""
        offsets, lens = _c64(offsets), _c32(lens)
        keep = np.ascontiguousarray(keep, dtype=np.uint8)
        n = len(offsets)
        if len(lens) != n or len(keep) != n:
            raise ValueError("frame_gather column length mismatch")
        src_arr = np.frombuffer(src, dtype=np.uint8)
        _check_gather_cols(src_arr, offsets, lens, n)
        dst = _take_scratch(out, _gather_dst_cap(lens, n))
        kept = ctypes.c_int32()
        length = self._dll.rp_frame_gather(
            src_arr.ctypes.data, offsets.ctypes.data, lens.ctypes.data,
            keep.ctypes.data, n, dst.ctypes.data, ctypes.byref(kept),
        )
        return dst[:length].tobytes(), kept.value

    def frame_many_gather(self, src, offsets, lens, keep, starts, ends, out=None):
        """Gather-frame many [start, end) record ranges in one crossing, the
        zero-copy twin of frame_many: records frame straight from ``src``
        through per-record (offset, len) columns. ``out`` is optional
        reusable scratch, replaced when too small. Returns (dst,
        payload_off[r], payload_len[r], kept[r])."""
        offsets, lens = _c64(offsets), _c32(lens)
        keep = np.ascontiguousarray(keep, dtype=np.uint8)
        starts, ends = _c64(starts), _c64(ends)
        n = len(offsets)
        if len(lens) != n or len(keep) != n:
            raise ValueError("frame_many_gather column length mismatch")
        _check_ranges(starts, ends, n, "frame_many_gather")
        src_arr = np.frombuffer(src, dtype=np.uint8)
        _check_gather_cols(src_arr, offsets, lens, n)
        dst = _take_scratch(out, _gather_dst_cap(lens, n))
        n_ranges = len(starts)
        out_off = np.empty(n_ranges, dtype=np.int64)
        out_len = np.empty(n_ranges, dtype=np.int64)
        out_kept = np.empty(n_ranges, dtype=np.int32)
        self._dll.rp_frame_many_gather(
            src_arr.ctypes.data, offsets.ctypes.data, lens.ctypes.data,
            keep.ctypes.data, starts.ctypes.data, ends.ctypes.data,
            n_ranges, dst.ctypes.data,
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

    def pack_table_into(self, payloads: list[bytes], rel_off, rel_len, dst: np.ndarray) -> None:
        """rp_pack_rows over a pointer table: batch b's records, at
        ``rel_off[b]`` / ``rel_len[b]`` within ``payloads[b]``, fill the next
        len(rel_len[b]) rows of ``dst`` [n, stride]. The spans are checked
        once for the whole table; each batch is then one bare crossing."""
        if dst.dtype != np.uint8 or dst.ndim != 2 or not dst.flags["C_CONTIGUOUS"]:
            raise ValueError("pack_table_into dst must be contiguous uint8 [n, stride]")
        counts = np.fromiter((len(ln) for ln in rel_len), np.int64, len(rel_len))
        n, stride = dst.shape
        total = int(counts.sum())
        if len(payloads) != len(rel_len) or len(rel_off) != len(rel_len) or total > n:
            raise ValueError(f"pack_table_into: {total} records of {len(rel_len)} batches "
                             f"for {n} rows and {len(payloads)} payloads")
        if total == 0:
            return
        off = _c64(np.concatenate(rel_off))
        ln = _c32(np.concatenate(rel_len))
        if len(off) != total:
            raise ValueError("pack_table_into offsets/lengths mismatch")
        p_len = np.repeat(np.fromiter((len(p) for p in payloads), np.int64, len(payloads)), counts)
        if (off < 0).any() or (off + np.clip(ln, 0, stride) > p_len).any():
            raise ValueError("pack span outside its payload")
        pack = self._dll.rp_pack_rows
        dst_addr, off_addr, ln_addr = dst.ctypes.data, off.ctypes.data, ln.ctypes.data
        row = 0
        for payload, k in zip(payloads, counts.tolist()):
            if k:
                pack(payload, off_addr + 8 * row, ln_addr + 4 * row, k,
                     dst_addr + stride * row, stride)
                row += k

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
