"""LZ4 block decode of many streams on the card (K11), and its measured
keep-or-kill probe against host liblz4.

``decode_rows(comp u8 [n, max_in], comp_len i32 [n], max_out)`` returns
(out u8 [n, max_out], out_len i32 [n], ok bool [n]). On CUDA tensors it
launches the hand-written kernel (csrc/lz4_block.cu, one warp per stream
in shared memory); on CPU tensors it runs the plain PyTorch version, the JAX
package's lockstep byte machine: every stream advances one token, length
extension, offset, literal or match byte per step, and stops at the end of
its input after literals or at the first failed check (a write at
op >= max_out, a consumed byte at ip >= comp_len, a match copy with offset
<= 0 or > op). Both give the same three outputs on every stream, rejected
ones included: the output starts zeroed, reads clip their index to the
buffer, the failing step still writes its byte at clip(op), and out_len is
the final op.

``measure_probe`` times the decoder on the card against host liblz4 on
text-like records and reports which is faster on this machine.
``edge_streams`` makes hand-built streams at the decoder's edges, the
test data that holds the kernel to its plain version.

Format (LZ4 block, lz4_Block_format.md): sequences of
  token(1B: lit_len<<4 | match_len) [lit_len ext 255*] literals
  offset(2B LE) [match_len ext 255*]; a match copies match_len+4 bytes from
  ``out[op-offset:]`` (overlap-safe: RLE when offset < length); the last
  sequence ends after its literals with no match.
"""

from __future__ import annotations

import ctypes
import functools
import time

import numpy as np
import torch

from redpanda_tpu_torch import kernels
from redpanda_tpu_torch.device import resolve_device

# byte-machine phases
_TOKEN, _LIT_EXT, _LIT_COPY, _OFF_LO, _OFF_HI, _M_EXT, _M_COPY, _DONE = range(8)


def _check(comp: torch.Tensor, comp_len: torch.Tensor, max_out: int) -> None:
    if comp.dtype != torch.uint8 or comp.dim() != 2 or not comp.is_contiguous():
        raise ValueError("comp must be a contiguous uint8 [n, max_in] tensor")
    if comp.shape[1] < 1 or max_out < 1:
        raise ValueError("max_in and max_out must be >= 1")
    if comp_len.dtype != torch.int32 or comp_len.shape != (comp.shape[0],) or not comp_len.is_contiguous():
        raise ValueError("comp_len must be a contiguous int32 [n] tensor")
    if comp_len.device != comp.device:
        raise ValueError("comp and comp_len must be on one device")
    if comp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {comp.device}")


def decode_plain(comp: torch.Tensor, comp_len: torch.Tensor, max_out: int):
    """Plain PyTorch LZ4 block decoder: the lockstep byte machine."""
    n, max_in = comp.shape
    dev = comp.device
    rows = torch.arange(n, device=dev)
    comp_len = comp_len.to(torch.int32)
    out = torch.zeros((n, max_out), dtype=torch.uint8, device=dev)
    zeros = torch.zeros(n, dtype=torch.int32, device=dev)
    ip, op, lit, mlen, moff = (zeros.clone() for _ in range(5))
    phase = torch.where(comp_len > 0, _TOKEN, _DONE).to(torch.int32)
    ok = torch.ones(n, dtype=torch.bool, device=dev)

    def where(cond, a, b):
        return torch.where(cond, torch.as_tensor(a, dtype=torch.int32, device=dev), b)

    while bool(((phase != _DONE) & ok).any()):
        active = (phase != _DONE) & ok
        cur = comp[rows, ip.clamp(0, max_in - 1)].to(torch.int32)
        is_tok = active & (phase == _TOKEN)
        lit0, ml0 = cur >> 4, cur & 15
        is_lext = active & (phase == _LIT_EXT)
        is_lcpy = active & (phase == _LIT_COPY)
        has_lit = is_lcpy & (lit > 0)
        end_of_input = is_lcpy & (lit == 0) & (ip >= comp_len)
        to_offset = is_lcpy & (lit == 0) & (ip < comp_len)
        is_olo = active & (phase == _OFF_LO)
        is_ohi = active & (phase == _OFF_HI)
        is_mext = active & (phase == _M_EXT)
        is_mcpy = active & (phase == _M_COPY)
        src = out[rows, (op - moff).clamp(0, max_out - 1)].to(torch.int32)

        nph = phase
        nph = where(is_tok & (lit0 == 15), _LIT_EXT, nph)
        nph = where(is_tok & (lit0 != 15), _LIT_COPY, nph)
        nph = where(is_lext & (cur != 255), _LIT_COPY, nph)
        nph = where(end_of_input, _DONE, nph)
        nph = where(to_offset, _OFF_LO, nph)
        nph = where(is_olo, _OFF_HI, nph)
        nph = where(is_ohi & (mlen == 15), _M_EXT, nph)
        nph = where(is_ohi & (mlen != 15), _M_COPY, nph)
        nph = where(is_mext & (cur != 255), _M_COPY, nph)
        nph = where(is_mcpy & (mlen == 1), _TOKEN, nph)

        nlit = torch.where(is_tok, lit0, lit)
        nlit = torch.where(is_lext, nlit + cur, nlit)
        nlit = torch.where(has_lit, nlit - 1, nlit)
        enter_mcpy = (is_ohi & (mlen != 15)) | (is_mext & (cur != 255))
        nml = torch.where(is_tok, ml0, mlen)
        nml = torch.where(is_mext, nml + cur, nml)
        nml = torch.where(enter_mcpy, nml + 4, nml)
        nml = torch.where(is_mcpy, nml - 1, nml)
        nmoff = torch.where(is_olo, cur, moff)
        nmoff = torch.where(is_ohi, nmoff | (cur << 8), nmoff)

        consumed = is_tok | is_lext | has_lit | is_olo | is_ohi | is_mext
        wrote = has_lit | is_mcpy
        widx = op.clamp(0, max_out - 1)
        wbyte = torch.where(has_lit, cur, src).to(torch.uint8)
        out[rows, widx] = torch.where(wrote, wbyte, out[rows, widx])

        ok = ok & ~(wrote & (op >= max_out))
        ok = ok & ~(consumed & (ip >= comp_len))
        ok = ok & ~(is_mcpy & ((moff <= 0) | (moff > op)))
        ip = ip + consumed.to(torch.int32)
        op = op + wrote.to(torch.int32)
        phase, lit, mlen, moff = nph, nlit, nml, nmoff
    return out, op, ok & (phase == _DONE)


def decode_rows(comp: torch.Tensor, comp_len: torch.Tensor, max_out: int):
    """LZ4 block decode (K11) of comp u8 [n, max_in] at comp_len i32 [n]
    -> (out u8 [n, max_out], out_len i32 [n], ok bool [n]). CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    _check(comp, comp_len, max_out)
    if comp.device.type == "cpu":
        return decode_plain(comp, comp_len, max_out)
    n, max_in = comp.shape
    out = torch.empty((n, max_out), dtype=torch.uint8, device=comp.device)
    out_len = torch.empty(n, dtype=torch.int32, device=comp.device)
    ok = torch.empty(n, dtype=torch.bool, device=comp.device)
    if n:
        kernels.LZ4_BLOCK.launch(
            comp.data_ptr(), comp_len.data_ptr(), n, max_in, out.data_ptr(),
            out_len.data_ptr(), ok.data_ptr(), max_out, kernels.stream_handle(comp.device),
        )
    return out, out_len, ok


@functools.lru_cache(maxsize=8)
def _block_decoder(max_in: int, max_out: int, device: torch.device):
    def decode(comp, comp_len):
        c = torch.from_numpy(np.ascontiguousarray(comp, dtype=np.uint8)).to(device)
        if c.dim() != 2 or c.shape[1] != max_in:
            raise ValueError(f"comp must be [n, {max_in}], got {tuple(c.shape)}")
        cl = torch.from_numpy(np.ascontiguousarray(comp_len, dtype=np.int32)).to(device)
        out, out_len, ok = decode_rows(c, cl, max_out)
        return out.cpu().numpy(), out_len.cpu().numpy(), ok.cpu().numpy()

    return decode


def make_block_decoder(max_in: int, max_out: int, device="cuda"):
    """fn(comp uint8 [n, max_in], comp_len int32 [n]) -> (out uint8
    [n, max_out], out_len int32 [n], ok bool [n]) on ``device`` (the card
    unless the caller asks for the CPU; raises without one). ok is False
    when a stream is malformed or overflows max_out."""
    return _block_decoder(int(max_in), int(max_out), resolve_device(device))


# ------------------------------------------------------------------ host refs
def _lz4_block_fn(name: str):
    from redpanda_tpu_torch.compression.codecs import _lz4_handle

    fn = getattr(_lz4_handle(), name)
    if not hasattr(fn, "_rp_typed"):
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        fn._rp_typed = True
    return fn


def lz4_block_compress(data: bytes) -> bytes:
    """Raw LZ4 block via the system liblz4 (the format the decoder speaks)."""
    bound = len(data) + len(data) // 255 + 32
    dst = ctypes.create_string_buffer(bound)
    n = _lz4_block_fn("LZ4_compress_default")(data, dst, len(data), bound)
    if n <= 0:
        raise RuntimeError("LZ4_compress_default failed")
    return dst.raw[:n]


def lz4_block_decompress(data: bytes, max_out: int) -> bytes:
    dst = ctypes.create_string_buffer(max_out)
    n = _lz4_block_fn("LZ4_decompress_safe")(data, dst, len(data), max_out)
    if n < 0:
        raise RuntimeError("LZ4_decompress_safe failed")
    return dst.raw[:n]


def text_records(n_records: int, record_size: int, seed: int = 3) -> list[bytes]:
    """Compressible-but-not-trivial records: 96 words with repeats, cut or
    padded with '.' to ``record_size`` (the reference probe's data: at the
    default seed, the same records it measures)."""
    rng = np.random.default_rng(seed)
    outs = []
    for _ in range(n_records):
        words = rng.choice([b"error", b"warn", b"info", b"trace", b"x" * 16, rng.bytes(8)], 96)
        outs.append(b" ".join(words)[:record_size].ljust(record_size, b"."))
    return outs


def pack_streams(streams: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """Streams as zero-padded rows [n, max_in] (max_in the next power of two
    of the longest) + int32 lengths."""
    max_in = 1 << (max(len(c) for c in streams) - 1).bit_length()
    rows = np.zeros((len(streams), max_in), np.uint8)
    lens = np.zeros(len(streams), np.int32)
    for i, c in enumerate(streams):
        rows[i, : len(c)] = np.frombuffer(c, np.uint8)
        lens[i] = len(c)
    return rows, lens


def _ext(out: bytearray, n: int) -> None:
    """Extension bytes of a length whose token nibble is 15."""
    while n >= 255:
        out.append(255)
        n -= 255
    out.append(n)


def _seq(literals: bytes, offset: int | None = None, match_len: int = 0) -> bytes:
    """One LZ4 sequence: token, literal-length extension, literals and, with
    an offset, the 2-byte offset and the match-length extension."""
    ml = match_len - 4
    out = bytearray([(min(len(literals), 15) << 4) | (min(ml, 15) if offset is not None else 0)])
    if len(literals) >= 15:
        _ext(out, len(literals) - 15)
    out += literals
    if offset is not None:
        out += bytes([offset & 255, offset >> 8])
        if ml >= 15:
            _ext(out, ml - 15)
    return bytes(out)


def edge_streams(max_out: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Hand-made LZ4 streams at the decoder's edges for ``max_out`` (>= 64),
    packed as ``pack_streams`` packs them: (rows u8 [n, max_in], lens i32
    [n]). They are test data for the decoder and its plain version:
      - a match of every offset 1..40 at every length 4..80, after as many
        literals as the offset, then 1-3 final literals;
      - a literal run, and a match, that end exactly at max_out and one
        byte past it, each followed by a final sequence or by nothing;
      - a match at op == offset (its source is byte 0) and at op ==
        offset - 1, offset 0 and offset 65535;
      - length extensions: exactly 15, 15 + 255 and runs of 255s, for the
        literal and the match length, and runs cut off by comp_len;
      - comp_len past max_in (reads clip to the row's last byte), with the
        literals straddling the row's end and with a run of 255s there;
      - rows of random bytes at random lengths.
    """
    rng = np.random.default_rng(seed)

    def text(n: int) -> bytes:
        return rng.integers(97, 123, n, dtype=np.uint8).tobytes()

    streams: list[bytes] = []
    for off in range(1, 41):
        for mlen in range(4, 81):
            streams.append(_seq(text(off), off, mlen) + _seq(text(1 + (off + mlen) % 3)))
    m = max_out
    for tail in (20, 21):  # a final literal run ending at max_out, one past it
        streams.append(_seq(b"abcd", 4, m - 24) + _seq(text(tail)))
    if m <= 2048:  # a literal-only run of max_out bytes, and one more
        streams += [_seq(text(m)), _seq(text(m + 1))]
    streams += [
        _seq(b"ab", 2, m - 2) + bytes([0x00]),  # a match ending at max_out, then no literals
        _seq(b"ab", 2, m - 2) + _seq(b"z"),  # ... then one literal past it
        _seq(b"ab", 2, m - 2),  # ... and the stream ends after the match
        _seq(b"ab", 2, m - 1) + _seq(b"z"),  # a match one byte past max_out
        _seq(b"abc", 3, m - 7) + _seq(b"wxyz"),  # literals ending exactly at max_out
    ]
    for k in (1, 2, 3, 5, 40):  # op == offset (valid), op == offset - 1 (not)
        streams += [_seq(text(k), k, 9) + _seq(b"e"), _seq(text(k - 1), k, 9) + _seq(b"e")]
    streams += [_seq(b"q", 0, 6) + _seq(b"e"), _seq(text(7), 65535, 6) + _seq(b"e")]
    streams += [
        bytes([0xF0, 0x00]) + text(15) + _seq(b"e"),  # literal length exactly 15
        bytes([0xF0, 0xFF, 0x00]) + text(270),  # 15 + 255
        _seq(b"ab", 2, 19) + _seq(b"e"),  # match length exactly 19 (ext 0)
        _seq(b"ab", 2, 4 + 15 + 255 + 255 + 7) + _seq(b"e"),  # ext 255, 255, 7
        bytes([0xF0, 0xFF, 0xFF]),  # a literal extension cut off by comp_len
        bytes([0x1F, 0x61, 0x01, 0x00, 0xFF, 0xFF]),  # a match extension cut off
    ]
    max_in = 1 << (max(len(c) for c in streams) - 1).bit_length()
    over = len(streams)
    # comp_len past max_in: literals straddling the row's end; a run of 255s
    # at its end; a valid stream claiming more input than the row holds
    straddle = bytearray([0xF0])
    _ext(straddle, max_in + 20 - 15)
    streams += [
        bytes(straddle) + text(max_in - len(straddle)),
        bytes([0xF0]) + bytes([0xFF]) * (max_in - 1),
        _seq(b"hello ", 6, 30) + _seq(b"world"),
    ]
    rows, lens = pack_streams(streams + [b"\0"] * 64)
    lens[over : over + 3] = [max_in + 40, max_in + 40, max_in + 5]
    garbage = slice(len(streams), None)
    rows[garbage] = rng.integers(0, 256, size=(64, max_in), dtype=np.uint8)
    lens[garbage] = rng.integers(-2, max_in + 9, 64)
    return rows, lens


def measure_probe(n_records: int = 64, record_size: int = 512, reps: int = 2,
                  device="cuda", compress=None) -> dict:
    """The keep-or-kill numbers: block decode MB/s on ``device`` (the
    entry point from host rows to host rows, and the kernel alone on
    resident tensors) against host liblz4 on the same streams.

    ``compress`` makes the streams (default: liblz4). Where liblz4 cannot
    be loaded, pass another block encoder: the host rate is then reported
    as None and the decision is the device's.
    """
    dev = resolve_device(device)
    outs = text_records(n_records, record_size)
    comp = [(compress or lz4_block_compress)(o) for o in outs]
    rows, lens = pack_streams(comp)
    fn = make_block_decoder(rows.shape[1], record_size, dev)
    out, out_len, ok = fn(rows, lens)  # build + check
    if not ok.all():
        raise RuntimeError("device LZ4 decoder rejected valid streams")
    for i, o in enumerate(outs):
        if out_len[i] != len(o) or out[i, : len(o)].tobytes() != o:
            raise RuntimeError(f"device LZ4 decode mismatch at stream {i}")

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    t0 = time.perf_counter()
    for _ in range(reps):
        fn(rows, lens)
    dev_s = (time.perf_counter() - t0) / reps
    c_t = torch.from_numpy(rows).to(dev)
    l_t = torch.from_numpy(lens).to(dev)
    decode_rows(c_t, l_t, record_size)
    sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        decode_rows(c_t, l_t, record_size)
    sync()
    kernel_s = (time.perf_counter() - t0) / reps
    total = n_records * record_size
    host_mb_s = None
    try:
        _lz4_block_fn("LZ4_decompress_safe")
    except OSError:
        pass
    else:
        t0 = time.perf_counter()
        for _ in range(20):
            for c in comp:
                lz4_block_decompress(c, record_size)
        host_mb_s = total / 1e6 / ((time.perf_counter() - t0) / 20)
    device_mb_s = total / 1e6 / dev_s
    probe = {
        "device": str(dev),
        "records": n_records,
        "record_size": record_size,
        "device_mb_s": round(device_mb_s, 3),
        "kernel_mb_s": round(total / 1e6 / kernel_s, 3),
        "host_mb_s": None if host_mb_s is None else round(host_mb_s, 1),
        "ratio_device_vs_host": None if host_mb_s is None else round(device_mb_s / host_mb_s, 6),
        "decision": "host" if host_mb_s is not None and host_mb_s >= device_mb_s else "device",
    }
    # the keep-or-kill verdict is a governed decision: it lands in the
    # process decision journal. Imported here: ops/ must not import coproc/
    # when it is imported.
    from redpanda_tpu_torch.coproc import governor

    governor.journal_record(
        governor.DEVICE_LZ4,
        probe["decision"],
        f"device block decode {probe['device_mb_s']} MB/s vs host liblz4 "
        f"{probe['host_mb_s']} MB/s (ratio {probe['ratio_device_vs_host']}x)",
        dict(probe),
    )
    return probe
