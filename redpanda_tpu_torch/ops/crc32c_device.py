"""Batched CRC-32C (K5) and its fused validator (K6) on the card.

``crc32c_rows(data u8 [N, r], lengths i32 [N])`` is the CRC-32C of each
row's first clip(len, 0, r) bytes; ``validate_rows(data, lengths,
claimed)`` is ok[i] = crc[i] == claimed[i] and len[i] > 0 (the raw length)
in the same launch. On CUDA tensors both launch the split CRC kernel
(csrc/crc_blocks.cu, ``crc_blocks``) over one block; on CPU tensors they
run the plain PyTorch version, a lockstep table walk over all rows like
``hashing.crc32c.crc32c_many``.
Inside the port a CRC travels as the int32 bit pattern of its uint32 value
(torch has no usable uint32 arithmetic); the numpy entry points
(``make_crc_fn``, ``crc32c_device``) hand out uint32 as the JAX functions
do.

The kernel's tables are built here: slicing-by-8, the register advance
over the 496 bytes a lane skips between its 16-byte blocks, and the
powers x^(8n) mod P that advance a lane's register to the row's end (see
the kernel's source for the design).

The produce path (ops/crc_backend.py), the raft follower plane
(raft/device_plane.py) and the recovery scan (storage/recovery.py) share
these. They, ``validate_segments`` (the validator with a bad count per
segment of rows) and the mesh's CRC checks (parallel/collectives.py) all
launch the one split kernel, which cuts a long row into spans of whole
rounds, one warp each, when the launch has too few rows to fill the card
(``split_layout``), and joins the spans' registers with ``span_table`` and
the powers of ``kernel_tables`` and ``round_powers``; with many rows each
row keeps one warp.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np
import torch

from redpanda_tpu_torch import kernels
from redpanda_tpu_torch.device import constants_on, resolve_device
from redpanda_tpu_torch.hashing.crc32c import TABLE, TABLE8

BLOCK = 16  # bytes a lane takes per round
ROUND = 32 * BLOCK  # bytes a warp takes per round
SPAN_ROUNDS = 4  # csrc/crc_blocks.cu: the fewest rounds a span of a split row holds
SPLIT_WARPS = 8  # the warps of one CTA of that kernel: the most spans a row
WARPS_PER_SM = 16  # split_layout's aim for a launch's warps an SM
MAX_ROW = 1 << 24  # the widest row it takes: the reach of round_powers
MAX_CRC_SHARDS = 120  # its table: four pointers a shard, 480 in all
POLY = 0x82F63B78  # the reflected Castagnoli polynomial


def _advance(states: np.ndarray, nbytes: int) -> np.ndarray:
    """CRC registers advanced over ``nbytes`` zero bytes."""
    s = states.astype(np.uint32)
    for _ in range(nbytes):
        s = TABLE[s & 0xFF] ^ (s >> np.uint32(8))
    return s


@functools.lru_cache(maxsize=1)
def kernel_tables() -> np.ndarray:
    """uint32 [8*256 + 4*256 + ROUND]: slicing-by-8, the skip map over
    ROUND - BLOCK zero bytes sliced by byte, and x^(8n) mod P for n < ROUND
    (x^0 is 0x80000000 in the reflected representation)."""
    b = np.arange(256, dtype=np.uint32)
    sliced = np.concatenate([b << np.uint32(8 * k) for k in range(4)])
    skip = _advance(sliced, ROUND - BLOCK)
    pows = np.zeros(ROUND, dtype=np.uint32)
    x = np.array([0x80000000], dtype=np.uint32)
    for n in range(ROUND):
        pows[n] = x[0]
        x = _advance(x, 1)
    return np.concatenate([TABLE8.reshape(-1), skip, pows]).astype(np.uint32)


def _multmodp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a * b mod P elementwise in the reflected representation (the
    kernel's multmodp)."""
    a, b = np.broadcast_arrays(a.astype(np.uint32), b.astype(np.uint32))
    p = np.zeros(a.shape, np.uint32)
    for k in range(32):
        p ^= np.where(a & np.uint32(0x80000000 >> k), b, np.uint32(0))
        b = np.where(b & np.uint32(1), (b >> np.uint32(1)) ^ np.uint32(POLY), b >> np.uint32(1))
    return p


@functools.lru_cache(maxsize=1)
def round_powers() -> np.ndarray:
    """uint32 [MAX_ROW // ROUND + 1]: x^(8 * ROUND * q) mod P for each q,
    which with ``kernel_tables``' x^(8n), n < ROUND, moves a register over
    any distance up to MAX_ROW bytes: the split kernel's lanes move past
    their span's end with them."""
    n = MAX_ROW // ROUND + 1
    out = np.empty(n, np.uint32)
    out[0] = 0x80000000  # x^0
    out[1] = _advance(out[:1], ROUND)[0]
    done = 2
    while done < n:  # x^(a+b) = x^a * x^b: each pass doubles the known powers
        step = _multmodp(out[done - 1 : done], out[1:2])[0]  # x^(8 ROUND done)
        m = min(done, n - done)
        out[done : done + m] = _multmodp(np.uint32(step), out[:m])
        done += m
    return out


@functools.lru_cache(maxsize=64)
def span_table(span: int) -> np.ndarray:
    """uint32 [4 * 256]: the register advance over ``span`` zero bytes, a
    whole number of rounds (x^(8 span) mod P), byte-sliced as
    ``kernel_tables``' skip map is for ROUND - BLOCK bytes: the split
    kernel joins its full spans with it."""
    if span <= 0 or span % ROUND or span > MAX_ROW:
        raise ValueError(f"span {span} is not a whole number of rounds up to {MAX_ROW}")
    b = np.arange(256, dtype=np.uint32)
    sliced = np.concatenate([b << np.uint32(8 * k) for k in range(4)])
    return _multmodp(round_powers()[span // ROUND], sliced)


def split_layout(r: int, rows: int, sms: int) -> tuple[int, int]:
    """(warps a row, span bytes) of the split kernel for a launch of
    ``rows`` rows of width r on a card of ``sms`` SMs: the most of 1, 2, 4
    and 8 spans of whole rounds that keeps every span at SPAN_ROUNDS rounds
    or more and the launch at WARPS_PER_SM warps an SM or fewer. Splitting
    pays while the rows are too few to fill the card and costs once they
    do (chip_tools/crc_split_ablation.py, PERF.md)."""
    if not 0 <= r <= MAX_ROW:
        raise ValueError(f"row width {r} outside [0, {MAX_ROW}]")
    rounds = max(1, -(-r // ROUND))
    wpr = 1
    while (wpr < SPLIT_WARPS and rounds // (2 * wpr) >= SPAN_ROUNDS
           and rows * 2 * wpr <= WARPS_PER_SM * sms):
        wpr *= 2
    return wpr, -(-rounds // wpr) * ROUND


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device (1 for the CPU, where the split kernel's
    launch code is driven only by tests)."""
    if device.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(device).multi_processor_count


_on_device: dict[torch.device, tuple[torch.Tensor, ...]] = {}
_on_device_lock = threading.Lock()


def _tables_on(device: torch.device) -> tuple[torch.Tensor, ...]:
    """(kernel tables as int32 bit patterns, the byte table as int64, the
    round powers as int32 bit patterns) kept on ``device``."""
    with _on_device_lock:
        if device not in _on_device:
            _on_device[device] = constants_on(
                device, kernel_tables().view(np.int32), TABLE.astype(np.int64),
                round_powers().view(np.int32))
        return _on_device[device]


def kernel_tables_on(device: torch.device) -> torch.Tensor:
    """The CRC kernels' tables (``kernel_tables``) kept on ``device``: the
    split kernel (csrc/crc_blocks.cu) and the fused coproc step
    (csrc/coproc_step.cu) read them."""
    return _tables_on(device)[0]


def round_powers_on(device: torch.device) -> torch.Tensor:
    """``round_powers`` kept on ``device``, for the split kernel."""
    return _tables_on(device)[2]


_span_tables: dict[tuple[torch.device, int], torch.Tensor] = {}


def span_table_on(device: torch.device, span: int) -> torch.Tensor:
    """``span_table(span)`` kept on ``device``, for the split kernel."""
    with _on_device_lock:
        key = (device, span)
        if key not in _span_tables:
            _span_tables[key] = constants_on(device, span_table(span).view(np.int32))[0]
        return _span_tables[key]


def _to_i32(crc: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> their int32 bit patterns."""
    return torch.where(crc >= 1 << 31, crc - (1 << 32), crc).to(torch.int32)


def _check(data: torch.Tensor, lengths: torch.Tensor, claimed: torch.Tensor | None) -> None:
    if data.dtype != torch.uint8 or data.dim() != 2 or not data.is_contiguous():
        raise ValueError("data must be a contiguous uint8 [N, r] tensor")
    n = data.shape[0]
    for name, t in (("lengths", lengths), ("claimed", claimed)):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.shape != (n,) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 [N] tensor")
        if t.device != data.device:
            raise ValueError(f"data and {name} must be on one device")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")


# ------------------------------------------------------------ plain versions
def crc_plain(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch CRC-32C of each row's first clip(len, 0, r) bytes:
    int32 bit patterns [N]."""
    n, r = data.shape
    table = _tables_on(data.device)[1]
    state = torch.full((n,), 0xFFFFFFFF, dtype=torch.int64, device=data.device)
    steps = int(lengths.clamp(0, r).max()) if n else 0
    for j in range(steps):
        nxt = table[(state ^ data[:, j].long()) & 0xFF] ^ (state >> 8)
        state = torch.where(j < lengths, nxt, state)
    return _to_i32(state ^ 0xFFFFFFFF)


def validate_plain(data: torch.Tensor, lengths: torch.Tensor, claimed: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch batch validator: (crc == claimed) & (len > 0), bool [N]."""
    return (crc_plain(data, lengths) == claimed) & (lengths > 0)


def validate_segments_plain(data, lengths, claimed, seg: int):
    """Plain PyTorch validator with a bad count per segment of ``seg``
    rows: (ok bool [N], bad int32 [ceil(N / seg)]), bad = sum(~ok & (len > 0))."""
    ok = validate_plain(data, lengths, claimed)
    bad_rows = (~ok & (lengths > 0)).to(torch.int32)
    n = bad_rows.shape[0]
    n_seg = -(-n // seg)
    pad = torch.zeros(n_seg * seg - n, dtype=torch.int32, device=data.device)
    return ok, torch.cat([bad_rows, pad]).reshape(n_seg, seg).sum(1, dtype=torch.int32)


# ------------------------------------------------------------ wrappers
def crc32c_rows(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """CRC-32C (K5) of each row of data u8 [N, r] at lengths i32 [N]:
    int32 bit patterns [N]. CPU tensors run the plain version; CUDA
    tensors launch the split kernel over the one block."""
    _check(data, lengths, None)
    if data.device.type == "cpu":
        return crc_plain(data, lengths)
    return _crc_rows_launch(data, lengths)


def _one_block(kernel, data, lengths, claimed, crc_out, ok) -> None:
    """One launch of the split kernel's one-block entry point
    (``rp_crc_rows``) over checked rows, contiguous: at a stride of r, as
    the kernel reads them."""
    n, r = data.shape
    if n == 0:
        return
    dev = data.device
    kernel.launch(
        data.data_ptr(), lengths.data_ptr(), None if claimed is None else claimed.data_ptr(), n,
        r, *_layout_args(dev, r, n), None if crc_out is None else crc_out.data_ptr(),
        None if ok is None else ok.data_ptr(), kernels.stream_handle(dev),
    )


def _crc_rows_launch(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """K5's launch over checked rows."""
    out = torch.empty(data.shape[0], dtype=torch.int32, device=data.device)
    _one_block(kernels.CRC32C, data, lengths, None, out, None)
    return out


def validate_rows(data: torch.Tensor, lengths: torch.Tensor, claimed: torch.Tensor) -> torch.Tensor:
    """The batch validator (K6): bool [N], ok[i] = CRC-32C of row i ==
    claimed[i] (int32 bit patterns) and lengths[i] > 0, in one launch."""
    _check(data, lengths, claimed)
    if data.device.type == "cpu":
        return validate_plain(data, lengths, claimed)
    return _validate_rows_launch(data, lengths, claimed)


def _validate_rows_launch(data, lengths, claimed) -> torch.Tensor:
    """K6's launch over checked rows (at a stride of r)."""
    ok = torch.empty(data.shape[0], dtype=torch.bool, device=data.device)
    _one_block(kernels.CRC32C_VALIDATE, data, lengths, claimed, None, ok)
    return ok


@functools.lru_cache(maxsize=None)
def _constant_ptrs(device: torch.device) -> tuple[int, int, int]:
    """(CRC tables, round powers, their count) of tensors kept on
    ``device`` for good."""
    rounds = round_powers_on(device)
    return kernel_tables_on(device).data_ptr(), rounds.data_ptr(), rounds.shape[0]


@functools.lru_cache(maxsize=None)
def _span_table_ptr(device: torch.device, span: int) -> int:
    return span_table_on(device, span).data_ptr()


def _layout_args(device: torch.device, r: int, rows: int) -> tuple:
    """The split kernel's layout arguments for a launch of ``rows`` rows of
    width r on ``device``: (wpr, span, CRC tables, round powers, n_rounds,
    span table or None). A row wider than MAX_ROW keeps one warp, which
    reads neither the powers nor a span table."""
    if r > MAX_ROW:
        wpr, span = 1, -(-r // ROUND) * ROUND
    else:
        wpr, span = split_layout(r, rows, sm_count(device))
    return (wpr, span, *_constant_ptrs(device),
            _span_table_ptr(device, span) if wpr > 1 else None)


def crc_blocks(kernel, blocks, r: int, seg: int, ok: torch.Tensor, bad: torch.Tensor,
               tally: torch.Tensor | None = None) -> None:
    """One launch of ``kernel`` (a row of csrc/crc_blocks.cu's
    ``rp_crc_blocks``) on the current stream over 1..MAX_CRC_SHARDS checked
    CUDA blocks of one card, ``(rows u8 [n, r] at stride r, lengths i32
    [n], claimed i32 [n], votes u8 [m, G] or None)`` each: ok [len(blocks)
    * n] (bool or u8), bad int32 (zeroed by the launch), bad[i // seg]
    counting the bad rows i, and with ``tally`` (int32 [G]) the column sums
    of every block's votes. With no rows and no tally nothing is launched:
    bad is zeroed."""
    rows0 = blocks[0][0]
    n = rows0.shape[0]
    g = 0 if tally is None else tally.shape[0]
    if n * len(blocks) == 0 and g == 0:
        bad.zero_()
        return
    dev = rows0.device
    table = (ctypes.c_void_p * (4 * len(blocks)))(
        *[None if t is None else t.data_ptr() for blk in blocks for t in blk])
    votes = blocks[0][3]
    kernel.launch(
        table, len(blocks), n, r, seg, *_layout_args(dev, r, n * len(blocks)), None,
        ok.data_ptr(), bad.data_ptr(), bad.shape[0], 0 if votes is None else votes.shape[0], g,
        None if tally is None else tally.data_ptr(), kernels.stream_handle(dev),
    )


def validate_segments(data, lengths, claimed, seg: int, kernel):
    """The validator with a bad count per segment of ``seg`` rows: (ok
    bool [N], bad int32 [ceil(N / seg)]); on the card one launch of
    ``kernel`` (the mesh's rows ``crc32c_vote`` and ``crc32c_sharded``)
    over the one block."""
    _check(data, lengths, claimed)
    if seg <= 0:
        raise ValueError(f"segment length {seg} must be positive")
    if data.device.type == "cpu":
        return validate_segments_plain(data, lengths, claimed, seg)
    n = data.shape[0]
    ok = torch.empty(n, dtype=torch.bool, device=data.device)
    bad = torch.empty(-(-n // seg), dtype=torch.int32, device=data.device)
    crc_blocks(kernel, [(data, lengths, claimed, None)], data.shape[1], seg, ok, bad)
    return ok, bad


# ------------------------------------------------------------ numpy entry points
def as_rows(a, device: torch.device, width: int) -> torch.Tensor:
    """A uint8 [N, width] array or tensor as a contiguous tensor on
    ``device``; raises on another shape."""
    t = a if torch.is_tensor(a) else torch.from_numpy(np.ascontiguousarray(a, dtype=np.uint8))
    if t.dim() != 2 or t.shape[1] != width:
        raise ValueError(f"rows must be [N, {width}], got {tuple(t.shape)}")
    return t.to(device=device, dtype=torch.uint8).contiguous()


def as_i32(a, device: torch.device) -> torch.Tensor:
    """Lengths (or uint32 CRCs, as bit patterns) as a contiguous int32
    tensor on ``device``."""
    if torch.is_tensor(a):
        return a.to(device=device, dtype=torch.int32).contiguous()
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)


def as_u32(crc: torch.Tensor) -> np.ndarray:
    return crc.cpu().numpy().view(np.uint32)


@functools.lru_cache(maxsize=16)
def _crc_fn(r: int, device: torch.device):
    def crc_fn(data, lengths) -> np.ndarray:
        return as_u32(crc32c_rows(as_rows(data, device, r), as_i32(lengths, device)))

    return crc_fn


def make_crc_fn(r: int, device="cuda"):
    """fn(data uint8 [N, r], lengths int32 [N]) -> uint32 [N] on ``device``
    (the card unless the caller asks for the CPU; raises without one)."""
    return _crc_fn(int(r), resolve_device(device))


def crc32c_device(data, lengths, device="cuda") -> np.ndarray:
    """CRC-32C of zero-padded records on ``device``, keeping any leading
    shape: data uint8 [..., R], lengths int [...] -> uint32 [...]."""
    data = np.asarray(data, dtype=np.uint8)
    lengths = np.asarray(lengths, dtype=np.int32)
    lead, r = data.shape[:-1], data.shape[-1]
    flat = make_crc_fn(r, device)(data.reshape(-1, r), lengths.reshape(-1))
    return flat.reshape(lead)
