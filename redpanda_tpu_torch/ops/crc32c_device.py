"""Batched CRC-32C (K5) and its fused validator (K6) on the card.

``crc32c_rows(data u8 [N, r], lengths i32 [N])`` is the CRC-32C of each
row's first clip(len, 0, r) bytes; ``validate_rows(data, lengths,
claimed)`` is ok[i] = crc[i] == claimed[i] and len[i] > 0 (the raw length)
in the same launch. On CUDA tensors both launch the hand-written kernel
(csrc/crc32c.cu); on CPU tensors they run the plain PyTorch version, a
lockstep table walk over all rows like ``hashing.crc32c.crc32c_many``.
Inside the port a CRC travels as the int32 bit pattern of its uint32 value
(torch has no usable uint32 arithmetic); the numpy entry points
(``make_crc_fn``, ``crc32c_device``) hand out uint32 as the JAX functions
do.

The kernel's tables are built here: slicing-by-8, the register advance
over the 496 bytes a lane skips between its 16-byte blocks, and the
powers x^(8n) mod P that advance a lane's register to the row's end (see
the kernel's source for the design).

This is the batched kernel the produce path (ops/crc_backend.py), the raft
follower plane (raft/device_plane.py) and the recovery scan
(storage/recovery.py) share.
"""

from __future__ import annotations

import functools
import threading

import numpy as np
import torch

from redpanda_tpu_torch import kernels
from redpanda_tpu_torch.device import constants_on, resolve_device
from redpanda_tpu_torch.hashing.crc32c import TABLE, TABLE8

BLOCK = 16  # bytes a lane takes per round
ROUND = 32 * BLOCK  # bytes a warp takes per round


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


_on_device: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}
_on_device_lock = threading.Lock()


def _tables_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(kernel tables as int32 bit patterns, the byte table as int64) kept
    on ``device``."""
    with _on_device_lock:
        if device not in _on_device:
            _on_device[device] = constants_on(
                device, kernel_tables().view(np.int32), TABLE.astype(np.int64))
        return _on_device[device]


def kernel_tables_on(device: torch.device) -> torch.Tensor:
    """The CRC kernels' tables (``kernel_tables``) kept on ``device``: the
    batch CRC kernel and the fused coproc step (csrc/coproc_step.cu) read
    them."""
    return _tables_on(device)[0]


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
def _launch(kernel, data, lengths, crc_out, claimed, ok_out, bad_out=None, seg: int = 0) -> None:
    n, r = data.shape
    if n == 0:
        return
    tables = kernel_tables_on(data.device)
    kernel.launch(
        data.data_ptr(), data.stride(0), lengths.data_ptr(), n, r, tables.data_ptr(),
        None if crc_out is None else crc_out.data_ptr(),
        None if claimed is None else claimed.data_ptr(),
        None if ok_out is None else ok_out.data_ptr(),
        None if bad_out is None else bad_out.data_ptr(), seg,
        kernels.stream_handle(data.device),
    )


def crc32c_rows(data: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """CRC-32C (K5) of each row of data u8 [N, r] at lengths i32 [N]:
    int32 bit patterns [N]. CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    _check(data, lengths, None)
    if data.device.type == "cpu":
        return crc_plain(data, lengths)
    out = torch.empty(data.shape[0], dtype=torch.int32, device=data.device)
    _launch(kernels.CRC32C, data, lengths, out, None, None)
    return out


def validate_rows(data: torch.Tensor, lengths: torch.Tensor, claimed: torch.Tensor) -> torch.Tensor:
    """The batch validator (K6): bool [N], ok[i] = CRC-32C of row i ==
    claimed[i] (int32 bit patterns) and lengths[i] > 0, in one launch."""
    _check(data, lengths, claimed)
    if data.device.type == "cpu":
        return validate_plain(data, lengths, claimed)
    ok = torch.empty(data.shape[0], dtype=torch.bool, device=data.device)
    _launch(kernels.CRC32C_VALIDATE, data, lengths, None, claimed, ok)
    return ok


def validate_segments(data, lengths, claimed, seg: int, kernel):
    """The validator with a bad count per segment of ``seg`` rows, in one
    launch of ``kernel`` (the mesh's rows ``crc32c_vote`` and
    ``crc32c_sharded``): (ok bool [N], bad int32 [ceil(N / seg)])."""
    _check(data, lengths, claimed)
    if seg <= 0:
        raise ValueError(f"segment length {seg} must be positive")
    if data.device.type == "cpu":
        return validate_segments_plain(data, lengths, claimed, seg)
    n = data.shape[0]
    ok = torch.empty(n, dtype=torch.bool, device=data.device)
    bad = torch.zeros(-(-n // seg), dtype=torch.int32, device=data.device)
    _launch(kernel, data, lengths, None, claimed, ok, bad, seg)
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
