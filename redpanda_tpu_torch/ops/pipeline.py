"""The coproc payload pipeline (K4) around the v1 transform (K3).

``make_packed_pipeline(spec, r_in)`` is the engine's record transform as a
single-buffer program: one uint8 staging array in, one uint8 packed result
out, so each launch is exactly one host-to-device and one device-to-host
copy. Lengths ride in trailing metadata columns of the input rows, and
(out_len, keep) ride in trailing columns of the output rows. The layouts
are the JAX package's (ops/pipeline.py), byte for byte.

``make_record_pipeline`` is the unpacked form (out, masked out_len, keep).
``run_packed`` and ``run_record`` are the kernel's wrappers: CUDA tensors
launch the payload kernel (csrc/payload_transform.cu) in the matching
layout, CPU tensors run the plain PyTorch version.

The output is CRC-free: batches are framed, recompressed and sealed on the
host after the launch (the Kafka CRC covers the compressed payload).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from redpanda_tpu_torch.ops.transforms import (
    TransformProgram,
    TransformSpec,
    _check_lengths,
    _check_rows,
    compile_transform,
    launch_payload_kernel,
    transform_plain,
)

# Trailing metadata columns of the staged input row: int32 LE record length,
# then 4 pad bytes.
IN_META = 8
# Trailing metadata columns of the packed output row: int32 LE out_len,
# uint8 keep flag, 3 pad bytes.
OUT_META = 8


def _le32(cols: torch.Tensor) -> torch.Tensor:
    """uint8 [N, 4] little-endian columns -> int32 [N]."""
    c = cols.to(torch.int32)
    return c[:, 0] | (c[:, 1] << 8) | (c[:, 2] << 16) | (c[:, 3] << 24)


def packed_plain(prog: TransformProgram, staged: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the packed pipeline:
    staged u8 [N, r_in+IN_META] -> packed u8 [N, r_out+OUT_META]."""
    r_in = prog.r_in
    out, out_len, keep = transform_plain(
        prog, staged[:, :r_in], _le32(staged[:, r_in : r_in + 4])
    )
    masked = torch.where(keep, out_len, 0).to(torch.int32)
    lenb = torch.stack([((masked >> (8 * k)) & 0xFF).to(torch.uint8) for k in range(4)], 1)
    pad = torch.zeros((out.shape[0], OUT_META - 5), dtype=torch.uint8, device=staged.device)
    return torch.cat([out, lenb, keep.to(torch.uint8)[:, None], pad], 1)


def record_plain(prog: TransformProgram, data: torch.Tensor, lengths: torch.Tensor):
    """Plain PyTorch version of the unpacked pipeline."""
    out, out_len, keep = transform_plain(prog, data, lengths)
    return out, torch.where(keep, out_len, 0).to(torch.int32), keep


def run_packed(prog: TransformProgram, staged: torch.Tensor) -> torch.Tensor:
    """The packed pipeline's wrapper: staged u8 [N, r_in+IN_META] ->
    packed u8 [N, r_out+OUT_META]."""
    _check_rows(staged, "staged", prog.r_in + IN_META)
    if staged.device.type == "cpu":
        return packed_plain(prog, staged)
    if staged.device.type != "cuda":
        raise ValueError(f"unsupported device {staged.device}")
    out = torch.empty(
        (staged.shape[0], prog.r_out + OUT_META), dtype=torch.uint8, device=staged.device
    )
    launch_payload_kernel(prog, staged, None, out, None, None, mask_len=True)
    return out


def run_record(prog: TransformProgram, data: torch.Tensor, lengths: torch.Tensor):
    """The unpacked pipeline's wrapper: (out, masked out_len, keep)."""
    _check_lengths(data, lengths, prog.r_in)
    if data.device.type == "cpu":
        return record_plain(prog, data, lengths)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    n = data.shape[0]
    out = torch.empty((n, prog.r_out), dtype=torch.uint8, device=data.device)
    out_len = torch.empty(n, dtype=torch.int32, device=data.device)
    keep = torch.empty(n, dtype=torch.bool, device=data.device)
    launch_payload_kernel(prog, data, lengths, out, out_len, keep, mask_len=True)
    return out, out_len, keep


def make_packed_pipeline(spec: TransformSpec, r_in: int):
    """(fn(staged u8 [N, r_in+IN_META]) -> packed u8 [N, r_out+OUT_META], r_out)."""
    prog = compile_transform(spec, r_in)
    return functools.partial(run_packed, prog), prog.r_out


def make_record_pipeline(spec: TransformSpec, r_in: int):
    """(fn(data u8 [N, r_in], lens i32 [N]) -> (out, masked out_len, keep), r_out)."""
    prog = compile_transform(spec, r_in)
    return functools.partial(run_record, prog), prog.r_out


def unpack_result(packed: np.ndarray, r_out: int):
    """Split a fetched packed result (numpy uint8 [N, r_out+OUT_META]) into
    (out [N, r_out], out_len int32 [N], keep bool [N])."""
    out = packed[:, :r_out]
    out_len = packed[:, r_out : r_out + 4].copy().view(np.int32).reshape(-1)
    keep = packed[:, r_out + 4].astype(bool)
    return out, out_len, keep
