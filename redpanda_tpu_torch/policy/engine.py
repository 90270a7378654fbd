"""Policy execution: device (the packed payload kernel, K4) and host (plain
Python), the JAX package's policy/engine.py.

The host evaluator is bit-exact with the device pipeline by construction:
it simulates the same byte-level semantics (fixed windows, zero padding, the
9-digit Int bound) rather than parsing JSON properly.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from redpanda_tpu_torch.compression import compress
from redpanda_tpu_torch.coproc import batch_codec
from redpanda_tpu_torch.coproc.engine import pack_staged
from redpanda_tpu_torch.device import resolve_device
from redpanda_tpu_torch.models.record import Compression, Record, RecordBatch
from redpanda_tpu_torch.ops.pipeline import IN_META, make_packed_pipeline, unpack_result
from redpanda_tpu_torch.ops.transforms import (
    Int,
    Str,
    TransformSpec,
    _FilterContains,
    _INT_WINDOW,
    _MapProject,
    _MapUppercase,
)

_NUM_CONT = frozenset(b"0123456789.eE+-")


# ------------------------------------------------------------------ host path
def _find_pattern_py(value: bytes, pat: bytes, require_nonnum_suffix: bool) -> int:
    """First valid start of ``pat`` in value, else -1 (the kernel's scan)."""
    start = 0
    while True:
        i = value.find(pat, start)
        if i < 0:
            return -1
        if not require_nonnum_suffix:
            return i
        end = i + len(pat)
        if end >= len(value) or value[end] not in _NUM_CONT:
            return i
        start = i + 1


def _parse_int_py(value: bytes, pos: int) -> tuple[int, bool]:
    """The kernel's Int parse: a 12-byte zero-padded window, <= 9 digits, a
    non-digit terminator inside the window."""
    if pos < 0:
        return 0, False
    win = value[pos : pos + _INT_WINDOW].ljust(_INT_WINDOW, b"\x00")
    i = 0
    neg = win[0:1] == b"-"
    if neg:
        i = 1
    digits = 0
    val = 0
    while i < _INT_WINDOW and 48 <= win[i] <= 57:
        val = val * 10 + (win[i] - 48)
        digits += 1
        i += 1
    ok = 0 < digits <= 9 and i < _INT_WINDOW  # terminator seen in-window
    return (-val if neg else val), ok


def evaluate_record(spec: TransformSpec, value: bytes) -> bytes | None:
    """Host-path record transform; None = dropped (keep=False)."""
    if not value:
        return None
    for f in spec.filters:
        if not isinstance(f, _FilterContains):
            raise TypeError(f"unsupported filter {f!r}")
        hit = _find_pattern_py(value, f.pattern, f.require_nonnum_suffix) >= 0
        if hit if f.negate else not hit:
            return None
    mapper = spec.mapper
    if mapper is None:
        return value
    if isinstance(mapper, _MapUppercase):
        return bytes(b - 32 if 97 <= b <= 122 else b for b in value)
    if not isinstance(mapper, _MapProject):
        raise TypeError(f"unsupported mapper {mapper!r}")
    parts = []
    for field in mapper.fields:
        if isinstance(field, Int):
            pat = f'"{field.key}":'.encode()
            pos = _find_pattern_py(value, pat, False)
            v, ok = _parse_int_py(value, pos + len(pat) if pos >= 0 else -1)
            if not ok:
                return None
            parts.append(struct.pack("<i", v))
        elif isinstance(field, Str):
            pat = f'"{field.key}":"'.encode()
            pos = _find_pattern_py(value, pat, False)
            if pos < 0:
                return None
            win = value[pos + len(pat) : pos + len(pat) + field.max_len + 1]
            q = win.find(b'"')
            if q < 0:  # no closing quote within max_len
                return None
            parts.append(struct.pack("<H", q) + win[:q].ljust(field.max_len, b"\x00"))
        else:
            raise TypeError(f"unsupported projection field {field!r}")
    return b"".join(parts)


# ------------------------------------------------------------------ engine
class PolicyEngine:
    """Executes a TransformSpec over fetched batches as a read-side view.

    ``device`` is where the device leg runs: the card (the default; raises
    without one) or ``"cpu"``, which runs the kernel's plain version. A
    fetch of at least ``min_records_for_device`` records takes the device
    leg unless ``force_engine`` ("device" | "host") pins one. A failing
    device leg raises: it does not give way to the host leg."""

    def __init__(
        self,
        *,
        row_stride: int = 2048,
        min_records_for_device: int = 256,
        force_engine: str | None = None,
        device: str | torch.device = "cuda",
    ):
        if force_engine not in (None, "device", "host"):
            raise ValueError(f"force_engine must be 'device', 'host' or None, not {force_engine!r}")
        self.row_stride = row_stride
        self.min_records_for_device = min_records_for_device
        self.force_engine = force_engine
        self.device = resolve_device(device)
        self._specs: dict[str, TransformSpec] = {}
        self._pipelines: dict[str, tuple] = {}

    def _spec(self, spec_json: str) -> TransformSpec:
        s = self._specs.get(spec_json)
        if s is None:
            s = self._specs[spec_json] = TransformSpec.from_json(spec_json)
        return s

    def transform_batches(self, spec_json: str, batches: list[RecordBatch]) -> list[RecordBatch]:
        """Filter/map records in place of the fetched view. Surviving
        records keep their original offset deltas, timestamps and keys."""
        if not batches:
            return batches
        spec = self._spec(spec_json)
        n_records = sum(b.header.record_count for b in batches)
        engine = self.force_engine or (
            "device" if n_records >= self.min_records_for_device else "host"
        )
        if engine == "device":
            return self._run_device(spec_json, spec, batches)
        return self._run_host(spec, batches)

    # ------------------------------------------------------------ host
    def _run_host(self, spec: TransformSpec, batches: list[RecordBatch]) -> list[RecordBatch]:
        out = []
        for batch in batches:
            kept: list[Record] = []
            changed = False
            for rec in batch.records():
                new_val = evaluate_record(spec, rec.value or b"")
                if new_val is None:
                    changed = True
                    continue
                if new_val != rec.value:
                    changed = True
                    rec = dataclasses.replace(rec, value=new_val)
                kept.append(rec)
            nb = self._rebuild(batch, kept, changed)
            if nb is not None:
                out.append(nb)
        return out

    # ------------------------------------------------------------ device
    def _run_device(self, spec_json: str, spec: TransformSpec,
                    batches: list[RecordBatch]) -> list[RecordBatch]:
        """One H2D copy from pinned memory, one packed-kernel launch and one
        D2H copy, on the card's current stream."""
        pipe = self._pipelines.get(spec_json)
        if pipe is None:
            pipe = self._pipelines[spec_json] = make_packed_pipeline(spec, self.row_stride)
        fn, r_out = pipe
        exploded = batch_codec.explode_batches(batches)
        n = len(exploded.sizes)
        if n == 0:
            return batches
        on_card = self.device.type == "cuda"
        staged = torch.empty((n, self.row_stride + IN_META), dtype=torch.uint8, pin_memory=on_card)
        pack_staged(exploded, self.row_stride, staged.numpy())
        if on_card:
            with torch.cuda.device(self.device):
                packed = fn(staged.to(self.device, non_blocking=True))
                host = torch.empty(packed.shape, dtype=torch.uint8, pin_memory=True)
                host.copy_(packed, non_blocking=True)
                torch.cuda.current_stream(self.device).synchronize()
        else:
            host = fn(staged)
        out_rows, out_len, keep = unpack_result(host.numpy(), r_out)
        keep = keep & (exploded.sizes <= self.row_stride)
        result = []
        for batch, (start, _) in zip(batches, exploded.ranges):
            kept: list[Record] = []
            changed = False
            for i, rec in enumerate(batch.records()):
                j = start + i
                if not keep[j]:
                    changed = True
                    continue
                new_val = out_rows[j, : out_len[j]].tobytes()
                if new_val != rec.value:
                    changed = True
                    rec = dataclasses.replace(rec, value=new_val)
                kept.append(rec)
            nb = self._rebuild(batch, kept, changed)
            if nb is not None:
                result.append(nb)
        return result

    # ------------------------------------------------------------ shared
    @staticmethod
    def _rebuild(batch: RecordBatch, kept: list[Record], changed: bool) -> RecordBatch | None:
        """The view batch; None when nothing survives. The original offset
        deltas ride along, so a partly filtered batch keeps its base offset
        and last offset delta and clients' offset arithmetic still works."""
        if not changed:
            return batch
        if not kept:
            return None
        payload = b"".join(r.encode() for r in kept)
        codec = batch.header.compression
        if codec != Compression.none:
            payload = compress(payload, codec)
        hdr = dataclasses.replace(batch.header, record_count=len(kept))
        nb = RecordBatch(hdr, payload)
        nb.reseal()
        return nb
