"""Carry state across from the JAX package to the port.

What the JAX package holds for the coproc engine is bytes and numpy arrays:
a deployed script's spec JSON, record batches in their internal wire
encoding, and the column arrays or staged rows its plans build. These
functions take exactly those and return the port's objects, with tensors on
a named device -- the counterpart, for this system, of carrying weights
across. The JAX package itself is never imported: both sides meet at the
bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from redpanda_tpu_torch.coproc.column_plan import plan_spec
from redpanda_tpu_torch.coproc.engine import ProcessBatchItem, ProcessBatchRequest
from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.models.record import RecordBatch
from redpanda_tpu_torch.ops.transforms import TransformSpec


def spec_from_json(blob: str | bytes) -> TransformSpec:
    """A deployed script's spec JSON -> the port's TransformSpec."""
    return TransformSpec.from_json(blob)


def plan_from_json(blob: str | bytes):
    """A deployed script's spec JSON -> the port's execution plan."""
    return plan_spec(spec_from_json(blob))


def batch_from_wire(blob: bytes) -> RecordBatch:
    """One batch in the internal encoding (61-byte header + payload),
    checked against its header CRC."""
    batch, size = RecordBatch.decode_internal(blob)
    if size != len(blob):
        raise ValueError(f"batch encoding is {size} bytes, blob has {len(blob)}")
    return batch


def request_from_wire(items) -> ProcessBatchRequest:
    """[(script_id, (ns, topic, partition), [batch blobs])] -> a request."""
    return ProcessBatchRequest([
        ProcessBatchItem(int(sid), NTP(*ntp), [batch_from_wire(b) for b in blobs])
        for sid, ntp, blobs in items
    ])


def tensors_from_arrays(arrays, device: str | torch.device) -> list[torch.Tensor]:
    """Column arrays or staged rows (numpy) -> contiguous tensors on
    ``device``, same dtypes and shapes."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]
