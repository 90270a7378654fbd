"""Coproc deploy events (the JAX package's coproc/wasm_event.py, copied: its
records are the JAX package's byte for byte).

Parity with coproc/wasm_event.h:28-41 + wasm_event.cc validation: scripts
are (un)deployed by producing records to ``coprocessor_internal_topic``.
Record layout: key = script name, value = the script body (here: a
TransformSpec JSON + input topics instead of a JS blob), headers:
  action: "deploy" | "remove"
  checksum: xxhash64 of the value (integrity, wasm_event.cc checks it)
  type: "transform-spec" (the reference uses "wasm")
Reconciliation keeps only the LAST event per script (wasm_event.cc
reconcile), so redeploys and removes compose naturally with log replay.
"""

from __future__ import annotations

import json
import struct
from dataclasses import dataclass

from redpanda_tpu_torch.hashing.xx import xxhash64
from redpanda_tpu_torch.models.record import Record, RecordBatch, RecordHeader

DEPLOY = b"deploy"
REMOVE = b"remove"
EVENT_TYPE = b"transform-spec"
EVENT_TYPE_PY = b"py-sandbox"  # sandboxed python transform (coproc/sandbox.py)


@dataclass
class WasmEvent:
    name: str
    action: bytes
    spec_json: str = ""
    input_topics: tuple[str, ...] = ()
    checksum: int = 0
    py_source: str = ""  # non-empty for EVENT_TYPE_PY deploys
    policy: str = "skip"  # "skip" | "deregister" (wasm_event.h policy)

    @property
    def script_id(self) -> int:
        """Stable id from the script name (the reference keys scripts by the
        event's sharded id; a name hash keeps ids stable across redeploys)."""
        return xxhash64(self.name.encode()) & 0x7FFFFFFF


def make_deploy_record(name: str, spec_json: str, input_topics: list[str]) -> Record:
    value = json.dumps(
        {"spec": json.loads(spec_json), "input_topics": list(input_topics)},
        separators=(",", ":"),
    ).encode()
    return Record(
        key=name.encode(),
        value=value,
        headers=(
            RecordHeader(b"action", DEPLOY),
            RecordHeader(b"checksum", struct.pack("<Q", xxhash64(value))),
            RecordHeader(b"type", EVENT_TYPE),
        ),
    )


def make_py_deploy_record(
    name: str,
    py_source: str,
    input_topics: list[str],
    policy: str = "skip",
) -> Record:
    """Deploy a sandboxed python transform over the SAME event path as DSL
    specs (the reference ships JS blobs the same way, wasm_event.h:28-41).
    Validation happens again on every consuming broker at enable time; this
    client-side check fails fast at the deploy call site."""
    from redpanda_tpu_torch.coproc.sandbox import validate_source

    validate_source(py_source)
    if policy not in ("skip", "deregister"):
        raise ValueError(f"unknown policy {policy!r}")
    value = json.dumps(
        {
            "py_source": py_source,
            "input_topics": list(input_topics),
            "policy": policy,
        },
        separators=(",", ":"),
    ).encode()
    return Record(
        key=name.encode(),
        value=value,
        headers=(
            RecordHeader(b"action", DEPLOY),
            RecordHeader(b"checksum", struct.pack("<Q", xxhash64(value))),
            RecordHeader(b"type", EVENT_TYPE_PY),
        ),
    )


def make_remove_record(name: str) -> Record:
    return Record(
        key=name.encode(),
        value=None,
        headers=(RecordHeader(b"action", REMOVE),),
    )


def parse_event(rec: Record) -> WasmEvent | None:
    """Validated decode; None for malformed events (wasm_event.cc rules:
    missing action/key → reject; deploy needs value + matching checksum)."""
    if rec.key is None:
        return None
    headers = {h.key: h.value for h in rec.headers}
    action = headers.get(b"action")
    name = rec.key.decode("utf-8", "replace")
    if action == REMOVE:
        return WasmEvent(name, REMOVE)
    if action != DEPLOY:
        return None
    if rec.value is None:
        return None
    csum_raw = headers.get(b"checksum")
    if csum_raw is None or len(csum_raw) != 8:
        return None
    (csum,) = struct.unpack("<Q", csum_raw)
    if xxhash64(rec.value) != csum:
        return None
    try:
        body = json.loads(rec.value.decode())
        topics = tuple(body["input_topics"])
        if headers.get(b"type") == EVENT_TYPE_PY:
            py_source = body["py_source"]
            policy = body.get("policy", "skip")
            if policy not in ("skip", "deregister") or not isinstance(py_source, str):
                return None
            ev = WasmEvent(
                name, DEPLOY, "", topics, csum,
                py_source=py_source, policy=policy,
            )
        else:
            ev = WasmEvent(name, DEPLOY, json.dumps(body["spec"]), topics, csum)
    except (ValueError, KeyError):
        return None
    if not topics:
        return None
    return ev


def reconcile(events: list[WasmEvent]) -> dict[str, WasmEvent]:
    """Last event per script wins."""
    out: dict[str, WasmEvent] = {}
    for ev in events:
        out[ev.name] = ev
    return out


def deploy_batch(records: list[Record]) -> RecordBatch:
    return RecordBatch.build(
        [
            Record(
                attributes=r.attributes, timestamp_delta=r.timestamp_delta,
                offset_delta=i, key=r.key, value=r.value, headers=r.headers,
            )
            for i, r in enumerate(records)
        ]
    )
