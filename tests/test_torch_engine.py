"""TorchEngine (the PyTorch port) against TpuEngine (the JAX package).

Both engines take the same requests -- the port's built from the reference's
batch wire bytes through redpanda_tpu_torch.interop -- and must return the
same reply bytes for every spec mode the port runs: columnar passthrough,
columnar projection, payload filter + project, and payload filter +
uppercase. The workload holds one zstd-compressed input batch and one
record wider than the staging row. The reference is pinned to its inline
device lanes (no host pool, no column cache, no structural parse) so that
both run the same machinery.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from redpanda_tpu.coproc.engine import ProcessBatchItem, ProcessBatchRequest, TpuEngine
from redpanda_tpu.models import NTP, Record, RecordBatch
from redpanda_tpu.models.record import Compression
from redpanda_tpu.ops.exprs import field
from redpanda_tpu.ops.transforms import (
    Int,
    Str,
    filter_contains,
    filter_field_eq,
    map_project,
    map_uppercase,
    where,
)
from redpanda_tpu_torch import interop
from redpanda_tpu_torch.coproc.engine import ErrorPolicy, TorchEngine

ROW_STRIDE = 256
PARTITIONS = 8
RECORDS = 32

SPECS = {
    "columnar_passthrough": where(field("level") == "error"),
    "columnar_projection": where((field("level") == "error") | (field("code") >= 20))
    | map_project(Int("code"), Str("msg", 32)),
    "payload_project": filter_field_eq("level", "error") | map_project(Int("code"), Str("msg", 32)),
    "payload_uppercase": filter_contains(b"warn") | map_uppercase(),
}


def _workload(seed: int = 7) -> ProcessBatchRequest:
    """8 partitions x 32 records of ~200 B JSON; partition 3 is one
    zstd-compressed batch and partition 5 holds a record wider than
    ROW_STRIDE."""
    rng = np.random.default_rng(seed)
    levels = ["error", "info", "warn"]
    items = []
    for p in range(PARTITIONS):
        recs = []
        for i in range(RECORDS):
            doc = {
                "level": levels[int(rng.integers(0, 3))],
                "code": int(rng.integers(-50, 100)),
                "msg": "m" * int(rng.integers(0, 48)),
                "pad": "x" * int(rng.integers(80, 150)),
            }
            if p == 5 and i == 7:
                doc["pad"] = "w" * (ROW_STRIDE + 40)
            value = json.dumps(doc, separators=(",", ":")).encode()
            if i == 11:
                value = b""
            recs.append(Record(offset_delta=i, timestamp_delta=i, value=value))
        batch = RecordBatch.build(
            recs, base_offset=0, first_timestamp=1_000 + p,
            compression=Compression.zstd if p == 3 else Compression.none,
        )
        items.append(ProcessBatchItem(1, NTP.kafka("t", p), [batch]))
    return ProcessBatchRequest(items)


def _port_request(req: ProcessBatchRequest):
    return interop.request_from_wire([
        (it.script_id, (it.ntp.ns, it.ntp.topic, it.ntp.partition),
         [b.encode_internal() for b in it.batches])
        for it in req.items
    ])


def _reply_bytes(reply):
    return (
        [
            (it.script_id, (it.source.ns, it.source.topic, it.source.partition),
             [b.encode_internal() for b in it.batches])
            for it in reply.items
        ],
        list(reply.deregistered),
    )


@pytest.fixture(scope="module")
def workload():
    return _workload()


@pytest.mark.parametrize("name", sorted(SPECS))
def test_reply_bytes_match_reference(name, workload):
    spec_json = SPECS[name].to_json()
    ref = TpuEngine(
        row_stride=ROW_STRIDE, force_mode="columnar_device", host_workers=1,
        structural_parse=False, device_column_cache_mb=0,
    )
    try:
        assert ref.enable_coprocessors([(1, spec_json, ("t",))]) == [0]
        want = _reply_bytes(ref.process_batch(workload))
    finally:
        ref.shutdown()
    eng = TorchEngine(device="cpu", row_stride=ROW_STRIDE)
    assert eng.enable_coprocessors([(1, spec_json, ("t",))]) == [0]
    # two fused requests in one launch, like the bench's GROUP loop
    tickets = eng.submit_group([_port_request(workload), _port_request(workload)])
    got = [_reply_bytes(t.result()) for t in tickets]
    assert got[0] == want
    assert got[1] == want
    stats = eng.stats()
    mode = eng._plans[1].mode
    kernel = {"columnar": "predicate", "payload": "payload_transform"}[mode]
    assert stats[f"n_kernel_{kernel}"] == 1
    assert stats["n_records"] == 2 * PARTITIONS * RECORDS
    assert not any(k.startswith("n_failures") for k in stats)
    # outputs are not trivially empty: every spec keeps some records
    assert any(batches for _, _, batches in want[0])


def test_host_plans_match_reference(workload):
    for spec in (map_uppercase(), None):
        spec_json = spec.to_json() if spec is not None else json.dumps({"name": "id", "ops": []})
        ref = TpuEngine(row_stride=ROW_STRIDE, host_workers=1, structural_parse=False)
        try:
            ref.enable_coprocessors([(1, spec_json, ("t",))])
            want = _reply_bytes(ref.process_batch(workload))
        finally:
            ref.shutdown()
        eng = TorchEngine(device="cpu", row_stride=ROW_STRIDE)
        eng.enable_coprocessors([(1, spec_json, ("t",))])
        assert eng._plans[1].mode == "host"
        assert _reply_bytes(eng.process_batch(_port_request(workload))) == want


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default engine runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TorchEngine()


def test_enable_codes_and_unknown_scripts():
    eng = TorchEngine(device="cpu")
    spec = SPECS["columnar_projection"].to_json()
    assert eng.enable_coprocessors([
        (1, spec, ("t",)), (1, spec, ("t",)), (2, spec, ()), (3, spec, ("__x",)),
        (4, "{not json", ("t",)),
    ]) == [0, 2, 4, 3, 1]
    assert eng.heartbeat() == 1
    assert eng.stats()["n_failures_enable"] == 1
    req = _port_request(_workload())
    for it in req.items:
        it.script_id = 9
    reply = eng.process_batch(req)
    assert [len(it.batches) for it in reply.items] == [0] * PARTITIONS
    assert eng.disable_coprocessors([1, 1]) == [0, 2]


@pytest.mark.parametrize("policy", [ErrorPolicy.skip_on_failure, ErrorPolicy.deregister])
def test_error_policies(policy):
    """A batch whose records cannot be parsed fails its launch: skip keeps
    the script and answers empty, deregister unloads it."""
    eng = TorchEngine(device="cpu")
    spec = SPECS["columnar_passthrough"].to_json()
    assert eng.enable_coprocessors([(1, spec, ("t",), policy)]) == [0]
    req = _port_request(_workload())
    broken = req.items[0].batches[0]
    broken.payload = broken.payload[:10]  # framing parse runs off the end
    reply = eng.process_batch(req)
    assert eng.stats()["n_failures_dispatch"] == 1
    if policy == ErrorPolicy.deregister:
        assert reply.deregistered == [1]
        assert eng.heartbeat() == 0
    else:
        assert reply.deregistered == []
        assert [len(it.batches) for it in reply.items] == [0] * PARTITIONS
        assert eng.heartbeat() == 1


def test_interop_carries_batches_and_columns(workload):
    blob = workload.items[3].batches[0].encode_internal()
    batch = interop.batch_from_wire(blob)
    assert batch.encode_internal() == blob
    assert batch.record_values() == workload.items[3].batches[0].record_values()
    with pytest.raises(ValueError):
        interop.batch_from_wire(blob + b"\0")
    arrays = [np.arange(24, dtype=np.int32), np.ones((24, 5), np.uint8)]
    tensors = interop.tensors_from_arrays(arrays, "cpu")
    assert [t.dtype for t in tensors] == [torch.int32, torch.uint8]
    assert all(np.array_equal(t.numpy(), a) for t, a in zip(tensors, arrays))
    plan = interop.plan_from_json(SPECS["columnar_projection"].to_json())
    assert plan.mode == "columnar" and plan.r_out == 4 + 2 + 32


def test_zstd_through_libzstd_without_the_package(monkeypatch):
    """The card's machine has no `zstandard`: the port's codec then goes
    through the system libzstd and must still read and write zstd."""
    import zstandard

    from redpanda_tpu_torch.compression import codecs, registry
    from redpanda_tpu_torch.models.record import Compression as PortCompression

    data = json.dumps({"k": list(range(400))}).encode() * 3
    framed = zstandard.ZstdCompressor(level=3).compressobj()
    streamed = framed.compress(data) + framed.flush()  # no content size in the header
    monkeypatch.setattr(codecs, "zstandard", None)
    assert registry.is_available(PortCompression.zstd)
    packed = codecs.zstd_compress(data)
    assert zstandard.ZstdDecompressor().decompressobj().decompress(packed) == data
    assert codecs.zstd_uncompress(packed) == data
    assert codecs.zstd_uncompress(streamed) == data


@pytest.mark.parametrize("codec", ["none", "gzip", "snappy", "lz4", "zstd"])
def test_record_batches_are_the_same_bytes(codec):
    """The port's models/record.py and codecs write the JAX package's wire
    bytes, and read them back."""
    from redpanda_tpu_torch.models import Record as PRecord
    from redpanda_tpu_torch.models import RecordBatch as PRecordBatch
    from redpanda_tpu_torch.models.record import Compression as PCompression
    from redpanda_tpu_torch.models.record import RecordHeader as PHeader
    from redpanda_tpu.models.record import RecordHeader

    rng = np.random.default_rng(3)
    vals = [rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes() for _ in range(20)]
    ref = RecordBatch.build(
        [Record(offset_delta=i, timestamp_delta=2 * i, key=b"k%d" % i if i % 2 else None, value=v,
                headers=(RecordHeader(b"h", b"v"),) if i % 3 == 0 else ())
         for i, v in enumerate(vals)],
        base_offset=77, first_timestamp=123, compression=Compression[codec],
    )
    port = PRecordBatch.build(
        [PRecord(offset_delta=i, timestamp_delta=2 * i, key=b"k%d" % i if i % 2 else None, value=v,
                 headers=(PHeader(b"h", b"v"),) if i % 3 == 0 else ())
         for i, v in enumerate(vals)],
        base_offset=77, first_timestamp=123, compression=PCompression[codec],
    )
    assert port.encode_internal() == ref.encode_internal()
    back = interop.batch_from_wire(ref.encode_internal())
    assert back.verify_kafka_crc() and back.verify_header_crc()
    assert [r.value for r in back.records()] == vals
