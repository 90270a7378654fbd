"""The port's single-device host ladder against the JAX package.

The structural-index parse (rp_explode_find2 + rp_extract_cols2), the staged
ladder, gather framing and pointer-table payload staging of
redpanda_tpu_torch must give the JAX package's span tables, columns, staged
rows and engine replies on the same seeded inputs, bit for bit: the
reference suites' generators (tests/test_structural_parse.py,
tests/test_harvest_gather.py) make the batches, and the reference engine runs
inline (no host pool), as tests/test_structural_parse.py builds it.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from redpanda_tpu.coproc import batch_codec as ref_codec
from redpanda_tpu.coproc import column_plan as ref_cp
from redpanda_tpu.coproc.engine import TpuEngine
from redpanda_tpu.models.record import Compression, Record, RecordBatch
from redpanda_tpu.ops.exprs import field
from redpanda_tpu.ops.transforms import (
    Concat,
    Int,
    Str,
    Substr,
    filter_contains,
    filter_field_eq,
    identity,
    map_project,
    map_uppercase,
    where,
)
from redpanda_tpu_torch import interop, native
from redpanda_tpu_torch.coproc import batch_codec
from redpanda_tpu_torch.coproc.column_plan import plan_spec
from redpanda_tpu_torch.coproc.engine import (
    TorchEngine,
    _bucket_rows,
    pack_staged,
    pack_staged_ptrs,
)
from redpanda_tpu_torch.ops.pipeline import IN_META
from test_harvest_gather import _scenarios
from test_structural_parse import (
    ADVERSARIAL_VALUES,
    PASS_SPEC,
    PATHS,
    PROJ_SPEC,
    _adversarial_request,
    _request,
)

ROW_STRIDE = 512
SPECS = {"proj": PROJ_SPEC, "pass": PASS_SPEC}


def _port(batches):
    return [interop.batch_from_wire(b.encode_internal()) for b in batches]


def _port_request(req):
    return interop.request_from_wire([
        (it.script_id, (it.ntp.ns, it.ntp.topic, it.ntp.partition),
         [b.encode_internal() for b in it.batches])
        for it in req.items
    ])


def _reply_bytes(reply):
    return (
        [(it.script_id, it.source.partition, [b.encode_internal() for b in it.batches])
         for it in reply.items],
        list(reply.deregistered),
    )


def _adversarial_batches():
    """test_structural_parse's adversarial corpus: plain and gzip copies, a
    zero-record batch, a null value, four batches of random JSON."""
    return [b for it in _adversarial_request().items for b in it.batches]


def _zero_and_compressed():
    recs = [Record(offset_delta=i, value=v) for i, v in enumerate(ADVERSARIAL_VALUES[:6])]
    return [
        RecordBatch.build([], base_offset=0),
        RecordBatch.build(recs, base_offset=10, compression=Compression.gzip),
    ]


def _one_item(batches):
    from redpanda_tpu.coproc.engine import ProcessBatchItem, ProcessBatchRequest
    from redpanda_tpu.models import NTP

    return ProcessBatchRequest([ProcessBatchItem(1, NTP.kafka("bench", 0), batches)])


WORKLOADS = {
    "request": lambda: _request(pad=40),  # msgs of 40-89 bytes: Str("msg", 64) keeps some
    "adversarial": _adversarial_request,
    "zero_and_compressed": lambda: _one_item(_zero_and_compressed()),
}


def _ref_replies(spec_json, reqs, **kw):
    kw.setdefault("structural_parse", False)
    ref = TpuEngine(row_stride=ROW_STRIDE, force_mode="columnar_host", host_workers=0, **kw)
    try:
        assert ref.enable_coprocessors([(1, spec_json, ("bench",))]) == [0]
        return [_reply_bytes(ref.process_batch(r)) for r in reqs]
    finally:
        ref.shutdown()


def _tables_equal(a, b):
    """(types, vs, ve) equal, spans compared where a path was found (both
    walks leave a missing path's spans unwritten)."""
    ta, va, ea = a
    tb, vb, eb = b
    assert np.array_equal(ta, tb)
    m = ta != 0
    assert np.array_equal(va[m], vb[m]) and np.array_equal(ea[m], eb[m])


# ---------------------------------------------------------------- span tables
@pytest.mark.parametrize("joined", [True, False], ids=["joined", "no_joined"])
def test_span_tables_match_reference(joined):
    batches = _adversarial_batches()
    want = ref_codec.explode_find_structural(batches, PATHS, joined)
    got = batch_codec.explode_find_structural(_port(batches), PATHS, joined)
    _tables_equal((got.types, got.vs, got.ve), (want.types, want.vs, want.ve))
    assert np.array_equal(got.val_off, want.val_off)
    assert np.array_equal(got.val_len, want.val_len)
    assert got.ranges == want.ranges and got.n == want.n
    # the staged ladder's tables over the joined blob are the same
    ex, types, vs, ve = batch_codec.explode_and_find(_port(batches), PATHS)
    _tables_equal((got.types, got.vs, got.ve), (types, vs, ve))
    assert np.array_equal(ex.offsets, got.val_off) and np.array_equal(ex.sizes, got.sizes)
    if joined:
        assert got.joined.tobytes() == want.joined.tobytes() == ex.joined
    else:
        assert got.joined is None


def test_zero_record_launch():
    batches = [RecordBatch.build([], base_offset=0)]
    for need in (True, False):
        want = ref_codec.explode_find_structural(batches, PATHS, need)
        got = batch_codec.explode_find_structural(_port(batches), PATHS, need)
        assert got.n == want.n == 0 and got.ranges == want.ranges == [(0, 0)]
        assert got.types.shape == want.types.shape
        assert (got.joined is None) == (not need)


def test_find_multi_and_json_find_match_reference():
    from redpanda_tpu.native import lib as ref_lib

    ex, types, vs, ve = batch_codec.explode_and_find(_port(_adversarial_batches()), PATHS)
    got = native.lib().find_multi(ex.joined, ex.offsets, ex.sizes, PATHS)
    _tables_equal(got, ref_lib.find_multi(ex.joined, ex.offsets, ex.sizes, PATHS))
    _tables_equal(got, (types, vs, ve))
    plan = plan_spec(interop.spec_from_json(PROJ_SPEC.to_json()))
    cache = plan.build_find_cache(ex.joined, ex.offsets, ex.sizes)
    _tables_equal((cache.types, cache.vs, cache.ve), (types[:, :3], vs[:, :3], ve[:, :3]))
    for v in ADVERSARIAL_VALUES:
        for path in PATHS + ["nested.level", "nested.arr"]:
            assert native.lib().json_find(v, path) == ref_lib.json_find(v, path), (v, path)


# ---------------------------------------------------------------- extraction
@pytest.mark.parametrize("name", sorted(SPECS))
def test_extract_fused_matches_staged_and_reference(name):
    batches = _adversarial_batches()
    spec_json = SPECS[name].to_json()
    plan = plan_spec(interop.spec_from_json(spec_json))
    ref_plan = ref_cp.plan_spec(SPECS[name])
    assert plan.structural_eligible() and ref_plan.structural_eligible()
    paths = plan.flat_paths()
    assert paths == ref_plan.flat_paths()
    ex, types, vs, ve = batch_codec.explode_and_find(_port(batches), paths)
    cache = plan.make_cache_from_tables(ex, paths, types, vs, ve)
    n_pad = _bucket_rows(len(ex.sizes))
    staged_cols = plan.extract_device_inputs(ex.joined, ex.offsets, ex.sizes, n_pad, cache)
    sp = batch_codec.explode_find_structural(_port(batches), paths, plan.byte_identity)
    cols, data, ok = plan.extract_fused(sp, n_pad)
    ref_cols, ref_data, ref_ok = ref_plan.extract_fused(
        ref_codec.explode_find_structural(batches, paths, ref_plan.byte_identity), n_pad)
    assert len(cols) == len(staged_cols) == len(ref_cols)
    for a, b, c in zip(cols, staged_cols, ref_cols):
        assert a.dtype == b.dtype == c.dtype
        assert np.array_equal(a, b) and np.array_equal(a, c)
    if plan.passthrough:
        assert data is None and ok is None and ref_data is None
    else:
        staged_data, staged_ok = plan.extract_projection(ex.joined, ex.offsets, ex.sizes, cache)
        assert np.array_equal(ok, staged_ok) and np.array_equal(ok, ref_ok)
        assert np.array_equal(data[0][1], staged_data[0][1])
        assert np.array_equal(data[0][1], ref_data[0][1])


def test_ineligible_plans_stay_staged():
    specs = [
        where(field("a.b") == 1),
        where(field("level") == "error") | map_project(Substr("msg", 1, 4)),
        where(field("level") == "error") | map_project(Concat("level", "msg", 8)),
        PASS_SPEC,
        PROJ_SPEC,
    ]
    for spec in specs:
        plan = plan_spec(interop.spec_from_json(spec.to_json()))
        assert plan.structural_eligible() == ref_cp.plan_spec(spec).structural_eligible()
    assert not plan_spec(interop.spec_from_json(specs[0].to_json())).structural_eligible()


# ---------------------------------------------------------------- engine lanes
LANES = {
    "staged": dict(structural_parse=False),
    "structural": dict(structural_probe=False),
}


@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("name", sorted(SPECS))
def test_engine_lanes_match_reference(name, lane):
    spec_json = SPECS[name].to_json()
    reqs = [make() for make in WORKLOADS.values()]
    want = _ref_replies(spec_json, reqs)
    eng = TorchEngine(device="cpu", row_stride=ROW_STRIDE, **LANES[lane])
    assert eng.enable_coprocessors([(1, spec_json, ("bench",))]) == [0]
    got = [_reply_bytes(eng.process_batch(_port_request(r))) for r in reqs]
    assert got == want
    assert any(batches for _, _, batches in want[0][0])
    st = eng.stats()
    assert st["parse_path"] == lane
    if lane == "structural":
        assert st["t_explode_find2"] > 0 and st["t_fused_extract"] > 0
        assert "t_extract_pred" not in st and "t_explode_find" not in st
    else:
        assert st["t_explode_find"] > 0 and "t_explode_find2" not in st
    assert st["n_kernel_predicate"] == len(reqs)
    assert not any(k.startswith("n_failures") for k in st)


@pytest.mark.parametrize("gather", [True, False], ids=["gather", "padded"])
def test_gather_framing_matches_reference(gather):
    """Byte-identity plans (passthrough, identity) frame straight from the
    joined blob; projections and uppercase keep the padded path."""
    reqs = [make() for make in WORKLOADS.values()]
    specs = {
        "pass": (PASS_SPEC.to_json(), True),
        "identity": (identity().to_json(), True),
        "proj": (PROJ_SPEC.to_json(), False),
        "uppercase": (map_uppercase().to_json(), False),
    }
    for name, (spec_json, byte_identity) in specs.items():
        want = _ref_replies(spec_json, reqs)
        for lane in LANES.values():
            eng = TorchEngine(device="cpu", row_stride=ROW_STRIDE, gather_frame=gather, **lane)
            eng.enable_coprocessors([(1, spec_json, ("bench",))])
            got = [_reply_bytes(eng.process_batch(_port_request(r))) for r in reqs]
            assert got == want, name
            st = eng.stats()
            assert st.get("n_frame_gather", 0) == (len(reqs) if gather and byte_identity else 0)
            assert st.get("n_frame_padded", 0) + st.get("n_frame_gather", 0) == len(reqs)
            assert st["arena"]["allocs"] + st["arena"]["reuses"] == len(reqs)


def test_gather_framing_failure_retries_with_the_mask(monkeypatch):
    """A framing failure after the keep bits were fetched must not lose them:
    the retry frames the filtered records, not every record."""
    req = _port_request(_request(n_items=2))
    eng = TorchEngine(device="cpu", row_stride=ROW_STRIDE, compress_threshold=10**9)
    eng.enable_coprocessors([(1, PASS_SPEC.to_json(), ("bench",))])
    want = _reply_bytes(eng.process_batch(req))
    real = batch_codec.frame_ranges_gather
    calls = []

    def flaky(*a, **kw):
        calls.append(1)
        if len(calls) == 1:
            raise MemoryError("framing allocation failure")
        return real(*a, **kw)

    monkeypatch.setattr(batch_codec, "frame_ranges_gather", flaky)
    ticket = eng.submit(req)
    assert all(not it.batches for it in ticket.result().items)
    assert _reply_bytes(ticket.result()) == want
    assert len(calls) == 2 and eng.stats()["n_failures_rebuild"] == 1


@pytest.mark.parametrize("name", sorted(_scenarios()))
def test_frame_gather_matches_padded_and_reference(name):
    batches = _scenarios()[name]
    ex = batch_codec.explode_batches(_port(batches))
    ref_ex = ref_codec.explode_batches(batches)
    keep = (np.arange(len(ex.sizes)) % 3) != 1
    stride = max(int(ex.sizes.max()) if len(ex.sizes) else 1, 1)
    rows = np.zeros((len(ex.sizes), stride), np.uint8)
    native.lib().pack_rows_into(ex.joined, ex.offsets, ex.sizes, rows)
    padded = batch_codec.frame_ranges(rows, ex.sizes, keep, ex.ranges)
    arena = batch_codec.Arena()
    gathered = batch_codec.frame_ranges_gather(ex.joined, ex.offsets, ex.sizes, keep, ex.ranges,
                                               arena=arena)
    plain = [batch_codec._frame_gather_py(ex.joined, ex.offsets, ex.sizes, keep, s, e)
             for s, e in ex.ranges]
    want = ref_codec.frame_ranges_gather(ref_ex.joined, ref_ex.offsets, ref_ex.sizes, keep,
                                         ref_ex.ranges)
    assert gathered == padded == plain == want
    assert batch_codec.frame_ranges(rows, ex.sizes, keep, ex.ranges, arena=arena) == padded
    assert arena.stats()["allocs"] + arena.stats()["reuses"] == 2
    parked = arena.stats()["free_buffers"]
    assert parked >= 1 and arena.trim() == parked and arena.stats()["free_buffers"] == 0
    for (s, e), part in zip(ex.ranges, gathered):
        one = native.lib().frame_gather(ex.joined, ex.offsets[s:e], ex.sizes[s:e], keep[s:e])
        assert one == part == batch_codec.frame_records(rows[s:e], ex.sizes[s:e], keep[s:e])


def test_frame_many_gather_rejects_bad_spans():
    lib = native.lib()
    keep = np.ones(2, np.uint8)
    starts, ends = np.array([0], np.int64), np.array([2], np.int64)
    for offs, lens in (([0, 4], [3, 10]), ([-1, 0], [1, 1])):
        with pytest.raises(ValueError):
            lib.frame_many_gather(b"abcdef", np.array(offs, np.int64), np.array(lens, np.int32),
                                  keep, starts, ends)
    with pytest.raises(ValueError):
        lib.frame_many_gather(b"abcdef", np.zeros(2, np.int64), np.ones(2, np.int32), keep,
                              starts, np.array([3], np.int64))


# ---------------------------------------------------------------- parse probe
def test_parse_probe_pins_a_ladder_and_small_launches_do_not():
    eng = TorchEngine(device="cpu", row_stride=ROW_STRIDE)
    eng.enable_coprocessors([(1, PROJ_SPEC.to_json(), ("bench",))])
    small = _request(n_items=2, records=16)
    want_small = _ref_replies(PROJ_SPEC.to_json(), [small])[0]
    assert _reply_bytes(eng.process_batch(_port_request(small))) == want_small
    assert eng.stats()["parse_path"] is None and "parse_probe" not in eng.stats()
    big = _request(n_items=32, records=32)  # 1024 records: representative
    want = _ref_replies(PROJ_SPEC.to_json(), [big])[0]
    assert _reply_bytes(eng.process_batch(_port_request(big))) == want
    st = eng.stats()
    assert st["parse_path"] in ("staged", "structural")
    probe = st["parse_probe"]
    assert probe["chosen"] == st["parse_path"]
    assert probe["t_staged_ms"] > 0 and probe["t_structural_ms"] > 0
    pinned = TorchEngine(device="cpu", structural_parse=False)
    pinned.enable_coprocessors([(1, PROJ_SPEC.to_json(), ("bench",))])
    pinned.process_batch(_port_request(big))
    assert pinned.stats()["parse_path"] == "staged" and "parse_probe" not in pinned.stats()


def test_parse_calibration_failure_pins_staged(monkeypatch):
    def broken(*a, **kw):
        raise ValueError("structural parse failed")

    monkeypatch.setattr(batch_codec, "explode_find_structural", broken)
    big = _request(n_items=32, records=32)
    eng = TorchEngine(device="cpu", row_stride=ROW_STRIDE)
    eng.enable_coprocessors([(1, PASS_SPEC.to_json(), ("bench",))])
    assert _reply_bytes(eng.process_batch(_port_request(big))) == _ref_replies(
        PASS_SPEC.to_json(), [big])[0]
    st = eng.stats()
    assert st["parse_path"] == "staged" and st["n_failures_parse_calibration"] == 1


# ---------------------------------------------------------------- payload lane
def _payload_batches():
    """Null, empty and over-wide values, a compressed batch and a
    zero-record batch."""
    rng = np.random.default_rng(11)
    batches = []
    for p in range(5):
        recs = []
        for i in range(24):
            doc = {"level": ["error", "info", "warn"][int(rng.integers(0, 3))],
                   "code": int(rng.integers(-500, 500)), "msg": "m" * int(rng.integers(0, 40))}
            value = json.dumps(doc, separators=(",", ":")).encode()
            if i == 3:
                value = None
            elif i == 5:
                value = b""
            elif i == 7 and p == 2:
                value += b"w" * (ROW_STRIDE + 10)
            recs.append(Record(offset_delta=i, timestamp_delta=i, value=value))
        batches.append(RecordBatch.build(
            recs, base_offset=100 * p,
            compression=Compression.zstd if p == 1 else Compression.none))
    batches.insert(3, RecordBatch.build([], base_offset=999))
    return batches


def test_pointer_table_staging_matches_classic():
    batches = _port(_payload_batches())
    pe = batch_codec.explode_ptrs(batches)
    ex = batch_codec.explode_batches(batches)
    ref_pe = ref_codec.explode_ptrs(_payload_batches())
    assert pe.ranges == ex.ranges == ref_pe.ranges
    assert np.array_equal(pe.sizes, ex.sizes) and np.array_equal(pe.sizes, ref_pe.sizes)
    for a, b, c, d in zip(pe.rel_off, ref_pe.rel_off, pe.rel_len, ref_pe.rel_len):
        assert np.array_equal(a, b) and np.array_equal(c, d)
    for payload, off, ln in zip(pe.payloads, pe.rel_off, pe.rel_len):
        py_off, py_len = batch_codec._parse_record_values_py(payload, len(ln))
        assert np.array_equal(py_off, off) and np.array_equal(py_len, ln)
    n_pad = _bucket_rows(len(pe.sizes))
    classic = np.empty((n_pad, ROW_STRIDE + IN_META), np.uint8)
    ptrs = np.full((n_pad, ROW_STRIDE + IN_META), 0xAB, np.uint8)  # every byte rewritten
    pack_staged(ex, ROW_STRIDE, classic)
    pack_staged_ptrs(pe, ROW_STRIDE, ptrs)
    assert np.array_equal(classic, ptrs)


def test_merge_exploded_matches_one_explode():
    batches = _port(_payload_batches())
    whole = batch_codec.explode_batches(batches)
    parts = [batch_codec.explode_batches(batches[s:e]) for s, e in ((0, 2), (2, 4), (4, 6))]
    merged = batch_codec.merge_exploded(parts)
    assert merged.joined == whole.joined and merged.ranges == whole.ranges
    assert np.array_equal(merged.offsets, whole.offsets)
    assert np.array_equal(merged.sizes, whole.sizes)
    assert batch_codec.merge_exploded([whole]) is whole
    assert batch_codec.merge_exploded([]).ranges == []


@pytest.mark.parametrize("name", ["project", "uppercase"])
def test_pointer_table_payload_lane_matches_reference(name):
    spec = {
        "project": filter_field_eq("level", "error") | map_project(Int("code"), Str("msg", 16)),
        "uppercase": filter_contains(b"warn") | map_uppercase(),
    }[name]
    reqs = [_one_item(_payload_batches()), _request(n_items=4, records=16, pad=20)]
    want = _ref_replies(spec.to_json(), reqs, structural_parse=None)
    eng = TorchEngine(device="cpu", row_stride=ROW_STRIDE)
    eng.enable_coprocessors([(1, spec.to_json(), ("bench",))])
    tickets = eng.submit_group([_port_request(r) for r in reqs])
    assert [_reply_bytes(t.result()) for t in tickets] == want
    assert any(batches for _, _, batches in want[0][0])
    st = eng.stats()
    assert st["t_explode_ptrs"] > 0 and "t_explode" not in st
    assert st["n_kernel_payload_transform"] == 1


def test_pack_table_rejects_bad_spans():
    lib = native.lib()
    dst = np.zeros((4, 8), np.uint8)
    payloads = [b"abcdef", b"xyz"]
    good = ([np.array([0, 2], np.int64), np.array([1], np.int64)],
            [np.array([2, 3], np.int32), np.array([2], np.int32)])
    lib.pack_table_into(payloads, *good, dst)
    assert dst[:3].tobytes() == (b"ab" + bytes(6)) + (b"cde" + bytes(5)) + (b"yz" + bytes(6))
    bad = [
        ([np.array([0, 4], np.int64), np.array([1], np.int64)], good[1]),  # past payload 0
        ([np.array([0, 2], np.int64), np.array([-1], np.int64)], good[1]),  # before payload 1
        (good[0], [np.array([2, 3], np.int32)]),  # a batch without lengths
    ]
    for off, ln in bad:
        with pytest.raises(ValueError):
            lib.pack_table_into(payloads, off, ln, dst)
    with pytest.raises(ValueError):  # more records than rows
        lib.pack_table_into(payloads, *good, np.zeros((2, 8), np.uint8))
