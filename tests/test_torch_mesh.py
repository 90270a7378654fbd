"""The partition mesh of the PyTorch port against the JAX package's.

The JAX side runs on the conftest's virtual CPU devices
(``partition_mesh(devices=eight_devices[:4])``); the port's side on a mesh of
four CPU shards (``partition_mesh(4, device="cpu")``), where every shard runs
the kernels' plain PyTorch versions. Both get the same seeded numpy inputs,
and every comparison is exact: the vote tally (K7), the sharded CRC checks
(K8, K9), the per-tick coproc step (K10), the stacked predicate (K2), the
range shard, the engine's mesh lane (reply bytes and rows per device), the
raft plane's mesh leg and ``dryrun_multichip``. The kernels themselves are
held to the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from redpanda_tpu import parallel as RPAR
from redpanda_tpu.coproc import host_pool as RHP
from redpanda_tpu.coproc.column_plan import plan_spec as ref_plan_spec
from redpanda_tpu.coproc.engine import ProcessBatchItem as RItem
from redpanda_tpu.coproc.engine import ProcessBatchRequest as RRequest
from redpanda_tpu.coproc.engine import TpuEngine
from redpanda_tpu.hashing.crc32c import crc32c as ref_crc32c
from redpanda_tpu.models import NTP as RNTP
from redpanda_tpu.models import Record as RRecord
from redpanda_tpu.models import RecordBatch as RRecordBatch
from redpanda_tpu.ops.exprs import field as ref_field
from redpanda_tpu.ops.packing import pack_batches_prefixed as ref_pack_batches_prefixed
from redpanda_tpu.ops.transforms import Int as RInt
from redpanda_tpu.ops.transforms import Str as RStr
from redpanda_tpu.ops.transforms import filter_contains as ref_filter_contains
from redpanda_tpu.ops.transforms import filter_field_eq as ref_filter_field_eq
from redpanda_tpu.ops.transforms import map_project as ref_map_project
from redpanda_tpu.ops.transforms import where as ref_where
from redpanda_tpu.raft import device_plane as RDP
from redpanda_tpu_torch import entry, interop
from redpanda_tpu_torch.coproc import column_plan as CP
from redpanda_tpu_torch.coproc import host_pool as HP
from redpanda_tpu_torch.coproc.engine import TorchEngine
from redpanda_tpu_torch.ops.transforms import TransformSpec, compile_transform
from redpanda_tpu_torch.parallel import collectives as COL
from redpanda_tpu_torch.parallel import mesh as M
from redpanda_tpu_torch.raft import device_plane as DP
from test_torch_predicate import DOCS, REF_EXPRS, _records

D = 4


@pytest.fixture(scope="module")
def ref_mesh(eight_devices):
    return RPAR.partition_mesh(devices=eight_devices[:D])


@pytest.fixture(scope="module")
def mesh():
    return M.partition_mesh(D, device="cpu")


@pytest.fixture(scope="module")
def ref_aggregator(ref_mesh):
    return RPAR.make_vote_aggregator(ref_mesh)


@pytest.fixture(scope="module")
def ref_coproc_step(ref_mesh):
    """The JAX step at the K10 cases' widths (r_batch 256, r_rec 128)."""
    return RPAR.make_sharded_coproc_step(ref_mesh, SPEC.to_json(), 256, 128)


# ------------------------------------------------------------------ mesh
def test_partition_mesh_and_shard_to_mesh(mesh):
    assert mesh.size == D and mesh.type == "cpu" and mesh.axis == "p"
    assert all(s is None for s in mesh.streams)
    a = np.arange(24, dtype=np.int32).reshape(8, 3)
    claimed = np.array([1, 2**32 - 1, 7, 2**31], np.uint32)
    sa, sc = M.shard_to_mesh(mesh, a, claimed)
    assert [tuple(b.shape) for b in sa.blocks] == [(2, 3)] * D
    np.testing.assert_array_equal(np.asarray(sa), a)
    # CRCs travel as their int32 bit patterns
    np.testing.assert_array_equal(np.asarray(sc).view(np.uint32), claimed)
    assert M.shard_to_mesh(mesh, sa) is sa
    with pytest.raises(ValueError):
        M.shard_to_mesh(mesh, np.zeros((6, 2), np.uint8))  # 6 rows over 4 shards
    assert M.partition_mesh(devices=[torch.device("cpu")] * 3).size == 3
    assert M.partition_mesh(2, devices=["cpu"] * 4).size == 2


@pytest.mark.parametrize("seed", range(4))
def test_partition_counts_match_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        counts = [int(c) for c in rng.integers(0, 60, int(rng.integers(0, 12)))]
        for shards in (1, 2, 3, 4, 8):
            assert HP.partition_counts(counts, shards) == RHP.partition_counts(counts, shards)


# ------------------------------------------------------------------ K7
def _ops_votes():
    """tests/test_ops.py test_vote_aggregator's votes."""
    votes = np.zeros((8, 16), dtype=np.uint8)
    votes[0, 3] = votes[5, 3] = votes[7, 3] = votes[2, 9] = 1
    return votes


@pytest.mark.parametrize("case", ["ops", "random", "one_group"])
def test_vote_aggregator_matches_reference(case, mesh, ref_aggregator):
    rng = np.random.default_rng(21)
    votes = {
        "ops": _ops_votes(),
        "random": rng.integers(0, 2, (D, 32)).astype(np.uint8),
        "one_group": rng.integers(0, 2, (D, 1)).astype(np.uint8),
    }[case]
    want = np.asarray(ref_aggregator(votes))
    got = COL.make_vote_aggregator(mesh)(votes)
    assert got.dtype == torch.int32 and got.device == mesh.devices[0]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(COL.vote_tally_plain(torch.from_numpy(votes)).numpy(), want)


def test_vote_tally_wrapper_checks_its_inputs():
    v = torch.zeros((3, 5), dtype=torch.uint8)
    assert torch.equal(COL.vote_tally(v), torch.zeros(5, dtype=torch.int32))
    assert torch.equal(COL.vote_tally(v.to(torch.int32) + 2), torch.full((5,), 6, dtype=torch.int32))
    for bad in (v.long(), v[0], v.t()):
        with pytest.raises(ValueError):
            COL.vote_tally(bad)


def _cuda(*idx):
    return [torch.device("cuda", i) for i in idx]


@pytest.mark.parametrize("devices,want", [
    (_cuda(0, 0, 0, 0), [(0, (0, 1, 2, 3))]),  # a virtual mesh: one launch, no copy
    (_cuda(0, 1, 0, 1), [(0, (0, 2)), (1, (1, 3))]),
    (_cuda(0, 1, 2, 3), [(0, (0,)), (1, (1,)), (2, (2,)), (3, (3,))]),
    (_cuda(2, 0, 2, 1), [(2, (0, 2)), (0, (1,)), (1, (3,))]),  # group 0 is devices[0]'s
])
def test_card_groups_give_one_tally_launch_per_card(devices, want):
    """The tally's grouping: group g's partial lands in row g of the stacked
    partials on devices[0] (row 0 written in place by devices[0]'s own
    launch), so C cards take C + 1 launches and C - 1 copies, one card 1."""
    groups = M.card_groups(devices)
    assert [(dev.index, shards) for dev, shards in groups] == want
    assert groups[0][0] == devices[0]
    assert sorted(d for _, shards in groups for d in shards) == list(range(len(devices)))
    assert M.card_groups([torch.device("cpu")] * 4) == ((torch.device("cpu"), (0, 1, 2, 3)),)


def test_vote_tally_blocks_and_local_blocks_on_the_cpu(mesh):
    rng = np.random.default_rng(5)
    votes = rng.integers(0, 2, (2 * D, 9)).astype(np.uint8)
    v = M.local_blocks(mesh, votes)
    assert [tuple(b.shape) for b in v.blocks] == [(2, 9)] * D and M.local_blocks(mesh, v) is v
    want = votes.astype(np.int32).sum(0)
    np.testing.assert_array_equal(COL.vote_tally_blocks(v.blocks).numpy(), want)
    out = torch.full((9,), -1, dtype=torch.int32)
    assert COL.vote_tally_blocks(v.blocks, out=out) is out
    np.testing.assert_array_equal(out.numpy(), want)
    parts = [torch.from_numpy(votes[:4].astype(np.int32)), torch.from_numpy(votes[4:].astype(np.int32))]
    np.testing.assert_array_equal(COL.vote_tally_blocks(parts).numpy(), want)
    for bad in ([], [v.blocks[0]] * (COL.MAX_TALLY_BLOCKS + 1), [v.blocks[0], v.blocks[1][:1]],
                [v.blocks[0], parts[0][:2]], [v.blocks[0].t()]):
        with pytest.raises(ValueError):
            COL.vote_tally_blocks(bad)
    with pytest.raises(ValueError):
        COL.vote_tally_blocks(v.blocks, out=torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError):
        M.local_blocks(mesh, votes[:6])  # 6 rows over 4 shards


@pytest.mark.parametrize("devices,want", [
    (_cuda(0) * 4, [(0, (0, 1, 2, 3))]),
    (_cuda(0) * 130, [(0, tuple(range(64))), (0, tuple(range(64, 128))), (0, (128, 129))]),
    (_cuda(1, 0) * 65, [(1, tuple(range(0, 128, 2))), (1, (128,)),
                        (0, tuple(range(1, 129, 2))), (0, (129,))]),
    (_cuda(0, 1) * 2, [(0, (0, 2)), (1, (1, 3))]),
])
def test_tally_chunks_cut_a_card_at_64_shards(devices, want):
    """A card holding more shards than the kernel's table takes one launch
    per 64 of them; chunk 0 is devices[0]'s."""
    chunks = COL.tally_chunks(devices)
    assert [(dev.index, shards) for dev, shards in chunks] == want
    assert sorted(d for _, shards in chunks for d in shards) == list(range(len(devices)))


@pytest.mark.parametrize("n_shards", [65, 130])
def test_vote_aggregator_over_more_than_64_shards_on_the_cpu(n_shards):
    """The aggregator on a CPU mesh wider than one launch's table: the
    chunks' partials are summed like the cards', equal to the plain sum;
    the host votes' blocks are views of one array."""
    mesh = M.partition_mesh(n_shards, device="cpu")
    votes = np.random.default_rng(n_shards).integers(0, 2, (2 * n_shards, 7)).astype(np.uint8)
    v = M.local_blocks(mesh, votes)
    assert len({b.untyped_storage().data_ptr() for b in v.blocks}) == 1
    got = COL.make_vote_aggregator(mesh)(votes)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), votes.astype(np.int32).sum(0))


# ------------------------------------------------------------------ K9
def _ops_packed_batches():
    """tests/test_ops.py test_sharded_crc_check's rows, one byte corrupted."""
    p, b, r = 8, 4, 256
    rng = np.random.default_rng(3)
    batches = [
        RRecordBatch.build([RRecord(offset_delta=j, value=rng.bytes(40)) for j in range(2)],
                           base_offset=i)
        for i in range(p * b)
    ]
    rows, lens, crcs = ref_pack_batches_prefixed(batches, r)
    rows, lens, crcs = rows.reshape(p, b, r), lens.reshape(p, b), crcs.reshape(p, b)
    rows[3, 2, 45] ^= 1
    return rows, lens, crcs


def test_sharded_crc_check_matches_reference(mesh, ref_mesh):
    rows, lens, crcs = _ops_packed_batches()
    r = rows.shape[2]
    want_ok, want_bad = map(np.asarray, RPAR.make_sharded_crc_check(ref_mesh, r)(
        *RPAR.shard_to_mesh(ref_mesh, rows, lens, crcs)))
    ok, bad = COL.make_sharded_crc_check(mesh, r)(rows, lens, crcs)
    np.testing.assert_array_equal(np.asarray(ok), want_ok)
    np.testing.assert_array_equal(np.asarray(bad), want_bad)
    assert not want_ok[3, 2] and want_bad[3] == 1 and want_bad.sum() == 1
    t = [torch.from_numpy(x) for x in (rows, lens, crcs.view(np.int32))]
    p_ok, p_bad = COL.sharded_crc_plain(*t)
    np.testing.assert_array_equal(p_ok.numpy(), want_ok)
    np.testing.assert_array_equal(p_bad.numpy(), want_bad)


# ------------------------------------------------------------------ K8
def _crc_vote_inputs():
    """tests/test_meshrunner.py test_crc_vote_step_matches_host_oracle's
    generator: random lengths (zero included), two claims corrupted."""
    rng = np.random.default_rng(3)
    d, b, r, g = D, 6, 192, 16
    rows = np.zeros((d, b, r), np.uint8)
    lens = np.zeros((d, b), np.int32)
    claimed = np.zeros((d, b), np.uint32)
    for i in range(d):
        for j in range(b):
            ln = int(rng.integers(0, r + 1))
            payload = rng.bytes(ln)
            rows[i, j, :ln] = np.frombuffer(payload, np.uint8)
            lens[i, j] = ln
            claimed[i, j] = ref_crc32c(payload)
    claimed[1, 2] ^= 0xDEAD
    claimed[3, 0] ^= 1
    lens[2, 4] = 0  # a zero-length row with a wrong claim: neither ok nor bad
    votes = rng.integers(0, 2, (d, g)).astype(np.uint8)
    return rows, lens, claimed, votes


def test_crc_vote_step_matches_reference(mesh, ref_mesh):
    rows, lens, claimed, votes = _crc_vote_inputs()
    r = rows.shape[2]
    want = [np.asarray(x) for x in RPAR.make_crc_vote_step(ref_mesh, r)(
        *RPAR.shard_to_mesh(ref_mesh, rows, lens, claimed, votes))]
    ok, bad, tally = COL.make_crc_vote_step(mesh, r)(rows, lens, claimed, votes)
    for got, w in zip((np.asarray(ok), np.asarray(bad), tally.numpy()), want):
        np.testing.assert_array_equal(got, w)
    assert want[1].sum() == 2 and not want[0][2, 4]
    t = [torch.from_numpy(x) for x in (rows, lens, claimed.view(np.int32), votes)]
    for got, w in zip(COL.crc_vote_plain(*t), want):
        np.testing.assert_array_equal(got.numpy(), w)


def test_segment_validator_counts_bad_rows_per_segment():
    from redpanda_tpu_torch.ops import crc32c_device as C

    rows, lens, claimed, _ = _crc_vote_inputs()
    data = torch.from_numpy(rows.reshape(-1, rows.shape[2]))
    ln = torch.from_numpy(lens.reshape(-1))
    cl = torch.from_numpy(claimed.reshape(-1).view(np.int32))
    ok, bad = C.validate_segments(data, ln, cl, 5, None)  # CPU: the plain version
    assert torch.equal(ok, C.validate_plain(data, ln, cl))
    rows_bad = (~ok & (ln > 0)).to(torch.int32)
    want = [int(rows_bad[i : i + 5].sum()) for i in range(0, len(rows_bad), 5)]
    assert bad.tolist() == want and len(want) == 5  # 24 rows: the last segment holds 4
    with pytest.raises(ValueError):
        C.validate_segments(data, ln, cl, 0, None)


# ------------------------------------------------------------------ K10
SPEC = ref_filter_field_eq("level", "error") | ref_map_project(RInt("code"), RStr("msg", 32))


def _dryrun_tick(p: int):
    """__graft_entry__.dryrun_multichip's tick: p partitions x 2 batches,
    x 4 records, votes on group 3."""
    import __graft_entry__ as G

    b, g, r_batch, r_rec = 2, 16, 256, 128
    batches = [
        RRecordBatch.build([RRecord(offset_delta=j, value=b"v%d" % j) for j in range(2)],
                           base_offset=i)
        for i in range(p * b)
    ]
    rows, lens, crcs = ref_pack_batches_prefixed(batches, r_batch)
    rec_data, rec_lens = G._example_records(p * 4, r_rec)
    votes = np.zeros((p, g), dtype=np.uint8)
    votes[:, 3] = 1
    return (rows.reshape(p, b, r_batch), lens.reshape(p, b), crcs.reshape(p, b),
            rec_data.reshape(p, 4, r_rec), rec_lens.reshape(p, 4), votes)


def _random_tick(p: int, b: int, n: int, r_batch: int = 256, r_rec: int = 128):
    rng = np.random.default_rng(17)
    batches = [
        RRecordBatch.build([RRecord(offset_delta=j, value=rng.bytes(int(rng.integers(0, 60))))
                            for j in range(int(rng.integers(1, 3)))], base_offset=i)
        for i in range(p * b)
    ]
    rows, lens, crcs = ref_pack_batches_prefixed(batches, r_batch)
    crcs[[2, 11]] ^= 0x40
    lens[5] = 0
    rec = rng.integers(0, 256, size=(p * n, r_rec), dtype=np.uint8)  # garbage past each length
    rec_lens = np.zeros(p * n, np.int32)
    for i in range(p * n):
        doc = {"level": ["error", "info", "warn"][int(rng.integers(0, 3))],
               "code": int(rng.integers(-10**10, 10**10)) if i % 7 == 0 else int(rng.integers(-99, 999)),
               "msg": "m" * int(rng.integers(0, 40))}
        v = json.dumps(doc, separators=(",", ":")).encode()[:r_rec]
        rec[i, : len(v)] = np.frombuffer(v, np.uint8)
        rec_lens[i] = len(v)
    votes = rng.integers(0, 2, (p, 24)).astype(np.uint8)
    return (rows.reshape(p, b, r_batch), lens.reshape(p, b), crcs.reshape(p, b),
            rec.reshape(p, n, r_rec), rec_lens.reshape(p, n), votes)


@pytest.mark.parametrize("case", ["dryrun", "random"])
def test_sharded_coproc_step_matches_reference(case, mesh, ref_mesh, ref_coproc_step):
    args = _dryrun_tick(D) if case == "dryrun" else _random_tick(8, 3, 5)
    r_batch, r_rec = args[0].shape[2], args[3].shape[2]
    assert (r_batch, r_rec) == (256, 128)
    want = [np.asarray(x) for x in ref_coproc_step(*RPAR.shard_to_mesh(ref_mesh, *args))]
    got = COL.make_sharded_coproc_step(mesh, SPEC.to_json(), r_batch, r_rec)(*args)
    ok, out, out_len, keep, tally = [np.asarray(g) if isinstance(g, M.Sharded) else g.numpy()
                                      for g in got]
    w_ok, w_out, w_len, w_keep, w_tally = want
    np.testing.assert_array_equal(ok, w_ok)
    np.testing.assert_array_equal(keep, w_keep)
    np.testing.assert_array_equal(out_len, w_len)
    np.testing.assert_array_equal(out[w_keep], w_out[w_keep])  # dropped rows are undefined
    np.testing.assert_array_equal(tally, w_tally)
    assert w_keep.any() and not w_keep.all()
    if case == "random":
        assert not w_ok.all()
    prog = compile_transform(TransformSpec.from_json(SPEC.to_json()), r_rec)
    plain = COL.coproc_step_plain(prog, *[torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32
                                                          else a) for a in args])
    for g, w in zip((ok, out_len, keep, tally), (plain[0], plain[2], plain[3], plain[4])):
        np.testing.assert_array_equal(g, w.numpy())


def test_dryrun_multichip_on_cpu_shards():
    entry.dryrun_multichip(D, device="cpu")
    entry.dryrun_multichip(3, devices=["cpu"] * 3, device="cpu")
    fn, (data, lens) = entry.entry(device="cpu")
    out, out_len, keep = fn(data, lens)
    assert keep.tolist() == [i % 2 == 0 for i in range(8)]


# ------------------------------------------------------------------ K2
# DOCS' records cut into 4 shards, the second of them empty
SHARDS = [(0, 7), (7, 7), (7, 13), (13, len(DOCS))]


def _stacked(plan, vals, n_pad):
    stacks = []
    for s, e in SHARDS:
        if s == e:
            stacks.append(plan.zero_device_inputs(n_pad))
        else:
            stacks.append(plan.extract_device_inputs(*_records(vals[s:e]), n_pad))
    return [np.stack(cols) for cols in zip(*stacks)]


@pytest.mark.parametrize("idx", range(len(REF_EXPRS)))
def test_stacked_predicate_matches_reference(idx, mesh, ref_mesh):
    vals = [json.dumps(d, separators=(",", ":")).encode() for d in DOCS]
    n_pad = 8
    ref = ref_plan_spec(ref_where(REF_EXPRS[idx]))
    ref_stacked = _stacked(ref, vals, n_pad)
    ref_args = RPAR.shard_to_mesh(ref_mesh, *ref_stacked)  # one array comes back bare
    ref_args = ref_args if isinstance(ref_args, tuple) else (ref_args,)
    want = np.asarray(ref.compile_device_stacked(ref_mesh)(*ref_args))
    plan = CP.plan_spec(TransformSpec.from_json(ref_where(REF_EXPRS[idx]).to_json()))
    stacked = _stacked(plan, vals, n_pad)
    for a, b in zip(ref_stacked, stacked):
        np.testing.assert_array_equal(a, b)
    got = plan.predicate_stacked(mesh, stacked)
    assert isinstance(got, M.Sharded) and got.shape == (D, n_pad // 8)
    np.testing.assert_array_equal(np.asarray(got), want)
    plain = CP.predicate_stacked_plain(plan, [torch.from_numpy(a) for a in stacked])
    np.testing.assert_array_equal(plain.numpy(), want)
    # block d is the single-device predicate over shard d's rows alone
    for d, (s, e) in enumerate(SHARDS):
        if s < e:
            cols = [torch.from_numpy(c) for c in plan.extract_device_inputs(*_records(vals[s:e]), n_pad)]
            np.testing.assert_array_equal(plan.predicate(cols).numpy(), want[d])


def test_zero_device_inputs_match_reference():
    spec = ref_where((ref_field("level") == "error") & (ref_field("code") > 3)
                     & ref_field("meta").exists())
    ref = ref_plan_spec(spec)
    plan = CP.plan_spec(TransformSpec.from_json(spec.to_json()))
    for a, b in zip(ref.zero_device_inputs(16), plan.zero_device_inputs(16)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ engine mesh lane
MESH_SPECS = {  # tests/test_meshrunner.py SPECS
    "passthrough": ref_where(ref_field("level") == "error"),
    "projection": ref_where(ref_field("level") == "error") | ref_map_project(RInt("code"),
                                                                             RStr("msg", 24)),
    "payload": ref_filter_contains(b"error"),
}


def _mesh_request(n_items=8, records=48, topic="mesh"):
    """tests/test_meshrunner.py's _request."""
    rng = np.random.default_rng(11)
    items = []
    for p in range(n_items):
        recs = [
            RRecord(offset_delta=i, value=json.dumps({
                "level": ["error", "info", "warn"][(p + i) % 3],
                "code": p * 1000 + i,
                "msg": "m%d-%s" % (p, "x" * int(rng.integers(4, 20))),
            }).encode())
            for i in range(records)
        ]
        items.append(RItem(1, RNTP.kafka(topic, p), [RRecordBatch.build(recs, base_offset=0)]))
    return RRequest(items)


def _port_request(req):
    return interop.request_from_wire([
        (it.script_id, (it.ntp.ns, it.ntp.topic, it.ntp.partition),
         [b.encode_internal() for b in it.batches])
        for it in req.items
    ])


def _reply_bytes(reply):
    return [(it.script_id, it.source.partition, [b.encode_internal() for b in it.batches])
            for it in reply.items], list(reply.deregistered)


def _ref_run(spec, req):
    TpuEngine.reset_columnar_probe()
    eng = TpuEngine(row_stride=256, host_workers=0, host_pool_probe=False, mesh_devices=D,
                    mesh_backend="cpu", mesh_probe=False)
    try:
        assert eng.enable_coprocessors([(1, spec.to_json(), ("mesh",))]) == [0]
        return _reply_bytes(eng.process_batch(req)), eng.stats()
    finally:
        eng.shutdown()


@pytest.mark.parametrize("plan", sorted(MESH_SPECS))
@pytest.mark.parametrize("shape", [(8, 48), (3, 48), (8, 0)])
def test_engine_mesh_lane_matches_reference(plan, shape, mesh):
    """(8, 48): the reference suite's request; (3, 48): fewer batches than
    shards, so one shard runs empty; (8, 0): no records at all."""
    req = _mesh_request(*shape)
    want, ref_stats = _ref_run(MESH_SPECS[plan], req)
    eng = TorchEngine(device="cpu", row_stride=256, mesh=mesh, mesh_probe=False)
    assert eng.enable_coprocessors([(1, MESH_SPECS[plan].to_json(), ("mesh",))]) == [0]
    got = _reply_bytes(eng.process_batch(_port_request(req)))
    stats = eng.stats()
    eng.shutdown()
    assert got == want
    assert stats["mesh"]["rows_per_device"] == ref_stats["mesh"]["rows_per_device"]
    assert stats.get("n_mesh_launches", 0) == ref_stats.get("n_mesh_launches", 0)
    if plan != "payload" and shape[1]:
        assert stats["n_mesh_launches"] == 1 and stats["n_kernel_predicate_stacked"] == D
        assert sum(stats["mesh"]["rows_per_device"]) == shape[0] * shape[1]
        assert "n_kernel_predicate" not in stats
    assert not any(k.startswith("n_failures") for k in stats)


def test_engine_mesh_devices_builds_a_cpu_mesh():
    req = _port_request(_mesh_request())
    spec = MESH_SPECS["projection"].to_json()
    single = TorchEngine(device="cpu", row_stride=256)
    single.enable_coprocessors([(1, spec, ("mesh",))])
    want = _reply_bytes(single.process_batch(req))
    eng = TorchEngine(device="cpu", row_stride=256, mesh_devices=3, mesh_probe=False)
    eng.enable_coprocessors([(1, spec, ("mesh",))])
    assert _reply_bytes(eng.process_batch(req)) == want
    assert eng.stats()["mesh"]["devices"] == 3
    for n in (None, 1):  # below two shards: the single lane, no mesh block
        assert "mesh" not in TorchEngine(device="cpu", mesh_devices=n).stats()


def test_engine_one_batch_launch_splits_evenly_on_a_pinned_mesh(mesh):
    req = _port_request(_mesh_request(n_items=1, records=300))
    spec = MESH_SPECS["projection"].to_json()
    single = TorchEngine(device="cpu", row_stride=256)
    single.enable_coprocessors([(1, spec, ("mesh",))])
    want = _reply_bytes(single.process_batch(req))
    eng = TorchEngine(device="cpu", row_stride=256, mesh=mesh, mesh_probe=False)
    eng.enable_coprocessors([(1, spec, ("mesh",))])
    assert _reply_bytes(eng.process_batch(req)) == want
    st = eng.stats()
    # the padded launch of 512 rows as 4 blocks of 128; the range shard's
    # rows-per-device accounting is untouched
    assert st["n_mesh_launches"] == 1 and st["n_kernel_predicate_stacked"] == D
    assert st["mesh"]["launches"] == 0 and st["mesh"]["rows_per_device"] == [0] * D


def test_engine_mesh_probe_decides_and_records(mesh):
    req = _port_request(_mesh_request(n_items=8, records=160))  # 1280 rows >= PROBE_MIN_ROWS
    small = _port_request(_mesh_request(n_items=8, records=16))
    spec = MESH_SPECS["passthrough"].to_json()
    single = TorchEngine(device="cpu", row_stride=256)
    single.enable_coprocessors([(1, spec, ("mesh",))])
    eng = TorchEngine(device="cpu", row_stride=256, mesh=mesh)
    eng.enable_coprocessors([(1, spec, ("mesh",))])
    assert _reply_bytes(eng.process_batch(small)) == _reply_bytes(single.process_batch(small))
    assert eng.stats()["mesh"]["decision"] is None  # too small to pin anything
    assert _reply_bytes(eng.process_batch(req)) == _reply_bytes(single.process_batch(req))
    m = eng.stats()["mesh"]
    assert m["decision"] in ("mesh", "single") and m["probe"]["chosen"] == m["decision"]
    assert m["probe"]["devices"] == D and m["probe"]["t_mesh_ms"] > 0


def test_mesh_must_match_the_device():
    class CudaMesh:  # a mesh of another device type than the caller's
        size, type = 2, "cuda"

    with pytest.raises(ValueError):
        TorchEngine(device="cpu", mesh=CudaMesh())
    with pytest.raises(ValueError):
        DP.RaftDevicePlane(mesh=CudaMesh(), device="cpu")


# ------------------------------------------------------------------ raft mesh leg
def test_raft_plane_mesh_leg_matches_reference(mesh, ref_mesh):
    """tests/test_meshrunner.py test_raft_device_plane_validate_and_tally's
    regions, one more of them: 97 rows, so the mesh leg pads three zero
    rows, which must be neither ok nor bad."""
    rng = np.random.default_rng(5)
    regions = [rng.bytes(64 + 13 * i) for i in range(97)]  # 97 rows: three zero pad rows
    claimed = np.array([ref_crc32c(x) for x in regions], np.uint32)
    claimed[7] ^= 0x10
    ref = RDP.RaftDevicePlane(mesh=ref_mesh, probe=False)
    plane = DP.RaftDevicePlane(mesh=mesh, probe=False, device="cpu")
    want = ref.validate(regions, claimed)
    got = plane.validate(regions, claimed)
    np.testing.assert_array_equal(got, want)
    assert got.sum() == 96 and not got[7]
    votes = rng.integers(0, 2, (D, 32)).astype(np.uint8)
    np.testing.assert_array_equal(plane.tally_votes(votes), ref.tally_votes(votes))
    # a matrix with another number of voter rows is the host sum, by design
    votes5 = rng.integers(0, 2, (5, 32)).astype(np.uint8)
    np.testing.assert_array_equal(plane.tally_votes(votes5), ref.tally_votes(votes5))
    st = plane.stats()
    assert st["devices"] == D and st["validations"] == 1 and st["tallies"] == 2


def test_raft_plane_mesh_probe_and_default_plane(mesh):
    rng = np.random.default_rng(9)
    regions = [rng.bytes(200) for _ in range(130)]
    claimed = np.array([ref_crc32c(x) for x in regions], np.uint32)
    claimed[::17] ^= 1
    plane = DP.RaftDevicePlane(mesh=mesh, probe=True, device="cpu")
    np.testing.assert_array_equal(plane.validate(regions, claimed),
                                  DP._host_validate(regions, claimed))
    assert plane.stats()["probe"]["devices"] == D
    DP.reset_default_plane()
    DP.configure(mesh_devices=D)
    try:
        p = DP.default_plane(device="cpu")
        assert p.n_devices == D and p.mesh is not None
    finally:
        DP.configure(mesh_devices=0)
        DP.reset_default_plane()
    assert DP.default_plane(device="cpu").n_devices == 1
    DP.reset_default_plane()


@pytest.mark.parametrize("policy", ["skip_on_failure", "deregister"])
def test_failing_shard_launch_meets_the_dispatch_boundary(policy, mesh, monkeypatch):
    """A shard launch that fails raises into the engine's dispatch boundary
    (the script's error policy, counted in stats()); no shard's answer
    comes from a host or numpy fallback."""
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc.engine import ErrorPolicy

    predicate = CP.ColumnarPlan.predicate

    def failing(self, arrays, kernel=kernels.PREDICATE):
        if kernel is kernels.PREDICATE_STACKED:
            raise RuntimeError("predicate_stacked: kernel launch failed, CUDA error 700")
        return predicate(self, arrays, kernel)

    monkeypatch.setattr(CP.ColumnarPlan, "predicate", failing)
    eng = TorchEngine(device="cpu", row_stride=256, mesh=mesh, mesh_probe=False)
    spec = MESH_SPECS["projection"].to_json()
    assert eng.enable_coprocessors([(1, spec, ("mesh",), ErrorPolicy[policy])]) == [0]
    reply = eng.process_batch(_port_request(_mesh_request()))
    st = eng.stats()
    assert st["n_failures_dispatch"] == 1 and "n_mesh_launches" not in st
    if policy == "deregister":
        assert reply.deregistered == [1] and eng.heartbeat() == 0
    else:
        assert len(reply.items) == 8 and all(not it.batches for it in reply.items)
