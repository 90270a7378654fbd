"""The port's CUDA kernels against their plain PyTorch versions, on the card.

The tests marked ``cuda`` need an NVIDIA CUDA device and skip elsewhere (the
kernels have no CPU mode); the mesh's no-card test runs where there are
fewer than two cards. They import only the port, so they run on a machine
without JAX:

    python -m pytest -p no:cacheprovider tests/test_torch_cuda.py

Inputs are made from a seed with numpy; every comparison is exact (bits,
bytes and ints).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from redpanda_tpu_torch import kernels
from redpanda_tpu_torch.coproc.column_plan import plan_spec, predicate_plain
from redpanda_tpu_torch.coproc.engine import ProcessBatchItem, ProcessBatchRequest, TorchEngine
from redpanda_tpu_torch.models import NTP, Record, RecordBatch
from redpanda_tpu_torch.ops import exprs as E
from redpanda_tpu_torch.ops import transforms as T
from redpanda_tpu_torch.ops.pipeline import IN_META, packed_plain, run_packed


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _no_columnar_verdict():
    """The engines' columnar backend is process-wide: every test starts and
    ends with none measured, so that no test inherits another's verdict."""
    TorchEngine.reset_columnar_probe()
    yield
    TorchEngine.reset_columnar_probe()


def _docs(rng, n):
    out = []
    for i in range(n):
        d = {"level": ["error", "info", "", "errorx"][i % 4], "code": int(rng.integers(-600, 600))}
        if i % 5:
            d["msg"] = "ab" * int(rng.integers(0, 20)) + ("needle" if i % 3 == 0 else "")
        if i % 7 == 0:
            d["code"] = [1.5, 2**31, "12", True, None][i % 5]
        out.append(json.dumps(d, separators=(",", ":")).encode())
    return out


EXPRS = [
    (E.field("level") == "error") & (E.field("code") >= 100),
    E.field("level") != "error",
    E.field("msg").contains(b"needle", window=16) | ~E.field("msg").exists(),
    (E.field("code") == 2**31) | (E.field("code") < -2.5) | (E.field("code") == None),  # noqa: E711
    E.field("code") == True,  # noqa: E712
]


@pytest.mark.cuda
@pytest.mark.parametrize("idx", range(len(EXPRS)))
def test_predicate_kernel_matches_plain(card, idx):
    """The one-block call over resident column tensors, K2's entry
    (rp_predicate_blocks) counted under K2; K1's entry has its own test."""
    rng = np.random.default_rng(idx)
    vals = _docs(rng, 1003)
    joined = b"".join(vals)
    offsets = np.cumsum([0] + [len(v) for v in vals[:-1]]).astype(np.int64)
    sizes = np.array([len(v) for v in vals], np.int32)
    plan = plan_spec(T.where(EXPRS[idx]))
    cols = [torch.from_numpy(c).to(card) for c in plan.extract_device_inputs(
        joined, offsets, sizes, 1008)]  # a multiple of 8, not of 32
    before = kernels.PREDICATE_STACKED.launches
    got = plan.predicate(cols)
    assert kernels.PREDICATE_STACKED.launches == before + 1
    assert torch.equal(got, predicate_plain(plan, cols))
    with pytest.raises(ValueError):
        plan.predicate([c.cpu() if i == 0 else c for i, c in enumerate(cols)])


def _cols(plan, vals, n_pad):
    """The extraction's host columns of ``vals`` at ``n_pad`` rows."""
    joined = b"".join(vals)
    offsets = np.cumsum([0] + [len(v) for v in vals[:-1]]).astype(np.int64)
    sizes = np.array([len(v) for v in vals], np.int32)
    return plan.extract_device_inputs(joined, offsets, sizes, n_pad)


def _deep():
    """A tree 70 deep: one spill word."""
    deep = E.field("code") >= -600
    for k in range(1, 70):
        deep = E.And(E.field("code") >= k - 600, deep) if k % 2 else E.Or(E.field("code") < k, deep)
    return deep


@pytest.mark.cuda
@pytest.mark.parametrize("idx", range(len(EXPRS) + 1))
def test_predicate_leg_matches_plain(card, idx):
    """One rp_predicate_leg crossing from a pinned block (copy up, kernel,
    bits down into pinned memory, four events) and one over the block left
    resident on the card, each one K1 launch, both equal to the plain
    version; a pageable host block is refused before any launch."""
    from redpanda_tpu_torch.coproc.column_plan import LegEvents

    plan = plan_spec(T.where(EXPRS[idx] if idx < len(EXPRS) else _deep()))
    cols = _cols(plan, _docs(np.random.default_rng(20 + idx), 1003), 1008)
    want = predicate_plain(plan, [torch.from_numpy(c) for c in cols])
    lay = plan.block_layout(1008)
    host = torch.empty(lay.total, dtype=torch.uint8, pin_memory=True)
    lay.pack(cols, host.numpy())
    block = torch.empty(lay.total, dtype=torch.uint8, device=card)
    bits = torch.empty(126, dtype=torch.uint8, device=card)
    bits_host = torch.zeros(126, dtype=torch.uint8, pin_memory=True)
    words = max(plan.spill_words(), 0) * 1008
    scratch = torch.empty(max(words, 1), dtype=torch.int64, device=card)
    events = LegEvents()
    try:
        before = kernels.PREDICATE.launches
        plan.predicate_leg(1008, block, bits, host_block=host, bits_host=bits_host,
                           scratch=scratch, events=events)
        h2d, kern, d2h = events.wait()
        assert kernels.PREDICATE.launches == before + 1 and events.done()
        assert torch.equal(bits_host, want) and min(h2d, kern, d2h) >= 0
        bits.zero_()
        plan.predicate_leg(1008, block, bits, scratch=scratch)  # resident: no copy up
        assert torch.equal(bits.cpu(), want) and kernels.PREDICATE.launches == before + 2
        with pytest.raises(ValueError, match="pinned"):
            plan.predicate_leg(1008, block, bits, host_block=host.clone(), scratch=scratch)
        assert kernels.PREDICATE.launches == before + 2
    finally:
        events.close()


@pytest.mark.cuda
def test_predicate_leg_200_calls_through_reused_slots(card):
    """200 legs of an engine on fresh columns each, three in flight at a
    time, through the engine's staging slots (at most three, reused), each
    result equal to the plain version: a slot reused too early would hand
    over another launch's bits."""
    plan = plan_spec(T.where(EXPRS[0]))
    rng = np.random.default_rng(21)
    eng = TorchEngine(device=card, row_stride=128, host_workers=0, force_mode="columnar_device")
    try:
        before = kernels.PREDICATE.launches
        inflight = []
        for k in range(200):
            cols = _cols(plan, _docs(rng, int(rng.integers(100, 1000))), 1024)
            inflight.append((eng._run_leg(plan, cols), cols))
            if len(inflight) == 3 or k == 199:
                for pending, c in inflight:
                    got = pending.wait(eng)
                    want = predicate_plain(plan, [torch.from_numpy(a) for a in c]).numpy()
                    assert (got == want).all()
                inflight = []
        st = eng.leg_slot_stats()
        assert kernels.PREDICATE.launches == before + 200
        assert st["slots"] <= 3 and st["held"] == 0
        assert eng.stats()["t_dev_kernel"] > 0
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_predicate_leg_over_a_cached_block(card):
    """A cache miss copies its columns into a device block of the entry's
    own; a hit launches over that block with no copy up; both equal the
    plain version, and the entry's block outlives the slot's next use."""
    from redpanda_tpu_torch.coproc import colcache

    plan = plan_spec(T.where(EXPRS[2]))
    rng = np.random.default_rng(22)
    cols = _cols(plan, _docs(rng, 900), 1024)
    other = _cols(plan, _docs(rng, 900), 1024)
    want = predicate_plain(plan, [torch.from_numpy(c) for c in cols]).numpy()
    eng = TorchEngine(device=card, row_stride=128, host_workers=0, force_mode="columnar_device")
    try:
        entry = colcache.Entry(n=900, n_pad=1024, ranges=[(0, 900)], cols=cols)
        assert (eng._run_leg(plan, cols, entry=entry).wait(eng) == want).all()
        block = entry.cols_dev
        assert block.is_cuda and block.nbytes == plan.block_layout(1024).total
        eng._run_leg(plan, other).wait(eng)  # the slot rewritten with other columns
        st0 = eng.stats()
        before = kernels.PREDICATE.launches
        hit = eng._run_leg(plan, cols, dev_block=block).wait(eng)
        st1 = eng.stats()
        assert (hit == want).all() and kernels.PREDICATE.launches == before + 1
        assert st1["bytes_h2d"] == st0["bytes_h2d"]  # nothing copied up
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_a_failing_leg_raises_with_no_launch_counted(card):
    """rp_predicate_leg refuses a row count that is not a multiple of 8:
    RuntimeError, no launch counted, and on an engine the slot goes back."""
    plan = plan_spec(T.where(EXPRS[1]))
    cols = _cols(plan, _docs(np.random.default_rng(23), 10), 12)
    lay = plan.block_layout(12)
    host = torch.empty(lay.total, dtype=torch.uint8, pin_memory=True)
    lay.pack(cols, host.numpy())
    block = torch.empty(lay.total, dtype=torch.uint8, device=card)
    bits = torch.empty(2, dtype=torch.uint8, device=card)
    before = kernels.PREDICATE.launches
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        plan.predicate_leg(12, block, bits, host_block=host)
    eng = TorchEngine(device=card, row_stride=128, host_workers=0, force_mode="columnar_device")
    try:
        with pytest.raises(RuntimeError, match="kernel launch failed"):
            eng._run_leg(plan, cols)
        assert kernels.PREDICATE.launches == before and eng.leg_slot_stats()["held"] == 0
    finally:
        eng.shutdown()


SPECS = [
    T.filter_field_eq("level", "error") | T.map_project(T.Int("code"), T.Str("msg", 16)),
    T.filter_field_eq("code", 42),
    T.filter_contains(b"rr") | T.map_uppercase(),
    T.map_project(T.Str("msg", 4), T.Int("code")),
]


@pytest.mark.cuda
@pytest.mark.parametrize("idx", range(len(SPECS)))
def test_payload_kernel_matches_plain(card, idx):
    rng = np.random.default_rng(10 + idx)
    r = 96
    vals = _docs(rng, 997)
    data = rng.integers(0, 256, size=(len(vals), r), dtype=np.uint8)
    lens = np.zeros(len(vals), np.int32)
    for i, v in enumerate(vals):
        m = min(len(v), r)
        data[i, :m] = np.frombuffer(v[:m], np.uint8)
        lens[i] = m
    prog = T.compile_transform(SPECS[idx], r)
    d, ln = torch.from_numpy(data).to(card), torch.from_numpy(lens).to(card)
    out, out_len, keep = T.transform(prog, d, ln)
    w_out, w_len, w_keep = T.transform_plain(prog, d, ln)
    assert torch.equal(keep, w_keep) and torch.equal(out_len, w_len)
    assert torch.equal(out[w_keep], w_out[w_keep])
    staged = torch.zeros((len(vals), r + IN_META), dtype=torch.uint8, device=card)
    staged[:, :r] = d
    staged[:, r : r + 4] = ln.view(torch.uint8).reshape(-1, 4)
    got, want = run_packed(prog, staged), packed_plain(prog, staged)
    kept = want[:, prog.r_out + 4].bool()
    assert torch.equal(got[:, prog.r_out:], want[:, prog.r_out:])
    assert torch.equal(got[kept, : prog.r_out], want[kept, : prog.r_out])


def _staged_at(d, ln, offset, dev):
    """Rows staged as the engine stages them (row, LE32 length, 4 zero
    bytes: stride r + 8) in a view offset bytes past a 16-byte boundary
    that ends where its buffer's bytes end."""
    n, r = d.shape
    buf = torch.zeros(n * (r + IN_META) + offset, dtype=torch.uint8, device=dev)
    staged = buf[offset:].view(n, r + IN_META)
    staged[:, :r] = d
    staged[:, r : r + 4] = ln.view(torch.uint8).reshape(n, 4)
    return staged


def _assert_payload_matches(prog, d, ln, dev):
    """Packed at every offset mod 16 and unpacked at offsets 0 and 3: the
    kernel equals the plain version (meta of every row, out of kept rows)."""
    from redpanda_tpu_torch.ops.pipeline import record_plain, run_record

    for off in range(16):
        staged = _staged_at(d, ln, off, dev)
        got, want = run_packed(prog, staged), packed_plain(prog, staged)
        kept = want[:, prog.r_out + 4].bool()
        assert torch.equal(got[:, prog.r_out:], want[:, prog.r_out:]), off
        assert torch.equal(got[kept, : prog.r_out], want[kept, : prog.r_out]), off
    for off in (0, 3):
        buf = torch.zeros(d.numel() + off, dtype=torch.uint8, device=dev)
        dd = buf[off:].view(d.shape)
        dd.copy_(d)
        out, out_len, keep = run_record(prog, dd, ln)
        w_out, w_len, w_keep = record_plain(prog, dd, ln)
        assert torch.equal(keep, w_keep) and torch.equal(out_len, w_len), off
        assert torch.equal(out[w_keep], w_out[w_keep]), off


@pytest.mark.cuda
@pytest.mark.parametrize("idx", range(9))
def test_payload_kernel_matches_plain_on_edge_rows(card, idx):
    """The hand-made edge rows (ops/transforms.py edge_cases at r = 1152:
    first valid starts at 31/32/33 and 127/128/129, matches ending at the
    length and at r, with and without the nonnum rule, lengths 0, negative
    and past r, Int and Str fields at their limits) with each edge spec."""
    data, lens, specs = T.edge_cases(1152)
    prog = T.compile_transform(specs[idx], 1152)
    _assert_payload_matches(prog, torch.from_numpy(data).to(card),
                            torch.from_numpy(lens).to(card), card)


@pytest.mark.cuda
@pytest.mark.parametrize("r", [96, 1152, 1155])
def test_payload_kernel_at_every_alignment(card, r):
    """JSON rows (bytes past each length random) staged at stride r + 8 in
    buffers at every offset mod 16, for every spec: rows at every alignment,
    the last one ending where the buffer ends."""
    rng = np.random.default_rng(r)
    vals = _docs(rng, 613)
    data = rng.integers(0, 256, size=(len(vals), r), dtype=np.uint8)
    lens = np.zeros(len(vals), np.int32)
    for i, v in enumerate(vals):
        m = min(len(v), r)
        data[i, :m] = np.frombuffer(v[:m], np.uint8)
        lens[i] = m
    lens[:3] = [0, -3, r + 9]
    d, ln = torch.from_numpy(data).to(card), torch.from_numpy(lens).to(card)
    for spec in SPECS:
        _assert_payload_matches(T.compile_transform(spec, r), d, ln, card)


@pytest.mark.cuda
def test_engine_on_card_matches_cpu_engine(card):
    rng = np.random.default_rng(4)
    items = []
    for p in range(4):
        recs = [Record(offset_delta=i, value=v) for i, v in enumerate(_docs(rng, 40))]
        items.append(ProcessBatchItem(1, NTP.kafka("t", p), [RecordBatch.build(recs)]))
    req = ProcessBatchRequest(items)
    specs = [T.where(EXPRS[0]) | T.map_project(T.Int("code"), T.Str("msg", 24)), SPECS[0]]
    for spec in specs:
        replies = []
        for dev in (card, "cpu"):
            eng = TorchEngine(device=dev, row_stride=128)
            assert eng.enable_coprocessors([(1, spec.to_json(), ("t",))]) == [0]
            tickets = eng.submit_group([req, req, req])
            replies.append([[b.encode_internal() for it in t.result().items for b in it.batches]
                            for t in tickets])
            eng.shutdown()
        assert replies[0] == replies[1]
        assert any(replies[1][0])


# ------------------------------------------------------------------ CRC (K5/K6)
def _crc_rows(r, seed):
    rng = np.random.default_rng(seed)
    lens = [0, 1, 7, 8, 15, 16, 17, 63, 64, 65, 511, 512, 513, r - 1, r, r + 5, -3]
    lens += [int(x) for x in rng.integers(0, r + 1, 300)]
    data = rng.integers(0, 256, size=(len(lens), r), dtype=np.uint8)  # garbage past len
    return data, np.array(lens, np.int32), rng


@pytest.mark.cuda
@pytest.mark.parametrize("r", [100, 2048, 16384])
def test_crc_kernel_matches_plain(card, r):
    from redpanda_tpu_torch.hashing.crc32c import crc32c_many
    from redpanda_tpu_torch.ops import crc32c_device as C

    data, lens, rng = _crc_rows(r, r)
    d, ln = torch.from_numpy(data).to(card), torch.from_numpy(lens).to(card)
    before = kernels.CRC32C.launches, kernels.CRC32C_VALIDATE.launches
    got = C.crc32c_rows(d, ln)
    assert torch.equal(got, C.crc_plain(d, ln))
    np.testing.assert_array_equal(C.as_u32(got), crc32c_many(data, lens))
    claimed = got.clone()
    claimed[::5] ^= 1
    ok = C.validate_rows(d, ln, claimed)
    assert torch.equal(ok, C.validate_plain(d, ln, claimed))
    assert (kernels.CRC32C.launches, kernels.CRC32C_VALIDATE.launches) == (before[0] + 1, before[1] + 1)
    # rows that are not 16-byte aligned take the byte loads
    odd = torch.from_numpy(data[:, 1:].copy()).to(card)
    assert torch.equal(C.crc32c_rows(odd, ln), C.crc_plain(odd, ln))


@pytest.mark.cuda
@pytest.mark.parametrize("r,n", [(100, 256), (100, 8192), (2048, 1024), (4097, 256),
                                 (4097, 1024), (4097, 8192), (16384, 64), (16384, 256),
                                 (16384, 512), (16384, 1024), (16384, 8192)])
def test_crc_kernel_matches_plain_on_split_layouts(card, r, n):
    """K5 and K6 are the split kernel's one-block case: at every span count
    split_layout picks (1, 2, 4, 8 warps a row), on rows at a 16-byte
    boundary and one byte past it, at edge and random lengths, each one
    launch counted on its own row."""
    from redpanda_tpu_torch.ops import crc32c_device as C

    gen = torch.Generator(device=card).manual_seed(r + n)
    lens = torch.randint(0, r + 1, (n,), generator=gen, device=card, dtype=torch.int32)
    edge = [0, -3, r + 5, r, r - 1, 1, 15, 16, 17, 511, 512, 513, 2048, 2049, 4096, 8192]
    lens[: len(edge)] = torch.tensor(edge, dtype=torch.int32, device=card)
    buf = torch.randint(0, 256, (n * r + 1,), generator=gen, device=card, dtype=torch.uint8)
    for off in (0, 1):
        d = buf[off : off + n * r].view(n, r)
        want = C.crc_plain(d, lens)
        claimed = want.clone()
        claimed[::3] ^= 0x100
        before = kernels.CRC32C.launches, kernels.CRC32C_VALIDATE.launches
        assert torch.equal(C.crc32c_rows(d, lens), want)
        assert torch.equal(C.validate_rows(d, lens, claimed), C.validate_plain(d, lens, claimed))
        after = kernels.CRC32C.launches, kernels.CRC32C_VALIDATE.launches
        assert after == (before[0] + 1, before[1] + 1)


# ------------------------------------------------------------------ LZ4 (K11)
@pytest.mark.cuda
def test_lz4_kernel_matches_plain(card):
    from redpanda_tpu_torch.ops import lz4_device as L

    rng = np.random.default_rng(8)
    recs = L.text_records(200, 700)
    try:
        comp = [L.lz4_block_compress(p) for p in recs]
    except OSError:  # no liblz4 on this machine: the tests' encoder makes the streams
        from lz4_block_encoder import lz4_block_encode

        comp = [lz4_block_encode(p) for p in recs]
    rows, lens = L.pack_streams(comp)
    lens[::7] = lens[::7] // 2  # truncated
    rows[3::11, 5] ^= 0x5A  # damaged
    lens[1] = 0
    garbage = rng.integers(0, 256, size=(50, rows.shape[1]), dtype=np.uint8)
    rows = np.concatenate([rows, garbage])
    lens = np.concatenate([lens, rng.integers(-2, rows.shape[1] + 9, 50).astype(np.int32)])
    c, cl = torch.from_numpy(rows).to(card), torch.from_numpy(lens).to(card)
    for max_out in (700, 512, 1):
        before = kernels.LZ4_BLOCK.launches
        got = L.decode_rows(c, cl, max_out)
        want = L.decode_plain(c, cl, max_out)
        assert kernels.LZ4_BLOCK.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    out, out_len, ok = L.decode_rows(c, cl, 700)
    good = [i for i in range(len(recs)) if i % 7 and (i - 3) % 11 and i != 1]
    assert ok[good].all()
    for i in good[:20]:
        assert out[i, : int(out_len[i])].cpu().numpy().tobytes() == recs[i]


@pytest.mark.cuda
@pytest.mark.parametrize("max_out,pad", [(128, 0), (77, 3), (1024, 0), (49152, 0)])
def test_lz4_kernel_matches_plain_on_edge_streams(card, max_out, pad):
    """The edge streams (ops/lz4_device.py edge_streams) in shared memory
    (rows of 512 or 2048 in; 77 out and 515 in: unaligned rows take the
    byte loads) and, at max_out 49152, on the global rows (one warp's
    slice past 48 KB)."""
    from redpanda_tpu_torch.ops import lz4_device as L

    rows, lens = L.edge_streams(max_out, seed=max_out)
    rows = np.pad(rows, ((0, 0), (0, pad)))
    if max_out > 2048:  # every 11th offset/length pair and every other stream: the
        keep = np.r_[0 : 40 * 77 : 11, 40 * 77 : len(lens)]  # plain version runs
        rows, lens = rows[keep], lens[keep]  # max_out steps, on the host
    c, cl = torch.from_numpy(rows).to(card), torch.from_numpy(lens).to(card)
    before = kernels.LZ4_BLOCK.launches
    got = L.decode_rows(c, cl, max_out)
    assert kernels.LZ4_BLOCK.launches == before + 1
    want = L.decode_plain(c.cpu(), cl.cpu(), max_out)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool(want[2].any()) and not bool(want[2].all())


@pytest.mark.cuda
def test_vote_aggregator_200_calls_on_fresh_votes(card):
    """One launch and no copy per call on a virtual mesh, each tally equal
    to the plain sum of votes made on the card just before the call (and
    of host votes): a missing stream wait would read stale votes."""
    from redpanda_tpu_torch.parallel import collectives as COL
    from redpanda_tpu_torch.parallel import partition_mesh

    mesh = partition_mesh(devices=[card] * 4)
    agg = COL.make_vote_aggregator(mesh)
    gen = torch.Generator(device=card).manual_seed(7)
    before = kernels.VOTE_TALLY.launches, COL.tally_copies
    for _ in range(200):
        votes = torch.randint(0, 2, (4, 256), generator=gen, device=card, dtype=torch.uint8)
        assert torch.equal(agg(votes), COL.vote_tally_plain(votes))
    host = np.random.default_rng(3).integers(0, 2, (8, 256)).astype(np.uint8)
    assert (agg(host).cpu().numpy() == host.astype(np.int32).sum(0)).all()
    assert kernels.VOTE_TALLY.launches == before[0] + 201
    assert COL.tally_copies == before[1]


@pytest.mark.cuda
def test_vote_aggregator_200_calls_across_two_cards(card):
    """On a mesh of shards on two cards (0, 1, 0, 1) each call makes three
    launches and one cross-card copy, each tally equal to the plain sum of
    votes made on the first card just before the call."""
    from redpanda_tpu_torch.parallel import collectives as COL
    from redpanda_tpu_torch.parallel import partition_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the cross-card copy of the tally's partial")
    other = torch.device("cuda", 1 - card.index)
    mesh = partition_mesh(devices=[card, other] * 2)
    agg = COL.make_vote_aggregator(mesh)
    gen = torch.Generator(device=card).manual_seed(8)
    before = kernels.VOTE_TALLY.launches, COL.tally_copies
    for _ in range(200):
        votes = torch.randint(0, 2, (4, 256), generator=gen, device=card, dtype=torch.uint8)
        assert torch.equal(agg(votes), COL.vote_tally_plain(votes))
    assert kernels.VOTE_TALLY.launches == before[0] + 3 * 200
    assert COL.tally_copies == before[1] + 200


# ------------------------------------------------------------------ the mesh (K2, K7-K10)
def _mesh_inputs(rng, p=8, b=3, r=512, n=5, r_rec=256, g=256):
    """Batch rows at random lengths (garbage past each, one empty, three
    claims wrong), JSON record rows and votes, over p partitions."""
    from redpanda_tpu_torch.hashing.crc32c import crc32c_many

    rows = rng.integers(0, 256, size=(p * b, r), dtype=np.uint8)
    lens = rng.integers(1, r + 1, p * b).astype(np.int32)
    lens[4] = 0
    claimed = crc32c_many(rows, lens)
    claimed[[1, 9, p * b - 1]] ^= 0x20
    vals = _docs(rng, p * n)
    rec = rng.integers(0, 256, size=(p * n, r_rec), dtype=np.uint8)
    rec_lens = np.zeros(p * n, np.int32)
    for i, v in enumerate(vals):
        m = min(len(v), r_rec)
        rec[i, :m] = np.frombuffer(v[:m], np.uint8)
        rec_lens[i] = m
    votes = rng.integers(0, 2, (p, g)).astype(np.uint8)
    return (rows.reshape(p, b, r), lens.reshape(p, b), claimed.reshape(p, b),
            rec.reshape(p, n, r_rec), rec_lens.reshape(p, n), votes)


def _t(a, dev):
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a).to(dev)


def _host(x) -> np.ndarray:
    """A mesh result (Sharded or a tensor on the card) on the host."""
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _mesh_kernels_match_plain(mesh, dev):
    from redpanda_tpu_torch.parallel import collectives as COL

    from redpanda_tpu_torch.parallel.mesh import card_groups

    rng = np.random.default_rng(31)
    rows, lens, claimed, rec, rec_lens, votes = _mesh_inputs(rng, p=2 * mesh.size)
    cards = len(card_groups(mesh.devices))
    before = kernels.VOTE_TALLY.launches, COL.tally_copies
    for v in (votes, votes[:, :1]):
        tally = COL.make_vote_aggregator(mesh)(v)
        assert tally.device == mesh.devices[0]
        assert torch.equal(tally.cpu(), COL.vote_tally_plain(torch.from_numpy(v)))
    # one launch per card, plus the partials' sum and C - 1 copies across cards
    assert kernels.VOTE_TALLY.launches == before[0] + 2 * (1 if cards == 1 else cards + 1)
    assert COL.tally_copies == before[1] + 2 * (cards - 1)
    args = [_t(a, dev) for a in (rows, lens, claimed)]
    want_ok, want_bad = COL.sharded_crc_plain(*args)
    before = kernels.CRC32C_SHARDED.launches
    ok, bad = COL.make_sharded_crc_check(mesh, rows.shape[2])(rows, lens, claimed)
    assert kernels.CRC32C_SHARDED.launches == before + cards  # one launch per card
    assert torch.equal(torch.from_numpy(np.asarray(ok)), want_ok.cpu())
    assert torch.equal(torch.from_numpy(np.asarray(bad)), want_bad.cpu())
    assert int(want_bad.sum()) == 3
    v = votes[: mesh.size]
    step = COL.make_crc_vote_step(mesh, rows.shape[2])
    before = kernels.CRC32C_VOTE.launches, kernels.VOTE_TALLY.launches
    got = step(rows[: mesh.size], lens[: mesh.size], claimed[: mesh.size], v)
    # one launch per card, the tally in it; the partials' sum across cards
    assert kernels.CRC32C_VOTE.launches == before[0] + cards
    assert kernels.VOTE_TALLY.launches == before[1] + (0 if cards == 1 else 1)
    want = COL.crc_vote_plain(*[_t(a[: mesh.size], dev) for a in (rows, lens, claimed, v)])
    for g, w in zip(got, want):
        assert (_host(g) == w.cpu().numpy()).all()
    spec = T.filter_field_eq("level", "error") | T.map_project(T.Int("code"), T.Str("msg", 16))
    step = COL.make_sharded_coproc_step(mesh, spec.to_json(), rows.shape[2], rec.shape[2])
    before = kernels.COPROC_STEP.launches
    ok, out, out_len, keep, tally = step(rows, lens, claimed, rec, rec_lens, votes)
    assert kernels.COPROC_STEP.launches == before + cards  # one fused launch per card
    prog = T.compile_transform(spec, rec.shape[2])
    w = COL.coproc_step_plain(prog, *[_t(a, dev) for a in (rows, lens, claimed, rec, rec_lens, votes)])
    w_keep = w[3].cpu().numpy()
    assert (np.asarray(ok) == w[0].cpu().numpy()).all()
    assert (np.asarray(keep) == w_keep).all() and (np.asarray(out_len) == w[2].cpu().numpy()).all()
    assert (np.asarray(out)[w_keep] == w[1].cpu().numpy()[w_keep]).all()
    assert torch.equal(tally.cpu(), w[4].cpu())


@pytest.mark.cuda
def test_mesh_kernels_match_plain_on_a_virtual_mesh(card):
    from redpanda_tpu_torch.parallel import partition_mesh

    _mesh_kernels_match_plain(partition_mesh(devices=[card] * 4), card)


@pytest.mark.cuda
def test_mesh_kernels_match_plain_across_cards(card):
    from redpanda_tpu_torch.parallel import partition_mesh

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: the cross-card copies of the tally's sum")
    _mesh_kernels_match_plain(partition_mesh(), card)


@pytest.mark.cuda
def test_stacked_predicate_matches_plain(card):
    from redpanda_tpu_torch.parallel import partition_mesh

    mesh = partition_mesh(devices=[card] * 4)
    rng = np.random.default_rng(41)
    plan = plan_spec(T.where(EXPRS[0]))
    n_pad = 264  # a multiple of 8, not of 32
    stacks = []
    for d, n in enumerate((250, 0, 264, 17)):  # shard 1 is empty
        if n == 0:
            stacks.append(plan.zero_device_inputs(n_pad))
            continue
        vals = _docs(rng, n)
        joined = b"".join(vals)
        offsets = np.cumsum([0] + [len(v) for v in vals[:-1]]).astype(np.int64)
        sizes = np.array([len(v) for v in vals], np.int32)
        stacks.append(plan.extract_device_inputs(joined, offsets, sizes, n_pad))
    stacked = [np.stack(c) for c in zip(*stacks)]
    before = kernels.PREDICATE_STACKED.launches
    got = np.asarray(plan.predicate_stacked(mesh, stacked))
    assert kernels.PREDICATE_STACKED.launches == before + 1  # one launch for the one card
    from redpanda_tpu_torch.coproc.column_plan import predicate_stacked_plain

    want = predicate_stacked_plain(plan, [torch.from_numpy(a).to(card) for a in stacked])
    assert (got == want.cpu().numpy()).all()
    assert not got[1].any()


def _pool_stacks(plan, rng, n_blocks, n_pad):
    """Column stacks [n_blocks, n_pad, ...] of random documents (every
    fourth block empty)."""
    per = []
    for b in range(n_blocks):
        n = 0 if b % 4 == 1 else int(rng.integers(1, n_pad + 1))
        if n == 0:
            per.append(plan.zero_device_inputs(n_pad))
            continue
        vals = _docs(rng, n)
        joined = b"".join(vals)
        offsets = np.cumsum([0] + [len(v) for v in vals[:-1]]).astype(np.int64)
        sizes = np.array([len(v) for v in vals], np.int32)
        per.append(plan.extract_device_inputs(joined, offsets, sizes, n_pad))
    return [np.stack(c) for c in zip(*per)]


@pytest.mark.cuda
@pytest.mark.parametrize("n_blocks,n_pad", [(1, 8), (4, 8192), (4, 8), (500, 8)])
def test_predicate_blocks_match_plain(card, n_blocks, n_pad):
    """One launch per chunk of the block table (500 blocks of two column
    arrays: 240 + 240 + 20), each block equal to the plain version, also
    for a tree deeper than one stack word (its spill words per block)."""
    from redpanda_tpu_torch.coproc.column_plan import block_chunks, predicate_stacked_plain

    rng = np.random.default_rng(n_blocks + n_pad)
    deep = E.field("code") >= -600
    for k in range(1, 70):  # depth 70: one spill word
        deep = E.And(E.field("code") >= k - 600, deep) if k % 2 else E.Or(E.field("code") < k, deep)
    for expr in (E.field("level") == "error", EXPRS[0], deep):
        plan = plan_spec(T.where(expr))
        stacks = [torch.from_numpy(a).to(card) for a in _pool_stacks(plan, rng, n_blocks, n_pad)]
        before = kernels.PREDICATE_STACKED.launches
        got = plan.predicate_blocks([[t[b] for t in stacks] for b in range(n_blocks)])
        assert kernels.PREDICATE_STACKED.launches == before + len(
            block_chunks(n_blocks, len(stacks)))
        assert torch.equal(got, predicate_stacked_plain(plan, stacks))


@pytest.mark.cuda
def test_stacked_predicate_200_calls_on_fresh_columns(card):
    """One launch per call on a virtual mesh, each result equal to the
    plain version of columns made on the card just before the call: a
    missing stream wait would read stale columns."""
    from redpanda_tpu_torch.coproc.column_plan import predicate_stacked_plain
    from redpanda_tpu_torch.parallel import partition_mesh

    mesh = partition_mesh(devices=[card] * 4)
    plan = plan_spec(T.where(EXPRS[0]))
    pool = [torch.from_numpy(a).to(card).flatten(0, 1)
            for a in _pool_stacks(plan, np.random.default_rng(43), 8, 256)]
    gen = torch.Generator(device=card).manual_seed(9)
    before = kernels.PREDICATE_STACKED.launches
    for _ in range(200):
        perm = torch.randperm(pool[0].shape[0], generator=gen, device=card)[: 4 * 256]
        stacks = [c[perm].reshape(4, 256, *c.shape[1:]) for c in pool]
        got = plan.predicate_stacked(mesh, stacks)
        assert torch.equal(torch.cat(got.blocks), predicate_stacked_plain(plan, stacks))
    assert kernels.PREDICATE_STACKED.launches == before + 200


def _step_plain(step_inputs, prog, dev):
    from redpanda_tpu_torch.parallel import collectives as COL

    return COL.coproc_step_plain(prog, *[_t(a, dev) if isinstance(a, np.ndarray) else a
                                         for a in step_inputs])


def _assert_step_equal(got, want):
    ok, out, out_len, keep, tally = (_host(g) for g in got)
    w_ok, w_out, w_len, w_keep, w_tally = (w.cpu().numpy() for w in want)
    assert (ok == w_ok).all() and (keep == w_keep).all() and (out_len == w_len).all()
    assert (out[w_keep] == w_out[w_keep]).all() and (tally == w_tally).all()


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["full", "n_pad_8"])
def test_coproc_step_kernel_matches_plain(card, shape):
    """The fused step at chip_smoke.py's full width (64 partitions x 4
    batches of 16 KiB rows, 64 x 512 records of 1152 B, [64, 256] votes)
    and at 8 records a shard, one launch a step on one card."""
    from redpanda_tpu_torch.parallel import collectives as COL
    from redpanda_tpu_torch.parallel import partition_mesh

    mesh = partition_mesh(devices=[card] * 4)
    rng = np.random.default_rng(47)
    if shape == "full":
        args = _mesh_inputs(rng, p=64, b=4, r=16384, n=512, r_rec=1152, g=256)
    else:
        args = _mesh_inputs(rng, p=4, b=3, r=100, n=8, r_rec=96, g=3)
    r, r_rec = args[0].shape[2], args[3].shape[2]
    spec = T.filter_field_eq("level", "error") | T.map_project(T.Int("code"), T.Str("msg", 48))
    step = COL.make_sharded_coproc_step(mesh, spec.to_json(), r, r_rec)
    dev_args = [_t(a, card) for a in args]
    before = kernels.COPROC_STEP.launches, kernels.VOTE_TALLY.launches
    got = step(*dev_args)
    assert kernels.COPROC_STEP.launches == before[0] + 1
    assert kernels.VOTE_TALLY.launches == before[1]  # the tally is in the fused launch
    want = _step_plain(dev_args, T.compile_transform(spec, r_rec), card)
    _assert_step_equal(got, want)
    assert not want[0].all() and want[3].any() and not want[3].all()


@pytest.mark.cuda
def test_coproc_step_200_calls_on_fresh_inputs(card):
    """200 steps, each on batch lengths, record rows and votes made on the
    card just before it, each equal to the plain version."""
    from redpanda_tpu_torch.parallel import collectives as COL
    from redpanda_tpu_torch.parallel import partition_mesh

    mesh = partition_mesh(devices=[card] * 4)
    args = [_t(a, card) for a in _mesh_inputs(np.random.default_rng(53), p=8, b=3, r=512)]
    spec = T.filter_field_eq("level", "error") | T.map_project(T.Int("code"), T.Str("msg", 16))
    step = COL.make_sharded_coproc_step(mesh, spec.to_json(), 512, args[3].shape[2])
    prog = T.compile_transform(spec, args[3].shape[2])
    gen = torch.Generator(device=card).manual_seed(11)
    before = kernels.COPROC_STEP.launches
    for _ in range(200):
        fresh = list(args)
        fresh[1] = torch.randint(0, 513, args[1].shape, generator=gen, device=card,
                                 dtype=torch.int32)
        perm = torch.randperm(args[3].shape[0] * args[3].shape[1], generator=gen, device=card)
        fresh[3] = args[3].flatten(0, 1)[perm].reshape(args[3].shape)
        fresh[4] = args[4].flatten()[perm].reshape(args[4].shape)
        fresh[5] = torch.randint(0, 2, args[5].shape, generator=gen, device=card,
                                 dtype=torch.uint8)
        _assert_step_equal(step(*fresh), _step_plain(fresh, prog, card))
    assert kernels.COPROC_STEP.launches == before + 200


# ------------------------------------------------------------------ K8/K9 (split CRC kernel)
def _split_rows(rng, r, n):
    """n rows of width r (random bytes everywhere, garbage past each
    length) at lengths on and around every round and span boundary of the
    split kernel, 0, negative and past r, the rest random; three claims
    wrong."""
    from redpanda_tpu_torch.hashing.crc32c import crc32c_many
    from redpanda_tpu_torch.ops.crc32c_device import ROUND

    rounds = -(-r // ROUND)
    spans = sorted({-(-rounds // w) * ROUND for w in (2, 4, 8)})  # every split's spans
    marks = [0, -3, r + 5, 1, 15, 16, 17, r - 1, r]
    marks += [j * s + e for s in spans for j in range(1, r // s + 1) for e in (-1, 0, 1)]
    marks += [k * ROUND + e for k in range(1, r // ROUND + 1) for e in (-1, 0, 1)]
    marks = [x for x in marks if -3 <= x <= r + 5][:n]
    lens = np.array(marks + [int(x) for x in rng.integers(0, r + 1, n - len(marks))], np.int32)
    rows = rng.integers(0, 256, size=(n, r), dtype=np.uint8)
    claimed = crc32c_many(rows, lens)
    live = np.flatnonzero(lens > 0)
    claimed[live[[1, len(live) // 2, -1]]] ^= 0x20
    return rows, lens, claimed


@pytest.mark.cuda
@pytest.mark.parametrize("r", [100, 2048, 5000, 8192, 16384])
def test_crc_blocks_match_plain_on_edge_rows(card, r):
    """K9 over [16, 4, r] and K8 over [4, 16, r] with [4, 33] votes on a
    virtual mesh of four shards, one launch a call and no tally launch, and
    validate_segments' one-block case: all equal to the plain versions at
    the edge lengths (widths that are not multiples of 16 give unaligned
    rows; 5000, 8192 and 16384 are split across 2, 4 and 8 warps)."""
    from redpanda_tpu_torch.ops import crc32c_device as C
    from redpanda_tpu_torch.parallel import collectives as COL
    from redpanda_tpu_torch.parallel import partition_mesh

    mesh = partition_mesh(devices=[card] * 4)
    rng = np.random.default_rng(r)
    rows, lens, claimed = _split_rows(rng, r, 64)
    d, ln, cl = _t(rows, card), _t(lens, card), _t(claimed, card)
    votes = _t(rng.integers(0, 2, (4, 33)).astype(np.uint8), card)
    p9 = (d.view(16, 4, r), ln.view(16, 4), cl.view(16, 4))
    p8 = (d.view(4, 16, r), ln.view(4, 16), cl.view(4, 16), votes)
    before = [k.launches for k in (kernels.CRC32C_SHARDED, kernels.CRC32C_VOTE, kernels.VOTE_TALLY)]
    ok, bad = COL.make_sharded_crc_check(mesh, r)(*p9)
    got8 = COL.make_crc_vote_step(mesh, r)(*p8)
    after = [k.launches for k in (kernels.CRC32C_SHARDED, kernels.CRC32C_VOTE, kernels.VOTE_TALLY)]
    assert after == [before[0] + 1, before[1] + 1, before[2]]
    w_ok, w_bad = COL.sharded_crc_plain(*p9)
    assert (_host(ok) == w_ok.cpu().numpy()).all() and (_host(bad) == w_bad.cpu().numpy()).all()
    for g, w in zip(got8, COL.crc_vote_plain(*p8)):
        assert (_host(g) == w.cpu().numpy()).all()
    assert int(w_bad.sum()) == 3 and not w_ok.all()
    seg_ok, seg_bad = C.validate_segments(d, ln, cl, 7, kernels.CRC32C_SHARDED)
    w_ok, w_bad = C.validate_segments_plain(d, ln, cl, 7)
    assert torch.equal(seg_ok, w_ok) and torch.equal(seg_bad, w_bad)


@pytest.mark.cuda
def test_crc_blocks_match_plain_at_full_width(card):
    """Config 5's append as K9 [256, 4, 16384] and K8 [4, 256, 16384] with
    [4, 256] votes on a virtual mesh, each equal to the plain version."""
    from redpanda_tpu_torch.parallel import collectives as COL
    from redpanda_tpu_torch.parallel import partition_mesh

    mesh = partition_mesh(devices=[card] * 4)
    rng = np.random.default_rng(41)
    rows, lens, claimed = _split_rows(rng, 16384, 1024)
    d, ln, cl = _t(rows, card), _t(lens, card), _t(claimed, card)
    votes = _t(rng.integers(0, 2, (4, 256)).astype(np.uint8), card)
    p9 = (d.view(256, 4, 16384), ln.view(256, 4), cl.view(256, 4))
    ok, bad = COL.make_sharded_crc_check(mesh, 16384)(*p9)
    w_ok, w_bad = COL.sharded_crc_plain(*p9)
    assert (_host(ok) == w_ok.cpu().numpy()).all() and (_host(bad) == w_bad.cpu().numpy()).all()
    p8 = (d.view(4, 256, 16384), ln.view(4, 256), cl.view(4, 256), votes)
    for g, w in zip(COL.make_crc_vote_step(mesh, 16384)(*p8), COL.crc_vote_plain(*p8)):
        assert (_host(g) == w.cpu().numpy()).all()


@pytest.mark.cuda
def test_crc_blocks_200_calls_on_fresh_inputs(card):
    """200 calls of K8 on a virtual mesh, each on rows, lengths and claims
    permuted and votes drawn on the card just before it, each equal to the
    plain answer permuted the same way (the plain version runs once)."""
    from redpanda_tpu_torch.parallel import collectives as COL
    from redpanda_tpu_torch.parallel import partition_mesh

    mesh = partition_mesh(devices=[card] * 4)
    r, n = 5000, 64
    rows, lens, claimed = _split_rows(np.random.default_rng(43), r, n)
    d, ln, cl = _t(rows, card), _t(lens, card), _t(claimed, card)
    base_ok = COL.sharded_crc_plain(d.view(n, 1, r), ln.view(n, 1), cl.view(n, 1))[0].view(n)
    step = COL.make_crc_vote_step(mesh, r)
    gen = torch.Generator(device=card).manual_seed(17)
    before = kernels.CRC32C_VOTE.launches
    for _ in range(200):
        perm = torch.randperm(n, generator=gen, device=card)
        votes = torch.randint(0, 2, (4, 256), generator=gen, device=card, dtype=torch.uint8)
        lp = ln[perm]
        ok, bad, tally = step(d[perm].view(4, 16, r), lp.view(4, 16), cl[perm].view(4, 16), votes)
        w_ok = base_ok[perm].view(4, 16)
        assert torch.equal(torch.from_numpy(_host(ok)), w_ok.cpu())
        w_bad = (~w_ok & (lp.view(4, 16) > 0)).sum(1, dtype=torch.int32)
        assert torch.equal(torch.from_numpy(_host(bad)), w_bad.cpu())
        assert torch.equal(tally, COL.vote_tally_plain(votes))
    assert kernels.CRC32C_VOTE.launches == before + 200


@pytest.mark.cuda
def test_engine_mesh_lane_and_raft_mesh_leg_on_the_card(card):
    from redpanda_tpu_torch import entry
    from redpanda_tpu_torch.parallel import partition_mesh
    from redpanda_tpu_torch.raft.device_plane import RaftDevicePlane, _host_validate

    mesh = partition_mesh(devices=[card] * 4)
    rng = np.random.default_rng(5)
    items = []
    for p in range(6):
        recs = [Record(offset_delta=i, value=v) for i, v in enumerate(_docs(rng, 40 + p))]
        items.append(ProcessBatchItem(1, NTP.kafka("t", p), [RecordBatch.build(recs)]))
    req = ProcessBatchRequest(items)
    spec = T.where(EXPRS[0]) | T.map_project(T.Int("code"), T.Str("msg", 24))
    replies = []
    for kw in ({"device": card, "mesh": mesh, "mesh_probe": False}, {"device": "cpu"}):
        eng = TorchEngine(row_stride=128, **kw)
        assert eng.enable_coprocessors([(1, spec.to_json(), ("t",))]) == [0]
        replies.append([[b.encode_internal() for it in t.result().items for b in it.batches]
                        for t in eng.submit_group([req, req])])
        stats = eng.stats()
        eng.shutdown()
        if "mesh" in kw:
            assert stats["n_mesh_launches"] == 1 and "n_kernel_predicate" not in stats
            assert sum(stats["mesh"]["rows_per_device"]) == 2 * sum(40 + p for p in range(6))
    assert replies[0] == replies[1] and any(replies[1][0])
    regions = [rng.bytes(int(rng.integers(1, 3000))) for _ in range(103)]
    from redpanda_tpu_torch.hashing.crc32c import crc32c

    claimed = np.array([crc32c(x) for x in regions], np.uint32)
    claimed[[0, 50]] ^= 1
    plane = RaftDevicePlane(mesh=mesh, probe=False, device=card)
    before = kernels.CRC32C_VOTE.launches, kernels.VOTE_TALLY.launches
    assert (plane.validate(regions, claimed) == _host_validate(regions, claimed)).all()
    # one launch for the card's four shards, the (empty) tally in it
    assert kernels.CRC32C_VOTE.launches == before[0] + 1
    assert kernels.VOTE_TALLY.launches == before[1]
    votes = rng.integers(0, 2, (4, 256)).astype(np.uint8)
    assert (plane.tally_votes(votes) == votes.astype(np.int32).sum(0)).all()
    entry.dryrun_multichip(4, devices=[card] * 4)


def test_mesh_entry_points_raise_with_too_few_cards():
    """Without enough cards nothing falls back to the CPU or one device."""
    if torch.cuda.device_count() >= 2:
        pytest.skip("two CUDA devices are present: a two-card mesh builds")
    from redpanda_tpu_torch import entry
    from redpanda_tpu_torch.parallel import partition_mesh
    from redpanda_tpu_torch.raft import device_plane as DP

    def default_plane_on_a_mesh():
        DP.reset_default_plane()
        DP.configure(mesh_devices=2)
        try:
            DP.default_plane()
        finally:
            DP.configure(mesh_devices=0)
            DP.reset_default_plane()

    for make in (lambda: partition_mesh(2), lambda: TorchEngine(mesh_devices=2),
                 lambda: DP.RaftDevicePlane(mesh=partition_mesh(2)),
                 lambda: entry.dryrun_multichip(2), default_plane_on_a_mesh):
        with pytest.raises(RuntimeError, match="CUDA device"):
            make()


# ------------------------------------------------------------------ host ladder lanes
HOST_LADDER_LANES = {
    "staged": dict(structural_parse=False),
    "structural": dict(structural_probe=False),
    "cached": dict(structural_probe=False, device_column_cache_mb=16),
    "padded": dict(structural_parse=False, gather_frame=False),
}


@pytest.mark.cuda
@pytest.mark.parametrize("lane", sorted(HOST_LADDER_LANES))
def test_engine_host_ladder_lanes_match_cpu_engine(card, lane):
    """Each lane of the single-device host ladder on the card gives the CPU
    engine's replies; the cached lane's hits copy nothing up."""
    rng = np.random.default_rng(6)
    items = []
    for p in range(4):
        recs = [Record(offset_delta=i, value=v) for i, v in enumerate(_docs(rng, 40))]
        items.append(ProcessBatchItem(1, NTP.kafka("t", p), [RecordBatch.build(recs)]))
    req = ProcessBatchRequest(items)
    specs = [T.where(EXPRS[0]) | T.map_project(T.Int("code"), T.Str("msg", 24)),
             T.where(EXPRS[1])]
    for spec in specs:
        replies = []
        for dev in (card, "cpu"):
            eng = TorchEngine(device=dev, row_stride=128, **HOST_LADDER_LANES[lane])
            assert eng.enable_coprocessors([(1, spec.to_json(), ("t",))]) == [0]
            replies.append([[b.encode_internal() for it in eng.process_batch(req).items
                             for b in it.batches] for _ in range(3)])
            st = eng.stats()
            eng.shutdown()
            if dev != "cpu":
                assert st["n_kernel_predicate"] == 3
                assert not any(k.startswith("n_failures") for k in st)
                if lane == "cached":
                    # one cold launch copied the columns up; two hits copied nothing
                    assert st["colcache"]["hits"] == 2
                    assert st["bytes_h2d"] == eng._colcache._entries[
                        next(iter(eng._colcache._entries))].cols_dev.nbytes
        assert replies[0] == replies[1]
        assert any(replies[1][0])


@pytest.mark.cuda
def test_pointer_table_payload_lane_matches_cpu_engine(card):
    rng = np.random.default_rng(8)
    items = []
    for p in range(4):
        recs = [Record(offset_delta=i, value=v) for i, v in enumerate(_docs(rng, 50))]
        items.append(ProcessBatchItem(1, NTP.kafka("t", p), [RecordBatch.build(recs)]))
    req = ProcessBatchRequest(items)
    replies = []
    for dev in (card, "cpu"):
        eng = TorchEngine(device=dev, row_stride=128)
        assert eng.enable_coprocessors([(1, SPECS[0].to_json(), ("t",))]) == [0]
        tickets = eng.submit_group([req, req])
        replies.append([[b.encode_internal() for it in t.result().items for b in it.batches]
                        for t in tickets])
        assert eng.stats()["t_explode_ptrs"] > 0
        eng.shutdown()
    assert replies[0] == replies[1]


@pytest.mark.cuda
def test_policy_device_leg_matches_cpu_and_raises_on_a_failing_launch(card, monkeypatch):
    from redpanda_tpu_torch.policy import PolicyEngine

    rng = np.random.default_rng(9)
    batches = [RecordBatch.build([Record(offset_delta=i, value=v)
                                  for i, v in enumerate(_docs(rng, 64))], base_offset=64 * k)
               for k in range(8)]
    spec = SPECS[0].to_json()
    outs = []
    for dev, leg in ((card, "device"), ("cpu", "device"), ("cpu", "host")):
        eng = PolicyEngine(device=dev, force_engine=leg, row_stride=256)
        outs.append([b.encode_internal() for b in eng.transform_batches(spec, batches)])
    assert outs[0] == outs[1] == outs[2]
    before = kernels.PAYLOAD_TRANSFORM.launches
    PolicyEngine(device=card, row_stride=256).transform_batches(spec, batches)  # 512 records
    assert kernels.PAYLOAD_TRANSFORM.launches == before + 1

    def failing(*args):
        raise RuntimeError("payload kernel launch failed")

    monkeypatch.setattr(kernels.PAYLOAD_TRANSFORM, "launch", failing)
    with pytest.raises(RuntimeError, match="launch failed"):
        PolicyEngine(device=card, force_engine="device").transform_batches(spec, batches)


# ------------------------------------------------------------------ budget plane
@pytest.mark.cuda
def test_pressure_eviction_frees_the_cached_cuda_columns(card, monkeypatch):
    """Critical pressure, pushed through another account of the plane,
    evicts column-cache entries; their CUDA tensors are freed by the
    eviction itself (memory_allocated falls by at least their bytes), with
    the shards' legs on fetch workers and masks on the harvest thread."""
    import weakref

    from redpanda_tpu_torch.coproc import engine as engine_mod
    from redpanda_tpu_torch.resource_mgmt import BudgetPlane

    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)
    rng = np.random.default_rng(10)
    plane = BudgetPlane(64 << 20)
    # K1 pinned: the cached entries must hold CUDA columns whatever the
    # columnar backend probe would choose
    eng = TorchEngine(device=card, row_stride=128, device_column_cache_mb=1, host_workers=2,
                      host_pool_probe=False, budget_plane=plane, force_mode="columnar_device")
    try:
        assert eng.enable_coprocessors([(1, T.where(EXPRS[1]).to_json(), ("t",))]) == [0]
        cc = eng.stats()["colcache"]
        for w in range(16):  # distinct windows until the entries pass half the budget
            items = [ProcessBatchItem(1, NTP.kafka("t", p), [RecordBatch.build(
                [Record(offset_delta=i, value=v) for i, v in enumerate(_docs(rng, 1024))],
                base_offset=w)]) for p in range(4)]
            eng.process_batch(ProcessBatchRequest(items))
            cc = eng.stats()["colcache"]
            if cc["bytes"] > cc["budget_bytes"] // 2:
                break
        assert cc["bytes"] > cc["budget_bytes"] // 2
        torch.cuda.synchronize(card)
        held = {k: (e.cols_dev.nbytes, [weakref.ref(e.cols_dev)])
                for k, e in eng._colcache._entries.items()}
        assert held and all(n > 0 for n, _ in held.values())
        before = torch.cuda.memory_allocated(card)
        storage = plane.account("storage")
        got = storage.try_acquire(int(storage.limit * 0.95))
        after = torch.cuda.memory_allocated(card)
        evicted = set(held) - set(eng._colcache._entries)
        assert evicted and eng.stats()["n_pressure_evictions"] == len(evicted)
        assert all(r() is None for k in evicted for r in held[k][1])
        assert before - after >= sum(held[k][0] for k in evicted)
        storage.release(got)
        assert plane.pressure() == "ok" and not eng.stats()["colcache"]["pressure"]
    finally:
        eng.shutdown()


# ------------------------------------------------------------------ columnar backend
def _probe_request(rng, n_items=4, n=400):
    items = []
    for p in range(n_items):
        recs = [Record(offset_delta=i, value=v) for i, v in enumerate(_docs(rng, n))]
        items.append(ProcessBatchItem(1, NTP.kafka("t", p), [RecordBatch.build(recs)]))
    return ProcessBatchRequest(items)  # 1600 records: 2048 padded rows


@pytest.mark.cuda
def test_columnar_probe_on_the_card_publishes_a_verdict(card):
    """A default engine's first launch of 2048 padded rows probes: the host
    predicate against K1's launch and fetch (two K1 launches, not the
    engine's); the verdict is published, journaled once and followed, and
    the replies are the CPU engine's."""
    from redpanda_tpu_torch.coproc import governor

    governor.reset_journal()
    req = _probe_request(np.random.default_rng(12))
    spec = T.where(EXPRS[0]) | T.map_project(T.Int("code"), T.Str("msg", 24))
    replies, stats = [], []
    for dev in (card, "cpu"):
        eng = TorchEngine(device=dev, row_stride=128, host_workers=0)
        assert eng.enable_coprocessors([(1, spec.to_json(), ("t",))]) == [0]
        before = kernels.PREDICATE.launches
        replies.append([[b.encode_internal() for it in eng.process_batch(req).items
                         for b in it.batches] for _ in range(2)])
        stats.append((eng.stats(), kernels.PREDICATE.launches - before))
        eng.shutdown()
    assert replies[0] == replies[1] and any(replies[1][0])
    (st, k1), (cpu_st, _) = stats
    backend, probe = st["columnar_backend"], st["columnar_probe"]
    assert backend in ("host", "device") and probe["chosen"] == backend
    assert probe["t_host_s"] > 0 and probe["t_device_s"] > 0 and probe["margin"] == 4.0
    own = st.get("n_kernel_predicate", 0)
    assert own == (2 if backend == "device" else 0) and k1 == own + 2
    assert st.get("n_host_predicate", 0) == (2 if backend == "host" else 0)
    assert "columnar_backend" not in cpu_st  # a CPU engine neither probes nor reads it
    entries = [e for e in governor.journal.entries() if e["domain"] == "columnar_backend"]
    assert len(entries) == 1 and entries[0]["inputs"] == probe
    assert not any(k.startswith("n_failures") for k in st)
    governor.reset_journal()


@pytest.mark.cuda
def test_columnar_pins_on_the_card(card):
    """Under a host verdict, "columnar_device" still launches K1 every launch
    and "columnar_host" launches nothing and copies nothing up; both give
    the CPU engine's replies."""
    req = _probe_request(np.random.default_rng(13))
    spec = T.where(EXPRS[1])
    with TorchEngine._columnar_probe_lock:
        TorchEngine._columnar_backend = "host"
        TorchEngine._columnar_probe = {"chosen": "host"}
    replies = {}
    for mode in ("columnar_device", "columnar_host", "cpu"):
        dev = "cpu" if mode == "cpu" else card
        eng = TorchEngine(device=dev, row_stride=128, host_workers=0,
                          force_mode=None if mode == "cpu" else mode)
        assert eng.enable_coprocessors([(1, spec.to_json(), ("t",))]) == [0]
        before = kernels.PREDICATE.launches
        replies[mode] = [[b.encode_internal() for it in eng.process_batch(req).items
                          for b in it.batches] for _ in range(3)]
        st = eng.stats()
        eng.shutdown()
        if mode == "columnar_device":
            assert kernels.PREDICATE.launches == before + 3 and st["n_kernel_predicate"] == 3
        elif mode == "columnar_host":
            assert kernels.PREDICATE.launches == before and st["n_host_predicate"] == 3
            assert "bytes_h2d" not in st and "n_kernel_predicate" not in st
    assert replies["columnar_device"] == replies["cpu"] == replies["columnar_host"]


@pytest.mark.cuda
def test_a_host_verdict_frees_cached_device_columns_on_the_card(card):
    """A window under the probe's size launches K1 before any verdict and
    caches its CUDA columns; after a "host" verdict its hit runs the host
    predicate, makes no K1 launch, and the columns leave the cache and its
    charge."""
    req = _probe_request(np.random.default_rng(14), n_items=1, n=100)  # 128 padded rows
    spec = T.where(EXPRS[1])
    eng = TorchEngine(device=card, row_stride=128, host_workers=0, device_column_cache_mb=16)
    try:
        assert eng.enable_coprocessors([(1, spec.to_json(), ("t",))]) == [0]
        cold = [b.encode_internal() for it in eng.process_batch(req).items for b in it.batches]
        [entry] = eng._colcache._entries.values()
        assert entry.cols_dev is not None and TorchEngine.sticky_columnar_backend() is None
        charged, held = entry.nbytes, entry.cols_dev.nbytes
        with TorchEngine._columnar_probe_lock:
            TorchEngine._columnar_backend = "host"
            TorchEngine._columnar_probe = {"chosen": "host"}
        before = kernels.PREDICATE.launches
        hit = [b.encode_internal() for it in eng.process_batch(req).items for b in it.batches]
        st = eng.stats()
        assert hit == cold and kernels.PREDICATE.launches == before
        assert st["n_colcache_hit"] == 1 and st["n_host_predicate"] == 1
        assert entry.cols_dev is None and entry.nbytes == charged - held
        assert st["colcache"]["bytes"] == entry.nbytes
    finally:
        eng.shutdown()


@pytest.mark.cuda
def test_kafka_produce_checks_every_partition_on_the_card(card, tmp_path):
    """A KafkaServer on the card with the produce path pinned to
    CrcBackend("device"): one K6 launch a partition of a PRODUCE request,
    the flipped batch answered corrupt_message with nothing appended, and
    the produced records fetched back whole."""
    import asyncio

    from redpanda_tpu_torch.kafka.client import KafkaClient
    from redpanda_tpu_torch.kafka.protocol import messages as m
    from redpanda_tpu_torch.kafka.protocol.batch import encode_wire_batches
    from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode
    from redpanda_tpu_torch.kafka.server import KafkaServer
    from redpanda_tpu_torch.kafka.server.broker import Broker, BrokerConfig
    from redpanda_tpu_torch.ops import crc_backend
    from redpanda_tpu_torch.storage import StorageApi

    rng = np.random.default_rng(23)
    batches = [RecordBatch.build([Record(offset_delta=k, value=rng.bytes(1024)) for k in range(16)])
               for _ in range(3)]
    bad = bytearray(encode_wire_batches([batches[0]]))
    bad[61 + 40] ^= 1

    async def main():
        storage = await StorageApi(str(tmp_path)).start()
        broker = Broker(BrokerConfig(data_dir=str(tmp_path)), storage, device=card)
        server = await KafkaServer(broker, "127.0.0.1", 0).start()
        broker.config.advertised_port = server.port
        client = await KafkaClient([("127.0.0.1", server.port)]).connect()
        crc_backend.install_default_backend(crc_backend.CrcBackend("device", device=card))
        try:
            await client.create_topic("k6", partitions=3)
            conn = await client.leader_connection("k6", 0)

            def body(parts):
                return {"transactional_id": None, "acks": -1, "timeout_ms": 5000,
                        "topics": [{"name": "k6", "partitions": [
                            {"partition_index": p, "records": r} for p, r in parts]}]}

            before = kernels.CRC32C_VALIDATE.launches
            resp = await conn.request(m.PRODUCE, body(
                [(p, encode_wire_batches([b])) for p, b in enumerate(batches)]))
            assert [p["error_code"] for p in resp["responses"][0]["partitions"]] == [0, 0, 0]
            resp = await conn.request(m.PRODUCE, body([(0, bytes(bad))]))
            assert resp["responses"][0]["partitions"][0]["error_code"] == int(ErrorCode.corrupt_message)
            assert kernels.CRC32C_VALIDATE.launches == before + 4
            for p, b in enumerate(batches):
                got, hwm = await client.fetch("k6", p, 0)
                assert hwm == 16 and [x.payload for x in got] == [b.payload]
        finally:
            crc_backend.install_default_backend(None)
            await client.close()
            await server.stop()
            await storage.stop()

    asyncio.run(main())
