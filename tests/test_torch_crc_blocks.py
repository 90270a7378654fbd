"""The sharded CRC check (K9) and the CRC + vote step (K8) of the port's mesh
against the JAX package, and the split CRC kernel's host side.

K8 and K9 run as one launch per card of csrc/crc_blocks.cu over a table of
the card's shard blocks; on a CPU mesh every shard runs the plain versions.
These tests hold the CPU meshes' results to the JAX programs on the same
seeded numpy inputs, exactly; drive the wrappers' launch code (tables,
chunks, output views, the summed tally) through a host stand-in of the
entry point that computes with the plain versions; check the chunk cut at
the table's cap; and check the arithmetic the kernel joins a row's spans
with: each span's register moved to the row's end with the host-built
powers and XORed equals the CRC of the whole row. The kernel itself is held
to the plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

from __future__ import annotations

import ctypes

import numpy as np
import pytest
import torch

from redpanda_tpu import parallel as RPAR
from redpanda_tpu.ops import pipeline as RP
from redpanda_tpu.ops.crc32c_device import make_crc_fn as jax_make_crc_fn
from redpanda_tpu_torch import kernels
from redpanda_tpu_torch.hashing.crc32c import crc32c, crc32c_many, crc32c_update
from redpanda_tpu_torch.ops import crc32c_device as C
from redpanda_tpu_torch.parallel import collectives as COL
from redpanda_tpu_torch.parallel import mesh as M

R = 2100  # not a multiple of 16, five of a warp's 512-byte rounds
P, B, G = 8, 3, 11


@pytest.fixture(scope="module")
def ref_meshes(eight_devices):
    return {d: RPAR.partition_mesh(devices=eight_devices[:d]) for d in (1, 2, 4)}


def _inputs(seed: int, p: int = P, b: int = B, r: int = R):
    """[p, b, r] rows, random bytes everywhere (garbage past each length),
    at lengths 0, negative, past r, on and around round boundaries and
    random; claims right but for two rows of partition 5 (one claim
    wrong, one byte flipped inside the length) and a zero-length row with
    a wrong claim; [p, G] votes."""
    rng = np.random.default_rng(seed)
    n = p * b
    edge = [0, -3, r + 7, 1, 15, 511, 512, 513, 1024, 1536, 2047, r - 1, r]
    lens = np.array((edge + [int(x) for x in rng.integers(0, r + 1, n)])[:n], np.int32)
    rng.shuffle(lens[6:])
    lens[5 * b : 5 * b + 2] = [r, min(1500, r)]  # partition 5's first two rows
    rows = rng.integers(0, 256, size=(n, r), dtype=np.uint8)
    claimed = crc32c_many(rows, lens)
    claimed[5 * b] ^= 0x4000
    rows[5 * b + 1, min(700, r - 1)] ^= 1
    claimed[0] ^= 1  # lens[0] == 0: neither ok nor bad
    votes = rng.integers(0, 2, (p, G)).astype(np.uint8)
    return rows.reshape(p, b, r), lens.reshape(p, b), claimed.reshape(p, b), votes


def _numpy(x) -> np.ndarray:
    return np.asarray(x) if isinstance(x, M.Sharded) else x.numpy()


# ------------------------------------------------------------------ against JAX
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_sharded_crc_check_matches_reference(shards, ref_meshes):
    rows, lens, claimed, _ = _inputs(shards)
    ref = ref_meshes[shards]
    want = [np.asarray(x) for x in RPAR.make_sharded_crc_check(ref, R)(
        *RPAR.shard_to_mesh(ref, rows, lens, claimed))]
    mesh = M.partition_mesh(shards, device="cpu")
    got = COL.make_sharded_crc_check(mesh, R)(rows, lens, claimed)
    assert all(len(g.blocks) == shards for g in got)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_numpy(g), w)
    assert want[1][5] == 2 and want[1].sum() == 2 and not want[0][0, 0]


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_crc_vote_step_matches_reference(shards, ref_meshes):
    rows, lens, claimed, votes = _inputs(10 + shards)
    ref = ref_meshes[shards]
    want = [np.asarray(x) for x in RPAR.make_crc_vote_step(ref, R)(
        *RPAR.shard_to_mesh(ref, rows, lens, claimed, votes))]
    mesh = M.partition_mesh(shards, device="cpu")
    got = COL.make_crc_vote_step(mesh, R)(rows, lens, claimed, votes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_numpy(g), w)
    assert want[1][5] == 2 and want[2].sum() == votes.sum()
    t = [torch.from_numpy(x) for x in (rows, lens, claimed.view(np.int32), votes)]
    for g, w in zip(COL.crc_vote_plain(*t), want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_crc_checks_reject_blocks_of_another_kind():
    rows, lens, claimed, votes = _inputs(3)
    mesh = M.partition_mesh(2, device="cpu")
    check, step = COL.make_sharded_crc_check(mesh, R), COL.make_crc_vote_step(mesh, R)
    for bad in ((rows[:, :, :64], lens, claimed),  # rows of another width
                (rows, lens[:, :1], claimed),  # lengths of another shape
                (rows, lens.astype(np.int64), claimed)):  # lengths not int32
        with pytest.raises(ValueError):
            check(*bad)
    with pytest.raises(ValueError):
        step(rows, lens, claimed, votes[:, :, None])  # votes not [rows, G]
    with pytest.raises(ValueError):
        step(rows, lens, claimed, votes.astype(np.int32))  # votes not u8


# ------------------------------------------------------------------ the launch code
def _host_entry(calls):
    """A host stand-in of rp_crc_blocks over host pointers: the plain
    versions per block, with the entry point's optional outputs (the CRCs,
    ok with the claims, bad with ok), bad zeroing, segment index and column
    sums; records each call's (n_blocks, rows, seg, n_bad)."""

    def view(ptr, dtype, count):
        ctype = {np.uint8: ctypes.c_uint8, np.int32: ctypes.c_int32}[dtype]
        return np.ctypeslib.as_array((ctype * max(count, 1)).from_address(ptr))[:count]

    def entry(table, n_blocks, rows, r, seg, wpr, span, crc_tables, rounds, n_rounds,
              span_table, crc_out, ok, bad, n_bad, vote_rows, g, tally, stream):
        # sm_count of a CPU device is 1
        assert (wpr, span) == C.split_layout(r, n_blocks * rows, 1)
        assert n_rounds == len(C.round_powers())
        if wpr > 1:
            assert np.array_equal(view(span_table, np.int32, 1024).view(np.uint32),
                                  C.span_table(span))
        else:  # one warp a row joins no spans
            assert span_table is None
        assert crc_out or ok, "no output"
        assert bool(bad) <= bool(ok), "bad without ok"
        calls.append((n_blocks, rows, seg, n_bad))
        if bad:
            bad_out = view(bad, np.int32, n_bad)
            bad_out[:] = 0
        sums = np.zeros(g, np.int64)
        for k in range(n_blocks):
            rp, lp, cp, vp = table[4 * k : 4 * k + 4]
            assert bool(cp) == bool(ok), "claims and ok come as a pair"
            if rows:
                data = torch.from_numpy(view(rp, np.uint8, rows * r).reshape(rows, r).copy())
                ln = torch.from_numpy(view(lp, np.int32, rows).copy())
                if crc_out:
                    view(crc_out, np.int32, n_blocks * rows)[k * rows : (k + 1) * rows] = (
                        C.crc_plain(data, ln).numpy())
                if ok:
                    cl = torch.from_numpy(view(cp, np.int32, rows).copy())
                    got = C.validate_plain(data, ln, cl).numpy()
                    view(ok, np.uint8, n_blocks * rows)[k * rows : (k + 1) * rows] = got
                    for i in np.flatnonzero(~got & (ln.numpy() > 0)) if bad else ():
                        bad_out[(k * rows + i) // seg] += 1
            if g:
                votes = view(vp, np.uint8, vote_rows * g).reshape(vote_rows, g)
                sums += votes.sum(0, dtype=np.int64)
        if g:
            view(tally, np.int32, g)[:] = sums
        return 0

    return entry


def _host_rows_entry(calls):
    """A host stand-in of rp_crc_rows, the one-block entry: the block's
    pointers as a table for the stand-in of rp_crc_blocks."""
    blocks_entry = _host_entry(calls)

    def entry(rows_p, lens, claimed, rows, r, wpr, span, crc_tables, rounds, n_rounds,
              span_table, crc_out, ok, stream):
        return blocks_entry([rows_p, lens, claimed, None], 1, rows, r, 1, wpr, span, crc_tables,
                            rounds, n_rounds, span_table, crc_out, ok, None, 0, 0, 0, None, stream)

    return entry


@pytest.mark.parametrize("shards,vote", [(4, False), (4, True), (121, False), (241, True)])
def test_launch_code_on_host_pointers_matches_plain(shards, vote, monkeypatch):
    """The CUDA branch of K8/K9 (``_crc_on_cards``) run on CPU blocks with
    the entry point replaced by a host stand-in: one call per chunk of 120
    shards, each writing its run of the card's ok and bad tensors, and the
    chunks' tallies summed, all equal to the plain version."""
    calls = []
    kern = kernels.CRC32C_VOTE if vote else kernels.CRC32C_SHARDED
    monkeypatch.setattr(kern, "_fn", _host_entry(calls))
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    p, b, r = 2, 3, 96
    rows, lens, claimed, _ = _inputs(shards, p=shards * p, b=b, r=r)
    votes = np.random.default_rng(shards).integers(0, 2, (shards, 5)).astype(np.uint8)
    mesh = M.partition_mesh(shards, device="cpu")
    arrays = (rows, lens, claimed, votes) if vote else (rows, lens, claimed)
    args = [M.local_blocks(mesh, a) for a in arrays]
    before = kern.launches
    oks, bads, tally = COL._crc_on_cards(mesh, args, r, kern)
    chunks = -(-shards // C.MAX_CRC_SHARDS)
    assert kern.launches - before == chunks == len(calls)
    assert [c[0] for c in calls] == [min(C.MAX_CRC_SHARDS, shards - C.MAX_CRC_SHARDS * i)
                                     for i in range(chunks)]
    assert all(c[1:] == (p * b, b, c[0] * p) for c in calls)
    t = [torch.from_numpy(x) for x in (rows, lens, claimed.view(np.int32))]
    w_ok, w_bad = COL.sharded_crc_plain(*t)
    assert torch.equal(torch.cat(oks), w_ok) and torch.equal(torch.cat(bads), w_bad)
    assert int(w_bad.sum()) >= 2
    if vote:
        assert torch.equal(tally, COL.vote_tally_plain(torch.from_numpy(votes)))
    else:
        assert tally is None


def test_segments_and_empty_batches_on_host_pointers(monkeypatch):
    """validate_segments' one-block case with segments that do not divide
    the rows, and a mesh whose partitions hold no batch: bad is zeroed
    without a launch."""
    calls = []
    monkeypatch.setattr(kernels.CRC32C_SHARDED, "_fn", _host_entry(calls))
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    rows, lens, claimed, _ = _inputs(7, p=8, b=3, r=R)
    data = torch.from_numpy(rows.reshape(-1, R))
    ln = torch.from_numpy(lens.reshape(-1))
    cl = torch.from_numpy(claimed.reshape(-1).view(np.int32))
    ok = torch.empty(24, dtype=torch.bool)
    bad = torch.full((5,), 9, dtype=torch.int32)
    C.crc_blocks(kernels.CRC32C_SHARDED, [(data, ln, cl, None)], R, 5, ok, bad)
    w_ok, w_bad = C.validate_segments_plain(data, ln, cl, 5)
    assert torch.equal(ok, w_ok) and torch.equal(bad, w_bad) and calls == [(1, 24, 5, 5)]
    mesh = M.partition_mesh(2, device="cpu")
    empty = [M.local_blocks(mesh, a[:, :0]) for a in (rows, lens, claimed)]
    oks, bads, _ = COL._crc_on_cards(mesh, empty, R, kernels.CRC32C_SHARDED)
    assert len(calls) == 1 and all(b.tolist() == [0] * 4 for b in bads)
    assert [tuple(o.shape) for o in oks] == [(4, 0)] * 2


@pytest.mark.parametrize("r,rows", [(100, 17), (1300, 17), (4097, 1), (4097, 17)])
def test_batch_crc_and_validator_launch_code_match_plain_and_reference(r, rows, monkeypatch):
    """K5 and K6 on the card are the split kernel's one-block case: their
    launch code (``_crc_rows_launch``, ``_validate_rows_launch``) run on CPU
    rows at a base that is not 16-byte aligned, with the one-block entry
    point replaced by the host stand-in, gives the plain versions' and the JAX
    programs' answers at the edge lengths (0, negative, past r, on round
    boundaries); one launch each, counted on its own row, the CRCs through
    crc_out alone and ok through the claims alone (4097 B over one row is
    split in two spans)."""
    calls = []
    for k in (kernels.CRC32C, kernels.CRC32C_VALIDATE):
        monkeypatch.setattr(k, "_fn", _host_rows_entry(calls))
    monkeypatch.setattr(kernels, "stream_handle", lambda dev: None)
    rng = np.random.default_rng(r + rows)
    edge = [0, -3, r + 5, r, r - 1, 1, 511, 512, 513]
    lens = np.array((edge + [int(x) for x in rng.integers(0, r + 1, rows)])[:rows], np.int32)
    data = rng.integers(0, 256, size=(rows, r), dtype=np.uint8)
    buf = torch.zeros(rows * r + 3, dtype=torch.uint8)
    d = buf[3:].view(rows, r)
    d.copy_(torch.from_numpy(data))
    ln = torch.from_numpy(lens)
    before = kernels.CRC32C.launches, kernels.CRC32C_VALIDATE.launches
    crc = C._crc_rows_launch(d, ln)
    assert torch.equal(crc, C.crc_plain(d, ln))
    np.testing.assert_array_equal(crc.numpy().view(np.uint32), np.asarray(jax_make_crc_fn(r)(data, lens)))
    claimed = crc.clone()
    claimed[::3] ^= 0x40
    ok = C._validate_rows_launch(d, ln, claimed)
    assert torch.equal(ok, C.validate_plain(d, ln, claimed))
    ref = RP.make_batch_validator(r)(data, lens, claimed.numpy().view(np.uint32))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(ref))
    assert (kernels.CRC32C.launches, kernels.CRC32C_VALIDATE.launches) == (before[0] + 1,
                                                                           before[1] + 1)
    assert calls == [(1, rows, 1, 0)] * 2


def test_rows_wider_than_the_powers_keep_one_warp():
    """The layout arguments of a launch: split_layout's below MAX_ROW, with
    the span table only for a split row; one warp a row, without powers or
    span table, above it (where split_layout refuses)."""
    cpu = torch.device("cpu")
    wpr, span, _, _, n_rounds, table = C._layout_args(cpu, C.MAX_ROW + 1, 1)
    assert (wpr, span, table) == (1, C.MAX_ROW + C.ROUND, None)
    assert n_rounds == len(C.round_powers())
    for r, rows in ((16384, 1), (16384, 64), (2048, 1)):
        args = C._layout_args(cpu, r, rows)
        assert args[:2] == C.split_layout(r, rows, 1)
        assert (args[5] is None) == (args[0] == 1)


# ------------------------------------------------------------------ the cap
@pytest.mark.parametrize("n_shards", [121, 130])
def test_crc_checks_over_more_than_120_shards_on_the_cpu(n_shards):
    """A CPU mesh wider than one launch's table: every shard's ok and bad,
    and the tally summed as the aggregator sums it, equal to the plain
    version."""
    rows, lens, claimed, _ = _inputs(n_shards, p=n_shards, b=2, r=64)
    votes = np.random.default_rng(n_shards).integers(0, 2, (2 * n_shards, 3)).astype(np.uint8)
    mesh = M.partition_mesh(n_shards, device="cpu")
    t = [torch.from_numpy(x) for x in (rows, lens, claimed.view(np.int32), votes)]
    want = COL.crc_vote_plain(*t)
    got = COL.make_crc_vote_step(mesh, 64)(rows, lens, claimed, votes)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_numpy(g), w.numpy())
    ok, bad = COL.make_sharded_crc_check(mesh, 64)(rows, lens, claimed)
    np.testing.assert_array_equal(np.asarray(ok), want[0].numpy())
    np.testing.assert_array_equal(np.asarray(bad), want[1].numpy())


def _cuda(*idx):
    return [torch.device("cuda", i) for i in idx]


@pytest.mark.parametrize("devices,want", [
    (_cuda(0) * 4, [(0, (0, 1, 2, 3))]),
    (_cuda(0) * 120, [(0, tuple(range(120)))]),
    (_cuda(0) * 241, [(0, tuple(range(120))), (0, tuple(range(120, 240))), (0, (240,))]),
    (_cuda(1, 0) * 121, [(1, tuple(range(0, 240, 2))), (1, (240,)),
                         (0, tuple(range(1, 241, 2))), (0, (241,))]),
])
def test_crc_chunks_cut_at_the_pointer_cap(devices, want):
    """K8/K9's launches: a card's shards in runs of 120 (four pointers a
    shard in a table of 480); chunk 0 is devices[0]'s."""
    chunks = M.card_chunks(devices, C.MAX_CRC_SHARDS)
    assert [(dev.index, shards) for dev, shards in chunks] == want
    assert all(len(s) * 4 <= 480 for _, s in chunks)


# ------------------------------------------------------------------ the span arithmetic
def _multmodp(a: int, b: int) -> int:
    p = 0
    for k in range(32):
        if a & (0x80000000 >> k):
            p ^= b
        b = (b >> 1) ^ C.POLY if b & 1 else b >> 1
    return p


def _sliced(table, c: int) -> int:
    return int(table[c & 0xFF] ^ table[256 + ((c >> 8) & 0xFF)] ^ table[512 + ((c >> 16) & 0xFF)]
               ^ table[768 + (c >> 24)])


@pytest.mark.parametrize("wpr", [1, 2, 4, 8])
@pytest.mark.parametrize("r", [100, 2048, 2049, 5000, 16384, 20000])
def test_split_spans_join_to_the_row_crc(r, wpr):
    """The kernel's join of a row's spans, in Python: span j of the row's
    first len bytes is [j * span, min((j + 1) * span, len)) and its
    register at its end starts at 0xFFFFFFFF for j == 0 and 0 after; every
    span before the last is moved over the last span's L bytes by x^(8 (L
    mod 512)) from kernel_tables and x^(8 * 512 * (L // 512)) from
    round_powers, then Horner's rule moves the joined register over every
    full span with span_table's four lookups, XORing in each span's; with
    the last span's register XORed in and inverted, it is the row's
    CRC-32C, at lengths on and around every span and round boundary."""
    span = -(-(-(-r // C.ROUND)) // wpr) * C.ROUND  # the kernel takes any such split
    assert span % C.ROUND == 0 and wpr * span >= r
    pows, rounds, table = C.kernel_tables()[3072:], C.round_powers(), C.span_table(span)
    rng = np.random.default_rng(r)
    row = rng.bytes(r)
    marks = {0, 1, r - 1, r}
    marks |= {k * C.ROUND + e for k in range(r // C.ROUND + 1) for e in (-1, 0, 1)}
    marks |= {j * span + e for j in range(wpr + 1) for e in (-1, 0, 1)}
    for ln in sorted(x for x in marks if 0 <= x <= r):
        regs = [crc32c_update(0xFFFFFFFF if j == 0 else 0, row[j * span : min((j + 1) * span, ln)])
                for j in range(wpr) if j == 0 or j * span < ln]
        m = len(regs)
        last = ln - (m - 1) * span
        for j in range(m - 1):  # past the last span's bytes
            if last % C.ROUND:
                regs[j] = _multmodp(int(pows[last % C.ROUND]), regs[j])
            if last // C.ROUND:
                regs[j] = _multmodp(int(rounds[last // C.ROUND]), regs[j])
        joined = regs[0]
        for j in range(1, m - 1):
            joined = _sliced(table, joined) ^ regs[j]
        if m > 1:
            joined ^= regs[-1]
        assert joined ^ 0xFFFFFFFF == crc32c(row[:ln]), (r, ln)


def test_span_tables_advance_over_their_span():
    """span_table(span) is the byte-sliced advance over span zero bytes,
    as kernel_tables' skip map is over 496."""
    x = np.random.default_rng(2).integers(0, 2**32, 16, dtype=np.uint64).astype(np.uint32)
    for span in (512, 1536, 2048, 16384):
        table = C.span_table(span)
        assert [_sliced(table, c) for c in x.tolist()] == C._advance(x, span).tolist()
    skip = C.kernel_tables()[2048:3072]
    assert [_sliced(skip, c) for c in x.tolist()] == C._advance(x, 496).tolist()


def test_round_powers_reach_the_widest_row():
    """round_powers[q] is x^(8 * 512 * q) mod P up to MAX_ROW bytes, the
    split layout takes every width up to MAX_ROW and refuses wider rows."""
    rounds = C.round_powers()
    assert len(rounds) == C.MAX_ROW // C.ROUND + 1 and rounds[0] == 0x80000000
    x = np.array([0x80000000], np.uint32)
    for q in (1, 2, 3, 64):
        assert C._advance(x, C.ROUND * q)[0] == rounds[q]
    last = len(rounds) - 1  # x^(8 * MAX_ROW): the 2^24 zero bytes' power, by halving
    assert _multmodp(int(rounds[last // 2]), int(rounds[last // 2])) == int(rounds[last])
    assert C.split_layout(C.MAX_ROW, 1, 132) == (8, C.MAX_ROW // 8)
    with pytest.raises(ValueError):
        C.split_layout(C.MAX_ROW + 1, 1, 132)


@pytest.mark.parametrize("r,rows,want", [
    (100, 64, (1, 512)), (2048, 64, (1, 2048)), (5000, 64, (2, 2560)), (8192, 64, (4, 2048)),
    (16384, 64, (8, 2048)), (16384, 256, (8, 2048)), (16384, 512, (4, 4096)),
    (16384, 1024, (2, 8192)), (16384, 4096, (1, 16384)), (0, 10, (1, 512)),
])
def test_split_layout_fills_the_card_and_no_more(r, rows, want):
    """Rows are split while the launch has fewer than 16 warps an SM (132
    SMs here), into spans of four rounds or more, eight at most."""
    assert C.split_layout(r, rows, 132) == want
