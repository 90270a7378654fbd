"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA CUDA device and skip elsewhere (the kernels have
no CPU mode). They import only the port, so they run on a machine without
JAX:

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

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda", 0)


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


@pytest.mark.parametrize("idx", range(len(EXPRS)))
def test_predicate_kernel_matches_plain(card, idx):
    rng = np.random.default_rng(idx)
    vals = _docs(rng, 1003)
    joined = b"".join(vals)
    offsets = np.cumsum([0] + [len(v) for v in vals[:-1]]).astype(np.int64)
    sizes = np.array([len(v) for v in vals], np.int32)
    plan = plan_spec(T.where(EXPRS[idx]))
    cols = [torch.from_numpy(c).to(card) for c in plan.extract_device_inputs(
        joined, offsets, sizes, 1008)]  # a multiple of 8, not of 32
    before = kernels.PREDICATE.launches
    got = plan.predicate(cols)
    assert kernels.PREDICATE.launches == before + 1
    assert torch.equal(got, predicate_plain(plan, cols))
    with pytest.raises(ValueError):
        plan.predicate([c.cpu() if i == 0 else c for i, c in enumerate(cols)])


SPECS = [
    T.filter_field_eq("level", "error") | T.map_project(T.Int("code"), T.Str("msg", 16)),
    T.filter_field_eq("code", 42),
    T.filter_contains(b"rr") | T.map_uppercase(),
    T.map_project(T.Str("msg", 4), T.Int("code")),
]


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


# ------------------------------------------------------------------ LZ4 (K11)
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
