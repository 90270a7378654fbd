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
