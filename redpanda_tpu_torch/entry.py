"""Entry points of the port for a quick run (the JAX package's ``__graft_entry__``).

- ``entry(device)``: the flagship single-device program, the fused coproc
  record pipeline (JSON filter + projection) that the engine launches per
  tick, with example arguments on ``device``.
- ``dryrun_multichip(n_devices, devices, device)``: one tick through both
  multi-device surfaces of a partition mesh: the engine on the mesh
  (``TorchEngine(mesh=...)``, the columnar stacked predicate via
  ``submit_group``) and the raw sharded per-tick step (batch CRC
  validation + payload transform + vote tally), with its own asserts.

Both run on the card unless the caller passes ``device="cpu"``. A mesh of
``n_devices`` cards raises when there are fewer; ``devices=[cuda:0] * n``
runs a virtual mesh on one card (parallel/mesh.py says what that measures).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from redpanda_tpu_torch.device import resolve_device


def _spec():
    from redpanda_tpu_torch.ops.transforms import Int, Str, filter_field_eq, map_project

    return filter_field_eq("level", "error") | map_project(Int("code"), Str("msg", 32))


def _example_records(n: int, r: int):
    recs = [
        ('{"level":"%s","code":%d,"msg":"m%d"}' % (["error", "info"][i % 2], i, i)).encode()
        for i in range(n)
    ]
    data = np.zeros((n, r), dtype=np.uint8)
    lens = np.zeros(n, dtype=np.int32)
    for i, rec in enumerate(recs):
        data[i, : len(rec)] = np.frombuffer(rec, dtype=np.uint8)
        lens[i] = len(rec)
    return data, lens


def entry(device="cuda"):
    """Returns (fn, example_args): the flagship pipeline's step on one
    device, fn(data u8 [8, 256], lens i32 [8]) -> (out, masked out_len,
    keep), with the arguments on ``device``."""
    from redpanda_tpu_torch.ops.pipeline import make_record_pipeline

    dev = resolve_device(device)
    fn, _r_out = make_record_pipeline(_spec(), 256)
    data, lens = _example_records(8, 256)
    return fn, (torch.from_numpy(data).to(dev), torch.from_numpy(lens).to(dev))


def dryrun_multichip(n_devices: int, devices=None, device="cuda") -> None:
    """Execute one tick on tiny shapes over an ``n_devices``-shard mesh
    through both surfaces; raises AssertionError when a result is wrong."""
    from redpanda_tpu_torch.coproc.engine import ProcessBatchItem, ProcessBatchRequest, TorchEngine
    from redpanda_tpu_torch.models import NTP, Record, RecordBatch
    from redpanda_tpu_torch.ops.exprs import field
    from redpanda_tpu_torch.ops.packing import pack_batches_prefixed
    from redpanda_tpu_torch.ops.transforms import Int, Str, map_project, where
    from redpanda_tpu_torch.parallel import make_sharded_coproc_step, partition_mesh

    mesh = partition_mesh(n_devices, devices=devices, device=device)
    if mesh.size != n_devices:
        raise ValueError(f"need {n_devices} devices, have {mesh.size}")

    # --- surface 1: the engine on the mesh (the mesh lane pinned)
    eng_spec = where((field("level") == "error") & (field("code") >= 0)) | map_project(
        Int("code"), Str("msg", 16)
    )
    engine = TorchEngine(device=mesh.devices[0], mesh=mesh, mesh_probe=False)
    try:
        codes = engine.enable_coprocessors([(1, eng_spec.to_json(), ("dry",))])
        assert codes == [0], codes
        docs = [
            {"level": ["error", "info"][i % 2], "code": i, "msg": f"m{i}"}
            for i in range(n_devices * 4)
        ]
        eng_batch = RecordBatch.build(
            [Record(offset_delta=i, value=json.dumps(d, separators=(",", ":")).encode())
             for i, d in enumerate(docs)],
            base_offset=0,
        )
        reqs = [
            ProcessBatchRequest([ProcessBatchItem(1, NTP.kafka("dry", pp), [eng_batch])])
            for pp in range(n_devices)
        ]
        replies = [t.result() for t in engine.submit_group(reqs)]
        mesh_launches = engine.stats().get("n_mesh_launches", 0)
    finally:
        engine.shutdown()
    eng_kept = sum(b.header.record_count for rep in replies for it in rep.items for b in it.batches)
    want_kept = n_devices * sum(1 for d in docs if d["level"] == "error")
    assert eng_kept == want_kept, (eng_kept, want_kept)
    assert mesh_launches == 1, mesh_launches

    # --- surface 2: the raw sharded per-tick step
    p, b, g = n_devices, 2, 16
    r_batch, r_rec = 256, 128
    batches = [
        RecordBatch.build([Record(offset_delta=j, value=b"v%d" % j) for j in range(2)],
                          base_offset=i)
        for i in range(p * b)
    ]
    rows, lens, crcs = pack_batches_prefixed(batches, r_batch)
    rows, lens, crcs = rows.reshape(p, b, r_batch), lens.reshape(p, b), crcs.reshape(p, b)
    n_rec = 4
    rec_data, rec_lens = _example_records(p * n_rec, r_rec)
    rec_data = rec_data.reshape(p, n_rec, r_rec)
    rec_lens = rec_lens.reshape(p, n_rec)
    votes = np.zeros((p, g), dtype=np.uint8)
    votes[:, 3] = 1

    step = make_sharded_coproc_step(mesh, _spec().to_json(), r_batch, r_rec)
    ok, _out, _out_len, keep, tally = step(rows, lens, crcs, rec_data, rec_lens, votes)
    ok, keep, tally = np.asarray(ok), np.asarray(keep), tally.cpu().numpy()
    assert ok.all(), "batch CRC validation failed in dry run"
    assert keep.reshape(-1).tolist() == [i % 2 == 0 for i in range(p * n_rec)]
    assert tally[3] == p and tally.sum() == p
    print(
        f"dryrun_multichip OK: {n_devices}-shard mesh {[str(d) for d in mesh.devices]}, "
        f"engine submit_group kept {eng_kept}/{n_devices * len(docs)}, "
        f"{p * b} batches validated, {int(keep.sum())}/{p * n_rec} records kept, "
        f"vote tally {int(tally[3])}/{p}"
    )
