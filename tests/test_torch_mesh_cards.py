"""The mesh programs that run as one launch per card, against the JAX package.

The stacked predicate (K2) is ``ColumnarPlan.predicate_blocks`` over a
table of column blocks, and the coproc step (K10) one fused launch over a
card's shards; both cut a card's shards into chunks at the pointer cap of
their kernel's table. On the CPU the blocks run the plain versions, so
these tests hold the block and chunk bookkeeping, the CPU mesh's results
and the engine's dispatch boundary to the JAX package on the same seeded
numpy inputs, exactly. The kernels themselves are held to the plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from redpanda_tpu import parallel as RPAR
from redpanda_tpu.coproc.column_plan import plan_spec as ref_plan_spec
from redpanda_tpu.ops.transforms import where as ref_where
from redpanda_tpu_torch import kernels
from redpanda_tpu_torch.coproc import column_plan as CP
from redpanda_tpu_torch.coproc.engine import ErrorPolicy, TorchEngine
from redpanda_tpu_torch.ops.transforms import TransformSpec
from redpanda_tpu_torch.parallel import collectives as COL
from redpanda_tpu_torch.parallel import mesh as M
from test_torch_mesh import MESH_SPECS, SPEC, _mesh_request, _port_request, _random_tick
from test_torch_predicate import REF_EXPRS, _records

N_PAD = 16  # rows per block


def _doc_values(rng, n):
    out = []
    for i in range(n):
        d = {"level": ["error", "info", "", "errorx"][int(rng.integers(0, 4))],
             "code": int(rng.integers(-600, 600))}
        if i % 3:
            d["msg"] = "ab" * int(rng.integers(0, 8)) + ("needle" if i % 4 == 0 else "")
        if i % 7 == 0:
            d["code"] = [1.5, 2**31, "12", True, None][i % 5]
        out.append(json.dumps(d, separators=(",", ":")).encode())
    return out


def _block_stacks(plan, n_blocks: int, seed: int):
    """[n_blocks, N_PAD, ...] stacks of the plan's columns, one block of
    0..N_PAD random records each (every fifth block empty)."""
    rng = np.random.default_rng(seed)
    per = []
    for b in range(n_blocks):
        n = 0 if b % 5 == 1 else int(rng.integers(1, N_PAD + 1))
        per.append(plan.zero_device_inputs(N_PAD) if n == 0 else
                   plan.extract_device_inputs(*_records(_doc_values(rng, n)), N_PAD))
    return [np.stack(c) for c in zip(*per)]


@pytest.fixture(scope="module")
def ref_meshes(eight_devices):
    return {1: RPAR.partition_mesh(devices=eight_devices[:1]),
            4: RPAR.partition_mesh(devices=eight_devices[:4])}


def _ref_stacked(ref_plan, ref_meshes, stacks):
    """The JAX stacked predicate over the blocks, four at a time (one at a
    time for a single block): one block per virtual device."""
    n = stacks[0].shape[0]
    mesh = ref_meshes[1 if n == 1 else 4]
    d = mesh.devices.size
    fn = ref_plan.compile_device_stacked(mesh)
    out = []
    for lo in range(0, n, d):
        args = RPAR.shard_to_mesh(mesh, *[s[lo : lo + d] for s in stacks])
        out.append(np.asarray(fn(*(args if isinstance(args, tuple) else (args,)))))
    return np.concatenate(out)


# ------------------------------------------------------------------ K2
@pytest.mark.parametrize("n_blocks", [1, 4, 68])
@pytest.mark.parametrize("idx", [0, 18, 22])
def test_predicate_blocks_match_reference(n_blocks, idx, ref_meshes):
    spec_json = ref_where(REF_EXPRS[idx]).to_json()
    ref = ref_plan_spec(ref_where(REF_EXPRS[idx]))
    plan = CP.plan_spec(TransformSpec.from_json(spec_json))
    stacks = _block_stacks(plan, n_blocks, seed=n_blocks + idx)
    for a, b in zip(_block_stacks(ref, n_blocks, seed=n_blocks + idx), stacks):
        np.testing.assert_array_equal(a, b)
    want = _ref_stacked(ref, ref_meshes, stacks)
    tensors = [torch.from_numpy(s) for s in stacks]
    got = plan.predicate_blocks([[t[b] for t in tensors] for b in range(n_blocks)])
    assert got.dtype == torch.uint8 and tuple(got.shape) == (n_blocks, N_PAD // 8)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(CP.predicate_stacked_plain(plan, tensors).numpy(), want)
    # the one-block case is the single-device predicate
    np.testing.assert_array_equal(plan.predicate([t[0] for t in tensors]).numpy(), want[0])
    # a mesh of n_blocks CPU shards: one predicate_blocks call for its one "card"
    mesh = M.partition_mesh(n_blocks, device="cpu")
    np.testing.assert_array_equal(np.asarray(plan.predicate_stacked(mesh, stacks)), want)


def test_predicate_blocks_check_their_blocks():
    plan = CP.plan_spec(TransformSpec.from_json(ref_where(REF_EXPRS[19]).to_json()))
    stacks = [torch.from_numpy(s) for s in _block_stacks(plan, 3, seed=1)]
    blocks = [[t[b] for t in stacks] for b in range(3)]
    with pytest.raises(ValueError):
        plan.predicate_blocks([])
    with pytest.raises(ValueError):
        plan.predicate_blocks([blocks[0], blocks[1][:-1]])  # a column short
    with pytest.raises(ValueError):
        plan.predicate_blocks([blocks[0], [t[:8] for t in blocks[1]]])  # another row count


@pytest.mark.parametrize("n_blocks,n_cols,want", [
    (1, 2, [(0, 1)]),
    (240, 2, [(0, 240)]),
    (500, 2, [(0, 240), (240, 480), (480, 500)]),
    (7, 64, [(0, 7)]),
    (15, 64, [(0, 7), (7, 14), (14, 15)]),
    (161, 3, [(0, 160), (160, 161)]),
])
def test_predicate_chunks_cut_at_the_pointer_cap(n_blocks, n_cols, want):
    """A launch takes as many blocks as fit in its table of 480 pointers."""
    assert CP.block_chunks(n_blocks, n_cols) == want
    assert all((hi - lo) * n_cols <= CP.MAX_TABLE_PTRS for lo, hi in want)


def _cuda(*idx):
    return [torch.device("cuda", i) for i in idx]


@pytest.mark.parametrize("devices,want", [
    (_cuda(0) * 4, [(0, (0, 1, 2, 3))]),
    (_cuda(0) * 161, [(0, tuple(range(80))), (0, tuple(range(80, 160))), (0, (160,))]),
    (_cuda(1, 0) * 81, [(1, tuple(range(0, 160, 2))), (1, (160,)),
                        (0, tuple(range(1, 161, 2))), (0, (161,))]),
])
def test_step_chunks_cut_at_the_pointer_cap(devices, want):
    """The coproc step's launches: a card's shards in runs of 80 (six
    pointers a shard in a table of 480); chunk 0 is devices[0]'s."""
    chunks = M.card_chunks(devices, COL.MAX_STEP_SHARDS)
    assert [(dev.index, shards) for dev, shards in chunks] == want
    assert sorted(d for _, shards in chunks for d in shards) == list(range(len(devices)))
    with pytest.raises(ValueError):
        M.card_chunks(devices, 0)


@pytest.mark.parametrize("policy", ["skip_on_failure", "deregister"])
def test_failing_predicate_blocks_meets_the_dispatch_boundary(policy, monkeypatch):
    """A failure raised by the stacked predicate's launch reaches the
    engine's dispatch boundary (the script's error policy, counted in
    stats()); nothing answers in its place."""

    def failing(self, blocks, kernel=kernels.PREDICATE_STACKED):
        raise RuntimeError("predicate_stacked: kernel launch failed, CUDA error 700")

    monkeypatch.setattr(CP.ColumnarPlan, "predicate_blocks", failing)
    mesh = M.partition_mesh(4, device="cpu")
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


# ------------------------------------------------------------------ K10
P_STEP = 260  # partitions: divisible by 1, 4 and 65 shards


@pytest.fixture(scope="module")
def step_tick_and_reference(ref_meshes):
    """One tick of 260 partitions (1 batch, 2 records each; wrong claims,
    an empty batch, garbage past each length) and the JAX step's answer on
    four virtual devices."""
    args = _random_tick(P_STEP, 1, 2)
    mesh = ref_meshes[4]
    fn = RPAR.make_sharded_coproc_step(mesh, SPEC.to_json(), 256, 128)
    return args, [np.asarray(x) for x in fn(*RPAR.shard_to_mesh(mesh, *args))]


@pytest.mark.parametrize("n_shards", [1, 4, 65])
def test_coproc_step_on_cpu_meshes_matches_reference(n_shards, step_tick_and_reference):
    args, want = step_tick_and_reference
    mesh = M.partition_mesh(n_shards, device="cpu")
    got = COL.make_sharded_coproc_step(mesh, SPEC.to_json(), 256, 128)(*args)
    ok, out, out_len, keep, tally = [np.asarray(g) if isinstance(g, M.Sharded) else g.numpy()
                                      for g in got]
    w_ok, w_out, w_len, w_keep, w_tally = want
    assert all(len(g.blocks) == n_shards for g in got[:4])
    np.testing.assert_array_equal(ok, w_ok)
    np.testing.assert_array_equal(keep, w_keep)
    np.testing.assert_array_equal(out_len, w_len)
    np.testing.assert_array_equal(out[w_keep], w_out[w_keep])  # dropped rows are undefined
    np.testing.assert_array_equal(tally, w_tally)
    assert not w_ok.all() and w_keep.any() and not w_keep.all()


def test_coproc_step_checks_its_blocks():
    args = list(_random_tick(16, 1, 2))
    mesh = M.partition_mesh(4, device="cpu")
    step = COL.make_sharded_coproc_step(mesh, SPEC.to_json(), 256, 128)
    for k, bad in ((3, args[3][:, :, :64]),  # record rows of another width
                   (4, args[4][:, :1]),  # record lengths of another shape
                   (5, args[5][:, :, None]),  # votes not [P, G]
                   (4, args[4].astype(np.int64))):  # lengths not int32
        with pytest.raises(ValueError):
            step(*args[:k], bad, *args[k + 1:])


# ------------------------------------------------------------------ the build
def test_kernel_builds_are_named_by_their_headers(tmp_path, monkeypatch):
    """The fused step shares the CRC, transform and tally device bodies
    through headers in csrc/, as the split CRC kernel shares the CRC and
    tally bodies; a kernel's library is named by a hash of its source and
    every header it includes, so a changed header never loads a stale
    library."""
    import os
    import sys

    from redpanda_tpu_torch import build

    names = {k.name: sorted(os.path.basename(f) for f in kernels.source_files(
        os.path.join(kernels.CSRC, os.path.basename(k.source)))) for k in kernels.KERNELS}
    assert names["coproc_step"] == ["coproc_step.cu", "crc32c.cuh", "payload_transform.cuh",
                                    "vote_tally.cuh"]
    assert names["crc32c_vote"] == ["crc32c.cuh", "crc_blocks.cu", "vote_tally.cuh"]
    assert names["crc32c"] == names["crc32c_validate"] == names["crc32c_vote"]
    assert names["vote_tally"] == ["vote_tally.cu", "vote_tally.cuh"]
    assert names["payload_transform"] == names["payload_record"] == [
        "payload_transform.cu", "payload_transform.cuh"]
    assert names["predicate_stacked"] == ["predicate.cu"]

    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("int b = 1;\n")
    monkeypatch.setattr(kernels, "CSRC", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))

    def built() -> str:
        src = str(tmp_path / "k.cu")
        return build.cached_build("k", kernels.source_files(src), lambda out: [
            sys.executable, "-c", f"open({out!r}, 'w').write('lib')"])

    first = built()
    assert built() == first and os.path.exists(first)
    (tmp_path / "b.cuh").write_text("int b = 2;\n")  # a header two includes down
    assert built() != first
