"""K1's leg (the columnar predicate as one native crossing) on the CPU.

A launch's predicate columns travel in one block (``ColumnarPlan.block_layout``)
that a staging slot of the engine's pool holds; on the card one crossing of
``rp_predicate_leg`` copies the block up, runs the kernel and copies the bits
down (tests/test_torch_cuda.py holds it to the plain version there). Here the
same block layout is packed and read back, the leg's plain version over the
packed block is held to the JAX package's ``compile_device`` program bit for
bit, the slots' reuse rules are driven with faked events, and a CPU engine's
columnar replies are held to the JAX engine's.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from redpanda_tpu.coproc.engine import TpuEngine
from redpanda_tpu_torch.coproc import column_plan as CP
from redpanda_tpu_torch.coproc import engine as engine_mod
from redpanda_tpu_torch.coproc.engine import TorchEngine
from redpanda_tpu_torch.ops.transforms import TransformSpec
from redpanda_tpu_torch.resource_mgmt import BudgetPlane

from test_torch_engine import ROW_STRIDE, SPECS, _port_request, _reply_bytes, _workload
from test_torch_predicate import REF_EXPRS, RANDOM_EXPRS, _both, _docs_vals, _random_docs
from redpanda_tpu.ops import exprs as RE
from redpanda_tpu.ops.transforms import where as ref_where


def _deep_expr():
    """The right-deep tree of tests/test_torch_predicate.py: 150 deep, so the
    kernel spills stack words."""
    leaves = [RE.field("code") >= k for k in range(-60, 90)]
    expr = leaves[-1]
    for i, leaf in enumerate(reversed(leaves[:-1])):
        expr = RE.Or(leaf, expr) if i % 2 else RE.And(leaf, expr)
    return expr


def _cases():
    """(id, JAX expression, record values, n_pad): the DOCS x EXPRS table at
    24 rows (a multiple of 8, not of 32), the random records at 2008 rows and
    the deep tree at 200."""
    out = [(f"docs{i}", e, _docs_vals(), 24) for i, e in enumerate(REF_EXPRS)]
    out += [(f"random{i}", f(RE.field), _random_docs(np.random.default_rng(1000 + i), 2003), 2008)
            for i, f in enumerate(RANDOM_EXPRS)]
    out.append(("deep", _deep_expr(), _random_docs(np.random.default_rng(5), 200), 200))
    return out


CASES = _cases()


def _leg_plain(plan, cols, n_pad) -> np.ndarray:
    """The leg's plain version: the columns packed into one block, the
    predicate over the block's views."""
    lay = plan.block_layout(n_pad)
    block = torch.zeros(lay.total, dtype=torch.uint8)
    lay.pack(cols, block.numpy())
    bits = torch.full((n_pad // 8 + 3,), 0xAA, dtype=torch.uint8)
    plan.predicate_leg(n_pad, block, bits)
    assert (bits[n_pad // 8 :] == 0xAA).all()  # nothing past the launch's bytes
    return bits[: n_pad // 8].numpy()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_the_block_layout_packs_and_reads_back(case):
    _, expr, vals, n_pad = case
    _, _, plan, cols = _both(expr, vals, n_pad)
    lay = plan.block_layout(n_pad)
    assert plan.block_layout(n_pad) is lay  # made once per row count
    ends = 0
    for off, c in zip(lay.offsets, cols):
        assert off % CP.LEG_ALIGN == 0 and off >= ends
        ends = off + c.nbytes
    assert lay.total % CP.LEG_ALIGN == 0 and ends <= lay.total < ends + CP.LEG_ALIGN
    block = np.full(lay.total, 0x5A, np.uint8)
    lay.pack(cols, block)
    views = lay.views(block)
    for v, c in zip(views, cols):
        assert v.dtype == c.dtype and v.shape == c.shape
        assert v.size == 0 or np.shares_memory(v, block)  # a str column may be 0 wide
        np.testing.assert_array_equal(v, c)
    for t, c in zip(lay.views(torch.from_numpy(block)), cols):
        np.testing.assert_array_equal(t.numpy(), c)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_the_leg_over_a_packed_block_matches_jax(case):
    """Bit-identical, with no tolerance, to the JAX package's device
    program over the same columns."""
    _, expr, vals, n_pad = case
    want, _, plan, cols = _both(expr, vals, n_pad)
    np.testing.assert_array_equal(_leg_plain(plan, cols, n_pad), want)
    if case[0] == "deep":
        assert plan.spill_words() == 2  # 150 deep: two words past the register's


def test_the_layout_refuses_what_it_cannot_hold():
    _, _, plan, cols = _both(REF_EXPRS[19], _docs_vals(), 24)  # level and code: five arrays
    lay = plan.block_layout(24)
    block = np.zeros(lay.total, np.uint8)
    with pytest.raises(ValueError):
        lay.pack(cols[:-1], block)
    with pytest.raises(ValueError):
        lay.pack([c.astype(np.int64) if c.dtype == np.int32 else c for c in cols], block)
    with pytest.raises(ValueError):
        lay.pack([c[:16] for c in cols], block)
    with pytest.raises(ValueError):
        lay.pack(cols, block[:-1])


def test_the_leg_runs_the_plain_version_only_where_the_block_lies():
    """A CPU block is evaluated where it lies: no copy up, no events; and a
    row count that is not a multiple of 8 is refused."""
    _, _, plan, cols = _both(REF_EXPRS[0], _docs_vals(), 24)
    lay = plan.block_layout(24)
    block = torch.zeros(lay.total, dtype=torch.uint8)
    lay.pack(cols, block.numpy())
    bits = torch.zeros(3, dtype=torch.uint8)
    with pytest.raises(ValueError):
        plan.predicate_leg(24, block, bits, host_block=block)
    with pytest.raises(ValueError):
        plan.predicate_leg(20, block, bits)


# ------------------------------------------------------------------ slots
class _FakeEvents:
    """A slot's events with a completion the test sets."""

    def __init__(self, done: bool):
        self.is_done = done

    def done(self) -> bool:
        return self.is_done

    def wait(self):
        self.is_done = True
        return 0.0, 0.0, 0.0

    def close(self) -> None:
        pass


def _plan_and_cols(seed: int, n: int = 200, n_pad: int = 256):
    plan = CP.plan_spec(TransformSpec.from_json(ref_where(REF_EXPRS[19]).to_json()))
    joined_vals = _random_docs(np.random.default_rng(seed), n)
    joined = b"".join(joined_vals)
    offsets = np.cumsum([0] + [len(v) for v in joined_vals[:-1]]).astype(np.int64)
    sizes = np.array([len(v) for v in joined_vals], np.int32)
    return plan, plan.extract_device_inputs(joined, offsets, sizes, n_pad)


@pytest.fixture
def eng():
    e = TorchEngine(device="cpu", row_stride=ROW_STRIDE, host_workers=0)
    yield e
    e.shutdown()


def test_a_slot_is_reused_only_once_its_last_event_completed(eng):
    plan, cols = _plan_and_cols(1)
    pending = eng._run_leg(plan, cols)
    slot = pending.slot
    pending.wait(eng)
    assert eng.leg_slot_stats()["slots"] == 1 and slot.owner is None
    slot.events = _FakeEvents(done=False)  # its last leg still runs
    other = eng._run_leg(plan, cols)
    assert other.slot is not slot and eng.leg_slot_stats()["slots"] == 2
    other.wait(eng)
    slot.events.is_done = True
    again = eng._run_leg(plan, cols)
    assert again.slot in (slot, other.slot) and eng.leg_slot_stats()["slots"] == 2
    again.wait(eng)


def test_fetched_bits_do_not_change_when_the_slot_is_rewritten(eng):
    plan, cols_a = _plan_and_cols(2)
    _, cols_b = _plan_and_cols(3)
    want_a = plan.eval_host_mask(cols_a)
    want_b = plan.eval_host_mask(cols_b)
    assert not np.array_equal(want_a, want_b)
    first = eng._run_leg(plan, cols_a)
    slot = first.slot
    bits_a = first.wait(eng)
    second = eng._run_leg(plan, cols_b)
    assert second.slot is slot  # the same staging, rewritten
    bits_b = second.wait(eng)
    np.testing.assert_array_equal(bits_a, want_a)
    np.testing.assert_array_equal(bits_b, want_b)
    assert not np.shares_memory(bits_a, slot.bits_np) and not np.shares_memory(bits_a, bits_b)


class _GatedEvents(_FakeEvents):
    """Events whose n-th wait blocks until the test opens gate n."""

    def __init__(self):
        super().__init__(done=True)
        self.gates = [threading.Event(), threading.Event()]
        self.entered = threading.Event()
        self.calls = 0

    def wait(self):
        gate = self.gates[min(self.calls, 1)]
        self.calls += 1
        self.entered.set()
        assert gate.wait(10.0)
        return 0.0, 0.0, 0.0


def test_two_waiters_on_one_result_hand_its_slot_back_once(eng):
    """A retried fetch waits on a result whose first fetch still runs: both
    get the result's own bits, though another leg takes the slot between
    them, and that leg keeps its slot."""
    plan, cols_a = _plan_and_cols(10)
    _, cols_b = _plan_and_cols(11)
    want_a, want_b = plan.eval_host_mask(cols_a), plan.eval_host_mask(cols_b)
    assert not np.array_equal(want_a, want_b)
    pending = eng._run_leg(plan, cols_a)
    slot = pending.slot
    slot.events = events = _GatedEvents()
    got = {}

    def fetch(name):
        got[name] = pending.wait(eng).copy()

    first = threading.Thread(target=fetch, args=("first",))
    first.start()
    assert events.entered.wait(10.0)
    second = threading.Thread(target=fetch, args=("second",))
    second.start()
    time.sleep(0.05)  # the second waiter reaches its wait
    events.gates[0].set()
    first.join(10.0)
    third = eng._run_leg(plan, cols_b)  # the slot, rewritten by another leg
    assert third.slot is slot
    events.gates[1].set()
    second.join(10.0)
    np.testing.assert_array_equal(got["first"], want_a)
    np.testing.assert_array_equal(got["second"], want_a)
    assert slot.owner is not None and slot.owner() is third
    assert eng.leg_slot_stats()["held"] == 1
    np.testing.assert_array_equal(third.wait(eng), want_b)


def test_an_abandoned_mask_returns_its_slot_after_its_event(eng):
    plan, cols = _plan_and_cols(4)
    launch = engine_mod._Launch(eng, 1, engine_mod.ErrorPolicy.skip_on_failure, plan)
    mask = engine_mod._MaskSlot(eng._run_leg(plan, cols))
    slot = mask.pending.slot
    slot.events = _FakeEvents(done=False)
    mask.state = "queued"
    launch.pending_slots.append(mask)
    eng._abandon_pending_masks(launch)
    assert mask.state == "abandoned" and slot.owner is None
    held = eng._run_leg(plan, cols)  # the abandoned slot is still in flight
    assert held.slot is not slot
    slot.events.is_done = True
    reuse = eng._run_leg(plan, cols)
    assert reuse.slot is slot
    assert eng.leg_slot_stats() == {"slots": 2, "held": 2, "bytes": 2 * slot.nbytes,
                                    "grows": 2, "trimmed": 0}


def test_a_dropped_result_frees_its_slot(eng):
    plan, cols = _plan_and_cols(5)
    pending = eng._run_leg(plan, cols)
    slot = pending.slot
    assert eng.leg_slot_stats()["held"] == 1
    del pending  # never fetched: its weak owner dies with it
    assert eng.leg_slot_stats()["held"] == 0
    assert eng._run_leg(plan, cols).slot is slot


def test_slots_grow_to_the_largest_launch(eng):
    plan, small = _plan_and_cols(6, n=100, n_pad=128)
    _, large = _plan_and_cols(7, n=2000, n_pad=2048)
    for cols in (small, large, small):
        pending = eng._run_leg(plan, cols)
        np.testing.assert_array_equal(pending.wait(eng), plan.eval_host_mask(cols))
    st = eng.leg_slot_stats()
    assert st["slots"] == 1 and st["grows"] == 2 and st["held"] == 0
    assert st["bytes"] >= plan.block_layout(2048).total


def test_critical_pressure_frees_the_free_slots_and_their_charge():
    plane = BudgetPlane(64 << 20)
    eng = TorchEngine(device="cpu", row_stride=ROW_STRIDE, host_workers=0, budget_plane=plane)
    try:
        plan, cols = _plan_and_cols(8)
        held = eng._run_leg(plan, cols)  # unfetched: its slot stays
        eng._run_leg(plan, cols).wait(eng)  # fetched: free
        before = eng.leg_slot_stats()
        assert before["slots"] == 2 and before["held"] == 1
        storage = plane.account("storage")
        got = storage.try_acquire(int(storage.limit * 0.95))
        assert plane.pressure() == "critical"
        after = eng.leg_slot_stats()
        assert after["slots"] == 1 and after["held"] == 1 and after["trimmed"] == 1
        assert after["bytes"] == held.slot.nbytes == before["bytes"] // 2
        assert eng.stats()["n_pressure_slot_bytes"] == before["bytes"] - after["bytes"]
        np.testing.assert_array_equal(held.wait(eng), plan.eval_host_mask(cols))
        storage.release(got)
    finally:
        eng.shutdown()
    assert eng.leg_slot_stats()["slots"] == 0


def test_shutdown_frees_every_slot(eng):
    plan, cols = _plan_and_cols(9)
    pendings = [eng._run_leg(plan, cols) for _ in range(3)]
    assert eng.leg_slot_stats()["slots"] == 3
    eng.shutdown()
    st = eng.leg_slot_stats()
    assert st["slots"] == 0 and st["bytes"] == 0
    assert all(p.slot.cap == 0 for p in pendings)


# ------------------------------------------------------------------ engine
COLUMNAR = sorted(k for k in SPECS if k.startswith("columnar"))
LANES = {
    "inline": dict(host_workers=0),
    "cached": dict(host_workers=0, device_column_cache_mb=16),
    "pool": dict(host_workers=2, host_pool_probe=False),
}


@pytest.fixture(scope="module")
def workload():
    return _workload()


@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("name", COLUMNAR)
def test_a_cpu_engine_matches_the_jax_engine_through_the_slots(name, lane, workload, monkeypatch):
    """Every columnar launch's predicate goes through a staging slot; the
    replies are the JAX engine's bytes on the inline lane, on the column
    cache's hits and on the pool's shards, and no slot stays held."""
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)
    spec_json = SPECS[name].to_json()
    ref = TpuEngine(row_stride=ROW_STRIDE, force_mode="columnar_device", host_workers=1,
                    structural_parse=False, device_column_cache_mb=0)
    try:
        assert ref.enable_coprocessors([(1, spec_json, ("t",))]) == [0]
        want = _reply_bytes(ref.process_batch(workload))
    finally:
        ref.shutdown()
    eng = TorchEngine(device="cpu", row_stride=ROW_STRIDE, **LANES[lane])
    try:
        assert eng.enable_coprocessors([(1, spec_json, ("t",))]) == [0]
        for _ in range(3):  # the cached lane: one cold launch, then hits
            tickets = eng.submit_group([_port_request(workload), _port_request(workload)])
            assert [_reply_bytes(t.result()) for t in tickets] == [want, want]
        st, slots = eng.stats(), eng.leg_slot_stats()
    finally:
        eng.shutdown()
    assert not any(k.startswith("n_failures") for k in st)
    assert st["n_kernel_predicate"] == (6 if lane == "pool" else 3)
    assert slots["held"] == 0 and 1 <= slots["slots"] <= (2 if lane == "pool" else 1)
    if lane == "cached":
        assert st["n_colcache_hit"] == 2
    if lane == "pool":
        assert st["n_sharded_launches"] == 3
