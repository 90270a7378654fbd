"""The port's budget plane and admission (redpanda_tpu_torch/resource_mgmt/,
TorchEngine(budget_plane=)) against the JAX package's.

Accounts, the plane's pressure levels and listeners, the admission
controller's throttle ramp and the inflight gate are fed the same seeded
operation sequences in both packages and must answer the same, snapshot for
snapshot, with no tolerance. The engine runs on the CPU, where the plain
versions stand in for the kernels: a shed submit raises the same ShedError
as the JAX engine's and runs nothing, the same ADMISSION journal entries are
written, and after the release the reply is bit-identical to the JAX
engine's. Every lane and every raise path of the port gives its reserved
bytes back. Following tests/test_resource_mgmt.py.
"""

from __future__ import annotations

import asyncio
import gc
import weakref

import numpy as np
import pytest

from redpanda_tpu import metrics as ref_metrics
from redpanda_tpu import resource_mgmt as ref_rm
from redpanda_tpu.coproc import governor as ref_governor
from redpanda_tpu.coproc.engine import TpuEngine
from redpanda_tpu.finjector import honey_badger as ref_badger
from redpanda_tpu.ops.transforms import Int, Str, filter_field_eq, identity, map_project
from redpanda_tpu.resource_mgmt import admission as ref_admission
from redpanda_tpu.resource_mgmt import budgets as ref_budgets
from redpanda_tpu_torch import metrics
from redpanda_tpu_torch import resource_mgmt as rm
from redpanda_tpu_torch.coproc import engine as engine_mod
from redpanda_tpu_torch.coproc import faults, governor
from redpanda_tpu_torch.coproc.column_plan import ColumnarPlan
from redpanda_tpu_torch.coproc.engine import ErrorPolicy, TorchEngine
from redpanda_tpu_torch.finjector import honey_badger
from redpanda_tpu_torch.parallel.mesh import partition_mesh
from redpanda_tpu_torch.resource_mgmt import admission, budgets
from test_meshrunner import PROJ_SPEC as MESH_PROJ_SPEC
from test_meshrunner import _request as _mesh_request
from test_resource_mgmt import _req as _ref_test_req
from test_structural_parse import PASS_SPEC, PROJ_SPEC, _request
from test_torch_structural import ROW_STRIDE, _port_request, _reply_bytes

PAYLOAD_SPEC = filter_field_eq("level", "error") | map_project(Int("code"), Str("msg", 16))

_engines: list = []


def _disarm(badger) -> None:
    for module, armed in list(badger.armed().items()):
        for probe in armed:
            badger.unset(module, probe)
    badger.disable()


@pytest.fixture(autouse=True)
def _clean_process_state():
    """The process plane, the port's journal and both honey badgers are
    process-global: every test starts and ends with no plane installed, an
    empty journal and disarmed badgers, and its engines shut down."""
    budgets.install(None)
    governor.reset_journal()
    faults.reset_warned()
    yield
    while _engines:
        _engines.pop().shutdown()
    _disarm(honey_badger)
    _disarm(ref_badger)
    governor.reset_journal()
    budgets.install(None)


def _engine(plane=None, **kw) -> TorchEngine:
    kw.setdefault("host_workers", 0)
    kw.setdefault("retry_backoff_ms", 1)
    kw.setdefault("row_stride", ROW_STRIDE)
    eng = TorchEngine(device="cpu", budget_plane=plane, **kw)
    _engines.append(eng)
    return eng


def _enable(eng, spec=PROJ_SPEC, policy=ErrorPolicy.skip_on_failure, topic="bench"):
    assert eng.enable_coprocessors([(1, spec.to_json(), (topic,), policy)]) == [0]


def _nbytes(req) -> int:
    return sum(len(b.payload) for item in req.items for b in item.batches)


# ------------------------------------------------------------------ accounts
def _account_ops(seed: int, n: int = 300):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(n):
        k = int(rng.integers(0, 10))
        if k < 5:
            ops.append(("try", int(rng.integers(-5, 400))))
        elif k < 8:
            ops.append(("release", int(rng.integers(-5, 400))))
        elif k == 8:
            ops.append(("reset_peak",))
        else:
            ops.append(("huge", int(rng.integers(1001, 10**9))))
    return ops


def _drive_account(mod, ops, limit=1000):
    a = mod.MemoryAccount("t", limit)
    out = []
    for op in ops:
        if op[0] in ("try", "huge"):
            out.append(("try", a.try_acquire(op[1])))
        elif op[0] == "release":
            a.release(op[1])
        else:
            a.reset_peak()
        out.append((a.held, a.peak, a.occupancy(), a.snapshot()))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_account_sequences_match_reference(seed):
    ops = _account_ops(seed)
    assert _drive_account(budgets, ops) == _drive_account(ref_budgets, ops)


def test_account_acquire_release_clamp_peak():
    for mod in (budgets, ref_budgets):
        a = mod.MemoryAccount("t", 1000)
        assert a.try_acquire(400) == 400 and (a.held, a.peak) == (400, 400)
        assert a.try_acquire(700) == 0 and a.held == 400  # refused: untouched
        a.release(400)
        assert a.try_acquire(10**9) == 1000  # oversized: clamped to the limit
        a.release(1000)
        assert (a.held, a.peak) == (0, 1000)
        a.reset_peak()
        assert a.peak == 0 and a.try_acquire(0) == 0 and a.held == 0


async def _fifo_scenario(mod):
    """FIFO order, cancel-before-grant, cancel-after-grant and a dead-loop
    head, as a log of what each waiter saw."""
    a = mod.MemoryAccount("t", 100)
    log = [("first", await a.acquire(80))]

    async def waiter(tag, n):
        try:
            got = await a.acquire(n)
            log.append(("got", tag, got, a.held))
        except asyncio.CancelledError:
            log.append(("cancelled", tag, a.held))
            raise

    big = asyncio.create_task(waiter("big", 60))
    await asyncio.sleep(0.005)
    small = asyncio.create_task(waiter("small", 10))
    gone = asyncio.create_task(waiter("gone", 5))
    await asyncio.sleep(0.005)
    log.append(("parked", len(a._waiters), a.held))
    gone.cancel()  # cancelled before any grant: leaves the queue
    await asyncio.gather(gone, return_exceptions=True)
    log.append(("after_cancel", len(a._waiters), a.held))
    a.release(80)  # grants big, then small, in order
    await asyncio.gather(big, small)
    log.append(("granted", a.held, a.peak))
    # cancel-after-grant: the grant lands, then the task is cancelled
    late = asyncio.create_task(waiter("late", 40))
    await asyncio.sleep(0.005)
    a.release(40)  # grants late synchronously; cancel it before it runs
    late.cancel()
    await asyncio.gather(late, return_exceptions=True)
    log.append(("late_returned", a.held))
    # a dead-loop head is skipped, never blocking the live waiter behind it
    dead_loop = asyncio.new_event_loop()
    dead_fut = dead_loop.create_future()
    dead_loop.close()
    a.try_acquire(a.limit - a.held)
    a._waiters.append((10, dead_fut))
    live = asyncio.create_task(waiter("live", 10))
    await asyncio.sleep(0.005)
    a.release(30)
    await live
    log.append(("end", a.held, len(a._waiters), dead_fut.done()))
    return log


def test_account_async_fifo_wait_matches_reference():
    got = asyncio.run(_fifo_scenario(budgets))
    assert got == asyncio.run(_fifo_scenario(ref_budgets))
    assert [e[1] for e in got if e[0] == "got"] == ["big", "small", "live"]
    assert ("late_returned", 30) in got and ("cancelled", "late", 30) in got
    assert got[-1] == ("end", 80, 0, False)


# ------------------------------------------------------------------ the plane
def _drive_plane(mod, seed, total=10_000, n=400):
    rng = np.random.default_rng(seed)
    plane = mod.BudgetPlane(total)
    events = []
    plane.add_pressure_listener(lambda lvl, snap: events.append((lvl, snap)))
    names = list(plane.accounts)
    held = {k: [] for k in names}
    out = []
    for _ in range(n):
        name = names[int(rng.integers(0, len(names)))]
        acct = plane.account(name)
        if rng.random() < 0.55:
            got = acct.try_acquire(int(rng.integers(1, acct.limit // 3 + 2)))
            if got:
                held[name].append(got)
        elif held[name]:
            acct.release(held[name].pop(int(rng.integers(0, len(held[name])))))
        out.append((plane.pressure(), plane.max_occupancy()))
    return out, events, plane.snapshot()


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_plane_levels_and_listener_calls_match_reference(seed):
    got = _drive_plane(budgets, seed)
    assert got == _drive_plane(ref_budgets, seed)
    assert {lvl for lvl, _ in got[1]} == {"ok", "warn", "critical"}


def test_plane_pressure_levels_listener_and_hysteresis():
    for mod in (budgets, ref_budgets):
        plane = mod.BudgetPlane(1000, {"x": 1.0}, warn_pct=0.75, critical_pct=0.90)
        events = []
        plane.add_pressure_listener(lambda lvl, snap: events.append(lvl))
        acct = plane.account("x")
        levels = []
        for op, n in [("a", 800), ("a", 150), ("r", 80), ("r", 100), ("r", 50), ("r", 720)]:
            acct.try_acquire(n) if op == "a" else acct.release(n)
            levels.append(plane.pressure())
        # 0.8 warn, 0.95 critical, 0.87 held critical, 0.77 warn, 0.72 held warn, 0 ok
        assert levels == ["warn", "critical", "critical", "warn", "warn", "ok"]
        assert events == ["warn", "critical", "warn", "ok"]


def test_plane_defaults_and_a_failing_listener_match_reference():
    for mod in (budgets, ref_budgets):
        plane = mod.BudgetPlane()
        assert plane.total_bytes == 512 * 1024 * 1024 and plane.warn_pct == 0.75
        assert plane.critical_pct == 0.90 and mod.DEFAULT_SPLIT == ref_budgets.DEFAULT_SPLIT
        assert plane.account("coproc").limit == 128 * 1024 * 1024
        calls = []
        plane.add_pressure_listener(lambda lvl, snap: 1 / 0)  # logged, never raised
        plane.add_pressure_listener(lambda lvl, snap: calls.append(lvl))
        acct = plane.account("raft")
        acct.try_acquire(acct.limit)
        assert calls == ["critical"]
        fn = plane._listeners[1]
        plane.remove_pressure_listener(fn)
        plane.remove_pressure_listener(fn)  # a second removal is a no-op
        acct.release(acct.limit)
        assert calls == ["critical"] and plane.pressure() == "ok"


def test_install_current_and_account_or_none():
    assert budgets.current() is None and budgets.account_or_none("coproc") is None
    plane = rm.BudgetPlane(1 << 20)
    budgets.install(plane)
    assert budgets.current() is plane
    assert budgets.account_or_none("coproc") is plane.account("coproc")
    assert budgets.account_or_none("nope") is None
    budgets.install(None)
    assert budgets.current() is None


# ------------------------------------------------------------------ gauges
def test_gauge_series_match_reference(monkeypatch):
    """Both planes' gauges on private registries: the same series names,
    labels and values, live, and -1 once the plane is collected."""
    ports, refs = metrics.MetricsRegistry(), ref_metrics.MetricsRegistry()
    monkeypatch.setattr(budgets, "registry", ports)
    monkeypatch.setattr(ref_budgets, "registry", refs)
    planes = [budgets.BudgetPlane(1 << 20, register_gauges=True),
              ref_budgets.BudgetPlane(1 << 20, register_gauges=True)]
    for p in planes:
        p.account("coproc").try_acquire(300_000)
        p.account("coproc").release(100_000)
    snap = ports.snapshot()
    assert snap == refs.snapshot()
    # 300000 clamps to the account's 262144, then 162144 held: back to ok
    assert snap['resource_account_held_bytes{account="coproc"}'] == 162_144
    assert snap['resource_account_peak_bytes{account="coproc"}'] == 262_144
    assert snap["resource_pressure_state"] == 0.0
    del planes, p
    gc.collect()
    assert set(ports.snapshot().values()) == {-1.0} == set(refs.snapshot().values())


def test_gauges_are_registered_and_live_in_the_process_registry():
    plane = rm.BudgetPlane(1 << 20, register_gauges=True)
    key = 'resource_account_held_bytes{account="coproc"}'
    assert metrics.registry.snapshot()[key] == 0.0
    got = plane.account("coproc").try_acquire(1234)
    snap = metrics.registry.snapshot()
    assert snap[key] == 1234.0 and snap["resource_pressure_state"] == 0.0
    assert 'resource_account_limit_bytes{account="coproc"}' in snap
    text = metrics.registry.render_prometheus()
    assert 'redpanda_tpu_resource_account_held_bytes{account="coproc"} 1234' in text
    plane.account("coproc").release(got)
    del plane
    gc.collect()
    assert metrics.registry.snapshot()[key] == -1.0


# ------------------------------------------------------------------ admission
def _drive_controller(adm_mod, bud_mod, seed):
    rng = np.random.default_rng(seed)
    a = bud_mod.MemoryAccount("t", 1000)
    episodes = []
    c = adm_mod.AdmissionController(a, "torch_parity_sub", base_throttle_ms=50,
                                    max_throttle_ms=1000, warn_pct=0.75,
                                    on_episode=lambda kind, info: episodes.append((kind, info)))
    out, held = [], []
    for _ in range(300):
        r = rng.random()
        if r < 0.5:
            got = c.try_admit(int(rng.integers(-2, 300)))
            out.append(("try", got))
            if got[0]:
                held.append(got[0])
        elif r < 0.6:
            try:
                got = c.admit(int(rng.integers(1, 300)))
                held.append(got)
                out.append(("admit", got))
            except adm_mod.ShedError as exc:
                out.append(("shed", exc.subsystem, exc.retry_after_ms, str(exc)))
        elif held:
            c.release(held.pop(int(rng.integers(0, len(held)))))
        out.append((c.throttle_ms(), c.snapshot()))
    return out, episodes


@pytest.mark.parametrize("seed", [6, 7])
def test_controller_sequences_match_reference(seed):
    got = _drive_controller(admission, budgets, seed)
    assert got == _drive_controller(ref_admission, ref_budgets, seed)
    kinds = [k for k, _ in got[1]]
    assert "shed" in kinds and "resumed" in kinds
    assert all(a != b for a, b in zip(kinds, kinds[1:]))  # one entry an episode


def test_throttle_ramp_and_counters():
    sheds = admission.shed_counter("torch_parity_ramp").value
    ramps = []
    for adm_mod, bud_mod in ((admission, budgets), (ref_admission, ref_budgets)):
        a = bud_mod.MemoryAccount("t", 1000)
        c = adm_mod.AdmissionController(a, "torch_parity_ramp", warn_pct=0.75)
        ramp = []
        for held in range(0, 1001, 50):
            a.try_acquire(held)
            ramp.append(c.throttle_ms())
            a.release(held)
        # base up to the warn line, then linear to max at a full account
        assert ramp[:16] == [50] * 16 and ramp[-1] == 1000
        assert ramp[16:] == sorted(set(ramp[16:])) and 235 < ramp[16] < 245
        ramps.append(ramp)
        a.try_acquire(1000)
        assert c.try_admit(10) == (0, 1000)
        a.release(1000)
        assert c.try_admit(10) == (10, 0) and c.try_admit(0) == (0, 0)
        snap = c.snapshot()
        assert (snap["sheds"], snap["admitted"]) == (1, 1)
        c.release(10)
        assert a.held == 0
    assert ramps[0] == ramps[1]
    assert admission.shed_counter("coproc") is admission.shed_counter("coproc")
    assert admission.shed_counter("torch_parity_ramp").value == sheds + 1
    assert "torch_parity_ramp_admission_shed_total" in metrics.registry.snapshot()


def _drive_gate(adm_mod, bud_mod, met_mod):
    a = bud_mod.MemoryAccount("rpc", 100)
    episodes = []
    g = adm_mod.InflightGate(a, max_requests=2, subsystem="torch_parity_rpc",
                             on_episode=lambda kind, info: episodes.append((kind, info)))
    out = []
    r1, r2 = g.try_enter(40), g.try_enter(40)
    out += [r1, r2, g.try_enter(1)]  # the request cap
    g.leave(r1)
    out += [g.try_enter(90)]  # the byte cap: 40 + 90 > 100
    r3 = g.try_enter(30)
    out += [r3, g.snapshot()]
    g.leave(r2)
    g.leave(r3)
    out += [g.try_enter(0), a.held, g.snapshot()]
    # the inflight gauge, live while the gate is
    out.append(met_mod.registry.snapshot()['rpc_inflight_requests{subsystem="torch_parity_rpc"}'])
    return out, episodes


def test_inflight_gate_caps_match_reference():
    got = _drive_gate(admission, budgets, metrics)
    assert got == _drive_gate(ref_admission, ref_budgets, ref_metrics)
    out, episodes = got
    assert out[:4] == [40, 40, None, None] and out[4] == 30
    assert out[5]["sheds"] == 2 and [k for k, _ in episodes] == ["shed", "resumed"]
    assert out[-4:-2] == [1, 1] and out[-1] == 1.0


def test_memory_budget_groups_and_scheduling_groups_match_reference():
    async def drive(mod):
        b = mod.MemoryBudget(100)
        got = [await b.acquire(60), b.available, b.in_use]
        b.release(60)
        g = mod.SchedulingGroup("coproc", max_concurrency=1)

        async def work(x):
            await asyncio.sleep(0)
            return x * 2

        got += [await g.run(work(3)), g.tasks_run, b.available]
        groups = mod.MemoryGroups(1 << 20)
        got += [groups.kafka_request_memory, groups.rpc_memory, groups.coproc_staging_memory,
                groups.storage_cache_memory, sorted(mod.default_scheduling_groups())]
        return got

    assert asyncio.run(drive(rm)) == asyncio.run(drive(ref_rm))


# ------------------------------------------------------------------ the engine
def _tiny_planes(coproc_bytes=256):
    """A plane whose coproc account is smaller than a 64-record launch, in
    each package (tests/test_resource_mgmt.py's _tiny_plane)."""
    split = {"kafka_produce": 0.125, "rpc": 0.125, "coproc": 0.125, "storage": 0.5, "raft": 0.125}
    return budgets.BudgetPlane(coproc_bytes * 8, split), ref_budgets.BudgetPlane(coproc_bytes * 8,
                                                                                 split)


def _admission_entries(journal, tag):
    return [(e["verdict"], e["reason"], e["inputs"]) for e in reversed(journal.entries(
        domain=governor.ADMISSION)) if e.get("engine") == tag]


def test_engine_shed_before_ack_matches_reference():
    """The same filler in both packages: the same ShedError, nothing run,
    the same ADMISSION entries, and after the release a reply bit-identical
    to the JAX engine's, with every byte back."""
    planes = _tiny_planes()
    ref_req = _ref_test_req(64)
    port = _engine(planes[0], row_stride=256)
    ref = TpuEngine(row_stride=256, budget_plane=planes[1], force_mode="columnar_host",
                    host_workers=0)
    try:
        assert ref.enable_coprocessors([(1, PAYLOAD_SPEC.to_json(), ("orders",))]) == [0]
        _enable(port, PAYLOAD_SPEC, topic="orders")
        outs = []
        for eng, plane, req in ((port, planes[0], _port_request(ref_req)),
                                (ref, planes[1], ref_req)):
            acct = plane.account("coproc")
            filler = acct.try_acquire(acct.limit)
            before = eng.stats()
            with pytest.raises(Exception) as info:
                eng.submit(req)
            exc = info.value
            st = eng.stats()
            assert acct.held == filler and st["n_shed_submits"] == 1.0
            moved = {k for k in set(st) | set(before) if k.startswith(("n_", "t_", "bytes_"))
                     and st.get(k) != before.get(k)}
            assert moved == {"n_shed_submits"}  # shed before anything ran
            acct.release(filler)
            reply = _reply_bytes(eng.submit(req).result())
            assert acct.held == 0
            outs.append((type(exc).__name__, exc.subsystem, exc.retry_after_ms, str(exc), reply,
                         st["admission"]["sheds"], eng.stats()["admission"]))
        assert outs[0] == outs[1]
        assert outs[0][0] == "ShedError" and outs[0][2] == 1000
        (item,) = outs[0][4][0]
        assert len(item[2]) == 1  # one output batch kept
        got = _admission_entries(governor.journal, port.governor.engine_tag)
        assert got == _admission_entries(ref_governor.journal, ref.governor.engine_tag)
        # the filler fills the account (critical); the admitted request is
        # clamped to the whole account (critical again) until it harvests
        assert [v for v, _, _ in got] == ["critical", "shed", "ok", "critical", "resumed", "ok"]
    finally:
        ref.shutdown()


def test_engine_admission_releases_on_result_exception_idempotently():
    plane = rm.BudgetPlane(1 << 20)
    acct = plane.account("coproc")
    eng = _engine(plane)
    _enable(eng)
    req = _port_request(_request(n_items=2, records=16, pad=40))
    ticket = eng.submit(req)
    assert acct.held == _nbytes(req) == ticket._admitted

    def boom():
        raise RuntimeError("synthetic harvest failure")

    ticket._result = boom
    with pytest.raises(RuntimeError):
        ticket.result()
    assert acct.held == 0 and ticket._admitted == 0
    eng._release_admission(ticket)  # a second release is a no-op
    eng._release_admission(ticket)
    assert acct.held == 0 and acct.snapshot()["peak_bytes"] == _nbytes(req)


def test_concurrent_releases_free_each_ticket_once():
    """Threads racing to release the same tickets (a harvest and an
    abandonment, say) free each ticket's bytes exactly once: a double
    release would eat into the bytes another holder still holds."""
    import sys
    import threading

    plane = rm.BudgetPlane(1 << 20)
    acct = plane.account("coproc")
    eng = _engine(plane)
    filler = acct.try_acquire(1000)
    tickets = []
    for _ in range(200):
        t = engine_mod.Ticket(eng)
        t._admitted = acct.try_acquire(7)
        tickets.append(t)
    assert acct.held == filler + 1400
    go = threading.Barrier(16)

    def release_all():
        go.wait(timeout=10)
        for t in tickets:
            eng._release_admission(t)

    saved = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=release_all) for _ in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(saved)
    assert not any(th.is_alive() for th in threads)
    assert acct.held == filler and all(t._admitted == 0 for t in tickets)
    acct.release(filler)


def test_plane_less_engine_admits_everything_and_keeps_its_stats_keys():
    req = _port_request(_request(n_items=2, records=16, pad=40))
    bare, planed = _engine(), _engine(rm.BudgetPlane(1 << 20))
    for eng in (bare, planed):
        _enable(eng)
        eng.submit_group([req] * 3)[0].result()
    st_bare, st_planed = bare.stats(), planed.stats()
    assert "admission" not in st_bare and not any(k.startswith("n_shed") for k in st_bare)
    assert set(st_planed) == set(st_bare) | {"admission"}
    adm = st_planed["admission"]
    assert adm["subsystem"] == "coproc" and adm["admitted"] == 3 and adm["sheds"] == 0
    assert bare.governor.posture()["autotune"] is None
    assert planed.governor.posture()["autotune"] is None
    assert planed.governor._config["admission"] is True and bare.governor._config[
        "admission"] is False


# every lane the port has: (spec, engine knobs, request, the stat that shows the lane ran)
LANES = {
    "structural": (PROJ_SPEC, dict(structural_probe=False), "t_explode_find2"),
    "staged": (PROJ_SPEC, dict(structural_parse=False), "t_explode_find"),
    "pool_shards": (PROJ_SPEC, dict(host_workers=2, host_pool_probe=False), "n_sharded_launches"),
    "colcache_hit": (PROJ_SPEC, dict(device_column_cache_mb=1), "n_colcache_hit"),
    "payload": (PAYLOAD_SPEC, {}, "t_explode_ptrs"),
    "passthrough": (PASS_SPEC, {}, "n_frame_gather"),
    "mesh": (MESH_PROJ_SPEC, dict(mesh_probe=False, row_stride=256), "n_mesh_launches"),
    "host_plan": (identity(), {}, "t_explode"),
}


@pytest.mark.parametrize("lane", sorted(LANES))
def test_every_lane_reserves_sheds_and_releases(lane, monkeypatch):
    spec, kw, proof = LANES[lane]
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)
    if lane == "mesh":
        kw = dict(kw, mesh=partition_mesh(4, device="cpu"))
        req = _port_request(_mesh_request())
    else:
        req = _port_request(_request(n_items=4, records=16, pad=40))
    bare = _engine(**kw)
    _enable(bare, spec, topic="mesh" if lane == "mesh" else "bench")
    want = [_reply_bytes(bare.process_batch(req)) for _ in range(2)]
    plane = rm.BudgetPlane(1 << 22)
    acct = plane.account("coproc")
    eng = _engine(plane, **kw)
    _enable(eng, spec, topic="mesh" if lane == "mesh" else "bench")
    got = []
    for _ in range(2):  # the second submit is the cache-hit lane's hit
        tickets = eng.submit_group([req, req])
        assert acct.held == 2 * _nbytes(req) == sum(t._admitted for t in tickets)
        got.append(_reply_bytes(tickets[0].result()))
        assert acct.held == _nbytes(req)
        tickets[1].result()
        assert acct.held == 0
    assert got == want
    st = eng.stats()
    assert st.get(proof, 0) > 0, (lane, proof)
    # a full account sheds the whole group before the lane runs anything
    filler = acct.try_acquire(acct.limit - _nbytes(req) + 1)
    with pytest.raises(rm.ShedError):
        eng.submit_group([req])
    after = eng.stats()
    assert acct.held == filler and after["n_shed_submits"] == 1.0
    assert {k: v for k, v in after.items() if k.startswith(("t_", "bytes_", "n_kernel"))} == \
        {k: v for k, v in st.items() if k.startswith(("t_", "bytes_", "n_kernel"))}
    acct.release(filler)
    assert _reply_bytes(eng.submit(req).result()) == want[0] and acct.held == 0


def test_a_shed_group_releases_what_it_had_reserved():
    plane = rm.BudgetPlane(1 << 20)
    acct = plane.account("coproc")
    eng = _engine(plane)
    _enable(eng)
    small = _port_request(_request(n_items=1, records=4, pad=10))
    big = _port_request(_request(n_items=8, records=32, pad=900))
    filler = acct.try_acquire(acct.limit - _nbytes(small) - 10)
    with pytest.raises(rm.ShedError) as info:
        eng.submit_group([small, small, big])  # the first fits, the second not
    assert acct.held == filler and "staged bytes" in str(info.value)
    (entry,) = [e for e in governor.journal.entries(domain=governor.ADMISSION)
                if e["verdict"] == "shed"]
    assert entry["inputs"]["requested_bytes"] == _nbytes(small)
    acct.release(filler)
    assert eng.submit(small).result().items and acct.held == 0


def test_a_shed_episode_journals_once_and_zero_byte_submits_do_not_close_it():
    plane = rm.BudgetPlane(1 << 20)
    acct = plane.account("coproc")
    eng = _engine(plane)
    _enable(eng)
    req = _port_request(_request(n_items=2, records=16, pad=40))
    filler = acct.try_acquire(acct.limit)
    for _ in range(3):
        with pytest.raises(rm.ShedError):
            eng.submit(req)
    eng.submit(type(req)()).result()  # nothing to reserve: admitted, episode open
    acct.release(filler)
    eng.submit(req).result()
    verdicts = [e["verdict"] for e in reversed(governor.journal.entries(
        domain=governor.ADMISSION))]
    assert verdicts == ["critical", "shed", "ok", "resumed"]
    assert eng.stats()["n_shed_submits"] == 3.0 and acct.held == 0
    assert eng.stats()["admission"]["sheds"] == 3


def test_a_shed_never_moves_the_breaker_and_an_open_breaker_never_sheds():
    """The port's counterpart of tests/test_resource_mgmt.py's isolation
    test: an open dispatch breaker raises DeviceUnavailable into the
    policy where the JAX engine demotes to its host path, so the reply is
    empty here; admission admits it all the same and the bytes return,
    and a shed leaves the breaker's state alone."""
    plane = rm.BudgetPlane(1 << 20)
    acct = plane.account("coproc")
    eng = _engine(plane)
    _enable(eng)
    req = _port_request(_request(n_items=2, records=16, pad=40))
    breaker = eng.governor.breaker_for(faults.DEVICE_DISPATCH)
    for _ in range(100):
        breaker.record_failure()
    assert breaker.state == faults.STATE_OPEN
    ticket = eng.submit(req)  # admitted: the breaker does not shed
    assert acct.held == _nbytes(req)
    reply = ticket.result()
    assert all(not it.batches for it in reply.items) and acct.held == 0
    assert eng.stats()["n_failures_dispatch"] == 1 and "n_kernel_predicate" not in eng.stats()
    snap = breaker.snapshot()
    filler = acct.try_acquire(acct.limit)
    with pytest.raises(rm.ShedError):
        eng.submit(req)
    assert breaker.snapshot() == snap and acct.held == filler
    acct.release(filler)


def _arm(domain, count=None):
    honey_badger.enable()
    honey_badger.set_exception(faults.MODULE, domain, count=count)


def _failing(exc):
    def fn(*args, **kw):
        raise exc("the call itself is wrong")
    return fn


# the port's own raise paths: (engine knobs, how to arm it, harvest thread,
# what raises where: None (the error policy), "submit" or "result")
RAISE_PATHS = {
    "exhausted_dispatch_skip": ({}, lambda mp: _arm(faults.DEVICE_DISPATCH), False, None),
    "exhausted_dispatch_deregister": ({}, lambda mp: _arm(faults.DEVICE_DISPATCH), False, None),
    "exhausted_mask_fetch": ({}, lambda mp: _arm(faults.MASK_FETCH), False, None),
    "harvest_thread_copy_down": ({}, lambda mp: _arm(faults.HARVEST), True, None),
    "unretried_out_of_submit": ({}, lambda mp: mp.setattr(
        ColumnarPlan, "predicate", _failing(ValueError)), False, "submit"),
    "unretried_out_of_result": ({}, lambda mp: mp.setattr(
        engine_mod._Pending, "wait", _failing(AssertionError)), True, "result"),
    "pool_shard_degrades": (dict(host_workers=2, host_pool_probe=False),
                            lambda mp: _arm(faults.SHARD_WORKER, count=1), False, None),
    "pool_shard_unretried": (dict(host_workers=2, host_pool_probe=False), lambda mp: mp.setattr(
        ColumnarPlan, "predicate", _failing(TypeError)), False, "submit"),
    "exhausted_payload_fetch": (dict(spec=PAYLOAD_SPEC), lambda mp: _arm(faults.HARVEST), False,
                                None),
}


@pytest.mark.parametrize("case", sorted(RAISE_PATHS))
def test_every_raise_path_gives_the_bytes_back(case, monkeypatch):
    kw, arm, thread, raises = RAISE_PATHS[case]
    kw = dict(kw)
    spec = kw.pop("spec", PROJ_SPEC)
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)
    monkeypatch.setattr(TorchEngine, "_harvest_async", lambda self: thread)
    plane = rm.BudgetPlane(1 << 20)
    acct = plane.account("coproc")
    eng = _engine(plane, **kw)
    policy = ErrorPolicy.deregister if case.endswith("deregister") else ErrorPolicy.skip_on_failure
    _enable(eng, spec, policy)
    req = _port_request(_request(n_items=4, records=16, pad=40))
    arm(monkeypatch)
    if raises == "submit":
        with pytest.raises((ValueError, TypeError)):
            eng.submit_group([req, req])
    else:
        tickets = eng.submit_group([req, req])
        assert acct.held == 2 * _nbytes(req)
        if raises == "result":
            with pytest.raises(AssertionError):
                tickets[0].result()
            assert acct.held == _nbytes(req)
            with pytest.raises(AssertionError):
                tickets[1].result()
        else:
            replies = [t.result() for t in tickets]
            if case == "pool_shard_degrades":
                assert any(it.batches for it in replies[0].items)
                assert eng.stats()["n_failures_shard_worker"] == 1
            elif policy == ErrorPolicy.deregister:
                assert replies[0].deregistered == [1] and eng.heartbeat() == 0
            else:
                assert all(not it.batches for r in replies for it in r.items)
                assert any(k.startswith("n_failures") for k in eng.stats())
    assert acct.held == 0 and plane.pressure() == "ok"
    assert eng.stats()["admission"]["admitted"] == 2


# ------------------------------------------------------------------ pressure
def _pressure_requests():
    return [_port_request(_request(n_items=16, records=64, pad=250 + k)) for k in range(2)]


def test_pressure_trims_the_arena_and_the_cache_through_the_plane():
    """Occupancy pushed over 0.90 through another account of the plane (not
    by calling the listener): the arena is trimmed, the cache evicts to
    half its budget, the next submit of the evicted window misses and
    launches; back at ok the whole budget returns."""
    plane = rm.BudgetPlane(64 << 20)
    eng = _engine(plane, device_column_cache_mb=1)
    _enable(eng, PASS_SPEC)
    reqs = _pressure_requests()
    want = [_reply_bytes(eng.process_batch(r)) for r in reqs]  # two cold launches fill it
    cc = eng.stats()["colcache"]
    assert cc["entries"] == 2 and cc["bytes"] > cc["budget_bytes"] // 2
    assert eng.stats()["arena"]["free_buffers"] > 0
    storage = plane.account("storage")
    got = storage.try_acquire(int(storage.limit * 0.95))
    assert plane.pressure() == "critical"
    st = eng.stats()
    cc = st["colcache"]
    assert st["n_pressure_trims"] == 1 and st["n_pressure_evictions"] == 1
    assert cc["pressure"] is True and cc["entries"] == 1
    assert cc["effective_budget_bytes"] == cc["budget_bytes"] // 2
    assert cc["bytes"] <= cc["effective_budget_bytes"]
    assert st["arena"]["trims"] == 1 and st["arena"]["free_buffers"] == 0
    # the evicted (least recent) window misses and launches the predicate
    before = eng.stats()
    assert _reply_bytes(eng.process_batch(reqs[0])) == want[0]
    after = eng.stats()
    assert after["n_colcache_miss"] == before["n_colcache_miss"] + 1
    assert after["n_kernel_predicate"] == before["n_kernel_predicate"] + 1
    storage.release(got)
    assert plane.pressure() == "ok"
    cc = eng.stats()["colcache"]
    assert cc["pressure"] is False and cc["effective_budget_bytes"] == cc["budget_bytes"]
    entries = [e for e in reversed(governor.journal.entries(domain=governor.ADMISSION))]
    assert [e["verdict"] for e in entries] == ["critical", "ok"]
    assert entries[0]["reason"] == ("memory pressure critical: arena buffers freed "
                                    f"{entries[0]['inputs']['arena_freed']}, colcache entries "
                                    "evicted 1")
    assert entries[0]["inputs"]["account"] == "storage"
    assert entries[0]["inputs"]["max_occupancy"] == round(got / storage.limit, 4)


def test_an_evicted_entry_is_freed_at_once_with_worker_legs(monkeypatch):
    """The card's leg path (each attempt on a fetch worker, masks on the
    harvest thread): once the cache evicts an entry, nothing else holds its
    columns -- not an idle worker's last job -- so they are freed by the
    eviction itself, with no garbage collection (on the card: the CUDA
    tensors, so that memory_allocated falls at once)."""
    monkeypatch.setattr(TorchEngine, "_harvest_async", lambda self: True)
    plane = rm.BudgetPlane(64 << 20)
    eng = _engine(plane, device_column_cache_mb=1)
    eng._leg_deadlines = True
    _enable(eng, PASS_SPEC)
    for req in _pressure_requests():
        eng.process_batch(req)
    oldest = next(iter(eng._colcache._entries.values()))
    cols = [weakref.ref(c) for c in oldest.cols]
    del oldest
    assert all(c() is not None for c in cols)
    storage = plane.account("storage")
    got = storage.try_acquire(int(storage.limit * 0.95))
    assert eng.stats()["n_pressure_evictions"] == 1
    assert all(c() is None for c in cols)
    storage.release(got)


def test_an_idle_fetch_worker_keeps_nothing_of_its_last_leg():
    """A worker parked after a leg holds neither the leg nor its result:
    a leg's closure is what holds a cache entry's CUDA columns on the
    card, which eviction must free at once."""

    class Columns:
        pass

    cols = Columns()
    alive = weakref.ref(cols)
    assert faults.fetch_with_deadline(lambda c=cols: c is not None, 5.0) is True
    del cols
    assert alive() is None


def test_pressure_journal_matches_reference():
    """The same transitions through both packages' planes journal the same
    verdicts and reasons (the arena's and the cache's counts come from each
    engine's own state: none here)."""
    planes = rm.BudgetPlane(1 << 20), ref_budgets.BudgetPlane(1 << 20)
    port = _engine(planes[0])
    ref = TpuEngine(row_stride=ROW_STRIDE, budget_plane=planes[1], force_mode="columnar_host",
                    host_workers=0)
    try:
        for plane in planes:
            acct = plane.account("raft")
            for n in (int(acct.limit * 0.8), int(acct.limit * 0.15)):
                acct.try_acquire(n)
            acct.release(acct.held)
        got = _admission_entries(governor.journal, port.governor.engine_tag)
        assert got == _admission_entries(ref_governor.journal, ref.governor.engine_tag)
        assert [v for v, _, _ in got] == ["warn", "critical", "ok"]
        assert "n_pressure_trims" in port.stats() and port.stats()["n_pressure_trims"] == 1
    finally:
        ref.shutdown()


def test_a_dropped_engine_is_collected_and_shutdown_removes_its_listener():
    plane = rm.BudgetPlane(1 << 20)
    eng = TorchEngine(device="cpu", host_workers=0, budget_plane=plane)
    _enable(eng)
    eng.process_batch(_port_request(_request(n_items=2, records=16, pad=40)))
    ref = weakref.ref(eng)
    del eng
    gc.collect()
    assert ref() is None and len(plane._listeners) == 1
    acct = plane.account("storage")
    acct.try_acquire(acct.limit)  # the dead engine's listener is a no-op
    acct.release(acct.limit)
    assert plane.pressure() == "ok"
    live = _engine(plane)
    assert len(plane._listeners) == 2
    live.shutdown()
    live.shutdown()  # a second shutdown removes nothing more
    assert len(plane._listeners) == 1
    acct.try_acquire(acct.limit)
    assert "n_pressure_trims" not in live.stats()
    acct.release(acct.limit)


def test_admission_reasons_read_like_the_reference():
    """The ShedError text and the journal's reasons keep the reference's
    wording (operators grep them)."""
    exc = rm.ShedError("coproc", 250, "10 staged bytes")
    ref_exc = ref_rm.ShedError("coproc", 250, "10 staged bytes")
    assert str(exc) == str(ref_exc) and (exc.subsystem, exc.retry_after_ms) == ("coproc", 250)
    gov = governor.Governor(fault_policy=faults.FaultPolicy(), register_gauges=False,
                            journal_override=governor.DecisionJournal(16))
    gov.note_admitted("coproc")  # no episode open: nothing journaled
    gov.note_shed("coproc", 75, {"requested_bytes": 5})
    gov.note_shed("coproc", 80)
    gov.note_admitted("coproc")
    got = [(e["verdict"], e["reason"], e["inputs"]) for e in reversed(gov._journal.entries())]
    assert got == [
        ("shed", "coproc: admission shedding (retry after 75 ms)",
         {"subsystem": "coproc", "retry_after_ms": 75, "requested_bytes": 5}),
        ("resumed", "coproc: admission resumed", {"subsystem": "coproc"}),
    ]
