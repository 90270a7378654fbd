"""The port's leakwatch (redpanda_tpu_torch/coproc/leakwatch.py) against the
JAX package's, and the port's engine under it.

Off, ``wrap`` is the identity: a fresh budget plane holds raw accounts and a
fresh ``TorchEngine`` a raw arena and admission controller. On, the parity
workload matrix of tests/test_torch_lockwatch.py (tests/test_lockwatch.py's
engines, each with the budget plane, and the first one run as on a card)
goes through ``TorchEngine(device="cpu")`` with a one-shot and a persistent
fault on each coproc probe point, then the cancellation round of
tests/test_leakwatch.py runs against the plane's wrapped async vocabulary.
At the end every balance nets to zero, no imbalance fired, every observed
acquire site is a statement of pandalint's lifecycle model over
``redpanda_tpu_torch/`` and this file, and the clean replies are
byte-identical to ``TpuEngine``'s. The recorder itself is held to the JAX
package's on scripted sequences: the same balances, sites, imbalances and
adoptions.
"""

from __future__ import annotations

import ast
import asyncio
import os

import numpy as np
import pytest

from redpanda_tpu.coproc import TpuEngine
from redpanda_tpu.coproc import leakwatch as ref_leakwatch
from redpanda_tpu.finjector import honey_badger as ref_badger
from redpanda_tpu.resource_mgmt import budgets as ref_budgets
from redpanda_tpu_torch.coproc import batch_codec, faults, governor, leakwatch
from redpanda_tpu_torch.coproc import engine as engine_mod
from redpanda_tpu_torch.coproc.engine import TorchEngine
from redpanda_tpu_torch.finjector import honey_badger
from redpanda_tpu_torch.observability import probes
from redpanda_tpu_torch.resource_mgmt.admission import AdmissionController, InflightGate
from redpanda_tpu_torch.resource_mgmt.budgets import BudgetPlane, MemoryAccount
from test_lockwatch import _workload
from test_torch_faults import _disarm
from test_torch_lockwatch import MATRIX, PORT_DEADLINE_MS, PROBES, _enable, _knobs
from test_torch_structural import _port_request, _reply_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_FILES = ("redpanda_tpu_torch/coproc/", "redpanda_tpu_torch/resource_mgmt/")

_engines: list = []


@pytest.fixture(autouse=True)
def _quiet():
    """Both recorders, both honey badgers and the port's journal are
    process-global: every test starts and ends with them off and empty."""
    saved = (honey_badger.wedge_max_s, honey_badger.delay_ms)
    leakwatch.disable()
    leakwatch.reset()
    governor.reset_journal()
    yield
    leakwatch.disable()
    leakwatch.reset()
    ref_leakwatch.disable()
    _disarm(honey_badger)
    _disarm(ref_badger)
    honey_badger.wedge_max_s, honey_badger.delay_ms = saved
    governor.reset_journal()
    while _engines:
        _engines.pop().shutdown()


def static_model() -> dict[str, set[int]]:
    """pandalint's acquire-site model over redpanda_tpu_torch/ and this
    file (the cancellation round acquires here), read-only."""
    from tools.pandalint.engine import iter_python_files
    from tools.pandalint.lifecycle import model_sites

    paths = list(iter_python_files([os.path.join(REPO, "redpanda_tpu_torch")]))
    paths.append(os.path.abspath(__file__))
    mods = []
    for p in paths:
        rel = os.path.relpath(p, REPO).replace(os.sep, "/")
        with open(p, encoding="utf-8", errors="replace") as fh:
            mods.append((rel, ast.parse(fh.read())))
    return model_sites(mods)


async def _cancellation_round(plane: BudgetPlane) -> None:
    """tests/test_leakwatch.py's three cancellation shapes against the
    port's wrapped async vocabulary, each with its release discipline."""
    acct = plane.account("rpc")
    gate = leakwatch.wrap(InflightGate(acct, max_requests=8), "test.inflight_gate")

    async def held_with_finally(n: int) -> None:
        reserved = await acct.acquire(n)
        try:
            await asyncio.sleep(30)  # cancelled mid-hold
        finally:
            acct.release(reserved)

    # cancelled while suspended mid-hold: the finally releases
    t = asyncio.create_task(held_with_finally(4096))
    await asyncio.sleep(0.01)
    t.cancel()
    with pytest.raises(asyncio.CancelledError):
        await t

    # cancelled before its first step: the slot rides a done-callback
    async def handler(reserved: int) -> None:  # pragma: no cover - cancelled
        await asyncio.sleep(30)

    reserved = gate.try_enter(1024)
    assert reserved is not None
    t2 = asyncio.create_task(handler(reserved))
    t2.add_done_callback(lambda _t, g=gate, r=reserved: g.leave(r))
    t2.cancel()
    with pytest.raises(asyncio.CancelledError):
        await t2
    await asyncio.sleep(0)  # let the done-callback run

    # abandonment: the waiter gives up on a parked acquire
    filler = acct.try_acquire(acct.limit)
    waiter = asyncio.create_task(held_with_finally(1))
    await asyncio.sleep(0.01)
    waiter.cancel()
    with pytest.raises(asyncio.CancelledError):
        await waiter
    acct.release(filler)


def _ref_clean(req) -> list:
    engines = []
    try:
        plane = ref_budgets.BudgetPlane(total_bytes=256 * 1024 * 1024)
        out = []
        for spec, force_mode, workers in MATRIX:
            eng = TpuEngine(**_knobs(force_mode, workers), budget_plane=plane)
            engines.append(eng)
            _enable(eng, spec)
            out.append(_reply_bytes(eng.process_batch(req)))
        return out
    finally:
        for eng in engines:
            eng.shutdown()


@pytest.fixture
def chaos(monkeypatch) -> dict:
    """The matrix, its fault rounds and the cancellation round under the
    port's recorder."""
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 64)
    honey_badger.wedge_max_s, honey_badger.delay_ms = 0.12, 5
    req = _port_request(_workload())
    leakwatch.enable()
    try:
        plane = BudgetPlane(total_bytes=256 * 1024 * 1024)
        clean, engines = [], []
        for k, (spec, force_mode, workers) in enumerate(MATRIX):
            eng = TorchEngine(device="cpu", **_knobs(force_mode, workers, PORT_DEADLINE_MS),
                              budget_plane=plane)
            _engines.append(eng)
            engines.append(eng)
            assert isinstance(eng._arena, leakwatch.WatchedArena)
            if k == 0:  # as on a card: the harvest thread, legs on fetch workers
                eng._harvest_async = lambda: True
                eng._leg_deadlines = True
            _enable(eng, spec)
            clean.append(_reply_bytes(eng.process_batch(req)))
        honey_badger.enable()
        try:
            for probe in PROBES:
                for count in (1, None):
                    honey_badger.set_exception(faults.MODULE, probe, count=count)
                    try:
                        engines[0].process_batch(req)
                    finally:
                        honey_badger.unset(faults.MODULE, probe)
        finally:
            honey_badger.disable()
        asyncio.run(_cancellation_round(plane))
        return dict(clean=clean, stats=engines[0].stats(), balances=leakwatch.balances(),
                    snapshot=leakwatch.snapshot(), observed=leakwatch.acquire_sites(),
                    journal=governor.journal.entries(domain=governor.LEAKWATCH))
    finally:
        leakwatch.disable()


# ------------------------------------------------------------ off = free
def test_leakwatch_off_installs_no_proxy():
    assert not leakwatch.enabled()
    raw = MemoryAccount("probe", 1024)
    assert leakwatch.wrap(raw, "x") is raw
    plane = BudgetPlane(total_bytes=1 << 20)
    for name, acct in plane.accounts.items():
        assert type(acct) is MemoryAccount, name
    eng = TorchEngine(device="cpu", host_workers=0, budget_plane=plane)
    _engines.append(eng)
    assert type(eng._arena) is batch_codec.Arena
    assert type(eng._admission) is AdmissionController
    eng.reset_arenas()
    assert type(eng._arena) is batch_codec.Arena


def test_every_wrap_site_wraps_when_on():
    leakwatch.enable()
    try:
        plane = BudgetPlane(total_bytes=1 << 20)
        assert all(isinstance(a, leakwatch.WatchedAccount) for a in plane.accounts.values())
        assert plane.account("coproc")._lw_name == "account.coproc"
        eng = TorchEngine(device="cpu", host_workers=0, budget_plane=plane)
        _engines.append(eng)
        assert isinstance(eng._admission, leakwatch.WatchedAdmission)
        assert isinstance(eng._arena, leakwatch.WatchedArena)
        eng.reset_arenas()
        assert isinstance(eng._arena, leakwatch.WatchedArena)
        assert eng.stats()["leakwatch"]["enabled"] is True
    finally:
        leakwatch.disable()


# ------------------------------------------------------------ on = analyzer verified
def test_chaos_replies_match_the_reference(chaos):
    assert chaos["clean"] == _ref_clean(_workload())


def test_chaos_balances_net_to_zero(chaos):
    assert chaos["balances"], "the workload must drive wrapped acquisitions"
    assert {k: v for k, v in chaos["balances"].items() if v} == {}
    snap = chaos["snapshot"]
    assert snap["enabled"] is True and snap["imbalances"] == 0 and snap["outstanding"] == {}
    assert chaos["stats"]["leakwatch"]["imbalances"] == 0
    assert {"engine.arena", "engine.admission", "account.coproc", "account.rpc",
            "test.inflight_gate"} <= set(chaos["balances"])


def test_chaos_acquire_sites_are_in_the_static_model(chaos):
    observed = chaos["observed"]
    rels = {rel for rel, _ in observed}
    assert "redpanda_tpu_torch/coproc/engine.py" in rels
    assert all(rel.startswith(PORT_FILES) or rel == "tests/test_torch_leakwatch.py"
               for rel in rels), rels
    journaled = {e["inputs"]["site"] for e in chaos["journal"] if "site" in e["inputs"]}
    assert {f"{rel}:{ln}" for rel, ln in observed} <= journaled
    model = static_model()
    missing = sorted((rel, ln) for rel, ln in observed if ln not in model.get(rel, set()))
    assert not missing, f"acquire sites the static lifecycle model lacks: {missing}"


def _drive(mod, ops):
    """Feed ``ops`` to ``mod``'s recorder over a fresh account and arena,
    from one call site each; (balances, site counts, snapshot) with the
    sites reduced to their resource and direction."""
    mod.reset()
    mod.enable()
    try:
        acct = mod.wrap(MemoryAccount("a", 1 << 20), "account.a")
        arena = mod.wrap(batch_codec.Arena(), "engine.arena")
        bufs = []
        for op, n in ops:
            if op == "acq":
                acct.try_acquire(n)
            elif op == "rel":
                acct.release(n)
            elif op == "buf":
                bufs.append(arena.acquire(n))
            elif op == "put" and bufs:
                arena.release(bufs.pop())
            elif op == "adopt":
                arena.release(np.empty(n, np.uint8))  # a buffer the arena never issued
        snap = mod.snapshot()
        sites = sorted((name, acq, rel) for (name, _site), (acq, rel) in mod.sites().items())
        return mod.balances(), sites, {k: snap[k] for k in ("resources", "outstanding",
                                                              "imbalances")}
    finally:
        mod.disable()
        mod.reset()


OPS = {
    "balanced": [("acq", 100), ("acq", 50), ("rel", 100), ("rel", 50)],
    "leak": [("acq", 100), ("rel", 40)],
    "double_release": [("acq", 64), ("rel", 64), ("rel", 64)],
    "refused_grant": [("acq", 1 << 21), ("acq", 8), ("rel", 8)],
    "arena": [("buf", 256), ("buf", 512), ("put", 0), ("adopt", 128), ("put", 0)],
    "arena_leak": [("buf", 256), ("buf", 256), ("put", 0), ("adopt", 64)],
}


@pytest.mark.parametrize("case", sorted(OPS))
def test_recorder_matches_the_reference(case):
    assert _drive(leakwatch, OPS[case]) == _drive(ref_leakwatch, OPS[case])


def test_a_double_release_journals_one_imbalance_and_bumps_the_counter():
    before = probes.coproc_leakwatch_imbalance.value
    leakwatch.enable()
    try:
        acct = leakwatch.wrap(MemoryAccount("a", 1 << 20), "account.a")
        got = acct.try_acquire(64)
        acct.release(got)
        acct.release(got)
    finally:
        leakwatch.disable()
    assert probes.coproc_leakwatch_imbalance.value == before + 1
    assert leakwatch.snapshot()["imbalances"] == 1
    (entry,) = [e for e in governor.journal.entries(domain=governor.LEAKWATCH)
                if e["verdict"] == "imbalance"]
    assert entry["inputs"]["resource"] == "account.a" and entry["inputs"]["balance"] == -64
    assert entry["inputs"]["site"].startswith("tests/test_torch_leakwatch.py:")


def test_arena_adoption_is_ignored():
    leakwatch.enable()
    try:
        arena = leakwatch.wrap(batch_codec.Arena(), "engine.arena")
        buf = arena.acquire(1024)
        grown = np.empty(4096, np.uint8)  # a callee's replacement for the out= buffer
        arena.release(grown)
        assert leakwatch.balances() == {"engine.arena": 1}
        arena.release(buf)
    finally:
        leakwatch.disable()
    assert leakwatch.balances() == {"engine.arena": 0}
    assert leakwatch.snapshot()["imbalances"] == 0
    assert arena.stats() == arena._raw.stats()
