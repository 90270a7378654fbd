"""The port's decision plane (redpanda_tpu_torch/coproc/governor.py) against
the JAX package's, and the engine's journal and stats blocks.

Both governors are fed the same decisions, breaker sequences, injected
clocks and seeded device-leg samples (each package's own HdrHist), each
with a private journal and a fixed engine tag; their journal entries (all
but the wall-clock ``ts``), summaries, deadlines, envelope bounds and
snapshots must be equal, with no tolerance. The engine's adaptive choices
land in the port's process journal as the JAX engine's do.
"""

from __future__ import annotations

import gc

import numpy as np
import pytest

from redpanda_tpu.coproc import faults as ref_faults
from redpanda_tpu.coproc import governor as ref_governor
from redpanda_tpu.utils.hdr import HdrHist as RefHdrHist
from redpanda_tpu_torch.coproc import engine as engine_mod
from redpanda_tpu_torch.coproc import faults, governor
from redpanda_tpu_torch.coproc.engine import TorchEngine
from redpanda_tpu_torch.metrics import registry
from redpanda_tpu_torch.utils.hdr import HdrHist
from test_harvest_gather import _matrix_request
from test_structural_parse import PASS_SPEC, PROJ_SPEC, _request
from test_torch_structural import ROW_STRIDE, _port_request

PKGS = {"port": (governor, faults, HdrHist), "jax": (ref_governor, ref_faults, RefHdrHist)}

_engines: list[TorchEngine] = []


@pytest.fixture(autouse=True)
def _fresh_journal():
    governor.reset_journal()
    yield
    governor.reset_journal()
    while _engines:
        _engines.pop().shutdown()


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def _entries(journal, **kw):
    return [{k: v for k, v in e.items() if k != "ts"} for e in journal.entries(**kw)]


def _gov(pkg, floor_s=0.05, **kw):
    """A scratch governor of ``pkg`` with a private journal, injected
    histograms and a fake clock: (governor, journal, histograms, clock)."""
    gov_mod, faults_mod, hist = PKGS[pkg]
    hists = {d: hist() for d in gov_mod.BREAKER_DOMAINS}
    journal = gov_mod.DecisionJournal(capacity=64)
    clock = FakeClock()
    kw.setdefault("deadline_min_samples", 64)
    kw.setdefault("deadline_margin", 4.0)
    g = gov_mod.Governor(
        fault_policy=faults_mod.FaultPolicy(deadline_s=floor_s, retries=1),
        stage_hist=lambda d: hists[d], register_gauges=False, clock=clock,
        engine_tag="e", journal_override=journal, **kw)
    return g, journal, hists, clock


# ------------------------------------------------------------ decision journal
@pytest.mark.parametrize("capacity", [1, 4, 256])
def test_journal_ring_matches_reference(capacity):
    out = []
    for gov_mod in (governor, ref_governor):
        j = gov_mod.DecisionJournal(capacity=capacity)
        for i in range(10):
            j.append(["harvest_path", "host_pool"][i % 2], ["gather", "inline"][i % 3 % 2],
                     f"r{i}", {"i": i}, {"knob": i}, engine="e" if i % 4 else None)
        out.append((_entries(j), _entries(j, limit=3, domain="host_pool"), j.summary()))
    assert out[0] == out[1]
    assert out[0][2]["dropped"] == 10 - min(capacity, 10)


def test_domains_and_constants_match_reference():
    for name in ("DOMAINS", "BREAKER_DOMAINS", "DEADLINE_RECOMPUTE_SAMPLES",
                 "_DEADLINE_JOURNAL_DELTA", "_STATE_ENCODING"):
        assert getattr(governor, name) == getattr(ref_governor, name), name


def _decisions(pkg):
    g, journal, _, _ = _gov(pkg)
    g.set_config_snapshot({"device_deadline_ms": 50})
    g.update_config_snapshot(host_workers=4)
    got = [g.record_mode("harvest_path", "gather", "first"),
           g.record_mode("harvest_path", "gather", "same"),
           g.record_mode("harvest_path", "padded", "flip")]
    for _ in range(5):  # two scripts' alternating launches: once per script
        got.append(g.record_mode("harvest_path", "gather", "script 1", key=1))
        got.append(g.record_mode("harvest_path", "padded", "script 2", key=2))
    g.record("host_pool", "inline", "measured", {"speedup": 0.9})
    g.note_posture("parse_path", "structural")
    return got, _entries(journal), journal.summary(), g.posture()


def test_record_mode_and_posture_match_reference():
    port, ref = _decisions("port"), _decisions("jax")
    assert port == ref
    assert port[0] == [True, False, True, True, True] + [False] * 8 and len(port[1]) == 5
    assert port[3]["harvest_path"] == "padded" and port[3]["parse_path"] == "structural"


def test_breaker_transitions_journal_consistent_pairs():
    out = []
    for pkg in PKGS:
        g, journal, _, clock = _gov(pkg, breaker_threshold=1, breaker_cooldown_s=5.0)
        b = g.breaker_for(PKGS[pkg][1].DEVICE_DISPATCH)
        b.record_failure()
        clock.t += 6.0
        b.snapshot()  # the tick inside a snapshot: open -> half_open
        assert b.allow_device()
        b.record_success()
        out.append((_entries(journal, domain="breaker"), g.breakers_snapshot(),
                    g.aggregate_breaker_snapshot()))
    assert out[0] == out[1]
    pairs = [(e["inputs"]["from"], e["verdict"]) for e in reversed(out[0][0])]
    assert pairs == [("closed", "open"), ("open", "half_open"), ("half_open", "closed")]


def test_aggregate_breaker_snapshot_matches_reference():
    out = []
    for pkg in PKGS:
        g, _, _, clock = _gov(pkg, breaker_threshold=3, breaker_cooldown_s=5.0)
        f = PKGS[pkg][1]
        for _ in range(2):
            g.breaker_for(f.MASK_FETCH).record_failure()
        for _ in range(3):
            g.breaker_for(f.HARVEST).record_failure()
        snaps = [g.aggregate_breaker_snapshot()]
        clock.t += 5.0
        snaps.append(g.aggregate_breaker_snapshot())
        out.append(snaps)
    assert out[0] == out[1]
    assert out[0][0]["state"] == "open" and out[0][1]["state"] == "half_open"


def test_decision_counters_count_the_live_journal_only():
    key = 'coproc_governor_decisions_total{domain="sharded_seal",verdict="sharded"}'
    before = registry.snapshot().get(key, 0.0)
    live = governor.Governor(fault_policy=faults.FaultPolicy(), register_gauges=False)
    live.record("sharded_seal", "sharded", "test")
    live.record("sharded_seal", "sharded", "again")
    scratch, journal, _, _ = _gov("port")
    scratch.record("sharded_seal", "sharded", "private")
    assert registry.snapshot()[key] == before + 2
    assert len(governor.journal.entries()) == 2 and len(journal.entries()) == 1


# ------------------------------------------------------------ adaptive deadlines
def _samples(seed, n, scale_us):
    return np.random.default_rng(seed).exponential(scale_us, n).astype(np.int64) + 1


DEADLINE_CASES = {
    "below_min_samples": (dict(), [("dispatch", 20, 5_000_000)]),
    "tracks_p999": (dict(), [("dispatch", 1000, 8_000)]),
    "never_undercuts_floor": (dict(), [("harvest", 5000, 10)]),
    "caps_at_8x_floor": (dict(), [("dispatch", 1000, 60_000_000)]),
    "disabled": (dict(adaptive_deadline=False), [("dispatch", 1000, 30_000_000)]),
    "recomputes_after_new_samples": (dict(), [
        ("dispatch", 1000, 8_000), ("dispatch", 63, 100_000), ("dispatch", 1000, 30_000)]),
    "bound_is_monotonic": (dict(), [("harvest", 1000, 60_000_000), ("harvest", 5000, 10)]),
}

_DOMAIN = {"dispatch": "device_dispatch", "harvest": "harvest"}


def _deadlines(pkg, case):
    kw, steps = DEADLINE_CASES[case]
    g, journal, hists, _ = _gov(pkg, **kw)
    trace = []
    for i, (dom, n, scale) in enumerate(steps):
        domain = _DOMAIN[dom]
        for v in _samples(i, n, scale):
            hists[domain].record(int(v))
        trace.append((
            g.deadline_s(domain), g.policy_for(domain).deadline_s,
            g.policy_for(domain).envelope_s(), g.envelope_bound_s(domain),
            g.max_envelope_s(), g.breaker_for(domain).probe_timeout_s,
            {d: g.deadline_s(d) for d in PKGS[pkg][0].BREAKER_DOMAINS},
        ))
    return trace, _entries(journal), g.posture()["deadlines_ms"]


@pytest.mark.parametrize("case", sorted(DEADLINE_CASES))
def test_adaptive_deadlines_match_reference(case):
    port, ref = _deadlines("port", case), _deadlines("jax", case)
    assert port == ref
    first = port[0][0][0]
    floor = 0.05
    assert first >= floor and first <= 8 * floor
    if case == "caps_at_8x_floor":
        assert first == pytest.approx(8 * floor) and port[1][0]["verdict"] == "capped"
    if case == "tracks_p999":
        assert floor < first < 8 * floor and port[1][0]["verdict"] == "raised"
    if case in ("below_min_samples", "never_undercuts_floor", "disabled"):
        assert first == floor and port[1] == []
    if case == "bound_is_monotonic":
        assert port[0][1][3] == port[0][0][3] > faults.FaultPolicy(
            deadline_s=floor, retries=1).envelope_s()


def test_observe_leg_feeds_the_deadline_source():
    out = []
    for pkg in PKGS:
        g, _, hists, _ = _gov(pkg)
        d = PKGS[pkg][1].MASK_FETCH
        for _ in range(1000):
            g.observe_leg(d, 0.030)
        out.append((hists[d].count, g.deadline_s(d)))
    assert out[0] == out[1] and out[0][0] == 1000 and 0.1 <= out[0][1] <= 0.2


def test_default_source_is_the_success_only_leg_histogram():
    from redpanda_tpu_torch.observability import probes

    g = governor.Governor(fault_policy=faults.FaultPolicy(deadline_s=0.05, retries=1),
                          register_gauges=False, journal_override=governor.DecisionJournal())
    for domain in governor.BREAKER_DOMAINS:
        assert g._stage_hist(domain) is probes.coproc_device_leg_hist(domain).hist
        assert g._stage_hist(domain) is not probes.coproc_stage_hist("fetch").hist


def test_snapshot_matches_reference():
    out = []
    for pkg in PKGS:
        g, _, _, _ = _gov(pkg)
        g.record_mode("mesh", "single", "demoted", key="path")
        snap = g.snapshot()
        out.append(snap)
    assert out[0] == out[1]
    assert out[0]["posture"]["autotune"] is None and out[0]["journal"]["entries"] == 1


def test_gauges_hold_their_governor_weakly():
    g = governor.Governor(fault_policy=faults.FaultPolicy(),
                          journal_override=governor.DecisionJournal())
    g.breaker_for(faults.HARVEST).record_failure()
    key = 'coproc_breaker_state{domain="harvest"}'
    assert registry.snapshot()[key] == 0.0
    assert registry.snapshot()['coproc_governor_deadline_ms{domain="harvest"}'] == 30000.0
    del g
    gc.collect()
    assert registry.snapshot()[key] == -1.0


# ------------------------------------------------------------ the engine
def _engine(**kw):
    kw.setdefault("host_workers", 0)
    eng = TorchEngine(device="cpu", row_stride=ROW_STRIDE, **kw)
    _engines.append(eng)
    return eng


def test_stats_carry_the_breakers_and_the_governor():
    eng = _engine(breaker_threshold=3, breaker_cooldown_ms=1500, device_deadline_ms=2000)
    assert eng.enable_coprocessors([(1, PROJ_SPEC.to_json(), ("bench",))]) == [0]
    eng.process_batch(_port_request(_request(n_items=2, records=16, pad=40)))
    st = eng.stats()
    assert st["breaker"] == {"state": "closed", "consecutive_failures": 0, "trips": 0,
                             "threshold": 3, "cooldown_ms": 1500}
    assert sorted(st["breakers"]) == sorted(governor.BREAKER_DOMAINS)
    assert st["governor"]["posture"]["deadlines_ms"][faults.HARVEST] == 2000.0
    assert eng._breaker is eng.governor.breaker_for(faults.DEVICE_DISPATCH)
    assert eng._breaker.probe_timeout_s >= 2 * eng._fault_policy.envelope_s()
    (entry,) = governor.journal.entries(domain=governor.HARVEST_PATH)
    assert entry["config"]["breaker_threshold"] == 3 and entry["engine"] == \
        eng.governor.engine_tag


def test_fault_knobs_default_to_the_reference_engines():
    from redpanda_tpu.coproc.engine import TpuEngine

    ref = TpuEngine(host_workers=0)
    try:
        eng = _engine()
        fields = ("deadline_s", "retries", "backoff_s", "backoff_cap_s")
        assert [getattr(eng._fault_policy, f) for f in fields] == [
            getattr(ref._fault_policy, f) for f in fields]
        assert eng.governor._adaptive == ref.governor._adaptive
        assert eng.governor._margin == ref.governor._margin
        assert eng._breaker.snapshot() == ref._breaker.snapshot()
        assert eng._breaker.probe_timeout_s == ref._breaker.probe_timeout_s
    finally:
        ref.shutdown()


def test_journal_capacity_knob_sizes_the_process_journal():
    try:
        _engine(governor_journal_capacity=3)
        assert governor.journal.capacity == 3
    finally:
        governor.journal.configure(256)


def test_engine_journals_its_pool_parse_and_seal_decisions(monkeypatch):
    """The pool probe, the parse probe and the reply-wide seal journal their
    verdicts; pins are posture only."""
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)
    monkeypatch.setattr(engine_mod, "_PROBE_MIN_ROWS", 32)
    eng = _engine(host_workers=2, compress_threshold=64)
    assert eng.enable_coprocessors([(1, PASS_SPEC.to_json(), ("bench",))]) == [0]
    eng.process_batch(_port_request(_matrix_request(n_items=10, n_recs=48)))
    domains = {e["domain"]: e for e in governor.journal.entries()}
    assert domains["host_pool"]["verdict"] == eng.stats()["host_pool_probe"]["chosen"]
    assert domains["host_pool"]["inputs"]["recalibration"] is False
    assert domains["parse_path"]["verdict"] == eng.stats()["parse_path"]
    assert domains["harvest_path"]["verdict"] == "gather"
    posture = eng.stats()["governor"]["posture"]
    assert posture["host_pool"] == eng.stats()["host_pool_probe"]["chosen"]
    pinned = _engine(host_workers=2, host_pool_probe=False, structural_parse=False,
                     compress_threshold=64)
    assert pinned.enable_coprocessors([(1, PASS_SPEC.to_json(), ("bench",))]) == [0]
    governor.reset_journal()
    pinned.process_batch(_port_request(_matrix_request(n_items=10, n_recs=48)))
    p = pinned.stats()["governor"]["posture"]
    assert (p["host_pool"], p["parse_path"]) == ("sharded", "staged")
    assert {e["domain"] for e in governor.journal.entries()} == {"harvest_path",
                                                                 "sharded_seal"}
    assert governor.journal.entries(domain="sharded_seal")[0]["verdict"] == "sharded"


# ------------------------------------------------------------ launch-knob autotune
class _LegHist:
    """A device-leg histogram whose p99.9 and count the test sets."""

    def __init__(self):
        self.count = 0
        self._p = 0.0

    def percentile(self, q):
        return self._p

    def record(self, v):
        self.count += 1


def _autotune_gov(pkg, hist, pressure, **kw):
    """tests/test_resource_mgmt.py's autotune governor, of ``pkg``: a 1 s
    deadline floor, knobs 2/2 with caps 4/4, a 10 s hold."""
    gov_mod, faults_mod, _ = PKGS[pkg]
    clock = FakeClock()
    clock.t = 0.0
    g = gov_mod.Governor(
        fault_policy=faults_mod.FaultPolicy(deadline_s=1.0, retries=0, backoff_s=0.01),
        clock=clock, register_gauges=False, stage_hist=lambda domain: hist,
        engine_tag="e", journal_override=gov_mod.DecisionJournal(64))
    cfg = dict(enabled=True, group_ticks=2, group_ticks_cap=4, launch_depth=2,
               launch_depth_cap=4, hold_s=10.0, pressure_fn=lambda: pressure[0])
    cfg.update(kw)
    g.configure_autotune(**cfg)
    return g, clock


def _grow_hold_and_caps(pkg) -> tuple:
    hist, pressure = _LegHist(), [("ok", 0.1)]
    g, clock = _autotune_gov(pkg, hist, pressure)
    seen = [g.launch_knobs()]  # no device-leg evidence: the knobs hold
    hist.count, hist._p = 1000, 0.1 * 1e6  # cheap legs: grow one step a window
    seen.append(g.launch_knobs())
    pressure[0] = ("critical", 0.99)
    clock.t = 5.0  # inside the hold window nothing moves
    seen.append(g.launch_knobs())
    clock.t = 11.0  # window over: critical floors both knobs in one verdict
    seen.append(g.launch_knobs())
    pressure[0] = ("ok", 0.1)
    for i in range(6):
        clock.t = 22.0 + 11.0 * i
        seen.append(g.launch_knobs())
    pressure[0] = ("warn", 0.8)
    clock.t = 100.0
    seen.append(g.launch_knobs())
    return seen, _entries(g._journal, domain=PKGS[pkg][0].ADMISSION), g.autotune_snapshot(), \
        g.posture()["autotune"]


def test_autotune_grow_hold_and_caps_match_reference():
    out = {pkg: _grow_hold_and_caps(pkg) for pkg in PKGS}
    assert out["port"] == out["jax"]
    seen, entries, snap, posture = out["port"]
    k = lambda gt, ld: {"group_ticks": gt, "launch_depth": ld}  # noqa: E731
    assert seen[:4] == [k(2, 2), k(3, 3), k(3, 3), k(1, 1)]
    assert seen[-2] == k(4, 4) and seen[-1] == k(3, 3)  # capped, then a warn shrinks
    # the journal lists the newest entry first
    assert [e["verdict"] for e in entries] == ["shrink", "grow", "grow", "grow", "floor", "grow"]
    assert all("pressure" in e["inputs"] and "group_ticks" in e["inputs"] for e in entries)
    assert snap == posture == {"enabled": True, "group_ticks": 3, "group_ticks_cap": 4,
                               "launch_depth": 3, "launch_depth_cap": 4, "hold_s": 10.0}


def _latency_guard(pkg) -> tuple:
    hist, pressure = _LegHist(), [("ok", 0.1)]
    hist.count, hist._p = 1000, 0.9 * 1e6  # p99.9 0.9 s against a 1 s floor: shrink
    g, clock = _autotune_gov(pkg, hist, pressure)
    seen = [g.launch_knobs()]
    hist._p = 0.1 * 1e6  # a healthy tail again: grows back
    clock.t = 11.0
    seen.append(g.launch_knobs())
    hist._p = 0.6 * 1e6  # between the grow and shrink fractions: hold
    clock.t = 30.0
    seen.append(g.launch_knobs())
    return seen, _entries(g._journal)


def test_autotune_latency_guard_shrinks_match_reference():
    out = {pkg: _latency_guard(pkg) for pkg in PKGS}
    assert out["port"] == out["jax"]
    seen, entries = out["port"]
    assert seen == [{"group_ticks": 1, "launch_depth": 1}, {"group_ticks": 2, "launch_depth": 2},
                    {"group_ticks": 2, "launch_depth": 2}]
    assert [e["verdict"] for e in entries] == ["grow", "shrink"]  # newest first


def _unarmed_disabled_and_failing(pkg) -> tuple:
    gov_mod, faults_mod, _ = PKGS[pkg]
    hist = _LegHist()
    hist.count, hist._p = 1000, 0.1 * 1e6
    g = _gov(pkg, floor_s=1.0)[0]
    unarmed = (g.launch_knobs(), g.autotune_snapshot(), g.posture()["autotune"])
    off, _ = _autotune_gov(pkg, hist, [("critical", 1.0)], enabled=False)
    disabled = (off.launch_knobs(), off.autotune_snapshot()["enabled"], _entries(off._journal))

    def broken():
        raise RuntimeError("plane gone")

    bad, _ = _autotune_gov(pkg, hist, None, pressure_fn=broken)
    failing = (bad.launch_knobs(), [e["inputs"]["pressure"] for e in _entries(bad._journal)])
    return unarmed, disabled, failing


def test_autotune_unarmed_disabled_and_failing_pressure_match_reference():
    """Unarmed: the static 1/4 and no snapshot; disabled: the configured
    knobs whatever the inputs; a raising pressure source: counted as an
    ``autotune_pressure`` failure and the latency guard alone decides."""
    before = sum(v for k, v in registry.snapshot().items()
                 if k.startswith('coproc_failures_total{domain="autotune_pressure"'))
    out = {pkg: _unarmed_disabled_and_failing(pkg) for pkg in PKGS}
    assert out["port"] == out["jax"]
    unarmed, disabled, failing = out["port"]
    assert unarmed == ({"group_ticks": 1, "launch_depth": 4}, None, None)
    assert disabled == ({"group_ticks": 2, "launch_depth": 2}, False, [])
    assert failing == ({"group_ticks": 3, "launch_depth": 3}, ["ok"])
    after = sum(v for k, v in registry.snapshot().items()
                if k.startswith('coproc_failures_total{domain="autotune_pressure"'))
    assert after == before + 1


def test_pacemaker_backstop_derives_from_the_envelope_bounds():
    """tests/test_governor.py's backstop check: the pacemaker's tick
    deadline outwaits four times the largest envelope the governor has
    issued, in both packages, and follows an adaptive raise."""
    import types

    from redpanda_tpu.coproc.pacemaker import Pacemaker as RefPacemaker
    from redpanda_tpu_torch.coproc.pacemaker import Pacemaker

    out = {}
    for pkg, pm_cls in (("port", Pacemaker), ("jax", RefPacemaker)):
        g, _, hists, _ = _gov(pkg)
        eng = types.SimpleNamespace(governor=g)
        pm = pm_cls(object(), eng, tick_deadline_s=0.5)
        static = pm.tick_deadline_for(eng)
        for _ in range(1000):
            hists[PKGS[pkg][1].HARVEST].record(60_000_000)  # raise to the cap
        g.policy_for(PKGS[pkg][1].HARVEST)
        bound = g.envelope_bound_s(PKGS[pkg][1].HARVEST)
        raised = pm.tick_deadline_for(eng)
        assert g.max_envelope_s() >= bound
        assert static == max(0.5, 4.0 * g._policy.envelope_s())
        assert raised == max(0.5, 4.0 * g.max_envelope_s()) > static
        assert pm.tick_deadline_for(object()) == 0.5  # no governor: the static value
        out[pkg] = (static, raised)
    assert out["port"] == out["jax"]
