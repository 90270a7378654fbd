"""The port's fault envelope (redpanda_tpu_torch/coproc/faults.py) against
the JAX package's, and the engine's device legs under it.

The breaker, the policy's envelope and backoff, the retry loop and the
failure classification are fed the same call sequences and injected clocks
in both packages (the backoff's jitter from the same seed) and must answer
the same, with no tolerance. The engine runs on the CPU, where the plain
versions stand in for the kernels: a transient fault on each domain is
retried to the JAX package's inline reply, byte for byte; an exhausted
envelope or an open breaker ends in the script's error policy and launches
nothing; a build failure or a wrong call re-raises unretried; the mesh
domain's open breaker demotes a launch to the single lane.
"""

from __future__ import annotations

import random
import threading
import time

import numpy as np
import pytest

from redpanda_tpu.coproc import faults as ref_faults
from redpanda_tpu.finjector import ProbeTriggered as RefProbeTriggered
from redpanda_tpu.finjector import honey_badger as ref_badger
from redpanda_tpu.ops.transforms import Int, Str, filter_contains, filter_field_eq, map_project
from redpanda_tpu_torch import build, kernels, metrics
from redpanda_tpu_torch.coproc import engine as engine_mod
from redpanda_tpu_torch.coproc import faults, governor
from redpanda_tpu_torch.coproc.column_plan import ColumnarPlan
from redpanda_tpu_torch.coproc.engine import ErrorPolicy, TorchEngine
from redpanda_tpu_torch.finjector import ProbeTriggered, honey_badger
from redpanda_tpu_torch.observability import probes
from redpanda_tpu_torch.parallel.mesh import partition_mesh
from test_meshrunner import PROJ_SPEC as MESH_PROJ_SPEC
from test_meshrunner import _request as _mesh_request
from test_harvest_gather import _matrix_request
from test_structural_parse import PASS_SPEC, PROJ_SPEC, _request
from test_torch_structural import (
    ROW_STRIDE,
    _one_item,
    _payload_batches,
    _port_request,
    _ref_replies,
    _reply_bytes,
)

PAYLOAD_SPEC = filter_field_eq("level", "error") | map_project(Int("code"), Str("msg", 16))

_engines: list[TorchEngine] = []


def _disarm(badger) -> None:
    for module, armed in list(badger.armed().items()):
        for probe in armed:
            badger.unset(module, probe)
    badger.disable()


@pytest.fixture(autouse=True)
def _quiet_badgers():
    """Both honey badgers and the port's journal are process-global: every
    test starts and ends with them disarmed and empty, and its engines shut
    down."""
    saved = (honey_badger.wedge_max_s, honey_badger.delay_ms)
    governor.reset_journal()
    faults.reset_warned()
    yield
    _disarm(honey_badger)
    _disarm(ref_badger)
    honey_badger.wedge_max_s, honey_badger.delay_ms = saved
    governor.reset_journal()
    while _engines:
        _engines.pop().shutdown()


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


# ------------------------------------------------------------ circuit breaker
def _drive(mod, ops, **kw):
    """Run ``ops`` on a breaker of ``mod`` with a fake clock; the answers
    and the listener's transitions, in order."""
    clk = FakeClock()
    events = []
    b = mod.CircuitBreaker(clock=clk, listener=lambda *e: events.append(e), **kw)
    out = []
    for op, *arg in ops:
        if op == "tick":
            clk.t += arg[0]
        elif op == "fail":
            b.record_failure()
        elif op == "ok":
            b.record_success()
        elif op == "allow":
            out.append(("allow", b.allow_device()))
        elif op == "state":
            out.append(("state", b.state))
        elif op == "snap":
            out.append(("snap", b.snapshot()))
    out.append(("trips", b.trips))
    return out, events


BREAKER_CASES = {
    "trips_at_threshold": (dict(threshold=3, cooldown_s=30.0), [
        ("state",), ("fail",), ("fail",), ("state",), ("allow",), ("fail",), ("state",),
        ("allow",)]),
    "success_resets_the_count": (dict(threshold=2, cooldown_s=30.0),
                                 [("fail",), ("ok",)] * 5 + [("state",), ("snap",)]),
    "half_open_admits_one_probe": (dict(threshold=1, cooldown_s=10.0), [
        ("fail",), ("state",), ("tick", 9.9), ("allow",), ("tick", 0.2), ("state",),
        ("allow",), ("allow",), ("ok",), ("state",), ("allow",), ("allow",)]),
    "failed_probe_reopens": (dict(threshold=1, cooldown_s=10.0), [
        ("fail",), ("tick", 10.1), ("allow",), ("fail",), ("state",), ("allow",),
        ("tick", 10.1), ("allow",)]),
    "stale_probe_releases": (dict(threshold=1, cooldown_s=10.0, probe_timeout_s=25.0), [
        ("fail",), ("tick", 10.1), ("allow",), ("allow",), ("tick", 24.9), ("allow",),
        ("tick", 0.2), ("state",), ("allow",), ("ok",), ("state",)]),
    "named_snapshot": (dict(threshold=4, cooldown_s=1.5, name="harvest"), [
        ("fail",), ("snap",), ("fail",), ("fail",), ("fail",), ("snap",), ("tick", 1.5),
        ("snap",)]),
}


@pytest.mark.parametrize("case", sorted(BREAKER_CASES))
def test_breaker_matches_reference(case):
    kw, ops = BREAKER_CASES[case]
    assert _drive(faults, ops, **kw) == _drive(ref_faults, ops, **kw)


@pytest.mark.parametrize("seed", range(4))
def test_breaker_random_sequences_match_reference(seed):
    rng = np.random.default_rng(seed)
    ops = []
    for _ in range(200):
        k = int(rng.integers(0, 6))
        ops.append([("fail",), ("ok",), ("allow",), ("state",), ("snap",),
                    ("tick", float(rng.choice([0.5, 2.0, 5.0, 7.5])))][k])
    kw = dict(threshold=3, cooldown_s=5.0, probe_timeout_s=7.0, name="device_dispatch")
    got, want = _drive(faults, ops, **kw), _drive(ref_faults, ops, **kw)
    assert got == want
    assert any(e[2] == "open" for e in got[1])  # the sequence did trip


def test_breaker_snapshot_shape():
    b = faults.CircuitBreaker(threshold=4, cooldown_s=1.5)
    b.record_failure()
    assert b.snapshot() == {"state": "closed", "consecutive_failures": 1, "trips": 0,
                            "threshold": 4, "cooldown_ms": 1500}


# ------------------------------------------------------------ fault policy
@pytest.mark.parametrize("knobs", [
    (2.0, 2, 0.1, 0.15), (30.0, 2, 0.05, 2.0), (0.05, 5, 0.001, 0.004), (1.0, 0, 0.5, 2.0)])
def test_envelope_matches_reference(knobs):
    d, r, b, cap = knobs
    got = faults.FaultPolicy(deadline_s=d, retries=r, backoff_s=b, backoff_cap_s=cap)
    want = ref_faults.FaultPolicy(deadline_s=d, retries=r, backoff_s=b, backoff_cap_s=cap)
    assert got.envelope_s() == want.envelope_s()


@pytest.mark.parametrize("seed", range(3))
def test_backoff_matches_reference_on_one_seed(seed):
    """The port's jitter draws from the policy's own Random; the JAX
    package's from the module's: seeded alike, they give the same waits,
    each within 50-100% of its capped step."""
    pol = faults.FaultPolicy(deadline_s=1.0, retries=6, backoff_s=0.1, backoff_cap_s=0.5,
                             rng=random.Random(seed))
    ref = ref_faults.FaultPolicy(deadline_s=1.0, retries=6, backoff_s=0.1, backoff_cap_s=0.5)
    state = random.getstate()
    try:
        random.seed(seed)
        want = [ref.backoff(a) for a in range(7) for _ in range(5)]
    finally:
        random.setstate(state)
    got = [pol.backoff(a) for a in range(7) for _ in range(5)]
    assert got == want
    for i, d in enumerate(got):
        step = min(0.5, 0.1 * 2 ** (i // 5))
        assert 0.5 * step <= d <= step


def test_replaced_policy_shares_its_random():
    import dataclasses

    pol = faults.FaultPolicy(rng=random.Random(1))
    assert dataclasses.replace(pol, deadline_s=2.0).rng is pol.rng
    assert faults.FaultPolicy() == faults.FaultPolicy()  # the Random is not compared


# ------------------------------------------------------------ retry_call
def _flaky(n_fail, exc=RuntimeError):
    calls = []

    def fn():
        calls.append(1)
        if len(calls) <= n_fail:
            raise exc("blip")
        return "ok"

    return fn, calls


@pytest.mark.parametrize("n_fail", [0, 1, 2])
def test_retry_call_counts_match_reference(n_fail):
    out = []
    for mod in (faults, ref_faults):
        fn, calls = _flaky(n_fail)
        counted = []
        pol = mod.FaultPolicy(deadline_s=1.0, retries=2, backoff_s=0.001)
        got = mod.retry_call(fn, pol, "test", count=lambda k, v: counted.append((k, v)))
        out.append((got, len(calls), counted))
    assert out[0] == out[1] == ("ok", n_fail + 1, [("n_retries", 1.0)] * n_fail)


@pytest.mark.parametrize("mod", [faults, ref_faults], ids=["port", "jax"])
def test_retry_call_exhaustion_raises_the_last_error(mod):
    pol = mod.FaultPolicy(deadline_s=1.0, retries=1, backoff_s=0.001)
    fn, calls = _flaky(5, KeyError)
    with pytest.raises(KeyError):
        mod.retry_call(fn, pol, "test")
    assert len(calls) == 2


@pytest.mark.parametrize("exc", [AssertionError, NameError, build.BuildError, ValueError,
                                 TypeError])
def test_never_retried_failures_run_once_and_are_marked(exc):
    """The JAX package's programming errors, and the port's build failures
    and argument checks, are never retried; retry_call marks them."""
    fn, calls = _flaky(5, exc)
    pol = faults.FaultPolicy(deadline_s=1.0, retries=3, backoff_s=0.001)
    with pytest.raises(exc) as info:
        faults.retry_call(fn, pol, "test")
    assert len(calls) == 1 and faults.unretried(info.value)
    assert not faults.unretried(RuntimeError("device fault"))


def test_inline_retries_run_on_the_calling_thread():
    pol = faults.FaultPolicy(deadline_s=1e-6, retries=1, backoff_s=0.001)
    before = faults.fetch_pool_stats()["created"]
    assert faults.retry_call(threading.get_ident, pol, "test", inline=True) == threading.get_ident()
    assert faults.fetch_pool_stats()["created"] == before


# ----------------------------------------------- abandonable fetch workers
@pytest.mark.parametrize("mod", [faults, ref_faults], ids=["port", "jax"])
def test_fetch_with_deadline_result_exception_and_inline(mod):
    assert mod.fetch_with_deadline(lambda: 41 + 1, 5.0) == 42
    with pytest.raises(ValueError):
        mod.fetch_with_deadline(lambda: (_ for _ in ()).throw(ValueError("x")), 5.0)
    assert mod.fetch_with_deadline(threading.get_ident, None) == threading.get_ident()


@pytest.mark.parametrize("mod", [faults, ref_faults], ids=["port", "jax"])
def test_fetch_deadline_abandons_a_wedged_leg(mod):
    release = threading.Event()
    t0 = time.perf_counter()
    with pytest.raises(mod.DeadlineExceeded):
        mod.fetch_with_deadline(lambda: release.wait(5.0), 0.02)
    assert time.perf_counter() - t0 < 0.5
    release.set()


def test_late_completion_reclaims_its_worker():
    """A leg that completes after its caller gave up returns its worker to
    the free list: repeated late completions do not grow the threads."""
    before = faults.fetch_pool_stats()["created"]
    for _ in range(3):
        done = threading.Event()

        def late(done=done):
            time.sleep(0.03)
            done.set()
            return "stale"

        with pytest.raises(faults.DeadlineExceeded):
            faults.fetch_with_deadline(late, 0.005)
        assert done.wait(2.0)
        deadline = time.time() + 2.0
        while faults.fetch_pool_stats()["free"] == 0 and time.time() < deadline:
            time.sleep(0.002)
        assert faults.fetch_with_deadline(lambda: "fresh", 2.0) == "fresh"
    assert faults.fetch_pool_stats()["created"] - before <= 1


# ------------------------------------------------------ failure accounting
def test_domains_and_probes_match_reference():
    names = ("MODULE", "DEVICE_DISPATCH", "MASK_FETCH", "HARVEST", "SHARD_WORKER",
             "SANDBOX_COMPILE", "MESH_DISPATCH", "PROGRAMMING_ERRORS", "STATE_NUM")
    assert [getattr(faults, n) for n in names] == [getattr(ref_faults, n) for n in names]
    assert honey_badger.modules()["coproc"] == ref_badger.modules()["coproc"]


def test_kinds_match_reference():
    port = [faults.DeadlineExceeded("x"), ProbeTriggered("m.p"), ValueError("x"),
            faults.DeviceUnavailable("harvest"), KeyError("k")]
    ref = [ref_faults.DeadlineExceeded("x"), RefProbeTriggered("m.p"), ValueError("x"),
           None, KeyError("k")]
    assert [faults.kind_of(e) for e in port] == [
        ref_faults.kind_of(e) if e is not None else "DeviceUnavailable" for e in ref]


def test_note_failure_counts_every_failure_and_warns_once(caplog):
    ctr = probes.coproc_failure_counter("test_domain", "RuntimeError")
    v0 = ctr.value
    with caplog.at_level("WARNING", logger="rptorch.coproc.faults"):
        faults.note_failure("test_domain", RuntimeError("a"))
        faults.note_failure("test_domain", RuntimeError("b"))
    assert len([r for r in caplog.records if r.levelname == "WARNING"]) == 1
    assert ctr.value == v0 + 2


def test_note_failure_reraises_unretried_failures():
    with pytest.raises(AssertionError):
        faults.note_failure("test_domain", AssertionError("bug"), reraise_programming=True)
    assert probes.coproc_failure_counter("test_domain", "AssertionError").value >= 1
    marked = ValueError("wrong call")
    marked.rp_unretried = True
    with pytest.raises(ValueError):
        faults.note_failure("test_domain", marked, reraise_programming=True)
    # unmarked, a ValueError is a failure like another (a user's bad data)
    assert faults.note_failure("test_domain", ValueError("x"), reraise_programming=True) == \
        "ValueError"


# ------------------------------------------------------------ the engine
@pytest.fixture(params=[False, True], ids=["inline_legs", "worker_legs"])
def legs(request) -> bool:
    """Where the device legs run: inline on the calling thread, as on the
    CPU, or each attempt on an abandonable fetch worker under its deadline,
    as on a card. Every engine test runs both ways."""
    return request.param


def _engine(lane="inline", legs=False, **kw):
    kw.setdefault("retry_backoff_ms", 1)
    if lane == "pool":
        kw.update(host_workers=2, host_pool_probe=False)
    else:
        kw.setdefault("host_workers", 0)
    kw.setdefault("row_stride", ROW_STRIDE)
    eng = TorchEngine(device="cpu", **kw)
    eng._leg_deadlines = legs
    _engines.append(eng)
    return eng


def _failures_total() -> float:
    """coproc_failures_total summed over its domains and kinds."""
    return sum(v for k, v in metrics.registry.snapshot().items()
               if k.startswith("coproc_failures_total{"))


def _enable(eng, spec=PROJ_SPEC, policy=ErrorPolicy.skip_on_failure):
    assert eng.enable_coprocessors([(1, spec.to_json(), ("bench",), policy)]) == [0]


def _arm(domain, count=None):
    honey_badger.enable()
    honey_badger.set_exception(faults.MODULE, domain, count=count)


def _closed(st) -> bool:
    return all(b["state"] == "closed" for b in st["breakers"].values())


TRANSIENT = {
    "dispatch": (faults.DEVICE_DISPATCH, PROJ_SPEC, False),
    "mask_fetch": (faults.MASK_FETCH, PROJ_SPEC, False),
    "harvest_thread": (faults.HARVEST, PROJ_SPEC, True),
    "payload_dispatch": (faults.DEVICE_DISPATCH, PAYLOAD_SPEC, False),
    "payload_fetch": (faults.HARVEST, PAYLOAD_SPEC, False),
}


@pytest.mark.parametrize("case", sorted(TRANSIENT))
def test_a_transient_fault_is_retried_to_the_reference_reply(case, legs, monkeypatch):
    domain, spec, thread = TRANSIENT[case]
    monkeypatch.setattr(TorchEngine, "_harvest_async", lambda self: thread)
    req = (_one_item(_payload_batches()) if spec is PAYLOAD_SPEC
           else _request(n_items=4, records=16, pad=40))
    want = _ref_replies(spec.to_json(), [req])
    eng = _engine(legs=legs)
    _enable(eng, spec)
    _arm(domain, count=1)
    got = _reply_bytes(eng.process_batch(_port_request(req)))
    st = eng.stats()
    assert [got] == want and any(b for _, _, b in got[0])
    assert st["n_retries"] == 1 and _closed(st)
    assert not any(k.startswith("n_failures") for k in st)
    assert honey_badger.armed() == {}
    kernel = "n_kernel_payload_transform" if spec is PAYLOAD_SPEC else "n_kernel_predicate"
    assert st[kernel] == 1


def test_a_clean_run_counts_no_retry_and_journals_its_framing(legs):
    req = _request(n_items=4, records=16, pad=40)
    eng = _engine(legs=legs)
    _enable(eng)
    eng.process_batch(_port_request(req))
    st = eng.stats()
    assert "n_retries" not in st and _closed(st) and st["breaker"]["trips"] == 0
    (entry,) = governor.journal.entries(domain=governor.HARVEST_PATH)
    assert entry["verdict"] == "padded" and entry["inputs"]["script_id"] == 1


EXHAUSTED = {
    "dispatch": (faults.DEVICE_DISPATCH, False),
    "mask_fetch": (faults.MASK_FETCH, False),
    "harvest_thread": (faults.HARVEST, True),
}


@pytest.mark.parametrize("policy", ["skip_on_failure", "deregister"])
@pytest.mark.parametrize("case", sorted(EXHAUSTED))
def test_an_exhausted_envelope_ends_in_the_policy(case, policy, legs, monkeypatch):
    domain, thread = EXHAUSTED[case]
    monkeypatch.setattr(TorchEngine, "_harvest_async", lambda self: thread)
    eng = _engine(legs=legs)
    _enable(eng, policy=ErrorPolicy[policy])
    _arm(domain)
    total, mine = _failures_total(), probes.coproc_failure_counter(domain, "injected").value
    reply = eng.process_batch(_port_request(_request(n_items=4, records=16, pad=40)))
    st = eng.stats()
    # one failure, one sample: under the leg's domain, not again at the policy
    assert _failures_total() == total + 1
    assert probes.coproc_failure_counter(domain, "injected").value == mine + 1
    if policy == "deregister":
        assert reply.deregistered == [1] and eng.heartbeat() == 0 and reply.items == []
    else:
        assert reply.items and all(not it.batches for it in reply.items)
    assert st["n_retries"] == 2  # launch_retries' default
    assert st["breakers"][domain]["consecutive_failures"] == 1
    if domain == faults.DEVICE_DISPATCH:
        # the probe fires before the launch: no kernel ran
        assert st["n_failures_dispatch"] == 1 and "n_kernel_predicate" not in st
    else:
        assert st["n_failures_harvest"] == 1 and st["n_failures_rebuild"] == 1
        assert st["n_kernel_predicate"] == 1


@pytest.mark.parametrize("lane", ["inline", "pool"])
def test_an_open_breaker_fails_fast_and_its_half_open_probe_recloses(lane, legs, monkeypatch):
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)
    req = _request(n_items=4, records=16, pad=40)
    want = _ref_replies(PROJ_SPEC.to_json(), [req])[0]
    eng = _engine(lane, legs, breaker_threshold=2, breaker_cooldown_ms=40)
    _enable(eng)
    _arm(faults.DEVICE_DISPATCH)
    for _ in range(2):  # two exhausted launches open the breaker
        eng.process_batch(_port_request(req))
    assert eng.stats()["breakers"][faults.DEVICE_DISPATCH]["state"] == "open"
    _disarm(honey_badger)
    before = eng.stats()
    refused = probes.coproc_failure_counter("dispatch", "DeviceUnavailable").value
    reply = eng.process_batch(_port_request(req))  # refused: nothing runs
    st = eng.stats()
    assert all(not it.batches for it in reply.items)
    assert "n_kernel_predicate" not in st and st.get("t_explode_find2") == before.get(
        "t_explode_find2") and st.get("t_explode_find") == before.get("t_explode_find")
    assert st["n_failures_dispatch"] == before["n_failures_dispatch"] + 1
    assert probes.coproc_failure_counter("dispatch", "DeviceUnavailable").value == refused + 1
    time.sleep(0.05)  # the cooldown
    assert _reply_bytes(eng.process_batch(_port_request(req))) == want
    st = eng.stats()
    assert st["n_kernel_predicate"] == 1  # the half-open probe: one launch, inline
    assert st["breaker"] == dict(state="closed", consecutive_failures=0, trips=1,
                                 threshold=2, cooldown_ms=40)
    assert "n_sharded_launches" not in st
    pairs = [(e["inputs"]["from"], e["verdict"])
             for e in reversed(governor.journal.entries(domain=governor.BREAKER))]
    assert pairs == [("closed", "open"), ("open", "half_open"), ("half_open", "closed")]
    # closed again, the pool lane shards
    assert _reply_bytes(eng.process_batch(_port_request(req))) == want
    assert eng.stats().get("n_sharded_launches", 0) == (1 if lane == "pool" else 0)


def test_a_wedged_leg_raises_deadline_exceeded_into_the_policy():
    """On the CPU the legs run inline; with the card's deadlines turned on,
    a wedge past the deadline is abandoned on every attempt."""
    honey_badger.enable()
    honey_badger.wedge_max_s = 0.3
    eng = _engine(device_deadline_ms=20, launch_retries=1, adaptive_deadline=False)
    eng._leg_deadlines = True
    _enable(eng)
    honey_badger.set_wedge(faults.MODULE, faults.DEVICE_DISPATCH)
    deadline = probes.coproc_failure_counter(faults.DEVICE_DISPATCH, "deadline").value
    total = _failures_total()
    t0 = time.perf_counter()
    reply = eng.process_batch(_port_request(_request(n_items=2, records=16, pad=40)))
    wall = time.perf_counter() - t0
    _disarm(honey_badger)
    assert all(not it.batches for it in reply.items)
    assert wall < eng.governor.envelope_bound_s(faults.DEVICE_DISPATCH) + 0.2
    assert probes.coproc_failure_counter(faults.DEVICE_DISPATCH, "deadline").value == \
        deadline + 1
    assert _failures_total() == total + 1 and eng.stats()["n_failures_dispatch"] == 1
    assert eng.stats()["n_retries"] == 1


def test_a_faulted_shard_worker_degrades_the_launch(legs, monkeypatch):
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)
    req = _request(n_items=4, records=16, pad=40)
    eng = _engine("pool", legs)
    _enable(eng)
    _arm(faults.SHARD_WORKER, count=1)
    got = _reply_bytes(eng.process_batch(_port_request(req)))
    st = eng.stats()
    assert [got] == _ref_replies(PROJ_SPEC.to_json(), [req])
    assert st["n_failures_shard_worker"] == 1 and "n_sharded_launches" not in st
    assert "n_retries" not in st and _closed(st)


@pytest.mark.parametrize("exc", [build.BuildError, ValueError, TypeError, AssertionError])
def test_an_unretried_failure_reraises_out_of_submit_group(exc, legs, monkeypatch):
    calls = []

    def wrong(self, arrays, kernel=kernels.PREDICATE):
        calls.append(1)
        raise exc("the call itself is wrong")

    monkeypatch.setattr(ColumnarPlan, "predicate", wrong)
    eng = _engine(legs=legs)
    _enable(eng)
    with pytest.raises(exc):
        eng.submit(_port_request(_request(n_items=2, records=16, pad=40)))
    st = eng.stats()
    assert len(calls) == 1 and "n_retries" not in st and _closed(st)
    assert st["breakers"][faults.DEVICE_DISPATCH]["consecutive_failures"] == 0
    assert not any(k.startswith("n_failures") for k in st) and eng.heartbeat() == 1


def test_a_kernel_build_failure_reaches_the_caller_unretried(legs, monkeypatch, tmp_path):
    """The predicate's kernel fails to build (the compiler exits non-zero):
    the BuildError is raised to the caller of submit_group on the first
    attempt, with no breaker verdict and no error policy."""
    k = kernels.Kernel("predicate", "redpanda_tpu_torch/csrc/predicate.cu", "-",
                       "rp_predicate_blocks", [])
    builds = []

    def failing_nvcc():
        builds.append(1)
        return "false"  # a compiler that always fails

    monkeypatch.setattr(kernels, "nvcc", failing_nvcc)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(ColumnarPlan, "predicate",
                        lambda self, arrays, kernel=kernels.PREDICATE: k.launch())
    eng = _engine(legs=legs)
    _enable(eng)
    with pytest.raises(build.BuildError, match="building predicate failed"):
        eng.submit_group([_port_request(_request(n_items=2, records=16, pad=40))])
    st = eng.stats()
    assert len(builds) == 1 and "n_retries" not in st and eng.heartbeat() == 1
    assert st["breakers"][faults.DEVICE_DISPATCH]["consecutive_failures"] == 0


def test_a_missing_nvcc_is_a_build_error(monkeypatch):
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(kernels.os.path, "isfile", lambda p: False)
    monkeypatch.setattr(kernels.shutil, "which", lambda name: None)
    with pytest.raises(build.BuildError, match="nvcc not found") as info:
        kernels.nvcc()
    assert isinstance(info.value, RuntimeError)


def test_a_programming_error_on_the_harvest_thread_gets_no_verdict(legs, monkeypatch):
    """A bug between the probe site and the card is counted, reaches the
    caller and leaves the harvest breaker closed; the thread lives on."""
    monkeypatch.setattr(TorchEngine, "_harvest_async", lambda self: True)

    def buggy(self, engine):
        raise AssertionError("engine bug, not a device fault")

    monkeypatch.setattr(engine_mod._Pending, "wait", buggy)
    ctr = probes.coproc_failure_counter(faults.HARVEST, "AssertionError")
    v0 = ctr.value
    eng = _engine(legs=legs, breaker_threshold=1)
    _enable(eng)
    ticket = eng.submit(_port_request(_request(n_items=2, records=16, pad=40)))
    with pytest.raises(AssertionError):
        ticket.result()
    st = eng.stats()
    assert ctr.value == v0 + 1 and _closed(st) and eng._harvester.is_alive()
    assert "n_retries" not in st and "n_failures_rebuild" not in st


def test_the_mesh_breaker_demotes_launches_to_the_single_lane(legs):
    req = _mesh_request()
    spec_json = MESH_PROJ_SPEC.to_json()
    single = _engine(row_stride=256)
    single.enable_coprocessors([(1, spec_json, ("mesh",))])
    want = _reply_bytes(single.process_batch(_port_request(req)))
    eng = _engine(row_stride=256, legs=legs, mesh=partition_mesh(4, device="cpu"),
                  mesh_probe=False, breaker_threshold=1)
    eng.enable_coprocessors([(1, spec_json, ("mesh",))])
    _arm(faults.MESH_DISPATCH)
    total = _failures_total()
    first = eng.process_batch(_port_request(req))  # exhausted: the policy, breaker open
    assert all(not it.batches for it in first.items)
    assert _failures_total() == total + 1
    st = eng.stats()
    assert st["n_failures_dispatch"] == 1 and "n_mesh_launches" not in st
    assert st["breakers"][faults.MESH_DISPATCH]["state"] == "open"
    assert _reply_bytes(eng.process_batch(_port_request(req))) == want  # demoted
    st = eng.stats()
    assert st["mesh"]["demotions"] == 1 and st["n_kernel_predicate"] == 1
    assert st["breakers"][faults.DEVICE_DISPATCH]["state"] == "closed"
    (entry,) = governor.journal.entries(domain=governor.MESH)
    assert entry["verdict"] == "single"


def test_the_mesh_lane_journals_its_launches_and_feeds_device_rows(legs):
    req = _mesh_request()
    rows = [probes.coproc_mesh_device_rows(d).value for d in range(4)]
    eng = _engine(row_stride=256, legs=legs, mesh=partition_mesh(4, device="cpu"),
                  mesh_probe=False)
    eng.enable_coprocessors([(1, MESH_PROJ_SPEC.to_json(), ("mesh",))])
    for _ in range(2):
        eng.process_batch(_port_request(req))
    st = eng.stats()
    (entry,) = governor.journal.entries(domain=governor.MESH)
    assert entry["verdict"] == "mesh" and st["n_mesh_launches"] == 2
    got = [probes.coproc_mesh_device_rows(d).value - r for d, r in enumerate(rows)]
    assert got == st["mesh"]["rows_per_device"]


@pytest.mark.parametrize("spec", ["proj", "pass", "payload"])
def test_the_pool_probe_keeps_no_stats_on_worker_legs(spec, monkeypatch):
    """The pool probe's passes run their device legs on fetch workers, as on
    a card: the legs inherit the probing thread's quiet stats, so the probe
    leaves the engine's stats (kernel counts, dispatch and device times,
    link bytes) and its harvest thread alone."""
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)
    spec_json = {"proj": PROJ_SPEC.to_json(), "pass": PASS_SPEC.to_json(),
                 "payload": filter_contains(b"error").to_json()}[spec]
    eng = _engine("pool", True, compress_threshold=64)
    eng.enable_coprocessors([(1, spec_json, ("bench",))])
    batches = [b for it in _port_request(_matrix_request(n_items=10, n_recs=48)).items
               for b in it.batches]
    before = eng.stats()
    launch = engine_mod._Launch(eng, 1, ErrorPolicy.skip_on_failure, eng._plans[1])
    t_inline, t_sharded = eng._measure_pool_ratio(
        launch, batches, [b.header.record_count for b in batches])
    assert t_inline > 0 and t_sharded > 0
    after = eng.stats()
    after.pop("arena"), before.pop("arena")  # the framing arena counts its buffers
    assert after == before and eng._harvester is None


def test_a_leg_on_a_worker_times_its_hop(monkeypatch):
    """With the card's deadlines on, each leg that ran in one attempt adds
    its hand-off to the fetch worker and back to ``t_leg_hop``; inline legs
    add nothing."""
    monkeypatch.setattr(TorchEngine, "_harvest_async", lambda self: False)
    req = _port_request(_request(n_items=4, records=16, pad=40))
    for legs in (False, True):
        eng = _engine(legs=legs)
        _enable(eng)
        eng.process_batch(req)
        st = eng.stats()
        assert ("t_leg_hop" in st) is legs and st.get("t_leg_hop", 0.0) >= 0.0
