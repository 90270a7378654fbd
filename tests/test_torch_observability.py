"""The port's observability layer against the JAX package's: HdrHist
(utils/hdr.py), the metrics registry and its exposition (metrics.py), the
span tracer (observability/trace.py), the coproc probes and exemplars
(observability/probes.py) and the honey badger (finjector.py).

Each module of the port and its JAX-package counterpart get the same calls
on the same seeded values and must answer the same, with no tolerance (a
span's clock readings and a wall-clock stamp are left out of the
comparison).
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from redpanda_tpu import finjector as ref_finjector
from redpanda_tpu import metrics as ref_metrics
from redpanda_tpu.observability import probes as ref_probes
from redpanda_tpu.observability import trace as ref_trace
from redpanda_tpu.utils import hdr as ref_hdr
from redpanda_tpu_torch import finjector, metrics
from redpanda_tpu_torch.coproc import host_pool
from redpanda_tpu_torch.observability import probes, trace
from redpanda_tpu_torch.utils import hdr

_CLOCK_KEYS = ("start_us", "dur_us", "epoch", "wall_us", "ts")


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in _CLOCK_KEYS}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    return x


# ------------------------------------------------------------ HdrHist
DISTS = {
    "uniform": lambda rng: rng.integers(0, 2_000, 5_000),
    "lognormal": lambda rng: rng.lognormal(6.0, 2.0, 5_000).astype(np.int64),
    "small": lambda rng: rng.integers(0, 5, 300),
    "spiky": lambda rng: np.concatenate([np.full(990, 120), rng.integers(10**6, 10**8, 10)]),
}


@pytest.mark.parametrize("dist", sorted(DISTS))
def test_hdr_hist_matches_reference(dist):
    values = DISTS[dist](np.random.default_rng(5))
    out = []
    for mod in (hdr, ref_hdr):
        h = mod.HdrHist()
        assert h.percentile(50) == 0  # empty
        for v in values:
            h.record(int(v))
        out.append((h.count, h.sum, h.max, h.mean(), h.cumulative_buckets(),
                    [h.percentile(p) for p in (0, 1, 25, 50, 90, 99, 99.9, 100)]))
    assert out[0] == out[1]
    assert [mod._bucket_upper(mod._bucket_of(v)) for mod in (hdr,) for v in range(1, 300)] == \
        [ref_hdr._bucket_upper(ref_hdr._bucket_of(v)) for v in range(1, 300)]


# ------------------------------------------------------------ metrics
def _escaping(mod):
    reg = mod.MetricsRegistry()
    reg.counter("esc_total", "escaping", path='a"b', dir="c\\d", msg="x\ny").inc(3)
    reg.counter("multi_total", "line1\nline2 \\ slash", a="1").inc()
    reg.counter("multi_total", "line1\nline2 \\ slash", a="2").inc(2.5)
    return reg


def _gauges(mod):
    reg = mod.MetricsRegistry()
    state = {"v": 1.0}
    reg.gauge("live_value", lambda: state["v"], "sampled live")
    state["v"] = 7.5

    def boom() -> float:
        raise RuntimeError("scrape-time failure")

    reg.gauge("broken", boom, "raises", kind="x")
    return reg


def _histograms(mod):
    reg = mod.MetricsRegistry()
    h = reg.histogram("lat_us", "latency", op="x")
    for v in (1, 1, 5, 900):
        h.record(v)
    reg.histogram("stage_us", "per stage", stage="a").record(10)
    reg.histogram("stage_us", "per stage", stage="b").record(20)
    reg.histogram("stage_us", "per stage", stage="a").record(30)
    return reg


def _mixed(mod):
    reg = mod.MetricsRegistry()
    rng = np.random.default_rng(2)
    for i in range(40):
        kind = int(rng.integers(0, 3))
        labels = {"domain": f"d{int(rng.integers(0, 4))}"}
        if kind == 0:
            reg.counter("ops_total", "ops", **labels).inc(int(rng.integers(1, 9)))
        elif kind == 1:
            reg.histogram("leg_us", "legs", **labels).record(int(rng.integers(0, 10**6)))
        else:
            reg.gauge("depth", lambda i=i: float(i), "queue depth", **labels)
    return reg


REGISTRIES = {"escaping": _escaping, "gauges": _gauges, "histograms": _histograms,
              "mixed": _mixed}


@pytest.mark.parametrize("name", sorted(REGISTRIES))
def test_exposition_matches_reference(name):
    port, ref = REGISTRIES[name](metrics), REGISTRIES[name](ref_metrics)
    assert port.render_prometheus() == ref.render_prometheus()
    snap, ref_snap = port.snapshot(), ref.snapshot()
    nan = [k for k, v in ref_snap.items() if v is None]
    assert snap == ref_snap and all(snap[k] is None for k in nan)
    assert sorted(port.histograms()) == sorted(ref.histograms())


def test_series_keys_and_prefix_match_reference():
    labels = (("domain", 'a"b'), ("kind", "x\ny"))
    assert metrics.series_key("n", labels) == ref_metrics.series_key("n", labels)
    assert metrics.series_key("n") == ref_metrics.series_key("n") == "n"
    assert metrics.PREFIX == ref_metrics.PREFIX


def test_counter_increments_are_not_lost_across_threads():
    c = metrics.MetricsRegistry().counter("race_total", "race")

    def work():
        for _ in range(2000):
            c.inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10.0)
    assert not any(t.is_alive() for t in threads) and c.value == 16000


# ------------------------------------------------------------ tracer
def _spans(mod):
    tr = mod.Tracer(enabled=True, capacity=64, slow_threshold_ms=0.0)
    with tr.span("mid.noop") as s:  # no ambient trace: a no-op
        assert s.trace_id is None
    with tr.span("coproc.tick", root=True) as root:
        root.set("bytes", 10)
        with tr.span("coproc.dispatch") as child:
            child.set("queue_us", 5)
            assert tr.current_trace() == root.trace_id
        with tr.detached():
            with tr.span("detached.noop") as d:
                assert d.trace_id is None
        tid = root.trace_id
    tr.record("coproc.device_harvest", 125.0, tid, start_perf=time.perf_counter(),
              device_us=120)
    tr.record("orphan", 1.0, None)  # no trace id: not recorded
    with tr.span("coproc.harvest", trace_id=tid):
        pass
    with tr.span("explicit.none", trace_id=None) as n:
        assert n.trace_id is None
    off = mod.Tracer(enabled=False)
    assert off.span("x", root=True).trace_id is None and off.current_trace() is None
    return (tr.spans_recorded, _strip(tr.recent()), _strip(tr.slow()),
            _strip(tr.spans_for(tid)))


def test_tracer_matches_reference():
    port, ref = _spans(trace), _spans(ref_trace)
    assert port == ref
    names = [s["name"] for s in port[3]]
    assert sorted(names) == ["coproc.device_harvest", "coproc.dispatch", "coproc.harvest",
                             "coproc.tick"]


def test_tracer_reconfigure_and_reset_match_reference():
    out = []
    for mod in (trace, ref_trace):
        tr = mod.Tracer(enabled=True, capacity=4, slow_threshold_ms=1e9)
        for i in range(6):
            with tr.span(f"s{i}", root=True):
                pass
        tr.configure(capacity=2, slow_threshold_ms=0.0)
        kept = [s["name"] for t in tr.recent() for s in t["spans"]]
        tr.reset()
        out.append((kept, tr.recent(), tr.slow(), tr.spans_recorded, tr.slow_threshold_us))
    assert out[0] == out[1] and out[0][0] == ["s5", "s4"]


# ------------------------------------------------------------ probes
def test_coproc_series_match_reference():
    pairs = [
        (probes.coproc_failure_counter("harvest", "deadline"),
         ref_probes.coproc_failure_counter("harvest", "deadline")),
        (probes.coproc_mesh_device_rows(3), ref_probes.coproc_mesh_device_rows(3)),
        (probes.coproc_device_leg_hist("mask_fetch"), ref_probes.coproc_device_leg_hist(
            "mask_fetch")),
        (probes.coproc_stage_hist("dispatch"), ref_probes.coproc_stage_hist("dispatch")),
        (probes.coproc_breaker_trips, ref_probes.coproc_breaker_trips),
        (probes.coproc_retries_total, ref_probes.coproc_retries_total),
        (probes.coproc_host_pool_busy, ref_probes.coproc_host_pool_busy),
    ]
    for got, want in pairs:  # the help texts may name the card
        assert (got.name, got.labels) == (want.name, want.labels)
    assert probes.coproc_stage_hist("dispatch") is probes.coproc_stage_hist("dispatch")


def _exemplars(mod, metrics_mod):
    hist = metrics_mod.Histogram("exemplar_probe_us", "probe", labels=(("op", "x"),))
    mod.arm_exemplar_threshold(hist, 1000)
    rng = np.random.default_rng(4)
    for i in range(40):
        mod.record_us(hist, int(rng.integers(0, 3000)), trace_id=100 + i)
    mod.record_us(hist, 5000)  # no trace id and no ambient trace: no exemplar
    key = metrics_mod.series_key(hist.name, hist.labels)
    got = _strip(mod.exemplars_for(key))
    mod.disarm_exemplar_threshold(hist)
    mod.record_us(hist, 9999, trace_id=1)  # disarmed, tracer off: no exemplar
    after = len(mod.exemplars_for(key))
    mod.reset_exemplars()
    return got, after, hist.hist.count, mod.exemplars_for(key)


def test_exemplars_match_reference():
    port, ref = _exemplars(probes, metrics), _exemplars(ref_probes, ref_metrics)
    assert port == ref
    assert len(port[0]) == 16 and port[1] == 16 and port[2] == 42 and port[3] == []
    assert all(e["value_us"] >= 1000 and e["bucket_us"] >= e["value_us"] for e in port[0])


def test_pool_tasks_are_counted_busy_while_they_run():
    pool = host_pool.HostStagePool(3)
    gate = threading.Barrier(3, timeout=5.0)

    def task():
        gate.wait()  # all three running at once
        busy = probes.coproc_host_pool_busy.fn()
        gate.wait()  # and none ends before every one has read
        return busy

    try:
        base = probes.coproc_host_pool_busy.fn()
        assert pool.run([task] * 3) == [base + 3] * 3
        assert probes.coproc_host_pool_busy.fn() == base
        assert pool.run([lambda: probes.coproc_host_pool_busy.fn()]) == [base + 1]
    finally:
        pool.shutdown()


# ------------------------------------------------------------ honey badger
def _claims(mod):
    hb = mod.HoneyBadger()
    out = []

    def fire(module, probe):
        try:
            hb.inject_sync(module, probe)
            return "-"
        except mod.ProbeTriggered as exc:
            return f"raised {exc}"
        except SystemExit:
            return "exit"

    hb.register_probe("coproc", "device_dispatch", "harvest")
    hb.set_exception("coproc", "device_dispatch")  # disabled: arming is a no-op
    out.append((hb.armed(), fire("coproc", "device_dispatch")))
    hb.enable()
    hb.set_exception("coproc", "device_dispatch", count=2)
    hb.set_termination("coproc", "harvest")
    out.append((hb.armed(), hb.armed_counts(), hb.remaining("coproc", "device_dispatch")))
    out.append([fire("coproc", "device_dispatch") for _ in range(3)])
    out.append((fire("coproc", "harvest"), hb.armed(), hb.armed_counts()))
    hb.set_corrupt("coproc", "harvest", count=1)
    out.append((hb.corrupt_claim("coproc", "device_dispatch"),
                hb.corrupt_claim("coproc", "harvest"), hb.corrupt_claim("coproc", "harvest")))
    hb.unset("nope", "typo")  # no phantom module
    hb.set_exception("coproc", "harvest", count=1)
    hb.set_exception("coproc", "harvest")  # re-armed without a count: unlimited
    out.append((hb.modules(), hb.remaining("coproc", "harvest"),
                [fire("coproc", "harvest") for _ in range(2)]))
    hb.disable()
    out.append((hb.armed(), hb.enabled))
    return out


def test_honey_badger_claims_match_reference():
    assert _claims(finjector) == _claims(ref_finjector)


def test_delay_and_one_shot_wedge_match_reference():
    out = []
    for mod in (finjector, ref_finjector):
        hb = mod.HoneyBadger()
        hb.enable()
        hb.delay_ms = 20
        hb.wedge_max_s = 0.05
        hb.set_delay("m", "p", count=1)
        hb.set_wedge("m", "w", count=1)
        times = []
        for probe in ("p", "p", "w", "w"):
            t0 = time.perf_counter()
            hb.inject_sync("m", probe)
            times.append(time.perf_counter() - t0)
        out.append(([t >= 0.015 for t in times], hb.armed()))
    assert out[0] == out[1] == ([True, False, True, False], {})


def test_counted_claims_are_exact_under_concurrency():
    hb = finjector.HoneyBadger()
    hb.enable()
    hb.set_exception("coproc", "shard_worker", count=3)
    fired = []
    start = threading.Barrier(8, timeout=5.0)

    def site():
        start.wait()
        for _ in range(4):
            try:
                hb.inject_sync("coproc", "shard_worker")
            except finjector.ProbeTriggered:
                fired.append(1)

    threads = [threading.Thread(target=site) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=5.0)
    assert not any(t.is_alive() for t in threads)
    assert len(fired) == 3 and hb.armed() == {}


def test_async_probe_consumes_like_the_reference():
    import asyncio

    out = []
    for mod in (finjector, ref_finjector):
        hb = mod.HoneyBadger()
        hb.enable()
        hb.set_exception("rpc", "send", count=1)
        got = []

        async def main(hb=hb, mod=mod, got=got):
            for _ in range(2):
                try:
                    await hb.maybe_inject("rpc", "send")
                    got.append("-")
                except mod.ProbeTriggered:
                    got.append("raised")

        asyncio.run(main())
        out.append((got, hb.armed()))
    assert out[0] == out[1] == (["raised", "-"], {})
