"""The port's probes over the metrics registry (the JAX package's
observability/probes.py, its coproc series: the fault domains, the device
legs, the engine's stages, the host-stage pool and the mesh; its two
storage series: the log's append and the manager's housekeeping; raft's
replicate and the internal rpc round trip; and the Kafka front door's
produce and fetch latencies).

Unlike the tracer (trace.py) these are always on: a histogram record is a
dict lookup plus integer bucket math. The series names are the JAX
package's, so a scrape of the port reads like its scrape:
``coproc_stage_latency_us{stage=...}`` for the engine's per-stage
breakdown, ``coproc_device_leg_latency_us{domain=...}`` for successful
device legs (the adaptive deadline's source),
``coproc_failures_total{domain,kind}`` for classified failures.
"""

from __future__ import annotations

import collections
import threading
import time
import weakref

from redpanda_tpu_torch.metrics import Counter, Histogram, registry, series_key
from redpanda_tpu_torch.observability.trace import tracer
from redpanda_tpu_torch.utils.hdr import _bucket_of, _bucket_upper

# ------------------------------------------------------------ broker path
# the storage layer's two series (storage/log.py, storage/log_manager.py),
# the raft and rpc series (raft/consensus.py, rpc/transport.py) and the
# Kafka front door's two (kafka/server/protocol.py)
storage_append_hist = registry.histogram(
    "storage_append_latency_us", "Storage log append latency (us)"
)
storage_housekeeping_hist = registry.histogram(
    "storage_housekeeping_latency_us",
    "One compaction/retention housekeeping pass over a log (us)",
)
raft_replicate_hist = registry.histogram(
    "raft_replicate_latency_us",
    "Raft replicate() to the requested consistency level (us)",
)
# Recorded at the kafka dispatch layer (server/protocol.py _dispatch), so
# one request is one sample — handler wrappers must NOT record these too.
kafka_produce_hist = registry.histogram(
    "kafka_produce_latency_us", "Produce handler latency (microseconds)"
)
kafka_fetch_hist = registry.histogram(
    "kafka_fetch_latency_us",
    "Fetch handler latency incl. long-poll wait (microseconds)",
)
rpc_request_hist = registry.histogram(
    "rpc_request_latency_us", "Internal RPC round-trip latency (us)"
)

# ------------------------------------------------------ multi-chip meshrunner
# per-device record counters, created lazily per mesh device index so the
# series set matches the mesh actually built (locked check-then-create,
# same rationale as coproc_failure_counter)
_mesh_device_rows: dict[int, Counter] = {}
_mesh_device_lock = threading.Lock()


def coproc_mesh_device_rows(device: int) -> Counter:
    c = _mesh_device_rows.get(device)
    if c is None:
        with _mesh_device_lock:
            c = _mesh_device_rows.get(device)
            if c is None:
                c = registry.counter(
                    "coproc_mesh_device_rows_total",
                    "Records dispatched to each mesh device shard",
                    device=str(device),
                )
                _mesh_device_rows[device] = c
    return c


# -------------------------------------------------------- coproc fault domains
# Classified failure counter, one series per (fault domain, exception kind):
# every failure the engine routes into an error policy reports here.
# Locked check-then-create: an unlocked one could register one Counter in
# the registry while caching a twin here, and the exported series would
# then stay frozen.
_failure_counters: dict[tuple[str, str], Counter] = {}
_failure_lock = threading.Lock()


def coproc_failure_counter(domain: str, kind: str) -> Counter:
    key = (domain, kind)
    c = _failure_counters.get(key)
    if c is None:
        with _failure_lock:
            c = _failure_counters.get(key)
            if c is None:
                c = registry.counter(
                    "coproc_failures_total",
                    "Classified coproc failures by fault domain",
                    domain=domain,
                    kind=kind,
                )
                _failure_counters[key] = c
    return c


coproc_breaker_trips = registry.counter(
    "coproc_breaker_trips_total",
    "Device circuit breaker transitions to open",
)
coproc_retries_total = registry.counter(
    "coproc_device_retries_total",
    "Device interaction retry attempts (deadline/launch failures)",
)
coproc_lockwatch_edges = registry.counter(
    "coproc_lockwatch_edges_total",
    "Distinct lock-order edges observed by the coproc_lockwatch recorder",
)
coproc_leakwatch_imbalance = registry.counter(
    "coproc_leakwatch_imbalance_total",
    "Resource balances driven negative under the coproc_leakwatch recorder",
)

# ------------------------------------------------------ host-stage pool
# Busy-worker gauge for the coproc host-stage pool (coproc/host_pool.py).
# The counter lives here, not on the pool: the gauge is registered once per
# process while pools are per engine. inc/dec under a lock: += on an int is
# a read-modify-write and worker threads race it.
_host_pool_busy = 0
_host_pool_lock = threading.Lock()


def host_pool_task_started() -> None:
    global _host_pool_busy
    with _host_pool_lock:
        _host_pool_busy += 1


def host_pool_task_finished() -> None:
    global _host_pool_busy
    with _host_pool_lock:
        _host_pool_busy -= 1


coproc_host_pool_busy = registry.gauge(
    "coproc_host_pool_busy_workers",
    lambda: float(_host_pool_busy),
    "Host-stage pool workers currently running a shard task",
)

# Success-only device-leg latency per fault domain: the adaptive deadline's
# source (governor.observe_leg records a sample only when a leg completes;
# abandoned or failed attempts contribute nothing, so a burst of timeouts
# cannot inflate the tail the next deadline derives from).
_device_leg: dict[str, Histogram] = {}
_device_leg_lock = threading.Lock()


def coproc_device_leg_hist(domain: str) -> Histogram:
    """Histogram for one fault domain's successful device legs. Locked
    check-then-create; callers serialize record() themselves (the governor
    records under its own lock)."""
    h = _device_leg.get(domain)
    if h is None:
        with _device_leg_lock:
            h = _device_leg.get(domain)
            if h is None:
                h = registry.histogram(
                    "coproc_device_leg_latency_us",
                    "Successful device-leg wall time per fault domain "
                    "(adaptive-deadline source; success-only)",
                    domain=domain,
                )
                _device_leg[domain] = h
    return h


_coproc_stage: dict[str, Histogram] = {}
_coproc_stage_lock = threading.Lock()


def coproc_stage_hist(stage: str) -> Histogram:
    """Histogram for one engine stage (explode/pack/dispatch/fetch/...).
    Locked creation, as above. Callers serialize record() themselves (the
    engine records under its stats lock; HdrHist's read-modify-write is not
    thread-safe)."""
    h = _coproc_stage.get(stage)
    if h is None:
        with _coproc_stage_lock:
            h = _coproc_stage.get(stage)
            if h is None:
                h = registry.histogram(
                    "coproc_stage_latency_us",
                    "Coproc engine per-stage wall time (us)",
                    stage=stage,
                )
                _coproc_stage[stage] = h
    return h


# ------------------------------------------------------------ trace exemplars
# When a histogram observation lands at or over its breach threshold, the
# ambient trace id is recorded beside the bucket it fell into, so a slow
# bucket links to the trace that filled it. A histogram with no armed
# threshold falls back to the tracer's slow threshold; with the tracer off
# the whole layer is one dict lookup and a compare per observation.
_EXEMPLAR_CAP = 16  # newest-first ring per series

_exemplar_lock = threading.Lock()
# id(hist) -> threshold_us armed for it
_exemplar_thresholds: dict[int, float] = {}
# series key -> deque of {"trace_id", "value_us", "bucket_us", "ts"}
_exemplars: dict[str, collections.deque] = {}
# ids that already have a deallocation finalizer: kept apart from the
# thresholds, which disarm/reset clear while the finalizer lives as long as
# the histogram (one finalizer per object lifetime, not per arm)
_exemplar_finalized: set[int] = set()


def _drop_exemplar_threshold(key: int) -> None:
    with _exemplar_lock:
        _exemplar_thresholds.pop(key, None)
        # the object is being deallocated: a future histogram at this
        # address is a different object and gets its own finalizer
        _exemplar_finalized.discard(key)


def arm_exemplar_threshold(hist: Histogram, threshold_us: float) -> None:
    """Arm a per-histogram breach threshold: observations at or over it
    record the ambient trace id. Keyed by id(hist); the finalizer drops the
    entry when the histogram is collected, so a histogram allocated later
    at the same address never inherits it."""
    with _exemplar_lock:
        first = id(hist) not in _exemplar_finalized
        if first:
            _exemplar_finalized.add(id(hist))
        _exemplar_thresholds[id(hist)] = float(threshold_us)
    if first:
        weakref.finalize(hist, _drop_exemplar_threshold, id(hist))


def disarm_exemplar_threshold(hist: Histogram) -> None:
    with _exemplar_lock:
        _exemplar_thresholds.pop(id(hist), None)


def reset_exemplars() -> None:
    with _exemplar_lock:
        _exemplar_thresholds.clear()
        _exemplars.clear()


def exemplars_for(key: str) -> list[dict]:
    """Newest-first exemplars for one series key (metrics.series_key)."""
    with _exemplar_lock:
        ring = _exemplars.get(key)
        return list(ring)[::-1] if ring else []


def exemplars_snapshot() -> dict[str, list[dict]]:
    with _exemplar_lock:
        return {k: list(ring)[::-1] for k, ring in _exemplars.items() if ring}


def _note_exemplar(hist: Histogram, value_us: int, trace_id) -> None:
    """Slow path: only runs for an over-threshold observation."""
    if trace_id is None:
        trace_id = tracer.current_trace()
        if trace_id is None:
            return  # no trace to link: an exemplar would dangle
    entry = {
        "trace_id": trace_id,
        "value_us": int(value_us),
        "bucket_us": _bucket_upper(_bucket_of(int(value_us))),
        # wall-clock stamp so a windowed report can drop exemplars recorded
        # before its window (the ring outlives incidents)
        "ts": time.time(),
    }
    key = series_key(hist.name, hist.labels)
    with _exemplar_lock:
        ring = _exemplars.get(key)
        if ring is None:
            ring = _exemplars[key] = collections.deque(maxlen=_EXEMPLAR_CAP)
        ring.append(entry)


def record_us(hist: Histogram, value_us: int, trace_id=None) -> None:
    """Record a latency observation with exemplar capture. The always-on
    cost beyond hist.record is one dict lookup and a compare."""
    value_us = int(value_us)
    hist.record(value_us)
    thr = _exemplar_thresholds.get(id(hist))
    if thr is None:
        if not tracer.enabled:
            return
        thr = tracer.slow_threshold_us
    if value_us >= thr:
        _note_exemplar(hist, value_us, trace_id)


def observe_us(hist: Histogram, t0: float) -> None:
    """Record elapsed-since-t0 (a perf_counter timestamp) in microseconds."""
    record_us(hist, int((time.perf_counter() - t0) * 1e6))


__all__ = [
    "Counter",
    "Histogram",
    "arm_exemplar_threshold",
    "coproc_breaker_trips",
    "coproc_device_leg_hist",
    "coproc_failure_counter",
    "coproc_host_pool_busy",
    "coproc_leakwatch_imbalance",
    "coproc_lockwatch_edges",
    "coproc_mesh_device_rows",
    "coproc_retries_total",
    "coproc_stage_hist",
    "disarm_exemplar_threshold",
    "exemplars_for",
    "exemplars_snapshot",
    "host_pool_task_finished",
    "host_pool_task_started",
    "kafka_fetch_hist",
    "kafka_produce_hist",
    "observe_us",
    "raft_replicate_hist",
    "record_us",
    "reset_exemplars",
    "rpc_request_hist",
    "storage_append_hist",
    "storage_housekeeping_hist",
]
