"""pandaprobe span tracer: where does a record batch spend its time?

(The JAX package's observability/trace.py, copied.)

The reference answers "what is slow" with per-subsystem probes exported at
/metrics; it has no cross-subsystem *trace* because a seastar request never
leaves its shard. Our produce → raft → TPU-transform → fetch path crosses
an event loop, an executor pool AND the engine's harvester thread, so the
aggregate histograms (observability/probes.py) are paired with a span
tracer that stitches one batch's journey back together:

  with tracer.span("raft.replicate"):
      ...

* A span inherits the ambient trace id (a ``contextvars.ContextVar``, so it
  follows the asyncio task across awaits); ``root=True`` starts a fresh
  trace, and a mid-path span with NO ambient trace is a no-op (heartbeat /
  follower chatter must not mint orphan traces that evict real ones).
  Work hopping to another thread carries the id EXPLICITLY
  (``ProcessBatchRequest.trace_id`` → ``Ticket`` → ``_Launch`` → the
  harvester thread) because executor threads do not inherit task context.
* Completed spans land in a bounded ring (``collections.deque(maxlen=N)``)
  — tracing a busy broker must never grow memory; old traces fall off.
* Spans record wall time; stages that wait in a queue or block on the
  device attach ``queue_us`` / ``device_us`` extras (the harvester records
  device time AFTER the async D2H lands, i.e. post-``block_until_ready``
  semantics).
* Spans over ``slow_threshold_us`` additionally land in a slow-request
  ring and a WARNING log line — the "why was this one produce 2s" answer
  without trawling the full ring.

Cost discipline: a disabled tracer does ONE attribute check per span and
returns a shared no-op context manager — no clock read, no allocation, no
lock (tools/microbench.py --only tracer_overhead measures the delta).
"""

from __future__ import annotations

import collections
import itertools
import logging
import os
import threading
import time
from contextvars import ContextVar

logger = logging.getLogger("rptorch.observability.trace")

# Ambient trace id for the current asyncio task / thread.
_current_trace: ContextVar[int | None] = ContextVar("rptorch_trace_id", default=None)

# Ambient NODE id: which broker's work this task is doing. Only entry-point
# spans set it (``span(..., node=N)``) — the kafka handlers, the rpc server's
# join span, the raft append_entries send — and child spans inherit it, so a
# single process hosting several in-process brokers (the loadgen cluster
# stack, the cluster test fixtures) still attributes each span to the right
# node. A real one-broker-per-process deployment falls back to the tracer's
# configured node id.
_current_node: ContextVar[int | None] = ContextVar("rptorch_trace_node", default=None)

_UNSET = object()


class _NoopSpan:
    """Shared do-nothing span: the entire cost of a disabled tracer."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, key: str, value) -> None:
        pass


_NOOP = _NoopSpan()

# Per-thread cached name: threading.current_thread().name walks the active
# registry on every call (~2x a plain local lookup); one enabled span pays
# it once per commit, and the propagation microbench prices that against
# the <1%-of-an-rpc budget. Thread names here never change after spawn.
_thread_name = threading.local()


def _current_thread_name() -> str:
    name = getattr(_thread_name, "v", None)
    if name is None:
        name = _thread_name.v = threading.current_thread().name
    return name


class _Detached:
    """Nulls the ambient trace id for the duration of the block."""

    __slots__ = ("_token",)

    def __enter__(self) -> "_Detached":
        self._token = _current_trace.set(None)
        return self

    def __exit__(self, *exc) -> bool:
        _current_trace.reset(self._token)
        return False


class _Span:
    __slots__ = ("_tracer", "name", "trace_id", "span_id", "_token", "_t0",
                 "extras", "_no_slow", "_node", "_ntoken")

    def __init__(
        self, tracer: "Tracer", name: str, trace_id: int, no_slow: bool,
        node: int | None = None,
    ) -> None:
        self._tracer = tracer
        self.name = name
        self.trace_id = trace_id
        self.span_id = tracer.new_span_id()
        self._token = None
        self._t0 = 0.0
        self.extras: dict | None = None
        self._no_slow = no_slow
        self._node = node
        self._ntoken = None

    def set(self, key: str, value) -> None:
        """Attach an extra (queue_us, device_us, bytes, ...) to this span."""
        if self.extras is None:
            self.extras = {}
        self.extras[key] = value

    def __enter__(self) -> "_Span":
        self._token = _current_trace.set(self.trace_id)
        if self._node is not None:
            # entry-point span: publish the node for every child span
            self._ntoken = _current_node.set(self._node)
        else:
            self._node = _current_node.get()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        t1 = time.perf_counter()
        _current_trace.reset(self._token)
        if self._ntoken is not None:
            _current_node.reset(self._ntoken)
            self._ntoken = None
        # positional call: one enabled span commits per sampled rpc, and
        # kwargs marshalling is measurable against the propagation budget
        self._tracer._commit(
            self.name,
            self.trace_id,
            self._t0,
            (t1 - self._t0) * 1e6,
            self.extras,
            self._no_slow,
            self.span_id,
            self._node,
        )
        return False


class Tracer:
    """Bounded, thread-safe span recorder. One process-wide instance
    (``tracer`` below), configured from broker config in app startup."""

    def __init__(
        self,
        *,
        enabled: bool = False,
        capacity: int = 2048,
        slow_capacity: int = 256,
        slow_threshold_ms: float = 500.0,
    ) -> None:
        self.enabled = enabled
        self.slow_threshold_us = float(slow_threshold_ms) * 1000.0
        self._ring: collections.deque = collections.deque(maxlen=capacity)
        self._slow: collections.deque = collections.deque(maxlen=slow_capacity)
        # Committed-span sink (pandapulse flight recorder). One attribute
        # check per commit when unset; the sink itself must be cheap and
        # never raise (it runs inside every instrumented hot path).
        self._sink = None
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._span_ids = itertools.count(1)
        self._node_id: int | None = None
        # wall-clock anchor so start_us is meaningful across processes
        self._epoch_wall = time.time()
        self._epoch_perf = time.perf_counter()
        self._recorded = 0

    # ------------------------------------------------------------ config
    def configure(
        self,
        *,
        enabled: bool | None = None,
        capacity: int | None = None,
        slow_threshold_ms: float | None = None,
        node_id: int | None = None,
    ) -> None:
        with self._lock:
            if capacity is not None and capacity != self._ring.maxlen:
                self._ring = collections.deque(self._ring, maxlen=capacity)
            if slow_threshold_ms is not None:
                self.slow_threshold_us = float(slow_threshold_ms) * 1000.0
            if node_id is not None and node_id != self._node_id:
                # Namespace trace/span ids by node so a trace assembled
                # across broker processes never merges two nodes' unrelated
                # traces that happened to share a small counter value, and
                # salt the counter start with per-INCARNATION entropy: a
                # SIGKILLed-and-restarted broker seeding deterministically
                # would reuse its previous life's exact ids, and peers'
                # rings (which outlive the restart) would stitch both
                # incarnations into one bogus cluster trace. 36 random
                # bits leave 2^36+ spans of headroom inside the 40-bit
                # counter field before a wrap could touch the node bits.
                # The counters only ever RESEED on an actual node change —
                # reconfiguring other knobs must not rewind ids.
                self._node_id = int(node_id)
                base = ((self._node_id + 1) & 0xFFFF) << 40
                salt = int.from_bytes(os.urandom(5), "big") >> 4  # 36 bits
                self._ids = itertools.count(base | salt | 1)
                self._span_ids = itertools.count(base | salt | 1)
        if enabled is not None:
            self.enabled = enabled  # last: spans only start once ring is sized

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._slow.clear()
            self._recorded = 0

    def set_sink(self, sink) -> None:
        """Install (or clear, with ``None``) the committed-span sink — the
        pandapulse flight recorder's feed. Exactly one sink: the recorder
        owns fan-out if it ever needs one."""
        self._sink = sink

    # ------------------------------------------------------------ ids
    def new_trace_id(self) -> int:
        return next(self._ids)

    def new_span_id(self) -> int:
        return next(self._span_ids)

    @property
    def node_id(self) -> int | None:
        return self._node_id

    def current_trace(self) -> int | None:
        """Ambient trace id (None when disabled or outside any span) —
        what cross-thread hops stamp onto their request objects."""
        if not self.enabled:
            return None
        return _current_trace.get()

    def current_node(self) -> int | None:
        """Ambient node id set by the nearest entry-point span, or the
        tracer's configured node (None when neither is known)."""
        n = _current_node.get()
        return n if n is not None else self._node_id

    @property
    def spans_recorded(self) -> int:
        return self._recorded

    @property
    def epoch_wall(self) -> float:
        """Wall-clock time perf-epoch 0 corresponds to — what lets the
        cluster assembler align span start_us across processes."""
        return self._epoch_wall

    @property
    def epoch_perf(self) -> float:
        return self._epoch_perf

    # ------------------------------------------------------------ spans
    def span(
        self, name: str, trace_id=_UNSET, *, root: bool = False,
        no_slow: bool = False, node: int | None = None,
    ):
        """Context manager timing one stage.

        - ``span(name)``: joins the ambient trace; NO-OP when there is
          none. Traces only ever originate at request entry points
          (``root=True``) — a mid-path span (storage.append on a follower,
          an rpc.send heartbeat) must not mint single-span orphan traces,
          or steady-state chatter evicts the end-to-end traces the ring
          exists for.
        - ``span(name, root=True)``: starts a fresh trace (request entry
          points: kafka produce/fetch, a coproc tick).
        - ``span(name, trace_id=tid)``: explicit id carried across a
          thread hop; ``tid=None`` means "caller had no trace" → no-op.
        - ``no_slow=True``: exempt from the slow-request log — for spans
          whose duration is INTENTIONAL waiting (a fetch long poll), which
          would otherwise bury real slow work.
        - ``node=N``: entry-point spans stamp which broker's work this is
          and publish it to child spans (see ``_current_node``); child
          spans inherit the ambient node automatically.
        """
        if not self.enabled:
            return _NOOP
        if root:
            tid = self.new_trace_id()
        elif trace_id is _UNSET:
            tid = _current_trace.get()
            if tid is None:
                return _NOOP
        elif trace_id is None:
            return _NOOP
        else:
            tid = trace_id
        return _Span(self, name, tid, no_slow, node=node)

    def detached(self):
        """Wrap creation of LONG-LIVED tasks (a replicate batcher's flush
        loop, follower recovery) in this: ``asyncio.create_task`` copies the
        caller's contextvars, so a task spawned inside a request span would
        otherwise attribute every span it ever records to that first
        request's trace — starving later traces of their legs and growing
        one ancient trace forever. Work the task does on behalf of many
        requests either carries ids explicitly or goes untraced."""
        return _Detached()

    def record(
        self,
        name: str,
        dur_us: float,
        trace_id: int | None = None,
        *,
        start_perf: float | None = None,
        **extras,
    ) -> None:
        """Manually record a completed stage (used where a context manager
        cannot wrap the work: harvester thread, pre-trace read phases)."""
        if not self.enabled or trace_id is None:
            return
        t0 = start_perf if start_perf is not None else time.perf_counter() - dur_us / 1e6
        self._commit(name, trace_id, t0, dur_us, extras or None)

    def _commit(
        self,
        name: str,
        trace_id: int,
        t0: float,
        dur_us: float,
        extras: dict | None,
        no_slow: bool = False,
        span_id: int | None = None,
        node: int | None = None,
    ) -> None:
        span = {
            "trace_id": trace_id,
            "name": name,
            "start_us": int((t0 - self._epoch_perf) * 1e6),
            "dur_us": int(dur_us),
            "thread": _current_thread_name(),
        }
        if span_id is None:
            span_id = self.new_span_id()  # manual record(): still unique
        span["span_id"] = span_id
        if node is None:
            # ambient first: tracer.record() calls inside an entry-point
            # span (pacemaker's back-dated read phase) belong to THAT
            # broker, not to whichever in-process app configured last
            node = _current_node.get()
            if node is None:
                node = self._node_id
        if node is not None:
            span["node"] = node
        if extras:
            span.update(extras)
        with self._lock:
            self._ring.append(span)
            self._recorded += 1
            if not no_slow and dur_us >= self.slow_threshold_us:
                self._slow.append(span)
                slow = True
            else:
                slow = False
        sink = self._sink
        if sink is not None:
            # outside the lock: the recorder has its own bounded ring and
            # must never serialize behind the tracer's
            sink(span)
        if slow:
            logger.warning(
                "slow span %s: %.1f ms (trace %d, thread %s)",
                name, dur_us / 1000.0, trace_id, span["thread"],
            )

    # ------------------------------------------------------------ queries
    def recent(self, limit: int = 20) -> list[dict]:
        """Newest-first traces: [{trace_id, wall_us, spans:[...]}, ...].

        Spans of one trace are grouped and time-ordered; a trace whose
        early spans already fell off the ring shows what survived.
        """
        with self._lock:
            spans = list(self._ring)
        by_trace: dict[int, list[dict]] = {}
        order: list[int] = []
        for s in spans:
            tid = s["trace_id"]
            if tid not in by_trace:
                by_trace[tid] = []
                order.append(tid)
            by_trace[tid].append(s)
        out = []
        for tid in reversed(order[-limit:] if limit else order):
            group = sorted(by_trace[tid], key=lambda s: s["start_us"])
            first = min(s["start_us"] for s in group)
            last = max(s["start_us"] + s["dur_us"] for s in group)
            out.append({
                "trace_id": tid,
                "epoch": self._epoch_wall,
                "wall_us": last - first,
                "spans": group,
            })
        return out

    def slow(self, limit: int = 50) -> list[dict]:
        """Newest-first spans that crossed the slow threshold."""
        with self._lock:
            return list(self._slow)[-limit:][::-1]

    def spans_for(self, trace_id: int) -> list[dict]:
        """Every surviving span of ONE trace, time-ordered — what the
        cluster-trace assembler (GET /v1/trace/id/<tid> per node, merged by
        admin fan-out) pulls. Ring and slow-ring hold the same dict objects,
        so the union dedupes by identity: a slow span whose trace fell off
        the main ring is still returned."""
        with self._lock:
            seen: dict[int, dict] = {}
            for s in list(self._ring) + list(self._slow):
                if s["trace_id"] == trace_id:
                    seen[id(s)] = s
        return sorted(seen.values(), key=lambda s: s["start_us"])


# Process-wide tracer, like the metrics registry singleton: subsystems
# import this instance; app startup flips it on from config.
tracer = Tracer()
