"""Metrics registry with prometheus text exposition (the JAX package's
metrics.py, copied, with its series names and ``PREFIX``, so that a scrape
of the port reads like the JAX package's).

Parity with the reference's probe pattern: every subsystem registers a
"probe" of counters/gauges/histograms (storage/probe.h, raft/probe.cc,
kafka/latency_probe.h) and the admin server exports them all at /metrics in
prometheus format (admin_server.cc:148-151). Gauges may be callables so
live state (partition counts, HWMs) is sampled at scrape time.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable

from redpanda_tpu_torch.utils.hdr import HdrHist

PREFIX = "redpanda_tpu"


@dataclass
class Counter:
    name: str
    help: str
    labels: tuple[tuple[str, str], ...] = ()
    value: float = 0
    # `value += n` is a read-modify-write across bytecodes; counters are
    # shared by the harvester daemon, fetch workers, host-pool shards and
    # the tick executor, and unlocked concurrent incs LOSE updates
    # (pandaraces RAC1101). Scrape-side reads of the single float stay
    # lock-free: a read observes one consistent published value.
    _lock: threading.Lock = field(
        default_factory=threading.Lock, repr=False, compare=False
    )

    def inc(self, n: float = 1) -> None:
        with self._lock:
            self.value += n


@dataclass
class Gauge:
    name: str
    help: str
    fn: Callable[[], float]
    labels: tuple[tuple[str, str], ...] = ()


@dataclass
class Histogram:
    name: str
    help: str
    hist: HdrHist = field(default_factory=HdrHist)
    labels: tuple[tuple[str, str], ...] = ()

    def record(self, value: int) -> None:
        self.hist.record(value)


def _escape_label_value(v: str) -> str:
    """Prometheus text-format label escaping: backslash, quote, newline."""
    return str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(text: str) -> str:
    """HELP lines escape backslash and newline (not quotes)."""
    return text.replace("\\", "\\\\").replace("\n", "\\n")


def _labelstr(labels: tuple[tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


def series_key(name: str, labels: tuple[tuple[str, str], ...] = ()) -> str:
    """The unprefixed series identity used by snapshot()/histograms():
    ``name{label="value",...}``. One function so the SLO engine, the
    exemplar store and the snapshot diff all join on the same key."""
    return f"{name}{_labelstr(labels)}"


class MetricsRegistry:
    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._hists: dict[str, Histogram] = {}

    def _key(self, name: str, labels) -> str:
        return name + repr(sorted(labels))

    def counter(self, name: str, help: str = "", **labels: str) -> Counter:
        key = self._key(name, labels.items())
        c = self._counters.get(key)
        if c is None:
            c = Counter(name, help, tuple(sorted(labels.items())))
            self._counters[key] = c
        return c

    def gauge(self, name: str, fn: Callable[[], float], help: str = "", **labels: str) -> Gauge:
        key = self._key(name, labels.items())
        g = Gauge(name, help, fn, tuple(sorted(labels.items())))
        self._gauges[key] = g
        return g

    def histogram(self, name: str, help: str = "", **labels: str) -> Histogram:
        key = self._key(name, labels.items())
        h = self._hists.get(key)
        if h is None:
            h = Histogram(name, help, labels=tuple(sorted(labels.items())))
            self._hists[key] = h
        return h

    def histograms(self) -> dict[str, Histogram]:
        """Live histogram series keyed like snapshot() (series_key form).
        The SLO engine quantile-interpolates straight off these buckets;
        callers must treat the Histogram objects as read-only. The dict
        is materialized with one GIL-atomic ``list()`` first: scrapers
        (SLO engine, history recorder) run off-thread from registration,
        and a plain ``.values()`` walk races a concurrent first-label
        registration with "dict changed size during iteration"."""
        return {
            series_key(h.name, h.labels): h
            for h in list(self._hists.values())
        }

    # ------------------------------------------------------------ exposition
    def render_prometheus(self) -> str:
        lines: list[str] = []
        seen_help: set[str] = set()

        def _head(name: str, help: str, typ: str) -> None:
            if name not in seen_help:
                lines.append(f"# HELP {PREFIX}_{name} {_escape_help(help)}")
                lines.append(f"# TYPE {PREFIX}_{name} {typ}")
                seen_help.add(name)

        # GIL-atomic materializations: the scrape runs on the admin loop
        # while worker threads lazily register new labeled series
        for c in list(self._counters.values()):
            _head(c.name, c.help, "counter")
            lines.append(f"{PREFIX}_{c.name}{_labelstr(c.labels)} {c.value}")
        for g in list(self._gauges.values()):
            _head(g.name, g.help, "gauge")
            try:
                v = g.fn()
            except Exception:
                v = float("nan")
            lines.append(f"{PREFIX}_{g.name}{_labelstr(g.labels)} {v}")
        for h in list(self._hists.values()):
            _head(h.name, h.help, "histogram")
            for upper, cum in h.hist.cumulative_buckets():
                le = 'le="%s"' % upper
                lines.append(
                    f"{PREFIX}_{h.name}_bucket{_labelstr(h.labels, le)} {cum}"
                )
            le_inf = 'le="+Inf"'
            lines.append(
                f"{PREFIX}_{h.name}_bucket{_labelstr(h.labels, le_inf)} {h.hist.count}"
            )
            lines.append(f"{PREFIX}_{h.name}_sum{_labelstr(h.labels)} {h.hist.sum}")
            lines.append(f"{PREFIX}_{h.name}_count{_labelstr(h.labels)} {h.hist.count}")
        return "\n".join(lines) + "\n"

    def snapshot(self) -> dict:
        """Point-in-time metric values keyed by UNPREFIXED series name +
        labels (exposition lines additionally carry the ``redpanda_tpu_``
        prefix) — the before/after anchor tools/microbench.py emits so a
        bench run can be diffed against the counters it moved."""
        out: dict[str, object] = {}
        # same list() materialization as render_prometheus: snapshot is
        # called from the history recorder thread under live registration
        for c in list(self._counters.values()):
            out[f"{c.name}{_labelstr(c.labels)}"] = c.value
        for g in list(self._gauges.values()):
            try:
                v = g.fn()
            except Exception:
                v = None
            out[f"{g.name}{_labelstr(g.labels)}"] = v
        for h in list(self._hists.values()):
            out[f"{h.name}{_labelstr(h.labels)}"] = {
                "count": h.hist.count,
                "sum": h.hist.sum,
                "max": h.hist.max,
                "p99": h.hist.percentile(99),
            }
        return out


# process-wide registry, like the seastar metrics singleton
registry = MetricsRegistry()
