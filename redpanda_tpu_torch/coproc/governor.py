"""The coproc governor: one decision plane for every adaptive choice (the
JAX package's coproc/governor.py, ported with its admission shed episodes
and its launch-knob autotune).

The engine carries a family of measured probes -- the host-pool
calibration (and its periodic recalibration), the parse-path probe, the
mesh-vs-single probe, the circuit breakers, the harvest framing path and
the sharded seal. The governor routes every such decision through ONE
policy surface:

- **Decision journal** -- a bounded in-memory ring of every adaptive
  decision made in this process: monotonic ``seq``, wall-clock ``ts``,
  ``domain``, the measured ``inputs`` that drove it, the ``verdict``, a
  human-readable ``reason`` and the active-config snapshot at decision
  time.
- **Metrics** -- ``coproc_governor_decisions_total{domain,verdict}``
  counters, per-domain posture gauges (``coproc_governor_state{domain=}``)
  and per-domain breaker gauges (``coproc_breaker_state{domain=}``).
- **Per-domain breakers** -- one per device fault domain (dispatch,
  mask_fetch, harvest, mesh_dispatch), so a flaky copy down opens the
  harvest domain's breaker while dispatch keeps its own.
- **Adaptive deadlines** -- per-domain per-attempt deadlines derived from
  the domain's success-only device-leg p99.9:
  ``deadline = clamp(margin * p99.9, floor, cap_x * floor)`` where the
  static ``device_deadline_ms`` is the FLOOR and the fallback below
  ``min_samples``: the adaptive path may only ever RAISE a deadline.

The journal and its counters are process-wide (like the metrics registry);
Governor instances are per engine and own the per-engine state: breakers,
deadline derivation, posture.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import logging
import threading
import time
import weakref

from redpanda_tpu_torch.coproc import faults, lockwatch
from redpanda_tpu_torch.metrics import Counter, registry
from redpanda_tpu_torch.observability import probes

logger = logging.getLogger("rptorch.coproc.governor")

# ------------------------------------------------------------ decision domains
# The JAX package's domains, all of them, so that the two journals read
# alike. The port journals host_pool, breaker, harvest_path, sharded_seal,
# deadline, parse_path, mesh and admission (shed episodes and memory
# pressure transitions); the others belong to modules still to be ported
# (the columnar backend probe, LZ4, lockwatch, leakwatch, trends, bench
# diagnoses).
HOST_POOL = "host_pool"
COLUMNAR_BACKEND = "columnar_backend"
DEVICE_LZ4 = "device_lz4"
BREAKER = "breaker"
HARVEST_PATH = "harvest_path"
SHARDED_SEAL = "sharded_seal"
DEADLINE = "deadline"
# the measured structural-vs-staged parse ladder
PARSE_PATH = "parse_path"
COLUMN_CACHE = "column_cache"
DIAGNOSIS = "diagnosis"
LOCKWATCH = "lockwatch"
LEAKWATCH = "leakwatch"
# the measured mesh-vs-single decision and the mesh breaker's demotions
MESH = "mesh"
ADMISSION = "admission"
TREND = "trend"

DOMAINS = (
    HOST_POOL, COLUMNAR_BACKEND, DEVICE_LZ4, BREAKER, HARVEST_PATH,
    SHARDED_SEAL, DEADLINE, PARSE_PATH, COLUMN_CACHE, DIAGNOSIS, LOCKWATCH,
    LEAKWATCH, MESH, ADMISSION, TREND,
)

# fault domains that get their own breaker + adaptive deadline. Each
# deadline derives from the domain's SUCCESS-ONLY device-leg histogram
# (coproc_device_leg_latency_us{domain=}, fed by Governor.observe_leg at
# every successful leg completion) — NOT from the fetch-stage
# coproc_stage_latency_us histogram: the stage clock keeps running
# through abandoned attempts and envelope waits, so a burst of timeouts
# used to inflate the very tail the next deadline was derived from (the
# 8x cap bounded that feedback; the success-only source removes it).
BREAKER_DOMAINS = (
    faults.DEVICE_DISPATCH, faults.MASK_FETCH, faults.HARVEST,
    faults.MESH_DISPATCH,
)

# Adaptive-deadline shape: derived = clamp(margin * p99.9, floor, cap_x *
# floor). The cap bounds every waiter sized off envelope_s() (the tick
# backstop, a caller's wait on the harvest thread) — without it one wedged fetch
# recorded into the stage histogram could balloon the next deadline toward
# its own wedge duration.
DEADLINE_RECOMPUTE_SAMPLES = 64  # recompute p99.9 after this many new obs
_DEADLINE_JOURNAL_DELTA = 0.2    # journal a change only when >= 20%

# Launch-knob autotune (ADMISSION domain): how often a verdict may CHANGE
# the knobs (hysteresis hold window — a flapping input cannot flap the
# knobs faster than this), and where the success-only dispatch-leg p99.9
# sits relative to the static deadline floor before we grow (cheap legs:
# deepen batching toward the ~90%-utilization posture) or shrink (tail
# approaching the deadline: trade launch depth for latency).
AUTOTUNE_HOLD_S = 5.0
_AUTOTUNE_GROW_FRAC = 0.5
_AUTOTUNE_SHRINK_FRAC = 0.8

# posture verdict -> gauge value per domain (unknown/undecided = -1)
_STATE_ENCODING: dict[str, dict[str, float]] = {
    HOST_POOL: {"inline": 0.0, "sharded": 1.0},
    COLUMNAR_BACKEND: {"host": 0.0, "device": 1.0},
    DEVICE_LZ4: {"host": 0.0, "device": 1.0},
    HARVEST_PATH: {"padded": 0.0, "gather": 1.0},
    SHARDED_SEAL: {"inline": 0.0, "sharded": 1.0},
    PARSE_PATH: {"staged": 0.0, "structural": 1.0},
    MESH: {"single": 0.0, "mesh": 1.0},
}

_BREAKER_SEVERITY = {
    faults.STATE_CLOSED: 0,
    faults.STATE_HALF_OPEN: 1,
    faults.STATE_OPEN: 2,
}


# ------------------------------------------------------------ decision journal
class DecisionJournal:
    """Bounded ring of decision entries with a monotonic sequence.

    A standalone class (not bare module state) so that a test or a scratch
    governor can append to a throwaway instance without writing into the
    live process journal.
    """

    def __init__(self, capacity: int = 256) -> None:
        self._lock = threading.Lock()
        self._ring: collections.deque = collections.deque(
            maxlen=max(1, int(capacity))
        )
        self._seq = itertools.count(1)
        self._last_seq = 0

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    def configure(self, capacity: int) -> None:
        capacity = max(1, int(capacity))
        with self._lock:
            if capacity != self._ring.maxlen:
                self._ring = collections.deque(self._ring, maxlen=capacity)

    def reset(self) -> None:
        with self._lock:
            self._ring.clear()
            self._seq = itertools.count(1)
            self._last_seq = 0

    def append(
        self,
        domain: str,
        verdict: str,
        reason: str,
        inputs: dict | None = None,
        config: dict | None = None,
        engine: str | None = None,
    ) -> dict:
        entry = {
            "seq": 0,  # assigned under the lock below
            "ts": time.time(),
            "domain": domain,
            "verdict": str(verdict),
            "reason": reason,
            "inputs": dict(inputs) if inputs else {},
            "config": dict(config) if config else {},
        }
        if engine is not None:
            entry["engine"] = engine
        with self._lock:
            entry["seq"] = self._last_seq = next(self._seq)
            self._ring.append(entry)
        return entry

    def entries(
        self, limit: int | None = None, domain: str | None = None
    ) -> list[dict]:
        """Newest-first entries, optionally filtered by domain."""
        with self._lock:
            items = list(self._ring)
        if domain is not None:
            items = [e for e in items if e["domain"] == domain]
        items.reverse()
        return items[:limit] if limit else items

    def summary(self) -> dict:
        with self._lock:
            items = list(self._ring)
            last_seq = self._last_seq
            cap = self._ring.maxlen or 0
        by: dict[str, dict[str, int]] = {}
        for e in items:
            d = by.setdefault(e["domain"], {})
            d[e["verdict"]] = d.get(e["verdict"], 0) + 1
        return {
            "entries": len(items),
            "seq": last_seq,          # decisions ever made this process
            "capacity": cap,
            "dropped": max(0, last_seq - len(items)),
            "by_domain": by,
        }


# The process journal (metrics-registry posture: one per process).
journal = DecisionJournal()

# Serializes device-leg histogram records PROCESS-wide: the default
# deadline source (probes.coproc_device_leg_hist) is one histogram per
# domain shared by every engine's governor, so a per-Governor lock would
# let two engines' legs interleave the same HdrHist read-modify-write —
# exactly the HST1001 contract. Leg completions are per-launch cadence;
# one module lock is plenty.
_leg_record_lock = threading.Lock()

# coproc_governor_decisions_total{domain,verdict}: lazy check-then-create
# under a lock, same reason as probes.coproc_failure_counter.
_decision_counters: dict[tuple[str, str], Counter] = {}
_decision_lock = threading.Lock()


def _decision_counter(domain: str, verdict: str) -> Counter:
    key = (domain, verdict)
    c = _decision_counters.get(key)
    if c is None:
        with _decision_lock:
            c = _decision_counters.get(key)
            if c is None:
                c = registry.counter(
                    "coproc_governor_decisions_total",
                    "Adaptive decisions routed through the coproc governor",
                    domain=domain,
                    verdict=verdict,
                )
                _decision_counters[key] = c
    return c


def journal_record(
    domain: str,
    verdict: str,
    reason: str,
    inputs: dict | None = None,
    config: dict | None = None,
    engine: str | None = None,
) -> dict:
    """Append one decision to the process journal + its counter series.
    Process-scoped deciders with no engine (ops/lz4_device.measure_probe)
    call this directly; Governor.record wraps it with the engine's
    active-config snapshot."""
    entry = journal.append(domain, verdict, reason, inputs, config, engine)
    _decision_counter(domain, str(verdict)).inc()
    return entry


def reset_journal() -> None:
    """Test hook: clear the process journal (counters are registry-owned
    and keep their monotonic totals, like every other counter)."""
    journal.reset()


# ------------------------------------------------------------ governor
_engine_tags = itertools.count(1)


class Governor:
    """Per-engine decision plane: per-domain breakers, adaptive deadlines,
    posture, and the engine's view into the process decision journal."""

    def __init__(
        self,
        *,
        fault_policy: faults.FaultPolicy,
        breaker_threshold: int = 5,
        breaker_cooldown_s: float = 30.0,
        breaker_probe_timeout_s: float | None = None,
        clock=time.monotonic,
        adaptive_deadline: bool = True,
        deadline_margin: float = 4.0,
        deadline_cap_x: float = 8.0,
        deadline_min_samples: int = 64,
        stage_hist=None,
        engine_tag: str | None = None,
        register_gauges: bool = True,
        journal_override: DecisionJournal | None = None,
    ) -> None:
        self._policy = fault_policy
        self._clock = clock
        self._adaptive = bool(adaptive_deadline)
        self._margin = max(1.0, float(deadline_margin))
        self._cap_x = max(1.0, float(deadline_cap_x))
        self._min_samples = max(1, int(deadline_min_samples))
        # injectable histogram source: FAULT DOMAIN -> object with
        # .count/.percentile/.record (the process registry's success-only
        # device-leg HdrHist by default; tests inject their own so the
        # derivation is provable without polluting the live series).
        # observe_leg records into the same source, so injected tests see
        # a closed loop.
        self._stage_hist = stage_hist or (
            lambda domain: probes.coproc_device_leg_hist(domain).hist
        )
        self.engine_tag = engine_tag or f"engine-{next(_engine_tags)}"
        self._lock = lockwatch.wrap(threading.Lock(), "Governor._lock")
        # tests inject a private journal so scratch governors never
        # write the live process journal or its counters
        self._journal = journal_override if journal_override is not None else journal
        # active-config snapshot attached to every journal entry
        self._config: dict = {}
        # current per-domain posture (what the gauges and posture() show)
        self._posture_modes: dict[str, str] = {}
        # record_mode dedupe state, keyed (domain, caller key): the
        # harvest-path verdict is per SCRIPT (a mixed gather+padded
        # workload must journal once per script, not flip-flop the ring
        # on every alternating launch)
        self._mode_keys: dict[tuple, str] = {}
        # per-domain adaptive deadline state:
        # domain -> {"count": samples at last recompute, "deadline_s": ...}
        self._deadline_state: dict[str, dict] = {}
        # launch-knob autotune (configure_autotune arms it) + open shed
        # episodes (note_shed / note_admitted bracket them)
        self._auto: dict | None = None
        self._shed_open: set = set()
        self._policies: dict[str, faults.FaultPolicy] = {}
        # monotonic per-domain max of deadlines actually ISSUED (floor
        # when never raised): the basis of envelope_bound_s
        self._max_issued: dict[str, float] = {}
        self._breakers: dict[str, faults.CircuitBreaker] = {
            domain: faults.CircuitBreaker(
                threshold=breaker_threshold,
                cooldown_s=breaker_cooldown_s,
                clock=clock,
                probe_timeout_s=breaker_probe_timeout_s,
                name=domain,
                listener=self._on_breaker_transition,
            )
            for domain in BREAKER_DOMAINS
        }
        if register_gauges:
            self._register_gauges()

    # ------------------------------------------------------------ gauges
    def _register_gauges(self) -> None:
        """Labeled per-domain gauges bound to THIS governor via weakref.
        Registration overwrites the previous governor's gauges (the
        registry is process-wide and the broker owns exactly one engine);
        a collected governor reads -1 instead of a stale engine's state —
        the fix for the old weakref-to-latest-engine breaker gauge."""
        ref = weakref.ref(self)
        for domain in BREAKER_DOMAINS:
            registry.gauge(
                "coproc_breaker_state",
                self._breaker_gauge_fn(ref, domain),
                "Per-domain device circuit breaker state "
                "(0 closed, 1 open, 2 half_open, -1 none)",
                domain=domain,
            )
            registry.gauge(
                "coproc_governor_deadline_ms",
                self._deadline_gauge_fn(ref, domain),
                "Effective per-attempt device deadline per fault domain "
                "(adaptive over observed stage p99.9; floor = "
                "coproc_device_deadline_ms)",
                domain=domain,
            )
        for domain in _STATE_ENCODING:
            registry.gauge(
                "coproc_governor_state",
                self._posture_gauge_fn(ref, domain),
                "Governor posture per decision domain (see "
                "coproc/governor.py encoding; -1 undecided)",
                domain=domain,
            )
        for knob in ("group_ticks", "launch_depth"):
            # the autotune knobs as live gauges, so that a knob resize
            # shows on a metrics timeline, not only as a journal instant
            registry.gauge(
                "coproc_autotune_knob",
                self._knob_gauge_fn(ref, knob),
                "Current dynamic launch knob value (ADMISSION autotune; "
                "-1 when autotune is unarmed)",
                knob=knob,
            )

    @staticmethod
    def _breaker_gauge_fn(ref, domain):
        def fn() -> float:
            gov = ref()
            if gov is None:
                return -1.0
            return faults.STATE_NUM.get(gov._breakers[domain].state, -1.0)

        return fn

    @staticmethod
    def _deadline_gauge_fn(ref, domain):
        def fn() -> float:
            gov = ref()
            if gov is None:
                return -1.0
            return round(gov.deadline_s(domain) * 1000.0, 3)

        return fn

    @staticmethod
    def _posture_gauge_fn(ref, domain):
        def fn() -> float:
            gov = ref()
            if gov is None:
                return -1.0
            verdict = gov._posture_modes.get(domain)
            return _STATE_ENCODING[domain].get(verdict, -1.0)

        return fn

    @staticmethod
    def _knob_gauge_fn(ref, knob):
        def fn() -> float:
            gov = ref()
            if gov is None:
                return -1.0
            auto = gov._auto
            if auto is None:
                return -1.0
            with gov._lock:
                return float(auto[knob])

        return fn

    # ------------------------------------------------------------ config
    def set_config_snapshot(self, config: dict) -> None:
        """The knob values journal entries carry as their active-config
        snapshot (journal entries copy it at record time)."""
        self._config = dict(config)

    def update_config_snapshot(self, **kw) -> None:
        self._config.update(kw)

    # ------------------------------------------------------------ recording
    def _emit(
        self, domain: str, verdict: str, reason: str, inputs: dict | None
    ) -> dict:
        """Append to this governor's journal; the decision counters only
        move for the live process journal (a scratch governor with an
        injected journal must not write product metrics)."""
        entry = self._journal.append(
            domain, verdict, reason, inputs, self._config, self.engine_tag
        )
        if self._journal is journal:
            _decision_counter(domain, str(verdict)).inc()
        return entry

    def record(
        self, domain: str, verdict: str, reason: str, inputs: dict | None = None
    ) -> dict:
        """Journal one decision with this engine's config snapshot, and
        remember the verdict as the domain's current posture."""
        with self._lock:
            self._posture_modes[domain] = str(verdict)
        return self._emit(domain, verdict, reason, inputs)

    def note_posture(self, domain: str, verdict: str) -> None:
        """Update the domain's current posture WITHOUT a journal entry —
        for inherited process-wide picks (an engine adopting the sticky
        columnar backend made no new decision; the probe that did already
        journaled it)."""
        with self._lock:
            self._posture_modes[domain] = str(verdict)

    def record_mode(
        self,
        domain: str,
        verdict: str,
        reason: str,
        inputs: dict | None = None,
        key=None,
    ) -> bool:
        """Journal only when ``verdict`` differs from the last one recorded
        under ``(domain, key)`` — per-launch callers (harvest framing, seal
        engagement) would otherwise flood the bounded ring with identical
        entries. ``key`` scopes the dedupe (the harvest-path verdict is a
        property of the SCRIPT's plan: a mixed gather+padded workload
        journals once per script instead of flip-flopping every launch).
        The unchanged path is the hot path: one lock, two dict ops."""
        verdict = str(verdict)
        k = (domain, key)
        with self._lock:
            # posture always tracks the most recent launch's verdict
            self._posture_modes[domain] = verdict
            if self._mode_keys.get(k) == verdict:
                return False
            self._mode_keys[k] = verdict
        self._emit(domain, verdict, reason, inputs)
        return True

    def _on_breaker_transition(
        self, name: str, old: str, new: str, reason: str, info: dict
    ) -> None:
        self._emit(
            BREAKER,
            new,
            f"{name}: {old} -> {new} ({reason})",
            {"breaker": name, "from": old, **info},
        )

    # ------------------------------------------------------------ breakers
    def breaker_for(self, fault_domain: str) -> faults.CircuitBreaker:
        return self._breakers[fault_domain]

    def breakers_snapshot(self) -> dict:
        return {d: b.snapshot() for d, b in self._breakers.items()}

    def aggregate_breaker_snapshot(self) -> dict:
        """Engine-level rollup (the shape ``stats()["breaker"]`` always
        had): worst state across domains, the MAX per-domain consecutive
        count (a sum would contradict the per-domain threshold it sits
        next to — 3 domains at 4/5 must not read as 12/5), total trips —
        so "is any part of the device path demoted" stays a one-field
        answer."""
        snaps = [b.snapshot() for b in self._breakers.values()]
        worst = max(snaps, key=lambda s: _BREAKER_SEVERITY[s["state"]])
        return {
            "state": worst["state"],
            "consecutive_failures": max(
                s["consecutive_failures"] for s in snaps
            ),
            "trips": sum(s["trips"] for s in snaps),
            "threshold": snaps[0]["threshold"],
            "cooldown_ms": snaps[0]["cooldown_ms"],
        }

    # ------------------------------------------------------------ deadlines
    def observe_leg(self, fault_domain: str, dt_s: float) -> None:
        """Record one SUCCESSFUL device-leg wall time — the only samples
        the adaptive deadline derives from. Abandoned attempts never call
        this (the leg raised or never returned), so a burst of timeouts
        cannot inflate the tail that sizes the next deadline. Locked on
        the MODULE lock: the default histograms are process-wide per
        domain (shared across engines), and legs complete on fetch
        workers, the harvester and the tick executor concurrently."""
        hist = self._stage_hist(fault_domain)
        with _leg_record_lock:
            hist.record(int(dt_s * 1e6))

    def deadline_s(self, fault_domain: str) -> float:
        """Effective per-attempt deadline for one device fault domain.

        ``clamp(margin * observed_leg_p99.9, floor, cap_x * floor)``;
        the static floor is the fallback below ``min_samples`` and the
        derivation may only RAISE the deadline above it. Recomputed only
        after DEADLINE_RECOMPUTE_SAMPLES new observations (the common path
        is two dict lookups + an int compare)."""
        st = self._deadline_state.get(fault_domain)
        if st is not None:
            # hot path: one dict get + a histogram count compare. The
            # histogram OBJECT is cached per domain (registry histograms
            # are process-immortal; an injected test source is resolved
            # once per domain, up front).
            hist = st["hist"]
            if hist.count - st["count"] < DEADLINE_RECOMPUTE_SAMPLES:
                return st["deadline_s"]
            return self._recompute_deadline(
                fault_domain, st["stage"], hist, hist.count
            )
        floor = self._policy.deadline_s
        if not self._adaptive or fault_domain not in BREAKER_DOMAINS:
            return floor
        hist = self._stage_hist(fault_domain)
        return self._recompute_deadline(
            fault_domain, fault_domain, hist, hist.count
        )

    def _recompute_deadline(self, fault_domain, stage, hist, count) -> float:
        floor = self._policy.deadline_s
        cap = self._cap_x * floor
        p999_us = hist.percentile(99.9) if count else 0
        if count < self._min_samples:
            derived, verdict = floor, "floor"
        else:
            raw = self._margin * p999_us / 1e6
            derived = min(max(floor, raw), cap)
            if derived == floor:
                verdict = "floor"
            elif raw > cap:
                verdict = "capped"
            else:
                verdict = "raised"
        with self._lock:
            st = self._deadline_state.get(fault_domain)
            prev = st["deadline_s"] if st else floor
            self._deadline_state[fault_domain] = {
                "count": count, "deadline_s": derived,
                "stage": stage, "hist": hist,
            }
            # monotonic: envelope_bound_s waiters must cover every
            # deadline ever handed out, not just the current one
            self._max_issued[fault_domain] = max(
                self._max_issued.get(fault_domain, floor), derived
            )
            if derived != prev:
                self._policies.pop(fault_domain, None)
            changed = (
                abs(derived - prev) / max(prev, 1e-9) >= _DEADLINE_JOURNAL_DELTA
            )
        # a half-open probe in this domain runs under the (possibly just
        # raised) adaptive envelope: its stale-probe release must keep
        # outwaiting it, or a legitimately slow probe gets a second probe
        # stacked onto the same struggling device (the invariant
        # CircuitBreaker.probe_timeout_s documents). Plain float store —
        # _tick_locked reads it under the breaker's own lock.
        breaker = self._breakers.get(fault_domain)
        if breaker is not None:
            breaker.probe_timeout_s = max(
                breaker.probe_timeout_s,
                2.0 * self.envelope_bound_s(fault_domain),
            )
        if changed:
            self._emit(
                DEADLINE,
                verdict,
                f"{fault_domain}: success-only device-leg p99.9 = "
                f"{p999_us} us over {count} samples -> deadline "
                f"{derived * 1e3:.1f} ms "
                f"(floor {floor * 1e3:.1f} ms, margin {self._margin}x, "
                f"cap {cap * 1e3:.1f} ms)",
                {
                    "fault_domain": fault_domain,
                    "source": f"coproc_device_leg_latency_us[{stage}]",
                    "p999_us": int(p999_us),
                    "samples": int(count),
                    "floor_ms": round(floor * 1e3, 3),
                    "margin": self._margin,
                    "deadline_ms": round(derived * 1e3, 3),
                    "prev_deadline_ms": round(prev * 1e3, 3),
                },
            )
        return derived

    def policy_for(self, fault_domain: str) -> faults.FaultPolicy:
        """The fault envelope a device leg in this domain runs under: the
        engine's configured policy with the domain's effective (possibly
        adaptively raised) per-attempt deadline."""
        d = self.deadline_s(fault_domain)
        pol = self._policies.get(fault_domain)
        if pol is None or pol.deadline_s != d:
            pol = dataclasses.replace(self._policy, deadline_s=d)
            self._policies[fault_domain] = pol
        return pol

    def envelope_bound_s(self, fault_domain: str) -> float:
        """Envelope of the LARGEST deadline this governor has ever issued
        for the domain (monotonic; starts at the static floor, so with no
        adaptive raise this is exactly the pre-governor static envelope —
        not the 8x cap, which would inflate every wedge-abandonment wait
        ~an order of magnitude for deadlines that were never raised).

        A waiter that must outwait an envelope computed CONCURRENTLY by
        another thread (a caller waiting on the harvest thread's fetch)
        sizes off this bound rather than its own policy_for() snapshot,
        and RE-READS it before declaring the owner dead: the owner updates
        the issued maximum inside its own policy_for() before starting the
        fetch, so a recompute landing between the two reads cannot leave
        the re-reading waiter shorter than the fetch it waits on."""
        with self._lock:
            issued = self._max_issued.get(
                fault_domain, self._policy.deadline_s
            )
        if issued == self._policy.deadline_s:
            return self._policy.envelope_s()
        return dataclasses.replace(
            self._policy, deadline_s=issued
        ).envelope_s()

    def max_envelope_s(self) -> float:
        """Worst-case wall of one retried interaction across ALL domains
        at the deadlines actually issued so far — what outer backstops
        (the pacemaker tick deadline) must outwait. Grows monotonically
        with adaptive raises; equals the static envelope until one
        happens."""
        return max(
            self.envelope_bound_s(d) for d in BREAKER_DOMAINS
        )

    # ------------------------------------------------------------ admission
    def configure_autotune(
        self,
        *,
        enabled: bool = True,
        group_ticks: int = 1,
        group_ticks_cap: int = 8,
        launch_depth: int = 4,
        launch_depth_cap: int = 8,
        hold_s: float = AUTOTUNE_HOLD_S,
        pressure_fn=None,
    ) -> None:
        """Arm the dynamic ``group_ticks_per_launch`` / ``launch_depth``
        verdicts. ``pressure_fn() -> (level, occupancy)`` is the budget
        plane's signal (None = no plane: the latency guard still runs).
        The configured values are the STARTING point; verdicts move within
        [1, cap] and may only change once per ``hold_s`` (hysteresis) —
        the same floors/caps posture as the adaptive-deadline machinery."""
        with self._lock:
            self._auto = {
                "enabled": bool(enabled),
                "group_ticks": max(1, int(group_ticks)),
                "group_ticks_cap": max(1, int(group_ticks_cap)),
                "launch_depth": max(1, int(launch_depth)),
                "launch_depth_cap": max(1, int(launch_depth_cap)),
                "hold_s": max(0.0, float(hold_s)),
                "last_change": -float("inf"),
                "pressure_fn": pressure_fn,
            }

    def launch_knobs(self) -> dict:
        """Current {"group_ticks", "launch_depth"} — recomputed here (the
        pacemaker polls once per tick), journaled under the ADMISSION
        domain only when a knob actually moves, and held still inside the
        hysteresis window no matter what the inputs do."""
        auto = self._auto
        if auto is None:
            return {"group_ticks": 1, "launch_depth": 4}
        with self._lock:
            gt, ld = auto["group_ticks"], auto["launch_depth"]
            if not auto["enabled"]:
                return {"group_ticks": gt, "launch_depth": ld}
            now = self._clock()
            if now - auto["last_change"] < auto["hold_s"]:
                return {"group_ticks": gt, "launch_depth": ld}
        # inputs read OUTSIDE the lock (pressure_fn reaches the plane,
        # the histogram percentile walks buckets)
        level, occ = "ok", 0.0
        fn = auto["pressure_fn"]
        if fn is not None:
            try:
                level, occ = fn()
            except Exception as exc:
                # classified: a dead pressure source silently pins the
                # knobs at the latency-guard-only posture
                faults.note_failure("autotune_pressure", exc)
                logger.exception("autotune pressure source failed")
        hist = self._stage_hist(faults.DEVICE_DISPATCH)
        p999_us = hist.percentile(99.9) if hist.count >= self._min_samples else None
        floor_us = self._policy.deadline_s * 1e6
        new_gt, new_ld, verdict = gt, ld, None
        if level == "critical":
            # memory first: collapse to the floors so held staged bytes
            # drain; admission keeps shedding the excess meanwhile
            new_gt, new_ld, verdict = 1, 1, "floor"
        elif level == "warn":
            new_gt, new_ld = max(1, gt - 1), max(1, ld - 1)
            verdict = "shrink"
        elif p999_us is None:
            # no device-leg evidence yet (idle engine, host-pinned box):
            # HOLD the configured knobs — growing on zero samples would
            # ratchet to the caps exactly when nothing supports it
            pass
        elif p999_us > _AUTOTUNE_SHRINK_FRAC * floor_us:
            # device-leg tail approaching the deadline: trade depth for
            # latency before the deadline machinery starts abandoning
            new_gt, new_ld = max(1, gt - 1), max(1, ld - 1)
            verdict = "shrink"
        elif p999_us < _AUTOTUNE_GROW_FRAC * floor_us:
            new_gt = min(auto["group_ticks_cap"], gt + 1)
            new_ld = min(auto["launch_depth_cap"], ld + 1)
            verdict = "grow"
        if (new_gt, new_ld) == (gt, ld):
            return {"group_ticks": gt, "launch_depth": ld}
        with self._lock:
            # re-check under the lock: a concurrent caller may have moved
            # the knobs (and armed the hold window) while we read inputs
            if self._clock() - auto["last_change"] < auto["hold_s"]:
                return {
                    "group_ticks": auto["group_ticks"],
                    "launch_depth": auto["launch_depth"],
                }
            auto["group_ticks"], auto["launch_depth"] = new_gt, new_ld
            auto["last_change"] = self._clock()
        self._emit(
            ADMISSION,
            verdict,
            f"launch knobs {verdict}: group_ticks {gt} -> {new_gt}, "
            f"launch_depth {ld} -> {new_ld} (pressure {level}, occupancy "
            f"{occ:.2f}, dispatch-leg p99.9 "
            f"{'n/a' if p999_us is None else int(p999_us)} us vs floor "
            f"{int(floor_us)} us)",
            {
                "pressure": level,
                "occupancy": round(occ, 4),
                "p999_us": None if p999_us is None else int(p999_us),
                "floor_us": int(floor_us),
                "group_ticks": new_gt,
                "launch_depth": new_ld,
                "prev_group_ticks": gt,
                "prev_launch_depth": ld,
            },
        )
        return {"group_ticks": new_gt, "launch_depth": new_ld}

    def autotune_snapshot(self) -> dict | None:
        auto = self._auto
        if auto is None:
            return None
        with self._lock:
            return {
                k: auto[k]
                for k in (
                    "enabled", "group_ticks", "group_ticks_cap",
                    "launch_depth", "launch_depth_cap", "hold_s",
                )
            }

    def note_shed(
        self, subsystem: str, retry_after_ms: int, inputs: dict | None = None
    ) -> None:
        """Open a shed EPISODE in the journal: the first shed journals,
        repeats inside the same episode only count (the bounded ring must
        keep the episode boundary, not 10^6 identical entries)."""
        open_ = self._shed_open
        with self._lock:
            first = subsystem not in open_
            open_.add(subsystem)
        if first:
            self._emit(
                ADMISSION,
                "shed",
                f"{subsystem}: admission shedding (retry after "
                f"{retry_after_ms} ms)",
                {"subsystem": subsystem, "retry_after_ms": retry_after_ms,
                 **(inputs or {})},
            )

    def note_admitted(self, subsystem: str) -> None:
        """Close the shed episode (first successful admit after sheds)."""
        open_ = self._shed_open
        if not open_:
            return
        with self._lock:
            was_open = subsystem in open_
            open_.discard(subsystem)
        if was_open:
            self._emit(
                ADMISSION,
                "resumed",
                f"{subsystem}: admission resumed",
                {"subsystem": subsystem},
            )

    # ------------------------------------------------------------ views
    def posture(self) -> dict:
        """Current per-domain stance: the operator's one-glance answer to
        "where is every adaptive knob sitting right now"."""
        with self._lock:
            modes = dict(self._posture_modes)
        return {
            "engine": self.engine_tag,
            HOST_POOL: modes.get(HOST_POOL),
            COLUMNAR_BACKEND: modes.get(COLUMNAR_BACKEND),
            DEVICE_LZ4: modes.get(DEVICE_LZ4),
            HARVEST_PATH: modes.get(HARVEST_PATH),
            SHARDED_SEAL: modes.get(SHARDED_SEAL),
            PARSE_PATH: modes.get(PARSE_PATH),
            MESH: modes.get(MESH),
            ADMISSION: modes.get(ADMISSION),
            "autotune": self.autotune_snapshot(),
            "breakers": self.breakers_snapshot(),
            "deadlines_ms": {
                d: round(self.deadline_s(d) * 1e3, 3) for d in BREAKER_DOMAINS
            },
            "adaptive_deadline": self._adaptive,
        }

    def snapshot(self) -> dict:
        """The ``stats()["governor"]`` / BENCH block: posture + the
        journal's summary (NOT the full journal — stats() is polled)."""
        return {"posture": self.posture(), "journal": self._journal.summary()}
