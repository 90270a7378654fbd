"""Coproc fault domains: deadlines, bounded retry and the device breakers
(the JAX package's coproc/faults.py, ported).

The engine's device interactions (dispatch, mask fetch, harvest, the mesh
launch) share one failure physics: a healthy card answers in microseconds
to milliseconds, a flaky one answers late or throws, and a wedged copy
never answers at all -- it hangs inside the wait rather than raising. This
module turns that physics into policy, in one place:

- ``FaultPolicy`` -- per-attempt deadline + bounded retries with
  exponential backoff and jitter (the engine's ``device_deadline_ms``,
  ``launch_retries``, ``retry_backoff_ms``). The jitter draws from the
  policy's own ``random.Random``, which a test seeds.
- ``fetch_with_deadline`` -- runs a device leg on a reusable *abandonable*
  daemon worker: on deadline the caller walks away and the worker, if it
  ever finishes, discards the stale result and returns itself to the free
  pool (no thread growth across completed-late fetches; a truly wedged
  fetch strands at most its one worker).
- ``retry_call`` -- the two combined.
- ``CircuitBreaker`` -- per-domain closed -> open -> half-open machine:
  ``threshold`` consecutive device failures open it; after ``cooldown_s``
  one half-open probe launch is admitted and its outcome re-closes or
  re-opens the breaker.
- ``note_failure`` -- classified failure accounting: every failure lands
  in ``coproc_failures_total{domain,kind}`` and logs once per (domain,
  kind) at WARNING (DEBUG after).

Where the JAX package ends an exhausted envelope or an open breaker on its
exact host path, the port's engine raises into the script's error policy
(an open breaker as ``DeviceUnavailable``): no host evaluation takes the
card's place. The mesh domain's open breaker demotes a launch to the
single-card lane, which still runs its kernel on the card.

Never retried: besides the JAX package's programming errors
(``PROGRAMMING_ERRORS``), a failed kernel build (``build.BuildError``)
and a wrapper's argument check (``ValueError``, ``TypeError``, raised
before a launch) say that the call is wrong, not that the card is
degraded. ``retry_call`` re-raises them at once and marks them
(``unretried``); the engine then gives them no breaker verdict and
re-raises them out of ``submit_group`` instead of feeding an error policy.

The honey-badger probes (finjector.py) of the coproc fault domains are
registered here; every injectable site calls ``inject(<domain>)``, an
attribute check unless the badger was enabled.
"""

from __future__ import annotations

import logging
import queue
import random
import threading
import time
from dataclasses import dataclass, field

from redpanda_tpu_torch.build import BuildError
from redpanda_tpu_torch.coproc import lockwatch
from redpanda_tpu_torch.finjector import ProbeTriggered, honey_badger
from redpanda_tpu_torch.observability import probes

logger = logging.getLogger("rptorch.coproc.faults")

# ------------------------------------------------------------ fault domains
MODULE = "coproc"
DEVICE_DISPATCH = "device_dispatch"
MASK_FETCH = "mask_fetch"
HARVEST = "harvest"
SHARD_WORKER = "shard_worker"
SANDBOX_COMPILE = "sandbox_compile"
# the mesh lane's stacked predicate launch: its own domain, so that a flaky
# mesh path demotes mesh launches to the single-card lane while plain
# dispatch keeps its own breaker
MESH_DISPATCH = "mesh_dispatch"

honey_badger.register_probe(
    MODULE, DEVICE_DISPATCH, MASK_FETCH, HARVEST, SHARD_WORKER,
    SANDBOX_COMPILE, MESH_DISPATCH,
)


def inject(probe: str) -> None:
    """Honey-badger probe site for a coproc fault domain (sync paths)."""
    honey_badger.inject_sync(MODULE, probe)


class DeadlineExceeded(Exception):
    """A device leg outlived its per-attempt deadline (wedged link)."""


class DeviceUnavailable(Exception):
    """A domain's breaker is open (or its one half-open probe is in
    flight): the launch was refused without touching the card."""

    def __init__(self, domain: str):
        super().__init__(f"{domain}: circuit breaker open, device leg refused")
        self.domain = domain


# Failures that indicate a bug in OUR code, not a degraded environment:
# retrying would mask the bug, so they always propagate.
PROGRAMMING_ERRORS = (AssertionError, NameError, UnboundLocalError)
# Inside a device leg, a kernel that cannot be built and a wrapper's
# argument check are bugs of the same kind.
NEVER_RETRIED = PROGRAMMING_ERRORS + (BuildError, ValueError, TypeError)


def unretried(exc: BaseException) -> bool:
    """Whether ``exc`` re-raises past every error policy: a programming
    error anywhere, a build failure, or a failure ``retry_call`` refused to
    retry. A python script's own exception (``rp_script``: a NameError in
    user code, say) is the script's failure, never one of these."""
    if getattr(exc, "rp_script", False):
        return False
    return isinstance(exc, PROGRAMMING_ERRORS + (BuildError,)) or getattr(
        exc, "rp_unretried", False)


def kind_of(exc: BaseException) -> str:
    if isinstance(exc, DeadlineExceeded):
        return "deadline"
    if isinstance(exc, ProbeTriggered):
        return "injected"
    return type(exc).__name__


# warn-once registry: the first failure of a (domain, kind) pair is loud,
# repeats are DEBUG -- a flapping link must not flood the log, but neither
# may any class of degradation stay invisible (the counter sees them all).
_warned: set[tuple[str, str]] = set()
_warned_lock = threading.Lock()


def reset_warned() -> None:
    """Test hook: forget which (domain, kind) pairs have warned."""
    with _warned_lock:
        _warned.clear()


def note_failure(
    domain: str, exc: BaseException, *, reraise_programming: bool = False
) -> str:
    """Account one classified failure; returns the kind label.

    With ``reraise_programming=True`` (device legs: our code between the
    probe site and the device), an ``unretried`` failure re-raises after
    being counted."""
    kind = kind_of(exc)
    probes.coproc_failure_counter(domain, kind).inc()
    with _warned_lock:
        first = (domain, kind) not in _warned
        if first:
            _warned.add((domain, kind))
    if first:
        logger.warning(
            "coproc fault domain %r degraded: %s [%s] "
            "(repeats log at DEBUG; coproc_failures_total counts all)",
            domain, exc, kind,
        )
    else:
        logger.debug("coproc fault domain %r: %s [%s]", domain, exc, kind)
    if reraise_programming and unretried(exc):
        raise exc
    return kind


# ------------------------------------------------------------ fault policy
@dataclass(frozen=True)
class FaultPolicy:
    """Deadline + bounded-retry envelope for one device interaction."""

    deadline_s: float = 30.0
    retries: int = 2
    backoff_s: float = 0.05
    backoff_cap_s: float = 2.0
    # the jitter's source; a test passes a seeded one
    rng: random.Random = field(default_factory=random.Random, compare=False, repr=False)

    def backoff(self, attempt: int) -> float:
        """Exponential backoff with jitter (50-100% of the step): retrying
        launches from many scripts must not re-converge on the device in
        lockstep after a shared blip."""
        step = min(self.backoff_cap_s, self.backoff_s * (2 ** attempt))
        return step * (0.5 + self.rng.random() * 0.5)

    def envelope_s(self) -> float:
        """Worst-case wall time of ONE full retried interaction: every
        attempt runs to its deadline, every backoff takes its full step.
        Anything that waits on such an interaction (a caller waiting for
        the harvest thread's verdict, the breaker's stale-probe release)
        must wait at least this long, or it declares the interaction dead
        while it is legitimately mid-envelope."""
        backoffs = sum(
            min(self.backoff_cap_s, self.backoff_s * (2 ** a))
            for a in range(self.retries)
        )
        return (self.retries + 1) * self.deadline_s + backoffs


# ----------------------------------------------- abandonable fetch workers
# A wedged device wait cannot be cancelled, only abandoned. Workers are
# plain daemon threads (concurrent.futures joins its workers at interpreter
# exit, which would hang shutdown on a wedge) that are REUSED: a worker
# whose fetch completes goes back to the free list, including one that
# completes after its caller timed out -- the late result is discarded and
# the thread reclaimed, so completed-late fetches never grow the pool.


class _Job:
    __slots__ = ("fn", "state", "result", "exc", "event")

    def __init__(self, fn):
        self.fn = fn
        self.state = "pending"  # pending -> done | abandoned
        self.result = None
        self.exc: BaseException | None = None
        self.event = threading.Event()


_pool_lock = threading.Lock()
_free_workers: list["_FetchWorker"] = []
_workers_created = 0


class _FetchWorker(threading.Thread):
    def __init__(self, idx: int):
        super().__init__(name=f"rptorch-fault-fetch-{idx}", daemon=True)
        # one job at a time: a worker is checked out of the free list per
        # fetch and holds its job until it completes or is abandoned
        self._jobs: "queue.Queue[_Job]" = queue.Queue()
        self.start()

    def submit(self, job: _Job) -> None:
        self._jobs.put(job)

    def run(self) -> None:
        while True:
            job = self._jobs.get()
            try:
                res, exc = job.fn(), None
            except BaseException as e:  # noqa: BLE001 -- delivered to the caller
                res, exc = None, e
            with _pool_lock:
                # the leg's closure may hold CUDA tensors (a cache entry's
                # columns): an idle worker must not keep them alive
                job.fn = None
                abandoned = job.state == "abandoned"
                if abandoned:
                    # late completion: discard the stale result (it may pin
                    # a device buffer) and reclaim this thread
                    job.result = job.exc = None
                    _free_workers.append(self)
                else:
                    job.state = "done"
                    job.result, job.exc = res, exc
            if not abandoned:
                job.event.set()
            # nor may this frame's locals, while it waits for the next job
            job = res = exc = None


def fetch_pool_stats() -> dict:
    """{'created', 'free'}: the no-thread-growth regression test's view."""
    with _pool_lock:
        return {"created": _workers_created, "free": len(_free_workers)}


def fetch_with_deadline(fn, deadline_s: float | None):
    """Run ``fn()`` on an abandonable worker; raise DeadlineExceeded after
    ``deadline_s``. ``None`` runs inline (no deadline, no thread)."""
    global _workers_created
    if deadline_s is None:
        return fn()
    with _pool_lock:
        worker = _free_workers.pop() if _free_workers else None
        if worker is None:
            _workers_created += 1
            idx = _workers_created
    if worker is None:
        worker = _FetchWorker(idx)
    job = _Job(fn)
    worker.submit(job)
    finished = job.event.wait(deadline_s)
    with _pool_lock:
        if not finished and job.state == "done":
            finished = True  # completion raced the timeout: take the result
        if finished:
            _free_workers.append(worker)
        else:
            job.state = "abandoned"
    if not finished:
        raise DeadlineExceeded(
            f"device leg exceeded its {deadline_s:.3f}s deadline"
        )
    if job.exc is not None:
        raise job.exc
    return job.result


def retry_call(fn, policy: FaultPolicy, domain: str, *, count=None, inline: bool = False):
    """``fn()`` under the policy's per-attempt deadline, retried with
    backoff+jitter up to ``policy.retries`` times. The last failure
    propagates (callers decide what it means); ``NEVER_RETRIED`` failures
    and SystemExit (honey-badger terminate) never retry, and the former
    are marked ``unretried``. ``count`` is the engine's ``_stat_add``, so
    that retries land in stats(). ``inline=True`` runs every attempt on
    the calling thread with no deadline: a leg that cannot hang, such as
    the plain versions on the CPU."""
    last: BaseException | None = None
    for attempt in range(policy.retries + 1):
        try:
            return fetch_with_deadline(fn, None if inline else policy.deadline_s)
        except NEVER_RETRIED as exc:
            exc.rp_unretried = True
            raise
        except Exception as exc:
            last = exc
            if attempt < policy.retries:
                probes.coproc_retries_total.inc()
                if count is not None:
                    count("n_retries", 1.0)
                logger.debug(
                    "retrying %s after %s [attempt %d/%d]",
                    domain, kind_of(exc), attempt + 1, policy.retries,
                )
                time.sleep(policy.backoff(attempt))
    assert last is not None
    raise last


# ------------------------------------------------------------ circuit breaker
STATE_CLOSED = "closed"
STATE_OPEN = "open"
STATE_HALF_OPEN = "half_open"
STATE_NUM = {STATE_CLOSED: 0.0, STATE_OPEN: 1.0, STATE_HALF_OPEN: 2.0}


class CircuitBreaker:
    """Per-domain device circuit breaker.

    closed --[threshold consecutive failures]--> open
    open --[cooldown elapsed]--> half_open (admits ONE probe launch)
    half_open --[probe success]--> closed / --[probe failure]--> open

    While not closed, ``allow_device()`` answers False (except to the one
    half-open probe) and the engine refuses the domain's device legs.
    ``clock`` is injectable so the state machine is testable without
    sleeping through cooldowns.
    """

    def __init__(
        self,
        threshold: int = 5,
        cooldown_s: float = 30.0,
        clock=time.monotonic,
        probe_timeout_s: float | None = None,
        name: str = "",
        listener=None,
    ) -> None:
        self.threshold = max(1, int(threshold))
        self.cooldown_s = float(cooldown_s)
        # identity + transition hook for the governor's decision journal:
        # ``listener(name, old_state, new_state, reason, info)`` fires AFTER
        # the breaker's lock is released (a listener that re-enters breaker
        # state, or appends to a locked journal, must not deadlock here)
        self.name = name
        self._listener = listener
        # how long an admitted half-open probe may run before its slot is
        # presumed abandoned. MUST exceed the probe launch's own retry
        # envelope (FaultPolicy.envelope_s) or a legitimately slow probe
        # gets a second probe stacked onto the same struggling device.
        self.probe_timeout_s = (
            float(probe_timeout_s) if probe_timeout_s is not None
            else self.cooldown_s
        )
        self._clock = clock
        self._lock = lockwatch.wrap(threading.Lock(), "CircuitBreaker._lock")
        self._state = STATE_CLOSED
        self._consecutive = 0
        self._opened_at = 0.0
        self._probe_inflight = False
        self._probe_started_at = 0.0
        self.trips = 0

    def _tick_locked(self) -> None:
        if (
            self._state == STATE_OPEN
            and self._clock() - self._opened_at >= self.cooldown_s
        ):
            self._state = STATE_HALF_OPEN
            self._probe_inflight = False
        elif (
            self._state == STATE_HALF_OPEN
            and self._probe_inflight
            and self._clock() - self._probe_started_at >= self.probe_timeout_s
        ):
            # stale probe: the admitted launch never reported a verdict
            # (e.g. it failed on a host-side fault before touching the
            # device, which is no verdict on the device at all). Without
            # this the breaker would stay half-open for good.
            self._probe_inflight = False

    def _tick_event_locked(self, events: list) -> None:
        """Run _tick_locked and capture its transition (if any) while the
        lock is STILL held: the (old, new, reason, info) tuple must be a
        consistent snapshot of one transition."""
        old = self._state
        self._tick_locked()
        if self._state != old:
            events.append((
                old, self._state,
                "cooldown elapsed; half-open probe slot available",
                self._info_locked(),
            ))

    def _info_locked(self) -> dict:
        return {"consecutive_failures": self._consecutive, "trips": self.trips}

    def _fire(self, events: list) -> None:
        """Deliver captured transitions OUTSIDE the lock (the listener
        appends to the governor's journal, which takes its own locks)."""
        if self._listener is None:
            return
        for old, new, reason, info in events:
            try:
                self._listener(self.name, old, new, reason, info)
            except Exception:  # observability must not kill the data path
                logger.exception("breaker transition listener failed")

    @property
    def state(self) -> str:
        events: list = []
        with self._lock:
            self._tick_event_locked(events)
            state = self._state
        self._fire(events)
        return state

    def allow_device(self) -> bool:
        """May the next launch touch the device? Half-open admits exactly
        one probe at a time; everyone else is refused until that probe's
        verdict lands."""
        events: list = []
        with self._lock:
            self._tick_event_locked(events)
            if self._state == STATE_CLOSED:
                allowed = True
            elif self._state == STATE_HALF_OPEN and not self._probe_inflight:
                self._probe_inflight = True
                self._probe_started_at = self._clock()
                allowed = True
            else:
                allowed = False
        self._fire(events)
        return allowed

    def record_success(self) -> None:
        events: list = []
        with self._lock:
            self._tick_event_locked(events)
            self._consecutive = 0
            if self._state == STATE_HALF_OPEN:
                logger.info(
                    "coproc breaker %s re-closed after successful half-open "
                    "probe", self.name or "(unnamed)",
                )
                old = self._state
                self._state = STATE_CLOSED
                self._probe_inflight = False
                events.append((
                    old, STATE_CLOSED,
                    "half-open probe succeeded; device re-admitted",
                    self._info_locked(),
                ))
        self._fire(events)

    def record_failure(self) -> None:
        events: list = []
        with self._lock:
            self._tick_event_locked(events)
            self._consecutive += 1
            tripped = False
            if self._state == STATE_HALF_OPEN:
                tripped = True  # probe failed: straight back to open
            elif (
                self._state == STATE_CLOSED
                and self._consecutive >= self.threshold
            ):
                tripped = True
            if tripped:
                old = self._state
                self._state = STATE_OPEN
                self._opened_at = self._clock()
                self._probe_inflight = False
                self.trips += 1
                probes.coproc_breaker_trips.inc()
                logger.warning(
                    "coproc breaker %s OPEN after %d consecutive device "
                    "failures (trip #%d); the domain's launches fail into "
                    "their error policy, re-probe in %.1fs",
                    self.name or "(unnamed)", self._consecutive, self.trips,
                    self.cooldown_s,
                )
                events.append((
                    old, STATE_OPEN,
                    f"{self._consecutive} consecutive failure(s) against "
                    f"threshold {self.threshold}",
                    self._info_locked(),
                ))
        self._fire(events)

    def snapshot(self) -> dict:
        events: list = []
        with self._lock:
            self._tick_event_locked(events)
            out = {
                "state": self._state,
                "consecutive_failures": self._consecutive,
                "trips": self.trips,
                "threshold": self.threshold,
                "cooldown_ms": round(self.cooldown_s * 1000.0),
            }
            if self.name:
                out["domain"] = self.name
        self._fire(events)
        return out
