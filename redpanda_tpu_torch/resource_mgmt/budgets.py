"""The budget plane: per-subsystem byte accounts + the pressure signal (the
JAX package's resource_mgmt/budgets.py, copied). In this package the coproc
engine (coproc/engine.py ``TorchEngine(budget_plane=)``) is the only consumer
so far; the other accounts are carved as in the JAX package, so the split,
the pressure signal and the gauges read alike, and any account's occupancy
moves the pressure the engine listens to. The file names below are the JAX
package's consumers.

Parity with resource_mgmt/memory_groups.h: the reference statically divides
each shard's memory between subsystems so no single workload can balloon the
heap, and its autotune posture targets ~90% utilization with predictable
latency. Here one ``BudgetPlane`` per process carves a configurable total
into named ``MemoryAccount``s:

- ``kafka_produce`` — bytes of produce record payloads in flight between
  admission and the replicate ack (kafka/server/handlers.py).
- ``rpc``           — inbound internal-rpc request bodies between dispatch
  admission and response write (rpc/server.py InflightGate).
- ``coproc``        — staged transform rows held from ``submit_group``
  admission until the ticket harvests (coproc/engine.py), plus the column
  cache rides the same account's pressure signal.
- ``storage``       — append buffers inflight through ``DiskLog.append``.
- ``raft``          — replicate-batcher entries between submit and flush.

Two acquisition disciplines on ONE account type:

- ``try_acquire``/``release`` — synchronous, non-blocking, thread-safe: the
  ADMISSION users (kafka produce, coproc submit, rpc dispatch) shed with a
  retriable backpressure error instead of queueing, so exhaustion is a
  judged, counted event — never silent queue growth, never after-ack loss.
- ``async acquire``/``release`` — FIFO-waiting (the MemoryBudget
  semantics): the BUDGET users (storage append, raft batcher) sit *behind*
  an admission gate, so waiting is bounded backpressure, not unbounded
  queueing. Waiters are granted on the loop thread only.

``MemoryPressure`` (ok/warn/critical) derives from the worst account's
occupancy and is recomputed on every acquire/release; level CHANGES fire
registered listeners synchronously (the coproc engine trims its arena
free-list and column cache on critical). The exit threshold sits 5 points
below the entry threshold so occupancy oscillating on a boundary cannot
flap listeners.

Gauges: ``resource_account_held_bytes{account=}``, ``..._limit_bytes``,
``..._peak_bytes`` and ``resource_pressure_state`` (0 ok / 1 warn /
2 critical) — the occupancy inputs the governor's admission autotune and
the loadgen overload gate both judge.
"""

from __future__ import annotations

import asyncio
import logging
import threading
import weakref
from collections import deque

from redpanda_tpu_torch.metrics import registry

logger = logging.getLogger("rptorch.resources")

PRESSURE_OK = "ok"
PRESSURE_WARN = "warn"
PRESSURE_CRITICAL = "critical"
PRESSURE_LEVELS = (PRESSURE_OK, PRESSURE_WARN, PRESSURE_CRITICAL)
PRESSURE_NUM = {PRESSURE_OK: 0.0, PRESSURE_WARN: 1.0, PRESSURE_CRITICAL: 2.0}

# the memory_groups.h-style split of the plane total (fractions sum to 1)
DEFAULT_SPLIT: dict[str, float] = {
    "kafka_produce": 0.25,
    "rpc": 0.125,
    "coproc": 0.25,
    "storage": 0.25,
    "raft": 0.125,
}

# how far below the entry threshold occupancy must fall before the level
# steps back down (flap guard for workloads oscillating on a boundary)
_EXIT_MARGIN = 0.05


class MemoryAccount:
    """One subsystem's byte account.

    ``try_acquire`` is the admission path: non-blocking, thread-safe, and a
    request larger than the whole account is CLAMPED to the limit (it may
    proceed alone rather than being unservable forever — the reference's
    semaphore-units posture for oversized requests). Callers must release
    the value ``try_acquire`` returned, not the value they asked for.

    ``acquire`` is the waiting path (storage/raft budget users): FIFO
    waiters granted synchronously by ``release`` on the loop thread, the
    proven MemoryBudget discipline. Accounts whose releases happen on
    engine/executor threads must use only the try_acquire discipline —
    granting an asyncio future from a foreign thread is not safe, and the
    plane keeps the two user populations disjoint by construction.
    """

    def __init__(self, name: str, limit_bytes: int, plane: "BudgetPlane | None" = None):
        self.name = name
        self.limit = max(1, int(limit_bytes))
        self._held = 0
        self._peak = 0
        self._lock = threading.Lock()
        self._plane = plane
        self._waiters: deque[tuple[int, asyncio.Future]] = deque()

    # ------------------------------------------------------------ admission
    def try_acquire(self, n: int) -> int:
        """Reserve up to ``n`` bytes without blocking. Returns the amount
        actually reserved (clamped to the limit; 0 means REFUSED — the
        caller sheds). Zero/negative requests reserve nothing and admit."""
        if n <= 0:
            return 0
        n = min(int(n), self.limit)
        with self._lock:
            if self._held + n > self.limit:
                return 0
            self._held += n
            if self._held > self._peak:
                self._peak = self._held
        self._pressure_changed()
        return n

    # ------------------------------------------------------------ waiting
    async def acquire(self, n: int) -> int:
        """Reserve ``n`` bytes (clamped to the limit), waiting FIFO until
        available. Loop-thread only (see class docstring)."""
        if n <= 0:
            return 0
        n = min(int(n), self.limit)
        granted = False
        with self._lock:
            if self._held + n <= self.limit and not self._waiters:
                self._held += n
                if self._held > self._peak:
                    self._peak = self._held
                granted = True
        if granted:
            self._pressure_changed()
            return n
        fut = asyncio.get_running_loop().create_future()
        with self._lock:
            self._waiters.append((n, fut))
        try:
            await fut  # resolved by _drain with the bytes already deducted
        except asyncio.CancelledError:
            if fut.done() and not fut.cancelled():
                self.release(n)  # grant landed before cancellation
            else:
                with self._lock:
                    try:
                        self._waiters.remove((n, fut))
                    except ValueError:
                        pass
                self._drain()
            raise
        self._pressure_changed()
        return n

    def release(self, n: int) -> None:
        if n <= 0:
            return
        with self._lock:
            self._held = max(0, self._held - int(n))
        self._drain()
        self._pressure_changed()

    def _drain(self) -> None:
        """Grant parked FIFO waiters (same liveness rules as MemoryBudget:
        cancelled/dead-loop heads are skipped, never block live waiters)."""
        to_grant = []
        with self._lock:
            while self._waiters:
                n, fut = self._waiters[0]
                if fut.cancelled():
                    self._waiters.popleft()
                    continue
                try:
                    dead = fut.get_loop().is_closed()
                except RuntimeError:
                    dead = True
                if dead:
                    self._waiters.popleft()
                    continue
                if self._held + n > self.limit:
                    break
                self._waiters.popleft()
                self._held += n
                if self._held > self._peak:
                    self._peak = self._held
                to_grant.append(fut)
        for fut in to_grant:
            if not fut.done():
                fut.set_result(None)

    def _pressure_changed(self) -> None:
        if self._plane is not None:
            self._plane._recompute_pressure(self)

    # ------------------------------------------------------------ views
    @property
    def held(self) -> int:
        return self._held

    @property
    def peak(self) -> int:
        return self._peak

    def occupancy(self) -> float:
        with self._lock:
            return self._held / self.limit

    def reset_peak(self) -> None:
        with self._lock:
            self._peak = self._held

    def snapshot(self) -> dict:
        with self._lock:
            held, peak = self._held, self._peak
        return {
            "limit_bytes": self.limit,
            "held_bytes": held,
            "peak_bytes": peak,
            "occupancy": round(held / self.limit, 4),
            "waiters": len(self._waiters),
        }


class BudgetPlane:
    """The process budget split into named accounts + the pressure signal."""

    def __init__(
        self,
        total_bytes: int = 512 * 1024 * 1024,
        split: dict[str, float] | None = None,
        *,
        warn_pct: float = 0.75,
        critical_pct: float = 0.90,
        register_gauges: bool = False,
    ) -> None:
        self.total_bytes = max(1, int(total_bytes))
        split = dict(split or DEFAULT_SPLIT)
        self.warn_pct = float(warn_pct)
        self.critical_pct = float(critical_pct)
        # leakwatch (coproc/leakwatch.py) records each account's balance
        # when on; off, wrap returns the raw account. Imported here:
        # resource_mgmt must not pull coproc in when it is imported.
        from redpanda_tpu_torch.coproc import leakwatch

        self.accounts: dict[str, MemoryAccount] = {
            name: leakwatch.wrap(
                MemoryAccount(name, max(1, int(self.total_bytes * frac)), plane=self),
                f"account.{name}")
            for name, frac in split.items()
        }
        self._level = PRESSURE_OK
        self._level_lock = threading.Lock()
        self._listeners: list = []
        if register_gauges:
            self.register_gauges()

    def account(self, name: str) -> MemoryAccount:
        return self.accounts[name]

    # ------------------------------------------------------------ pressure
    def pressure(self) -> str:
        with self._level_lock:
            return self._level

    def max_occupancy(self) -> tuple[str, float]:
        """(account name, occupancy) of the fullest account."""
        worst_name, worst = "", 0.0
        for name, acct in self.accounts.items():
            occ = acct.occupancy()
            if occ >= worst:
                worst_name, worst = name, occ
        return worst_name, worst

    def add_pressure_listener(self, fn) -> None:
        """``fn(level: str, snapshot: dict)`` fired synchronously on level
        CHANGE from whatever thread moved the occupancy — listeners must be
        cheap and thread-safe (the engine's arena/colcache trims are).
        The plane outlives its listeners' owners (it is process-wide):
        owners that die must ``remove_pressure_listener`` (the engine does
        in ``shutdown()``) or their dead closures accumulate."""
        self._listeners.append(fn)

    def remove_pressure_listener(self, fn) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def _recompute_pressure(self, acct: MemoryAccount | None = None) -> None:
        # Fast path for the admission hot pair: in the ok regime, a
        # mutation that leaves ITS OWN account below the warn line cannot
        # move the level (every other account sat below it at the last
        # recompute, and each mutation recomputes) — one occupancy read
        # instead of the full account sweep.
        if acct is not None:
            with self._level_lock:
                level = self._level
            if level == PRESSURE_OK and acct.occupancy() < self.warn_pct:
                return
        _, occ = self.max_occupancy()
        with self._level_lock:
            old = self._level
            if occ >= self.critical_pct:
                new = PRESSURE_CRITICAL
            elif occ >= self.warn_pct:
                # already critical: hold until occupancy exits with margin
                if old == PRESSURE_CRITICAL and occ >= self.critical_pct - _EXIT_MARGIN:
                    new = PRESSURE_CRITICAL
                else:
                    new = PRESSURE_WARN
            else:
                if (
                    old != PRESSURE_OK
                    and occ >= self.warn_pct - _EXIT_MARGIN
                ):
                    new = PRESSURE_WARN  # hold inside the exit margin
                else:
                    new = PRESSURE_OK
            if new == old:
                return
            self._level = new
        snap = self.snapshot()
        for fn in list(self._listeners):
            try:
                fn(new, snap)
            except Exception:
                logger.exception("pressure listener failed")

    # ------------------------------------------------------------ views
    def snapshot(self) -> dict:
        worst_name, worst = self.max_occupancy()
        return {
            "total_bytes": self.total_bytes,
            "pressure": self.pressure(),
            "warn_pct": self.warn_pct,
            "critical_pct": self.critical_pct,
            "max_occupancy": round(worst, 4),
            "max_occupancy_account": worst_name,
            "accounts": {
                name: acct.snapshot() for name, acct in self.accounts.items()
            },
        }

    # ------------------------------------------------------------ gauges
    def register_gauges(self) -> None:
        """Weakref-bound labeled gauges (the governor-gauge posture: a new
        plane's registration overwrites the old one's; a collected plane
        reads -1 instead of stale occupancy)."""
        ref = weakref.ref(self)
        for name in self.accounts:
            registry.gauge(
                "resource_account_held_bytes",
                _acct_gauge(ref, name, "held"),
                "Bytes currently held in the subsystem memory account",
                account=name,
            )
            registry.gauge(
                "resource_account_limit_bytes",
                _acct_gauge(ref, name, "limit"),
                "Configured byte limit of the subsystem memory account",
                account=name,
            )
            registry.gauge(
                "resource_account_peak_bytes",
                _acct_gauge(ref, name, "peak"),
                "Peak held bytes since start (or reset_peak)",
                account=name,
            )
        registry.gauge(
            "resource_pressure_state",
            _pressure_gauge(ref),
            "Memory pressure level (0 ok, 1 warn, 2 critical, -1 no plane)",
        )


def _acct_gauge(ref, name: str, field: str):
    def fn() -> float:
        plane = ref()
        if plane is None:
            return -1.0
        acct = plane.accounts[name]
        return float(getattr(acct, field))

    return fn


def _pressure_gauge(ref):
    def fn() -> float:
        plane = ref()
        if plane is None:
            return -1.0
        return PRESSURE_NUM.get(plane.pressure(), -1.0)

    return fn


# ------------------------------------------------------------ process plane
# Installed by Application.start (config resource_memory_total_mb); bare
# engines/tests run plane-less (admission disabled) unless they install
# their own. A module accessor rather than config plumbing because the
# storage/raft charge sites sit below the service graph (DiskLog has no
# broker reference), mirroring how shard_local_cfg() is reached.
_current: BudgetPlane | None = None


def install(plane: BudgetPlane | None) -> None:
    """Install the process plane. KNOWN LIMITATION: in-process multi-
    broker stacks (tests, inproc loadgen) share one interpreter, so the
    last Application's plane wins and every node's storage/raft appends
    charge it — per-node attribution there is approximate by design
    (mirroring the shared metrics registry). Real broker processes (the
    proc backend, production) each own exactly one plane. The admission
    controllers (kafka produce, coproc, rpc) are NOT affected: they hold
    direct references to their own broker's plane."""
    global _current
    _current = plane


def current() -> BudgetPlane | None:
    return _current


def account_or_none(name: str) -> MemoryAccount | None:
    plane = _current
    if plane is None:
        return None
    return plane.accounts.get(name)
