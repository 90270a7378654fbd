"""Admission control over the budget plane: shed-before-ack, never silent
(the JAX package's resource_mgmt/admission.py, copied). In this package
``TorchEngine.submit_group`` is the one admission point so far; the list
below is the JAX package's.

Parity with the reference's connection_context memory units + the Kafka
quota/throttle posture: a subsystem that cannot reserve its bytes REFUSES
the work up front with a retriable backpressure signal and a throttle
delay, instead of queueing unboundedly or failing after the ack. Three
admission points consume this module:

- kafka produce (kafka/server/handlers.py): shed → per-partition retriable
  ``throttling_quota_exceeded`` (KIP-599) + ``throttle_time_ms`` — the
  produce never reaches ``replicate``, so a shed write is never readable.
- coproc ``submit_group`` (coproc/engine.py): shed → ``ShedError`` before
  any dispatch; the pacemaker backs off ``retry_after_ms`` and re-reads
  the same offsets (nothing lost, nothing duplicated).
- rpc dispatch (rpc/server.py): ``InflightGate`` sheds whole requests at
  dispatch with ``wire.STATUS_BACKPRESSURE`` before the handler runs.

The throttle delay ramps with occupancy past the warn line — a barely-full
account answers "retry soon", a saturated one "back off hard" — so an
open-loop flood converges to the knee instead of retry-storming it.
"""

from __future__ import annotations

import threading
import weakref

from redpanda_tpu_torch.metrics import Counter, registry
from redpanda_tpu_torch.resource_mgmt.budgets import MemoryAccount


class ShedError(Exception):
    """Admission refused: retriable backpressure, never a data fault.

    ``retry_after_ms`` is the throttle hint the transport-level reply
    carries (kafka ``throttle_time_ms``, pacemaker backoff)."""

    def __init__(self, subsystem: str, retry_after_ms: int, detail: str = ""):
        self.subsystem = subsystem
        self.retry_after_ms = int(retry_after_ms)
        super().__init__(
            f"{subsystem} admission shed (retry after {retry_after_ms} ms)"
            + (f": {detail}" if detail else "")
        )


# lazy per-subsystem shed counters (<subsystem>_admission_shed_total),
# check-then-create under a lock like probes.coproc_failure_counter
_shed_counters: dict[str, Counter] = {}
_shed_lock = threading.Lock()


def shed_counter(subsystem: str) -> Counter:
    c = _shed_counters.get(subsystem)
    if c is None:
        with _shed_lock:
            c = _shed_counters.get(subsystem)
            if c is None:
                c = registry.counter(
                    f"{subsystem}_admission_shed_total",
                    "Requests shed by admission control (retriable "
                    "backpressure, counted not lost)",
                )
                _shed_counters[subsystem] = c
    return c


class AdmissionController:
    """Admission over one memory account.

    ``try_admit(n)`` reserves before the work is acked; a refusal returns
    ``(0, retry_after_ms)`` and counts one shed. The caller must
    ``release`` exactly what was reserved once the work's bytes leave the
    subsystem (response drained / ticket harvested), on every path —
    including exceptions (the leak-on-exception tests pin this)."""

    def __init__(
        self,
        account: MemoryAccount,
        subsystem: str,
        *,
        base_throttle_ms: int = 50,
        max_throttle_ms: int = 1000,
        warn_pct: float = 0.75,
        on_episode=None,
    ) -> None:
        self.account = account
        self.subsystem = subsystem
        self.base_throttle_ms = int(base_throttle_ms)
        self.max_throttle_ms = int(max_throttle_ms)
        self._warn_pct = float(warn_pct)
        # episode hook: ``on_episode(kind, info)`` fires on the FIRST shed
        # of an episode and on the first admit after one ("resumed") — the
        # application journals these through the governor so the decision
        # journal reconstructs every shed episode without a per-request
        # entry flooding the bounded ring
        self._on_episode = on_episode
        self._episode_open = False
        # counter lock: try_admit runs on engine/executor threads AND the
        # loop concurrently; unlocked += would lose updates
        self._stats_lock = threading.Lock()
        self._sheds = 0
        self._admitted = 0
        self._counter = shed_counter(subsystem)

    def throttle_ms(self) -> int:
        """Deterministic occupancy ramp: base at the warn line, max at a
        full account (linear between) — testable, no randomness."""
        occ = self.account.occupancy()
        if occ <= self._warn_pct:
            return self.base_throttle_ms
        frac = min(1.0, (occ - self._warn_pct) / max(1e-9, 1.0 - self._warn_pct))
        return int(
            self.base_throttle_ms
            + frac * (self.max_throttle_ms - self.base_throttle_ms)
        )

    def try_admit(self, n: int) -> tuple[int, int]:
        """(reserved_bytes, retry_after_ms). reserved == 0 for n > 0 means
        SHED (retry_after_ms says when); n <= 0 admits reserving nothing —
        and touches NO episode state (a zero-byte request during an open
        shed episode is not evidence the account recovered)."""
        if n <= 0:
            return 0, 0
        reserved = self.account.try_acquire(n)
        if n > 0 and reserved == 0:
            retry_ms = self.throttle_ms()
            with self._stats_lock:
                self._sheds += 1
                first = not self._episode_open
                self._episode_open = True
            self._counter.inc()
            if first and self._on_episode is not None:
                self._on_episode("shed", {
                    "subsystem": self.subsystem,
                    "requested_bytes": int(n),
                    "held_bytes": self.account.held,
                    "limit_bytes": self.account.limit,
                    "retry_after_ms": retry_ms,
                })
            return 0, retry_ms
        with self._stats_lock:
            self._admitted += 1
            resumed = self._episode_open
            self._episode_open = False
        if resumed and self._on_episode is not None:
            self._on_episode("resumed", {"subsystem": self.subsystem})
        return reserved, 0

    def admit(self, n: int) -> int:
        """Reserve or raise ShedError. Returns the reserved amount the
        caller must release."""
        reserved, retry_ms = self.try_admit(n)
        if n > 0 and reserved == 0:
            raise ShedError(self.subsystem, retry_ms)
        return reserved

    def release(self, reserved: int) -> None:
        self.account.release(reserved)

    def snapshot(self) -> dict:
        with self._stats_lock:
            admitted, sheds = self._admitted, self._sheds
        return {
            "subsystem": self.subsystem,
            "admitted": admitted,
            "sheds": sheds,
            "base_throttle_ms": self.base_throttle_ms,
            "max_throttle_ms": self.max_throttle_ms,
            "account": self.account.snapshot(),
        }


class InflightGate:
    """Dispatch-time inflight cap for the rpc server: bounds BOTH request
    count and body bytes (charged to the rpc account so the occupancy
    gauges and the pressure signal see them). ``try_enter`` runs on the
    accept loop per inbound request — two int compares on the admit path."""

    def __init__(
        self,
        account: MemoryAccount,
        *,
        max_requests: int = 1024,
        subsystem: str = "rpc",
        on_episode=None,
    ) -> None:
        self.account = account
        self.max_requests = max(1, int(max_requests))
        self._inflight = 0
        self._lock = threading.Lock()
        self._sheds = 0
        self._counter = shed_counter(subsystem)
        # same episode contract as AdmissionController: first shed /
        # first admit-after-sheds fire the hook once, so the decision
        # journal reconstructs rpc shed episodes too
        self._on_episode = on_episode
        self._episode_open = False
        self._subsystem = subsystem
        # live inflight depth as a gauge (weakref posture, like the
        # budget-plane account gauges): the pandatrend history ring
        # samples it into the `inflight:rpc` counter track
        ref = weakref.ref(self)
        registry.gauge(
            "rpc_inflight_requests",
            lambda: float(g._inflight) if (g := ref()) is not None else -1.0,
            "Requests currently inside the rpc dispatch inflight gate "
            "(-1 when the gate has been collected)",
            subsystem=subsystem,
        )

    def _shed(self, why: str) -> None:
        with self._lock:
            self._sheds += 1
            first = not self._episode_open
            self._episode_open = True
        self._counter.inc()
        if first and self._on_episode is not None:
            self._on_episode("shed", {
                "subsystem": self._subsystem, "reason": why,
                "inflight": self._inflight,
                "held_bytes": self.account.held,
                "limit_bytes": self.account.limit,
            })

    def try_enter(self, nbytes: int) -> int | None:
        """Reserved byte count to hand back to ``leave``, or None = SHED."""
        with self._lock:
            if self._inflight >= self.max_requests:
                over = True
            else:
                over = False
                self._inflight += 1
        if over:
            self._shed("inflight request cap")
            return None
        reserved = self.account.try_acquire(max(1, nbytes))
        if reserved == 0:
            with self._lock:
                self._inflight -= 1
            self._shed("rpc byte account exhausted")
            return None
        with self._lock:
            resumed = self._episode_open
            self._episode_open = False
        if resumed and self._on_episode is not None:
            self._on_episode("resumed", {"subsystem": self._subsystem})
        return reserved

    def leave(self, reserved: int) -> None:
        with self._lock:
            self._inflight = max(0, self._inflight - 1)
        self.account.release(reserved)

    def snapshot(self) -> dict:
        with self._lock:
            inflight, sheds = self._inflight, self._sheds
        return {
            "inflight": inflight,
            "max_requests": self.max_requests,
            "sheds": sheds,
            "account": self.account.snapshot(),
        }
