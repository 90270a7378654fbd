"""Failure-injection registry ("honey badger"; the JAX package's
finjector.py, copied: the port's probes are armed on this instance, not on
the JAX package's).

Parity with finjector/hbadger.h:23-60: subsystems register named probes;
tests (or, once the broker is ported, the admin API) arm a probe on a
module with one of five effects -- raise an exception, delay, wedge (block
at the site until disarmed or ``wedge_max_s``, simulating a hung device
fetch / dead link), terminate (here: raise SystemExit) or corrupt (the
site mutates its own bytes). Arming is a no-op unless
``honey_badger.enable()`` was called, so production paths pay one
attribute check. A probe armed with ``count=N`` fires N times and then
disarms itself. The coproc fault domains (device dispatch, mask fetch,
harvest, shard worker, mesh dispatch) register in coproc/faults.py.
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

EXCEPTION = "exception"
DELAY = "delay"
TERMINATE = "terminate"
WEDGE = "wedge"
# data-corruption fault: the SITE mutates its own bytes when the claim
# fires (an injector can't reach into a site's buffers) — used by the raft
# append path to prove the device-plane CRC validation rejects torn blobs
CORRUPT = "corrupt"

EFFECTS = (EXCEPTION, DELAY, WEDGE, TERMINATE, CORRUPT)


class ProbeTriggered(Exception):
    """Raised by an armed 'exception' probe."""


@dataclass
class _Module:
    probes: set = field(default_factory=set)
    armed: dict = field(default_factory=dict)  # probe -> effect
    # probe -> remaining injections; absent = armed until disarmed. A probe
    # armed with count=1 ("one-shot") auto-disarms after its first
    # injection — deterministic single-fault tests without a disarm race.
    counts: dict = field(default_factory=dict)


class HoneyBadger:
    def __init__(self) -> None:
        self._enabled = False
        self._modules: dict[str, _Module] = defaultdict(_Module)
        # serializes count-limited claims: probe sites fire concurrently
        # (pool workers, harvester, RPC handlers), and "exactly N
        # injections" needs an atomic select+decrement. Only taken when
        # the registry is enabled — the disabled fast path stays lock-free.
        self._claim_lock = threading.Lock()
        self.delay_ms = 50
        # A wedge simulates an indefinite hang, but an orphaned wedge (the
        # operator forgot to disarm) must not hold a broker thread forever:
        # the site blocks until the probe is disarmed OR this cap elapses.
        # Tests lower it to keep deadline-abandonment runs fast.
        self.wedge_max_s = 2.0

    def enable(self) -> None:
        self._enabled = True  # read lock-free by every probe site: a racy read costs one missed injection

    def disable(self) -> None:
        self._enabled = False
        for m in self._modules.values():
            m.armed.clear()
            m.counts.clear()

    @property
    def enabled(self) -> bool:
        return self._enabled

    def register_probe(self, module: str, *probes: str) -> None:
        self._modules[module].probes.update(probes)

    def modules(self) -> dict[str, list[str]]:
        return {name: sorted(m.probes) for name, m in self._modules.items()}

    def armed(self) -> dict[str, dict[str, str]]:
        """module -> {probe: effect} for every currently-armed probe."""
        return {
            name: dict(m.armed)
            for name, m in self._modules.items()
            if m.armed
        }

    def armed_counts(self) -> dict[str, dict[str, int]]:
        """module -> {probe: remaining injections} for count-limited
        probes only (unlimited probes don't appear)."""
        return {
            name: dict(m.counts)
            for name, m in self._modules.items()
            if m.counts
        }

    def remaining(self, module: str, probe: str) -> int | None:
        """Remaining injections for a count-limited probe; None when the
        probe is unlimited or not armed."""
        m = self._modules.get(module)
        return None if m is None else m.counts.get(probe)

    def set_exception(self, module: str, probe: str, count: int | None = None) -> None:
        self._arm(module, probe, EXCEPTION, count)

    def set_delay(self, module: str, probe: str, count: int | None = None) -> None:
        self._arm(module, probe, DELAY, count)

    def set_termination(self, module: str, probe: str, count: int | None = None) -> None:
        self._arm(module, probe, TERMINATE, count)

    def set_wedge(self, module: str, probe: str, count: int | None = None) -> None:
        self._arm(module, probe, WEDGE, count)

    def set_corrupt(self, module: str, probe: str, count: int | None = None) -> None:
        self._arm(module, probe, CORRUPT, count)

    def corrupt_claim(self, module: str, probe: str) -> bool:
        """True when an armed CORRUPT probe fires for this call — the SITE
        then flips its own bytes (count budgets consume per claim, exactly
        like the other effects). A probe armed with a non-corrupt effect
        is NOT consumed here: the site's maybe_inject/inject_sync owns it."""
        if not self._enabled:
            return False
        m = self._modules.get(module)
        if m is None or m.armed.get(probe) != CORRUPT:
            return False
        effect, _ = self._claim(module, probe)
        return effect == CORRUPT

    def unset(self, module: str, probe: str) -> None:
        # plain lookup, not the defaultdict: disarming a typo'd name must
        # not conjure a phantom module entry into modules()/armed()
        m = self._modules.get(module)
        if m is not None:
            m.armed.pop(probe, None)
            m.counts.pop(probe, None)

    def _arm(self, module: str, probe: str, effect: str, count: int | None = None) -> None:
        if not self._enabled:
            return
        m = self._modules[module]
        m.armed[probe] = effect
        if count is not None and int(count) > 0:
            m.counts[probe] = int(count)
        else:
            # re-arming without a count clears a stale one-shot budget
            m.counts.pop(probe, None)

    def _claim(self, module: str, probe: str) -> tuple[str | None, bool]:
        """Atomically select the effect for ONE injection, consuming a
        count-limited budget (probe sites race from pool workers — an
        unlocked check-then-consume would fire a count=1 probe twice).
        Returns (effect, disarm_after): effect is None when nothing is
        armed or the budget is spent; disarm_after=True means this was a
        count-limited WEDGE's last injection — the wedge block polls the
        armed state, so it stays armed through the block and the SITE
        disarms it afterwards (counts pinned at 0 meanwhile, so a racing
        claim sees the drained budget, not an unlimited wedge). Other
        effects disarm right here at zero. The registry stays enabled
        either way — the admin DELETE handler owns the
        last-probe-disables-registry rule."""
        with self._claim_lock:
            m = self._modules.get(module)
            effect = m.armed.get(probe) if m is not None else None
            if effect is None:
                return None, False
            c = m.counts.get(probe)
            if c is None:
                return effect, False  # unlimited
            if c <= 0:
                return None, False  # drained wedge mid-block elsewhere
            if c == 1:
                if effect == WEDGE:
                    m.counts[probe] = 0
                    return effect, True
                m.armed.pop(probe, None)
                m.counts.pop(probe, None)
                return effect, False
            m.counts[probe] = c - 1
            return effect, False

    def _wedged(self, module: str, probe: str) -> bool:
        return (
            self._enabled
            and self._modules[module].armed.get(probe) == WEDGE
        )

    async def maybe_inject(self, module: str, probe: str) -> None:
        """Await point placed at each probe site."""
        if not self._enabled:
            return
        effect, disarm_after = self._claim(module, probe)
        if effect == DELAY:
            await asyncio.sleep(self.delay_ms / 1000)
        elif effect == EXCEPTION:
            raise ProbeTriggered(f"{module}.{probe}")
        elif effect == WEDGE:
            deadline = time.monotonic() + self.wedge_max_s
            while time.monotonic() < deadline and self._wedged(module, probe):
                await asyncio.sleep(0.01)
            if disarm_after:
                self.unset(module, probe)
        elif effect == TERMINATE:
            raise SystemExit(f"honey badger terminate: {module}.{probe}")

    def inject_sync(self, module: str, probe: str) -> None:
        """Synchronous probe site (storage paths, coproc device legs)."""
        if not self._enabled:
            return
        effect, disarm_after = self._claim(module, probe)
        if effect == EXCEPTION:
            raise ProbeTriggered(f"{module}.{probe}")
        if effect == TERMINATE:
            raise SystemExit(f"honey badger terminate: {module}.{probe}")
        if effect == DELAY:
            # deliberate BLOCKING sleep: a delay fault at a sync site must
            # actually delay (stalling the loop is the injected fault —
            # this only ever runs with the badger explicitly enabled)
            time.sleep(self.delay_ms / 1000)
        elif effect == WEDGE:
            # block like a hung device fetch until disarmed (or the cap):
            # this is what the engine's per-attempt deadlines must cut
            # through by abandoning the wedged worker
            deadline = time.monotonic() + self.wedge_max_s
            while time.monotonic() < deadline and self._wedged(module, probe):
                time.sleep(0.01)
            if disarm_after:
                self.unset(module, probe)


honey_badger = HoneyBadger()
