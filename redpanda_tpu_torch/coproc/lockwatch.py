"""coproc lockwatch: the runtime half of the lock-order cross-check.

The JAX package's recorder (coproc/lockwatch.py), for the port's locks.
When it is on, the engine's named locks are wrapped in a recorder that
journals every lock-ORDER edge it observes: acquiring lock B while holding
lock A (on the acquiring thread) is the edge ``A -> B``. Its job is to
validate the static analyzer: a test runs the parity workload under
lockwatch and asserts that the observed edge set is a subgraph of
pandalint's static acquisition graph over ``redpanda_tpu_torch/``
(tools/pandalint/lockgraph.py), so the analyzer's blind spots surface as
test failures.

Off by default, and free when off:

- ``wrap(lock, name)`` returns the RAW lock object untouched unless
  lockwatch was enabled before the owning object was constructed; the
  engine carries plain ``threading.Lock``s and pays one flag check per
  lock construction, nothing per acquisition.
- ``enable()`` flips the flag and swaps the module-level locks
  (``engine._mask_claim_lock``, ``faults._pool_lock``/``_warned_lock``)
  for wrapped twins; ``disable()`` restores the originals. Per-object
  locks (engine, launches, leg slots, pools, breakers) pick the wrapper up
  at construction, so enable() must run BEFORE the engine is built.

Lock names match the static analyzer's identity scheme (``Class.attr``
for instance locks, ``module.name`` for module globals), so that the
subgraph comparison is a set comparison on names.

Each newly discovered edge journals a ``lockwatch`` governor decision and
bumps ``coproc_lockwatch_edges_total``; a repeat observation is two set
lookups. The decision journal's own lock is NOT wrapped: it is the
recording channel, and wrapping it would recurse.
"""

from __future__ import annotations

import threading

_enabled = False
_state_lock = threading.Lock()
# (held_name, acquired_name) -> True, discovered this process
_edges: dict[tuple[str, str], bool] = {}
# locals of each thread: stack of lock names currently held (wrapped only)
_tls = threading.local()

# module-level locks swapped at enable(): (module, attr, canonical name)
_MODULE_LOCKS = (
    ("redpanda_tpu_torch.coproc.engine", "_mask_claim_lock", "engine._mask_claim_lock"),
    ("redpanda_tpu_torch.coproc.faults", "_pool_lock", "faults._pool_lock"),
    ("redpanda_tpu_torch.coproc.faults", "_warned_lock", "faults._warned_lock"),
)
_swapped: list[tuple[object, str, object]] = []  # (module, attr, original)


def enabled() -> bool:
    return _enabled


def _held_stack() -> list[str]:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


class WatchedLock:
    """Context-manager/lock wrapper recording acquisition-order edges.

    Not reentrant-aware beyond what the wrapped lock is; `with` blocks
    release LIFO, raw acquire/release pairs are matched by name."""

    __slots__ = ("_lock", "name")

    def __init__(self, lock, name: str):
        self._lock = lock
        self.name = name

    def _note_acquired(self) -> None:
        stack = _held_stack()
        if _enabled:  # wrappers outlive disable(); they go quiet, not away
            for held in stack:
                if held != self.name:
                    _record_edge(held, self.name)
        stack.append(self.name)

    def acquire(self, *a, **kw):
        got = self._lock.acquire(*a, **kw)
        if got:
            self._note_acquired()
        return got

    def release(self) -> None:
        stack = _held_stack()
        # LIFO for with-blocks; tolerate out-of-order raw release
        for i in range(len(stack) - 1, -1, -1):
            if stack[i] == self.name:
                del stack[i]
                break
        self._lock.release()

    def __enter__(self):
        self._lock.acquire()
        self._note_acquired()
        return self

    def __exit__(self, *exc):
        self.release()
        return False

    def locked(self):
        return self._lock.locked()


def wrap(lock, name: str):
    """The ONE construction-time hook: returns `lock` untouched when
    lockwatch is off (zero steady-state overhead, no wrapper installed),
    a WatchedLock when on."""
    if not _enabled:
        return lock
    return WatchedLock(lock, name)


def _record_edge(src: str, dst: str) -> None:
    key = (src, dst)
    with _state_lock:
        if key in _edges:
            return
        _edges[key] = True
        n = len(_edges)
    # outside _state_lock: the journal and its counter take their own
    # (unwrapped) locks; _state_lock must stay a leaf
    from redpanda_tpu_torch.coproc import governor
    from redpanda_tpu_torch.observability import probes

    probes.coproc_lockwatch_edges.inc()
    governor.journal_record(
        governor.LOCKWATCH,
        "edge",
        f"observed lock-order edge {src} -> {dst} (#{n} this process); "
        f"the static acquisition graph must contain it",
        {"from": src, "to": dst, "edges_total": n},
    )


def edges() -> list[tuple[str, str]]:
    with _state_lock:
        return sorted(_edges)


def reset_edges() -> None:
    with _state_lock:
        _edges.clear()


def snapshot() -> dict:
    with _state_lock:
        return {"enabled": _enabled, "edges": len(_edges)}


def enable() -> None:
    """Flip lockwatch on and swap the module-level locks. Call BEFORE
    constructing engines: per-object locks bind at construction."""
    global _enabled
    import importlib

    with _state_lock:
        if _enabled:
            return
        _enabled = True
    for modname, attr, canonical in _MODULE_LOCKS:
        mod = importlib.import_module(modname)
        original = getattr(mod, attr)
        if isinstance(original, WatchedLock):  # pragma: no cover - defensive
            continue
        setattr(mod, attr, WatchedLock(original, canonical))
        _swapped.append((mod, attr, original))


def disable() -> None:
    """Restore the raw module locks and stop wrapping. Engines built
    while enabled keep their (now inert but harmless) wrappers."""
    global _enabled
    with _state_lock:
        _enabled = False
    while _swapped:
        mod, attr, original = _swapped.pop()
        setattr(mod, attr, original)
