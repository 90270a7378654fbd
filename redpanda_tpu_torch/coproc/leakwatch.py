"""coproc leakwatch: the runtime half of the resource-lifecycle cross-check.

The JAX package's recorder (coproc/leakwatch.py), for the port's
resources. When it is on, the budget plane's accounts, the engine's
admission controller and its framing arena (and any inflight gate a caller
wraps) are wrapped in a BALANCE recorder: every acquire/release is
attributed to its repo-relative call site (file:line of the caller) and
netted per resource. Its job is to validate the static analyzer: the
parity suite runs the fault matrix (with cancellation injection) under
leakwatch and asserts that (a) every balance nets to zero at the end and
(b) every observed acquire SITE is a statement that pandalint's lifecycle
model knows (tools/pandalint/lifecycle.model_sites over
``redpanda_tpu_torch/``), so the analyzer's vocabulary blind spots surface
as test failures.

Off by default, and free when off, as lockwatch is:

- ``wrap(obj, name)`` returns the RAW object untouched unless leakwatch
  was enabled before the owning object was constructed; the engine
  carries plain accounts and arenas and pays one flag check per resource
  construction, nothing per acquisition.
- ``enable()`` flips the flag; construction sites (BudgetPlane, the
  engine's admission controller and arena) pick the wrapper up when they
  are built afterwards.

Balance accounting per wrapper kind:

- accounts/admission/gates net GRANTED amounts (refusals -- 0 grants,
  ``None`` slots -- are not acquisitions); a net going NEGATIVE (more
  released than acquired) is an imbalance the moment it happens, bumps
  ``coproc_leakwatch_imbalance_total`` and journals under the governor
  ``leakwatch`` domain.
- arenas track buffer IDENTITY, not counts: under the grown-by-replacement
  scratch contract a callee may hand back a replacement for the ``out=``
  buffer it consumed, so releasing a buffer this wrapper never issued is
  ADOPTION (legal, ignored), while an issued buffer never released is the
  leak.

Like lockwatch, the recorder's own lock stays a leaf: the journal and
counter are taken OUTSIDE ``_state_lock``.
"""

from __future__ import annotations

import os
import sys
import threading

_enabled = False
_state_lock = threading.Lock()
# resource name -> net outstanding (bytes/slots) or, for arenas, buffer count
_balance: dict[str, int] = {}
# (resource name, "rel/path.py:line") -> [acquires, releases]
_sites: dict[tuple[str, str], list] = {}
_imbalances: int = 0

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def enabled() -> bool:
    return _enabled


def _caller_site(depth: int = 2) -> str:
    """repo-relative file:line of the frame that called the wrapper."""
    try:
        f = sys._getframe(depth)
    except ValueError:  # pragma: no cover - shallow stack
        return "?:0"
    path = f.f_code.co_filename
    try:
        rel = os.path.relpath(path, _REPO_ROOT)
    except ValueError:  # pragma: no cover - different drive (windows)
        rel = path
    return f"{rel.replace(os.sep, '/')}:{f.f_lineno}"


def _note(name: str, site: str, delta: int, acquire: bool) -> None:
    global _imbalances
    new_site = False
    negative = None
    with _state_lock:
        counts = _sites.get((name, site))
        if counts is None:
            counts = _sites[(name, site)] = [0, 0]
            new_site = acquire
        counts[0 if acquire else 1] += 1
        bal = _balance.get(name, 0) + delta
        _balance[name] = bal
        if bal < 0:
            _imbalances += 1
            negative = bal
    # outside _state_lock: journal/counter take their own locks
    if negative is not None:
        from redpanda_tpu_torch.coproc import governor
        from redpanda_tpu_torch.observability import probes

        probes.coproc_leakwatch_imbalance.inc()
        governor.journal_record(
            governor.LEAKWATCH,
            "imbalance",
            f"resource {name} balance went negative ({negative}) at "
            f"{site}: released more than was ever acquired — a "
            f"double-release or an adoption the recorder cannot pair",
            {"resource": name, "balance": negative, "site": site},
        )
    elif new_site:
        from redpanda_tpu_torch.coproc import governor

        governor.journal_record(
            governor.LEAKWATCH,
            "site",
            f"first acquire of {name} from {site}; the static lifecycle "
            f"model must contain this statement",
            {"resource": name, "site": site},
        )


class _Proxy:
    """Forwarding base: everything not intercepted hits the raw object,
    so identity-free callers (gauges, pressure recompute, snapshots)
    behave exactly as without leakwatch."""

    # __weakref__: the budget plane's gauge registration weakrefs its
    # accounts — the proxy must be weakref-able like the raw object
    __slots__ = ("_raw", "_lw_name", "__weakref__")

    def __init__(self, raw, name: str):
        object.__setattr__(self, "_raw", raw)
        object.__setattr__(self, "_lw_name", name)

    def __getattr__(self, attr):
        return getattr(object.__getattribute__(self, "_raw"), attr)

    def __setattr__(self, attr, value):
        if attr in ("_raw", "_lw_name", "_lw_out"):  # pragma: no cover
            object.__setattr__(self, attr, value)
        else:
            setattr(object.__getattribute__(self, "_raw"), attr, value)


class WatchedAccount(_Proxy):
    """MemoryAccount balance recorder (also fits anything with the
    try_acquire/acquire/release byte vocabulary, e.g. MemoryBudget)."""

    __slots__ = ()

    def try_acquire(self, n: int) -> int:
        got = self._raw.try_acquire(n)
        if got:
            _note(self._lw_name, _caller_site(), got, True)
        return got

    async def acquire(self, n: int) -> int:
        site = _caller_site()  # capture BEFORE suspension
        got = await self._raw.acquire(n)
        if got:
            _note(self._lw_name, site, got, True)
        return got

    def release(self, n: int) -> None:
        if n:
            _note(self._lw_name, _caller_site(), -n, False)
        self._raw.release(n)


class WatchedAdmission(_Proxy):
    """AdmissionController recorder: try_admit returns (reserved,
    retry_ms); zero reserved is a shed, not an acquisition."""

    __slots__ = ()

    def try_admit(self, n: int):
        reserved, retry_ms = self._raw.try_admit(n)
        if reserved:
            _note(self._lw_name, _caller_site(), reserved, True)
        return reserved, retry_ms

    def admit(self, n: int) -> int:
        reserved = self._raw.admit(n)
        if reserved:
            _note(self._lw_name, _caller_site(), reserved, True)
        return reserved

    def release(self, reserved: int) -> None:
        if reserved:
            _note(self._lw_name, _caller_site(), -reserved, False)
        self._raw.release(reserved)


class WatchedGate(_Proxy):
    """InflightGate recorder: try_enter returns the reserved byte count
    or None on refusal; leave gives the bytes back."""

    __slots__ = ()

    def try_enter(self, nbytes: int):
        reserved = self._raw.try_enter(nbytes)
        if reserved is not None:
            _note(self._lw_name, _caller_site(), reserved, True)
        return reserved

    def leave(self, reserved: int) -> None:
        _note(self._lw_name, _caller_site(), -reserved, False)
        self._raw.leave(reserved)


class WatchedArena(_Proxy):
    """Arena recorder: identity accounting for the grown-by-replacement
    contract. Issued buffers are tracked by id(); releasing a buffer the
    arena never issued through this wrapper is ADOPTION (the callee grew
    the out= scratch and handed ownership of its replacement back) and
    is forwarded without touching the balance."""

    __slots__ = ("_lw_out",)

    def __init__(self, raw, name: str):
        super().__init__(raw, name)
        object.__setattr__(self, "_lw_out", set())

    def acquire(self, nbytes: int):
        buf = self._raw.acquire(nbytes)
        out = object.__getattribute__(self, "_lw_out")
        with _state_lock:
            out.add(id(buf))
        _note(self._lw_name, _caller_site(), 1, True)
        return buf

    def release(self, buf) -> None:
        out = object.__getattribute__(self, "_lw_out")
        issued = False
        with _state_lock:
            if id(buf) in out:
                out.discard(id(buf))
                issued = True
        if issued:
            _note(self._lw_name, _caller_site(), -1, False)
        self._raw.release(buf)


def wrap(obj, name: str):
    """The ONE construction-time hook: returns `obj` untouched when
    leakwatch is off (zero steady-state overhead, no proxy installed),
    a duck-typed balance recorder when on."""
    if not _enabled:
        return obj
    if hasattr(obj, "try_enter"):
        return WatchedGate(obj, name)
    if hasattr(obj, "try_admit"):
        return WatchedAdmission(obj, name)
    if hasattr(obj, "try_acquire") or hasattr(obj, "release") and hasattr(obj, "acquire"):
        # arenas release BUFFERS, accounts release COUNTS: arenas have
        # no try_acquire and no held/occupancy vocabulary
        if hasattr(obj, "try_acquire"):
            return WatchedAccount(obj, name)
        return WatchedArena(obj, name)
    return obj  # pragma: no cover - unknown vocabulary: leave it alone


def balances() -> dict[str, int]:
    with _state_lock:
        return dict(sorted(_balance.items()))


def sites() -> dict[tuple[str, str], tuple[int, int]]:
    """(resource, 'rel/path.py:line') -> (acquires, releases)."""
    with _state_lock:
        return {k: (v[0], v[1]) for k, v in sorted(_sites.items())}


def acquire_sites() -> set[tuple[str, int]]:
    """Observed acquire sites as (relpath, line) -- the set the parity
    test checks against the static lifecycle model."""
    with _state_lock:
        out = set()
        for (_name, site), (acq, _rel) in _sites.items():
            if not acq:
                continue
            rel, _colon, line = site.rpartition(":")
            out.add((rel, int(line)))
        return out


def snapshot() -> dict:
    with _state_lock:
        outstanding = {k: v for k, v in sorted(_balance.items()) if v}
        return {
            "enabled": _enabled,
            "resources": len(_balance),
            "sites": len(_sites),
            "outstanding": outstanding,
            "imbalances": _imbalances,
        }


def reset() -> None:
    global _imbalances
    with _state_lock:
        _balance.clear()
        _sites.clear()
        _imbalances = 0


def enable() -> None:
    """Flip leakwatch on. Call BEFORE constructing the budget plane /
    engine: wrappers bind at construction."""
    global _enabled
    with _state_lock:
        _enabled = True


def disable() -> None:
    """Stop wrapping new constructions. Objects built while enabled keep
    their (still-recording but cheap) proxies."""
    global _enabled
    with _state_lock:
        _enabled = False
