"""Debug file-handle sanitizer (the JAX package's storage/file_sanitizer.py,
copied: the port arms its own process globals, not the JAX package's).

Parity with the reference's file_io_sanitizer (utils/file_sanitizer.h:51,
armed by the `storage::debug_sanitize_files` knob on log_config/kvstore
config, application.cc:418,429): in debug runs, long-lived storage file
handles are wrapped so misuse — writing or fsyncing a closed handle,
closing twice, leaking an open handle at shutdown — raises at the misuse
site with the original open() location attached, instead of surfacing
later as silent data loss or an EBADF on an unrelated fd.

Process-global arm/disarm mirrors the reference's config knob; wrapping is
zero-cost when disarmed (`maybe_wrap` returns the raw handle).
"""

from __future__ import annotations

import os
import traceback

_enabled = False
_open_files: dict[int, "SanitizedFile"] = {}


class FileSanitizerError(RuntimeError):
    pass


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False
    _open_files.clear()


def enabled() -> bool:
    return _enabled


class SanitizedFile:
    """Wraps a file object; every op checks liveness first."""

    def __init__(self, f, path: str):
        self._f = f
        self._path = path
        self._closed = False
        self._opened_at = "".join(traceback.format_stack(limit=8)[:-1])
        _open_files[id(self)] = self

    def _check(self, op: str) -> None:
        if self._closed:
            raise FileSanitizerError(
                f"{op} on closed file {self._path!r}\nopened at:\n{self._opened_at}"
            )

    def write(self, data):
        self._check("write")
        return self._f.write(data)

    def flush(self):
        self._check("flush")
        return self._f.flush()

    def fileno(self):
        self._check("fileno")
        return self._f.fileno()

    def close(self):
        if self._closed:
            raise FileSanitizerError(
                f"double close of {self._path!r}\nopened at:\n{self._opened_at}"
            )
        self._closed = True
        _open_files.pop(id(self), None)
        return self._f.close()

    def __getattr__(self, name):
        # reads/seeks pass through but still require a live handle
        self._check(name)
        return getattr(self._f, name)


def maybe_wrap(f, path: str):
    """Wrap when armed, return the raw handle otherwise."""
    return SanitizedFile(f, path) if _enabled else f


def verify_all_closed(prefix: str | None = None) -> list[str]:
    """Shutdown check: paths of handles never closed (leaks), cleared from
    the registry as they are reported.

    The arm knob is process-global (matching the reference's debug-build
    flag), but MULTIPLE storage instances can coexist in one process
    (in-process multi-node fixtures) — pass `prefix` (a base directory) so
    one instance's shutdown only reports and clears its own handles
    instead of wiping another instance's live ones."""
    if prefix is not None:
        # path-separator boundary: '<tmp>/d' must not claim '<tmp>/d2'
        prefix = prefix.rstrip(os.sep) + os.sep
    doomed = [
        key
        for key, sf in _open_files.items()
        if prefix is None or sf._path.startswith(prefix)
    ]
    leaked = [_open_files.pop(key)._path for key in doomed]
    return leaked
