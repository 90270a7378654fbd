"""Build cache for the port's compiled sources.

Every shared library the port loads (the host C++ helpers and the CUDA
kernels) is compiled from sources in the checkout into ``_build/`` beside
this file, named by a hash of its sources and its command line, so a changed
source or flag can never load a stale library. A file lock per library makes
concurrent first uses (test workers, threads) build it once; the compiler
writes to a temporary name that is renamed into place only on success.
"""

from __future__ import annotations

import fcntl
import hashlib
import os
import subprocess
from typing import Callable, Sequence

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class BuildError(RuntimeError):
    """A compiler run failed; the message carries its output."""


def cached_build(
    name: str,
    sources: Sequence[str],
    command: Callable[[str], list[str]],
    timeout_s: float = 900.0,
) -> str:
    """Path of ``lib<name>-<hash>.so`` built from ``sources``.

    ``command(out_path)`` returns the compiler argv that writes the library
    to ``out_path``; it is part of the hash (flags change the artifact).
    """
    h = hashlib.sha256()
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    h.update("\0".join(command("OUT")).encode())
    path = os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, f"{name}.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):
            return path
        tmp = f"{path}.tmp{os.getpid()}"
        try:
            proc = subprocess.run(
                command(tmp), capture_output=True, text=True, timeout=timeout_s
            )
            if proc.returncode != 0:
                raise BuildError(
                    f"building {name} failed (exit {proc.returncode}):\n"
                    f"{proc.stdout}\n{proc.stderr}"
                )
            # the compiler's own report (e.g. nvcc -Xptxas -v register and
            # shared-memory use) stays readable beside the library
            with open(path + ".log", "w") as log:
                log.write(proc.stdout + proc.stderr)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return path
