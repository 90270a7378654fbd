"""Produce-path CRC validation backend: a measured host-or-device choice.

The reference verifies the Kafka CRC-32C of every produced batch inline in
its wire adapter (kafka_batch_adapter.cc:93-121, castagnoli over
attributes..records). ``CrcBackend`` validates many batches at once, either
on the host (the native CRC, one region at a time) or on the card (the
regions packed into [N, r] rows and checked by one launch of the CRC
kernel in its validator mode, ops/pipeline.py ``make_batch_validator``).

``CrcBackend.pick()`` measures both on representative regions and keeps the
faster one: a speed decision, and both backends are bit-exact. A device
leg that fails to build, to launch, or to agree with the host on the probe
rows raises; the choice is never made by an exception.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import numpy as np

from redpanda_tpu_torch.device import resolve_device
from redpanda_tpu_torch.hashing.crc32c import crc32c


@dataclass
class CrcDecision:
    backend: str  # "host" | "device"
    host_batches_per_sec: float
    device_batches_per_sec: float

    @property
    def ratio_device_vs_host(self) -> float:
        return self.device_batches_per_sec / max(self.host_batches_per_sec, 1e-9)


class CrcBackend:
    """Validate claimed batch CRCs over many batches, on ``device`` (the
    card unless the caller asks for the CPU; raises without one) or, when
    ``pick()`` measured it faster or the caller asks for it, on the host."""

    def __init__(self, backend: str = "device", decision: CrcDecision | None = None,
                 device="cuda"):
        if backend not in ("host", "device"):
            raise ValueError(f"unknown CRC backend {backend!r}")
        self.backend = backend
        self.decision = decision
        self.device = resolve_device(device) if backend == "device" else None
        self._validators: dict[int, object] = {}

    # ------------------------------------------------------------ validate
    def validate(self, regions: list[bytes], claimed) -> np.ndarray:
        """ok[i] = crc32c(regions[i]) == claimed[i] (the device backend also
        requires a non-empty region, as the validator kernel does)."""
        claimed = np.asarray(claimed, dtype=np.uint32)
        if self.backend == "host":
            return np.fromiter(
                (crc32c(r) == int(c) for r, c in zip(regions, claimed)),
                dtype=bool,
                count=len(regions),
            )
        return self._validate_device(regions, claimed)

    def _validate_device(self, regions: list[bytes], claimed: np.ndarray) -> np.ndarray:
        from redpanda_tpu_torch.ops.packing import pack_rows
        from redpanda_tpu_torch.ops.pipeline import make_batch_validator

        n = len(regions)
        if n == 0:
            return np.zeros(0, dtype=bool)
        r = max(len(x) for x in regions)
        r = 1 << (r - 1).bit_length()  # shape-bucketed stride
        rows, lens = pack_rows(regions, r)
        validate = self._validators.setdefault(r, make_batch_validator(r, self.device))
        return validate(rows, lens, claimed)[:n]

    # ------------------------------------------------------------ probing
    @classmethod
    def pick(
        cls,
        sample_regions: list[bytes] | None = None,
        reps: int = 3,
        device="cuda",
    ) -> "CrcBackend":
        """Measure both paths on sample regions; return the faster backend
        with the measured rates in ``decision``. A device probe that fails,
        or whose flags differ from the host's, raises.
        """
        if sample_regions is None:
            rng = np.random.default_rng(0)
            sample_regions = [rng.bytes(1536) for _ in range(64)]
        claimed = np.array([crc32c(r) for r in sample_regions], dtype=np.uint32)

        host = cls("host")
        t0 = time.perf_counter()
        for _ in range(reps):
            host_ok = host.validate(sample_regions, claimed)
        host_rate = reps * len(sample_regions) / (time.perf_counter() - t0)
        if not host_ok.all():
            raise RuntimeError("host CRC rejected its own probe rows")

        dev = cls("device", device=device)
        dev.validate(sample_regions, claimed)  # build and first launch off the clock
        t0 = time.perf_counter()
        for _ in range(reps):
            dev_ok = dev.validate(sample_regions, claimed)
        dev_rate = reps * len(sample_regions) / (time.perf_counter() - t0)
        if not np.array_equal(dev_ok, host_ok):
            raise RuntimeError("device CRC disagrees with the host on the probe rows")

        decision = CrcDecision("device" if dev_rate > host_rate else "host", host_rate, dev_rate)
        chosen = dev if decision.backend == "device" else cls("host")
        chosen.decision = decision
        return chosen


_defaults: dict[str, CrcBackend] = {}
_installed: CrcBackend | None = None
_default_lock = threading.Lock()


def default_backend(device="cuda") -> CrcBackend:
    """Process-wide backend for the produce path on ``device``, chosen by
    ``pick()`` on first use (the card unless the caller asks for the CPU;
    raises without one), or the one ``install_default_backend`` pinned."""
    if _installed is not None:
        return _installed
    key = str(resolve_device(device))
    if key not in _defaults:
        with _default_lock:
            if key not in _defaults:
                _defaults[key] = CrcBackend.pick(device=key)
    return _defaults[key]


async def default_backend_async(device="cuda") -> CrcBackend:
    """Async-safe accessor: the first call's probe runs in a worker thread
    so the event loop keeps serving; later calls return the cached
    instance without a thread hop."""
    if _installed is not None:
        return _installed
    key = str(resolve_device(device))
    if key in _defaults:
        return _defaults[key]
    import asyncio

    return await asyncio.to_thread(default_backend, key)


def install_default_backend(backend: CrcBackend | None) -> None:
    """Test and smoke hook: make ``backend`` the produce path's backend on
    every device (a pinned ``CrcBackend("device")`` keeps the card's CRC
    on the path whatever ``pick()`` would measure), or, with None, forget
    it and every picked backend, so that the next use picks again."""
    global _installed
    with _default_lock:
        _installed = backend
        if backend is None:
            _defaults.clear()
