"""meshrunner: the coproc engine's partition mesh (BASELINE config 5).

The JAX package maps the ``[partition, batch, record]`` axis of a launch
onto a 1-D device mesh (coproc/meshrunner.py there); this is its port over
a ``PartitionMesh`` (parallel/mesh.py):

- a launch's batches cut into per-device shards with the host pool's
  contiguous range shard (``host_pool.partition_counts``), so the shards,
  and ``stats()["mesh"]["rows_per_device"]``, equal the JAX engine's and
  the concatenated outputs are byte-identical to the single-device path;
- the predicate runs as the stacked predicate (K2): one launch of the
  predicate kernel per card over its shards' blocks of a common row
  bucket;
- mesh-vs-single is a measured decision taken on the first representative
  launch (``PROBE_MIN_ROWS``): the same predicate over the same columns,
  once over the mesh and once on the engine's one device, and the mesh
  must win by ``host_pool.PROBE_MARGIN``. One launch calibrates at a time;
  a launch that finds a calibration running goes single
  (``probe_lock_busy``). The decision and the probe's times are in
  ``stats()``. On a virtual mesh (one card named several times) the mesh
  does the single lane's work in one launch over padded blocks, so it
  cannot win by the margin and "single" is the expected answer there.

The engine runs each shard's host ladder (coproc/engine.py
``_run_mesh_shard``) on its host-stage pool, stacks the shards' columns and
places them with ``stack_and_put``.

The probe's numbers are in ``stats()["probe"]`` and, when the engine passes
its governor, in the decision journal (domain ``mesh``); each launch's
records per device feed ``coproc_mesh_device_rows_total{device=}``. The JAX package's
``available_devices`` (which returned [] on any error) has no counterpart:
``partition_mesh(n)`` raises when there are fewer than n cards.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from redpanda_tpu_torch.coproc import host_pool, lockwatch
from redpanda_tpu_torch.observability import probes
from redpanda_tpu_torch.parallel.mesh import PartitionMesh

# don't pin the engine-sticky mesh-vs-single decision on a launch too
# small to represent steady state
PROBE_MIN_ROWS = 1024


class MeshRunner:
    """Owns the mesh-vs-single decision and the per-device accounting of a
    ``PartitionMesh``; the engine keeps the launch machinery."""

    def __init__(self, mesh: PartitionMesh, probe: bool = True):
        if mesh.size < 2:
            raise ValueError(f"meshrunner needs >= 2 shards, have {mesh.size}")
        self.mesh = mesh
        self.n_devices = mesh.size
        self._probe_enabled = bool(probe)
        # probe=False pins "mesh" unmeasured: parity runs and ablations need
        # the mesh lane deterministically
        self._decision: str | None = None if probe else "mesh"
        self._probe: dict | None = None
        # the JAX package's MeshRunner names this lock _decision_lock
        self._lock = lockwatch.wrap(threading.Lock(), "MeshRunner._lock")
        # serializes calibration runs only; never held while the decision
        # is read or published
        self._probe_run_lock = lockwatch.wrap(threading.Lock(), "MeshRunner._probe_run_lock")
        self._n_launches = 0
        self._n_demotions = 0
        self._rows_per_device = [0] * self.n_devices

    @property
    def decision(self) -> str | None:
        with self._lock:
            return self._decision

    @property
    def probe_enabled(self) -> bool:
        return self._probe_enabled

    @property
    def probe_lock_busy(self) -> bool:
        """True while a calibration runs: an undecided launch that finds it
        so goes single before it pays the per-shard mesh ladders."""
        return self._probe_run_lock.locked()

    def shard_ranges(self, counts: list[int]) -> list[tuple[int, int]]:
        """Per-device contiguous batch slices (may be fewer than the mesh's
        shards when there are fewer batches; the rest run empty)."""
        return host_pool.partition_counts(counts, self.n_devices)

    def stack_and_put(self, stacked: list[np.ndarray]) -> list[torch.Tensor]:
        """The [D, n_pad, ...] column stacks as tensors the cards copy from:
        pinned host memory on a CUDA mesh (each card then copies its rows up
        on its own stream), the arrays themselves on the CPU."""
        out = [torch.from_numpy(s) for s in stacked]
        if self.mesh.type == "cuda":
            out = [t.pin_memory() for t in out]
        return out

    def note_launch(self, shard_rows: list[int]) -> None:
        with self._lock:
            self._n_launches += 1
            for d, n in enumerate(shard_rows):
                self._rows_per_device[d] += int(n)
        for d, n in enumerate(shard_rows):
            if n:
                probes.coproc_mesh_device_rows(d).inc(n)

    def note_demotion(self) -> None:
        """A mesh-eligible launch that went down the single lane: a faulted
        shard worker, or the mesh_dispatch breaker refusing the mesh leg."""
        with self._lock:
            self._n_demotions += 1

    def maybe_calibrate(self, plan, stacked: list[np.ndarray], flat: list[np.ndarray],
                        single_leg, n_rows: int, governor=None) -> str:
        """The engine-sticky pin, measured on the first representative
        launch's own columns: ``stacked`` ([D, n_pad, ...] per column) over
        the mesh against ``flat`` (the single lane's columns) through
        ``single_leg(plan, flat)``, the engine's single-card leg (K1's
        crossing) with its keep bits back on the host. A launch under PROBE_MIN_ROWS, or one that finds another
        launch calibrating, runs single without pinning. A failing probe
        raises. ``governor`` (the engine's) journals the pin."""
        with self._lock:
            if self._decision is not None:
                return self._decision
        if n_rows < PROBE_MIN_ROWS or not self._probe_run_lock.acquire(blocking=False):
            return "single"
        try:
            with self._lock:
                if self._decision is not None:
                    return self._decision
            return self._calibrate(plan, stacked, flat, single_leg, governor)
        finally:
            self._probe_run_lock.release()

    def _calibrate(self, plan, stacked, flat, single_leg, governor=None) -> str:
        t_mesh, t_single = self._measure(plan, stacked, flat, single_leg)
        ratio = t_single / t_mesh if t_mesh > 0 else 0.0
        decision = "mesh" if ratio >= host_pool.PROBE_MARGIN else "single"
        probe = {
            "t_single_ms": round(t_single * 1e3, 3),
            "t_mesh_ms": round(t_mesh * 1e3, 3),
            "speedup": round(ratio, 3),
            "devices": self.n_devices,
            "chosen": decision,
        }
        with self._lock:
            self._decision = decision
            self._probe = probe
        if governor is not None:
            governor.record(
                "mesh", decision,
                f"measured predicate leg: single-device {t_single * 1e3:.3f} ms vs "
                f"{self.n_devices}-device mesh {t_mesh * 1e3:.3f} ms (mesh must win "
                f"{host_pool.PROBE_MARGIN}x; engine-sticky)",
                dict(probe),
            )
        return decision

    def _measure(self, plan, stacked, flat, single_leg) -> tuple[float, float]:
        """Best of two timed passes each (after one untimed pass), host
        columns in and keep bits back on the host, as a launch needs."""
        def mesh_leg():
            return np.asarray(plan.predicate_stacked(self.mesh, stacked))

        mesh_leg()
        single_leg(plan, flat)
        t_mesh = t_single = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            mesh_leg()
            t_mesh = min(t_mesh, time.perf_counter() - t0)
            t0 = time.perf_counter()
            single_leg(plan, flat)
            t_single = min(t_single, time.perf_counter() - t0)
        return t_mesh, t_single

    def stats(self) -> dict:
        with self._lock:
            out = {
                "devices": self.n_devices,
                "decision": self._decision,
                "launches": self._n_launches,
                "demotions": self._n_demotions,
                "rows_per_device": list(self._rows_per_device),
            }
            if self._probe is not None:
                out["probe"] = dict(self._probe)
        return out
