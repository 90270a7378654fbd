"""Batched raft follower CRC validation and vote tally (BASELINE config 5),
single-device leg.

The reference validates batch CRCs one at a time in host code
(kafka_batch_adapter.cc:93, record_utils.cc:82) and counts votes and
heartbeat acks one message at a time (heartbeat_manager.cc:155-204). Here
every batch of an append is packed into [N, r] rows and CRC-validated by
one launch of the CRC kernel (ops/crc32c_device.py) on the card; the vote
tally is the host sum over a [voters, groups] bit matrix.

Where a validation runs is a measured decision: the first representative
validation times the device leg against the host oracle on the same rows,
and the process keeps the winner (the device must win by PROBE_MARGIN).
Both backends are bit-exact. The probe is a speed decision only: a device
leg that fails to build or launch, or disagrees with the host oracle on
the probe rows, raises; it never hands its call to the host.

The mesh leg (a sharded CRC + vote step across cards) is not ported yet.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from redpanda_tpu_torch.device import resolve_device
from redpanda_tpu_torch.hashing.crc32c import crc32c

# the device must beat the host by this factor to be chosen (the same
# margin as the coproc host pool's probe)
PROBE_MARGIN = 1.25

# probe floor: fewer rows than this stay on the host oracle without
# pinning the process-wide decision (a 3-batch heartbeat tick is not
# representative of a recovery-scan burst)
PROBE_MIN_ROWS = 64

# ceiling on the padded [n, bucket(max_len)] device matrix: the pack
# amplifies a width-skewed blob (512 x 1KB + one 8MB region = a ~4GB
# matrix); past this, validate unpadded on the host instead
_PACK_BUDGET_BYTES = 64 << 20


def _bucket(r: int) -> int:
    b = 64
    while b < r:
        b *= 2
    return b


def _host_validate(regions: list[bytes], claimed: np.ndarray) -> np.ndarray:
    """The unpadded host oracle: crc each region where it lies."""
    n = len(regions)
    got = np.fromiter((crc32c(x) for x in regions), np.uint32, n)
    lens = np.fromiter((len(x) for x in regions), np.int64, n)
    return (got == claimed) & (lens > 0)


class RaftDevicePlane:
    """Process-scoped batched CRC/vote executor with a measured backend.

    ``device`` is the card the device leg runs on (``"cuda"`` by default;
    raises without one) or ``"cpu"`` for the plain versions. ``mesh`` is
    the multi-card leg, which is not ported yet. ``probe=False`` pins the
    device leg.
    """

    def __init__(self, mesh=None, probe: bool = True, device="cuda"):
        if mesh is not None:
            raise NotImplementedError(
                "RaftDevicePlane(mesh=...): the multi-card leg comes with the mesh "
                "slice of the port (sharded CRC + vote step over torch.distributed)"
            )
        self.n_devices = 1
        self.device = resolve_device(device)
        self._decision: str | None = None if probe else "device"
        self._probe: dict | None = None
        self._lock = threading.Lock()
        # serializes the one calibration; siblings that lose the race serve
        # their call on the host oracle instead of queueing behind it
        self._probe_run_lock = threading.Lock()
        self._steps: dict[int, object] = {}
        self._n_validations = 0
        self._n_tallies = 0
        self._rows_validated = 0

    # ------------------------------------------------------------ decision
    @property
    def decision(self) -> str | None:
        with self._lock:
            return self._decision

    def _device_step(self, r: int):
        with self._lock:
            fn = self._steps.get(r)
        if fn is None:
            from redpanda_tpu_torch.ops.crc32c_device import make_crc_fn

            fn = make_crc_fn(r, self.device)
            with self._lock:
                fn = self._steps.setdefault(r, fn)
        return fn

    def _run_device(self, rows, lens, claimed):
        """ok flags on the device backend; rows is [N, r] host-packed."""
        got = self._device_step(rows.shape[1])(rows, lens)
        return (got == claimed) & (lens > 0)

    def _calibrate(self, regions, rows, lens, claimed) -> str:
        """Host-vs-device pin on representative rows. Times the host leg
        that serves a "host" pin (_host_validate, unpadded) against the
        device leg; raises when the device leg fails or disagrees."""
        t0 = time.perf_counter()
        host_ok = _host_validate(regions, claimed)
        t_host = time.perf_counter() - t0
        self._run_device(rows, lens, claimed)  # build + warm
        t0 = time.perf_counter()
        dev_ok = self._run_device(rows, lens, claimed)
        t_dev = time.perf_counter() - t0
        if not np.array_equal(host_ok, dev_ok):
            raise RuntimeError("raft device plane: device CRC disagrees with the host oracle")
        ratio = t_host / t_dev if t_dev > 0 else 0.0
        decision = "device" if ratio >= PROBE_MARGIN else "host"
        probe = {
            "t_host_ms": round(t_host * 1e3, 3),
            "t_device_ms": round(t_dev * 1e3, 3),
            "speedup": round(ratio, 3),
            "devices": self.n_devices,
            "rows": int(len(lens)),
            "chosen": decision,
        }
        with self._lock:
            self._decision = decision
            self._probe = probe
        return decision

    # ------------------------------------------------------------ API
    def validate(self, regions: list[bytes], claimed) -> np.ndarray:
        """ok[i] = crc32c(regions[i]) == claimed[i] & non-empty, batched over
        all regions on the measured backend (bit-exact on both)."""
        n = len(regions)
        claimed = np.asarray(claimed, dtype=np.uint32)
        if n == 0:
            return np.zeros(0, dtype=bool)
        with self._lock:
            decision = self._decision
            self._n_validations += 1
            self._rows_validated += n
        if decision == "host" or (decision is None and n < PROBE_MIN_ROWS):
            # host-pinned (or too small to probe on): crc each region in
            # place, without the padded-matrix pack the device leg needs
            return _host_validate(regions, claimed)
        r = _bucket(max(len(x) for x in regions))
        if n * r > _PACK_BUDGET_BYTES:
            # width skew (one outsized region buckets every row to its
            # width): validate unpadded on the host, pinning nothing
            return _host_validate(regions, claimed)
        from redpanda_tpu_torch.ops.packing import pack_rows

        rows = lens = None
        if decision is None:
            if not self._probe_run_lock.acquire(blocking=False):
                # a sibling thread is mid-calibration: answer on the host
                # oracle (bit-exact), checked before the pack
                return _host_validate(regions, claimed)
            try:
                with self._lock:
                    decision = self._decision
                if decision is None:
                    rows, lens = pack_rows(regions, r)
                    decision = self._calibrate(regions, rows, lens, claimed)
            finally:
                self._probe_run_lock.release()
        if decision == "device":
            if rows is None:
                rows, lens = pack_rows(regions, r)
            return self._run_device(rows, lens, claimed)
        return _host_validate(regions, claimed)

    def tally_votes(self, votes: np.ndarray) -> np.ndarray:
        """Per-group vote/ack tally over a [voters, groups] bit matrix: the
        batched analogue of counting one reply at a time. Without a mesh
        this is the host sum, int32 counts."""
        votes = np.ascontiguousarray(votes, dtype=np.uint8)
        with self._lock:
            self._n_tallies += 1
        return votes.astype(np.int32).sum(axis=0)

    def stats(self) -> dict:
        with self._lock:
            out = {
                "decision": self._decision,
                "devices": self.n_devices,
                "validations": self._n_validations,
                "rows_validated": self._rows_validated,
                "tallies": self._n_tallies,
            }
            if self._probe is not None:
                out["probe"] = dict(self._probe)
        return out


# broker wiring: both consumers are off by default. The measured probe
# decides where a validation runs; these flags decide whether the call
# sites run at all.
_crc_validate = False
_vote_tally = False


def configure(crc_validate: bool | None = None, vote_tally: bool | None = None) -> None:
    global _crc_validate, _vote_tally
    if crc_validate is not None:
        _crc_validate = bool(crc_validate)
    if vote_tally is not None:
        _vote_tally = bool(vote_tally)


def crc_validate_enabled() -> bool:
    return _crc_validate


def vote_tally_enabled() -> bool:
    return _vote_tally


_default: RaftDevicePlane | None = None
_default_lock = threading.Lock()


def default_plane(device="cuda") -> RaftDevicePlane:
    """Process-wide single-device plane, built lazily on first use (on
    ``device``; raises without a card unless the caller asks for the
    CPU)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = RaftDevicePlane(device=device)
    return _default


def reset_default_plane() -> None:
    """Test hook: forget the process plane (and its sticky decision)."""
    global _default
    with _default_lock:
        _default = None
