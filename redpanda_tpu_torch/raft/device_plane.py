"""Batched raft follower CRC validation and vote tally (BASELINE config 5).

The reference validates batch CRCs one at a time in host code
(kafka_batch_adapter.cc:93, record_utils.cc:82) and counts votes and
heartbeat acks one message at a time (heartbeat_manager.cc:155-204). Here
every batch of an append is packed into [N, r] rows and CRC-validated on
the card: by one launch of the CRC kernel (ops/crc32c_device.py) on one
device, or, with a partition mesh, by the sharded CRC + vote step
(parallel/collectives.py ``make_crc_vote_step``) with the rows laid over
the mesh's shards. The vote tally over a [voters, groups] bit matrix is
the mesh's vote aggregator when the plane has a mesh with one shard per
voter row, and the host sum otherwise (by design, as in the JAX package).

Where a validation runs is a measured decision: the first representative
validation times the device leg against the host oracle on the same rows,
and the process keeps the winner (the device must win by PROBE_MARGIN).
Both backends are bit-exact. The probe is a speed decision only: a device
leg that fails to build or launch, or disagrees with the host oracle on
the probe rows, raises; it never hands its call to the host.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from redpanda_tpu_torch.device import resolve_device
from redpanda_tpu_torch.hashing.crc32c import crc32c
from redpanda_tpu_torch.parallel.mesh import PartitionMesh, partition_mesh

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
    raises without one) or ``"cpu"`` for the plain versions. ``mesh`` (a
    ``PartitionMesh`` of ``device``'s type) runs the device leg as the
    sharded CRC + vote step over its shards and the vote tally as its
    aggregator. ``probe=False`` pins the device leg.
    """

    def __init__(self, mesh: PartitionMesh | None = None, probe: bool = True, device="cuda"):
        self.device = resolve_device(device)
        if mesh is not None and mesh.type != self.device.type:
            raise ValueError(f"mesh {mesh} does not run on the plane's device {self.device}")
        self.mesh = mesh
        self.n_devices = mesh.size if mesh is not None else 1
        self._decision: str | None = None if probe else "device"
        self._probe: dict | None = None
        self._lock = threading.Lock()
        # serializes the one calibration; siblings that lose the race serve
        # their call on the host oracle instead of queueing behind it
        self._probe_run_lock = threading.Lock()
        self._steps: dict = {}  # row width (or "vote") -> step
        self._n_validations = 0
        self._n_tallies = 0
        self._rows_validated = 0

    # ------------------------------------------------------------ decision
    @property
    def decision(self) -> str | None:
        with self._lock:
            return self._decision

    def _device_step(self, key):
        with self._lock:
            fn = self._steps.get(key)
        if fn is None:
            from redpanda_tpu_torch.parallel import collectives

            if key == "vote":
                fn = collectives.make_vote_aggregator(self.mesh)
            elif self.mesh is not None:
                fn = collectives.make_crc_vote_step(self.mesh, key)
            else:
                from redpanda_tpu_torch.ops.crc32c_device import make_crc_fn

                fn = make_crc_fn(key, self.device)
            with self._lock:
                fn = self._steps.setdefault(key, fn)
        return fn

    def _run_device(self, rows, lens, claimed):
        """ok flags on the device backend; rows is [N, r] host-packed."""
        n, r = rows.shape
        if self.mesh is None:
            got = self._device_step(r)(rows, lens)
            return (got == claimed) & (lens > 0)
        d = self.n_devices
        n_pad = -(-n // d) * d  # N rounded up to a multiple of D: zero rows,
        if n_pad != n:  # lengths and claims, neither ok nor bad
            rows = np.concatenate([rows, np.zeros((n_pad - n, r), np.uint8)])
            lens = np.concatenate([lens, np.zeros(n_pad - n, np.int32)])
            claimed = np.concatenate([claimed, np.zeros(n_pad - n, np.uint32)])
        k = n_pad // d
        ok, _bad, _tally = self._device_step(r)(
            rows.reshape(d, k, r), lens.reshape(d, k), claimed.reshape(d, k),
            np.zeros((d, 1), np.uint8),
        )
        return np.asarray(ok).reshape(n_pad)[:n]

    def _calibrate(self, regions, rows, lens, claimed) -> str:
        """Host-vs-device pin on representative rows. Times the host leg
        that serves a "host" pin (_host_validate, unpadded) against the
        device leg; raises when the device leg fails or disagrees. The
        measured verdict is journaled (mesh domain)."""
        t0 = time.perf_counter()
        host_ok = _host_validate(regions, claimed)
        t_host = time.perf_counter() - t0
        self._run_device(rows, lens, claimed)  # build + warm
        t0 = time.perf_counter()
        dev_ok = self._run_device(rows, lens, claimed)
        t_dev = time.perf_counter() - t0
        if not np.array_equal(host_ok, dev_ok):
            raise RuntimeError("raft device plane: device CRC disagrees with the host oracle")
        if self.mesh is not None:
            # build the vote aggregator here, off the heartbeat tick
            self._device_step("vote")(np.zeros((self.n_devices, 1), np.uint8))
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
        # journaled under the mesh domain, as the JAX plane does; imported
        # here: raft/ does not import coproc/ when it is imported
        from redpanda_tpu_torch.coproc import governor

        governor.journal_record(
            governor.MESH,
            decision,
            f"raft batched CRC/vote probe: host {t_host * 1e3:.3f} ms vs "
            f"device ({self.n_devices} dev) {t_dev * 1e3:.3f} ms (device "
            f"must win {PROBE_MARGIN}x; process-sticky)",
            dict(probe),
        )
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
        batched analogue of counting one reply at a time, int32 counts.
        On the device leg with a mesh of one shard per voter row it is the
        mesh's vote aggregator (K7); otherwise the host sum, by design."""
        votes = np.ascontiguousarray(votes, dtype=np.uint8)
        with self._lock:
            self._n_tallies += 1
            decision = self._decision
        if decision == "device" and self.mesh is not None and votes.shape[0] == self.n_devices:
            return self._device_step("vote")(votes).cpu().numpy()
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
# sites run at all. With mesh_devices >= 2 the default plane's device leg
# is the sharded step over the first mesh_devices cards.
_crc_validate = False
_vote_tally = False
_mesh_devices = 0


def configure(
    crc_validate: bool | None = None,
    vote_tally: bool | None = None,
    mesh_devices: int | None = None,
) -> None:
    global _crc_validate, _vote_tally, _mesh_devices
    if crc_validate is not None:
        _crc_validate = bool(crc_validate)
    if vote_tally is not None:
        _vote_tally = bool(vote_tally)
    if mesh_devices is not None:
        _mesh_devices = int(mesh_devices)


def crc_validate_enabled() -> bool:
    return _crc_validate


def vote_tally_enabled() -> bool:
    return _vote_tally


_default: RaftDevicePlane | None = None
_default_lock = threading.Lock()


def default_plane(device="cuda") -> RaftDevicePlane:
    """Process-wide plane, built lazily on first use on ``device`` (raises
    without a card unless the caller asks for the CPU). With configured
    ``mesh_devices >= 2`` its device leg is the sharded step over a mesh of
    that many devices, and it raises when there are fewer. Raises
    ValueError when the existing plane runs on another device: two callers
    never share one plane across devices."""
    global _default
    dev = resolve_device(device)
    with _default_lock:
        if _default is None:
            mesh = None
            if _mesh_devices >= 2:
                mesh = partition_mesh(_mesh_devices, device=dev)
            _default = RaftDevicePlane(mesh=mesh, device=dev)
        plane = _default
    if plane.device != dev:
        raise ValueError(
            f"the process raft plane runs on {plane.device}, not on {dev}"
        )
    return plane


def install_default_plane(plane: RaftDevicePlane | None) -> None:
    """Test and smoke hook: make ``plane`` the process plane (a pinned or a
    virtual-mesh plane under the consensus path), or forget it with None,
    as ``reset_default_plane`` does."""
    global _default
    with _default_lock:
        _default = plane


def reset_default_plane() -> None:
    """Test hook: forget the process plane (and its sticky decision)."""
    install_default_plane(None)
