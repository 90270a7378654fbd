"""Batched CRC-32C (K5), the batch validator (K6) and their consumers in the
PyTorch port against the JAX package.

The same rows, made from a seed with numpy, go through the JAX package's
functions and the port's on the CPU (the kernels' plain PyTorch versions):
``make_crc_fn`` / ``crc32c_device``, ``make_batch_validator``, the row
packers, ``CrcBackend``, the single-device ``RaftDevicePlane`` and both
recovery scans. Every result must be bit-identical; there is no tolerance.
The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from redpanda_tpu.hashing.crc32c import crc32c_many as jax_crc32c_many
from redpanda_tpu.models import Record as RRecord
from redpanda_tpu.models import RecordBatch as RRecordBatch
from redpanda_tpu.ops import packing as RPK
from redpanda_tpu.ops.crc32c_device import crc32c_device as jax_crc32c_device
from redpanda_tpu.ops.crc32c_device import make_crc_fn as jax_make_crc_fn
from redpanda_tpu.ops import pipeline as RP
from redpanda_tpu.ops.crc_backend import CrcBackend as RCrcBackend
from redpanda_tpu.raft import device_plane as RDP
from redpanda_tpu.storage import recovery as RREC
from redpanda_tpu_torch import kernels
from redpanda_tpu_torch.hashing.crc32c import TABLE, TABLE8, crc32c, crc32c_many, crc32c_update
from redpanda_tpu_torch.models import Record, RecordBatch
from redpanda_tpu_torch.models.record import RecordBatchType
from redpanda_tpu_torch.ops import crc32c_device as C
from redpanda_tpu_torch.ops import packing as PK
from redpanda_tpu_torch.ops import pipeline as P
from redpanda_tpu_torch.ops.crc_backend import CrcBackend
from redpanda_tpu_torch.raft import device_plane as DP
from redpanda_tpu_torch.storage import recovery as REC


def _edge_rows(r: int, seed: int, extra: int = 12):
    """Rows of width r with random bytes everywhere (so bytes past each
    length are garbage) at the edge lengths and random ones."""
    rng = np.random.default_rng(seed)
    lens = [0, 1, 7, 8, 15, 16, 17, 63, 64, 65, r - 1, r, r + 5, -3]
    lens += [int(x) for x in rng.integers(0, r + 1, extra)]
    data = rng.integers(0, 256, size=(len(lens), r), dtype=np.uint8)
    return data, np.array(lens, np.int32)


def _oracle(data, lens):
    r = data.shape[1]
    return np.array([crc32c(data[i, : max(0, min(int(n), r))].tobytes())
                     for i, n in enumerate(lens)], np.uint32)


# ------------------------------------------------------------------ K5
@pytest.mark.parametrize("r", [100, 512, 1300])
def test_crc_matches_jax_at_edge_lengths(r):
    data, lens = _edge_rows(r, seed=r)
    want = np.asarray(jax_make_crc_fn(r)(data, lens))
    got = C.make_crc_fn(r, "cpu")(data, lens)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _oracle(data, lens))
    np.testing.assert_array_equal(got, jax_crc32c_many(data, lens))
    np.testing.assert_array_equal(crc32c_many(data, lens), jax_crc32c_many(data, lens))


def test_crc_rows_plain_is_the_cpu_wrapper():
    data, lens = _edge_rows(256, seed=3)
    d, ln = torch.from_numpy(data), torch.from_numpy(lens)
    got = C.crc32c_rows(d, ln)
    assert got.dtype == torch.int32 and torch.equal(got, C.crc_plain(d, ln))
    np.testing.assert_array_equal(C.as_u32(got), jax_crc32c_many(data, lens))
    with pytest.raises(ValueError):
        C.crc32c_rows(d[:, ::2], ln)
    with pytest.raises(ValueError):
        C.crc32c_rows(d, ln.long())
    with pytest.raises(ValueError):
        C.validate_rows(d, ln, ln[:-1])


def test_crc32c_device_keeps_leading_shape():
    rng = np.random.default_rng(1)  # tests/test_ops.py
    data = rng.integers(0, 256, size=(4, 8, 128), dtype=np.uint8)
    lens = rng.integers(0, 129, size=(4, 8)).astype(np.int32)
    got = C.crc32c_device(data, lens, device="cpu")
    want = np.asarray(jax_crc32c_device(data, lens))
    assert got.shape == (4, 8)
    np.testing.assert_array_equal(got, want)


def test_crc_random_messages_like_test_ops():
    rng = np.random.default_rng(42)
    r = 512
    sizes = [0, 1, 7, 8, 9, 63, 64, 65, 100, 511, 512] + list(rng.integers(1, r, 20))
    msgs = [rng.integers(0, 256, size=s, dtype=np.uint8).tobytes() for s in sizes]
    rows, lens = PK.pack_rows(msgs, r)
    got = C.crc32c_device(rows, lens, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(jax_crc32c_device(*RPK.pack_rows(msgs, r))))
    np.testing.assert_array_equal(got, np.array([crc32c(m) for m in msgs], np.uint32))


def _advance(s: int, nbytes: int) -> int:
    for _ in range(nbytes):
        s = int(TABLE[s & 0xFF]) ^ (s >> 8)
    return s


def _multmodp(a: int, b: int) -> int:
    p = 0
    for k in range(32):
        if a & (0x80000000 >> k):
            p ^= b
        b = (b >> 1) ^ 0x82F63B78 if b & 1 else b >> 1
    return p


def _register(data: bytes, init: int) -> int:
    return crc32c_update(init, data)


def test_kernel_tables_combine_registers():
    """The tables the kernel stages: the byte-sliced 496-byte skip and the
    powers x^(8n) join two registers as the kernel joins its lanes."""
    t = C.kernel_tables()
    skip, pows = t[2048:3072], t[3072:]
    assert np.array_equal(t[:2048].reshape(8, 256), TABLE8)
    rng = np.random.default_rng(9)
    for s in [int(x) for x in rng.integers(0, 2**32, 8, dtype=np.uint64)]:
        sliced = int(skip[s & 0xFF] ^ skip[256 + ((s >> 8) & 0xFF)]
                     ^ skip[512 + ((s >> 16) & 0xFF)] ^ skip[768 + (s >> 24)])
        assert sliced == _advance(s, C.ROUND - C.BLOCK)
    for n in [1, 2, 15, 16, 17, 100, 496, C.ROUND - 1]:
        a, b = rng.bytes(int(rng.integers(0, 300))), rng.bytes(n)
        joined = _multmodp(int(pows[n]), _register(a, 0xFFFFFFFF)) ^ _register(b, 0)
        assert joined == _register(a + b, 0xFFFFFFFF)


# ------------------------------------------------------------------ K6 + packing
def _batches(mod):
    rec, batch = (Record, RecordBatch) if mod == "port" else (RRecord, RRecordBatch)
    return [
        batch.build([rec(offset_delta=i, value=f"v{i}-{o}".encode() * (1 + o % 7)) for i in range(3)],
                    base_offset=o)
        for o in (0, 10, 20, 30, 40)
    ]


def test_pack_rows_and_unpack_match_jax():
    payloads = [b"alpha", b"", b"x" * 64, b"beta-beta", b"y" * 100]
    rows, lens = PK.pack_rows(payloads, 64)
    want_rows, want_lens = RPK.pack_rows(payloads, 64)
    np.testing.assert_array_equal(rows, want_rows)
    np.testing.assert_array_equal(lens, want_lens)
    assert PK.unpack_rows(rows, lens) == RPK.unpack_rows(want_rows, want_lens)
    assert PK.unpack_rows(rows, lens)[:4] == payloads[:4]


def test_batch_validator_matches_jax():
    rows, lens, crcs = PK.pack_batches_prefixed(_batches("port"), 256)
    want = RPK.pack_batches_prefixed(_batches("jax"), 256)
    for a, b in zip((rows, lens, crcs), want):
        np.testing.assert_array_equal(a, b)
    rows[1, 50] ^= 0xFF  # corrupt one payload byte
    claimed = crcs.copy()
    claimed[3] ^= 1
    lens = lens.copy()
    lens[4] = 0  # an empty row never validates, even with the CRC of nothing
    claimed[4] = 0
    got = P.make_batch_validator(256, "cpu")(rows, lens, claimed)
    ref = np.asarray(RP.make_batch_validator(256)(rows, lens, claimed))
    np.testing.assert_array_equal(got, ref)
    assert got.tolist() == [True, False, True, False, False]


# ------------------------------------------------------------------ CrcBackend
def _regions(mod):
    """tests/test_crc_backend.py's regions."""
    rec, batch = (Record, RecordBatch) if mod == "port" else (RRecord, RRecordBatch)
    batches = [batch.build([rec(offset_delta=0, value=bytes([b % 251]) * 700)], base_offset=b)
               for b in range(16)]
    return [b.crc_region() for b in batches], np.array([b.header.crc for b in batches], np.uint32)


def test_crc_backend_host_and_device_match_jax():
    regions, claimed = _regions("port")
    assert regions == _regions("jax")[0]
    bad = claimed.copy()
    bad[3] ^= 0xDEAD
    bad[11] ^= 1
    for c in (claimed, bad):
        want = RCrcBackend("host").validate(regions, c)
        np.testing.assert_array_equal(want, RCrcBackend("device").validate(regions, c))
        np.testing.assert_array_equal(CrcBackend("host").validate(regions, c), want)
        np.testing.assert_array_equal(CrcBackend("device", device="cpu").validate(regions, c), want)
    assert CrcBackend("device", device="cpu").validate(regions, bad).sum() == 14


def test_crc_backend_pick_records_measurement():
    regions, _ = _regions("port")
    b = CrcBackend.pick(regions, reps=2, device="cpu")
    d = b.decision
    assert d.host_batches_per_sec > 0 and d.device_batches_per_sec > 0
    want = "device" if d.device_batches_per_sec > d.host_batches_per_sec else "host"
    assert b.backend == d.backend == want


def test_default_backend_is_picked_once_per_device(monkeypatch):
    from redpanda_tpu_torch.ops import crc_backend as CB

    monkeypatch.setattr(CB, "_defaults", {})
    b = CB.default_backend("cpu")
    assert b.decision is not None and b.decision.device_batches_per_sec > 0
    assert CB.default_backend("cpu") is b
    import asyncio

    assert asyncio.run(CB.default_backend_async("cpu")) is b


def test_crc_backend_empty_input():
    assert CrcBackend("host").validate([], []).shape == (0,)
    assert CrcBackend("device", device="cpu").validate([], []).shape == (0,)
    # an empty region with the CRC of nothing: the reference's host backend
    # accepts it and its device backend (len > 0) rejects it; both kept
    for backend, want in (("host", True), ("device", False)):
        assert RCrcBackend(backend).validate([b""], [0]).tolist() == [want]
    assert CrcBackend("host").validate([b""], [0]).tolist() == [True]
    assert CrcBackend("device", device="cpu").validate([b""], [0]).tolist() == [False]
    with pytest.raises(ValueError):
        CrcBackend("gpu")


# ------------------------------------------------------------------ raft plane
def _raft_regions():
    """tests/test_meshrunner.py's regions (single-device half)."""
    rng = np.random.default_rng(5)
    regions = [rng.bytes(64 + 13 * i) for i in range(96)]
    claimed = np.array([crc32c(x) for x in regions], np.uint32)
    claimed[7] ^= 0x10
    return regions, claimed, rng


def test_raft_plane_matches_jax_single_device():
    regions, claimed, rng = _raft_regions()
    regions = regions + [b""]
    claimed = np.append(claimed, np.uint32(0))
    want = RDP.RaftDevicePlane(probe=False).validate(regions, claimed)
    pinned = DP.RaftDevicePlane(probe=False, device="cpu")
    np.testing.assert_array_equal(pinned.validate(regions, claimed), want)
    assert want.sum() == 95 and not want[7] and not want[-1]
    probing = DP.RaftDevicePlane(probe=True, device="cpu")
    np.testing.assert_array_equal(probing.validate(regions, claimed), want)
    st = probing.stats()
    assert st["decision"] in ("host", "device") and st["probe"]["chosen"] == st["decision"]
    assert st["probe"]["rows"] == len(regions) and st["validations"] == 1
    votes = rng.integers(0, 2, (4, 32)).astype(np.uint8)
    np.testing.assert_array_equal(pinned.tally_votes(votes), RDP.RaftDevicePlane(probe=False).tally_votes(votes))
    assert pinned.stats()["tallies"] == 1
    assert pinned.validate([], []).shape == (0,)


def test_raft_plane_routing_matches_jax(monkeypatch):
    regions, claimed, _ = _raft_regions()
    small = DP.RaftDevicePlane(probe=True, device="cpu")

    def no_device(*_a, **_k):
        raise AssertionError("the device leg ran")

    monkeypatch.setattr(small, "_run_device", no_device)
    few = DP.PROBE_MIN_ROWS - 1
    np.testing.assert_array_equal(
        small.validate(regions[:few], claimed[:few]),
        RDP.RaftDevicePlane(probe=True).validate(regions[:few], claimed[:few]),
    )
    assert small.decision is None  # too few rows to probe on: nothing pinned
    # one outsized region buckets every row past the pack budget: host, unpinned
    wide = regions + [b"w" * (1 << 20)]
    wide_claimed = np.append(claimed, np.uint32(crc32c(wide[-1])))
    assert len(wide) * DP._bucket(1 << 20) > DP._PACK_BUDGET_BYTES
    np.testing.assert_array_equal(
        small.validate(wide, wide_claimed), RDP.RaftDevicePlane(probe=True).validate(wide, wide_claimed))
    assert small.decision is None
    assert DP.PROBE_MIN_ROWS == RDP.PROBE_MIN_ROWS
    assert DP._PACK_BUDGET_BYTES == RDP._PACK_BUDGET_BYTES
    assert [DP._bucket(x) for x in (1, 64, 65, 5000)] == [RDP._bucket(x) for x in (1, 64, 65, 5000)]


def test_raft_plane_config_and_default_plane():
    DP.configure(crc_validate=True, vote_tally=True)
    try:
        assert DP.crc_validate_enabled() and DP.vote_tally_enabled()
    finally:
        DP.configure(crc_validate=False, vote_tally=False)
    assert not DP.crc_validate_enabled() and not DP.vote_tally_enabled()
    DP.reset_default_plane()
    try:
        plane = DP.default_plane(device="cpu")
        assert plane is DP.default_plane(device="cpu") and plane.n_devices == 1
    finally:
        DP.reset_default_plane()
    from redpanda_tpu_torch.parallel import partition_mesh

    plane = DP.RaftDevicePlane(mesh=partition_mesh(2, device="cpu"), device="cpu")
    assert plane.n_devices == 2 and plane.mesh is not None


# ------------------------------------------------------------------ recovery
def _segment(mod, frames: int = 6, value_size: int = 24):
    """A segment of 2-record batches like tests/test_storage.py's."""
    rec, batch = (Record, RecordBatch) if mod == "port" else (RRecord, RRecordBatch)
    out = []
    for i in range(frames):
        rng = np.random.default_rng(1000 + i)
        recs = [rec(offset_delta=k, timestamp_delta=k, value=rng.bytes(value_size)) for k in range(2)]
        b = batch.build(recs, type=RecordBatchType.raft_data, first_timestamp=0, max_timestamp=1)
        out.append(b.with_base_offset(2 * i).encode_internal())
    return b"".join(out)


def _scans(blob: bytes, row_stride: int = 4096):
    got = (REC.scan_valid_prefix_host(blob),
           REC.scan_valid_prefix_device(blob, row_stride=row_stride, device="cpu"))
    want = (RREC.scan_valid_prefix_host(blob), RREC.scan_valid_prefix_device(blob, row_stride))
    return got, want


def test_recovery_scans_match_jax_on_torn_segments():
    blob = _segment("port")
    assert blob == _segment("jax")
    got, want = _scans(blob)
    assert got == want and got[0] == (len(blob), 11)
    frame = len(blob) // 6
    corrupt = bytearray(blob)
    corrupt[3 * frame + 70] ^= 0xFF  # a payload byte of the 4th frame
    got, want = _scans(bytes(corrupt))
    assert got == want and got[1][1] == 5
    torn = blob[: 5 * frame - 17]  # a torn write inside the 5th frame
    got, want = _scans(torn)
    assert got == want and got[0] == (4 * frame, 7)
    hdr = bytearray(blob)
    hdr[2 * frame + 9] ^= 0x01  # a header byte of the 3rd frame
    got, want = _scans(bytes(hdr))
    assert got == want and got[0] == (2 * frame, 3)
    got, want = _scans(blob[:40])
    assert got == want and got[0] == (0, -1)
    got, want = _scans(blob, row_stride=64)  # frames wider than the row: the host scan
    assert got == want and got[1] == (len(blob), 11)


# ------------------------------------------------------------------ no fallback
def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")
    import asyncio

    from redpanda_tpu_torch.ops.crc_backend import default_backend, default_backend_async
    from redpanda_tpu_torch.storage.recovery import scan_valid_prefix_device

    for make in (lambda: C.make_crc_fn(64), lambda: C.crc32c_device(np.zeros((1, 8), np.uint8), [1]),
                 lambda: P.make_batch_validator(64), lambda: CrcBackend("device"), CrcBackend,
                 lambda: CrcBackend.pick([b"x"] * 4, reps=1), default_backend,
                 lambda: asyncio.run(default_backend_async()), lambda: DP.RaftDevicePlane(),
                 lambda: scan_valid_prefix_device(_segment("port"))):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def _failing_launch(monkeypatch):
    """Every CRC wrapper launches a kernel whose entry point reports CUDA
    error 700 (an illegal address)."""
    for k in (kernels.CRC32C, kernels.CRC32C_VALIDATE):
        monkeypatch.setattr(k, "fn", lambda: (lambda *args: 700))
    monkeypatch.setattr(C, "crc32c_rows", lambda d, ln: kernels.CRC32C.launch())
    monkeypatch.setattr(P, "validate_rows", lambda d, ln, c: kernels.CRC32C_VALIDATE.launch())


def test_device_leg_failure_raises_instead_of_using_the_host(monkeypatch):
    regions, claimed, _ = _raft_regions()
    _failing_launch(monkeypatch)
    before = kernels.CRC32C.launches, kernels.CRC32C_VALIDATE.launches
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        CrcBackend("device", device="cpu").validate(regions, claimed)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        CrcBackend.pick(regions, reps=1, device="cpu")
    for probe in (True, False):
        plane = DP.RaftDevicePlane(probe=probe, device="cpu")
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            plane.validate(regions, claimed)
        assert plane.decision in (None, "device")  # a failed probe pins nothing
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        REC.scan_valid_prefix_device(_segment("port"), device="cpu")
    # a launch that failed is not counted
    assert (kernels.CRC32C.launches, kernels.CRC32C_VALIDATE.launches) == before


def test_device_disagreement_on_probe_rows_raises(monkeypatch):
    regions, claimed, _ = _raft_regions()
    monkeypatch.setattr(C, "crc32c_rows", lambda d, ln: torch.zeros(d.shape[0], dtype=torch.int32))
    monkeypatch.setattr(P, "validate_rows", lambda d, ln, c: torch.zeros(d.shape[0], dtype=torch.bool))
    with pytest.raises(RuntimeError, match="disagrees"):
        DP.RaftDevicePlane(probe=True, device="cpu").validate(regions, claimed)
    with pytest.raises(RuntimeError, match="disagrees"):
        CrcBackend.pick(regions, reps=1, device="cpu")
