"""The port's storage layer (redpanda_tpu_torch/storage/) against the JAX
package's, on the CPU.

Every test of tests/test_storage.py and tests/test_file_sanitizer.py has a
counterpart here: the same op sequence, with the same inputs (the
reference suites' own batch generators, each batch built once by the JAX
package and handed to both packages as its encoded bytes), runs through
each package in a directory of its own. The answers (offsets, reads,
timequery and truncation results, compaction's key index, the kvstore's
reads, the sanitizer's errors) must be equal, and so must every file the
two runs leave on disk, byte for byte: segment data and index files,
compacted segments, the kvstore's WAL and snapshot. There is no tolerance.

Then state crosses the packages, as weights do in a model's port: a log
and a kvstore directory written by one package open in the other, whose
recovery cuts their torn tails at the same frame. ``recover_segment`` on
the card's path (``use_device=True``) runs K5's plain version here and
cuts where the JAX package's host and device scans cut; without a card it
raises and scans nothing on the host.
"""

from __future__ import annotations

import asyncio
import importlib
import inspect
import os
import shutil
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from test_file_sanitizer import _batch as sanitizer_batch
from test_storage import _batch as ref_batch
from test_storage import _kv_batch as ref_kv_batch


def _pkg(root: str, **dev) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        root=root,
        dev=dev,  # how this package's device scan is asked to run on the CPU
        record=m("models.record"),
        NTP=m("models.fundamental").NTP,
        storage=m("storage"),
        log=m("storage.log"),
        segment=m("storage.segment"),
        recovery=m("storage.recovery"),
        compaction=m("storage.compaction"),
        snapshot=m("storage.snapshot"),
        sanitizer=m("storage.file_sanitizer"),
        batch_cache=m("storage.batch_cache"),
        readers_cache=m("storage.readers_cache"),
        backlog=m("storage.backlog_controller"),
        finjector=m("finjector"),
        budgets=m("resource_mgmt.budgets"),
        probes=m("observability.probes"),
        trace=m("observability.trace"),
        models=m("models"),
        iobuf=m("utils.iobuf"),
    )


# The JAX package's device scan runs its jitted K5 on the CPU; the port's
# is asked for the CPU, where the wrapper runs K5's plain version.
PKGS = {"jax": _pkg("redpanda_tpu"), "port": _pkg("redpanda_tpu_torch", device="cpu")}
FIXED_NOW_S = 1_700_000_000.25  # time.time() in both packages' log and compaction


def log_config(pk, **kw):
    """A LogConfig of ``pk``; device recovery runs on the CPU."""
    if kw.get("use_device_recovery") and "device" in pk.dev:
        kw.setdefault("recovery_device", pk.dev["device"])
    return pk.log.LogConfig(**kw)


def conv(pk, batch):
    """``batch`` (built once, by the JAX package) as ``pk``'s batch, from its
    encoded bytes."""
    return pk.record.RecordBatch.decode_internal(batch.encode_internal())[0]


def seen(batches) -> list:
    return [(b.base_offset, b.header.term, b.encode_internal()) for b in batches]


def offsets(log) -> tuple:
    o = log.offsets()
    return o.start_offset, o.dirty_offset, o.committed_offset


def segments(log) -> list:
    return [(s.base_offset, s.term, s.size_bytes, s.dirty_offset, s.max_timestamp,
             [(e.rel_offset, e.file_pos, e.timestamp) for e in s.index.entries])
            for s in log.segments]


def tree(root) -> dict:
    """Every file under ``root``: relative path -> bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def error(e: BaseException, d: str) -> tuple:
    return type(e).__name__, str(e).split("\n")[0].replace(d, "<dir>")


def run_both(scenario, tmp_path) -> list:
    """Run ``scenario(pk, dir, obs)`` through each package in a directory of
    its own; the observations and the files left behind must be equal."""
    got = {}
    for name, pk in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        obs: list = []
        res = scenario(pk, str(d), obs)
        if inspect.iscoroutine(res):
            asyncio.run(res)
        got[name] = obs
    assert got["port"] == got["jax"]
    files = tree(tmp_path / "port")
    assert files == tree(tmp_path / "jax")
    return got["port"]


class _Clock:
    """The ``time`` module with a fixed ``time()``."""

    def time(self):
        return FIXED_NOW_S

    def __getattr__(self, name):
        return getattr(time, name)


def _disarm(badger) -> None:
    for module, armed in list(badger.armed().items()):
        for probe in armed:
            badger.unset(module, probe)
    badger.disable()


@pytest.fixture(autouse=True)
def _globals(monkeypatch):
    """Both packages' process globals (the sanitizer, the honey badger, the
    budget plane) are reset around every test; their clocks are fixed."""
    saved = [pk.finjector.honey_badger.delay_ms for pk in PKGS.values()]
    for pk in PKGS.values():
        monkeypatch.setattr(pk.compaction, "time", _Clock())
        monkeypatch.setattr(pk.log, "time", _Clock())
    yield
    for pk, delay in zip(PKGS.values(), saved):
        pk.sanitizer.disable()
        _disarm(pk.finjector.honey_badger)
        pk.finjector.honey_badger.delay_ms = delay
        pk.budgets.install(None)


def ntp(pk, topic="t-log", p=0):
    return pk.NTP.kafka(topic, p)


# ------------------------------------------------------------ tests/test_storage.py
async def s_append_read_roundtrip(pk, d, obs):
    log = await pk.log.DiskLog.open(ntp(pk), log_config(pk, base_dir=d))
    try:
        r1 = await log.append([conv(pk, ref_batch(3)), conv(pk, ref_batch(2))])
        r2 = await log.append([conv(pk, ref_batch(4))])
        batches = await log.read(0)
        assert [b.base_offset for b in batches] == [0, 3, 5]
        assert all(b.verify_kafka_crc() and b.verify_header_crc() for b in batches)
        obs += [(r1.base_offset, r1.last_offset, r1.byte_size), (r2.base_offset, r2.last_offset),
                seen(batches), seen(await log.read(3, max_offset=4)), offsets(log)]
    finally:
        await log.close()


async def s_reopen_preserves_state(pk, d, obs):
    cfg = log_config(pk, base_dir=d)
    log = await pk.log.DiskLog.open(ntp(pk), cfg)
    await log.append([conv(pk, ref_batch(3)), conv(pk, ref_batch(3))])
    await log.flush()
    await log.close()
    log2 = await pk.log.DiskLog.open(ntp(pk), cfg)
    try:
        obs += [offsets(log2), segments(log2), seen(await log2.read(0))]
        r = await log2.append([conv(pk, ref_batch(1))])
        assert r.base_offset == 6
        obs.append(r.base_offset)
    finally:
        await log2.close()


async def s_segment_roll_and_read_across(pk, d, obs):
    log = await pk.log.DiskLog.open(ntp(pk), log_config(pk, base_dir=d, max_segment_size=400))
    try:
        for _ in range(10):
            await log.append([conv(pk, ref_batch(2, value_size=64))])
        assert len(log.segments) > 1
        batches = await log.read(0, max_bytes=1 << 30)
        assert [b.base_offset for b in batches] == [2 * i for i in range(10)]
        obs += [segments(log), seen(batches)]
    finally:
        await log.close()


async def s_truncate_suffix(pk, d, obs):
    log = await pk.log.DiskLog.open(ntp(pk), log_config(pk, base_dir=d))
    try:
        for _ in range(5):
            await log.append([conv(pk, ref_batch(2))])
        await log.truncate(6)
        assert log.offsets().dirty_offset == 5
        obs += [offsets(log), segments(log), seen(await log.read(0))]
        obs.append((await log.append([conv(pk, ref_batch(1))])).base_offset)
    finally:
        await log.close()


async def s_prefix_truncate_and_retention(pk, d, obs):
    log = await pk.log.DiskLog.open(ntp(pk), log_config(pk, base_dir=d, max_segment_size=300))
    try:
        for _ in range(10):
            await log.append([conv(pk, ref_batch(2, value_size=64))])
        await log.prefix_truncate(8)
        batches = await log.read(0)
        assert log.offsets().start_offset == 8 and all(b.last_offset >= 8 for b in batches)
        obs += [offsets(log), segments(log), seen(batches)]
    finally:
        await log.close()


async def s_timequery(pk, d, obs):
    log = await pk.log.DiskLog.open(ntp(pk), log_config(pk, base_dir=d))
    try:
        for i in range(5):
            await log.append([conv(pk, ref_batch(2, ts=1000 * i))])
        for ts in (-1, 0, 2500, 4000, 4001, 10**12):
            obs.append(await log.timequery(ts))
        assert obs[2] == 6
    finally:
        await log.close()


async def _four_flushed(pk, d, cfg, value_size=32):
    log = await pk.log.DiskLog.open(ntp(pk), cfg)
    for _ in range(4):
        await log.append([conv(pk, ref_batch(2, value_size=value_size))])
    await log.flush()
    tail = log.segments[-1]
    await log.close()
    return tail


async def s_recovery_truncates_torn_write(pk, d, obs):
    cfg = log_config(pk, base_dir=d)
    tail = await _four_flushed(pk, d, cfg)
    with open(tail.data_path, "r+b") as f:
        f.truncate(os.path.getsize(tail.data_path) - 7)
    log2 = await pk.log.DiskLog.open(ntp(pk), cfg)
    try:
        assert log2.offsets().dirty_offset == 5
        obs += [offsets(log2), segments(log2), seen(await log2.read(0))]
        obs.append((await log2.append([conv(pk, ref_batch(1))])).base_offset)
    finally:
        await log2.close()


async def s_recovery_detects_corruption_midfile(pk, d, obs):
    cfg = log_config(pk, base_dir=d)
    tail = await _four_flushed(pk, d, cfg)
    with open(tail.data_path, "r+b") as f:
        f.seek(os.path.getsize(tail.data_path) // 2)
        f.write(b"\xde\xad")
    log2 = await pk.log.DiskLog.open(ntp(pk), cfg)
    try:
        got = await log2.read(0)
        assert log2.offsets().dirty_offset < 7 and all(b.verify_kafka_crc() for b in got)
        obs += [offsets(log2), segments(log2), seen(got)]
    finally:
        await log2.close()


def s_device_recovery_scan_matches_host(pk, d, obs):
    blob = b"".join(ref_batch(2, value_size=24).with_base_offset(2 * i).encode_internal()
                    for i in range(6))
    scan_dev = pk.recovery.scan_valid_prefix_device
    obs += [pk.recovery.scan_valid_prefix_host(blob), scan_dev(blob, **pk.dev)]
    assert obs[-2] == obs[-1] == (len(blob), 11)
    corrupt = bytearray(blob)
    corrupt[3 * (len(blob) // 6) + 70] ^= 0xFF
    obs += [pk.recovery.scan_valid_prefix_host(bytes(corrupt)), scan_dev(bytes(corrupt), **pk.dev)]
    assert obs[-2] == obs[-1] and obs[-1][1] == 5


async def s_recovery_fully_corrupt_tail_no_offset_hole(pk, d, obs):
    cfg = log_config(pk, base_dir=d, max_segment_size=250)
    tail = await _four_flushed(pk, d, cfg, value_size=64)
    with open(tail.data_path, "r+b") as f:
        f.write(b"\xff\xff\xff\xff")
    log2 = await pk.log.DiskLog.open(ntp(pk), cfg)
    try:
        assert log2.offsets().dirty_offset == tail.base_offset - 1
        r = await log2.append([conv(pk, ref_batch(1))])
        assert r.base_offset == tail.base_offset
        obs += [offsets(log2), segments(log2), seen(await log2.read(0))]
    finally:
        await log2.close()


async def s_term_survives_restart(pk, d, obs):
    cfg = log_config(pk, base_dir=d)
    log = await pk.log.DiskLog.open(ntp(pk), cfg)
    await log.append([conv(pk, ref_batch(2))], term=3)
    await log.append([conv(pk, ref_batch(2))], term=5)
    obs += [log.term, seen(await log.read(0))]
    await log.flush()
    await log.close()
    log2 = await pk.log.DiskLog.open(ntp(pk), cfg)
    try:
        got = await log2.read(0)
        assert log2.term == 5 and [b.header.term for b in got] == [3, 5]
        obs += [log2.term, seen(got), segments(log2)]
    finally:
        await log2.close()


async def s_follower_append_preserves_wire_terms_across_restart(pk, d, obs):
    cfg = log_config(pk, base_dir=d)

    def at(base, term):
        b = conv(pk, ref_batch(2).with_base_offset(base))
        b.header.term = term
        return b

    log = await pk.log.DiskLog.open(ntp(pk), cfg)
    await log.append([at(0, 5), at(2, 7), at(4, 7)], assign_offsets=False)
    obs.append(seen(await log.read(0)))
    await log.flush()
    await log.close()
    log2 = await pk.log.DiskLog.open(ntp(pk), cfg)
    obs.append(seen(await log2.read(0)))
    await log2.truncate(2)
    await log2.append([at(2, 6)], assign_offsets=False)
    obs.append(seen(await log2.read(0)))
    await log2.flush()
    await log2.close()
    log3 = await pk.log.DiskLog.open(ntp(pk), cfg)
    try:
        got = await log3.read(0)
        assert [b.header.term for b in got] == [5, 6]
        obs += [seen(got), segments(log3)]
    finally:
        await log3.close()


def s_kvstore_stop_without_start_preserves_state(pk, d, obs):
    kvs = pk.storage
    path = os.path.join(d, "kv")
    kv = kvs.KvStore(path).start()
    kv.put(kvs.KeySpace.consensus, b"voted_for", b"node-3")
    kv.stop()
    kvs.KvStore(path).stop()
    kv2 = kvs.KvStore(path).start()
    obs.append(kv2.get(kvs.KeySpace.consensus, b"voted_for"))
    assert obs[-1] == b"node-3"
    kv2.stop()


def s_kvstore_roundtrip_and_recovery(pk, d, obs):
    kvs, path = pk.storage, os.path.join(d, "kv")
    KS = kvs.KeySpace
    kv = kvs.KvStore(path).start()
    kv.put(KS.consensus, b"voted_for", b"node-3")
    kv.put(KS.storage, b"start_offset", b"42")
    kv.remove(KS.storage, b"missing")
    kv.stop()
    kv2 = kvs.KvStore(path).start()
    obs += [kv2.get(KS.consensus, b"voted_for"), kv2.get(KS.storage, b"start_offset"),
            kv2.get(KS.storage, b"missing")]
    kv2.put(KS.consensus, b"voted_for", b"node-5")
    kv2.stop()
    kv3 = kvs.KvStore(path).start()
    obs += [kv3.get(KS.consensus, b"voted_for"), sorted(kv3.keys(KS.storage))]
    assert obs[:3] == [b"node-3", b"42", None] and obs[3] == b"node-5"
    kv3.stop()


def s_kvstore_wal_only_recovery(pk, d, obs):
    kvs, path = pk.storage, os.path.join(d, "kv")
    kv = kvs.KvStore(path).start()
    kv.put(kvs.KeySpace.coproc, b"k1", b"v1")
    kv.put(kvs.KeySpace.coproc, b"k2", b"v2")
    kv._wal.close()  # a crash: no snapshot
    obs.append(tree(path))  # the WAL alone
    kv2 = kvs.KvStore(path).start()
    obs += [kv2.get(kvs.KeySpace.coproc, b"k1"), kv2.get(kvs.KeySpace.coproc, b"k2")]
    assert obs[1:] == [b"v1", b"v2"]
    kv2.stop()


def s_kvstore_torn_wal_tail(pk, d, obs):
    kvs, path = pk.storage, os.path.join(d, "kv")
    kv = kvs.KvStore(path).start()
    kv.put(kvs.KeySpace.testing, b"a", b"1")
    kv.put(kvs.KeySpace.testing, b"b", b"2")
    kv._wal.close()
    wal = os.path.join(path, "kvstore.wal")
    with open(wal, "r+b") as f:
        f.truncate(os.path.getsize(wal) - 3)
    obs.append(tree(path))  # the torn WAL
    kv2 = kvs.KvStore(path).start()
    obs += [kv2.get(kvs.KeySpace.testing, b"a"), kv2.get(kvs.KeySpace.testing, b"b")]
    assert obs[1:] == [b"1", None]
    kv2.stop()


def s_snapshot_roundtrip(pk, d, obs):
    p = os.path.join(d, "snap")
    pk.storage.write_snapshot(p, b"meta", b"payload-bytes")
    obs.append(pk.storage.read_snapshot(p))
    mgr = pk.storage.SnapshotManager(os.path.join(d, "mgr"), "named")
    obs.append(mgr.read())
    mgr.write(b"m2", bytes(range(256)))
    obs += [mgr.exists(), mgr.read()]
    assert obs[0] == (b"meta", b"payload-bytes")


def s_snapshot_corruption_detected(pk, d, obs):
    for at in (-2, 5, 14):  # the payload, the metadata length, the metadata
        p = os.path.join(d, f"snap{at}")
        pk.storage.write_snapshot(p, b"meta", b"payload-bytes")
        with open(p, "rb") as f:
            blob = bytearray(f.read())
        blob[at] ^= 1
        with open(p, "wb") as f:
            f.write(blob)
        with pytest.raises(pk.snapshot.SnapshotError) as e:
            pk.storage.read_snapshot(p)
        obs.append(error(e.value, d))


async def s_log_manager_manage_and_remove(pk, d, obs):
    mgr = pk.storage.LogManager(log_config(pk, base_dir=d))
    try:
        a = await mgr.manage(ntp(pk, "a", 0))
        await mgr.manage(ntp(pk, "b", 1))
        assert a is await mgr.manage(ntp(pk, "a", 0))
        await a.append([conv(pk, ref_batch(1))])
        await mgr.remove(ntp(pk, "a", 0))
        obs += [mgr.get(ntp(pk, "a", 0)) is None, os.path.exists(os.path.join(d, "kafka/a/0")),
                sorted(str(n) for n in mgr.logs())]
    finally:
        await mgr.stop()


async def s_opfuzz_random_interleaving(pk, d, obs):
    rng = np.random.default_rng(1234)
    cfg = log_config(pk, base_dir=d, max_segment_size=600)
    log = await pk.log.DiskLog.open(ntp(pk, "fuzz"), cfg)
    model: list = []
    start = 0

    def dirty():
        return model[-1].last_offset if model else start - 1

    try:
        for step in range(120):
            op = rng.choice(["append", "read", "truncate", "prefix", "reopen"],
                            p=[0.5, 0.2, 0.1, 0.1, 0.1])
            if op == "append":
                b = conv(pk, ref_batch(int(rng.integers(1, 4)), value_size=int(rng.integers(8, 80))))
                r = await log.append([b])
                assert r.base_offset == dirty() + 1, f"step {step}"
                model.append(b.with_base_offset(r.base_offset))
                obs.append(("append", r.base_offset, r.last_offset))
            elif op == "read":
                got = await log.read(start, max_bytes=1 << 30)
                assert [g.base_offset for g in got] == [
                    w.base_offset for w in model if w.last_offset >= start], f"step {step}"
                obs.append(("read", seen(got)))
            elif op == "truncate" and model:
                cut = int(rng.integers(start, dirty() + 2))
                await log.truncate(cut)
                model = [b for b in model if b.last_offset < cut]
                obs.append(("truncate", cut, offsets(log)))
            elif op == "prefix" and model:
                cut = int(rng.integers(start, dirty() + 2))
                await log.prefix_truncate(cut)
                start = max(start, cut)
                obs.append(("prefix", cut, offsets(log)))
            elif op == "reopen":
                await log.flush()
                await log.close()
                log = await pk.log.DiskLog.open(ntp(pk, "fuzz"), cfg)
                assert log.offsets().dirty_offset == dirty(), f"step {step}"
                obs.append(("reopen", offsets(log), segments(log)))
    finally:
        await log.close()


async def s_opfuzz_with_caches_and_cursors(pk, d, obs):
    rng = np.random.default_rng(987654)

    def manager():
        return pk.storage.LogManager(log_config(pk, base_dir=d, max_segment_size=600),
                                     batch_cache_bytes=8 << 10)

    mgr = manager()
    log = await mgr.manage(ntp(pk, "fuzzc"))
    model: list = []
    start = 0

    def dirty():
        return model[-1].last_offset if model else start - 1

    try:
        for step in range(150):
            op = rng.choice(["append", "read", "read_seq", "truncate", "prefix", "reopen"],
                            p=[0.4, 0.15, 0.2, 0.1, 0.05, 0.1])
            if op == "append":
                b = conv(pk, ref_batch(int(rng.integers(1, 4)), value_size=int(rng.integers(8, 80))))
                r = await log.append([b])
                model.append(b.with_base_offset(r.base_offset))
                obs.append(("append", r.base_offset))
            elif op == "read":
                got = await log.read(start, max_bytes=1 << 30)
                assert [g.base_offset for g in got] == [
                    w.base_offset for w in model if w.last_offset >= start], f"step {step}"
                obs.append(("read", seen(got)))
            elif op == "read_seq" and model and dirty() >= start:
                lo = cur = int(rng.integers(start, dirty() + 1))
                walk = []
                while True:
                    got = await log.read(cur, max_bytes=200)
                    if not got:
                        break
                    walk += got
                    cur = got[-1].last_offset + 1
                assert [g.payload for g in walk] == [
                    w.payload for w in model if w.last_offset >= lo], f"step {step}"
                obs.append(("read_seq", lo, seen(walk), mgr.readers_cache.stats(),
                            mgr.batch_cache.stats()))
            elif op == "truncate" and model:
                cut = int(rng.integers(start, dirty() + 2))
                await log.truncate(cut)
                model = [b for b in model if b.last_offset < cut]
                obs.append(("truncate", cut))
            elif op == "prefix" and model:
                cut = int(rng.integers(start, dirty() + 2))
                await log.prefix_truncate(cut)
                start = max(start, cut)
                obs.append(("prefix", cut))
            elif op == "reopen":
                await log.flush()
                await mgr.stop()
                mgr = manager()
                log = await mgr.manage(ntp(pk, "fuzzc"))
                assert log.offsets().dirty_offset == dirty(), f"step {step}"
                obs.append(("reopen", offsets(log)))
        assert mgr.readers_cache.hits > 0
        obs.append(mgr.readers_cache.stats())
    finally:
        await mgr.stop()


def _kv_view(batches) -> dict:
    out = {}
    for b in batches:
        for r in b.records():
            out[r.key] = r.value
    return out


async def s_compaction_last_value_wins(pk, d, obs):
    cfg = log_config(pk, base_dir=d, cleanup_policy="compact", max_segment_size=400)
    log = await pk.log.DiskLog.open(ntp(pk), cfg)
    try:
        for rnd in range(6):
            await log.append([conv(pk, ref_kv_batch(
                [(b"k%d" % i, b"v%d-%d" % (i, rnd)) for i in range(4)]))])
        dirty = log.offsets().dirty_offset
        before, after = await log.compact()
        got = await log.read(0, 1 << 30)
        assert after < before and log.offsets().dirty_offset == dirty
        assert _kv_view(got) == {b"k%d" % i: b"v%d-5" % i for i in range(4)}
        obs += [(before, after), offsets(log), segments(log), seen(got), log.compaction_backlog()]
    finally:
        await log.close()


async def s_compaction_preserves_offsets_across_restart(pk, d, obs):
    cfg = log_config(pk, base_dir=d, cleanup_policy="compact", max_segment_size=300)
    log = await pk.log.DiskLog.open(ntp(pk), cfg)
    for i in range(8):
        await log.append([conv(pk, ref_kv_batch([(b"k", b"v%d" % i)]))])
    dirty = log.offsets().dirty_offset
    obs.append(await log.compact())
    assert log.offsets().dirty_offset == dirty
    r = await log.append([conv(pk, ref_kv_batch([(b"k2", b"x")]))])
    assert r.base_offset == dirty + 1
    await log.close()
    log2 = await pk.log.DiskLog.open(ntp(pk), cfg)
    try:
        got = await log2.read(0, 1 << 30)
        assert _kv_view(got) == {b"k": b"v7", b"k2": b"x"}
        obs += [offsets(log2), segments(log2), seen(got)]
    finally:
        await log2.close()


async def s_compaction_tombstones(pk, d, obs):
    cfg = log_config(pk, base_dir=d, cleanup_policy="compact", max_segment_size=1)
    log = await pk.log.DiskLog.open(ntp(pk), cfg)
    try:
        now_ms = 1_700_000_000_000
        await log.append([conv(pk, ref_kv_batch([(b"a", b"1"), (b"b", b"2")], ts=now_ms))])
        await log.append([conv(pk, ref_kv_batch([(b"a", None)], ts=now_ms + 1))])
        await log.append([conv(pk, ref_kv_batch([(b"c", b"3")], ts=now_ms + 2))])
        cfg.delete_retention_ms = 10**15
        obs.append(await log.compact())
        got = await log.read(0, 1 << 30)
        assert _kv_view(got) == {b"a": None, b"b": b"2", b"c": b"3"}
        obs += [seen(got), segments(log)]
        # the cutoff lands between the tombstone and the batch after it
        cfg.delete_retention_ms = int(FIXED_NOW_S * 1000) - (now_ms + 2)
        log._compacted_through = None
        obs.append(await log.compact())
        got = await log.read(0, 1 << 30)
        assert _kv_view(got) == {b"b": b"2", b"c": b"3"}
        obs += [seen(got), segments(log)]
    finally:
        await log.close()


async def s_compaction_key_index_spills(pk, d, obs):
    cfg = log_config(pk, base_dir=d, cleanup_policy="compact", max_segment_size=4096)
    log = await pk.log.DiskLog.open(ntp(pk), cfg)
    try:
        for chunk in range(10):
            await log.append([conv(pk, ref_kv_batch(
                [(b"key-%04d" % (chunk * 50 + i), b"v") for i in range(50)]))])
        spilled = pk.compaction.build_key_index(log.segments, max_keys_in_memory=64)
        in_memory = pk.compaction.build_key_index(log.segments)
        assert len(spilled) == 500 and spilled == in_memory
        assert spilled[b"key-0000"] == 0 and spilled[b"key-0499"] == 499
        obs.append(sorted(spilled.items()))
    finally:
        await log.close()


async def s_compaction_keeps_non_data_batches(pk, d, obs):
    cfg = log_config(pk, base_dir=d, cleanup_policy="compact", max_segment_size=1)
    log = await pk.log.DiskLog.open(ntp(pk), cfg)
    try:
        await log.append([conv(pk, ref_kv_batch([(b"k", b"old")]))])
        await log.append([conv(pk, ref_batch(1, type=pk.record.RecordBatchType.raft_configuration))])
        await log.append([conv(pk, ref_kv_batch([(b"k", b"new")]))])
        await log.append([conv(pk, ref_kv_batch([(b"z", b"tail")]))])
        obs.append(await log.compact())
        got = await log.read(0, 1 << 30)
        assert pk.record.RecordBatchType.raft_configuration in [b.header.type for b in got]
        obs += [seen(got), segments(log)]
    finally:
        await log.close()


async def s_storage_failure_probes(pk, d, obs):
    badger, triggered = pk.finjector.honey_badger, pk.finjector.ProbeTriggered
    assert {"log_append", "log_roll", "log_truncate"} <= set(badger.modules().get("storage", []))
    log = await pk.log.DiskLog.open(ntp(pk, "probe"), log_config(pk, base_dir=d))
    badger.enable()
    try:
        for probe, op in (("log_append", lambda: log.append([conv(pk, ref_batch(1))])),
                          ("log_truncate", lambda: log.truncate(0))):
            badger.set_exception("storage", probe)
            with pytest.raises(triggered) as e:
                await op()
            obs.append(error(e.value, d))
            badger.unset("storage", probe)
            await op()  # service restored
            obs.append(offsets(log))
        badger.set_exception("storage", "log_roll", count=1)
        log.config.max_segment_size = 1
        await log.append([conv(pk, ref_batch(1))])  # into the empty log's new segment: no roll
        with pytest.raises(triggered):
            await log.append([conv(pk, ref_batch(1))])
        await log.append([conv(pk, ref_batch(1))])  # the probe fired once: this one rolls
        obs += [offsets(log), segments(log)]
    finally:
        badger.disable()
        await log.close()


async def s_storage_delay_probe_actually_delays(pk, d, obs):
    badger = pk.finjector.honey_badger
    log = await pk.log.DiskLog.open(ntp(pk, "dly"), log_config(pk, base_dir=d))
    badger.enable()
    try:
        badger.delay_ms = 120
        badger.set_delay("storage", "log_append")
        t0 = time.perf_counter()
        r = await log.append([conv(pk, ref_batch(1))])
        obs += [time.perf_counter() - t0 >= 0.1, r.base_offset]
        assert obs[0], "delay probe did not delay"
    finally:
        badger.disable()
        await log.close()


def s_kvstore_opfuzz_vs_model(pk, d, obs):
    rng = np.random.default_rng(31337)
    kvs, path = pk.storage, os.path.join(d, "kvf")
    KS = kvs.KeySpace
    kv = kvs.KvStore(path).start()
    model: dict = {}
    keys = [b"k%03d" % i for i in range(40)]
    try:
        for step in range(300):
            op = rng.choice(["put", "delete", "snapshot", "reopen"], p=[0.6, 0.2, 0.1, 0.1])
            if op == "put":
                k = keys[int(rng.integers(len(keys)))]
                v = rng.bytes(int(rng.integers(1, 64)))
                kv.put(KS.storage, k, v)
                model[k] = v
            elif op == "delete" and model:
                k = list(model)[int(rng.integers(len(model)))]
                kv.remove(KS.storage, k)
                del model[k]
            elif op == "snapshot":
                kv._do_snapshot()
                obs.append(("snapshot", tree(path)))
            elif op == "reopen":
                if rng.random() < 0.5:
                    kv._wal.close()  # a crash: the WAL is replayed
                    kv._wal = None
                else:
                    kv.stop()
                obs.append(("reopen", step, tree(path)))
                kv = kvs.KvStore(path).start()
                for k in keys:
                    assert kv.get(KS.storage, k) == model.get(k), (step, k)
        kv.stop()
        kv = kvs.KvStore(path).start()
        obs.append([kv.get(KS.storage, k) for k in keys])
        assert obs[-1] == [model.get(k) for k in keys]
    finally:
        kv.stop()


STORAGE = {name[2:]: fn for name, fn in dict(globals()).items() if name.startswith("s_")}


@pytest.mark.parametrize("name", sorted(STORAGE))
def test_storage_suite_matches_jax(name, tmp_path):
    """Each test of tests/test_storage.py through both packages: the same
    answers and byte-identical files."""
    run_both(STORAGE[name], tmp_path)


# ------------------------------------------------------------ tests/test_file_sanitizer.py
def f_write_after_close_raises(pk, d, obs):
    fs = pk.sanitizer
    fs.enable()
    f = fs.maybe_wrap(open(os.path.join(d, "x"), "wb"), "x")
    f.write(b"ok")
    f.close()
    with pytest.raises(fs.FileSanitizerError, match="write on closed") as e:
        f.write(b"boom")
    obs.append(error(e.value, d))
    for op in ("flush", "fileno", "tell"):
        with pytest.raises(fs.FileSanitizerError) as e:
            getattr(f, op)()
        obs.append(error(e.value, d))


def f_double_close_raises(pk, d, obs):
    fs = pk.sanitizer
    fs.enable()
    f = fs.maybe_wrap(open(os.path.join(d, "x"), "wb"), "x")
    f.close()
    with pytest.raises(fs.FileSanitizerError, match="double close") as e:
        f.close()
    obs.append(error(e.value, d))


def f_leak_detection(pk, d, obs):
    fs = pk.sanitizer
    fs.enable()
    f = fs.maybe_wrap(open(os.path.join(d, "leaky"), "wb"), "leaky")
    obs += [fs.verify_all_closed(), fs.verify_all_closed()]
    assert obs == [["leaky"], []]
    f.close()


def f_scoped_leak_check_spares_other_instances(pk, d, obs):
    fs = pk.sanitizer
    fs.enable()
    a = fs.maybe_wrap(open(os.path.join(d, "a.wal"), "wb"), os.path.join(d, "a.wal"))
    other = os.path.join(d, "other")
    os.mkdir(other)
    b = fs.maybe_wrap(open(os.path.join(other, "b.wal"), "wb"), os.path.join(other, "b.wal"))
    obs.append([p.replace(d, "<dir>") for p in fs.verify_all_closed(prefix=other)])
    a.write(b"still live")
    a.close()
    b.close()
    obs.append(fs.verify_all_closed())
    assert obs == [["<dir>/other/b.wal"], []]


def f_disarmed_is_passthrough(pk, d, obs):
    fs = pk.sanitizer
    assert not fs.enabled()
    f = fs.maybe_wrap(open(os.path.join(d, "x"), "wb"), "x")
    obs.append(isinstance(f, fs.SanitizedFile))
    f.write(b"raw")
    f.close()
    obs.append(fs.verify_all_closed())


async def f_truncate_keeps_sanitizer_coverage(pk, d, obs):
    cfg = log_config(pk, base_dir=d, sanitize_files=True)
    log = await pk.log.DiskLog.open(ntp(pk, "tr"), cfg)
    for i in range(4):
        await log.append([conv(pk, sanitizer_batch(i))], assign_offsets=False)
    await log.truncate(2)
    obs.append(isinstance(log.segments[-1]._file, pk.sanitizer.SanitizedFile))
    await log.append([conv(pk, sanitizer_batch(2))], assign_offsets=False)
    obs += [offsets(log), seen(await log.read(0))]
    await log.close()
    obs.append(pk.sanitizer.verify_all_closed())
    assert obs[0] and obs[-1] == []


async def f_sanitized_log_lifecycle_is_clean(pk, d, obs):
    cfg = log_config(pk, base_dir=d, sanitize_files=True, max_segment_size=256)
    log = await pk.log.DiskLog.open(ntp(pk, "san"), cfg)
    for i in range(12):
        await log.append([conv(pk, sanitizer_batch(i))], assign_offsets=False)
    got = await log.read(0, 1 << 20)
    assert len(got) == 12
    obs += [seen(got), segments(log)]
    await log.close()
    obs.append(pk.sanitizer.verify_all_closed())
    assert obs[-1] == []


SANITIZER = {name[2:]: fn for name, fn in dict(globals()).items() if name.startswith("f_")}


@pytest.mark.parametrize("name", sorted(SANITIZER))
def test_file_sanitizer_suite_matches_jax(name, tmp_path):
    """Each test of tests/test_file_sanitizer.py through both packages: the
    same errors at the same misuse sites and the same leak reports."""
    run_both(SANITIZER[name], tmp_path)


# ------------------------------------------------------------ state across packages
def _tear(log_dir: str) -> None:
    """Cut the tail segment's last frame in half and flip a payload byte of
    the frame before it."""
    logs = sorted((f for f in os.listdir(log_dir) if f.endswith(".log")),
                  key=lambda f: int(f.split("-")[0]))
    path = os.path.join(log_dir, logs[-1])
    with open(path, "rb") as f:
        blob = f.read()
    at, frames = 0, []
    while at < len(blob):
        size = int.from_bytes(blob[at + 4:at + 8], "little")
        frames.append((at, size))
        at += size
    (last, last_size), (prev, _) = frames[-1], frames[-2]
    torn = bytearray(blob[: last + last_size // 2])
    torn[prev + 61 + 5] ^= 0x10
    with open(path, "wb") as f:
        f.write(torn)


async def _write_log(pk, d: str, ntp_) -> None:
    log = await pk.log.DiskLog.open(ntp_, log_config(pk, base_dir=d, max_segment_size=600))
    for i in range(12):
        await log.append([conv(pk, ref_batch(1 + i % 3, value_size=40 + i))], term=1 + i // 5)
    await log.close()


async def _reopen(pk, d: str, ntp_, device: bool) -> list:
    log = await pk.log.DiskLog.open(ntp_, log_config(
        pk, base_dir=d, max_segment_size=600, use_device_recovery=device))
    try:
        out = [offsets(log), segments(log), log.term, seen(await log.read(0, 1 << 30))]
        r = await log.append([conv(pk, ref_batch(2))])
        return out + [(r.base_offset, r.last_offset), seen(await log.read(r.base_offset))]
    finally:
        await log.close()


@pytest.mark.parametrize("device", [False, True], ids=["host", "device"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_log_directory_crosses_packages(writer, reader, device, tmp_path):
    """A log written by one package, its tail torn, opens in the other: the
    reader recovers to the cut the writer's own reopen makes, reads the same
    batches and appends at the same offset, leaving the same files."""
    src, w, r = tmp_path / "src", PKGS[writer], PKGS[reader]
    asyncio.run(_write_log(w, str(src), ntp(w)))
    _tear(os.path.join(src, "kafka", "t-log", "0"))
    shutil.copytree(src, tmp_path / "w")
    shutil.copytree(src, tmp_path / "r")
    want = asyncio.run(_reopen(w, str(tmp_path / "w"), ntp(w), device))
    got = asyncio.run(_reopen(r, str(tmp_path / "r"), ntp(r), device))
    assert got == want
    assert want[0][1] < 23 and len(want[1]) > 1  # the tail was cut; segments rolled
    assert tree(tmp_path / "r") == tree(tmp_path / "w")


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_kvstore_directory_crosses_packages(writer, reader, tmp_path):
    """A kvstore written by one package (a snapshot, then WAL records, the
    last one torn by a crash) opens in the other with the same contents, and
    the reader's stop writes the snapshot the writer's own would."""
    w, r = PKGS[writer], PKGS[reader]
    src = str(tmp_path / "src")
    kv = w.storage.KvStore(src).start()
    for i in range(20):
        kv.put(w.storage.KeySpace.coproc, b"k%02d" % (i % 7), b"v%d" % i)
    kv._do_snapshot()
    for i in range(5):
        kv.put(w.storage.KeySpace.storage, b"s%d" % i, bytes(range(i * 9)))
    kv.remove(w.storage.KeySpace.coproc, b"k03")
    kv._wal.close()
    wal = os.path.join(src, "kvstore.wal")
    with open(wal, "r+b") as f:
        f.truncate(os.path.getsize(wal) - 2)
    answers = {}
    for name, pk in (("w", w), ("r", r)):
        path = str(tmp_path / name)
        shutil.copytree(src, path)
        kv = pk.storage.KvStore(path).start()
        KS = pk.storage.KeySpace
        answers[name] = [(k, kv.get(KS.coproc, k)) for k in sorted(kv.keys(KS.coproc))] + [
            (k, kv.get(KS.storage, k)) for k in sorted(kv.keys(KS.storage))]
        kv.stop()
    assert answers["r"] == answers["w"]
    # the torn record is the last one, k03's removal: k03 stays
    assert (b"k03", b"v17") in answers["w"] and len(answers["w"]) == 12
    assert tree(tmp_path / "r") == tree(tmp_path / "w")


def _recovery_blob(case: str) -> bytes:
    """tests/test_storage.py's recovery scan input: six 2-record frames."""
    blob = b"".join(ref_batch(2, value_size=24).with_base_offset(2 * i).encode_internal()
                    for i in range(6))
    frame = len(blob) // 6
    cut = bytearray(blob)
    if case == "corrupt":
        cut[3 * frame + 70] ^= 0xFF  # a payload byte of the 4th frame
    elif case == "header":
        cut[2 * frame + 9] ^= 0x01  # a header byte of the 3rd frame
    elif case == "torn":
        cut = cut[: 5 * frame - 17]
    elif case == "empty":
        cut = cut[:40]
    return bytes(cut)


@pytest.mark.parametrize("case", ["clean", "corrupt", "header", "torn", "empty"])
def test_recover_segment_on_the_card_path_matches_jax(case, tmp_path, monkeypatch):
    """recover_segment(use_device=True, device="cpu") runs K5's plain version
    (one call a segment with a frame to check) and cuts the segment file
    where the JAX package's host and device scans cut it."""
    from redpanda_tpu_torch.ops import crc32c_device

    blob = _recovery_blob(case)
    calls = []
    real = crc32c_device.crc32c_rows

    def spy(data, lengths):
        calls.append(data.device.type)
        return real(data, lengths)

    monkeypatch.setattr(crc32c_device, "crc32c_rows", spy)
    jax_rec = PKGS["jax"].recovery
    cut = jax_rec.scan_valid_prefix_host(blob)
    assert jax_rec.scan_valid_prefix_device(blob) == cut
    got = {}
    for name, pk, kw in (("jax", PKGS["jax"], {}), ("port", PKGS["port"], {"device": "cpu"})):
        d = tmp_path / name
        d.mkdir()
        with open(d / "0-1-v1.log", "wb") as f:
            f.write(blob)
        seg = pk.segment.Segment(str(d), 0, 1).open_existing(writable=False)
        pk.recovery.recover_segment(seg, use_device=True, **kw)
        seg.index.persist(seg.dirty_offset, seg.max_timestamp)
        got[name] = (seg.size_bytes, seg.dirty_offset, seg.max_timestamp,
                     [(e.rel_offset, e.file_pos, e.timestamp) for e in seg.index.entries])
    assert got["port"] == got["jax"]
    assert got["port"][:2] == (cut[0], cut[1] if cut[1] >= 0 else -1)
    assert tree(tmp_path / "port") == tree(tmp_path / "jax")
    assert calls == ([] if case == "empty" else ["cpu"])


def test_device_recovery_without_a_card_raises_and_scans_nothing(tmp_path, monkeypatch):
    """LogConfig(use_device_recovery=True) on a machine without CUDA: the
    card is the default device, so DiskLog.open raises; the torn tail is
    neither scanned on the host nor cut."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the device scan runs on it")
    pk = PKGS["port"]
    asyncio.run(_write_log(pk, str(tmp_path), ntp(pk)))
    log_dir = os.path.join(tmp_path, "kafka", "t-log", "0")
    _tear(log_dir)
    before = tree(log_dir)

    def host_scan(blob):
        raise AssertionError("the host scan ran in the device scan's place")

    monkeypatch.setattr(pk.recovery, "scan_valid_prefix_host", host_scan)
    cfg = pk.log.LogConfig(base_dir=str(tmp_path), max_segment_size=600,
                           use_device_recovery=True)
    assert cfg.recovery_device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(pk.log.DiskLog.open(ntp(pk), cfg))
    mgr = pk.storage.LogManager(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        asyncio.run(mgr.manage(ntp(pk)))
    assert tree(log_dir) == before


def test_partition_restart_recovers_each_tail_once_on_the_device_path(tmp_path, monkeypatch):
    """The restart chip_smoke.py's phase 7b drives, at a small size: a
    manager over several partitions, every tail torn, one with a corrupt
    frame, reopened with device recovery (K5's plain version, one call a
    partition) and with host recovery in the port and in the JAX package:
    the same offsets, files and reads, and one more append a partition
    lands at the recovered dirty offset + 1."""
    from redpanda_tpu_torch.ops import crc32c_device

    parts = 4
    batches = [ref_batch(4, value_size=100, ts=1000 + i) for i in range(24)]

    async def fill(pk, d):
        mgr = pk.storage.LogManager(log_config(pk, base_dir=d))
        for p in range(parts):
            log = await mgr.manage(ntp(pk, "restart", p))
            await log.append([conv(pk, b) for b in batches[: 20 + p]])
        await mgr.stop()

    async def reopen(pk, d, device):
        mgr = pk.storage.LogManager(log_config(pk, base_dir=d, use_device_recovery=device))
        try:
            out = []
            for p in range(parts):
                log = await mgr.manage(ntp(pk, "restart", p))
                o = offsets(log)
                got = await log.read(max(0, o[1] - 31), 1 << 30)
                assert all(b.verify_kafka_crc() for b in got)
                r = await log.append([conv(pk, batches[0])])
                assert r.base_offset == o[1] + 1
                out.append((o, segments(log), seen(got), r.base_offset))
            return out
        finally:
            await mgr.stop()

    src = str(tmp_path / "src")
    asyncio.run(fill(PKGS["port"], src))
    for p in range(parts):
        _tear(os.path.join(src, "kafka", "restart", str(p)))
    calls = []
    real = crc32c_device.crc32c_rows
    monkeypatch.setattr(crc32c_device, "crc32c_rows",
                        lambda d, ln: calls.append(d.shape) or real(d, ln))
    got = {}
    for name, pk, device in (("dev", PKGS["port"], True), ("host", PKGS["port"], False),
                             ("jax", PKGS["jax"], False)):
        shutil.copytree(src, tmp_path / name)
        got[name] = asyncio.run(reopen(pk, str(tmp_path / name), device))
    assert len(calls) == parts
    assert got["dev"] == got["host"] == got["jax"]
    assert [o[1] for o, *_ in got["dev"]] == [4 * (18 + p) - 1 for p in range(parts)]
    assert tree(tmp_path / "dev") == tree(tmp_path / "host") == tree(tmp_path / "jax")


def samples(hist) -> int:
    n = hist.hist.count
    return n() if callable(n) else n


def test_append_budget_histogram_and_span_match_jax(tmp_path):
    """The log's ties to the rest of the port, as in the JAX package: the
    storage account of the installed budget plane holds an append's bytes
    only while it runs, each append records one storage_append_latency_us
    sample, and a traced append opens a storage.append span."""
    got = {}
    for name, pk in PKGS.items():
        plane = pk.budgets.BudgetPlane(1 << 20)
        pk.budgets.install(plane)
        tracer = pk.trace.tracer
        was = tracer.enabled
        tracer.configure(enabled=True)
        hist = pk.probes.storage_append_hist
        n0 = samples(hist)

        async def body():
            log = await pk.log.DiskLog.open(ntp(pk), log_config(pk, base_dir=str(tmp_path / name)))
            try:
                with tracer.span("test.produce", root=True) as span:
                    r = await log.append([conv(pk, ref_batch(3)), conv(pk, ref_batch(2))])
                await log.append([conv(pk, ref_batch(1))])
                names = [s["name"] for s in tracer.spans_for(span.trace_id)]
                return r, names
            finally:
                await log.close()

        try:
            r, names = asyncio.run(body())
        finally:
            tracer.configure(enabled=was)
            pk.budgets.install(None)
        n1 = samples(hist)
        acct = plane.account("storage").snapshot()
        got[name] = (r.byte_size, acct["peak_bytes"], acct["held_bytes"], n1 - n0,
                     "storage.append" in names)
    assert got["port"] == got["jax"]
    assert got["port"][1] == got["port"][0] and got["port"][2:] == (0, 2, True)


def test_mem_log_matches_jax():
    """MemLog, the in-memory backend, answers as the JAX package's."""

    async def body(pk):
        log = pk.storage.MemLog(ntp(pk), start_offset=3)
        out = [offsets(log)]
        for i in range(6):
            r = await log.append([conv(pk, ref_batch(2, ts=100 * i))], term=i // 2)
            out.append((r.base_offset, r.last_offset, r.byte_size, log.term))
        out += [seen(await log.read(6)), seen(await log.read(0, max_offset=8)),
                seen(await log.read(0, max_bytes=1)), await log.timequery(250),
                await log.timequery(10**6)]
        follower = conv(pk, ref_batch(1).with_base_offset(15))
        follower.header.term = 9
        await log.append([follower], assign_offsets=False)
        out.append(log.term)
        await log.truncate(10)
        await log.prefix_truncate(6)
        out += [offsets(log), seen(await log.read(0))]
        await log.remove()
        return out + [offsets(log)]

    assert asyncio.run(body(PKGS["port"])) == asyncio.run(body(PKGS["jax"]))


def test_reader_and_iobuf_match_jax():
    """models/reader.py and utils/iobuf.py, exported as the JAX package
    exports them, answer as its copies do."""

    async def body(pk):
        batches = [conv(pk, ref_batch(i + 1)) for i in range(4)]
        out = [seen(await pk.models.make_memory_reader(batches).collect())]
        taken = []

        async def consumer(b):
            taken.append(b.base_offset)
            return len(taken) < 2

        await pk.models.make_memory_reader(batches).consume(consumer)

        async def agen():
            for b in batches[::-1]:
                yield b

        out += [taken, seen([b async for b in pk.models.make_generator_reader(agen())])]
        buf = pk.iobuf.IOBuf(b"hello ").append(bytearray(b"port")).prepend(b">> ")
        buf.append(pk.iobuf.IOBuf(memoryview(b"!!")))
        out += [len(buf), bytes(buf), buf.linearize(), bytes(buf.share(2, 9)),
                len(buf.fragments()), buf == bytes(buf), repr(buf)]
        with pytest.raises(IndexError):
            buf.share(5, 100)
        return out

    assert asyncio.run(body(PKGS["port"])) == asyncio.run(body(PKGS["jax"]))
    from redpanda_tpu_torch import models, utils
    from redpanda_tpu import models as jax_models, utils as jax_utils

    assert [n for n in jax_models.__all__ if n not in models.__all__] == []
    assert [n for n in jax_utils.__all__ if n not in utils.__all__] == []
