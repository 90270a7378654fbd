"""The port's batch cache, readers cache and backlog controller
(redpanda_tpu_torch/storage/) against the JAX package's, on the CPU.

Every test of tests/test_batch_cache.py, tests/test_readers_cache.py and
tests/test_backlog_controller.py has a counterpart here: the same op
sequence, on the reference suites' own batches (built once by the JAX
package and handed to both packages as their encoded bytes), runs through
each package in a directory of its own. The caches' answers and stats, the
controller's intervals, the reads and every file left on disk must be
equal; there is no tolerance.
"""

from __future__ import annotations

import asyncio

import pytest

from test_backlog_controller import _kb
from test_batch_cache import _batch as cache_batch
from test_readers_cache import _batch as cursor_batch
from test_torch_storage import (  # noqa: F401  (the autouse fixture resets both packages)
    PKGS,
    _globals,
    conv,
    error,
    log_config,
    ntp,
    offsets,
    run_both,
    seen,
    segments,
)


# ------------------------------------------------------------ tests/test_batch_cache.py
def c_get_covering_offset(pk, d, obs):
    c = pk.batch_cache.BatchCache(1 << 20)
    c.put(1, conv(pk, cache_batch(0, 4)))
    c.put(1, conv(pk, cache_batch(4, 4)))
    for key, off in ((1, 0), (1, 3), (1, 4), (1, 7), (1, 8), (2, 0), (1, -1)):
        b = c.get(key, off)
        obs.append(None if b is None else b.header.base_offset)
    obs.append(c.stats())
    assert obs[:3] == [0, 0, 4] and obs[-1]["hits"] == 4


def c_lru_eviction_respects_budget(pk, d, obs):
    one = cache_batch(0).size_bytes
    c = pk.batch_cache.BatchCache(one * 3 + 1)
    for base in range(0, 16, 4):
        c.put(7, conv(pk, cache_batch(base)))
    obs += [c.bytes_used, c.get(7, 0) is None, c.get(7, 12) is not None]
    c.get(7, 4)  # touched: spared by the next eviction
    c.put(7, conv(pk, cache_batch(16)))
    obs += [c.get(7, 4) is not None, c.get(7, 8) is None, c.stats()]
    c.put(7, conv(pk, cache_batch(20, n=40, pad=200)))  # wider than the budget: not cached
    obs.append(c.stats())
    assert obs[0] <= c.max_bytes and obs[1:5] == [True, True, True, True]


def c_invalidate_suffix_and_prefix(pk, d, obs):
    c = pk.batch_cache.BatchCache(1 << 20)
    for base in range(0, 16, 4):
        c.put(1, conv(pk, cache_batch(base)))
    c.invalidate(1, from_offset=9)
    obs.append([c.get(1, o) is None for o in (0, 4, 8, 12)])
    c.invalidate(1, below_offset=4)
    obs.append([c.get(1, o) is None for o in (0, 4)])
    c.invalidate(1)
    obs += [c.get(1, 4) is None, c.bytes_used, c.stats()]
    assert obs[0] == [False, False, True, True] and obs[1] == [True, False]


async def c_fetch_hits_after_produce_and_after_disk_read(pk, d, obs):
    mgr = pk.storage.LogManager(log_config(pk, base_dir=d))
    mgr2 = pk.storage.LogManager(log_config(pk, base_dir=d))
    try:
        log = await mgr.manage(ntp(pk, "c"))
        for b in (0, 4, 8):
            await log.append([conv(pk, cache_batch(b))], assign_offsets=False)
        h0 = mgr.batch_cache.hits
        got = await log.read(0, 1 << 20)
        assert mgr.batch_cache.hits > h0
        obs += [seen(got), mgr.batch_cache.stats()]
        await log.flush()
        log2 = await mgr2.manage(ntp(pk, "c"))
        disk = await log2.read(0, 1 << 20)
        m = mgr2.batch_cache.misses
        cached = await log2.read(0, 1 << 20)
        assert mgr2.batch_cache.misses == m and seen(cached) == seen(disk)
        obs += [seen(disk), mgr2.batch_cache.stats()]
    finally:
        await mgr.stop()
        await mgr2.stop()


async def c_truncate_invalidates(pk, d, obs):
    mgr = pk.storage.LogManager(log_config(pk, base_dir=d))
    try:
        log = await mgr.manage(ntp(pk, "t"))
        for b in (0, 4, 8):
            await log.append([conv(pk, cache_batch(b))], assign_offsets=False)
        await log.read(0, 1 << 20)
        await log.truncate(6)
        got = await log.read(0, 1 << 20)
        assert [b.header.base_offset for b in got] == [0]
        obs += [seen(got), offsets(log), mgr.batch_cache.stats()]
    finally:
        await mgr.stop()


async def c_partial_cache_falls_back_to_disk(pk, d, obs):
    mgr = pk.storage.LogManager(log_config(pk, base_dir=d))
    try:
        log = await mgr.manage(ntp(pk, "p"))
        for b in (0, 4, 8):
            await log.append([conv(pk, cache_batch(b))], assign_offsets=False)
        mgr.batch_cache.invalidate(id(log), from_offset=4)
        mgr.batch_cache.invalidate(id(log), below_offset=0)
        got = await log.read(0, 1 << 20)
        assert [b.header.base_offset for b in got] == [0, 4, 8]
        obs += [seen(got), mgr.batch_cache.stats()]
    finally:
        await mgr.stop()


async def c_mid_batch_start_not_shortened(pk, d, obs):
    mgr = pk.storage.LogManager(log_config(pk, base_dir=d))
    try:
        log = await mgr.manage(ntp(pk, "m"))
        for b in (0, 4):
            await log.append([conv(pk, cache_batch(b))], assign_offsets=False)
        got = await log.read(2, 1 << 20)
        assert [b.header.base_offset for b in got][-1] == 4
        obs += [seen(got), mgr.batch_cache.stats()]
    finally:
        await mgr.stop()


async def c_max_offset_respected_from_cache(pk, d, obs):
    mgr = pk.storage.LogManager(log_config(pk, base_dir=d))
    try:
        log = await mgr.manage(ntp(pk, "x"))
        for b in (0, 4, 8):
            await log.append([conv(pk, cache_batch(b))], assign_offsets=False)
        got = await log.read(0, 1 << 20, max_offset=5)
        assert [b.header.base_offset for b in got] == [0, 4]
        obs += [seen(got), mgr.batch_cache.stats()]
    finally:
        await mgr.stop()


def c_stats_exposed(pk, d, obs):
    mgr = pk.storage.LogManager(log_config(pk, base_dir=d), batch_cache_bytes=12345)
    obs += [mgr.batch_cache.stats(), mgr.readers_cache.stats()]
    assert set(obs[0]) >= {"hits", "misses", "bytes_used", "max_bytes", "batches"}


BATCH_CACHE = {n[2:]: fn for n, fn in dict(globals()).items() if n.startswith("c_")}


@pytest.mark.parametrize("name", sorted(BATCH_CACHE))
def test_batch_cache_suite_matches_jax(name, tmp_path):
    """Each test of tests/test_batch_cache.py through both packages."""
    run_both(BATCH_CACHE[name], tmp_path)


# ------------------------------------------------------------ tests/test_readers_cache.py
def r_lru_and_stats(pk, d, obs):
    rc = pk.readers_cache
    c = rc.ReadersCache(max_entries=2)
    c.put(1, 10, rc.ReadCursor(0, 100))
    c.put(1, 20, rc.ReadCursor(0, 200))
    obs.append(c.get(1, 10))
    c.put(1, 30, rc.ReadCursor(0, 300))
    obs += [c.get(1, 20), c.get(1, 10), c.get(1, 30), c.stats()]
    obs[:] = [(o.segment_base, o.file_pos) if isinstance(o, rc.ReadCursor) else o for o in obs]
    assert obs[0] == (0, 100) and obs[1] is None and obs[-1]["entries"] == 2


def r_invalidate_ranges(pk, d, obs):
    rc = pk.readers_cache
    c = rc.ReadersCache()
    for off in (5, 10, 15):
        c.put(1, off, rc.ReadCursor(0, off * 10))
        c.put(2, off, rc.ReadCursor(0, off * 10))
    c.invalidate(1, from_offset=10)
    obs.append([c.get(1, o) is None for o in (5, 10, 15)])
    c.invalidate(2, below_offset=10)
    obs.append([c.get(2, o) is None for o in (5, 10)])
    c.invalidate(2)
    obs += [[c.get(2, o) is None for o in (10, 15)], c.stats()]
    assert obs[:3] == [[False, True, True], [True, False], [True, True]]


def _cursor_mgr(pk, d):
    # no batch cache: every read reaches the segment scan and its cursor
    return pk.storage.LogManager(log_config(pk, base_dir=d), batch_cache_bytes=0)


async def _cold_read(pk, d, name, start):
    m = _cursor_mgr(pk, d)
    try:
        return seen(await (await m.manage(ntp(pk, name))).read(start, 1 << 20))
    finally:
        await m.stop()


async def r_sequential_reads_hit_cursor(pk, d, obs):
    mgr = _cursor_mgr(pk, d)
    try:
        log = await mgr.manage(ntp(pk, "seq"))
        for base in range(0, 40, 4):
            await log.append([conv(pk, cursor_batch(base))], assign_offsets=False)
        one = cursor_batch(0).size_bytes
        chunks, start = [], 0
        while True:
            got = await log.read(start, one * 2)
            if not got:
                break
            chunks += got
            start = got[-1].last_offset + 1
        assert mgr.readers_cache.hits >= 4
        obs += [seen(chunks), mgr.readers_cache.stats()]
    finally:
        await mgr.stop()
    assert obs[0] == await _cold_read(pk, d, "seq", 0)


async def r_tail_cursor_survives_append(pk, d, obs):
    mgr = _cursor_mgr(pk, d)
    try:
        log = await mgr.manage(ntp(pk, "tail"))
        await log.append([conv(pk, cursor_batch(0))], assign_offsets=False)
        await log.read(0, 1 << 20)
        await log.append([conv(pk, cursor_batch(4))], assign_offsets=False)
        h0 = mgr.readers_cache.hits
        got = await log.read(4, 1 << 20)
        assert mgr.readers_cache.hits == h0 + 1
        obs += [seen(got), mgr.readers_cache.stats()]
    finally:
        await mgr.stop()
    assert obs[0] == await _cold_read(pk, d, "tail", 4)


async def r_truncate_drops_cursor(pk, d, obs):
    mgr = _cursor_mgr(pk, d)
    try:
        log = await mgr.manage(ntp(pk, "trunc"))
        for base in (0, 4, 8):
            await log.append([conv(pk, cursor_batch(base))], assign_offsets=False)
        await log.read(0, 1 << 20)
        await log.truncate(4)
        await log.append([conv(pk, cursor_batch(4, n=4, pad=8))], assign_offsets=False)
        got = await log.read(4, 1 << 20)
        assert got[0].payload == cursor_batch(4, n=4, pad=8).payload
        obs += [seen(got), mgr.readers_cache.get(id(log), 12) is None, mgr.readers_cache.stats()]
        assert obs[1]
    finally:
        await mgr.stop()


async def r_compaction_drops_cursor(pk, d, obs):
    mgr = _cursor_mgr(pk, d)
    try:
        cfg = log_config(pk, base_dir=d, cleanup_policy="compact", max_segment_size=1024)
        log = await mgr.manage(ntp(pk, "comp"), overrides=cfg)
        rec = PKGS["jax"].record
        for base in range(12):
            b = rec.RecordBatch.build([rec.Record(offset_delta=0, key=b"k%d" % (base % 2),
                                                  value=b"v%d" % base)], base_offset=base)
            await log.append([conv(pk, b)], assign_offsets=False)
        await log.read(0, 1 << 20)
        assert any(k[0] == id(log) for k in mgr.readers_cache._lru)
        obs.append(await log.compact())
        assert not any(k[0] == id(log) for k in mgr.readers_cache._lru)
        got = await log.read(0, 1 << 20)
        vals = {r.key: r.value for b in got for r in b.records()}
        assert vals[b"k0"] == b"v10" and vals[b"k1"] == b"v11"
        obs += [seen(got), segments(log)]
    finally:
        await mgr.stop()


async def r_corrupt_frame_size_raises_not_short_read(pk, d, obs):
    mgr = _cursor_mgr(pk, d)
    try:
        log = await mgr.manage(ntp(pk, "corrupt"))
        await log.append([conv(pk, cursor_batch(0)), conv(pk, cursor_batch(4))],
                         assign_offsets=False)
        await log.flush()
        with open(log.segments[-1].data_path, "r+b") as f:
            f.seek(cursor_batch(0).size_bytes + 4)
            f.write((0x40000000).to_bytes(4, "little"))
        with pytest.raises(pk.record.CorruptBatchError) as e:
            await log.read(0, 1 << 20)
        obs.append(error(e.value, d))
    finally:
        await mgr.stop()


async def r_trailing_filtered_frames_not_skipped_by_cursor(pk, d, obs):
    T = pk.record.RecordBatchType
    mgr = _cursor_mgr(pk, d)
    try:
        log = await mgr.manage(ntp(pk, "filt"))
        await log.append([conv(pk, cursor_batch(0))], assign_offsets=False)
        await log.append([conv(pk, cursor_batch(4, type=PKGS["jax"].record.RecordBatchType
                                                 .raft_configuration))], assign_offsets=False)
        got = await log.read(0, 1 << 20, type_filter={T.raft_data})
        got2 = await log.read(4, 1 << 20)
        assert [b.header.base_offset for b in got] == [0]
        assert got2[0].header.type == T.raft_configuration
        obs += [seen(got), seen(got2), mgr.readers_cache.stats()]
    finally:
        await mgr.stop()


READERS_CACHE = {n[2:]: fn for n, fn in dict(globals()).items() if n.startswith("r_")}


@pytest.mark.parametrize("name", sorted(READERS_CACHE))
def test_readers_cache_suite_matches_jax(name, tmp_path):
    """Each test of tests/test_readers_cache.py through both packages."""
    run_both(READERS_CACHE[name], tmp_path)


# ------------------------------------------------------------ tests/test_backlog_controller.py
def b_idle_below_setpoint_runs_lazy(pk, d, obs):
    c = pk.backlog.BacklogController(setpoint_bytes=1000, min_interval_s=0.1, max_interval_s=10)
    obs += [c.update(0), c.update(1000), c.last_backlog, c.last_interval]
    assert obs[:2] == [10, 10]


def b_interval_shrinks_monotonically_with_backlog(pk, d, obs):
    c = pk.backlog.BacklogController(setpoint_bytes=1000, min_interval_s=0.1, max_interval_s=10)
    obs.append([c.update(b) for b in (1001, 2000, 5000, 20000, 10**9)])
    assert obs[0] == sorted(obs[0], reverse=True) and obs[0][0] < 10
    assert obs[0][-1] == pytest.approx(0.1)


def b_pressure_relaxes_when_backlog_drains(pk, d, obs):
    c = pk.backlog.BacklogController(setpoint_bytes=1000, kp=3.5, min_interval_s=0.1,
                                     max_interval_s=10)
    obs += [c.update(50_000), c.update(0), c.update(1500)]
    assert obs[0] < 1 and obs[1] == 10


async def _compacted_log(pk, d, name, n=64):
    mgr = pk.storage.LogManager(log_config(pk, base_dir=d))
    cfg = log_config(pk, base_dir=d, cleanup_policy="compact", max_segment_size=2048)
    log = await mgr.manage(ntp(pk, name), overrides=cfg)
    for i in range(n):
        await log.append([conv(pk, _kb(i, b"k%d" % (i % 4)))], assign_offsets=False)
    return mgr, log


async def b_backlog_measured_and_compaction_drains_it(pk, d, obs):
    mgr, log = await _compacted_log(pk, d, "bl", n=0)
    try:
        obs.append(mgr.compaction_backlog())
        for i in range(64):
            await log.append([conv(pk, _kb(i, b"k%d" % (i % 4)))], assign_offsets=False)
        obs.append(mgr.compaction_backlog())
        obs.append(await log.compact())
        obs += [mgr.compaction_backlog(), segments(log)]
        assert obs[0] == 0 and obs[1] > 0 and obs[3] == 0
    finally:
        await mgr.stop()


async def b_trickle_appends_do_not_refill_backlog(pk, d, obs):
    mgr, log = await _compacted_log(pk, d, "trickle")
    try:
        obs.append(await log.compact())
        await log.append([conv(pk, _kb(64, b"k0"))], assign_offsets=False)
        obs.append(mgr.compaction_backlog())
        for i in range(65, 90):
            await log.append([conv(pk, _kb(i, b"k%d" % (i % 4)))], assign_offsets=False)
        closed = sum(s.size_bytes for s in log.segments if not s.writable)
        obs += [mgr.compaction_backlog(), closed, segments(log)]
        assert obs[1] == 0 and 0 < obs[2] < closed
    finally:
        await mgr.stop()


async def b_housekeeping_loop_compacts_under_pressure(pk, d, obs):
    mgr, log = await _compacted_log(pk, d, "hk")
    try:
        hist = pk.probes.storage_housekeeping_hist.hist
        n0 = hist.count() if callable(hist.count) else hist.count
        await mgr.start_housekeeping(interval_s=3600, compaction_interval_s=3600)
        ctl = mgr.backlog_controller
        obs.append((ctl.max_interval_s, ctl.min_interval_s))
        ctl.setpoint_bytes, ctl.max_interval_s, ctl.min_interval_s = 1024, 5.0, 0.05
        deadline = asyncio.get_running_loop().time() + 15
        while mgr.compaction_backlog() > 0:
            assert asyncio.get_running_loop().time() < deadline, "no compaction pass"
            await asyncio.sleep(0.05)
        n1 = hist.count() if callable(hist.count) else hist.count
        obs += [mgr.compaction_backlog(), segments(log), n1 > n0]
        assert obs[-1]
    finally:
        await mgr.stop()


BACKLOG = {n[2:]: fn for n, fn in dict(globals()).items() if n.startswith("b_")}


@pytest.mark.parametrize("name", sorted(BACKLOG))
def test_backlog_controller_suite_matches_jax(name, tmp_path):
    """Each test of tests/test_backlog_controller.py through both packages."""
    run_both(BACKLOG[name], tmp_path)
