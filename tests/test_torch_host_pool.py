"""The port's host-stage pool (coproc/host_pool.py and the engine's pool,
seal and pooled mesh lanes) against the JAX package.

Replies of the pool lane must be the reference engine's bytes on the same
seeded requests, with no tolerance: the reference suites' generators
(tests/test_harvest_gather.py, tests/test_structural_parse.py,
tests/test_meshrunner.py) make the batches. The reference engine runs
inline (``host_workers=0``): its own pool lane shares one zstd context
across threads and is no oracle. The shard gate is lowered, as the
reference suite lowers it, so that small launches fan out; one test runs at
the real gate.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest

from redpanda_tpu.coproc import host_pool as ref_host_pool
from redpanda_tpu.coproc.engine import ProcessBatchItem, ProcessBatchRequest, TpuEngine
from redpanda_tpu.models import NTP, Compression
from redpanda_tpu.ops.transforms import filter_contains, identity, map_uppercase
from redpanda_tpu_torch.coproc import batch_codec
from redpanda_tpu_torch.coproc import engine as engine_mod
from redpanda_tpu_torch.coproc import host_pool
from redpanda_tpu_torch.coproc.engine import TorchEngine
from redpanda_tpu_torch.parallel.mesh import partition_mesh
from test_harvest_gather import _json_batch, _matrix_request
from test_meshrunner import PROJ_SPEC as MESH_PROJ_SPEC
from test_meshrunner import _request as _mesh_request
from test_structural_parse import PASS_SPEC, PROJ_SPEC, _request
from test_torch_structural import _port_request, _ref_replies, _reply_bytes

ROW_STRIDE = 512
SPECS = {"proj": PROJ_SPEC, "pass": PASS_SPEC}
LADDERS = {"staged": dict(structural_parse=False), "structural": dict(structural_probe=False)}


def _codec_request(n_items=6, n_recs=40):
    """_matrix_request's shapes with every batch compressed, the codecs in
    turn."""
    codecs = [Compression.gzip, Compression.lz4, Compression.zstd]
    return ProcessBatchRequest([
        ProcessBatchItem(1, NTP.kafka("orders", p), [
            _json_batch(n_recs, base_offset=100 * p, codec=codecs[p % 3]),
            _json_batch(n_recs - 7, base_offset=100 * p + 50, codec=codecs[(p + 1) % 3],
                        empty_every=5, null_every=7),
        ])
        for p in range(n_items)
    ])


def _skewed_request():
    """One fat batch, then small and zero-record ones: two shards of very
    different sizes."""
    sizes = [600, 3, 0, 5, 4]
    return ProcessBatchRequest([ProcessBatchItem(1, NTP.kafka("orders", 0), [
        _json_batch(n, base_offset=1000 * k) for k, n in enumerate(sizes)])])


WORKLOADS = {
    "matrix": _matrix_request,  # empty, null and zero-record batches
    "compressed": _codec_request,
    "skewed": _skewed_request,
}


@pytest.fixture
def low_gate(monkeypatch):
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)


def _engine(**kw):
    kw.setdefault("host_workers", 2)
    kw.setdefault("host_pool_probe", False)
    return TorchEngine(device="cpu", row_stride=ROW_STRIDE, **kw)


def _run(eng, spec_json, reqs):
    try:
        assert eng.enable_coprocessors([(1, spec_json, ("bench",))]) == [0]
        return [_reply_bytes(eng.process_batch(_port_request(r))) for r in reqs], eng.stats()
    finally:
        eng.shutdown()


def _no_failures(st):
    return not any(k.startswith("n_failures") for k in st)


# ---------------------------------------------------------------- the pool
def test_pool_keeps_input_order_and_raises_the_first_failure_after_all_end():
    done = threading.Event()

    def slow():
        time.sleep(0.05)
        done.set()
        return 3

    def boom_a():
        raise ValueError("a")

    def boom_b():
        raise KeyError("b")

    before = set(threading.enumerate())
    pool = host_pool.HostStagePool(3)
    ref = ref_host_pool.HostStagePool(3)
    try:
        for p in (pool, ref):
            assert p.run([lambda: 1, lambda: 2, lambda: 3]) == [1, 2, 3]
            assert p.run([lambda: "one"]) == ["one"]
            done.clear()
            with pytest.raises(ValueError):
                p.run([boom_a, boom_b, slow])
            assert done.is_set()  # the failure came after every task ended
        mine = [t for t in set(threading.enumerate()) - before
                if t.name.startswith("rptorch-host-stage")]
        assert len(mine) == 3
    finally:
        pool.shutdown()
        ref.shutdown()
    assert not any(t.is_alive() for t in mine)  # shutdown joins them
    assert pool.run([lambda: 1, lambda: 2]) == [1, 2]  # a new executor after shutdown
    pool.shutdown()


def test_default_workers_and_capacity_probe_match_reference():
    assert host_pool.default_host_workers() == ref_host_pool.default_host_workers()
    assert host_pool.PROBE_MARGIN == ref_host_pool.PROBE_MARGIN
    got = host_pool.measure_parallel_capacity(2)
    want = ref_host_pool.measure_parallel_capacity(2)
    assert set(got) == set(want) == {"speedup", "workers"}
    assert got["workers"] == want["workers"] == 2 and got["speedup"] > 0


def test_pool_exists_only_at_two_workers():
    for workers, has_pool in ((0, False), (1, False), (2, True), (None, None)):
        eng = TorchEngine(device="cpu", host_workers=workers)
        st = eng.stats()
        if has_pool is None:  # the default: min(4, cores)
            assert st["host_workers"] == host_pool.default_host_workers()
        else:
            assert (eng._host_pool is not None) == has_pool
            assert ("host_pool_recal" in st) == has_pool
        eng.shutdown()


# ---------------------------------------------------------------- pool lane parity
@pytest.mark.parametrize("workload", sorted(WORKLOADS))
@pytest.mark.parametrize("ladder", sorted(LADDERS))
@pytest.mark.parametrize("name", sorted(SPECS))
def test_pool_lane_matches_reference(name, ladder, workload, low_gate):
    spec_json = SPECS[name].to_json()
    req = WORKLOADS[workload]()
    want = _ref_replies(spec_json, [req])
    got, st = _run(_engine(**LADDERS[ladder]), spec_json, [req])
    assert got == want
    assert st["n_sharded_launches"] == 1 and st["n_kernel_predicate"] == 2  # one a shard
    assert st["t_sharded_dispatch"] > 0 and st["t_sharded_frame"] > 0
    if ladder == "structural":
        assert st["t_shard_explode_find2"] > 0 and "t_explode_find2" not in st
    else:
        assert st["t_shard_explode_find"] > 0 and "t_explode_find" not in st
    if name == "pass":
        assert st["n_frame_gather"] == 2 and "n_frame_padded" not in st
    assert _no_failures(st)


@pytest.mark.parametrize("spec", ["payload", "identity", "uppercase"])
def test_pool_lane_shards_the_explode_of_payload_and_host_plans(spec, low_gate):
    spec_json = {"payload": filter_contains(b"error"), "identity": identity(),
                 "uppercase": map_uppercase()}[spec].to_json()
    req = _matrix_request()
    want = _ref_replies(spec_json, [req], structural_parse=None)
    got, st = _run(_engine(), spec_json, [req])
    assert got == want and any(b for _, _, b in want[0][0])
    assert st["n_sharded_launches"] == 1
    # payload plans keep the one staging path: the pointer table, merged
    explode, other = ("t_explode_ptrs", "t_explode") if spec == "payload" else (
        "t_explode", "t_explode_ptrs")
    assert st[explode] > 0 and other not in st
    assert st.get("n_kernel_payload_transform", 0) == (1 if spec == "payload" else 0)
    assert _no_failures(st)


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_merged_pointer_tables_equal_one_explode(name):
    batches = [b for it in _port_request(WORKLOADS[name]()).items for b in it.batches]
    whole = batch_codec.explode_ptrs(batches)
    cuts = host_pool.partition_counts([b.header.record_count for b in batches], 3)
    merged = batch_codec.merge_ptrs([batch_codec.explode_ptrs(batches[s:e]) for s, e in cuts])
    assert merged.ranges == whole.ranges
    assert merged.sizes.tolist() == whole.sizes.tolist()
    assert [bytes(p) for p in merged.payloads] == [bytes(p) for p in whole.payloads]
    assert all(a.tolist() == b.tolist() for a, b in zip(merged.rel_off, whole.rel_off))
    assert all(a.tolist() == b.tolist() for a, b in zip(merged.rel_len, whole.rel_len))
    n_pad = engine_mod._bucket_rows(len(whole.sizes))
    a = np.zeros((n_pad, ROW_STRIDE + 8), np.uint8)
    b = np.ones_like(a)
    engine_mod.pack_staged_ptrs(merged, ROW_STRIDE, a)
    engine_mod.pack_staged(batch_codec.explode_batches(batches), ROW_STRIDE, b)
    assert np.array_equal(a, b)


def test_pool_lane_at_the_real_gate():
    """Launches of _SHARD_MIN_ROWS records or more fan out, smaller ones
    keep the inline path."""
    big = _request(n_items=33, records=64, pad=20)  # 2112 records
    small = _request(n_items=31, records=66, pad=20)  # 2046 records
    for req, sharded in ((big, True), (small, False)):
        want = _ref_replies(PASS_SPEC.to_json(), [req])
        got, st = _run(_engine(structural_probe=False), PASS_SPEC.to_json(), [req])
        assert got == want
        assert st.get("n_sharded_launches", 0) == (1 if sharded else 0)
        assert st["n_kernel_predicate"] == (2 if sharded else 1)


# ---------------------------------------------------------------- calibration
def _calibrating_engine(monkeypatch, timings, **kw):
    seq = list(timings)
    monkeypatch.setattr(TorchEngine, "_measure_pool_ratio",
                        lambda self, plan, batches, counts: seq.pop(0))
    return _engine(host_pool_probe=True, **kw)


def test_calibration_keeps_inline_on_a_loss(monkeypatch, low_gate):
    req = _matrix_request(n_items=4)
    want = _ref_replies(PROJ_SPEC.to_json(), [req] * 2)
    got, st = _run(_calibrating_engine(monkeypatch, [(0.010, 0.009)]), PROJ_SPEC.to_json(),
                   [req] * 2)
    assert got == want
    assert "n_sharded_launches" not in st
    assert st["host_pool_probe"]["chosen"] == "inline"
    assert st["host_pool_probe"]["speedup"] == round(10 / 9, 3)


def test_calibration_pins_sharded_on_a_win(monkeypatch, low_gate):
    req = _matrix_request(n_items=4)
    want = _ref_replies(PROJ_SPEC.to_json(), [req] * 2)
    got, st = _run(_calibrating_engine(monkeypatch, [(0.010, 0.005)]), PROJ_SPEC.to_json(),
                   [req] * 2)
    assert got == want
    assert st["n_sharded_launches"] == 2
    assert st["host_pool_probe"]["chosen"] == "sharded"
    assert st["host_pool_probe"]["workers"] == 2


def test_calibration_measures_again_after_the_interval(monkeypatch, low_gate):
    """interval 2: launch 1 calibrates (inline wins), launch 3 measures
    again (sharded wins); the first probe is kept as the previous one."""
    eng = _calibrating_engine(monkeypatch, [(0.010, 0.009), (0.010, 0.005)],
                              host_pool_recal_launches=2)
    req = _matrix_request(n_items=4)
    got, st = _run(eng, PASS_SPEC.to_json(), [req] * 3)
    assert got == _ref_replies(PASS_SPEC.to_json(), [req] * 3)
    assert st["host_pool_probe"]["chosen"] == "sharded"
    assert st["host_pool_probe_prev"]["chosen"] == "inline"
    assert st["host_pool_recal"]["interval"] == 2
    assert st["n_sharded_launches"] == 1


def test_calibration_interval_zero_and_pinned_engines_never_measure_again(monkeypatch,
                                                                           low_gate):
    req = _matrix_request(n_items=4)
    _, st = _run(_calibrating_engine(monkeypatch, [(0.010, 0.009)],
                                     host_pool_recal_launches=0), PASS_SPEC.to_json(), [req] * 4)
    assert st["host_pool_probe"]["chosen"] == "inline" and "host_pool_probe_prev" not in st
    assert st["host_pool_recal"]["interval"] == 0

    def never(*a):
        raise AssertionError("a pinned pool must not measure")

    monkeypatch.setattr(TorchEngine, "_measure_pool_ratio", never)
    _, st = _run(_engine(host_pool_recal_launches=1), PASS_SPEC.to_json(), [req] * 3)
    assert st["n_sharded_launches"] == 3 and st["host_pool_recal"]["interval"] == 0


def test_calibration_failure_keeps_inline(monkeypatch, low_gate):
    def boom(self, plan, batches, counts):
        raise RuntimeError("measurement failed")

    monkeypatch.setattr(TorchEngine, "_measure_pool_ratio", boom)
    req = _matrix_request(n_items=4)
    got, st = _run(_engine(host_pool_probe=True), PROJ_SPEC.to_json(), [req])
    assert got == _ref_replies(PROJ_SPEC.to_json(), [req])
    assert st["n_failures_pool_calibration"] == 1 and "n_sharded_launches" not in st


@pytest.mark.parametrize("spec", ["proj", "pass", "payload", "identity"])
def test_measure_pool_ratio_times_the_launch_and_keeps_no_stats(spec, low_gate):
    """The probe runs the launch both ways, from the explode through the
    predicate launch, the mask, the framing and the seal, and leaves the
    engine's stats and harvest thread alone."""
    spec_json = {"proj": PROJ_SPEC.to_json(), "pass": PASS_SPEC.to_json(),
                 "payload": filter_contains(b"error").to_json(),
                 "identity": identity().to_json()}[spec]
    eng = _engine(compress_threshold=64)
    calls, sealed = [], []
    real, real_seal = TorchEngine._predicate_mask, TorchEngine._seal
    eng._predicate_mask = lambda *a, **kw: calls.append(1) or real(eng, *a, **kw)
    eng._seal = lambda jobs, idx: sealed.append(len(idx)) or real_seal(eng, jobs, idx)
    try:
        eng.enable_coprocessors([(1, spec_json, ("bench",))])
        batches = [b for it in _port_request(_matrix_request(n_items=10, n_recs=48)).items
                   for b in it.batches]
        before = eng.stats()
        launch = engine_mod._Launch(eng, 1, engine_mod.ErrorPolicy.skip_on_failure,
                                    eng._plans[1])
        t_inline, t_sharded = eng._measure_pool_ratio(
            launch, batches, [b.header.record_count for b in batches])
        assert t_inline > 0 and t_sharded > 0
        after = eng.stats()
        after.pop("arena"), before.pop("arena")  # the framing arena counts its buffers
        assert after == before
        # two passes each way: one launch inline, one a shard sharded
        assert len(calls) == (6 if spec in ("proj", "pass") else 0)
        # the seal: inline in one go, sharded in two chunks of the same jobs
        assert len(sealed) == 6 and sealed[0] == sealed[1] + sealed[2] > 0
        assert eng._harvester is None
    finally:
        eng.shutdown()


@pytest.mark.parametrize("slow_thread,chosen", [("caller", "sharded"), ("pool", "inline")])
def test_the_pool_probe_weighs_the_seal(slow_thread, chosen, monkeypatch, low_gate):
    """The probe's passes end in the seal: a seal made slow on the
    caller's thread is a win for the pool, one slow on the pool's threads a
    loss, and the replies are the reference's either way."""
    real = TorchEngine._seal

    def seal(self, jobs, idx):
        on_pool = threading.current_thread().name.startswith("rptorch-host-stage")
        if on_pool == (slow_thread == "pool"):
            time.sleep(0.002 * len(idx))
        return real(self, jobs, idx)

    monkeypatch.setattr(TorchEngine, "_seal", seal)
    req = _matrix_request(n_items=10, n_recs=48)  # 20 output batches
    got, st = _run(_engine(host_pool_probe=True, compress_threshold=64), PASS_SPEC.to_json(),
                   [req] * 2)
    assert got == _ref_replies(PASS_SPEC.to_json(), [req] * 2, compress_threshold=64)
    assert st["host_pool_probe"]["chosen"] == chosen
    assert ("t_sharded_seal" in st) == (chosen == "sharded") and _no_failures(st)


# ---------------------------------------------------------------- a faulted shard
def test_faulted_shard_degrades_the_launch_to_the_inline_lane(monkeypatch, low_gate):
    """One shard worker fails: the launch runs inline from its batches, with
    the reference's bytes; the other shard's mask, handed to the harvest
    thread before the fan-in, is abandoned, and the inline mask, still
    queued (no harvest thread runs here), is claimed and fetched by its
    caller."""
    real = TorchEngine._run_columnar_shard
    calls, slots = [], []

    def flaky(self, launch, plan, batches, paths, structural):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("shard worker fault")
        return real(self, launch, plan, batches, paths, structural)

    real_publish = TorchEngine._publish_mask

    def publish(self, slot):
        slots.append(slot)
        real_publish(self, slot)

    monkeypatch.setattr(TorchEngine, "_run_columnar_shard", flaky)
    monkeypatch.setattr(TorchEngine, "_harvest_async", lambda self: True)
    monkeypatch.setattr(TorchEngine, "_ensure_harvester", lambda self: None)
    monkeypatch.setattr(TorchEngine, "_publish_mask", publish)
    monkeypatch.setattr(engine_mod, "_HARVEST_WAIT_S", 0.01)
    req = _matrix_request()
    got, st = _run(_engine(), PROJ_SPEC.to_json(), [req])
    assert got == _ref_replies(PROJ_SPEC.to_json(), [req])
    assert st["n_failures_shard_worker"] == 1 and "n_sharded_launches" not in st
    assert [s.state for s in slots] == ["abandoned", "claimed"]
    assert {k for k in st if k.startswith("n_failures")} == {"n_failures_shard_worker"}


# ---------------------------------------------------------------- reply-wide seal
def test_seal_fans_out_at_eight_batches_and_matches_the_serial_loop(low_gate):
    req = _matrix_request(n_items=10, n_recs=48)  # 20 output batches
    want = _ref_replies(PASS_SPEC.to_json(), [req], compress_threshold=64)
    got, st = _run(_engine(compress_threshold=64), PASS_SPEC.to_json(), [req])
    assert got == want
    assert st["t_sharded_seal"] > 0 and st["t_shard_seal"] > 0 and "t_seal" not in st
    inline, st0 = _run(_engine(compress_threshold=64, host_workers=0), PASS_SPEC.to_json(),
                       [req])
    assert inline == got and st0["t_seal"] > 0 and "t_sharded_seal" not in st0


def test_seal_below_eight_batches_stays_inline(low_gate):
    req = _matrix_request(n_items=2)  # 4 output batches
    got, st = _run(_engine(compress_threshold=64), PASS_SPEC.to_json(), [req])
    assert got == _ref_replies(PASS_SPEC.to_json(), [req], compress_threshold=64)
    assert st["n_sharded_launches"] == 1
    assert st["t_seal"] > 0 and "t_sharded_seal" not in st


def test_a_failing_pool_seals_inline_and_is_counted(monkeypatch, low_gate):
    def broken(self, fns):
        raise RuntimeError("executor failure")

    monkeypatch.setattr(host_pool.HostStagePool, "run", broken)
    req = _matrix_request(n_items=10, n_recs=48)
    got, st = _run(_engine(compress_threshold=64), PASS_SPEC.to_json(), [req])
    assert got == _ref_replies(PASS_SPEC.to_json(), [req], compress_threshold=64)
    # the dispatch fan-out and the seal fan-out each fell back once
    assert st["n_failures_shard_worker"] == 2 and st["t_seal"] > 0


@pytest.mark.parametrize("timing,fans_out", [((0.010, 0.005), True), ((0.010, 0.009), False)])
def test_seal_fans_out_under_the_pool_decision_only(timing, fans_out, monkeypatch, low_gate):
    """The seal has no decision of its own: it fans out exactly when the
    pool's measured decision is "sharded"."""
    req = _matrix_request(n_items=10, n_recs=48)
    got, st = _run(_calibrating_engine(monkeypatch, [timing], compress_threshold=64),
                   PASS_SPEC.to_json(), [req] * 2)
    assert got == _ref_replies(PASS_SPEC.to_json(), [req] * 2, compress_threshold=64)
    assert st["host_pool_probe"]["chosen"] == ("sharded" if fans_out else "inline")
    assert ("t_sharded_seal" in st) == fans_out and ("t_seal" in st) != fans_out
    assert "seal_probe" not in st and _no_failures(st)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_shard_cache_entries_populate_then_hit(name, low_gate):
    """Per launch one launch-wide miss (the lookup before the fan-out) and
    one lookup a shard: three launches of two shards miss 3 + 2 times and
    hit 2 * 2 times, as the reference counts them."""
    req = _request(n_items=8, records=32, pad=40)
    spec_json = SPECS[name].to_json()
    want = _ref_replies(spec_json, [req] * 3)
    got, st = _run(_engine(device_column_cache_mb=32, structural_probe=False), spec_json,
                   [req] * 3)
    assert got == want
    cc = st["colcache"]
    assert (cc["misses"], cc["hits"], cc["entries"]) == (5, 4, 2)
    assert st["n_sharded_launches"] == 3
    assert st["t_shard_explode_find2"] > 0 and st["n_kernel_predicate"] == 6


# ---------------------------------------------------------------- pooled mesh ladders
def test_pooled_mesh_lane_matches_single_lane_and_caches_per_shard():
    """The mesh lane's shard ladders on the pool: the single lane's and the
    reference's bytes, and tests/test_meshrunner.py's per-shard cache
    counts (4 misses, then 4 hits a launch)."""
    req = _mesh_request()
    spec_json = MESH_PROJ_SPEC.to_json()
    ref = TpuEngine(row_stride=256, host_workers=0, mesh_devices=4, mesh_backend="cpu",
                    mesh_probe=False, device_column_cache_mb=32)
    try:
        ref.enable_coprocessors([(1, spec_json, ("mesh",))])
        want = [_reply_bytes(ref.process_batch(req)) for _ in range(3)]
        ref_st = ref.stats()
    finally:
        ref.shutdown()
    single, _ = _run(TorchEngine(device="cpu", row_stride=256, host_workers=0), spec_json,
                     [req] * 3)
    eng = TorchEngine(device="cpu", row_stride=256, mesh=partition_mesh(4, device="cpu"),
                      mesh_probe=False, host_workers=2, device_column_cache_mb=32)
    got, st = _run(eng, spec_json, [req] * 3)
    assert got == single == want
    assert st["colcache"]["misses"] == ref_st["colcache"]["misses"] == 4
    assert st["colcache"]["hits"] == ref_st["colcache"]["hits"] == 8
    assert st["mesh"]["launches"] == 3 and st["n_mesh_launches"] == 3
    assert st["mesh"]["rows_per_device"] == ref_st["mesh"]["rows_per_device"]
    assert st["n_kernel_predicate_stacked"] == 3 * 4 and "n_kernel_predicate" not in st
    assert st["t_mesh_ladder"] > 0 and st["t_shard_explode_find"] > 0
    assert _no_failures(st)


def test_faulted_mesh_shard_goes_single_and_counts_a_demotion(monkeypatch):
    def boom(self, *a):
        raise RuntimeError("mesh shard worker fault")

    monkeypatch.setattr(TorchEngine, "_run_mesh_shard", boom)
    req = _mesh_request()
    spec_json = MESH_PROJ_SPEC.to_json()
    single, _ = _run(TorchEngine(device="cpu", row_stride=256, host_workers=0), spec_json,
                     [req])
    eng = TorchEngine(device="cpu", row_stride=256, mesh=partition_mesh(4, device="cpu"),
                      mesh_probe=False, host_workers=2)
    got, st = _run(eng, spec_json, [req])
    assert got == single
    assert st["n_failures_shard_worker"] == 1 and st["mesh"]["demotions"] == 1
    assert "n_mesh_launches" not in st and st["n_kernel_predicate"] == 1


# ---------------------------------------------------------------- shutdown
def test_shutdown_leaves_no_harvester_or_pool_thread(monkeypatch, low_gate):
    monkeypatch.setattr(TorchEngine, "_harvest_async", lambda self: True)
    req = _matrix_request(n_items=10, n_recs=48)
    before = set(threading.enumerate())
    eng = _engine(compress_threshold=64)
    eng.enable_coprocessors([(1, PASS_SPEC.to_json(), ("bench",))])
    got = _reply_bytes(eng.process_batch(_port_request(req)))
    assert got == _ref_replies(PASS_SPEC.to_json(), [req], compress_threshold=64)[0]
    threads = set(threading.enumerate()) - before
    assert sorted(t.name.split("_")[0] for t in threads) == [
        "rptorch-host-stage", "rptorch-host-stage", "rptorch-mask-harvester"]
    eng.shutdown()
    assert not any(t.is_alive() for t in threads) and eng._harvester is None


# ---------------------------------------------------------------- zstd without the package
def test_libzstd_contexts_are_per_thread_and_match_one_shot_compress(monkeypatch):
    """Without the zstandard package (the card's machine) the seal runs on
    libzstd through ctypes: each pool thread reuses its own context, and the
    bytes are the library's one-shot ZSTD_compress's (a fresh context a
    call), which the reference's decompressor reads back."""
    import ctypes

    from redpanda_tpu import compression as ref_compression
    from redpanda_tpu.models.record import Compression as RCompression
    from redpanda_tpu_torch.compression import codecs

    monkeypatch.setattr(codecs, "zstandard", None)
    lib = codecs._zstd_handle()
    one_shot = lib.ZSTD_compress
    one_shot.restype = ctypes.c_size_t
    one_shot.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                         ctypes.c_int]

    def fresh(data):
        bound = lib.ZSTD_compressBound(len(data))
        dst = ctypes.create_string_buffer(bound)
        n = one_shot(dst, bound, data, len(data), codecs.ZSTD_LEVEL)
        return dst.raw[:n]

    payloads = [b"".join(b'{"level":"error","code":%d}' % (k * 37 + i) for i in range(40 + 90 * k))
                for k in range(12)]
    want = [fresh(p) for p in payloads]
    pool = host_pool.HostStagePool(4)

    def work(k):
        got = codecs.zstd_compress(payloads[k])
        return got, codecs.zstd_uncompress(got), codecs._zstd_lib_ctx()

    try:
        out = pool.run([(lambda k=k: work(k)) for k in range(len(payloads))] * 3)
    finally:
        pool.shutdown()
    assert [c for c, _, _ in out] == want * 3
    assert [u for _, u, _ in out] == payloads * 3
    assert [ref_compression.uncompress(c, RCompression.zstd) for c in want] == payloads
    assert 2 <= len({id(ctx) for _, _, ctx in out}) <= 4  # one context a thread
