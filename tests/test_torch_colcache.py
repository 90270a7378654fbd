"""The port's column cache (coproc/colcache.py) against the JAX package's.

A hit must give the cold launch's reply bytes (and the reference engine's),
skip the host ladder and be counted; an appended window misses; script
disable, ``invalidate_columns`` and LRU eviction drop entries; the counters
and the fingerprint are the reference's. Inputs are test_structural_parse's
generators; the reference engine runs inline (no host pool).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from redpanda_tpu.coproc import colcache as ref_colcache
from redpanda_tpu.coproc.engine import TpuEngine
from redpanda_tpu.models.record import Record, RecordBatch
from redpanda_tpu_torch import interop
from redpanda_tpu_torch.coproc import colcache
from redpanda_tpu_torch.coproc.engine import TorchEngine
from test_structural_parse import PASS_SPEC, PROJ_SPEC, _request
from test_torch_structural import _port_request, _reply_bytes

ROW_STRIDE = 512
SPECS = {"proj": PROJ_SPEC, "pass": PASS_SPEC}
LANES = {"staged": dict(structural_parse=False), "structural": dict(structural_probe=False)}
HOST_STAGES = ("t_explode_find", "t_explode_find2", "t_extract_pred", "t_extract_proj",
               "t_fused_extract")


def _ref_engine(**kw):
    return TpuEngine(row_stride=ROW_STRIDE, force_mode="columnar_host", host_workers=0, **kw)


def _engine(**kw):
    kw.setdefault("device_column_cache_mb", 16)
    return TorchEngine(device="cpu", row_stride=ROW_STRIDE, **kw)


def test_fingerprint_matches_reference_and_changes_on_append():
    recs = [Record(offset_delta=i, value=b'{"level":"error"}') for i in range(4)]
    b1 = RecordBatch.build(recs, base_offset=0)
    b2 = RecordBatch.build(recs + [Record(offset_delta=4, value=b'{"level":"info"}')],
                           base_offset=0)
    b3 = RecordBatch.build(recs, base_offset=7)
    port = {id(b): interop.batch_from_wire(b.encode_internal()) for b in (b1, b2, b3)}
    for window in ([b1], [b2], [b1, b3], [b3, b1], []):
        assert colcache.fingerprint([port[id(b)] for b in window]) == ref_colcache.fingerprint(
            window)
    fps = {colcache.fingerprint([port[id(b)] for b in w]) for w in ([b1], [b2], [b1, b3], [b3, b1])}
    assert len(fps) == 4  # append, base offset and order all change the key


@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("name", sorted(SPECS))
def test_hit_is_bit_identical_and_counted(name, lane):
    req = _request(pad=40)
    spec_json = SPECS[name].to_json()
    ref = _ref_engine(device_column_cache_mb=16, **LANES[lane])
    try:
        ref.enable_coprocessors([(1, spec_json, ("bench",))])
        want = [_reply_bytes(ref.process_batch(req)) for _ in range(3)]
        ref_stats = ref.stats()["colcache"]
    finally:
        ref.shutdown()
    eng = _engine(**LANES[lane])
    eng.enable_coprocessors([(1, spec_json, ("bench",))])
    cold = _reply_bytes(eng.process_batch(_port_request(req)))
    eng.reset_stats()
    warm = [_reply_bytes(eng.process_batch(_port_request(req))) for _ in range(2)]
    assert [cold] + warm == want
    assert any(batches for _, _, batches in cold[0])
    st = eng.stats()
    assert st["colcache"] == ref_stats  # hits, misses, entries and bytes alike
    assert st["colcache"]["hits"] == 2 and st["colcache"]["misses"] == 1
    assert st["colcache"]["entries"] == 1 and st["colcache"]["bytes"] > 0
    assert st["n_colcache_hit"] == 2 and "n_colcache_miss" not in st
    assert not any(k in st for k in HOST_STAGES)  # the hits skipped the ladder
    assert st["n_kernel_predicate"] == 2 and st["n_records"] == 2 * 8 * 32


def test_append_misses_then_invalidate_hook():
    eng = _engine()
    eng.enable_coprocessors([(1, PASS_SPEC.to_json(), ("bench",))])
    req = _port_request(_request())
    eng.process_batch(req)
    eng.process_batch(req)
    assert eng.stats()["colcache"]["hits"] == 1
    appended = _request(pad=201)  # a changed window must miss, never read stale
    ref = _ref_engine()
    ref.enable_coprocessors([(1, PASS_SPEC.to_json(), ("bench",))])
    want = _reply_bytes(ref.process_batch(appended))
    ref.shutdown()
    got = _reply_bytes(eng.process_batch(_port_request(appended)))
    assert got == want
    st = eng.stats()["colcache"]
    assert st["misses"] == 2 and st["entries"] == 2
    assert eng.invalidate_columns(1) == st["entries"]
    assert _reply_bytes(eng.process_batch(_port_request(appended))) == got
    st = eng.stats()["colcache"]
    assert st["invalidations"] == 2 and st["entries"] == 1 and st["misses"] == 3
    assert eng.invalidate_columns() == 1 and eng.stats()["colcache"]["bytes"] == 0


def test_script_disable_drops_entries():
    eng = _engine()
    eng.enable_coprocessors([(1, PASS_SPEC.to_json(), ("bench",)),
                             (2, PROJ_SPEC.to_json(), ("bench",))])
    req = _port_request(_request())
    eng.process_batch(req)
    for it in req.items:
        it.script_id = 2
    eng.process_batch(req)
    assert eng.stats()["colcache"]["entries"] == 2
    eng.disable_coprocessors([1])
    assert eng.stats()["colcache"]["entries"] == 1
    eng.disable_coprocessors([2])
    assert eng.stats()["colcache"]["entries"] == 0


def test_lru_eviction_under_budget():
    for mod in (colcache, ref_colcache):
        cache = mod.DeviceColumnCache(3000)

        def entry(nbytes):
            return mod.Entry(n=1, n_pad=1, ranges=[(0, 1)], cols=[np.zeros(nbytes, np.uint8)])

        assert cache.put((1, 1), entry(1000))
        assert cache.put((1, 2), entry(1000))
        assert cache.put((1, 3), entry(1000))
        assert cache.lookup((1, 1)) is not None  # (1, 2) is now the LRU entry
        assert cache.put((1, 4), entry(1000))
        assert cache.lookup((1, 2)) is None
        assert cache.lookup((1, 1)) is not None
        assert not cache.put((1, 9), entry(5000))  # bigger than the whole budget
        assert cache.lookup((1, 9)) is None
        assert cache.set_pressure(True) == 2  # half the budget: two LRU entries go
        cache.set_pressure(False)
        if mod is colcache:
            got = cache.stats()
        else:
            assert got == cache.stats()
    assert got["evictions"] == 3 and got["pressure_evictions"] == 2 and got["bytes"] == 1000


def test_entry_counts_device_bytes():
    e = colcache.Entry(n=4, n_pad=8, ranges=[(0, 4)], cols=[np.zeros(8, np.uint8)])
    assert e.nbytes == 8
    # one device block: a uint8 and an int32 column of 8 rows at 16-byte offsets
    e.cols_dev = torch.zeros(16 + 32, dtype=torch.uint8)
    assert e._measure() == 8 + 16 + 32


def test_reset_hook_and_stats_shape():
    eng = _engine(device_column_cache_mb=8)
    eng.enable_coprocessors([(1, PASS_SPEC.to_json(), ("bench",))])
    eng.process_batch(_port_request(_request(n_items=2, records=8)))
    eng.reset_column_cache()
    ref = _ref_engine(device_column_cache_mb=8)
    ref.reset_column_cache()
    assert eng.stats()["colcache"] == ref.stats()["colcache"] == {
        "hits": 0, "misses": 0, "entries": 0, "bytes": 0,
        "budget_bytes": 8 << 20, "evictions": 0, "invalidations": 0,
        "effective_budget_bytes": 8 << 20, "pressure": False, "pressure_evictions": 0,
    }
    ref.shutdown()


def test_disabled_cache_reports_nothing():
    eng = TorchEngine(device="cpu", row_stride=ROW_STRIDE)
    eng.enable_coprocessors([(1, PASS_SPEC.to_json(), ("bench",))])
    req = _port_request(_request(n_items=2, records=8))
    eng.process_batch(req)
    eng.process_batch(req)
    st = eng.stats()
    assert "colcache" not in st and "n_colcache_miss" not in st
    assert eng.invalidate_columns() == 0
