"""The engine's columnar backend of the PyTorch port against the JAX package:
the host predicate, ``force_mode`` and the process-wide backend probe, and
the journal records of the LZ4 and raft probes.

The host predicate (``ColumnarPlan.eval_host_mask``, numpy) must give the
JAX package's ``eval_host_mask`` bits and the port's plain K1
(``predicate_plain``) on the same columns, bit for bit: the expressions and
documents of tests/test_exprs.py, and seeded random columns. Each
``force_mode`` on a CPU engine gives the JAX engine's replies under the same
mode, byte for byte. The probe runs on engines that follow the process-wide
backend (on a card; here a CPU engine with ``_backend_probe`` set, whose
device leg is the plain version), with its leg times stubbed where a
verdict must be forced. Every test resets both packages' backends, the
port's journal and honey badger, and shuts its engines down.
"""

from __future__ import annotations

import os
import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from redpanda_tpu.coproc import governor as ref_gov
from redpanda_tpu.coproc.column_plan import plan_spec as ref_plan_spec
from redpanda_tpu.coproc.engine import TpuEngine
from redpanda_tpu.finjector import honey_badger as ref_badger
from redpanda_tpu.ops import lz4_device as ref_lz4
from redpanda_tpu.ops.transforms import Int, identity, map_project, map_uppercase, where
from redpanda_tpu.raft import device_plane as RDP
from redpanda_tpu_torch import metrics
from redpanda_tpu_torch.coproc import engine as engine_mod
from redpanda_tpu_torch.coproc import faults, governor
from redpanda_tpu_torch.coproc.column_plan import ColumnarPlan, PayloadPlan, plan_spec
from redpanda_tpu_torch.coproc.engine import ErrorPolicy, TorchEngine
from redpanda_tpu_torch.finjector import honey_badger
from redpanda_tpu_torch.ops import lz4_device as L
from redpanda_tpu_torch.ops.transforms import TransformSpec
from redpanda_tpu_torch.parallel.mesh import partition_mesh
from redpanda_tpu_torch.hashing.crc32c import crc32c
from redpanda_tpu_torch.raft import device_plane as DP
from test_exprs import DOCS, EXPRS, _vals
from test_structural_parse import PASS_SPEC, PROJ_SPEC, _request
from test_torch_structural import _port_request, _reply_bytes

ROW_STRIDE = 512
SPECS = {
    "proj": PROJ_SPEC,
    "pass": PASS_SPEC,
    "identity": identity(),
    "uppercase": map_uppercase(),
    "project_only": map_project(Int("code")),
}
_engines: list = []


def _disarm(badger) -> None:
    for module, armed in list(badger.armed().items()):
        for probe in armed:
            badger.unset(module, probe)
    badger.disable()


def _reset() -> None:
    TorchEngine.reset_columnar_probe()
    TpuEngine.reset_columnar_probe()
    governor.reset_journal()
    _disarm(honey_badger)
    _disarm(ref_badger)


@pytest.fixture(autouse=True)
def _fresh_backend():
    """The backend, the journal and the badgers are process-wide: every test
    starts and ends with none measured, empty and disarmed, and its engines
    shut down."""
    _reset()
    try:
        yield
    finally:
        try:
            while _engines:
                _engines.pop().shutdown()
        finally:
            _reset()


def _engine(probing=False, **kw):
    kw.setdefault("host_workers", 0)
    eng = TorchEngine(device="cpu", row_stride=ROW_STRIDE, **kw)
    _engines.append(eng)
    eng._backend_probe = probing
    return eng


def _ref_engine(**kw):
    kw.setdefault("host_workers", 0)
    eng = TpuEngine(row_stride=ROW_STRIDE, **kw)
    _engines.append(eng)
    return eng


def _enable(eng, spec, policy=None):
    script = (1, spec.to_json(), ("bench",)) + (() if policy is None else (policy,))
    assert eng.enable_coprocessors([script]) == [0]
    return eng


def _replies(eng, reqs):
    return [_reply_bytes(eng.process_batch(_port_request(r) if isinstance(eng, TorchEngine)
                                           else r)) for r in reqs]


def _big_request():
    """1280 records of short messages in 8 batches: a launch of 2048 padded
    rows, past the probe's 1024, with records Str("msg", 64) keeps."""
    return _request(n_items=8, records=160, pad=10)


def _small_request():
    return _request(n_items=2, records=40, pad=10)  # 80 records: 128 padded rows


def _journal(domain):
    return [e for e in governor.journal.entries() if e["domain"] == domain]


def _failures(domain):
    return sum(v for k, v in metrics.registry.snapshot().items()
               if k.startswith("coproc_failures_total{") and f'domain="{domain}"' in k)


def _stub_legs(monkeypatch, t_host, t_dev):
    calls = []
    monkeypatch.setattr(TorchEngine, "_probe_host_leg", lambda self, p, c: t_host)

    def dev_leg(self, plan, cols):
        calls.append(len(cols[0]))
        return t_dev

    monkeypatch.setattr(TorchEngine, "_probe_device_leg", dev_leg)
    return calls


# ------------------------------------------------------------ host predicate
def _port_plan(ref_expr):
    return plan_spec(TransformSpec.from_json(where(ref_expr).to_json()))


def _three_ways(ref_expr, cols):
    """(JAX eval_host_mask, port eval_host_mask, port predicate_plain)."""
    ref = ref_plan_spec(where(ref_expr))
    plan = _port_plan(ref_expr)
    assert isinstance(plan, ColumnarPlan)
    got = plan.eval_host_mask(cols)
    plain = plan.predicate([torch.from_numpy(c) for c in cols]).numpy()
    return ref.eval_host_mask(cols), got, plain


@pytest.mark.parametrize("idx", range(len(EXPRS)))
def test_host_predicate_matches_reference_and_plain_on_documents(idx):
    vals = _vals()
    joined = b"".join(vals)
    offsets = np.cumsum([0] + [len(v) for v in vals[:-1]]).astype(np.int64)
    sizes = np.array([len(v) for v in vals], np.int32)
    n_pad = ((len(vals) + 7) // 8) * 8
    cols = _port_plan(EXPRS[idx]).extract_device_inputs(joined, offsets, sizes, n_pad)
    want, got, plain = _three_ways(EXPRS[idx], cols)
    assert got.dtype == np.uint8 and got.shape == (n_pad // 8,)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)
    assert len(DOCS) == len(vals)


_NUMS = [0.0, 1.0, 1.5, 2.0, 3.0, 9.0, 42.0, 100.0, 200.0, 499.5, 499.6, 500.0, 503.0,
         -7.0, -2.5, 2.0 ** 31 - 1, 2.0 ** 31]


def _random_cols(plan, n_pad, rng):
    """Seeded random host columns of the plan's kinds: strings made of the
    expressions' words at random cut points, numbers on and next to their
    constants (f32 and i32 drawn apart, so that the int-exact select
    matters), random flag bits."""
    words = [b"error", b"info", b"needle in a haystack", b"ndl", b"x", b"hay", b""]
    cols = []
    for c in plan.dev_cols:
        if c.kind == "str":
            b = np.zeros((n_pad, c.w), np.uint8)
            v = rng.integers(-1, c.w + 3, n_pad).astype(np.int32)
            for i in range(n_pad):
                w = words[rng.integers(len(words))][rng.integers(0, 3):]
                w = w[: c.w]
                b[i, : len(w)] = np.frombuffer(w, np.uint8)
                if rng.random() < 0.5:
                    v[i] = len(w)
            cols += [b, v]
        elif c.kind == "num":
            base = np.array(_NUMS, np.float32)[rng.integers(len(_NUMS), size=n_pad)]
            step = rng.integers(-1, 2, n_pad)
            f32 = np.where(step < 0, np.nextafter(base, np.float32(-np.inf)),
                           np.where(step > 0, np.nextafter(base, np.float32(np.inf)), base))
            f32 = f32.astype(np.float32)
            i32 = (np.clip(np.array(_NUMS)[rng.integers(len(_NUMS), size=n_pad)], -2**31, 2**31 - 1)
                   .astype(np.int64) + rng.integers(-1, 2, n_pad)).clip(-2**31, 2**31 - 1)
            cols += [f32, i32.astype(np.int32), rng.integers(0, 32, n_pad).astype(np.uint8)]
        else:
            cols.append(rng.integers(0, 3, n_pad).astype(np.uint8))
    return cols


@pytest.mark.parametrize("idx", range(len(EXPRS)))
def test_host_predicate_matches_reference_and_plain_on_random_columns(idx):
    rng = np.random.default_rng(100 + idx)
    cols = _random_cols(_port_plan(EXPRS[idx]), 1024, rng)
    want, got, plain = _three_ways(EXPRS[idx], cols)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, plain)
    assert 0 < np.unpackbits(got).sum() < 1024  # the columns reach both answers


def test_host_predicate_is_numpy_and_checks_its_rows():
    plan = _port_plan(EXPRS[0])
    cols = _random_cols(plan, 16, np.random.default_rng(0))
    assert isinstance(plan.eval_host_mask(cols), np.ndarray)
    with pytest.raises(ValueError):
        plan.eval_host_mask([c[:12] for c in cols])


# ------------------------------------------------------------ force_mode
@pytest.mark.parametrize("mode", ["payload", "columnar_host", "columnar_device"])
@pytest.mark.parametrize("spec", sorted(SPECS))
def test_force_mode_replies_match_the_reference_engine(mode, spec):
    reqs = [_request(pad=40), _big_request()]
    want = _replies(_enable(_ref_engine(force_mode=mode), SPECS[spec]), reqs)
    eng = _enable(_engine(force_mode=mode), SPECS[spec])
    assert _replies(eng, reqs) == want
    st = eng.stats()
    where_spec = spec in ("proj", "pass")
    assert eng.governor._config["force_mode"] == mode
    if mode == "columnar_host" and where_spec:
        assert "n_kernel_predicate" not in st and st["n_host_predicate"] == 2
        assert "bytes_h2d" not in st
    elif where_spec:
        assert st["n_kernel_predicate"] == 2 and "n_host_predicate" not in st
    if mode == "payload":
        # a where-less spec takes the payload plan (K4); a where spec keeps its columnar plan
        assert isinstance(eng._plans[1], ColumnarPlan if where_spec else PayloadPlan)
        if not where_spec:
            assert st["n_kernel_payload_transform"] == 2
    assert "columnar_backend" not in st and not any(k.startswith("n_failures") for k in st)


def test_force_mode_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="force_mode"):
        TorchEngine(device="cpu", force_mode="columnar")


def test_columnar_host_pool_shards_evaluate_on_the_host(monkeypatch):
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)
    req = _request(pad=40)
    want = _replies(_enable(_ref_engine(force_mode="columnar_host"), PROJ_SPEC), [req])
    eng = _enable(_engine(force_mode="columnar_host", host_workers=2, host_pool_probe=False),
                  PROJ_SPEC)
    assert _replies(eng, [req]) == want
    st = eng.stats()
    assert st["n_sharded_launches"] == 1 and st["n_host_predicate"] == 2
    assert "n_kernel_predicate" not in st


def test_columnar_host_never_takes_the_mesh_lane():
    req = _big_request()
    want = _replies(_enable(_ref_engine(force_mode="columnar_host"), PROJ_SPEC), [req])
    eng = _enable(_engine(force_mode="columnar_host", mesh=partition_mesh(4, device="cpu"),
                          mesh_probe=False), PROJ_SPEC)
    assert _replies(eng, [req]) == want
    st = eng.stats()
    assert "n_mesh_launches" not in st and "n_kernel_predicate_stacked" not in st
    assert st["n_host_predicate"] == 1


# ------------------------------------------------------------ the probe
def test_probe_runs_once_under_concurrent_first_launches(monkeypatch):
    """The port's counterpart of test_coproc_races.py's: concurrent first
    launches (more threads than cores, the switch interval shortened) probe
    once; the losers wait and adopt the winner's verdict."""
    calls = []

    def slow_probe(self, plan, cols):
        calls.append(1)
        time.sleep(0.05)  # a wide window: an unlocked loser would enter too
        with TorchEngine._columnar_probe_lock:
            TorchEngine._columnar_backend = "host"
            TorchEngine._columnar_probe = {"chosen": "host"}

    monkeypatch.setattr(TorchEngine, "_probe_columnar_backend", slow_probe)
    eng = _enable(_engine(probing=True), PROJ_SPEC)
    req = _port_request(_request(n_items=4, records=150, pad=10))  # 600 records: 1024 rows
    errors = []

    def run():
        try:
            eng.process_batch(req)
        except BaseException as exc:  # noqa: BLE001 - asserted below
            errors.append(exc)

    threads = [threading.Thread(target=run) for _ in range(2 * (os.cpu_count() or 2))]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(calls) == 1
    assert TorchEngine.sticky_columnar_backend() == "host"
    assert eng.stats()["n_host_predicate"] == len(threads)


@pytest.mark.parametrize("ratio,chosen", [(3.9, "host"), (4.1, "device")])
def test_margin_rule_and_the_record(ratio, chosen, monkeypatch):
    t_host = 0.0041
    calls = _stub_legs(monkeypatch, t_host, t_host / ratio)
    eng = _enable(_engine(probing=True), PROJ_SPEC)
    eng.process_batch(_port_request(_big_request()))
    assert calls == [2048]
    probe = {"t_host_s": t_host, "t_device_s": round(t_host / ratio, 6),
             "margin": engine_mod._PROBE_DEVICE_MARGIN, "chosen": chosen}
    st = eng.stats()
    assert st["columnar_backend"] == chosen and st["columnar_probe"] == probe
    [entry] = _journal(governor.COLUMNAR_BACKEND)
    assert entry["verdict"] == chosen and entry["inputs"] == probe
    assert entry["reason"] == (
        f"measured predicate leg: host {t_host * 1e3:.3f} ms vs device "
        f"{t_host / ratio * 1e3:.3f} ms (device must win 4.0x; process-sticky)")
    assert st["governor"]["posture"][governor.COLUMNAR_BACKEND] == chosen
    assert ("n_host_predicate" in st) == (chosen == "host")
    assert ("n_kernel_predicate" in st) == (chosen == "device")


def _template(reason):
    return re.sub(r"\d+\.\d+", "#", reason)


def test_probe_record_and_stats_keys_match_the_reference():
    """The same request on a probing engine of each package (real legs):
    the journal entry's verdict rule, input keys and reason text, and the
    stats() keys, are the reference's."""
    req = _big_request()
    ref = _enable(_ref_engine(), PROJ_SPEC)
    ref.process_batch(req)
    [want] = [e for e in ref_gov.journal.entries()
              if e["domain"] == "columnar_backend" and e["engine"] == ref.governor.engine_tag]
    eng = _enable(_engine(probing=True), PROJ_SPEC)
    eng.process_batch(_port_request(req))
    [got] = _journal(governor.COLUMNAR_BACKEND)
    assert set(got["inputs"]) == set(want["inputs"])
    assert _template(got["reason"]) == _template(want["reason"])
    for e in (want, got):
        p = e["inputs"]
        assert p["margin"] == 4.0
        assert p["chosen"] == ("device" if p["t_device_s"] * 4.0 < p["t_host_s"] else "host")
    ref_st, st = ref.stats(), eng.stats()
    assert set(st["columnar_probe"]) == set(ref_st["columnar_probe"])
    assert st["columnar_backend"] == got["verdict"]
    assert engine_mod._PROBE_MIN_ROWS == 1024 and engine_mod._PROBE_DEVICE_TIMEOUT_S == 120.0


def test_after_a_host_verdict_launches_make_no_k1_launch(monkeypatch):
    _stub_legs(monkeypatch, 0.001, 0.01)  # the device 10x slower: host
    reqs = [_big_request(), _big_request(), _request(pad=40)]
    want = _replies(_enable(_ref_engine(force_mode="columnar_host"), PROJ_SPEC), reqs)
    eng = _enable(_engine(probing=True), PROJ_SPEC)
    assert _replies(eng, reqs) == want
    st = eng.stats()
    assert st["columnar_backend"] == "host" and st["n_host_predicate"] == 3
    assert "n_kernel_predicate" not in st and "bytes_h2d" not in st
    # a second engine adopts it, journaling nothing new
    other = _enable(_engine(probing=True), PASS_SPEC)
    other.process_batch(_port_request(_request(pad=40)))
    assert other.stats()["n_host_predicate"] == 1 and len(_journal(governor.COLUMNAR_BACKEND)) == 1
    assert other.governor.posture()[governor.COLUMNAR_BACKEND] == "host"


def test_a_launch_under_the_probes_size_pins_nothing(monkeypatch):
    calls = _stub_legs(monkeypatch, 0.001, 0.01)
    eng = _enable(_engine(probing=True), PROJ_SPEC)
    req = _small_request()
    want = _replies(_enable(_ref_engine(force_mode="columnar_device"), PROJ_SPEC), [req])
    assert _replies(eng, [req]) == want
    st = eng.stats()
    assert not calls and TorchEngine.sticky_columnar_backend() is None
    assert "columnar_backend" not in st and not _journal(governor.COLUMNAR_BACKEND)
    # departure: before a verdict the launch runs K1, not the host predicate
    assert st["n_kernel_predicate"] == 1 and "n_host_predicate" not in st


def _fake_device_cols(eng) -> None:
    """Give every cache entry a device block of its columns and charge it,
    as a card engine's K1 leg leaves it (here a CPU tensor in the same
    block layout)."""
    cache = eng._colcache
    [plan] = eng._plans.values()
    for key, entry in list(cache._entries.items()):
        with cache._lock:  # out at its old charge, back in at the new one
            cache._bytes -= cache._entries.pop(key).nbytes
        lay = plan.block_layout(entry.n_pad)
        entry.cols_dev = torch.zeros(lay.total, dtype=torch.uint8)
        lay.pack(entry.cols, entry.cols_dev.numpy())
        eng._store(key, entry)


@pytest.mark.parametrize("lane", ["inline", "pool"])
def test_a_host_verdict_drops_cached_device_columns(lane, monkeypatch):
    """Cache entries whose columns went up before a "host" verdict (a small
    window's K1 launch before any verdict; the pool's shards under an
    earlier "device" verdict): a later hit runs the host predicate, makes no
    K1 launch, and the entry's device tensors leave the cache and its
    charge."""
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)
    pool = lane == "pool"
    eng = _enable(_engine(probing=True, device_column_cache_mb=64, host_workers=2 if pool else 0,
                          host_pool_probe=False), PROJ_SPEC)
    window = _request(pad=40) if pool else _small_request()
    want = _replies(_enable(_ref_engine(force_mode="columnar_host"), PROJ_SPEC), [window])
    if pool:
        _stub_legs(monkeypatch, 0.001, 0.0001)  # the device 10x faster: device
        eng.process_batch(_port_request(_big_request()))
        assert TorchEngine.sticky_columnar_backend() == "device"
    assert _replies(eng, [window]) == want
    assert eng.stats().get("n_sharded_launches", 0) == (1 if pool else 0)
    _fake_device_cols(eng)
    charged = {k: e.nbytes for k, e in eng._colcache._entries.items()}
    k1 = eng.stats()["n_kernel_predicate"]
    TorchEngine.reset_columnar_probe()
    _stub_legs(monkeypatch, 0.001, 0.01)  # the device 10x slower: host
    eng.process_batch(_port_request(_big_request()))  # in the pool case a hit
    assert TorchEngine.sticky_columnar_backend() == "host"
    assert _replies(eng, [window]) == want
    st = eng.stats()
    assert st["n_kernel_predicate"] == k1 and st["n_colcache_hit"] >= (3 if pool else 1)
    entries = eng._colcache._entries
    assert all(e.cols_dev is None and e.nbytes == e._measure() for e in entries.values())
    assert charged and all(entries[k].nbytes < was for k, was in charged.items())
    assert st["colcache"]["bytes"] == sum(e.nbytes for e in entries.values())


def test_pool_gate_keeps_the_first_launch_inline_until_a_verdict(monkeypatch):
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)
    calls = _stub_legs(monkeypatch, 0.001, 0.01)
    eng = _enable(_engine(probing=True, host_workers=2, host_pool_probe=False), PROJ_SPEC)
    req = _big_request()
    want = _replies(_enable(_ref_engine(force_mode="columnar_host"), PROJ_SPEC), [req, req])
    got = _replies(eng, [req])
    st = eng.stats()
    assert calls == [2048] and "n_sharded_launches" not in st and st["n_host_predicate"] == 1
    got += _replies(eng, [req])
    assert got == want
    st = eng.stats()
    assert st["n_sharded_launches"] == 1 and st["n_host_predicate"] == 3
    assert "n_kernel_predicate" not in st


def test_the_probes_device_leg_is_the_plain_launch_and_keeps_no_stats():
    eng = _enable(_engine(probing=True), PROJ_SPEC)
    req = _big_request()
    want = _replies(_enable(_ref_engine(force_mode="columnar_device"), PROJ_SPEC), [req])
    assert _replies(eng, [req]) == want
    st = eng.stats()
    backend = st["columnar_backend"]
    assert backend in ("host", "device") and st["columnar_probe"]["t_device_s"] > 0
    # the probe's two launches are not the engine's
    assert st.get("n_kernel_predicate", 0) == (1 if backend == "device" else 0)
    assert st.get("n_host_predicate", 0) == (1 if backend == "host" else 0)


# ------------------------------------------------------------ departures
@pytest.mark.parametrize("policy", [ErrorPolicy.skip_on_failure, ErrorPolicy.deregister])
def test_departure_a_a_failed_probe_leg_raises_into_the_policy(policy):
    """A dispatch fault in the probe's device leg: one
    coproc_failures_total{domain="columnar_probe"} sample, the script's
    error policy, no verdict; the next launch probes again."""
    eng = _enable(_engine(probing=True), PROJ_SPEC, policy)
    honey_badger.enable()
    honey_badger.set_exception("coproc", faults.DEVICE_DISPATCH, count=1)
    before, dispatch = _failures("columnar_probe"), _failures(faults.DEVICE_DISPATCH)
    reply = eng.process_batch(_port_request(_big_request()))
    # one sample, under the probe's domain only
    assert _failures("columnar_probe") == before + 1
    assert _failures(faults.DEVICE_DISPATCH) == dispatch
    st = eng.stats()
    assert st["n_failures_dispatch"] == 1 and "columnar_backend" not in st
    assert TorchEngine.sticky_columnar_backend() is None
    assert not _journal(governor.COLUMNAR_BACKEND)
    if policy == ErrorPolicy.deregister:
        assert reply.deregistered == [1] and eng.heartbeat() == 0
        _enable(eng, PROJ_SPEC)
    else:
        assert all(not it.batches for it in reply.items)
    eng.process_batch(_port_request(_big_request()))
    assert TorchEngine.sticky_columnar_backend() in ("host", "device")
    assert len(_journal(governor.COLUMNAR_BACKEND)) == 1


def test_departure_a_an_erring_or_wedged_leg_publishes_no_host_verdict(monkeypatch):
    eng = _enable(_engine(probing=True), PROJ_SPEC)

    def erring(self, plan, cols):
        raise RuntimeError("predicate kernel launch failed")

    monkeypatch.setattr(TorchEngine, "_probe_device_leg", erring)
    before = _failures("columnar_probe")
    eng.process_batch(_port_request(_big_request()))
    assert _failures("columnar_probe") == before + 1
    assert TorchEngine.sticky_columnar_backend() is None
    # a leg past its deadline, on a worker as on a card
    release = threading.Event()

    def wedged(self, plan, cols):
        release.wait(10)
        return 0.0

    monkeypatch.setattr(TorchEngine, "_probe_device_leg", wedged)
    monkeypatch.setattr(engine_mod, "_PROBE_DEVICE_TIMEOUT_S", 0.05)
    eng._leg_deadlines = True
    try:
        eng.process_batch(_port_request(_big_request()))
    finally:
        release.set()
    assert _failures("columnar_probe") == before + 2
    assert TorchEngine.sticky_columnar_backend() is None
    assert eng.stats()["n_failures_dispatch"] == 2
    deadline = time.monotonic() + 10
    while faults.fetch_pool_stats()["free"] < faults.fetch_pool_stats()["created"]:
        assert time.monotonic() < deadline
        time.sleep(0.01)


def test_departure_b_cpu_engines_never_run_or_read_the_probe(monkeypatch):
    def no_probe(self, plan, cols):
        raise AssertionError("a CPU engine probed")

    monkeypatch.setattr(TorchEngine, "_probe_columnar_backend", no_probe)
    with TorchEngine._columnar_probe_lock:
        TorchEngine._columnar_backend = "host"
        TorchEngine._columnar_probe = {"chosen": "host"}
    eng = _enable(_engine(), PROJ_SPEC)
    assert eng._backend_probe is False
    req = _big_request()
    want = _replies(_enable(_ref_engine(force_mode="columnar_device"), PROJ_SPEC), [req])
    assert _replies(eng, [req]) == want
    st = eng.stats()
    assert st["n_kernel_predicate"] == 1 and "n_host_predicate" not in st
    assert "columnar_backend" not in st and "columnar_probe" not in st
    TorchEngine.reset_columnar_probe()
    eng.process_batch(_port_request(req))
    assert TorchEngine.sticky_columnar_backend() is None


@pytest.mark.parametrize("lane", ["mesh", "mesh_blocks", "single"])
def test_departure_c_the_probe_runs_only_on_the_single_card_leg(lane, monkeypatch):
    calls = _stub_legs(monkeypatch, 0.001, 0.0001)
    mesh = partition_mesh(4, device="cpu")
    eng = _enable(_engine(probing=True, mesh=mesh, mesh_probe=lane == "single"), PROJ_SPEC)
    # one batch (1100 records) cannot be range-sharded: a pinned mesh runs it
    # as row blocks, a probing one sends it down the single-card leg
    req = _big_request() if lane == "mesh" else _request(n_items=1, records=1100, pad=10)
    want = _replies(_enable(_ref_engine(force_mode="columnar_device"), PROJ_SPEC), [req])
    assert _replies(eng, [req]) == want
    st = eng.stats()
    if lane == "single":
        assert calls == [2048] and st["columnar_backend"] == "device"
        assert "n_mesh_launches" not in st and st["n_kernel_predicate"] == 1
    else:
        assert not calls and TorchEngine.sticky_columnar_backend() is None
        assert st["n_mesh_launches"] == 1


# ------------------------------------------------------------ journal records
def test_lz4_measure_probe_journals_its_decision():
    res = L.measure_probe(n_records=8, record_size=128, reps=1, device="cpu")
    [entry] = _journal(governor.DEVICE_LZ4)
    assert entry["verdict"] == res["decision"] and entry["inputs"] == res
    assert entry["reason"] == (
        f"device block decode {res['device_mb_s']} MB/s vs host liblz4 {res['host_mb_s']} MB/s "
        f"(ratio {res['ratio_device_vs_host']}x)")
    ref = _ref_record(lambda: ref_lz4.measure_probe(n_records=8, record_size=128, reps=1))
    assert ref[0] == entry["domain"] and _template(ref[2]) == _template(entry["reason"])
    assert set(ref[3]) <= set(entry["inputs"])  # the port's probe has more keys


def _ref_record(run):
    """The one record the reference journals while ``run`` runs, as
    (domain, verdict, reason, inputs)."""
    seen = []
    real = ref_gov.journal_record

    def catch(domain, verdict, reason, inputs=None, *a, **kw):
        seen.append((domain, verdict, reason, inputs))
        return real(domain, verdict, reason, inputs, *a, **kw)

    ref_gov.journal_record = catch
    try:
        run()
    finally:
        ref_gov.journal_record = real
    [rec] = seen
    return rec


def test_raft_calibration_journals_its_verdict():
    rng = np.random.default_rng(11)
    regions = [rng.bytes(int(rng.integers(100, 300))) for _ in range(DP.PROBE_MIN_ROWS + 8)]
    claimed = np.array([crc32c(x) for x in regions], np.uint32)
    plane = DP.RaftDevicePlane(probe=True, device="cpu")
    plane.validate(regions, claimed)
    probe = plane.stats()["probe"]
    [entry] = _journal(governor.MESH)
    assert entry["verdict"] == probe["chosen"] and entry["inputs"] == probe
    ref = _ref_record(lambda: RDP.RaftDevicePlane(probe=True).validate(regions, claimed))
    assert ref[0] == entry["domain"] and set(ref[3]) == set(probe)
    assert _template(ref[2]) == _template(entry["reason"])
    # a plane that does not probe journals nothing
    DP.RaftDevicePlane(probe=False, device="cpu").validate(regions, claimed)
    assert len(_journal(governor.MESH)) == 1
