"""The port's lockwatch (redpanda_tpu_torch/coproc/lockwatch.py) against the
JAX package's, and the port's engine under it.

Off, ``wrap`` is the identity and a fresh ``TorchEngine`` holds raw locks.
On, the parity workload matrix of tests/test_lockwatch.py (every engine
mode, the pool on and off, each coproc probe point faulted) runs through
``TorchEngine(device="cpu")``: its replies must be byte-identical to
``TpuEngine``'s on the same seeded requests, and every lock-order edge it
observes must be in pandalint's static acquisition graph over
``redpanda_tpu_torch/`` and, where both ends of the edge have a counterpart
in the JAX package (``TorchEngine`` for ``TpuEngine``, ``MeshRunner._lock``
for ``MeshRunner._decision_lock``), among the edges that the JAX package's
recorder observes on the same workload.

The port's first matrix engine runs as on a card: the mask-harvest thread
on and each device leg on an abandonable fetch worker (``_leg_deadlines``),
so that those threads' lock paths are recorded too. Its fault round arms
each probe point once for one shot, then persistently. Where the JAX engine
answers a persistently failing device leg on its host path, the port
answers with the script's error policy (no host answer stands in for a
kernel: tests/test_torch_faults.py): those persistent rounds end in empty
items here, where the JAX engine's keep their records.
"""

from __future__ import annotations

import ast
import json
import os
import re
import threading

import pytest

from redpanda_tpu.coproc import TpuEngine
from redpanda_tpu.coproc import engine as ref_engine_mod
from redpanda_tpu.coproc import faults as ref_faults
from redpanda_tpu.coproc import lockwatch as ref_lockwatch
from redpanda_tpu.finjector import honey_badger as ref_badger
from redpanda_tpu.ops.exprs import field
from redpanda_tpu.ops.transforms import Int, Str, filter_contains, identity, map_project, where
from redpanda_tpu_torch.coproc import engine as engine_mod
from redpanda_tpu_torch.coproc import faults, governor, lockwatch
from redpanda_tpu_torch.coproc.engine import TorchEngine
from redpanda_tpu_torch.finjector import honey_badger
from redpanda_tpu_torch.observability import probes
from test_lockwatch import _workload
from test_torch_faults import _disarm
from test_torch_structural import _port_request, _reply_bytes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROJ = where(field("level") == "error") | map_project(Int("code"), Str("msg", 16))
# tests/test_lockwatch.py's matrix: (spec, force_mode, host workers), and the
# payload spec inline. The JAX engine's pool lane transforms payload shards
# on the host, so only its inline payload lane fetches a device result
# under the launch lock, as the port's payload lanes (one K4 launch a
# launch, pooled or not) both do.
MATRIX = [
    (PROJ, "columnar_device", 4),
    (PROJ, "columnar_host", 4),
    (filter_contains(b"error"), None, 4),
    (identity(), None, 0),
    (filter_contains(b"error"), None, 0),
]
PROBES = (faults.DEVICE_DISPATCH, faults.MASK_FETCH, faults.HARVEST, faults.SHARD_WORKER)

_engines: list = []


@pytest.fixture(autouse=True)
def _quiet():
    """Both recorders, both honey badgers and the port's journal are
    process-global: every test starts and ends with them off and empty."""
    saved = (honey_badger.wedge_max_s, honey_badger.delay_ms,
             ref_badger.wedge_max_s, ref_badger.delay_ms)
    lockwatch.disable()
    ref_lockwatch.disable()
    lockwatch.reset_edges()
    governor.reset_journal()
    yield
    lockwatch.disable()
    ref_lockwatch.disable()
    lockwatch.reset_edges()
    _disarm(honey_badger)
    _disarm(ref_badger)
    (honey_badger.wedge_max_s, honey_badger.delay_ms,
     ref_badger.wedge_max_s, ref_badger.delay_ms) = saved
    governor.reset_journal()
    while _engines:
        _engines.pop().shutdown()


def _knobs(force_mode, workers, deadline_ms=60) -> dict:
    """tests/test_lockwatch.py's engine knobs. The port's engines take a
    longer deadline: a leg that overran 60 ms on a loaded machine would end
    in the policy here, where the JAX engine answers on its host path."""
    return dict(row_stride=256, compress_threshold=10**9, force_mode=force_mode,
                host_workers=workers, host_pool_probe=False, device_deadline_ms=deadline_ms,
                adaptive_deadline=False, launch_retries=1, retry_backoff_ms=1,
                breaker_threshold=10_000)


PORT_DEADLINE_MS = 10_000


def _enable(eng, spec) -> None:
    assert eng.enable_coprocessors([(1, spec.to_json(), ("orders",))]) == [0]


def static_edge_set() -> set[tuple[str, str]]:
    """pandalint's lock-order graph over redpanda_tpu_torch/, read-only."""
    from tools.pandalint.affinity import Program
    from tools.pandalint.engine import iter_python_files
    from tools.pandalint.lockgraph import LockGraph

    mods = []
    for p in iter_python_files([os.path.join(REPO, "redpanda_tpu_torch")]):
        rel = os.path.relpath(p, REPO).replace(os.sep, "/")
        with open(p, encoding="utf-8", errors="replace") as fh:
            mods.append((rel, ast.parse(fh.read())))
    return LockGraph(Program(mods)).edge_set()


def reference_lock_names() -> set[str]:
    """Every lock the JAX package's recorder can name: the names its wrap
    sites pass and its swapped module locks, read from its sources."""
    names = {canonical for _m, _a, canonical in ref_lockwatch._MODULE_LOCKS}
    pat = re.compile(r'lockwatch\.wrap\(\s*threading\.Lock\(\),\s*"([^"]+)"', re.S)
    for root, _dirs, files in os.walk(os.path.join(REPO, "redpanda_tpu")):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f), encoding="utf-8") as fh:
                    names.update(pat.findall(fh.read()))
    return names


def counterpart(name: str) -> str:
    """The JAX package's name for a port lock."""
    if name.startswith("TorchEngine."):
        return "TpuEngine." + name.split(".", 1)[1]
    if name == "MeshRunner._lock":
        return "MeshRunner._decision_lock"
    return name


def _ref_run(req):
    """tests/test_lockwatch.py's matrix through TpuEngine under the JAX
    package's recorder: its clean replies, its fault round's replies and
    the edges it observed."""
    ref_lockwatch.reset_edges()
    ref_lockwatch.enable()
    saved = ref_engine_mod._SHARD_MIN_ROWS
    ref_engine_mod._SHARD_MIN_ROWS = 64
    ref_badger.wedge_max_s, ref_badger.delay_ms = 0.12, 5
    engines = []
    try:
        clean = []
        for spec, force_mode, workers in MATRIX:
            eng = TpuEngine(**_knobs(force_mode, workers))
            engines.append(eng)
            _enable(eng, spec)
            clean.append(_reply_bytes(eng.process_batch(req)))
        faulted = {}
        ref_badger.enable()
        try:
            for probe in PROBES:
                ref_badger.set_exception(ref_faults.MODULE, probe)
                try:
                    faulted[probe] = _reply_bytes(engines[0].process_batch(req))
                finally:
                    ref_badger.unset(ref_faults.MODULE, probe)
        finally:
            ref_badger.disable()
        return clean, faulted, set(ref_lockwatch.edges())
    finally:
        for eng in engines:
            eng.shutdown()
        ref_engine_mod._SHARD_MIN_ROWS = saved
        ref_lockwatch.disable()


def _port_run(req, monkeypatch) -> dict:
    """The same matrix through TorchEngine(device="cpu") under the port's
    recorder, with a one-shot and a persistent round on each probe point."""
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 64)
    honey_badger.wedge_max_s, honey_badger.delay_ms = 0.12, 5
    edges0 = probes.coproc_lockwatch_edges.value
    lockwatch.reset_edges()
    lockwatch.enable()
    try:
        clean, engines = [], []
        for k, (spec, force_mode, workers) in enumerate(MATRIX):
            eng = TorchEngine(device="cpu", **_knobs(force_mode, workers, PORT_DEADLINE_MS))
            _engines.append(eng)
            engines.append(eng)
            if k == 0:  # as on a card: the harvest thread, legs on fetch workers
                eng._harvest_async = lambda: True
                eng._leg_deadlines = True
            _enable(eng, spec)
            clean.append(_reply_bytes(eng.process_batch(req)))
        one_shot, persistent = {}, {}
        honey_badger.enable()
        try:
            for probe in PROBES:
                for count, out in ((1, one_shot), (None, persistent)):
                    honey_badger.set_exception(faults.MODULE, probe, count=count)
                    try:
                        out[probe] = _reply_bytes(engines[0].process_batch(req))
                    finally:
                        honey_badger.unset(faults.MODULE, probe)
        finally:
            honey_badger.disable()
        observed = lockwatch.edges()
        return dict(clean=clean, one_shot=one_shot, persistent=persistent, observed=observed,
                    counted=probes.coproc_lockwatch_edges.value - edges0,
                    stats=engines[0].stats(),
                    journaled={(e["inputs"]["from"], e["inputs"]["to"])
                               for e in governor.journal.entries(domain=governor.LOCKWATCH)})
    finally:
        lockwatch.disable()


@pytest.fixture(scope="module")
def ref_run():
    return _ref_run(_workload())


@pytest.fixture
def port_run(monkeypatch):
    return _port_run(_port_request(_workload()), monkeypatch)


# ------------------------------------------------------------ off = free
def test_lockwatch_off_installs_no_wrapper():
    assert not lockwatch.enabled()
    raw = threading.Lock()
    assert lockwatch.wrap(raw, "x") is raw
    eng = TorchEngine(device="cpu", host_workers=2, host_pool_probe=False)
    _engines.append(eng)
    for lock in (eng._stats_lock, eng._pool_decision_lock, eng._parse_decision_lock,
                 eng._parse_probe_run_lock, eng._leg_slots._lock, eng._arena._lock,
                 eng._host_pool._lock, eng.governor._lock, eng._breaker._lock,
                 engine_mod._mask_claim_lock, faults._pool_lock, faults._warned_lock):
        assert type(lock) is type(raw)


def test_enable_and_disable_swap_the_three_module_locks():
    originals = (engine_mod._mask_claim_lock, faults._pool_lock, faults._warned_lock)
    lockwatch.enable()
    try:
        swapped = (engine_mod._mask_claim_lock, faults._pool_lock, faults._warned_lock)
        assert all(isinstance(w, lockwatch.WatchedLock) for w in swapped)
        assert [w._lock for w in swapped] == list(originals)
        assert [w.name for w in swapped] == [
            "engine._mask_claim_lock", "faults._pool_lock", "faults._warned_lock"]
        eng = TorchEngine(device="cpu", host_workers=0)
        _engines.append(eng)
        assert isinstance(eng._stats_lock, lockwatch.WatchedLock)
        assert eng._stats_lock.name == "TorchEngine._stats_lock"
    finally:
        lockwatch.disable()
    assert (engine_mod._mask_claim_lock, faults._pool_lock, faults._warned_lock) == originals


def _script(mod, steps):
    """Drive ``steps`` (("with"|"try"|"acquire"|"release", name)) through
    ``mod``'s WatchedLock on one thread; the edges recorded."""
    locks = {}
    held = []
    mod.reset_edges()
    mod.enable()
    try:
        for op, name in steps:
            lock = locks.setdefault(name, mod.wrap(threading.Lock(), name))
            if op == "acquire":
                assert lock.acquire()
                held.append(lock)
            elif op == "try":
                if lock.acquire(blocking=False):
                    held.append(lock)
            elif op == "release":
                held.remove(lock)
                lock.release()
            elif op == "with":
                with lock:
                    pass
        for lock in reversed(held):
            lock.release()
        return mod.edges()
    finally:
        mod.disable()
        mod.reset_edges()


@pytest.mark.parametrize("seed", range(3))
def test_recorder_records_the_reference_edges_on_scripted_sequences(seed):
    import random

    rng = random.Random(seed)
    names = ["A._lock", "B._lock", "C.lock", "mod._g"]
    steps, held = [], []
    for _ in range(40):
        free = [n for n in names if n not in held]
        op = rng.choice(["acquire", "try", "with", "release"])
        if op == "release" and held:
            n = rng.choice(held)
            held.remove(n)
            steps.append(("release", n))
        elif op != "release" and free:
            n = rng.choice(free)
            if op != "with":
                held.append(n)
            steps.append((op, n))
    got = _script(lockwatch, steps)
    assert got == _script(ref_lockwatch, steps)
    assert got  # the sequence nested something


# ------------------------------------------------------------ on = analyzer verified
def test_parity_matrix_replies_match_the_reference(ref_run, port_run):
    ref_clean, ref_faulted, _ = ref_run
    assert port_run["clean"] == ref_clean
    assert all(any(b for _, _, b in items) for items, _ in ref_clean)
    for probe in PROBES:
        # one shot: retried (or degraded to the inline lane) to the clean reply
        assert port_run["one_shot"][probe] == ref_clean[0], probe
    # persistent: a shard worker's fault degrades to the inline lane, as in the
    # JAX engine; a device leg that fails on every attempt ends in the policy
    # (skip_on_failure: every item empty) where the JAX engine keeps its host
    # answer
    assert port_run["persistent"][faults.SHARD_WORKER] == ref_faulted[faults.SHARD_WORKER]
    for probe in (faults.DEVICE_DISPATCH, faults.HARVEST):
        items, dereg = port_run["persistent"][probe]
        assert dereg == [] and items and all(not b for _, _, b in items), probe
        assert any(b for _, _, b in ref_faulted[probe][0])
    # the caller's own mask fetch fires only where the harvest thread has not
    # taken the mask first: either answer is the port's
    got = port_run["persistent"][faults.MASK_FETCH]
    assert got == ref_clean[0] or all(not b for _, _, b in got[0])


def test_observed_edges_are_in_the_static_graph_journaled_and_counted(port_run):
    observed = port_run["observed"]
    assert observed, "the workload must traverse nested lock paths"
    assert any(src == "_Launch._lock" for src, _ in observed)
    assert any("_LegSlots._lock" in e or "_Pending.lock" in e for e in observed)
    st = port_run["stats"]
    assert st["lockwatch"] == {"enabled": True, "edges": len(observed)}
    assert set(observed) <= port_run["journaled"]
    assert port_run["counted"] == len(observed)
    static = static_edge_set()
    missing = [e for e in observed if e not in static]
    assert not missing, f"edges the static acquisition graph lacks: {missing}"


def test_counterpart_edges_are_observed_by_the_reference(ref_run, port_run):
    _, _, ref_edges = ref_run
    assert ref_edges
    ref_names = reference_lock_names()
    assert {"TpuEngine._stats_lock", "MeshRunner._decision_lock", "_Launch._lock"} <= ref_names
    shared = [(a, b) for a, b in port_run["observed"]
              if counterpart(a) in ref_names and counterpart(b) in ref_names]
    assert shared
    extra = [(a, b) for a, b in shared if (counterpart(a), counterpart(b)) not in ref_edges]
    assert not extra, f"edges the JAX package's recorder does not observe: {extra}"


def test_stats_carry_no_recorder_block_when_off():
    eng = TorchEngine(device="cpu", host_workers=0)
    _engines.append(eng)
    st = eng.stats()
    assert "lockwatch" not in st and "leakwatch" not in st
    json.dumps(st["governor"])  # the snapshot stays serializable
