"""The port's sandboxed python transforms (redpanda_tpu_torch/coproc/sandbox.py)
and the engine's python escape hatches against the JAX package's.

``validate_source`` must accept and reject exactly what the JAX package's
does (the same reason) over every source of tests/test_sandbox.py, its
malicious list and more edge sources; ``compile_transform``'s outputs and
failures must equal the JAX package's on seeded records; the operand guards
must refuse the same operands. The deadline and post-hoc layers are driven
with the deadline shrunk, as tests/test_sandbox.py does. Through the engine,
``enable_py_transform`` and ``enable_py_sandboxed`` must give the JAX
engine's response codes and byte-identical replies under skip_on_failure and
deregister, inline and on the host pool; a guard kill under deregister
unloads the script and journals one TREND kill.
"""

from __future__ import annotations

import ast
import json
import os
import random
import time

import numpy as np
import pytest

from redpanda_tpu.coproc import TpuEngine
from redpanda_tpu.coproc import sandbox as ref_sandbox
from redpanda_tpu.coproc.engine import ErrorPolicy as RefErrorPolicy
from redpanda_tpu.coproc.engine import ProcessBatchItem, ProcessBatchRequest
from redpanda_tpu.finjector import honey_badger as ref_badger
from redpanda_tpu.models import NTP, Record, RecordBatch
from redpanda_tpu.models.record import Compression
from redpanda_tpu_torch.coproc import engine as engine_mod
from redpanda_tpu_torch.coproc import faults, governor, sandbox
from redpanda_tpu_torch.coproc.column_plan import HostPlan, plan_spec
from redpanda_tpu_torch.coproc.engine import EnableResponseCode, ErrorPolicy, TorchEngine
from redpanda_tpu_torch.finjector import honey_badger
from redpanda_tpu_torch.ops.transforms import TransformSpec
from test_sandbox import GOOD, MALICIOUS
from test_torch_faults import _disarm
from test_torch_structural import _port_request, _reply_bytes

HERE = os.path.dirname(os.path.abspath(__file__))

_engines: list = []


@pytest.fixture(autouse=True)
def _quiet():
    governor.reset_journal()
    faults.reset_warned()
    yield
    _disarm(honey_badger)
    _disarm(ref_badger)
    governor.reset_journal()
    while _engines:
        _engines.pop().shutdown()


def _reference_sources() -> list[str]:
    """Every string constant of tests/test_sandbox.py that defines or
    names ``transform`` (its malicious list, its guard and engine cases)."""
    with open(os.path.join(HERE, "test_sandbox.py"), encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) and \
                "transform" in node.value and "def " in node.value:
            out.append(node.value)
        elif isinstance(node, ast.BinOp):  # concatenated sources
            try:
                val = ast.literal_eval(node)
            except ValueError:
                continue
            if isinstance(val, str) and "def transform" in val:
                out.append(val)
    return out


EXTRA = [
    # what the validator must keep accepting
    "def transform(value):\n    return value\n",
    "def transform(value):\n    try:\n        x = json_loads(value)\n"
    "    except ValueError:\n        return None\n    return json_dumps(x)\n",
    "def transform(value):\n    return f'{len(value)}:{value.decode()!r}'\n",
    "def transform(value):\n    d = {}\n    d.setdefault('a', []).append(1)\n    return str(d)\n",
    "def transform(value):\n    return b''.join(sorted({value, b'z'}))\n",
    "def transform(value):\n    del value\n    return None\n",
    # and keep rejecting
    "def transform(value):\n    return f'{value:{value}}'\n",
    "def transform(value):\n    with open('x') as f:\n        return f\n",
    "def transform(value):\n    nonlocal value\n    return value\n",
    "def transform(value):\n    class A:\n        pass\n    return value\n",
    "@dec\ndef transform(value):\n    return value\n",
    "def transform(value=1):\n    return value\n",
    "def transform(*, value):\n    return value\n",
    "def transform(value, /):\n    return value\n",
    "def transform(value):\n    return value._x\n",
    "def transform(value):\n    return value.__len__()\n",
    "def transform(value):\n    return __sbx_pow__(2, 3)\n",
    "def transform(value):\n    return type(value)\n",
    "def transform(value):\n    assert value\n    return value\n",
    "def transform(value):\n    try:\n        pass\n    except (ValueError, BaseException):\n"
    "        pass\n    return value\n",
    "def transform(value):\n    return [x async for x in value]\n",
    "def transform(value):\n    return " + "(" * 300 + "1" + ")" * 300 + "\n",
    "def transform(value):\n    return " + "-" * 60000 + "1\n",
    "def transform(value):\n    return 1\n" + "#" * (64 * 1024),
    "not python at all (",
    "",
]

SOURCES = MALICIOUS + [GOOD] + _reference_sources() + EXTRA


def _verdict(mod, src):
    try:
        return "ok", ast.dump(mod.validate_source(src))
    except mod.SandboxViolation as exc:
        return "violation", str(exc)


@pytest.mark.parametrize("i", range(len(SOURCES)))
def test_validate_source_agrees_with_the_reference(i):
    assert _verdict(sandbox, SOURCES[i]) == _verdict(ref_sandbox, SOURCES[i])


def test_the_source_list_covers_both_verdicts():
    verdicts = [_verdict(sandbox, s)[0] for s in SOURCES]
    assert verdicts.count("ok") >= 10 and verdicts.count("violation") >= len(MALICIOUS)


def _values(seed: int, n: int = 48) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        doc = {"level": ["error", "info", "warn"][int(rng.integers(0, 3))],
               "code": int(rng.integers(-50, 50)), "msg": "m" * int(rng.integers(0, 12))}
        v = json.dumps(doc, separators=(",", ":")).encode()
        if i % 11 == 3:
            v = b"not json"
        elif i % 13 == 5:
            v = b""
        out.append(v)
    return out


def _outcome(fn, value):
    try:
        return "ok", fn(value)
    except BaseException as exc:  # noqa: BLE001 - the class and text are compared
        return type(exc).__name__, str(exc)


@pytest.mark.parametrize("seed", range(2))
def test_compiled_transforms_agree_with_the_reference(seed, monkeypatch):
    # a shared deadline far from any record, so that no machine's load decides
    monkeypatch.setattr(sandbox, "EXEC_WALL_DEADLINE_S", 30.0)
    monkeypatch.setattr(ref_sandbox, "EXEC_WALL_DEADLINE_S", 30.0)
    values = _values(seed)
    n = 0
    for src in SOURCES:
        if _verdict(ref_sandbox, src)[0] != "ok" or "10 ** 10 ** 8" in src:
            continue
        got, want = _outcome(sandbox.compile_transform, src), _outcome(
            ref_sandbox.compile_transform, src)
        if want[0] != "ok":  # valid, yet refused by compile(): both alike
            assert (got[0], got[1]) == (want[0], want[1]), src
            continue
        got, want = got[1], want[1]
        # the runaway and slow sources take a second or so a record: two each
        for v in values[:2] if "while" in src or "range" in src else values:
            assert _outcome(got, v) == _outcome(want, v), (src, v)
        n += 1
    assert n >= 10


def test_guards_refuse_the_same_operands():
    rng = random.Random(5)
    ints = [0, 1, -1, 2, 3, 10, -7, 2**20, 1 << 21, (1 << 21) + 1, 2**40, 10**7, -(2**30)]
    ints += [rng.randrange(-(1 << 22), 1 << 22) for _ in range(12)]
    seqs = ["ab", b"xy", [0], (1, 2), "", bytearray(b"z")]
    cases = []
    for a in ints:
        for b in ints:
            if abs(b) <= 1 << 22:
                cases.append(("_guard_lshift", (a, b)))
                cases.append(("_guard_mult", (a, b)))
            if 0 <= b < 64 or b > 1 << 21:  # results that are cheap, or refused
                cases.append(("_guard_pow", (a, b)))
    for s in seqs:
        for n in (0, 3, 1 << 23, 1 << 25, -2):
            cases += [("_guard_mult", (s, n)), ("_guard_mult", (n, s))]
    for args in [(5,), (1 << 24,), ((1 << 24) + 1,), (0, 1 << 25, 2), (10, 0, -1), (1 << 40,)]:
        cases.append(("_guard_range", args))
    refused = 0
    for name, args in cases:
        got = _outcome(lambda a, f=getattr(sandbox, name): f(*a), args)
        want = _outcome(lambda a, f=getattr(ref_sandbox, name): f(*a), args)
        assert got == want, (name, args)
        refused += want[0] == "SandboxDeadlineExceeded"
    assert refused >= 20


def _trend_kills() -> list:
    return [e for e in governor.journal.entries(domain=governor.TREND)
            if e["verdict"] == "watchdog_kill"]


def test_a_guard_kills_the_single_opcode_burn_before_it_starts():
    fn = sandbox.compile_transform(
        "def transform(value):\n    x = 10 ** 10 ** 8\n    return value\n", script_id=901)
    t0 = time.monotonic()
    with pytest.raises(sandbox.SandboxRuntimeError, match="bits"):
        fn(b"x")
    assert time.monotonic() - t0 < 0.5
    with pytest.raises(sandbox.SandboxRuntimeError):
        fn(b"x")
    (kill,) = _trend_kills()
    assert kill["inputs"]["script_id"] == 901 and kill["inputs"]["layer"] == "guard"
    assert kill["config"]["deadline_s"] == sandbox.EXEC_WALL_DEADLINE_S


def test_the_deadline_layer_kills_a_slow_loop(monkeypatch):
    monkeypatch.setattr(sandbox, "EXEC_WALL_DEADLINE_S", 0.05)
    fn = sandbox.compile_transform(
        "def transform(value):\n"
        "    n = 0\n"
        "    while n < 50000:\n"
        "        s = 'x' * 65536\n"
        "        n = n + 1\n"
        "    return value\n")
    with pytest.raises(sandbox.SandboxRuntimeError, match="wall-clock deadline"):
        fn(b"x")
    (kill,) = _trend_kills()
    assert kill["inputs"]["layer"] == "deadline"


def test_the_post_hoc_layer_fails_a_residual_overrun(monkeypatch):
    """A single permitted call on the return line overruns the shrunk
    deadline: nothing interrupts it, and the record fails after it returns."""
    monkeypatch.setattr(sandbox, "EXEC_WALL_DEADLINE_S", 0.01)
    fn = sandbox.compile_transform("def transform(value):\n    return str(sum(range(10000000)))\n")
    t0 = time.monotonic()
    with pytest.raises(sandbox.SandboxRuntimeError, match="deadline"):
        fn(b"x")
    assert time.monotonic() - t0 > 0.01  # it ran to its end first
    (kill,) = _trend_kills()
    assert kill["inputs"]["layer"] == "post_hoc"


def test_the_budget_kill_is_not_swallowed_by_user_code():
    fn = sandbox.compile_transform(
        "def transform(value):\n"
        "    hits = 0\n"
        "    while hits < 3:\n"
        "        try:\n"
        "            n = 0\n"
        "            while True:\n"
        "                n = n + 1\n"
        "        except Exception:\n"
        "            hits = hits + 1\n"
        "    return value\n")
    with pytest.raises(sandbox.SandboxRuntimeError):
        fn(b"x")
    assert issubclass(sandbox.SandboxBudgetExceeded, BaseException)
    assert not issubclass(sandbox.SandboxBudgetExceeded, Exception)
    assert not issubclass(sandbox.SandboxDeadlineExceeded, Exception)


def test_the_sandbox_globals_hold_no_builtins():
    fn = sandbox.compile_transform(GOOD)
    inner = [c.cell_contents for c in fn.__closure__
             if getattr(c.cell_contents, "__name__", "") == "transform"][0]
    assert inner.__globals__["__builtins__"] == {}
    assert "open" not in inner.__globals__ and "getattr" not in inner.__globals__


def test_plan_spec_makes_a_python_host_plan():
    fn = sandbox.compile_transform(GOOD)
    plan = plan_spec(TransformSpec(name="py:x"), py_fn=fn)
    assert isinstance(plan, HostPlan) and plan.kind == "python" and plan.fn is fn
    assert plan.mode == "host" and plan.byte_identity is False
    assert plan_spec(TransformSpec()).fn is None


# ------------------------------------------------------------ the engine
CRASHY = ("def transform(value):\n"
          "    if value == b'bad':\n"
          "        raise ValueError('nope')\n"
          "    if value == b'name':\n"
          "        return undefined_name\n"
          "    return value.upper()\n")
KEEP_ERRORS = ("def transform(value):\n"
               "    if b'\"error\"' not in value:\n"
               "        return None\n"
               "    return value.upper()\n")
BURN = "def transform(value):\n    x = 10 ** 10 ** 8\n    return value\n"


def _request(seed: int, script_id: int, special=()) -> ProcessBatchRequest:
    """Eight partitions of seeded JSON records (one batch zstd-compressed,
    one empty batch, null and empty values), plus ``special`` values in
    partition 0."""
    items = []
    for p in range(8):
        vals = _values(seed * 100 + p, n=24)
        recs = [Record(offset_delta=i, timestamp_delta=i, value=None if i == 7 else v)
                for i, v in enumerate(vals)]
        if p == 0:
            recs += [Record(offset_delta=len(recs) + j, value=v) for j, v in enumerate(special)]
        batches = [RecordBatch.build(recs, base_offset=100 * p, first_timestamp=1000,
                                     compression=Compression.zstd if p == 3 else Compression.none)]
        if p == 5:
            batches.append(RecordBatch.build([], base_offset=999))
        items.append(ProcessBatchItem(script_id, NTP.kafka("t", p), batches))
    return ProcessBatchRequest(items)


def _engines_pair(workers: int):
    """The JAX engine inline (its pool lane shares one zstd context across
    threads and fails at the seed) and the port's engine on ``workers``."""
    ref = TpuEngine(row_stride=512, force_mode="columnar_host", host_workers=0)
    got = TorchEngine(device="cpu", row_stride=512, host_workers=workers, host_pool_probe=False)
    _engines.extend([ref, got])
    return ref, got


CASES = {
    # name: (source, values of partition 0, policy)
    "keep_errors": (KEEP_ERRORS, (), "skip_on_failure"),
    "crashy_skip": (CRASHY, (b"bad", b"aa", b"name"), "skip_on_failure"),
    "crashy_deregister": (CRASHY, (b"aa", b"name"), "deregister"),
    "burn_deregister": (BURN, (), "deregister"),
    "burn_skip": (BURN, (), "skip_on_failure"),
}


@pytest.mark.parametrize("workers", [0, 2], ids=["inline", "pool"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_sandboxed_replies_match_the_reference(case, workers, monkeypatch):
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)
    src, special, policy = CASES[case]
    ref, got = _engines_pair(workers)
    assert got.enable_py_sandboxed(4, src, ("t",), ErrorPolicy[policy]) == \
        ref.enable_py_sandboxed(4, src, ("t",), RefErrorPolicy[policy]) == \
        EnableResponseCode.success
    for seed in range(2):
        req = _request(seed, 4, special)
        want = _reply_bytes(ref.process_batch(req))
        assert _reply_bytes(got.process_batch(_port_request(req))) == want
        assert got.heartbeat() == ref.heartbeat()
    if policy == "deregister":
        assert want[1] == [] and got.heartbeat() == 0  # unloaded by the first round
    elif case == "keep_errors":
        assert any(b for _, _, b in want[0])
    if workers and case == "keep_errors":
        assert got.stats().get("n_sharded_launches", 0) >= 1


def test_py_transform_replies_match_the_reference():
    """An in-process callable: bytes, str and None returns, and a raising
    record under skip_on_failure."""

    def fn(value):
        if value.startswith(b"not"):
            raise RuntimeError("boom")
        if b"warn" in value:
            return None
        return value.decode()[::-1] if b"info" in value else value + b"!"

    ref, got = _engines_pair(0)
    assert got.enable_py_transform(2, fn, ("t",)) == ref.enable_py_transform(2, fn, ("t",)) == 0
    req = _request(3, 2)
    assert _reply_bytes(got.process_batch(_port_request(req))) == _reply_bytes(
        ref.process_batch(req))
    assert got.scripts[2].spec.name == "py:fn" and got.scripts[2].policy == ErrorPolicy(0)


def test_enable_response_codes_match_the_reference():
    ref, got = _engines_pair(0)
    calls = [
        (1, MALICIOUS[0], ("t",)),
        (2, GOOD, ("t",)),
        (2, GOOD, ("t",)),  # already exists
        (3, GOOD, ()),  # no topics
        (4, "x = (", ("t",)),
        (5, CRASHY, ("t",)),
    ]
    for sid, src, topics in calls:
        assert got.enable_py_sandboxed(sid, src, topics) == ref.enable_py_sandboxed(
            sid, src, topics), (sid, src)
    assert got.heartbeat() == ref.heartbeat() == 2
    assert got.enable_py_transform(2, len, ("t",)) == ref.enable_py_transform(2, len, ("t",)) \
        == EnableResponseCode.script_id_already_exists
    assert got.enable_py_transform(9, len, ()) == EnableResponseCode.script_contains_no_topics


def test_a_refused_compile_is_counted_under_sandbox_compile():
    from redpanda_tpu_torch.observability import probes

    _, got = _engines_pair(0)
    before = probes.coproc_failure_counter(faults.SANDBOX_COMPILE, "SandboxViolation").value
    assert got.enable_py_sandboxed(1, MALICIOUS[0], ("t",)) == EnableResponseCode.internal_error
    assert probes.coproc_failure_counter(faults.SANDBOX_COMPILE, "SandboxViolation").value == \
        before + 1
    honey_badger.enable()
    honey_badger.set_exception(faults.MODULE, faults.SANDBOX_COMPILE, count=1)
    injected = probes.coproc_failure_counter(faults.SANDBOX_COMPILE, "injected").value
    assert got.enable_py_sandboxed(2, GOOD, ("t",)) == EnableResponseCode.internal_error
    assert probes.coproc_failure_counter(faults.SANDBOX_COMPILE, "injected").value == \
        injected + 1
    assert got.enable_py_sandboxed(2, GOOD, ("t",)) == EnableResponseCode.success
    assert got.heartbeat() == 1


def test_a_guard_kill_under_deregister_unloads_the_script_and_journals_once():
    _, got = _engines_pair(0)
    assert got.enable_py_sandboxed(7, BURN, ("t",), ErrorPolicy.deregister) == 0
    req = ProcessBatchRequest([ProcessBatchItem(
        7, NTP.kafka("t", 0), [RecordBatch.build([Record(offset_delta=0, value=b"x")])])])
    reply = got.process_batch(_port_request(req))
    assert reply.deregistered == [7] and reply.items == [] and got.heartbeat() == 0
    (kill,) = _trend_kills()
    assert kill["inputs"]["script_id"] == 7 and kill["inputs"]["layer"] == "guard"
    st = got.stats()
    assert st["n_failures_rebuild"] == 1 and "n_kernel_predicate" not in st


def _pooled_request(script_id: int, per_part: int = 264) -> ProcessBatchRequest:
    """Eight partitions of short values, more records in all than the pool
    shards at (``_SHARD_MIN_ROWS``): every value is distinct, and every
    eleventh starts with ``bad``."""
    items = []
    for p in range(8):
        recs = [Record(offset_delta=i, value=(b"bad-" if (p * per_part + i) % 11 == 0
                                               else b"ok-") + b"%d.%d" % (p, i))
                for i in range(per_part)]
        items.append(ProcessBatchItem(script_id, NTP.kafka("t", p),
                                      [RecordBatch.build(recs, base_offset=1000 * p)]))
    req = ProcessBatchRequest(items)
    assert sum(it.batches[0].header.record_count for it in items) > engine_mod._SHARD_MIN_ROWS
    return req


def _counting(calls: list):
    def fn(value):
        calls.append(bytes(value))
        if value.startswith(b"bad"):
            raise RuntimeError("boom")
        return value.upper()

    return fn


def _assert_pool_measured(got):
    """The pool decision came from a measured probe, never from a failure."""
    st = got.stats()
    assert "n_failures_pool_calibration" not in st
    assert got._pool_decision in ("sharded", "inline")
    assert st["host_pool_probe"]["chosen"] == got._pool_decision
    assert not [e for e in governor.journal.entries(domain=governor.HOST_POOL)
                if "FAILED" in e["reason"]]


def test_a_probed_pool_runs_a_python_script_once_a_record():
    """On a default pooled engine (the pool probed), the first shardable
    launch of a python plan calibrates the pool by timing its explode: the
    script runs once a record, and each failing record counts once under
    ``host_plan``."""
    from redpanda_tpu_torch.observability import probes

    ref = TpuEngine(row_stride=512, force_mode="columnar_host", host_workers=0)
    got = TorchEngine(device="cpu", row_stride=512, host_workers=2)
    _engines.extend([ref, got])
    ref_calls, calls = [], []
    assert ref.enable_py_transform(3, _counting(ref_calls), ("t",)) == 0
    assert got.enable_py_transform(3, _counting(calls), ("t",)) == 0
    req = _pooled_request(3)
    before = probes.coproc_failure_counter("host_plan", "RuntimeError").value
    assert _reply_bytes(got.process_batch(_port_request(req))) == _reply_bytes(
        ref.process_batch(req))
    values = [r.value for it in req.items for r in it.batches[0].records()]
    assert sorted(calls) == sorted(values) == sorted(ref_calls)
    bad = sum(v.startswith(b"bad") for v in values)
    assert probes.coproc_failure_counter("host_plan", "RuntimeError").value == before + bad
    _assert_pool_measured(got)


@pytest.mark.parametrize("how", ["py_transform", "sandboxed_guard"])
def test_a_deregister_script_failure_on_a_probed_pool_stays_the_scripts(how):
    """Under deregister a failing script on a default pooled engine unloads
    that script alone: the pool's calibration never runs it, so its failure
    is no ``pool_calibration`` failure and leaves the pool's measured
    decision, and a guard kill is journaled once."""
    got = TorchEngine(device="cpu", row_stride=512, host_workers=2)
    _engines.append(got)
    calls = []
    if how == "py_transform":
        code = got.enable_py_transform(5, _counting(calls), ("t",), ErrorPolicy.deregister)
    else:
        code = got.enable_py_sandboxed(5, BURN, ("t",), ErrorPolicy.deregister)
    assert code == EnableResponseCode.success
    assert got.enable_py_transform(6, lambda v: v + b"!", ("t",)) == EnableResponseCode.success
    reply = got.process_batch(_port_request(_pooled_request(5)))
    assert reply.deregistered == [5] and reply.items == [] and got.heartbeat() == 1
    _assert_pool_measured(got)
    if how == "py_transform":
        assert calls == [b"bad-0.0"]  # the launch's first record, once
    else:
        (kill,) = _trend_kills()
        assert kill["inputs"]["script_id"] == 5
    # the other script still runs, on the same pool decision
    ok = got.process_batch(_port_request(_pooled_request(6)))
    assert ok.deregistered == [] and len(ok.items) == 8
    _assert_pool_measured(got)
