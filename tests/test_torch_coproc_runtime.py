"""The port's coproc runtime (redpanda_tpu_torch/coproc/{wasm_event,
pacemaker,api}.py) over its standalone broker, against the JAX package's, on
the CPU.

tests/test_coproc_runtime.py's six tests run on the port's ``Broker`` with
``CoprocApi(broker, device="cpu")``. There is no ``KafkaServer`` in the
port, so the tests call ``broker.recover_topics()`` after a start, as the
JAX package's server does on its start. The deploy events' record bytes and
``parse_event``'s verdicts equal the JAX package's on the same inputs,
tampered ones among them. Then the two runtimes meet: the same produced
bytes and deploys through both give the same materialized records, the same
offsets JSON in the kvstore and the same translator state; and a data
directory that the JAX package's broker and runtime wrote and stopped opens
in the port's broker, whose runtime replays the JAX package's deploy events
and resumes from its saved offsets, processing no record twice.

Timing decides how many batches a tick reads, so no test compares how
materialized records are grouped into batches: each compares the records
(key, value, headers, in order) and checks every batch's Kafka CRC.
"""

from __future__ import annotations

import asyncio
import json
import struct

import numpy as np
import pytest

from redpanda_tpu.coproc import governor as ref_governor
from redpanda_tpu.coproc import wasm_event as ref_wasm_event
from redpanda_tpu.finjector import honey_badger as ref_badger
from redpanda_tpu.models.record import Record as RefRecord
from redpanda_tpu.models.record import RecordBatch as RefRecordBatch
from redpanda_tpu.models.record import RecordHeader as RefRecordHeader
from redpanda_tpu.resource_mgmt import budgets as ref_budgets
from redpanda_tpu_torch.cluster.topic_table import TopicConfig
from redpanda_tpu_torch.coproc import faults, governor, leakwatch, lockwatch, wasm_event
from redpanda_tpu_torch.coproc.api import CoprocApi
from redpanda_tpu_torch.coproc.engine import ProcessBatchItem, ProcessBatchRequest, TorchEngine
from redpanda_tpu_torch.coproc.pacemaker import Pacemaker
from redpanda_tpu_torch.finjector import honey_badger
from redpanda_tpu_torch.kafka.server.broker import Broker, BrokerConfig
from redpanda_tpu_torch.metrics import registry
from redpanda_tpu_torch.models.fundamental import COPROC_INTERNAL_TOPIC, NTP
from redpanda_tpu_torch.models.record import Record, RecordBatch, RecordHeader
from redpanda_tpu_torch.observability import probes
from redpanda_tpu_torch.ops.exprs import field
from redpanda_tpu_torch.ops.transforms import (
    Int,
    Str,
    filter_field_eq,
    identity,
    map_project,
    where,
)
from redpanda_tpu_torch.resource_mgmt import budgets
from redpanda_tpu_torch.storage.kvstore import KeySpace
from redpanda_tpu_torch.utils.hdr import HdrHist
from redpanda_tpu_torch.storage.log_manager import StorageApi

WAIT_S = 30.0  # a ceiling, not a pace: the -n 6 run loads the host
PAYLOAD_SPEC = filter_field_eq("level", "error") | map_project(Int("code"), Str("msg", 16))
COLUMNAR_SPEC = where(field("level") == "error") | map_project(Int("code"), Str("msg", 16))
PY_SOURCE = "def transform(value):\n    return value.upper()\n"


def _disarm(badger) -> None:
    for module, armed in list(badger.armed().items()):
        for probe in armed:
            badger.unset(module, probe)
    badger.disable()


@pytest.fixture(autouse=True)
def _clean_process_state(monkeypatch):
    """The columnar backend, the journal, the badgers, the budget plane and
    the recorders are process-wide: every test starts and ends with them
    reset. So are the device legs' latency histograms, which every
    governor's autotune reads: an earlier test's engines on the same worker
    leave enough fast samples there to grow a new engine's knobs on its
    first poll, so every test starts with them empty."""
    TorchEngine.reset_columnar_probe()
    governor.reset_journal()
    for domain in (faults.DEVICE_DISPATCH, faults.MASK_FETCH, faults.HARVEST,
                   faults.SHARD_WORKER, faults.SANDBOX_COMPILE, faults.MESH_DISPATCH):
        monkeypatch.setattr(probes.coproc_device_leg_hist(domain), "hist", HdrHist())
    yield
    TorchEngine.reset_columnar_probe()
    governor.reset_journal()
    ref_governor.reset_journal()
    _disarm(honey_badger)
    _disarm(ref_badger)
    budgets.install(None)
    ref_budgets.install(None)
    lockwatch.disable()
    leakwatch.disable()
    leakwatch.reset()


def run(coro):
    return asyncio.run(coro)


async def wait_until(pred, timeout=WAIT_S, interval=0.03, msg=""):
    deadline = asyncio.get_running_loop().time() + timeout
    while not pred():
        if asyncio.get_running_loop().time() > deadline:
            raise AssertionError(f"timeout: {msg}")
        await asyncio.sleep(interval)


async def _start(tmp_path, config=None):
    storage = await StorageApi(str(tmp_path)).start()
    broker = Broker(BrokerConfig(data_dir=str(tmp_path)), storage)
    await broker.recover_topics()  # what the JAX package's KafkaServer.start does
    api = CoprocApi(broker, config, device="cpu")
    await api.start()
    api.poll_interval_s = 0.02
    broker.coproc_api = api
    return storage, broker, api


async def _stop(storage, api):
    try:
        await api.stop()
    finally:
        await storage.stop()


def _json_records(n, level="error"):
    return [
        json.dumps(
            {"level": level if i % 2 == 0 else "info", "code": i, "msg": f"m{i}"},
            separators=(",", ":"),
        ).encode()
        for i in range(n)
    ]


async def _produce(broker, topic, partition, values):
    p = broker.get_partition(topic, partition)
    batch = RecordBatch.build([Record(value=v, offset_delta=i) for i, v in enumerate(values)])
    await p.replicate([batch], 0)


def _hwm(broker, ntp) -> int:
    p = broker.partition_manager.get(ntp)
    return p.high_watermark if p else 0


def _failures(domain: str) -> float:
    """coproc_failures_total of one domain, summed over its kinds."""
    return sum(v for k, v in registry.snapshot().items()
               if k.startswith("coproc_failures_total{") and f'domain="{domain}"' in k)


async def _records(partition) -> list:
    """Every record of a partition as (key, value, headers), in order; every
    batch must verify its Kafka CRC."""
    out, off = [], partition.start_offset
    while off < partition.high_watermark:
        batches = await partition.make_reader(off, 1 << 20)
        assert batches
        for b in batches:
            assert b.verify_kafka_crc()
            out += [(r.key, r.value, tuple((h.key, h.value) for h in r.headers))
                    for r in b.records()]
        off = batches[-1].last_offset + 1
    return out


# ------------------------------------------------------------------ events
def test_wasm_event_validation_roundtrip():
    spec = identity().to_json()
    rec = wasm_event.make_deploy_record("s1", spec, ["in"])
    ev = wasm_event.parse_event(rec)
    assert ev is not None and ev.action == wasm_event.DEPLOY
    assert ev.input_topics == ("in",)
    assert json.loads(ev.spec_json) == json.loads(spec)
    # checksum tamper -> rejected
    bad = Record(key=rec.key, value=rec.value + b"x", headers=rec.headers)
    assert wasm_event.parse_event(bad) is None
    ev2 = wasm_event.parse_event(wasm_event.make_remove_record("s1"))
    assert ev2.action == wasm_event.REMOVE
    # reconcile: last wins
    assert wasm_event.reconcile([ev, ev2])["s1"].action == wasm_event.REMOVE


def _event_cases(pk) -> dict:
    """Deploy-event records of ``pk`` (the JAX package's or the port's
    wasm_event module with its Record), good and tampered."""
    we, R, H = pk
    spec = PAYLOAD_SPEC.to_json()
    dep = we.make_deploy_record("errs", spec, ["logs", "more"])
    py = we.make_py_deploy_record("up", PY_SOURCE, ["logs"], policy="deregister")

    def with_headers(rec, headers, value=None):
        return R(key=rec.key, value=rec.value if value is None else value, headers=headers)

    csum = dict((h.key, h.value) for h in dep.headers)[b"checksum"]
    body_no_topics = json.dumps({"spec": json.loads(spec), "input_topics": []},
                                separators=(",", ":")).encode()
    body_bad_json = b"{not json"
    body_py_bad_policy = json.dumps({"py_source": PY_SOURCE, "input_topics": ["a"],
                                     "policy": "explode"}, separators=(",", ":")).encode()

    def signed(value, typ=we.EVENT_TYPE):
        return (H(b"action", we.DEPLOY), H(b"checksum", struct.pack("<Q", xxh(value))),
                H(b"type", typ))

    xxh = we.xxhash64
    return {
        "deploy": dep,
        "py_deploy": py,
        "remove": we.make_remove_record("errs"),
        "tampered_value": with_headers(dep, dep.headers, dep.value + b" "),
        "no_key": R(key=None, value=dep.value, headers=dep.headers),
        "no_action": with_headers(dep, tuple(h for h in dep.headers if h.key != b"action")),
        "unknown_action": with_headers(dep, (H(b"action", b"pause"),) + tuple(dep.headers[1:])),
        "short_checksum": with_headers(dep, (H(b"action", we.DEPLOY), H(b"checksum", csum[:4]))),
        "no_value": R(key=b"errs", value=None, headers=dep.headers),
        "no_topics": R(key=b"errs", value=body_no_topics, headers=signed(body_no_topics)),
        "bad_json": R(key=b"errs", value=body_bad_json, headers=signed(body_bad_json)),
        "py_bad_policy": R(key=b"up", value=body_py_bad_policy,
                           headers=signed(body_py_bad_policy, we.EVENT_TYPE_PY)),
    }


def _event_view(ev):
    if ev is None:
        return None
    return (ev.name, ev.action, ev.spec_json, ev.input_topics, ev.checksum, ev.py_source,
            ev.policy, ev.script_id)


def test_wasm_event_records_and_verdicts_match_jax():
    """The same events built by both packages: deploy_batch's bytes (each
    case's record alone and all in one batch) and parse_event's verdict on
    each, tampered records among them, are equal."""
    mine = _event_cases((wasm_event, Record, RecordHeader))
    ref = _event_cases((ref_wasm_event, RefRecord, RefRecordHeader))
    assert list(mine) == list(ref)
    verdicts = {}
    for name in mine:
        assert (wasm_event.deploy_batch([mine[name]]).encode_internal()
                == ref_wasm_event.deploy_batch([ref[name]]).encode_internal()), name
        got = _event_view(wasm_event.parse_event(mine[name]))
        assert got == _event_view(ref_wasm_event.parse_event(ref[name])), name
        verdicts[name] = got is not None
    assert verdicts == {"deploy": True, "py_deploy": True, "remove": True, **{
        n: False for n in mine if n not in ("deploy", "py_deploy", "remove")}}
    assert (wasm_event.deploy_batch(list(mine.values())).encode_internal()
            == ref_wasm_event.deploy_batch(list(ref.values())).encode_internal())
    # a JAX-built event parses in the port, and the port's in the JAX package
    for name in mine:
        ref_bytes = ref_wasm_event.deploy_batch([ref[name]]).encode_internal()
        (rec,) = RecordBatch.decode_internal(ref_bytes)[0].records()
        assert _event_view(wasm_event.parse_event(rec)) == _event_view(
            ref_wasm_event.parse_event(ref[name]))
    with pytest.raises(ValueError):
        wasm_event.make_py_deploy_record("x", PY_SOURCE, ["a"], policy="explode")


# ------------------------------------------------------------------ the runtime on the port
def test_coproc_e2e_identity_transform(tmp_path):
    """Deploy identity, produce: the materialized topic mirrors the input."""

    async def main():
        storage, broker, api = await _start(tmp_path)
        try:
            await broker.create_topic(TopicConfig("src", 2))
            await api.deploy("ident", identity().to_json(), ["src"])
            await wait_until(lambda: "ident" in api.active_scripts(), msg="deployed")
            await _produce(broker, "src", 0, [b"r0", b"r1", b"r2"])
            await _produce(broker, "src", 1, [b"r3"])
            m0, m1 = NTP.kafka("src.$ident$", 0), NTP.kafka("src.$ident$", 1)
            await wait_until(lambda: _hwm(broker, m0) >= 3, msg="p0 materialized")
            await wait_until(lambda: _hwm(broker, m1) >= 1, msg="p1 materialized")
            recs = await _records(broker.partition_manager.get(m0))
            assert [v for _, v, _ in recs] == [b"r0", b"r1", b"r2"]
            assert broker.topic_table.contains("src.$ident$")
        finally:
            await _stop(storage, api)

    run(main())


def test_coproc_filter_project_and_remove(tmp_path):
    async def main():
        storage, broker, api = await _start(tmp_path)
        try:
            await broker.create_topic(TopicConfig("logs", 1))
            await api.deploy("errs", PAYLOAD_SPEC.to_json(), ["logs"])
            await wait_until(lambda: api.active_scripts() == ["errs"], msg="deployed")
            await _produce(broker, "logs", 0, _json_records(8))
            mntp = NTP.kafka("logs.$errs$", 0)
            await wait_until(lambda: _hwm(broker, mntp) >= 4, msg="filtered output")
            assert _hwm(broker, mntp) == 4  # 4 of 8 are error
            # remove: the script stops, later produces are NOT transformed
            await api.remove("errs")
            await wait_until(lambda: api.active_scripts() == [], msg="removed")
            await _produce(broker, "logs", 0, _json_records(8))
            await asyncio.sleep(0.3)
            assert _hwm(broker, mntp) == 4
        finally:
            await _stop(storage, api)

    run(main())


def test_coproc_offsets_survive_restart(tmp_path):
    """Restart the broker; the script resumes from its saved offsets
    without reprocessing."""

    async def main():
        mntp = NTP.kafka("ev.$keep$", 0)
        storage, broker, api = await _start(tmp_path)
        try:
            await broker.create_topic(TopicConfig("ev", 1))
            await api.deploy("keep", identity().to_json(), ["ev"])
            await wait_until(lambda: api.active_scripts() == ["keep"], msg="deployed")
            await _produce(broker, "ev", 0, [b"a", b"b"])
            await wait_until(lambda: _hwm(broker, mntp) >= 2, msg="first round")
            api.pacemaker._save_offsets()
        finally:
            await _stop(storage, api)
        storage2, broker2, api2 = await _start(tmp_path)
        try:
            await wait_until(lambda: api2.active_scripts() == ["keep"], msg="redeployed from log")
            await _produce(broker2, "ev", 0, [b"c"])
            await wait_until(lambda: _hwm(broker2, mntp) >= 3, msg="resumed")
            recs = await _records(broker2.partition_manager.get(mntp))
            assert [v for _, v, _ in recs] == [b"a", b"b", b"c"]
        finally:
            await _stop(storage2, api2)

    run(main())


def test_deploy_validation(tmp_path):
    async def main():
        storage, broker, api = await _start(tmp_path)
        try:
            with pytest.raises(ValueError):
                await api.deploy("x", identity().to_json(), ["missing-topic"])
            await broker.create_topic(TopicConfig("ok", 1))
            await broker.create_topic(TopicConfig("__consumer_offsets", 1))
            with pytest.raises(ValueError):
                await api.deploy("x", identity().to_json(), ["__consumer_offsets"])
            await broker.create_topic(TopicConfig("ok.$s$", 1))
            with pytest.raises(ValueError):  # a materialized topic is no input
                await api.deploy("x", identity().to_json(), ["ok.$s$"])
        finally:
            await _stop(storage, api)

    run(main())


def test_ingest_poison_skipped_transient_retried(tmp_path):
    """A poison event (SandboxViolation/ValueError) is skipped and the
    cursor advances past it; any other exception is transient: it re-raises
    without advancing, so the chunk retries on the next poll."""

    async def main():
        storage, broker, api = await _start(tmp_path)
        try:
            await broker.create_topic(TopicConfig("src", 1))
            await wait_until(
                lambda: broker.get_partition(COPROC_INTERNAL_TOPIC, 0) is not None,
                msg="listener up")
            real_enable = api._enable
            calls = {"n": 0}

            async def flaky_enable(ev):
                calls["n"] += 1
                if calls["n"] == 1:
                    raise RuntimeError("partition moving")  # transient
                await real_enable(ev)

            api._enable = flaky_enable
            failures0 = _failures("wasm_ingest")
            await api.deploy("t1", identity().to_json(), ["src"])
            await wait_until(lambda: api.active_scripts() == ["t1"], msg="retried")
            assert calls["n"] >= 2
            assert _failures("wasm_ingest") > failures0
            cursor_after_t1 = api._listen_offset

            async def poison_enable(ev):
                calls["n"] += 1
                raise ValueError("malformed event body")

            api._enable = poison_enable
            await api.deploy("t2", identity().to_json(), ["src"])
            await wait_until(lambda: api._listen_offset > cursor_after_t1, msg="cursor advanced")
            assert api.active_scripts() == ["t1"]  # t2 never registered
            n_after_poison = calls["n"]
            await asyncio.sleep(0.1)
            assert calls["n"] == n_after_poison  # not retried forever
            api._enable = real_enable
            await api.deploy("t3", identity().to_json(), ["src"])
            await wait_until(lambda: sorted(api.active_scripts()) == ["t1", "t3"],
                             msg="recovered")
        finally:
            await _stop(storage, api)

    run(main())


def test_sandboxed_python_deploy_runs_through_the_pacemaker(tmp_path):
    """A py-sandbox deploy event enables the python lane; an unchanged
    redeploy is deduplicated by its checksum; a source that fails the
    sandbox's validation on the broker is refused and nothing runs."""

    async def main():
        storage, broker, api = await _start(tmp_path)
        try:
            await broker.create_topic(TopicConfig("src", 1))
            await _produce(broker, "src", 0, [b"abc", b"xyz"])
            rec = wasm_event.make_py_deploy_record("up", PY_SOURCE, ["src"])
            await api._produce_event(rec)
            await api._produce_event(rec)  # unchanged redeploy: a no-op
            mntp = NTP.kafka("src.$up$", 0)
            await wait_until(lambda: _hwm(broker, mntp) >= 2, msg="python output")
            recs = await _records(broker.partition_manager.get(mntp))
            assert [v for _, v, _ in recs] == [b"ABC", b"XYZ"]
            assert api.active_scripts() == ["up"]
            ctx = api.pacemaker.scripts()["up"]
            # a body that passes the client-side check in no package: built by hand
            bad = "import os\ndef transform(value):\n    return value\n"
            value = json.dumps({"py_source": bad, "input_topics": ["src"], "policy": "skip"},
                               separators=(",", ":")).encode()
            await api._produce_event(Record(key=b"bad", value=value, headers=(
                RecordHeader(b"action", wasm_event.DEPLOY),
                RecordHeader(b"checksum", struct.pack("<Q", wasm_event.xxhash64(value))),
                RecordHeader(b"type", wasm_event.EVENT_TYPE_PY))))
            hwm = broker.get_partition(COPROC_INTERNAL_TOPIC, 0).high_watermark
            await wait_until(lambda: api._listen_offset >= hwm, msg="bad event ingested")
            assert api.active_scripts() == ["up"]
            assert api.pacemaker.scripts()["up"] is ctx
        finally:
            await _stop(storage, api)

    run(main())


def test_api_knobs_arm_recorders_autotune_and_backstop(tmp_path):
    """The knobs the JAX package's api reads: the recorders are on before
    the engine is built (its arena is wrapped), the autotune is armed from
    the launch knobs and the pacemaker follows it, the read budget bounds
    the configured inflight bytes, and the tick backstop sits above the
    engine's envelope."""

    class Cfg:
        coproc_lockwatch = True
        coproc_leakwatch = True
        coproc_max_batch_size = 4096
        coproc_max_inflight_bytes = 3 * 4096
        coproc_group_ticks_per_launch = 2
        coproc_group_ticks_max = 3
        coproc_launch_depth = 3
        coproc_launch_depth_max = 5
        coproc_host_workers = 0
        coproc_offset_flush_interval_ms = 50

    async def main():
        storage, broker, api = await _start(tmp_path, Cfg())
        try:
            assert lockwatch.enabled() and leakwatch.enabled()
            assert isinstance(api.engine._arena, leakwatch.WatchedArena)
            pm = api.pacemaker
            assert api.engine.governor.autotune_snapshot() == {
                "enabled": True, "group_ticks": 2, "group_ticks_cap": 3,
                "launch_depth": 3, "launch_depth_cap": 5, "hold_s": governor.AUTOTUNE_HOLD_S}
            assert api.engine.governor.posture()["autotune"]["group_ticks"] == 2
            assert pm.launch_knobs() == {"group_ticks": 2, "launch_depth": 3}
            assert pm.read_budget.limit == 3 * 4096
            assert pm.offset_flush_interval_s == 0.05
            env = api.engine._fault_policy.envelope_s()
            assert pm.tick_deadline_s == max(60.0, 4 * env)
            assert pm.tick_deadline_for(api.engine) == max(
                pm.tick_deadline_s, 4 * api.engine.governor.max_envelope_s())
            # the flush loop saves offsets on its interval
            await broker.create_topic(TopicConfig("f", 1))
            await api.deploy("keep", identity().to_json(), ["f"])
            await _produce(broker, "f", 0, [b"a"])
            await wait_until(
                lambda: json.loads(storage.kvs.get(KeySpace.coproc, b"offsets") or b"{}")
                == {"keep": {"kafka/f/0": 0}}, msg="flushed offsets")
        finally:
            await _stop(storage, api)
        assert leakwatch.snapshot()["imbalances"] == 0

    run(main())


def test_pacemaker_knobs_without_a_governor_and_default_device():
    """A bare engine double (no governor) keeps the static knobs and the
    static backstop; with no CUDA device the api's default engine raises."""
    import torch

    pm = Pacemaker(object(), object(), group_ticks_per_launch=3, launch_depth=0,
                   tick_deadline_s=7.0)
    assert pm.launch_knobs() == {"group_ticks": 3, "launch_depth": 1}
    assert pm.tick_deadline_for(object()) == 7.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            CoprocApi(object())


# ------------------------------------------------------------------ against the JAX package
def _input_values(seed: int, partitions: int, batches: int, records: int) -> dict:
    """{partition: [[value, ...] per batch]}: JSON records of the bench's
    shape, small, from a numpy seed."""
    rng = np.random.default_rng(seed)
    levels = ["error", "info", "warn"]
    out = {}
    for p in range(partitions):
        out[p] = [[json.dumps({"level": levels[int(rng.integers(0, 3))],
                               "code": int(rng.integers(-50, 600)),
                               "msg": "x" * int(rng.integers(0, 40))},
                              separators=(",", ":")).encode()
                   for _ in range(records)] for _ in range(batches)]
    return out


def _batch_bytes(values: list, ts: int) -> bytes:
    """A batch built by the JAX package with fixed timestamps, as bytes for
    either package."""
    return RefRecordBatch.build(
        [RefRecord(offset_delta=i, timestamp_delta=i, value=v, key=b"k%d" % i)
         for i, v in enumerate(values)],
        first_timestamp=ts,
    ).encode_internal()


def _pkg_rt(root: str):
    import importlib

    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return (m("storage.log_manager").StorageApi, m("kafka.server.broker"),
            m("cluster.topic_table").TopicConfig, m("coproc.api").CoprocApi,
            m("models.record").RecordBatch, m("models.fundamental").NTP)


async def _runtime_session(root, d, produce, deploys, outputs, check=None):
    """Start ``root``'s broker and runtime over ``d``, produce ``produce``
    ({topic: {partition: [batch bytes]}}) and create the topics that are
    missing, deploy ``deploys`` one at a time (waiting for each one's
    output), wait for ``outputs`` ({materialized topic: {partition: record
    count}}), stop, and return what the directory then holds."""
    StorageApi_, broker_mod, TC, Api, RB, NTP_ = _pkg_rt(root)
    storage = await StorageApi_(d).start()
    broker = broker_mod.Broker(broker_mod.BrokerConfig(data_dir=d), storage)
    await broker.recover_topics()
    for topic, parts in produce.items():
        if not broker.topic_table.contains(topic):
            await broker.create_topic(TC(topic, len(parts)))
        for p, blobs in parts.items():
            await broker.get_partition(topic, p).replicate(
                [RB.decode_internal(b)[0] for b in blobs], 0)
    api = Api(broker, device="cpu") if root == "redpanda_tpu_torch" else Api(broker)
    await api.start()
    api.poll_interval_s = 0.02
    try:
        def done(mtopic):
            return all(_hwm(broker, NTP_.kafka(mtopic, p)) >= n
                       for p, n in outputs[mtopic].items())

        for name, spec_json, topics, mtopic in deploys:
            await api.deploy(name, spec_json, topics)
            await wait_until(lambda: done(mtopic), msg=f"{root} {name}")
        for mtopic in outputs:
            await wait_until(lambda: done(mtopic), msg=f"{root} {mtopic}")
        if check is not None:
            await check(broker, api)
        active = api.active_scripts()
        offsets_live = {n: {str(k): v for k, v in ctx.offsets.items()}
                        for n, ctx in api.pacemaker.scripts().items()}
    finally:
        await api.stop()
    out = {
        "active": active,
        "offsets_live": offsets_live,
        "records": {},
        "otl": {},
    }
    for ntp, part in sorted(broker.partition_manager.partitions().items()):
        out["records"][ntp.path()] = await _records(part)
        otl = part.otl
        out["otl"][ntp.path()] = (otl._base, otl._base_delta, otl.upto, list(otl._gaps))
    kvs = storage.kvs
    out["offsets_json"] = kvs.get(KeySpace.coproc, b"offsets")
    out["otl_kv"] = {k: kvs.get(KeySpace.offset_translator, k)
                     for k in sorted(kvs.keys(KeySpace.offset_translator))}
    out["topic_cfg"] = {k: kvs.get(KeySpace.storage, k)
                        for k in sorted(kvs.keys(KeySpace.storage))}
    await storage.stop()
    return out


def _engine_records(spec, values_by_part: dict, topic: str) -> dict:
    """The records of each partition's input run through the port's engine
    directly (one request of all its batches)."""
    eng = TorchEngine(device="cpu", host_workers=0)
    try:
        assert eng.enable_coprocessors([(1, spec.to_json(), (topic,))]) == [0]
        items = [ProcessBatchItem(1, NTP.kafka(topic, p),
                                  [RecordBatch.decode_internal(b)[0] for b in blobs])
                 for p, blobs in values_by_part.items()]
        reply = eng.process_batch(ProcessBatchRequest(items))
        return {it.source.partition: [(r.key, r.value, tuple((h.key, h.value) for h in r.headers))
                                      for b in it.batches for r in b.records()]
                for it in reply.items}
    finally:
        eng.shutdown()


def test_runtimes_match_jax_on_the_same_inputs(tmp_path):
    """The same produced bytes and the same two deploys (the columnar spec,
    then the payload spec) through the JAX package's runtime and the
    port's: the same materialized records, the same offsets JSON in the
    kvstore, the same translator state and the same topic configs; and the
    records equal the port's engine run on the input directly."""
    vals = _input_values(20, partitions=2, batches=3, records=8)
    blobs = {p: [_batch_bytes(v, 1_700_000_000_000 + 1000 * i) for i, v in enumerate(bs)]
             for p, bs in vals.items()}
    want = {name: _engine_records(spec, blobs, "logs")
            for name, spec in (("cols", COLUMNAR_SPEC), ("pay", PAYLOAD_SPEC))}
    outputs = {f"logs.${n}$": {p: len(want[n][p]) for p in blobs} for n in want}
    deploys = [("cols", COLUMNAR_SPEC.to_json(), ["logs"], "logs.$cols$"),
               ("pay", PAYLOAD_SPEC.to_json(), ["logs"], "logs.$pay$")]
    got = {}
    for root in ("redpanda_tpu", "redpanda_tpu_torch"):
        d = tmp_path / root
        d.mkdir()
        got[root] = run(_runtime_session(root, str(d), {"logs": blobs}, deploys, outputs))
    mine, ref = got["redpanda_tpu_torch"], got["redpanda_tpu"]
    assert mine == ref
    for n in want:
        for p in blobs:
            assert mine["records"][f"kafka/logs.${n}$/{p}"] == want[n][p]
    assert json.loads(mine["offsets_json"]) == {
        n: {f"kafka/logs/{p}": 3 * 8 - 1 for p in blobs} for n in want}
    assert mine["active"] == ["cols", "pay"]


def test_port_resumes_a_directory_the_jax_runtime_wrote(tmp_path):
    """The JAX package's broker and runtime process a backlog and stop; the
    port's broker opens the directory (recover_topics), its runtime replays
    the JAX package's deploy event and resumes from its saved offsets: one
    more batch a partition appears exactly once, after the JAX package's
    output, and nothing of the backlog is processed twice."""
    vals = _input_values(21, partitions=2, batches=4, records=6)
    first = {p: [_batch_bytes(v, 1_700_000_000_000 + 1000 * i) for i, v in enumerate(bs[:3])]
             for p, bs in vals.items()}
    second = {p: [_batch_bytes(bs[3], 1_700_000_009_000)] for p, bs in vals.items()}
    want1 = _engine_records(PAYLOAD_SPEC, first, "logs")
    want2 = _engine_records(PAYLOAD_SPEC, second, "logs")
    d = str(tmp_path)
    ref = run(_runtime_session(
        "redpanda_tpu", d, {"logs": first},
        [("pay", PAYLOAD_SPEC.to_json(), ["logs"], "logs.$pay$")],
        {"logs.$pay$": {p: len(want1[p]) for p in first}}))
    assert json.loads(ref["offsets_json"]) == {"pay": {f"kafka/logs/{p}": 17 for p in first}}

    async def check(broker, api):
        assert api.active_scripts() == ["pay"]
        assert api.pacemaker.scripts()["pay"].offsets == {
            NTP.kafka("logs", p): 3 * 6 - 1 + 6 for p in first}

    mine = run(_runtime_session(
        "redpanda_tpu_torch", d, {"logs": second}, [],
        {"logs.$pay$": {p: len(want1[p]) + len(want2[p]) for p in first}}, check))
    for p in first:
        recs = mine["records"][f"kafka/logs.$pay$/{p}"]
        assert recs == want1[p] + want2[p]
        assert recs[: len(want1[p])] == ref["records"][f"kafka/logs.$pay$/{p}"]
    assert json.loads(mine["offsets_json"]) == {"pay": {f"kafka/logs/{p}": 23 for p in first}}
    assert mine["active"] == ["pay"]
    # the deploy event in the internal topic is still the JAX package's one
    assert (mine["records"]["kafka/coprocessor_internal_topic/0"]
            == ref["records"]["kafka/coprocessor_internal_topic/0"])


def test_autotune_knob_gauges_read_the_live_governor():
    """coproc_autotune_knob{knob=} reads -1 until the autotune is armed,
    then the current knobs."""

    def gauge(knob):
        return registry.snapshot()[f'coproc_autotune_knob{{knob="{knob}"}}']

    eng = TorchEngine(device="cpu", host_workers=0)
    try:
        assert (gauge("group_ticks"), gauge("launch_depth")) == (-1.0, -1.0)
        eng.governor.configure_autotune(group_ticks=3, launch_depth=2)
        assert (gauge("group_ticks"), gauge("launch_depth")) == (3.0, 2.0)
    finally:
        eng.shutdown()
