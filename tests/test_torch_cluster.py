"""The port's partition runtime (redpanda_tpu_torch/cluster/) and its
standalone broker's storage half (redpanda_tpu_torch/kafka/server/broker.py)
against the JAX package's, on the CPU.

tests/test_offset_translation.py's four tests run on the port. Then both
packages are fed the same operations, with the same inputs made from a numpy
seed: the topic table's deltas, the offset translator's conversions and the
bytes it persists under ``KeySpace.offset_translator``, a partition's
replicate results, reads, watermarks and timequeries over logs that hold
non-data batches, and a broker's topic create/grow/delete/recover with the
kvstore it leaves behind must be equal, with no tolerance. The port's
``Broker`` has exactly the JAX package's attributes and methods less the
members that stand on modules not ported yet.
"""

from __future__ import annotations

import asyncio
import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest


def _pkg(root: str) -> SimpleNamespace:
    def m(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        root=root,
        record=m("models.record"),
        NTP=m("models.fundamental").NTP,
        kvstore=m("storage.kvstore"),
        log=m("storage.log"),
        log_manager=m("storage.log_manager"),
        topic_table=m("cluster.topic_table"),
        otl=m("cluster.offset_translator"),
        partition=m("cluster.partition"),
        cluster=m("cluster"),
        broker=m("kafka.server.broker"),
    )


PKGS = {"jax": _pkg("redpanda_tpu"), "port": _pkg("redpanda_tpu_torch")}
port = PKGS["port"]


def run(coro):
    return asyncio.run(coro)


def both(fn, tmp_path=None):
    """``fn(pk[, dir])`` through each package (a directory of its own);
    the two results must be equal. Returns the port's."""
    got = {}
    for name, pk in PKGS.items():
        if tmp_path is None:
            res = fn(pk)
        else:
            d = tmp_path / name
            d.mkdir()
            res = fn(pk, str(d))
        got[name] = run(res) if asyncio.iscoroutine(res) else res
    assert got["port"] == got["jax"]
    return got["port"]


def kv_items(kvs) -> list:
    return sorted((int(sp), k, v) for (sp, k), v in kvs._data.items())


# ------------------------------------------------------------ tests/test_offset_translation.py
def test_translator_identity_without_gaps():
    RT = port.record.RecordBatchType
    t = port.otl.OffsetTranslator(port.NTP.kafka("t", 0))
    for base, last in [(0, 4), (5, 5), (6, 9)]:
        t.observe(RT.raft_data, base, last)
    assert t.to_kafka(9) == 9
    assert t.from_kafka(3) == 3
    assert t.to_kafka_excl(10) == 10


def test_translator_gaps_roundtrip():
    RT = port.record.RecordBatchType
    t = port.otl.OffsetTranslator(port.NTP.kafka("t", 0))
    # raft log: [cfg@0] [data 1-3] [cfg@4, cfg@5] [data 6-8] [cfg@9] [data 10]
    t.observe(RT.raft_configuration, 0, 0)
    t.observe(RT.raft_data, 1, 3)
    t.observe(RT.raft_configuration, 4, 5)
    t.observe(RT.raft_data, 6, 8)
    t.observe(RT.raft_configuration, 9, 9)
    t.observe(RT.raft_data, 10, 10)
    assert [t.to_kafka(r) for r in (1, 2, 3, 6, 7, 8, 10)] == [0, 1, 2, 3, 4, 5, 6]
    assert [t.from_kafka(k) for k in range(7)] == [1, 2, 3, 6, 7, 8, 10]
    assert t.to_kafka_excl(11) == 7  # HWM
    for k in range(7):
        assert t.to_kafka(t.from_kafka(k)) == k


def test_translator_truncate_and_base_advance():
    RT = port.record.RecordBatchType
    t = port.otl.OffsetTranslator(port.NTP.kafka("t", 0))
    t.observe(RT.raft_configuration, 0, 0)
    t.observe(RT.raft_data, 1, 5)
    t.observe(RT.raft_configuration, 6, 7)
    t.observe(RT.raft_data, 8, 9)
    assert t.to_kafka(9) == 6
    # suffix truncation at raft 7 removes part of the config gap + data tail
    t.truncate(7)
    assert t.upto == 6
    t.observe(RT.raft_data, 7, 9)  # divergent rewrite, data now
    assert t.to_kafka(9) == 7
    # prefix truncation collapses leading gap into the base delta
    t.advance_base(6)
    assert t.to_kafka(9) == 7
    assert t.from_kafka(7) == 9


def _cfg_batch(pk):
    return pk.record.RecordBatch.build(
        [pk.record.Record(offset_delta=0, value=b"cfg")],
        type=pk.record.RecordBatchType.raft_configuration,
        first_timestamp=1_700_000_000_000,
    )


def _data_batch(pk, n, ts=1_700_000_000_000, tag=b"d"):
    return pk.record.RecordBatch.build(
        [pk.record.Record(offset_delta=i, timestamp_delta=i, value=tag + bytes([i]))
         for i in range(n)],
        first_timestamp=ts,
    )


def test_translator_persists_and_recovers(tmp_path):
    async def main():
        ntp = port.NTP.kafka("t", 0)
        kvs = port.kvstore.KvStore(str(tmp_path / "kv"))
        kvs.start()
        cfg = port.log.LogConfig(base_dir=str(tmp_path))
        log = await port.log.DiskLog.open(ntp, cfg)
        t = port.otl.OffsetTranslator(ntp, kvs)
        log.append_listeners.append(t.observe)
        await t.bootstrap(log)
        await log.append([_cfg_batch(port)])
        await log.append([_data_batch(port, 3)])
        await log.append([_cfg_batch(port)])
        await log.append([_data_batch(port, 2)])
        assert t.to_kafka_excl(log.offsets().dirty_offset + 1) == 5
        await log.close()
        kvs.stop()

        # restart: fresh translator bootstraps from kvstore (+ scan)
        kvs2 = port.kvstore.KvStore(str(tmp_path / "kv"))
        kvs2.start()
        log2 = await port.log.DiskLog.open(ntp, cfg)
        t2 = port.otl.OffsetTranslator(ntp, kvs2)
        await t2.bootstrap(log2)
        assert t2.to_kafka_excl(log2.offsets().dirty_offset + 1) == 5
        assert [t2.from_kafka(k) for k in range(5)] == [1, 2, 3, 5, 6]
        # and a cold-cache translator (no kvstore) rebuilds purely by scan
        t3 = port.otl.OffsetTranslator(ntp, None)
        await t3.bootstrap(log2)
        assert [t3.from_kafka(k) for k in range(5)] == [1, 2, 3, 5, 6]
        await log2.close()
        kvs2.stop()

    run(main())


# ------------------------------------------------------------ translator against the JAX package
def _translator_ops(seed: int, n: int = 60) -> list:
    """A seeded sequence of observe / truncate / advance_base calls over a
    growing raft log."""
    rng = np.random.default_rng(seed)
    ops, nxt = [], 0
    for _ in range(n):
        r = rng.random()
        if r < 0.75 or nxt == 0:
            length = int(rng.integers(1, 6))
            data = bool(rng.random() < 0.6)
            ops.append(("observe", data, nxt, nxt + length - 1))
            nxt += length
        elif r < 0.88:
            cut = int(rng.integers(max(0, nxt - 8), nxt + 1))
            ops.append(("truncate", cut))
            nxt = min(nxt, cut)
        else:
            ops.append(("advance_base", int(rng.integers(0, nxt + 1))))
    return ops


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_translator_ops_and_kvstore_bytes_match_jax(seed, tmp_path):
    """The same ops through both translators, each persisting into its own
    kvstore: every conversion, the state and the persisted key and value
    bytes are equal after every op."""

    def scenario(pk, d):
        RT = pk.record.RecordBatchType
        kvs = pk.kvstore.KvStore(os.path.join(d, "kv"))
        kvs.start()
        t = pk.otl.OffsetTranslator(pk.NTP.kafka("topic-a", 7), kvs)
        out = []
        for op in _translator_ops(seed):
            if op[0] == "observe":
                t.observe(RT.raft_data if op[1] else RT.raft_configuration, op[2], op[3])
            else:
                getattr(t, op[0])(op[1])
            hi = max(t.upto + 2, 1)
            out.append((
                t.upto, t.total_delta(), list(t._gaps), t._base, t._base_delta,
                [t.gaps_below(b) for b in range(hi)],
                [t.from_kafka(k) for k in range(hi)],
                [t.to_kafka_excl(b) for b in range(hi)],
                kv_items(kvs),
            ))
        kvs.stop()
        return out

    states = both(scenario, tmp_path)
    keys = {k for s in states for (_, k, _) in s[-1]}
    assert keys == {b"otl/kafka/topic-a/7"}


def test_translator_blob_crosses_packages(tmp_path):
    """A translator state persisted by one package loads in the other."""
    RT = {n: pk.record.RecordBatchType for n, pk in PKGS.items()}
    for writer, reader in (("jax", "port"), ("port", "jax")):
        d = str(tmp_path / f"{writer}-{reader}")
        w, r = PKGS[writer], PKGS[reader]
        kvs = w.kvstore.KvStore(d)
        kvs.start()
        t = w.otl.OffsetTranslator(w.NTP.kafka("x", 1), kvs)
        for op in _translator_ops(9):
            if op[0] == "observe":
                t.observe(RT[writer].raft_data if op[1] else RT[writer].raft_configuration,
                          op[2], op[3])
            else:
                getattr(t, op[0])(op[1])
        kvs.stop()
        kvs2 = r.kvstore.KvStore(d)
        kvs2.start()
        t2 = r.otl.OffsetTranslator(r.NTP.kafka("x", 1), kvs2)
        assert t2._load()
        assert (t2._base, t2._base_delta, t2._upto, t2._gaps) == (
            t._base, t._base_delta, t._upto, t._gaps)
        kvs2.stop()


# ------------------------------------------------------------ topic table
def _delta_view(deltas) -> list:
    return [(int(d.type), d.ntp.ns, d.ntp.topic, d.ntp.partition,
             None if d.assignment is None else (
                 d.assignment.replicas, d.assignment.leader, d.assignment.group,
                 d.assignment.moving_to))
            for d in deltas]


def test_topic_table_deltas_match_jax():
    def scenario(pk):
        tt = pk.topic_table
        table = tt.TopicTable()
        out = []
        table.add_topic(tt.TopicConfig("a", 3), replicas_for=lambda p: [p % 2, 2])
        table.add_topic(tt.TopicConfig("b", 1, ns="redpanda"))
        out.append(_delta_view(table.drain_deltas()))
        with pytest.raises(ValueError):
            table.add_topic(tt.TopicConfig("a", 1))
        table.add_partitions("a", 5, replicas_for=lambda p: [1])
        with pytest.raises(ValueError):
            table.add_partitions("a", 5)
        ntp = pk.NTP.kafka("a", 1)
        table.begin_move(ntp, [3, 4])
        table.finish_move(ntp, [3, 4])
        table.set_leader(ntp, 4)
        table.set_leader(pk.NTP.kafka("missing", 0), 1)  # no topic: no delta
        pas = [tt.PartitionAssignment(pk.NTP.kafka("c", p), [0, 1], leader=1, group=10 + p)
               for p in range(2)]
        table.apply_create(tt.TopicConfig("c", 0), pas)
        table.apply_create(tt.TopicConfig("c", 9), pas[:1])  # duplicate: a no-op
        table.apply_add_partitions(
            "c", [tt.PartitionAssignment(pk.NTP.kafka("c", 2), [1], group=12)])
        table.update_properties("a", {"retention.ms": "1000", "cleanup.policy": "compact",
                                      "x.custom": "v", "segment.bytes": None})
        out.append(_delta_view(table.drain_deltas()))
        table.remove_topic("b")
        out.append(_delta_view(table.drain_deltas()))
        out.append(sorted((n, md.config.partition_count, md.config.config_map())
                          for n, md in table.topics().items()))
        out.append(sorted(str(n) for n in table.all_ntps()))
        out.append((table.contains("a"), table.contains("b"), table.get("b")))
        return out

    both(scenario)


def test_topic_table_wait_for_deltas_wakes_on_push():
    async def main():
        tt = port.topic_table
        table = tt.TopicTable()
        waiter = asyncio.create_task(table.wait_for_deltas())
        await asyncio.sleep(0)
        assert not waiter.done()
        table.add_topic(tt.TopicConfig("w", 2))
        got = await asyncio.wait_for(waiter, 5)
        assert [d.ntp.partition for d in got] == [0, 1]
        assert table.drain_deltas() == []

    run(main())


@pytest.mark.parametrize("overrides", [
    {},
    {"segment_size": 1 << 20, "retention_bytes": 4096, "retention_ms": 60_000},
    {"retention_bytes": -1, "retention_ms": -1, "cleanup_policy": "compact",
     "delete_retention_ms": 5},
    {"segment_size": 0, "cleanup_policy": "compact,delete"},
], ids=["none", "sizes", "unlimited-compact", "zero-segment"])
def test_topic_config_log_overrides_match_jax(overrides):
    def scenario(pk):
        cfg = pk.topic_table.TopicConfig("t", 1, **overrides)
        base = pk.log.LogConfig(base_dir="/data", max_segment_size=8 << 20)
        got = cfg.log_overrides(base)
        if got is None:
            return None
        return {k: getattr(got, k) for k in (
            "base_dir", "max_segment_size", "retention_bytes", "retention_ms",
            "cleanup_policy", "delete_retention_ms")}

    both(scenario)


# ------------------------------------------------------------ partition
def _batches(pk, seed: int) -> list:
    """Data and raft configuration batches, seeded, with fixed timestamps."""
    rng = np.random.default_rng(seed)
    out = []
    ts = 1_700_000_000_000
    for i in range(24):
        if rng.random() < 0.3:
            out.append(("cfg", _cfg_batch(pk)))
        else:
            n = int(rng.integers(1, 6))
            out.append(("data", _data_batch(pk, n, ts=ts + 10 * i, tag=bytes([65 + i]))))
    return out


def _read_view(batches) -> list:
    return [(b.base_offset, b.last_offset, int(b.header.type), b.verify_kafka_crc(),
             [(r.offset_delta, r.value) for r in b.records()]) for b in batches]


@pytest.mark.parametrize("seed", [0, 5])
def test_partition_offsets_and_reads_match_jax(seed, tmp_path):
    """A partition over a DiskLog that holds raft configuration batches:
    replicate results, watermarks, reads from every kafka offset (re-based
    into the kafka domain), timequery and prefix truncation, equal in both
    packages; and after a restart the translator comes back from the
    kvstore with the same answers."""

    async def scenario(pk, d):
        P = pk.partition
        storage = await pk.log_manager.StorageApi(d).start()
        mgr = P.PartitionManager(storage, 0)
        ntp = pk.NTP.kafka("p", 0)
        part = await mgr.manage(ntp)
        out = []
        for kind, b in _batches(pk, seed):
            if kind == "cfg":
                await part.log.append([b])  # raft's own batch: never seen by clients
            else:
                res = await part.replicate([b], P.ConsistencyLevel.leader_ack)
                out.append(("rep", res.base_offset, res.last_offset))
        hwm = part.high_watermark
        out.append(("wm", part.start_offset, hwm, part.last_stable_offset,
                    part.is_leader(), part.ready_for_reads(), part.leader_id, part.term))
        for k in range(hwm):
            out.append(("read", k, _read_view(await part.make_reader(k, 1 << 20))))
        out.append(("bounded", _read_view(await part.make_reader(3, 1 << 20, max_offset=9))))
        for ts in (1_699_999_999_999, 1_700_000_000_045, 1_700_000_000_231, 1_800_000_000_000):
            out.append(("tq", ts, await part.timequery(ts)))
        await part.prefix_truncate(4)
        out.append(("trunc", part.start_offset, part.high_watermark,
                    _read_view(await part.make_reader(part.start_offset, 1 << 20))))
        await storage.stop()
        # restart: the translator loads from the kvstore and scans the rest
        storage = await pk.log_manager.StorageApi(d).start()
        mgr = P.PartitionManager(storage, 0)
        part = await mgr.manage(ntp)
        out.append(("restart", part.start_offset, part.high_watermark,
                    list(part.otl._gaps), part.otl.upto,
                    _read_view(await part.make_reader(part.start_offset, 1 << 20))))
        out.append(("kv", [x for x in kv_items(storage.kvs) if x[0] == 4]))
        assert mgr.get(ntp) is part and list(mgr.partitions()) == [ntp]
        await mgr.remove(ntp)
        out.append(("removed", mgr.get(ntp), os.path.isdir(os.path.join(d, "data", ntp.path()))))
        await storage.stop()
        return out

    both(scenario, tmp_path)


# ------------------------------------------------------------ broker
# the JAX package's Broker members and methods the port leaves out until the
# replicated security manager is ported; the policy engine is a property
# built on first use on the broker's device, and the port's own members hold
# that device
LEFT_OUT_MEMBERS = {"security"}
LAZY_MEMBERS = {"policy_engine"}
PORT_ONLY_MEMBERS = {"_device_arg", "_device", "_policy_engine"}
LEFT_OUT_METHODS = {"replicate_security_cmd"}
NONE_MEMBERS = {"metadata_cache", "coproc_api", "controller_dispatcher",
                "controller_leader_fn", "budget_plane", "produce_admission"}


def _methods(cls) -> set:
    return {n for n, v in vars(cls).items() if callable(v) and not n.startswith("__")}


def test_broker_has_the_reference_surface_less_the_left_out_members(tmp_path):
    """The port's Broker has every member and method of the JAX package's
    (the group and transaction coordinators, the producer state machines and
    ``rm_stm_for`` included) but the security manager and its command route,
    which wait for ROADMAP item 10d."""
    import dataclasses

    async def main():
        got = {}
        for name, pk in PKGS.items():
            storage = await pk.log_manager.StorageApi(str(tmp_path / name)).start()
            b = pk.broker.Broker(pk.broker.BrokerConfig(data_dir=str(tmp_path / name)), storage)
            got[name] = b
            await storage.stop()
        ref, mine = got["jax"], got["port"]
        assert set(vars(mine)) - PORT_ONLY_MEMBERS == set(vars(ref)) - LEFT_OUT_MEMBERS - LAZY_MEMBERS
        for n in LAZY_MEMBERS:
            assert isinstance(getattr(type(mine), n), property) and n in vars(ref)
        for n in NONE_MEMBERS:
            assert getattr(mine, n) is None and getattr(ref, n) is None
        for n in LEFT_OUT_MEMBERS | LEFT_OUT_METHODS:
            with pytest.raises(AttributeError):
                getattr(mine, n)
        assert _methods(port.broker.Broker) == _methods(PKGS["jax"].broker.Broker) - LEFT_OUT_METHODS
        ref_cfg = PKGS["jax"].broker.BrokerConfig
        assert ([(f.name, f.default) for f in dataclasses.fields(port.broker.BrokerConfig)]
                == [(f.name, f.default) for f in dataclasses.fields(ref_cfg)])

    run(main())


def test_cluster_exports():
    ref = PKGS["jax"].cluster
    assert port.cluster.__all__ == ref.__all__
    for n in port.cluster.__all__:
        assert hasattr(port.cluster, n)


def test_broker_topic_lifecycle_and_recovery_match_jax(tmp_path):
    """Create (with overrides), grow, alter, delete and recreate topics,
    then restart and recover the topic tree: the topic table, the logs'
    configs and the kvstore (topic configs, the revision counter, the
    translators' states) are the same in both packages."""

    async def scenario(pk, d):
        TC = pk.topic_table.TopicConfig
        storage = await pk.log_manager.StorageApi(d).start()
        b = pk.broker.Broker(pk.broker.BrokerConfig(data_dir=d), storage)
        out = []
        await b.create_topic(TC("orders", 3, segment_size=1 << 20, retention_ms=3_600_000))
        await b.create_topic(TC("audit", 1, cleanup_policy="compact"))
        await b.create_topic(TC("gone", 2))
        with pytest.raises(ValueError):
            await b.create_topic(TC("orders", 1))
        await b.create_partitions("orders", 5)
        b.topic_table.update_properties("audit", {"retention.bytes": "4096"})
        b.update_log_configs("audit")
        b.update_log_configs("missing")
        p = b.get_partition("orders", 4)
        await p.replicate([_data_batch(pk, 3)], 0)
        await b.delete_topic("gone")
        await b.create_topic(TC("gone", 1))  # a recreate: a new revision
        out.append([(n, md.config.revision, md.config.partition_count, md.config.config_map())
                    for n, md in sorted(b.topic_table.topics().items())])
        out.append([(str(n), p.log.config.max_segment_size, p.log.config.retention_ms,
                     p.log.config.retention_bytes, p.log.config.cleanup_policy)
                    for n, p in sorted(b.partition_manager.partitions().items())])
        out.append((b.get_partition("orders", 9), b.get_partition("orders", 0, ns="redpanda"),
                    [b.is_internal_topic(t) for t in ("__consumer_offsets", "_redpanda_x",
                                                      "orders", "coprocessor_internal_topic")]))
        await storage.stop()
        out.append(kv_items(storage.kvs))
        storage = await pk.log_manager.StorageApi(d).start()
        b = pk.broker.Broker(pk.broker.BrokerConfig(data_dir=d), storage)
        await b.recover_topics()
        await b.recover_topics()  # idempotent
        out.append([(n, md.config.ns, md.config.revision, md.config.partition_count,
                     md.config.config_map())
                    for n, md in sorted(b.topic_table.topics().items())])
        out.append((b.get_partition("orders", 4).high_watermark,
                    b._log_overrides(b.topic_table.get("audit").config).cleanup_policy))
        await storage.stop()
        out.append(kv_items(storage.kvs))
        return out

    both(scenario, tmp_path)
