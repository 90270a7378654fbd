"""The port's consumer groups and transactions (redpanda_tpu_torch/cluster/
rm_stm.py and tx_gateway.py, kafka/server/group*.py and tx_*.py,
kafka/client/producer.py and consumer.py) against the JAX package's: every
test of tests/test_groups.py and tests/test_transactions.py on the port,
one seeded frame script of the group and transaction APIs whose responses
and files must be byte-identical across the two servers, directories with
open and aborted transactions resumed across the packages both ways, the
transaction gateway between two brokers in one process, and a data policy
over control batches, kept as the reference has it.
"""

from __future__ import annotations

import asyncio
import dataclasses
import json
import shutil
import types
import uuid

import numpy as np
import pytest

import test_groups
import test_transactions
from test_torch_kafka import _frame, _send, _tree
from test_torch_kafka_wire import PortTwin, _crc_default, _twin_id, port_broker  # noqa: F401
from redpanda_tpu.cluster import rm_stm as jrm
from redpanda_tpu.cluster import tx_gateway as jgw
from redpanda_tpu.kafka.client import consumer as jconsumer
from redpanda_tpu.kafka.server import group as jgroup
from redpanda_tpu.kafka.server import tx_coordinator as jtxc
from redpanda_tpu.models.record import Record as JRecord
from redpanda_tpu.models.record import RecordBatch as JRecordBatch
from redpanda_tpu_torch.cluster import rm_stm
from redpanda_tpu_torch.cluster import tx_gateway
from redpanda_tpu_torch.kafka.client import consumer
from redpanda_tpu_torch.kafka.protocol import messages as m
from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode
from redpanda_tpu_torch.kafka.protocol.schema import decode_message
from redpanda_tpu_torch.kafka.server import group
from redpanda_tpu_torch.kafka.server import tx_coordinator as txc
from redpanda_tpu_torch.kafka.server.group_manager import GROUP_TOPIC

GROUPS_TWIN = PortTwin(test_groups, {"Broker": port_broker()})
TX_TWIN = PortTwin(test_transactions, {"Broker": port_broker()})


def run(coro):
    return asyncio.run(coro)


# ------------------------------------------------------------ the reference suites on the port
@pytest.mark.parametrize("case", GROUPS_TWIN.tests(), ids=_twin_id)
def test_reference_groups_suite_on_the_port(case, monkeypatch, tmp_path):
    """Every test of test_groups.py, its names taken from the port."""
    name, params = case
    GROUPS_TWIN.run(name, monkeypatch, tmp_path=tmp_path, **params)


@pytest.mark.parametrize("case", TX_TWIN.tests(), ids=_twin_id)
def test_reference_transactions_suite_on_the_port(case, monkeypatch, tmp_path):
    """Every test of test_transactions.py, its names taken from the port."""
    name, params = case
    TX_TWIN.run(name, monkeypatch, tmp_path=tmp_path, **params)


def test_twins_cover_the_reference_modules():
    from redpanda_tpu_torch.kafka.client.producer import TransactionalProducer
    from redpanda_tpu_torch.kafka.server import KafkaServer

    assert len(GROUPS_TWIN.tests()) == 12
    assert len(TX_TWIN.tests()) == 10
    assert GROUPS_TWIN.globals["GroupConsumer"] is consumer.GroupConsumer
    assert GROUPS_TWIN.globals["Group"] is group.Group
    assert GROUPS_TWIN.globals["KafkaServer"] is KafkaServer
    assert TX_TWIN.globals["TransactionalProducer"] is TransactionalProducer
    assert "redpanda_tpu.kafka.server.group_manager" in GROUPS_TWIN.local_imports
    assert "redpanda_tpu.models.record" in TX_TWIN.local_imports


# ------------------------------------------------------------ module parity
def test_control_markers_and_codecs_are_byte_identical():
    """Control markers, the consumer protocol's blobs, the range plan and
    the gateway's commit codec, on seeded inputs, against the JAX
    package's."""
    rng = np.random.default_rng(24)
    for _ in range(8):
        pid, epoch, coord = (int(x) for x in rng.integers(0, 1 << 15, 3))
        for mtype in (0, 1):
            a = rm_stm.make_control_marker(mtype, pid, epoch, coord)
            b = jrm.make_control_marker(mtype, pid, epoch, coord)
            assert (a.header.encode(), a.payload) == (b.header.encode(), b.payload)
            assert rm_stm.parse_control_marker(a) == jrm.parse_control_marker(b) == mtype
        topics = ["t%d" % i for i in rng.permutation(6)[: int(rng.integers(1, 6))]]
        sub = consumer.encode_subscription(topics, rng.bytes(int(rng.integers(0, 9))))
        assert sub == jconsumer.encode_subscription(topics, sub[-len(sub) + 6 + sum(2 + len(t) for t in topics) + 4:])
        assert consumer.decode_subscription(sub) == jconsumer.decode_subscription(sub) == topics
        members = [("m%d" % i, list(rng.choice(topics, int(rng.integers(1, len(topics) + 1)), replace=False)))
                   for i in rng.permutation(5)]
        parts = {t: int(rng.integers(0, 9)) for t in topics}
        plan = consumer.range_assign(members, parts)
        assert plan == jconsumer.range_assign(members, parts)
        for a in plan.values():
            blob = consumer.encode_assignment(a)
            assert blob == jconsumer.encode_assignment(a)
            assert consumer.decode_assignment(blob) == jconsumer.decode_assignment(blob)
        commits = {(t, int(p)): (int(rng.integers(0, 1 << 40)), int(rng.integers(-1, 9)),
                                 None if rng.random() < 0.5 else "m%d" % p)
                   for t in topics for p in rng.integers(0, 9, 2)}
        mine = tx_gateway.encode_commits({k: group.OffsetCommit(*v) for k, v in commits.items()})
        assert mine == jgw.encode_commits({k: jgroup.OffsetCommit(*v) for k, v in commits.items()})
        back = tx_gateway.decode_commits(mine)
        assert {k: (oc.offset, oc.leader_epoch, oc.metadata) for k, oc in back.items()} == commits


def test_tx_metadata_and_gateway_serde_match_the_reference():
    """TxMetadata's persisted dict and the gateway's rpc method table and
    request/reply bytes are the JAX package's."""
    for pkg_md, pkg_oc in ((txc, group), (jtxc, jgroup)):
        md = pkg_md.TxMetadata("tx-q", 7, 3, 9000)
        md.state = pkg_md.TxState.prepare_commit
        md.partitions = {("b", 1), ("a", 0)}
        md.staged_offsets = {"g": {("a", 0): pkg_oc.OffsetCommit(5, 2, "x")}}
        d = md.to_dict()
        assert pkg_md.TxMetadata.from_dict(json.loads(json.dumps(d))).to_dict() == d
        if pkg_md is txc:
            mine = d
    assert mine == d
    mine_svc, ref_svc = tx_gateway.tx_gateway_service, jgw.tx_gateway_service
    assert [(n, x.id) for n, x in mine_svc.methods.items()] == [(n, x.id) for n, x in ref_svc.methods.items()]
    req = {"topic": "t", "partition": 3, "pid": 1 << 40, "epoch": 2, "commit": 1}
    assert tx_gateway.TX_MARKER_REQUEST.encode(req) == jgw.TX_MARKER_REQUEST.encode(req)
    blob = tx_gateway.encode_commits({("t", 0): group.OffsetCommit(1)})
    req = {"group_id": "g", "commits_json": blob}
    assert tx_gateway.TX_GROUP_OFFSETS_REQUEST.encode(req) == jgw.TX_GROUP_OFFSETS_REQUEST.encode(req)


# ------------------------------------------------------------ seeded ids and clocks
class _Seeded:
    """The same member ids (uuid4) and wall clock for the group and the
    transaction modules of both packages; monotonic time stays real."""

    def __init__(self, monkeypatch, seed: int):
        import time as _time

        self.seed, self.n, self.t = seed, 0, 1_700_000_000.0

        def uuid4():
            self.n += 1
            return uuid.UUID(int=(self.seed << 64) + self.n)

        def wall():
            self.t += 0.001
            return self.t

        ids = types.SimpleNamespace(uuid4=uuid4)
        clock = types.SimpleNamespace(time=wall, monotonic=_time.monotonic)
        for mod in (group, jgroup):
            monkeypatch.setattr(mod, "uuid", ids)
            monkeypatch.setattr(mod, "time", clock)
        for mod in (txc, jtxc):
            monkeypatch.setattr(mod, "time", clock)

    def reset(self) -> None:
        self.n, self.t = 0, 1_700_000_000.0

    def member(self, client_id: str, k: int) -> str:
        return f"{client_id}-{uuid.UUID(int=(self.seed << 64) + k)}"


# ------------------------------------------------------------ the frame script
def _group_tx_script(seed: int, member: str) -> list[bytes]:
    """Two topics and plain records; a group joined, synced, heartbeaten,
    its offsets committed and fetched; a transaction over two partitions
    with offsets sent to the group and committed; one aborted; a produce
    outside any transaction refused; an idempotent producer with a
    duplicate and a gap; read_committed and read_uncommitted fetches; the
    transactional id re-initialised and its zombie fenced; the group
    described, listed, left and deleted."""
    rng = np.random.default_rng(seed)
    corr = iter(range(1, 1000))
    seqs: dict = {}

    def batch(n, pid=-1, epoch=-1, seq=-1, tx=False):
        recs = [JRecord(offset_delta=j, timestamp_delta=j, key=rng.bytes(3),
                        value=rng.bytes(int(rng.integers(1, 300)))) for j in range(n)]
        return JRecordBatch.build(recs, first_timestamp=1_700_000_000_000, producer_id=pid,
                                  producer_epoch=epoch, base_sequence=seq, transactional=tx)

    def wire(*batches):
        from redpanda_tpu.kafka.protocol.batch import encode_wire_batches

        return encode_wire_batches(list(batches))

    def produce(tx_id, parts, version=8):
        return _frame(m.PRODUCE, version, next(corr), {
            "transactional_id": tx_id, "acks": -1, "timeout_ms": 5000,
            "topics": [{"name": t, "partitions": [{"partition_index": p, "records": r}]}
                       for t, p, r in parts],
        })

    def tx_batch(t, p, n, pid=0, epoch=0):
        seq = seqs.get((t, p), 0)
        seqs[(t, p)] = seq + n
        return wire(batch(n, pid, epoch, seq, tx=True))

    def fetch(topic, isolation, version=11):
        return _frame(m.FETCH, version, next(corr), {
            "replica_id": -1, "max_wait_ms": 0, "min_bytes": 0, "max_bytes": 1 << 22,
            "isolation_level": isolation, "session_id": 0, "session_epoch": -1,
            "topics": [{"name": topic, "partitions": [
                {"partition_index": p, "current_leader_epoch": -1, "fetch_offset": 0,
                 "log_start_offset": -1, "partition_max_bytes": 1 << 20} for p in range(2)]}],
            "forgotten_topics_data": [], "rack_id": "",
        })

    def offset_fetch(topics, version=6):
        return _frame(m.OFFSET_FETCH, version, next(corr), {
            "group_id": "g-s", "topics": topics, "require_stable": False})

    def add_partitions(parts, epoch=0):
        return _frame(m.ADD_PARTITIONS_TO_TXN, 3, next(corr), {
            "transactional_id": "tx-s", "producer_id": 0, "producer_epoch": epoch,
            "topics": [{"name": "dst", "partitions": parts}]})

    def end_txn(commit, epoch=0):
        return _frame(m.END_TXN, 3, next(corr), {
            "transactional_id": "tx-s", "producer_id": 0, "producer_epoch": epoch,
            "committed": commit})

    def init_pid(tx_id, version=2):
        return _frame(m.INIT_PRODUCER_ID, version, next(corr), {
            "transactional_id": tx_id, "transaction_timeout_ms": 60_000,
            "producer_id": -1, "producer_epoch": -1})

    src = [[batch(int(rng.integers(1, 4))) for _ in range(3)] for _ in range(2)]
    sub = consumer.encode_subscription(["src"])
    assign = consumer.encode_assignment({"src": [0, 1]})
    idem = [batch(2, 1, 0, 0), batch(1, 1, 0, 5)]
    return [
        _frame(m.CREATE_TOPICS, 5, next(corr), {"topics": [
            {"name": n, "num_partitions": 2, "replication_factor": 1, "assignments": [],
             "configs": []} for n in ("src", "dst")], "timeout_ms": 5000, "validate_only": False}),
        produce(None, [("src", p, wire(*src[p])) for p in range(2)]),
        _frame(m.FIND_COORDINATOR, 3, next(corr), {"key": "g-s", "key_type": 0}),
        _frame(m.JOIN_GROUP, 6, next(corr), {
            "group_id": "g-s", "session_timeout_ms": 30000, "rebalance_timeout_ms": 30000,
            "member_id": "", "group_instance_id": None, "protocol_type": "consumer",
            "protocols": [{"name": "range", "metadata": sub}, {"name": "rr", "metadata": b""}]}),
        _frame(m.SYNC_GROUP, 4, next(corr), {
            "group_id": "g-s", "generation_id": 1, "member_id": member, "group_instance_id": None,
            "assignments": [{"member_id": member, "assignment": assign}]}),
        _frame(m.HEARTBEAT, 4, next(corr), {
            "group_id": "g-s", "generation_id": 1, "member_id": member, "group_instance_id": None}),
        _frame(m.HEARTBEAT, 2, next(corr), {
            "group_id": "g-s", "generation_id": 0, "member_id": member}),
        _frame(m.OFFSET_COMMIT, 8, next(corr), {
            "group_id": "g-s", "generation_id": 1, "member_id": member, "group_instance_id": None,
            "topics": [{"name": "src", "partitions": [
                {"partition_index": p, "committed_offset": p + 1, "committed_leader_epoch": -1,
                 "committed_metadata": "m%d" % p} for p in range(2)]}]}),
        offset_fetch([{"name": "src", "partition_indexes": [0, 1, 2]}]),
        init_pid("tx-s"),
        add_partitions([0, 1]),
        produce("tx-s", [("dst", p, tx_batch("dst", p, 2 + p)) for p in range(2)]),
        _frame(m.ADD_OFFSETS_TO_TXN, 1, next(corr), {
            "transactional_id": "tx-s", "producer_id": 0, "producer_epoch": 0, "group_id": "g-s"}),
        _frame(m.TXN_OFFSET_COMMIT, 2, next(corr), {
            "transactional_id": "tx-s", "group_id": "g-s", "producer_id": 0, "producer_epoch": 0,
            "topics": [{"name": "src", "partitions": [
                {"partition_index": p, "committed_offset": 10 + p, "committed_leader_epoch": -1,
                 "committed_metadata": None} for p in range(2)]}]}),
        offset_fetch([{"name": "src", "partition_indexes": [0, 1]}]),
        end_txn(True),
        offset_fetch([{"name": "src", "partition_indexes": [0, 1]}], version=1),
        add_partitions([0]),
        produce("tx-s", [("dst", 0, tx_batch("dst", 0, 3))]),
        end_txn(False),
        produce("tx-s", [("dst", 1, tx_batch("dst", 1, 1))]),
        init_pid(None, version=1),
        produce(None, [("src", 0, wire(idem[0]))]),
        produce(None, [("src", 0, wire(idem[0]))]),
        produce(None, [("src", 0, wire(idem[1]))]),
        fetch("dst", 1),
        fetch("dst", 0),
        fetch("dst", 1, version=4),
        init_pid("tx-s"),
        end_txn(True, epoch=0),
        _frame(m.DESCRIBE_GROUPS, 5, next(corr), {
            "groups": ["g-s", "nope"], "include_authorized_operations": True}),
        _frame(m.LIST_GROUPS, 3, next(corr), {"states_filter": []}),
        _frame(m.DELETE_GROUPS, 2, next(corr), {"groups_names": ["g-s"]}),
        _frame(m.LEAVE_GROUP, 4, next(corr), {
            "group_id": "g-s", "members": [{"member_id": member, "group_instance_id": None}]}),
        _frame(m.DELETE_GROUPS, 2, next(corr), {"groups_names": ["g-s", "gone"]}),
        offset_fetch(None),
    ]


class _Node:
    """One broker and its KafkaServer of either package on port 0."""

    def __init__(self, pkg: str, d: str, advertise: bool = True):
        self.pkg, self.d, self.advertise = pkg, d, advertise

    async def start(self) -> "_Node":
        if self.pkg == "port":
            from redpanda_tpu_torch.cluster.topic_table import TopicConfig
            from redpanda_tpu_torch.kafka.server import KafkaServer
            from redpanda_tpu_torch.kafka.server.broker import Broker, BrokerConfig
            from redpanda_tpu_torch.storage.log_manager import StorageApi

            kw = {"device": "cpu"}
        else:
            from redpanda_tpu.cluster.topic_table import TopicConfig
            from redpanda_tpu.kafka.server import KafkaServer
            from redpanda_tpu.kafka.server.broker import Broker, BrokerConfig
            from redpanda_tpu.storage.log_manager import StorageApi

            kw = {}
        self.TopicConfig = TopicConfig
        self.storage = await StorageApi(self.d).start()
        self.broker = Broker(BrokerConfig(data_dir=self.d), self.storage, **kw)
        self.server = await KafkaServer(self.broker, "127.0.0.1", 0).start()
        if self.advertise:
            self.broker.config.advertised_port = self.server.port
        return self

    async def stop(self) -> None:
        await self.server.stop()
        await self.storage.stop()


def _decode(raw: bytes, key: int, version: int) -> dict:
    """A response body past its header: the correlation id, and an empty
    tag buffer at a flexible version."""
    api = m.APIS[key]
    return decode_message(api, "response", raw[5 if api.is_flexible(version) else 4:], version)


def test_group_tx_frame_script_is_byte_identical_across_servers(tmp_path, monkeypatch):
    seeded = _Seeded(monkeypatch, 24)
    member = seeded.member("script", 1)
    frames = _group_tx_script(24, member)

    async def main(pkg):
        seeded.reset()
        node = await _Node(pkg, str(tmp_path / pkg), advertise=False).start()
        try:
            return await _send(node.server.port, frames)
        finally:
            await node.stop()

    ref = run(main("jax"))
    mine = run(main("port"))
    assert len(mine) == len(ref) == len(frames)
    for i, (a, b) in enumerate(zip(mine, ref)):
        assert a == b, f"response {i} differs"
    # the script did what it says
    join = _decode(mine[3], m.JOIN_GROUP, 6)
    assert (join["error_code"], join["member_id"], join["leader"]) == (0, member, member)
    commit = _decode(mine[15], m.END_TXN, 3)
    assert commit["error_code"] == 0
    sneak = _decode(mine[20], m.PRODUCE, 8)
    assert sneak["responses"][0]["partitions"][0]["error_code"] == int(ErrorCode.invalid_txn_state)
    dup, gap = (_decode(mine[i], m.PRODUCE, 8) for i in (23, 24))
    assert dup["responses"][0]["partitions"][0]["base_offset"] == -1
    assert gap["responses"][0]["partitions"][0]["error_code"] == int(
        ErrorCode.out_of_order_sequence_number)
    rc = _decode(mine[25], m.FETCH, 11)
    p0 = rc["responses"][0]["partitions"][0]
    assert p0["last_stable_offset"] == p0["high_watermark"] > 0
    assert [a["producer_id"] for a in p0["aborted_transactions"]] == [0]
    zombie = _decode(mine[29], m.END_TXN, 3)
    assert zombie["error_code"] == int(ErrorCode.invalid_producer_epoch)
    files_ref, files_mine = _tree(str(tmp_path / "jax")), _tree(str(tmp_path / "port"))
    assert any(GROUP_TOPIC in p for p in files_mine) and any("dst" in p for p in files_mine)
    assert sorted(files_mine) == sorted(files_ref)
    for p in files_ref:
        assert files_mine[p] == files_ref[p], p


# ------------------------------------------------------------ directories across packages
async def _write_tx_dir(pkg: str, d: str) -> None:
    """A committed transaction with offsets sent to a group, an aborted one,
    one left open, an idempotent producer and a simple offset commit; then
    the broker stops with the open transaction in flight."""
    if pkg == "port":
        from redpanda_tpu_torch.kafka.client import KafkaClient
        from redpanda_tpu_torch.kafka.client.producer import TransactionalProducer
    else:
        from redpanda_tpu.kafka.client import KafkaClient
        from redpanda_tpu.kafka.client.producer import TransactionalProducer
    node = await _Node(pkg, d).start()
    client = await KafkaClient([("127.0.0.1", node.server.port)]).connect()
    try:
        await client.create_topic("t", partitions=2)
        await client.produce("t", 1, [b"plain"])
        tx = await TransactionalProducer(client, "tx-a").init()
        tx.begin()
        await tx.send("t", 0, [b"c1", b"c2"])
        await tx.send("t", 1, [b"c3"])
        await tx.send_offsets("g-r", {("t", 0): 2, ("t", 1): 1})
        await tx.commit()
        tx.begin()
        await tx.send("t", 0, [b"a1"])
        await tx.abort()
        tx.begin()
        await tx.send("t", 0, [b"o1", b"o2"])
        await tx.send("t", 1, [b"o3"])
        idem = await TransactionalProducer(client).init()
        await idem.send("t", 1, [b"i1", b"i2"])
        conn = await client.any_connection()
        resp = await conn.request(m.OFFSET_COMMIT, {
            "group_id": "g-s", "generation_id": -1, "member_id": "", "group_instance_id": None,
            "retention_time_ms": -1, "topics": [{"name": "t", "partitions": [
                {"partition_index": 1, "committed_offset": 3, "committed_leader_epoch": -1,
                 "committed_metadata": "meta"}]}]})
        assert resp["topics"][0]["partitions"][0]["error_code"] == 0
    finally:
        await client.close()
        await node.stop()


async def _read_tx_dir(pkg: str, d: str) -> list:
    """What a restarted broker of ``pkg`` serves from the directory: each
    partition's read_committed fetch, its producer state machine, the
    coordinator's transactions and pid block, the groups' offsets; then
    the open transaction fenced by a new incarnation."""
    if pkg == "port":
        from redpanda_tpu_torch.kafka.client import KafkaClient
        from redpanda_tpu_torch.kafka.client.producer import TransactionalProducer
        from redpanda_tpu_torch.storage.kvstore import KeySpace
    else:
        from redpanda_tpu.kafka.client import KafkaClient
        from redpanda_tpu.kafka.client.producer import TransactionalProducer
        from redpanda_tpu.storage.kvstore import KeySpace
    node = await _Node(pkg, d).start()
    client = await KafkaClient([("127.0.0.1", node.server.port)]).connect()
    out = []
    try:
        conn = await client.any_connection()

        async def fetch_committed():
            resp = await conn.request(m.FETCH, {
                "replica_id": -1, "max_wait_ms": 0, "min_bytes": 0, "max_bytes": 1 << 20,
                "isolation_level": 1, "session_id": 0, "session_epoch": -1,
                "topics": [{"name": "t", "partitions": [
                    {"partition_index": p, "current_leader_epoch": -1, "fetch_offset": 0,
                     "log_start_offset": -1, "partition_max_bytes": 1 << 20} for p in range(2)]}],
                "forgotten_topics_data": [], "rack_id": "",
            })
            return [(p["partition_index"], p["error_code"], p["high_watermark"],
                     p["last_stable_offset"], p["aborted_transactions"], p["records"])
                    for p in resp["responses"][0]["partitions"]]

        async def offsets(gid):
            resp = await conn.request(m.OFFSET_FETCH, {"group_id": gid, "topics": None})
            return [(t["name"], p["partition_index"], p["committed_offset"], p["metadata"])
                    for t in resp["topics"] for p in t["partitions"]]

        out.append(("fetch", await fetch_committed()))
        for p in range(2):
            stm = await node.broker.recovered_rm_stm(node.broker.get_partition("t", p))
            out.append(("stm", p, stm.last_stable_offset,
                        sorted((pid, s.epoch, s.last_seq) for pid, s in stm._producers.items()),
                        sorted(stm._ongoing.items()),
                        [dataclasses.astuple(a) for a in stm._aborted]))
        txco = node.broker.tx_coordinator
        await txco._load()
        out.append(("txs", {k: v.to_dict() for k, v in sorted(txco._txs.items())}))
        out.append(("pid_block", node.storage.kvs.get(KeySpace.controller, b"id_allocator/next_block")))
        out.append(("offsets", await offsets("g-r"), await offsets("g-s")))
        again = await TransactionalProducer(client, "tx-a").init()
        fresh = await TransactionalProducer(client).init()
        out.append(("reinit", again.producer_id, again.epoch, fresh.producer_id))
        out.append(("fetch", await fetch_committed()))
        out.append(("txs", {k: v.to_dict() for k, v in sorted(txco._txs.items())}))
    finally:
        await client.close()
        await node.stop()
    return out


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tx_directory_is_resumed_across_packages(tmp_path, writer):
    """A directory one package's broker wrote with open and aborted
    transactions and committed offsets is served by both packages' brokers
    alike: the same fetches, producer state, coordinator state, pid block
    and offsets, the same fencing of the open transaction, and files
    byte-identical after it."""
    src = str(tmp_path / "written")
    run(_write_tx_dir(writer, src))
    obs = {}
    for reader in ("jax", "port"):
        d = str(tmp_path / reader)
        shutil.copytree(src, d)
        obs[reader] = run(_read_tx_dir(reader, d))
    assert obs["port"] == obs["jax"]
    (_, before), stm0, stm1, (_, txs), pid_block, offsets, reinit, (_, after), _ = obs["port"]
    p0, p1 = before
    assert p0[3] < p0[2] and p1[3] < p1[2]  # the open transaction holds the LSO back
    assert [a["producer_id"] for a in p0[4]] == [0]  # the aborted one
    assert stm0[4] and stm1[4] and stm0[5]  # open on both partitions, an aborted range on 0
    assert txs["tx-a"]["state"] == "Ongoing" and txs["tx-a"]["partitions"] == [("t", 0), ("t", 1)]
    assert pid_block == ("pid_block", b"1000")
    assert offsets[1:] == ([("t", 0, 2, None), ("t", 1, 1, None)], [("t", 1, 3, "meta")])
    assert reinit == ("reinit", 0, 1, 1000)
    assert all(p[3] == p[2] for p in after)  # the fence aborted the open transaction
    trees = {r: _tree(str(tmp_path / r)) for r in ("jax", "port")}
    assert sorted(trees["port"]) == sorted(trees["jax"])
    for p in trees["jax"]:
        assert trees["port"][p] == trees["jax"][p], p


# ------------------------------------------------------------ the gateway between two brokers
@pytest.mark.parametrize("router_pkg", ["port", "jax"])
def test_tx_router_reaches_the_leader_through_the_gateway(tmp_path, router_pkg):
    """Broker A's coordinator (``router_pkg``'s) finishes transactions over
    partitions and a group that broker B (the port's) leads: the router
    sends tx_begin and tx_marker to B's TxGatewayService over rpc, and the
    staged offsets land on B's group coordinator, none on A's."""
    from redpanda_tpu_torch import rpc
    from redpanda_tpu_torch.cluster.partition import ConsistencyLevel
    from redpanda_tpu_torch.cluster.topic_table import TopicConfig
    from redpanda_tpu_torch.kafka.server.broker import Broker, BrokerConfig
    from redpanda_tpu_torch.models.record import Record, RecordBatch
    from redpanda_tpu_torch.storage.log_manager import StorageApi

    if router_pkg == "port":
        from redpanda_tpu_torch import rpc as arpc
        from redpanda_tpu_torch.cluster import topic_table as att
        from redpanda_tpu_torch.cluster.leaders_table import PartitionLeadersTable
        from redpanda_tpu_torch.cluster.members import MembersTable
        from redpanda_tpu_torch.cluster.metadata_cache import MetadataCache
        from redpanda_tpu_torch.cluster.tx_gateway import TxRouter
        from redpanda_tpu_torch.kafka.server.broker import Broker as ABroker
        from redpanda_tpu_torch.kafka.server.broker import BrokerConfig as ABrokerConfig
        from redpanda_tpu_torch.kafka.server.group import OffsetCommit
        from redpanda_tpu_torch.storage.log_manager import StorageApi as AStorageApi

        akw = {"device": "cpu"}
    else:
        from redpanda_tpu import rpc as arpc
        from redpanda_tpu.cluster import topic_table as att
        from redpanda_tpu.cluster.leaders_table import PartitionLeadersTable
        from redpanda_tpu.cluster.members import MembersTable
        from redpanda_tpu.cluster.metadata_cache import MetadataCache
        from redpanda_tpu.cluster.tx_gateway import TxRouter
        from redpanda_tpu.kafka.server.broker import Broker as ABroker
        from redpanda_tpu.kafka.server.broker import BrokerConfig as ABrokerConfig
        from redpanda_tpu.kafka.server.group import OffsetCommit
        from redpanda_tpu.storage.log_manager import StorageApi as AStorageApi

        akw = {}

    async def main():
        sb = await StorageApi(str(tmp_path / "b")).start()
        b = Broker(BrokerConfig(node_id=1, data_dir=str(tmp_path / "b")), sb, device="cpu")
        await b.create_topic(TopicConfig("x", 2))
        gm_b = await b.group_coordinator.start()
        proto = rpc.SimpleProtocol()
        tx_gateway.TxGatewayService(b).register(proto)
        server = rpc.Server()
        server.set_protocol(proto)
        await server.start()
        sa = await AStorageApi(str(tmp_path / "a")).start()
        a = ABroker(ABrokerConfig(node_id=0, data_dir=str(tmp_path / "a")), sa, **akw)
        for name, n, policy in (("x", 2, "delete"), (GROUP_TOPIC, gm_b.n_partitions, "compact")):
            a.topic_table.add_topic(att.TopicConfig(name, n, cleanup_policy=policy),
                                    replicas_for=lambda p: [1])
        conns = arpc.ConnectionCache()
        conns.register(1, "127.0.0.1", server.port)
        a.tx_coordinator.router = TxRouter(
            a, MetadataCache(a.topic_table, MembersTable(), PartitionLeadersTable()), conns)
        gm_a = a.group_coordinator
        co = a.tx_coordinator
        try:
            assert a.get_partition("x", 0) is None
            code, pid, epoch = await co.init_producer_id("tx-r", 60_000)
            assert code == 0
            got = await co.add_partitions("tx-r", pid, epoch, [("x", 0), ("x", 1), ("x", 7)])
            assert {k: int(v) for k, v in got.items()} == {
                ("x", 0): 0, ("x", 1): 0, ("x", 7): int(ErrorCode.unknown_topic_or_partition)}
            parts = [b.get_partition("x", p) for p in range(2)]
            for p, part in enumerate(parts):
                batch = RecordBatch.build([Record(value=b"v%d" % p)], producer_id=pid,
                                          producer_epoch=epoch, base_sequence=0, transactional=True)
                stm = await b.recovered_rm_stm(part)
                code, _ = await stm.replicate([batch], ConsistencyLevel.quorum_ack)
                assert code == 0 and stm.last_stable_offset == 0
            assert int(await co.add_offsets("tx-r", pid, epoch, "g-r")) == 0
            staged = {("x", 0): OffsetCommit(1, -1, "s"), ("x", 1): OffsetCommit(1)}
            assert int(await co.txn_offset_commit("tx-r", pid, epoch, "g-r", staged)) == 0
            assert b.group_coordinator.get("g-r") is None
            assert int(await co.end_txn("tx-r", pid, epoch, True)) == 0
            for part in parts:
                last = (await part.make_reader(0, 1 << 20))[-1]
                assert rm_stm.parse_control_marker(last) == 1
                assert last.header.producer_id == pid
                stm = await b.recovered_rm_stm(part)
                assert stm.last_stable_offset == part.high_watermark == 2
            g = b.group_coordinator.get("g-r")
            assert {k: (oc.offset, oc.metadata) for k, oc in g.offsets.items()} == {
                ("x", 0): (1, "s"), ("x", 1): (1, None)}
            assert gm_a.get("g-r") is None and a.get_partition(GROUP_TOPIC, 0) is None
            # an abort writes B's abort marker and an aborted range, and moves no offset
            assert all(int(c) == 0 for c in (await co.add_partitions("tx-r", pid, epoch, [("x", 0)])).values())
            batch = RecordBatch.build([Record(value=b"gone")], producer_id=pid, producer_epoch=epoch,
                                      base_sequence=1, transactional=True)
            stm = await b.recovered_rm_stm(parts[0])
            code, res = await stm.replicate([batch], ConsistencyLevel.quorum_ack)
            assert code == 0
            assert int(await co.end_txn("tx-r", pid, epoch, False)) == 0
            last = (await parts[0].make_reader(0, 1 << 20))[-1]
            assert rm_stm.parse_control_marker(last) == 0
            assert [(x.producer_id, x.first_offset) for x in stm.aborted_ranges(0, 10)] == [
                (pid, res.base_offset)]
            assert b.group_coordinator.get("g-r").offsets[("x", 0)].offset == 1
            assert a.get_partition("x", 0) is None and a.get_partition(GROUP_TOPIC, 0) is None
        finally:
            await gm_a.stop()
            await co.stop()
            await conns.close()
            await server.stop()
            await sa.stop()
            await b.group_coordinator.stop()
            await sb.stop()

    run(main())


# ------------------------------------------------------------ a data policy over control batches
@pytest.mark.parametrize("leg", ["host", "device"])
def test_policy_fetch_rewrites_control_batches_as_the_reference(tmp_path, monkeypatch, leg):
    """A quirk kept for parity: the fetch path's data policy evaluates every
    record, control markers included, so a filter drops the commit marker
    of a transactional topic from the view (ROADMAP Queue 3). The port's
    responses are byte-identical to the JAX server's on both legs of the
    policy engine."""
    from redpanda_tpu_torch.ops.transforms import Int, Str, filter_field_eq, map_project

    spec = (filter_field_eq("level", "error") | map_project(Int("code"), Str("msg", 16))).to_json()
    seeded = _Seeded(monkeypatch, 25)
    vals = [b'{"level":"%s","code":%d,"msg":"m%d"}' % (lv, i, i)
            for i, lv in enumerate([b"error", b"info", b"error", b"warn"])]
    logged = None

    async def main(pkg):
        nonlocal logged
        seeded.reset()
        node = await _Node(pkg, str(tmp_path / pkg), advertise=False).start()
        try:
            await node.broker.create_topic(node.TopicConfig("pol", 1))
            await node.broker.set_data_policy("pol", "errs", spec)
            node.broker.policy_engine.force_engine = leg
            batch = JRecordBatch.build([JRecord(offset_delta=i, value=v) for i, v in enumerate(vals)],
                                       producer_id=0, producer_epoch=0, base_sequence=0,
                                       transactional=True)
            from redpanda_tpu.kafka.protocol.batch import encode_wire_batches

            fetches = [_frame(m.FETCH, 11, 50 + iso, {
                "replica_id": -1, "max_wait_ms": 0, "min_bytes": 0, "max_bytes": 1 << 20,
                "isolation_level": iso, "session_id": 0, "session_epoch": -1,
                "topics": [{"name": "pol", "partitions": [
                    {"partition_index": 0, "current_leader_epoch": -1, "fetch_offset": 0,
                     "log_start_offset": -1, "partition_max_bytes": 1 << 20}]}],
                "forgotten_topics_data": [], "rack_id": ""}) for iso in (1, 0)]
            frames = [
                _frame(m.INIT_PRODUCER_ID, 2, 1, {"transactional_id": "tx-p",
                                                  "transaction_timeout_ms": 60_000}),
                _frame(m.ADD_PARTITIONS_TO_TXN, 3, 2, {
                    "transactional_id": "tx-p", "producer_id": 0, "producer_epoch": 0,
                    "topics": [{"name": "pol", "partitions": [0]}]}),
                _frame(m.PRODUCE, 8, 3, {
                    "transactional_id": "tx-p", "acks": -1, "timeout_ms": 5000,
                    "topics": [{"name": "pol", "partitions": [
                        {"partition_index": 0, "records": encode_wire_batches([batch])}]}]}),
                _frame(m.END_TXN, 3, 4, {"transactional_id": "tx-p", "producer_id": 0,
                                         "producer_epoch": 0, "committed": True}),
            ] + fetches
            resps = await _send(node.server.port, frames)
            batches = await node.broker.get_partition("pol", 0).make_reader(0, 1 << 20)
            logged = [b.header.is_control for b in batches]
            return resps
        finally:
            await node.stop()

    ref = run(main("jax"))
    mine = run(main("port"))
    assert mine == ref
    assert logged == [False, True]  # the log holds the data batch and its commit marker
    for raw in mine[4:]:
        resp = _decode(raw, m.FETCH, 11)
        p = resp["responses"][0]["partitions"][0]
        assert p["error_code"] == 0 and p["high_watermark"] == 5
        from redpanda_tpu_torch.kafka.protocol.batch import decode_wire_batches

        view = [a.batch for a in decode_wire_batches(p["records"], verify_crc=False)]
        assert [b.header.is_control for b in view] == [False]  # the marker was filtered out
        assert [r.offset_delta for r in view[0].records()] == [0, 2]
