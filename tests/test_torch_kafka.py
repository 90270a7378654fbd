"""The port's Kafka front door (redpanda_tpu_torch/kafka/server, the
``Broker``'s data plane and kafka/client) against the JAX package's: every
test of tests/test_kafka.py on the port's server and client, each
package's client against the other's server, one seeded frame script whose
responses and data files must be byte-identical across the two servers,
and one test per standing departure of the port.
"""

from __future__ import annotations

import asyncio
import os
import struct

import numpy as np
import pytest

from test_torch_kafka_wire import KAFKA_TWIN, _crc_default, _twin_id  # noqa: F401
from redpanda_tpu.kafka.client import KafkaClient as JKafkaClient
from redpanda_tpu.kafka.protocol.batch import encode_wire_batches as j_encode_wire_batches
from redpanda_tpu.kafka.server import KafkaServer as JKafkaServer
from redpanda_tpu.kafka.server.broker import Broker as JBroker
from redpanda_tpu.kafka.server.broker import BrokerConfig as JBrokerConfig
from redpanda_tpu.models.record import Record as JRecord
from redpanda_tpu.models.record import RecordBatch as JRecordBatch
from redpanda_tpu.storage.log_manager import StorageApi as JStorageApi
from redpanda_tpu_torch.kafka.client import KafkaClient
from redpanda_tpu_torch.kafka.protocol import messages as m
from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode
from redpanda_tpu_torch.kafka.protocol.primitives import Reader
from redpanda_tpu_torch.kafka.protocol.schema import RequestHeader, decode_message, encode_message
from redpanda_tpu_torch.kafka.server import KafkaServer
from redpanda_tpu_torch.kafka.server.broker import Broker, BrokerConfig
from redpanda_tpu_torch.models.record import Record, RecordBatch
from redpanda_tpu_torch.ops import crc_backend
from redpanda_tpu_torch.storage.log_manager import StorageApi


def run(coro):
    return asyncio.run(coro)


# ------------------------------------------------------------ test_kafka.py on the port
@pytest.mark.parametrize("case", KAFKA_TWIN.tests(), ids=_twin_id)
def test_reference_kafka_suite_on_the_port(case, monkeypatch, tmp_path):
    """Every case of test_kafka.py, its names taken from the port (the
    KIP-430 case sets ``broker.authorizer`` over bindings, as it does on
    the reference)."""
    name, params = case
    KAFKA_TWIN.run(name, monkeypatch, tmp_path=tmp_path, **params)


def test_kafka_twin_covers_the_reference_module():
    assert len({n for n, _ in KAFKA_TWIN.tests()}) == 16
    assert KAFKA_TWIN.globals["KafkaServer"] is KafkaServer
    assert KAFKA_TWIN.globals["KafkaClient"] is KafkaClient
    assert "redpanda_tpu.security.acl" in KAFKA_TWIN.local_imports


# ------------------------------------------------------------ helpers
class _Node:
    """One broker and its KafkaServer of either package on port 0."""

    def __init__(self, pkg: str, d: str, **cfg):
        self.pkg, self.d, self.cfg = pkg, d, cfg

    async def start(self) -> "_Node":
        if self.pkg == "port":
            self.storage = await StorageApi(self.d).start()
            self.broker = Broker(BrokerConfig(data_dir=self.d, **self.cfg), self.storage, device="cpu")
            self.server = await KafkaServer(self.broker, "127.0.0.1", 0).start()
        else:
            self.storage = await JStorageApi(self.d).start()
            self.broker = JBroker(JBrokerConfig(data_dir=self.d, **self.cfg), self.storage)
            self.server = await JKafkaServer(self.broker, "127.0.0.1", 0).start()
        return self

    async def stop(self) -> None:
        await self.server.stop()
        await self.storage.stop()


def _values(batches) -> list:
    return [(r.key, r.value) for b in batches for r in b.records()]


# ------------------------------------------------------------ across packages
@pytest.mark.parametrize("server_pkg,client_pkg", [("port", "jax"), ("jax", "port")])
def test_client_of_one_package_against_server_of_the_other(tmp_path, server_pkg, client_pkg):
    rng = np.random.default_rng(7)
    values = [rng.bytes(int(rng.integers(1, 2000))) for _ in range(40)]

    async def main():
        node = await _Node(server_pkg, str(tmp_path)).start()
        node.broker.config.advertised_port = node.server.port
        Client = KafkaClient if client_pkg == "port" else JKafkaClient
        client = await Client([("127.0.0.1", node.server.port)]).connect()
        try:
            await client.create_topic("x", partitions=2)
            for i in range(0, 40, 8):
                base = await client.produce("x", i // 8 % 2, [(b"k%d" % j, values[j]) for j in range(i, i + 8)])
                assert base == (i // 16) * 8
            got = {}
            for p in range(2):
                batches, hwm = await client.fetch("x", p, 0)
                got[p] = _values(batches)
                assert hwm == len(got[p])
                assert await client.latest_offset("x", p) == hwm
            want = {p: [(b"k%d" % j, values[j]) for i in range(0, 40, 8) if i // 8 % 2 == p
                        for j in range(i, i + 8)] for p in range(2)}
            assert got == want
        finally:
            await client.close()
            await node.stop()

    run(main())


def test_start_recovers_the_topic_tree(tmp_path):
    """A single-node KafkaServer recovers the topic tree on start: after a
    restart over the same directory the topics, their configs and their
    records are served again with no create."""
    rng = np.random.default_rng(11)
    values = [rng.bytes(int(rng.integers(1, 300))) for _ in range(12)]

    async def main():
        for restart in (False, True):
            node = await _Node("port", str(tmp_path)).start()
            node.broker.config.advertised_port = node.server.port
            client = await KafkaClient([("127.0.0.1", node.server.port)]).connect()
            try:
                if not restart:
                    await client.create_topic("kept", partitions=2, configs={"retention.ms": "86400000"})
                    for p in range(2):
                        await client.produce("kept", p, values[6 * p:6 * p + 6])
                else:
                    md = node.broker.topic_table.get("kept")
                    assert md.config.partition_count == 2
                    assert md.config.config_map()["retention.ms"] == "86400000"
                    for p in range(2):
                        batches, hwm = await client.fetch("kept", p, 0)
                        assert hwm == 6
                        assert [r.value for b in batches for r in b.records()] == values[6 * p:6 * p + 6]
            finally:
                await client.close()
                await node.stop()

    run(main())


# ------------------------------------------------------------ the frame script
def _frame(key: int, version: int, corr: int, body: dict) -> bytes:
    api = m.APIS[key]
    return RequestHeader(key, version, corr, "script").encode(api.is_flexible(version)) + \
        encode_message(api, "request", body, version)


def _script(seed: int) -> list[bytes]:
    """Create two topics, read metadata, produce seeded batches (one with a
    flipped record byte), fetch, list offsets, describe and alter configs,
    delete records and a topic, read metadata again."""
    rng = np.random.default_rng(seed)
    corr = iter(range(1, 1000))

    def batches(n, base=0):
        out = []
        for _ in range(n):
            recs = [JRecord(offset_delta=j, timestamp_delta=j, key=rng.bytes(4),
                            value=rng.bytes(int(rng.integers(1, 600))))
                    for j in range(int(rng.integers(1, 6)))]
            out.append(JRecordBatch.build(recs, first_timestamp=1_700_000_000_000 + len(out)))
        return out

    def produce(parts, version=7):
        return _frame(m.PRODUCE, version, next(corr), {
            "transactional_id": None, "acks": -1, "timeout_ms": 5000,
            "topics": [{"name": t, "partitions": [{"partition_index": p, "records": r}
                                                  for p, r in ps]} for t, ps in parts],
        })

    def fetch(offsets, version=11):
        return _frame(m.FETCH, version, next(corr), {
            "replica_id": -1, "max_wait_ms": 0, "min_bytes": 0, "max_bytes": 1 << 22,
            "isolation_level": 0, "session_id": 0, "session_epoch": -1,
            "topics": [{"name": t, "partitions": [
                {"partition_index": p, "current_leader_epoch": -1, "fetch_offset": o,
                 "log_start_offset": -1, "partition_max_bytes": 1 << 20}
                for p, o in ps]} for t, ps in offsets],
            "forgotten_topics_data": [], "rack_id": "",
        })

    def list_offsets(ts):
        return _frame(m.LIST_OFFSETS, 5, next(corr), {
            "replica_id": -1, "isolation_level": 0,
            "topics": [{"name": "fs-a", "partitions": [
                {"partition_index": p, "current_leader_epoch": -1, "timestamp": ts}
                for p in range(3)]}],
        })

    def describe(keys=None):
        return _frame(m.DESCRIBE_CONFIGS, 2, next(corr), {"resources": [
            {"resource_type": 2, "resource_name": "fs-a", "configuration_keys": keys},
            {"resource_type": 2, "resource_name": "nope", "configuration_keys": None},
            {"resource_type": 4, "resource_name": "0", "configuration_keys": None},
        ], "include_synonyms": False})

    def metadata(version, topics):
        return _frame(m.METADATA, version, next(corr), {
            "topics": topics, "allow_auto_topic_creation": False,
            "include_cluster_authorized_operations": version >= 8,
            "include_topic_authorized_operations": version >= 8,
        })

    wire = {p: j_encode_wire_batches(batches(int(rng.integers(2, 6)))) for p in range(3)}
    bad = bytearray(j_encode_wire_batches(batches(2)))
    bad[61 + 3] ^= 0x20  # a record byte of the first batch
    frames = [
        _frame(m.CREATE_TOPICS, 5, next(corr), {"topics": [
            {"name": "fs-a", "num_partitions": 3, "replication_factor": 1, "assignments": [],
             "configs": [{"name": "cleanup.policy", "value": "delete"}]},
            {"name": "fs-b", "num_partitions": 1, "replication_factor": 1, "assignments": [],
             "configs": []},
            {"name": "bad name!", "num_partitions": 1, "replication_factor": 1,
             "assignments": [], "configs": []},
        ], "timeout_ms": 5000, "validate_only": False}),
        _frame(m.CREATE_TOPICS, 2, next(corr), {"topics": [
            {"name": "fs-a", "num_partitions": 1, "replication_factor": 1, "assignments": [],
             "configs": []}], "timeout_ms": 5000, "validate_only": False}),
        metadata(1, None),
        metadata(9, [{"name": "fs-a"}, {"name": "missing"}]),
        produce([("fs-a", [(0, wire[0])])]),
        produce([("fs-a", [(1, wire[1]), (2, wire[2])]), ("fs-b", [(0, wire[0])])], version=8),
        produce([("fs-a", [(1, bytes(bad))])]),
        produce([("fs-a", [(0, wire[2]), (7, wire[1])])], version=3),
        fetch([("fs-a", [(0, 0), (1, 0), (2, 0)]), ("fs-b", [(0, 0)])]),
        fetch([("fs-a", [(1, 2)])], version=4),
        list_offsets(-2),
        list_offsets(-1),
        describe(),
        describe(["cleanup.policy", "retention.ms"]),
        _frame(m.INCREMENTAL_ALTER_CONFIGS, 1, next(corr), {"resources": [
            {"resource_type": 2, "resource_name": "fs-a", "configs": [
                {"name": "retention.ms", "config_operation": 0, "value": "3600000"},
                {"name": "segment.bytes", "config_operation": 0, "value": "1048576"}]},
            {"resource_type": 2, "resource_name": "nope", "configs": []},
        ], "validate_only": False}),
        describe(),
        _frame(m.DELETE_RECORDS, 1, next(corr), {"topics": [{"name": "fs-a", "partitions": [
            {"partition_index": 0, "offset": 2}, {"partition_index": 1, "offset": 10_000},
            {"partition_index": 2, "offset": -1}]}], "timeout_ms": 5000}),
        fetch([("fs-a", [(0, 0), (0, 2), (2, 0)])]),
        list_offsets(-2),
        _frame(m.DELETE_TOPICS, 4, next(corr), {"topic_names": ["fs-b", "nope"], "timeout_ms": 5000}),
        metadata(9, None),
    ]
    return frames


async def _send(port: int, frames: list[bytes]) -> list[bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    out = []
    try:
        for f in frames:
            writer.write(struct.pack(">i", len(f)) + f)
            await writer.drain()
            (n,) = struct.unpack(">i", await reader.readexactly(4))
            out.append(await reader.readexactly(n))
    finally:
        writer.close()
        await writer.wait_closed()
    return out


def _tree(d: str) -> dict[str, bytes]:
    out = {}
    for root, _, files in os.walk(d):
        for f in files:
            p = os.path.join(root, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, d)] = fh.read()
    return out


def test_frame_script_is_byte_identical_across_servers(tmp_path):
    frames = _script(23)

    async def main(pkg):
        node = await _Node(pkg, str(tmp_path / pkg)).start()
        try:
            return await _send(node.server.port, frames)
        finally:
            await node.stop()

    ref = run(main("jax"))
    mine = run(main("port"))
    assert len(mine) == len(ref) == len(frames)
    for i, (a, b) in enumerate(zip(mine, ref)):
        assert a == b, f"response {i} differs"
    # the script did what it says: the flipped byte is corrupt_message,
    # the unknown partition is refused, a topic went away
    r = Reader(mine[6])
    assert r.int32() == 7
    resp = decode_message(m.APIS[m.PRODUCE], "response", mine[6][r.pos:], 7)
    assert resp["responses"][0]["partitions"][0]["error_code"] == int(ErrorCode.corrupt_message)
    files_ref, files_mine = _tree(str(tmp_path / "jax")), _tree(str(tmp_path / "port"))
    assert any("fs-a" in p for p in files_mine) and not any("fs-b" in p for p in files_mine)
    assert sorted(files_mine) == sorted(files_ref)
    for p in files_ref:
        assert files_mine[p] == files_ref[p], p


# ------------------------------------------------------------ standing departures
_NO_HANDLER = [m.JOIN_GROUP, m.OFFSET_COMMIT, m.FIND_COORDINATOR, m.INIT_PRODUCER_ID,
               m.END_TXN, m.SASL_HANDSHAKE, m.DESCRIBE_ACLS, m.CREATE_ACLS]
_SECURITY_KEYS = {m.SASL_HANDSHAKE, m.DESCRIBE_ACLS, m.CREATE_ACLS}


async def _versions_then(port: int, key: int) -> tuple[bytes, bytes | None]:
    """ApiVersions, then ``key`` at its top version with an empty body:
    the two raw answers (None for the second when the server closed the
    connection instead)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        f = _frame(key, m.APIS[key].max_version, 5, {})
        versions = _frame(m.API_VERSIONS, 0, 6, {})
        writer.write(struct.pack(">i", len(versions)) + versions)
        writer.write(struct.pack(">i", len(f)) + f)
        await writer.drain()
        (n,) = struct.unpack(">i", await reader.readexactly(4))
        first = await reader.readexactly(n)
        head = await reader.read(4)
        if not head:
            return first, None
        (n,) = struct.unpack(">i", head)
        return first, await reader.readexactly(n)
    finally:
        writer.close()


@pytest.mark.parametrize("key", _NO_HANDLER, ids=[m.APIS[k].name for k in _NO_HANDLER])
def test_group_tx_sasl_acl_keys_get_the_no_handler_answer(tmp_path, key):
    """The SASL and ACL keys have no handler yet (ROADMAP item 10d): such a
    request gets the reference's answer for a key with no handler (the
    connection is closed), while ApiVersions still advertises the whole
    APIS table. The group and transaction keys are registered, and the
    port's answer to the same frame is byte-identical to the JAX server's."""

    async def main(pkg):
        node = await _Node(pkg, str(tmp_path / pkg)).start()
        try:
            assert (key in node.server.handlers) == (key not in _SECURITY_KEYS)
            return await _versions_then(node.server.port, key)
        finally:
            await node.stop()

    versions, answer = run(main("port"))
    resp = decode_message(m.APIS[m.API_VERSIONS], "response", versions[4:], 0)
    assert resp["error_code"] == 0
    assert sorted(e["api_key"] for e in resp["api_keys"]) == sorted(m.APIS)
    if key in _SECURITY_KEYS:
        assert answer is None  # closed, no answer
        return
    ref_versions, ref_answer = run(main("jax"))
    assert answer is not None and (versions, answer) == (ref_versions, ref_answer)
    r = Reader(answer)
    assert r.int32() == 5


def test_sasl_broker_is_refused_at_construction(tmp_path):
    """No SCRAM yet: a KafkaServer over a broker with sasl_enabled is
    refused, and a client asked to authenticate raises."""

    async def main():
        storage = await StorageApi(str(tmp_path)).start()
        try:
            broker = Broker(BrokerConfig(data_dir=str(tmp_path), sasl_enabled=True), storage,
                            device="cpu")
            assert broker.sasl_enabled
            with pytest.raises(NotImplementedError, match="10d"):
                KafkaServer(broker, "127.0.0.1", 0)
            with pytest.raises(NotImplementedError, match="10d"):
                await KafkaClient([("127.0.0.1", 1)], sasl=("u", "p"))._new_conn("h", 1)._authenticate()
        finally:
            await storage.stop()

    run(main())


def test_producer_state_requests_answer_unknown_server_error(tmp_path):
    """The producer state machine is ported: an idempotent produce sent
    twice is appended once (the retry is acked with base_offset -1), and a
    read_committed fetch is answered with error 0 and the last stable
    offset, as the reference answers them."""
    from redpanda_tpu_torch.cluster.rm_stm import RmStm
    from redpanda_tpu_torch.kafka.protocol.batch import encode_wire_batches

    async def main():
        node = await _Node("port", str(tmp_path)).start()
        node.broker.config.advertised_port = node.server.port
        client = await KafkaClient([("127.0.0.1", node.server.port)]).connect()
        try:
            await client.create_topic("idem", partitions=1)
            await client.produce("idem", 0, [b"plain"])
            stm = await node.broker.recovered_rm_stm(node.broker.get_partition("idem", 0))
            assert isinstance(stm, RmStm)
            b = RecordBatch.build([Record(value=b"v")], producer_id=5, producer_epoch=0, base_sequence=0)
            conn = await client.leader_connection("idem", 0)
            body = {
                "transactional_id": None, "acks": -1, "timeout_ms": 1000,
                "topics": [{"name": "idem", "partitions": [
                    {"partition_index": 0, "records": encode_wire_batches([b])}]}],
            }
            first = (await conn.request(m.PRODUCE, body))["responses"][0]["partitions"][0]
            again = (await conn.request(m.PRODUCE, body))["responses"][0]["partitions"][0]
            assert (first["error_code"], first["base_offset"]) == (0, 1)
            assert (again["error_code"], again["base_offset"]) == (0, -1)
            resp = await conn.request(m.FETCH, {
                "replica_id": -1, "max_wait_ms": 0, "min_bytes": 0, "max_bytes": 1 << 20,
                "isolation_level": 1, "session_id": 0, "session_epoch": -1,
                "topics": [{"name": "idem", "partitions": [
                    {"partition_index": 0, "current_leader_epoch": -1, "fetch_offset": 0,
                     "log_start_offset": -1, "partition_max_bytes": 1 << 20}]}],
                "forgotten_topics_data": [], "rack_id": "",
            })
            p = resp["responses"][0]["partitions"][0]
            assert p["error_code"] == 0
            assert p["last_stable_offset"] == p["high_watermark"] == stm.last_stable_offset == 2
            assert p["aborted_transactions"] is None
            assert await client.latest_offset("idem", 0) == 2
        finally:
            await client.close()
            await node.stop()

    run(main())


def test_installed_crc_backend_is_the_produce_paths(tmp_path):
    """``install_default_backend`` pins the produce path's backend (one
    validate call per partition of a request); None forgets it and the
    next produce picks again on the broker's device."""
    calls = []

    class Counting(crc_backend.CrcBackend):
        def validate(self, regions, claimed):
            calls.append(len(regions))
            return super().validate(regions, claimed)

    async def main():
        node = await _Node("port", str(tmp_path)).start()
        node.broker.config.advertised_port = node.server.port
        client = await KafkaClient([("127.0.0.1", node.server.port)]).connect()
        try:
            await client.create_topic("crc", partitions=3)
            pinned = Counting("device", device="cpu")
            crc_backend.install_default_backend(pinned)
            assert crc_backend.default_backend("cuda") is pinned
            batches = [RecordBatch.build([Record(value=b"%d" % i)]) for i in range(4)]
            from redpanda_tpu_torch.kafka.protocol.batch import encode_wire_batches

            conn = await client.leader_connection("crc", 0)
            resp = await conn.request(m.PRODUCE, {
                "transactional_id": None, "acks": -1, "timeout_ms": 1000,
                "topics": [{"name": "crc", "partitions": [
                    {"partition_index": p, "records": encode_wire_batches(batches[:p + 1])}
                    for p in range(3)]}],
            })
            assert all(p["error_code"] == 0 for p in resp["responses"][0]["partitions"])
            assert sorted(calls) == [1, 2, 3]
            crc_backend.install_default_backend(None)
            await client.produce("crc", 0, [b"again"])
            assert len(calls) == 3
            picked = crc_backend.default_backend("cpu")
            assert picked is not pinned and picked.decision is not None
        finally:
            await client.close()
            await node.stop()

    run(main())


def test_start_on_cuda_without_a_card_raises_and_listens_on_nothing(tmp_path, monkeypatch):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    started = []
    monkeypatch.setattr(asyncio, "start_server", lambda *a, **k: started.append(a))

    async def main():
        storage = await StorageApi(str(tmp_path)).start()
        try:
            broker = Broker(BrokerConfig(data_dir=str(tmp_path)), storage)  # device="cuda"
            server = KafkaServer(broker, "127.0.0.1", 0)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                await server.start()
            assert server._server is None and not started
            await server.stop()
        finally:
            await storage.stop()

    run(main())
