"""Async Kafka client (the JAX package's kafka/client/client.py).

Parity surface (kafka/client/client.h): broker connections with correlated
in-flight requests, metadata-driven topic routing, produce/fetch/offsets,
topic admin, and group membership calls (used by the group-aware consumer).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import struct

from redpanda_tpu_torch.kafka.protocol import messages as m
from redpanda_tpu_torch.kafka.protocol.batch import decode_wire_batches, encode_wire_batches
from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode, KafkaError
from redpanda_tpu_torch.kafka.protocol.primitives import Reader
from redpanda_tpu_torch.kafka.protocol.schema import RequestHeader, decode_message, encode_message
from redpanda_tpu_torch.models.record import Record, RecordBatch

logger = logging.getLogger("rptpu.kafka.client")


class BrokerConnection:
    """One TCP connection with correlation-id request/response matching
    (kafka/client/broker.h + transport)."""

    def __init__(
        self,
        host: str,
        port: int,
        client_id: str = "rptpu-client",
        sasl: tuple[str, str] | None = None,
        sasl_mechanism: str = "SCRAM-SHA-256",
        ssl_context=None,
    ):
        self.host = host
        self.port = port
        self.client_id = client_id
        self.sasl = sasl  # (username, password) enables the SCRAM dance
        self.sasl_mechanism = sasl_mechanism
        self.ssl_context = ssl_context
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._correlation = itertools.count(1)
        self._inflight: dict[int, tuple] = {}  # corr -> (future, api, version)
        self._recv_task: asyncio.Task | None = None
        self._versions: dict[int, tuple[int, int]] = {}
        self._lock = asyncio.Lock()

    async def connect(self) -> "BrokerConnection":
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, ssl=self.ssl_context
        )
        self._recv_task = asyncio.create_task(self._recv_loop())
        vs = await self.request(m.API_VERSIONS, {}, version=0)
        if vs["error_code"] == 0:
            self._versions = {
                e["api_key"]: (e["min_version"], e["max_version"]) for e in vs["api_keys"]
            }
        if self.sasl is not None:
            await self._authenticate()
        return self

    async def _authenticate(self) -> None:
        """SCRAM over SaslHandshake/SaslAuthenticate (client/sasl_client).
        The port has no SCRAM yet (ROADMAP item 10d): a connection asked to
        authenticate raises rather than talk to the broker unauthenticated."""
        raise NotImplementedError(
            "SASL/SCRAM is not ported yet (ROADMAP item 10d); "
            "connect without sasl="
        )

    async def close(self) -> None:
        if self._recv_task:
            self._recv_task.cancel()
            try:
                await self._recv_task
            except asyncio.CancelledError:
                pass
        if self._writer:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
        for fut, _api, _v in self._inflight.values():
            if not fut.done():
                fut.set_exception(ConnectionError("connection closed"))
        self._inflight.clear()

    def negotiated_version(self, api_key: int, preferred: int | None = None) -> int:
        api = m.APIS[api_key]
        lo, hi = self._versions.get(api_key, (api.min_version, api.max_version))
        v = min(api.max_version, hi) if preferred is None else min(preferred, hi, api.max_version)
        if v < max(api.min_version, lo):
            raise KafkaError(ErrorCode.unsupported_version, f"api {api_key}")
        return v

    async def request(self, api_key: int, body: dict, version: int | None = None) -> dict:
        api = m.APIS[api_key]
        v = self.negotiated_version(api_key) if version is None else version
        corr = next(self._correlation)
        header = RequestHeader(api_key, v, corr, self.client_id)
        payload = header.encode(api.is_flexible(v)) + encode_message(api, "request", body, v)
        fut = asyncio.get_running_loop().create_future()
        self._inflight[corr] = (fut, api, v)
        async with self._lock:
            self._writer.write(struct.pack(">i", len(payload)) + payload)
            await self._writer.drain()
        return await fut

    async def oneway(self, api_key: int, body: dict, version: int | None = None) -> None:
        """Fire-and-forget (acks=0 produce has no response frame)."""
        api = m.APIS[api_key]
        v = self.negotiated_version(api_key) if version is None else version
        corr = next(self._correlation)
        header = RequestHeader(api_key, v, corr, self.client_id)
        payload = header.encode(api.is_flexible(v)) + encode_message(api, "request", body, v)
        async with self._lock:
            self._writer.write(struct.pack(">i", len(payload)) + payload)
            await self._writer.drain()

    async def _recv_loop(self) -> None:
        try:
            while True:
                size_buf = await self._reader.readexactly(4)
                (size,) = struct.unpack(">i", size_buf)
                frame = await self._reader.readexactly(size)
                r = Reader(frame)
                corr = r.int32()
                entry = self._inflight.pop(corr, None)
                if entry is None:
                    continue
                fut, api, v = entry
                if api.is_flexible(v) and api.key != m.API_VERSIONS:
                    r.tagged_fields()
                try:
                    resp = decode_message(api, "response", frame[r.pos :], v)
                    if not fut.done():
                        fut.set_result(resp)
                except Exception as e:  # noqa: BLE001
                    if not fut.done():
                        fut.set_exception(e)
        except asyncio.CancelledError:
            pass
        except Exception:  # noqa: BLE001 — any framing error kills the connection
            logger.exception("broker connection receive loop failed")
        finally:
            # Whatever ended the loop, nothing will ever complete these.
            for entry in self._inflight.values():
                fut = entry[0]
                if not fut.done():
                    fut.set_exception(ConnectionError("connection lost"))
            self._inflight.clear()


class KafkaClient:
    """Metadata-routed multi-broker client (kafka/client/client.h)."""

    def __init__(
        self,
        bootstrap: list[tuple[str, int]],
        client_id: str = "rptpu-client",
        sasl: tuple[str, str] | None = None,
        sasl_mechanism: str = "SCRAM-SHA-256",
        ssl_context=None,
    ):
        self.bootstrap = bootstrap
        self.client_id = client_id
        self.sasl = sasl
        self.sasl_mechanism = sasl_mechanism
        self.ssl_context = ssl_context
        self._conns: dict[int, BrokerConnection] = {}
        self._brokers: dict[int, tuple[str, int]] = {}
        self._leaders: dict[tuple[str, int], int] = {}
        self._bootstrap_conn: BrokerConnection | None = None
        self._conn_lock = asyncio.Lock()

    def _new_conn(self, host: str, port: int) -> BrokerConnection:
        return BrokerConnection(
            host, port, self.client_id, sasl=self.sasl,
            sasl_mechanism=self.sasl_mechanism, ssl_context=self.ssl_context,
        )

    async def connect(self) -> "KafkaClient":
        host, port = self.bootstrap[0]
        self._bootstrap_conn = await self._new_conn(host, port).connect()
        await self.refresh_metadata()
        return self

    async def close(self) -> None:
        for conn in self._conns.values():
            await conn.close()
        self._conns.clear()
        if self._bootstrap_conn:
            await self._bootstrap_conn.close()

    # ------------------------------------------------------------ metadata
    async def refresh_metadata(
        self, topics: list[str] | None = None, *, auto_create: bool = True
    ) -> dict:
        body = {
            "topics": None if topics is None else [{"name": t} for t in topics],
            "allow_auto_topic_creation": auto_create,
        }
        md = await self._bootstrap_conn.request(m.METADATA, body)
        for b in md["brokers"]:
            self._brokers[b["node_id"]] = (b["host"], b["port"])
        for t in md["topics"]:
            for p in t.get("partitions") or []:
                if p["leader_id"] >= 0:
                    self._leaders[(t["name"], p["partition_index"])] = p["leader_id"]
        return md

    async def connection_for(self, node_id: int) -> BrokerConnection:
        async with self._conn_lock:
            if node_id not in self._conns:
                host, port = self._brokers[node_id]
                self._conns[node_id] = await self._new_conn(host, port).connect()
            return self._conns[node_id]

    async def leader_connection(self, topic: str, partition: int) -> BrokerConnection:
        key = (topic, partition)
        if key not in self._leaders:
            # A just-created partition is mid-election (leader_id -1 in
            # metadata); standard client behavior polls metadata rather
            # than failing the first produce after create_topic.
            deadline = asyncio.get_event_loop().time() + 10.0
            while True:
                await self.refresh_metadata([topic])
                if key in self._leaders:
                    break
                if asyncio.get_event_loop().time() > deadline:
                    raise KafkaError(
                        ErrorCode.unknown_topic_or_partition, f"{topic}/{partition}"
                    )
                await asyncio.sleep(0.25)
        return await self.connection_for(self._leaders[key])

    async def any_connection(self) -> BrokerConnection:
        return self._bootstrap_conn

    # ------------------------------------------------------------ produce
    async def produce(
        self,
        topic: str,
        partition: int,
        records: list[tuple[bytes | None, bytes | None]] | list[bytes],
        *,
        acks: int = -1,
        timeout_ms: int = 30000,
    ) -> int:
        """Produce one batch; returns the assigned base offset."""
        recs = []
        for i, r in enumerate(records):
            key, value = r if isinstance(r, tuple) else (None, r)
            recs.append(Record(offset_delta=i, key=key, value=value))
        batch = RecordBatch.build(recs)
        return await self.produce_batches(
            topic, partition, [batch], acks=acks, timeout_ms=timeout_ms
        )

    async def produce_batches(
        self,
        topic: str,
        partition: int,
        batches: list[RecordBatch],
        *,
        acks: int = -1,
        timeout_ms: int = 30000,
    ) -> int:
        conn = await self.leader_connection(topic, partition)
        body = {
            "transactional_id": None,
            "acks": acks,
            "timeout_ms": timeout_ms,
            "topics": [
                {
                    "name": topic,
                    "partitions": [
                        {
                            "partition_index": partition,
                            "records": encode_wire_batches(batches),
                        }
                    ],
                }
            ],
        }
        if acks == 0:
            await conn.oneway(m.PRODUCE, body)
            return -1
        resp = await conn.request(m.PRODUCE, body)
        presp = resp["responses"][0]["partitions"][0]
        if presp["error_code"] != 0:
            raise KafkaError(ErrorCode(presp["error_code"]), f"produce {topic}/{partition}")
        return presp["base_offset"]

    # ------------------------------------------------------------ fetch
    async def fetch(
        self,
        topic: str,
        partition: int,
        offset: int,
        *,
        max_bytes: int = 1 << 20,
        max_wait_ms: int = 100,
        min_bytes: int = 1,
        isolation_level: int = 0,
    ) -> tuple[list[RecordBatch], int]:
        """Returns (batches, high_watermark). isolation_level=1 =
        read_committed (server clamps to LSO; aborted batches filtered
        client-side via the aborted_transactions ranges)."""
        conn = await self.leader_connection(topic, partition)
        body = {
            "replica_id": -1,
            "max_wait_ms": max_wait_ms,
            "min_bytes": min_bytes,
            "max_bytes": max_bytes,
            "isolation_level": isolation_level,
            "session_id": 0,
            "session_epoch": -1,
            "topics": [
                {
                    "name": topic,
                    "partitions": [
                        {
                            "partition_index": partition,
                            "current_leader_epoch": -1,
                            "fetch_offset": offset,
                            "log_start_offset": -1,
                            "partition_max_bytes": max_bytes,
                        }
                    ],
                }
            ],
            "forgotten_topics_data": [],
            "rack_id": "",
        }
        resp = await conn.request(m.FETCH, body)
        presp = resp["responses"][0]["partitions"][0]
        if presp["error_code"] != 0:
            raise KafkaError(ErrorCode(presp["error_code"]), f"fetch {topic}/{partition}")
        records = presp.get("records")
        batches = []
        if records:
            batches = [a.batch for a in decode_wire_batches(records) if a.batch is not None]
        if isolation_level != 1:
            # control batches (tx markers) are transport metadata, never
            # application records — skipped at EVERY isolation level
            batches = [b for b in batches if not b.header.is_control]
        if isolation_level == 1:
            # Standard read_committed consumer: a pid becomes "aborted" at
            # its advertised first_offset and stops being aborted at its
            # control marker — offsets after the marker are a NEW tx.
            pending = sorted(
                (a["first_offset"], a["producer_id"])
                for a in presp.get("aborted_transactions") or []
            )
            aborted_active: set[int] = set()
            visible = []
            for b in batches:
                while pending and pending[0][0] <= b.header.base_offset:
                    aborted_active.add(pending.pop(0)[1])
                if b.header.is_control:
                    aborted_active.discard(b.header.producer_id)
                    continue
                if b.header.is_transactional and b.header.producer_id in aborted_active:
                    continue
                visible.append(b)
            batches = visible
        return batches, presp["high_watermark"]

    # ------------------------------------------------------------ offsets
    async def list_offset(self, topic: str, partition: int, timestamp: int) -> int:
        conn = await self.leader_connection(topic, partition)
        body = {
            "replica_id": -1,
            "isolation_level": 0,
            "topics": [
                {
                    "name": topic,
                    "partitions": [
                        {
                            "partition_index": partition,
                            "current_leader_epoch": -1,
                            "timestamp": timestamp,
                        }
                    ],
                }
            ],
        }
        resp = await conn.request(m.LIST_OFFSETS, body)
        presp = resp["topics"][0]["partitions"][0]
        if presp["error_code"] != 0:
            raise KafkaError(ErrorCode(presp["error_code"]), f"list_offsets {topic}")
        return presp["offset"]

    async def earliest_offset(self, topic: str, partition: int) -> int:
        return await self.list_offset(topic, partition, -2)

    async def latest_offset(self, topic: str, partition: int) -> int:
        return await self.list_offset(topic, partition, -1)

    # ------------------------------------------------------------ admin
    async def create_topic(
        self,
        name: str,
        partitions: int = 1,
        replication: int = 1,
        configs: dict[str, str] | None = None,
    ) -> None:
        conn = await self.any_connection()
        body = {
            "topics": [
                {
                    "name": name,
                    "num_partitions": partitions,
                    "replication_factor": replication,
                    "assignments": [],
                    "configs": [
                        {"name": k, "value": v} for k, v in (configs or {}).items()
                    ],
                }
            ],
            "timeout_ms": 30000,
            "validate_only": False,
        }
        resp = await conn.request(m.CREATE_TOPICS, body)
        tr = resp["topics"][0]
        if tr["error_code"] != 0:
            raise KafkaError(ErrorCode(tr["error_code"]), f"create_topic {name}")
        await self.refresh_metadata([name])

    async def delete_topic(self, name: str) -> None:
        conn = await self.any_connection()
        resp = await conn.request(
            m.DELETE_TOPICS, {"topic_names": [name], "timeout_ms": 30000}
        )
        tr = resp["responses"][0]
        if tr["error_code"] != 0:
            raise KafkaError(ErrorCode(tr["error_code"]), f"delete_topic {name}")
        for key in [k for k in self._leaders if k[0] == name]:
            del self._leaders[key]
