"""Idempotent + transactional producer.

Parity with kafka/client produce_batcher + the reference ducktape
tx-verifier's client behavior: InitProducerId, per-partition sequence
numbering, AddPartitionsToTxn before first transactional send, EndTxn
commit/abort, and send_offsets for consume-transform-produce EOS.

(The JAX package's kafka/client/producer.py, copied.)
"""

from __future__ import annotations

import asyncio

from redpanda_tpu_torch.kafka.protocol import messages as m
from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode, KafkaError
from redpanda_tpu_torch.models.record import Record, RecordBatch


class TransactionalProducer:
    def __init__(self, client, transactional_id: str | None = None, timeout_ms: int = 60_000):
        self.client = client
        self.transactional_id = transactional_id
        self.timeout_ms = timeout_ms
        self.producer_id = -1
        self.epoch = -1
        self._seqs: dict[tuple[str, int], int] = {}
        self._in_tx_partitions: set[tuple[str, int]] = set()
        self._tx_open = False

    # Transient coordination states (elections, dissemination lag, an
    # in-flight previous transaction) are POLL signals on every tx RPC:
    _RETRIABLE = frozenset({
        int(ErrorCode.coordinator_not_available),
        int(ErrorCode.not_leader_for_partition),
        int(ErrorCode.concurrent_transactions),
    })

    async def _tx_request(self, api, body: dict, what: str, get_code) -> dict:
        deadline = asyncio.get_event_loop().time() + 30.0
        while True:
            conn = await self.client.any_connection()
            resp = await conn.request(api, body)
            code = get_code(resp)
            if code == 0:
                return resp
            if (
                code not in self._RETRIABLE
                or asyncio.get_event_loop().time() > deadline
            ):
                raise KafkaError(ErrorCode(code), what)
            await asyncio.sleep(0.3)

    async def init(self) -> "TransactionalProducer":
        resp = await self._tx_request(
            m.INIT_PRODUCER_ID,
            {
                "transactional_id": self.transactional_id,
                "transaction_timeout_ms": self.timeout_ms,
            },
            "init_producer_id",
            lambda r: r["error_code"],
        )
        self.producer_id = resp["producer_id"]
        self.epoch = resp["producer_epoch"]
        return self

    # ------------------------------------------------------------ transactional
    def begin(self) -> None:
        if self.transactional_id is None:
            raise RuntimeError("begin() requires a transactional_id")
        self._tx_open = True
        self._in_tx_partitions.clear()

    async def _ensure_partition(self, topic: str, partition: int) -> None:
        if (topic, partition) in self._in_tx_partitions:
            return
        await self._tx_request(
            m.ADD_PARTITIONS_TO_TXN,
            {
                "transactional_id": self.transactional_id,
                "producer_id": self.producer_id,
                "producer_epoch": self.epoch,
                "topics": [{"name": topic, "partitions": [partition]}],
            },
            "add_partitions_to_txn",
            lambda r: r["results"][0]["results"][0]["error_code"],
        )
        self._in_tx_partitions.add((topic, partition))

    async def send(self, topic: str, partition: int, values: list[bytes]) -> int:
        transactional = self._tx_open
        if transactional:
            await self._ensure_partition(topic, partition)
        seq = self._seqs.get((topic, partition), 0)
        batch = RecordBatch.build(
            [Record(value=v, offset_delta=i) for i, v in enumerate(values)],
            producer_id=self.producer_id,
            producer_epoch=self.epoch,
            base_sequence=seq,
            transactional=transactional,
        )
        base = await self.client.produce_batches(topic, partition, [batch])
        self._seqs[(topic, partition)] = seq + len(values)
        return base

    async def send_offsets(
        self, group_id: str, offsets: dict[tuple[str, int], int]
    ) -> None:
        """EOS consume-transform-produce: stage group offsets inside the tx."""
        conn = await self.client.any_connection()
        resp = await conn.request(m.ADD_OFFSETS_TO_TXN, {
            "transactional_id": self.transactional_id,
            "producer_id": self.producer_id,
            "producer_epoch": self.epoch,
            "group_id": group_id,
        })
        if resp["error_code"] != 0:
            raise KafkaError(ErrorCode(resp["error_code"]), "add_offsets_to_txn")
        topics: dict[str, list] = {}
        for (topic, p), off in offsets.items():
            topics.setdefault(topic, []).append({
                "partition_index": p,
                "committed_offset": off,
                "committed_leader_epoch": -1,
                "committed_metadata": None,
            })
        resp = await conn.request(m.TXN_OFFSET_COMMIT, {
            "transactional_id": self.transactional_id,
            "group_id": group_id,
            "producer_id": self.producer_id,
            "producer_epoch": self.epoch,
            "topics": [{"name": t, "partitions": ps} for t, ps in topics.items()],
        })
        for t in resp["topics"]:
            for p in t["partitions"]:
                if p["error_code"] != 0:
                    raise KafkaError(ErrorCode(p["error_code"]), "txn_offset_commit")

    async def _end(self, commit: bool) -> None:
        # Retriable while the coordinator re-drives marker/offset fan-out
        # (state stays prepare_*): "again later", not failure.
        await self._tx_request(
            m.END_TXN,
            {
                "transactional_id": self.transactional_id,
                "producer_id": self.producer_id,
                "producer_epoch": self.epoch,
                "committed": commit,
            },
            "end_txn",
            lambda r: r["error_code"],
        )
        self._tx_open = False
        self._in_tx_partitions.clear()

    async def commit(self) -> None:
        await self._end(True)

    async def abort(self) -> None:
        await self._end(False)
