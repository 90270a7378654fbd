"""Transaction coordinator: producer-id allocation + tx state + gateway.

Parity with cluster/id_allocator_stm (producer id blocks), cluster/tm_stm
(transactional_id → {pid, epoch, state, partitions}) and
tx_gateway_frontend (the begin/commit choreography, tx_gateway.json RPCs).
The reference replicates coordinator state through dedicated raft groups;
here it rides the broker's kvstore WAL (single-node durable) with the same
state machine — the cluster path reuses these transitions behind partition
leadership of a tx-state topic when multi-node tx lands.

EOS flow (matching the reference's message order):
  InitProducerId → [AddPartitionsToTxn → produce…] → (AddOffsetsToTxn →
  TxnOffsetCommit)… → EndTxn{commit|abort} → rm_stm markers + group offsets.

(The JAX package's kafka/server/tx_coordinator.py, copied.)
"""

from __future__ import annotations

import enum
import json
import logging
import time

from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode as E
from redpanda_tpu_torch.kafka.server.group import OffsetCommit
from redpanda_tpu_torch.storage.kvstore import KeySpace

logger = logging.getLogger("rptpu.kafka.tx")

_PID_BLOCK = 1000  # id_allocator_stm hands out ranges, not single ids


def _new_lock():
    import asyncio

    return asyncio.Lock()


class TxState(enum.Enum):
    empty = "Empty"
    ongoing = "Ongoing"
    prepare_commit = "PrepareCommit"
    prepare_abort = "PrepareAbort"
    complete_commit = "CompleteCommit"
    complete_abort = "CompleteAbort"


class TxMetadata:
    def __init__(self, tx_id: str, pid: int, epoch: int, timeout_ms: int) -> None:
        self.tx_id = tx_id
        self.pid = pid
        self.epoch = epoch
        self.timeout_ms = timeout_ms
        self.state = TxState.empty
        self.partitions: set[tuple[str, int]] = set()
        # group_id -> staged offset commits, applied atomically on commit
        self.staged_offsets: dict[str, dict[tuple[str, int], OffsetCommit]] = {}
        self.last_update = time.monotonic()
        # runtime-only (not persisted): finish serialization + re-drive pacing
        self.finish_lock = _new_lock()
        self.redrive_attempts = 0
        self.next_redrive = 0.0

    def to_dict(self) -> dict:
        return {
            "tx_id": self.tx_id, "pid": self.pid, "epoch": self.epoch,
            "timeout_ms": self.timeout_ms, "state": self.state.value,
            "partitions": sorted(self.partitions),
            # staged offsets must survive a crash between TxnOffsetCommit
            # and the commit completing, or acked-committed offsets vanish
            "staged_offsets": {
                g: [[t, p, oc.offset, oc.leader_epoch, oc.metadata]
                    for (t, p), oc in commits.items()]
                for g, commits in self.staged_offsets.items()
            },
        }

    @staticmethod
    def from_dict(d: dict) -> "TxMetadata":
        md = TxMetadata(d["tx_id"], d["pid"], d["epoch"], d["timeout_ms"])
        md.state = TxState(d["state"])
        md.partitions = {(t, p) for t, p in d["partitions"]}
        for g, commits in d.get("staged_offsets", {}).items():
            md.staged_offsets[g] = {
                (t, p): OffsetCommit(off, epoch, meta)
                for t, p, off, epoch, meta in commits
            }
        return md


class TxCoordinator:
    def __init__(self, broker, expire_interval_s: float = 1.0) -> None:
        from redpanda_tpu_torch.cluster.tx_gateway import TxRouter

        # local-only by default; the app swaps in a mesh-routed router
        # (metadata cache + connection cache) when clustered
        self.router = TxRouter(broker)
        self.broker = broker
        self.expire_interval_s = expire_interval_s
        self._txs: dict[str, TxMetadata] = {}
        self._next_pid: int | None = None
        self._block_end = -1
        self._loaded = False
        self._expire_task = None

    # ------------------------------------------------------------ lifecycle
    def start_expiry(self) -> None:
        import asyncio

        if self._expire_task is None or self._expire_task.done():
            self._expire_task = asyncio.create_task(self._expire_loop())

    async def stop(self) -> None:
        import asyncio

        if self._expire_task is not None:
            self._expire_task.cancel()
            try:
                await self._expire_task
            except asyncio.CancelledError:
                pass
            self._expire_task = None

    async def _expire_loop(self) -> None:
        import asyncio

        # load (and re-drive crashed prepare_* transactions) even if no
        # client ever issues a tx API call after restart
        try:
            await self._load()
        except Exception:
            logger.exception("tx state load failed")
        while True:
            await asyncio.sleep(self.expire_interval_s)
            try:
                await self.expire_stale()
            except Exception:
                logger.exception("tx expiry pass failed")

    # ------------------------------------------------------------ persistence
    def _kvs(self):
        return self.broker.storage.kvs

    async def _load(self) -> None:
        if self._loaded:
            return
        for key in self._kvs().keys(KeySpace.controller):
            if key.startswith(b"tx/"):
                d = json.loads(self._kvs().get(KeySpace.controller, key).decode())
                self._txs[d["tx_id"]] = TxMetadata.from_dict(d)
        self._loaded = True
        # resume transactions that crashed mid-commit/abort: re-drive the
        # marker fan-out (tm_stm replays prepared txs on recovery)
        for md in list(self._txs.values()):
            if md.state == TxState.prepare_commit:
                await self._finish(md, commit=True)
            elif md.state == TxState.prepare_abort:
                await self._finish(md, commit=False)

    def _persist_tx(self, md: TxMetadata) -> None:
        self._kvs().put(
            KeySpace.controller, b"tx/" + md.tx_id.encode(),
            json.dumps(md.to_dict()).encode(),
        )

    # ------------------------------------------------------------ pid allocation
    def _alloc_pid(self) -> int:
        """id_allocator_stm: claim a block in the durable store, hand out
        ids from memory — one write per _PID_BLOCK allocations."""
        if self._next_pid is None or self._next_pid > self._block_end:
            raw = self._kvs().get(KeySpace.controller, b"id_allocator/next_block")
            start = int(raw.decode()) if raw else 0
            self._kvs().put(
                KeySpace.controller, b"id_allocator/next_block",
                str(start + _PID_BLOCK).encode(),
            )
            self._next_pid, self._block_end = start, start + _PID_BLOCK - 1
        pid = self._next_pid
        self._next_pid += 1
        return pid

    # ------------------------------------------------------------ api
    async def init_producer_id(
        self, tx_id: str | None, timeout_ms: int
    ) -> tuple[E, int, int]:
        await self._load()
        if not tx_id:
            return E.none, self._alloc_pid(), 0
        md = self._txs.get(tx_id)
        if md is None:
            md = TxMetadata(tx_id, self._alloc_pid(), 0, timeout_ms)
        else:
            # fence the previous incarnation: finish whatever it left open
            # BEFORE handing out a new epoch — clearing partitions with
            # markers unwritten would pin those partitions' LSO forever
            pending = {
                TxState.ongoing: False,
                TxState.prepare_abort: False,
                TxState.prepare_commit: True,
            }
            if md.state in pending:
                code = await self._finish(md, commit=pending[md.state])
                if code != E.none:
                    return E.concurrent_transactions, -1, -1  # retriable
            md.epoch += 1
            md.timeout_ms = timeout_ms
            if md.epoch > 0x7FFF - 1:
                md = TxMetadata(tx_id, self._alloc_pid(), 0, timeout_ms)
        md.state = TxState.empty
        md.partitions.clear()
        md.staged_offsets.clear()
        md.last_update = time.monotonic()
        self._txs[tx_id] = md
        self._persist_tx(md)
        return E.none, md.pid, md.epoch

    async def _check(self, tx_id: str, pid: int, epoch: int) -> tuple[E, TxMetadata | None]:
        await self._load()
        md = self._txs.get(tx_id)
        if md is None:
            return E.invalid_producer_id_mapping, None
        if md.pid != pid:
            return E.invalid_producer_id_mapping, None
        if md.epoch != epoch:
            return E.invalid_producer_epoch, None
        return E.none, md

    async def add_partitions(
        self, tx_id: str, pid: int, epoch: int, parts: list[tuple[str, int]]
    ) -> dict[tuple[str, int], E]:
        code, md = await self._check(tx_id, pid, epoch)
        if code != E.none:
            return {tp: code for tp in parts}
        out: dict[tuple[str, int], E] = {}
        for topic, p in parts:
            md_t = self.broker.topic_table.get(topic)
            if md_t is None or p not in md_t.assignments:
                out[(topic, p)] = E.unknown_topic_or_partition
                continue
            # begin on the partition LEADER via the tx gateway (local rm_stm
            # fast path when this broker leads it)
            try:
                out[(topic, p)] = E(await self.router.begin_tx(topic, p, pid, epoch))
            except Exception:
                logger.exception("tx %s: begin failed on %s/%d", tx_id, topic, p)
                out[(topic, p)] = E.coordinator_not_available
            if out[(topic, p)] == E.none:
                md.partitions.add((topic, p))
        if any(c == E.none for c in out.values()):
            md.state = TxState.ongoing
            md.last_update = time.monotonic()
            self._persist_tx(md)
        return out

    async def add_offsets(self, tx_id: str, pid: int, epoch: int, group_id: str) -> E:
        code, md = await self._check(tx_id, pid, epoch)
        if code != E.none:
            return code
        md.staged_offsets.setdefault(group_id, {})
        md.state = TxState.ongoing
        self._persist_tx(md)
        return E.none

    async def txn_offset_commit(
        self, tx_id: str, pid: int, epoch: int, group_id: str,
        commits: dict[tuple[str, int], OffsetCommit],
    ) -> E:
        code, md = await self._check(tx_id, pid, epoch)
        if code != E.none:
            return code
        if group_id not in md.staged_offsets:
            return E.invalid_txn_state  # AddOffsetsToTxn must come first
        md.staged_offsets[group_id].update(commits)
        # durable BEFORE the ack: a crash between this ack and EndTxn must
        # not lose offsets the app was told are part of the transaction
        self._persist_tx(md)
        return E.none

    async def end_txn(self, tx_id: str, pid: int, epoch: int, commit: bool) -> E:
        code, md = await self._check(tx_id, pid, epoch)
        if code != E.none:
            return code
        # retrying EndTxn after a failed/interrupted finish is legal as long
        # as the direction matches the prepared one
        if md.state == TxState.prepare_commit and not commit:
            return E.invalid_txn_state
        if md.state == TxState.prepare_abort and commit:
            return E.invalid_txn_state
        if md.state in (TxState.complete_commit, TxState.complete_abort):
            return E.invalid_txn_state
        if md.state == TxState.empty and not md.partitions and not md.staged_offsets:
            return E.none  # nothing to do; kafka allows the no-op commit
        return await self._finish(md, commit)

    async def _finish(self, md: TxMetadata, commit: bool, *, redrive: bool = False) -> E:
        # Serialized per tx: the 1 Hz re-drive (expire_stale) must never
        # overlap the client's own EndTxn attempt — a duplicate marker RPC
        # landing AFTER completion could commit/abort the producer's NEXT
        # transaction's open data (same pid/epoch spans transactions).
        async with md.finish_lock:
            if md.state in (TxState.complete_commit, TxState.complete_abort):
                return E.none  # the other driver already completed it
            return await self._finish_locked(md, commit, redrive)

    async def _finish_locked(self, md: TxMetadata, commit: bool, redrive: bool) -> E:
        md.state = TxState.prepare_commit if commit else TxState.prepare_abort
        self._persist_tx(md)
        # Partitions whose TOPIC no longer exists can never take a marker —
        # their rm_stm state died with the topic; keeping them would brick
        # this transactional id in an unfinishable prepare_* loop.
        for topic, p in list(md.partitions):
            tmd = self.broker.topic_table.get(topic)
            if tmd is None or p not in tmd.assignments:
                logger.warning(
                    "tx %s: dropping marker for deleted %s/%d", md.tx_id, topic, p
                )
                md.partitions.discard((topic, p))
        # 1. control markers on every touched partition (tx_gateway fan-out).
        #    Any failure leaves the tx in prepare_* so EndTxn/recovery can
        #    re-drive it — claiming success with a marker missing would pin
        #    that partition's LSO forever.
        failed = False
        retriable = {
            int(E.not_leader_for_partition),
            int(E.coordinator_not_available),
            int(E.unknown_server_error),
            int(E.unknown_topic_or_partition),
        }

        # markers route through the tx gateway: local rm_stm when this
        # broker leads the partition, internal RPC to the leader otherwise
        # (cluster/tx_gateway.py). Independent partitions fan out
        # CONCURRENTLY so one attempt is bounded by the slowest single RPC,
        # not their sum (the reference's parallel tx_gateway fan-out).
        import asyncio

        parts = sorted(md.partitions)

        async def one_marker(topic: str, p: int) -> int:
            try:
                return await self.router.write_marker(
                    topic, p, md.pid, md.epoch, commit
                )
            except Exception:
                logger.exception(
                    "tx %s: marker write failed on %s/%d", md.tx_id, topic, p
                )
                return int(E.unknown_server_error)

        codes = await asyncio.gather(*(one_marker(t, p) for t, p in parts))
        for (topic, p), code in zip(parts, codes):
            if code in retriable:
                logger.warning(
                    "tx %s: partition %s/%d unavailable during end_txn "
                    "(errc %d); will retry", md.tx_id, topic, p, code,
                )
                failed = True
                continue
            if code != 0:
                if redrive:
                    # A fence during RE-DRIVE means a newer epoch already
                    # superseded this tx on that partition — its markers are
                    # moot; complete as aborted so the 1 Hz loop terminates
                    # instead of re-driving a dead tx forever.
                    logger.warning(
                        "tx %s: fenced during re-drive (errc %d); "
                        "completing as aborted", md.tx_id, code,
                    )
                    md.partitions.clear()
                    md.staged_offsets.clear()
                    md.state = TxState.complete_abort
                    md.last_update = time.monotonic()
                    self._persist_tx(md)
                    return E.none
                return E(code)  # epoch fence: not retriable, must re-init
        if failed:
            return E.coordinator_not_available  # retriable; state stays prepare_*
        # 2. staged group offsets become visible only on commit
        #    (group_commit_tx / group_abort_tx batches in the reference),
        #    routed to the group coordinator node
        if commit:
            for group_id, commits in md.staged_offsets.items():
                if commits:
                    try:
                        code = await self.router.commit_group_offsets(
                            group_id, commits
                        )
                    except Exception:
                        logger.exception(
                            "tx %s: offset fold failed for group %s",
                            md.tx_id, group_id,
                        )
                        return E.coordinator_not_available
                    if code != 0:
                        return E.coordinator_not_available
        md.partitions.clear()
        md.staged_offsets.clear()
        md.state = TxState.complete_commit if commit else TxState.complete_abort
        md.last_update = time.monotonic()
        self._persist_tx(md)
        return E.none

    async def expire_stale(self) -> None:
        """Abort timed-out transactions AND re-drive interrupted finishes
        (tm_stm expiry + re-drive). A tx stuck in prepare_* — the client
        gave up while a remote partition leader was down — pins every begun
        partition's LSO until its markers land; the coordinator, not the
        client, owns completing it."""
        now = time.monotonic()
        for md in list(self._txs.values()):
            if (
                md.state == TxState.ongoing
                and now - md.last_update > md.timeout_ms / 1000.0
            ):
                logger.info("aborting expired tx %s", md.tx_id)
                await self._finish(md, commit=False)
            elif md.state in (TxState.prepare_commit, TxState.prepare_abort):
                # exponential backoff (1s..60s): a partition that stays
                # unreachable shouldn't be hammered at 1 Hz forever; the
                # per-tx finish_lock keeps this from overlapping a client
                # retry, and skip entirely while one is in flight
                if md.finish_lock.locked() or now < md.next_redrive:
                    continue
                code = await self._finish(
                    md, commit=md.state == TxState.prepare_commit, redrive=True
                )
                if code == E.none:
                    logger.info("re-drove interrupted tx %s", md.tx_id)
                    md.redrive_attempts = 0
                else:
                    md.redrive_attempts += 1
                    md.next_redrive = time.monotonic() + min(
                        2.0 ** md.redrive_attempts, 60.0
                    )
