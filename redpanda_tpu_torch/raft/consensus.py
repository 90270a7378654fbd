"""Raft consensus — one instance per partition replica (the JAX package's
raft/consensus.py, with the device its follower CRC validation runs on
made explicit).

Parity with raft/consensus.h:51 / consensus.cc: ``replicate()`` with three
consistency levels (consensus.cc:600-650), concurrent quorum writes coalesced
by a batcher (replicate_batcher.cc:40), prevote+vote elections
(vote_stm/prevote_stm), follower catch-up (recovery_stm.cc) throttled by a
shared recovery throttle, snapshot install, joint-consensus membership
change, and leadership transfer via timeout_now.

Durable state: term + voted_for live in the per-shard kvstore
(KeySpace.consensus, mirroring kvstore.h:61-73); entries live in the
storage log with the term stamped in each batch header; configurations are
``raft_configuration`` batches in the log, tracked by ConfigurationManager.

``device`` is where a follower's batched CRC validation runs when
``device_plane.configure(crc_validate=True)``: the card by default (the
constructor raises without one), or ``"cpu"`` for the plain versions. A
failed launch fails the append; nothing validates on the host in its place.
"""

from __future__ import annotations

import asyncio
import bisect
import logging
import random
import struct
import time

from redpanda_tpu_torch.device import resolve_device
from redpanda_tpu_torch.finjector import honey_badger
from redpanda_tpu_torch.metrics import registry
from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.observability import probes
from redpanda_tpu_torch.observability.trace import tracer
from redpanda_tpu_torch.models.record import Record, RecordBatch, RecordBatchType
from redpanda_tpu_torch.raft import device_plane
from redpanda_tpu_torch.raft.configuration import ConfigurationManager, GroupConfiguration
from redpanda_tpu_torch.raft.types import (
    ConsistencyLevel,
    Errc,
    FollowerIndex,
    RaftError,
    ReplicateResult,
    VNode,
)
from redpanda_tpu_torch.rpc.transport import RpcError, TransportClosed
from redpanda_tpu_torch.storage.kvstore import KeySpace
from redpanda_tpu_torch.storage.snapshot import SnapshotManager

logger = logging.getLogger("rptorch.raft")

# chaos probe: one byte of a received append blob flips before validation
# (finjector CORRUPT effect — loadgen crc_chaos drives it)
honey_badger.register_probe("raft", "append_blob")

# follower-side batched-CRC rejections (raft/device_plane.py, on with
# device_plane.configure(crc_validate=True)): the scrape must see torn
# appends being refused, not just a leader-side retry
raft_crc_rejected = registry.counter(
    "raft_crc_rejected_batches_total",
    "Append-entries batches rejected by the follower CRC validation",
)

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"


class RaftTimings:
    """Tunable timings (config/configuration.cc raft_* properties)."""

    def __init__(
        self,
        election_timeout_ms: float = 600.0,
        heartbeat_interval_ms: float = 60.0,
        recovery_chunk_bytes: int = 512 * 1024,
        rpc_timeout_s: float = 2.0,
    ) -> None:
        self.election_timeout_ms = election_timeout_ms
        self.heartbeat_interval_ms = heartbeat_interval_ms
        self.recovery_chunk_bytes = recovery_chunk_bytes
        self.rpc_timeout_s = rpc_timeout_s

    def jittered_timeout(self) -> float:
        base = self.election_timeout_ms / 1000.0
        return base + random.random() * base


class OffsetMonitor:
    """Waiters on a monotonically advancing offset (raft/offset_monitor.h)."""

    def __init__(self) -> None:
        self._waiters: list[tuple[int, asyncio.Future]] = []

    def notify(self, offset: int) -> None:
        fire = [w for w in self._waiters if w[0] <= offset]
        self._waiters = [w for w in self._waiters if w[0] > offset]
        for _, fut in fire:
            if not fut.done():
                fut.set_result(offset)

    def fail_all(self, exc: Exception) -> None:
        for _, fut in self._waiters:
            if not fut.done():
                fut.set_exception(exc)
        self._waiters = []

    async def wait_for(self, offset: int, current: int, timeout: float | None = None) -> int:
        if current >= offset:
            return current
        fut: asyncio.Future = asyncio.get_event_loop().create_future()
        self._waiters.append((offset, fut))
        if timeout is None:
            return await fut
        try:
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            raise RaftError(Errc.timeout, f"offset {offset} not committed in time")


class Consensus:
    def __init__(
        self,
        group: int,
        ntp: NTP,
        self_node: VNode,
        initial_config: GroupConfiguration,
        log,
        kvstore,
        client_for,  # callable(node_id) -> raftgen rpc.Client
        timings: RaftTimings | None = None,
        leadership_cb=None,  # callable(consensus) on leadership change
        recovery_throttle: asyncio.Semaphore | None = None,
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.group = group
        self.ntp = ntp
        self.self_node = self_node
        self.log = log
        self._kvstore = kvstore
        self._client_for = client_for
        self.timings = timings or RaftTimings()
        self._leadership_cb = leadership_cb
        self._recovery_throttle = recovery_throttle or asyncio.Semaphore(4)

        self.term = 0
        self.voted_for: VNode | None = None
        self.role = FOLLOWER
        self.leader_id: int | None = None
        self._commit_index = -1
        self.config_mgr = ConfigurationManager(initial_config)

        self._followers: dict[int, FollowerIndex] = {}
        self._op_lock = asyncio.Lock()
        self._commit_monitor = OffsetMonitor()
        self._term_starts: list[tuple[int, int]] = []  # (first_offset, term) spans
        self._last_leader_contact = 0.0
        self._election_task: asyncio.Task | None = None
        self._recovery_tasks: dict[int, asyncio.Task] = {}
        # fire-and-forget work (step-down, transfer elections, quorum acks):
        # handles are retained so the tasks can't be GC'd mid-flight and are
        # cancelled on stop() (pandalint TSK301)
        self._bg_tasks: set[asyncio.Task] = set()
        self._batcher: _ReplicateBatcher | None = None
        # sampled "owner trace" for the replicate path's detached rpc sends:
        # the batcher's flush task and follower recovery run under
        # tracer.detached() by span-hygiene design, so their rpc.send spans
        # (and SLO breach exemplars) carried no trace id at all. One
        # submitter's ambient trace id per coalesced flush round is sampled
        # here and consumed ONCE PER FOLLOWER (seq-tracked below) by the
        # next append_entries send to that follower — so the sampled
        # produce's cluster trace gains a JOINed leg on EVERY replica
        # (pandascope wire propagation rides those sends) while the
        # long-lived tasks are never re-attributed wholesale: a follower
        # that already consumed this round's owner sends untraced again.
        self._replicate_owner: int | None = None
        self._replicate_owner_seq = 0
        self._owner_consumed: dict[int, int] = {}  # follower id -> seq
        self._snapshots = SnapshotManager(log.dir, name="raft_snapshot")
        self._snapshot_rx: dict | None = None  # in-progress chunked install
        self._transferring = False
        self._stopped = False

    # ---------------------------------------------------------------- state
    @property
    def commit_index(self) -> int:
        return self._commit_index

    @property
    def dirty_offset(self) -> int:
        return self.log.offsets().dirty_offset

    @property
    def flushed_offset(self) -> int:
        return self.log.offsets().committed_offset

    # Partition-facade accessors (cluster::partition delegates here; the
    # same names DirectConsensus exposes — raw log offsets, pre-translation)
    @property
    def committed_offset(self) -> int:
        return self._commit_index

    @property
    def last_stable_offset(self) -> int:
        """Exclusive; tx-aware LSO clamping happens in rm_stm above."""
        return self._commit_index + 1

    @property
    def start_offset(self) -> int:
        return self.log.offsets().start_offset

    def is_leader(self) -> bool:
        return self.role == LEADER

    def leadership_settled(self) -> bool:
        """Raft §8 read barrier: a NEW leader may only serve linearizable
        reads once an entry of ITS OWN term has committed (the election
        configuration batch, _become_leader) — prior-term quorum entries
        are only then covered by the commit rule, so the high watermark
        cannot show a reader less than what an earlier leader acked."""
        return (
            self.role == LEADER
            and self._commit_index >= 0
            and self.term_at(self._commit_index) == self.term
        )

    def config(self) -> GroupConfiguration:
        return self.config_mgr.latest()

    def term_at(self, offset: int) -> int:
        """Term of the batch covering `offset` (-1 when unknown/compacted)."""
        if offset < 0:
            return -1
        idx = bisect.bisect_right(self._term_starts, (offset, 1 << 62)) - 1
        if idx < 0:
            return -1
        return self._term_starts[idx][1]

    def _note_term_span(self, first_offset: int, term: int) -> None:
        if not self._term_starts or self._term_starts[-1][1] != term:
            self._term_starts.append((first_offset, term))

    # ---------------------------------------------------------------- lifecycle
    async def start(self) -> "Consensus":
        raw = self._kvstore.get(KeySpace.consensus, self._kv_key(b"voted_for"))
        if raw is not None:
            term, vid, vrev, has_vote = struct.unpack("<qiqB", raw)
            self.term = term
            self.voted_for = VNode(vid, vrev) if has_vote else None
        snap = self._snapshots.read()
        if snap is not None:
            meta, _payload = snap
            last_idx, last_term = struct.unpack("<qq", meta[:16])
            self._term_starts = [(last_idx, last_term)]
            self._commit_index = max(self._commit_index, last_idx)
        await self._rebuild_from_log()
        self._election_task = asyncio.create_task(self._election_loop())
        self._batcher = _ReplicateBatcher(self)
        return self

    async def _rebuild_from_log(self) -> None:
        """Scan the log once to rebuild term spans + config history
        (the reference persists both and CRC-scans the tail; our storage
        recovery already validated CRCs)."""
        offsets = self.log.offsets()
        at = offsets.start_offset
        while at <= offsets.dirty_offset:
            batches = self.log.read(at, 4 << 20)
            if asyncio.iscoroutine(batches):
                batches = await batches
            if not batches:
                break
            for b in batches:
                self._note_term_span(b.base_offset, b.header.term)
                self.term = max(self.term, b.header.term)
                if b.header.type == RecordBatchType.raft_configuration:
                    cfg = GroupConfiguration.decode(b.record_values()[0])
                    if b.base_offset > self.config_mgr.latest_offset():
                        self.config_mgr.add(b.base_offset, cfg)
            at = batches[-1].last_offset + 1

    def _spawn_bg(self, coro) -> asyncio.Task:
        """create_task with a retained handle: fire-and-forget raft work
        (step-down, transfer elections, quorum acks) must not be GC'd
        mid-flight and must die with the group (pandalint TSK301).
        Detached from any ambient trace: these outlive the request that
        triggered them, and create_task's context copy would otherwise pin
        its trace id onto everything they ever record."""
        with tracer.detached():
            t = asyncio.create_task(coro)
        self._bg_tasks.add(t)
        t.add_done_callback(self._bg_tasks.discard)
        return t

    async def stop(self) -> None:
        self._stopped = True
        tasks = [
            t
            for t in [
                self._election_task,
                *self._recovery_tasks.values(),
                *self._bg_tasks,
            ]
            if t
        ]
        if self._batcher is not None:
            tasks.extend(self._batcher.tasks())
        for t in tasks:
            t.cancel()
        if tasks:
            await asyncio.gather(*tasks, return_exceptions=True)
        self._commit_monitor.fail_all(RaftError(Errc.shutting_down))

    def _kv_key(self, suffix: bytes) -> bytes:
        return b"raft/%d/" % self.group + suffix

    def _persist_vote(self) -> None:
        v = self.voted_for
        self._kvstore.put(
            KeySpace.consensus,
            self._kv_key(b"voted_for"),
            struct.pack(
                "<qiqB",
                self.term,
                v.id if v else -1,
                v.revision if v else 0,
                1 if v else 0,
            ),
        )

    # ---------------------------------------------------------------- election
    async def _election_loop(self) -> None:
        loop = asyncio.get_event_loop()
        while not self._stopped:
            timeout = self.timings.jittered_timeout()
            await asyncio.sleep(timeout)
            if self._stopped or self.is_leader():
                continue
            if not self.config().is_voter(self.self_node):
                continue  # learners never start elections
            if loop.time() - self._last_leader_contact < timeout:
                continue  # heard from a live leader recently
            try:
                await self.dispatch_election()
            except asyncio.CancelledError:
                raise
            except Exception:
                logger.exception("group %d election failed", self.group)

    async def dispatch_election(self, *, leadership_transfer: bool = False) -> bool:
        """Prevote round then a real vote round (vote_stm/prevote_stm)."""
        if not leadership_transfer:
            ok = await self._request_votes(self.term + 1, prevote=True)
            if not ok:
                return False
        async with self._op_lock:
            self.role = CANDIDATE
            self.term += 1
            self.leader_id = None
            self.voted_for = self.self_node
            self._persist_vote()
            term = self.term
        granted = await self._request_votes(term, prevote=False, leadership_transfer=leadership_transfer)
        if granted and self.role == CANDIDATE and self.term == term:
            await self._become_leader()
            return True
        return False

    async def _request_votes(self, term: int, *, prevote: bool, leadership_transfer: bool = False) -> bool:
        cfg = self.config()
        last_idx = self.dirty_offset
        last_term = self.term_at(last_idx)
        req = {
            "group": self.group,
            "node": {"id": self.self_node.id, "revision": self.self_node.revision},
            "term": term,
            "prev_log_index": last_idx,
            "prev_log_term": last_term,
            "leadership_transfer": leadership_transfer,
            "prevote": prevote,
        }
        acked = {self.self_node.id}

        async def ask(node: VNode) -> None:
            client = self._client_for(node.id)
            try:
                reply = await client.vote(
                    {**req, "target": {"id": node.id, "revision": node.revision}},
                    timeout=self.timings.rpc_timeout_s,
                )
            except (RpcError, TransportClosed, OSError):
                return
            if reply["granted"]:
                acked.add(node.id)
            elif not prevote and reply["term"] > self.term:
                await self._step_down(reply["term"])

        await asyncio.gather(*(ask(n) for n in cfg.all_voters() if n.id != self.self_node.id))
        return cfg.majority(acked)

    async def _become_leader(self) -> None:
        async with self._op_lock:
            self.role = LEADER
            self.leader_id = self.self_node.id
            dirty = self.dirty_offset
            self._followers = {
                n.id: FollowerIndex(n, next_index=dirty + 1)
                for n in self.config().all_nodes()
                if n.id != self.self_node.id
            }
            # Commit a configuration batch in the new term: commits all prior-
            # term entries once it replicates (the raft "no-op on election"
            # rule; the reference replicates the active configuration).
            await self._append_config_locked(self.config())
        logger.info("group %d: node %d elected leader term %d", self.group, self.self_node.id, self.term)
        self._fanout_append()
        if self._leadership_cb:
            self._leadership_cb(self)

    async def _step_down(self, term: int, leader: int | None = None) -> None:
        async with self._op_lock:
            self._step_down_locked(term, leader)

    def _step_down_locked(self, term: int, leader: int | None = None) -> None:
        was_leader = self.role == LEADER
        if term > self.term:
            self.term = term
            self.voted_for = None
            self._persist_vote()
        self.role = FOLLOWER
        self.leader_id = leader
        for t in self._recovery_tasks.values():
            t.cancel()
        self._recovery_tasks.clear()
        if was_leader:
            self._commit_monitor.fail_all(RaftError(Errc.not_leader))
            if self._leadership_cb:
                self._leadership_cb(self)

    # ---------------------------------------------------------------- vote RPC
    async def handle_vote(self, req: dict) -> dict:
        async with self._op_lock:
            req_term = req["term"]
            candidate = VNode(req["node"]["id"], req["node"]["revision"])
            last_idx = self.dirty_offset
            log_ok = req["prev_log_term"] > self.term_at(last_idx) or (
                req["prev_log_term"] == self.term_at(last_idx)
                and req["prev_log_index"] >= last_idx
            )
            if req["prevote"]:
                # Prevote grants without disturbing state: would we vote?
                granted = log_ok and req_term > self.term
                if not granted and req.get("leadership_transfer"):
                    granted = log_ok
                return {"term": self.term, "granted": granted, "log_ok": log_ok}
            if req_term < self.term:
                return {"term": self.term, "granted": False, "log_ok": log_ok}
            if req_term > self.term:
                self._step_down_locked(req_term)
            granted = log_ok and (self.voted_for is None or self.voted_for.id == candidate.id)
            if granted:
                self.voted_for = candidate
                self._persist_vote()
                self._last_leader_contact = asyncio.get_event_loop().time()
            return {"term": self.term, "granted": granted, "log_ok": log_ok}

    # ---------------------------------------------------------------- replicate
    async def replicate(
        self,
        batches: list[RecordBatch],
        consistency: ConsistencyLevel = ConsistencyLevel.quorum_ack,
        timeout: float | None = 10.0,
    ) -> ReplicateResult:
        t0 = time.perf_counter()
        try:
            with tracer.span("raft.replicate"):
                enqueued, replicated = await self.replicate_in_stages(
                    batches, consistency, timeout
                )
                await enqueued
                return await replicated
        finally:
            probes.observe_us(probes.raft_replicate_hist, t0)

    async def replicate_in_stages(
        self,
        batches: list[RecordBatch],
        consistency: ConsistencyLevel = ConsistencyLevel.quorum_ack,
        timeout: float | None = 10.0,
    ):
        """Two-stage replicate (consensus.cc:576-650): the first future
        resolves when the entry is enqueued/appended (order fixed), the
        second when the requested consistency level is reached."""
        if not self.is_leader():
            raise RaftError(Errc.not_leader, f"group {self.group}: not leader")
        if consistency == ConsistencyLevel.quorum_ack:
            return await self._batcher.submit(batches, timeout)
        loop = asyncio.get_event_loop()
        enqueued: asyncio.Future = loop.create_future()
        replicated: asyncio.Future = loop.create_future()
        async with self._op_lock:
            if not self.is_leader():
                raise RaftError(Errc.not_leader)
            res = await self._append_locked(batches)
            enqueued.set_result(res.last_offset)
        self._fanout_append()
        replicated.set_result(ReplicateResult(res.last_offset, self.term))
        return enqueued, replicated

    async def _append_locked(self, batches: list[RecordBatch]):
        res = self.log.append(batches, term=self.term)
        if asyncio.iscoroutine(res):
            res = await res
        self._note_term_span(res.base_offset, self.term)
        return res

    async def _append_config_locked(self, cfg: GroupConfiguration) -> int:
        batch = RecordBatch.build(
            [Record(offset_delta=0, value=cfg.encode())],
            type=RecordBatchType.raft_configuration,
        )
        res = await self._append_locked([batch])
        self.config_mgr.add(res.base_offset, cfg)
        # Flush so the leader's own ack counts toward the quorum: config
        # appends happen outside the batcher's flush path, and in a 2-voter
        # group one follower ack alone can never reach majority.
        r = self.log.flush()
        if asyncio.iscoroutine(r):
            await r
        self._maybe_advance_commit_index()
        return res.last_offset

    def _fanout_append(self) -> None:
        """Kick per-follower dispatch; recovery handles lagging peers."""
        for f in self._followers.values():
            if not f.is_recovering:
                self._start_recovery(f)

    def _start_recovery(self, f: FollowerIndex) -> None:
        if f.is_recovering or self._stopped or not self.is_leader():
            return
        f.is_recovering = True
        # detached: recovery outlives the replicate that kicked it and
        # serves every later append too — no single trace owns it
        with tracer.detached():
            t = asyncio.create_task(self._recover_follower(f))
        self._recovery_tasks[f.node.id] = t
        t.add_done_callback(lambda _t: self._recovery_tasks.pop(f.node.id, None))

    async def _recover_follower(self, f: FollowerIndex) -> None:
        """recovery_stm: stream chunks until the follower's dirty offset
        matches ours; falls back to install_snapshot when the follower needs
        offsets we no longer have."""
        try:
            while self.is_leader() and not self._stopped and f.next_index <= self.dirty_offset:
                async with self._recovery_throttle:
                    if f.next_index < self.start_offset:
                        ok = await self._install_snapshot_on(f)
                        if not ok:
                            return
                        continue
                    prev = f.next_index - 1
                    batches = self.log.read(f.next_index, self.timings.recovery_chunk_bytes)
                    if asyncio.iscoroutine(batches):
                        batches = await batches
                    blob = _encode_entries(batches)
                    req = {
                        "group": self.group,
                        "node": {"id": self.self_node.id, "revision": self.self_node.revision},
                        "target": {"id": f.node.id, "revision": f.node.revision},
                        "term": self.term,
                        "prev_log_index": prev,
                        "prev_log_term": self.term_at(prev),
                        "commit_index": self._commit_index,
                        "batches": blob,
                        "flush": True,
                    }
                    # consume-once-per-follower owner trace: the span JOINS
                    # the sampled submitter's trace for exactly one send to
                    # THIS follower per sampled round (trace_id=None = the
                    # usual untraced no-op), so the rpc.send histogram
                    # record inside — and any exemplar a breach captures —
                    # resolves to a real trace, and the propagated context
                    # lands a JOINed leg on every replica of the round.
                    # Once every CURRENT follower consumed the round the
                    # owner is cleared — without that, a follower added
                    # (or rejoining) hours later would join an arbitrarily
                    # stale trace and propagate it over the wire into an
                    # unrelated, possibly recycled cluster view.
                    owner = None
                    seq = self._replicate_owner_seq
                    if (
                        self._replicate_owner is not None
                        and self._owner_consumed.get(f.node.id, 0) < seq
                    ):
                        owner = self._replicate_owner
                        self._owner_consumed[f.node.id] = seq
                        if all(
                            self._owner_consumed.get(fid, 0) >= seq
                            for fid in self._followers
                        ):
                            self._replicate_owner = None
                    try:
                        with tracer.span(
                            "raft.append_entries.send", trace_id=owner,
                            node=self.self_node.id,
                        ):
                            reply = await self._client_for(f.node.id).append_entries(
                                req, timeout=self.timings.rpc_timeout_s
                            )
                    except (RpcError, TransportClosed, OSError):
                        return  # next heartbeat/append retries
                    if reply["term"] > self.term:
                        await self._step_down(reply["term"])
                        return
                    if reply["result"] == 0:
                        f.last_dirty_offset = reply["last_dirty_log_index"]
                        f.last_flushed_offset = reply["last_flushed_log_index"]
                        f.next_index = f.last_dirty_offset + 1
                        self._maybe_advance_commit_index()
                    elif reply["result"] == 1:
                        # Divergence: back up to the follower's tail.
                        f.next_index = min(f.next_index - 1, reply["last_dirty_log_index"] + 1)
                        f.next_index = max(f.next_index, 0)
                    else:
                        return
        except asyncio.CancelledError:
            pass
        finally:
            f.is_recovering = False

    async def _install_snapshot_on(self, f: FollowerIndex) -> bool:
        snap = self._snapshots.read()
        if snap is None:
            meta = struct.pack("<qq", self.start_offset - 1, self.term_at(self.start_offset - 1))
            payload = b""
        else:
            meta, payload = snap
        last_idx, last_term = struct.unpack("<qq", meta[:16])
        chunk_size = self.timings.recovery_chunk_bytes
        at = 0
        while True:
            chunk = payload[at : at + chunk_size]
            done = at + len(chunk) >= len(payload)
            req = {
                "group": self.group,
                "node": {"id": self.self_node.id, "revision": self.self_node.revision},
                "target": {"id": f.node.id, "revision": f.node.revision},
                "term": self.term,
                "last_included_index": last_idx,
                "last_included_term": last_term,
                "file_offset": at,
                "chunk": chunk,
                "done": done,
            }
            try:
                reply = await self._client_for(f.node.id).install_snapshot(
                    req, timeout=self.timings.rpc_timeout_s
                )
            except (RpcError, TransportClosed, OSError):
                return False
            if reply["term"] > self.term:
                await self._step_down(reply["term"])
                return False
            if not reply["success"]:
                return False
            at += len(chunk)
            if done:
                f.next_index = last_idx + 1
                f.last_dirty_offset = last_idx
                return True

    # ---------------------------------------------------------------- commit
    def _maybe_advance_commit_index(self) -> None:
        if not self.is_leader():
            return
        cfg = self.config()
        self_flushed = self.flushed_offset
        candidates = sorted(
            {self_flushed}
            | {f.last_flushed_offset for f in self._followers.values() if cfg.is_voter(f.node)},
            reverse=True,
        )
        for offset in candidates:
            if offset <= self._commit_index:
                break
            acked = {self.self_node.id} if self_flushed >= offset else set()
            acked |= {
                fid for fid, f in self._followers.items() if f.last_flushed_offset >= offset
            }
            # Only entries from the current term commit by counting (§5.4.2).
            if cfg.majority(acked) and self.term_at(offset) == self.term:
                self._set_commit_index(offset)
                break

    def _set_commit_index(self, offset: int) -> None:
        if offset > self._commit_index:
            self._commit_index = offset
            self._commit_monitor.notify(offset)

    async def wait_for_commit(self, offset: int, timeout: float | None = None) -> int:
        return await self._commit_monitor.wait_for(offset, self._commit_index, timeout)

    # ---------------------------------------------------------------- append RPC
    async def handle_append_entries(self, req: dict) -> dict:
        blob = req["batches"]
        # chaos probe (finjector CORRUPT): flip one byte of the received
        # blob BEFORE validation, as a torn wire/disk read would — the
        # device-plane CRC check below must reject it, the leader's
        # recovery resend repairs it, and quorum acks ride the healthy
        # replicas meanwhile (loadgen crc_chaos scenario)
        if blob and honey_badger.enabled and honey_badger.corrupt_claim(
            "raft", "append_blob"
        ):
            blob = blob[:-1] + bytes([blob[-1] ^ 0xFF])
        crc_failures = 0
        batches = None
        if blob and device_plane.crc_validate_enabled():
            # BASELINE config 5 (follower half): batched CRC validation of
            # the whole append in ONE kernel call instead of one host CRC
            # per batch — the measured probe inside the plane decides
            # host-vs-device, both bit-exact. Runs BEFORE _op_lock: the
            # validation is a pure function of the wire bytes, and the
            # first call on a card builds the kernel for seconds — held
            # under the lock that would queue this group's heartbeats
            # while the unlocked election-loop staleness check fires a
            # spurious election against a healthy leader.
            batches = _decode_batches(blob)
            if batches:
                ok = await asyncio.to_thread(
                    device_plane.default_plane(self.device).validate,
                    [b.crc_region() for b in batches],
                    [b.header.crc for b in batches],
                )
                crc_failures = int((~ok).sum())
                if crc_failures:
                    raft_crc_rejected.inc(crc_failures)
                    logger.warning(
                        "group %d: rejecting append, %d/%d batch CRC "
                        "failures", self.group, crc_failures, len(ok),
                    )
        async with self._op_lock:
            return await self._do_handle_append(
                req, blob, req["flush"],
                crc_failures=crc_failures, batches=batches,
            )

    async def handle_heartbeat(self, meta: dict) -> dict:
        async with self._op_lock:
            return await self._do_handle_append(meta, b"", False)

    async def _do_handle_append(
        self, req: dict, blob: bytes, flush: bool,
        crc_failures: int = 0, batches: list[RecordBatch] | None = None,
    ) -> dict:
        def reply(result: int) -> dict:
            return {
                "group": self.group,
                "node": {"id": self.self_node.id, "revision": self.self_node.revision},
                "target": req["node"],
                "term": self.term,
                "last_dirty_log_index": self.dirty_offset,
                "last_flushed_log_index": self.flushed_offset,
                "result": result,
            }

        if req["term"] < self.term:
            return reply(1)
        if req["term"] > self.term or self.role != FOLLOWER or self.leader_id != req["node"]["id"]:
            self._step_down_locked(req["term"], leader=req["node"]["id"])
        self._last_leader_contact = asyncio.get_event_loop().time()

        prev_idx = req["prev_log_index"]
        dirty = self.dirty_offset
        if prev_idx > dirty:
            return reply(1)  # gap: leader must back up / recover
        if prev_idx >= self.start_offset and prev_idx >= 0:
            local_term = self.term_at(prev_idx)
            if local_term != -1 and local_term != req["prev_log_term"]:
                # Divergent history: drop our conflicting suffix.
                await self._truncate_locked(prev_idx)
                return reply(1)
        if blob:
            if crc_failures:
                # a corrupted wire batch (caught by the pre-lock batched
                # CRC validation in handle_append_entries) rejects the
                # append — the leader retries/recovers — instead of
                # poisoning the follower log
                return reply(1)
            if batches is None:
                batches = _decode_batches(blob)
            if batches:
                first = batches[0].base_offset
                if first <= dirty:
                    # Overlap: if already-present suffix matches terms, skip
                    # duplicates; otherwise truncate the divergent tail.
                    if self.term_at(dirty) == batches[-1].header.term and batches[-1].last_offset <= dirty:
                        return reply(0)
                    await self._truncate_locked(first)
                res = self.log.append(batches, assign_offsets=False)
                if asyncio.iscoroutine(res):
                    res = await res
                for b in batches:
                    self._note_term_span(b.base_offset, b.header.term)
                    if b.header.type == RecordBatchType.raft_configuration:
                        if b.base_offset > self.config_mgr.latest_offset():
                            self.config_mgr.add(
                                b.base_offset, GroupConfiguration.decode(b.record_values()[0])
                            )
        if flush:
            r = self.log.flush()
            if asyncio.iscoroutine(r):
                await r
        self._set_commit_index(min(req["commit_index"], self.dirty_offset))
        return reply(0)

    async def _truncate_locked(self, offset: int) -> None:
        r = self.log.truncate(offset)
        if asyncio.iscoroutine(r):
            await r
        self._term_starts = [(o, t) for o, t in self._term_starts if o < offset]
        self.config_mgr.truncate(offset)
        self._commit_index = min(self._commit_index, self.dirty_offset)

    # ---------------------------------------------------------------- snapshot RPC
    async def handle_install_snapshot(self, req: dict) -> dict:
        async with self._op_lock:
            if req["term"] < self.term:
                return {"term": self.term, "bytes_stored": 0, "success": False}
            if req["term"] > self.term:
                self._step_down_locked(req["term"], leader=req["node"]["id"])
            self._last_leader_contact = asyncio.get_event_loop().time()
            if req["file_offset"] == 0:
                self._snapshot_rx = {"data": bytearray(), "meta": (req["last_included_index"], req["last_included_term"])}
            rx = self._snapshot_rx
            if rx is None or req["file_offset"] != len(rx["data"]):
                return {"term": self.term, "bytes_stored": 0, "success": False}
            rx["data"] += req["chunk"]
            if req["done"]:
                last_idx, last_term = rx["meta"]
                self._snapshots.write(struct.pack("<qq", last_idx, last_term), bytes(rx["data"]))
                self._snapshot_rx = None
                r = self.log.prefix_truncate(last_idx + 1)
                if asyncio.iscoroutine(r):
                    await r
                # Preserve the term of retained entries above last_idx: the
                # span covering them may START at an offset <= last_idx, and
                # dropping it would make term_at() return -1 for offsets we
                # still hold, breaking divergence detection on later appends.
                retained_term = (
                    self.term_at(last_idx + 1) if self.dirty_offset > last_idx else -1
                )
                kept = [(o, t) for o, t in self._term_starts if o > last_idx]
                spans = [(last_idx, last_term)]
                if retained_term != -1 and not any(o == last_idx + 1 for o, _ in kept):
                    spans.append((last_idx + 1, retained_term))
                self._term_starts = spans + kept
                self.config_mgr.prefix_truncate(last_idx)
                self._set_commit_index(max(self._commit_index, last_idx))
            return {"term": self.term, "bytes_stored": len(rx["data"]), "success": True}

    def write_snapshot(self, last_included: int, payload: bytes) -> None:
        """Local snapshot at a committed offset + log prefix eviction
        (log_eviction_stm / install-snapshot source)."""
        assert last_included <= self._commit_index
        self._snapshots.write(
            struct.pack("<qq", last_included, self.term_at(last_included)), payload
        )

    def read_snapshot(self) -> tuple[int, bytes] | None:
        snap = self._snapshots.read()
        if snap is None:
            return None
        meta, payload = snap
        (last_idx,) = struct.unpack("<q", meta[:8])
        return last_idx, payload

    # ---------------------------------------------------------------- transfer
    async def handle_timeout_now(self, req: dict) -> dict:
        if req["term"] < self.term:
            return {"term": self.term, "result": 1}
        self._spawn_bg(self.dispatch_election(leadership_transfer=True))
        return {"term": self.term, "result": 0}

    async def do_transfer_leadership(self, target_id: int = -1) -> bool:
        """Suppress new writes, wait for the target to catch up, then ask it
        to start an immediate election (consensus transfer_leadership)."""
        if not self.is_leader():
            return False
        if self._transferring:
            raise RaftError(Errc.leadership_transfer_in_progress)
        voters = [f for f in self._followers.values() if self.config().is_voter(f.node)]
        if not voters:
            return False
        if target_id == -1:
            target = max(voters, key=lambda f: f.last_dirty_offset)
        else:
            match = [f for f in voters if f.node.id == target_id]
            if not match:
                raise RaftError(Errc.node_does_not_exist)
            target = match[0]
        self._transferring = True
        try:
            deadline = asyncio.get_event_loop().time() + 5.0
            self._start_recovery(target)
            while target.last_dirty_offset < self.dirty_offset:
                if asyncio.get_event_loop().time() > deadline:
                    return False
                await asyncio.sleep(0.01)
                self._start_recovery(target)
            # Ask the target to start an immediate election; retry until we
            # observe ourselves deposed (its election can lose a timing race
            # under load — a single shot would leave leadership stuck here).
            while asyncio.get_event_loop().time() < deadline:
                try:
                    reply = await self._client_for(target.node.id).timeout_now(
                        {
                            "group": self.group,
                            "node": {"id": self.self_node.id, "revision": self.self_node.revision},
                            "target": {"id": target.node.id, "revision": target.node.revision},
                            "term": self.term,
                        },
                        timeout=self.timings.rpc_timeout_s,
                    )
                except (RpcError, TransportClosed, OSError):
                    return False
                if reply["result"] != 0:
                    return False
                step_deadline = asyncio.get_event_loop().time() + 1.0
                while asyncio.get_event_loop().time() < step_deadline:
                    if not self.is_leader():
                        return True
                    await asyncio.sleep(0.02)
            return not self.is_leader()
        finally:
            self._transferring = False

    # ---------------------------------------------------------------- membership
    async def change_configuration(self, new_voters: list[VNode], timeout: float = 10.0) -> None:
        """Joint-consensus membership change: replicate Cold+Cnew, wait for
        it to commit under both majorities, then replicate Cnew."""
        if not self.is_leader():
            raise RaftError(Errc.not_leader)
        if self.config().old_voters is not None:
            # An earlier change attempt left a joint config in the log (e.g.
            # its commit timed out while a new voter bootstrapped). Resume it
            # if the target matches; a different target must wait.
            if sorted(v.id for v in self.config().voters) != sorted(
                v.id for v in new_voters
            ):
                raise RaftError(Errc.configuration_change_in_progress)
            off = self.config_mgr.latest_offset()
        else:
            async with self._op_lock:
                joint = self.config().enter_joint(new_voters)
                off = await self._append_config_locked(joint)
                self._sync_followers_with_config(joint)
        self._fanout_append()
        await self.wait_for_commit(off, timeout)
        async with self._op_lock:
            final = self.config_mgr.latest().leave_joint()
            off = await self._append_config_locked(final)
            self._sync_followers_with_config(final)
        self._fanout_append()
        await self.wait_for_commit(off, timeout)

    def _sync_followers_with_config(self, cfg: GroupConfiguration) -> None:
        dirty = self.dirty_offset
        for n in cfg.all_nodes():
            if n.id != self.self_node.id and n.id not in self._followers:
                self._followers[n.id] = FollowerIndex(n, next_index=0)
        for fid in list(self._followers):
            if not any(n.id == fid for n in cfg.all_nodes()):
                t = self._recovery_tasks.get(fid)
                if t:
                    t.cancel()
                del self._followers[fid]

    # ---------------------------------------------------------------- reads
    async def make_reader(
        self,
        start_offset: int,
        max_bytes: int = 1 << 20,
        max_offset: int | None = None,
        type_filter=None,
    ):
        """Committed reads only (partition::make_reader clamps to
        committed/LSO — partition.h:65). max_offset is a raw log offset,
        further clamped to the commit index."""
        if self._commit_index < start_offset:
            return []
        limit = self._commit_index
        if max_offset is not None:
            limit = min(limit, max_offset)
        r = self.log.read(
            start_offset, max_bytes, max_offset=limit, type_filter=type_filter
        )
        if asyncio.iscoroutine(r):
            r = await r
        return r

    # ------------------------------------------------------------ heartbeats
    def heartbeat_metadata(self) -> list[dict]:
        """Per-follower heartbeat metadata for the shard-level batched
        heartbeat (heartbeat_manager.cc:155-204)."""
        if not self.is_leader():
            return []
        out = []
        for f in self._followers.values():
            if f.is_recovering:
                continue  # recovery traffic already acts as heartbeats
            prev = f.last_dirty_offset if f.last_dirty_offset >= 0 else self.dirty_offset
            out.append(
                {
                    "group": self.group,
                    "node": {"id": self.self_node.id, "revision": self.self_node.revision},
                    "target": {"id": f.node.id, "revision": f.node.revision},
                    "term": self.term,
                    "prev_log_index": prev,
                    "prev_log_term": self.term_at(prev),
                    "commit_index": self._commit_index,
                }
            )
        return out

    def process_heartbeat_reply(self, reply: dict) -> None:
        if not self.is_leader():
            return
        if reply["term"] > self.term:
            self._spawn_bg(self._step_down(reply["term"]))
            return
        f = self._followers.get(reply["node"]["id"])
        if f is None:
            return
        if reply["result"] == 0:
            f.last_dirty_offset = reply["last_dirty_log_index"]
            f.last_flushed_offset = reply["last_flushed_log_index"]
            f.last_hbeat_ok = True
            if f.next_index <= self.dirty_offset and not f.is_recovering:
                f.next_index = max(f.next_index, f.last_dirty_offset + 1)
                if f.next_index <= self.dirty_offset:
                    self._start_recovery(f)
            self._maybe_advance_commit_index()
        elif reply["result"] == 1:
            f.last_hbeat_ok = False
            f.next_index = max(0, min(f.next_index - 1, reply["last_dirty_log_index"] + 1))
            self._start_recovery(f)


class _ReplicateBatcher:
    """Coalesces concurrent quorum-ack replicates into one append + fanout +
    flush (replicate_batcher.cc:40-62)."""

    def __init__(self, consensus: Consensus) -> None:
        self._c = consensus
        self._pending: list[tuple[list[RecordBatch], asyncio.Future, asyncio.Future, float | None]] = []
        self._flush_task: asyncio.Task | None = None

    def tasks(self) -> list[asyncio.Task]:
        return [self._flush_task] if self._flush_task else []

    async def submit(self, batches: list[RecordBatch], timeout: float | None):
        loop = asyncio.get_event_loop()
        enqueued: asyncio.Future = loop.create_future()
        replicated: asyncio.Future = loop.create_future()
        # raft account (resource_mgmt budget plane): batcher entries are
        # bounded bytes, held from submit until the append phase resolves
        # either way. Waiting is bounded backpressure (submitters sit
        # behind the kafka produce admission gate); plane-less processes
        # skip it entirely.
        from redpanda_tpu_torch.resource_mgmt import budgets as _budgets

        acct = _budgets.account_or_none("raft")
        if acct is not None:
            n = sum(b.size_bytes for b in batches)
            reserved = await acct.acquire(n)
            enqueued.add_done_callback(
                lambda _f, a=acct, r=reserved: a.release(r)
            )
        # sample the submitter's ambient trace as the round's owner trace
        # (the flush task itself is deliberately detached); latest non-None
        # submitter wins — ONE resolvable exemplar per flush round is the
        # contract, not per-submission attribution
        tid = tracer.current_trace()
        if tid is not None:
            self._c._replicate_owner = tid
            self._c._replicate_owner_seq += 1
        self._pending.append((batches, enqueued, replicated, timeout))
        if self._flush_task is None or self._flush_task.done():
            # detached: under sustained load this task loops across MANY
            # coalesced replicates — inheriting the first caller's trace id
            # would mis-attribute every later append's spans to it
            with tracer.detached():
                self._flush_task = asyncio.create_task(self._flush())
        return enqueued, replicated

    async def _flush(self) -> None:
        c = self._c
        while self._pending:
            pending, self._pending = self._pending, []
            async with c._op_lock:
                if not c.is_leader():
                    for _, enq, rep, _t in pending:
                        err = RaftError(Errc.not_leader)
                        enq.set_exception(err)
                        rep.set_exception(err)
                        rep.exception()  # consumed
                    continue
                term = c.term
                lasts: list[int] = []
                for batches, enq, _rep, _t in pending:
                    try:
                        res = await c._append_locked(batches)
                        lasts.append(res.last_offset)
                        enq.set_result(res.last_offset)
                    except Exception as e:  # storage failure
                        lasts.append(-1)
                        enq.set_exception(e)
                r = c.log.flush()
                if asyncio.iscoroutine(r):
                    await r
            c._maybe_advance_commit_index()  # single-replica groups commit here
            c._fanout_append()

            async def wait_one(last: int, rep: asyncio.Future, timeout: float | None) -> None:
                if last < 0:
                    if not rep.done():
                        rep.set_exception(RaftError(Errc.timeout, "append failed"))
                    return
                try:
                    await c.wait_for_commit(last, timeout)
                    if not rep.done():
                        rep.set_result(ReplicateResult(last, term))
                except RaftError as e:
                    if not rep.done():
                        rep.set_exception(e)
                except asyncio.CancelledError:
                    # stop() cancels retained bg tasks: submitters must not
                    # hang on a future nobody will resolve
                    if not rep.done():
                        rep.set_exception(RaftError(Errc.shutting_down))
                    raise

            # Don't block the batcher loop on quorum: new submissions keep
            # coalescing while acks stream in. Handles live in the consensus
            # bg set so stop() cancels pending quorum waits.
            for (batches, enq, rep, t), last in zip(pending, lasts):
                c._spawn_bg(wait_one(last, rep, t))


def _encode_entries(batches: list[RecordBatch]) -> bytes:
    """Wire format for append_entries payloads: [term i64][internal batch]…

    The on-disk 61-byte header carries no term (term context comes from the
    segment), but the RPC payload must — the reference's async_adl for
    record_batch_header serializes ctx.term the same way."""
    parts = []
    for b in batches:
        parts.append(struct.pack("<q", b.header.term))
        parts.append(b.encode_internal())
    return b"".join(parts)


def _decode_batches(blob: bytes) -> list[RecordBatch]:
    from redpanda_tpu_torch.models.record import INTERNAL_HEADER_SIZE

    out = []
    at = 0
    while at + 8 + INTERNAL_HEADER_SIZE <= len(blob):
        (term,) = struct.unpack_from("<q", blob, at)
        batch, consumed = RecordBatch.decode_internal(blob, at + 8)
        batch.header.term = term
        out.append(batch)
        at += 8 + consumed
    return out
