"""The port's raft (redpanda_tpu_torch/raft/) over its rpc, on the CPU, held
to the JAX package's.

Every test of tests/test_raft.py runs here against the port: N real
``Consensus`` instances with real storage and real rpc over localhost
sockets in one process, with ``GroupManager(device="cpu")``: elections,
replication at every consistency level, failover, follower recovery,
leadership transfer, membership change, snapshot install and restart
persistence, with the reference's deflake helpers (tests/raft_stability.py).

Then the two call sites of the raft device plane, on its plain versions:
a follower's batched CRC check of a torn append (its flags equal the JAX
plane's host oracle, and the append is refused), and the heartbeat ack
tally through a two-shard CPU mesh (``last_tick_acks`` equals the host
sum of the tick's acks). The departures the port's rules force each have
a test: ``default_plane`` refuses a second device, ``install_default_plane``
round-trips, and a ``GroupManager`` on ``"cuda"`` without a card raises.

Last, raft state crosses the packages: a data directory the JAX
package's ``GroupManager`` wrote and stopped resumes in the port with the
same term, vote, commit index and committed values, and a mixed group of
two JAX nodes and one port node elects a leader and replicates, the port
follower's log holding the leader's batches byte for byte. (The JAX nodes
keep their CRC validation off, so no jit runs.)
"""

from __future__ import annotations

import asyncio
import importlib
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from redpanda_tpu_torch import rpc
from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.models.record import Record, RecordBatch, RecordBatchType
from redpanda_tpu_torch.raft import (
    ConsistencyLevel,
    GroupManager,
    RaftError,
    RaftTimings,
    StateMachine,
    VNode,
)
from redpanda_tpu_torch.raft import device_plane
from redpanda_tpu_torch.storage.log_manager import StorageApi

from raft_stability import flaky_election_retry, wait_for_stable_leader

FAST = dict(election_timeout_ms=200.0, heartbeat_interval_ms=25.0, rpc_timeout_s=0.5)
GROUP = 7
NTP_ = NTP("kafka", "rtest", 0)
WAIT_S = 30.0  # wait_until's ceiling: xdist load stretches elections


def _reset_process_state():
    import redpanda_tpu.finjector as ref_finjector
    import redpanda_tpu.resource_mgmt.budgets as ref_budgets
    from redpanda_tpu_torch.finjector import honey_badger
    from redpanda_tpu_torch.resource_mgmt import budgets

    for badger in (honey_badger, ref_finjector.honey_badger):
        for module, probes in badger.armed().items():
            for probe in probes:
                badger.unset(module, probe)
        badger.disable()
    budgets.install(None)
    ref_budgets.install(None)
    device_plane.configure(crc_validate=False, vote_tally=False, mesh_devices=0)
    device_plane.reset_default_plane()
    device_plane.install_default_plane(None)


@pytest.fixture(autouse=True)
def _clean_process_state():
    _reset_process_state()
    yield
    _reset_process_state()


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def wait_until(pred, timeout: float = WAIT_S, interval: float = 0.02, msg: str = ""):
    deadline = asyncio.get_event_loop().time() + timeout
    while True:
        v = pred()
        if asyncio.iscoroutine(v):
            v = await v
        if v:
            return
        if asyncio.get_event_loop().time() > deadline:
            raise AssertionError(f"wait_until timed out: {msg}")
        await asyncio.sleep(interval)


def _pkg(root: str) -> SimpleNamespace:
    """One package's raft node parts: the port's or the JAX package's."""
    m = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        root=root,
        rpc=m("rpc"),
        raft=m("raft"),
        StorageApi=m("storage.log_manager").StorageApi,
        NTP=m("models.fundamental").NTP,
        record=m("models.record"),
        port=root == "redpanda_tpu_torch",
    )


PORT = _pkg("redpanda_tpu_torch")


class RaftNode:
    """One 'broker': storage + rpc server + raft group manager, of the
    port (``device="cpu"``) or of the JAX package."""

    def __init__(self, node_id: int, base_dir: str, pkg: SimpleNamespace = PORT, timings=None):
        self.node_id = node_id
        self.base_dir = base_dir
        self.pkg = pkg
        self.timings = timings or FAST
        self.vnode = pkg.raft.VNode(node_id, 0)
        self.storage = None
        self.server = None
        self.gm = None
        self.connections = pkg.rpc.ConnectionCache()
        self.port: int | None = None

    async def start(self, port: int = 0) -> "RaftNode":
        p = self.pkg
        self.storage = await p.StorageApi(self.base_dir).start()
        dev = {"device": "cpu"} if p.port else {}
        self.gm = p.raft.GroupManager(
            self.vnode, self.storage, self.connections,
            timings=p.raft.RaftTimings(**self.timings), **dev,
        )
        proto = p.rpc.SimpleProtocol()
        self.gm.register_service(proto)
        self.server = p.rpc.Server(port=port)
        self.server.set_protocol(proto)
        await self.server.start()
        self.port = self.server.port
        await self.gm.start()
        return self

    async def create_group(self, ids) -> None:
        p = self.pkg
        await self.gm.create_group(
            GROUP, p.NTP("kafka", "rtest", 0), [p.raft.VNode(i, 0) for i in ids]
        )

    async def stop(self) -> None:
        try:
            if self.gm is not None:
                await self.gm.stop()
                self.gm = None
        finally:
            try:
                if self.server is not None:
                    await self.server.stop()
                    self.server = None
            finally:
                try:
                    if self.storage is not None:
                        await self.storage.stop()
                        self.storage = None
                finally:
                    await self.connections.close()

    def consensus(self):
        return self.gm.consensus_for(GROUP) if self.gm else None


class RaftGroupFixture:
    def __init__(self, tmp_path, n: int, pkgs=None):
        pkgs = pkgs or [PORT] * n
        self.nodes = [RaftNode(i, str(tmp_path / f"n{i}"), pkgs[i]) for i in range(n)]

    async def start(self) -> "RaftGroupFixture":
        for node in self.nodes:
            await node.start()
        self.wire()
        for node in self.nodes:
            await node.create_group(range(len(self.nodes)))
        return self

    def wire(self) -> None:
        for a in self.nodes:
            if a.gm is None:
                continue
            for b in self.nodes:
                if a is not b and b.port is not None:
                    a.connections.register(b.node_id, "127.0.0.1", b.port)

    async def stop(self) -> None:
        errors = []
        for node in self.nodes:
            try:
                await node.stop()
            except Exception as e:  # stop every node, then report
                errors.append(e)
        if errors:
            raise errors[0]

    def live(self):
        return [n for n in self.nodes if n.gm is not None]

    def leader(self):
        for n in self.live():
            c = n.consensus()
            if c is not None and c.is_leader():
                return n
        return None

    async def wait_for_leader(self, timeout: float = WAIT_S) -> "RaftNode":
        await wait_until(lambda: self.leader() is not None, timeout, msg="no leader elected")
        return self.leader()

    async def wait_for_stable_leader(
        self, timeout: float = WAIT_S, margin: float = 1.0
    ) -> "RaftNode":
        """Deflake: see raft_stability.wait_for_stable_leader (margin =
        how many election timeouts the leader must survive in-term)."""
        return await wait_for_stable_leader(
            self.leader,
            lambda n: n.consensus() if n.gm is not None else None,
            FAST["election_timeout_ms"] / 1000.0,
            timeout,
            margin=margin,
        )


def data_batch(*values: bytes) -> RecordBatch:
    return RecordBatch.build(
        [Record(offset_delta=i, value=v) for i, v in enumerate(values)],
        type=RecordBatchType.raft_data,
    )


async def committed_values(c) -> list[bytes]:
    out = []
    start = c.start_offset
    while True:
        batches = await c.make_reader(start, 1 << 20, type_filter=(RecordBatchType.raft_data,))
        if not batches:
            return out
        for b in batches:
            out.extend(b.record_values())
        start = batches[-1].last_offset + 1


# ---------------------------------------------------------------- tests
def test_elect_single_leader(tmp_path):
    async def main():
        fx = await RaftGroupFixture(tmp_path, 3).start()
        try:
            await fx.wait_for_stable_leader()

            def settled() -> bool:
                # exactly one leader and every node in its term — sampled
                # until true: under heavy load a re-election may still fire
                # after the stable wait, but split-brain (two leaders, or a
                # node stuck in an old term) never settles and still fails
                leaders = [n for n in fx.nodes if n.consensus().is_leader()]
                if len(leaders) != 1:
                    return False
                term = leaders[0].consensus().term
                return all(n.consensus().term == term for n in fx.nodes)

            await wait_until(settled, msg="one leader, uniform term")
        finally:
            await fx.stop()

    run(main())


def test_replicate_quorum_reaches_all_nodes(tmp_path):
    async def main():
        fx = await RaftGroupFixture(tmp_path, 3).start()
        try:
            leader = (await fx.wait_for_stable_leader()).consensus()
            res = await leader.replicate([data_batch(b"a", b"b")], ConsistencyLevel.quorum_ack)
            assert leader.commit_index >= res.last_offset
            assert await committed_values(leader) == [b"a", b"b"]
            # followers converge via heartbeat-piggybacked commit index
            for n in fx.nodes:
                await wait_until(
                    lambda c=n.consensus(): c.commit_index >= res.last_offset,
                    msg=f"node {n.node_id} commit index",
                )
                assert await committed_values(n.consensus()) == [b"a", b"b"]
        finally:
            await fx.stop()

    run(main())


@flaky_election_retry("a fresh leader's heartbeats delayed under xdist load can be deposed mid-test")
def test_replicate_coalesces_concurrent_writes(tmp_path):
    async def main():
        fx = await RaftGroupFixture(tmp_path, 3).start()
        try:
            leader = (await fx.wait_for_stable_leader()).consensus()
            results = await asyncio.gather(
                *(leader.replicate([data_batch(b"m%d" % i)]) for i in range(20))
            )
            offsets = [r.last_offset for r in results]
            assert len(set(offsets)) == 20  # all distinct, all acked
            vals = await committed_values(leader)
            assert sorted(vals) == sorted(b"m%d" % i for i in range(20))
        finally:
            await fx.stop()

    run(main())


def test_leader_ack_and_no_ack(tmp_path):
    async def main():
        fx = await RaftGroupFixture(tmp_path, 3).start()
        try:
            leader = (await fx.wait_for_stable_leader()).consensus()
            r1 = await leader.replicate([data_batch(b"la")], ConsistencyLevel.leader_ack)
            r2 = await leader.replicate([data_batch(b"na")], ConsistencyLevel.no_ack)
            assert r2.last_offset > r1.last_offset
            # data still commits eventually (heartbeats propagate+flush)
            await wait_until(lambda: leader.commit_index >= r2.last_offset, msg="eventual commit")
        finally:
            await fx.stop()

    run(main())


def test_not_leader_rejection(tmp_path):
    async def main():
        fx = await RaftGroupFixture(tmp_path, 3).start()
        try:
            await fx.wait_for_stable_leader()
            follower = next(n for n in fx.nodes if not n.consensus().is_leader())
            with pytest.raises(RaftError):
                await follower.consensus().replicate([data_batch(b"x")])
        finally:
            await fx.stop()

    run(main())


def test_leader_failover_and_rejoin(tmp_path):
    async def main():
        fx = await RaftGroupFixture(tmp_path, 3).start()
        try:
            old = await fx.wait_for_stable_leader()
            leader_c = old.consensus()
            await leader_c.replicate([data_batch(b"pre")])
            old_dir = old.base_dir
            old_id = old.node_id
            await old.stop()
            # remaining two elect a new leader and accept writes
            await wait_until(
                lambda: any(
                    n.gm and n.consensus() and n.consensus().is_leader() for n in fx.nodes
                ),
                timeout=WAIT_S,
                msg="failover election",
            )
            new_leader = fx.leader().consensus()
            await new_leader.replicate([data_batch(b"post")])
            # old leader rejoins with its old state and catches up as follower
            node = RaftNode(old_id, old_dir)
            fx.nodes[old_id] = node
            await node.start()
            fx.wire()
            for other in fx.nodes:
                if other is not node:
                    other.connections.register(old_id, "127.0.0.1", node.port)
            voters = [VNode(i, 0) for i in range(3)]
            await node.gm.create_group(GROUP, NTP_, voters)
            await wait_until(
                lambda: node.consensus().commit_index >= new_leader.commit_index,
                timeout=WAIT_S,
                msg="rejoined node catch-up",
            )
            assert await committed_values(node.consensus()) == [b"pre", b"post"]
            assert not node.consensus().is_leader()
        finally:
            await fx.stop()

    run(main())


def test_follower_recovery_after_missing_writes(tmp_path):
    async def main():
        fx = await RaftGroupFixture(tmp_path, 3).start()
        try:
            leader_node = await fx.wait_for_stable_leader()
            leader = leader_node.consensus()
            victim = next(n for n in fx.nodes if n is not leader_node)
            vid, vdir = victim.node_id, victim.base_dir
            await victim.stop()
            for i in range(5):
                await leader.replicate([data_batch(b"w%d" % i)])
            node = RaftNode(vid, vdir)
            fx.nodes[vid] = node
            await node.start()
            fx.wire()
            for other in fx.nodes:
                if other is not node and other.gm is not None:
                    other.connections.register(vid, "127.0.0.1", node.port)
            await node.gm.create_group(GROUP, NTP_, [VNode(i, 0) for i in range(3)])
            await wait_until(
                lambda: node.consensus().commit_index >= leader.commit_index,
                timeout=WAIT_S,
                msg="recovery catch-up",
            )
            assert await committed_values(node.consensus()) == [b"w%d" % i for i in range(5)]
        finally:
            await fx.stop()

    run(main())


def test_leadership_transfer(tmp_path):
    async def main():
        fx = await RaftGroupFixture(tmp_path, 3).start()
        try:
            old = await fx.wait_for_stable_leader()
            target = next(n for n in fx.nodes if n is not old)
            ok = await old.consensus().do_transfer_leadership(target.node_id)
            assert ok
            await wait_until(
                lambda: target.consensus().is_leader(), timeout=WAIT_S, msg="transfer target leads"
            )
            # new leader accepts writes
            await target.consensus().replicate([data_batch(b"after-transfer")])
        finally:
            await fx.stop()

    run(main())


def test_membership_change_add_node(tmp_path):
    async def main():
        fx = RaftGroupFixture(tmp_path, 4)
        for node in fx.nodes:
            await node.start()
        fx.wire()
        try:
            initial = [fx.nodes[i].vnode for i in range(3)]
            for node in fx.nodes[:3]:
                await node.gm.create_group(GROUP, NTP_, initial)
            leader = (await fx.wait_for_stable_leader()).consensus()
            await leader.replicate([data_batch(b"before")])
            # node 3 starts empty with the group (learner-style bootstrap)
            await fx.nodes[3].gm.create_group(GROUP, NTP_, initial)
            await leader.change_configuration([VNode(i, 0) for i in range(4)])
            assert leader.config().old_voters is None
            assert len(leader.config().voters) == 4
            await leader.replicate([data_batch(b"after")])
            c3 = fx.nodes[3].consensus()
            await wait_until(
                lambda: c3.commit_index >= leader.commit_index, timeout=WAIT_S, msg="new node sync"
            )
            assert await committed_values(c3) == [b"before", b"after"]
            assert c3.config().voters == leader.config().voters
        finally:
            await fx.stop()

    run(main())


def test_snapshot_install_for_lagging_follower(tmp_path):
    async def main():
        fx = await RaftGroupFixture(tmp_path, 3).start()
        try:
            leader_node = await fx.wait_for_stable_leader()
            leader = leader_node.consensus()
            victim = next(n for n in fx.nodes if n is not leader_node)
            vid, vdir = victim.node_id, victim.base_dir
            await victim.stop()
            for i in range(4):
                await leader.replicate([data_batch(b"s%d" % i)])
            # snapshot + evict the prefix so recovery MUST install a snapshot
            snap_at = leader.commit_index
            leader.write_snapshot(snap_at, b"stm-state")
            await leader.log.prefix_truncate(snap_at + 1)
            await leader.replicate([data_batch(b"tail")])
            node = RaftNode(vid, vdir)
            fx.nodes[vid] = node
            # wipe the victim's state: it must bootstrap from the snapshot
            import shutil

            shutil.rmtree(vdir)
            await node.start()
            fx.wire()
            for other in fx.nodes:
                if other is not node and other.gm is not None:
                    other.connections.register(vid, "127.0.0.1", node.port)
            await node.gm.create_group(GROUP, NTP_, [VNode(i, 0) for i in range(3)])
            await wait_until(
                lambda: node.consensus().commit_index >= leader.commit_index,
                timeout=WAIT_S,
                msg="snapshot + tail catch-up",
            )
            c = node.consensus()
            snap = c.read_snapshot()
            assert snap is not None and snap[1] == b"stm-state"
            assert await committed_values(c) == [b"tail"]
            assert c.start_offset == snap_at + 1
        finally:
            await fx.stop()

    run(main())


def test_term_and_vote_persist_across_restart(tmp_path):
    async def main():
        fx = await RaftGroupFixture(tmp_path, 3).start()
        try:
            leader = await fx.wait_for_stable_leader()
            term_before = leader.consensus().term
            await leader.consensus().replicate([data_batch(b"p")])
            nid, ndir = leader.node_id, leader.base_dir
            await leader.stop()
            node = RaftNode(nid, ndir)
            fx.nodes[nid] = node
            await node.start()
            fx.wire()
            for other in fx.nodes:
                if other is not node and other.gm is not None:
                    other.connections.register(nid, "127.0.0.1", node.port)
            await node.gm.create_group(GROUP, NTP_, [VNode(i, 0) for i in range(3)])
            # restarted node remembers a term >= the one it led in
            assert node.consensus().term >= term_before
            assert await wait_restart_sees(node, b"p")
        finally:
            await fx.stop()

    async def wait_restart_sees(node, value) -> bool:
        async def has() -> bool:
            return value in (await committed_values(node.consensus()))

        await wait_until(has, timeout=WAIT_S, msg="restarted node sees data")
        return True

    run(main())


class CountingStm(StateMachine):
    def __init__(self, consensus):
        super().__init__(consensus)
        self.seen: list[bytes] = []

    async def apply(self, batch):
        if batch.header.type == RecordBatchType.raft_data:
            self.seen.extend(batch.record_values())


def test_state_machine_apply_loop(tmp_path):
    async def main():
        fx = await RaftGroupFixture(tmp_path, 3).start()
        try:
            leader = (await fx.wait_for_stable_leader()).consensus()
            stm = await CountingStm(leader).start()
            for i in range(3):
                await leader.replicate([data_batch(b"e%d" % i)])
            await stm.wait_applied(leader.commit_index, timeout=WAIT_S)
            assert stm.seen == [b"e0", b"e1", b"e2"]
            await stm.stop()
        finally:
            await fx.stop()

    run(main())


# ---------------------------------------------------------------- the device plane's call sites
class _Recording(device_plane.RaftDevicePlane):
    """A plane that keeps what each call was given and answered."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.validated: list = []
        self.tallied: list = []

    def validate(self, regions, claimed):
        ok = super().validate(regions, claimed)
        self.validated.append((list(regions), np.asarray(claimed, np.uint32).copy(), ok.copy()))
        return ok

    def tally_votes(self, votes):
        out = super().tally_votes(votes)
        self.tallied.append((np.array(votes, copy=True), np.asarray(out).copy()))
        return out


def test_follower_rejects_corrupted_append_crc(tmp_path):
    # the follower half of BASELINE config 5: with crc_validate on,
    # handle_append_entries batch-validates the wire blob before taking the
    # op lock (here on the pinned CPU plane: K5's plain version) and refuses
    # the append when a batch's CRC disagrees with its bytes
    from redpanda_tpu.raft.device_plane import _host_validate as ref_host_validate
    from redpanda_tpu_torch.raft.consensus import _encode_entries, raft_crc_rejected

    async def main():
        plane = _Recording(probe=False, device="cpu")
        device_plane.install_default_plane(plane)
        device_plane.configure(crc_validate=True)
        fx = await RaftGroupFixture(tmp_path, 3).start()
        try:
            leader_node = await fx.wait_for_stable_leader()
            leader = leader_node.consensus()
            res = await leader.replicate([data_batch(b"clean")], ConsistencyLevel.quorum_ack)
            assert leader.commit_index >= res.last_offset
            assert plane.validated and all(ok.all() for _, _, ok in plane.validated)
            follower = next(n for n in fx.nodes if n.node_id != leader_node.node_id).consensus()
            # quorum_ack returned on one follower's ack: the other may still be
            # receiving the clean batch, which would land inside the check below
            await wait_until(lambda: follower.dirty_offset == leader.dirty_offset,
                             msg="the follower holds the clean batch")
            good = data_batch(b"stays-good")
            bad = data_batch(b"payload-to-corrupt")
            good.header.term = bad.header.term = leader.term
            blob = bytearray(_encode_entries([good, bad]))
            blob[-3] ^= 0xFF  # flip a payload byte; the header crc still holds
            dirty = follower.dirty_offset
            rejected = raft_crc_rejected.value
            plane.validated.clear()
            reply = await follower.handle_append_entries({
                "group": GROUP,
                "node": {"id": leader_node.node_id, "revision": 0},
                "target": {"id": follower.self_node.id, "revision": 0},
                "term": follower.term,
                "prev_log_index": dirty,
                "prev_log_term": follower.term_at(dirty),
                "commit_index": follower.commit_index,
                "batches": bytes(blob),
                "flush": True,
            })
            assert reply["result"] == 1  # rejected, not appended
            assert follower.dirty_offset == dirty
            assert raft_crc_rejected.value == rejected + 1
            torn = [v for v in plane.validated if len(v[0]) == 2]
            assert len(torn) == 1
            regions, claimed, ok = torn[0]
            assert ok.tolist() == [True, False]
            np.testing.assert_array_equal(ok, ref_host_validate(regions, claimed))
        finally:
            await fx.stop()

    run(main())


def test_heartbeat_tally_on_a_two_shard_cpu_mesh(tmp_path):
    # the vote half: each tick's acks as a [peer, group] bit matrix through
    # the mesh's aggregator (K7's plain version); last_tick_acks equals the
    # host sum of the acks the tick received
    from redpanda_tpu_torch.parallel.mesh import partition_mesh
    from redpanda_tpu_torch.raft.heartbeat_manager import HeartbeatManager

    async def main():
        plane = _Recording(mesh=partition_mesh(2, device="cpu"), probe=False, device="cpu")
        device_plane.install_default_plane(plane)
        device_plane.configure(vote_tally=True)
        seen = []
        fx = RaftGroupFixture(tmp_path, 3)
        for node in fx.nodes:
            await node.start()
        fx.wire()
        for node in fx.nodes:
            hb = node.gm.heartbeats
            orig = hb._tally_acks

            def spy(acks, hb=hb, orig=orig):
                orig(acks)
                if acks and device_plane.vote_tally_enabled():
                    seen.append((hb, [dict(a) for a in acks], dict(hb.last_tick_acks)))

            hb._tally_acks = spy
        try:
            for node in fx.nodes:
                for g in (GROUP, GROUP + 1, GROUP + 2):
                    await node.gm.create_group(
                        g, NTP("kafka", "rtest", g), [VNode(i, 0) for i in range(3)]
                    )
            await fx.wait_for_stable_leader()
            await wait_until(lambda: any(len(a) == 2 for _, a, _ in seen), msg="a tick to both peers")
            two_peer = [(hb, a, last) for hb, a, last in seen if len(a) == 2]
            for hb, acks, last in two_peer:
                groups = sorted(hb._groups)
                want = {g: sum(1 for a in acks if a.get(g)) for g in groups}
                assert last == want
            # the two-row ticks went through the mesh's aggregator (K7's plain
            # version), a one-row tick (a follower still recovering) to the sum
            assert sum(1 for v, _ in plane.tallied if v.shape[0] == 2) >= len(two_peer)
            for votes, out in plane.tallied:
                np.testing.assert_array_equal(out, votes.astype(np.int32).sum(axis=0))
            assert plane.stats()["tallies"] >= len(two_peer)
        finally:
            await fx.stop()

    run(main())


def test_a_failing_device_leg_fails_the_append(tmp_path):
    # no try on the consensus path hands a failed launch to the host: the
    # follower's append raises (the rpc answers 500), nothing is appended,
    # and the leader's replicate times out
    from redpanda_tpu_torch.raft.consensus import _encode_entries

    class Broken(device_plane.RaftDevicePlane):
        def _run_device(self, rows, lens, claimed):
            raise RuntimeError("crc32c: kernel launch failed, CUDA error 719")

    async def main():
        fx = await RaftGroupFixture(tmp_path, 3).start()
        try:
            leader_node = await fx.wait_for_stable_leader()
            leader = leader_node.consensus()
            device_plane.install_default_plane(Broken(probe=False, device="cpu"))
            device_plane.configure(crc_validate=True)
            follower = next(n for n in fx.nodes if n is not leader_node).consensus()
            dirty = follower.dirty_offset
            batch = data_batch(b"never-validated")
            batch.header.term = leader.term
            with pytest.raises(RuntimeError, match="kernel launch failed"):
                await follower.handle_append_entries({
                    "group": GROUP,
                    "node": {"id": leader_node.node_id, "revision": 0},
                    "target": {"id": follower.self_node.id, "revision": 0},
                    "term": follower.term,
                    "prev_log_index": dirty,
                    "prev_log_term": follower.term_at(dirty),
                    "commit_index": follower.commit_index,
                    "batches": _encode_entries([batch]),
                    "flush": True,
                })
            assert follower.dirty_offset == dirty
            with pytest.raises(RaftError):
                await leader.replicate([data_batch(b"x")], timeout=1.0)
            for n in fx.nodes:
                if n is not leader_node:
                    assert n.consensus().dirty_offset == dirty
        finally:
            await fx.stop()

    run(main())


# ---------------------------------------------------------------- departures
def test_default_plane_refuses_a_second_device(monkeypatch):
    plane = device_plane.default_plane("cpu")
    assert device_plane.default_plane("cpu") is plane
    assert plane.device == torch.device("cpu")
    # a plane that runs elsewhere (a card) is never handed to a CPU caller
    monkeypatch.setattr(plane, "device", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="runs on cuda:0"):
        device_plane.default_plane("cpu")


def test_install_default_plane_round_trips():
    pinned = device_plane.RaftDevicePlane(probe=False, device="cpu")
    device_plane.install_default_plane(pinned)
    assert device_plane.default_plane("cpu") is pinned
    assert device_plane.default_plane("cpu").decision == "device"
    device_plane.install_default_plane(None)
    fresh = device_plane.default_plane("cpu")
    assert fresh is not pinned and fresh.decision is None  # the probing plane
    device_plane.reset_default_plane()
    assert device_plane.default_plane("cpu") is not fresh


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is there: nothing raises")
def test_cuda_group_manager_without_a_card_raises(tmp_path):
    async def main():
        device_plane.configure(crc_validate=True, vote_tally=True)
        storage = await StorageApi(str(tmp_path / "n0")).start()
        cache = rpc.ConnectionCache()
        try:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                GroupManager(VNode(0, 0), storage, cache)  # device="cuda"
            with pytest.raises(RuntimeError, match="no CUDA device"):
                device_plane.default_plane("cuda")
        finally:
            await storage.stop()
            await cache.close()

    run(main())


# ---------------------------------------------------------------- across packages
JAX = None


def _jax():
    global JAX
    if JAX is None:
        JAX = _pkg("redpanda_tpu")
    return JAX


async def _log_bytes(c) -> list[bytes]:
    """Every batch of a node's log as (term, internal bytes)."""
    out = []
    at = c.log.offsets().start_offset
    while at <= c.log.offsets().dirty_offset:
        batches = c.log.read(at, 1 << 20)
        if asyncio.iscoroutine(batches):
            batches = await batches
        if not batches:
            break
        out += [(b.header.term, b.encode_internal()) for b in batches]
        at = batches[-1].last_offset + 1
    return out


def _jax_batch(values):
    rec = _jax().record
    return rec.RecordBatch.build(
        [rec.Record(offset_delta=i, value=v) for i, v in enumerate(values)],
        type=rec.RecordBatchType.raft_data,
    )


def test_jax_written_raft_directory_resumes_in_the_port(tmp_path):
    values = [b"r%d" % i for i in range(6)]

    async def main():
        fx = await RaftGroupFixture(tmp_path, 3, [_jax()] * 3).start()
        before = {}
        try:
            leader_node = await fx.wait_for_stable_leader()
            leader = leader_node.consensus()
            for i in range(0, 4, 2):
                await leader.replicate([_jax_batch(values[i : i + 2])])
            snap_at = leader.commit_index
            for i in range(4, 6):
                await leader.replicate([_jax_batch([values[i]])])
            for n in fx.nodes:
                await wait_until(
                    lambda c=n.consensus(): c.commit_index >= leader.commit_index,
                    msg=f"jax node {n.node_id} commit",
                )
            for n in fx.nodes:
                c = n.consensus()
                c.write_snapshot(snap_at, b"stm-state-%d" % n.node_id)
                vote = None if c.voted_for is None else (c.voted_for.id, c.voted_for.revision)
                before[n.node_id] = (
                    c.term, vote, c.commit_index, await committed_values(c), await _log_bytes(c)
                )
        finally:
            await fx.stop()
        assert all(b[3] == values for b in before.values())
        # the same directories under the port: term, vote and the snapshot's
        # commit index as they were, read before any election can run
        port = RaftGroupFixture(tmp_path, 3)
        for n in port.nodes:
            n.timings = dict(RaftTimings().__dict__)  # 600 ms elections
        try:
            for n in port.nodes:
                await n.start()
            port.wire()
            for n in port.nodes:
                await n.create_group(range(3))
                c = n.consensus()
                term, vote, _commit, _vals, log = before[n.node_id]
                assert c.term == term
                assert (None if c.voted_for is None else (c.voted_for.id, c.voted_for.revision)) == vote
                assert c.commit_index == snap_at
                assert c.read_snapshot() == (snap_at, b"stm-state-%d" % n.node_id)
                assert await _log_bytes(c) == log
            leader = (await wait_for_stable_leader(
                port.leader, lambda n: n.consensus(), 0.6, WAIT_S)).consensus()
            assert leader.term > max(b[0] for b in before.values())
            for n in port.nodes:
                await wait_until(
                    lambda c=n.consensus(): c.commit_index >= before[n.node_id][2],
                    msg=f"port node {n.node_id} recommits",
                )
                assert await committed_values(n.consensus()) == values
        finally:
            await port.stop()

    run(main())


@flaky_election_retry("a fresh leader's heartbeats delayed under xdist load can be deposed mid-test")
def test_mixed_group_replicates_to_a_port_follower(tmp_path):
    async def main():
        # nodes 0 and 1: the JAX package's (CRC validation off, no jit);
        # node 2: the port's, validating each append on the CPU plane
        device_plane.configure(crc_validate=True)
        fx = await RaftGroupFixture(tmp_path, 3, [_jax(), _jax(), PORT]).start()
        port_node = fx.nodes[2]
        try:
            leader_node = await fx.wait_for_stable_leader()
            if leader_node is port_node:
                assert await port_node.consensus().do_transfer_leadership(0)
                leader_node = await fx.wait_for_stable_leader()
            assert leader_node is not port_node
            leader = leader_node.consensus()
            vals = [[b"mix-%d-%d" % (i, j) for j in range(3)] for i in range(5)]
            results = await asyncio.gather(*(leader.replicate([_jax_batch(v)]) for v in vals))
            last = max(r.last_offset for r in results)
            follower = port_node.consensus()
            await wait_until(
                lambda: all(n.consensus().commit_index >= last for n in fx.nodes)
                and len({n.consensus().dirty_offset for n in fx.nodes}) == 1,
                msg="port follower catch-up",
            )
            # the port follower's log holds the leader's batches byte for byte
            # (and so does the other JAX node's)
            logs = [await _log_bytes(n.consensus()) for n in fx.nodes]
            assert logs[2] == logs[leader_node.node_id] == logs[1 - leader_node.node_id]
            assert sorted(await committed_values(follower)) == sorted(x for v in vals for x in v)
            assert device_plane.default_plane("cpu").stats()["validations"] > 0
        finally:
            await fx.stop()

    run(main())
