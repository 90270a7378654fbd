"""The port's cluster control plane (redpanda_tpu_torch/cluster/: commands,
allocator, members, leaders and shard tables, metadata cache, controller,
backend, metadata dissemination, cluster service) on the CPU, held to the
JAX package's.

Every test of tests/test_cluster.py runs here against the port: N brokers in
one process (storage, an rpc server, a ``GroupManager(device="cpu")``, the
controller on raft group 0, its backend and the leadership gossip) over
real sockets, at the same 150/40 ms raft timings and with the same
``flaky_election_retry`` marks.

Then the two packages meet. Every controller command's record and batch
bytes equal the JAX package's, and ``Command.from_record`` decodes each
package's bytes in the other; the allocator's replica sets, the shard
table's routing and the gossip's update bytes are equal on the same seeded
inputs. A mixed cluster (two JAX brokers and one port broker) shares one
controller: a topic the JAX leader creates reconciles on the port broker,
and a create the port broker's dispatcher forwards applies on the JAX
brokers. A JAX cluster's directories, after topics were created and a
replica moved, restart as port brokers whose replayed tables, hosted
partitions and logs equal the JAX brokers'.

Last, the wiring around the controller: a port ``Broker`` wired to it
materializes a coproc script's output through the controller, with the
records the standalone broker writes; and a controller on a ``"cuda"``
group manager without a card raises at ``start`` and creates no group.
"""

from __future__ import annotations

import asyncio
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raft_stability import flaky_election_retry, wait_for_stable_leader
from redpanda_tpu_torch.raft import device_plane

PORT_ROOT, JAX_ROOT = "redpanda_tpu_torch", "redpanda_tpu"
FAST = dict(election_timeout_ms=150, heartbeat_interval_ms=40)
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
    while not pred():
        if asyncio.get_event_loop().time() > deadline:
            raise AssertionError(f"timeout: {msg}")
        await asyncio.sleep(interval)


def _pkg(root: str) -> SimpleNamespace:
    """One package's control-plane parts: the port's or the JAX package's."""
    m = lambda name: importlib.import_module(f"{root}.{name}")
    return SimpleNamespace(
        root=root,
        rpc=m("rpc"),
        cluster=m("cluster"),
        cmds=m("cluster.commands"),
        service=m("cluster.service"),
        mdd=m("cluster.metadata_dissemination"),
        allocator=m("cluster.allocator"),
        raft=m("raft"),
        StorageApi=m("storage.log_manager").StorageApi,
        NTP=m("models.fundamental").NTP,
        record=m("models.record"),
        port=root == PORT_ROOT,
    )


PORT = _pkg(PORT_ROOT)
_JAX = []


def _jax() -> SimpleNamespace:
    if not _JAX:
        _JAX.append(_pkg(JAX_ROOT))
    return _JAX[0]


class ClusterNode:
    """One broker: storage + rpc + raft + controller + backend + gossip, of
    the port (``device="cpu"``) or of the JAX package. With ``broker`` the
    port's ``Broker`` is wired to the controller as a broker's start wires
    it: its partition manager is the backend's, its topic table the
    controller's, and it forwards topic mutations through the dispatcher."""

    def __init__(self, node_id: int, base_dir: str, pkg: SimpleNamespace = PORT,
                 broker: bool = False):
        self.node_id = node_id
        self.base_dir = base_dir
        self.pkg = pkg
        self.with_broker = broker
        self.vnode = pkg.raft.VNode(node_id, 0)
        self.connections = pkg.rpc.ConnectionCache()
        self.storage = self.server = self.gm = self.controller = None
        self.backend = self.pm = self.md = self.dispatcher = self.port = None
        self.broker = None
        self.leaders = pkg.cluster.PartitionLeadersTable()
        self.shards = pkg.cluster.ShardTable(n_shards=4)

    async def start(self, port: int = 0) -> "ClusterNode":
        p, c = self.pkg, self.pkg.cluster
        self.storage = await p.StorageApi(self.base_dir).start()
        dev = {"device": "cpu"} if p.port else {}
        self.gm = p.raft.GroupManager(
            self.vnode, self.storage, self.connections,
            timings=p.raft.RaftTimings(**FAST), **dev,
        )
        self.controller = c.Controller(self.vnode, self.gm, self.connections)
        self.dispatcher = c.ControllerDispatcher(self.controller, self.connections)
        if self.with_broker:
            from redpanda_tpu_torch.kafka.server.broker import Broker, BrokerConfig

            self.broker = Broker(BrokerConfig(node_id=self.node_id, data_dir=self.base_dir),
                                 self.storage)
            self.pm = self.broker.partition_manager
        else:
            self.pm = c.PartitionManager(self.storage, self.node_id)
        self.backend = c.ControllerBackend(
            self.vnode, self.controller.topic_table, self.gm, self.pm,
            leaders_table=self.leaders, shard_table=self.shards,
            finish_move=lambda ntp, reps: self.dispatcher.replicate(
                p.cmds.finish_moving_cmd(ntp, reps)
            ),
        )
        self.md = c.MetadataDisseminationService(
            self.node_id, self.leaders, self.controller.members, self.connections,
            interval_s=0.05,
        )
        self.gm.register_leadership_notification(
            lambda cons: self.md.notify_leadership(cons.ntp, cons.leader_id, cons.term)
        )
        proto = p.rpc.SimpleProtocol()
        self.gm.register_service(proto)
        c.ClusterService(self.controller, self.dispatcher).register(proto)
        proto.register_service(p.rpc.ServiceHandler(p.mdd.md_dissemination_service, self.md))
        self.server = p.rpc.Server(port=port)
        self.server.set_protocol(proto)
        await self.server.start()
        self.port = self.server.port
        await self.gm.start()
        if self.broker is not None:
            self.broker.topic_table = self.controller.topic_table
            self.broker.controller_dispatcher = self.dispatcher
            self.broker.controller_leader_fn = lambda: self.controller.leader_id
            self.broker.metadata_cache = c.MetadataCache(
                self.controller.topic_table, self.controller.members, self.leaders
            )
        return self

    async def start_control_plane(self, seeds) -> None:
        await self.controller.start(seeds)
        await self.backend.start()
        await self.md.start()

    async def stop(self) -> None:
        steps = [self.md, self.backend, self.controller, self.gm, self.server, self.storage]
        errors = []
        for part in steps:
            if part is not None:
                try:
                    await part.stop()
                except Exception as e:  # stop every part, then report
                    errors.append(e)
        await self.connections.close()
        self.gm = None
        if errors:
            raise errors[0]


class ClusterFixture:
    def __init__(self, tmp_path, n: int, pkgs=None, broker: bool = False):
        pkgs = pkgs or [PORT] * n
        self.nodes = [ClusterNode(i, str(tmp_path / f"n{i}"), pkgs[i], broker)
                      for i in range(n)]

    async def start(self, ports=None, register: bool = True) -> "ClusterFixture":
        try:
            for i, n in enumerate(self.nodes):
                await n.start(ports[i] if ports else 0)
            self.wire()
            for n in self.nodes:
                await n.start_control_plane([x.vnode for x in self.nodes])
            await self.wait_for_stable_leader()
            # seed brokers register themselves (application start does this on join)
            if register:
                for n in self.nodes:
                    await n.dispatcher.replicate(
                        n.pkg.cmds.register_node_cmd(
                            n.node_id, "127.0.0.1", n.port, "127.0.0.1", 9092 + n.node_id
                        )
                    )
        except BaseException:
            await self.stop()
            raise
        return self

    def wire(self) -> None:
        for a in self.nodes:
            for b in self.nodes:
                if a is not b and b.port is not None:
                    a.connections.register(b.node_id, "127.0.0.1", b.port)

    async def stop(self) -> None:
        errors = []
        for n in self.nodes:
            try:
                await n.stop()
            except Exception as e:
                errors.append(e)
        if errors:
            raise errors[0]

    def controller_leader(self):
        for n in self.nodes:
            if n.controller and n.controller.is_leader():
                return n
        return None

    async def wait_for_stable_leader(self, timeout: float = WAIT_S, margin: float = 1.0):
        """Deflake: see raft_stability.wait_for_stable_leader (margin =
        how many election timeouts the leader must survive in-term)."""
        return await wait_for_stable_leader(
            self.controller_leader,
            lambda n: n.controller.consensus if n.controller else None,
            FAST["election_timeout_ms"] / 1000.0,
            timeout,
            what="controller leader",
            margin=margin,
        )

    async def wait_converged(self, pred_per_node, timeout: float = WAIT_S, msg: str = ""):
        await wait_until(lambda: all(pred_per_node(n) for n in self.nodes), timeout, msg=msg)


def data_batch(*values: bytes, pkg: SimpleNamespace = PORT):
    rec = pkg.record
    return rec.RecordBatch.build(
        [rec.Record(value=v, offset_delta=i) for i, v in enumerate(values)]
    )


def _part_leader(fx, ntp):
    for n in fx.nodes:
        p = n.pm.get(ntp)
        if p is not None and p.is_leader():
            return n
    return None


QUORUM = PORT.raft.ConsistencyLevel.quorum_ack
TopicConfig = PORT.cluster.TopicConfig
NTP = PORT.NTP
ccmds = PORT.cmds


# ===================================================================== tests/test_cluster.py
def test_create_topic_reconciles_on_all_replicas(tmp_path):
    async def main():
        fx = await ClusterFixture(tmp_path, 3).start()
        try:
            leader = await fx.wait_for_stable_leader()
            await leader.controller.create_topic(
                TopicConfig("events", partition_count=2, replication_factor=3)
            )
            await fx.wait_converged(
                lambda n: n.controller.topic_table.contains("events"),
                msg="topic table convergence",
            )
            await fx.wait_converged(
                lambda n: all(n.pm.get(NTP.kafka("events", p)) is not None for p in range(2)),
                msg="partitions materialized",
            )
            ntp = NTP.kafka("events", 0)
            await wait_until(lambda: _part_leader(fx, ntp) is not None, msg="partition leader")
            ln = _part_leader(fx, ntp)
            res = await ln.pm.get(ntp).replicate([data_batch(b"hello")], QUORUM)
            assert res.last_offset >= 0
        finally:
            await fx.stop()

    run(main())


def test_forwarding_from_non_leader(tmp_path):
    async def main():
        fx = await ClusterFixture(tmp_path, 3).start()
        try:
            leader = await fx.wait_for_stable_leader()
            follower = next(n for n in fx.nodes if n is not leader)
            ntp = NTP.kafka("fwd", 0)
            cmd = ccmds.create_topic_cmd(
                {"name": "fwd", "ns": "kafka", "replication_factor": 3, "overrides": {}},
                [ccmds.assignment_payload(ntp, 1000, [0, 1, 2])],
            )
            await follower.dispatcher.replicate(cmd)
            await fx.wait_converged(
                lambda n: n.controller.topic_table.contains("fwd"),
                msg="forwarded create applied",
            )
        finally:
            await fx.stop()

    run(main())


def test_delete_topic_removes_partitions(tmp_path):
    async def main():
        fx = await ClusterFixture(tmp_path, 3).start()
        try:
            leader = await fx.wait_for_stable_leader()
            await leader.controller.create_topic(
                TopicConfig("gone", partition_count=1, replication_factor=3)
            )
            ntp = NTP.kafka("gone", 0)
            await fx.wait_converged(lambda n: n.pm.get(ntp) is not None, msg="created")
            await leader.controller.delete_topic("gone")
            await fx.wait_converged(
                lambda n: n.pm.get(ntp) is None
                and not n.controller.topic_table.contains("gone"),
                msg="deleted everywhere",
            )
        finally:
            await fx.stop()

    run(main())


def test_metadata_cache_and_leader_gossip(tmp_path):
    async def main():
        fx = await ClusterFixture(tmp_path, 3).start()
        try:
            leader = await fx.wait_for_stable_leader()
            await leader.controller.create_topic(
                TopicConfig("md", partition_count=1, replication_factor=3)
            )
            ntp = NTP.kafka("md", 0)
            await fx.wait_converged(
                lambda n: n.leaders.get_leader(ntp) is not None,
                msg="leader known cluster-wide",
            )
            n0 = fx.nodes[0]
            cache = PORT.cluster.MetadataCache(
                n0.controller.topic_table, n0.controller.members, n0.leaders
            )
            assert cache.get_leader(ntp) is not None
            assert len(cache.all_brokers()) == 3
            assert cache.contains("md")
        finally:
            await fx.stop()

    run(main())


@flaky_election_retry(
    "4-node membership churn on top of a fresh controller: heartbeats "
    "delayed by CI load can depose the settled leader mid-move"
)
def test_replica_move(tmp_path):
    async def main():
        fx = await ClusterFixture(tmp_path, 4).start()
        try:
            leader = await fx.wait_for_stable_leader(margin=1.5)
            await leader.controller.create_topic(
                TopicConfig("mv", partition_count=1, replication_factor=3)
            )
            ntp = NTP.kafka("mv", 0)
            await fx.wait_converged(
                lambda n: n.controller.topic_table.contains("mv"), msg="created"
            )
            md = leader.controller.topic_table.get("mv")
            old = list(md.assignments[0].replicas)
            outsider = next(i for i in range(4) if i not in old)
            victim = old[0]
            target = [r for r in old if r != victim] + [outsider]
            await leader.controller.move_partition_replicas(ntp, target)
            await wait_until(lambda: fx.nodes[outsider].pm.get(ntp) is not None,
                             msg="new replica created")
            await wait_until(lambda: fx.nodes[victim].pm.get(ntp) is None,
                             msg="old replica dropped")
            md2 = leader.controller.topic_table.get("mv")
            assert sorted(md2.assignments[0].replicas) == sorted(target)
            assert md2.assignments[0].moving_to is None
        finally:
            await fx.stop()

    run(main())


@flaky_election_retry(
    "decommission drains replicas through the controller while startup "
    "elections can still thrash under CI load"
)
def test_decommission_drains_node(tmp_path):
    async def main():
        fx = await ClusterFixture(tmp_path, 4).start()
        try:
            leader = await fx.wait_for_stable_leader(margin=1.5)
            await leader.controller.create_topic(
                TopicConfig("dr", partition_count=2, replication_factor=3)
            )
            await fx.wait_converged(
                lambda n: n.controller.topic_table.contains("dr"), msg="created"
            )
            victim = next(
                n.node_id
                for n in fx.nodes
                if n is not leader
                and any(
                    n.node_id in pa.replicas
                    for pa in leader.controller.topic_table.get("dr").assignments.values()
                )
            )
            await leader.controller.decommission_node(victim)

            def drained():
                md = leader.controller.topic_table.get("dr")
                return all(
                    victim not in pa.replicas and pa.moving_to is None
                    for pa in md.assignments.values()
                )

            await wait_until(drained, msg="node drained")
            await wait_until(
                lambda: leader.controller.members.get(victim).state
                == PORT.cluster.MembershipState.removed,
                msg="finish_reallocations applied",
            )
            assert victim not in leader.controller.members.node_ids()
        finally:
            await fx.stop()

    run(main())


def test_allocator_constraints():
    from redpanda_tpu_torch.cluster import AllocationError, PartitionAllocator

    a = PartitionAllocator()
    for i in range(3):
        a.register_node(i)
    sets = a.allocate(6, 3, commit=True)
    assert all(len(set(s)) == 3 for s in sets)
    assert all(n.allocated == 6 for n in a.nodes())
    a.allocate(4, 2)
    assert all(n.allocated == 6 for n in a.nodes())
    a.decommission_node(2)
    with pytest.raises(AllocationError):
        a.allocate(1, 3)
    sets = a.allocate(2, 2)
    assert all(2 not in s for s in sets)


def test_duplicate_create_applies_as_first_wins_noop(tmp_path):
    async def main():
        fx = await ClusterFixture(tmp_path, 3).start()
        try:
            leader = await fx.wait_for_stable_leader()
            ntp = NTP.kafka("dup", 0)
            cmd1 = ccmds.create_topic_cmd(
                {"name": "dup", "ns": "kafka", "replication_factor": 3, "overrides": {}},
                [ccmds.assignment_payload(ntp, 2000, [0, 1, 2])],
            )
            cmd2 = ccmds.create_topic_cmd(
                {"name": "dup", "ns": "kafka", "replication_factor": 3, "overrides": {}},
                [ccmds.assignment_payload(ntp, 2001, [2, 1, 0])],  # the loser
            )
            await leader.controller.replicate_and_wait(cmd1)
            await leader.controller.replicate_and_wait(cmd2)  # no raise
            await fx.wait_converged(
                lambda n: n.controller.topic_table.contains("dup"), msg="applied everywhere"
            )
            for node in fx.nodes:
                md = node.controller.topic_table.get("dup")
                assert md is not None
                assert md.assignments[0].group == 2000  # first wins
        finally:
            await fx.stop()

    run(main())


def test_join_via_non_leader_seed(tmp_path):
    async def main():
        fx = await ClusterFixture(tmp_path, 3).start()
        try:
            leader = await fx.wait_for_stable_leader()
            seed = next(n for n in fx.nodes if n is not leader)  # NON-leader seed
            from redpanda_tpu_torch.cluster import Broker, join_cluster

            joiner_conns = PORT.rpc.ConnectionCache()
            try:
                await join_cluster(
                    Broker(9, "127.0.0.1", 5999, "127.0.0.1", 9099),
                    ("127.0.0.1", seed.port),
                    joiner_conns,
                    seed_node_hint=seed.node_id,
                )
                await fx.wait_converged(
                    lambda n: n.controller.members.contains(9),
                    msg="joined broker visible cluster-wide",
                )
            finally:
                await joiner_conns.close()
        finally:
            await fx.stop()

    run(main())


def test_shard_table_stable_and_grouped():
    st = PORT.cluster.ShardTable(n_shards=8)
    ntps = [NTP.kafka("t", p) for p in range(64)]
    first = [st.shard_for(n) for n in ntps]
    assert first == [st.shard_for(n) for n in ntps]  # deterministic
    groups = st.group_by_shard(ntps)
    assert sum(len(v) for v in groups.values()) == 64
    assert len(groups) > 1  # spreads
    st.update(ntps[0], 3)
    assert st.shard_for(ntps[0]) == 3


@flaky_election_retry(
    "forced leadership transfers mid-produce: a transfer can race a "
    "load-delayed election and leave no leader within the wait budget"
)
def test_offsets_gap_free_across_leadership_transfers(tmp_path):
    """Leadership changes mid-produce append non-data batches to the raft
    log; the Kafka-visible offsets stay contiguous from 0."""

    async def main():
        fx = await ClusterFixture(tmp_path, 3).start()
        try:
            leader = await fx.wait_for_stable_leader(margin=1.5)
            await leader.controller.create_topic(
                TopicConfig("gapless", partition_count=1, replication_factor=3)
            )
            ntp = NTP.kafka("gapless", 0)
            await fx.wait_converged(lambda n: n.pm.get(ntp) is not None,
                                    msg="partition everywhere")
            total = 0
            for round_ in range(3):
                await wait_until(lambda: _part_leader(fx, ntp) is not None, msg="leader")
                p = _part_leader(fx, ntp).pm.get(ntp)
                for i in range(4):
                    res = await p.replicate([data_batch(b"r%d-%d" % (round_, i))], QUORUM)
                    assert res.base_offset == total, (res, total)
                    total += 1
                if round_ < 2:  # transfer leadership -> config/election churn
                    assert await p.consensus.do_transfer_leadership()
                    await wait_until(
                        lambda: (
                            (n := _part_leader(fx, ntp)) is not None
                            and n.pm.get(ntp).consensus.leadership_settled()
                        ),
                        msg="settled post-transfer leader",
                    )
            await wait_until(lambda: _part_leader(fx, ntp) is not None, msg="final leader")
            p = _part_leader(fx, ntp).pm.get(ntp)
            assert p.otl.total_delta() > 0, "test exercised no config batches"
            await wait_until(lambda: p.high_watermark >= total, msg="hwm catchup")
            batches = await p.make_reader(0, 1 << 30)
            offsets = [b.base_offset + r.offset_delta for b in batches for r in b.records()]
            assert offsets == list(range(total)), offsets
            assert p.high_watermark == total
        finally:
            await fx.stop()

    run(main())


# ===================================================================== bytes across packages
def _command_cases(pk) -> dict:
    """Every controller command of the package ``pk`` (its builders where it
    has one, the bare ``Command`` for the user and ACL commands), on the
    same inputs."""
    c, N = pk.cmds, pk.NTP
    T = c.CommandType
    ntp = N.kafka("orders", 3)
    a = [c.assignment_payload(N.kafka("orders", p), 10 + p, [p % 3, (p + 1) % 3, (p + 2) % 3])
         for p in range(4)]
    return {
        "create_topic": c.create_topic_cmd(
            {"name": "orders", "ns": "kafka", "replication_factor": 3,
             "overrides": {"cleanup.policy": "compact", "retention.ms": "60000"}}, a),
        "delete_topic": c.delete_topic_cmd("kafka", "orders"),
        "update_topic_properties": c.update_topic_properties_cmd(
            "kafka", "orders", {"retention.bytes": "1048576", "segment.bytes": None}),
        "move_partition_replicas": c.move_partition_replicas_cmd(ntp, [2, 0, 3]),
        "finish_moving_partition_replicas": c.finish_moving_cmd(ntp, [2, 0, 3]),
        "create_partition": c.create_partition_cmd("kafka", "orders", a[2:]),
        "create_non_replicable_topic": c.create_non_replicable_topic_cmd(
            "kafka", "orders", "orders.$errs$"),
        "create_user": c.Command(T.create_user, {"username": "alice", "mechanism": "SCRAM-SHA-256",
                                                 "salt": "c2FsdA==", "iterations": 4096}),
        "delete_user": c.Command(T.delete_user, {"username": "alice"}),
        "update_user": c.Command(T.update_user, {"username": "alice", "iterations": 8192}),
        "create_acls": c.Command(T.create_acls, {"bindings": [
            {"principal": "User:alice", "resource": "topic", "name": "orders",
             "op": "read", "permission": "allow"}]}),
        "delete_acls": c.Command(T.delete_acls, {"filters": [{"principal": "User:alice"}]}),
        "create_data_policy": c.create_data_policy_cmd(
            "orders", "errs", '{"v":2,"ops":[{"op":"where"}]}'),
        "delete_data_policy": c.delete_data_policy_cmd("orders"),
        "register_node": c.register_node_cmd(4, "10.0.0.4", 33145, "10.0.0.4", 9092),
        "register_node_admin": c.register_node_cmd(5, "h5", 33146, "k5", 9093, admin_port=9644),
        "decommission_node": c.decommission_node_cmd(4),
        "recommission_node": c.recommission_node_cmd(4),
        "finish_reallocations": c.Command(T.finish_reallocations, {"node_id": 4}),
        "empty_payload": c.Command(T.delete_topic, {}),
    }


def test_every_command_type_has_a_case():
    cases = _command_cases(PORT)
    assert {c.type for c in cases.values()} == set(PORT.cmds.CommandType)
    assert ([(t.name, int(t)) for t in PORT.cmds.CommandType]
            == [(t.name, int(t)) for t in _jax().cmds.CommandType])
    assert ({t.name: int(b) for t, b in PORT.cmds.BATCH_TYPE_FOR.items()}
            == {t.name: int(b) for t, b in _jax().cmds.BATCH_TYPE_FOR.items()})


@pytest.mark.parametrize("name", list(_command_cases(PORT)))
def test_command_bytes_equal_and_decode_across_packages(name):
    mine, ref = _command_cases(PORT)[name], _command_cases(_jax())[name]
    assert mine.data == ref.data
    got, want = mine.to_batch(), ref.to_batch()
    (rec,), (ref_rec,) = list(got.records()), list(want.records())
    assert (rec.key, rec.value) == (ref_rec.key, ref_rec.value)
    assert got.encode_internal() == want.encode_internal()
    # the JAX package's bytes decode in the port, and the port's in the JAX package
    (from_ref,) = PORT.record.RecordBatch.decode_internal(want.encode_internal())[0].records()
    cmd = PORT.cmds.Command.from_record(from_ref)
    assert (cmd.type, cmd.data) == (mine.type, mine.data)
    (from_port,) = _jax().record.RecordBatch.decode_internal(got.encode_internal())[0].records()
    cmd = _jax().cmds.Command.from_record(from_port)
    assert (int(cmd.type), cmd.data) == (int(ref.type), ref.data)


def _allocator_trace(pk, seed: int) -> list:
    """A seeded sequence of register, allocate, decommission, recommission,
    reallocate and deallocate on the package's ``PartitionAllocator``: each
    step's answer (replica sets or the error's type) and the nodes' books."""
    rng = np.random.default_rng(seed)
    a = pk.allocator.PartitionAllocator()
    out = []
    for _ in range(200):
        op = int(rng.integers(0, 8))
        ids = [n.node_id for n in a.nodes()]
        try:
            if op == 0 or not ids:
                nid = int(rng.integers(0, 9))
                a.register_node(nid, max_capacity=int(rng.integers(4, 40)))
                got = ("register", nid)
            elif op == 1:
                got = a.allocate(int(rng.integers(1, 6)), int(rng.integers(1, 4)),
                                 commit=bool(rng.integers(0, 2)))
            elif op == 2:
                got = a.decommission_node(int(rng.choice(ids)))
            elif op == 3:
                got = a.recommission_node(int(rng.choice(ids)))
            elif op == 4:
                current = [int(x) for x in rng.choice(ids, min(len(ids), 3), replace=False)]
                got = a.reallocate_replica(current, current[0])
            elif op == 5:
                reps = [int(x) for x in rng.choice(ids, min(len(ids), 2), replace=False)]
                a.note_allocated(reps)
                got = ("noted", reps)
            elif op == 6:
                reps = [int(x) for x in rng.choice(ids, min(len(ids), 2), replace=False)]
                a.deallocate(reps)
                got = ("freed", reps)
            else:
                nid = int(rng.choice(ids))
                a.unregister_node(nid)
                got = ("unregister", nid)
        except Exception as e:
            got = (type(e).__name__, str(e))
        out.append((op, got, [(n.node_id, n.max_capacity, n.allocated, n.decommissioned)
                              for n in a.nodes()]))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_replica_sets_equal_jax(seed):
    mine, ref = _allocator_trace(PORT, seed), _allocator_trace(_jax(), seed)
    assert mine == ref
    assert any(isinstance(got, list) and got and isinstance(got[0], list) for _op, got, _b in mine)
    assert any(got[0] == "AllocationError" for _op, got, _b in mine if isinstance(got, tuple))


@pytest.mark.parametrize("n_shards", [1, 4, 7])
def test_shard_for_equal_jax(n_shards):
    rng = np.random.default_rng(n_shards)
    names = ["t%d" % i for i in range(40)] + ["orders", "logs.$errs$", "__consumer_offsets"]
    picks = [(str(rng.choice(["kafka", "redpanda"])), str(rng.choice(names)),
              int(rng.integers(0, 4096))) for _ in range(1000)]
    mine = PORT.cluster.ShardTable(n_shards)
    ref = _jax().cluster.ShardTable(n_shards)
    got = [mine.shard_for(PORT.NTP(*x)) for x in picks]
    assert got == [ref.shard_for(_jax().NTP(*x)) for x in picks]
    assert all(0 <= s < n_shards for s in got)
    grouped = mine.group_by_shard([PORT.NTP(*x) for x in picks])
    ref_grouped = ref.group_by_shard([_jax().NTP(*x) for x in picks])
    assert ({s: [str(n) for n in v] for s, v in grouped.items()}
            == {s: [str(n) for n in v] for s, v in ref_grouped.items()})


def test_leadership_update_bytes_equal_jax():
    rng = np.random.default_rng(7)
    raw = [(str(rng.choice(["kafka", "redpanda"])), "t%d" % int(rng.integers(0, 30)),
            int(rng.integers(0, 256)), None if rng.integers(0, 4) == 0 else int(rng.integers(0, 5)),
            int(rng.integers(-1, 50))) for _ in range(300)]
    mine = PORT.mdd._encode_updates([(PORT.NTP(ns, t, p), l, term) for ns, t, p, l, term in raw])
    ref = _jax().mdd._encode_updates([(_jax().NTP(ns, t, p), l, term) for ns, t, p, l, term in raw])
    assert mine == ref
    back = PORT.mdd._decode_updates(ref)
    assert [(n.ns, n.topic, n.partition, l, t) for n, l, t in back] == raw
    back = _jax().mdd._decode_updates(mine)
    assert [(n.ns, n.topic, n.partition, l, t) for n, l, t in back] == raw
    assert PORT.mdd.md_dissemination_service.name == _jax().mdd.md_dissemination_service.name
    assert ([(m.name, m.id) for m in PORT.mdd.md_dissemination_service.methods.values()]
            == [(m.name, m.id) for m in _jax().mdd.md_dissemination_service.methods.values()])


def test_cluster_exports_equal_jax():
    assert PORT.cluster.__all__ == _jax().cluster.__all__
    for name in PORT.cluster.__all__:
        mine, ref = getattr(PORT.cluster, name), getattr(_jax().cluster, name)
        if isinstance(mine, type) or callable(mine):
            assert mine.__module__.startswith(PORT_ROOT + "."), name
            assert mine.__module__.split(".", 1)[1] == ref.__module__.split(".", 1)[1], name
        else:
            assert str(mine) == str(ref), name
    assert ([(m.name, m.id) for m in PORT.service.cluster_service.methods.values()]
            == [(m.name, m.id) for m in _jax().service.cluster_service.methods.values()])
    ops = ("OP_CREATE_TOPIC", "OP_DELETE_TOPIC", "OP_ADD_PARTITIONS", "OP_DECOMMISSION",
           "OP_RECOMMISSION", "OP_CREATE_NON_REPLICABLE")
    assert [getattr(PORT.service, o) for o in ops] == [getattr(_jax().service, o) for o in ops]


# ===================================================================== clusters across packages
def _table_view(controller) -> dict:
    """A topic table as plain values, comparable across packages."""
    out = {}
    for name, md in controller.topic_table.topics().items():
        cfg = md.config
        out[name] = (
            cfg.ns, cfg.partition_count, cfg.replication_factor, cfg.config_map(),
            {p: (str(pa.ntp), list(pa.replicas), pa.group,
                 None if pa.moving_to is None else list(pa.moving_to))
             for p, pa in sorted(md.assignments.items())},
        )
    return out


def _members_view(controller) -> list:
    return sorted((b.node_id, b.host, b.port, b.kafka_host, b.kafka_port, b.admin_port,
                   int(b.state)) for b in controller.members._brokers.values())


def _allocator_view(controller) -> list:
    return sorted((n.node_id, n.allocated, n.decommissioned)
                  for n in controller.allocator.nodes())


async def _log_bytes(log, upto: int) -> list:
    """Every batch of a log up to ``upto`` as (term, internal bytes)."""
    out, at = [], log.offsets().start_offset
    while at <= upto:
        batches = log.read(at, 1 << 20, max_offset=upto)
        if asyncio.iscoroutine(batches):
            batches = await batches
        if not batches:
            break
        out += [(b.header.term, b.encode_internal()) for b in batches]
        at = batches[-1].last_offset + 1
    return out


def _hosted(node) -> list:
    return sorted(str(ntp) for ntp in node.pm.partitions())


@flaky_election_retry("a mixed cluster's fresh leader can be deposed under xdist load")
def test_mixed_cluster_shares_one_controller(tmp_path):
    async def main():
        # nodes 0 and 1: the JAX package's; node 2: the port's, validating
        # every append of group 0 and of the data groups on the CPU plane
        device_plane.configure(crc_validate=True)
        fx = await ClusterFixture(tmp_path, 3, [_jax(), _jax(), PORT]).start()
        port_node = fx.nodes[2]
        try:
            leader = await fx.wait_for_stable_leader()
            if leader is port_node:
                assert await port_node.controller.consensus.do_transfer_leadership(0)
                leader = await fx.wait_for_stable_leader()
            assert leader is not port_node
            # created on a JAX controller: reconciles on the port broker
            await leader.controller.create_topic(
                _jax().cluster.TopicConfig("mixed-a", partition_count=2, replication_factor=3)
            )
            await fx.wait_converged(
                lambda n: all(n.pm.get(n.pkg.NTP.kafka("mixed-a", p)) is not None
                              for p in range(2)),
                msg="mixed-a hosted everywhere",
            )
            # forwarded by the port broker's dispatcher: applies on the JAX brokers
            await port_node.dispatcher.topic_op(
                PORT.service.OP_CREATE_TOPIC,
                {"name": "mixed-b", "ns": "kafka", "partitions": 1, "replication": 3,
                 "overrides": {}},
            )
            await fx.wait_converged(
                lambda n: n.pm.get(n.pkg.NTP.kafka("mixed-b", 0)) is not None,
                msg="mixed-b hosted everywhere",
            )
            await fx.wait_converged(
                lambda n: _table_view(n.controller) == _table_view(port_node.controller),
                msg="equal topic tables",
            )
            assert set(_table_view(port_node.controller)) == {"mixed-a", "mixed-b"}
            assert _members_view(port_node.controller) == _members_view(leader.controller)
            # a data group led by a JAX broker replicates to the port broker
            ntp = PORT.NTP.kafka("mixed-b", 0)
            jntp = _jax().NTP.kafka("mixed-b", 0)

            def jax_leader():
                for n in fx.nodes[:2]:
                    p = n.pm.get(jntp)
                    if p is not None and p.is_leader():
                        return p
                return None

            pl = port_node.pm.get(ntp)
            await wait_until(lambda: pl.leader_id is not None, msg="mixed-b leader")
            if pl.is_leader():
                assert await pl.consensus.do_transfer_leadership(0)
                await wait_until(lambda: jax_leader() is not None, msg="JAX leader of mixed-b")
            await wait_until(lambda: jax_leader() is not None, msg="JAX leader of mixed-b")
            res = await jax_leader().replicate([data_batch(b"m0", b"m1", pkg=_jax())],
                                               _jax().raft.ConsistencyLevel.quorum_ack)
            await wait_until(lambda: pl.consensus.commit_index >= res.last_offset,
                             msg="port replica commits")
            want = await _log_bytes(jax_leader().consensus.log, res.last_offset)
            assert await _log_bytes(pl.consensus.log, res.last_offset) == want
            assert device_plane.default_plane("cpu").stats()["validations"] > 0
        finally:
            await fx.stop()

    run(main())


@flaky_election_retry("a cluster's fresh leader can be deposed under xdist load")
def test_jax_controller_directories_restart_as_port_brokers(tmp_path):
    async def main():
        J = _jax()
        fx = await ClusterFixture(tmp_path, 3, [J] * 3).start()
        ports = [n.port for n in fx.nodes]
        try:
            leader = await fx.wait_for_stable_leader()
            await leader.controller.create_topic(J.cluster.TopicConfig("carry-a", 2, 3))
            await leader.controller.create_topic(J.cluster.TopicConfig("carry-b", 1, 2))
            await fx.wait_converged(
                lambda n: all(n.controller.topic_table.contains(t) for t in ("carry-a", "carry-b")),
                msg="created",
            )
            md = leader.controller.topic_table.get("carry-b")
            old = list(md.assignments[0].replicas)
            outsider = next(i for i in range(3) if i not in old)
            target = old[1:] + [outsider]
            bntp = J.NTP.kafka("carry-b", 0)
            await fx.wait_converged(
                lambda n: n.node_id not in old or n.pm.get(bntp) is not None, msg="carry-b hosted"
            )
            await wait_until(lambda: _part_leader(fx, bntp) is not None, msg="carry-b leader")
            await _part_leader(fx, bntp).pm.get(bntp).replicate(
                [data_batch(b"before-move", pkg=J)], J.raft.ConsistencyLevel.quorum_ack)
            await leader.controller.move_partition_replicas(bntp, target)
            await wait_until(
                lambda: (pa := leader.controller.topic_table.get("carry-b").assignments[0])
                .moving_to is None and sorted(pa.replicas) == sorted(target),
                msg="move finished",
            )
            await wait_until(lambda: fx.nodes[old[0]].pm.get(bntp) is None, msg="old replica gone")
            last = {}
            for p, vals in ((0, [b"a0", b"a1"]), (1, [b"a2"])):
                ntp = J.NTP.kafka("carry-a", p)
                await wait_until(lambda: _part_leader(fx, ntp) is not None, msg="carry-a leader")
                res = await _part_leader(fx, ntp).pm.get(ntp).replicate(
                    [data_batch(*vals, pkg=J)], J.raft.ConsistencyLevel.quorum_ack)
                last[str(ntp)] = res.last_offset
            await wait_until(lambda: _part_leader(fx, bntp) is not None, msg="carry-b leader")
            res = await _part_leader(fx, bntp).pm.get(bntp).replicate(
                [data_batch(b"after-move", pkg=J)], J.raft.ConsistencyLevel.quorum_ack)
            last[str(bntp)] = res.last_offset
            await fx.wait_converged(
                lambda n: all(c.commit_index >= c.dirty_offset for c in n.gm.groups())
                and all(c.commit_index >= leader.controller.consensus.commit_index
                        for c in n.gm.groups() if c.group == 0),
                msg="every group committed",
            )
            before = {}
            for n in fx.nodes:
                logs = {str(c.ntp): (c.dirty_offset, await _log_bytes(c.log, c.dirty_offset))
                        for c in n.gm.groups()}
                before[n.node_id] = (_table_view(n.controller), _members_view(n.controller),
                                     _allocator_view(n.controller), _hosted(n), logs)
        finally:
            await fx.stop()
        assert len({str(b[:3]) for b in before.values()}) == 1  # the JAX brokers agreed
        a0, a1, b0 = (str(J.NTP.kafka(t, p)) for t, p in
                      (("carry-a", 0), ("carry-a", 1), ("carry-b", 0)))
        assert before[outsider][3] == sorted([a0, a1, b0])
        assert before[old[0]][3] == sorted([a0, a1])
        # the same directories and rpc ports under the port: the members
        # table replays the addresses the JAX brokers registered
        port = ClusterFixture(tmp_path, 3)
        try:
            await port.start(ports=ports, register=False)
            for n in port.nodes:
                want = before[n.node_id]
                await wait_until(
                    lambda n=n, want=want: (_table_view(n.controller), _members_view(n.controller),
                                            _allocator_view(n.controller), _hosted(n))
                    == want[:4],
                    msg=f"port node {n.node_id} replayed",
                )
                for ntp, (upto, log) in want[4].items():
                    c = next(c for c in n.gm.groups() if str(c.ntp) == ntp)
                    assert await _log_bytes(c.log, upto) == log, (n.node_id, ntp)
            assert str(J.cluster.CONTROLLER_NTP) in before[0][4]
        finally:
            await port.stop()

    run(main())


# ===================================================================== wiring around the controller
@flaky_election_retry("a cluster's fresh leader can be deposed under xdist load")
def test_clustered_ensure_materialized_matches_standalone(tmp_path):
    from redpanda_tpu_torch.coproc import governor
    from redpanda_tpu_torch.coproc.api import CoprocApi
    from redpanda_tpu_torch.coproc.engine import TorchEngine
    from redpanda_tpu_torch.kafka.server.broker import Broker, BrokerConfig
    from redpanda_tpu_torch.models.fundamental import COPROC_INTERNAL_TOPIC
    from redpanda_tpu_torch.models.fundamental import NTP as PNTP
    from redpanda_tpu_torch.ops.transforms import Int, Str, filter_field_eq, map_project
    from redpanda_tpu_torch.storage.log_manager import StorageApi

    spec = (filter_field_eq("level", "error") | map_project(Int("code"), Str("msg", 16))).to_json()
    values = [json.dumps({"level": "error" if i % 3 else "info", "code": i, "msg": f"m{i}"},
                         separators=(",", ":")).encode() for i in range(12)]
    mntp = PNTP.kafka("logs.$errs$", 0)

    async def drive(broker, level) -> list:
        api = CoprocApi(broker, device="cpu")
        await api.start()
        api.poll_interval_s = 0.02
        broker.coproc_api = api
        try:
            await broker.create_topic(TopicConfig("logs", 1, 1))
            await wait_until(lambda: broker.get_partition("logs", 0) is not None, msg="logs")
            part = broker.get_partition("logs", 0)
            await wait_until(lambda: part.is_leader(), msg="logs leader")
            for i in range(0, 12, 4):
                await part.replicate([data_batch(*values[i:i + 4])], level)
            # the event log's partition takes the deploy once it has a leader
            while not await api._ensure_internal_topic():
                await asyncio.sleep(0.05)
            await wait_until(
                lambda: (e := broker.get_partition(COPROC_INTERNAL_TOPIC, 0)) is not None
                and e.is_leader(),
                msg="event log leader",
            )
            await api.deploy("errs", spec, ["logs"])
            await wait_until(
                lambda: (m := broker.partition_manager.get(mntp)) is not None
                and m.high_watermark >= 8,
                msg="materialized",
            )
            m = broker.partition_manager.get(mntp)
            out, off = [], m.start_offset
            while off < m.high_watermark:
                batches = await m.make_reader(off, 1 << 20)
                for b in batches:
                    assert b.verify_kafka_crc()
                    out += [(r.key, r.value) for r in b.records()]
                off = batches[-1].last_offset + 1
            return out
        finally:
            await api.stop()

    async def main():
        TorchEngine.reset_columnar_probe()
        governor.reset_journal()
        fx = await ClusterFixture(tmp_path / "clustered", 1, broker=True).start()
        try:
            node = fx.nodes[0]
            clustered = await drive(node.broker, QUORUM)
            md = node.controller.topic_table.get("logs.$errs$")
            assert md is not None and [pa.group for pa in md.assignments.values()] == [-1]
            assert node.broker.metadata_cache.get_leader(mntp) == 0  # the source's leader
        finally:
            await fx.stop()
        storage = await StorageApi(str(tmp_path / "standalone")).start()
        try:
            broker = Broker(BrokerConfig(data_dir=str(tmp_path / "standalone")), storage)
            await broker.recover_topics()
            standalone = await drive(broker, 0)
        finally:
            await storage.stop()
        assert clustered == standalone
        assert len(clustered) == 8

    try:
        run(main())
    finally:
        TorchEngine.reset_columnar_probe()
        governor.reset_journal()


def test_controller_on_cuda_without_a_card_raises_and_creates_no_group(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")

    async def main():
        storage = await PORT.StorageApi(str(tmp_path / "n0")).start()
        cache = PORT.rpc.ConnectionCache()
        try:
            # a group manager that was built where a card answered
            monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
            gm = PORT.raft.GroupManager(PORT.raft.VNode(0, 0), storage, cache,
                                        timings=PORT.raft.RaftTimings(**FAST), device="cuda:0")
            monkeypatch.undo()
            assert gm.device == torch.device("cuda", 0)
            controller = PORT.cluster.Controller(PORT.raft.VNode(0, 0), gm, cache)
            with pytest.raises(RuntimeError, match="no CUDA device"):
                await controller.start([PORT.raft.VNode(0, 0)])
            assert gm.groups() == [] and controller.consensus is None
            assert storage.log_mgr.get(PORT.cluster.CONTROLLER_NTP) is None
            await gm.stop()
        finally:
            await storage.stop()
            await cache.close()

    run(main())
