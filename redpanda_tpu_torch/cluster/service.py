"""Internal cluster RPC service + leader-forwarding frontend.

Parity with cluster/service.cc + controller.json: brokers that are not the
controller leader forward mutations (topic ops, node join, decommission) to
the leader over the internal RPC mesh. The wire carries the already-built
``Command`` (type + JSON payload), so the leader-side handler is one line:
replicate_and_wait. join_node is the cluster entry point for new brokers
(members_manager handle_join_request).

(The JAX package's cluster/service.py, copied.)
"""

from __future__ import annotations

import json
import logging

from redpanda_tpu_torch import rpc
from redpanda_tpu_torch.cluster.commands import Command, CommandType
from redpanda_tpu_torch.cluster.controller import (
    ClusterError,
    Controller,
    NotControllerError,
    TopicExistsError,
)
from redpanda_tpu_torch.cluster.members import Broker
from redpanda_tpu_torch.rpc import serde

logger = logging.getLogger("rptorch.cluster.service")

REPLICATE_CMD_REQUEST = serde.S(("type", serde.I32), ("data_json", serde.BYTES))
REPLICATE_CMD_REPLY = serde.S(
    ("errc", serde.I32),  # 0 ok, 1 not-leader, 2 error
    ("leader", serde.I32),  # -1 unknown
    ("message", serde.STRING),
)
JOIN_NODE_REQUEST = serde.S(
    ("node_id", serde.I32),
    ("host", serde.STRING),
    ("port", serde.I32),
    ("kafka_host", serde.STRING),
    ("kafka_port", serde.I32),
    # pandascope: peers dial this for trace fan-out + /metrics federation
    ("admin_port", serde.I32),
)
JOIN_NODE_REPLY = REPLICATE_CMD_REPLY
# Topic ops need LEADER-side logic (partition allocation, group ids), so
# they cannot ride replicate_command's pre-built payloads; op: 0 create,
# 1 delete, 2 add_partitions (controller.json create/delete_topic analogue).
TOPIC_OP_REQUEST = serde.S(("op", serde.I32), ("data_json", serde.BYTES))
TOPIC_OP_REPLY = REPLICATE_CMD_REPLY

cluster_service = rpc.ServiceDef(
    "cluster",
    "controller",
    [
        rpc.MethodDef("replicate_command", REPLICATE_CMD_REQUEST, REPLICATE_CMD_REPLY),
        rpc.MethodDef("join_node", JOIN_NODE_REQUEST, JOIN_NODE_REPLY),
        rpc.MethodDef("topic_op", TOPIC_OP_REQUEST, TOPIC_OP_REPLY),
    ],
)

_OK, _NOT_LEADER, _ERROR, _EXISTS = 0, 1, 2, 3


OP_CREATE_TOPIC, OP_DELETE_TOPIC, OP_ADD_PARTITIONS = 0, 1, 2
OP_DECOMMISSION, OP_RECOMMISSION = 3, 4
OP_CREATE_NON_REPLICABLE = 5  # coproc materialized topics


async def apply_topic_op(controller: Controller, op: int, data: dict) -> None:
    """Leader-side controller frontend op (topics + membership); the ONE
    implementation used by both the RPC handler and the dispatcher's
    local-leader path. Membership ops ride the same channel because they
    too need LEADER-side logic (decommission kicks the replica drain and
    the finish_reallocations watcher, controller.decommission_node — the
    raw replicated command alone only flips membership state)."""
    if op == OP_CREATE_TOPIC:
        from redpanda_tpu_torch.cluster.topic_table import TopicConfig

        cfg = TopicConfig(
            data["name"],
            data["partitions"],
            data["replication"],
            ns=data.get("ns", "kafka"),
        )
        for k, v in (data.get("overrides") or {}).items():
            cfg.apply_override(k, v)
        await controller.create_topic(cfg)
    elif op == OP_DELETE_TOPIC:
        await controller.delete_topic(data["name"], data.get("ns", "kafka"))
    elif op == OP_ADD_PARTITIONS:
        await controller.create_partitions(data["name"], data["total"])
    elif op == OP_DECOMMISSION:
        await controller.decommission_node(data["node_id"])
    elif op == OP_RECOMMISSION:
        await controller.recommission_node(data["node_id"])
    elif op == OP_CREATE_NON_REPLICABLE:
        await controller.create_non_replicable_topic(
            data["source"], data["name"], data.get("ns", "kafka")
        )
    else:
        raise ClusterError(f"unknown frontend op {op}")


class ClusterService:
    """Server-side handler bound on every broker.

    With a dispatcher attached, join_node works against ANY broker (the
    handler forwards to the controller leader itself — members_manager
    handle_join_request semantics); without one it serves leader-local only.
    """

    def __init__(self, controller: Controller, dispatcher: "ControllerDispatcher | None" = None) -> None:
        self.controller = controller
        self.dispatcher = dispatcher

    def register(self, protocol: rpc.SimpleProtocol) -> None:
        protocol.register_service(rpc.ServiceHandler(cluster_service, self))

    def _reply(self, errc: int, message: str = "") -> dict:
        leader = self.controller.leader_id
        return {"errc": errc, "leader": -1 if leader is None else leader, "message": message}

    async def replicate_command(self, req: dict) -> dict:
        cmd = Command(CommandType(req["type"]), json.loads(req["data_json"].decode()))
        try:
            await self.controller.replicate_and_wait(cmd)
            return self._reply(_OK)
        except NotControllerError:
            return self._reply(_NOT_LEADER)
        except Exception as e:
            logger.exception("replicate_command failed")
            return self._reply(_ERROR, str(e))

    async def topic_op(self, req: dict) -> dict:
        """Leader-side topic mutation (create/delete/add_partitions)."""
        data = json.loads(req["data_json"].decode())
        try:
            await apply_topic_op(self.controller, req["op"], data)
            return self._reply(_OK)
        except NotControllerError:
            return self._reply(_NOT_LEADER)
        except TopicExistsError as e:
            return self._reply(_EXISTS, str(e))
        except ClusterError as e:
            return self._reply(_ERROR, str(e))
        except Exception as e:
            logger.exception("topic_op failed")
            return self._reply(_ERROR, str(e))

    async def join_node(self, req: dict) -> dict:
        from redpanda_tpu_torch.cluster import commands as cmds

        cmd = cmds.register_node_cmd(
            req["node_id"], req["host"], req["port"],
            req["kafka_host"], req["kafka_port"],
            admin_port=req.get("admin_port", 0),
        )
        try:
            if self.dispatcher is not None:
                await self.dispatcher.replicate(cmd)
            else:
                await self.controller.replicate_and_wait(cmd)
            return self._reply(_OK)
        except NotControllerError:
            return self._reply(_NOT_LEADER)
        except Exception as e:
            logger.exception("join_node failed")
            return self._reply(_ERROR, str(e))


class ControllerDispatcher:
    """Run a controller mutation from ANY broker: try locally, forward to
    the leader otherwise (topics_frontend redirect semantics)."""

    def __init__(self, controller: Controller, connection_cache: rpc.ConnectionCache) -> None:
        self.controller = controller
        self.connections = connection_cache

    async def replicate(self, cmd: Command, *, retries: int = 3, timeout: float = 10.0) -> None:
        last = "no controller leader"
        for _ in range(retries):
            if self.controller.is_leader():
                try:
                    await self.controller.replicate_and_wait(cmd, timeout)
                    return
                except NotControllerError:
                    pass  # lost leadership mid-call; fall through to forward
            leader = self.controller.leader_id
            if leader is None or leader == self.controller.self_node.id:
                import asyncio

                await asyncio.sleep(0.2)
                continue
            # serialization is deterministic: do it OUTSIDE the retry guard
            # so a bad command surfaces immediately with its real traceback
            payload = {"type": int(cmd.type), "data_json": json.dumps(cmd.data).encode()}
            try:
                client = rpc.Client(cluster_service, self.connections.get(leader))
                reply = await client.replicate_command(payload, timeout=timeout)
            except Exception as e:
                # Leader died mid-RPC: re-resolve after the election — the
                # path startup registration rides through a SIGKILL/restart
                # (retries=300 must actually outwait it). A reply lost
                # after commit means the retry re-appends the command;
                # controller commands are apply-idempotent (registrations
                # and topic ops re-apply as no-ops/exists).
                last = f"{type(e).__name__}: {e}"
                logger.debug("controller forward to %s failed", leader, exc_info=True)
                import asyncio

                await asyncio.sleep(0.2)
                continue
            if reply["errc"] == _OK:
                return
            last = reply["message"] or f"errc={reply['errc']}"
        raise ClusterError(f"controller mutation failed: {last}", retriable=True)

    async def topic_op(
        self, op: int, data: dict, *, retries: int = 25, timeout: float = 10.0
    ) -> None:
        """Create/delete/add_partitions on the controller leader, from any
        broker. Leader-side because allocation + group-id assignment live
        there. Only LEADERLESS states retry (elections in flight — a real
        cluster spends seconds leaderless after a kill); permanent errors
        (exists, allocation impossible) surface immediately and identically
        from both the local-leader and the forwarded path.

        Raises ValueError for already-exists (the single-node
        topic_table.add_topic contract every idempotent caller handles).
        """
        import asyncio

        last = "no controller leader"
        for _ in range(retries):
            if self.controller.is_leader():
                try:
                    await apply_topic_op(self.controller, op, data)
                    return
                except NotControllerError:
                    pass  # lost leadership mid-call; fall through to forward
                except TopicExistsError as e:
                    raise ValueError(str(e)) from e
            leader = self.controller.leader_id
            if leader is None or leader == self.controller.self_node.id:
                await asyncio.sleep(0.2)
                continue
            try:
                client = rpc.Client(cluster_service, self.connections.get(leader))
                reply = await client.topic_op(
                    {"op": op, "data_json": json.dumps(data).encode()},
                    timeout=timeout,
                )
            except Exception as e:  # leader just died: retry after re-election
                last = str(e)
                await asyncio.sleep(0.2)
                continue
            if reply["errc"] == _OK:
                return
            last = reply["message"] or f"errc={reply['errc']}"
            if reply["errc"] == _EXISTS:
                raise ValueError(last)
            if reply["errc"] == _ERROR:
                raise ClusterError(last)  # permanent: no retry
            await asyncio.sleep(0.2)  # _NOT_LEADER: election in flight
        raise ClusterError(f"topic op failed: {last}", retriable=True)


async def join_cluster(
    broker: Broker,
    seed_addr: tuple[str, int],
    connections: rpc.ConnectionCache,
    *,
    seed_node_hint: int = 0,
    timeout: float = 10.0,
) -> None:
    """Client side of node join: a fresh broker announces itself to a seed
    broker, which forwards to the controller leader if needed."""
    import asyncio

    connections.register(seed_node_hint, *seed_addr)
    client = rpc.Client(cluster_service, connections.get(seed_node_hint))
    deadline = asyncio.get_running_loop().time() + timeout
    while True:
        reply = await client.join_node(
            {
                "node_id": broker.node_id,
                "host": broker.host,
                "port": broker.port,
                "kafka_host": broker.kafka_host,
                "kafka_port": broker.kafka_port,
                "admin_port": broker.admin_port,
            },
            timeout=5.0,
        )
        if reply["errc"] == _OK:
            return
        if asyncio.get_running_loop().time() > deadline:
            raise ClusterError(f"join failed: {reply['message']}")
        await asyncio.sleep(0.3)
