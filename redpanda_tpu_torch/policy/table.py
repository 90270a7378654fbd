"""Replicated per-topic data-policy table (v8_engine/data_policy_table).

(The JAX package's policy/table.py, copied.)
"""

from __future__ import annotations

from dataclasses import dataclass

from redpanda_tpu_torch.cluster.commands import Command, CommandType


@dataclass
class DataPolicy:
    topic: str
    name: str
    spec_json: str


_POLICY_CMDS = [CommandType.create_data_policy, CommandType.delete_data_policy]


class DataPolicyTable:
    """topic -> DataPolicy; fed by controller command replay (clustered)
    or direct application (single-node)."""

    def __init__(self) -> None:
        self._policies: dict[str, DataPolicy] = {}
        self._version = 0

    def attach(self, controller) -> "DataPolicyTable":
        """Plug into the controller mux (data_policy_manager's seat in
        controller_stm.h)."""
        controller.register_applier(_POLICY_CMDS, self.apply_command)
        return self

    def get(self, topic: str) -> DataPolicy | None:
        return self._policies.get(topic)

    def policies(self) -> dict[str, DataPolicy]:
        return dict(self._policies)

    @property
    def version(self) -> int:
        return self._version

    async def apply_command(self, cmd: Command) -> None:
        d = cmd.data
        if cmd.type == CommandType.create_data_policy:
            # validate the spec NOW: a deterministic apply failure must be
            # identical on every node (the controller records apply errors)
            from redpanda_tpu_torch.ops.transforms import TransformSpec

            TransformSpec.from_json(d["spec"])
            self._policies[d["topic"]] = DataPolicy(d["topic"], d["name"], d["spec"])
        elif cmd.type == CommandType.delete_data_policy:
            self._policies.pop(d["topic"], None)
        else:
            raise ValueError(f"not a data-policy command: {cmd.type}")
        self._version += 1
