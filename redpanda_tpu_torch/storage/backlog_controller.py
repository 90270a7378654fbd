"""Backlog-driven compaction pacing (the JAX package's
storage/backlog_controller.py, copied).

Parity with the reference's compaction_controller/backlog_controller
(storage/backlog_controller.h, configured in application.cc:445-489): a
proportional controller samples the compaction backlog each housekeeping
tick and converts the error against a setpoint into scheduling pressure.
The reference actuates Seastar scheduling-group shares; this runtime's
actuator is the compaction cadence — idle logs are visited lazily at
`max_interval_s`, and as backlog grows past the setpoint the interval
shrinks toward `min_interval_s` so compaction keeps up with produce rate
instead of letting closed segments pile up.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class BacklogController:
    setpoint_bytes: int = 64 << 20  # backlog we tolerate before pressure
    kp: float = 2.0  # proportional gain on the backlog ratio
    min_interval_s: float = 0.5
    max_interval_s: float = 10.0
    last_backlog: int = 0
    last_interval: float = 0.0

    def update(self, backlog_bytes: int) -> float:
        """Next compaction-pass interval for the measured backlog."""
        self.last_backlog = backlog_bytes
        error = (backlog_bytes - self.setpoint_bytes) / max(self.setpoint_bytes, 1)
        if error <= 0:
            interval = self.max_interval_s
        else:
            # pressure grows with the backlog ratio; clamped to the floor
            interval = max(
                self.min_interval_s, self.max_interval_s / (1.0 + self.kp * error)
            )
        self.last_interval = interval
        return interval
