"""The port's observability layer (the JAX package's observability/, in
part): ``probes``, the always-on histograms and counters of the coproc
engine, and ``tracer``, the opt-in span tracer."""

from redpanda_tpu_torch.observability import probes
from redpanda_tpu_torch.observability.trace import Tracer, tracer

__all__ = ["Tracer", "probes", "tracer"]
