"""Data policies: a TransformSpec bound to a topic, applied on the fetch path
as a read-side view (the JAX package's policy/).

Two evaluators with the same semantics: the device leg packs the fetched
records into one staging buffer and runs the packed payload kernel (K4) over
it; the host leg is a plain Python evaluator of the same DSL, bit-exact with
the kernel's byte semantics. A fetch of fewer than ``min_records_for_device``
records takes the host leg. Surviving records keep their original offset
deltas, timestamps and keys; dropped records become offset gaps, as
compaction leaves them. ``DataPolicyTable`` is the replicated table of
policies, fed by the controller's commands.
"""

from redpanda_tpu_torch.policy.engine import PolicyEngine, evaluate_record
from redpanda_tpu_torch.policy.table import DataPolicy, DataPolicyTable

__all__ = ["DataPolicy", "DataPolicyTable", "PolicyEngine", "evaluate_record"]
