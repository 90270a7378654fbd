"""The port's data-policy engine (redpanda_tpu_torch.policy) against the JAX
package's.

The host evaluator and the device leg (the packed payload kernel's plain
version on the CPU) must give the reference's records for every spec of
tests/test_policy.py on its random documents, and the view batches the
reference builds, byte for byte. A fetch under ``min_records_for_device``
takes the host leg; a failing device leg raises. The replicated table of
policies applies the controller's commands as the JAX package's does, and a
policy created through the port's controller reaches every node's table.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from redpanda_tpu.models.record import Compression, Record, RecordBatch
from redpanda_tpu.ops.transforms import (
    Int,
    Str,
    filter_contains,
    filter_field_eq,
    identity,
    map_project,
    map_uppercase,
)
from redpanda_tpu.policy import PolicyEngine as RefPolicyEngine
from redpanda_tpu.policy import evaluate_record as ref_evaluate_record
from redpanda_tpu_torch import interop
from redpanda_tpu_torch.policy import PolicyEngine, evaluate_record
from redpanda_tpu_torch.policy import engine as policy_engine
from test_policy import _random_docs

ROW_STRIDE = 256
SPECS = [
    identity(),
    filter_field_eq("level", "error"),
    filter_field_eq("code", 42),
    filter_contains(b"err", negate=True),
    map_uppercase(),
    filter_field_eq("level", "error") | map_project(Int("code"), Str("msg", 16)),
    map_project(Int("code")),
    map_project(Str("level", 8), Str("msg", 8)),
]


def _batches(seed: int = 11):
    """The random documents of test_policy.py in batches of 10, one of them
    zstd-compressed, plus a value wider than the staging row."""
    docs = [d for d in _random_docs(seed=seed) if d]
    docs[17] = b'{"level":"error","code":7,"msg":"' + b"w" * ROW_STRIDE + b'"}'
    return [
        RecordBatch.build(
            [Record(offset_delta=i, timestamp_delta=i, value=v)
             for i, v in enumerate(docs[k : k + 10])],
            base_offset=k, compression=Compression.zstd if k == 20 else Compression.none,
        )
        for k in range(0, len(docs) - 10, 10)
    ]


def _port(batches):
    return [interop.batch_from_wire(b.encode_internal()) for b in batches]


@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_host_evaluator_matches_reference(spec):
    port_spec = interop.spec_from_json(spec.to_json())
    for doc in _random_docs():
        assert evaluate_record(port_spec, doc) == ref_evaluate_record(spec, doc), doc


@pytest.mark.parametrize("leg", ["host", "device"])
@pytest.mark.parametrize("spec", SPECS, ids=lambda s: s.name)
def test_policy_legs_match_reference(spec, leg):
    batches = _batches()
    ref = RefPolicyEngine(row_stride=ROW_STRIDE, force_engine=leg)
    want = [b.encode_internal() for b in ref.transform_batches(spec.to_json(), batches)]
    eng = PolicyEngine(row_stride=ROW_STRIDE, force_engine=leg, device="cpu")
    got = [b.encode_internal() for b in eng.transform_batches(spec.to_json(), _port(batches))]
    assert got == want


def test_device_leg_equals_host_evaluator_on_rows_that_fit():
    """The two legs of the port agree record for record where every value
    fits the staging row (a wider value is dropped by the device leg only,
    as in the reference)."""
    docs = [d for d in _random_docs(seed=3) if 0 < len(d) <= ROW_STRIDE]
    batches = [RecordBatch.build([Record(offset_delta=i, value=v) for i, v in enumerate(docs)])]
    for spec in SPECS:
        legs = [
            [b.encode_internal() for b in PolicyEngine(
                row_stride=ROW_STRIDE, force_engine=leg, device="cpu").transform_batches(
                    spec.to_json(), _port(batches))]
            for leg in ("host", "device")
        ]
        assert legs[0] == legs[1], spec.name


def test_adaptive_leg_and_empty_fetch(monkeypatch):
    spec = filter_field_eq("level", "error").to_json()
    legs = []
    monkeypatch.setattr(PolicyEngine, "_run_host", lambda self, s, b: legs.append("host") or b)
    monkeypatch.setattr(PolicyEngine, "_run_device",
                        lambda self, j, s, b: legs.append("device") or b)
    eng = PolicyEngine(device="cpu", min_records_for_device=40)
    batches = _port(_batches())
    eng.transform_batches(spec, batches[:3])  # 30 records: under the threshold
    eng.transform_batches(spec, batches[:4])  # 40
    assert legs == ["host", "device"]
    assert eng.transform_batches(spec, []) == []
    with pytest.raises(ValueError):
        PolicyEngine(device="cpu", force_engine="gpu")


def test_failing_device_leg_raises(monkeypatch):
    """No exception on the device leg gives way to the host leg."""
    def broken(spec, r_in):
        def fn(staged):
            raise RuntimeError("payload kernel launch failed")
        return fn, 8

    monkeypatch.setattr(policy_engine, "make_packed_pipeline", broken)
    eng = PolicyEngine(device="cpu", force_engine="device")
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.transform_batches(filter_field_eq("level", "error").to_json(), _port(_batches()))


def test_default_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default engine runs on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PolicyEngine()


def test_surviving_records_keep_their_offsets():
    spec = filter_field_eq("level", "error").to_json()
    batches = _port(_batches())
    out = PolicyEngine(device="cpu", force_engine="device").transform_batches(spec, batches)
    by_base = {b.header.base_offset: b for b in batches}
    for b in out:
        src = {r.offset_delta: r for r in by_base[b.header.base_offset].records()}
        for r in b.records():
            assert src[r.offset_delta] == r
    assert np.sum([b.header.record_count for b in out]) > 0


# ------------------------------------------------------------------ the replicated table
def _policy_view(table) -> tuple:
    return table.version, {t: (p.topic, p.name, p.spec_json) for t, p in table.policies().items()}


def test_policy_table_apply_commands():
    """tests/test_policy.py's table test on the port's ``DataPolicyTable``,
    its state after each command equal to the JAX package's table fed the
    JAX package's commands."""
    import asyncio

    from redpanda_tpu.cluster import commands as ref_cmds
    from redpanda_tpu.policy import DataPolicyTable as RefDataPolicyTable
    from redpanda_tpu_torch.cluster import commands as cmds
    from redpanda_tpu_torch.policy import DataPolicyTable

    async def main():
        t, ref = DataPolicyTable(), RefDataPolicyTable()
        spec = filter_field_eq("level", "error").to_json()
        await t.apply_command(cmds.create_data_policy_cmd("orders", "errors-only", spec))
        await ref.apply_command(ref_cmds.create_data_policy_cmd("orders", "errors-only", spec))
        assert t.get("orders").name == "errors-only"
        assert _policy_view(t) == _policy_view(ref)
        # malformed spec is rejected at apply time, by both
        with pytest.raises(Exception):
            await t.apply_command(cmds.create_data_policy_cmd("x", "bad", "{not json"))
        with pytest.raises(Exception):
            await ref.apply_command(ref_cmds.create_data_policy_cmd("x", "bad", "{not json"))
        assert _policy_view(t) == _policy_view(ref)
        with pytest.raises(ValueError):
            await t.apply_command(cmds.delete_topic_cmd("kafka", "orders"))
        await t.apply_command(cmds.delete_data_policy_cmd("orders"))
        await ref.apply_command(ref_cmds.delete_data_policy_cmd("orders"))
        assert t.get("orders") is None
        assert _policy_view(t) == _policy_view(ref)

    asyncio.run(main())


def test_policy_replicates_through_controller(tmp_path):
    """A create_data_policy command through the port's controller reaches a
    ``DataPolicyTable`` attached to every node's controller."""
    from redpanda_tpu_torch.cluster.commands import create_data_policy_cmd
    from redpanda_tpu_torch.policy import DataPolicyTable
    from test_torch_controller import ClusterFixture, run

    async def main():
        fx = await ClusterFixture(tmp_path, 3).start()
        try:
            spec = filter_field_eq("level", "error")
            tables = [DataPolicyTable().attach(n.controller) for n in fx.nodes]
            await fx.controller_leader().dispatcher.replicate(
                create_data_policy_cmd("orders", "errs", spec.to_json())
            )
            await fx.wait_converged(
                lambda n: tables[n.node_id].get("orders") is not None,
                msg="policy replicated",
            )
            assert all(t.get("orders").name == "errs" for t in tables)
            assert all(t.get("orders").spec_json == spec.to_json() for t in tables)
        finally:
            await fx.stop()

    run(main())
