"""The port's mask-harvest thread against the JAX package, and the launch
counter it relies on.

On a card the harvest thread waits on each predicate launch's copy down and
publishes its keep bits; here, on the CPU, the engine is told to hand its
masks over all the same (``_harvest_async``), so the thread, the claim
protocol and the failure path run on the plain versions. Replies are held
to the reference engine's inline lane on test_harvest_gather's and
test_structural_parse's seeded requests, with no tolerance. A failed
harvest must end in the script's error policy: no host evaluation takes the
card's place, now or on a retry.
"""

from __future__ import annotations

import sys
import threading

import pytest

from redpanda_tpu_torch import kernels
from redpanda_tpu_torch.coproc import engine as engine_mod
from redpanda_tpu_torch.coproc.engine import ErrorPolicy, TorchEngine, _Pending
from test_harvest_gather import _matrix_request
from test_structural_parse import PASS_SPEC, PROJ_SPEC
from test_torch_structural import _port_request, _ref_replies, _reply_bytes

ROW_STRIDE = 512
LANES = {
    "inline": dict(host_workers=0),
    "pool": dict(host_workers=2, host_pool_probe=False),
}


@pytest.fixture
def harvested(monkeypatch):
    """Masks go to the harvest thread on the CPU too; the shard gate is
    lowered so that the pool lane's launches fan out."""
    monkeypatch.setattr(TorchEngine, "_harvest_async", lambda self: True)
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)


def _engine(lane, **kw):
    return TorchEngine(device="cpu", row_stride=ROW_STRIDE, **LANES[lane], **kw)


@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("spec", [PROJ_SPEC, PASS_SPEC], ids=["proj", "pass"])
def test_harvest_thread_serves_every_mask(spec, lane, harvested):
    reqs = [_matrix_request(), _matrix_request(n_items=3)]
    want = _ref_replies(spec.to_json(), reqs)
    eng = _engine(lane)
    try:
        eng.enable_coprocessors([(1, spec.to_json(), ("bench",))])
        tickets = eng.submit_group([_port_request(r) for r in reqs])
        assert eng._harvester.is_alive() and eng._harvester.name == "rptorch-mask-harvester"
        got = [_reply_bytes(t.result()) for t in tickets]
        st = eng.stats()
    finally:
        eng.shutdown()
    assert got == want
    assert st["t_harvest_wait"] > 0 and st["n_kernel_predicate"] == (2 if lane == "pool" else 1)
    assert not any(k.startswith("n_failures") for k in st)


@pytest.mark.parametrize("policy", ["skip_on_failure", "deregister"])
@pytest.mark.parametrize("thread", [True, False], ids=["harvest_thread", "caller"])
@pytest.mark.parametrize("lane", sorted(LANES))
def test_failed_harvest_raises_into_the_error_policy(lane, thread, policy, monkeypatch):
    """The copy down fails: the exception stays on the mask and Ticket.result
    raises it into the script's policy, on every retry; no record is kept
    for want of its bits."""
    monkeypatch.setattr(engine_mod, "_SHARD_MIN_ROWS", 32)
    monkeypatch.setattr(TorchEngine, "_harvest_async", lambda self: thread)

    def failing(self, engine):
        raise RuntimeError("copy down failed: CUDA error 700")

    monkeypatch.setattr(_Pending, "wait", failing)
    eng = _engine(lane)
    try:
        eng.enable_coprocessors([(1, PROJ_SPEC.to_json(), ("bench",), ErrorPolicy[policy])])
        ticket = eng.submit(_port_request(_matrix_request()))
        reply = ticket.result()
        st = eng.stats()
        if policy == "deregister":
            assert reply.deregistered == [1] and eng.heartbeat() == 0
            assert reply.items == []
        else:
            assert reply.items and all(not it.batches for it in reply.items)
            again = ticket.result()  # a retry finds the failure, not "keep all"
            assert all(not it.batches for it in again.items)
            assert eng.stats()["n_failures_rebuild"] == 2
        assert st["n_failures_harvest"] >= 1 and st["n_failures_rebuild"] == 1
    finally:
        eng.shutdown()


def test_a_queued_mask_is_claimed_by_its_caller(monkeypatch):
    """With the harvest thread stuck elsewhere, a caller that waited
    _HARVEST_WAIT_S takes its still-queued mask and fetches it itself; the
    thread then skips it."""
    monkeypatch.setattr(TorchEngine, "_harvest_async", lambda self: True)
    monkeypatch.setattr(engine_mod, "_HARVEST_WAIT_S", 0.01)
    gate = threading.Event()
    real_loop = TorchEngine._harvest_loop

    def stalled_loop(self):
        gate.wait()
        real_loop(self)

    monkeypatch.setattr(TorchEngine, "_harvest_loop", stalled_loop)
    req = _matrix_request()
    eng = _engine("inline")
    try:
        eng.enable_coprocessors([(1, PASS_SPEC.to_json(), ("bench",))])
        ticket = eng.submit(_port_request(req))
        got = _reply_bytes(ticket.result())
        gate.set()
        eng.shutdown()  # the thread drains the queue, skipping the claimed mask
        st = eng.stats()
    finally:
        gate.set()
        eng.shutdown()
    assert got == _ref_replies(PASS_SPEC.to_json(), [req])[0]
    assert "t_harvest_wait" not in st and st["t_fetch"] > 0


class _Count(int):
    """An int whose addition runs Python code, so that a thread switch can
    fall between the counter's read and its write (CPython's own int
    addition leaves no such window to test)."""

    def __add__(self, other):
        return _Count(int(self) + other)


def test_launch_counts_are_exact_from_four_threads():
    """Pool workers launch K1 from several threads: no launch is lost."""
    k = kernels.Kernel("counter", "redpanda_tpu_torch/csrc/predicate.cu", "-", "rp_none", [])
    k._fn = lambda *args: 0  # a launch that always succeeds
    k.launches = _Count(0)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        threads = [threading.Thread(target=lambda: [k.launch() for _ in range(20_000)])
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads)
    assert k.launches == 4 * 20_000
