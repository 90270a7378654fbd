"""The port's client quotas, incremental fetch sessions, request-memory
gate and queue-depth control (redpanda_tpu_torch/kafka/server
quota_manager.py, fetch_session_cache.py, qdc.py, protocol.py): every test
of tests/test_quotas_sessions.py and tests/test_qdc.py, run with the
port's names in place of the JAX package's."""

from __future__ import annotations

import sys

import pytest

import test_qdc
import test_quotas_sessions
from test_torch_kafka_wire import PortTwin, _crc_default, _twin_id, port_broker  # noqa: F401
from redpanda_tpu_torch.kafka.server import quota_manager
from redpanda_tpu_torch.kafka.server.qdc import QdcMonitor

QUOTAS_TWIN = PortTwin(test_quotas_sessions, {"Broker": port_broker()})
QDC_TWIN = PortTwin(test_qdc, {"Broker": port_broker()})


@pytest.mark.parametrize("case", QUOTAS_TWIN.tests(), ids=_twin_id)
def test_reference_quota_and_session_suite_on_the_port(case, monkeypatch, tmp_path):
    name, params = case
    QUOTAS_TWIN.run(name, monkeypatch, tmp_path=tmp_path, **params)


@pytest.mark.parametrize("case", QDC_TWIN.tests(), ids=_twin_id)
def test_reference_qdc_suite_on_the_port(case, monkeypatch, tmp_path):
    name, params = case
    QDC_TWIN.run(name, monkeypatch, tmp_path=tmp_path, **params)


def test_twins_cover_the_reference_modules(monkeypatch):
    """The twins run every reference test, and a function-level import of
    the JAX package's module inside one gets the port's."""
    assert len(QUOTAS_TWIN.tests()) == 7 and len(QDC_TWIN.tests()) == 5
    assert QDC_TWIN.globals["QdcMonitor"] is QdcMonitor
    QUOTAS_TWIN.run("test_quota_manager_throttles_over_rate", monkeypatch)
    assert sys.modules["redpanda_tpu.kafka.server.quota_manager"] is quota_manager
