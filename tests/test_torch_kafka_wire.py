"""The port's Kafka wire codec (redpanda_tpu_torch/kafka/protocol) against
the JAX package's: every golden frame of tests/test_wire_golden.py, every
API at every version on seeded request and response bodies, and the record
batch adapter and legacy up-conversion on seeded batches.

``PortTwin`` also serves tests/test_torch_kafka.py and
tests/test_torch_kafka_quotas.py: it runs a reference test module's own
test functions with every name they take from the JAX package replaced by
the port's.
"""

from __future__ import annotations

import ast
import functools
import importlib
import inspect
import sys
import types

import numpy as np
import pytest

import test_wire_golden as golden
from redpanda_tpu.kafka.protocol import batch as jbatch
from redpanda_tpu.kafka.protocol import legacy as jlegacy
from redpanda_tpu.kafka.protocol import messages as jm
from redpanda_tpu.kafka.protocol import schema as jschema
from redpanda_tpu.models.record import Compression as JCompression
from redpanda_tpu.models.record import Record as JRecord
from redpanda_tpu.models.record import RecordBatch as JRecordBatch
from redpanda_tpu.models.record import RecordHeader as JRecordHeader
from redpanda_tpu_torch.kafka.protocol import batch as pbatch
from redpanda_tpu_torch.kafka.protocol import legacy as plegacy
from redpanda_tpu_torch.kafka.protocol import messages as pm
from redpanda_tpu_torch.kafka.protocol import schema as pschema
from redpanda_tpu_torch.kafka.protocol.schema import Array, T

REF = "redpanda_tpu."
PORT = "redpanda_tpu_torch."


# ------------------------------------------------------------ port twins
def port_module(name: str) -> types.ModuleType:
    """The port's counterpart of the JAX package's module ``name``."""
    return importlib.import_module(PORT + name[len(REF):])


def _port_value(name: str, value):
    if isinstance(value, types.ModuleType):
        return port_module(value.__name__) if value.__name__.startswith(REF) else value
    src = getattr(value, "__module__", None)
    if isinstance(src, str) and src.startswith(REF):
        return getattr(port_module(src), getattr(value, "__name__", name))
    return value


class PortTwin:
    """A reference test module's functions rebound to globals in which every
    name imported from the JAX package is the port's (``overrides`` last:
    e.g. the port's ``Broker`` on the CPU). ``run(name, monkeypatch,
    **fixtures)`` calls
    one test with the module names of its function-level imports (JAX
    package modules and the sibling test modules in ``siblings``) pointed
    at the port's for the duration."""

    def __init__(self, mod, overrides: dict | None = None, siblings: dict | None = None):
        self.mod = mod
        g = {n: _port_value(n, v) for n, v in vars(mod).items()}
        g.update(overrides or {})
        for n, v in vars(mod).items():
            if isinstance(v, types.FunctionType) and v.__module__ == mod.__name__:
                f = types.FunctionType(v.__code__, g, v.__name__, v.__defaults__, v.__closure__)
                f.__kwdefaults__ = v.__kwdefaults__
                g[n] = f
        self.globals = g
        self.siblings = siblings or {}
        with open(mod.__file__) as fh:
            tree = ast.parse(fh.read())
        self.local_imports = sorted({
            node.module for node in ast.walk(tree)
            if isinstance(node, ast.ImportFrom) and node.module
            and (node.module.startswith(REF) or node.module in self.siblings)
        })

    def namespace(self) -> types.ModuleType:
        ns = types.ModuleType(self.mod.__name__ + "_port")
        vars(ns).update(self.globals)
        return ns

    def tests(self) -> list[tuple[str, dict]]:
        """(name, parameters) of every test function, parametrize marks
        expanded."""
        out = []
        for n, v in vars(self.mod).items():
            if not (n.startswith("test_") and isinstance(v, types.FunctionType)):
                continue
            cases = [{}]
            for mark in getattr(v, "pytestmark", []):
                if mark.name == "parametrize":
                    names, values = mark.args[0], mark.args[1]
                    names = [s.strip() for s in names.split(",")] if isinstance(names, str) else list(names)
                    cases = [
                        {**c, **dict(zip(names, val if len(names) > 1 else (val,)))}
                        for c in cases for val in values
                    ]
            out += [(n, c) for c in cases]
        return out

    def run(self, name: str, monkeypatch, **fixtures):
        for mod_name in self.local_imports:
            target = self.siblings.get(mod_name)
            monkeypatch.setitem(
                sys.modules, mod_name,
                target.namespace() if target is not None else port_module(mod_name),
            )
        fn = self.globals[name]
        wanted = inspect.signature(fn).parameters
        return fn(**{k: v for k, v in fixtures.items() if k in wanted})


def _twin_id(case) -> str:
    name, params = case
    return name + "".join(f"[{k}={v}]" for k, v in params.items())


def port_broker():
    from redpanda_tpu_torch.kafka.server.broker import Broker

    return functools.partial(Broker, device="cpu")


import test_kafka  # noqa: E402  (the golden e2e case imports its broker helpers)

KAFKA_TWIN = PortTwin(test_kafka, {"Broker": port_broker()})
GOLDEN_TWIN = PortTwin(golden, siblings={"test_kafka": KAFKA_TWIN})


@pytest.fixture(autouse=True)
def _crc_default():
    from redpanda_tpu_torch.ops import crc_backend

    crc_backend.install_default_backend(None)
    yield
    crc_backend.install_default_backend(None)


@pytest.mark.parametrize("case", GOLDEN_TWIN.tests(), ids=_twin_id)
def test_golden_frames_through_the_port(case, monkeypatch, tmp_path):
    """Every case of test_wire_golden.py, run on the port's codec (and, for
    the legacy produce case, on the port's server and client)."""
    name, params = case
    GOLDEN_TWIN.run(name, monkeypatch, tmp_path=tmp_path, **params)


def test_golden_twin_covers_the_reference_module():
    assert len(GOLDEN_TWIN.tests()) == 25
    assert "redpanda_tpu.kafka.protocol.legacy" in GOLDEN_TWIN.local_imports
    assert "test_kafka" in GOLDEN_TWIN.local_imports  # the legacy produce case's server
    assert GOLDEN_TWIN.globals["encode_message"] is pschema.encode_message
    assert GOLDEN_TWIN.globals["m"] is pm


# ------------------------------------------------------------ every api, every version
def _shape(fields) -> list:
    def typ(t):
        if type(t).__name__ == "Array":
            inner = _shape(t.inner) if isinstance(t.inner, tuple) else t.inner
            return ("array", inner, t.nullable)
        return t

    return [(f.name, typ(f.typ), f.versions, f.default, f.tag) for f in fields]


_INT_RANGES = {
    T.INT8: (-(1 << 7), 1 << 7), T.INT16: (-(1 << 15), 1 << 15),
    T.INT32: (-(1 << 31), 1 << 31), T.INT64: (-(1 << 63), 1 << 63),
    T.UINT32: (0, 1 << 32), T.VARINT: (-(1 << 31), 1 << 31),
}
_CHARS = list("abcxyz._-09Zé✓")


def _draw_scalar(rng, typ):
    if typ in _INT_RANGES:
        lo, hi = _INT_RANGES[typ]
        return int(rng.integers(lo, hi - 1, dtype=np.int64))
    if typ == T.FLOAT64:
        return float(rng.normal() * 10.0 ** int(rng.integers(-3, 9)))
    if typ == T.BOOL:
        return bool(rng.integers(0, 2))
    if typ == T.UUID:
        return rng.bytes(16)
    if typ in (T.STRING, T.NULLABLE_STRING):
        if typ == T.NULLABLE_STRING and rng.random() < 0.25:
            return None
        return "".join(rng.choice(_CHARS, size=int(rng.integers(0, 12))))
    if typ in (T.BYTES, T.NULLABLE_BYTES, T.RECORDS):
        if typ != T.BYTES and rng.random() < 0.25:
            return None
        return rng.bytes(int(rng.integers(0, 40)))
    raise AssertionError(f"unhandled type {typ}")


def _draw(rng, typ, v: int, flexible: bool, depth: int):
    if isinstance(typ, Array):
        if typ.nullable and rng.random() < 0.2:
            return None
        n = int(rng.integers(0, 4 if depth < 2 else 2))
        if isinstance(typ.inner, tuple):
            return [_draw_struct(rng, typ.inner, v, flexible, depth + 1) for _ in range(n)]
        return [_draw_scalar(rng, typ.inner) for _ in range(n)]
    return _draw_scalar(rng, typ)


def _draw_struct(rng, fields, v: int, flexible: bool, depth: int = 0) -> dict:
    msg = {}
    for f in fields:
        if not f.present(v):
            continue
        if f.tag is not None and flexible and rng.random() < 0.5:
            continue  # an absent tagged field
        msg[f.name] = _draw(rng, f.typ, v, flexible, depth)
    return msg


_VERSIONS = [(k, v) for k in sorted(pm.APIS) for v in range(pm.APIS[k].min_version, pm.APIS[k].max_version + 1)]


def test_api_tables_match_reference():
    assert sorted(pm.APIS) == sorted(jm.APIS)
    for k, api in pm.APIS.items():
        ref = jm.APIS[k]
        assert (api.name, api.min_version, api.max_version, api.flexible_since) == (
            ref.name, ref.min_version, ref.max_version, ref.flexible_since)
        assert _shape(api.request) == _shape(ref.request)
        assert _shape(api.response) == _shape(ref.response)


@pytest.mark.parametrize("key,version", _VERSIONS, ids=[f"{pm.APIS[k].name}-v{v}" for k, v in _VERSIONS])
def test_every_api_version_encodes_and_decodes_like_reference(key, version):
    rng = np.random.default_rng(1000 * key + version)
    papi, japi = pm.APIS[key], jm.APIS[key]
    flexible = papi.is_flexible(version)
    for which in ("request", "response"):
        fields = papi.request if which == "request" else papi.response
        for _ in range(6):
            msg = _draw_struct(rng, fields, version, flexible)
            mine = pschema.encode_message(papi, which, msg, version)
            ref = jschema.encode_message(japi, which, msg, version)
            assert mine == ref, f"{papi.name} v{version} {which}"
            back = jschema.decode_message(japi, which, mine, version)
            assert pschema.decode_message(papi, which, ref, version) == back
            assert pschema.decode_message(papi, which, mine, version) == back
    # the request header, both forms
    for flex in (False, True):
        h = pschema.RequestHeader(key, version, int(rng.integers(0, 1 << 31)), "cli-é")
        jh = jschema.RequestHeader(key, version, h.correlation_id, "cli-é")
        assert h.encode(flex) == jh.encode(flex)
        assert pschema.encode_response_header(h.correlation_id, flex) == \
            jschema.encode_response_header(h.correlation_id, flex)


# ------------------------------------------------------------ batches and legacy
def _seeded_batches(seed: int, n: int = 6) -> list[bytes]:
    """Internal-format bytes of ``n`` seeded batches (keys, nulls, headers,
    timestamps, producer ids, a gzip batch), built by the JAX package."""
    rng = np.random.default_rng(seed)
    out, base = [], 0
    for i in range(n):
        recs = []
        for j in range(int(rng.integers(1, 9))):
            key = None if rng.random() < 0.3 else rng.bytes(int(rng.integers(0, 12)))
            value = None if rng.random() < 0.1 else rng.bytes(int(rng.integers(0, 300)))
            headers = tuple(JRecordHeader(b"h%d" % q, rng.bytes(int(rng.integers(0, 6))))
                            for q in range(int(rng.integers(0, 3))))
            recs.append(JRecord(offset_delta=j, timestamp_delta=int(rng.integers(0, 50)),
                                key=key, value=value, headers=headers))
        b = JRecordBatch.build(
            recs, base_offset=base, first_timestamp=int(rng.integers(0, 1 << 40)),
            producer_id=7 + i if i % 3 == 2 else -1, producer_epoch=1 if i % 3 == 2 else -1,
            base_sequence=3 if i % 3 == 2 else -1,
            compression=JCompression.gzip if i == 4 else JCompression.none,
        )
        out.append(b.encode_internal())
        base += len(recs)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_wire_batches_match_reference(seed):
    from redpanda_tpu_torch.models.record import RecordBatch as PRecordBatch

    internal = _seeded_batches(seed)
    jb = [JRecordBatch.decode_internal(x)[0] for x in internal]
    pb = [PRecordBatch.decode_internal(x)[0] for x in internal]
    wire = jbatch.encode_wire_batches(jb)
    assert pbatch.encode_wire_batches(pb) == wire
    for verify in (True, False):
        mine = pbatch.decode_wire_batches(wire, verify_crc=verify)
        ref = jbatch.decode_wire_batches(wire, verify_crc=verify)
        assert [(a.v2_format, a.valid_crc, a.batch.encode_internal()) for a in mine] == \
            [(a.v2_format, a.valid_crc, a.batch.encode_internal()) for a in ref]
    # one flipped record byte in the second batch: both see a bad CRC there
    bad = bytearray(wire)
    second = len(jbatch.encode_wire_batch(jb[0]))
    bad[second + pbatch.WIRE_HEADER_SIZE + 2] ^= 0x40
    mine = pbatch.decode_wire_batches(bytes(bad), verify_crc=True)
    ref = jbatch.decode_wire_batches(bytes(bad), verify_crc=True)
    assert [a.valid_crc for a in mine] == [a.valid_crc for a in ref]
    assert [a.valid_crc for a in mine][:2] == [True, False]
    assert [a.batch.encode_internal() for a in mine] == [a.batch.encode_internal() for a in ref]
    # a truncated blob: the same EOFError in both
    with pytest.raises(EOFError):
        jbatch.decode_wire_batches(wire[:-3])
    with pytest.raises(EOFError):
        pbatch.decode_wire_batches(wire[:-3])


def _legacy_sets(seed: int) -> list[bytes]:
    rng = np.random.default_rng(seed)
    out = []
    for magic in (0, 1):
        ms, off = b"", 0
        for _ in range(int(rng.integers(1, 6))):
            key = None if rng.random() < 0.3 else rng.bytes(int(rng.integers(0, 10)))
            ms += golden.legacy_message(magic, key, rng.bytes(int(rng.integers(0, 200))),
                                        timestamp=int(rng.integers(0, 1 << 40)), offset=off)
            off += 1
        out.append(ms)
    inner = golden.legacy_message(1, b"a", rng.bytes(30), timestamp=5) + \
        golden.legacy_message(1, None, rng.bytes(9), timestamp=6)
    import gzip

    out.append(golden.legacy_message(1, None, gzip.compress(inner, mtime=0), timestamp=7, attributes=1))
    out.append(golden.legacy_message(0, b"k", b"v", corrupt_crc=True))  # corrupt
    out.append(golden.legacy_message(0, None, b"\x00" * 8, attributes=3))  # lz4 + magic 0
    out.append(b"\x00" * 13)  # truncated
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_legacy_upconversion_matches_reference(seed):
    for ms in _legacy_sets(seed):
        def outcome(mod):
            try:
                return ("ok", mod.convert_message_set(ms).encode_internal())
            except (mod.LegacyBatchError, mod.LegacyUnsupportedError) as e:
                return (type(e).__name__, str(e))

        assert outcome(plegacy) == outcome(jlegacy)
