"""The port's internal RPC stack (redpanda_tpu_torch/rpc/) on the CPU,
held to the JAX package's.

Every test of tests/test_rpc.py runs here against the port: an echo
service round-trips requests over a real localhost socket, exercising the
checksums, concurrent correlation, the missing-method status, server
errors, compression, reconnect backoff and the per-method failure probes.
Then the wire crosses the packages: frames and serde bodies one package
writes are byte-equal to the other's and read by it, a port client talks
to a JAX ``Server`` and a JAX client to a port ``Server``, and the raft
service's requests and replies (append, vote, heartbeat) cross both ways.
Nothing here runs on a card.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

from redpanda_tpu_torch import rpc
from redpanda_tpu_torch.finjector import ProbeTriggered, honey_badger
from redpanda_tpu_torch.rpc import serde, wire
from redpanda_tpu_torch.rpc.transport import RpcError, Transport, TransportClosed


@pytest.fixture(autouse=True)
def _clean_badgers():
    import redpanda_tpu.finjector as ref_finjector

    yield
    for badger in (honey_badger, ref_finjector.honey_badger):
        for module, probes in badger.armed().items():
            for probe in probes:
                badger.unset(module, probe)
        badger.disable()


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


# ---------------------------------------------------------------- serde
def test_serde_scalar_roundtrip():
    s = serde.S(
        ("a", serde.I32),
        ("b", serde.I64),
        ("c", serde.STRING),
        ("d", serde.BYTES),
        ("e", serde.Vector(serde.I16)),
        ("f", serde.Optional(serde.STRING)),
        ("g", serde.Map(serde.STRING, serde.I32)),
        ("h", serde.BOOL),
    )
    msg = {
        "a": -7, "b": 1 << 40, "c": "héllo", "d": b"\x00\xff",
        "e": [1, 2, 3], "f": None, "g": {"x": 1, "y": 2}, "h": True,
    }
    assert s.decode(s.encode(msg)) == msg


def test_serde_nested_struct_and_envelope():
    inner = serde.S(("x", serde.I32), ("y", serde.STRING))
    env = serde.Envelope(serde.S(("items", serde.Vector(inner))), version=1)
    msg = {"items": [{"x": 1, "y": "a"}, {"x": 2, "y": "b"}]}
    assert env.decode(env.encode(msg)) == msg


def test_envelope_compat_rejection():
    env_v0 = serde.Envelope(serde.S(("x", serde.I32)), version=0)
    blob = serde.Envelope(serde.S(("x", serde.I32)), version=3, compat_version=2).encode({"x": 1})
    with pytest.raises(serde.SerdeError):
        env_v0.decode(blob)


# ---------------------------------------------------------------- wire
def test_header_roundtrip_and_corruption():
    h = wire.Header(compression=0, payload_size=10, meta=0xDEAD, correlation_id=7, payload_checksum=123)
    raw = bytearray(h.encode())
    assert wire.Header.decode(bytes(raw)).meta == 0xDEAD
    raw[10] ^= 0xFF  # corrupt a post-checksum byte
    with pytest.raises(wire.WireError):
        wire.Header.decode(bytes(raw))


def test_frame_compression_roundtrip():
    from redpanda_tpu_torch.compression import is_available
    from redpanda_tpu_torch.models.record import Compression

    if not is_available(Compression.zstd):
        pytest.skip("rpc wire compression is zstd by protocol; zstandard not installed")
    payload = b"z" * 4096
    framed = wire.frame(payload, meta=1, correlation_id=2, compress=True)
    h = wire.Header.decode(framed[: wire.HEADER_SIZE])
    assert h.compression == wire.COMPRESSION_ZSTD
    assert h.payload_size < len(payload)
    assert wire.open_payload(h, framed[wire.HEADER_SIZE :]) == payload


# ---------------------------------------------------------------- service defs
ECHO_REQ = serde.S(("text", serde.STRING))
ECHO_RESP = serde.S(("text", serde.STRING))
SLEEP_REQ = serde.S(("ms", serde.I32))

echo_service = rpc.ServiceDef(
    "cycling", "echo",
    [
        rpc.MethodDef("echo", ECHO_REQ, ECHO_RESP),
        rpc.MethodDef("echo_twice", ECHO_REQ, ECHO_RESP),
        rpc.MethodDef("sleep_for", SLEEP_REQ, ECHO_RESP),
        rpc.MethodDef("fail", ECHO_REQ, ECHO_RESP),
    ],
)


class EchoImpl:
    async def echo(self, req):
        return {"text": req["text"]}

    async def echo_twice(self, req):
        return {"text": req["text"] * 2}

    async def sleep_for(self, req):
        await asyncio.sleep(req["ms"] / 1000)
        return {"text": "zzz"}

    async def fail(self, req):
        raise RuntimeError("boom")


def test_method_ids_stable_and_distinct():
    ids = [m.id for m in echo_service.methods.values()]
    assert len(set(ids)) == len(ids)
    again = rpc.ServiceDef(
        "cycling", "echo", [rpc.MethodDef("echo", ECHO_REQ, ECHO_RESP)]
    )
    assert again.methods["echo"].id == echo_service.methods["echo"].id


async def _with_server(fn):
    server = rpc.Server()
    proto = rpc.SimpleProtocol()
    proto.register_service(rpc.ServiceHandler(echo_service, EchoImpl()))
    server.set_protocol(proto)
    await server.start()
    t = Transport("127.0.0.1", server.port)
    await t.connect()
    try:
        return await fn(server, t)
    finally:
        await t.close()
        await server.stop()


def test_echo_roundtrip():
    async def go(server, t):
        client = rpc.Client(echo_service, t)
        assert (await client.echo({"text": "hi"}))["text"] == "hi"
        assert (await client.echo_twice({"text": "ab"}))["text"] == "abab"

    run(_with_server(go))


def test_concurrent_requests_preserve_correlation():
    async def go(server, t):
        client = rpc.Client(echo_service, t)
        slow = asyncio.ensure_future(client.sleep_for({"ms": 100}))
        fast = [client.echo({"text": f"r{i}"}) for i in range(16)]
        results = await asyncio.gather(*fast)
        assert [r["text"] for r in results] == [f"r{i}" for i in range(16)]
        assert (await slow)["text"] == "zzz"

    run(_with_server(go))


def test_trace_ctx_frame_roundtrip():
    ctx = wire.TraceContext(0xABCDEF0123, 0x42, True)
    framed = wire.frame(b"payload", meta=9, correlation_id=3, trace_ctx=ctx)
    h = wire.Header.decode(framed[: wire.HEADER_SIZE])
    assert h.version == wire.VERSION_TRACE_CTX
    got = wire.TraceContext.decode(
        framed[wire.HEADER_SIZE : wire.HEADER_SIZE + wire.TRACE_CTX_SIZE]
    )
    assert got == ctx
    body = framed[wire.HEADER_SIZE + wire.TRACE_CTX_SIZE :]
    assert wire.open_payload(h, body) == b"payload"
    with pytest.raises(wire.WireError):
        wire.TraceContext.decode(b"short")


def test_no_trace_ctx_adds_zero_wire_bytes():
    """The propagation header is feature-flagged on the tracer: without a
    sampled trace the frame is the classic version-0 layout byte-for-byte
    — a disabled tracer costs NOTHING on the wire."""
    plain = wire.frame(b"x" * 100, meta=1, correlation_id=7)
    assert len(plain) == wire.HEADER_SIZE + 100
    assert wire.Header.decode(plain[: wire.HEADER_SIZE]).version == 0

    async def go(server, t):
        from redpanda_tpu_torch.observability import tracer

        assert not tracer.enabled  # default posture in the test process
        client = rpc.Client(echo_service, t)
        assert (await client.echo({"text": "hi"}))["text"] == "hi"

    run(_with_server(go))


def test_server_joins_sampled_trace_never_roots():
    """A sampled request's context rides the wire and the server opens a
    JOINed rpc.handle span under the SAME trace id, anchored to the
    sender's rpc.send span; an unsampled request (no ambient trace) adds
    no bytes and mints no orphan trace."""
    from redpanda_tpu_torch.observability import tracer

    async def go(server, t):
        client = rpc.Client(echo_service, t)
        tracer.configure(enabled=True)
        tracer.reset()
        try:
            with tracer.span("test.root", root=True) as root:
                await client.echo({"text": "sampled"})
            # outside any span: unsampled, must not create traces
            await client.echo({"text": "unsampled"})
            spans = [s for tr in tracer.recent(0) for s in tr["spans"]]
            sends = [s for s in spans if s["name"] == "rpc.send"]
            handles = [s for s in spans if s["name"] == "rpc.handle"]
            assert len(sends) == 1 and len(handles) == 1
            assert sends[0]["trace_id"] == root.trace_id
            assert handles[0]["trace_id"] == root.trace_id  # JOINed
            assert handles[0]["parent_span"] == sends[0]["span_id"]
            # no orphan trace exists for the unsampled echo
            tids = {s["trace_id"] for s in spans}
            assert tids == {root.trace_id}
        finally:
            tracer.configure(enabled=False)
            tracer.reset()

    run(_with_server(go))


def test_unknown_method_404():
    async def go(server, t):
        with pytest.raises(RpcError) as ei:
            await t.send(0xDEADBEEF, b"")
        assert ei.value.status == wire.STATUS_METHOD_NOT_FOUND

    run(_with_server(go))


def test_handler_exception_500():
    async def go(server, t):
        client = rpc.Client(echo_service, t)
        with pytest.raises(RpcError) as ei:
            await client.fail({"text": "x"})
        assert ei.value.status == wire.STATUS_SERVER_ERROR

    run(_with_server(go))


def test_client_timeout_408():
    async def go(server, t):
        client = rpc.Client(echo_service, t)
        with pytest.raises(RpcError) as ei:
            await client.sleep_for({"ms": 2000}, timeout=0.05)
        assert ei.value.status == wire.STATUS_REQUEST_TIMEOUT

    run(_with_server(go))


def test_reconnect_transport_recovers():
    async def go():
        server = rpc.Server()
        proto = rpc.SimpleProtocol()
        proto.register_service(rpc.ServiceHandler(echo_service, EchoImpl()))
        server.set_protocol(proto)
        await server.start()
        port = server.port
        rt = rpc.ReconnectTransport("127.0.0.1", port, rpc.BackoffPolicy(base_ms=1))
        client = rpc.Client(echo_service, rt)
        assert (await client.echo({"text": "a"}))["text"] == "a"
        await server.stop()
        with pytest.raises((TransportClosed, RpcError)):
            await client.echo({"text": "b"})
        # restart on the same port; transport reconnects
        server2 = rpc.Server(port=port)
        server2.set_protocol(proto)
        await server2.start()
        for _ in range(20):
            try:
                assert (await client.echo({"text": "c"}))["text"] == "c"
                break
            except (TransportClosed, RpcError):
                await asyncio.sleep(0.02)
        else:
            raise AssertionError("never reconnected")
        await rt.close()
        await server2.stop()

    run(go())


def test_failure_probe_injects_exception():
    async def go(server, t):
        honey_badger.enable()
        honey_badger.set_exception("echo", "echo")
        client = rpc.Client(echo_service, t)
        try:
            with pytest.raises(RpcError) as ei:
                await client.echo({"text": "x"})
            assert ei.value.status == wire.STATUS_SERVER_ERROR
            honey_badger.unset("echo", "echo")
            assert (await client.echo({"text": "x"}))["text"] == "x"
        finally:
            honey_badger.disable()

    run(_with_server(go))


def test_probe_registry_lists_methods():
    mods = honey_badger.modules()
    assert "echo" in mods and "sleep_for" in mods["echo"]


def test_connection_cache_shard_assignment():
    cc = rpc.ConnectionCache(n_shards=8)
    shards = {cc.shard_for(n) for n in range(64)}
    assert shards <= set(range(8)) and len(shards) > 1


def test_tron_style_soak_with_connection_churn():
    """Soak the RPC stack the way the reference's tron echo tool does
    (src/v/raft/tron): many concurrent echo clients hammer one server
    while connections are periodically torn down mid-flight; every
    response must match its request (correlation never crosses wires)
    and the server must end the run with zero leaked connections."""

    async def go():
        server = rpc.Server()
        proto = rpc.SimpleProtocol()
        proto.register_service(rpc.ServiceHandler(echo_service, EchoImpl()))
        server.set_protocol(proto)
        await server.start()

        N_CLIENTS = 8
        OPS = 60
        errors: list[str] = []

        async def soak_client(cid: int):
            rt = rpc.ReconnectTransport(
                "127.0.0.1", server.port, rpc.BackoffPolicy(base_ms=1)
            )
            client = rpc.Client(echo_service, rt)
            done = 0
            for i in range(OPS):
                text = f"c{cid}-{i}"
                try:
                    resp = await client.echo({"text": text})
                    if resp["text"] != text:
                        errors.append(f"cross-talk: sent {text} got {resp['text']}")
                    done += 1
                except (TransportClosed, RpcError, OSError):
                    pass  # churn window: retried ops are not required
                # churn: every 17th op this client drops its own socket
                if i % 17 == 16:
                    await rt.close()
            await rt.close()
            return done

        totals = await asyncio.gather(*(soak_client(c) for c in range(N_CLIENTS)))
        # all client sockets are closed: the server's connection handlers
        # must all have drained (no leaked connection tasks)
        for _ in range(50):
            if not server._conn_tasks:
                break
            await asyncio.sleep(0.1)
        leaked = len(server._conn_tasks)
        await server.stop()
        assert leaked == 0, f"{leaked} server connection task(s) leaked"
        assert not errors, errors[:5]
        # the vast majority of ops complete despite the churn
        assert sum(totals) >= N_CLIENTS * OPS * 0.8, totals

    asyncio.run(asyncio.wait_for(go(), 120))


# ---------------------------------------------------------------- across packages
def _ref():
    from redpanda_tpu import rpc as ref_rpc
    from redpanda_tpu.rpc import serde as ref_serde
    from redpanda_tpu.rpc import wire as ref_wire

    return ref_rpc, ref_serde, ref_wire


def _frame_cases():
    rng = np.random.default_rng(21)
    big = rng.integers(0, 8, 5000, dtype=np.uint8).tobytes()  # compressible
    return [
        (b"", 0, 1, False, None),
        (b"x", 0xDEAD, 7, False, None),
        (rng.integers(0, 256, 300, dtype=np.uint8).tobytes(), 200, 1 << 31, False, None),
        (big, 404, 9, False, None),
        (big, 1, 2, True, None),  # zstd body
        (b"sampled", 9, 3, False, (0xABCDEF0123, 0x42, True)),
        (big, 5, 6, True, (1, 2, False)),
    ]


@pytest.mark.parametrize("case", range(7))
def test_frames_equal_and_cross_both_ways(case):
    from redpanda_tpu.compression import is_available
    from redpanda_tpu.models.record import Compression

    _ref_rpc, _ref_serde, ref_wire = _ref()
    payload, meta, corr, compress, ctx = _frame_cases()[case]
    if compress and not is_available(Compression.zstd):
        pytest.skip("the JAX package's zstd is not installed")
    mine = wire.frame(
        payload, meta, corr, compress=compress,
        trace_ctx=None if ctx is None else wire.TraceContext(*ctx),
    )
    theirs = ref_wire.frame(
        payload, meta, corr, compress=compress,
        trace_ctx=None if ctx is None else ref_wire.TraceContext(*ctx),
    )
    assert mine == theirs
    for reader_wire, framed in ((ref_wire, mine), (wire, theirs)):
        h = reader_wire.Header.decode(framed[: reader_wire.HEADER_SIZE])
        at = reader_wire.HEADER_SIZE
        if h.version == reader_wire.VERSION_TRACE_CTX:
            got = reader_wire.TraceContext.decode(framed[at : at + reader_wire.TRACE_CTX_SIZE])
            assert (got.trace_id, got.parent_span_id, got.sampled) == ctx
            at += reader_wire.TRACE_CTX_SIZE
        assert (h.meta, h.correlation_id) == (meta, corr)
        assert reader_wire.open_payload(h, framed[at:]) == payload


def _all_types(s):
    return s.S(
        ("a", s.I8), ("b", s.U8), ("c", s.I16), ("d", s.U16), ("e", s.I32),
        ("f", s.U32), ("g", s.I64), ("h", s.U64), ("i", s.F64), ("j", s.BOOL),
        ("k", s.STRING), ("l", s.BYTES), ("m", s.Vector(s.S(("x", s.I32)))),
        ("n", s.Optional(s.STRING)), ("o", s.Optional(s.I64)),
        ("p", s.Map(s.STRING, s.Vector(s.I16))),
        ("q", s.Envelope(s.S(("v", s.I32)), version=2, compat_version=1)),
    )


def test_serde_bodies_equal_and_cross_both_ways():
    _ref_rpc, ref_serde, _ref_wire = _ref()
    msg = {
        "a": -5, "b": 250, "c": -30000, "d": 65000, "e": -(1 << 30),
        "f": (1 << 32) - 1, "g": -(1 << 60), "h": (1 << 64) - 1, "i": 2.5,
        "j": True, "k": "héllo", "l": b"\x00\xff\x10", "m": [{"x": 1}, {"x": -2}],
        "n": None, "o": 7, "p": {"b": [1, 2], "a": [-3]}, "q": {"v": 11},
    }
    mine, theirs = _all_types(serde), _all_types(ref_serde)
    assert mine.encode(msg) == theirs.encode(msg)
    assert theirs.decode(mine.encode(msg)) == msg
    assert mine.decode(theirs.encode(msg)) == msg
    env_mine = serde.Envelope(mine, version=3, compat_version=1)
    env_theirs = ref_serde.Envelope(theirs, version=3, compat_version=1)
    assert env_mine.encode(msg) == env_theirs.encode(msg)
    assert env_theirs.decode(env_mine.encode(msg)) == msg


def _echo_def(r, s):
    req = s.S(("text", s.STRING))
    return r.ServiceDef(
        "cycling", "echo",
        [r.MethodDef("echo", req, req), r.MethodDef("echo_twice", req, req),
         r.MethodDef("sleep_for", s.S(("ms", s.I32)), req), r.MethodDef("fail", req, req)],
    )


def test_method_ids_equal_across_packages():
    from redpanda_tpu.raft.service import raftgen_service as ref_raftgen
    from redpanda_tpu_torch.raft.service import raftgen_service

    ref_rpc, ref_serde, _ref_wire = _ref()
    theirs = _echo_def(ref_rpc, ref_serde)
    assert {n: m.id for n, m in echo_service.methods.items()} == {
        n: m.id for n, m in theirs.methods.items()
    }
    assert {n: m.id for n, m in raftgen_service.methods.items()} == {
        n: m.id for n, m in ref_raftgen.methods.items()
    }


async def _serve(r, definition, impl):
    server = r.Server()
    proto = r.SimpleProtocol()
    proto.register_service(r.ServiceHandler(definition, impl))
    server.set_protocol(proto)
    await server.start()
    return server


@pytest.mark.parametrize("direction", ["port_client_jax_server", "jax_client_port_server"])
def test_client_and_server_cross_packages(direction):
    ref_rpc, ref_serde, ref_wire = _ref()
    ref_echo = _echo_def(ref_rpc, ref_serde)
    if direction == "port_client_jax_server":
        srv_rpc, srv_def, cli_rpc, cli_def, cli_transport = ref_rpc, ref_echo, rpc, echo_service, Transport
        cli_err, cli_wire = RpcError, wire
    else:
        from redpanda_tpu.rpc.transport import RpcError as RefRpcError
        from redpanda_tpu.rpc.transport import Transport as RefTransport

        srv_rpc, srv_def, cli_rpc, cli_def, cli_transport = rpc, echo_service, ref_rpc, ref_echo, RefTransport
        cli_err, cli_wire = RefRpcError, ref_wire

    async def go():
        server = await _serve(srv_rpc, srv_def, EchoImpl())
        t = cli_transport("127.0.0.1", server.port)
        await t.connect()
        try:
            client = cli_rpc.Client(cli_def, t)
            assert (await client.echo({"text": "hi"}))["text"] == "hi"
            got = await asyncio.gather(*(client.echo_twice({"text": f"r{i}"}) for i in range(8)))
            assert [g["text"] for g in got] == [f"r{i}" * 2 for i in range(8)]
            with pytest.raises(cli_err) as ei:
                await client.fail({"text": "x"})
            assert ei.value.status == cli_wire.STATUS_SERVER_ERROR
            with pytest.raises(cli_err) as ei:
                await t.send(0xDEADBEEF, b"")
            assert ei.value.status == cli_wire.STATUS_METHOD_NOT_FOUND
        finally:
            await t.close()
            await server.stop()

    run(go())


def _raft_messages():
    vnode = {"id": 2, "revision": 5}
    meta = {
        "group": 7, "node": vnode, "target": {"id": 1, "revision": 0}, "term": 3,
        "prev_log_index": 41, "prev_log_term": 2, "commit_index": 40,
    }
    reply = {
        "group": 7, "node": {"id": 1, "revision": 0}, "target": vnode, "term": 3,
        "last_dirty_log_index": 41, "last_flushed_log_index": 40, "result": 1,
    }
    return {
        "vote": (
            {**{k: v for k, v in meta.items() if k != "commit_index"},
             "leadership_transfer": True, "prevote": False},
            {"term": 3, "granted": True, "log_ok": False},
        ),
        "append_entries": (
            {**meta, "batches": bytes(range(256)) * 3, "flush": True},
            reply,
        ),
        "heartbeat": ({"heartbeats": [meta, {**meta, "group": 8}]}, {"meta": [reply, reply]}),
    }


@pytest.mark.parametrize("method", ["vote", "append_entries", "heartbeat"])
def test_raft_requests_and_replies_cross_both_ways(method):
    from redpanda_tpu.raft.service import raftgen_service as ref_raftgen
    from redpanda_tpu_torch.raft.service import raftgen_service

    mine, theirs = raftgen_service.methods[method], ref_raftgen.methods[method]
    req, rep = _raft_messages()[method]
    for msg, a, b in ((req, mine.request, theirs.request), (rep, mine.response, theirs.response)):
        got = a.encode(msg)
        assert got == b.encode(msg)
        assert b.decode(got) == msg
        assert a.decode(b.encode(msg)) == msg


def _random_type(rng, s, depth=0):
    """A random serde type tree over package ``s``, and a value maker."""
    leaves = [
        (s.I8, lambda: int(rng.integers(-128, 128))), (s.U8, lambda: int(rng.integers(0, 256))),
        (s.I16, lambda: int(rng.integers(-(2**15), 2**15))), (s.U16, lambda: int(rng.integers(0, 2**16))),
        (s.I32, lambda: int(rng.integers(-(2**31), 2**31))), (s.U32, lambda: int(rng.integers(0, 2**32))),
        (s.I64, lambda: int(rng.integers(-(2**63), 2**63))), (s.U64, lambda: int(rng.integers(0, 2**63)) * 2),
        (s.F64, lambda: float(rng.random())), (s.BOOL, lambda: bool(rng.integers(0, 2))),
        (s.STRING, lambda: "s%dé" % rng.integers(0, 99)), (s.BYTES, lambda: rng.bytes(int(rng.integers(0, 6)))),
    ]
    kind = "leaf" if depth > 2 or rng.random() < 0.45 else rng.choice(
        ["vector", "optional", "map", "struct", "envelope"])
    if kind == "leaf":
        return leaves[int(rng.integers(0, len(leaves)))]
    if kind in ("struct", "envelope"):
        fields = [(f"f{i}", *_random_type(rng, s, depth + 1)) for i in range(int(rng.integers(0, 5)))]
        typ = s.S(*[(n, t) for n, t, _m in fields])
        if kind == "envelope":
            compat = int(rng.integers(0, 3))
            typ = s.Envelope(typ, version=compat + int(rng.integers(0, 2)), compat_version=compat)

        def make():  # a missing key takes the field's default
            return {n: m() for n, _t, m in fields if rng.random() > 0.2}

        return typ, make
    if kind == "map":
        key = leaves[4] if rng.random() < 0.5 else leaves[10]
        inner, make = _random_type(rng, s, depth + 1)
        return s.Map(key[0], inner), lambda: {key[1](): make() for _ in range(int(rng.integers(0, 4)))}
    inner, make = _random_type(rng, s, depth + 1)
    if kind == "vector":
        return s.Vector(inner), lambda: [make() for _ in range(int(rng.integers(0, 4)))]
    return s.Optional(inner), lambda: None if rng.random() < 0.3 else make()


@pytest.mark.parametrize("seed", range(4))
def test_compiled_codecs_equal_the_jax_serde_on_random_types(seed):
    # the port compiles each type into closures (one struct pack for a
    # Struct of scalars); the JAX package walks the field table per value:
    # the bytes, the decoded values and the errors of a truncated buffer
    # must be the same on random type trees and values
    _ref_rpc, ref_serde, _ref_wire = _ref()
    for trial in range(300):
        trees = []
        for pkg in (serde, ref_serde):  # the same draws build both trees
            rng = np.random.default_rng((seed, trial))
            typ, make = _random_type(rng, pkg)
            trees.append((pkg.S(("a", typ), ("b", pkg.I32)), make))
        (mine, make), (theirs, _make) = trees
        msg = {"a": make(), "b": trial}
        try:
            blob = theirs.encode(msg)
        except Exception as e:  # noqa: BLE001 — e.g. a missing Envelope field
            with pytest.raises(type(e)):
                mine.encode(msg)
            continue
        assert mine.encode(msg) == blob
        assert mine.decode(blob) == theirs.decode(blob)
        for cut in range(0, len(blob), max(1, len(blob) // 5)):
            errs = []
            for codec in (mine, theirs):
                try:
                    errs.append(("ok", codec.decode(blob[:cut])))
                except Exception as e:  # noqa: BLE001 — compared by type
                    errs.append(type(e).__name__)
            assert errs[0] == errs[1], (trial, cut)


def test_flat_struct_takes_objects_and_defaults():
    # a Struct of scalar leaves packs in one call; values given as objects
    # (fields as attributes) and missing keys encode as the JAX package does
    from types import SimpleNamespace

    _ref_rpc, ref_serde, _ref_wire = _ref()
    mk = lambda s: s.S(("group", s.I64), ("node", s.S(("id", s.I32), ("revision", s.I64))),
                       ("ok", s.BOOL))
    mine, theirs = mk(serde), mk(ref_serde)
    for msg in ({}, {"group": 3}, {"node": {"id": 2}}, {"group": 1, "node": SimpleNamespace(id=4, revision=9), "ok": 1},
                SimpleNamespace(group=5, node={"id": 1, "revision": 2}, ok=False)):
        assert mine.encode(msg) == theirs.encode(msg)
        assert mine.decode(theirs.encode(msg)) == theirs.decode(theirs.encode(msg))
