"""Internal RPC server.

Parity with rpc::server (rpc/server.cc:47-99): an accept loop hands each
connection to a pluggable ``protocol`` — the internal simple_protocol here;
the Kafka layer plugs its own protocol into the same engine
(kafka/server/protocol.py), mirroring how the reference reuses one server
for both (application.cc:791-850).

simple_protocol semantics (rpc/simple_protocol.cc): read header, verify
checksums, look up method id; unknown id → status 404 in the reply header
meta (simple_protocol.cc:101-103); handler exception → 500; per-connection
requests may overlap, responses carry the request's correlation id.

(The JAX package's rpc/server.py, copied.)
"""

from __future__ import annotations

import asyncio
import logging

from redpanda_tpu_torch.observability.trace import tracer
from redpanda_tpu_torch.rpc import wire
from redpanda_tpu_torch.rpc.service import ServiceHandler

logger = logging.getLogger("rpc.server")


class SimpleProtocol:
    """Method-id dispatch over registered services.

    ``node_id`` stamps the JOINed per-request span (pandascope): a
    process hosting several in-process brokers shares one tracer, so the
    span itself must say which broker served the request."""

    name = "vectorized internal rpc protocol"

    def __init__(self, node_id: int | None = None, inflight_gate=None) -> None:
        self._methods: dict[int, ServiceHandler] = {}
        self.node_id = node_id
        # resource_mgmt.admission.InflightGate (or None = uncapped, the
        # historical semantics): bounds concurrent dispatched requests and
        # their body bytes, shedding WHOLE requests at dispatch with
        # STATUS_BACKPRESSURE before the handler runs — a shed request did
        # nothing, so peers resend safely (transport.RpcBackpressure)
        if inflight_gate is not None:
            # leakwatch balance recorder with coproc_leakwatch on; the raw
            # gate untouched (zero overhead) otherwise
            from redpanda_tpu_torch.coproc import leakwatch

            inflight_gate = leakwatch.wrap(inflight_gate, "rpc.inflight_gate")
        self.inflight_gate = inflight_gate

    def register_service(self, handler: ServiceHandler) -> None:
        for mid in handler.method_ids():
            if mid in self._methods:
                raise ValueError(f"duplicate method id {mid:#x}")
            self._methods[mid] = handler

    async def apply(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        write_lock = asyncio.Lock()
        pending: set[asyncio.Task] = set()
        try:
            while True:
                try:
                    h, ctx, body = await wire.read_message(reader)
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    return
                reserved = None
                if self.inflight_gate is not None:
                    reserved = self.inflight_gate.try_enter(len(body))
                    if reserved is None:
                        # shed at dispatch: answer backpressure without
                        # spawning the handler (counted by the gate;
                        # retriable by contract — nothing ran)
                        out = wire.frame(
                            b"", wire.STATUS_BACKPRESSURE, h.correlation_id
                        )
                        async with write_lock:
                            try:
                                writer.write(out)
                                await writer.drain()
                            except (ConnectionResetError, BrokenPipeError):
                                return
                        continue
                # Handlers overlap across requests on one connection; each
                # response is written atomically under the lock.
                t = asyncio.ensure_future(
                    self._handle_one(h, body, writer, write_lock, ctx)
                )
                pending.add(t)
                t.add_done_callback(pending.discard)
                if reserved is not None:
                    # release via done-callback, NOT inside the handler: a
                    # task cancelled before its first step (connection
                    # torn down in the same read that delivered the
                    # frame) never enters the coroutine body, so an
                    # in-handler finally would leak the slot — callbacks
                    # run for cancelled tasks too
                    t.add_done_callback(
                        lambda _t, g=self.inflight_gate, r=reserved: g.leave(r)
                    )
        finally:
            for t in pending:
                t.cancel()

    async def _handle_one(
        self, h: wire.Header, body: bytes, writer, write_lock,
        ctx: wire.TraceContext | None = None,
    ) -> None:
        status = wire.STATUS_SUCCESS
        handler = self._methods.get(h.meta)
        if handler is None:
            status, reply = wire.STATUS_METHOD_NOT_FOUND, b""
        else:
            try:
                # JOINed, never root: an inbound request without wire
                # context (unsampled peer, tracer off) must not mint
                # orphan traces — span(trace_id=None) is the usual no-op.
                # Everything the handler awaits under this span (follower
                # storage.append, coproc dispatch, nested sends) inherits
                # the submitter's trace id and this broker's node stamp.
                with tracer.span(
                    "rpc.handle",
                    trace_id=ctx.trace_id if ctx is not None else None,
                    node=self.node_id,
                ) as sp:
                    if ctx is not None:
                        sp.set("method_id", h.meta)
                        sp.set("parent_span", ctx.parent_span_id)
                    reply = await handler.dispatch(h.meta, body)
            except asyncio.CancelledError:
                raise
            except SystemExit:
                raise
            except Exception:
                logger.exception("rpc handler failed (method %#x)", h.meta)
                status, reply = wire.STATUS_SERVER_ERROR, b""
        out = wire.frame(reply, status, h.correlation_id)
        async with write_lock:
            try:
                writer.write(out)
                await writer.drain()
            except (ConnectionResetError, BrokenPipeError):
                pass


class Server:
    """TCP accept loop with a pluggable protocol."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0, tls=None) -> None:
        self.host = host
        self.port = port
        self.tls = tls  # security.tls.ReloadableTlsContext | None
        self._protocol = None
        self._server: asyncio.AbstractServer | None = None
        self._conn_tasks: set[asyncio.Task] = set()

    def set_protocol(self, protocol) -> None:
        self._protocol = protocol

    async def start(self) -> None:
        assert self._protocol is not None, "set_protocol first"
        ssl_ctx = self.tls.server_context if self.tls is not None else None
        self._server = await asyncio.start_server(
            self._on_conn, self.host, self.port, ssl=ssl_ctx
        )
        self.port = self._server.sockets[0].getsockname()[1]

    async def _on_conn(self, reader, writer) -> None:
        t = asyncio.current_task()
        self._conn_tasks.add(t)
        try:
            await self._protocol.apply(reader, writer)
        except (wire.WireError, ConnectionResetError) as e:
            logger.debug("connection dropped: %s", e)
        finally:
            self._conn_tasks.discard(t)
            try:
                writer.close()
                await writer.wait_closed()
            except Exception:
                pass

    async def stop(self) -> None:
        # Cancel live connection handlers BEFORE wait_closed(): since
        # Python 3.12 wait_closed blocks until every handler returns.
        if self._server is not None:
            self._server.close()
        for t in list(self._conn_tasks):
            t.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        self._conn_tasks.clear()
        if self._server is not None:
            await self._server.wait_closed()
            self._server = None
