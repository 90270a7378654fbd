"""Kafka protocol server loop (the JAX package's kafka/server/protocol.py).

Parity with kafka::protocol + connection_context (kafka/server/protocol.cc:81
apply loop; connection_context.cc:32 process_one_request, :215
dispatch_method_once): size-prefixed frames, per-connection **staged
pipelining** — each request's handler runs as its own task so handlers
overlap, while a writer fiber drains responses strictly in request order —
with pipeline depth bounded per connection (the reference gates on
size-based memory units; here the response queue is bounded, so one
connection can hold at most MAX_PIPELINE frames in flight).

The server registers the data-plane, topic-admin, group and transaction
handlers, as the reference does. The SASL and ACL handlers come with
ROADMAP item 10d: until then a request for one of those keys gets the
reference's answer for a key with no handler (the unsupported-version
path, which closes the connection), while ApiVersions still advertises the
whole ``APIS`` table, as the reference does. A broker with
``sasl_enabled`` is refused at construction, since nothing could
authenticate against it; TLS comes with item 10d too.
"""

from __future__ import annotations

import asyncio
import logging
import struct

from redpanda_tpu_torch.kafka.protocol.errors import ErrorCode, KafkaError
from redpanda_tpu_torch.kafka.protocol.messages import (
    API_VERSIONS,
    APIS,
    FETCH,
    JOIN_GROUP,
    PRODUCE,
    SASL_AUTHENTICATE,
    SASL_HANDSHAKE,
    SYNC_GROUP,
)
from redpanda_tpu_torch.kafka.protocol.primitives import Reader
from redpanda_tpu_torch.kafka.protocol.schema import (
    RequestHeader,
    decode_message,
    encode_message,
    encode_response_header,
)

logger = logging.getLogger("rptpu.kafka")

MAX_REQUEST_SIZE = 100 * 1024 * 1024
MAX_PIPELINE = 64  # max in-flight requests per connection

# HDR latency probes for the two hot APIs (kafka/latency_probe.h:33-43:
# the reference histograms produce and fetch specifically), exported at
# /metrics with cumulative buckets + sum/count for quantile queries.
# Defined once in observability/probes.py; recorded ONLY here at the
# dispatch layer so decode/encode are covered and nothing double-counts.
from redpanda_tpu_torch.observability.probes import (  # noqa: E402
    kafka_fetch_hist as _fetch_latency,
    kafka_produce_hist as _produce_latency,
    record_us as _record_us,
)


class RequestContext:
    """Per-request context handed to handlers (kafka::request_context)."""

    __slots__ = ("broker", "header", "request", "connection", "trace_id")

    def __init__(self, broker, header: RequestHeader, request: dict, connection):
        self.broker = broker
        self.header = header
        self.request = request
        self.connection = connection
        # stamped by the handler's root span (handlers.handle_produce/
        # handle_fetch): the dispatch layer records the latency histogram
        # AFTER the span closed, so exemplar capture needs the id carried
        # out-of-band (observability/probes.py trace exemplars)
        self.trace_id = None

    @property
    def api_version(self) -> int:
        return self.header.api_version


class Connection:
    def __init__(self, server: "KafkaServer", reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        self.server = server
        self.reader = reader
        self.writer = writer
        self.sasl_state = None  # set by the sasl handlers
        self.authenticated_principal: str | None = None
        peer = writer.get_extra_info("peername")
        self.client_host: str = peer[0] if peer else "*"
        # Bounded: `await put` backpressures the read loop once MAX_PIPELINE
        # requests are in flight on this connection.
        self._responses: asyncio.Queue[asyncio.Task | None] = asyncio.Queue(maxsize=MAX_PIPELINE)
        self._handler_tasks: set[asyncio.Task] = set()
        # memory-gate reservations held by in-flight requests
        self._reserved: dict[object, int] = {}

    async def run(self) -> None:
        writer_task = asyncio.create_task(self._drain_responses())
        cancelled = False
        try:
            while True:
                frame, reserved = await self._read_frame()
                if frame is None:
                    break
                # Staged pipelining: decode synchronously here so wire order
                # and the sasl state machine are preserved, then dispatch the
                # handler as a task so handlers overlap while the writer
                # fiber drains responses strictly in request order.
                decoded = self._decode_frame(frame)
                if decoded is None:
                    self._release(reserved)
                    break  # fatal protocol error: close the connection
                if isinstance(decoded, bytes):
                    done: asyncio.Future = asyncio.get_running_loop().create_future()
                    done.set_result(decoded)
                    self._reserved[done] = reserved
                    await self._responses.put(done)
                else:
                    task = asyncio.create_task(self._dispatch(*decoded))
                    self._handler_tasks.add(task)
                    task.add_done_callback(self._handler_tasks.discard)
                    self._reserved[task] = reserved
                    await self._responses.put(task)
        except asyncio.CancelledError:
            cancelled = True
            raise
        finally:
            if cancelled:
                # Server shutdown: stop in-flight handlers (they may be
                # long-polling fetches) before tearing down the writer.
                for t in list(self._handler_tasks):
                    t.cancel()
                writer_task.cancel()
            else:
                # Normal close: let queued handlers finish and drain.
                self._responses.put_nowait(None)
                await writer_task
            if self._handler_tasks:
                await asyncio.gather(*self._handler_tasks, return_exceptions=True)
            for reserved in self._reserved.values():
                self._release(reserved)
            self._reserved.clear()
            self.writer.close()
            try:
                await self.writer.wait_closed()
            except (ConnectionError, OSError, asyncio.CancelledError):
                pass

    async def _read_frame(self) -> tuple[bytes | None, int]:
        try:
            size_buf = await self.reader.readexactly(4)
        except (asyncio.IncompleteReadError, ConnectionError):
            return None, 0
        (size,) = struct.unpack(">i", size_buf)
        if size < 0 or size > MAX_REQUEST_SIZE:
            raise ValueError(f"invalid frame size {size}")
        # Memory gate (connection_context.cc:32): reserve the frame size
        # BEFORE reading the body; a flood of large requests backpressures
        # here instead of ballooning the heap. Released when the response
        # drains (or the connection dies).
        reserved = await self.server.memory.acquire(size)
        try:
            frame = await self.reader.readexactly(size)
        except (asyncio.IncompleteReadError, ConnectionError):
            self._release(reserved)
            return None, 0
        except BaseException:
            # Cancellation (connection teardown racing a slow body read)
            # must give the bytes back: this reservation is not yet in
            # self._reserved, so the close path can't see it.
            self._release(reserved)
            raise
        return frame, reserved

    def _release(self, reserved: int) -> None:
        if reserved:
            self.server.memory.release(reserved)

    def _decode_frame(self, frame: bytes):
        """Synchronous decode: returns a prebuilt error response (bytes) or
        (header, api, request) for dispatch."""
        r = Reader(frame)
        header = RequestHeader.decode(r, flexible=False)
        api = APIS.get(header.api_key)
        # Range-check BEFORE the flexible re-decode: an out-of-range version
        # (e.g. a KIP-511 ApiVersions probe from the future) may not carry
        # the tagged-field header byte our flexible table would expect, and
        # the v0 error response only needs the fixed-offset correlation id.
        if api is None or not (api.min_version <= header.api_version <= api.max_version):
            return self._unsupported_version_response(header)
        if api.is_flexible(header.api_version):
            # re-decode with the flexible header (v2: + tagged fields)
            r = Reader(frame)
            header = RequestHeader.decode(r, flexible=True)
        if self.server.handlers.get(header.api_key) is None:
            return self._unsupported_version_response(header)
        try:
            request = decode_message(api, "request", frame[r.pos :], header.api_version)
        except Exception:
            # A frame we can't parse at a version we claim to support is a
            # broken client; close rather than answer with garbage.
            logger.exception("decode failed for %s v%d", api.name, header.api_version)
            return None
        return header, api, request

    async def _dispatch(self, header: RequestHeader, api, request: dict) -> bytes | None:
        ctx = RequestContext(self.server.broker, header, request, self)
        handler = self.server.handlers[header.api_key]
        # SASL gate: with authentication enabled, only the handshake dance
        # and ApiVersions may run unauthenticated (requests.cc:99-160).
        if (
            getattr(self.server.broker, "sasl_enabled", False)
            and self.authenticated_principal is None
            and header.api_key not in (API_VERSIONS, SASL_HANDSHAKE, SASL_AUTHENTICATE)
        ):
            resp = self.server.error_response(
                api, header.api_version, ctx, ErrorCode.sasl_authentication_failed
            )
            if resp:
                return self._encode_response(header, api, resp)
            # No expressible error shape for this API (no error_code field,
            # no maker): a success-shaped empty body would read as a healthy
            # empty cluster, so close the connection like real brokers do.
            logger.warning(
                "closing unauthenticated connection on api %s", api.name
            )
            self.writer.close()
            return None
        # qdc gate: bound concurrent execution so latency tracks the target
        # (no-op unless kafka_qdc_enable). APIs that PARK inside their
        # handler are exempt — a long-poll fetch waits for data and a
        # join/sync waits for the rest of the group, not queue pressure;
        # gating them would let one parked request hold the window's slots
        # and starve produces (or deadlock a rebalance at depth 1), while
        # their multi-second waits would poison the latency EWMA.
        gated = header.api_key not in (FETCH, JOIN_GROUP, SYNC_GROUP)
        # t0 BEFORE acquire: the HISTOGRAMS must include queue-wait, or an
        # overloaded-but-queueing broker reads as healthy to operators.
        # The qdc control signal is sampled from t_svc (AFTER acquire):
        # feeding queue-wait back into the controller would make the
        # measured latency depend inversely on the depth being controlled —
        # a positive feedback loop that pins depth at the floor.
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        if gated:
            await self.server.qdc.acquire()
        t_svc = loop.time()
        try:
            response = await handler(ctx)
        except KafkaError as e:
            response = self.server.error_response(api, header.api_version, ctx, e.code)
        except Exception:
            logger.exception("handler %s failed", api.name)
            response = self.server.error_response(
                api, header.api_version, ctx, ErrorCode.unknown_server_error
            )
        finally:
            if gated:
                await self.server.qdc.release(loop.time() - t_svc)
        # exemplar-aware record: over-threshold observations keep the
        # request's trace id so an SLO breach links to /v1/trace/slow.
        # Fetch records WITHOUT a trace id on purpose: its root span is
        # no_slow (a long poll's duration is intentional waiting, never in
        # the slow ring), so a fetch exemplar could only ever be a dead
        # link — fetch objectives are judged on their error budget instead.
        if header.api_key == PRODUCE:
            _record_us(
                _produce_latency, int((loop.time() - t0) * 1e6),
                trace_id=ctx.trace_id,
            )
        elif header.api_key == FETCH:
            _fetch_latency.record(int((loop.time() - t0) * 1e6))
        return self._encode_response(header, api, response)

    def _encode_response(self, header: RequestHeader, api, response: dict | None) -> bytes | None:
        if response is None:
            return None  # e.g. acks=0 produce: no response on the wire
        # ApiVersions responses always use the v0 response header.
        flexible_hdr = api.is_flexible(header.api_version) and header.api_key != API_VERSIONS
        body = encode_message(api, "response", response, header.api_version)
        return encode_response_header(header.correlation_id, flexible_hdr) + body

    def _unsupported_version_response(self, header: RequestHeader) -> bytes | None:
        """Per KIP-511, an unsupported ApiVersions request gets a v0 response
        with the supported ranges so the client downgrades. For any other API
        we cannot encode a response the client will parse at its requested
        version, so close the connection (what real brokers do) by returning
        the close sentinel."""
        if header.api_key == API_VERSIONS:
            api = APIS.get(API_VERSIONS)
            body = encode_message(
                api,
                "response",
                {
                    "error_code": int(ErrorCode.unsupported_version),
                    "api_keys": [
                        {
                            "api_key": a.key,
                            "min_version": a.min_version,
                            "max_version": a.max_version,
                        }
                        for a in sorted(APIS.values(), key=lambda a: a.key)
                    ],
                    "throttle_time_ms": 0,
                },
                0,
            )
            return encode_response_header(header.correlation_id, False) + body
        logger.warning(
            "unsupported api key %d v%d from client; closing connection",
            header.api_key,
            header.api_version,
        )
        return None

    async def _drain_responses(self) -> None:
        while True:
            task = await self._responses.get()
            if task is None:
                return
            try:
                payload = await task
            except asyncio.CancelledError:
                if isinstance(task, asyncio.Task) and task.cancelled():
                    self._release(self._reserved.pop(task, 0))
                    continue  # the handler was cancelled, not this fiber
                raise
            except Exception:
                logger.exception("response task failed")
                self._release(self._reserved.pop(task, 0))
                continue
            self._release(self._reserved.pop(task, 0))
            if payload is None:
                continue
            try:
                self.writer.write(struct.pack(">i", len(payload)) + payload)
                await self.writer.drain()
            except (ConnectionError, OSError):
                return


class KafkaServer:
    """Accept loop + handler registry (rpc::server with kafka::protocol)."""

    def __init__(self, broker, host: str = "127.0.0.1", port: int = 9092):
        from redpanda_tpu_torch.kafka.server import handlers as h

        if broker.sasl_enabled:
            raise NotImplementedError(
                "SASL is not ported yet (ROADMAP item 10d): "
                "a KafkaServer needs a broker with sasl_enabled=False"
            )
        self.broker = broker
        self.host = host
        self.port = port
        self.handlers = h.build_dispatch_table()
        from redpanda_tpu_torch.kafka.server import group_handlers as gh
        from redpanda_tpu_torch.kafka.server import tx_handlers as th

        gh.register_group_handlers(self.handlers)
        th.register_tx_handlers(self.handlers)
        from redpanda_tpu_torch.coproc import leakwatch
        from redpanda_tpu_torch.resource_mgmt import MemoryBudget

        # leakwatch: the request-memory budget is THE account the
        # _read_frame cancellation path reserves from — with
        # coproc_leakwatch on, a torn connection leaking its frame
        # reservation shows up as nonzero outstanding balance
        self.memory = leakwatch.wrap(
            MemoryBudget(broker.config.kafka_request_max_memory),
            "kafka.request_memory",
        )
        from redpanda_tpu_torch.kafka.server.qdc import QdcMonitor

        cfg = broker.config
        self.qdc = QdcMonitor(
            enabled=cfg.kafka_qdc_enable,
            target_latency_ms=cfg.kafka_qdc_max_latency_ms,
            window_s=cfg.kafka_qdc_window_s,
            min_depth=cfg.kafka_qdc_min_depth,
            max_depth=cfg.kafka_qdc_max_depth,
        )
        self._server: asyncio.AbstractServer | None = None
        self._conn_tasks: set[asyncio.Task] = set()

    async def start(self) -> "KafkaServer":
        # the produce and fetch paths run on the broker's device: resolve it
        # before anything else, so that "cuda" without a card raises here
        # and no socket is opened
        self.broker.device
        # single-node mode: rediscover topics from disk before serving
        # (cluster mode repopulates the table via controller replay instead)
        if getattr(self.broker, "controller_dispatcher", None) is None:
            await self.broker.recover_topics()
        tx = getattr(self.broker, "tx_coordinator", None)
        if tx is not None:
            tx.start_expiry()
        self._server = await asyncio.start_server(
            self._on_connection, self.host, self.port
        )
        if self.port == 0:
            self.port = self._server.sockets[0].getsockname()[1]
        logger.info("kafka api listening on %s:%d", self.host, self.port)
        return self

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # Force-close surviving connections rather than waiting: 3.12's
            # Server.wait_closed() blocks until every handler returns, which
            # would hang on clients that keep their sockets open.
            for task in list(self._conn_tasks):
                task.cancel()
            if self._conn_tasks:
                await asyncio.gather(*self._conn_tasks, return_exceptions=True)
            try:
                await asyncio.wait_for(self._server.wait_closed(), timeout=1.0)
            except asyncio.TimeoutError:
                pass
        # AFTER connections are torn down: an in-flight group request could
        # otherwise restart the manager and leak its expiry fiber
        gm = getattr(self.broker, "group_coordinator", None)
        if gm is not None:
            await gm.stop()
        tx = getattr(self.broker, "tx_coordinator", None)
        if tx is not None:
            await tx.stop()

    async def _on_connection(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        conn = Connection(self, reader, writer)
        try:
            await conn.run()
        except asyncio.CancelledError:
            try:
                writer.close()
            except Exception:
                pass
        except Exception:
            logger.exception("connection failed")
            try:
                writer.close()
            except Exception:
                pass
        finally:
            self._conn_tasks.discard(task)

    # ------------------------------------------------------------ errors
    def error_response(self, api, version: int, ctx: RequestContext, code: ErrorCode) -> dict:
        """Best-effort structured error response echoing request topology."""
        from redpanda_tpu_torch.kafka.server import handlers as h

        maker = h.ERROR_RESPONSE_MAKERS.get(api.key)
        if maker is not None:
            return maker(ctx, code)
        return self.minimal_error_body(api, code)

    @staticmethod
    def minimal_error_body(api, code: ErrorCode) -> dict:
        body: dict = {}
        for f in api.response:
            if f.name == "error_code":
                body[f.name] = int(code)
        return body
