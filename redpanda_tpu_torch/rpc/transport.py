"""RPC client transports.

- ``Transport``: one TCP connection; concurrent requests matched to
  responses by correlation id (rpc/transport.h — _correlations map).
- ``ReconnectTransport``: wraps a Transport with exponential backoff
  reconnection (rpc/reconnect_transport.h backoff_policy).
- ``ConnectionCache``: one ReconnectTransport per peer node id
  (rpc/connection_cache.h); the reference assigns each cached connection to
  a shard via jump-consistent hash — we keep the hash so ownership is
  deterministic, even though a single asyncio loop plays all shards.

(The JAX package's rpc/transport.py, copied.)
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time

from redpanda_tpu_torch.finjector import honey_badger
from redpanda_tpu_torch.hashing.jump import jump_consistent_hash
from redpanda_tpu_torch.observability import probes
from redpanda_tpu_torch.observability.trace import tracer
from redpanda_tpu_torch.rpc import wire

logger = logging.getLogger("rpc.transport")

# transport-level failure probe: one site below every per-method probe
# (rpc.service registers <service>.<method>), so chaos runs can fault the
# WIRE itself — exception/delay/wedge on any outbound send
honey_badger.register_probe("rpc", "send")


class RpcError(Exception):
    def __init__(self, status: int, msg: str = "") -> None:
        super().__init__(msg or f"rpc status {status}")
        self.status = status


class RpcBackpressure(RpcError):
    """The peer shed the request at dispatch (STATUS_BACKPRESSURE): its
    handler never ran, so a resend is always safe. Raft's retry loops
    treat this like any transient send failure — backoff and resend —
    which is exactly the open-loop-overload contract: shed, counted,
    never lost."""

    def __init__(self, msg: str = "") -> None:
        super().__init__(wire.STATUS_BACKPRESSURE, msg or "peer backpressure")


class TransportClosed(Exception):
    pass


class Transport:
    def __init__(
        self, host: str, port: int, compress: bool = False, ssl_context=None
    ) -> None:
        self.host = host
        self.port = port
        self.compress = compress
        self.ssl_context = ssl_context
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._corr = itertools.count(1)
        self._inflight: dict[int, asyncio.Future] = {}
        self._read_task: asyncio.Task | None = None

    @property
    def connected(self) -> bool:
        return self._writer is not None

    async def connect(self) -> None:
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port, ssl=self.ssl_context
        )
        self._read_task = asyncio.ensure_future(self._read_loop())

    async def _read_loop(self) -> None:
        assert self._reader is not None
        try:
            while True:
                h, _ctx, body = await wire.read_message(self._reader)
                fut = self._inflight.pop(h.correlation_id, None)
                if fut is None or fut.done():
                    continue
                if h.meta == wire.STATUS_SUCCESS:
                    fut.set_result(body)
                elif h.meta == wire.STATUS_BACKPRESSURE:
                    fut.set_exception(RpcBackpressure())
                else:
                    fut.set_exception(RpcError(h.meta))
        except asyncio.CancelledError:
            self._fail_all(TransportClosed("cancelled"))
        except Exception as e:  # noqa: BLE001 — any read/decode error is fatal
            self._fail_all(TransportClosed(str(e)))

    def _fail_all(self, exc: Exception) -> None:
        inflight, self._inflight = self._inflight, {}
        for fut in inflight.values():
            if not fut.done():
                fut.set_exception(exc)
        self._writer = None

    async def send(self, method_id: int, payload: bytes, timeout: float | None = None) -> bytes:
        if self._writer is None:
            raise TransportClosed("not connected")
        t0 = time.perf_counter()
        try:
            with tracer.span("rpc.send") as sp:
                sp.set("method_id", method_id)
                if honey_badger.enabled:  # keep the disabled hot path to one
                    # check, not a coroutine allocation per outbound RPC
                    # (hbadger.h:30-37 compiles probes out of release
                    # builds; this is our analogue). Inside the timed span
                    # deliberately: an injected slow/failed link must land
                    # in rpc_request_latency_us and the rpc.send span, or
                    # chaos runs judge a histogram the fault never touched.
                    await honey_badger.maybe_inject("rpc", "send")
                    if self._writer is None:
                        # the transport closed while the fault blocked us
                        raise TransportClosed("not connected")
                corr = next(self._corr)
                fut: asyncio.Future = asyncio.get_event_loop().create_future()
                self._inflight[corr] = fut
                # pandascope: a sampled request (live span joining an
                # ambient trace) carries its context on the wire so the
                # peer's handler span JOINs the same trace; an unsampled
                # one (tracer off, no ambient trace — heartbeats) stays a
                # version-0 frame with zero extra bytes
                ctx = None
                if sp.trace_id is not None:
                    ctx = wire.TraceContext(sp.trace_id, sp.span_id, True)
                self._writer.write(
                    wire.frame(
                        payload, method_id, corr, compress=self.compress,
                        trace_ctx=ctx,
                    )
                )
                await self._writer.drain()
                try:
                    if timeout is not None:
                        return await asyncio.wait_for(fut, timeout)
                    return await fut
                except asyncio.TimeoutError:
                    self._inflight.pop(corr, None)
                    raise RpcError(wire.STATUS_REQUEST_TIMEOUT, "client timeout")
        finally:
            # every exit path — success, timeout, peer-closed RpcError —
            # lands in the histogram, or an incident's latency never shows
            probes.observe_us(probes.rpc_request_hist, t0)

    async def close(self) -> None:
        # Take the writer FIRST: cancelling the read loop runs _fail_all,
        # which nulls _writer — checking it afterwards means the socket is
        # never actually closed, and the server leaks a connection handler
        # per churn (caught by the tron soak test's zero-leak assertion).
        w, self._writer = self._writer, None
        if self._read_task is not None:
            self._read_task.cancel()
            try:
                await self._read_task
            except (asyncio.CancelledError, Exception):
                pass
            self._read_task = None
        if w is not None:
            try:
                w.close()
                await w.wait_closed()
            except Exception:
                pass
        self._fail_all(TransportClosed("closed"))


class BackoffPolicy:
    """Exponential backoff with a cap (rpc/backoff_policy.h)."""

    def __init__(self, base_ms: int = 50, max_ms: int = 2000) -> None:
        self.base_ms = base_ms
        self.max_ms = max_ms
        self._fails = 0

    def next_backoff(self) -> float:
        d = min(self.max_ms, self.base_ms * (2 ** min(self._fails, 10)))
        self._fails += 1
        return d / 1000

    def reset(self) -> None:
        self._fails = 0


class ReconnectTransport:
    def __init__(
        self,
        host: str,
        port: int,
        backoff: BackoffPolicy | None = None,
        compress: bool = False,
        ssl_context=None,
    ) -> None:
        self.host = host
        self.port = port
        self._backoff = backoff or BackoffPolicy()
        self._compress = compress
        self.ssl_context = ssl_context
        self._transport: Transport | None = None
        self._lock = asyncio.Lock()
        self._next_attempt = 0.0  # monotonic deadline gating reconnects

    @property
    def connected(self) -> bool:
        return self._transport is not None and self._transport.connected

    async def get_connected(self, timeout: float | None = None) -> Transport:
        async with self._lock:
            if self._transport is not None and self._transport.connected:
                return self._transport
            # Honour the backoff window: refuse to dial again until it
            # elapses (reconnect_transport.h semantics — callers see an
            # immediate error, the peer is not hammered).
            now = asyncio.get_event_loop().time()
            if now < self._next_attempt:
                raise TransportClosed(
                    f"{self.host}:{self.port} in backoff for {self._next_attempt - now:.2f}s"
                )
            t = Transport(
                self.host, self.port, compress=self._compress,
                ssl_context=self.ssl_context,
            )
            try:
                if timeout is not None:
                    await asyncio.wait_for(t.connect(), timeout)
                else:
                    await t.connect()
            except (OSError, asyncio.TimeoutError) as e:
                delay = self._backoff.next_backoff()
                self._next_attempt = asyncio.get_event_loop().time() + delay
                raise TransportClosed(f"connect {self.host}:{self.port} failed ({e}); backoff {delay:.2f}s")
            self._backoff.reset()
            self._next_attempt = 0.0
            self._transport = t
            return t

    async def send(self, method_id: int, payload: bytes, timeout: float | None = None) -> bytes:
        t = await self.get_connected(timeout)
        return await t.send(method_id, payload, timeout=timeout)

    async def close(self) -> None:
        async with self._lock:
            if self._transport is not None:
                await self._transport.close()
                self._transport = None


class ConnectionCache:
    """node_id → ReconnectTransport (rpc/connection_cache.h)."""

    def __init__(self, n_shards: int = 1, ssl_context=None) -> None:
        self._n_shards = max(1, n_shards)
        self.ssl_context = ssl_context  # dial peers over TLS when set
        self._by_node: dict[int, ReconnectTransport] = {}
        self._addrs: dict[int, tuple[str, int]] = {}
        self._stale: list[ReconnectTransport] = []

    def shard_for(self, node_id: int) -> int:
        return jump_consistent_hash(node_id, self._n_shards)

    def register(self, node_id: int, host: str, port: int) -> None:
        self._addrs[node_id] = (host, port)
        existing = self._by_node.pop(node_id, None)
        if existing is not None:
            # register() is callable from synchronous wiring code, so defer
            # the close to the next async touch point instead of
            # fire-and-forgetting a task that may never run.
            self._stale.append(existing)

    def contains(self, node_id: int) -> bool:
        return node_id in self._addrs

    def get(self, node_id: int) -> ReconnectTransport:
        t = self._by_node.get(node_id)
        if t is None:
            host, port = self._addrs[node_id]
            t = ReconnectTransport(host, port, ssl_context=self.ssl_context)
            self._by_node[node_id] = t
        return t

    async def _drain_stale(self) -> None:
        stale, self._stale = self._stale, []
        for t in stale:
            await t.close()

    async def remove(self, node_id: int) -> None:
        self._addrs.pop(node_id, None)
        t = self._by_node.pop(node_id, None)
        if t is not None:
            await t.close()
        await self._drain_stale()

    async def close(self) -> None:
        for node_id in list(self._by_node):
            await self.remove(node_id)
        await self._drain_stale()
