"""Internal-RPC wire format.

Parity with the reference's 26-byte header (rpc/types.h:73-99): every payload
travels behind ``{version u8, header_checksum u32, compression u8,
payload_size u32, meta u32, correlation_id u32, payload_checksum u64}``.
The header checksum is CRC-32C over everything after the checksum field; the
payload checksum is xxhash64. ``meta`` carries the method id on requests and
an HTTP-style status (rpc/types.h:64-70) on responses. Optional zstd payload
compression mirrors compression_type (rpc/types.h:50-55).

pandascope trace propagation (no reference analogue — seastar requests
never leave their shard, ours hop brokers): a SAMPLED request may carry a
compact Dapper-style trace context ``{trace_id u64, parent_span_id u64,
flags u8}`` between the header and the payload, announced by
``version == VERSION_TRACE_CTX``. An unsampled request (tracer disabled, or
no ambient trace — heartbeats, chatter) stays version 0 and adds ZERO
bytes, so the feature costs nothing until an operator turns tracing on.
The block is deliberately outside both checksums: it is advisory
observability metadata, fixed-size, and keeping it out leaves the
version-0 header layout and its golden checksums untouched.

Upgrade contract: there is no per-connection version negotiation in this
rpc layer, so a version-1 frame requires a pandascope-aware peer — an
older reader would consume the ctx block as payload and desync the
stream. That is exactly why the header is feature-flagged rather than
always-on: ``trace_enabled`` defaults false, and the operator turns it on
only once the whole fleet runs pandascope-aware binaries (the standard
flag-gated wire-change rollout; README "Cluster observability").

(The JAX package's rpc/wire.py, copied.)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from redpanda_tpu_torch.hashing.crc32c import crc32c
from redpanda_tpu_torch.hashing.xx import xxhash64

HEADER_SIZE = 26
_PRE = struct.Struct("<B I")        # version, header_checksum
_POST = struct.Struct("<B I I I Q")  # compression, payload_size, meta, corr, payload_checksum

# version 1: a TraceContext block follows the header, ahead of the payload
VERSION_TRACE_CTX = 1
_TRACE_CTX = struct.Struct("<Q Q B")  # trace_id, parent_span_id, flags
TRACE_CTX_SIZE = _TRACE_CTX.size
_FLAG_SAMPLED = 0x01
_MASK64 = (1 << 64) - 1

COMPRESSION_NONE = 0
COMPRESSION_ZSTD = 1

# rpc::status (rpc/types.h:64-70) — well-known HTTP codes for readability.
STATUS_SUCCESS = 200
STATUS_METHOD_NOT_FOUND = 404
STATUS_REQUEST_TIMEOUT = 408
# server shed the request at dispatch (rpc inflight cap, resource_mgmt
# budget plane): retriable backpressure — the handler never ran, so the
# caller may safely resend
STATUS_BACKPRESSURE = 429
STATUS_SERVER_ERROR = 500

# Compress payloads above this size when the transport negotiated zstd.
ZSTD_MIN_SIZE = 1024


class WireError(Exception):
    pass


class TraceContext:
    """The trace context that rides a sampled request: enough for the
    receiving broker to JOIN its handler span to the submitter's trace
    (never to mint a new one). ``parent_span_id`` is the sender's rpc.send
    span, so cross-node flamegraphs can anchor the remote legs.

    A ``__slots__`` class, not a dataclass: one is decoded per sampled
    inbound request, and a frozen-dataclass construction costs ~2x (every
    field goes through object.__setattr__) — measured against the
    propagation microbench's <1%-of-an-rpc budget."""

    __slots__ = ("trace_id", "parent_span_id", "sampled")

    def __init__(
        self, trace_id: int, parent_span_id: int = 0, sampled: bool = True
    ) -> None:
        self.trace_id = trace_id
        self.parent_span_id = parent_span_id
        self.sampled = sampled

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, TraceContext)
            and self.trace_id == other.trace_id
            and self.parent_span_id == other.parent_span_id
            and self.sampled == other.sampled
        )

    def __repr__(self) -> str:
        return (
            f"TraceContext(trace_id={self.trace_id}, "
            f"parent_span_id={self.parent_span_id}, sampled={self.sampled})"
        )

    def encode(self) -> bytes:
        return _TRACE_CTX.pack(
            self.trace_id & _MASK64,
            self.parent_span_id & _MASK64,
            _FLAG_SAMPLED if self.sampled else 0,
        )

    @staticmethod
    def decode(buf: bytes) -> "TraceContext":
        if len(buf) < TRACE_CTX_SIZE:
            raise WireError(f"short trace context: {len(buf)}")
        tid, parent, flags = _TRACE_CTX.unpack_from(buf, 0)
        return TraceContext(tid, parent, bool(flags & _FLAG_SAMPLED))


@dataclass
class Header:
    version: int = 0
    compression: int = COMPRESSION_NONE
    payload_size: int = 0
    meta: int = 0
    correlation_id: int = 0
    payload_checksum: int = 0

    def _post_bytes(self) -> bytes:
        return _POST.pack(
            self.compression,
            self.payload_size,
            self.meta,
            self.correlation_id & 0xFFFFFFFF,
            self.payload_checksum,
        )

    def encode(self) -> bytes:
        post = self._post_bytes()
        return _PRE.pack(self.version, crc32c(post)) + post

    @staticmethod
    def decode(buf: bytes) -> "Header":
        if len(buf) < HEADER_SIZE:
            raise WireError(f"short header: {len(buf)}")
        version, hcrc = _PRE.unpack_from(buf, 0)
        post = buf[_PRE.size : HEADER_SIZE]
        if crc32c(post) != hcrc:
            raise WireError("header checksum mismatch")
        compression, size, meta, corr, pcrc = _POST.unpack(post)
        return Header(version, compression, size, meta, corr, pcrc)


def frame(
    payload: bytes,
    meta: int,
    correlation_id: int,
    compress: bool = False,
    trace_ctx: TraceContext | None = None,
) -> bytes:
    """Build header+payload for one message. ``trace_ctx`` (sampled
    requests only) rides between header and payload behind
    ``version == VERSION_TRACE_CTX``; ``None`` emits the classic version-0
    frame byte-for-byte — a disabled tracer adds nothing to the wire."""
    compression = COMPRESSION_NONE
    if compress and len(payload) >= ZSTD_MIN_SIZE:
        from redpanda_tpu_torch.compression.codecs import zstd_compress

        payload = zstd_compress(payload)
        compression = COMPRESSION_ZSTD
    h = Header(
        version=VERSION_TRACE_CTX if trace_ctx is not None else 0,
        compression=compression,
        payload_size=len(payload),
        meta=meta,
        correlation_id=correlation_id,
        payload_checksum=xxhash64(payload),
    )
    if trace_ctx is not None:
        return h.encode() + trace_ctx.encode() + payload
    return h.encode() + payload


async def read_message(reader) -> tuple[Header, TraceContext | None, bytes]:
    """Read one framed message off an asyncio stream: header, the optional
    trace-context block (version 1 only), and the verified/uncompressed
    payload. ONE reader for both sides of the wire — the client transport's
    response loop and the server's request loop must agree on where the
    ctx block sits or a sampled frame desyncs the stream."""
    raw = await reader.readexactly(HEADER_SIZE)
    h = Header.decode(raw)
    ctx = None
    if h.version == VERSION_TRACE_CTX:
        ctx = TraceContext.decode(await reader.readexactly(TRACE_CTX_SIZE))
    payload = await reader.readexactly(h.payload_size)
    return h, ctx, open_payload(h, payload)


def open_payload(h: Header, payload: bytes) -> bytes:
    """Verify the payload checksum and undo wire compression."""
    if xxhash64(payload) != h.payload_checksum:
        raise WireError("payload checksum mismatch")
    if h.compression == COMPRESSION_ZSTD:
        from redpanda_tpu_torch.compression.codecs import zstd_uncompress

        return zstd_uncompress(payload)
    if h.compression != COMPRESSION_NONE:
        raise WireError(f"unknown compression {h.compression}")
    return payload
