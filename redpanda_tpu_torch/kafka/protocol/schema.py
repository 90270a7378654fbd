"""Declarative Kafka message schemas.

The reference generates C++ request/response structs from 64 JSON message
schemas (kafka/protocol/schemata/generator.py). Here the same information is
expressed as Python field tables interpreted at runtime: each API declares a
list of version-gated fields; ``encode``/``decode`` walk the table for a
concrete api_version, handling both classic and flexible (KIP-482 compact +
tagged-field) encodings. Messages travel as plain dicts, so handlers and the
embedded client share one representation.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from redpanda_tpu_torch.kafka.protocol.primitives import Reader, Writer


# ------------------------------------------------------------------ types
class T:
    """Scalar wire types."""

    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    UINT32 = "uint32"
    FLOAT64 = "float64"
    BOOL = "bool"
    VARINT = "varint"
    UUID = "uuid"
    STRING = "string"
    NULLABLE_STRING = "nullable_string"
    BYTES = "bytes"
    NULLABLE_BYTES = "nullable_bytes"
    # Record batches travel as NULLABLE_BYTES on the wire; kept distinct so
    # the server can route them through the batch adapter / device CRC kernel.
    RECORDS = "records"


@dataclass(frozen=True)
class Array:
    inner: object  # scalar T.* or tuple[Field, ...]
    nullable: bool = False


@dataclass(frozen=True)
class Field:
    name: str
    typ: object  # T.* | Array
    versions: tuple[int, int | None] = (0, None)  # inclusive; None = open
    default: object = None
    tag: int | None = None  # tagged field number (flexible versions only)

    def present(self, v: int) -> bool:
        lo, hi = self.versions
        return v >= lo and (hi is None or v <= hi)


def F(name, typ, min_v=0, max_v=None, default=None, tag=None) -> Field:
    return Field(name, typ, (min_v, max_v), default, tag)


@dataclass(frozen=True)
class Api:
    key: int
    name: str
    min_version: int
    max_version: int
    request: tuple[Field, ...]
    response: tuple[Field, ...]
    flexible_since: int | None = None  # first flexible version, or None

    def is_flexible(self, v: int) -> bool:
        return self.flexible_since is not None and v >= self.flexible_since


# ------------------------------------------------------------------ encode
_SCALAR_WRITERS = {
    T.INT8: Writer.int8,
    T.INT16: Writer.int16,
    T.INT32: Writer.int32,
    T.INT64: Writer.int64,
    T.UINT32: Writer.uint32,
    T.FLOAT64: Writer.float64,
    T.BOOL: Writer.boolean,
    T.VARINT: Writer.varint,
    T.UUID: Writer.uuid,
}

_SCALAR_DEFAULTS = {
    T.INT8: 0,
    T.INT16: 0,
    T.INT32: 0,
    T.INT64: 0,
    T.UINT32: 0,
    T.FLOAT64: 0.0,
    T.BOOL: False,
    T.VARINT: 0,
    T.STRING: "",
    T.NULLABLE_STRING: None,
    T.BYTES: b"",
    T.NULLABLE_BYTES: None,
    T.RECORDS: None,
    T.UUID: b"\x00" * 16,
}


def _write_value(w: Writer, typ, value, v: int, flexible: bool) -> None:
    if isinstance(typ, Array):
        if isinstance(typ.inner, tuple):
            fn = lambda wr, item: _write_struct(wr, typ.inner, item, v, flexible)
        else:
            sw = _scalar_writer_for(typ.inner, flexible)
            fn = lambda wr, item: sw(wr, item)
        if flexible:
            w.compact_array(value, fn)
        else:
            w.array(value, fn)
        return
    sw = _scalar_writer_for(typ, flexible)
    sw(w, value)


def _scalar_writer_for(typ, flexible: bool):
    if typ == T.STRING:
        return Writer.compact_string if flexible else Writer.string
    if typ == T.NULLABLE_STRING:
        return Writer.compact_nullable_string if flexible else Writer.nullable_string
    if typ == T.BYTES:
        return Writer.compact_bytes if flexible else Writer.bytes_
    if typ in (T.NULLABLE_BYTES, T.RECORDS):
        return Writer.compact_nullable_bytes if flexible else Writer.nullable_bytes
    return _SCALAR_WRITERS[typ]


def _default_for(f: Field):
    if f.default is not None:
        return f.default
    typ = f.typ
    if isinstance(typ, Array):
        return None if typ.nullable else []
    return _SCALAR_DEFAULTS[typ]


def _write_struct(w: Writer, fields: tuple[Field, ...], msg: dict, v: int, flexible: bool) -> None:
    tagged: list[Field] = []
    for f in fields:
        if not f.present(v):
            continue
        if f.tag is not None and flexible:
            tagged.append(f)
            continue
        value = msg.get(f.name, _default_for(f))
        _write_value(w, f.typ, value, v, flexible)
    if flexible:
        tf: dict[int, bytes] = {}
        for f in tagged:
            if f.name in msg and msg[f.name] != _default_for(f):
                inner = Writer()
                _write_value(inner, f.typ, msg[f.name], v, flexible)
                tf[f.tag] = inner.build()
        w.tagged_fields(tf)


# ------------------------------------------------------------------ decode
_SCALAR_READERS = {
    T.INT8: Reader.int8,
    T.INT16: Reader.int16,
    T.INT32: Reader.int32,
    T.INT64: Reader.int64,
    T.UINT32: Reader.uint32,
    T.FLOAT64: Reader.float64,
    T.BOOL: Reader.boolean,
    T.VARINT: Reader.varint,
    T.UUID: Reader.uuid,
}


def _scalar_reader_for(typ, flexible: bool):
    if typ == T.STRING:
        return Reader.compact_string if flexible else Reader.string
    if typ == T.NULLABLE_STRING:
        return Reader.compact_nullable_string if flexible else Reader.nullable_string
    if typ == T.BYTES:
        return Reader.compact_bytes if flexible else Reader.bytes_
    if typ in (T.NULLABLE_BYTES, T.RECORDS):
        return Reader.compact_nullable_bytes if flexible else Reader.nullable_bytes
    return _SCALAR_READERS[typ]


def _read_value(r: Reader, typ, v: int, flexible: bool):
    if isinstance(typ, Array):
        if isinstance(typ.inner, tuple):
            fn = lambda rd: _read_struct(rd, typ.inner, v, flexible)
        else:
            sr = _scalar_reader_for(typ.inner, flexible)
            fn = lambda rd: sr(rd)
        return r.compact_array(fn) if flexible else r.array(fn)
    return _scalar_reader_for(typ, flexible)(r)


def _read_struct(r: Reader, fields: tuple[Field, ...], v: int, flexible: bool) -> dict:
    msg: dict = {}
    tagged_by_num: dict[int, Field] = {}
    for f in fields:
        if not f.present(v):
            continue
        if f.tag is not None and flexible:
            tagged_by_num[f.tag] = f
            msg[f.name] = _default_for(f)
            continue
        msg[f.name] = _read_value(r, f.typ, v, flexible)
    if flexible:
        for tag, raw in r.tagged_fields().items():
            f = tagged_by_num.get(tag)
            if f is not None:
                msg[f.name] = _read_value(Reader(raw), f.typ, v, flexible)
            else:
                msg.setdefault("_unknown_tags", {})[tag] = raw
    return msg


# ------------------------------------------------------------------ api surface
def encode_message(api: Api, which: str, msg: dict, version: int) -> bytes:
    fields = api.request if which == "request" else api.response
    w = Writer()
    _write_struct(w, fields, msg, version, api.is_flexible(version))
    return w.build()


def decode_message(api: Api, which: str, buf, version: int) -> dict:
    fields = api.request if which == "request" else api.response
    return _read_struct(Reader(buf), fields, version, api.is_flexible(version))


# ------------------------------------------------------------------ headers
@dataclass
class RequestHeader:
    api_key: int
    api_version: int
    correlation_id: int
    client_id: str | None = None

    def encode(self, flexible: bool) -> bytes:
        w = Writer()
        w.int16(self.api_key).int16(self.api_version).int32(self.correlation_id)
        w.nullable_string(self.client_id)
        if flexible:
            w.tagged_fields()
        return w.build()

    @staticmethod
    def decode(r: Reader, flexible: bool) -> "RequestHeader":
        h = RequestHeader(r.int16(), r.int16(), r.int32(), r.nullable_string())
        if flexible:
            r.tagged_fields()
        return h


def encode_response_header(correlation_id: int, flexible: bool) -> bytes:
    w = Writer()
    w.int32(correlation_id)
    if flexible:
        w.tagged_fields()
    return w.build()
