"""Declarative binary serialization for internal RPC and disk types.

The reference walks C++ structs at compile time (reflection/adl.h,
reflection/to_tuple.h) and layers a versioned envelope on top
(serde/envelope.h). Here the same information is a field table interpreted at
runtime: ``Struct`` holds ordered (name, type) pairs; values travel as plain
dicts. Everything is little-endian, matching adl.

Envelope framing (serde/envelope.h): {version u8, compat_version u8,
size u32} then the body; readers written against an older compat version
reject newer incompatible payloads, and trailing bytes added by newer
versions are skipped using the size field.

Each type compiles once into a pair of closures (``_compile``); a Struct of
scalar leaves packs and unpacks in one ``struct.Struct`` call. The bytes are
the JAX package's rpc/serde.py's, field for field; it walks the table per
value, which at 768 raft groups on one event loop made the heartbeats'
encode and decode most of the loop's time.

(The JAX package's rpc/serde.py, with a compiled codec core.)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass


class SerdeError(Exception):
    pass


# ------------------------------------------------------------------ types
@dataclass(frozen=True)
class Scalar:
    fmt: str  # struct format char


I8 = Scalar("b")
U8 = Scalar("B")
I16 = Scalar("h")
U16 = Scalar("H")
I32 = Scalar("i")
U32 = Scalar("I")
I64 = Scalar("q")
U64 = Scalar("Q")
F64 = Scalar("d")
BOOL = Scalar("?")


class _String:
    pass


class _Bytes:
    pass


STRING = _String()
BYTES = _Bytes()


@dataclass(frozen=True)
class Vector:
    inner: object


@dataclass(frozen=True)
class Optional:
    inner: object


@dataclass(frozen=True)
class Map:
    key: object
    value: object


@dataclass(frozen=True)
class Struct:
    fields: tuple  # of (name, type)

    def encode(self, msg: dict) -> bytes:
        out: list = []
        _codec(self)[0](out, msg)
        return b"".join(out)

    def decode(self, buf: bytes) -> dict:
        return _codec(self)[1](bytes(buf), 0)[0]


def S(*fields) -> Struct:
    return Struct(tuple(fields))


@dataclass(frozen=True)
class Envelope:
    """serde::envelope-style versioned wrapper around a Struct."""

    body: Struct
    version: int = 0
    compat_version: int = 0

    def encode(self, msg: dict) -> bytes:
        inner = self.body.encode(msg)
        return _ENV.pack(self.version, self.compat_version, len(inner)) + inner

    def decode(self, buf: bytes) -> dict:
        buf = bytes(buf)
        _version, compat, size = _unpack(_ENV, buf, 0)
        if compat > self.version:
            raise SerdeError(
                f"incompatible envelope: peer compat {compat} > our version {self.version}"
            )
        return self.body.decode(_take(buf, _ENV.size, size)[0])


# ------------------------------------------------------------------ codec core
# Each type is compiled once into an (encode, decode) pair of closures:
# encode(out, value) appends the value's bytes to the list ``out``;
# decode(buf, pos) returns (value, next pos). A Struct whose fields are all
# scalars, or Structs of scalars (a raft heartbeat's metadata, a vnode), is
# one struct.Struct pack or unpack; the bytes are the field-by-field ones.
_I8 = struct.Struct("<b")
_I32 = struct.Struct("<i")
_ENV = struct.Struct("<BBI")
_MISSING = object()


def _unpack(st: struct.Struct, buf: bytes, pos: int):
    if pos + st.size > len(buf):
        raise SerdeError("short buffer")
    return st.unpack_from(buf, pos)


def _take(buf: bytes, pos: int, n: int) -> tuple[bytes, int]:
    if n < 0 or pos + n > len(buf):
        raise SerdeError(f"short buffer: want {n}")
    return buf[pos : pos + n], pos + n


def _codec(typ):
    """The type's compiled (encode, decode), built on first use and kept on
    the type object."""
    c = typ.__dict__.get("_codec") if hasattr(typ, "__dict__") else None
    if c is None:
        c = _compile(typ)
        object.__setattr__(typ, "_codec", c)
    return c


def _scalar_leaves(typ) -> str | None:
    """The struct format of a Scalar, or of a Struct whose leaves are all
    Scalars (in field order); None for anything else."""
    if isinstance(typ, Scalar):
        return typ.fmt
    if isinstance(typ, Struct):
        parts = [_scalar_leaves(ft) for _name, ft in typ.fields]
        if all(p is not None for p in parts):
            return "".join(parts)
    return None


def _flat_codec(typ: Struct, fmt: str):
    """(encode, decode) of a Struct whose leaves are all Scalars: one pack
    or unpack of ``fmt``, in code generated for the Struct's fields. A value
    that is not a dict all the way down (an object with the fields as
    attributes) takes the generic per-field walk."""
    st = struct.Struct("<" + fmt)
    temps, leaves, conds, tree = [], [], [], []

    def walk(t, expr: str, into: list) -> None:
        for name, ft in t.fields:
            if isinstance(ft, Scalar):
                into.append(f"{name!r}: a[{len(leaves)}]")
                leaves.append(f"{expr}.get({name!r}, 0)")
            else:
                tmp = f"t{len(temps)}"
                temps.append(f"{tmp} = {expr}.get({name!r}, _E) if isinstance({expr}, dict) else _E")
                conds.append(f"isinstance({tmp}, dict)")
                sub: list = []
                walk(ft, tmp, sub)
                into.append(f"{name!r}: {{{', '.join(sub)}}}")

    walk(typ, "v", tree)
    lines = ["def enc(out, v):", "    if isinstance(v, dict):"]
    lines += [f"        {t}" for t in temps]
    lines += [f"        if {' and '.join(conds) or 'True'}:",
              f"            out.append(pack({', '.join(leaves)}))",
              "            return",
              "    slow(out, v)",
              "def dec(buf, pos):",
              "    if pos + size > len(buf):",
              "        raise SerdeError('short buffer')",
              "    a = unpack_from(buf, pos)",
              f"    return {{{', '.join(tree)}}}, pos + size"]

    def slow(out, v):
        out.append(st.pack(*_leaves(typ, v)))

    env = {"pack": st.pack, "unpack_from": st.unpack_from, "size": st.size, "_E": {},
           "SerdeError": SerdeError, "slow": slow}
    exec("\n".join(lines), env)  # the names enter the code only through repr()
    return env["enc"], env["dec"]


def _leaves(typ, v) -> list:
    """A flat Struct's scalar leaves from any value, in field order, with
    the field defaults of a missing key (0, or {} for a nested Struct)."""
    out = []
    for name, ft in typ.fields:
        x = v.get(name, 0 if isinstance(ft, Scalar) else {}) if isinstance(v, dict) else getattr(v, name)
        if isinstance(ft, Scalar):
            out.append(x)
        else:
            out += _leaves(ft, x)
    return out


def _compile(typ):
    if isinstance(typ, Scalar):
        st = struct.Struct("<" + typ.fmt)

        def enc(out, v, pack=st.pack):
            out.append(pack(v))

        def dec(buf, pos, st=st):
            return _unpack(st, buf, pos)[0], pos + st.size

        return enc, dec
    if typ is STRING or typ is BYTES:
        text = typ is STRING

        def enc(out, v):
            b = v.encode() if isinstance(v, str) else bytes(v)
            out.append(_I32.pack(len(b)))
            out.append(b)

        def dec(buf, pos):
            (n,) = _unpack(_I32, buf, pos)
            b, pos = _take(buf, pos + 4, n)
            return (b.decode() if text else b), pos

        return enc, dec
    if isinstance(typ, Vector):
        ienc, idec = _codec(typ.inner)

        def enc(out, v):
            items = list(v)
            out.append(_I32.pack(len(items)))
            for item in items:
                ienc(out, item)

        def dec(buf, pos):
            (n,) = _unpack(_I32, buf, pos)
            pos += 4
            res = []
            for _ in range(n):
                item, pos = idec(buf, pos)
                res.append(item)
            return res, pos

        return enc, dec
    if isinstance(typ, Optional):
        ienc, idec = _codec(typ.inner)

        def enc(out, v):
            if v is None:
                out.append(b"\x00")
            else:
                out.append(b"\x01")
                ienc(out, v)

        def dec(buf, pos):
            (flag,) = _unpack(_I8, buf, pos)
            return idec(buf, pos + 1) if flag else (None, pos + 1)

        return enc, dec
    if isinstance(typ, Map):
        kenc, kdec = _codec(typ.key)
        venc, vdec = _codec(typ.value)

        def enc(out, v):
            items = sorted(v.items()) if isinstance(v, dict) else list(v)
            out.append(_I32.pack(len(items)))
            for k, x in items:
                kenc(out, k)
                venc(out, x)

        def dec(buf, pos):
            (n,) = _unpack(_I32, buf, pos)
            pos += 4
            res = {}
            for _ in range(n):
                k, pos = kdec(buf, pos)
                res[k], pos = vdec(buf, pos)
            return res, pos

        return enc, dec
    if isinstance(typ, Struct):
        fmt = _scalar_leaves(typ)
        if fmt is not None:
            return _flat_codec(typ, fmt)
        fields = [(name, ft, *_codec(ft)) for name, ft in typ.fields]

        def enc(out, v):
            if isinstance(v, dict):
                for name, ft, fenc, _fdec in fields:
                    x = v.get(name, _MISSING)
                    fenc(out, _default(ft) if x is _MISSING else x)
            else:
                for name, _ft, fenc, _fdec in fields:
                    fenc(out, getattr(v, name))

        def dec(buf, pos):
            d = {}
            for name, _ft, _fenc, fdec in fields:
                d[name], pos = fdec(buf, pos)
            return d, pos

        return enc, dec
    if isinstance(typ, Envelope):

        def enc(out, v):
            out.append(typ.encode(v))

        def dec(buf, pos):
            _version, compat, size = _unpack(_ENV, buf, pos)
            if compat > typ.version:
                raise SerdeError("incompatible nested envelope")
            body, pos = _take(buf, pos + _ENV.size, size)
            return typ.body.decode(body), pos

        return enc, dec
    raise SerdeError(f"unknown type {typ!r}")


def _default(typ):
    if isinstance(typ, Scalar):
        return 0
    if typ is STRING:
        return ""
    if typ is BYTES:
        return b""
    if isinstance(typ, Vector):
        return []
    if isinstance(typ, Optional):
        return None
    if isinstance(typ, Map):
        return {}
    if isinstance(typ, Struct):
        return {}
    return None
