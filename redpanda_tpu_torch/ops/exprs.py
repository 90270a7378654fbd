"""Predicate-expression DSL v2: field-anchored transforms for the engine.

The reference accepts arbitrary user JS per record
(src/js/modules/public/SimpleTransform.ts:18, Coprocessor.apply()); v1 of our
DSL covered five fixed ops. v2 closes most of the expressiveness gap with a
composable expression tree over *parsed JSON fields*:

    spec = where(
        (field("meta.level") == "error") & (field("code") >= 500)
        | ~field("retriable").exists()
    ) | map_project(Int("code"), Str("msg", 64), Substr("msg", 4, 8))

A field-anchored expression compiles into a *column plan*: the native
columnarizer (native/redpanda_native.cc rp_extract_*) extracts just the
referenced fields — a few bytes per record — the device evaluates the whole
predicate tree over those columns, and one bit per record comes back: a
predicate pushdown at the host<->device boundary.

Comparison semantics (the host oracle `host_eval` is the normative spec and
the parity target for the device program):

- All comparisons require field presence: a missing field makes any
  comparison False (including ``!=``). Use ``field(p).exists()`` to test
  presence.
- Nested paths are dot-separated object traversal; a path step through a
  non-object yields missing.
- String equality compares the *raw JSON bytes* of the value (no escape
  processing, mirroring v1's canonical-form matching); values longer than
  the compiled width compare unequal via their true length.
- Numeric comparisons: values that are integral and fit int32 compare
  exactly; everything else compares at float32 precision (the device
  columns are f32). Booleans compare as 1/0 only against boolean
  constants; null only matches ``== None``.
- ``str_contains`` scans the first ``w`` bytes of the value (default 64).

The port's copy of the JAX package's ops/exprs.py, without change to the
semantics: the columnar kernel (csrc/predicate.cu) and its plain version
(coproc/column_plan.py) are held to this oracle.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

# Flag bits emitted by the numeric extractor (keep in sync with
# native/redpanda_native.cc rp_extract_num and tests/test_native.py).
F_PRESENT = 1
F_NUMBER = 2
F_INT_EXACT = 4
F_BOOL = 8
F_NULL = 16

_OPS = ("eq", "ne", "lt", "le", "gt", "ge")


class Expr:
    """Base predicate node. Combine with ``&``, ``|``, ``~``."""

    def __and__(self, other: "Expr") -> "Expr":
        return And(self, _as_expr(other))

    def __or__(self, other: "Expr") -> "Expr":
        return Or(self, _as_expr(other))

    def __invert__(self) -> "Expr":
        return Not(self)

    # serde ---------------------------------------------------------------
    def to_dict(self) -> dict:
        raise NotImplementedError

    @staticmethod
    def from_dict(d: dict) -> "Expr":
        k = d["k"]
        if k == "cmp":
            v = d["v"]
            if d.get("vt") == "bytes":
                v = v.encode("latin1")
            return Cmp(d["p"], d["op"], v)
        if k == "exists":
            return Exists(d["p"])
        if k == "contains":
            return StrContains(d["p"], d["n"].encode("latin1"), d.get("w", 64))
        if k == "and":
            return And(Expr.from_dict(d["a"]), Expr.from_dict(d["b"]))
        if k == "or":
            return Or(Expr.from_dict(d["a"]), Expr.from_dict(d["b"]))
        if k == "not":
            return Not(Expr.from_dict(d["a"]))
        raise ValueError(f"unknown expr node {k!r}")


def _as_expr(x) -> Expr:
    if not isinstance(x, Expr):
        raise TypeError(f"expected Expr, got {type(x).__name__}")
    return x


@dataclass(frozen=True, eq=True)
class Cmp(Expr):
    path: str
    op: str  # eq ne lt le gt ge
    value: Any  # str | bytes | int | float | bool | None

    def __post_init__(self):
        if self.op not in _OPS:
            raise ValueError(f"bad op {self.op!r}")
        if isinstance(self.value, (str, bytes, bool)) or self.value is None:
            if self.op not in ("eq", "ne"):
                raise ValueError(f"op {self.op!r} needs a numeric constant")

    def to_dict(self) -> dict:
        v = self.value
        d = {"k": "cmp", "p": self.path, "op": self.op, "v": v}
        if isinstance(v, bytes):
            d["v"] = v.decode("latin1")
            d["vt"] = "bytes"
        return d


@dataclass(frozen=True, eq=True)
class Exists(Expr):
    path: str

    def to_dict(self) -> dict:
        return {"k": "exists", "p": self.path}


@dataclass(frozen=True, eq=True)
class StrContains(Expr):
    path: str
    needle: bytes
    window: int = 64  # scan width over the value's leading bytes

    def to_dict(self) -> dict:
        return {
            "k": "contains",
            "p": self.path,
            "n": self.needle.decode("latin1"),
            "w": self.window,
        }


@dataclass(frozen=True, eq=True)
class And(Expr):
    a: Expr
    b: Expr

    def to_dict(self) -> dict:
        return {"k": "and", "a": self.a.to_dict(), "b": self.b.to_dict()}


@dataclass(frozen=True, eq=True)
class Or(Expr):
    a: Expr
    b: Expr

    def to_dict(self) -> dict:
        return {"k": "or", "a": self.a.to_dict(), "b": self.b.to_dict()}


@dataclass(frozen=True, eq=True)
class Not(Expr):
    a: Expr

    def to_dict(self) -> dict:
        return {"k": "not", "a": self.a.to_dict()}


class FieldRef:
    """Comparison builder: ``field("a.b") >= 5`` -> :class:`Cmp`."""

    __slots__ = ("path",)

    def __init__(self, path: str):
        if not path or path.startswith(".") or path.endswith(".") or ".." in path:
            raise ValueError(f"bad field path {path!r}")
        self.path = path

    def __eq__(self, other):  # type: ignore[override]
        return Cmp(self.path, "eq", other)

    def __ne__(self, other):  # type: ignore[override]
        return Cmp(self.path, "ne", other)

    def __lt__(self, other):
        return Cmp(self.path, "lt", other)

    def __le__(self, other):
        return Cmp(self.path, "le", other)

    def __gt__(self, other):
        return Cmp(self.path, "gt", other)

    def __ge__(self, other):
        return Cmp(self.path, "ge", other)

    def __hash__(self):
        return hash(("fieldref", self.path))

    def exists(self) -> Exists:
        return Exists(self.path)

    def contains(self, needle: bytes | str, window: int = 64) -> StrContains:
        if isinstance(needle, str):
            needle = needle.encode()
        return StrContains(self.path, bytes(needle), window)


def field(path: str) -> FieldRef:
    return FieldRef(path)


# --------------------------------------------------------------------------
# Host oracle: the normative semantics, evaluated per record on raw bytes.
# Used by parity tests against the device program and as the engine's
# host-mode fallback evaluator. Mirrors the native extractor exactly
# (raw-bytes strings, f32/i32 numeric lattice).
# --------------------------------------------------------------------------


def _skip_ws(s: bytes, i: int, end: int) -> int:
    while i < end and s[i] in b" \t\n\r":
        i += 1
    return i


def _skip_string(s: bytes, i: int, end: int) -> int:
    """i points at the opening quote; returns index after the closing quote."""
    i += 1
    while i < end:
        c = s[i]
        if c == 0x5C:  # backslash
            i += 2
            continue
        if c == 0x22:  # quote
            return i + 1
        i += 1
    return end


def _skip_value(s: bytes, i: int, end: int) -> int:
    i = _skip_ws(s, i, end)
    if i >= end:
        return end
    c = s[i]
    if c == 0x22:
        return _skip_string(s, i, end)
    if c in (0x7B, 0x5B):  # { [
        depth = 0
        while i < end:
            c = s[i]
            if c == 0x22:
                i = _skip_string(s, i, end)
                continue
            if c in (0x7B, 0x5B):
                depth += 1
            elif c in (0x7D, 0x5D):
                depth -= 1
                if depth == 0:
                    return i + 1
            i += 1
        return end
    # number / literal
    while i < end and s[i] not in b",}] \t\n\r":
        i += 1
    return i


def json_find(s: bytes, path: str) -> tuple[int, int, int]:
    """Locate `path` in the JSON object `s`.

    Returns (type, value_start, value_end) where type is:
    0 missing, 1 string (extent excludes the quotes, raw escaped bytes),
    2 number, 3 true, 4 false, 5 null, 6 object, 7 array.
    Must match native rp_json_find (redpanda_native.cc) byte for byte.
    """
    segs = path.split(".")
    i, end = 0, len(s)
    for depth, seg in enumerate(segs):
        want = seg.encode()
        i = _skip_ws(s, i, end)
        if i >= end or s[i] != 0x7B:  # not an object
            return 0, 0, 0
        i += 1
        found = False
        while True:
            i = _skip_ws(s, i, end)
            if i >= end or s[i] == 0x7D:
                return 0, 0, 0
            if s[i] != 0x22:
                return 0, 0, 0  # malformed
            kstart = i + 1
            i = _skip_string(s, i, end)
            kend = i - 1
            i = _skip_ws(s, i, end)
            if i >= end or s[i] != 0x3A:  # ':'
                return 0, 0, 0
            i += 1
            i = _skip_ws(s, i, end)
            if s[kstart:kend] == want:
                found = True
                break
            i = _skip_value(s, i, end)
            i = _skip_ws(s, i, end)
            if i < end and s[i] == 0x2C:  # ','
                i += 1
        if not found:
            return 0, 0, 0
        if depth == len(segs) - 1:
            if i >= end:
                return 0, 0, 0
            c = s[i]
            if c == 0x22:
                j = _skip_string(s, i, end)
                return 1, i + 1, j - 1
            if c == 0x7B:
                return 6, i, _skip_value(s, i, end)
            if c == 0x5B:
                return 7, i, _skip_value(s, i, end)
            j = _skip_value(s, i, end)
            tok = s[i:j]
            if tok == b"true":
                return 3, i, j
            if tok == b"false":
                return 4, i, j
            if tok == b"null":
                return 5, i, j
            return 2, i, j
        # descend: value must be an object
        # (leave i at the value start; next loop iteration checks '{')
    return 0, 0, 0


def _num_lattice(tok: bytes) -> tuple[float, int, int]:
    """(f32val, i32val, flags) for a JSON number token; mirrors native
    rp_extract_num exactly (strtod-style: no '_' separators; a malformed
    token is PRESENT but not a NUMBER)."""
    import math

    import numpy as np

    try:
        # Native-parity grammar: decimal-number characters only (float()
        # would also take 'inf'/'nan'/'_', strtod would take hex — both are
        # PRESENT-only on both paths), and tokens too long for the native
        # 48-byte parse buffer stay PRESENT-only too.
        if len(tok) >= 48 or not tok or any(
            c not in b"0123456789-+.eE" for c in tok
        ):
            raise ValueError(tok)
        d = float(tok)
    except ValueError:
        return 0.0, 0, F_PRESENT
    flags = F_PRESENT | F_NUMBER
    i32 = 0
    if math.isfinite(d) and d == int(d) and -(2**31) <= int(d) <= 2**31 - 1:
        flags |= F_INT_EXACT
        i32 = int(d)
    with np.errstate(over="ignore"):  # |d| > f32 max -> inf, same as the C cast
        f32 = float(np.float32(d))
    return f32, i32, flags


def host_field(s: bytes, path: str) -> dict:
    """Extract one field the way the columnarizer does: raw bytes + lattice."""
    t, vs, ve = json_find(s, path)
    out = {"type": t, "raw": s[vs:ve] if t else b""}
    if t == 2:
        f32, i32, flags = _num_lattice(s[vs:ve])
        out.update(f32=f32, i32=i32, flags=flags)
    elif t == 3:
        out.update(f32=1.0, i32=1, flags=F_PRESENT | F_BOOL)
    elif t == 4:
        out.update(f32=0.0, i32=0, flags=F_PRESENT | F_BOOL)
    elif t == 5:
        out.update(f32=0.0, i32=0, flags=F_PRESENT | F_NULL)
    else:
        out.update(f32=0.0, i32=0, flags=F_PRESENT if t else 0)
    return out


def _cmp_num(op: str, a, b) -> bool:
    if op == "eq":
        return a == b
    if op == "ne":
        return a != b
    if op == "lt":
        return a < b
    if op == "le":
        return a <= b
    if op == "gt":
        return a > b
    return a >= b


def host_eval(expr: Expr, value: bytes) -> bool:
    """Evaluate `expr` against one record value (normative semantics)."""
    import numpy as np

    if isinstance(expr, And):
        return host_eval(expr.a, value) and host_eval(expr.b, value)
    if isinstance(expr, Or):
        return host_eval(expr.a, value) or host_eval(expr.b, value)
    if isinstance(expr, Not):
        return not host_eval(expr.a, value)
    if isinstance(expr, Exists):
        return json_find(value, expr.path)[0] != 0
    if isinstance(expr, StrContains):
        f = host_field(value, expr.path)
        if f["type"] != 1:
            return False
        return expr.needle in f["raw"][: expr.window]
    assert isinstance(expr, Cmp)
    f = host_field(value, expr.path)
    v = expr.value
    if f["type"] == 0:
        return False
    if isinstance(v, (str, bytes)):
        if f["type"] != 1:
            return False
        raw = v.encode() if isinstance(v, str) else bytes(v)
        eq = f["raw"] == raw
        return eq if expr.op == "eq" else not eq
    if isinstance(v, bool):
        if not (f["flags"] & F_BOOL):
            return False
        eq = f["i32"] == (1 if v else 0)
        return eq if expr.op == "eq" else not eq
    if v is None:
        isnull = bool(f["flags"] & F_NULL)
        return isnull if expr.op == "eq" else (f["type"] != 0 and not isnull)
    # numeric constant
    if not (f["flags"] & F_NUMBER) and not (f["flags"] & F_BOOL):
        return False
    if f["flags"] & F_BOOL:
        return False  # booleans only compare to booleans
    const_int = isinstance(v, int) or (float(v) == int(v) and -(2**31) <= int(v) <= 2**31 - 1)
    if const_int and not -(2**31) <= int(v) <= 2**31 - 1:
        const_int = False
    if const_int and (f["flags"] & F_INT_EXACT):
        return _cmp_num(expr.op, f["i32"], int(v))
    return _cmp_num(expr.op, np.float32(f["f32"]), np.float32(float(v)))


def expr_paths(expr: Expr) -> list[str]:
    """All field paths referenced by the tree (deduped, in first-use order)."""
    out: list[str] = []

    def walk(e: Expr):
        if isinstance(e, (And, Or)):
            walk(e.a)
            walk(e.b)
        elif isinstance(e, Not):
            walk(e.a)
        else:
            p = e.path  # type: ignore[attr-defined]
            if p not in out:
                out.append(p)

    walk(expr)
    return out
