"""User map/filter transform DSL and the v1 payload transform (K3).

The spec types, the DSL and the JSON serde are the JAX package's
(ops/transforms.py) byte for byte, so deploy events are the same bytes on the
wire:

    spec = filter_field_eq("level", "error") | map_project(
        Int("ts"), Str("msg", 64))
    prog = compile_transform(spec, r_in=1024)
    out, out_len, keep = transform(prog, data, lengths)   # data: u8 [N, r_in]

``compile_transform`` validates the spec and builds, once, the descriptor the
CUDA kernel reads (csrc/payload_transform.cu). ``transform`` is that
kernel's wrapper: on a CUDA tensor it launches the kernel or raises; on a CPU
tensor it runs ``transform_plain``, the same function written in plain
PyTorch, which the tests hold to the JAX program.

Semantics notes (documented limits of v1):
- JSON matching is canonical-form (no whitespace around ':'): field
  predicates compile to substring scans for '"key":'.
- ``map_project`` emits a fixed-width binary struct per record: int fields as
  little-endian int32, string fields as uint16 length + fixed-width padded
  bytes. Records missing a projected field are dropped (keep=False).
- Output rows of dropped records are undefined (mask with ``keep``).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from redpanda_tpu_torch import kernels
from redpanda_tpu_torch.device import constants_on


# ----------------------------------------------------------------- spec types
@dataclass(frozen=True)
class Int:
    key: str


@dataclass(frozen=True)
class Str:
    key: str
    max_len: int = 64


@dataclass(frozen=True)
class Float:
    """Project a JSON number as little-endian float32 (4 bytes)."""

    key: str


@dataclass(frozen=True)
class Substr:
    """Project value[start : start+length] of a string field, padded."""

    key: str
    start: int
    length: int


@dataclass(frozen=True)
class Concat:
    """Project two string fields joined (a + b), truncated to max_len."""

    a: str
    b: str
    max_len: int = 64


@dataclass(frozen=True)
class _FilterContains:
    pattern: bytes
    negate: bool = False
    # Numeric-equality support: the byte following the match must not extend
    # the number (digit, '.', exponent char, sign), so '"code":42' does not
    # match {"code":420}.
    require_nonnum_suffix: bool = False


@dataclass(frozen=True)
class _MapProject:
    fields: tuple


@dataclass(frozen=True)
class _MapUppercase:
    pass


@dataclass(frozen=True)
class TransformSpec:
    """Filters (legacy raw-byte) and/or a predicate tree, plus one map.

    ``filters`` are v1 raw-payload substring ops (compiled to the payload
    device pipeline); ``where`` is a v2 field-anchored expression tree
    (redpanda_tpu_torch.ops.exprs) compiled to the columnar pushdown path. The
    engine picks the execution mode per spec (coproc/column_plan.py).
    """

    filters: tuple = ()
    mapper: object = None
    name: str = "identity"
    where: object = None  # exprs.Expr | None

    def __or__(self, other: "TransformSpec") -> "TransformSpec":
        if self.mapper is not None and other.mapper is not None:
            raise ValueError("only one map stage per transform")
        w = self.where
        if other.where is not None:
            from redpanda_tpu_torch.ops.exprs import And

            w = And(w, other.where) if w is not None else other.where
        return TransformSpec(
            filters=self.filters + other.filters,
            mapper=self.mapper or other.mapper,
            name=f"{self.name}|{other.name}",
            where=w,
        )

    # ------------------------------------------------------------- serde
    def to_json(self) -> str:
        """Wire form for deploy events (coproc internal topic)."""
        ops = []
        for f in self.filters:
            ops.append(
                {
                    "op": "filter_contains",
                    "pattern": f.pattern.decode("latin1"),
                    "negate": f.negate,
                    "nonnum_suffix": f.require_nonnum_suffix,
                }
            )
        if isinstance(self.mapper, _MapProject):
            fields = []
            for f in self.mapper.fields:
                if isinstance(f, Int):
                    fields.append({"kind": "int", "key": f.key})
                elif isinstance(f, Float):
                    fields.append({"kind": "float", "key": f.key})
                elif isinstance(f, Substr):
                    fields.append(
                        {"kind": "substr", "key": f.key, "start": f.start, "length": f.length}
                    )
                elif isinstance(f, Concat):
                    fields.append(
                        {"kind": "concat", "a": f.a, "b": f.b, "max_len": f.max_len}
                    )
                else:
                    fields.append({"kind": "str", "key": f.key, "max_len": f.max_len})
            ops.append({"op": "map_project", "fields": fields})
        elif isinstance(self.mapper, _MapUppercase):
            ops.append({"op": "map_uppercase"})
        doc = {"name": self.name, "ops": ops}
        if self.where is not None:
            doc["where"] = self.where.to_dict()
        return json.dumps(doc)

    @staticmethod
    def from_json(blob: str | bytes) -> "TransformSpec":
        doc = json.loads(blob)
        spec = TransformSpec(name=doc.get("name", "anon"))
        for op in doc.get("ops", []):
            kind = op["op"]
            if kind == "filter_contains":
                spec = spec | TransformSpec(
                    filters=(
                        _FilterContains(
                            op["pattern"].encode("latin1"),
                            op.get("negate", False),
                            op.get("nonnum_suffix", False),
                        ),
                    ),
                    name="",
                )
            elif kind == "map_project":
                fields = []
                for f in op["fields"]:
                    fk = f["kind"]
                    if fk == "int":
                        fields.append(Int(f["key"]))
                    elif fk == "float":
                        fields.append(Float(f["key"]))
                    elif fk == "substr":
                        fields.append(Substr(f["key"], f["start"], f["length"]))
                    elif fk == "concat":
                        fields.append(Concat(f["a"], f["b"], f["max_len"]))
                    else:
                        fields.append(Str(f["key"], f["max_len"]))
                spec = spec | TransformSpec(mapper=_MapProject(tuple(fields)), name="")
            elif kind == "map_uppercase":
                spec = spec | TransformSpec(mapper=_MapUppercase(), name="")
            else:
                raise ValueError(f"unknown transform op {kind!r}")
        w = None
        if "where" in doc:
            from redpanda_tpu_torch.ops.exprs import Expr

            w = Expr.from_dict(doc["where"])
        return TransformSpec(spec.filters, spec.mapper, doc.get("name", "anon"), w)


# ----------------------------------------------------------------- public DSL
def identity() -> TransformSpec:
    return TransformSpec(name="identity")


def filter_contains(pattern: bytes, negate: bool = False) -> TransformSpec:
    return TransformSpec(filters=(_FilterContains(bytes(pattern), negate),), name="contains")


def filter_field_eq(key: str, value) -> TransformSpec:
    """Canonical-JSON field equality: substring match of '"key":<value>'."""
    nonnum = False
    if isinstance(value, str):
        pat = f'"{key}":"{value}"'
    elif isinstance(value, bool):
        pat = f'"{key}":{"true" if value else "false"}'
    else:
        pat = f'"{key}":{value}'
        nonnum = True  # prevent prefix matches like 42 matching 420
    return TransformSpec(
        filters=(_FilterContains(pat.encode(), require_nonnum_suffix=nonnum),),
        name=f"eq:{key}",
    )


def map_project(*fields) -> TransformSpec:
    return TransformSpec(mapper=_MapProject(tuple(fields)), name="project")


def map_uppercase() -> TransformSpec:
    return TransformSpec(mapper=_MapUppercase(), name="upper")


def where(expr) -> TransformSpec:
    """v2 predicate: a field-anchored expression tree (ops.exprs).

    Compiled to the columnar pushdown path: only referenced fields cross
    the device link, the device evaluates the tree, one bit returns per
    record. Combine with ``|`` like any other stage::

        where((field("level") == "error") & (field("code") >= 500))
            | map_project(Int("code"), Str("msg", 64))
    """
    from redpanda_tpu_torch.ops.exprs import _as_expr

    return TransformSpec(where=_as_expr(expr), name="where")


def project_out_width(fields: Sequence) -> int:
    w = 0
    for f in fields:
        if isinstance(f, (Int, Float)):
            w += 4
        elif isinstance(f, Substr):
            w += 2 + f.length
        elif isinstance(f, Concat):
            w += 2 + f.max_len
        else:
            w += 2 + f.max_len
    return w



# ------------------------------------------------------------ plain version
def _first(match: torch.Tensor) -> torch.Tensor:
    """First True column of each row of ``match`` [n, w], else w."""
    w = match.shape[1]
    idx = torch.arange(w, dtype=torch.int32, device=match.device)
    return torch.where(match, idx, w).min(dim=1).values


def _find_pattern(data, lengths, pat: bytes, require_nonnum_suffix: bool = False):
    """First start index of `pat` within each row's valid prefix, else -1.

    With require_nonnum_suffix, a match is only valid when the byte after it
    is not a number-continuation character (digit, '.', 'e', 'E', '+', '-')
    or the match ends exactly at the record's length.
    """
    n, r = data.shape
    l = len(pat)
    if l == 0 or l > r:
        return torch.full((n,), -1, dtype=torch.int32, device=data.device)
    w = r - l + 1
    match = torch.ones((n, w), dtype=torch.bool, device=data.device)
    for i, byte in enumerate(pat):
        match &= data[:, i : i + w] == byte
    starts = torch.arange(w, dtype=torch.int32, device=data.device)
    match &= starts[None, :] <= (lengths - l)[:, None]
    if require_nonnum_suffix:
        # byte at start+l for each start (0 for the final start, which is
        # past the row end)
        nxt = torch.cat(
            [data[:, l:], torch.zeros((n, 1), dtype=data.dtype, device=data.device)], 1
        )
        is_num = ((nxt >= ord("0")) & (nxt <= ord("9"))) | (nxt == ord("."))
        for ch in b"eE+-":
            is_num |= nxt == ch
        at_end = (starts[None, :] + l) >= lengths[:, None]
        match &= at_end | ~is_num
    idx = _first(match)
    return torch.where(idx < w, idx, -1).to(torch.int32)


def _gather_window(data, pos, width: int):
    """data[i, pos[i] : pos[i]+width], zero-filled past the row; pos<0 -> zeros."""
    n, r = data.shape
    cols = pos[:, None] + torch.arange(width, dtype=torch.int32, device=data.device)[None, :]
    valid = (cols >= 0) & (cols < r) & (pos >= 0)[:, None]
    window = torch.gather(data, 1, cols.clamp(0, r - 1).long())
    return torch.where(valid, window, 0).to(torch.uint8)


_INT_WINDOW = 12  # sign + 9 digits + terminator fits comfortably


def _parse_int_at(data, pos):
    """Parse a decimal integer starting at pos[i]; returns (val int32, ok).

    At most 9 digits, and a non-digit terminator must appear within the
    window: longer numbers are rejected (ok=False), not truncated.
    """
    win = _gather_window(data, pos, _INT_WINDOW).to(torch.int32)
    n = win.shape[0]
    neg = win[:, 0] == ord("-")
    val = torch.zeros(n, dtype=torch.int32, device=data.device)
    ndigits = torch.zeros(n, dtype=torch.int32, device=data.device)
    seen = torch.zeros(n, dtype=torch.bool, device=data.device)
    stopped = torch.zeros(n, dtype=torch.bool, device=data.device)
    for i in range(_INT_WINDOW):
        d = win[:, i] - ord("0")
        isdig = (d >= 0) & (d <= 9)
        skip_sign = neg if i == 0 else torch.zeros_like(neg)
        stopped |= ~isdig & ~skip_sign
        active = ~stopped & isdig
        val = torch.where(active, val * 10 + d, val)
        ndigits += active.to(torch.int32)
        seen |= active
    val = torch.where(neg, -val, val)
    ok = seen & stopped & (ndigits <= 9) & (pos >= 0)
    return val, ok


def _le_bytes(v: torch.Tensor, k: int) -> torch.Tensor:
    """int32 [n] -> its k low little-endian bytes, uint8 [n, k]."""
    return torch.stack([((v >> (8 * i)) & 0xFF).to(torch.uint8) for i in range(k)], 1)


def transform_plain(prog: "TransformProgram", data, lengths):
    """The plain PyTorch version of the payload transform:
    (out u8 [N, r_out], out_len i32 [N], keep bool [N])."""
    data = data.to(torch.uint8)
    lengths = lengths.to(torch.int32)
    spec = prog.spec
    keep = lengths > 0
    for f in spec.filters:
        hit = _find_pattern(data, lengths, f.pattern, f.require_nonnum_suffix) >= 0
        keep &= ~hit if f.negate else hit
    mapper = spec.mapper
    if isinstance(mapper, _MapUppercase):
        is_lower = (data >= ord("a")) & (data <= ord("z"))
        return torch.where(is_lower, data - 32, data), lengths, keep
    if not isinstance(mapper, _MapProject):
        return data, lengths, keep
    n = data.shape[0]
    parts = []
    ok_all = torch.ones(n, dtype=torch.bool, device=data.device)
    for f in mapper.fields:
        if isinstance(f, Int):
            pat = f'"{f.key}":'.encode()
            pos = _find_pattern(data, lengths, pat)
            vpos = torch.where(pos >= 0, pos + len(pat), -1).to(torch.int32)
            val, ok = _parse_int_at(data, vpos)
            ok_all &= ok
            parts.append(_le_bytes(val, 4))
        else:
            pat = f'"{f.key}":"'.encode()
            pos = _find_pattern(data, lengths, pat)
            spos = torch.where(pos >= 0, pos + len(pat), -1).to(torch.int32)
            win = _gather_window(data, spos, f.max_len + 1)
            slen = _first(win == ord('"'))
            found_quote = slen <= f.max_len
            slen = slen.clamp(max=f.max_len)
            ok_all &= (pos >= 0) & found_quote
            idx = torch.arange(f.max_len, dtype=torch.int32, device=data.device)
            body = torch.where(idx[None, :] < slen[:, None], win[:, : f.max_len], 0)
            parts.append(torch.cat([_le_bytes(slen, 2), body.to(torch.uint8)], 1))
    out = torch.cat(parts, 1)
    keep2 = keep & ok_all
    out_len = torch.where(keep2, prog.r_out, 0).to(torch.int32)
    return out, out_len, keep2


# ------------------------------------------------------------ kernel program
MAPPER_IDENTITY, MAPPER_UPPERCASE, MAPPER_PROJECT = 0, 1, 2


class TransformProgram:
    """A payload spec compiled once, at enable time, for rows of ``r_in``
    bytes: the validated spec, the output width, and the descriptor the
    CUDA kernel reads (per-device copies made on first use)."""

    def __init__(self, spec: TransformSpec, r_in: int):
        if spec.where is not None:
            raise ValueError(
                "where-expression specs compile to the columnar path "
                "(coproc/column_plan.py), not the raw-payload pipeline"
            )
        mapper = spec.mapper
        if isinstance(mapper, _MapProject):
            if any(not isinstance(f, (Int, Str)) for f in mapper.fields):
                raise ValueError("Float/Substr/Concat projections require the columnar path")
            r_out = project_out_width(mapper.fields)
            if r_out > r_in:
                raise ValueError("projected width exceeds input width")
        else:
            r_out = r_in
        self.spec = spec
        self.r_in = int(r_in)
        self.r_out = r_out
        pats = bytearray()
        rows = []

        def pattern(p: bytes) -> tuple[int, int]:
            off = len(pats)
            pats.extend(p)
            return off, len(p)

        for f in spec.filters:
            rows.append([*pattern(f.pattern), int(f.negate), int(f.require_nonnum_suffix)])
        fields = mapper.fields if isinstance(mapper, _MapProject) else ()
        for f in fields:
            if isinstance(f, Int):
                rows.append([0, *pattern(f'"{f.key}":'.encode()), 0])
            else:
                rows.append([1, *pattern(f'"{f.key}":"'.encode()), f.max_len])
        self.n_filters = len(spec.filters)
        self.n_fields = len(fields)
        self.mapper = (
            MAPPER_PROJECT if fields
            else MAPPER_UPPERCASE if isinstance(mapper, _MapUppercase)
            else MAPPER_IDENTITY
        )
        # filter rows {pattern off, len, negate, nonnum}, then field rows
        # {kind 0 int / 1 str, pattern off, len, max_len}
        self.desc = np.asarray(rows or [[0, 0, 0, 0]], dtype=np.int32).reshape(-1, 4)
        self.patterns = np.frombuffer(bytes(pats) or b"\0", dtype=np.uint8).copy()
        self._dev: dict = {}

    def on(self, device: torch.device):
        """(desc, patterns) tensors on ``device``, uploaded once."""
        key = str(device)
        got = self._dev.get(key)
        if got is None:
            got = constants_on(device, self.desc, self.patterns)
            self._dev[key] = got
        return got


def compile_transform(spec: TransformSpec, r_in: int) -> TransformProgram:
    """Validate a payload spec and build its kernel program for rows of
    ``r_in`` bytes (the counterpart of the JAX package's jitted program)."""
    return TransformProgram(spec, r_in)


def _check_rows(t: torch.Tensor, name: str, width: int | None = None) -> None:
    if t.dtype != torch.uint8 or t.dim() != 2 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous uint8 [N, width] tensor")
    if width is not None and t.shape[1] != width:
        raise ValueError(f"{name} has width {t.shape[1]}, expected {width}")


def _check_lengths(data: torch.Tensor, lengths: torch.Tensor, r_in: int) -> None:
    _check_rows(data, "data", r_in)
    if lengths.dtype != torch.int32 or lengths.shape != (data.shape[0],) or not lengths.is_contiguous():
        raise ValueError("lengths must be a contiguous int32 [N] tensor")
    if lengths.device != data.device:
        raise ValueError("data and lengths must be on one device")


def launch_payload_kernel(prog: TransformProgram, src, lens, out, out_len, keep, mask_len: bool):
    """One launch of the payload kernel on the current stream. ``lens`` None
    reads each row's LE32 length from its meta columns at r_in and writes
    the packed meta (masked LE32 out_len, keep byte, 3 zero bytes) into
    ``out`` at r_out (counted as ``payload_transform``, K4); else lengths,
    out_len and keep are arrays (counted as ``payload_record``, K3)."""
    n = src.shape[0]
    if n == 0:
        return
    desc, pats = prog.on(src.device)
    kernel = kernels.PAYLOAD_TRANSFORM if lens is None else kernels.PAYLOAD_RECORD
    kernel.launch(
        src.data_ptr(), src.stride(0), None if lens is None else lens.data_ptr(),
        n, prog.r_in, out.data_ptr(), out.stride(0),
        None if out_len is None else out_len.data_ptr(),
        None if keep is None else keep.data_ptr(),
        prog.r_out, int(mask_len), desc.data_ptr(), prog.n_filters, prog.mapper,
        prog.n_fields, pats.data_ptr(), kernels.stream_handle(src.device),
    )


def transform(prog: TransformProgram, data: torch.Tensor, lengths: torch.Tensor):
    """The payload transform (K3) over data u8 [N, r_in] and lengths i32 [N]
    -> (out u8 [N, r_out], out_len i32 [N], keep bool [N]). CPU tensors run
    the plain version; CUDA tensors launch the kernel."""
    _check_lengths(data, lengths, prog.r_in)
    if data.device.type == "cpu":
        return transform_plain(prog, data, lengths)
    if data.device.type != "cuda":
        raise ValueError(f"unsupported device {data.device}")
    n = data.shape[0]
    out = torch.empty((n, prog.r_out), dtype=torch.uint8, device=data.device)
    out_len = torch.empty(n, dtype=torch.int32, device=data.device)
    keep = torch.empty(n, dtype=torch.bool, device=data.device)
    launch_payload_kernel(prog, data, lengths, out, out_len, keep, mask_len=False)
    return out, out_len, keep


def edge_cases(r: int, seed: int = 0) -> tuple[np.ndarray, np.ndarray, list[TransformSpec]]:
    """Hand-made rows at the payload kernel's edges for rows of r (>= 600)
    bytes, and the specs that probe them: (rows u8 [n, r], lengths i32 [n],
    specs). They are test data for the kernel and its plain version:
      - for patterns of 1, 2, 4, 6 and 9 bytes ('"code":42', whose filter
        requires a non-number after it), a match whose start is 0, 1, 31,
        32, 33, 127, 128, 129, 255, 256, 511, 512, 513 or r - l (the window
        edges of a scan of 32, of 128 and of 512 starts, and a match that
        ends at r): alone, after a
        prefix of it that breaks off, ending exactly at the length, one byte
        past the length, with a length past r, and followed by a digit --
        inside the record, as its last byte, and then again later;
      - rows of length 0 and of negative length;
      - JSON-like rows with '"code":' and '"msg":"' at those starts: numbers
        of 1 to 10 digits, signed or a lone sign, ended by ',' or by '_', 12
        digits (no terminator in the window), and strings that close at, or
        past, the projection's width.
    Bytes the rows do not set are '_' (not a number character)."""
    if r < 600:
        raise ValueError("edge rows need r >= 600")
    rng = np.random.default_rng(seed)
    starts = (0, 1, 31, 32, 33, 127, 128, 129, 255, 256, 511, 512, 513)
    pats = (b"q", b"ab", b"warn", b"needle", b'"code":42')
    rows: list[tuple[bytes, int]] = []

    def row(parts: dict[int, bytes], n: int) -> None:
        b = bytearray(b"_" * r)
        for at, p in parts.items():
            b[at : at + len(p)] = p[: max(0, r - at)]
        rows.append((bytes(b), n))

    for pat in pats:
        l = len(pat)
        for s in starts + (r - l,):
            row({s: pat}, r)  # alone (at r - l it ends at r)
            if s >= 8:
                row({s - 8: pat[:-1], s: pat}, r)  # a prefix that breaks off first
            row({s: pat, s + l: b"5"}, s + l)  # ends exactly at the length
            row({s: pat}, s + l - 1)  # one byte past the length
            row({s: pat}, r + 7)  # a length past r
            if s + l < r:
                row({s: pat, s + l: b"7"}, r)  # a digit follows
                row({s: pat, s + l: b"5"}, s + l + 1)  # the digit is the record's last byte
                later = min(s + 40, r - l)
                row({s: pat, s + l: b".", later: pat}, r)  # a number char, then a later match
    row({0: b"warn"}, 0)
    row({0: b"warn"}, -3)
    for s in starts:
        for digits in (b"7", b"-42", b"123456789", b"-123456789", b"1234567890", b"12", b"-"):
            term = b"" if digits == b"12" else b","  # "12" is ended by the '_' after it
            body = b'"code":' + digits + term
            msg = b'"msg":"' + bytes(rng.integers(97, 123, int(rng.integers(0, 20)), np.uint8))
            row({s: body, s + len(body) + 2: msg + b'"'}, r)
        row({s: b'"code":1,"msg":"' + b"x" * 16 + b'"'}, r)  # closes at the width
        row({s: b'"code":1,"msg":"' + b"x" * 17 + b'"'}, r)  # closes past it
        row({s: b'"code":000000000000,'}, r)  # twelve digits: no terminator in the window
    data = np.frombuffer(b"".join(b for b, _ in rows), np.uint8).reshape(len(rows), r).copy()
    lens = np.array([n for _, n in rows], np.int32)
    specs = [filter_contains(p) for p in pats[:4]] + [
        filter_field_eq("code", 42),
        filter_contains(b"needle", negate=True),
        filter_contains(b"ab") | map_uppercase(),
        map_project(Int("code"), Str("msg", 16)),
        filter_contains(b"_") | map_project(Str("msg", 4), Int("code")),
    ]
    return data, lens, specs
