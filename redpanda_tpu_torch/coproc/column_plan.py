"""Execution planning for transform specs: columnar / payload / host.

- **columnar** (v2 ``where`` expression specs): the native columnarizer
  (native/redpanda_native.cc rp_extract_*) turns each referenced field into
  a fixed-width column -- a few bytes per record. The device evaluates the
  whole predicate tree over the columns and returns ONE BIT per record
  (bit-packed, so the device-to-host copy is n/8 bytes). Projections are
  assembled on the host from columns the host already extracted.
- **payload** (v1 raw-byte specs): full rows are staged to the device and
  run through the payload kernel (ops/pipeline.py).
- **host** (identity, pure uppercase): no device stage exists; the engine's
  host stage runs them with the same interface and semantics.

`plan_spec` is the single decision point. A columnar plan compiles its
expression tree, once, into the flat postfix program the predicate kernel
(csrc/predicate.cu) interprets; ``predicate`` is that kernel's wrapper, and
``predicate_plain`` is the same function in plain PyTorch (the JAX
package's ``_build_expr`` / ``_contains`` / ``_packbits``). Extraction and
assembly are the JAX package's, over the port's own binding of the same
native library.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from redpanda_tpu_torch import kernels, native
from redpanda_tpu_torch.ops import exprs as E
from redpanda_tpu_torch.ops.transforms import (
    Concat,
    Float,
    Int,
    Str,
    Substr,
    TransformSpec,
    _MapProject,
    _MapUppercase,
    project_out_width,
)

_INT9 = 999_999_999  # v1 projection rule: ints limited to 9 digits


# ------------------------------------------------------------------ columns
@dataclass(frozen=True)
class DevCol:
    """One device input column; kind in {str, num, exists}."""

    kind: str
    path: str
    w: int = 0  # str byte width (merged across uses)


# input arrays contributed per DevCol kind: str -> (bytes, vlen),
# num -> (f32, i32, flags), exists -> (present,)
_COL_ARITY = {"str": 2, "num": 3, "exists": 1}


class FindCache:
    """The span tables of the fused explode + find pass (one native JSON
    walk per record for every single-segment path a plan references) --
    the extractors gather from these tables instead of re-walking the
    record per field."""

    def __init__(self, lib, joined, offsets, paths: list[str], types, vs, ve):
        self._lib = lib
        self._joined = joined
        self._offsets = np.ascontiguousarray(offsets, dtype=np.int64)
        self.col = {p: i for i, p in enumerate(paths)}
        self.types, self.vs, self.ve = types, vs, ve

    def gather_str(self, path: str, w: int):
        i = self.col[path]
        return self._lib.gather_str(
            self._joined, self._offsets, self.types[:, i], self.vs[:, i], self.ve[:, i], w
        )

    def gather_num(self, path: str):
        i = self.col[path]
        return self._lib.gather_num(
            self._joined, self._offsets, self.types[:, i], self.vs[:, i], self.ve[:, i]
        )

    def gather_exists(self, path: str):
        return (self.types[:, self.col[path]] != 0).astype(np.uint8)


# ------------------------------------------------------------------ program
OP_EXISTS, OP_STR_EQ, OP_CONTAINS, OP_BOOL, OP_NULL, OP_NUM, OP_AND, OP_OR, OP_NOT = range(1, 10)
_CMP = {"eq": 0, "ne": 1, "lt": 2, "le": 3, "gt": 4, "ge": 5}
MAX_COL_ARRAYS = 64  # csrc/predicate.cu kMaxCols: pointers passed by value


class PredicateProgram:
    """An expression tree flattened, once, to the predicate kernel's
    postfix program: ``code`` int32 [n_ops, 8], ``needles`` uint8, and the
    stack ``depth`` the program reaches. Device copies are made on first use
    per device and kept."""

    def __init__(self, code: np.ndarray, needles: bytes, depth: int):
        self.code = code
        self.needles = np.frombuffer(needles or b"\0", dtype=np.uint8).copy()
        self.depth = depth
        self._dev: dict = {}

    def on(self, device: torch.device):
        key = str(device)
        got = self._dev.get(key)
        if got is None:
            got = (
                torch.from_numpy(self.code).to(device),
                torch.from_numpy(self.needles).to(device),
            )
            self._dev[key] = got
        return got


def compile_predicate(expr, dev_cols: list[DevCol]) -> PredicateProgram:
    """Flatten ``expr`` to postfix over the arrays of ``dev_cols`` in their
    _bind_slots order (str -> bytes, vlen; num -> f32, i32, flags;
    exists -> present)."""
    base: dict = {}
    k = 0
    for c in dev_cols:
        base[(c.kind, c.path)] = k
        k += _COL_ARITY[c.kind]
    if k > MAX_COL_ARRAYS:
        raise ValueError(
            f"predicate reads {k} column arrays; the kernel takes at most {MAX_COL_ARRAYS}"
        )
    str_w = {c.path: c.w for c in dev_cols if c.kind == "str"}
    consts = _prepare_cmp_consts(expr)
    code: list[list[int]] = []
    needles = bytearray()
    depth = sp = 0

    def emit(ins: list[int], pops: int) -> None:
        nonlocal sp, depth
        code.append(ins + [0] * (8 - len(ins)))
        sp += 1 - pops
        depth = max(depth, sp)

    def needle(raw: bytes) -> int:
        off = len(needles)
        needles.extend(raw)
        return off

    def walk(e) -> None:
        if isinstance(e, (E.And, E.Or)):
            walk(e.a)
            walk(e.b)
            emit([OP_AND if isinstance(e, E.And) else OP_OR], 2)
        elif isinstance(e, E.Not):
            walk(e.a)
            emit([OP_NOT], 1)
        elif isinstance(e, E.Exists):
            emit([OP_EXISTS, base[("exists", e.path)]], 0)
        elif isinstance(e, E.StrContains):
            b = base[("str", e.path)]
            emit([OP_CONTAINS, b, b + 1, str_w[e.path], needle(e.needle),
                  len(e.needle), e.window], 0)
        else:
            v = e.value
            if isinstance(v, (str, bytes)):
                raw = v.encode() if isinstance(v, str) else bytes(v)
                b = base[("str", e.path)]
                emit([OP_STR_EQ, b, b + 1, str_w[e.path], needle(raw), len(raw),
                      int(e.op == "ne")], 0)
                return
            b = base[("num", e.path)]
            if isinstance(v, bool):
                emit([OP_BOOL, b + 1, b + 2, int(v), 0, 0, int(e.op == "ne")], 0)
            elif v is None:
                emit([OP_NULL, b + 2, 0, 0, 0, 0, int(e.op == "ne")], 0)
            else:
                f32c, i32c = consts[id(e)]
                bits = int(np.float32(f32c).view(np.int32))
                emit([OP_NUM, b, b + 1, b + 2, _CMP[e.op], bits,
                      int(i32c is not None), int(i32c or 0)], 0)

    walk(expr)
    return PredicateProgram(
        np.asarray(code, dtype=np.int32).reshape(-1, 8), bytes(needles), depth
    )


# ------------------------------------------------------------------ plans
@dataclass
class ColumnarPlan:
    spec: TransformSpec
    dev_cols: list[DevCol]
    proj: tuple  # projection fields (may be empty -> passthrough)
    r_out: int
    passthrough: bool  # no projection: output = input value bytes
    program: PredicateProgram = dc_field(init=False, repr=False)

    mode = "columnar"

    def __post_init__(self):
        # compiled once per plan, at enable time: a launch only binds columns
        self.program = compile_predicate(self.spec.where, self.dev_cols)

    def flat_paths(self) -> list[str]:
        """Distinct TOP-LEVEL (single-segment) paths the plan references;
        nested paths keep the per-path walker."""
        seen: dict[str, None] = {}
        for c in self.dev_cols:
            seen.setdefault(c.path)
        for f in self.proj:
            if isinstance(f, Concat):
                seen.setdefault(f.a)
                seen.setdefault(f.b)
            else:
                seen.setdefault(f.key)
        return [p for p in seen if "." not in p]

    def make_cache_from_tables(self, exploded, paths, types, vs, ve) -> FindCache:
        """Adopt the span tables the fused explode_find pass produced;
        ``paths`` must be the exact list that call used."""
        return FindCache(native.lib(), exploded.joined, exploded.offsets, paths, types, vs, ve)

    def _bind_slots(self, arrays) -> dict:
        """Ordered input arrays -> {(kind, path): arrays}; the one place that
        knows the per-kind arity (str=2, num=3, exists=1)."""
        slots = {}
        k = 0
        for c in self.dev_cols:
            arity = _COL_ARITY[c.kind]
            slots[(c.kind, c.path)] = arrays[k] if arity == 1 else tuple(arrays[k : k + arity])
            k += arity
        return slots

    # ------------------------------------------------------------ predicate
    def predicate(self, arrays: list[torch.Tensor]) -> torch.Tensor:
        """The predicate kernel's wrapper: the ordered column tensors ->
        packed keep bits uint8 [n_pad/8], MSB-first. CPU tensors run
        ``predicate_plain``; CUDA tensors launch the kernel."""
        n_pad = self._check_arrays(arrays)
        device = arrays[0].device
        if device.type == "cpu":
            return predicate_plain(self, arrays)
        if device.type != "cuda":
            raise ValueError(f"unsupported device {device}")
        prog = self.program
        code, needles = prog.on(device)
        out = torch.empty(n_pad // 8, dtype=torch.uint8, device=device)
        words = (prog.depth + 63) // 64 - 1
        scratch = (
            torch.empty((words, n_pad), dtype=torch.int64, device=device) if words > 0 else None
        )
        ptrs = (ctypes.c_void_p * len(arrays))(*[a.data_ptr() for a in arrays])
        kernels.PREDICATE.launch(
            ptrs, len(arrays), code.data_ptr(), code.shape[0], needles.data_ptr(), n_pad,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            kernels.stream_handle(device),
        )
        return out

    def _check_arrays(self, arrays) -> int:
        kinds = []
        for c in self.dev_cols:
            if c.kind == "str":
                kinds += [(torch.uint8, c.w), (torch.int32, None)]
            elif c.kind == "num":
                kinds += [(torch.float32, None), (torch.int32, None), (torch.uint8, None)]
            else:
                kinds.append((torch.uint8, None))
        if len(arrays) != len(kinds) or not arrays:
            raise ValueError(f"predicate takes {len(kinds)} column arrays, got {len(arrays)}")
        n_pad = arrays[0].shape[0]
        if n_pad % 8:
            raise ValueError(f"row count {n_pad} is not a multiple of 8")
        device = arrays[0].device
        for a, (dtype, w) in zip(arrays, kinds):
            shape = (n_pad,) if w is None else (n_pad, w)
            if a.dtype != dtype or tuple(a.shape) != shape or not a.is_contiguous():
                raise ValueError(
                    f"column {tuple(a.shape)} {a.dtype}: expected contiguous {shape} {dtype}"
                )
            if a.device != device:
                raise ValueError("predicate columns must all be on one device")
        return n_pad

    # ------------------------------------------------------------ host side
    def extract_device_inputs(self, joined, offsets, sizes, n_pad: int, cache=None):
        """Native pass over the records -> ordered device input arrays."""
        out = []
        for c in self.dev_cols:
            if c.kind == "str":
                out += _extract_str(joined, offsets, sizes, c.path, c.w, n_pad, cache)
            elif c.kind == "num":
                out += _extract_num(joined, offsets, sizes, c.path, n_pad, cache)
            else:
                out.append(_extract_exists(joined, offsets, sizes, c.path, n_pad, cache))
        return out

    def extract_projection(self, joined, offsets, sizes, cache=None):
        """Host-side projection columns -> (per-field data, ok mask [n]).

        Fast path: when every projection field is Int/Float/Str over a
        cached span column, ONE native pass (rp_project_rows) gathers all
        fields straight into the packed output rows. Substr/Concat/nested
        paths keep the general path."""
        n = len(sizes)
        descs = self._proj_desc_rows(cache.col) if cache is not None else None
        if descs is not None and n:
            rows, ok = native.lib().project_rows(
                joined, offsets, cache.types, cache.vs, cache.ve,
                np.asarray(descs, dtype=np.int32), self.r_out,
            )
            return [("rows", rows)], ok
        ok = np.ones(n, dtype=bool)
        data = []
        for f in self.proj:
            if isinstance(f, Int):
                _, i32, fl = _extract_num(joined, offsets, sizes, f.key, n, cache)
                want = E.F_PRESENT | E.F_NUMBER | E.F_INT_EXACT
                ok &= ((fl & want) == want) & (np.abs(i32.astype(np.int64)) <= _INT9)
                data.append(("int", i32))
            elif isinstance(f, Float):
                f32, _, fl = _extract_num(joined, offsets, sizes, f.key, n, cache)
                ok &= (fl & (E.F_PRESENT | E.F_NUMBER)) == (E.F_PRESENT | E.F_NUMBER)
                data.append(("float", f32))
            elif isinstance(f, Substr):
                b, v = _extract_str(joined, offsets, sizes, f.key, f.start + f.length, n, cache)
                ok &= v >= 0
                body = b[:, f.start : f.start + f.length]
                slen = np.clip(v - f.start, 0, f.length).astype(np.int32)
                data.append(("str", body, slen, f.length))
            elif isinstance(f, Concat):
                ba, va = _extract_str(joined, offsets, sizes, f.a, f.max_len, n, cache)
                bb, vb = _extract_str(joined, offsets, sizes, f.b, f.max_len, n, cache)
                ok &= (va >= 0) & (vb >= 0)
                data.append(("concat", ba, va, bb, vb, f.max_len))
            else:  # Str
                b, v = _extract_str(joined, offsets, sizes, f.key, f.max_len, n, cache)
                ok &= (v >= 0) & (v <= f.max_len)
                data.append(("str", b, np.clip(v, 0, f.max_len), f.max_len))
        return data, ok

    def _proj_desc_rows(self, col_of: dict) -> list | None:
        """[{kind, span col, w, out off}] rows for the fused projector, or
        None when any field needs the general path (Substr/Concat/nested).
        Field order and widths mirror assemble_rows' layout walk."""
        descs = []
        off = 0
        for f in self.proj:
            if isinstance(f, Int) and f.key in col_of:
                descs.append((0, col_of[f.key], 0, off))
                off += 4
            elif isinstance(f, Float) and f.key in col_of:
                descs.append((1, col_of[f.key], 0, off))
                off += 4
            elif type(f) is Str and f.key in col_of:
                descs.append((2, col_of[f.key], f.max_len, off))
                off += 2 + f.max_len
            else:
                return None
        return descs

    def assemble_rows(self, data, n: int) -> tuple[np.ndarray, np.ndarray]:
        """Projection columns -> ([n, r_out] u8 rows, [n] i32 lens)."""
        lens = np.full(n, self.r_out, dtype=np.int32)
        if len(data) == 1 and data[0][0] == "rows":
            # the fused projector already packed the rows at extract time
            return data[0][1], lens
        rows = np.zeros((n, self.r_out), dtype=np.uint8)
        off = 0
        for item in data:
            kind = item[0]
            if kind in ("int", "float"):
                rows[:, off : off + 4] = np.ascontiguousarray(item[1]).view(np.uint8).reshape(n, 4)
                off += 4
            elif kind == "str":
                _, body, slen, w = item
                rows[:, off] = slen & 0xFF
                rows[:, off + 1] = (slen >> 8) & 0xFF
                mask = np.arange(w, dtype=np.int32)[None, :] < slen[:, None]
                rows[:, off + 2 : off + 2 + w] = np.where(mask, body, 0)
                off += 2 + w
            else:  # concat
                _, ba, va, bb, vb, w = item
                alen = np.clip(va, 0, w).astype(np.int32)
                blen = np.clip(vb, 0, np.maximum(w - alen, 0)).astype(np.int32)
                total = alen + blen
                rows[:, off] = total & 0xFF
                rows[:, off + 1] = (total >> 8) & 0xFF
                idx = np.arange(w, dtype=np.int32)[None, :]
                in_a = idx < alen[:, None]
                from_b = idx - alen[:, None]
                in_b = ~in_a & (from_b < blen[:, None])
                a_part = np.where(in_a, ba[:, :w], 0)
                b_idx = np.clip(from_b, 0, w - 1)
                b_part = np.where(in_b, np.take_along_axis(bb[:, :w], b_idx, axis=1), 0)
                rows[:, off + 2 : off + 2 + w] = a_part | b_part
                off += 2 + w
        return rows, lens


@dataclass
class PayloadPlan:
    spec: TransformSpec
    mode = "payload"


@dataclass
class HostPlan:
    """No device stage: identity / pure uppercase."""

    spec: TransformSpec
    kind: str  # identity | uppercase
    mode = "host"


def plan_spec(spec: TransformSpec):
    """Pick the execution mode for a spec (see module docs)."""
    if spec.where is not None:
        if spec.filters:
            raise ValueError("where-exprs cannot combine with raw filters")
        if isinstance(spec.mapper, _MapUppercase):
            raise ValueError("uppercase is a raw-byte map; use payload specs")
        proj = spec.mapper.fields if isinstance(spec.mapper, _MapProject) else ()
        cols = _collect_dev_cols(spec.where)
        r_out = project_out_width(proj) if proj else 0
        return ColumnarPlan(spec, cols, tuple(proj), r_out, passthrough=not proj)
    if spec.filters:
        return PayloadPlan(spec)
    if isinstance(spec.mapper, _MapUppercase):
        return HostPlan(spec, "uppercase")
    if isinstance(spec.mapper, _MapProject):
        # a v1 projection-only spec keeps the v1 payload pipeline: its Int
        # semantics differ from columnar (v1 _parse_int_at truncates "3.5"
        # to 3; columnar requires an exact integer)
        return PayloadPlan(spec)
    return HostPlan(spec, "identity")


# ------------------------------------------------------------------ internals
def _collect_dev_cols(expr) -> list[DevCol]:
    cols: dict[tuple, DevCol] = {}

    def need(kind: str, path: str, w: int = 0):
        k = (kind, path)
        if k not in cols or (kind == "str" and w > cols[k].w):
            cols[k] = DevCol(kind, path, w)

    def walk(e):
        if isinstance(e, (E.And, E.Or)):
            walk(e.a)
            walk(e.b)
        elif isinstance(e, E.Not):
            walk(e.a)
        elif isinstance(e, E.Exists):
            need("exists", e.path)
        elif isinstance(e, E.StrContains):
            need("str", e.path, e.window)
        elif isinstance(e, E.Cmp):
            v = e.value
            if isinstance(v, (str, bytes)):
                raw = v.encode() if isinstance(v, str) else bytes(v)
                need("str", e.path, len(raw))
            elif isinstance(v, (bool, int, float, np.integer, np.floating)) or v is None:
                need("num", e.path)
            else:
                raise TypeError(f"unsupported comparison constant {v!r} for {e.path!r}")
        else:
            raise TypeError(f"not an expr: {e!r}")

    if expr is not None:
        walk(expr)
    return list(cols.values())


def _prepare_cmp_consts(expr) -> dict[int, tuple]:
    """id(Cmp node) -> (f32 const, i32 const | None), prepared on the host.

    The i32 constant exists only when the spec value is int32-exact, which
    is what gates the exact-integer comparison path on the device."""
    out: dict[int, tuple] = {}

    def walk(e):
        if isinstance(e, (E.And, E.Or)):
            walk(e.a)
            walk(e.b)
        elif isinstance(e, E.Not):
            walk(e.a)
        elif isinstance(e, E.Cmp):
            v = e.value
            if v is None or isinstance(v, (bool, str, bytes)):
                return
            const_int = (
                isinstance(v, (int, np.integer))
                and not isinstance(v, bool)
                and -(2**31) <= int(v) <= 2**31 - 1
            ) or (
                isinstance(v, (float, np.floating))
                and float(v) == int(v)
                and -(2**31) <= int(v) <= 2**31 - 1
            )
            out[id(e)] = (np.float32(float(v)), np.int32(int(v)) if const_int else None)

    if expr is not None:
        walk(expr)
    return out


# ------------------------------------------------------------------ plain K1
def _packbits(keep: torch.Tensor) -> torch.Tensor:
    """bool [n] -> uint8 [n/8], big-endian bit order (numpy unpackbits)."""
    n = keep.shape[0]
    b = keep.to(torch.int32).reshape(n // 8, 8)
    weights = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32, device=keep.device)
    return (b * weights[None, :]).sum(dim=1).to(torch.uint8)


def _contains(bytes_col, vlen, needle: bytes, window: int):
    """needle in raw[:window]; scan limited to min(vlen, window). The column
    may be wider than this predicate's window when another expression on the
    same path merged a larger width -- the scan honours THIS window."""
    n, w = bytes_col.shape
    weff = min(window, w)
    l = len(needle)
    present = vlen >= 0
    if l == 0:
        return present
    if l > weff:
        return torch.zeros_like(present)
    span = torch.clamp(vlen, max=weff)
    nwin = weff - l + 1
    match = torch.ones((n, nwin), dtype=torch.bool, device=bytes_col.device)
    for i, ch in enumerate(needle):
        match &= bytes_col[:, i : i + nwin] == ch
    starts = torch.arange(nwin, dtype=torch.int32, device=bytes_col.device)
    match &= starts[None, :] <= (span - l)[:, None]
    return present & match.any(dim=1)


def _build_expr(expr, slots, consts):
    if isinstance(expr, E.And):
        return _build_expr(expr.a, slots, consts) & _build_expr(expr.b, slots, consts)
    if isinstance(expr, E.Or):
        return _build_expr(expr.a, slots, consts) | _build_expr(expr.b, slots, consts)
    if isinstance(expr, E.Not):
        return ~_build_expr(expr.a, slots, consts)
    if isinstance(expr, E.Exists):
        return slots[("exists", expr.path)] != 0
    if isinstance(expr, E.StrContains):
        bytes_col, vlen = slots[("str", expr.path)]
        return _contains(bytes_col, vlen, expr.needle, expr.window)
    v = expr.value
    if isinstance(v, (str, bytes)):
        raw = v.encode() if isinstance(v, str) else bytes(v)
        bytes_col, vlen = slots[("str", expr.path)]
        present = vlen >= 0
        eq = present & (vlen == len(raw))
        for i, ch in enumerate(raw):
            eq &= bytes_col[:, i] == ch
        return eq if expr.op == "eq" else present & ~eq
    f32, i32, flags = slots[("num", expr.path)]
    present = (flags & E.F_PRESENT) != 0
    if isinstance(v, bool):
        isbool = (flags & E.F_BOOL) != 0
        eq = isbool & (i32 == (1 if v else 0))
        return eq if expr.op == "eq" else isbool & ~eq
    if v is None:
        isnull = (flags & E.F_NULL) != 0
        return isnull if expr.op == "eq" else present & ~isnull
    isnum = (flags & E.F_NUMBER) != 0
    f32c, i32c = consts[id(expr)]
    fcmp = E._cmp_num(expr.op, f32, float(f32c))
    if i32c is not None:
        int_exact = (flags & E.F_INT_EXACT) != 0
        icmp = E._cmp_num(expr.op, i32, int(i32c))
        return isnum & torch.where(int_exact, icmp, fcmp)
    return isnum & fcmp


def predicate_plain(plan: ColumnarPlan, arrays) -> torch.Tensor:
    """The plain PyTorch version of the predicate kernel."""
    keep = _build_expr(plan.spec.where, plan._bind_slots(arrays), _prepare_cmp_consts(plan.spec.where))
    return _packbits(keep)


# ---------------------------------------------------------------- extractors
def _pad(a: np.ndarray, n_pad: int, fill) -> np.ndarray:
    if n_pad <= len(a):
        return a
    return np.concatenate([a, np.full((n_pad - len(a),) + a.shape[1:], fill, a.dtype)])


def _extract_str(joined, offsets, sizes, path, w, n_pad, cache=None):
    if cache is not None and path in cache.col:
        b, v = cache.gather_str(path, w)
    else:
        b, v = native.lib().extract_str(joined, offsets, sizes, path, w)
    return [_pad(b, n_pad, 0), _pad(v, n_pad, -1)]


def _extract_num(joined, offsets, sizes, path, n_pad, cache=None):
    if cache is not None and path in cache.col:
        f32, i32, fl = cache.gather_num(path)
    else:
        f32, i32, fl = native.lib().extract_num(joined, offsets, sizes, path)
    return [_pad(f32, n_pad, 0), _pad(i32, n_pad, 0), _pad(fl, n_pad, 0)]


def _extract_exists(joined, offsets, sizes, path, n_pad, cache=None):
    if cache is not None and path in cache.col:
        ex = cache.gather_exists(path)
    else:
        ex = native.lib().extract_exists(joined, offsets, sizes, path)
    return _pad(ex, n_pad, 0)
