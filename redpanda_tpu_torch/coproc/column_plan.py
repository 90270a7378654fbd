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
(csrc/predicate.cu) interprets. K1, one engine launch's predicate, has the
wrapper ``predicate_leg``: the launch's columns in one block
(``block_layout``: each column at a 16-byte-aligned offset), copied up,
evaluated and the bits copied down in one native crossing
(``rp_predicate_leg``), or evaluated where a resident block lies. K2 has
``predicate_blocks`` (a table of column blocks, ``predicate`` its one-block
case, ``predicate_stacked`` the mesh's one launch per card). ``predicate_plain`` is the same function
in plain PyTorch (the JAX package's ``_build_expr`` / ``_contains`` /
``_packbits``); on the CPU ``predicate_leg`` runs it over views of the same
block layout the card reads. ``eval_host_mask``
is the host predicate, the same function in numpy (the JAX package's numpy
twin of its device program): a backend the engine can choose, not the
kernel's plain version. Extraction and
assembly are the JAX package's, over the port's own binding of the same
native library.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass, field as dc_field

import numpy as np
import torch

from redpanda_tpu_torch import kernels, native
from redpanda_tpu_torch.device import constants_on
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
from redpanda_tpu_torch.parallel.mesh import Sharded, card_groups, local_blocks, on_device

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

# DevCol kind -> rp_extract_cols2 desc kind code
_PRED_KIND = {"num": 0, "str": 1, "exists": 2}


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
MAX_COL_ARRAYS = 64  # csrc/predicate.cu kMaxCols: column arrays a block reads
MAX_TABLE_PTRS = 480  # csrc/predicate.cu kMaxPtrs: the block table a launch takes by value
LEG_ALIGN = 16  # bytes: every column of a launch's block starts on this boundary
_NP_DTYPE = {torch.uint8: np.dtype(np.uint8), torch.int32: np.dtype(np.int32),
             torch.float32: np.dtype(np.float32)}


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
            got = constants_on(device, self.code, self.needles)
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


def block_chunks(n_blocks: int, n_cols: int) -> list[tuple[int, int]]:
    """The launches of the predicate kernel over ``n_blocks`` blocks of
    ``n_cols`` column arrays each: [lo, hi) runs of at most
    ``MAX_TABLE_PTRS // n_cols`` blocks, the most its table holds."""
    if not 1 <= n_cols <= MAX_COL_ARRAYS:
        raise ValueError(f"a block reads 1 to {MAX_COL_ARRAYS} column arrays, not {n_cols}")
    cap = MAX_TABLE_PTRS // n_cols
    return [(lo, min(lo + cap, n_blocks)) for lo in range(0, n_blocks, cap)]


class BlockLayout:
    """One launch's predicate columns in one block of bytes, the layout K1's
    leg copies up whole: column array k (``extract_device_inputs`` order:
    str bytes [n_pad, w] and vlen int32, num float32, int32 and flags,
    exists uint8) at byte ``offsets[k]``, each aligned to ``LEG_ALIGN``;
    ``total`` bytes in all."""

    __slots__ = ("parts", "offsets", "total", "c_off")

    def __init__(self, kinds, n_pad: int):
        self.parts = []  # (offset, torch dtype, numpy dtype, shape, bytes) per array
        off = 0
        for dtype, w in kinds:
            shape = (n_pad,) if w is None else (n_pad, w)
            nbytes = n_pad * (1 if w is None else w) * _NP_DTYPE[dtype].itemsize
            self.parts.append((off, dtype, _NP_DTYPE[dtype], shape, nbytes))
            off += -(-nbytes // LEG_ALIGN) * LEG_ALIGN
        self.total = off
        self.offsets = tuple(p[0] for p in self.parts)
        self.c_off = (ctypes.c_longlong * len(self.parts))(*self.offsets)

    def views(self, block) -> list:
        """The column arrays as views of ``block``, a uint8 numpy array or
        tensor of at least ``total`` bytes."""
        if isinstance(block, np.ndarray):
            return [block[o : o + nb].view(nd).reshape(shape) for o, _, nd, shape, nb in self.parts]
        return [block[o : o + nb].view(td).view(shape) for o, td, _, shape, nb in self.parts]

    def pack(self, cols, block: np.ndarray) -> None:
        """Copy the numpy column arrays into their places in ``block``: one
        host copy each. Raises ValueError for a missing array or one of
        another dtype or shape."""
        if len(cols) != len(self.parts):
            raise ValueError(f"the block takes {len(self.parts)} column arrays, got {len(cols)}")
        if block.nbytes < self.total:
            raise ValueError(f"a block of {block.nbytes} B cannot hold {self.total} B")
        for c, (o, _, nd, shape, nb) in zip(cols, self.parts):
            if c.dtype != nd or c.shape != shape:
                raise ValueError(f"column {c.shape} {c.dtype}: expected {shape} {nd}")
            block[o : o + nb].view(nd).reshape(shape)[...] = c


class LegEvents:
    """The four CUDA timing events of one staging slot (csrc/predicate.cu
    ``rp_leg_events``), created once on the current device and recorded by
    every ``rp_predicate_leg`` crossing over the slot: start, copy up done,
    kernel done, copy down done. The last one fences the leg."""

    __slots__ = ("handles",)

    def __init__(self):
        self.handles = (ctypes.c_void_p * 4)()
        _check_cuda("rp_leg_events", kernels.PREDICATE.symbol(
            "rp_leg_events", [ctypes.c_void_p, ctypes.c_int, ctypes.c_int])(self.handles, 4, 1))

    def done(self) -> bool:
        """Whether the last leg recorded on these events has completed (a
        leg that ended in a CUDA error raises)."""
        rc = kernels.PREDICATE.symbol("rp_leg_query", [ctypes.c_void_p])(self.handles[3])
        if rc == _CUDA_NOT_READY:
            return False
        _check_cuda("rp_leg_query", rc)
        return True

    def wait(self) -> tuple[float, float, float]:
        """Wait for the last leg to end; its copy up, kernel and copy down
        in seconds (CUDA events)."""
        ms = (ctypes.c_float * 3)()
        _check_cuda("rp_leg_wait", kernels.PREDICATE.symbol(
            "rp_leg_wait", [ctypes.c_void_p, ctypes.c_void_p])(self.handles, ms))
        return ms[0] / 1e3, ms[1] / 1e3, ms[2] / 1e3

    def close(self) -> None:
        if self.handles[0]:
            kernels.PREDICATE.symbol("rp_leg_events", [ctypes.c_void_p, ctypes.c_int,
                                                       ctypes.c_int])(self.handles, 4, 0)


_CUDA_NOT_READY = 600  # cudaErrorNotReady


def _check_cuda(what: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


# ------------------------------------------------------------------ plans
@dataclass
class ColumnarPlan:
    spec: TransformSpec
    dev_cols: list[DevCol]
    proj: tuple  # projection fields (may be empty -> passthrough)
    r_out: int
    passthrough: bool  # no projection: output = input value bytes
    program: PredicateProgram = dc_field(init=False, repr=False)
    _kinds: list = dc_field(init=False, repr=False)
    _layouts: dict = dc_field(init=False, repr=False, default_factory=dict)

    mode = "columnar"

    def __post_init__(self):
        # compiled once per plan, at enable time: a launch only binds columns
        self.program = compile_predicate(self.spec.where, self.dev_cols)
        # (dtype, byte width or None) of each input array, in _bind_slots order
        self._kinds = []
        for c in self.dev_cols:
            if c.kind == "str":
                self._kinds += [(torch.uint8, c.w), (torch.int32, None)]
            elif c.kind == "num":
                self._kinds += [(torch.float32, None), (torch.int32, None), (torch.uint8, None)]
            else:
                self._kinds.append((torch.uint8, None))

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

    @property
    def byte_identity(self) -> bool:
        """True when the output bytes are the input value bytes (a pure
        filter): the harvest may then frame straight from the joined blob
        through (offset, len); a projection assembles new bytes."""
        return self.passthrough

    def build_find_cache(self, joined, offsets, sizes) -> FindCache | None:
        """The split ladder's span tables: one rp_find_multi walk per record
        locating every top-level path (None when the plan has none)."""
        paths = self.flat_paths()
        if not paths:
            return None
        lib = native.lib()
        tables = lib.find_multi(joined, offsets, sizes, paths)
        return FindCache(lib, joined, offsets, paths, *tables)

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
    def block_layout(self, n_pad: int) -> BlockLayout:
        """Where a launch of ``n_pad`` rows keeps each column in its block
        (made once per row count)."""
        lay = self._layouts.get(n_pad)
        if lay is None:
            lay = self._layouts[n_pad] = BlockLayout(self._kinds, n_pad)
        return lay

    def spill_words(self) -> int:
        """The kernel's spill words a row: stack words past the register's."""
        return (self.program.depth + 63) // 64 - 1

    def predicate(self, arrays: list[torch.Tensor],
                  kernel=kernels.PREDICATE_STACKED) -> torch.Tensor:
        """The predicate over one block: the ordered column tensors ->
        packed keep bits uint8 [n_pad/8], MSB-first. CPU tensors run
        ``predicate_plain``; CUDA tensors are ``predicate_blocks`` over the
        one block, counted under ``kernel``."""
        if arrays and arrays[0].device.type == "cpu":
            self._check_arrays(arrays)
            return predicate_plain(self, arrays)
        return self.predicate_blocks([arrays], kernel)[0]

    def predicate_leg(self, n_pad: int, block: torch.Tensor, bits: torch.Tensor, *,
                      host_block: torch.Tensor | None = None,
                      bits_host: torch.Tensor | None = None,
                      scratch: torch.Tensor | None = None, events: LegEvents | None = None,
                      stream: int | None = None) -> None:
        """K1's wrapper: the predicate over one launch's block of ``n_pad``
        rows (``block_layout(n_pad)``) into ``bits`` (uint8, its first
        n_pad/8 bytes). On a card, one crossing of ``rp_predicate_leg`` on
        ``stream`` (default: the current one): ``host_block`` (pinned) copied
        into ``block`` first unless None (a resident block), the launch, the
        bits copied down into ``bits_host`` (pinned) unless None, and
        ``events`` recorded between the steps; ``scratch`` holds
        ``spill_words() * n_pad`` int64 for trees deeper than 64. A refused
        argument or launch raises RuntimeError, with no launch counted.
        A CPU ``block`` (and only that) runs ``predicate_plain`` over views
        of it; no host block, events or scratch then."""
        lay = self.block_layout(n_pad)
        nb = n_pad // 8
        if block.device.type == "cpu":
            if host_block is not None or events is not None:
                raise ValueError("a CPU block is evaluated where it lies: no copy, no events")
            got = self.predicate(lay.views(block))
            bits[:nb] = got
            if bits_host is not None:
                bits_host[:nb] = got
            return
        if block.device.type != "cuda":
            raise ValueError(f"unsupported device {block.device}")
        dev = block.device
        if block.dtype != torch.uint8 or not block.is_contiguous() or block.numel() < lay.total:
            raise ValueError(f"block {tuple(block.shape)} {block.dtype}: expected contiguous "
                             f"uint8 of at least {lay.total} B")
        if bits.device != dev or bits.dtype != torch.uint8 or bits.numel() < nb:
            raise ValueError(f"bits: expected uint8 of at least {nb} B on {dev}")
        if host_block is not None and (host_block.device.type != "cpu" or not host_block.is_pinned()
                                       or host_block.dtype != torch.uint8
                                       or host_block.numel() < lay.total):
            # a pageable source would make the copy up synchronous
            raise ValueError(f"host_block: expected pinned uint8 of at least {lay.total} B")
        if bits_host is not None and (bits_host.device.type != "cpu" or not bits_host.is_pinned()
                                      or bits_host.numel() < nb):
            raise ValueError(f"bits_host: expected pinned uint8 of at least {nb} B")
        words = self.spill_words()
        if words > 0 and (scratch is None or scratch.device != dev
                          or scratch.dtype != torch.int64 or scratch.numel() < words * n_pad):
            raise ValueError(f"scratch: expected int64 of at least {words * n_pad} on {dev}")
        code, needles = self.program.on(dev)
        kernels.PREDICATE.launch(
            None if host_block is None else host_block.data_ptr(), block.data_ptr(),
            lay.total if host_block is not None else 0, lay.c_off, len(self._kinds),
            code.data_ptr(), code.shape[0], needles.data_ptr(), n_pad,
            scratch.data_ptr() if words > 0 else None, bits.data_ptr(),
            None if bits_host is None else bits_host.data_ptr(),
            None if events is None else events.handles,
            kernels.stream_handle(dev) if stream is None else stream,
        )

    def predicate_blocks(self, blocks, kernel=kernels.PREDICATE_STACKED) -> torch.Tensor:
        """The predicate kernel's wrapper: a list of blocks, each the
        ordered column tensors of ``n_pad`` rows, all on one device ->
        packed keep bits uint8 [len(blocks), n_pad/8]; row b is block b's
        bits, as ``predicate`` gives them. CUDA tensors launch the kernel on
        the current stream once per chunk of ``block_chunks`` (the block
        table it takes by value), counted under ``kernel``; CPU blocks run
        ``predicate`` block by block."""
        blocks = [list(b) for b in blocks]
        if not blocks:
            raise ValueError("predicate_blocks takes at least one block")
        n_pad = self._check_arrays(blocks[0])
        device = blocks[0][0].device
        for b in blocks[1:]:
            if self._check_arrays(b) != n_pad or b[0].device != device:
                raise ValueError("predicate blocks must share one row count and device")
        if device.type == "cpu":
            return torch.stack([self.predicate(b, kernel) for b in blocks])
        if device.type != "cuda":
            raise ValueError(f"unsupported device {device}")
        return self._launch_table([[a.data_ptr() for a in b] for b in blocks], n_pad, device,
                                  kernel)

    def _launch_table(self, table: list[list[int]], n_pad: int, device, kernel) -> torch.Tensor:
        """The kernel launches over checked blocks, given as the data
        pointers of each block's column arrays on ``device``: uint8
        [len(table), n_pad/8], one launch per ``block_chunks`` entry on the
        current stream."""
        prog = self.program
        code, needles = prog.on(device)
        n_cols = len(table[0])
        out = torch.empty((len(table), n_pad // 8), dtype=torch.uint8, device=device)
        words = (prog.depth + 63) // 64 - 1
        scratch = (torch.empty(words * len(table) * n_pad, dtype=torch.int64, device=device)
                   if words > 0 else None)
        stream = kernels.stream_handle(device)
        for lo, hi in block_chunks(len(table), n_cols):
            ptrs = (ctypes.c_void_p * ((hi - lo) * n_cols))(*[p for b in table[lo:hi] for p in b])
            kernel.launch(
                ptrs, hi - lo, n_cols, code.data_ptr(), code.shape[0], needles.data_ptr(), n_pad,
                None if scratch is None else scratch[words * lo * n_pad :].data_ptr(),
                out[lo].data_ptr(), stream,
            )
        return out

    def predicate_stacked(self, mesh, shard_arrays):
        """The stacked predicate (K2): every column a per-shard stack
        [D, n_pad, ...] (numpy, a tensor, or ``Sharded``) -> packed keep
        bits [D, n_pad/8] as a ``Sharded`` array whose blocks are views of
        one result per card. Host stacks are placed with ``local_blocks``
        (one copy per card, on its current stream); each shard's [1, n_pad,
        ...] blocks are checked, and a card's shards are then one
        ``predicate_blocks`` launch per chunk there, its table made from the
        blocks' pointers (no view per block). Block d equals ``predicate``
        over shard d's rows alone: the bits pack within a block and
        n_pad % 8 == 0."""
        args = [local_blocks(mesh, a) for a in shard_arrays]
        rows = {self._check_arrays([a.blocks[d] for a in args], lead=(1,))
                for d in range(mesh.size)}
        if len(rows) != 1:
            raise ValueError(f"stacks of {sorted(rows)} rows: one row count per mesh")
        n_pad = rows.pop()
        bits: list = [None] * mesh.size
        for dev, shards in card_groups(mesh.devices):
            if dev.type == "cuda":
                if any(args[0].blocks[d].device != dev for d in shards):
                    raise ValueError(f"a shard block of {mesh} is not on its device")
                with on_device(dev):
                    out = self._launch_table(
                        [[a.blocks[d].data_ptr() for a in args] for d in shards], n_pad, dev,
                        kernels.PREDICATE_STACKED)
            else:
                out = self.predicate_blocks([[a.blocks[d][0] for a in args] for d in shards],
                                            kernels.PREDICATE_STACKED)
            for i, d in enumerate(shards):
                bits[d] = out[i : i + 1]
        return Sharded(mesh, bits)

    def eval_host_mask(self, cols) -> np.ndarray:
        """The host predicate: the same tree over the same host columns
        (numpy arrays, ``extract_device_inputs`` order), evaluated in numpy
        -> packed keep bits uint8 [n_pad/8], MSB-first. A backend of its
        own, as the host CRC is ``CrcBackend``'s: the engine runs it for a
        measured "host" verdict or ``force_mode="columnar_host"``; it is not
        the kernel's plain version (``predicate_plain``), whose bits it
        equals."""
        keep = _build_expr(self.spec.where, self._bind_slots(cols),
                           _prepare_cmp_consts(self.spec.where), np)
        if keep.shape[0] % 8:
            raise ValueError(f"row count {keep.shape[0]} is not a multiple of 8")
        return np.packbits(keep)

    def zero_device_inputs(self, n_pad: int) -> list[np.ndarray]:
        """All-padding device inputs: the dtypes, shapes and arity of
        ``extract_device_inputs`` with zero records (str vlen -1 = absent).
        An empty mesh shard stacks these so every shard's block keeps one
        shape."""
        out = []
        for c in self.dev_cols:
            if c.kind == "str":
                out += [np.zeros((n_pad, c.w), np.uint8), np.full(n_pad, -1, np.int32)]
            elif c.kind == "num":
                out += [np.zeros(n_pad, np.float32), np.zeros(n_pad, np.int32),
                        np.zeros(n_pad, np.uint8)]
            else:
                out.append(np.zeros(n_pad, np.uint8))
        return out

    def _check_arrays(self, arrays, lead: tuple = ()) -> int:
        """The row count of the ordered column arrays, each of shape
        (*lead, n_pad[, w]), contiguous, of its kind's dtype and on one
        device; raises ValueError otherwise."""
        kinds = self._kinds
        if len(arrays) != len(kinds) or not arrays:
            raise ValueError(f"predicate takes {len(kinds)} column arrays, got {len(arrays)}")
        if arrays[0].dim() <= len(lead):
            raise ValueError(f"column {tuple(arrays[0].shape)} has no row axis after {lead}")
        n_pad = arrays[0].shape[len(lead)]
        if n_pad % 8:
            raise ValueError(f"row count {n_pad} is not a multiple of 8")
        device = arrays[0].device
        for a, (dtype, w) in zip(arrays, kinds):
            shape = (*lead, n_pad) if w is None else (*lead, n_pad, w)
            if a.dtype != dtype or a.shape != shape or not a.is_contiguous():
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

    # ------------------------------------------------------ structural fused
    def structural_eligible(self) -> bool:
        """Whether the structural-index fused ladder can serve this plan:
        every predicate path is a top-level single segment and the
        projection, if any, is expressible as fused Int/Float/Str descs.
        Anything else (nested paths, Substr, Concat) keeps the staged
        ladder."""
        col_of = {p: i for i, p in enumerate(self.flat_paths())}
        if not col_of or any(c.path not in col_of for c in self.dev_cols):
            return False
        return self.passthrough or self._proj_desc_rows(col_of) is not None

    def extract_fused(self, sp, n_pad: int):
        """One record-major native crossing (rp_extract_cols2) off the
        structural parse's span tables: every predicate column, padded to
        ``n_pad``, and for projection plans the packed output rows. Returns
        (cols in _bind_slots order, proj_data | None, proj_ok | None), the
        shapes extract_device_inputs and extract_projection give."""
        col_of = {p: i for i, p in enumerate(self.flat_paths())}
        pred = np.asarray(
            [(_PRED_KIND[c.kind], col_of[c.path], c.w, 0) for c in self.dev_cols],
            dtype=np.int32,
        ).reshape(-1, 4)
        proj_descs = None
        if not self.passthrough:
            proj_descs = np.asarray(self._proj_desc_rows(col_of), dtype=np.int32)
        cols, rows, ok = native.lib().extract_cols2(
            sp.payloads, sp.counts, sp.val_off, sp.val_len,
            sp.types, sp.vs, sp.ve, pred, n_pad, proj_descs, self.r_out,
        )
        if self.passthrough:
            return cols, None, None
        return cols, [("rows", rows)], ok

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
    # device-transformed rows: never a view into the input blob
    byte_identity = False


@dataclass
class HostPlan:
    """No device stage: identity / pure uppercase / a python transform."""

    spec: TransformSpec
    kind: str  # identity | uppercase | python
    fn: object = None  # python: callable(bytes) -> bytes | None
    mode = "host"

    @property
    def byte_identity(self) -> bool:
        # identity emits the input value bytes untouched (its keep rule,
        # drop empty values, needs only the sizes); uppercase and python
        # transforms mutate them
        return self.kind == "identity"


def plan_spec(spec: TransformSpec, py_fn=None):
    """Pick the execution mode for a spec (see module docs); ``py_fn`` makes
    a python host plan."""
    if py_fn is not None:
        return HostPlan(spec, "python", py_fn)
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


def _contains(bytes_col, vlen, needle: bytes, window: int, xp=torch):
    """needle in raw[:window]; scan limited to min(vlen, window). The column
    may be wider than this predicate's window when another expression on the
    same path merged a larger width -- the scan honours THIS window."""
    weff = min(window, bytes_col.shape[1])
    l = len(needle)
    present = vlen >= 0
    if l == 0:
        return present
    if l > weff:
        return xp.zeros_like(present)
    span = vlen.clip(max=weff)
    nwin = weff - l + 1
    match = bytes_col[:, 0:nwin] == needle[0]
    for i, ch in enumerate(needle[1:], 1):
        match &= bytes_col[:, i : i + nwin] == ch
    on = {} if xp is np else {"device": bytes_col.device}
    starts = xp.arange(nwin, dtype=xp.int32, **on)
    match &= starts[None, :] <= (span - l)[:, None]
    return present & match.any(1)


def _build_expr(expr, slots, consts, xp=torch):
    """The predicate tree over bound columns -> bool [n]: torch tensors
    (``predicate_plain``) or numpy arrays (``eval_host_mask``), ``xp``
    being the columns' array module."""
    if isinstance(expr, E.And):
        return _build_expr(expr.a, slots, consts, xp) & _build_expr(expr.b, slots, consts, xp)
    if isinstance(expr, E.Or):
        return _build_expr(expr.a, slots, consts, xp) | _build_expr(expr.b, slots, consts, xp)
    if isinstance(expr, E.Not):
        return ~_build_expr(expr.a, slots, consts, xp)
    if isinstance(expr, E.Exists):
        return slots[("exists", expr.path)] != 0
    if isinstance(expr, E.StrContains):
        bytes_col, vlen = slots[("str", expr.path)]
        return _contains(bytes_col, vlen, expr.needle, expr.window, xp)
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
        return isnum & xp.where(int_exact, icmp, fcmp)
    return isnum & fcmp


def predicate_plain(plan: ColumnarPlan, arrays) -> torch.Tensor:
    """The plain PyTorch version of the predicate kernel."""
    keep = _build_expr(plan.spec.where, plan._bind_slots(arrays), _prepare_cmp_consts(plan.spec.where))
    return _packbits(keep)


def predicate_stacked_plain(plan: ColumnarPlan, stacked) -> torch.Tensor:
    """The plain PyTorch version of the stacked predicate: column stacks
    [D, n_pad, ...] -> bits uint8 [D, n_pad/8], block by block."""
    return torch.stack([predicate_plain(plan, [a[d] for a in stacked])
                        for d in range(stacked[0].shape[0])])


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
