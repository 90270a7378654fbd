"""The coproc transform engine on PyTorch and CUDA.

Deploys carry a declarative TransformSpec (redpanda_tpu_torch.ops.transforms)
planned once per script (coproc/column_plan.py). ``submit_group()`` fuses
many requests into one launch per script; ``Ticket.result()`` materializes
the replies; ``process_batch()`` is the synchronous wrapper. The request and
reply types, the plan modes and the two error policies are the JAX
package's (coproc/engine.py):

  * **columnar plans** (v2 ``where`` specs) ship the extracted predicate
    columns -- a few bytes per record -- to the card, the predicate kernel
    (csrc/predicate.cu) evaluates the tree, and one bit per record comes
    back. Projections are assembled on the host from columns it extracted.
  * **payload plans** (v1 raw-byte specs) stage whole rows of
    ``row_stride`` bytes plus an LE32 length; the payload kernel
    (csrc/payload_transform.cu) returns packed output rows.
  * **host plans** (identity, uppercase) have no device stage.

The host ladder before and after the device is the JAX engine's
single-device one (its host-stage pool is not ported):

  * columnar plans parse either with the staged ladder (one native explode
    + find over the joined blob, then one gather per column) or with the
    structural-index ladder (``rp_explode_find2`` over a table of payload
    pointers, then one fused extraction crossing, ``rp_extract_cols2``);
    which one is a measured per-engine decision (``_parse_path``);
  * the column cache (coproc/colcache.py, off by default) keeps a launch's
    columns -- on a card, the tensors they were copied into -- keyed by the
    batch window's content, so a repeat launch skips the host ladder and
    the copy up;
  * payload plans stage from a pointer table: each batch's records are
    packed straight from its payload into the pinned staging tensor;
  * byte-identity plans (columnar passthrough, identity) frame their output
    straight from the joined blob (gather framing); framing buffers come
    from the engine's arena.

Device work runs on the engine's own CUDA stream, never synchronously: the
inputs are packed into pinned host memory, copied up, the kernel runs, the
result is copied down into pinned memory, and one CUDA event marks the end.
``Ticket.result()`` waits on that event, so several launches stay in flight
while the host explodes, extracts and frames others. On ``device="cpu"`` the
same path runs the kernels' plain PyTorch versions synchronously.

With a partition mesh (``mesh=`` a ``PartitionMesh``, or ``mesh_devices=n``
cards) columnar launches take the mesh lane (coproc/meshrunner.py): the
launch's records are cut into per-device shards by the host pool's range
shard over its batches, each shard's predicate columns are padded to one
common row bucket, and each card runs the stacked predicate (K2) over its
shards' blocks in one launch, with one pinned copy per column and one end
event per card. A launch of one batch cannot be range-sharded; on a mesh
pinned by ``mesh_probe=False`` it runs as D equal row blocks of the padded
launch through the same launcher (the JAX engine's ``mesh=`` lane). The measured
calibration may choose the single device; a failing shard launch raises
through the same dispatch boundary as a failing single-device launch.

Error policies mirror the public SDK: SkipOnFailure drops the failing batch
but keeps the script; Deregister removes the script on first failure.
"""

from __future__ import annotations

import enum
import logging
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

from redpanda_tpu_torch import native
from redpanda_tpu_torch import kernels
from redpanda_tpu_torch.coproc import batch_codec, colcache, host_pool, meshrunner
from redpanda_tpu_torch.coproc.column_plan import ColumnarPlan, PayloadPlan, plan_spec
from redpanda_tpu_torch.device import resolve_device
from redpanda_tpu_torch.hashing.xx import xxhash64
from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.models.record import Compression, RecordBatch
from redpanda_tpu_torch.ops.pipeline import IN_META, run_packed, unpack_result
from redpanda_tpu_torch.ops.transforms import TransformSpec, compile_transform
from redpanda_tpu_torch.parallel.mesh import PartitionMesh, card_groups, partition_mesh

logger = logging.getLogger("rptorch.coproc.engine")


class EnableResponseCode(enum.IntEnum):
    success = 0
    internal_error = 1
    script_id_already_exists = 2
    script_contains_invalid_topic = 3
    script_contains_no_topics = 4


class DisableResponseCode(enum.IntEnum):
    success = 0
    internal_error = 1
    script_id_does_not_exist = 2


class ErrorPolicy(enum.IntEnum):
    skip_on_failure = 0
    deregister = 1


@dataclass
class ScriptHandle:
    script_id: int
    spec: TransformSpec
    input_topics: tuple[str, ...]
    policy: ErrorPolicy = ErrorPolicy.skip_on_failure
    checksum: int = 0  # xxHash64 of the deployed spec JSON, as the reference's


@dataclass
class ProcessBatchItem:
    script_id: int
    ntp: NTP
    batches: list[RecordBatch]


@dataclass
class ProcessBatchRequest:
    items: list[ProcessBatchItem] = field(default_factory=list)
    trace_id: int | None = None


@dataclass
class ProcessBatchReplyItem:
    script_id: int
    source: NTP
    batches: list[RecordBatch]  # transformed output (may be empty)


@dataclass
class ProcessBatchReply:
    items: list[ProcessBatchReplyItem] = field(default_factory=list)
    deregistered: list[int] = field(default_factory=list)


def _bucket_rows(n: int) -> int:
    """Round the row count up so the device sees few distinct shapes."""
    b = 128
    while b < n:
        b *= 2
    return b


# failures of our own code re-raise instead of feeding an error policy
_PROGRAMMING_ERRORS = (AssertionError, NameError, UnboundLocalError)


class _Pending:
    """One device result in flight: the pinned host tensor it lands in, for
    each stream it runs on (one, or one per card of the mesh) four timing events
    (start, H2D done, kernel done, D2H done), and the tensors the streams
    still read or write."""

    __slots__ = ("host", "marks", "refs")

    def __init__(self, host: torch.Tensor, marks=None, refs=None):
        self.host = host
        self.marks = marks
        self.refs = refs

    def wait(self, engine: "TorchEngine") -> np.ndarray:
        if self.marks is not None:
            for m in self.marks:
                m[3].synchronize()
                engine._stat_add("t_dev_h2d", m[0].elapsed_time(m[1]) / 1e3)
                engine._stat_add("t_dev_kernel", m[1].elapsed_time(m[2]) / 1e3)
                engine._stat_add("t_dev_d2h", m[2].elapsed_time(m[3]) / 1e3)
            self.marks = self.refs = None
        return self.host.numpy()


class _Launch:
    """One device launch for one script, possibly spanning many requests.
    ``framed()`` yields [(payload, kept)] per input batch, computed once."""

    def __init__(self, engine: "TorchEngine", script_id: int, policy: ErrorPolicy, plan):
        self.engine = engine
        self.script_id = script_id
        self.policy = policy
        self.plan = plan
        self.r_out = 0
        self.n = 0
        self.ranges: list[tuple[int, int]] = []
        self.fits: np.ndarray | None = None
        self.pending: _Pending | None = None
        # mesh lane: the records of each shard's block, in launch order
        self.mesh_rows: list[int] | None = None
        self.exploded = None
        self.proj_data = None
        self.proj_ok: np.ndarray | None = None
        # the resolved columnar keep mask: the fetch consumes ``pending``, so
        # a framing retry after a failure must find the mask, not "no
        # predicate" (which would keep every record)
        self._keep: np.ndarray | None = None
        self._framed = None
        # tickets of one submit_group share this launch and may harvest
        # from different threads
        self._lock = threading.Lock()

    def framed(self) -> list[tuple[bytes, int]]:
        """Per-range (payload, kept), framed launch-wide in one native
        crossing the first time any ticket harvests. Byte-identity plans
        take the zero-copy gather path: kept records frame straight from
        the joined blob through the (offset, len) columns the explode stage
        produced, so the padded row matrix is never built. The bytes are
        the same either way."""
        with self._lock:
            if self._framed is None:
                eng = self.engine
                gv = self._gather_view()
                if gv is not None:
                    ex, keep = gv
                    t0 = time.perf_counter()
                    self._framed = batch_codec.frame_ranges_gather(
                        ex.joined, ex.offsets, ex.sizes, keep, self.ranges, arena=eng._arena
                    )
                    eng._stat("t_frame_gather", t0)
                    eng._stat_add("n_frame_gather", 1)
                else:
                    mode = self.plan.mode
                    if mode == "payload":
                        out, out_len, keep = self._mat_payload()
                    elif mode == "columnar":
                        out, out_len, keep = self._mat_columnar()
                    else:
                        out, out_len, keep = self._mat_host()
                    t0 = time.perf_counter()
                    self._framed = batch_codec.frame_ranges(
                        out, out_len, keep, self.ranges, arena=eng._arena
                    )
                    eng._stat("t_rebuild", t0)
                    eng._stat_add("n_frame_padded", 1)
                self.exploded = self.proj_data = None
            return self._framed

    def _gather_view(self):
        """(exploded, keep) when this launch's output bytes are (offset, len)
        views into the joined blob -- a byte-identity plan (columnar
        passthrough, host identity) with the exploded table in hand -- else
        None (the padded path)."""
        ex = self.exploded
        if not self.engine._gather_frame or not self.plan.byte_identity or ex is None:
            return None
        if self.plan.mode == "columnar":
            return ex, self._keep_columnar()
        return ex, ex.sizes > 0  # identity's rule: drop empty values

    def _fetch(self) -> np.ndarray:
        t0 = time.perf_counter()
        got = self.pending.wait(self.engine)
        self.engine._stat("t_fetch", t0)
        self.pending = None
        return got

    def _mat_payload(self):
        if self.pending is None:  # zero-record launch
            return np.zeros((0, self.r_out), np.uint8), np.zeros(0, np.int32), np.zeros(0, bool)
        out, out_len, keep = unpack_result(self._fetch(), self.r_out)
        n = len(self.fits)
        return out[:n], out_len[:n], keep[:n] & self.fits

    def _keep_columnar(self) -> np.ndarray:
        """The predicate's keep bits (fetched once) and the projection's ok."""
        if self._keep is None:
            keep = np.ones(self.n, dtype=bool)
            if self.pending is not None:
                bits = self._fetch()
                if self.mesh_rows is None:
                    keep = np.unpackbits(bits)[: self.n].astype(bool)
                else:  # [D, n_blk/8]: each shard's bits, trimmed to its records
                    keep = np.concatenate([np.unpackbits(b)[:k] for b, k in
                                           zip(bits, self.mesh_rows)]).astype(bool)
            self._keep = keep & self.proj_ok
        return self._keep

    def _mat_columnar(self):
        n = self.n
        if n == 0:
            return (
                np.zeros((0, max(self.r_out, 1)), np.uint8),
                np.zeros(0, np.int32),
                np.zeros(0, bool),
            )
        keep = self._keep_columnar()
        t0 = time.perf_counter()
        plan: ColumnarPlan = self.plan
        if plan.passthrough:
            # output = input value bytes of kept records (empty values are
            # kept when the predicate says so)
            ex = self.exploded
            rows, lens = _pack_values(ex, max(int(ex.sizes.max()), 1))
        else:
            rows, lens = plan.assemble_rows(self.proj_data, n)
        self.engine._stat("t_assemble", t0)
        return rows, lens, keep

    def _mat_host(self):
        ex = self.exploded
        if self.n == 0:
            return np.zeros((0, 1), np.uint8), np.zeros(0, np.int32), np.zeros(0, bool)
        t0 = time.perf_counter()
        rows, lens = _pack_values(ex, max(int(ex.sizes.max()), 1))
        keep = ex.sizes > 0  # identity's rule: drop empty values
        if self.plan.kind == "uppercase":
            is_lower = (rows >= ord("a")) & (rows <= ord("z"))
            rows = np.where(is_lower, rows - 32, rows).astype(np.uint8)
        self.engine._stat("t_assemble", t0)
        return rows, lens, keep


def _pack_values(ex, stride: int):
    """Pack exploded record values into [n, stride] rows + lens."""
    sizes = np.minimum(ex.sizes, stride).astype(np.int32)
    rows = np.empty((len(sizes), stride), dtype=np.uint8)
    native.lib().pack_rows_into(ex.joined, ex.offsets, sizes, rows)
    return rows, sizes


# The parse-path probe: a launch under this many records does not pin the
# ladder (it is not representative of steady state).
_PROBE_MIN_ROWS = 1024

# Per-slot dispositions inside a Ticket.
_UNKNOWN, _EMPTY, _DEREGISTERED, _LAUNCHED = range(4)


class Ticket:
    """Handle for an in-flight engine request; ``result()`` materializes it."""

    def __init__(self, engine: "TorchEngine"):
        self._engine = engine
        # (disposition, item, launch, [batch range indices])
        self._slots: list[tuple] = []

    def result(self) -> ProcessBatchReply:
        eng = self._engine
        reply = ProcessBatchReply()
        dereg: set[int] = set()
        failed_scripts: set[int] = set()
        for disp, item, launch, rng in self._slots:
            if disp in (_UNKNOWN, _EMPTY):
                reply.items.append(ProcessBatchReplyItem(item.script_id, item.ntp, []))
                continue
            if disp == _DEREGISTERED:
                dereg.add(item.script_id)
                continue
            if launch.script_id in failed_scripts:
                if launch.policy != ErrorPolicy.deregister:
                    reply.items.append(ProcessBatchReplyItem(item.script_id, item.ntp, []))
                continue
            try:
                framed = launch.framed()  # one crossing per launch
                t0 = time.perf_counter()
                out_batches = []
                for batch, ridx in zip(item.batches, rng):
                    payload, kept = framed[ridx]
                    b = batch_codec.build_output_batch(
                        batch, payload, kept,
                        compress_threshold=eng._compress_threshold,
                        codec=eng._output_codec,
                    )
                    if b is not None:
                        out_batches.append(b)
                eng._stat("t_seal", t0)
            except Exception as exc:
                # the script error policy boundary: a framing or seal failure
                # drops this script's output (skip) or unloads it (deregister)
                eng._note_failure("rebuild", exc)
                failed_scripts.add(launch.script_id)
                if launch.policy == ErrorPolicy.deregister:
                    eng.disable_coprocessors([launch.script_id])
                    dereg.add(launch.script_id)
                    reply.items = [ri for ri in reply.items if ri.script_id != launch.script_id]
                else:
                    reply.items.append(ProcessBatchReplyItem(item.script_id, item.ntp, []))
                continue
            reply.items.append(ProcessBatchReplyItem(item.script_id, item.ntp, out_batches))
        reply.deregistered = sorted(dereg)
        return reply


class TorchEngine:
    """Script table + batched asynchronous device execution.

    ``device`` is where the kernels run: ``"cuda"`` (the default; raises
    when no CUDA device is present) or ``"cpu"``, which runs the kernels'
    plain PyTorch versions and is the port's reference run. Records wider
    than ``row_stride`` cannot be staged for the payload kernel; they are
    dropped from payload-plan output, never truncated.

    ``mesh`` (a ``PartitionMesh`` of ``device``'s type) or ``mesh_devices``
    (n >= 2: the first n cards, raising when there are fewer) gives the
    columnar plans the mesh lane; a mesh of one shard is the single lane.
    ``mesh_probe=False`` pins the mesh lane; True measures mesh against
    single on the first representative launch (``stats()["mesh"]``).

    The host ladder's knobs are the JAX engine's, with its defaults:

    * ``gather_frame`` (True): byte-identity plans frame their output
      straight from the joined blob (``n_frame_gather``) instead of a
      padded row matrix (``n_frame_padded``);
    * ``structural_parse`` (None, meaning on) and ``structural_probe``
      (True): columnar plans the fused lane can express parse with the
      structural-index ladder when the first representative launch
      (``_PROBE_MIN_ROWS`` records) measures it faster than the staged
      one (``stats()["parse_path"]``, ``["parse_probe"]``);
      ``structural_parse=False`` pins staged, ``structural_probe=False``
      pins structural;
    * ``device_column_cache_mb`` (None, meaning 0: uncached): a byte
      budget for the column cache (coproc/colcache.py), whose hits skip
      the host ladder and, on a card, the copy up
      (``stats()["colcache"]``).
    """

    def __init__(
        self,
        *,
        device: str | torch.device = "cuda",
        row_stride: int = 1024,
        compress_threshold: int = 512,
        output_codec: Compression = Compression.zstd,
        mesh: PartitionMesh | None = None,
        mesh_devices: int | None = None,
        mesh_probe: bool = True,
        gather_frame: bool = True,
        structural_parse: bool | None = None,
        structural_probe: bool = True,
        device_column_cache_mb: int | None = None,
    ):
        self.device = resolve_device(device)
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
        if mesh is None and mesh_devices is not None and int(mesh_devices) >= 2:
            mesh = partition_mesh(int(mesh_devices), device=self.device.type)
        self._meshrunner: meshrunner.MeshRunner | None = None
        if mesh is not None and mesh.size >= 2:
            if mesh.type != self.device.type:
                raise ValueError(f"mesh {mesh} does not run on the engine's device {self.device}")
            self._meshrunner = meshrunner.MeshRunner(mesh, probe=mesh_probe)
        self._row_stride = int(row_stride)
        self._compress_threshold = compress_threshold
        self._output_codec = output_codec
        self._handles: dict[int, ScriptHandle] = {}
        self._plans: dict[int, object] = {}
        self._programs: dict = {}  # payload script_id -> TransformProgram
        self._stats: dict[str, float] = defaultdict(float)
        self._stats_lock = threading.Lock()
        self._gather_frame = bool(gather_frame)
        self._arena = batch_codec.Arena()
        # the parse ladder: a measured per-engine decision unless pinned
        self._structural_enabled = True if structural_parse is None else bool(structural_parse)
        self._parse_decision: str | None = None
        if not self._structural_enabled:
            self._parse_decision = "staged"
        elif not structural_probe:
            self._parse_decision = "structural"
        self._parse_probe: dict | None = None
        self._parse_decision_lock = threading.Lock()
        # serializes calibration runs only; never held while the decision
        # is read or published
        self._parse_probe_run_lock = threading.Lock()
        cache_mb = 0 if device_column_cache_mb is None else max(0, int(device_column_cache_mb))
        self._colcache = colcache.DeviceColumnCache(cache_mb << 20) if cache_mb else None

    # ------------------------------------------------------------ control
    def enable_coprocessors(self, scripts) -> list[EnableResponseCode]:
        """scripts: [(script_id, spec_json, input_topics[, ErrorPolicy])]."""
        out = []
        for script in scripts:
            script_id, spec_json, topics = script[:3]
            policy = ErrorPolicy(script[3]) if len(script) > 3 else ErrorPolicy.skip_on_failure
            if script_id in self._handles:
                out.append(EnableResponseCode.script_id_already_exists)
                continue
            if not topics:
                out.append(EnableResponseCode.script_contains_no_topics)
                continue
            if any(t.startswith("__") or ".$" in t for t in topics):
                out.append(EnableResponseCode.script_contains_invalid_topic)
                continue
            try:
                spec = TransformSpec.from_json(spec_json)
                plan = plan_spec(spec)  # validates the tree and compiles its program
                if isinstance(plan, ColumnarPlan) and self._stream is not None:
                    plan.program.on(self.device)
                elif isinstance(plan, PayloadPlan):
                    prog = compile_transform(spec, self._row_stride)
                    if self._stream is not None:
                        prog.on(self.device)
                    self._programs[script_id] = prog
                self._plans[script_id] = plan
            except Exception as exc:
                # a bad spec from the wire, not an engine fault: refuse it
                self._note_failure("enable", exc)
                out.append(EnableResponseCode.internal_error)
                continue
            self._handles[script_id] = ScriptHandle(
                script_id, spec, tuple(topics), policy, checksum=xxhash64(spec_json)
            )
            out.append(EnableResponseCode.success)
        return out

    def disable_coprocessors(self, script_ids: list[int]) -> list[DisableResponseCode]:
        out = []
        for sid in script_ids:
            if sid in self._handles:
                del self._handles[sid]
                self._plans.pop(sid, None)
                self._programs.pop(sid, None)
                self.invalidate_columns(sid)
                out.append(DisableResponseCode.success)
            else:
                out.append(DisableResponseCode.script_id_does_not_exist)
        return out

    def heartbeat(self) -> int:
        """Returns the number of registered scripts (liveness probe)."""
        return len(self._handles)

    @property
    def scripts(self) -> dict[int, ScriptHandle]:
        """The registered scripts by id (a copy of the table)."""
        return dict(self._handles)

    def shutdown(self) -> None:
        """Wait for every launch still on the engine's streams."""
        if self._stream is not None:
            self._stream.synchronize()
        if self._meshrunner is not None:
            for stream in self._meshrunner.mesh.streams:
                if stream is not None:
                    stream.synchronize()

    # ------------------------------------------------------------ colcache
    def invalidate_columns(self, script_id: int | None = None) -> int:
        """Drop cached columns (every script's when script_id is None) and
        their device tensors; returns entries dropped. The key is
        content-addressed, so this reclaims memory and never changes a
        reply."""
        if self._colcache is None:
            return 0
        return self._colcache.invalidate(script_id)

    def reset_column_cache(self) -> None:
        """Drop every cached entry and zero the cache's counters."""
        if self._colcache is not None:
            self._colcache.reset()

    def reset_arenas(self) -> None:
        """Swap in a fresh framing arena (deterministic reuse accounting;
        returns the held buffers to the allocator)."""
        self._arena = batch_codec.Arena()

    # ------------------------------------------------------------ metrics
    def stats(self) -> dict:
        """Per-stage wall seconds (``t_*``; ``t_dev_*`` are device seconds
        from CUDA events, summed over the mesh's cards on the mesh lane;
        ``t_mesh_ladder`` cuts a launch's columns into the shards' stacks),
        counts (``n_*``, ``n_kernel_*`` per kernel, ``n_mesh_launches``,
        ``n_colcache_hit``/``_miss``, ``n_frame_gather``/``_padded``), link
        bytes (``bytes_h2d``, ``bytes_d2h``), the framing ``arena``'s
        reuse counts, the ``parse_path`` decision (None until probed) and
        its ``parse_probe`` times, the ``colcache`` block when the cache is
        on and, with a mesh, the meshrunner's ``mesh`` block (decision,
        probe, launches and rows per device of the range-shard lane)."""
        with self._stats_lock:
            out = dict(self._stats)
        out["device"] = str(self.device)
        out["arena"] = self._arena.stats()
        with self._parse_decision_lock:
            out["parse_path"] = self._parse_decision
            if self._parse_probe is not None:
                out["parse_probe"] = dict(self._parse_probe)
        if self._colcache is not None:
            out["colcache"] = self._colcache.stats()
        if self._meshrunner is not None:
            out["mesh"] = self._meshrunner.stats()
        return out

    def reset_stats(self) -> None:
        with self._stats_lock:
            self._stats.clear()

    def _stat_add(self, key: str, v: float) -> None:
        with self._stats_lock:
            self._stats[key] += v

    def _stat(self, key: str, t0: float) -> None:
        self._stat_add(key, time.perf_counter() - t0)

    def _note_failure(self, domain: str, exc: BaseException) -> None:
        self._stat_add(f"n_failures_{domain}", 1.0)
        logger.warning("coproc %s failure: %r", domain, exc)

    # ------------------------------------------------------------ data path
    def process_batch(self, req: ProcessBatchRequest) -> ProcessBatchReply:
        """Synchronous wrapper: one submit, one harvest."""
        return self.submit(req).result()

    def submit(self, req: ProcessBatchRequest) -> Ticket:
        return self.submit_group([req])[0]

    def submit_group(self, reqs: list[ProcessBatchRequest]) -> list[Ticket]:
        """Fuse many requests into ONE launch per script: all records of all
        requests targeting a script go up in one staging copy, run in one
        kernel launch and come back in one copy."""
        tickets = [Ticket(self) for _ in reqs]
        by_script: dict[int, list[tuple]] = {}
        for ticket, req in zip(tickets, reqs):
            for item in req.items:
                if item.script_id not in self._handles:
                    ticket._slots.append((_UNKNOWN, item, None, None))
                else:
                    by_script.setdefault(item.script_id, []).append(
                        (ticket, len(ticket._slots), item)
                    )
                    ticket._slots.append(None)  # filled below
        for script_id, entries in by_script.items():
            handle = self._handles[script_id]
            launch = _Launch(self, script_id, handle.policy, self._plans[script_id])
            try:
                self._dispatch(launch, [b for _, _, item in entries for b in item.batches])
                ridx = 0
                for ticket, slot_idx, item in entries:
                    rng = list(range(ridx, ridx + len(item.batches)))
                    ridx += len(item.batches)
                    ticket._slots[slot_idx] = (_LAUNCHED, item, launch, rng)
            except Exception as exc:
                if isinstance(exc, _PROGRAMMING_ERRORS):
                    raise
                self._note_failure("dispatch", exc)
                disp = _EMPTY
                if handle.policy == ErrorPolicy.deregister:
                    self.disable_coprocessors([script_id])
                    disp = _DEREGISTERED
                for ticket, slot_idx, item in entries:
                    ticket._slots[slot_idx] = (disp, item, None, None)
        return tickets

    def _dispatch(self, launch: _Launch, batches: list[RecordBatch]) -> None:
        """Explode the launch's records and issue its (asynchronous) device
        work."""
        plan = launch.plan
        t0 = time.perf_counter()
        if isinstance(plan, PayloadPlan):
            # pointer-table staging: no joined blob; staging packs each
            # batch's records straight from its decompressed payload
            pe = batch_codec.explode_ptrs(batches)
            self._stat("t_explode_ptrs", t0)
            self._count_launch(launch, pe.ranges, len(pe.sizes))
            self._dispatch_payload_ptrs(launch, pe)
            return
        if not isinstance(plan, ColumnarPlan):  # host: materialized at harvest
            launch.exploded = batch_codec.explode_batches(batches)
            self._stat("t_explode", t0)
            self._count_launch(launch, launch.exploded.ranges, len(launch.exploded.sizes))
            return
        # a repeat launch over an unchanged batch window skips the whole
        # host ladder, and on a card the copy up
        store_key = None
        if self._colcache is not None and self._meshrunner is None and batches:
            key = (launch.script_id, colcache.fingerprint(batches))
            entry = self._colcache.lookup(key)
            self._count_colcache(entry is not None)
            if entry is not None:
                self._dispatch_columnar_cached(launch, plan, entry)
                return
            store_key = key
        # decided before the stage timer: the first representative launch
        # calibrates here, and its ladder passes are not this launch's stages
        parse = self._parse_path(plan, batches)
        paths = plan.flat_paths()
        t0 = time.perf_counter()
        if parse == "structural":
            sp = batch_codec.explode_find_structural(batches, paths, need_joined=plan.byte_identity)
            self._stat("t_explode_find2", t0)
            self._count_launch(launch, sp.ranges, sp.n)
            self._dispatch_columnar_fused(launch, plan, sp, store_key)
            return
        fused = batch_codec.explode_and_find(batches, paths)
        cache = None
        if fused is not None:
            exploded, types, vs, ve = fused
            cache = plan.make_cache_from_tables(exploded, paths, types, vs, ve)
            self._stat("t_explode_find", t0)
        else:  # only nested paths: the per-path walker extracts them
            exploded = batch_codec.explode_batches(batches)
            self._stat("t_explode", t0)
        self._count_launch(launch, exploded.ranges, len(exploded.sizes))
        self._dispatch_columnar(launch, plan, exploded, cache, store_key)

    def _count_launch(self, launch: _Launch, ranges, n: int) -> None:
        launch.ranges = ranges
        launch.n = n
        self._stat_add("n_records", n)
        self._stat_add("n_launches", 1)

    def _count_colcache(self, hit: bool) -> None:
        self._stat_add("n_colcache_hit" if hit else "n_colcache_miss", 1)

    # ------------------------------------------------------ parse-path probe
    def _parse_path(self, plan: ColumnarPlan, batches) -> str:
        """Which parse ladder this launch runs: the measured per-engine
        decision, gated by the plan (nested paths or general projections
        keep the staged ladder). Until a representative launch has probed,
        small launches take the staged ladder without pinning anything."""
        if not self._structural_enabled or not plan.structural_eligible():
            return "staged"
        with self._parse_decision_lock:
            decision = self._parse_decision
        if decision is not None:
            return decision
        if sum(b.header.record_count for b in batches) < _PROBE_MIN_ROWS:
            return "staged"
        with self._parse_probe_run_lock:
            with self._parse_decision_lock:
                decision = self._parse_decision
            if decision is None:
                self._calibrate_parse_path(plan, batches)
                with self._parse_decision_lock:
                    decision = self._parse_decision
        return decision

    def _measure_parse_ratio(self, plan: ColumnarPlan, batches) -> tuple[float, float]:
        """(t_staged, t_structural) of this launch's real parse + extract
        ladders, each the best of two."""
        paths = plan.flat_paths()
        n_pad = _bucket_rows(sum(b.header.record_count for b in batches))

        def staged():
            ex, types, vs, ve = batch_codec.explode_and_find(batches, paths)
            cache = plan.make_cache_from_tables(ex, paths, types, vs, ve)
            plan.extract_device_inputs(ex.joined, ex.offsets, ex.sizes, n_pad, cache)
            if not plan.passthrough:
                plan.extract_projection(ex.joined, ex.offsets, ex.sizes, cache)

        def structural():
            sp = batch_codec.explode_find_structural(batches, paths, need_joined=plan.byte_identity)
            plan.extract_fused(sp, n_pad)

        t_staged = t_structural = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            staged()
            t_staged = min(t_staged, time.perf_counter() - t0)
            t0 = time.perf_counter()
            structural()
            t_structural = min(t_structural, time.perf_counter() - t0)
        return t_staged, t_structural

    def _calibrate_parse_path(self, plan: ColumnarPlan, batches) -> None:
        """Pin the parse ladder off the first representative launch: the
        structural ladder must win by PROBE_MARGIN. The caller holds the
        probe run lock. Both ladders are host code: a probe that raises
        pins the staged ladder (``n_failures_parse_calibration``)."""
        try:
            t_staged, t_structural = self._measure_parse_ratio(plan, batches)
        except _PROGRAMMING_ERRORS:
            raise
        except Exception as exc:
            self._note_failure("parse_calibration", exc)
            with self._parse_decision_lock:
                self._parse_decision = "staged"
            return
        ratio = t_staged / t_structural if t_structural > 0 else 0.0
        decision = "structural" if ratio >= host_pool.PROBE_MARGIN else "staged"
        probe = {
            "t_staged_ms": round(t_staged * 1e3, 3),
            "t_structural_ms": round(t_structural * 1e3, 3),
            "speedup": round(ratio, 3),
            "chosen": decision,
        }
        with self._parse_decision_lock:
            self._parse_decision = decision
            self._parse_probe = probe
        logger.info("parse-path calibration: %s", probe)

    # ------------------------------------------------------ columnar lanes
    def _dispatch_columnar(self, launch, plan: ColumnarPlan, exploded, cache, store_key) -> None:
        """The staged ladder: per-column extraction from the span tables,
        the predicate launch, then the projection, which overlaps it."""
        n = launch.n
        launch.r_out = plan.r_out
        if n == 0:
            launch.proj_ok = np.zeros(0, bool)
            return
        n_pad = _bucket_rows(n)
        t0 = time.perf_counter()
        cols = plan.extract_device_inputs(
            exploded.joined, exploded.offsets, exploded.sizes, n_pad, cache
        )
        self._stat("t_extract_pred", t0)
        entry = None
        if store_key is not None:
            entry = colcache.Entry(
                n=n, n_pad=n_pad, ranges=launch.ranges, cols=cols,
                exploded=exploded if plan.passthrough else None, parse_mode="staged",
            )
        self._dispatch_predicate(launch, plan, cols, entry=entry)
        t0 = time.perf_counter()
        if plan.passthrough:
            launch.proj_ok = np.ones(n, bool)
            launch.exploded = exploded
        else:
            launch.proj_data, launch.proj_ok = plan.extract_projection(
                exploded.joined, exploded.offsets, exploded.sizes, cache
            )
        self._stat("t_extract_proj", t0)
        if entry is not None:
            if not plan.passthrough:
                entry.proj_data, entry.proj_ok = launch.proj_data, launch.proj_ok
            self._store(store_key, entry)

    def _dispatch_columnar_fused(self, launch, plan: ColumnarPlan, sp, store_key) -> None:
        """The structural lane: one record-major extraction crossing gives
        the predicate columns and the packed projection rows together."""
        n = sp.n
        launch.r_out = plan.r_out
        if n == 0:
            launch.proj_ok = np.zeros(0, bool)
            return
        t0 = time.perf_counter()
        n_pad = _bucket_rows(n)
        cols, proj_data, proj_ok = plan.extract_fused(sp, n_pad)
        self._stat("t_fused_extract", t0)
        if plan.passthrough:
            launch.proj_ok = np.ones(n, bool)
            launch.exploded = sp.exploded()
        else:
            launch.proj_data, launch.proj_ok = proj_data, proj_ok
        entry = None
        if store_key is not None:
            entry = colcache.Entry(
                n=n, n_pad=n_pad, ranges=launch.ranges, cols=cols,
                proj_data=launch.proj_data, proj_ok=launch.proj_ok,
                exploded=launch.exploded, parse_mode="structural",
            )
        self._dispatch_predicate(launch, plan, cols, entry=entry)
        if entry is not None:
            self._store(store_key, entry)

    def _dispatch_columnar_cached(self, launch, plan: ColumnarPlan, entry) -> None:
        """A column-cache hit: no host dispatch stage runs, and the predicate
        reads the entry's columns -- on a card the tensors the cold launch
        left there, so nothing is copied up. The arrays are the cold
        launch's, so the reply is bit-identical."""
        self._count_launch(launch, list(entry.ranges), entry.n)
        launch.r_out = plan.r_out
        if plan.passthrough:
            launch.proj_ok = np.ones(entry.n, bool)
            launch.exploded = entry.exploded
        else:
            launch.proj_data, launch.proj_ok = entry.proj_data, entry.proj_ok
        self._dispatch_predicate(launch, plan, entry.cols, dev_cols=entry.cols_dev)

    def _store(self, key, entry: colcache.Entry) -> None:
        entry.nbytes = entry._measure()  # with the device tensors, once copied up
        self._colcache.put(key, entry)

    def _dispatch_predicate(self, launch, plan: ColumnarPlan, cols, entry=None,
                            dev_cols=None) -> None:
        """The predicate over a launch's columns: the mesh lane when it takes
        the launch, else one launch on the engine's stream. ``entry`` (a
        cache entry being built) keeps the tensors the columns are copied
        into; ``dev_cols`` are such tensors from a hit, launched as they
        are."""
        if not plan.dev_cols:
            return
        if dev_cols is None:
            counts = [e - s for s, e in launch.ranges]
            if self._dispatch_mesh(launch, plan, cols, counts, launch.n):
                return
            inputs = [torch.from_numpy(c) for c in cols]
            if self._stream is not None:
                inputs = [t.pin_memory() for t in inputs]
        else:
            inputs = dev_cols
        launch.pending = self._run_device(inputs, plan.predicate, "predicate", entry)

    def _mesh_blocks(self, counts: list[int], n: int):
        """The mesh lane's cut of a launch, or None for the single lane:
        ([start, end) records of each shard, common rows per block, whether
        the cut is the range shard)."""
        runner = self._meshrunner
        if runner is None or n == 0:
            return None
        decision = runner.decision
        if decision == "single":
            return None
        d = runner.n_devices
        if len(counts) < 2:
            if decision != "mesh" or runner.probe_enabled:
                return None
            # one batch on a pinned mesh: D equal blocks of the padded launch
            blk = -(-_bucket_rows(n) // (8 * d)) * 8
            return [(min(k * blk, n), min((k + 1) * blk, n)) for k in range(d)], blk, False
        if n < meshrunner.PROBE_MIN_ROWS and (decision is None or runner.probe_enabled):
            # too small to probe on, or a trickle after a measured pin: the
            # single lane is cheaper; a pinned mesh (probe off) takes all
            return None
        starts = np.concatenate([[0], np.cumsum(counts)])
        rec = [(int(starts[s]), int(starts[e])) for s, e in runner.shard_ranges(counts)]
        rec += [(n, n)] * (d - len(rec))  # fewer batches than shards: empty shards
        return rec, _bucket_rows(max(e - s for s, e in rec)), True

    def _dispatch_mesh(self, launch, plan: ColumnarPlan, cols, counts, n: int) -> bool:
        """Issue the launch's predicate on the mesh; False sends it down the
        single lane (not mesh-eligible, or the calibration chose single)."""
        cut = self._mesh_blocks(counts, n)
        if cut is None:
            return False
        rec, n_blk, ranged = cut
        runner = self._meshrunner
        t0 = time.perf_counter()
        stacks = []
        for col, zero in zip(cols, plan.zero_device_inputs(n_blk)):
            stack = np.repeat(zero[None], runner.n_devices, axis=0)
            for k, (s, e) in enumerate(rec):
                stack[k, : e - s] = col[s:e]
            stacks.append(stack)
        self._stat("t_mesh_ladder", t0)
        if runner.decision is None:
            # cols are exactly what the single lane would launch
            if runner.maybe_calibrate(plan, stacks, cols, self.device, n) != "mesh":
                return False
        launch.mesh_rows = [e - s for s, e in rec]
        launch.pending = self._run_mesh(plan, stacks, n_blk)
        if ranged:
            runner.note_launch(launch.mesh_rows)
        self._stat_add("n_mesh_launches", 1)
        return True

    def _run_mesh(self, plan: ColumnarPlan, stacks: list[np.ndarray], n_blk: int) -> _Pending:
        """Per card, on its first shard's stream: one copy up from pinned
        memory per column of the card's rows of the stacks, one launch of
        the stacked predicate over the card's shard blocks, the bits down
        into the card's rows of one pinned host result, and four timing
        events."""
        mesh = self._meshrunner.mesh
        t0 = time.perf_counter()
        self._stat_add("n_kernel_predicate_stacked", mesh.size)
        host = torch.empty((mesh.size, n_blk // 8), dtype=torch.uint8,
                           pin_memory=mesh.type == "cuda")
        inputs = [torch.from_numpy(s) for s in stacks]
        if mesh.type != "cuda":
            host[:] = plan.predicate_blocks([[t[d] for t in inputs] for d in range(mesh.size)],
                                            kernels.PREDICATE_STACKED)
            self._stat("t_dispatch", t0)
            return _Pending(host)
        inputs = [t.pin_memory() for t in inputs]
        marks, refs = [], [inputs]
        for dev, shards in card_groups(mesh.devices):
            lo, hi = shards[0], shards[-1] + 1
            rows = slice(lo, hi) if hi - lo == len(shards) else list(shards)  # list: a gather
            with mesh.shard(lo):
                m = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
                m[0].record()
                cols = [t[rows].to(dev, non_blocking=True) for t in inputs]
                m[1].record()
                bits = plan.predicate_blocks([[c[i] for c in cols] for i in range(len(shards))],
                                             kernels.PREDICATE_STACKED)
                m[2].record()
                if isinstance(rows, slice):
                    host[rows].copy_(bits, non_blocking=True)
                else:
                    for i, d in enumerate(shards):
                        host[d].copy_(bits[i], non_blocking=True)
                m[3].record()
            marks.append(m)
            refs.append((cols, bits))
        self._stat("t_dispatch", t0)
        self._stat_add("bytes_h2d", sum(t.nbytes for t in inputs))
        self._stat_add("bytes_d2h", host.nbytes)
        return _Pending(host, marks, refs)

    def _dispatch_payload_ptrs(self, launch, pe) -> None:
        """The payload lane: staging rows packed straight from each batch's
        payload into the pinned staging tensor (its numpy view), copied up
        and run through the packed payload kernel (K4). The staging tensor
        stays referenced by the launch's _Pending until its copy is done."""
        prog = self._programs[launch.script_id]
        launch.r_out = prog.r_out
        launch.fits = pe.sizes <= self._row_stride
        if launch.n == 0:
            return
        t0 = time.perf_counter()
        staged = torch.empty(
            (_bucket_rows(launch.n), self._row_stride + IN_META), dtype=torch.uint8,
            pin_memory=self._stream is not None,
        )
        pack_staged_ptrs(pe, self._row_stride, staged.numpy())
        self._stat("t_pack", t0)
        launch.pending = self._run_device([staged], lambda t: run_packed(prog, t[0]),
                                          "payload_transform")

    def _run_device(self, inputs: list[torch.Tensor], run, kernel: str, entry=None) -> _Pending:
        """Inputs -> device -> ``run`` (one kernel launch) -> pinned host
        result, all enqueued on the engine's stream; on the CPU device
        ``run`` executes the plain version at once. Inputs already on the
        card (a cache hit's) are launched as they are, with no copy;
        ``entry`` keeps the device copies of host inputs."""
        t0 = time.perf_counter()
        self._stat_add(f"n_kernel_{kernel}", 1)
        if self._stream is None:
            out = run(inputs)
            self._stat("t_dispatch", t0)
            return _Pending(out)
        resident = inputs[0].device.type == "cuda"
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            marks[0].record()
            dev = inputs if resident else [t.to(self.device, non_blocking=True) for t in inputs]
            marks[1].record()
            out = run(dev)
            marks[2].record()
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            marks[3].record()
        if entry is not None:
            # made on the engine's stream, which every hit launches on too
            entry.cols_dev = dev
        self._stat("t_dispatch", t0)
        if not resident:
            self._stat_add("bytes_h2d", sum(t.nbytes for t in inputs))
        self._stat_add("bytes_d2h", host.nbytes)
        return _Pending(host, [marks], (inputs, dev, out))


def pack_staged(exploded, row_stride: int, staged: np.ndarray) -> None:
    """Fill ``staged`` [n_pad, row_stride + IN_META] with the launch's
    records: record bytes, then the LE32 length, then zero pad. A record
    wider than the row is staged with length 0 and its keep bit is cleared
    after the launch (``launch.fits``): truncating it would corrupt data
    silently. Rows past the records are zero (length 0)."""
    r = row_stride
    n_pad = staged.shape[0]
    n = len(exploded.sizes)
    offsets, sizes = exploded.offsets, exploded.sizes
    if n_pad != n:
        offsets = np.concatenate([offsets, np.zeros(n_pad - n, np.int64)])
        sizes = np.concatenate([sizes, np.zeros(n_pad - n, np.int32)])
    lens = np.where(sizes <= r, sizes, 0).astype("<i4")
    native.lib().pack_rows_into(exploded.joined, offsets, sizes, staged)
    staged[:, r : r + 4] = lens.view(np.uint8).reshape(n_pad, 4)
    staged[:, r + 4 :] = 0


def pack_staged_ptrs(pe, row_stride: int, staged: np.ndarray) -> None:
    """``pack_staged`` from a pointer-table explode: each batch's records
    pack straight from its own payload into its rows of ``staged`` (one
    rp_pack_rows crossing a batch), with the same bytes as pack_staged over
    the joined blob (rp_pack_rows clamps to the row and zero-fills each
    row's tail)."""
    r = row_stride
    n_pad = staged.shape[0]
    n = len(pe.sizes)
    native.lib().pack_table_into(pe.payloads, pe.rel_off, pe.rel_len, staged)
    staged[n:] = 0
    lens = np.zeros(n_pad, "<i4")
    lens[:n] = np.where(pe.sizes <= r, pe.sizes, 0)
    staged[:, r : r + 4] = lens.view(np.uint8).reshape(n_pad, 4)
    staged[:, r + 4 :] = 0
