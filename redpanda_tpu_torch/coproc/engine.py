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

Device work runs on the engine's own CUDA stream, never synchronously: the
inputs are packed into pinned host memory, copied up, the kernel runs, the
result is copied down into pinned memory, and one CUDA event marks the end.
``Ticket.result()`` waits on that event, so several launches stay in flight
while the host explodes, extracts and frames others. On ``device="cpu"`` the
same path runs the kernels' plain PyTorch versions synchronously.

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
from redpanda_tpu_torch.coproc import batch_codec
from redpanda_tpu_torch.coproc.column_plan import ColumnarPlan, PayloadPlan, plan_spec
from redpanda_tpu_torch.hashing.crc32c import crc32c
from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.models.record import Compression, RecordBatch
from redpanda_tpu_torch.ops.pipeline import IN_META, run_packed, unpack_result
from redpanda_tpu_torch.ops.transforms import TransformSpec, compile_transform

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
    checksum: int = 0  # CRC-32C of the deployed spec JSON


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
    """One device result in flight on the engine's stream: the pinned host
    tensor it lands in, four timing events (start, H2D done, kernel done,
    D2H done) and the tensors the stream still reads or writes."""

    __slots__ = ("host", "marks", "refs")

    def __init__(self, host: torch.Tensor, marks=None, refs=None):
        self.host = host
        self.marks = marks
        self.refs = refs

    def wait(self, engine: "TorchEngine") -> np.ndarray:
        if self.marks is not None:
            m = self.marks
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
        self.exploded = None
        self.proj_data = None
        self.proj_ok: np.ndarray | None = None
        self._framed = None
        # tickets of one submit_group share this launch and may harvest
        # from different threads
        self._lock = threading.Lock()

    def framed(self) -> list[tuple[bytes, int]]:
        with self._lock:
            if self._framed is None:
                mode = self.plan.mode
                if mode == "payload":
                    out, out_len, keep = self._mat_payload()
                elif mode == "columnar":
                    out, out_len, keep = self._mat_columnar()
                else:
                    out, out_len, keep = self._mat_host()
                t0 = time.perf_counter()
                self._framed = batch_codec.frame_ranges(out, out_len, keep, self.ranges)
                self.engine._stat("t_rebuild", t0)
                self.exploded = self.proj_data = None
            return self._framed

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

    def _mat_columnar(self):
        n = self.n
        if n == 0:
            return (
                np.zeros((0, max(self.r_out, 1)), np.uint8),
                np.zeros(0, np.int32),
                np.zeros(0, bool),
            )
        keep = np.ones(n, dtype=bool)
        if self.pending is not None:
            keep = np.unpackbits(self._fetch())[:n].astype(bool)
        keep &= self.proj_ok
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
    """Script table + batched asynchronous device execution on one device.

    ``device`` is where the kernels run: ``"cuda"`` (the default; raises
    when no CUDA device is present) or ``"cpu"``, which runs the kernels'
    plain PyTorch versions and is the port's reference run. Records wider
    than ``row_stride`` cannot be staged for the payload kernel; they are
    dropped from payload-plan output, never truncated.
    """

    def __init__(
        self,
        *,
        device: str | torch.device = "cuda",
        row_stride: int = 1024,
        compress_threshold: int = 512,
        output_codec: Compression = Compression.zstd,
    ):
        self.device = torch.device(device)
        self._stream = None
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "TorchEngine(device='cuda'): no CUDA device is available; "
                    "pass device='cpu' to run the plain versions"
                )
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(device=self.device)
        elif self.device.type != "cpu":
            raise ValueError(f"unsupported device {self.device}")
        self._row_stride = int(row_stride)
        self._compress_threshold = compress_threshold
        self._output_codec = output_codec
        self._handles: dict[int, ScriptHandle] = {}
        self._plans: dict[int, object] = {}
        self._programs: dict = {}  # payload script_id -> TransformProgram
        self._stats: dict[str, float] = defaultdict(float)
        self._stats_lock = threading.Lock()

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
            raw = spec_json.encode() if isinstance(spec_json, str) else bytes(spec_json)
            self._handles[script_id] = ScriptHandle(
                script_id, spec, tuple(topics), policy, checksum=crc32c(raw)
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
                out.append(DisableResponseCode.success)
            else:
                out.append(DisableResponseCode.script_id_does_not_exist)
        return out

    def heartbeat(self) -> int:
        """Returns the number of registered scripts (liveness probe)."""
        return len(self._handles)

    def shutdown(self) -> None:
        """Wait for every launch still on the engine's stream."""
        if self._stream is not None:
            self._stream.synchronize()

    # ------------------------------------------------------------ metrics
    def stats(self) -> dict:
        """Per-stage wall seconds (``t_*``; ``t_dev_*`` are device seconds
        from CUDA events), counts (``n_*``, ``n_kernel_*`` per kernel) and
        link bytes (``bytes_h2d``, ``bytes_d2h``)."""
        with self._stats_lock:
            out = dict(self._stats)
        out["device"] = str(self.device)
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
        cache = None
        if isinstance(plan, ColumnarPlan):
            paths = plan.flat_paths()
            fused = batch_codec.explode_and_find(batches, paths)
            if fused is not None:
                exploded, types, vs, ve = fused
                cache = plan.make_cache_from_tables(exploded, paths, types, vs, ve)
                self._stat("t_explode_find", t0)
            else:  # only nested paths: the per-path walker extracts them
                exploded = batch_codec.explode_batches(batches)
                self._stat("t_explode", t0)
        else:
            exploded = batch_codec.explode_batches(batches)
            self._stat("t_explode", t0)
        launch.ranges = exploded.ranges
        launch.n = n = len(exploded.sizes)
        self._stat_add("n_records", n)
        self._stat_add("n_launches", 1)
        if isinstance(plan, PayloadPlan):
            self._dispatch_payload(launch, exploded, n)
        elif isinstance(plan, ColumnarPlan):
            self._dispatch_columnar(launch, plan, exploded, n, cache)
        else:  # host: materialized at harvest
            launch.exploded = exploded

    def _dispatch_columnar(self, launch, plan: ColumnarPlan, exploded, n: int, cache) -> None:
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
        inputs = [torch.from_numpy(c) for c in cols]
        if self._stream is not None:
            inputs = [t.pin_memory() for t in inputs]
        launch.pending = self._run_device(inputs, plan.predicate, "predicate")
        # projection extraction overlaps the device launch
        t0 = time.perf_counter()
        if plan.passthrough:
            launch.proj_ok = np.ones(n, bool)
            launch.exploded = exploded
        else:
            launch.proj_data, launch.proj_ok = plan.extract_projection(
                exploded.joined, exploded.offsets, exploded.sizes, cache
            )
        self._stat("t_extract_proj", t0)

    def _dispatch_payload(self, launch, exploded, n: int) -> None:
        prog = self._programs[launch.script_id]
        launch.r_out = prog.r_out
        launch.fits = exploded.sizes <= self._row_stride
        if n == 0:
            return
        t0 = time.perf_counter()
        n_pad = _bucket_rows(n)
        staged = torch.empty(
            (n_pad, self._row_stride + IN_META), dtype=torch.uint8,
            pin_memory=self._stream is not None,
        )
        pack_staged(exploded, self._row_stride, staged.numpy())
        self._stat("t_pack", t0)
        launch.pending = self._run_device([staged], lambda t: run_packed(prog, t[0]),
                                          "payload_transform")

    def _run_device(self, inputs: list[torch.Tensor], run, kernel: str) -> _Pending:
        """Host inputs -> device -> ``run`` (one kernel launch) -> pinned
        host result, all enqueued on the engine's stream; on the CPU device
        ``run`` executes the plain version at once."""
        t0 = time.perf_counter()
        self._stat_add(f"n_kernel_{kernel}", 1)
        if self._stream is None:
            out = run(inputs)
            self._stat("t_dispatch", t0)
            return _Pending(out)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            marks[0].record()
            dev = [t.to(self.device, non_blocking=True) for t in inputs]
            marks[1].record()
            out = run(dev)
            marks[2].record()
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            marks[3].record()
        self._stat("t_dispatch", t0)
        self._stat_add("bytes_h2d", sum(t.nbytes for t in inputs))
        self._stat_add("bytes_d2h", host.nbytes)
        return _Pending(host, marks, (inputs, dev, out))


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
