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
  * **host plans** (identity, uppercase, and the python transforms of
    ``enable_py_transform`` and ``enable_py_sandboxed``, coproc/sandbox.py)
    have no device stage: they run on the host on every device.

The host ladder before and after the device is the JAX engine's:

  * columnar plans parse either with the staged ladder (one native explode
    + find over the joined blob, then one gather per column) or with the
    structural-index ladder (``rp_explode_find2`` over a table of payload
    pointers, then one fused extraction crossing, ``rp_extract_cols2``);
    which one is a measured per-engine decision (``_parse_path``);
  * the column cache (coproc/colcache.py, off by default) keeps a launch's
    columns -- on a card, the device block they were copied into -- keyed
    by the batch window's content, so a repeat launch skips the host ladder
    and the copy up;
  * payload plans stage from a pointer table: each batch's records are
    packed straight from its payload into the pinned staging tensor;
  * byte-identity plans (columnar passthrough, identity) frame their output
    straight from the joined blob (gather framing); framing buffers come
    from the engine's arena;
  * the host-stage pool (coproc/host_pool.py; ``host_workers``, on when its
    measured probe wins) cuts a launch of ``_SHARD_MIN_ROWS`` records or
    more into contiguous batch shards: each shard runs its own parse,
    extraction and column-cache consult on a pool worker and launches the
    predicate over its own columns; at harvest the shards assemble and frame
    on the pool, and a reply's recompress and seal jobs fan out over it
    (``_SEAL_MIN_BATCHES``). Payload and host plans shard only the explode
    (payload plans the pointer-table explode, merged for one staging pass).
    The output is byte-identical to the inline path.

Device work runs on the engine's own CUDA stream, never synchronously: the
inputs are packed into pinned host memory, copied up, the kernel runs, the
result is copied down into pinned memory, and one CUDA event marks the end.
A columnar launch's predicate (K1) is one native crossing
(``ColumnarPlan.predicate_leg``) over a staging slot of the engine's pool
(``_LegSlots``): the launch's columns are packed into the slot's pinned
block (``ColumnarPlan.block_layout``), and the copy up into the slot's
device block, the kernel, the bits' copy down into the slot's pinned output
and four timing events are enqueued in one C call. A slot is made once and
grows to the largest launch; it is reused only once its last event has
completed, and the bits are copied out of it when the mask is fetched. A
column-cache entry keeps its own device block, which a hit launches over
with no copy up. A pool worker enters the engine's device and stream itself
(both are per thread in PyTorch). On a card the mask-harvest thread waits on
each predicate launch's end event off the dispatch path and publishes its keep
bits; ``Ticket.result()`` then finds them ready, so several launches stay in
flight while the host explodes, extracts and frames others. A failed harvest
is kept on its mask and raised at harvest into the script's error policy:
no host evaluation takes its place. On ``device="cpu"`` the same path runs
the kernels' plain PyTorch versions synchronously.

With a partition mesh (``mesh=`` a ``PartitionMesh``, or ``mesh_devices=n``
cards) columnar launches take the mesh lane (coproc/meshrunner.py): the
launch's batches are cut into per-device shards by the host pool's range
shard, each shard runs its column-cache consult, parse and extraction (on
the host-stage pool when there is one) at one common row bucket, and each
card runs the stacked predicate (K2) over its shards' blocks in one launch,
with one pinned copy per column and one end event per card. A launch of one
batch cannot be range-sharded; on a mesh pinned by ``mesh_probe=False`` it
runs as D equal row blocks of the padded launch through the same launcher
(the JAX engine's ``mesh=`` lane). The measured calibration may choose the
single device; a failing shard launch raises through the same dispatch
boundary as a failing single-device launch.

Every device leg -- a predicate or payload launch (its copy up, kernel and
copy down enqueued), the mesh lane's stacked launch, a mask's or a payload
result's copy down -- runs inside the JAX engine's fault envelope
(coproc/faults.py, coproc/governor.py): ``faults.inject(<domain>)`` first,
then on a card a per-attempt deadline on an abandonable worker thread,
bounded retries with backoff, and a verdict on the domain's circuit
breaker. Where the JAX engine then falls back to its exact host path, this
engine raises into the script's error policy: an exhausted envelope raises
its last failure, an open breaker ``DeviceUnavailable`` without a launch.
The mesh domain's open breaker demotes a launch to the single-card lane. A
failed kernel build or a wrapper's argument check is never retried and
re-raises out of ``submit_group``. On the CPU the plain versions run
synchronously on the calling thread: the legs are retried and judged there
too, with no deadline (nothing is in flight to abandon).

Where a columnar predicate runs is the JAX engine's choice too:
``force_mode`` pins it ("columnar_host": the host predicate,
``ColumnarPlan.eval_host_mask``; "columnar_device": K1), and unpinned a card
engine follows a process-wide backend measured once, on the first launch of
``_PROBE_MIN_ROWS`` padded rows its single-card leg runs
(``_probe_columnar_backend``: the host predicate against K1's launch and
fetch, the device to win by ``_PROBE_DEVICE_MARGIN``). A probe whose device
leg fails raises into the script's error policy and decides nothing; a
measured "host" verdict is journaled and shown in ``stats()``. A host
predicate's bits reach harvest as a completed mask: no launch, no copy.

With a budget plane (``budget_plane=``, resource_mgmt/budgets.py) every
submit is admitted first, as in the JAX engine: each request's payload bytes
are reserved from the plane's ``coproc`` account, all or nothing per group,
before any host ladder, copy up or launch, whichever lane the launch then
takes. A submit the account cannot hold raises a retriable ``ShedError``
having run nothing (shed-before-ack); the bytes come back when the ticket
harvests, or at once when the submit raises. The engine listens to the
plane's pressure: on critical it trims its framing arena, frees its free K1
staging slots and halves the column cache's budget (the evicted entries'
device blocks are freed with them); back at ok the cache gets its whole
budget again.

Error policies mirror the public SDK: SkipOnFailure drops the failing batch
but keeps the script; Deregister removes the script on first failure.
"""

from __future__ import annotations

import enum
import logging
import queue
import threading
import time
import weakref
from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np
import torch

from redpanda_tpu_torch import native
from redpanda_tpu_torch import kernels
from redpanda_tpu_torch.coproc import (
    batch_codec, colcache, faults, governor, host_pool, leakwatch, lockwatch, meshrunner)
from redpanda_tpu_torch.coproc.column_plan import ColumnarPlan, LegEvents, PayloadPlan, plan_spec
from redpanda_tpu_torch.device import resolve_device
from redpanda_tpu_torch.hashing.xx import xxhash64
from redpanda_tpu_torch.models.fundamental import NTP
from redpanda_tpu_torch.models.record import Compression, RecordBatch
from redpanda_tpu_torch.observability import probes
from redpanda_tpu_torch.observability.trace import tracer
from redpanda_tpu_torch.ops.pipeline import IN_META, run_packed, unpack_result
from redpanda_tpu_torch.ops.transforms import TransformSpec, compile_transform
from redpanda_tpu_torch.parallel.mesh import PartitionMesh, card_groups, partition_mesh
from redpanda_tpu_torch.resource_mgmt import admission as rm_admission
from redpanda_tpu_torch.resource_mgmt import budgets as rm_budgets

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


# A launch under this many records keeps the inline path: the pool's
# handoff and the per-shard fixed costs eat the win.
_SHARD_MIN_ROWS = 2048

# A reply of fewer output batches seals inline: the handoff costs more than
# the recompress and CRC it spreads.
_SEAL_MIN_BATCHES = 8

# How long a caller waits on the mask-harvest thread before it claims a
# mask that is still queued behind others and fetches it itself.
_HARVEST_WAIT_S = 5.0

# serializes _MaskSlot.state transitions between the harvest thread, callers
# claiming a still-queued mask and a degraded sharded launch abandoning its
# shards' masks (rare, O(1): one lock for the process)
_mask_claim_lock = threading.Lock()

# set on a thread while it runs a pool probe's pass: the pass's stats are
# not kept and its masks are fetched in the pass, not by the harvest thread
_probing = threading.local()


class _Pending:
    """One device result in flight: the pinned host tensor it lands in, for
    each stream it runs on (one, or one per card of the mesh) four timing events
    (start, H2D done, kernel done, D2H done), and the tensors the streams
    still read or write. A K1 leg's result (``slot``: its staging slot, ``nb``
    its bytes) lands in the slot's output instead, timed by the slot's
    events: ``wait`` copies the bits out and gives the slot back, once, under
    ``lock``, however many waiters there are (a retried fetch runs ``wait``
    again on another worker while the first may still run)."""

    __slots__ = ("host", "marks", "refs", "slot", "nb", "lock", "__weakref__")

    def __init__(self, host: torch.Tensor | None, marks=None, refs=None, slot=None, nb: int = 0):
        self.host = host
        self.marks = marks
        self.refs = refs
        self.slot = slot
        self.nb = nb
        self.lock = lockwatch.wrap(threading.Lock(), "_Pending.lock") if slot is not None else None

    def wait(self, engine: "TorchEngine") -> np.ndarray:
        if self.marks is not None:
            for m in self.marks:
                m[3].synchronize()
                engine._stat_add("t_dev_h2d", m[0].elapsed_time(m[1]) / 1e3)
                engine._stat_add("t_dev_kernel", m[1].elapsed_time(m[2]) / 1e3)
                engine._stat_add("t_dev_d2h", m[2].elapsed_time(m[3]) / 1e3)
            self.marks = self.refs = None
        if self.lock is not None:
            # a second waiter finds the slot given back and the bits copied
            # out; it never reads a slot another leg may hold by then
            with self.lock:
                slot = self.slot
                if slot is not None:
                    if slot.events is not None:
                        h2d, kern, d2h = slot.events.wait()
                        engine._stat_many((("t_dev_h2d", h2d), ("t_dev_kernel", kern),
                                           ("t_dev_d2h", d2h)))
                    # a copy: the slot's output is the next launch's
                    self.host = torch.from_numpy(slot.bits_np[: self.nb].copy())
                    self.slot = self.refs = None
                    engine._leg_slots.release(slot, self)
        return self.host.numpy()

    def abandon(self, engine: "TorchEngine") -> None:
        """Nobody fetches this result: its slot goes back to the pool, to be
        reused once its last event has completed. A waiter still running
        (an abandoned fetch) gives the slot back itself."""
        if self.lock is None or not self.lock.acquire(blocking=False):
            return
        try:
            slot, self.slot = self.slot, None
            if slot is not None:
                self.refs = None
                engine._leg_slots.release(slot, self)
        finally:
            self.lock.release()


def _held() -> bool:  # a slot's owner between its acquisition and its _Pending
    return True


class _LegSlot:
    """One K1 leg's staging, made once and reused launch after launch: the
    host block the launch's columns are packed into (pinned on a card), the
    device block it is copied into, the keep bits on the card and their
    host copy (pinned), the spill words, and four timing events (a card's,
    ``LegEvents``). ``owner`` is a weak reference to the _Pending that holds
    the slot (None: free)."""

    def __init__(self):
        self.host = self.host_np = self.dev = None
        self.bits = self.bits_host = self.bits_np = self.scratch = None
        self.events = None
        self.cap = self.bits_cap = self.words_cap = 0
        self.owner = None

    @property
    def nbytes(self) -> int:
        """Host and device bytes the slot holds."""
        if self.dev is None:  # the CPU's: one block, one buffer of bits
            return self.cap + self.bits_cap
        return 2 * self.cap + 2 * self.bits_cap + 8 * self.words_cap

    def in_flight(self) -> bool:
        """Whether the last leg over the slot may still read or write it."""
        return self.events is not None and not self.events.done()


class _LegSlots:
    """The engine's pool of K1 staging slots. A launch takes a free slot (no
    holder, and its last event completed) and grows it to its own block,
    bits and spill words, or makes a new one; so at most as many slots live
    as legs were ever in flight at once (the launch depth plus the pool's
    shards). A slot goes back when its bits are fetched, when its mask is
    abandoned, or when its _Pending is dropped unfetched. ``trim`` frees the
    free slots (critical memory pressure), ``close`` every slot (shutdown,
    after the stream has drained). ``bytes`` is the pool's charge: host and
    device bytes of every slot."""

    _GRAIN = 4096  # blocks grow in whole pages

    def __init__(self, device: torch.device, stream):
        self._device = device
        self._stream = stream
        self._lock = lockwatch.wrap(threading.Lock(), "_LegSlots._lock")
        self._slots: list[_LegSlot] = []
        self._grows = 0
        self._trimmed = 0

    def acquire(self, block: int, nb: int, words: int) -> _LegSlot:
        """A free slot fitted to a launch of ``block`` bytes, ``nb`` bytes of
        bits and ``words`` spill words, held until ``bind``/``release``."""
        with self._lock:
            free = [s for s in self._slots
                    if (s.owner is None or s.owner() is None) and not s.in_flight()]
            slot = next((s for s in free if s.cap >= block and s.bits_cap >= nb
                         and s.words_cap >= words), free[0] if free else None)
            if slot is None:
                slot = _LegSlot()
                self._slots.append(slot)
            slot.owner = _held
            try:
                self._fit(slot, block, nb, words)
            except BaseException:
                slot.owner = None
                raise
        return slot

    def _fit(self, slot: _LegSlot, block: int, nb: int, words: int) -> None:
        cuda = self._device.type == "cuda"
        grain = self._GRAIN
        if slot.cap < block or slot.bits_cap < nb:
            cap = max(slot.cap, -(-block // grain) * grain)
            bcap = max(slot.bits_cap, -(-nb // grain) * grain)
            slot.host = torch.empty(cap, dtype=torch.uint8, pin_memory=cuda)
            slot.host_np = slot.host.numpy()
            slot.bits_host = torch.empty(bcap, dtype=torch.uint8, pin_memory=cuda)
            slot.bits_np = slot.bits_host.numpy()
            if cuda:
                with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
                    slot.dev = torch.empty(cap, dtype=torch.uint8, device=self._device)
                    slot.bits = torch.empty(bcap, dtype=torch.uint8, device=self._device)
            else:
                slot.bits = slot.bits_host  # the plain version writes the bits where they are read
            slot.cap, slot.bits_cap = cap, bcap
            self._grows += 1
        if cuda and slot.words_cap < words:
            with torch.cuda.device(self._device), torch.cuda.stream(self._stream):
                slot.scratch = torch.empty(words, dtype=torch.int64, device=self._device)
            slot.words_cap = words
        if cuda and slot.events is None:
            with torch.cuda.device(self._device):
                slot.events = LegEvents()

    def bind(self, slot: _LegSlot, pending: _Pending) -> None:
        slot.owner = weakref.ref(pending)

    def release(self, slot: _LegSlot, holder: _Pending | None = None) -> None:
        """Give ``slot`` back: from its _Pending ``holder``, or before it was
        bound (None). A slot another leg holds by now is left as it is."""
        with self._lock:
            owner = slot.owner
            if holder is None:
                mine = owner is _held
            else:
                mine = owner is not None and owner() is holder
            if mine:
                slot.owner = None

    def trim(self) -> int:
        """Free every free slot; returns the bytes they held."""
        with self._lock:
            gone = [s for s in self._slots
                    if (s.owner is None or s.owner() is None) and not s.in_flight()]
            self._slots = [s for s in self._slots if s not in gone]
            self._trimmed += len(gone)
        freed = sum(s.nbytes for s in gone)
        for s in gone:
            _free_slot(s)
        return freed

    def close(self) -> None:
        """Free every slot (the caller has drained the stream)."""
        with self._lock:
            gone, self._slots = self._slots, []
        for s in gone:
            _free_slot(s)

    def stats(self) -> dict:
        with self._lock:
            busy = sum(1 for s in self._slots if s.owner is not None and s.owner() is not None)
            return {"slots": len(self._slots), "held": busy,
                    "bytes": sum(s.nbytes for s in self._slots), "grows": self._grows,
                    "trimmed": self._trimmed}


def _free_slot(slot: _LegSlot) -> None:
    """Destroy a slot's events and drop its buffers."""
    if slot.events is not None:
        slot.events.close()
    slot.__init__()


class _MaskSlot:
    """One predicate result in flight -- an inline launch's keep bits, one
    pool shard's, or the mesh lane's [D, n_blk/8] -- and its claim state:
    "idle" (the caller fetches it), "queued" (handed to the harvest thread),
    "harvesting", "claimed" (a caller took it while still queued) or
    "abandoned" (its launch degraded to the inline path; nobody fetches it).
    ``bits`` or ``error`` holds the outcome once fetched; ``event`` is set
    when the harvest thread has published it. ``trace_id`` is the launch's
    trace and ``enq_t`` when the mask was handed over (its queue wait)."""

    __slots__ = ("pending", "bits", "error", "event", "state", "trace_id", "enq_t")

    def __init__(self, pending: _Pending, trace_id: int | None = None):
        self.pending = pending
        self.bits: np.ndarray | None = None
        self.error: BaseException | None = None
        self.event: threading.Event | None = None
        self.state = "idle"
        self.trace_id = trace_id
        self.enq_t = 0.0


class _HostShard:
    """One contiguous record range of a sharded launch: written by one pool
    worker, read after the fan-in. ``mask`` is its predicate result, ``row``
    its row of a mesh result (None for a shard's own launch)."""

    __slots__ = ("n", "ranges", "exploded", "proj_data", "proj_ok", "mask", "row")

    def __init__(self):
        self.n = 0
        self.ranges: list[tuple[int, int]] = []
        self.exploded = None
        self.proj_data = None
        self.proj_ok: np.ndarray | None = None
        self.mask: _MaskSlot | None = None
        self.row: int | None = None


class _Launch:
    """One device launch for one script, possibly spanning many requests.
    ``framed()`` yields [(payload, kept)] per input batch, computed once.
    A sharded launch (``shards`` set: the pool lane or the mesh lane)
    assembles and frames per shard; the concatenation is byte-identical to
    the launch-wide path."""

    def __init__(self, engine: "TorchEngine", script_id: int, policy: ErrorPolicy, plan):
        self.engine = engine
        self.script_id = script_id
        self.policy = policy
        self.plan = plan
        self.trace_id: int | None = None
        self.r_out = 0
        self.n = 0
        self.ranges: list[tuple[int, int]] = []
        self.fits: np.ndarray | None = None
        self.pending: _Pending | None = None  # the payload lane's packed rows
        self.mask: _MaskSlot | None = None  # the columnar lanes' keep bits
        # where the columnar predicate runs ("host" | "device" | None: not
        # measured yet), settled once per launch (_settled_backend)
        self.backend: str | None = None
        # one-batch mesh lane: the records of each shard's block, in order
        self.mesh_rows: list[int] | None = None
        self.shards: list[_HostShard] | None = None
        # the shards' masks handed to the harvest thread, abandoned if the
        # sharded launch degrades to the inline path
        self.pending_slots: list[_MaskSlot] = []
        self.exploded = None
        self.proj_data = None
        self.proj_ok: np.ndarray | None = None
        # the resolved columnar keep mask, kept for a framing retry after a
        # failure: it must find the mask, not "no predicate" (which would
        # keep every record)
        self._keep: np.ndarray | None = None
        self._framed = None
        # tickets of one submit_group share this launch and may harvest
        # from different threads
        self._lock = lockwatch.wrap(threading.Lock(), "_Launch._lock")

    def framed(self) -> list[tuple[bytes, int]]:
        """Per-range (payload, kept), framed launch-wide in one native
        crossing the first time any ticket harvests. Byte-identity plans
        take the zero-copy gather path: kept records frame straight from
        the joined blob through the (offset, len) columns the explode stage
        produced, so the padded row matrix is never built. The bytes are
        the same either way."""
        with self._lock:
            if self._framed is None and self.shards is not None:
                self._framed = self._framed_sharded()
            elif self._framed is None:
                eng = self.engine
                gv = self._gather_view()
                if gv is not None:
                    ex, keep = gv
                    t0 = time.perf_counter()
                    self._framed = batch_codec.frame_ranges_gather(
                        ex.joined, ex.offsets, ex.sizes, keep, self.ranges, arena=eng._arena
                    )
                    eng._stat("t_frame_gather", t0)
                    self._count_frame("n_frame_gather")
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
                    self._count_frame("n_frame_padded")
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

    def _count_frame(self, key: str) -> None:
        """Count one framing crossing and journal the script's framing path
        when it changes (gather for byte-identity plans, else padded)."""
        eng = self.engine
        eng._stat_add(key, 1)
        if getattr(_probing, "on", False):
            return  # a pool probe's pass records nothing
        mode = "gather" if key == "n_frame_gather" else "padded"
        eng.governor.record_mode(
            governor.HARVEST_PATH, mode,
            "byte-identity plan framed zero-copy from the joined blob" if mode == "gather"
            else "byte-mutating plan framed via the padded row matrix",
            {"script_id": self.script_id, "mode": self.plan.mode},
            key=self.script_id,
        )

    def _fetch(self) -> np.ndarray:
        """The payload lane's packed rows: the copy down under the harvest
        domain's envelope."""
        t0 = time.perf_counter()
        eng, pending = self.engine, self.pending

        def leg():
            faults.inject(faults.HARVEST)
            return pending.wait(eng)

        got = eng._try_device_leg(faults.HARVEST, leg)
        eng._stat("t_fetch", t0)
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
            if self.mask is not None:
                bits = self.engine._mask_bits(self.mask)
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

    def _shard_keep(self, shard: _HostShard) -> np.ndarray:
        if shard.n == 0:
            return np.zeros(0, dtype=bool)
        if shard.mask is None:  # no predicate
            return shard.proj_ok.copy()
        bits = self.engine._mask_bits(shard.mask)
        if shard.row is not None:
            bits = bits[shard.row]
        return np.unpackbits(bits)[: shard.n].astype(bool) & shard.proj_ok

    def _frame_shard(self, shard: _HostShard, keep: np.ndarray):
        """Assemble and frame one shard's record range (a pool worker's
        body; it touches only its own shard). Byte-identity plans gather
        straight from the shard's exploded table, as the inline path does.
        ``t_shard_*`` are per-shard seconds summed over the workers; the
        fan-out's wall time is ``t_sharded_frame``."""
        eng = self.engine
        plan: ColumnarPlan = self.plan
        ex = shard.exploded
        if eng._gather_frame and plan.byte_identity and ex is not None and shard.n > 0:
            t0 = time.perf_counter()
            framed = batch_codec.frame_ranges_gather(
                ex.joined, ex.offsets, ex.sizes, keep, shard.ranges, arena=eng._arena
            )
            eng._stat("t_shard_frame_gather", t0)
            self._count_frame("n_frame_gather")
            return framed
        t0 = time.perf_counter()
        if shard.n == 0:
            rows, lens = np.zeros((0, max(self.r_out, 1)), np.uint8), np.zeros(0, np.int32)
        elif plan.passthrough:
            rows, lens = _pack_values(ex, max(int(ex.sizes.max()), 1))
        else:
            rows, lens = plan.assemble_rows(shard.proj_data, shard.n)
        eng._stat("t_shard_assemble", t0)
        t0 = time.perf_counter()
        framed = batch_codec.frame_ranges(rows, lens, keep, shard.ranges, arena=eng._arena)
        eng._stat("t_shard_rebuild", t0)
        self._count_frame("n_frame_padded")
        return framed

    def _framed_sharded(self) -> list[tuple[bytes, int]]:
        """The shards' masks resolved in shard order, then assembly and
        framing fanned out over the pool; shards are contiguous record
        ranges in input order, so the concatenation is the launch-wide
        framing."""
        eng = self.engine
        keeps = [self._shard_keep(shard) for shard in self.shards]
        thunks = [(lambda s=shard, k=keep: self._frame_shard(s, k))
                  for shard, keep in zip(self.shards, keeps)]
        t0 = time.perf_counter()
        pool = eng._host_pool
        parts = pool.run(thunks) if pool is not None else [t() for t in thunks]
        eng._stat("t_sharded_frame", t0)
        for shard in self.shards:
            shard.proj_data = shard.exploded = None
        return [item for part in parts for item in part]

    def _mat_host(self):
        ex = self.exploded
        if self.n == 0:
            return np.zeros((0, 1), np.uint8), np.zeros(0, np.int32), np.zeros(0, bool)
        t0 = time.perf_counter()
        if self.plan.kind == "python":
            rows, lens, keep = self._mat_python(ex)
        else:
            rows, lens = _pack_values(ex, max(int(ex.sizes.max()), 1))
            keep = ex.sizes > 0  # identity's rule: drop empty values
            if self.plan.kind == "uppercase":
                is_lower = (rows >= ord("a")) & (rows <= ord("z"))
                rows = np.where(is_lower, rows - 32, rows).astype(np.uint8)
        self.engine._stat("t_assemble", t0)
        return rows, lens, keep

    def _mat_python(self, ex):
        """A python plan's records through its function, one at a time. This
        is user code on the host on every device, as in the JAX engine: the
        port's rule that no host answer stands in for a kernel on a card does
        not apply, since there is no kernel. A script's Exception drops its
        record under skip_on_failure (counted under ``host_plan``); under
        deregister it propagates, marked as the script's (``rp_script``), so
        that ``Ticket.result`` unloads the script."""
        fn = self.plan.fn
        outs = []
        for i in range(self.n):
            o = int(ex.offsets[i])
            val = ex.joined[o : o + int(ex.sizes[i])]
            try:
                outs.append(fn(val))
            except Exception as exc:
                if self.policy == ErrorPolicy.deregister:
                    exc.rp_script = True
                    raise
                faults.note_failure("host_plan", exc)
                outs.append(None)
        keep = np.array([o is not None for o in outs], dtype=bool)
        stride = max(max((len(o) for o in outs if o is not None), default=1), 1)
        rows = np.zeros((self.n, stride), dtype=np.uint8)
        lens = np.zeros(self.n, dtype=np.int32)
        for i, o in enumerate(outs):
            if o is not None:
                rows[i, : len(o)] = np.frombuffer(o, np.uint8)
                lens[i] = len(o)
        return rows, lens, keep


def _pack_values(ex, stride: int):
    """Pack exploded record values into [n, stride] rows + lens."""
    sizes = np.minimum(ex.sizes, stride).astype(np.int32)
    rows = np.empty((len(sizes), stride), dtype=np.uint8)
    native.lib().pack_rows_into(ex.joined, ex.offsets, sizes, rows)
    return rows, sizes


def _fit_cols(cols, n_pad: int) -> list:
    """Pad or trim host predicate columns to a row bucket. Rows past a
    shard's records are padding whose bits are discarded, so zero fill
    never changes output."""
    out = []
    for a in cols:
        if len(a) == n_pad:
            out.append(a)
        elif len(a) > n_pad:
            out.append(np.ascontiguousarray(a[:n_pad]))
        else:
            out.append(np.concatenate([a, np.zeros((n_pad - len(a),) + a.shape[1:], a.dtype)]))
    return out


def _launches_kernel(launch: _Launch) -> bool:
    """Whether a launch runs a kernel, and so crosses the dispatch domain's
    breaker (a columnar launch whose predicate runs on the host does not)."""
    plan = launch.plan
    if isinstance(plan, PayloadPlan):
        return True
    return isinstance(plan, ColumnarPlan) and bool(plan.dev_cols) and launch.backend != "host"


def _explode_shard(explode, batches):
    """A payload or host plan's explode shard on a pool worker (the
    shard_worker fault domain's probe site)."""
    faults.inject(faults.SHARD_WORKER)
    return explode(batches)


def _join_shards(shards: list[_HostShard]) -> tuple[list[tuple[int, int]], int]:
    """The launch-wide batch ranges and record count of its shards."""
    ranges: list[tuple[int, int]] = []
    n = 0
    for shard in shards:
        ranges.extend((a + n, b + n) for a, b in shard.ranges)
        n += shard.n
    return ranges, n


# The parse-path probe and the columnar backend probe: a launch under this
# many records (the backend probe: padded rows) pins neither choice (it is not
# representative of steady state).
_PROBE_MIN_ROWS = 1024
# The columnar backend probe's device leg (the predicate kernel's build, a
# warm-up launch and a timed launch with its fetch) must end within this, or
# it fails as a wedged leg.
_PROBE_DEVICE_TIMEOUT_S = 120.0
# The probe times only the predicate leg; a device launch also pays costs
# the probe cannot see (the harvest thread's hand-off, the GIL between the
# fetch worker and host assembly, dispatch bookkeeping), so the device must
# beat the host predicate by this factor to be chosen (the JAX engine's).
_PROBE_DEVICE_MARGIN = 4.0

_FORCE_MODES = (None, "payload", "columnar_host", "columnar_device")

# Per-slot dispositions inside a Ticket.
_UNKNOWN, _EMPTY, _DEREGISTERED, _LAUNCHED = range(4)


class Ticket:
    """Handle for an in-flight engine request; ``result()`` materializes it."""

    def __init__(self, engine: "TorchEngine"):
        self._engine = engine
        self.trace_id: int | None = None  # the request's, carried across threads
        # (disposition, item, launch, [batch range indices])
        self._slots: list[tuple] = []
        # bytes reserved from the coproc memory account at submit (0 when
        # admission is off); released exactly once when result() returns
        # OR raises -- leaking them would starve every later submit
        self._admitted: int = 0

    def result(self) -> ProcessBatchReply:
        try:
            with tracer.span("coproc.harvest", trace_id=self.trace_id):
                return self._result()
        finally:
            self._engine._release_admission(self)

    def _result(self) -> ProcessBatchReply:
        eng = self._engine
        reply = ProcessBatchReply()
        dereg: set[int] = set()
        failed_scripts: set[int] = set()
        # Phase 1: frame every launch and collect the reply's seal jobs, so
        # the recompress and seal can fan out over the pool in one go. The
        # jobs are independent and come back in input order, so the bytes
        # equal the serial loop's.
        seal_jobs: list[tuple] = []  # (source batch, payload, kept)
        slot_plans: list = []  # per slot: job indices, an exception, or None
        framing_failed: set[int] = set()
        for disp, item, launch, rng in self._slots:
            if disp != _LAUNCHED or launch.script_id in framing_failed:
                # a later slot of a script whose framing failed is settled in
                # phase 2 (the failing slot comes first)
                slot_plans.append(None)
                continue
            try:
                framed = launch.framed()  # one crossing per launch
                idxs = []
                for batch, ridx in zip(item.batches, rng):
                    payload, kept = framed[ridx]
                    idxs.append(len(seal_jobs))
                    seal_jobs.append((batch, payload, kept))
                slot_plans.append(idxs)
            except Exception as exc:  # held for phase 2's error policy
                if faults.unretried(exc):  # our bug, not a transform failure
                    raise
                slot_plans.append(exc)
                framing_failed.add(launch.script_id)
        sealed = eng._seal_jobs(seal_jobs)
        # Phase 2: the reply in slot order, under each script's error policy:
        # a framing or seal failure drops the script's output (skip) or
        # unloads it (deregister)
        for (disp, item, launch, rng), plan in zip(self._slots, slot_plans):
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
            exc = plan if isinstance(plan, Exception) else next(
                (sealed[i] for i in plan if isinstance(sealed[i], BaseException)), None)
            if exc is None:
                out_batches = [sealed[i] for i in plan if sealed[i] is not None]
                reply.items.append(ProcessBatchReplyItem(item.script_id, item.ntp, out_batches))
                continue
            eng._note_failure("rebuild", exc)
            failed_scripts.add(launch.script_id)
            if launch.policy == ErrorPolicy.deregister:
                eng.disable_coprocessors([launch.script_id])
                dereg.add(launch.script_id)
                reply.items = [ri for ri in reply.items if ri.script_id != launch.script_id]
            else:
                reply.items.append(ProcessBatchReplyItem(item.script_id, item.ntp, []))
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
      (``stats()["colcache"]``);
    * ``host_workers`` (None, meaning ``host_pool.default_host_workers()``):
      the host-stage pool's threads; 0 or 1 keeps the inline path;
    * ``host_pool_probe`` (True): the first launch the pool could shard
      runs inline and sharded, from its explode to its sealed output
      batches (``_measure_pool_ratio``), and pins the pool only on a
      ``host_pool.PROBE_MARGIN`` win (``stats()["host_pool_probe"]``); the
      reply-wide seal fans out under the same decision. False pins the
      pool on, unmeasured, and with it the seal's fan-out, which loses to
      the inline seal on a host whose seal jobs are tens of microseconds
      each;
    * ``host_pool_recal_launches`` (None, meaning 512): the decision is
      measured again after this many shardable launches (the previous
      probe in ``stats()["host_pool_probe_prev"]``); 0 pins it for good.

    The fault envelope's knobs are the JAX engine's too, with its defaults
    (``self.governor`` holds the per-domain breakers, the adaptive deadlines
    and this engine's view of the decision journal):

    * ``device_deadline_ms`` (None, meaning 30000): the per-attempt deadline
      of a device leg on a card, the floor of the adaptive deadlines;
    * ``launch_retries`` (None, meaning 2) and ``retry_backoff_ms`` (None,
      meaning 50): retries after a failed attempt, with exponential backoff
      and jitter;
    * ``breaker_threshold`` (None, meaning 5) consecutive failed legs open a
      domain's breaker; ``breaker_cooldown_ms`` (None, meaning 30000) later
      one half-open probe launch is admitted;
    * ``adaptive_deadline`` (None, meaning on) and
      ``adaptive_deadline_margin`` (None, meaning 4.0): a domain's deadline
      rises to margin x its successful legs' p99.9 (at most 8x the floor);
    * ``governor_journal_capacity`` (None: the process journal's 256): the
      decision journal's ring, process-wide.

    ``budget_plane`` (None: every submit admitted, the JAX engine's default)
    is a ``resource_mgmt.BudgetPlane``: submits reserve their payload bytes
    from its ``coproc`` account or shed (``ShedError``), and its pressure
    transitions trim the arena and the column cache (module docstring).

    ``force_mode`` (None) pins every script to one execution mode, as the
    JAX engine's does: "payload" gives a where-less spec the payload plan
    (K4), "columnar_host" evaluates every columnar predicate with the host
    predicate (``ColumnarPlan.eval_host_mask``: no K1 launch, nothing
    copied up, never the mesh lane) and "columnar_device" launches K1
    wherever the engine runs a predicate.

    Unpinned, where a card engine's single-card leg evaluates the predicate
    is a measured, process-wide decision: the first such launch of
    ``_PROBE_MIN_ROWS`` padded rows or more times the host predicate against
    K1's launch and fetch over the same columns (``_probe_columnar_backend``)
    and every engine of the process then keeps the verdict
    (``stats()["columnar_backend"]``, ``["columnar_probe"]``; the
    COLUMNAR_BACKEND journal entry); ``reset_columnar_probe()`` forgets it.
    Departures from the JAX engine: a probe whose device leg fails raises
    into the script's error policy and publishes no verdict (the JAX engine
    then picks the host); only engines on a card (``_backend_probe``) run the
    probe or read the verdict, so a CPU engine runs K1's plain version
    unless pinned to "columnar_host"; a launch under the probe's size
    before a verdict launches K1 and pins nothing (the JAX engine evaluates
    it on the host); a launch the mesh lane takes never probes.

    ``shutdown()`` stops the mask-harvest thread and the pool's threads, and
    removes the engine's pressure listener from the plane.
    """

    # The process-wide columnar backend ("device" | "host" | None: not
    # measured yet) and its probe's record: the link between host and card
    # does not change per engine. Two locks with distinct jobs: the run lock
    # serializes the probe itself (two concurrent first launches probe once;
    # the loser waits and adopts the verdict), the field lock guards the
    # two-field publish and every read, and is never held across the probe.
    _columnar_backend: str | None = None
    _columnar_probe: dict | None = None
    _columnar_probe_run_lock = threading.Lock()
    _columnar_probe_lock = threading.Lock()

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
        host_workers: int | None = None,
        host_pool_probe: bool = True,
        host_pool_recal_launches: int | None = None,
        device_deadline_ms: int | None = None,
        launch_retries: int | None = None,
        retry_backoff_ms: int | None = None,
        breaker_threshold: int | None = None,
        breaker_cooldown_ms: int | None = None,
        adaptive_deadline: bool | None = None,
        adaptive_deadline_margin: float | None = None,
        governor_journal_capacity: int | None = None,
        budget_plane: rm_budgets.BudgetPlane | None = None,
        force_mode: str | None = None,
    ):
        if force_mode not in _FORCE_MODES:
            raise ValueError(f"force_mode {force_mode!r} is not one of {_FORCE_MODES}")
        self.device = resolve_device(device)
        self._stream = None
        if self.device.type == "cuda":
            self._stream = torch.cuda.Stream(device=self.device)
        # K1's staging slots (one native crossing a launch)
        self._leg_slots = _LegSlots(self.device, self._stream)
        self._force_mode = force_mode
        # whether unpinned launches probe for, and follow, the process-wide
        # columnar backend: engines on a card only (tests set it on a CPU
        # engine to drive the probe over the plain version)
        self._backend_probe = self.device.type == "cuda"
        if mesh is None and mesh_devices is not None and int(mesh_devices) >= 2:
            mesh = partition_mesh(int(mesh_devices), device=self.device.type)
        self._meshrunner: meshrunner.MeshRunner | None = None
        if mesh is not None and mesh.size >= 2:
            if mesh.type != self.device.type:
                raise ValueError(f"mesh {mesh} does not run on the engine's device {self.device}")
            self._meshrunner = meshrunner.MeshRunner(mesh, probe=mesh_probe)
        # the fault envelope: the static deadline is the floor of the
        # governor's per-domain adaptive deadlines
        self._fault_policy = faults.FaultPolicy(
            deadline_s=(30_000 if device_deadline_ms is None else device_deadline_ms) / 1000.0,
            retries=2 if launch_retries is None else launch_retries,
            backoff_s=(50 if retry_backoff_ms is None else retry_backoff_ms) / 1000.0,
        )
        # the plain versions on the CPU run synchronously on the caller's
        # thread: there is no copy in flight to abandon, so no deadline
        self._leg_deadlines = self._stream is not None
        threshold = 5 if breaker_threshold is None else breaker_threshold
        cooldown_s = (30_000 if breaker_cooldown_ms is None else breaker_cooldown_ms) / 1000.0
        adaptive = True if adaptive_deadline is None else bool(adaptive_deadline)
        if governor_journal_capacity is not None:
            governor.journal.configure(governor_journal_capacity)
        self.governor = governor.Governor(
            fault_policy=self._fault_policy,
            breaker_threshold=threshold,
            breaker_cooldown_s=cooldown_s,
            # a half-open probe runs a whole retry envelope: the stale-probe
            # release must outwait it, or a slow probe gets a second probe
            # stacked onto the same struggling card
            breaker_probe_timeout_s=max(cooldown_s, 2.0 * self._fault_policy.envelope_s()),
            adaptive_deadline=adaptive,
            deadline_margin=4.0 if adaptive_deadline_margin is None else adaptive_deadline_margin,
        )
        self.governor.set_config_snapshot({
            "device_deadline_ms": round(self._fault_policy.deadline_s * 1e3),
            "launch_retries": self._fault_policy.retries,
            "retry_backoff_ms": round(self._fault_policy.backoff_s * 1e3),
            "breaker_threshold": threshold,
            "breaker_cooldown_ms": round(cooldown_s * 1e3),
            "force_mode": force_mode,
            "gather_frame": bool(gather_frame),
            "adaptive_deadline": adaptive,
        })
        # the dispatch domain's breaker: every launch crosses it first
        self._breaker = self.governor.breaker_for(faults.DEVICE_DISPATCH)
        self._row_stride = int(row_stride)
        self._compress_threshold = compress_threshold
        self._output_codec = output_codec
        self._handles: dict[int, ScriptHandle] = {}
        self._plans: dict[int, object] = {}
        self._programs: dict = {}  # payload script_id -> TransformProgram
        self._stats: dict[str, float] = defaultdict(float)
        self._stats_lock = lockwatch.wrap(threading.Lock(), "TorchEngine._stats_lock")
        self._gather_frame = bool(gather_frame)
        self._arena = leakwatch.wrap(batch_codec.Arena(), "engine.arena")
        # the parse ladder: a measured per-engine decision unless pinned
        self._structural_enabled = True if structural_parse is None else bool(structural_parse)
        self._parse_decision: str | None = None
        if not self._structural_enabled:
            self._parse_decision = "staged"
        elif not structural_probe:
            self._parse_decision = "structural"
        if self._parse_decision is not None:
            # an operator's pin, not a measurement: posture only
            self.governor.note_posture(governor.PARSE_PATH, self._parse_decision)
        self.governor.update_config_snapshot(structural_parse=self._structural_enabled)
        self._parse_probe: dict | None = None
        self._parse_decision_lock = lockwatch.wrap(
            threading.Lock(), "TorchEngine._parse_decision_lock")
        # serializes calibration runs only; never held while the decision
        # is read or published
        self._parse_probe_run_lock = lockwatch.wrap(
            threading.Lock(), "TorchEngine._parse_probe_run_lock")
        cache_mb = 0 if device_column_cache_mb is None else max(0, int(device_column_cache_mb))
        self._colcache = colcache.DeviceColumnCache(cache_mb << 20) if cache_mb else None
        self.governor.update_config_snapshot(
            device_column_cache_mb=cache_mb,
            mesh_devices=self._meshrunner.n_devices if self._meshrunner else 0)
        # the host-stage pool: exists at >= 2 workers; on or off is a
        # measured decision unless pinned (host_pool_probe=False)
        if host_workers is None:
            host_workers = host_pool.default_host_workers()
        self._host_workers = max(0, int(host_workers))
        self._host_pool = (host_pool.HostStagePool(self._host_workers)
                           if self._host_workers >= 2 else None)
        self._pool_decision: str | None = None if host_pool_probe else "sharded"
        self.governor.update_config_snapshot(host_workers=self._host_workers)
        if not host_pool_probe:
            self.governor.note_posture(governor.HOST_POOL, "sharded")  # a pin: posture only
        # held across a pool calibration, so concurrent first launches do
        # not measure against each other's load
        self._pool_decision_lock = lockwatch.wrap(
            threading.Lock(), "TorchEngine._pool_decision_lock")
        self._host_pool_probe: dict | None = None
        self._host_pool_probe_prev: dict | None = None
        # set while a periodic recalibration is pending: it journals as one
        self._recal_pending = False
        self._probe_enabled = bool(host_pool_probe)
        self._recal_interval = (512 if host_pool_recal_launches is None
                                else max(0, int(host_pool_recal_launches)))
        self._launches_since_cal = 0
        # the mask-harvest thread, started with the first mask it serves
        self._harvest_q: queue.Queue = queue.Queue()
        self._harvester: threading.Thread | None = None
        # The budget plane: a submit's payload bytes are reserved from the
        # 'coproc' account BEFORE any host ladder, copy up or launch; a full
        # account sheds the whole submit with a retriable ShedError. The
        # bytes return when the ticket harvests (Ticket.result's finally).
        # A plane-less engine admits everything. The pressure listener is
        # weakref-bound: the process-wide plane must not pin dead engines.
        self._budget_plane = budget_plane
        self._admission: rm_admission.AdmissionController | None = None
        self._pressure_listener = None
        if budget_plane is not None:
            acct = budget_plane.accounts.get("coproc")
            if acct is not None:
                self._admission = leakwatch.wrap(
                    rm_admission.AdmissionController(
                        acct, "coproc", warn_pct=budget_plane.warn_pct),
                    "engine.admission")
            _ref = weakref.ref(self)

            def _pressure_listener(level, snap, _ref=_ref):
                eng = _ref()
                if eng is not None:
                    eng._on_memory_pressure(level, snap)

            self._pressure_listener = _pressure_listener
            budget_plane.add_pressure_listener(_pressure_listener)
        self.governor.update_config_snapshot(admission=self._admission is not None)

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
                if (self._force_mode == "payload" and not isinstance(plan, PayloadPlan)
                        and spec.where is None):
                    # v1-expressible specs only: a where spec has no payload
                    # program and keeps its columnar plan
                    plan = PayloadPlan(spec)
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

    def enable_py_transform(
        self,
        script_id: int,
        fn,
        topics: tuple[str, ...],
        policy: ErrorPolicy = ErrorPolicy.skip_on_failure,
    ) -> EnableResponseCode:
        """Register an arbitrary python callable(value) -> bytes | str | None
        as a host plan (None drops the record): the escape hatch for
        transforms the declarative DSL cannot express. In-process trust
        only; the wire-deployable form is ``enable_py_sandboxed``."""
        if script_id in self._handles:
            return EnableResponseCode.script_id_already_exists
        if not topics:
            return EnableResponseCode.script_contains_no_topics
        spec = TransformSpec(name=f"py:{getattr(fn, '__name__', 'fn')}")
        self._plans[script_id] = plan_spec(spec, py_fn=fn)
        self._handles[script_id] = ScriptHandle(script_id, spec, tuple(topics), policy)
        return EnableResponseCode.success

    def enable_py_sandboxed(
        self,
        script_id: int,
        source: str,
        topics: tuple[str, ...],
        policy: ErrorPolicy = ErrorPolicy.skip_on_failure,
    ) -> EnableResponseCode:
        """Register restricted-AST python source (coproc/sandbox.py),
        validated and compiled here before registration, so that a refused
        source never runs. A source that fails to validate or compile is
        counted under ``sandbox_compile`` and refused with
        ``internal_error``."""
        from redpanda_tpu_torch.coproc.sandbox import SandboxViolation, compile_transform

        if script_id in self._handles:
            return EnableResponseCode.script_id_already_exists
        if not topics:
            return EnableResponseCode.script_contains_no_topics
        try:
            fn = compile_transform(source, script_id=script_id)
        except SandboxViolation as exc:
            faults.note_failure(faults.SANDBOX_COMPILE, exc)
            return EnableResponseCode.internal_error
        except Exception as exc:
            # any other compile-time failure is a bad script too, not an
            # engine fault: refuse the registration, with its traceback
            faults.note_failure(faults.SANDBOX_COMPILE, exc)
            logger.exception("sandboxed script %d failed to compile", script_id)
            return EnableResponseCode.internal_error
        return self.enable_py_transform(script_id, fn, topics, policy)

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
        """Stop the mask-harvest thread (a sentinel queued behind the masks
        in flight, then a join) and the host-stage pool's threads, wait for
        every launch still on the engine's streams and free every K1 staging
        slot. The engine takes no request after it."""
        with self._stats_lock:
            t, self._harvester = self._harvester, None
        if t is not None and t.is_alive():
            self._harvest_q.put(None)
            t.join(timeout=60.0)
        if self._host_pool is not None:
            self._host_pool.shutdown()
        if self._stream is not None:
            self._stream.synchronize()
        if self._meshrunner is not None:
            for stream in self._meshrunner.mesh.streams:
                if stream is not None:
                    stream.synchronize()
        self._leg_slots.close()
        with self._stats_lock:  # concurrent shutdowns: swap-then-remove once
            listener, self._pressure_listener = self._pressure_listener, None
        if self._budget_plane is not None and listener is not None:
            # the plane is process-wide and outlives this engine: a dead
            # closure left behind would be walked on every later transition
            self._budget_plane.remove_pressure_listener(listener)

    # ------------------------------------------------------------ colcache
    def invalidate_columns(self, script_id: int | None = None) -> int:
        """Drop cached columns (every script's when script_id is None) and
        their device blocks; returns entries dropped. The key is
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
        self._arena = leakwatch.wrap(batch_codec.Arena(), "engine.arena")

    # ------------------------------------------------------------ budget plane
    def _release_admission(self, ticket: Ticket) -> None:
        """Return a ticket's reserved coproc-account bytes. Idempotent AND
        atomic: the zero-swap runs under the stats lock, so two threads
        releasing one ticket cannot free its bytes twice and overcommit the
        account."""
        with self._stats_lock:
            n, ticket._admitted = ticket._admitted, 0
        if n and self._admission is not None:
            self._admission.release(n)

    def _on_memory_pressure(self, level: str, snap: dict) -> None:
        """Budget-plane pressure transition (fired by the plane on a level
        CHANGE, from whatever thread moved the occupancy). CRITICAL frees
        reclaimable memory: the arena's free list is trimmed, the free K1
        staging slots are freed (``n_pressure_slot_bytes``: their bytes) and
        the column cache evicts down to half its budget (an evicted entry
        takes its device block with it: nothing else holds it); OK restores
        the whole cache budget. WARN only journals. Each transition is one
        ADMISSION journal entry."""
        trims = evicted = slot_bytes = 0
        if level == rm_budgets.PRESSURE_CRITICAL:
            trims = self._arena.trim()
            slot_bytes = self._leg_slots.trim()
            if slot_bytes:
                self._stat_add("n_pressure_slot_bytes", float(slot_bytes))
            if self._colcache is not None:
                evicted = self._colcache.set_pressure(True)
            self._stat_add("n_pressure_trims", 1.0)
            if evicted:
                self._stat_add("n_pressure_evictions", float(evicted))
        elif level == rm_budgets.PRESSURE_OK and self._colcache is not None:
            self._colcache.set_pressure(False)
        self.governor.record(
            governor.ADMISSION, level,
            f"memory pressure {level}: arena buffers freed {trims}, "
            f"colcache entries evicted {evicted}",
            {
                "arena_freed": trims,
                "colcache_evicted": evicted,
                "max_occupancy": snap.get("max_occupancy"),
                "account": snap.get("max_occupancy_account"),
            },
        )

    # ------------------------------------------------------------ metrics
    def stats(self) -> dict:
        """Per-stage wall seconds (``t_*``; ``t_dev_*`` are device seconds
        from CUDA events, summed over the mesh's cards on the mesh lane;
        ``t_mesh_ladder`` is the mesh lane's per-shard ladders, or its cut of
        a one-batch launch; ``t_shard_*`` are a sharded launch's per-shard
        seconds summed over the pool's workers, and ``t_sharded_dispatch``,
        ``t_sharded_frame`` and ``t_sharded_seal`` the wall time of each
        fan-out; ``t_harvest_wait`` is the mask-harvest thread's wait on the
        card's copies down; ``t_leg_hop`` the device legs' hand-offs to the
        fetch workers and back, on a card), counts (``n_*``, ``n_kernel_*`` per kernel,
        ``n_mesh_launches``, ``n_sharded_launches``,
        ``n_colcache_hit``/``_miss``, ``n_frame_gather``/``_padded``,
        ``n_failures_*`` per failure domain), link bytes (``bytes_h2d``,
        ``bytes_d2h``), ``host_workers``, the pool's ``host_pool_probe`` (and
        ``host_pool_probe_prev``) and ``host_pool_recal`` when there is a
        pool, the framing ``arena``'s reuse counts, the ``parse_path``
        decision (None until probed) and its ``parse_probe`` times, the
        ``colcache`` block when the cache is on and, with a mesh, the
        meshrunner's ``mesh`` block (decision, probe, launches, demotions
        and rows per device of the range-shard lane). The fault envelope adds
        ``n_retries`` (attempts retried), ``breaker`` (the worst state
        across the fault domains' breakers, the largest consecutive-failure
        count, the trips summed), ``breakers`` (each domain's breaker) and
        ``governor`` (its posture and the decision journal's summary). With a
        budget plane: ``n_shed_submits`` (submits shed), ``n_pressure_trims``
        and ``n_pressure_evictions`` (critical transitions and the cache
        entries they evicted) and the ``admission`` block (the controller's
        admits, sheds, throttle and account). ``n_host_predicate`` counts
        the host predicate's evaluations; on an engine that follows the
        process-wide columnar backend, ``columnar_backend`` and
        ``columnar_probe`` (its probe's times, margin and verdict) appear
        once it is measured. ``t_h2d_enqueue`` is the host's time in the
        calls that enqueue the payload lane's copies up (host clock, inside
        ``t_dev_h2d``'s interval); ``t_leg_enqueue`` the host's time in K1's
        native crossings (copy up, launch, copy down, events). K1's staging
        pool reports apart (``leg_slot_stats``). While lockwatch or leakwatch
        is on (coproc/lockwatch.py, coproc/leakwatch.py), its block appears:
        ``lockwatch`` (the observed lock-order edges) or ``leakwatch``
        (outstanding balances, imbalances)."""
        with self._stats_lock:
            out = dict(self._stats)
        out["device"] = str(self.device)
        out["host_workers"] = float(self._host_workers)
        out["breaker"] = self.governor.aggregate_breaker_snapshot()
        out["breakers"] = self.governor.breakers_snapshot()
        out["governor"] = self.governor.snapshot()
        if self._host_pool_probe is not None:
            out["host_pool_probe"] = dict(self._host_pool_probe)
        if self._host_pool_probe_prev is not None:
            out["host_pool_probe_prev"] = dict(self._host_pool_probe_prev)
        if self._host_pool is not None:
            out["host_pool_recal"] = {
                "interval": self._recal_interval if self._probe_enabled else 0,
                "launches_since": self._launches_since_cal,
            }
        out["arena"] = self._arena.stats()
        if lockwatch.enabled():
            # debug mode only: the count of observed lock-order edges
            out["lockwatch"] = lockwatch.snapshot()
        if leakwatch.enabled():
            # debug mode only: outstanding balances and the imbalance count
            out["leakwatch"] = leakwatch.snapshot()
        with self._parse_decision_lock:
            out["parse_path"] = self._parse_decision
            if self._parse_probe is not None:
                out["parse_probe"] = dict(self._parse_probe)
        if self._colcache is not None:
            out["colcache"] = self._colcache.stats()
        if self._admission is not None:
            out["admission"] = self._admission.snapshot()
        if self._meshrunner is not None:
            out["mesh"] = self._meshrunner.stats()
        if self._backend_probe:
            with TorchEngine._columnar_probe_lock:  # the two fields, coherent
                backend, probe = TorchEngine._columnar_backend, TorchEngine._columnar_probe
            if probe is not None:
                out["columnar_backend"] = backend
                out["columnar_probe"] = dict(probe)
        return out

    def leg_slot_stats(self) -> dict:
        """K1's staging pool: its slots, those held by a leg in flight or
        unfetched, the host and device bytes of all of them, the growths and
        the slots freed by pressure."""
        return self._leg_slots.stats()

    @classmethod
    def sticky_columnar_backend(cls) -> str | None:
        """The process-wide columnar backend, read under the field lock (one
        coherent read, not the class attribute around a probe's publish)."""
        with cls._columnar_probe_lock:
            return cls._columnar_backend

    @classmethod
    def reset_columnar_probe(cls) -> None:
        """Forget the process-wide columnar backend, so that the next
        eligible launch probes again (ablations, and tests that need a
        fresh measurement instead of an inherited verdict)."""
        with cls._columnar_probe_lock:
            cls._columnar_backend = None
            cls._columnar_probe = None

    def reset_stats(self) -> None:
        with self._stats_lock:
            self._stats.clear()

    def _stat_add(self, key: str, v: float) -> None:
        """Add to one stat; a ``t_*`` stage also lands in
        ``coproc_stage_latency_us{stage=}``, recorded under the same lock
        (HdrHist's record is a read-modify-write)."""
        if getattr(_probing, "on", False):
            return
        with self._stats_lock:
            self._stats[key] += v
            if key.startswith("t_"):
                probes.coproc_stage_hist(key[2:]).record(int(v * 1e6))

    def _stat(self, key: str, t0: float) -> None:
        self._stat_add(key, time.perf_counter() - t0)

    def _stat_many(self, items) -> None:
        """Several ``_stat_add``s, (key, value) pairs, under one lock."""
        if getattr(_probing, "on", False):
            return
        with self._stats_lock:
            for key, v in items:
                self._stats[key] += v
                if key.startswith("t_"):
                    probes.coproc_stage_hist(key[2:]).record(int(v * 1e6))

    def _note_failure(self, domain: str, exc: BaseException) -> None:
        """One failure that meets an error policy or a degraded lane:
        ``n_failures_<domain>``, and ``coproc_failures_total`` unless a
        device leg's envelope classified it already (``rp_counted``): one
        failure is one sample of the series, under the leg's domain."""
        self._stat_add(f"n_failures_{domain}", 1.0)
        if not getattr(exc, "rp_counted", False):
            faults.note_failure(domain, exc)

    def _try_device_leg(self, domain: str, leg):
        """One device leg under the fault envelope of ``domain``: the
        breaker's admission (``DeviceUnavailable`` when it refuses, with no
        launch), the domain's per-attempt deadline (adaptive, from the
        governor; none on the CPU), bounded retries, classified failure
        accounting and the breaker's verdict. Returns the leg's value or
        raises its last failure: the caller raises it into the script's
        error policy where the JAX engine falls back to its host path. An
        ``unretried`` failure is counted and re-raised with no verdict.
        Each successful attempt's wall time feeds the domain's adaptive
        deadline (``governor.observe_leg``).

        On a card each attempt runs on an abandonable fetch worker, which
        inherits the calling thread's ``_probing``: a pool probe's legs keep
        no stats there either. ``t_leg_hop`` sums the hand-off to the worker
        and back of the legs that ran in one attempt."""
        gov = self.governor
        breaker = gov.breaker_for(domain)
        if not breaker.allow_device():
            raise faults.DeviceUnavailable(domain)
        probing = getattr(_probing, "on", False)
        spans: list[float] = []  # each attempt's start, then the last one's end

        def timed_leg():
            was, _probing.on = getattr(_probing, "on", False), probing
            try:
                t0 = time.perf_counter()
                spans.append(t0)
                out = leg()
                t1 = time.perf_counter()
            finally:
                _probing.on = was
            gov.observe_leg(domain, t1 - t0)
            spans.append(t1)
            return out

        t_call = time.perf_counter()
        try:
            out = faults.retry_call(timed_leg, gov.policy_for(domain), domain,
                                    count=self._stat_add, inline=not self._leg_deadlines)
        except Exception as exc:
            exc.rp_counted = True  # the policy boundary does not count it again
            faults.note_failure(domain, exc, reraise_programming=True)
            breaker.record_failure()
            raise
        if self._leg_deadlines and len(spans) == 2:
            self._stat_add("t_leg_hop", (spans[0] - t_call) + (time.perf_counter() - spans[1]))
        breaker.record_success()
        return out

    # ------------------------------------------------------------ harvest
    def _harvest_async(self) -> bool:
        """Whether masks are handed to the harvest thread: on a card, where
        the copy down is still in flight when dispatch returns."""
        return self._stream is not None

    def _publish_mask(self, slot: _MaskSlot) -> None:
        """Hand a mask in flight to the harvest thread (on a card)."""
        if not self._harvest_async() or getattr(_probing, "on", False):
            return
        slot.event = threading.Event()
        slot.state = "queued"
        slot.enq_t = time.perf_counter()
        self._ensure_harvester()
        self._harvest_q.put(slot)

    def _ensure_harvester(self) -> None:
        # locked: concurrent dispatchers must not each start a thread
        with self._stats_lock:
            if self._harvester is None or not self._harvester.is_alive():
                self._harvester = threading.Thread(
                    target=self._harvest_loop, name="rptorch-mask-harvester", daemon=True
                )
                self._harvester.start()

    def _harvest_loop(self) -> None:
        while True:
            slot = self._harvest_q.get()
            if slot is None:  # shutdown's sentinel
                return
            with _mask_claim_lock:
                if slot.state in ("claimed", "abandoned"):
                    continue  # its caller fetches it, or nobody needs it
                slot.state = "harvesting"
            t0 = time.perf_counter()
            try:
                self._fetch_mask(slot, faults.HARVEST)
            finally:
                t1 = time.perf_counter()
                self._stat_add("t_harvest_wait", t1 - t0)
                # the copy down's span (post-synchronize device time) and
                # how long the mask waited for this thread
                tracer.record("coproc.device_harvest", (t1 - t0) * 1e6, slot.trace_id,
                              start_perf=t0, queue_us=int((t0 - slot.enq_t) * 1e6),
                              device_us=int((t1 - t0) * 1e6))
                slot.event.set()

    def _fetch_mask(self, slot: _MaskSlot, domain: str) -> None:
        """Wait for a mask's copy down under ``domain``'s envelope (HARVEST
        on the harvest thread, MASK_FETCH for a caller); its bits, or the
        last exception, go into the slot. The envelope has classified the
        failure already; ``n_failures_harvest`` counts it for the engine."""
        pending = slot.pending

        def leg():
            faults.inject(domain)
            return pending.wait(self)

        try:
            slot.bits = self._try_device_leg(domain, leg)
        except Exception as exc:  # kept on the slot; raised at harvest
            slot.error = exc
            self._stat_add("n_failures_harvest", 1.0)
        finally:
            slot.pending = None

    def _mask_bits(self, slot: _MaskSlot) -> np.ndarray:
        """A mask's keep bits, once fetched: published by the harvest thread,
        or fetched here (MASK_FETCH) when it was never handed over or is
        still queued after ``_HARVEST_WAIT_S``. A mask the thread is
        fetching is waited for as long as the harvest domain's envelope
        (re-read while it grows). A failed fetch raises, now and on every
        retry: nothing takes the card's place."""
        if slot.bits is None and slot.error is None:
            t0 = time.perf_counter()
            if slot.event is None:
                self._fetch_mask(slot, faults.MASK_FETCH)
            elif not slot.event.wait(_HARVEST_WAIT_S):
                with _mask_claim_lock:
                    claimed = slot.state == "queued"
                    if claimed:
                        slot.state = "claimed"
                if claimed:
                    self._fetch_mask(slot, faults.MASK_FETCH)
                else:
                    self._await_harvest(slot)
            self._stat("t_fetch", t0)
        if slot.error is not None:
            raise slot.error
        return slot.bits

    def _await_harvest(self, slot: _MaskSlot) -> None:
        """Wait for the harvest thread's verdict on a mask it is fetching:
        its whole envelope and a second, the bound re-read until it stops
        growing (an adaptive raise lands in it before the fetch starts)."""
        waited = 0.0
        while True:
            bound = self.governor.envelope_bound_s(faults.HARVEST) + 1.0
            if bound <= waited:
                raise faults.DeadlineExceeded("the harvest thread outlived its envelope")
            if slot.event.wait(bound - waited):
                return
            waited = bound

    def _abandon_pending_masks(self, launch: _Launch) -> None:
        """Mark a degraded sharded launch's still-queued shard masks
        abandoned: the harvest thread skips them, and their staging slots go
        back to the pool (reused once their last event has completed)."""
        with launch._lock:
            slots, launch.pending_slots = launch.pending_slots, []
        with _mask_claim_lock:
            gone = [slot for slot in slots if slot.state == "queued"]
            for slot in gone:
                slot.state = "abandoned"
        for slot in gone:
            if slot.pending is not None:
                slot.pending.abandon(self)

    # ------------------------------------------------------------ seal
    def _seal_jobs(self, jobs: list[tuple]) -> list:
        """Recompress and seal framed payloads into output batches
        (``batch_codec.build_output_batch``; a job that kept no record is
        None). The output batches fan out over the pool, in chunks balanced
        by payload bytes, when its decision is "sharded" and the reply has
        ``_SEAL_MIN_BATCHES`` of them or more. The jobs are
        independent and the chunks come back in input order, so the bytes
        equal the serial loop's. A job's failure comes back as its exception
        (the caller applies the script's policy); a failure of the pool
        itself seals the reply inline (``n_failures_shard_worker``)."""
        out: list = [None] * len(jobs)
        live = [i for i, (_, _, kept) in enumerate(jobs) if kept]
        if not live:
            return out
        sealed = None
        pool = self._host_pool
        with self._pool_decision_lock:
            decision = self._pool_decision
        if pool is not None and decision == "sharded":
            chunks = self._seal_chunks(jobs, live)
            if len(chunks) >= 2:
                sealed = self._seal_sharded(jobs, chunks)
            if sealed is not None:
                # journaled once the fan-out committed
                self.governor.record_mode(
                    governor.SHARDED_SEAL, "sharded",
                    f"reply-wide seal fan-out engaged: {len(live)} jobs >= "
                    f"{_SEAL_MIN_BATCHES} over {len(chunks)} chunks",
                    {"jobs": len(live), "chunks": len(chunks)})
        if sealed is None and len(live) >= _SEAL_MIN_BATCHES:
            # only an eligible reply sealing inline is a decision
            self.governor.record_mode(
                governor.SHARDED_SEAL, "inline",
                "serial seal despite an eligible reply: pool off, measured inline "
                "decision, or pool failure", {"jobs": len(live)})
        if sealed is None:
            t0 = time.perf_counter()
            sealed = self._seal(jobs, live)
            self._stat("t_seal", t0)
        for i, b in zip(live, sealed):
            out[i] = b
        return out

    def _seal_chunks(self, jobs: list[tuple], live: list[int]) -> list[list[int]]:
        """The live jobs cut for the pool, balanced by payload bytes; one
        chunk under ``_SEAL_MIN_BATCHES`` jobs."""
        if len(live) < _SEAL_MIN_BATCHES:
            return [live]
        # +1 keeps empty payloads partitionable
        parts = host_pool.partition_counts([len(jobs[i][1]) + 1 for i in live],
                                           self._host_pool.workers)
        return [live[s:e] for s, e in parts]

    def _seal(self, jobs: list[tuple], idx: list[int]) -> list:
        sealed = []
        for i in idx:
            try:
                sealed.append(batch_codec.build_output_batch(
                    *jobs[i], compress_threshold=self._compress_threshold,
                    codec=self._output_codec))
            except Exception as exc:  # delivered as a value to the error policy
                sealed.append(exc)
        return sealed

    def _seal_sharded(self, jobs: list[tuple], chunks: list[list[int]]) -> list | None:
        """The chunks' jobs sealed on the pool, in order; None when the pool
        itself fails (counted), so that the caller seals inline."""
        def run_chunk(idx: list[int]) -> list:
            t0 = time.perf_counter()
            sealed = self._seal(jobs, idx)
            self._stat("t_shard_seal", t0)
            return sealed

        t0 = time.perf_counter()
        try:
            got = self._host_pool.run([(lambda idx=idx: run_chunk(idx)) for idx in chunks])
        except Exception as exc:
            if faults.unretried(exc):
                raise
            self._note_failure("shard_worker", exc)
            return None
        self._stat("t_sharded_seal", t0)
        return [b for part in got for b in part]

    # ------------------------------------------------------------ data path
    def process_batch(self, req: ProcessBatchRequest) -> ProcessBatchReply:
        """Synchronous wrapper: one submit, one harvest."""
        return self.submit(req).result()

    def submit(self, req: ProcessBatchRequest) -> Ticket:
        return self.submit_group([req])[0]

    def submit_group(self, reqs: list[ProcessBatchRequest]) -> list[Ticket]:
        """Fuse many requests into ONE launch per script: all records of all
        requests targeting a script go up in one staging copy, run in one
        kernel launch and come back in one copy.

        With a budget plane, every request's payload bytes reserve from the
        'coproc' account first, all or nothing per group: a shed submit
        raises ``ShedError`` having run nothing (no host ladder, no copy up,
        no launch). Reserved bytes release when each ticket harvests, or
        here when the submit raises."""
        admitted: list[int] = []
        if self._admission is not None:
            ctrl = self._admission
            for req in reqs:
                nbytes = sum(len(b.payload) for item in req.items for b in item.batches)
                reserved, retry_ms = ctrl.try_admit(nbytes)
                if nbytes > 0 and reserved == 0:
                    for r in admitted:
                        ctrl.release(r)
                    acct = ctrl.account
                    self.governor.note_shed(
                        "coproc", retry_ms,
                        {"requested_bytes": nbytes, "held_bytes": acct.held,
                         "limit_bytes": acct.limit},
                    )
                    self._stat_add("n_shed_submits", 1.0)
                    raise rm_admission.ShedError("coproc", retry_ms, f"{nbytes} staged bytes")
                admitted.append(reserved)
            if any(admitted):
                # a zero-byte submit is not evidence the account recovered
                self.governor.note_admitted("coproc")
        try:
            return self._submit_group_admitted(reqs, admitted)
        except BaseException:
            # nothing was handed back: the caller cannot harvest, so the
            # reservations must not outlive the failed submit
            if self._admission is not None:
                for r in admitted:
                    self._admission.release(r)
            raise

    def _submit_group_admitted(self, reqs: list[ProcessBatchRequest],
                               admitted: list[int]) -> list[Ticket]:
        tickets = [Ticket(self) for _ in reqs]
        for t, r in zip(tickets, admitted):
            t._admitted = r
        by_script: dict[int, list[tuple]] = {}
        for ticket, req in zip(tickets, reqs):
            ticket.trace_id = req.trace_id
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
            launch.trace_id = entries[0][0].trace_id
            try:
                self._dispatch(launch, [b for _, _, item in entries for b in item.batches])
                ridx = 0
                for ticket, slot_idx, item in entries:
                    rng = list(range(ridx, ridx + len(item.batches)))
                    ridx += len(item.batches)
                    ticket._slots[slot_idx] = (_LAUNCHED, item, launch, rng)
            except Exception as exc:
                if faults.unretried(exc):
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
        work: the mesh lane or a column-cache hit when either takes the
        launch, else the host-stage pool when it shards it, else inline."""
        plan = launch.plan
        store_key = None
        if isinstance(plan, ColumnarPlan) and plan.dev_cols:
            launch.backend = self._settled_backend()
        if isinstance(plan, ColumnarPlan) and self._meshrunner is not None and \
                self._dispatch_mesh(launch, plan, batches):
            return
        if batches and _launches_kernel(launch) and self._breaker.state == faults.STATE_OPEN:
            # fail fast: no host stage runs for a launch the breaker refuses
            raise faults.DeviceUnavailable(faults.DEVICE_DISPATCH)
        if isinstance(plan, ColumnarPlan):
            # a repeat launch over an unchanged batch window skips the whole
            # host ladder, and on a card the copy up (a sharded launch then
            # consults the cache per shard)
            if self._colcache is not None and self._meshrunner is None and batches:
                key = (launch.script_id, colcache.fingerprint(batches))
                entry = self._colcache.lookup(key)
                self._count_colcache(entry is not None)
                if entry is not None:
                    self._dispatch_columnar_cached(launch, plan, key, entry)
                    return
                store_key = key
        if self._dispatch_sharded(launch, plan, batches):
            return
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
        except Exception as exc:
            if faults.unretried(exc):
                raise
            self._note_failure("parse_calibration", exc)
            with self._parse_decision_lock:
                self._parse_decision = "staged"
            self.governor.record(
                governor.PARSE_PATH, "staged",
                f"calibration FAILED ({faults.kind_of(exc)}); keeping the staged ladder",
                {"error": faults.kind_of(exc)})
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
        self.governor.record(
            governor.PARSE_PATH, decision,
            f"measured parse+extract ladders: staged {t_staged * 1e3:.3f} ms vs structural "
            f"{t_structural * 1e3:.3f} ms (structural must win {host_pool.PROBE_MARGIN}x; "
            "engine-sticky)", dict(probe))

    # ------------------------------------------------------ host-stage pool
    def _measure_pool_ratio(self, launch: _Launch, batches, counts) -> tuple[float, float]:
        """(t_inline, t_sharded) of this launch run each way, each the best
        of two: the real workload, not a synthetic one, from the explode to
        the sealed output batches -- what the user waits for. Sharded, the
        stages the pool takes run on it: a columnar plan's parse,
        extraction and predicate launches (one a shard) and its framing,
        the explode of payload and host plans, and the seal when the launch
        has ``_SEAL_MIN_BATCHES`` output batches or more. The passes keep
        no stats (the framing arena still counts its buffers); their
        kernel launches are real and count."""
        parts = host_pool.partition_counts(counts, self._host_pool.workers)
        t_inline = t_sharded = float("inf")
        _probing.on = True
        try:
            for _ in range(2):
                t0 = time.perf_counter()
                self._probe_pass(launch, batches, [(0, len(batches))])
                t_inline = min(t_inline, time.perf_counter() - t0)
                t0 = time.perf_counter()
                self._probe_pass(launch, batches, parts)
                t_sharded = min(t_sharded, time.perf_counter() - t0)
        finally:
            _probing.on = False
        return t_inline, t_sharded

    def _probe_pass(self, launch: _Launch, batches, cuts) -> None:
        """One probe pass over the launch's batches, cut into ``cuts`` (one
        cut runs on this thread: the inline path)."""
        plan = launch.plan
        probe = _Launch(self, launch.script_id, launch.policy, plan)
        if isinstance(plan, ColumnarPlan):
            structural = self._parse_path(plan, batches) == "structural"
            paths = plan.flat_paths()
            shards = self._probe_run([(lambda s=s, e=e: self._probe_shard(
                plan, batches[s:e], paths, structural, launch.backend == "host"))
                for s, e in cuts])
            probe.r_out = plan.r_out
            keeps = [probe._shard_keep(shard) for shard in shards]
            parts = self._probe_run([(lambda s=shard, k=keep: probe._frame_shard(s, k))
                                     for shard, keep in zip(shards, keeps)])
            framed = [item for part in parts for item in part]
        else:
            payload = isinstance(plan, PayloadPlan)
            explode = batch_codec.explode_ptrs if payload else batch_codec.explode_batches
            merge = batch_codec.merge_ptrs if payload else batch_codec.merge_exploded
            ex = merge(self._probe_run([(lambda s=s, e=e: explode(batches[s:e]))
                                        for s, e in cuts]))
            if getattr(plan, "kind", None) == "python":
                # a python plan's probe times its explode only, as the JAX
                # engine's does: the user's script runs once a record, in the
                # launch, and its side effects and failures are its own
                return
            self._count_launch(probe, ex.ranges, len(ex.sizes))
            if payload:
                self._dispatch_payload_ptrs(probe, ex)
            else:
                probe.exploded = ex
            framed = probe.framed()
        jobs = [(batch, payload, kept) for batch, (payload, kept) in zip(batches, framed)]
        live = [i for i, (_, _, kept) in enumerate(jobs) if kept]
        chunks = self._seal_chunks(jobs, live) if len(cuts) >= 2 else [live]
        self._probe_run([(lambda idx=idx: self._seal(jobs, idx)) for idx in chunks])

    def _probe_run(self, fns: list) -> list:
        """A probe pass's thunks on the pool (one runs on this thread), each
        with stats off on the thread that runs it."""
        def quiet(fn):
            was, _probing.on = getattr(_probing, "on", False), True
            try:
                return fn()
            finally:
                _probing.on = was

        return self._host_pool.run([(lambda fn=fn: quiet(fn)) for fn in fns])

    def _probe_shard(self, plan: ColumnarPlan, batches, paths, structural: bool,
                     host_mask: bool = False) -> _HostShard:
        """A probe pass's shard: the ladder and the predicate (the launch,
        or the host predicate), with no column cache."""
        shard = _HostShard()
        cols, _ = self._shard_ladder(shard, plan, batches, paths, structural)
        if shard.n and cols is not None:
            shard.mask = (self._host_mask(plan, cols) if host_mask
                          else self._predicate_mask(plan, cols))
        return shard

    def _calibrate_host_pool(self, launch: _Launch, batches, counts) -> None:
        """Pin the pool on or off off this launch: sharded must win by
        PROBE_MARGIN. The caller holds the decision lock. A probe that
        raises keeps the inline path (``n_failures_pool_calibration``); an
        inline decision stops the pool's threads."""
        recal, self._recal_pending = self._recal_pending, False
        why = "periodic recalibration" if recal else "first shardable launch calibration"
        try:
            t_inline, t_sharded = self._measure_pool_ratio(launch, batches, counts)
        except Exception as exc:
            if faults.unretried(exc):
                raise
            self._note_failure("pool_calibration", exc)
            self._pool_decision = "inline"
            self.governor.record(
                governor.HOST_POOL, "inline",
                f"{why} FAILED ({faults.kind_of(exc)}); keeping the inline path",
                {"error": faults.kind_of(exc), "workers": self._host_workers})
        else:
            ratio = t_inline / t_sharded if t_sharded > 0 else 0.0
            self._pool_decision = "sharded" if ratio >= host_pool.PROBE_MARGIN else "inline"
            self._host_pool_probe = {
                "t_inline_ms": round(t_inline * 1e3, 3),
                "t_sharded_ms": round(t_sharded * 1e3, 3),
                "speedup": round(ratio, 3),
                "workers": self._host_workers,
                "chosen": self._pool_decision,
            }
            logger.info("host pool calibration: %s", self._host_pool_probe)
            self.governor.record(
                governor.HOST_POOL, self._pool_decision,
                f"{why}: the launch's host path (explode to sealed batches) {ratio:.3f}x "
                f"faster sharded, against margin {host_pool.PROBE_MARGIN} at "
                f"{self._host_workers} workers",
                dict(self._host_pool_probe, recalibration=recal))
        if self._pool_decision == "inline":
            self._host_pool.shutdown()

    def _dispatch_sharded(self, launch: _Launch, plan, batches) -> bool:
        """Shard the launch's host stages over the pool; False sends it down
        the inline path: no pool, fewer than ``_SHARD_MIN_ROWS`` records or
        two shards, an inline decision, or a faulted shard worker (counted
        as ``n_failures_shard_worker``; the inline path then runs every
        stage again from the batches, on the card as before). The decision
        is taken, or measured again every ``host_pool_recal_launches``
        shardable launches, under one lock. While the dispatch breaker is not
        closed a columnar launch stays inline: its one launch is the
        half-open probe. A shard refused by the breaker, or an unretried
        failure, fails the launch instead of degrading it. The shards'
        predicate follows ``force_mode`` or the process-wide columnar backend;
        while an engine that follows the backend has no verdict, a columnar
        launch stays inline, where it probes (and then the pool probe, if it
        runs, times the predicate the shards will run)."""
        pool = self._host_pool
        if pool is None or len(batches) < 2:
            return False
        if isinstance(plan, ColumnarPlan) and plan.dev_cols:
            if launch.backend is None:
                return False  # no verdict yet: this launch probes inline
            if launch.backend == "device" and self._breaker.state != faults.STATE_CLOSED:
                return False
        counts = [b.header.record_count for b in batches]
        if sum(counts) < _SHARD_MIN_ROWS:
            return False
        parts = host_pool.partition_counts(counts, pool.workers)
        if len(parts) < 2:
            # skewed batches collapse to one shard; never calibrate on one
            # (a one-thunk run is the inline path)
            return False
        with self._pool_decision_lock:
            decision = self._pool_decision
            if self._probe_enabled and self._recal_interval > 0 and decision is not None:
                self._launches_since_cal += 1
                if self._launches_since_cal >= self._recal_interval:
                    if self._host_pool_probe is not None:
                        self._host_pool_probe_prev = dict(self._host_pool_probe)
                    decision = self._pool_decision = None
                    self._launches_since_cal = 0
                    self._recal_pending = True
            if decision is None:
                self._calibrate_host_pool(launch, batches, counts)
                decision = self._pool_decision
        if decision != "sharded":
            return False
        if isinstance(plan, ColumnarPlan):
            paths = plan.flat_paths()
            # one parse ladder per launch, decided (maybe probed) here: the
            # shards must not race the probe or mix ladders
            structural = self._parse_path(plan, batches) == "structural"
            thunks = [(lambda s=s, e=e: self._run_columnar_shard(
                launch, plan, batches[s:e], paths, structural)) for s, e in parts]
        else:  # payload and host plans: only the explode is per-record work
            explode = (batch_codec.explode_ptrs if isinstance(plan, PayloadPlan)
                       else batch_codec.explode_batches)
            thunks = [(lambda s=s, e=e: _explode_shard(explode, batches[s:e])) for s, e in parts]
        t0 = time.perf_counter()
        try:
            got = pool.run(thunks)
        except Exception as exc:
            # masks the other shards handed over are nobody's now
            self._abandon_pending_masks(launch)
            if faults.unretried(exc) or isinstance(exc, faults.DeviceUnavailable):
                raise
            self._note_failure("shard_worker", exc)
            return False
        if isinstance(plan, ColumnarPlan):
            self._stat("t_sharded_dispatch", t0)
            launch.shards = got
            launch.r_out = plan.r_out
            self._count_launch(launch, *_join_shards(got))
        elif isinstance(plan, PayloadPlan):
            pe = batch_codec.merge_ptrs(got)
            self._stat("t_explode_ptrs", t0)
            self._count_launch(launch, pe.ranges, len(pe.sizes))
            self._dispatch_payload_ptrs(launch, pe)
        else:
            exploded = batch_codec.merge_exploded(got)
            self._stat("t_explode", t0)
            self._count_launch(launch, exploded.ranges, len(exploded.sizes))
            launch.exploded = exploded
        self._stat_add("n_sharded_launches", 1)
        return True

    def _shard_cache_key(self, script_id: int, batches) -> tuple | None:
        """A shard's column-cache key: the launch-wide key's fingerprint over
        the shard's batches, so every shard of a repeated launch hits."""
        if self._colcache is None or not batches:
            return None
        return (script_id, colcache.fingerprint(batches))

    def _shard_cache_entry(self, shard: _HostShard, plan: ColumnarPlan, cols, n_pad: int,
                           structural: bool) -> colcache.Entry:
        """The cache entry of a shard's just-run ladder (the pool and mesh
        lanes share it)."""
        return colcache.Entry(
            n=shard.n, n_pad=n_pad, ranges=shard.ranges, cols=cols,
            proj_data=shard.proj_data, proj_ok=shard.proj_ok,
            exploded=shard.exploded if plan.passthrough else None,
            parse_mode="structural" if structural else "staged",
        )

    def _shard_from_entry(self, shard: _HostShard, plan: ColumnarPlan, entry, n_pad: int):
        """Fill a shard from a cached entry (no ladder) and return its host
        columns fitted to ``n_pad``."""
        shard.n = entry.n
        shard.ranges = list(entry.ranges)
        if plan.passthrough:
            shard.exploded = entry.exploded
            shard.proj_ok = np.ones(entry.n, dtype=bool)
        else:
            shard.proj_data, shard.proj_ok = entry.proj_data, entry.proj_ok
        return _fit_cols(entry.cols, n_pad)

    def _shard_ladder(self, shard: _HostShard, plan: ColumnarPlan, batches, paths,
                      structural: bool, n_pad: int | None = None):
        """One shard's parse and extraction (no predicate): explode and find
        (structural or staged), the predicate columns, the projection. Fills
        ``shard`` and returns (cols, n_pad); ``n_pad`` pins the row bucket
        (the mesh lane's one bucket for all shards), None buckets the
        shard's own records. Stages land under ``t_shard_*``."""
        t0 = time.perf_counter()
        cols = cache = fused_proj = None
        if structural and paths:
            sp = batch_codec.explode_find_structural(batches, paths,
                                                     need_joined=plan.byte_identity)
            self._stat("t_shard_explode_find2", t0)
            shard.ranges, n = sp.ranges, sp.n
            shard.n = n
            if n == 0:
                shard.proj_ok = np.zeros(0, dtype=bool)
                return None, n_pad or 0
            shard.exploded = sp.exploded() if plan.byte_identity else None
            t0 = time.perf_counter()
            n_pad = n_pad or _bucket_rows(n)
            cols, proj_data, proj_ok = plan.extract_fused(sp, n_pad)
            self._stat("t_shard_fused_extract", t0)
            fused_proj = (proj_data, proj_ok)
        else:
            fused = batch_codec.explode_and_find(batches, paths) if paths else None
            if fused is not None:
                ex, types, vs, ve = fused
                cache = plan.make_cache_from_tables(ex, paths, types, vs, ve)
                self._stat("t_shard_explode_find", t0)
            else:
                ex = batch_codec.explode_batches(batches)
                self._stat("t_shard_explode", t0)
            shard.exploded = ex
            shard.ranges, n = ex.ranges, len(ex.sizes)
            shard.n = n
            if n == 0:
                shard.proj_ok = np.zeros(0, dtype=bool)
                return None, n_pad or 0
            if plan.dev_cols:
                t0 = time.perf_counter()
                n_pad = n_pad or _bucket_rows(n)
                cols = plan.extract_device_inputs(ex.joined, ex.offsets, ex.sizes, n_pad, cache)
                self._stat("t_shard_extract_pred", t0)
        if plan.passthrough:
            shard.proj_ok = np.ones(n, dtype=bool)
        elif fused_proj is not None:
            shard.proj_data, shard.proj_ok = fused_proj
        else:
            t0 = time.perf_counter()
            shard.proj_data, shard.proj_ok = plan.extract_projection(
                ex.joined, ex.offsets, ex.sizes, cache)
            shard.exploded = None  # framing reads proj_data, not the records
            self._stat("t_shard_extract_proj", t0)
        return cols, (n_pad or 0)

    def _run_columnar_shard(self, launch: _Launch, plan: ColumnarPlan, batches, paths,
                            structural: bool) -> _HostShard:
        """One shard on a pool worker: its column-cache consult (a hit skips
        the ladder), its ladder, the predicate over its own columns (on a
        card one K1 leg on the engine's stream, handed to the harvest
        thread, so it overlaps the other shards' extraction; the host
        predicate under a "host" backend: a hit's device block is then
        dropped from the cache), and its cache entry."""
        faults.inject(faults.SHARD_WORKER)
        shard = _HostShard()
        key = self._shard_cache_key(launch.script_id, batches)
        entry = dev_block = store_entry = None
        if key is not None:
            entry = self._colcache.lookup(key)
            self._count_colcache(entry is not None)
        if entry is not None:
            n_pad = _bucket_rows(entry.n) if entry.n else 0
            cols = self._shard_from_entry(shard, plan, entry, n_pad)
            if entry.cols_dev is not None and entry.n_pad == n_pad:
                dev_block = entry.cols_dev
        else:
            cols, n_pad = self._shard_ladder(shard, plan, batches, paths, structural)
            if key is not None and shard.n and cols is not None:
                store_entry = self._shard_cache_entry(shard, plan, cols, n_pad, structural)
        if shard.n and cols is not None and launch.backend == "host":
            shard.mask = self._host_mask(plan, cols, "t_shard_dispatch", launch.trace_id)
            if dev_block is not None:
                self._colcache.drop_device(key, entry)
        elif shard.n and cols is not None:
            shard.mask = self._predicate_mask(plan, cols, store_entry, dev_block,
                                              stage="t_shard_dispatch", trace_id=launch.trace_id)
            with launch._lock:
                launch.pending_slots.append(shard.mask)
        if store_entry is not None:
            # after the launch, so that the entry holds its device block
            self._store(key, store_entry)
        return shard

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

    def _dispatch_columnar_cached(self, launch, plan: ColumnarPlan, key, entry) -> None:
        """A column-cache hit: no host dispatch stage runs, and the predicate
        reads the entry's columns -- on a card the device block the cold
        launch left there, so nothing is copied up (under a "host" backend
        the host predicate reads the host columns, and the device block,
        which no launch will read again, leaves the cache). The arrays are
        the cold launch's, so the reply is bit-identical."""
        self._count_launch(launch, list(entry.ranges), entry.n)
        launch.r_out = plan.r_out
        if plan.passthrough:
            launch.proj_ok = np.ones(entry.n, bool)
            launch.exploded = entry.exploded
        else:
            launch.proj_data, launch.proj_ok = entry.proj_data, entry.proj_ok
        self._dispatch_predicate(launch, plan, entry.cols, dev_block=entry.cols_dev)
        if entry.cols_dev is not None and launch.backend == "host":
            self._colcache.drop_device(key, entry)

    def _store(self, key, entry: colcache.Entry) -> None:
        entry.nbytes = entry._measure()  # with the device block, once copied up
        self._colcache.put(key, entry)

    def _dispatch_predicate(self, launch, plan: ColumnarPlan, cols, entry=None,
                            dev_block=None) -> None:
        """The predicate over a launch's columns: the one-batch mesh lane
        when it takes the launch, else the single-card leg: the host
        predicate when ``force_mode`` or the columnar backend says so, else
        one K1 leg on the engine's stream. ``entry`` (a cache entry being
        built) keeps the device block the columns are copied into;
        ``dev_block`` is such a block from a hit, launched over as it is.
        ``cols`` are always the host columns (the probe's and the host
        predicate's)."""
        if not plan.dev_cols:
            return
        if dev_block is None and self._dispatch_mesh_blocks(launch, plan, cols):
            return
        if self._predicate_on_host(launch, plan, cols):
            launch.mask = self._host_mask(plan, cols, trace_id=launch.trace_id)
            return
        launch.mask = self._predicate_mask(plan, cols, entry, dev_block, trace_id=launch.trace_id)

    # ------------------------------------------------------ columnar backend
    def _settled_backend(self) -> str | None:
        """Where this engine's columnar predicate runs, when that is settled:
        "host" under ``force_mode="columnar_host"``, "device" under another
        pin or on an engine that does not follow the process-wide backend,
        else that backend (None while it is not measured). An engine that
        follows the backend notes a verdict it adopts as posture (the probe
        that made it journaled it)."""
        backend = TorchEngine.sticky_columnar_backend() if self._backend_probe else None
        if backend is not None:
            self.governor.note_posture(governor.COLUMNAR_BACKEND, backend)
        if self._force_mode == "columnar_host":
            return "host"
        if self._force_mode is not None or not self._backend_probe:
            return "device"
        return backend

    def _predicate_on_host(self, launch, plan: ColumnarPlan, cols) -> bool:
        """The single-card leg's choice: the launch's settled backend. With
        no verdict yet, a launch of ``_PROBE_MIN_ROWS`` padded rows or more
        probes, double-checked under the run lock (concurrent first launches
        probe once; the losers adopt the winner's verdict), and settles on
        the verdict; a smaller one launches K1 and pins nothing."""
        if launch.backend is None and len(cols[0]) >= _PROBE_MIN_ROWS:
            with TorchEngine._columnar_probe_run_lock:
                if TorchEngine.sticky_columnar_backend() is None:
                    self._probe_columnar_backend(plan, cols)
            launch.backend = self._settled_backend()
        return launch.backend == "host"

    def _probe_host_leg(self, plan: ColumnarPlan, cols) -> float:
        """The probe's host leg: seconds of one host predicate."""
        t0 = time.perf_counter()
        plan.eval_host_mask(cols)
        return time.perf_counter() - t0

    def _probe_device_leg(self, plan: ColumnarPlan, cols) -> float:
        """The probe's device leg, run on a fetch worker on a card: a
        warm-up K1 leg through ``_run_leg`` with its fetch (the kernel's
        build on a first use, the staging slot's growth), then the seconds
        of one more leg and fetch -- host columns packed, copied up,
        evaluated, the bits down and copied out -- timed inside the leg (the
        worker's hand-offs are not the leg's). Its stats are not kept; its
        launches count under the kernel."""
        faults.inject(faults.DEVICE_DISPATCH)
        self._unkept_leg(plan, cols)
        t0 = time.perf_counter()
        self._unkept_leg(plan, cols)
        return time.perf_counter() - t0

    def _unkept_leg(self, plan: ColumnarPlan, cols) -> np.ndarray:
        """K1's leg and fetch (``_run_leg``) for a probe: its keep bits,
        with its stats not kept; its launch counts under the kernel."""
        was, _probing.on = getattr(_probing, "on", False), True
        try:
            return self._run_leg(plan, cols).wait(self)
        finally:
            _probing.on = was

    def _probe_columnar_backend(self, plan: ColumnarPlan, cols) -> None:
        """Measure the process-wide columnar backend on this launch's host
        columns: the host predicate against K1's launch and fetch; the
        device must win by ``_PROBE_DEVICE_MARGIN``. The verdict is
        published under the field lock and journaled (COLUMNAR_BACKEND). A
        device leg that fails, errs or outlives ``_PROBE_DEVICE_TIMEOUT_S``
        is one ``coproc_failures_total{domain="columnar_probe"}`` sample and
        raises into the script's error policy, with no verdict published:
        the next eligible launch probes again (the JAX engine picks the
        host). The caller holds the run lock."""
        t_host = self._probe_host_leg(plan, cols)
        deadline = _PROBE_DEVICE_TIMEOUT_S if self._leg_deadlines else None
        try:
            t_dev = faults.fetch_with_deadline(lambda: self._probe_device_leg(plan, cols),
                                               deadline)
        except Exception as exc:
            exc.rp_counted = True  # the policy boundary does not count it again
            faults.note_failure("columnar_probe", exc)
            raise
        chosen = "device" if t_dev * _PROBE_DEVICE_MARGIN < t_host else "host"
        probe = {
            "t_host_s": round(t_host, 6),
            "t_device_s": round(t_dev, 6),
            "margin": _PROBE_DEVICE_MARGIN,
            "chosen": chosen,
        }
        with TorchEngine._columnar_probe_lock:
            TorchEngine._columnar_backend = chosen
            TorchEngine._columnar_probe = probe
        logger.info("columnar backend probe: %s", probe)
        self.governor.record(
            governor.COLUMNAR_BACKEND, chosen,
            f"measured predicate leg: host {t_host * 1e3:.3f} ms vs device "
            f"{t_dev * 1e3:.3f} ms (device must win {_PROBE_DEVICE_MARGIN}x; process-sticky)",
            dict(probe))

    def _host_mask(self, plan: ColumnarPlan, cols, stage: str = "t_dispatch",
                   trace_id: int | None = None) -> _MaskSlot:
        """The host predicate over a launch's host columns: no K1 launch,
        nothing copied up; the bits reach harvest as a completed slot."""
        t0 = time.perf_counter()
        slot = _MaskSlot(None, trace_id)
        slot.bits = plan.eval_host_mask(cols)
        self._stat(stage, t0)
        self._stat_add("n_host_predicate", 1)
        return slot

    def _predicate_mask(self, plan: ColumnarPlan, cols, entry=None, dev_block=None,
                        stage: str = "t_dispatch", trace_id: int | None = None) -> _MaskSlot:
        """One K1 leg over host columns or a hit's device block, under the
        dispatch domain's envelope; its mask is handed to the harvest
        thread."""
        def leg():
            faults.inject(faults.DEVICE_DISPATCH)
            return self._run_leg(plan, cols, entry, dev_block, stage)

        slot = _MaskSlot(self._try_device_leg(faults.DEVICE_DISPATCH, leg), trace_id)
        self._publish_mask(slot)
        return slot

    def _dispatch_mesh(self, launch: _Launch, plan: ColumnarPlan, batches) -> bool:
        """The mesh lane over the range shard of the launch's batches: each
        shard's column-cache consult, parse and extraction at the launch's
        common row bucket (on the pool when there is one), then the stacked
        predicate (K2), one launch per card. False sends the launch down the
        other lanes: no predicate, ``force_mode="columnar_host"``, fewer
        than two batches or no record, a
        "single" decision, a launch too small to probe on (or, after a
        measured pin, to be worth the mesh), a calibration running, a
        faulted shard worker (``n_failures_shard_worker``; the mesh counts a
        demotion), or the mesh_dispatch breaker refusing the mesh leg (a
        demotion, journaled). An exhausted mesh leg raises into the script's
        error policy, as a failed single-lane launch does."""
        runner = self._meshrunner
        if not plan.dev_cols or self._force_mode == "columnar_host":
            return False
        decision = runner.decision
        counts = [b.header.record_count for b in batches]
        n = sum(counts)
        if decision == "single" or n == 0 or len(batches) < 2:
            return False
        if n < meshrunner.PROBE_MIN_ROWS and (decision is None or runner.probe_enabled):
            # too small to probe on, or a trickle after a measured pin: the
            # single lane is cheaper; a pinned mesh (probe off) takes all
            return False
        if decision is None and runner.probe_lock_busy:
            return False  # another launch is calibrating: this one goes single
        if self.governor.breaker_for(faults.MESH_DISPATCH).state == faults.STATE_OPEN:
            return self._demote_mesh()
        parts = runner.shard_ranges(counts)
        structural = self._parse_path(plan, batches) == "structural"
        paths = plan.flat_paths()
        n_pad = _bucket_rows(max(sum(counts[s:e]) for s, e in parts))
        t0 = time.perf_counter()
        thunks = [(lambda s=s, e=e: self._run_mesh_shard(
            launch, plan, batches[s:e], paths, structural, n_pad)) for s, e in parts]
        pool = self._host_pool
        try:
            results = (pool.run(thunks) if pool is not None and len(thunks) >= 2
                       else [t() for t in thunks])
        except Exception as exc:
            if faults.unretried(exc):
                raise
            self._note_failure("shard_worker", exc)
            runner.note_demotion()
            return False
        self._stat("t_mesh_ladder", t0)
        shards = [shard for shard, _ in results]
        shard_cols = [cols for _, cols in results]
        zeros = plan.zero_device_inputs(n_pad)
        stacked = [np.stack([shard_cols[d][i] if d < len(shard_cols) and shard_cols[d] is not None
                             else zeros[i] for d in range(runner.n_devices)])
                   for i in range(len(zeros))]
        if decision is None:
            # the single lane's own columns: each shard's records, joined,
            # padded to the launch's bucket
            flat = [_fit_cols([np.concatenate([c[i][: sh.n] for sh, c in zip(shards, shard_cols)
                                               if c is not None])], _bucket_rows(n))[0]
                    for i in range(len(zeros))]
            if runner.maybe_calibrate(plan, stacked, flat, self._unkept_leg, n,
                                      governor=self.governor) != "mesh":
                return False
        launch.r_out = plan.r_out
        pending = self._mesh_leg(plan, stacked, n_pad)
        if pending is None:
            return self._demote_mesh()
        slot = _MaskSlot(pending, launch.trace_id)
        self._publish_mask(slot)
        for d, (shard, cols) in enumerate(zip(shards, shard_cols)):
            if shard.n and cols is not None:
                shard.mask, shard.row = slot, d
        launch.shards = shards
        self._count_launch(launch, *_join_shards(shards))
        runner.note_launch([shard.n for shard in shards])
        self.governor.record_mode(
            governor.MESH, "mesh",
            f"stacked launch over the {runner.n_devices}-shard mesh: the host-pool range "
            "shard, one predicate launch per card",
            {"devices": runner.n_devices, "rows": launch.n}, key="path")
        self._stat_add("n_mesh_launches", 1)
        return True

    def _mesh_leg(self, plan: ColumnarPlan, stacks: list[np.ndarray], n_blk: int):
        """The mesh lane's stacked launch under the mesh_dispatch domain's
        envelope; None when the breaker refuses it (the launch goes single)."""
        def leg():
            faults.inject(faults.MESH_DISPATCH)
            return self._run_mesh(plan, stacks, n_blk)

        try:
            return self._try_device_leg(faults.MESH_DISPATCH, leg)
        except faults.DeviceUnavailable:
            return None

    def _demote_mesh(self) -> bool:
        """A mesh-eligible launch sent down the single-card lane by the
        mesh_dispatch breaker: counted and journaled; False for the caller."""
        self._meshrunner.note_demotion()
        self.governor.record_mode(
            governor.MESH, "single",
            "mesh_dispatch breaker open: mesh launches demoted to the single-card lane",
            {"devices": self._meshrunner.n_devices}, key="path")
        return False

    def _run_mesh_shard(self, launch: _Launch, plan: ColumnarPlan, batches, paths,
                        structural: bool, n_pad: int) -> tuple[_HostShard, list | None]:
        """One mesh shard's host ladder (a pool worker or inline): its
        column-cache consult, its parse and extraction at the launch's
        common row bucket, its cache entry. The predicate is one stacked
        launch per card after the stacks are assembled."""
        faults.inject(faults.SHARD_WORKER)
        shard = _HostShard()
        key = self._shard_cache_key(launch.script_id, batches)
        entry = self._colcache.lookup(key) if key is not None else None
        if key is not None:
            self._count_colcache(entry is not None)
        if entry is not None:
            return shard, self._shard_from_entry(shard, plan, entry, n_pad)
        cols, _ = self._shard_ladder(shard, plan, batches, paths, structural, n_pad=n_pad)
        if key is not None and shard.n and cols is not None:
            self._store(key, self._shard_cache_entry(shard, plan, cols, n_pad, structural))
        return shard, cols

    def _dispatch_mesh_blocks(self, launch, plan: ColumnarPlan, cols) -> bool:
        """A one-batch launch cannot be range-sharded: on a mesh pinned by
        ``mesh_probe=False`` it runs as D equal row blocks of the padded
        launch through the stacked predicate (the JAX engine's ``mesh=``
        lane). False for the single lane."""
        runner = self._meshrunner
        n = launch.n
        if (runner is None or n == 0 or len(launch.ranges) >= 2
                or self._force_mode == "columnar_host"
                or runner.decision != "mesh" or runner.probe_enabled):
            return False
        if self.governor.breaker_for(faults.MESH_DISPATCH).state == faults.STATE_OPEN:
            return self._demote_mesh()
        d = runner.n_devices
        blk = -(-_bucket_rows(n) // (8 * d)) * 8
        rec = [(min(k * blk, n), min((k + 1) * blk, n)) for k in range(d)]
        t0 = time.perf_counter()
        stacks = []
        for col, zero in zip(cols, plan.zero_device_inputs(blk)):
            stack = np.repeat(zero[None], d, axis=0)
            for k, (s, e) in enumerate(rec):
                stack[k, : e - s] = col[s:e]
            stacks.append(stack)
        self._stat("t_mesh_ladder", t0)
        pending = self._mesh_leg(plan, stacks, blk)
        if pending is None:
            return self._demote_mesh()
        launch.mesh_rows = [e - s for s, e in rec]
        launch.mask = _MaskSlot(pending, launch.trace_id)
        self._publish_mask(launch.mask)
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
        inputs = self._meshrunner.stack_and_put(stacks)
        if mesh.type != "cuda":
            host[:] = plan.predicate_blocks([[t[d] for t in inputs] for d in range(mesh.size)],
                                            kernels.PREDICATE_STACKED)
            self._stat("t_dispatch", t0)
            return _Pending(host)
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
        self._launch_payload(launch, pe.sizes,
                             lambda staged: pack_staged_ptrs(pe, self._row_stride, staged))

    def _launch_payload(self, launch, sizes: np.ndarray, pack) -> None:
        prog = self._programs[launch.script_id]
        launch.r_out = prog.r_out
        launch.fits = sizes <= self._row_stride
        if launch.n == 0:
            return
        t0 = time.perf_counter()
        staged = torch.empty(
            (_bucket_rows(launch.n), self._row_stride + IN_META), dtype=torch.uint8,
            pin_memory=self._stream is not None,
        )
        pack(staged.numpy())
        self._stat("t_pack", t0)

        def leg():
            faults.inject(faults.DEVICE_DISPATCH)
            return self._run_device([staged], lambda t: run_packed(prog, t[0]),
                                    "payload_transform")

        launch.pending = self._try_device_leg(faults.DEVICE_DISPATCH, leg)

    def _run_device(self, inputs: list[torch.Tensor], run, kernel: str) -> _Pending:
        """Host inputs -> device -> ``run`` (one kernel launch) -> pinned
        host result, all enqueued on the engine's stream from any thread (the
        current device and stream are entered here, since PyTorch keeps them
        per thread); on the CPU device ``run`` executes the plain version at
        once. The returned _Pending keeps every tensor the stream still
        reads or writes until the result is fetched."""
        t0 = time.perf_counter()
        self._stat_add(f"n_kernel_{kernel}", 1)
        if self._stream is None:
            out = run(inputs)
            self._stat("t_dispatch", t0)
            return _Pending(out)
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            marks[0].record()
            t_enq = time.perf_counter()
            dev = [t.to(self.device, non_blocking=True) for t in inputs]
            # the host's share of the copy-up interval between marks 0 and 1
            self._stat("t_h2d_enqueue", t_enq)
            marks[1].record()
            out = run(dev)
            marks[2].record()
            host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
            host.copy_(out, non_blocking=True)
            marks[3].record()
        self._stat("t_dispatch", t0)
        self._stat_add("bytes_h2d", sum(t.nbytes for t in inputs))
        self._stat_add("bytes_d2h", host.nbytes)
        return _Pending(host, [marks], (inputs, dev, out))

    def _run_leg(self, plan: ColumnarPlan, cols, entry=None, dev_block=None,
                 stage: str = "t_dispatch") -> _Pending:
        """K1's leg over a launch's host columns (numpy, ``n_pad`` rows):
        they are packed into a staging slot's host block, one host copy a
        column (``ColumnarPlan.block_layout``), and on a card one native
        crossing (``ColumnarPlan.predicate_leg``) enqueues on the engine's
        stream the copy up into the slot's device block, the kernel, the
        bits' copy down into the slot's pinned output and the slot's four
        events; on the CPU the plain version runs over views of the block.
        ``entry`` (a cache entry being built) gets a device block of its own
        for the copy up, which it keeps; ``dev_block`` (a hit's) is launched
        over with no copy up. ``t_leg_enqueue`` is the host's time in the
        crossing. The _Pending holds the slot until its bits are fetched."""
        t0 = time.perf_counter()
        n_pad = len(cols[0])
        lay = plan.block_layout(n_pad)
        nb = n_pad // 8
        slot = self._leg_slots.acquire(lay.total, nb, plan.spill_words() * n_pad)
        stats = [("n_kernel_predicate", 1)]
        try:
            if self._stream is None:
                lay.pack(cols, slot.host_np)
                plan.predicate_leg(n_pad, slot.host, slot.bits)
                copied = False
            else:
                copied = dev_block is None
                with torch.cuda.device(self.device):
                    if copied:
                        lay.pack(cols, slot.host_np)
                        dev_block = slot.dev
                        if entry is not None:
                            with torch.cuda.stream(self._stream):
                                dev_block = torch.empty(lay.total, dtype=torch.uint8,
                                                        device=self.device)
                    t_enq = time.perf_counter()
                    plan.predicate_leg(n_pad, dev_block, slot.bits,
                                       host_block=slot.host if copied else None,
                                       bits_host=slot.bits_host, scratch=slot.scratch,
                                       events=slot.events, stream=self._stream.cuda_stream)
                    stats.append(("t_leg_enqueue", time.perf_counter() - t_enq))
                stats += [("bytes_h2d", lay.total)] if copied else []
                stats.append(("bytes_d2h", nb))
        except BaseException:
            self._leg_slots.release(slot)
            self._stat_add("n_kernel_predicate", 1)
            raise
        if copied and entry is not None:
            # made on the engine's stream, which every hit launches on too
            entry.cols_dev = dev_block
        stats.append((stage, time.perf_counter() - t0))
        self._stat_many(stats)
        pending = _Pending(None, refs=dev_block, slot=slot, nb=nb)
        self._leg_slots.bind(slot, pending)
        return pending


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
