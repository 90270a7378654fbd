"""The partition mesh: an ordered list of devices in one process.

The JAX package lays the partition axis of its data-plane arrays over a
1-D ``jax.sharding.Mesh`` whose axis is ``'p'``, and drives every device of
it from one Python process (parallel/mesh.py there). The port's mesh is the
same thing: ``PartitionMesh`` is an ordered tuple of ``torch.device`` with
one CUDA stream per shard, and shard d of an array is its d-th block on
the leading axis, held on ``devices[d]``. The mesh programs run once per
card, not once per shard: each card's shard blocks are placed with one copy
(``local_blocks``) and read by one kernel launch through a table of block
pointers, on the caller's current stream of that card (``card_groups``,
``card_chunks``). The one collective, the vote tally's sum, adds the cards'
partials on ``devices[0]`` (parallel/collectives.py). The shard streams
serve ``shard_to_mesh`` and the engine's mesh lane, which makes a card's
first shard stream current for that card's work (coproc/engine.py); the
mesh programs run on whatever stream is current.

A mesh may name one card several times (``devices=[cuda:0] * 4``): a
*virtual mesh*, the counterpart of the JAX package's virtual CPU devices.
Its shards share one card (one launch of each per-card program over all
four shards), so it runs every mesh kernel and every copy, but measures
nothing about scaling across cards.
``device="cpu"`` gives CPU shards, on which the kernels' plain versions run
synchronously: the tests' stand-in.

Every function of the mesh modules leaves its results ready on the
caller's current stream of each device. Work on the shard streams first
waits for the caller's streams (``fork``), and the caller's streams wait for
the shard streams at the end (``join``); work that runs only on the
caller's current streams (every mesh program, over ``local_blocks``) needs
neither.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from redpanda_tpu_torch.device import resolve_device

PARTITION_AXIS = "p"


class PartitionMesh:
    """An ordered tuple of devices over the partition axis ``'p'``, with
    one CUDA stream per shard (None on the CPU)."""

    axis = PARTITION_AXIS

    def __init__(self, devices):
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"a mesh's devices must be of one type, got {devs}")
        self.devices = devs
        self.streams = tuple(
            torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in devs
        )

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def type(self) -> str:
        return self.devices[0].type

    def __repr__(self) -> str:
        return f"PartitionMesh({[str(d) for d in self.devices]})"

    @contextlib.contextmanager
    def shard(self, d: int):
        """Run the block under it on shard d's device and stream."""
        stream = self.streams[d]
        if stream is None:
            yield
            return
        with torch.cuda.device(self.devices[d]), torch.cuda.stream(stream):
            yield

    def fork(self) -> None:
        """Each shard stream waits for the caller's current stream of its
        device, so the shards see what the caller enqueued before."""
        for dev, stream in zip(self.devices, self.streams):
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(dev))

    def join(self, *tensors: torch.Tensor) -> None:
        """The caller's current stream of each device waits for every shard
        stream, and each tensor is marked as used on the caller's stream of
        its device so that its memory is not reused before that."""
        if self.type != "cuda":
            return
        for dev, stream in zip(self.devices, self.streams):
            torch.cuda.current_stream(dev).wait_stream(stream)
        for t in tensors:
            t.record_stream(torch.cuda.current_stream(t.device))


class Sharded:
    """An array laid out over a mesh's partition axis: ``blocks[d]`` is its
    d-th block on the leading axis, held on ``mesh.devices[d]``.
    ``numpy()`` (or ``np.asarray``) gathers it on the host."""

    def __init__(self, mesh: PartitionMesh, blocks, keep=()):
        if len(blocks) != mesh.size:
            raise ValueError(f"{len(blocks)} blocks for a {mesh.size}-shard mesh")
        self.mesh = mesh
        self.blocks = tuple(blocks)
        # pinned host blocks whose copies may still be in flight
        self._keep = tuple(keep)

    @property
    def shape(self) -> tuple[int, ...]:
        b = self.blocks[0]
        return (sum(x.shape[0] for x in self.blocks), *b.shape[1:])

    def numpy(self) -> np.ndarray:
        return np.concatenate([b.cpu().numpy() for b in self.blocks])

    def __array__(self, dtype=None, copy=None):
        out = self.numpy()
        return out if dtype is None else out.astype(dtype)


def partition_mesh(n_devices: int | None = None, devices=None, device="cuda") -> PartitionMesh:
    """1-D mesh over the partition axis.

    ``devices`` names the shards explicitly (a device may repeat: a virtual
    mesh on one card). Otherwise the mesh takes the first ``n_devices``
    cards of ``torch.cuda.device_count()`` (all of them when None) and
    raises when there are fewer; ``device="cpu"`` gives ``n_devices`` CPU
    shards (1 when None).
    """
    if devices is None:
        kind = torch.device(device).type
        if kind == "cpu":
            devices = [torch.device("cpu")] * (1 if n_devices is None else int(n_devices))
        else:
            resolve_device(device)  # raises without a card
            have = torch.cuda.device_count()
            want = have if n_devices is None else int(n_devices)
            if want > have:
                raise RuntimeError(
                    f"partition_mesh({want}): only {have} CUDA device(s); name the shards "
                    "with devices=[...] for a virtual mesh on fewer cards"
                )
            devices = [torch.device("cuda", i) for i in range(want)]
    elif n_devices is not None:
        devices = list(devices)[: int(n_devices)]
    return PartitionMesh(devices)


def card_groups(devices) -> tuple[tuple[torch.device, tuple[int, ...]], ...]:
    """The shards of a mesh grouped by the device that holds them: one
    ``(device, shard indices)`` pair per distinct device, in the order of
    each device's first shard, the shards of a group in mesh order. Group 0
    is always ``devices[0]``'s. A virtual mesh on one card, and any CPU
    mesh, is one group."""
    groups: dict[torch.device, list[int]] = {}
    for d, dev in enumerate(devices):
        groups.setdefault(dev, []).append(d)
    return tuple((dev, tuple(shards)) for dev, shards in groups.items())


def card_chunks(devices, cap: int) -> tuple[tuple[torch.device, tuple[int, ...]], ...]:
    """``card_groups`` with each card's shards cut into runs of at most
    ``cap``: the launches of a program whose table holds ``cap`` shards.
    Chunk 0 is always ``devices[0]``'s."""
    if cap < 1:
        raise ValueError(f"a launch must take at least one shard, cap {cap}")
    return tuple((dev, shards[i:i + cap])
                 for dev, shards in card_groups(devices)
                 for i in range(0, len(shards), cap))


def on_device(dev: torch.device):
    """``dev`` as the current CUDA device under it (nothing on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _as_tensor(a) -> torch.Tensor:
    """A numpy array or tensor as a contiguous tensor; uint32 (claimed CRCs)
    travels as its int32 bit pattern, as everywhere in the port."""
    if torch.is_tensor(a):
        return a.contiguous()
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _split(mesh: PartitionMesh, a) -> list[torch.Tensor]:
    """``a``'s ``mesh.size`` equal blocks on its leading axis, as views;
    raises when the axis does not divide, as ``shard_map`` does."""
    t = _as_tensor(a)
    if t.dim() == 0 or t.shape[0] % mesh.size:
        raise ValueError(
            f"leading axis of {tuple(t.shape)} does not divide into {mesh.size} shards"
        )
    k = t.shape[0] // mesh.size
    return [t[d * k : (d + 1) * k] for d in range(mesh.size)]


def shard_to_mesh(mesh: PartitionMesh, *arrays):
    """Split each array on its leading axis into ``mesh.size`` equal blocks
    and put block d on shard d's device: host blocks through pinned memory
    with a ``non_blocking`` copy on shard d's stream. Raises when the
    leading axis does not divide by the mesh size, as ``shard_map`` does.
    A ``Sharded`` argument passes through unchanged."""
    mesh.fork()
    out, moved = [], []
    for a in arrays:
        if isinstance(a, Sharded):
            if a.mesh is not mesh:
                raise ValueError("array is sharded over another mesh")
            out.append(a)
            continue
        blocks, keep = [], []
        for d, (dev, block) in enumerate(zip(mesh.devices, _split(mesh, a))):
            with mesh.shard(d):
                if dev.type == "cuda" and block.device.type == "cpu":
                    block = block.pin_memory()
                    keep.append(block)
                blocks.append(block.to(dev, non_blocking=True).contiguous())
        moved += blocks
        out.append(Sharded(mesh, blocks, keep))
    mesh.join(*moved)
    return tuple(out) if len(out) != 1 else out[0]


def local_blocks(mesh: PartitionMesh, a) -> Sharded:
    """``a`` split over the mesh as ``shard_to_mesh`` splits it, with the
    blocks on ``devices[d]`` placed by one copy per distinct device (of the
    rows of that device's shards) on the caller's current stream there, and
    each block a view of its device's copy (or of ``a`` where it already
    lies there). No shard stream takes part, so work that reads the blocks
    on the current streams needs no fork and no join. A ``Sharded``
    argument passes through unchanged; its blocks are ready on the current
    streams, as every mesh function leaves them."""
    if isinstance(a, Sharded):
        if a.mesh is not mesh:
            raise ValueError("array is sharded over another mesh")
        return a
    t = _as_tensor(a)
    parts = _split(mesh, t)
    k = parts[0].shape[0]
    blocks: list = [None] * mesh.size
    for dev, shards in card_groups(mesh.devices):
        if t.device == dev:
            for d in shards:
                blocks[d] = parts[d]
            continue
        lo, hi = shards[0], shards[-1] + 1
        src = t[lo * k : hi * k] if hi - lo == len(shards) else torch.cat([parts[d] for d in shards])
        rows = src.to(dev, non_blocking=True)  # rows of a contiguous tensor are contiguous
        for i, d in enumerate(shards):
            blocks[d] = rows[i * k : (i + 1) * k]
    return Sharded(mesh, blocks)
