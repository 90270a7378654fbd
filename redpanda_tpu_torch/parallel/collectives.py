"""The mesh's data-plane programs: the vote tally (K7), the sharded CRC
checks (K8, K9) and the full per-tick coproc step (K10).

The JAX package runs each as one ``shard_map`` program over the mesh's
'p' axis (parallel/collectives.py there), one program per device. Here
each is one kernel launch per card over the blocks of that card's shards,
on the caller's current stream of the card; then the one collective, the
tally's sum across cards.

- ``make_vote_aggregator(mesh)``: the vote tally (csrc/vote_tally.cu) in
  one launch per card, on the caller's current stream of that card, over
  every block of u8 votes the card holds (``card_groups``; a card with
  more than 64 shards takes one launch per 64, ``tally_chunks``). On a
  mesh of one card (a virtual mesh) that launch writes the int32 [G]
  tally: one launch, no copy, no stream wait. With C cards each card
  writes an int32 partial, the C - 1 partials of the other cards are
  copied to ``mesh.devices[0]`` and one more launch sums the stacked
  [C, G] partials there. The blocks are placed with ``local_blocks`` on
  the current streams, so the aggregator touches no shard stream. Integer
  sums are exact, so the tally is bit-identical in any order.
- ``make_sharded_crc_check(mesh, r)``: the batch validator over each
  shard's [P/D, B, r] rows with a bad count per partition, in one launch
  of the split CRC kernel per card (per 120 of its shards,
  ``MAX_CRC_SHARDS``) over a table of its shards' blocks
  (csrc/crc_blocks.cu, row ``crc32c_sharded``).
- ``make_crc_vote_step(mesh, r)``: the same (row ``crc32c_vote``) with the
  column sums of the card's votes in the same launch, the cards' partials
  summed as the aggregator sums them: the raft follower plane's step.
- ``make_sharded_coproc_step(mesh, spec_json, r_batch, r_rec)``: the batch
  validator (K6), the payload transform (K3, unpacked) and the vote tally
  (K7) of a card's shards in one launch of the fused step kernel
  (csrc/coproc_step.cu) per card (per 80 of its shards,
  ``MAX_STEP_SHARDS``); the cards' tally partials are summed as the
  aggregator sums them. Each output is one tensor per card, and each
  shard's block a view of it.

Inputs are global numpy arrays or tensors (placed over the mesh with
``local_blocks``: one copy per card on the caller's current stream) or
``Sharded`` arrays; outputs sharded over 'p' are ``Sharded`` (each shard's
block a view of one tensor per card) and the replicated tally is one int32
tensor on ``mesh.devices[0]``. Each ``*_plain`` function is the same
computation in plain PyTorch on whole tensors, built from the kernels'
plain versions. On a CPU mesh every shard runs the plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from redpanda_tpu_torch import kernels
from redpanda_tpu_torch.ops.crc32c_device import (
    MAX_CRC_SHARDS,
    crc_blocks,
    kernel_tables_on,
    validate_plain,
)
from redpanda_tpu_torch.ops.transforms import TransformSpec, compile_transform, transform_plain
from redpanda_tpu_torch.parallel.mesh import (
    PartitionMesh,
    Sharded,
    card_chunks,
    card_groups,
    local_blocks,
    on_device,
)


# ------------------------------------------------------------ K7 kernel wrapper
def vote_tally_plain(votes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch column sums of [rows, G] votes: int32 [G]."""
    return votes.to(torch.int32).sum(0, dtype=torch.int32)


def vote_tally(votes: torch.Tensor) -> torch.Tensor:
    """Column sums (K7) of contiguous uint8 or int32 [rows, G] votes into
    int32 [G]: ``vote_tally_blocks`` over the one block."""
    if votes.dim() != 2 or votes.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"votes must be uint8 or int32 [rows, G], got {votes.dtype} "
                         f"{tuple(votes.shape)}")
    return vote_tally_blocks([votes])


MAX_TALLY_BLOCKS = 64  # the kernel's table of block pointers

# cross-card copies of tally partials made by ``_tally``, a plain count
tally_copies = 0


def vote_tally_blocks(blocks, out: torch.Tensor | None = None) -> torch.Tensor:
    """Column sums (K7) over every row of 1..64 contiguous blocks of one
    device, each uint8 or int32 [rows, G] of one dtype and shape, into
    int32 [G] (written into ``out`` when given). CPU blocks run the plain
    version; CUDA blocks launch the kernel once, on the current stream."""
    blocks = list(blocks)
    if not 1 <= len(blocks) <= MAX_TALLY_BLOCKS:
        raise ValueError(f"1 to {MAX_TALLY_BLOCKS} blocks, got {len(blocks)}")
    b0 = blocks[0]
    for b in blocks:
        if b.dim() != 2 or b.dtype not in (torch.uint8, torch.int32):
            raise ValueError(f"blocks must be uint8 or int32 [rows, G], got {b.dtype} "
                             f"{tuple(b.shape)}")
        if b.shape != b0.shape or b.dtype != b0.dtype or b.device != b0.device:
            raise ValueError("blocks must share one shape, dtype and device")
        if not b.is_contiguous():
            raise ValueError("blocks must be contiguous")
    g = b0.shape[1]
    if out is not None and (out.shape != (g,) or out.dtype != torch.int32
                            or out.device != b0.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous int32 [{g}] tensor on {b0.device}")
    if b0.device.type == "cpu":
        tally = vote_tally_plain(torch.cat(blocks))
        return tally if out is None else out.copy_(tally)
    if b0.device.type != "cuda":
        raise ValueError(f"unsupported device {b0.device}")
    if out is None:
        out = torch.empty(g, dtype=torch.int32, device=b0.device)
    ptrs = (ctypes.c_void_p * len(blocks))(*[b.data_ptr() for b in blocks])
    kernels.VOTE_TALLY.launch(
        ptrs, len(blocks), b0.shape[0], g, int(b0.dtype == torch.int32), out.data_ptr(),
        kernels.stream_handle(b0.device),
    )
    return out


def tally_chunks(devices) -> tuple[tuple[torch.device, tuple[int, ...]], ...]:
    """The tally's launches over a mesh: ``card_groups`` with each card's
    shards cut into runs of at most ``MAX_TALLY_BLOCKS``, one launch each.
    Chunk 0 is always ``devices[0]``'s."""
    return card_chunks(devices, MAX_TALLY_BLOCKS)


def _sum_chunks(mesh: PartitionMesh, chunks, g: int, launch) -> torch.Tensor:
    """The psum over a mesh's chunks of per-card launches: ``launch(dev,
    shards, out)`` enqueues one chunk's work on the current stream of
    ``dev`` and returns its int32 [g] column sums (written into ``out``
    when given). With one chunk its launch writes the tally. With several,
    the chunks on ``devices[0]`` write rows of the stacked partials there
    and every other card's partial is copied into its row (a
    device-to-device ``copy_``, which runs after an event wait on the
    destination's current stream and makes that stream wait for the copy),
    then one tally launch sums the rows. Integer sums are exact, so the
    result is the same in any order."""
    global tally_copies
    dev0 = mesh.devices[0]
    with on_device(dev0):
        if len(chunks) == 1:
            return launch(*chunks[0], None)
        stacked = torch.empty((len(chunks), g), dtype=torch.int32, device=dev0)
        for row, (dev, shards) in enumerate(chunks):
            if dev == dev0:
                launch(dev, shards, stacked[row])
                continue
            with on_device(dev):
                partial = launch(dev, shards, None)
            stacked[row].copy_(partial)
            tally_copies += 1
        return vote_tally(stacked)


def _tally(mesh: PartitionMesh, votes: Sharded) -> torch.Tensor:
    """The psum of every shard's column sums, one launch per chunk of a
    card's shards (``tally_chunks``) on the caller's current stream of that
    card; the blocks must be ready there."""

    def launch(dev, shards, out):
        return vote_tally_blocks([votes.blocks[d] for d in shards], out=out)

    return _sum_chunks(mesh, tally_chunks(mesh.devices), votes.blocks[0].shape[1], launch)


def make_vote_aggregator(mesh: PartitionMesh):
    """fn(votes uint8 [D*k, G]) -> int32 [G] on mesh.devices[0]: total votes
    per group, summed over the shards of each card and then across the
    cards."""

    def aggregate(votes) -> torch.Tensor:
        return _tally(mesh, local_blocks(mesh, votes))

    return aggregate


# ------------------------------------------------------------ K8, K9
def sharded_crc_plain(rows, lens, claimed):
    """Plain PyTorch version of K9 over whole tensors: rows u8 [P, B, r],
    lens i32 [P, B], claimed i32 [P, B] (CRC bit patterns) -> (ok bool
    [P, B], bad int32 [P])."""
    p, b, r = rows.shape
    ok = validate_plain(rows.reshape(p * b, r), lens.reshape(-1), claimed.reshape(-1)).reshape(p, b)
    bad = (~ok & (lens > 0)).sum(1, dtype=torch.int32)
    return ok, bad


def crc_vote_plain(rows, lens, claimed, votes):
    """Plain PyTorch version of K8: (ok bool [D, B], bad int32 [D], tally
    int32 [G])."""
    ok, bad = sharded_crc_plain(rows, lens, claimed)
    return ok, bad, vote_tally_plain(votes)


def _check_crc_blocks(rows: torch.Tensor, lens: torch.Tensor, claimed: torch.Tensor, r: int) -> None:
    if rows.dim() != 3 or rows.shape[2] != r:
        raise ValueError(f"rows must be [P, B, {r}], got {tuple(rows.shape)}")
    if tuple(lens.shape) != tuple(rows.shape[:2]) or tuple(claimed.shape) != tuple(rows.shape[:2]):
        raise ValueError("lens and claimed must be [P, B] like rows")


def _check_blocks(blocks, dtypes, dev: torch.device) -> None:
    for t, dtype in zip(blocks, dtypes):
        if t.dtype != dtype or not t.is_contiguous() or t.device != dev:
            raise ValueError(f"block {tuple(t.shape)} {t.dtype} on {t.device}: expected a "
                             f"contiguous {dtype} block on {dev}")


def _check_crc_args(mesh: PartitionMesh, args, r: int) -> None:
    """Every shard's blocks: rows u8 [p, B, r], lengths and claimed CRCs
    i32 [p, B] and, with a fourth argument, votes u8 [m, G], contiguous and
    on the shard's device."""
    for d in range(mesh.size):
        blocks = [a.blocks[d] for a in args]
        _check_crc_blocks(*blocks[:3], r)
        if len(blocks) > 3 and blocks[3].dim() != 2:
            raise ValueError(f"votes must be [rows, G], got {tuple(blocks[3].shape)}")
        _check_blocks(blocks, (torch.uint8, torch.int32, torch.int32, torch.uint8),
                      blocks[0].device)


def _crc_plain_shards(mesh: PartitionMesh, args):
    """K8/K9 on a CPU mesh: the plain versions shard by shard, and the
    tally (with votes) as the aggregator sums it."""
    oks, bads = zip(*(sharded_crc_plain(*(a.blocks[d] for a in args[:3]))
                      for d in range(mesh.size)))
    return list(oks), list(bads), _tally(mesh, args[3]) if len(args) > 3 else None


def _crc_on_cards(mesh: PartitionMesh, args, r: int, kernel):
    """The split CRC kernel's launches over checked shard blocks: one ok
    and one bad tensor per card (the shards' blocks are views of them), one
    launch of ``kernel`` per ``card_chunks`` entry on the current stream of
    its card and, with votes, the cards' partial tallies summed on
    ``devices[0]``. Returns the per-shard ok and bad blocks and the tally
    (None without votes)."""
    rows, lens, claimed = args[:3]
    votes = args[3] if len(args) > 3 else None
    p, b = rows.blocks[0].shape[:2]
    oks, bads = [None] * mesh.size, [None] * mesh.size
    per_card, where = {}, {}
    for dev, shards in card_groups(mesh.devices):
        per_card[dev] = (torch.empty((len(shards), p, b), dtype=torch.bool, device=dev),
                         torch.empty((len(shards), p), dtype=torch.int32, device=dev))
        for i, d in enumerate(shards):
            oks[d], bads[d], where[d] = per_card[dev][0][i], per_card[dev][1][i], i

    def launch(dev, shards, partial):
        if votes is not None and partial is None:
            partial = torch.empty(votes.blocks[0].shape[1], dtype=torch.int32, device=dev)
        blocks = [(rows.blocks[d].view(p * b, r), lens.blocks[d].view(-1),
                   claimed.blocks[d].view(-1), None if votes is None else votes.blocks[d])
                  for d in shards]
        ok, bad = per_card[dev]
        lo = where[shards[0]]  # a chunk is a run of its card's shards
        crc_blocks(kernel, blocks, r, max(b, 1), ok[lo : lo + len(shards)],
                   bad[lo : lo + len(shards)].view(-1), tally=partial)
        return partial

    chunks = card_chunks(mesh.devices, MAX_CRC_SHARDS)
    if votes is not None:
        return oks, bads, _sum_chunks(mesh, chunks, votes.blocks[0].shape[1], launch)
    for dev, shards in chunks:
        with on_device(dev):
            launch(dev, shards, None)
    return oks, bads, None


def _crc_step(mesh: PartitionMesh, arrays, r: int, kernel):
    args = [local_blocks(mesh, a) for a in arrays]
    _check_crc_args(mesh, args, r)
    if mesh.type == "cuda":
        return _crc_on_cards(mesh, args, r, kernel)
    return _crc_plain_shards(mesh, args)


def make_sharded_crc_check(mesh: PartitionMesh, r: int):
    """fn(rows u8 [P, B, r], lens i32 [P, B], claimed u32 [P, B]) ->
    (ok bool [P, B], bad int32 [P]) as ``Sharded`` arrays: every batch of
    every partition validated on the card that owns the partition, in one
    launch per card, no traffic between cards."""
    r = int(r)

    def check(rows, lens, claimed):
        oks, bads, _ = _crc_step(mesh, (rows, lens, claimed), r, kernels.CRC32C_SHARDED)
        return Sharded(mesh, oks), Sharded(mesh, bads)

    return check


def make_crc_vote_step(mesh: PartitionMesh, r: int):
    """The raft step (BASELINE config 5): fn(rows u8 [D, B, r], lens i32
    [D, B], claimed u32 [D, B], votes u8 [D, G]) -> (ok bool [D, B], bad
    int32 [D], tally int32 [G]): the batch validator with a bad count per
    row of ``rows`` and the column sums of the votes in one launch per
    card, and the cards' partial tallies summed on ``devices[0]``."""
    r = int(r)

    def step(rows, lens, claimed, votes):
        oks, bads, tally = _crc_step(mesh, (rows, lens, claimed, votes), r, kernels.CRC32C_VOTE)
        return Sharded(mesh, oks), Sharded(mesh, bads), tally

    return step


# ------------------------------------------------------------ K10
def coproc_step_plain(prog, b_rows, b_lens, claimed, rec_rows, rec_lens, votes):
    """Plain PyTorch version of K10 over whole tensors: (ok bool [P, B],
    out u8 [P, N, r_out], out_len int32 [P, N], keep bool [P, N], tally
    int32 [G])."""
    p, b, r_batch = b_rows.shape
    ok = validate_plain(b_rows.reshape(p * b, r_batch), b_lens.reshape(-1),
                        claimed.reshape(-1)).reshape(p, b)
    n = rec_rows.shape[1]
    out, out_len, keep = transform_plain(prog, rec_rows.reshape(p * n, -1), rec_lens.reshape(-1))
    return (ok, out.reshape(p, n, -1), out_len.reshape(p, n), keep.reshape(p, n),
            vote_tally_plain(votes))


MAX_STEP_SHARDS = 80  # csrc/coproc_step.cu: six pointers a shard, 480 in its table


def _check_step_blocks(blocks, r_batch: int, r_rec: int) -> None:
    """One shard's six blocks: batch rows u8 [p, B, r_batch], lengths and
    claimed CRCs i32 [p, B], record rows u8 [p, N, r_rec], lengths i32
    [p, N] and votes u8 [p, G], contiguous and on one device."""
    br, bl, cl, rr, rl, v = blocks
    _check_crc_blocks(br, bl, cl, r_batch)
    p = br.shape[0]
    if rr.dim() != 3 or rr.shape[0] != p or rr.shape[2] != r_rec:
        raise ValueError(f"record rows must be [{p}, N, {r_rec}], got {tuple(rr.shape)}")
    if tuple(rl.shape) != tuple(rr.shape[:2]):
        raise ValueError("record lengths must be [P, N] like the record rows")
    if v.dim() != 2 or v.shape[0] != p:
        raise ValueError(f"votes must be [{p}, G], got {tuple(v.shape)}")
    _check_blocks(blocks, (torch.uint8, torch.int32, torch.int32, torch.uint8, torch.int32,
                           torch.uint8), br.device)


def _step_plain_shards(mesh: PartitionMesh, prog, args, r_batch: int, r_rec: int):
    """The step on a CPU mesh: the plain versions shard by shard, and the
    tally as the aggregator sums it."""
    p, b = args[0].blocks[0].shape[:2]
    n = args[3].blocks[0].shape[1]
    oks, outs, out_lens, keeps = [], [], [], []
    for d in range(mesh.size):
        br, bl, cl, rr, rl, _ = (a.blocks[d] for a in args)
        oks.append(validate_plain(br.reshape(p * b, r_batch), bl.reshape(-1),
                                  cl.reshape(-1)).reshape(p, b))
        out, out_len, keep = transform_plain(prog, rr.reshape(p * n, r_rec), rl.reshape(-1))
        outs.append(out.reshape(p, n, prog.r_out))
        out_lens.append(out_len.reshape(p, n))
        keeps.append(keep.reshape(p, n))
    return oks, outs, out_lens, keeps, _tally(mesh, args[5])


def _step_on_cards(mesh: PartitionMesh, prog, args, r_batch: int, r_rec: int):
    """The fused step's launches over checked shard blocks: one output
    tensor of each kind per card (the shards' blocks are views of it), one
    launch per ``card_chunks`` entry on the current stream of its card, and
    the partial tallies summed on ``devices[0]``. Returns the per-shard
    (ok, out, out_len, keep) blocks and the tally."""
    p, b = args[0].blocks[0].shape[:2]
    n, g = args[3].blocks[0].shape[1], args[5].blocks[0].shape[1]
    oks, outs, out_lens, keeps = ([None] * mesh.size for _ in range(4))
    for dev, shards in card_groups(mesh.devices):
        k = len(shards)
        ok = torch.empty((k, p, b), dtype=torch.bool, device=dev)
        out = torch.empty((k, p, n, prog.r_out), dtype=torch.uint8, device=dev)
        out_len = torch.empty((k, p, n), dtype=torch.int32, device=dev)
        keep = torch.empty((k, p, n), dtype=torch.bool, device=dev)
        for i, d in enumerate(shards):
            oks[d], outs[d], out_lens[d], keeps[d] = ok[i], out[i], out_len[i], keep[i]

    def launch(dev, shards, partial):
        if partial is None:
            partial = torch.empty(g, dtype=torch.int32, device=dev)
        table = (ctypes.c_void_p * (6 * len(shards)))(
            *[a.blocks[d].data_ptr() for d in shards for a in args])
        desc, pats = prog.on(dev)
        first = shards[0]  # the chunk's outputs start at its first shard's views
        kernels.COPROC_STEP.launch(
            table, len(shards), p * b, r_batch, kernel_tables_on(dev).data_ptr(),
            oks[first].data_ptr(), p * n, r_rec, outs[first].data_ptr(),
            out_lens[first].data_ptr(), keeps[first].data_ptr(), prog.r_out, desc.data_ptr(),
            prog.n_filters, prog.mapper, prog.n_fields, pats.data_ptr(), p, g,
            partial.data_ptr(), kernels.stream_handle(dev),
        )
        return partial

    tally = _sum_chunks(mesh, card_chunks(mesh.devices, MAX_STEP_SHARDS), g, launch)
    return oks, outs, out_lens, keeps, tally


def make_sharded_coproc_step(mesh: PartitionMesh, spec_json: str, r_batch: int, r_rec: int):
    """The full per-tick device program over the partition axis:
    fn(batch_rows u8 [P, B, r_batch], batch_lens i32 [P, B], claimed u32
    [P, B], rec_rows u8 [P, N, r_rec], rec_lens i32 [P, N], votes u8 [P, G])
    -> (ok [P, B], out [P, N, r_out], out_len [P, N], keep [P, N], tally [G]).

    Per card, on its current stream: the inputs placed with one copy each
    (``local_blocks``) and one launch of the fused step (K10) over the
    card's shards -- the batch validator over their batches, the payload
    transform over their records (out_len unmasked, as the JAX package's
    ``compile_transform`` returns it) and the column sums of their votes --
    then the cards' partial tallies summed on ``devices[0]``. On a CPU mesh
    every shard runs the plain versions.
    """
    r_batch, r_rec = int(r_batch), int(r_rec)
    prog = compile_transform(TransformSpec.from_json(spec_json), r_rec)

    def step(b_rows, b_lens, claimed, rec_rows, rec_lens, votes):
        args = [local_blocks(mesh, a) for a in (b_rows, b_lens, claimed, rec_rows, rec_lens, votes)]
        for d in range(mesh.size):
            _check_step_blocks([a.blocks[d] for a in args], r_batch, r_rec)
        on_shards = _step_on_cards if mesh.type == "cuda" else _step_plain_shards
        oks, outs, out_lens, keeps, tally = on_shards(mesh, prog, args, r_batch, r_rec)
        return (Sharded(mesh, oks), Sharded(mesh, outs), Sharded(mesh, out_lens),
                Sharded(mesh, keeps), tally)

    return step
