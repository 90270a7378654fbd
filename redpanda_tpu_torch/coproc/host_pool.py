"""The range shard of a launch's batches (the JAX package's
coproc/host_pool.py ``partition_counts``, copied verbatim), and the margin
a measured choice of the engine must win by (``PROBE_MARGIN``).

The mesh lane (coproc/meshrunner.py) cuts a launch into per-device shards
with it, so its shard ranges, and ``stats()["mesh"]["rows_per_device"]``,
equal the JAX engine's for the same requests. The host-stage pool itself is
not ported yet.
"""

from __future__ import annotations

# A measured choice of the engine (the structural-vs-staged parse ladder,
# the mesh lane against the single device) pins the new path only when it
# wins by this factor: the old one is the known path.
PROBE_MARGIN = 1.25


def partition_counts(counts: list[int], n_shards: int) -> list[tuple[int, int]]:
    """Contiguous [start, end) slices over ``counts`` (per-batch record
    counts), balanced by total records per shard.

    Contiguity is the invariant everything downstream leans on: shard i's
    records form one contiguous record range, so merged offset/size/span
    tables are plain concatenations with rebased indices and the framed
    per-batch outputs concatenate back in input order byte-identically.
    Never returns empty slices; may return fewer than ``n_shards`` when
    there are fewer batches than shards.
    """
    n = len(counts)
    if n == 0 or n_shards <= 1:
        return [(0, n)] if n else []
    n_shards = min(n_shards, n)
    total = sum(counts)
    target = total / n_shards
    cuts = [0]
    acc = 0
    for i, c in enumerate(counts):
        acc += c
        # cut when this shard reached its share, leaving enough batches
        # for the remaining shards to be non-empty
        remaining_shards = n_shards - len(cuts)
        if (
            remaining_shards > 0
            and acc >= target * len(cuts)
            and (n - (i + 1)) >= remaining_shards
            and i + 1 > cuts[-1]
        ):
            cuts.append(i + 1)
            if len(cuts) == n_shards:
                break
    cuts.append(n)
    return [(cuts[i], cuts[i + 1]) for i in range(len(cuts) - 1) if cuts[i + 1] > cuts[i]]

