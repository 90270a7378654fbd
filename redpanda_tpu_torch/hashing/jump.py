"""Jump consistent hash (the JAX package's hashing/jump.py, copied).

Used for shard assignment: partition -> shard, peer node -> owning shard of
its connection. Lamping & Veach's algorithm, 64-bit LCG.
"""

from __future__ import annotations

_MASK = (1 << 64) - 1


def jump_consistent_hash(key: int, num_buckets: int) -> int:
    if num_buckets <= 0:
        raise ValueError("num_buckets must be positive")
    key &= _MASK
    b, j = -1, 0
    while j < num_buckets:
        b = j
        key = (key * 2862933555777941757 + 1) & _MASK
        j = int((b + 1) * (float(1 << 31) / float((key >> 33) + 1)))
    return b
