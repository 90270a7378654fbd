"""NTP → shard routing table.

Parity with cluster/shard_table.h. The reference pins each partition to one
seastar core and every cross-shard touch goes through this map. The TPU
build's "shards" are asyncio workers feeding per-shard device batches (the
`[partition, batch, record]` packing axis — SURVEY.md §2.3.1); the table
still exists so the coproc pacemaker and kafka fetch planner can group
partitions by shard exactly like the reference's fetch plan does
(kafka/server/fetch.cc:390).

(The JAX package's cluster/shard_table.py, copied.)
"""

from __future__ import annotations

from redpanda_tpu_torch.hashing.jump import jump_consistent_hash
from redpanda_tpu_torch.hashing.xx import xxhash64
from redpanda_tpu_torch.models.fundamental import NTP


class ShardTable:
    def __init__(self, n_shards: int = 1) -> None:
        self.n_shards = max(1, n_shards)
        self._explicit: dict[NTP, int] = {}

    def update(self, ntp: NTP, shard: int) -> None:
        self._explicit[ntp] = shard % self.n_shards

    def erase(self, ntp: NTP) -> None:
        self._explicit.pop(ntp, None)

    def shard_for(self, ntp: NTP) -> int:
        s = self._explicit.get(ntp)
        if s is not None:
            return s
        # default placement: jump hash of the ntp identity, the same scheme
        # connection_cache uses for peers (hashing/jump_consistent_hash.h)
        key = xxhash64(str(ntp).encode())
        return jump_consistent_hash(key, self.n_shards)

    def group_by_shard(self, ntps: list[NTP]) -> dict[int, list[NTP]]:
        out: dict[int, list[NTP]] = {}
        for ntp in ntps:
            out.setdefault(self.shard_for(ntp), []).append(ntp)
        return out
