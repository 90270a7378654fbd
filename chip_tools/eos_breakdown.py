#!/usr/bin/env python3
"""chip_smoke.py's phase 7g alone, with the loop's requests timed by API.

    python3 chip_tools/eos_breakdown.py [--runs 1] [--batches 64]

Runs phase 7g (the exactly-once read-process-write loop over the Kafka wire,
config 2's shape: chip_smoke.py's docstring) ``--runs`` times on the card,
each in a fresh directory, ``--batches`` input batches a partition, every
check of the phase in force. Around each run the client's
``BrokerConnection.request`` is wrapped: the count and the mean wall
milliseconds of every request by API (produce, fetch, the group and
transaction APIs) are printed after the phase's own lines. Request walls
overlap: the input's 16 partitions and the two members run at once on one
event loop, so a mean is a latency, not a share. Two calls that never
await are timed too, as the loop's own time: ``Segment.fsync`` (every
acks=-1 append, control marker and group record flushes its segment on the
loop's thread) and ``CrcBackend.validate`` (K6's call). Then the card's name
and power limit.
"""

from __future__ import annotations

import argparse
import collections
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--batches", type=int, default=64)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("eos_breakdown: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.kafka.client.client import BrokerConnection
    from redpanda_tpu_torch.kafka.protocol import messages as m
    from redpanda_tpu_torch.ops.crc_backend import CrcBackend
    from redpanda_tpu_torch.storage.segment import Segment

    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    kernels.build_all()
    print(f"built kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    cs.EOS_BATCHES = args.batches
    orig = BrokerConnection.request
    syncs = {"fsync": (Segment, "fsync"), "crc": (CrcBackend, "validate")}
    plain = {key: vars(owner)[name] for key, (owner, name) in syncs.items()}
    for run in range(args.runs):
        calls = collections.defaultdict(lambda: [0, 0.0])
        own = {k: [0, 0.0] for k in syncs}

        def sync_timer(key, fn):
            def timed_sync(*a, **k):
                t = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    own[key][0] += 1
                    own[key][1] += time.perf_counter() - t
            return timed_sync

        async def timed(self, api_key, body, version=None):
            t = time.perf_counter()
            try:
                return await orig(self, api_key, body, version)
            finally:
                c = calls[api_key]
                c[0] += 1
                c[1] += time.perf_counter() - t

        BrokerConnection.request = timed
        for key, (owner, name) in syncs.items():
            setattr(owner, name, sync_timer(key, plain[key]))
        t = time.perf_counter()
        try:
            launches = cs.phase_eos(dev)
        finally:
            BrokerConnection.request = orig
            for key, (owner, name) in syncs.items():
                setattr(owner, name, plain[key])
        wall = time.perf_counter() - t
        rows = sorted(calls.items(), key=lambda kv: -kv[1][1])
        print(f"run {run + 1}: launches {launches}; requests by API (count, mean ms): "
              + ", ".join(f"{m.APIS[k].name} {n} {s / n * 1e3:.3f}" for k, (n, s) in rows)
              + "; on the loop's thread: "
              + ", ".join(f"{k} {n} calls {s:.3f} s ({s / n * 1e3:.3f} ms a call, {s / wall:.1%} "
                          "of the phase)" for k, (n, s) in own.items() if n),
              flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
