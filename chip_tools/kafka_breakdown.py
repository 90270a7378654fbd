#!/usr/bin/env python3
"""Where a produce request of the Kafka front door spends its time on the card.

    python3 chip_tools/kafka_breakdown.py [--batches 1024] [--inflight 8]
                                          [--order device,host,host,device]

chip_smoke.py phase 7f's config 1 drive, taken apart: for each run of
``--order``, a fresh directory, a Broker(device="cuda") with a KafkaServer on
127.0.0.1 and the port's KafkaClient, the produce path's CRC backend pinned
to CrcBackend("device") (K6) or CrcBackend("host") (the native CRC), and
``--batches`` one-batch PRODUCE requests of 16 JSON records of 1 KiB at
acks=-1 with ``--inflight`` in flight on one connection.

Prints, for each run: batches/s, kafka_produce_hist p50 and p99, and the
mean microseconds a request in each stage, timed by wrappers on the one
event loop's thread. The frame decode (Connection._decode_frame), the
batch adapter (decode_wire_batches), the CRC check (CrcBackend.validate)
and the response encode never await, so they are the loop's own time and
their share of the wall is printed; the produce handler
(handlers._do_handle_produce) and the append (Partition.replicate) await,
so their times overlap other requests' (a latency, not a share). Then one 16 KiB region's
validate call alone, on each backend, and the device call's parts (rows
packed, the validator's copies, launch and wait), each the mean of 2000
calls. Then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = ("decode_frame", "handler", "adapter", "crc", "replicate", "encode")
SYNC = ("decode_frame", "adapter", "crc", "encode")  # no await inside: the loop's own time


class Stages:
    """Wall seconds per stage, summed, with wrappers installed and undone
    around one run."""

    def __init__(self):
        self.t = dict.fromkeys(STAGES, 0.0)
        self._undo = []

    def _patch(self, owner, name, stage, is_async):
        orig = getattr(owner, name)
        t = self.t

        if is_async:
            async def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return await orig(*a, **k)
                finally:
                    t[stage] += time.perf_counter() - t0
        else:
            def timed(*a, **k):
                t0 = time.perf_counter()
                try:
                    return orig(*a, **k)
                finally:
                    t[stage] += time.perf_counter() - t0
        setattr(owner, name, timed)
        self._undo.append((owner, name, orig))

    def install(self):
        from redpanda_tpu_torch.cluster.partition import Partition
        from redpanda_tpu_torch.kafka.server import handlers
        from redpanda_tpu_torch.kafka.server.protocol import Connection
        from redpanda_tpu_torch.ops.crc_backend import CrcBackend

        self._patch(Connection, "_decode_frame", "decode_frame", False)
        self._patch(Connection, "_encode_response", "encode", False)
        self._patch(handlers, "_do_handle_produce", "handler", True)
        self._patch(handlers, "decode_wire_batches", "adapter", False)
        self._patch(CrcBackend, "validate", "crc", False)
        self._patch(Partition, "replicate", "replicate", True)

    def undo(self):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        self._undo.clear()


async def one_run(dev, backend: str, wire: list, inflight: int) -> dict:
    from redpanda_tpu_torch.kafka.client import KafkaClient
    from redpanda_tpu_torch.kafka.protocol import messages as m
    from redpanda_tpu_torch.kafka.server import KafkaServer
    from redpanda_tpu_torch.kafka.server.broker import Broker, BrokerConfig
    from redpanda_tpu_torch.observability import probes
    from redpanda_tpu_torch.ops import crc_backend
    from redpanda_tpu_torch.storage import StorageApi
    from redpanda_tpu_torch.utils.hdr import HdrHist

    import chip_smoke as cs

    with tempfile.TemporaryDirectory(prefix="kafka-breakdown-") as d:
        storage = await StorageApi(d).start()
        broker = Broker(BrokerConfig(data_dir=d), storage, device=dev)
        server = await KafkaServer(broker, "127.0.0.1", 0).start()
        broker.config.advertised_port = server.port
        client = await KafkaClient([("127.0.0.1", server.port)]).connect()
        pinned = (crc_backend.CrcBackend("device", device=dev) if backend == "device"
                  else crc_backend.CrcBackend("host"))
        crc_backend.install_default_backend(pinned)
        stages = Stages()
        try:
            await client.create_topic("config1", partitions=1)
            conn = await client.leader_connection("config1", 0)
            await conn.request(m.PRODUCE, cs.produce_body([("config1", 0, wire[0])]))  # warm
            gate = asyncio.Semaphore(inflight)

            async def one(w):
                async with gate:
                    return await conn.request(m.PRODUCE, cs.produce_body([("config1", 0, w)]))

            probes.kafka_produce_hist.hist = HdrHist()
            stages.install()
            t0 = time.perf_counter()
            resps = await asyncio.gather(*(one(w) for w in wire[1:]))
            secs = time.perf_counter() - t0
        finally:
            stages.undo()
            crc_backend.install_default_backend(None)
            await client.close()
            await server.stop()
            await storage.stop()
    if any(p["error_code"] for r in resps for t in r["responses"] for p in t["partitions"]):
        raise SystemExit(f"{backend} run: a produce failed")
    h = probes.kafka_produce_hist.hist
    n = len(resps)
    return {"n": n, "secs": secs, "p50_ms": h.percentile(50) / 1e3, "p99_ms": h.percentile(99) / 1e3,
            "us": {k: v / n * 1e6 for k, v in stages.t.items()}}


def call_alone(dev, region: bytes, crc: int, reps: int = 2000) -> dict:
    import numpy as np
    import torch

    from redpanda_tpu_torch.ops.crc_backend import CrcBackend
    from redpanda_tpu_torch.ops.packing import pack_rows
    from redpanda_tpu_torch.ops.pipeline import make_batch_validator

    out = {}
    claimed = np.array([crc], np.uint32)
    for name in ("device", "host"):
        b = CrcBackend(name, device=dev) if name == "device" else CrcBackend("host")
        b.validate([region], claimed)
        t0 = time.perf_counter()
        for _ in range(reps):
            ok = b.validate([region], claimed)
        out[name] = (time.perf_counter() - t0) / reps * 1e6
        if not ok.all():
            raise SystemExit(f"{name} backend rejected a good region")
    r = 1 << (len(region) - 1).bit_length()
    t0 = time.perf_counter()
    for _ in range(reps):
        rows, lens = pack_rows([region], r)
    out["pack_rows"] = (time.perf_counter() - t0) / reps * 1e6
    validate = make_batch_validator(r, dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        validate(rows, lens, claimed)
    out["validator"] = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batches", type=int, default=1024)
    ap.add_argument("--inflight", type=int, default=8)
    ap.add_argument("--order", default="device,host,host,device")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kafka_breakdown: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.kafka.protocol.batch import encode_wire_batches

    dev = torch.device("cuda", 0)
    kernels.build_all()
    batches = cs.kafka_batches(args.batches + 1, seed=71)
    wire = [encode_wire_batches([b]) for b in batches]
    for backend in args.order.split(","):
        r = asyncio.run(one_run(dev, backend, wire, args.inflight))
        us, wall = r["us"], r["secs"] / r["n"] * 1e6
        print(f"{backend}: {r['n']} one-batch requests, {args.inflight} in flight: "
              f"{r['n'] / r['secs']:.1f} batches/s ({wall:.1f} us a request of wall); "
              f"kafka_produce_hist p50 {r['p50_ms']:.3f} ms p99 {r['p99_ms']:.3f} ms (bucket "
              "bounds); us a request on the loop's thread: "
              + ", ".join(f"{k} {us[k]:.1f}" for k in SYNC)
              + f" (together {sum(us[k] for k in SYNC) / wall:.1%} of the wall); awaited, "
              f"overlapping other requests: handler {us['handler']:.1f}, replicate "
              f"{us['replicate']:.1f}", flush=True)
    a = call_alone(dev, batches[0].crc_region(), batches[0].header.crc)
    print(f"one {len(batches[0].crc_region())} B region, validate alone: device "
          f"{a['device']:.1f} us (pack_rows {a['pack_rows']:.1f}, the validator's copies, "
          f"launch and wait {a['validator']:.1f}), host {a['host']:.1f} us", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
