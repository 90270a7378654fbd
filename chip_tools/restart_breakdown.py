#!/usr/bin/env python3
"""Where a log's tail recovery spends its time on the card, stage by stage.

    python3 chip_tools/restart_breakdown.py [--frames 1024,8192] [--reps N]

Builds a tail segment of chip_smoke.py's ~4 KiB batches (phase 7's
``random_batches`` shape: 4 records of 1000 B, 4097 B a frame), its last
frame torn in half, for each frame count of ``--frames`` (1024: one log of
phase 7b's restart; 8192: phase 7's 32 MiB segment), and times on the host
clock (median of ``--reps`` each, in turns, warm page cache):

* ``open_card`` / ``open_host``: ``DiskLog.open`` of the log with device
  recovery on the card and with host recovery (the whole of a restart's
  work for one log, the worker-thread hop included);
* ``scan_card`` / ``scan_host``: ``scan_valid_prefix_device`` and
  ``scan_valid_prefix_host`` over the tail's bytes;
* the card's scan in parts: ``walk`` (the frame headers decoded and their
  CRCs checked on the host), ``regions`` (each frame's Kafka CRC region
  joined), ``pack`` (``pack_rows`` into the staging array), ``crc`` (K5's
  call: the rows and lengths copied up, one launch, the CRCs copied down)
  and ``launch`` (K5 alone over rows already on the card, CUDA events);
* ``rebuild``: ``Segment.rebuild_index`` over the recovered bytes, which
  both reopens run after their scan.

Prints one line per frame count and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def median_ms(fn, reps: int) -> float:
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2] * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", default="1024,8192")
    ap.add_argument("--reps", type=int, default=15)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("restart_breakdown: no CUDA device available", file=sys.stderr)
        return 1
    from chip_smoke import SEGMENT_RECORDS, SEGMENT_VALUE, cuda_ms, random_batches
    from redpanda_tpu_torch.models import NTP
    from redpanda_tpu_torch.models.record import INTERNAL_HEADER_SIZE, RecordBatchHeader
    from redpanda_tpu_torch.ops.crc32c_device import as_i32, as_rows, crc32c_rows, make_crc_fn
    from redpanda_tpu_torch.ops.packing import pack_rows
    from redpanda_tpu_torch.storage import DiskLog, LogConfig
    from redpanda_tpu_torch.storage.recovery import (
        scan_valid_prefix_device, scan_valid_prefix_host)
    from redpanda_tpu_torch.storage.segment import Segment

    dev = torch.device("cuda", 0)
    r = 4096
    for n in [int(x) for x in args.frames.split(",")]:
        batches = random_batches(n, SEGMENT_RECORDS, SEGMENT_VALUE, 5)
        frames = [b.with_base_offset(SEGMENT_RECORDS * i).encode_internal()
                  for i, b in enumerate(batches)]
        blob = b"".join(frames)
        torn = blob[: len(blob) - len(frames[-1]) // 2]
        with tempfile.TemporaryDirectory(prefix="restart-breakdown-") as tmp:
            ntp = NTP.kafka("breakdown", 0)
            src = os.path.join(tmp, "src", ntp.path())
            os.makedirs(src)
            with open(os.path.join(src, "0-1-v1.log"), "wb") as f:
                f.write(torn)
            seg_dir = os.path.join(tmp, "seg")
            os.makedirs(seg_dir)
            with open(os.path.join(seg_dir, "0-1-v1.log"), "wb") as f:
                f.write(torn)
            seg = Segment(seg_dir, 0, 1)
            seg.size_bytes = len(torn)

            def reopen(device: bool):
                base = os.path.join(tmp, "card" if device else "host")
                shutil.rmtree(base, ignore_errors=True)
                shutil.copytree(os.path.join(tmp, "src"), base)
                cfg = LogConfig(base_dir=base, use_device_recovery=device,
                                recovery_device=str(dev))

                async def body():
                    t0 = time.perf_counter()
                    log = await DiskLog.open(ntp, cfg)
                    dt = time.perf_counter() - t0
                    await log.close()
                    return dt

                return asyncio.run(body())

            def walk():
                out, at = [], 0
                while at + INTERNAL_HEADER_SIZE <= len(torn):
                    hdr = RecordBatchHeader.decode(torn, at)
                    if at + hdr.size_bytes > len(torn) or (
                            hdr.header_crc != hdr.internal_header_only_crc()):
                        break
                    out.append((at, hdr))
                    at += hdr.size_bytes
                return out

            found = walk()
            regions = [hdr.kafka_header_crc_prefix()
                       + torn[pos + INTERNAL_HEADER_SIZE: pos + hdr.size_bytes]
                       for pos, hdr in found]
            rows, lens = pack_rows(regions, r)
            crc_fn = make_crc_fn(r, dev)
            d_rows, d_lens = as_rows(rows, dev, r), as_i32(lens, dev)
            claimed = np.array([hdr.crc for _, hdr in found], np.uint32)
            if not np.array_equal(crc_fn(rows, lens), claimed):
                print("restart_breakdown: K5 disagrees with the claimed CRCs", file=sys.stderr)
                return 1
            if scan_valid_prefix_device(torn, device=dev) != scan_valid_prefix_host(torn):
                print("restart_breakdown: the scans disagree", file=sys.stderr)
                return 1
            opens = {"open_card": [], "open_host": []}
            for _ in range(max(3, args.reps // 3)):
                opens["open_card"].append(reopen(True))
                opens["open_host"].append(reopen(False))
            got = {k: sorted(v)[len(v) // 2] * 1e3 for k, v in opens.items()}
            stages = {
                "scan_card": lambda: scan_valid_prefix_device(torn, device=dev),
                "scan_host": lambda: scan_valid_prefix_host(torn),
                "walk": walk,
                "regions": lambda: [hdr.kafka_header_crc_prefix()
                                    + torn[pos + INTERNAL_HEADER_SIZE: pos + hdr.size_bytes]
                                    for pos, hdr in found],
                "pack": lambda: pack_rows(regions, r),
                "crc": lambda: crc_fn(rows, lens),
                "rebuild": lambda: seg.rebuild_index(torn),
            }
            for name, fn in stages.items():
                got[name] = median_ms(fn, args.reps)
            got["launch"] = cuda_ms(lambda: crc32c_rows(d_rows, d_lens), 50)
        print(f"{n} frames ({len(torn) / 2**20:.2f} MiB, torn tail): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in got.items()), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
