#!/usr/bin/env python3
"""Where K1's leg spends its time on the card, stage by stage.

    python3 chip_tools/k1_leg_breakdown.py [--root DIR] [--reps N]

Builds the bench's launch (chip_smoke.py's request: 64 partitions x 32
records of ~1 KB JSON, GROUP 16 times over, the columnar spec), then, at
2048 rows and at the launch's 32768, times on the host clock (median of
``--reps`` each, in turns) the host predicate (``eval_host_mask``) and K1's
leg and its parts on a pinned engine of the checkout at ``--root``:

* ``leg``: ``TorchEngine._run_leg(...).wait()`` -- what the columnar probe's
  device leg times (pack, one crossing, wait, bits copied out);
* ``pack``: the columns packed into a slot's pinned block;
* ``wrapper``: ``ColumnarPlan.predicate_leg`` (its checks and the crossing)
  followed by the events' wait, over a slot packed beforehand;
* ``crossing``: the C entry point called directly with prepared arguments,
  then the events' wait: the card's floor for the three steps;
* ``crossing_enqueue``: the C call alone (host clock, no wait).

``--profile`` then runs 500 legs at 2048 rows under cProfile and prints the
25 functions with the most time of their own. ``--first-legs`` times, one
by one, the first eight legs at 32768 rows of a fresh engine (its staging
slot made by the first), on a fetch worker as the columnar probe runs them
and on the calling thread: the probe times its second leg.

Prints one line per row count and the card's name and power limit. Works
against an older checkout only as far as it has ``_run_leg``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time


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
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=300)
    ap.add_argument("--profile", action="store_true",
                    help="then cProfile 500 legs at 2048 rows and print the top functions")
    ap.add_argument("--first-legs", action="store_true",
                    help="then time a fresh engine's first legs one by one")
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_leg_breakdown: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc import batch_codec
    from redpanda_tpu_torch.coproc.column_plan import plan_spec
    from redpanda_tpu_torch.coproc.engine import TorchEngine

    dev = torch.device("cuda", 0)
    req = chip_smoke.build_request(short_msgs=False)
    batches = [b for it in req.items for b in it.batches] * chip_smoke.GROUP
    plan = plan_spec(chip_smoke.columnar_spec())
    ex, types, vs, ve = batch_codec.explode_and_find(batches, plan.flat_paths())
    cache = plan.make_cache_from_tables(ex, plan.flat_paths(), types, vs, ve)
    n = len(ex.sizes)
    full = plan.extract_device_inputs(ex.joined, ex.offsets, ex.sizes, n, cache)
    eng = TorchEngine(device=dev, row_stride=chip_smoke.ROW_STRIDE, host_workers=0,
                      force_mode="columnar_device")
    eng.enable_coprocessors([(1, chip_smoke.columnar_spec().to_json(), ("bench",))])
    out = {}
    for rows in (2048, n):
        cols = [np.ascontiguousarray(c[:rows]) for c in full]
        lay = plan.block_layout(rows)
        want = plan.eval_host_mask(cols)
        if not np.array_equal(eng._run_leg(plan, cols).wait(eng), want):
            print(f"k1_leg_breakdown: the leg at {rows} rows != the host predicate")
            return 1
        pending = eng._run_leg(plan, cols)
        slot = pending.slot
        pending.wait(eng)  # the slot is free again; the parts below reuse it
        lay.pack(cols, slot.host_np)
        code, needles = plan.program.on(dev)
        stream = eng._stream.cuda_stream
        argv = (slot.host.data_ptr(), slot.dev.data_ptr(), lay.total, lay.c_off, len(cols),
                code.data_ptr(), code.shape[0], needles.data_ptr(), rows, None,
                slot.bits.data_ptr(), slot.bits_host.data_ptr(), slot.events.handles, stream)
        fn = kernels.PREDICATE.fn()

        def crossing():
            if fn(*argv) != 0:
                raise RuntimeError("rp_predicate_leg refused")
            slot.events.wait()

        def enqueue():
            fn(*argv)

        def wrapper():
            with torch.cuda.device(dev):
                plan.predicate_leg(rows, slot.dev, slot.bits, host_block=slot.host,
                                   bits_host=slot.bits_host, events=slot.events, stream=stream)
            slot.events.wait()

        parts = {
            "host": lambda: plan.eval_host_mask(cols),
            "leg": lambda: eng._run_leg(plan, cols).wait(eng),
            "pack": lambda: lay.pack(cols, slot.host_np),
            "wrapper": wrapper,
            "crossing": crossing,
        }
        got = {k: [] for k in parts}
        for _ in range(3):  # in turns, three rounds
            for k, f in parts.items():
                got[k].append(median_ms(f, args.reps // 3))
        ms = {k: sorted(v)[1] for k, v in got.items()}
        ms["crossing_enqueue"] = median_ms(enqueue, args.reps)
        torch.cuda.synchronize()
        if not np.array_equal(slot.bits_np[: rows // 8], want):
            print(f"k1_leg_breakdown: the crossing at {rows} rows != the host predicate")
            return 1
        h2d, kern, d2h = slot.events.wait()
        ms["events_last"] = {"h2d": h2d * 1e3, "kernel": kern * 1e3, "d2h": d2h * 1e3}
        out[rows] = ms
        print(f"K1 leg breakdown at {rows} rows ({lay.total} B block, host clock, median ms): "
              + json.dumps({k: (round(v, 4) if isinstance(v, float) else
                                {a: round(b, 4) for a, b in v.items()}) for k, v in ms.items()}),
              flush=True)
    if args.first_legs:
        from redpanda_tpu_torch.coproc import faults

        for where in ("fetch worker", "calling thread", "fetch worker", "calling thread"):
            fresh = TorchEngine(device=dev, row_stride=chip_smoke.ROW_STRIDE, host_workers=0,
                                force_mode="columnar_device")
            cols = [c.copy() for c in full]

            def one():
                t0 = time.perf_counter()
                fresh._run_leg(plan, cols).wait(fresh)
                return (time.perf_counter() - t0) * 1e3

            legs = [faults.fetch_with_deadline(one, 120.0) if where == "fetch worker" else one()
                    for _ in range(8)]
            fresh.shutdown()
            print(f"K1 first legs of a fresh engine at {n} rows on the {where} (ms, in order): "
                  + ", ".join(f"{t:.4f}" for t in legs), flush=True)
    if args.profile:
        import cProfile
        import pstats

        cols = [np.ascontiguousarray(c[:2048]) for c in full]
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(500):
            eng._run_leg(plan, cols).wait(eng)
        prof.disable()
        pstats.Stats(prof).sort_stats("tottime").print_stats(25)
    eng.shutdown()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
