#!/usr/bin/env python3
"""K1's whole device leg as a checkout's engine runs it, for comparing two
checkouts on one card.

    python3 chip_tools/k1_leg_ab.py --root DIR [--reps N]

Imports the package and ``chip_smoke.py`` of the checkout at ``--root`` and
builds the bench's launch (64 partitions x 32 records of ~1 KB JSON, GROUP
ticks, the columnar spec). At 2048 rows and at the launch's 32768 it times,
on the host clock, one columnar launch's device leg from the launch's host
columns (numpy) to its keep bits on the host, with no envelope around it:

* a checkout with ``TorchEngine._run_leg``: ``_run_leg(plan, cols).wait()``
  (pack into a staging slot, one ``rp_predicate_leg`` crossing, the bits
  copied out);
* an older one: what its ``_predicate_mask`` and ``_run_device`` do per
  launch -- each column pinned with ``pin_memory()``, copied up with its own
  ``.to()``, the wrapper's launch, a fresh pinned output, four torch events,
  then the fetch.

Each leg is timed on the calling thread and on a fetch worker
(``faults.fetch_with_deadline``, timed inside the job, as the engine's legs
and the columnar probe run), beside the host predicate (``eval_host_mask``)
on the same columns: the median of ``--reps`` each, in turns over three
rounds. Then the columnar probe's device leg (``_probe_device_leg``, a
warm-up leg and one timed leg, on a fetch worker as the probe calls it): on
each of five fresh engines (what a probe reads) and on one engine again
and again; and a fresh engine's first eight legs in order on a fetch worker.
Every leg's bits are checked against the host predicate. Prints one JSON
line (``k1_leg_ab``) and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=300)
    args = ap.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k1_leg_ab: no CUDA device", file=sys.stderr)
        return 1
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    from redpanda_tpu_torch.coproc import batch_codec, faults
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
    path = "one crossing" if hasattr(TorchEngine, "_run_leg") else "per column"

    def engine():
        return TorchEngine(device=dev, row_stride=chip_smoke.ROW_STRIDE, host_workers=0,
                           force_mode="columnar_device")

    def leg_of(eng, cols):
        if path == "one crossing":
            return lambda: eng._run_leg(plan, cols).wait(eng)

        def per_column():
            inputs = [torch.from_numpy(c).pin_memory() for c in cols]
            return eng._run_device(inputs, plan.predicate, "predicate").wait(eng)

        return per_column

    def timed(fn):
        def run():
            t0 = time.perf_counter()
            got = fn()
            return time.perf_counter() - t0, got
        return run

    def on_worker(fn):
        return lambda: faults.fetch_with_deadline(fn, 120.0)

    eng = engine()
    out = {"root": root, "path": path, "rows": {}}
    for rows in (2048, n):
        cols = [np.ascontiguousarray(c[:rows]) for c in full]
        want = plan.eval_host_mask(cols)
        leg = leg_of(eng, cols)
        parts = {
            "host": timed(lambda: plan.eval_host_mask(cols)),
            "leg_thread": timed(leg),
            "leg_worker": on_worker(timed(leg)),
        }
        for f in parts.values():
            f()
        got = {k: [] for k in parts}
        for _ in range(3):
            for k, f in parts.items():
                for _ in range(args.reps // 3):
                    t, bits = f()
                    if not np.array_equal(np.asarray(bits), want):
                        print(f"k1_leg_ab: {k} at {rows} rows != the host predicate")
                        return 1
                    got[k].append(t * 1e3)
        ms = {k: round(sorted(v)[len(v) // 2], 4) for k, v in got.items()}
        ms["leg_worker_p90"] = round(sorted(got["leg_worker"])[len(got["leg_worker"]) * 9 // 10], 4)
        # the probe's device leg, as _probe_columnar_backend calls it
        fresh = []
        for _ in range(5):
            e = engine()
            fresh.append(faults.fetch_with_deadline(lambda: e._probe_device_leg(plan, cols),
                                                    120.0) * 1e3)
            e.shutdown()
        again = [faults.fetch_with_deadline(lambda: eng._probe_device_leg(plan, cols), 120.0)
                 * 1e3 for _ in range(21)]
        ms["probe_fresh"] = [round(t, 4) for t in fresh]
        ms["probe_again_median"] = round(sorted(again)[10], 4)
        e = engine()
        fl = on_worker(timed(leg_of(e, cols)))
        ms["first_legs_worker"] = [round(fl()[0] * 1e3, 4) for _ in range(8)]
        e.shutdown()
        out["rows"][rows] = ms
        print(f"k1_leg_ab {path} at {rows} rows (ms): {json.dumps(ms)}", flush=True)
    eng.shutdown()
    print("k1_leg_ab " + json.dumps(out), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
