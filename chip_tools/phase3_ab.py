#!/usr/bin/env python3
"""chip_smoke.py's phase 3 columnar lane, alone in a fresh process, on one
CUDA card.

    python3 chip_tools/phase3_ab.py [--root DIR] [--no-harvest] [--windows N]

Builds phase 3's TorchEngine of DIR's redpanda_tpu_torch (default: this
checkout; an unpacked checkout of another commit, e.g. `git archive
<commit> | tar -x -C build/parent`, runs that commit's engine under the
same measurement code) as phase 3 does -- the columnar spec at the
bench's shape (64 partitions x 32 ~1 KB JSON records, GROUP 16 ticks to a
launch, DEPTH 3 launches in flight), GROUP + 1 ticks of warm-up -- then
drives N windows of 160 ticks. For each window it prints the rate, the engine's host stage
seconds, the wall left outside them, and the garbage collector's pauses
inside the window by generation. ``--no-harvest`` turns the mask-harvest
thread off (the caller fetches each mask, as before the thread existed),
where the engine has one. Every reply is checked against the same
package's TorchEngine(device="cpu"). Run it once a process: phase 3 runs
first in chip_smoke.py's process, and a process that has run other phases
reads differently.

Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="checkout whose redpanda_tpu_torch to drive")
    ap.add_argument("--no-harvest", action="store_true", help="turn the mask-harvest thread off")
    ap.add_argument("--windows", type=int, default=3, help="160-tick windows to drive")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("phase3_ab: no CUDA device available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from redpanda_tpu_torch.coproc.engine import TorchEngine

    if not os.path.dirname(inspect.getfile(TorchEngine)).startswith(root):
        raise SystemExit(f"phase3_ab: imported {inspect.getfile(TorchEngine)}, not {root}")
    harvest = hasattr(TorchEngine, "_harvest_async")
    if args.no_harvest and harvest:
        TorchEngine._harvest_async = lambda self: False
    req = cs.build_request(short_msgs=False)
    cpu = TorchEngine(device="cpu", row_stride=cs.ROW_STRIDE)
    cpu.enable_coprocessors([(1, cs.columnar_spec().to_json(), ("bench",))])
    want = [cs.reply_bytes(t.result()) for t in cpu.submit_group([req] * cs.GROUP)]
    if hasattr(cpu, "shutdown"):
        cpu.shutdown()
    # K1 pinned as in phase 3, where the engine has the knob
    pin = {k: v for k, v in cs.PIN_K1.items()
           if k in inspect.signature(TorchEngine.__init__).parameters}
    eng = TorchEngine(device=torch.device("cuda", 0), row_stride=cs.ROW_STRIDE, **pin)
    eng.enable_coprocessors([(1, cs.columnar_spec().to_json(), ("bench",))])
    cs.run_stream(eng, req, cs.GROUP + 1)  # warm-up, as phase 3
    lane = ("default" + (", harvest thread off" if args.no_harvest and harvest else "")
            + ("" if harvest else " (no harvest thread)"))
    for w in range(args.windows):
        eng.reset_stats()
        with cs.GcPauses() as gcp:
            t0 = time.perf_counter()
            replies, rate = cs.run_stream(eng, req, cs.TICKS)
            wall = time.perf_counter() - t0
        if any(cs.reply_bytes(r) != want[k % cs.GROUP] for k, r in enumerate(replies)):
            cs.fail(f"phase3_ab {root}: a reply differs from the CPU engine's")
        st = eng.stats()
        stages = sum(v for k, v in st.items() if k.startswith("t_") and not k.startswith(
            ("t_dev_", "t_harvest_wait", "t_shard_")))
        gc_s = sum(p1 - p0 for p0, p1, _ in gcp.pauses)
        cs.log(f"phase3_ab {os.path.basename(root)} {lane} window {w + 1}: {rate:.1f} "
               f"record_batches/s ({wall:.6f} s); caller's host stages {stages:.6f} s, outside "
               f"them {wall - stages:.6f} s; gc pauses {gc_s:.6f} s, [s, count] by generation "
               f"{json.dumps(gcp.by_gen())}; pool probe "
               f"{json.dumps(st.get('host_pool_probe'))}; harvest wait "
               f"{st.get('t_harvest_wait', 0.0):.6f} s")
    if hasattr(eng, "shutdown"):
        eng.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
