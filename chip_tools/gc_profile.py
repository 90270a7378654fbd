#!/usr/bin/env python3
"""Where the engine's host seconds go to garbage collection, on one CUDA
card.

    python3 chip_tools/gc_profile.py [--root DIR] [--rounds N]

Runs two of chip_smoke.py's measurements against the redpanda_tpu_torch
package of DIR (default: this checkout; an unpacked checkout of another
commit, e.g. `git archive <commit> | tar -x -C build/parent`, profiles that
commit's engine with the same measurement code), at the bench's shape (64
partitions x 32 ~1 KB JSON records, GROUP 16 ticks to a launch, 160
ticks), the
columnar spec, every reply checked against the same package's
TorchEngine(device="cpu"):

- seal_profile: lanes whose replies are all empty (inline, and on
  column-cache hits), their t_seal seconds split into the collector's
  pauses inside the seal windows, by generation, and host work;
- gc_lanes: the default engine's lane and the inline one's
  (host_workers=0, where the package has the knob) in N rounds of turns,
  each rate beside the collector's pauses in its window.

Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import importlib.util
import inspect
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO, help="checkout whose redpanda_tpu_torch to profile")
    ap.add_argument("--rounds", type=int, default=3, help="turns of the gc_lanes lanes")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("gc_profile: no CUDA device available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from redpanda_tpu_torch.coproc.engine import TorchEngine

    if not os.path.dirname(inspect.getfile(TorchEngine)).startswith(root):
        raise SystemExit(f"gc_profile: imported {inspect.getfile(TorchEngine)}, not {root}")
    knobs = inspect.signature(TorchEngine.__init__).parameters
    cpu = TorchEngine(device="cpu", row_stride=cs.ROW_STRIDE,
                      **({"host_workers": 0} if "host_workers" in knobs else {}))
    cpu.enable_coprocessors([(1, cs.columnar_spec().to_json(), ("bench",))])
    req = cs.build_request(short_msgs=False)
    want = {"bench": [cs.reply_bytes(t.result()) for t in cpu.submit_group([req] * cs.GROUP)]}
    cs.log(f"gc profile of {root} on {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda", 0)
    cs.seal_profile(dev, {"bench": req}, want)
    cs.gc_lanes(dev, {"bench": req}, want, args.rounds)
    cs.log(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
