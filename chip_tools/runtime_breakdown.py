#!/usr/bin/env python3
"""Where a tick of the coproc runtime spends its time on the card.

    python3 chip_tools/runtime_breakdown.py [--batches 64] [--order both,errs,errs_v1,both]

chip_smoke.py phase 7c's drive, taken apart: a StorageApi, Broker and
CoprocApi(broker, device="cuda") with the default knobs over a fresh
directory; topic bench of 64 partitions holding ``--batches`` batches of
the bench's short_msgs workload each (phase 7c's backlog); then, for each
run of ``--order``, the named scripts deployed through ``api.deploy`` (the
columnar spec as errs, the payload spec as errs_v1, "both" deploys the
two at once) and the backlog transformed to its last offset. Each run
starts from a fresh directory and a fresh columnar probe.

Prints, for each run and script: input record_batches/s from its deploy
to its last offset, its ticks (coproc.tick spans) and the medians of its
coproc.read, coproc.submit.wait, coproc.harvest.wait and coproc.write
spans; for each run: the batch cache's hits and misses over the reads (the
backlog outgrows its 64 MiB at the default size), the probe's verdict,
and the engine's stage seconds (both scripts' launches together). Then the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


async def one_run(dev, backlog, names: list[str], last: int) -> dict:
    import chip_smoke as cs
    from redpanda_tpu_torch.cluster import TopicConfig
    from redpanda_tpu_torch.coproc.api import CoprocApi
    from redpanda_tpu_torch.kafka.server.broker import Broker, BrokerConfig
    from redpanda_tpu_torch.observability.trace import tracer
    from redpanda_tpu_torch.storage import StorageApi

    specs = {"errs": cs.columnar_spec(), "errs_v1": cs.payload_spec()}
    spans, script_of = [], {}
    with tempfile.TemporaryDirectory(prefix="runtime-breakdown-") as d:
        storage = await StorageApi(d).start()
        broker = Broker(BrokerConfig(data_dir=d), storage)
        api = await CoprocApi(broker, device=str(dev)).start()
        try:
            await broker.create_topic(TopicConfig("bench", len(backlog)))
            for p, batches in backlog.items():
                await broker.get_partition("bench", p).replicate(batches, 0)
            cache = storage.log_mgr.batch_cache
            hits0, misses0 = cache.hits, cache.misses
            engine_submit = api.engine.submit

            def submit(req):
                script_of[req.trace_id] = req.items[0].script_id
                return engine_submit(req)

            api.engine.submit = submit
            tracer.configure(enabled=True, slow_threshold_ms=60_000)
            tracer.set_sink(spans.append)
            t_deploy, t_done = {}, {}
            for n in names:
                t_deploy[n] = time.perf_counter()
                await api.deploy(n, specs[n].to_json(), ["bench"])
            t0 = time.perf_counter()
            while len(t_done) < len(names):
                for n in names:
                    ctx = api.pacemaker.scripts().get(n)
                    if n not in t_done and ctx is not None and len(ctx.offsets) == len(backlog) \
                            and all(v == last for v in ctx.offsets.values()):
                        t_done[n] = time.perf_counter()
                if time.perf_counter() - t0 > 300:
                    raise SystemExit("runtime_breakdown: the backlog was not transformed in 300 s")
                await asyncio.sleep(0.005)
        finally:
            await api.stop()
            tracer.set_sink(None)
            tracer.configure(enabled=False)
            await storage.stop()
        st = api.engine.stats()
    n_batches = sum(len(b) for b in backlog.values())
    out = {"cache": (cache.hits - hits0, cache.misses - misses0),
           "probe": (st.get("columnar_backend"), st.get("columnar_probe")),
           "stages": {k: round(v, 4) for k, v in sorted(st.items())
                      if k.startswith("t_") and isinstance(v, float)},
           "scripts": {}}
    for n in names:
        ticks, med = cs.script_spans(spans, script_of, n)
        secs = t_done[n] - t_deploy[n]
        out["scripts"][n] = {"rb_s": round(n_batches / secs, 1), "secs": round(secs, 3),
                             "ticks": ticks, "median_ms": med}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batches", type=int, default=64)
    ap.add_argument("--order", default="both,errs,errs_v1,both")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc.engine import TorchEngine

    if not torch.cuda.is_available():
        print("runtime_breakdown: no CUDA device available", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    kernels.build_all()
    requests = [cs.build_request(True, seed=b) for b in range(args.batches)]
    backlog = {p: [req.items[p].batches[0] for req in requests] for p in range(cs.P)}
    last = args.batches * cs.RECORDS_PER_BATCH - 1
    for i, run in enumerate(args.order.split(",")):
        names = ["errs", "errs_v1"] if run == "both" else [run]
        TorchEngine.reset_columnar_probe()
        res = asyncio.run(one_run(dev, backlog, names, last))
        for n, r in res["scripts"].items():
            print(f"runtime_breakdown run {i + 1} ({run}) {n}: {r['rb_s']} record_batches/s "
                  f"({r['secs']} s, {r['ticks']} ticks); span medians ms {json.dumps(r['median_ms'])}",
                  flush=True)
        print(f"runtime_breakdown run {i + 1} ({run}): batch cache hits/misses {res['cache']}; "
              f"probe {json.dumps(res['probe'])}; engine stages s {json.dumps(res['stages'])}",
              flush=True)
    TorchEngine.reset_columnar_probe()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
