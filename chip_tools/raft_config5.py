#!/usr/bin/env python3
"""chip_smoke.py phase 7d (BASELINE config 5 through raft) under other raft
timings, with the counts that say whether the one event loop keeps up.

    python3 chip_tools/raft_config5.py [--election-ms 5000] [--heartbeat-ms 500]
        [--recovery 4] [--groups 256] [--profile-round "run A"]
    python3 chip_tools/raft_config5.py --idle 5 [--groups 128] [--device cpu]

The first form runs phase 7d as chip_smoke.py does (three brokers, 256
groups, four rounds of 16 batches a group), after phase 6 so that the
plane-only number is printed beside it, with the election timeout, the
heartbeat interval and the recovery throttle given. Besides the phase's
own lines it prints every second how late the loop's timers fire and how
many groups have a leader; then the elections (dispatch_election calls)
in each 5 s of the run, the heartbeat ticks' duration (median, p99, max)
and how long a follower had gone without contact when it started an
election (median, max). ``--profile-round`` profiles that round with
cProfile (every thread: Python 3.12 profiles through sys.monitoring) and
prints the top 30 functions by own time. A failed phase prints its reason
and the counts, and exits 1.

The second form starts the three brokers and their groups, waits for
stable leaders, and profiles the idle cluster (heartbeats only) for the
given seconds: the loop thread's busy share of the wall (process time of
the thread over the wall) and the top 20 functions. ``--device cpu`` runs
the plain versions on this host; a CPU share is the host's, no device
metric.
"""

from __future__ import annotations

import argparse
import asyncio
import cProfile
import io
import os
import pstats
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def instrument(cs, t0: float) -> dict:
    """Count elections, time heartbeat ticks, and sample the loop's timer
    lateness while phase 7d runs; returns the lists they fill."""
    from redpanda_tpu_torch.raft import consensus, heartbeat_manager

    seen = {"elections": [], "gaps": [], "ticks": [], "monitor": []}
    dispatch = consensus.Consensus.dispatch_election
    send = heartbeat_manager.HeartbeatManager.send_heartbeats

    async def dispatch_election(self, **kw):
        loop = asyncio.get_event_loop()
        seen["elections"].append(time.perf_counter() - t0)
        if self.leader_id is not None:  # a follower that lost its leader
            seen["gaps"].append(loop.time() - self._last_leader_contact)
        return await dispatch(self, **kw)

    async def send_heartbeats(self):
        t = time.perf_counter()
        try:
            return await send(self)
        finally:
            seen["ticks"].append(time.perf_counter() - t)

    consensus.Consensus.dispatch_election = dispatch_election
    heartbeat_manager.HeartbeatManager.send_heartbeats = send_heartbeats

    leaders, stable = cs.config5_leaders, cs.config5_stable_leaders
    started = []

    async def monitor(nodes):
        while True:
            t = time.perf_counter()
            await asyncio.sleep(1.0)
            cs_of = [[n.gm.consensus_for(g) for n in nodes] for g in range(cs.CONFIG5_GROUPS)]
            led = sum(1 for row in cs_of if any(c is not None and c.is_leader() for c in row))
            line = (f"{time.perf_counter() - t0:8.2f} s: timers {time.perf_counter() - t - 1.0:.3f} s "
                    f"late, {led} of {cs.CONFIG5_GROUPS} groups with a leader")
            seen["monitor"].append(line)
            print(line, flush=True)

    async def config5_leaders(nodes, groups):
        if not started:
            started.append(asyncio.ensure_future(monitor(nodes)))
        return await leaders(nodes, groups)

    async def config5_stable_leaders(nodes, groups):
        if not started:
            started.append(asyncio.ensure_future(monitor(nodes)))
        return await stable(nodes, groups)

    cs.config5_leaders = config5_leaders
    cs.config5_stable_leaders = config5_stable_leaders
    return seen


def quantiles(xs: list[float]) -> str:
    if not xs:
        return "none"
    xs = sorted(xs)
    return (f"median {xs[len(xs) // 2]:.3f} s, p99 {xs[int(len(xs) * 0.99)]:.3f} s, "
            f"max {xs[-1]:.3f} s ({len(xs)})")


def profile_round(cs, name: str) -> None:
    rnd = cs.config5_round

    async def config5_round(nodes, leaders, batches, what):
        if what != name:
            return await rnd(nodes, leaders, batches, what)
        prof = cProfile.Profile()
        prof.enable()
        try:
            return await rnd(nodes, leaders, batches, what)
        finally:
            prof.disable()
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(30)
            print(f"profile of {what}:\n{out.getvalue()}", flush=True)

    cs.config5_round = config5_round


async def idle(cs, dev, seconds: float) -> None:
    from redpanda_tpu_torch.models import NTP
    from redpanda_tpu_torch.raft import VNode, device_plane

    groups = list(range(cs.CONFIG5_GROUPS))
    with tempfile.TemporaryDirectory(prefix="raft-config5-idle-") as d:
        nodes = [cs.Config5Node(i, os.path.join(d, f"n{i}"), dev) for i in range(cs.CONFIG5_NODES)]
        try:
            for n in nodes:
                await n.start()
            for a in nodes:
                for b in nodes:
                    if a is not b:
                        a.connections.register(b.node_id, "127.0.0.1", b.server.port)
            device_plane.configure(crc_validate=True, vote_tally=True)
            voters = [VNode(i, 0) for i in range(cs.CONFIG5_NODES)]
            for g in groups:
                for n in nodes:
                    await n.gm.create_group(g, NTP("kafka", "config5", g), voters)
            _leaders, t_stable = await cs.config5_stable_leaders(nodes, groups)
            prof = cProfile.Profile()
            cpu0, wall0 = time.thread_time(), time.perf_counter()
            prof.enable()
            await asyncio.sleep(seconds)
            prof.disable()
            busy = (time.thread_time() - cpu0) / (time.perf_counter() - wall0)
            out = io.StringIO()
            pstats.Stats(prof, stream=out).sort_stats("tottime").print_stats(20)
            print(f"{cs.CONFIG5_GROUPS} groups idle on {dev} (stable after {t_stable:.2f} s): "
                  f"the loop thread busy {busy:.3f} of the wall over {seconds:.0f} s "
                  f"(under cProfile)\n{out.getvalue()}")
        finally:
            for n in nodes:
                await n.stop()
            device_plane.configure(crc_validate=False, vote_tally=False)
            device_plane.reset_default_plane()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--election-ms", type=float, default=None)
    ap.add_argument("--heartbeat-ms", type=float, default=None)
    ap.add_argument("--recovery", type=int, default=None)
    ap.add_argument("--groups", type=int, default=None)
    ap.add_argument("--profile-round", default=None, help='e.g. "run A"')
    ap.add_argument("--idle", type=float, default=None, help="seconds of idle profile")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import torch

    import chip_smoke as cs

    if args.election_ms is not None:
        cs.CONFIG5_ELECTION_MS = args.election_ms
    if args.heartbeat_ms is not None:
        cs.CONFIG5_HEARTBEAT_MS = args.heartbeat_ms
    if args.recovery is not None:
        cs.CONFIG5_RECOVERY = args.recovery
    if args.groups is not None:
        cs.CONFIG5_GROUPS = args.groups
    dev = torch.device(args.device, 0) if args.device == "cuda" else torch.device(args.device)
    print(f"raft timings: election {cs.CONFIG5_ELECTION_MS:.0f} ms, heartbeat "
          f"{cs.CONFIG5_HEARTBEAT_MS:.0f} ms, recovery throttle {cs.CONFIG5_RECOVERY}, "
          f"{cs.CONFIG5_GROUPS} groups on {dev}", flush=True)
    if dev.type == "cuda":
        from redpanda_tpu_torch import kernels

        kernels.build_all()
    if args.idle is not None:
        asyncio.run(idle(cs, dev, args.idle))
        return 0
    t0 = time.perf_counter()
    seen = instrument(cs, t0)
    if args.profile_round:
        profile_round(cs, args.profile_round)
    rc = 0
    try:
        if dev.type == "cuda":
            cs.phase_raft(dev)
        cs.phase_config5(dev)
    except SystemExit as e:  # a failed phase: print the counts all the same
        print(e, flush=True)
        rc = 1
    per5 = {}
    for t in seen["elections"]:
        per5[int(t // 5) * 5] = per5.get(int(t // 5) * 5, 0) + 1
    print(f"elections: {len(seen['elections'])} in {time.perf_counter() - t0:.1f} s; per 5 s "
          + ", ".join(f"{k}: {v}" for k, v in sorted(per5.items())))
    print(f"a follower's time without contact at its election: {quantiles(seen['gaps'])}")
    print(f"heartbeat ticks: {quantiles(seen['ticks'])}")
    if dev.type == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        print(smi.stdout.strip())
    return rc


if __name__ == "__main__":
    sys.exit(main())
