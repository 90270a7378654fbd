#!/usr/bin/env python3
"""Smoke run of the PyTorch port (redpanda_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. Build every CUDA kernel from redpanda_tpu_torch/csrc/ with nvcc (one
   nvcc per source, all started together) and print the build times.
2. Hold each kernel against its plain PyTorch version on the same CUDA
   tensors, bit for bit: the predicate (K1) over the DOCS x EXPRS table,
   a tree deeper than one stack word, and the bench's 32768 rows; the
   payload transform (K3/K4) over the bench's staged rows in both output
   layouts. Print kernel ms (CUDA events), plain ms and the bound.
3. Drive TorchEngine(device="cuda") the way bench.py drives the engine:
   64 partitions x 32 records x ~1 KB JSON, row_stride 1152, GROUP 16
   ticks fused per launch, DEPTH 3 launches in flight, 160 ticks, for the
   columnar spec and the payload spec, plus the same shape with short
   messages so that records survive the projection. Every reply must be
   byte-identical to TorchEngine(device="cpu") on the same requests, and
   every kernel's launch count over this phase must be > 0. Print
   record_batches/s, stage times and H2D/D2H bytes and ms.
4. Print the kernels line, the card's name and power limit, and last the
   {"ok": true, "device": ...} line.

Without a CUDA device it exits 1 before printing any result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

P = 64  # partitions
RECORDS_PER_BATCH = 32
RECORD_JSON_PAD = 900  # ~1 KB records
ROW_STRIDE = 1152
GROUP = 16  # ticks fused per launch
DEPTH = 3  # launch groups in flight
TICKS = 160
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
SCALAR_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores


def log(*args) -> None:
    print(*args, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


# ------------------------------------------------------------------ inputs
def build_request(short_msgs: bool, seed: int = 0):
    """The bench's request (bench.py _build_workload): one batch of 32 JSON
    records per partition. ``short_msgs`` keeps the ~1 KB size in a pad
    field and draws msg lengths around the projection's 64 bytes, with one
    record wider than the staging row."""
    import numpy as np

    from redpanda_tpu_torch.coproc.engine import ProcessBatchItem, ProcessBatchRequest
    from redpanda_tpu_torch.models import NTP, Record, RecordBatch

    rng = np.random.default_rng(seed)
    levels = ["error", "info", "warn"]
    items = []
    for p in range(P):
        recs = []
        for i in range(RECORDS_PER_BATCH):
            pad = RECORD_JSON_PAD + int(rng.integers(0, 100))
            if short_msgs:
                msg = "m" * int(rng.integers(0, 90))
                if p == 7 and i == 3:
                    pad = ROW_STRIDE + 50
                doc = '{"level":"%s","code":%d,"msg":"%s","pad":"%s"}' % (
                    levels[(p + i) % 3], i - 5, msg, "y" * pad)
            else:
                doc = '{"level":"%s","code":%d,"msg":"%s"}' % (levels[(p + i) % 3], i, "x" * pad)
            recs.append(Record(offset_delta=i, timestamp_delta=i, value=doc.encode()))
        batch = RecordBatch.build(recs, base_offset=0, first_timestamp=1_000_000)
        items.append(ProcessBatchItem(1, NTP.kafka("bench", p), [batch]))
    return ProcessBatchRequest(items)


def columnar_spec():
    from redpanda_tpu_torch.ops.exprs import field
    from redpanda_tpu_torch.ops.transforms import Int, Str, map_project, where

    return where(field("level") == "error") | map_project(Int("code"), Str("msg", 64))


def payload_spec():
    from redpanda_tpu_torch.ops.transforms import Int, Str, filter_field_eq, map_project

    return filter_field_eq("level", "error") | map_project(Int("code"), Str("msg", 64))


def docs_and_exprs():
    """The DOCS x EXPRS table of tests/test_exprs.py."""
    from redpanda_tpu_torch.ops.exprs import field

    docs = [
        {"level": "error", "code": 500, "msg": "boom"},
        {"level": "info", "code": 200, "msg": "fine"},
        {"level": "error", "code": 42, "msg": "xx"},
        {"level": "warn", "meta": {"retriable": True, "n": 3}, "code": 503},
        {"code": 1.5, "msg": "nolevel"},
        {"level": "error", "msg": "nocode"},
        {"level": "errorx", "code": 500},
        {"level": "", "code": 0},
        {"level": None, "code": -7},
        {"level": True, "code": 2**31 - 1},
        {"level": "error", "code": 2**31},
        {"level": "error", "code": 499.5},
        {"level": "error", "code": "500"},
        {"meta": {"retriable": False}},
        {"meta": "flat"},
        {"msg": "needle in a haystack", "code": 1},
        {"msg": "no ndl here", "code": 2},
        {"deep": {"a": {"b": 9}}},
        {},
    ]
    f = field
    exprs = [
        f("level") == "error", f("level") != "error", f("code") == 500, f("code") != 500,
        f("code") < 100, f("code") <= 42, f("code") > 499, f("code") >= 500, f("code") >= 499.6,
        f("level") == True, f("level") == None, f("level") != None,  # noqa: E711,E712
        f("level").exists(), ~f("level").exists(), f("meta.retriable") == True,  # noqa: E712
        f("meta.n") >= 3, f("deep.a.b") == 9, f("msg").contains(b"needle"),
        f("msg").contains(b"ndl", window=6),
        (f("level") == "error") & (f("code") >= 100),
        (f("level") == "error") | (f("code") < 2),
        ~((f("level") == "error") & (f("code") >= 100)),
        (f("level") == "error") & ((f("code") >= 500) | ~f("msg").exists()),
        f("msg").contains(b"hay", window=8) | f("msg").contains(b"x", window=64),
    ]
    vals = [json.dumps(d, separators=(",", ":")).encode() for d in docs]
    return vals, exprs


def deep_expr():
    """A tree whose evaluation stack is 150 deep: the kernel spills words."""
    from redpanda_tpu_torch.ops import exprs as E

    leaves = [E.field("code") >= k for k in range(-60, 90)]
    expr = leaves[-1]
    for i, leaf in enumerate(reversed(leaves[:-1])):
        expr = E.Or(leaf, expr) if i % 2 else E.And(leaf, expr)
    return expr


# ------------------------------------------------------------------ timing
def cuda_ms(fn, iters: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_abs_err(pairs) -> float:
    """Largest |kernel - plain| over (kernel, plain) tensor pairs."""
    import torch

    return max(
        (float((a.to(torch.int64) - b.to(torch.int64)).abs().max()) for a, b in pairs if a.numel()),
        default=0.0,
    )


# ------------------------------------------------------------------ phases
def phase_predicate(dev) -> dict:
    import numpy as np
    import torch

    from redpanda_tpu_torch.coproc import batch_codec
    from redpanda_tpu_torch.coproc.column_plan import plan_spec, predicate_plain
    from redpanda_tpu_torch.ops.exprs import host_eval
    from redpanda_tpu_torch.ops.transforms import where

    def cols_for(plan, vals, n_pad):
        joined = b"".join(vals)
        offsets = np.cumsum([0] + [len(v) for v in vals[:-1]]).astype(np.int64)
        sizes = np.array([len(v) for v in vals], np.int32)
        return [torch.from_numpy(c).to(dev) for c in plan.extract_device_inputs(
            joined, offsets, sizes, n_pad)]

    vals, exprs = docs_and_exprs()
    for i, expr in enumerate(exprs):
        plan = plan_spec(where(expr))
        cols = cols_for(plan, vals, 24)
        got = plan.predicate(cols)
        torch.cuda.synchronize()
        if not torch.equal(got, predicate_plain(plan, cols)):
            fail(f"predicate kernel != plain on EXPRS[{i}]")
        oracle = np.array([host_eval(expr, v) for v in vals])
        if not (np.unpackbits(got.cpu().numpy())[: len(vals)].astype(bool) == oracle).all():
            fail(f"predicate kernel != host oracle on EXPRS[{i}]")
    deep = plan_spec(where(deep_expr()))
    rng = np.random.default_rng(5)
    deep_vals = [b'{"code":%d}' % int(c) for c in rng.integers(-100, 100, 2003)]
    cols = cols_for(deep, deep_vals, 2008)
    if not torch.equal(deep.predicate(cols), predicate_plain(deep, cols)):
        fail("predicate kernel != plain on the deep tree")
    log(f"K1 parity: {len(exprs)} DOCS x EXPRS cases and a depth-{deep.program.depth} "
        "tree bit-identical to the plain version")

    # the bench's launch: GROUP ticks x 64 partitions x 32 records
    req = build_request(short_msgs=False)
    batches = [b for it in req.items for b in it.batches] * GROUP
    plan = plan_spec(columnar_spec())
    ex, types, vs, ve = batch_codec.explode_and_find(batches, plan.flat_paths())
    cache = plan.make_cache_from_tables(ex, plan.flat_paths(), types, vs, ve)
    n = len(ex.sizes)
    cols = [torch.from_numpy(c).to(dev) for c in plan.extract_device_inputs(
        ex.joined, ex.offsets, ex.sizes, n, cache)]
    got = plan.predicate(cols)
    want = predicate_plain(plan, cols)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        fail("predicate kernel != plain at the bench shape")
    ms = cuda_ms(lambda: plan.predicate(cols), 200)
    plain_ms = cuda_ms(lambda: predicate_plain(plan, cols), 20)
    nbytes = sum(c.nbytes for c in cols) + n // 8
    b_ms, b_by = bound_ms(nbytes, n * len(plan.program.code))
    log(f"K1 bench shape: n={n} kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms * 1e3:.3f} us ({b_by}, {nbytes} B)")
    return {"max_abs_err": max_abs_err([(got, want)]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def phase_payload(dev) -> dict:
    import torch

    from redpanda_tpu_torch.coproc import batch_codec
    from redpanda_tpu_torch.coproc.engine import _bucket_rows, pack_staged
    from redpanda_tpu_torch.ops.pipeline import IN_META, OUT_META, packed_plain, record_plain
    from redpanda_tpu_torch.ops.pipeline import run_packed, run_record
    from redpanda_tpu_torch.ops.transforms import (
        compile_transform, filter_contains, map_uppercase)

    out = {}
    specs = {"project": payload_spec(), "uppercase": filter_contains(b"warn") | map_uppercase()}
    for short in (False, True):
        req = build_request(short_msgs=short)
        batches = [b for it in req.items for b in it.batches] * GROUP
        ex = batch_codec.explode_batches(batches)
        n_pad = _bucket_rows(len(ex.sizes))
        staged_np = torch.empty((n_pad, ROW_STRIDE + IN_META), dtype=torch.uint8)
        pack_staged(ex, ROW_STRIDE, staged_np.numpy())
        staged = staged_np.to(dev)
        for name, spec in specs.items():
            prog = compile_transform(spec, ROW_STRIDE)
            got = run_packed(prog, staged)
            want = packed_plain(prog, staged)
            torch.cuda.synchronize()
            keep = want[:, prog.r_out + 4].bool()
            if not (torch.equal(got[:, prog.r_out:], want[:, prog.r_out:])
                    and torch.equal(got[keep, : prog.r_out], want[keep, : prog.r_out])):
                fail(f"payload kernel != plain (packed, {name}, short={short})")
            data = staged[:, :ROW_STRIDE].contiguous()
            lens = staged[:, ROW_STRIDE : ROW_STRIDE + 4].contiguous().view(torch.int32).reshape(-1)
            g_out, g_len, g_keep = run_record(prog, data, lens)
            w_out, w_len, w_keep = record_plain(prog, data, lens)
            torch.cuda.synchronize()
            if not (torch.equal(g_keep, w_keep) and torch.equal(g_len, w_len)
                    and torch.equal(g_out[w_keep], w_out[w_keep])):
                fail(f"payload kernel != plain (unpacked, {name}, short={short})")
            log(f"K3/K4 parity ({name}, {'short' if short else 'bench'} msgs): "
                f"{int(keep.sum())} of {n_pad} rows kept, bit-identical in both layouts")
            if name == "project" and not short:
                ms = cuda_ms(lambda: run_packed(prog, staged), 50)
                plain_ms = cuda_ms(lambda: packed_plain(prog, staged), 3)
                nbytes = staged.nbytes + n_pad * (prog.r_out + OUT_META)
                b_ms, b_by = bound_ms(nbytes, staged.nbytes)
                pinned = staged_np.pin_memory()
                h2d_ms = cuda_ms(lambda: staged.copy_(pinned, non_blocking=True), 10)
                log(f"K3/K4 bench shape: {n_pad} x {ROW_STRIDE + IN_META} B staged, kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {b_ms * 1e3:.2f} us "
                    f"({b_by}, {nbytes} B); staged H2D from pinned memory {h2d_ms:.3f} ms")
                # compared: the meta columns of every row, the output of kept rows
                err = max_abs_err([(got[:, prog.r_out:], want[:, prog.r_out:]),
                                   (got[keep, : prog.r_out], want[keep, : prog.r_out])])
                out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b_ms, "bound_by": b_by, "h2d_ms": h2d_ms}
    return out


def reply_bytes(reply):
    return [(it.script_id, it.source.partition, [b.encode_internal() for b in it.batches])
            for it in reply.items], list(reply.deregistered)


def run_stream(engine, req, n_ticks):
    """GROUP ticks per launch, DEPTH launches in flight, replies fully
    rebuilt on the critical path (bench.py _run_engine_stream)."""
    n_groups = (n_ticks + GROUP - 1) // GROUP
    pending, replies = [], []
    t0 = time.perf_counter()
    for g in range(n_groups):
        k = min(GROUP, n_ticks - g * GROUP)
        pending.append(engine.submit_group([req] * k))
        while len(pending) > DEPTH:
            replies.extend(t.result() for t in pending.pop(0))
    while pending:
        replies.extend(t.result() for t in pending.pop(0))
    elapsed = time.perf_counter() - t0
    return replies, n_ticks * len(req.items) / elapsed


def phase_engine(dev) -> dict:
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc.engine import TorchEngine

    specs = {"columnar": columnar_spec(), "payload": payload_spec()}
    work = {"bench": build_request(short_msgs=False), "short_msgs": build_request(short_msgs=True)}
    want = {}
    for sname, spec in specs.items():
        cpu = TorchEngine(device="cpu", row_stride=ROW_STRIDE)
        cpu.enable_coprocessors([(1, spec.to_json(), ("bench",))])
        for wname, req in work.items():
            want[sname, wname] = [reply_bytes(t.result()) for t in cpu.submit_group([req] * GROUP)]
    engines = {}
    for sname, spec in specs.items():
        eng = TorchEngine(device=dev, row_stride=ROW_STRIDE)
        if eng.enable_coprocessors([(1, spec.to_json(), ("bench",))]) != [0]:
            fail(f"enable {sname}")
        run_stream(eng, work["bench"], GROUP + 1)  # warm-up
        eng.reset_stats()
        engines[sname] = eng

    kernels.reset_launches()  # the main path starts here
    results = {}
    for sname, eng in engines.items():
        for wname, req in work.items():
            n_ticks = TICKS if wname == "bench" else 2 * GROUP
            replies, rate = run_stream(eng, req, n_ticks)
            ref = want[sname, wname]
            for k, rep in enumerate(replies):
                if reply_bytes(rep) != ref[k % GROUP]:
                    fail(f"{sname} {wname}: CUDA reply {k} differs from the CPU engine's")
            kept = sum(len(b) for _, _, b in ref[0][0])
            results[sname, wname] = (rate, kept)
            if wname == "short_msgs" and kept == 0:
                fail(f"{sname} short_msgs: no output batch to compare")
            if wname == "bench":
                st = eng.stats()
                stages = {k: round(v, 6) for k, v in sorted(st.items())
                          if k.startswith(("t_", "n_", "bytes_"))}
                log(f"engine {sname} bench: {rate:.1f} record_batches/s over {n_ticks} ticks "
                    f"(GROUP {GROUP}, DEPTH {DEPTH}); H2D {st.get('bytes_h2d', 0):.0f} B "
                    f"in {st.get('t_dev_h2d', 0) * 1e3:.3f} ms, D2H {st.get('bytes_d2h', 0):.0f} B "
                    f"in {st.get('t_dev_d2h', 0) * 1e3:.3f} ms, kernel "
                    f"{st.get('t_dev_kernel', 0) * 1e3:.3f} ms")
                busy = (st.get("t_dev_h2d", 0) + st.get("t_dev_kernel", 0)
                        + st.get("t_dev_d2h", 0)) * rate / (n_ticks * len(req.items))
                log(f"engine {sname} stages: {json.dumps(stages)}")
                log(f"engine {sname}: device stream busy {busy:.2%} of the wall "
                    "(sum of CUDA-event stream intervals)")
                if any(k.startswith("n_failures") for k in st):
                    fail(f"{sname}: engine failures {st}")
            else:
                log(f"engine {sname} short_msgs: {rate:.1f} record_batches/s, "
                    f"{kept} output batches per tick, replies byte-identical to the CPU engine")
    launches = {k.name: k.launches for k in kernels.KERNELS}  # the main path ends here
    for name, count in launches.items():
        if count <= 0:
            fail(f"kernel {name} was not launched on the main path")
    for eng in engines.values():
        eng.shutdown()
    log(f"engine parity: every reply of both specs byte-identical to TorchEngine(cpu); "
        f"main-path launches {launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from redpanda_tpu_torch import kernels

    from redpanda_tpu_torch.compression import codecs

    dev = torch.device("cuda", 0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")
    zstd = ("zstandard" if codecs.zstandard is not None
            else "libzstd via ctypes" if codecs.zstd_available() else "none (output degrades to gzip)")
    log(f"zstd codec: {zstd}")
    t0 = time.perf_counter()
    builds = kernels.build_all()
    log(f"built kernels in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{k} {s:.2f} s" for k, s in builds.items()))
    for k in kernels.KERNELS:
        ptxas = [ln.strip() for ln in k.build_log().splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {k.name}: {' | '.join(ptxas)}")
    k1 = phase_predicate(dev)
    k3 = phase_payload(dev)
    launches = phase_engine(dev)
    measured = {"predicate": k1, "payload_transform": k3}
    line = []
    for k in kernels.KERNELS:
        m = measured[k.name]
        line.append({
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": launches[k.name], "max_abs_err": m["max_abs_err"], "ms": m["ms"],
            "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"], "bound_by": m["bound_by"],
            "library_ms": None, "parity": "bit-identical",
        })
    log(json.dumps({"kernels": line}))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
