#!/usr/bin/env python3
"""Where the split CRC kernel's time goes, on one CUDA card.

    python3 chip_tools/crc_split_ablation.py

Builds variants of redpanda_tpu_torch/csrc/crc_blocks.cu (the sharded CRC
check, K9, and the CRC + vote step, K8) into build/crc_split_ablation/,
each with one part of the work taken out or done another way, and times
each launch on config 5's append (1024 rows of 16384 bytes, lengths just
under 16 KiB, four blocks of 256 rows, a bad count per four rows) with
torch.profiler's device time: with the rows in L2 and with the L2 cache
flushed before each launch. The variants:

- committed: the kernel as it is in csrc/;
- join_by_multiply: each warp's register, once its lanes are XORed,
  moved to the row's end by x^(8 d) mod P (two more carry-less multiplies
  a warp) and the warps' registers XORed, instead of the lanes' moves past
  the last span and Horner's rule over the span table;
- no_loads: the row bytes taken from registers instead of device memory;
- no_lookups: the span walk without its table lookups;
- no_multiplies: without the lanes' carry-less multiplies;
- skeleton: without loads, lookups and multiplies;
- tables_only: each CTA stages its tables and returns;

and the committed kernel over 256, 1024 and 4096 such rows (one block)
with each row in 1, 2, 4 and 8 spans.

Only `committed` and `join_by_multiply` compute the CRC; each is checked
against the plain version. Prints one line per variant, one JSON object
with every time, and the card's name and power limit. Exits 1 without a
CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "crc_split_ablation")


def patch(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise SystemExit(f"crc_split_ablation: the source changed; cannot find {old[:60]!r}")
    return text.replace(old, new)


def variant_sources() -> None:
    """Write crc32c.cuh, vote_tally.cuh and crc_blocks.cu with EXP_*
    switches into OUT."""
    csrc = os.path.join(ROOT, "redpanda_tpu_torch", "csrc")
    hdr = open(os.path.join(csrc, "crc32c.cuh")).read()
    src = open(os.path.join(csrc, "crc_blocks.cu")).read()
    load = ("        const uint4 v = __ldg(reinterpret_cast<const uint4*>(src + p));\n"
            "        w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;")
    hdr = patch(hdr, load, "#ifdef EXP_NO_LOADS\n"
                "        w[0] = (uint32_t)p * 2654435761u ^ lane; w[1] = w[0] * 3u;\n"
                "        w[2] = w[0] * 5u; w[3] = w[0] * 7u;\n#else\n" + load + "\n#endif")
    steps = "      acc = step8(t, acc, w[0], w[1]);\n      acc = step8(t, acc, w[2], w[3]);"
    hdr = patch(hdr, steps, "#ifdef EXP_NO_LOOKUPS\n"
                "      acc = ((acc << 1) | (acc >> 31)) ^ w[0] ^ w[1] ^ w[2] ^ w[3];\n#else\n"
                + steps + "\n#endif")
    skip = "    if (p >= kRound) acc = skip(t, acc);  // the other lanes' 496 bytes"
    hdr = patch(hdr, skip, "#ifndef EXP_NO_LOOKUPS\n" + skip + "\n#endif")
    stage = "  stage_tables(t, ts, crc_tables, span_table, wpr > 1);\n"
    src = patch(src, stage, stage + "#ifdef EXP_TABLES_ONLY\n"
                "  if (t[threadIdx.x] == 0x12345678u && crc_ctas < 0) ok[0] = 1;\n"
                "  return;\n#endif\n")
    tail = "        const int tail = j < m - 1 ? len - (m - 1) * span : 0;\n"
    src = patch(src, tail, "#ifdef EXP_JOIN_BY_MULTIPLY\n        const int tail = 0;\n#else\n"
                + tail + "#endif\n")
    mul = "        if (d > 0 && reg != 0) {\n"
    src = patch(src, mul, "#ifdef EXP_NO_MULTIPLIES\n        if (false) {\n#else\n" + mul
                + "#endif\n")
    # the first design: each warp's register moved to the row's end after
    # the lanes' XOR (x^(8d), d = 512 q + m: two more multiplies a warp,
    # q's power from global memory), the warps' registers XORed
    xor = "        reg = rp_crc::warp_xor(reg);\n"
    src = patch(src, xor, xor + "#ifdef EXP_JOIN_BY_MULTIPLY\n"
                "        const int dd = len - s1;\n"
                "        if (dd % rp_crc::kRound)\n"
                "          reg = rp_crc::multmodp(t[rp_crc::kPowOff + dd % rp_crc::kRound], reg);\n"
                "        if (dd / rp_crc::kRound)\n"
                "          reg = rp_crc::multmodp(__ldg(rounds + dd / rp_crc::kRound), reg);\n"
                "#endif\n")
    join = ("        for (int w = 1; w < m - 1; ++w) reg = rp_crc::sliced(ts, reg) ^ part[warp + w];\n"
            "        if (m > 1) reg ^= part[warp + m - 1];\n")
    src = patch(src, join, "#ifdef EXP_JOIN_BY_MULTIPLY\n"
                "        for (int w = 1; w < wpr; ++w) reg ^= part[warp + w];\n#else\n"
                + join + "#endif\n")
    os.makedirs(OUT, exist_ok=True)
    for name, text in (("crc32c.cuh", hdr), ("crc_blocks.cu", src),
                       ("vote_tally.cuh", open(os.path.join(csrc, "vote_tally.cuh")).read())):
        with open(os.path.join(OUT, name), "w") as f:
            f.write(text)


VARIANTS = {
    "committed": [], "join_by_multiply": ["-DEXP_JOIN_BY_MULTIPLY"],
    "no_loads": ["-DEXP_NO_LOADS"], "no_lookups": ["-DEXP_NO_LOOKUPS"],
    "no_multiplies": ["-DEXP_NO_MULTIPLIES"],
    "skeleton": ["-DEXP_NO_LOADS", "-DEXP_NO_LOOKUPS", "-DEXP_NO_MULTIPLIES"],
    "tables_only": ["-DEXP_TABLES_ONLY"],
}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("crc_split_ablation: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.hashing.crc32c import crc32c_many
    from redpanda_tpu_torch.ops.crc32c_device import (
        kernel_tables_on, round_powers_on, sm_count, span_table_on, split_layout)
    from redpanda_tpu_torch.parallel.collectives import sharded_crc_plain
    from torch.profiler import ProfilerActivity, profile

    variant_sources()
    procs = {}
    for name, flags in VARIANTS.items():
        lib = os.path.join(OUT, f"lib_{name}.so")
        procs[name] = (lib, subprocess.Popen(
            [kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", OUT, *flags, "-o", lib,
             os.path.join(OUT, "crc_blocks.cu")], stderr=subprocess.PIPE, text=True))
    fns = {}
    for name, (lib, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise SystemExit(f"crc_split_ablation: {name} did not build:\n{err}")
        fn = ctypes.CDLL(lib).rp_crc_blocks
        fn.restype, fn.argtypes = ctypes.c_int, kernels.CRC32C_SHARDED.argtypes
        fns[name] = (fn, " ".join(l.split(":", 1)[-1].strip() for l in err.splitlines()
                                  if "registers" in l))

    dev = torch.device("cuda", 0)
    n, r, seg, blocks = 1024, 16384, 4, 4
    rng = np.random.default_rng(10)
    rows = rng.integers(0, 256, size=(n, r), dtype=np.uint8)
    lens = rng.integers(15_000, r + 1, n).astype(np.int32)
    claimed = crc32c_many(rows, lens)
    claimed[[3, n // 2, n - 1]] ^= 1
    rt = torch.from_numpy(rows).to(dev)
    lt = torch.from_numpy(lens).to(dev)
    ct = torch.from_numpy(claimed.view(np.int32)).to(dev)
    w_ok, w_bad = sharded_crc_plain(rt.view(n // seg, seg, r), lt.view(n // seg, seg),
                                    ct.view(n // seg, seg))
    k = n // blocks
    table = (ctypes.c_void_p * (4 * blocks))(*[
        p for d in range(blocks) for p in (rt[d * k:(d + 1) * k].data_ptr(),
                                          lt[d * k:(d + 1) * k].data_ptr(),
                                          ct[d * k:(d + 1) * k].data_ptr(), None)])
    ok = torch.empty(n, dtype=torch.bool, device=dev)
    bad = torch.empty(n // seg, dtype=torch.int32, device=dev)
    wpr, span = split_layout(r, n, sm_count(dev))
    rounds = round_powers_on(dev)
    argv = (table, blocks, k, r, seg, wpr, span, kernel_tables_on(dev).data_ptr(),
            rounds.data_ptr(), rounds.shape[0], span_table_on(dev, span).data_ptr(), None,
            ok.data_ptr(), bad.data_ptr(), n // seg, 0, 0, None,
            torch.cuda.current_stream(dev).cuda_stream)
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    valid = int(np.clip(lens, 0, r).sum())

    def device_ms(fn, flush: bool, args=None) -> float:
        args = argv if args is None else args
        for _ in range(3):  # the profiler now and then delivers no kernel record
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(40):
                    if flush:
                        l2_flush.fill_(1)
                    if fn(*args) != 0:
                        raise SystemExit("crc_split_ablation: a launch was refused")
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if "crc_blocks_kernel" in e.key]
            if ev:
                return ev[0].device_time_total / 1e3 / ev[0].count
        raise SystemExit("crc_split_ablation: the profiler saw no kernel time")

    print(f"config 5's append: {n} x {r}, {valid} valid B, {wpr} spans of {span} B a row; "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs", flush=True)
    result = {}
    for name, (fn, regs) in fns.items():
        fn(*argv)
        torch.cuda.synchronize()
        right = torch.equal(ok, w_ok.view(-1)) and torch.equal(bad, w_bad)
        if name in ("committed", "join_by_multiply") and not right:
            raise SystemExit(f"crc_split_ablation: {name} != the plain version")
        warm, cold = device_ms(fn, False), device_ms(fn, True)
        result[name] = {"warm_ms": warm, "l2_flushed_ms": cold, "computes_crc": right,
                        "ptxas": regs}
        crc = "equal to the plain version" if right else "no CRC"
        print(f"{name:17s} {warm:.4f} ms with the rows in L2 ({valid / warm / 1e6:.1f} GB/s), "
              f"{cold:.4f} ms with L2 flushed; {crc}; {regs}", flush=True)
    fn = fns["committed"][0]
    for rows_n in (256, 1024, 4096):  # the committed kernel with other splits of the row
        rr = torch.from_numpy(rng.integers(0, 256, size=(rows_n, r), dtype=np.uint8)).to(dev)
        ll = torch.from_numpy(rng.integers(15_000, r + 1, rows_n).astype(np.int32)).to(dev)
        cc = torch.from_numpy(crc32c_many(rr.cpu().numpy(), ll.cpu().numpy()).view(np.int32))
        cc = cc.to(dev)
        okk = torch.empty(rows_n, dtype=torch.bool, device=dev)
        bb = torch.empty(rows_n // seg, dtype=torch.int32, device=dev)
        tab = (ctypes.c_void_p * 4)(rr.data_ptr(), ll.data_ptr(), cc.data_ptr(), None)
        for lw in (1, 2, 4, 8):
            lspan = -(-(-(-r // lw)) // 512) * 512
            largv = (tab, 1, rows_n, r, seg, lw, lspan) + argv[7:10] + (
                span_table_on(dev, lspan).data_ptr(), None, okk.data_ptr(), bb.data_ptr(),
                rows_n // seg) + argv[15:]
            fn(*largv)
            torch.cuda.synchronize()
            if int(bb.sum()) != 0 or not bool(okk.all()):
                raise SystemExit(f"crc_split_ablation: {lw} spans of {lspan} B: a row is bad")
            warm = device_ms(fn, False, largv)
            result[f"committed_{rows_n}_rows_{lw}_spans"] = {"warm_ms": warm, "span": lspan}
            print(f"committed over {rows_n} rows, {lw} spans of {lspan} B a row: {warm:.4f} ms "
                  "with the rows in L2", flush=True)
    print(json.dumps(result))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
