#!/usr/bin/env python3
"""Where the payload transform's launch time goes, on one CUDA card.

    python3 chip_tools/payload_ablation.py [--parent DIR]

Builds variants of redpanda_tpu_torch/csrc/payload_transform.cu (the v1
payload transform, K3, and its packed pipeline, K4) into
build/payload_ablation/, each with a part of the work taken out, and times
one launch of its C entry point, called directly on tensors made ahead of
time, at the engine's bench shape: the bench's 64 partitions x 32 ~1 KB
JSON records, 16 ticks to a launch, staged as chip_smoke.py stages them
(32768 rows of 1160 B: a 1152-byte row and 8 bytes of meta, so every
other row is only 8-byte aligned). Specs: the engine's projection
(filter_field_eq("level", "error") | map_project(Int("code"), Str("msg",
64))) and the uppercase spec (filter_contains(b"warn") | map_uppercase()),
over the bench's messages and over short ones. The variants:

- full: the kernel as it is in the sources;
- load_only: the row's load, no filter, no mapper, no output row (the
  meta columns are still written);
- load_filter: the load and the filters' scans;
- load_filter_map: the load, the filters and the mapper, no output row;
- aligned_rows: the full kernel on the same rows restaged at a stride of
  1168 B, so every row starts on a 16-byte boundary;
- full_min4, 5, 6, 8 (this checkout's kernel only): the full kernel built
  with __launch_bounds__(256, N), so that N CTAs of 8 warps fit an SM by
  their registers.

Each is timed with CUDA events over back-to-back launches and with
torch.profiler's device time, with the rows in L2 and with the L2 cache
flushed before each launch (a 128 MB write outside the timed interval).
The full kernel is also timed in the unpacked layout (K3: lengths as their
own array, out / out_len / keep) and through the wrappers as a call
(run_packed, run_record; CUDA events over back-to-back calls).

With --parent DIR (an unpacked checkout of another commit), the same
launches run on that checkout's kernel in the same process, its variants
made the same way, so two designs compare on one card. The full variants
are checked against the plain version (meta columns of every row, the
output of kept rows). Prints one line per measurement, one
JSON object with every time, and the card's name and power limit. Exits 1
without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "payload_ablation")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate

# Each switch inserts code at one line of payload_transform.cuh (.cu for
# the launch bounds); the anchors name the lines in each design the script
# knows (the earlier one-warp-a-row design and the staged ring): exactly one
# must match.
SWITCHES = [
    ("EXP_MIN_BLOCKS", ["__global__ void payload_kernel("],
     "#ifdef EXP_MIN_BLOCKS\n__global__ void __launch_bounds__(256, EXP_MIN_BLOCKS) "
     "payload_kernel(\n#else\n__global__ void payload_kernel(\n#endif\n", "replace"),
    ("EXP_NO_FILTER", ["  bool keep = len > 0;\n"],
     "#ifdef EXP_NO_FILTER\n  n_filters = 0;\n"
     "  if (mask_len < 0 && row[lane] == 0xFFu) keep = false;  // keeps the load alive\n#endif\n",
     "after"),
    ("EXP_NO_MAP", ["  int olen = len;\n"], "#ifdef EXP_NO_MAP\n  mapper = 0;\n#endif\n", "after"),
    ("EXP_NO_STORE",
     ["  if (mapper != kMapperProject || keep) warp_store(dst, src, r_out, lane);\n",
      "  if (mapper != kMapperProject || keep) warp_copy(dst, src, nbytes, lane);\n"],
     None, "wrap"),
]

VARIANTS = {
    "full": [],
    "load_only": ["-DEXP_NO_FILTER", "-DEXP_NO_MAP", "-DEXP_NO_STORE"],
    "load_filter": ["-DEXP_NO_MAP", "-DEXP_NO_STORE"],
    "load_filter_map": ["-DEXP_NO_STORE"],
}
# the full kernel held to at least N CTAs of 256 threads an SM (at most
# 65536 / (256 N) registers a thread): the occupancy the registers allow
OCCUPANCY = {f"full_min{n}": [f"-DEXP_MIN_BLOCKS={n}"] for n in (4, 5, 6, 8)}


def variant_sources(csrc: str, out: str) -> None:
    """Copy payload_transform.cu and its header from ``csrc`` into ``out``
    with the EXP_* switches put in."""
    text = {f: open(os.path.join(csrc, f)).read()
            for f in ("payload_transform.cuh", "payload_transform.cu")}
    for name, anchors, code, how in SWITCHES:
        f = "payload_transform.cu" if name == "EXP_MIN_BLOCKS" else "payload_transform.cuh"
        found = [a for a in anchors if text[f].count(a) == 1]
        if len(found) != 1:
            raise SystemExit(f"payload_ablation: cannot place {name} in {csrc}")
        a = found[0]
        new = {"after": a + (code or ""), "replace": code,
               "wrap": f"#ifndef {name}\n{a}#endif\n"}[how]
        text[f] = text[f].replace(a, new)
    os.makedirs(out, exist_ok=True)
    for f, t in text.items():
        with open(os.path.join(out, f), "w") as fh:
            fh.write(t)


def build(designs: dict[str, str]) -> dict:
    """Every variant of every design, one nvcc each, all started together:
    {(design, variant): (entry point, ptxas register line)}."""
    from redpanda_tpu_torch import kernels

    procs = {}
    for design, csrc in designs.items():
        out = os.path.join(OUT, design)
        variant_sources(csrc, out)
        variants = {**VARIANTS, **(OCCUPANCY if design == "this" else {})}
        for name, flags in variants.items():
            lib = os.path.join(out, f"lib_{name}.so")
            procs[design, name] = (lib, subprocess.Popen(
                [kernels.nvcc(), *kernels.NVCC_FLAGS, "-I", out, *flags, "-o", lib,
                 os.path.join(out, "payload_transform.cu")], stderr=subprocess.PIPE, text=True))
    fns = {}
    for key, (lib, proc) in procs.items():
        err = proc.communicate()[1]
        if proc.returncode:
            raise SystemExit(f"payload_ablation: {key} did not build:\n{err}")
        fn = ctypes.CDLL(lib).rp_payload_transform
        fn.restype, fn.argtypes = ctypes.c_int, kernels.PAYLOAD_TRANSFORM.argtypes
        regs = " ".join(ln.split(":", 1)[-1].strip() for ln in err.splitlines()
                        if "registers" in ln)
        fns[key] = (fn, regs)
    return fns


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout whose kernel is timed beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("payload_ablation: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as S
    from redpanda_tpu_torch import kernels
    from redpanda_tpu_torch.coproc import batch_codec
    from redpanda_tpu_torch.coproc.engine import _bucket_rows, pack_staged
    from redpanda_tpu_torch.ops.pipeline import (
        IN_META, OUT_META, packed_plain, record_plain, run_packed, run_record)
    from redpanda_tpu_torch.ops.transforms import (
        compile_transform, filter_contains, map_uppercase)
    from torch.profiler import ProfilerActivity, profile

    designs = {"this": os.path.join(ROOT, "redpanda_tpu_torch", "csrc")}
    if args.parent:
        designs["parent"] = os.path.join(os.path.abspath(args.parent), "redpanda_tpu_torch", "csrc")
    fns = build(designs)
    dev = torch.device("cuda", 0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    l2_flush = torch.empty(128 << 20, dtype=torch.uint8, device=dev)
    r = S.ROW_STRIDE

    def events_ms(run, flush: bool, iters: int = 50) -> float:
        run()
        torch.cuda.synchronize()
        if not flush:
            return S.cuda_ms(run, iters)
        total = 0.0
        for _ in range(iters):
            l2_flush.fill_(1)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters

    def device_ms(run, flush: bool) -> float:
        for _ in range(3):  # the profiler now and then delivers no kernel record
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(40):
                    if flush:
                        l2_flush.fill_(1)
                    run()
                torch.cuda.synchronize()
            ev = [e for e in prof.key_averages() if "payload_kernel" in e.key]
            if ev:
                return ev[0].device_time_total / 1e3 / ev[0].count
        raise SystemExit("payload_ablation: the profiler saw no kernel time")

    def raw(fn, prog, src, lens, out, out_len, keep):
        desc, pats = prog.on(dev)
        argv = (src.data_ptr(), src.stride(0), None if lens is None else lens.data_ptr(),
                src.shape[0], prog.r_in, out.data_ptr(), out.stride(0),
                None if out_len is None else out_len.data_ptr(),
                None if keep is None else keep.data_ptr(), prog.r_out, 1, desc.data_ptr(),
                prog.n_filters, prog.mapper, prog.n_fields, pats.data_ptr(), stream)

        def run():
            if fn(*argv) != 0:
                raise SystemExit("payload_ablation: a launch was refused")

        return run

    def timed(label: str, run, nbytes: int) -> dict:
        t = {"events_ms": events_ms(run, False), "events_l2_flushed_ms": events_ms(run, True),
             "device_ms": device_ms(run, False), "device_l2_flushed_ms": device_ms(run, True)}
        print(f"{label}: device {t['device_ms']:.4f} ms ({nbytes / t['device_ms'] / 1e6:.1f} GB/s), "
              f"{t['device_l2_flushed_ms']:.4f} with L2 flushed; events {t['events_ms']:.4f}, "
              f"{t['events_l2_flushed_ms']:.4f} flushed", flush=True)
        return t

    specs = {"project": S.payload_spec(), "uppercase": filter_contains(b"warn") | map_uppercase()}
    print(f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.get_device_properties(0).multi_processor_count} SMs; designs "
          f"{sorted(designs)}", flush=True)
    for key, (_, regs) in sorted(fns.items()):
        print(f"  {key[0]} {key[1]}: {regs}", flush=True)
    result = {}
    for short in (False, True):
        msgs = "short" if short else "bench"
        batches = [b for it in S.build_request(short_msgs=short).items for b in it.batches] * S.GROUP
        ex = batch_codec.explode_batches(batches)
        n = _bucket_rows(len(ex.sizes))
        staged_np = torch.empty((n, r + IN_META), dtype=torch.uint8)
        pack_staged(ex, r, staged_np.numpy())
        staged = staged_np.to(dev)
        aligned = torch.zeros((n, r + IN_META + 8), dtype=torch.uint8, device=dev)
        aligned[:, : r + IN_META] = staged
        aligned_rows = aligned[:, : r + IN_META]  # stride 1168: every row 16-byte aligned
        data = staged[:, :r].contiguous()
        lens = staged[:, r : r + 4].contiguous().view(torch.int32).reshape(-1)
        for sname, spec in specs.items():
            prog = compile_transform(spec, r)
            want = packed_plain(prog, staged)
            kept = want[:, prog.r_out + 4].bool()
            w_out, w_len, w_keep = record_plain(prog, data, lens)
            out = torch.empty((n, prog.r_out + OUT_META), dtype=torch.uint8, device=dev)
            u_out = torch.empty((n, prog.r_out), dtype=torch.uint8, device=dev)
            u_len = torch.empty(n, dtype=torch.int32, device=dev)
            u_keep = torch.empty(n, dtype=torch.bool, device=dev)
            nbytes = staged.nbytes + out.nbytes
            tag = f"{sname} spec, {msgs} msgs"
            for label, run in (("run_packed call", lambda: run_packed(prog, staged)),
                               ("run_record call", lambda: run_record(prog, data, lens))):
                ms = events_ms(run, False)
                result[f"this/{label}/{sname}/{msgs}"] = {"events_ms": ms}
                print(f"this {label}, {tag}: events {ms:.4f} ms", flush=True)
            for (design, variant), (fn, _) in sorted(fns.items()):
                if variant != "full" and short:
                    continue  # the ablation runs on the bench's messages
                cases = [("packed", staged)]
                if variant == "full":
                    cases += [("aligned_rows", aligned_rows), ("unpacked", data)]
                for layout, src in cases:
                    if layout == "unpacked":
                        run = raw(fn, prog, src, lens, u_out, u_len, u_keep)
                    else:
                        run = raw(fn, prog, src, None, out, None, None)
                    run()
                    torch.cuda.synchronize()
                    if variant.startswith("full"):  # the kernel as built computes the transform
                        if layout == "unpacked":
                            right = (torch.equal(u_keep, w_keep) and torch.equal(u_len, w_len)
                                     and torch.equal(u_out[w_keep], w_out[w_keep]))
                        else:
                            right = (torch.equal(out[:, prog.r_out:], want[:, prog.r_out:])
                                     and torch.equal(out[kept, : prog.r_out],
                                                     want[kept, : prog.r_out]))
                        if not right:
                            raise SystemExit(f"payload_ablation: {design} {layout} != plain "
                                             f"({tag})")
                    name = variant if layout == "packed" else layout
                    result[f"{design}/{name}/{sname}/{msgs}"] = timed(
                        f"{design} {name}, {tag}", run, nbytes)
    print(json.dumps(result))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
