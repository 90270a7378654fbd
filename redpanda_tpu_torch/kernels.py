"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C entry
point; device code that two kernels share lives in headers there
(``*.cuh``). A source is compiled with ``nvcc`` for ``sm_90a`` (``-I csrc``)
into a shared library in the port's build directory at first use (or all at
once, in parallel, with ``build_all``), named by a hash of the source, every
header it includes and the command line, and loaded with ctypes: pointers
and the stream travel as ``c_void_p``, and the C function returns
``cudaGetLastError()`` so that a refused launch raises here instead of
passing silently.

Every ``Kernel`` keeps a plain integer count of its launches; the wrappers
add one where they launch, and nowhere else. Two ``Kernel`` rows may share
one source and library (``lib``) when one kernel serves two JAX programs
that are counted apart; a library's helpers that launch nothing (``symbol``)
are bound beside its entry point and counted nowhere.
"""

from __future__ import annotations

import ctypes
import os
import re
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from redpanda_tpu_torch.build import BuildError, cached_build

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin``, ``/usr/local/cuda/bin`` or PATH."""
    cands = ["/usr/local/cuda/bin/nvcc"]
    if os.environ.get("CUDA_HOME"):
        cands.insert(0, os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    for cand in cands:
        if os.path.isfile(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise BuildError("nvcc not found: the CUDA kernels cannot be built")
    return found


def source_files(src: str) -> list[str]:
    """``src`` and every header it includes with ``#include "..."`` from
    ``csrc/``, transitively: the files whose bytes name its build."""
    out, todo = [], [src]
    while todo:
        path = todo.pop()
        if path in out:
            continue
        out.append(path)
        with open(path) as f:
            found = re.findall(r'^#include "([^"]+)"', f.read(), re.M)
        todo += [os.path.join(CSRC, h) for h in found]
    return out


class Kernel:
    """One CUDA source, its C entry point's signature and its launch count."""

    def __init__(self, name: str, source: str, replaces: str, entry: str, argtypes,
                 lib: str | None = None):
        self.name = name
        self.lib = lib or name  # the build's name; rows sharing it build once
        self.source = source  # repo-relative path
        self.replaces = replaces  # file:line of the JAX program it replaces
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self.path: str | None = None
        self._fn = None
        self._dll = None
        self._helpers: dict = {}
        self._lock = threading.Lock()

    def fn(self):
        """The bound C entry point, building the library on first use."""
        if self._fn is not None:
            return self._fn
        with self._lock:
            if self._fn is None:
                src = os.path.join(CSRC, os.path.basename(self.source))
                exe = nvcc()
                self.path = cached_build(
                    self.lib, source_files(src),
                    lambda out: [exe, *NVCC_FLAGS, "-I", CSRC, "-o", out, src],
                )
                self._dll = ctypes.CDLL(self.path)
                fn = getattr(self._dll, self.entry)
                fn.restype = ctypes.c_int
                fn.argtypes = self.argtypes
                self._fn = fn
            return self._fn

    def symbol(self, name: str, argtypes):
        """Another C function of this kernel's library, returning a CUDA
        error code: a helper that launches nothing, so no count."""
        got = self._helpers.get(name)
        if got is None:
            self.fn()
            got = getattr(self._dll, name)
            got.restype = ctypes.c_int
            got.argtypes = argtypes
            self._helpers[name] = got
        return got

    def build_log(self) -> str:
        if self.path is None or not os.path.exists(self.path + ".log"):
            return ""
        with open(self.path + ".log") as f:
            return f.read()

    def launch(self, *args) -> None:
        """Call the entry point, count the launch and raise on a CUDA error."""
        rc = self.fn()(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: kernel launch failed, CUDA error {rc}")
        with self._lock:  # pool workers launch one kernel from several threads
            self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# table (host array of n_blocks * n_cols device pointers), n_blocks, n_cols,
# code, n_ops, needles, n_pad, scratch, out, stream
_PREDICATE_ARGS = [_P, _I, _I, _P, _I, _P, _I, _P, _P, _P]

# K1: one launch's device leg in one crossing (copy up, kernel, copy down,
# events): host_block, dev_block, block_bytes, col_off (host int64 array),
# n_cols, code, n_ops, needles, n_pad, scratch, bits, bits_host, events
# (host array of four events), stream
PREDICATE = Kernel(
    "predicate",
    "redpanda_tpu_torch/csrc/predicate.cu",
    "redpanda_tpu/coproc/column_plan.py:213",
    "rp_predicate_leg",
    [_P, _P, _L, _P, _I, _P, _I, _P, _I, _P, _P, _P, _P, _P],
)

# in, in_stride, lens, n, r_in, out, out_stride, out_len, keep, r_out,
# mask_len, desc, n_filters, mapper, n_fields, patterns, stream
_PAYLOAD_ARGS = [_P, _L, _P, _I, _I, _P, _L, _P, _P, _I, _I, _P, _I, _I, _I, _P, _P]

# the payload transform in the packed layout (the engine's pipeline) ...
PAYLOAD_TRANSFORM = Kernel(
    "payload_transform",
    "redpanda_tpu_torch/csrc/payload_transform.cu",
    "redpanda_tpu/ops/pipeline.py:73",
    "rp_payload_transform",
    _PAYLOAD_ARGS,
)

# ... and in the unpacked one (lengths, out, out_len and keep as arrays),
# counted apart
PAYLOAD_RECORD = Kernel(
    "payload_record",
    "redpanda_tpu_torch/csrc/payload_transform.cu",
    "redpanda_tpu/ops/transforms.py:378",
    "rp_payload_transform",
    _PAYLOAD_ARGS,
    lib="payload_transform",
)

# table (host array of 4 * n_blocks device pointers), n_blocks, rows, r,
# seg, wpr, span, crc tables, round powers, n_rounds, span table, crc_out,
# ok, bad, n_bad, vote_rows, g, tally, stream
_CRC_BLOCKS_ARGS = [_P, _I, _I, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _P, _P]

# rows, lengths, claimed, rows, r, wpr, span, crc tables, round powers,
# n_rounds, span table, crc_out, ok, stream: rp_crc_blocks over one block
_CRC_ROWS_ARGS = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P, _P, _P, _P]

# The split CRC kernel (csrc/crc_blocks.cu) serves four JAX programs,
# counted apart: the batch CRC over one block of rows (crc_out) ...
CRC32C = Kernel(
    "crc32c",
    "redpanda_tpu_torch/csrc/crc_blocks.cu",
    "redpanda_tpu/ops/crc32c_device.py:84",
    "rp_crc_rows",
    _CRC_ROWS_ARGS,
    lib="crc_blocks",
)

# ... the batch validator over one block (claimed -> ok) ...
CRC32C_VALIDATE = Kernel(
    "crc32c_validate",
    "redpanda_tpu_torch/csrc/crc_blocks.cu",
    "redpanda_tpu/ops/pipeline.py:53",
    "rp_crc_rows",
    _CRC_ROWS_ARGS,
    lib="crc_blocks",
)

# ... over a table of a card's shard blocks, with a bad-row count per
# segment: the raft mesh step, with the vote tally in the same launch ...
CRC32C_VOTE = Kernel(
    "crc32c_vote",
    "redpanda_tpu_torch/csrc/crc_blocks.cu",
    "redpanda_tpu/parallel/collectives.py:124",
    "rp_crc_blocks",
    _CRC_BLOCKS_ARGS,
    lib="crc_blocks",
)

# ... and the sharded CRC check, a bad count per partition, counted apart
CRC32C_SHARDED = Kernel(
    "crc32c_sharded",
    "redpanda_tpu_torch/csrc/crc_blocks.cu",
    "redpanda_tpu/parallel/collectives.py:155",
    "rp_crc_blocks",
    _CRC_BLOCKS_ARGS,
    lib="crc_blocks",
)

# the same entry point launched once per card over the blocks of the card's
# mesh shards (the stacked predicate), counted apart
PREDICATE_STACKED = Kernel(
    "predicate_stacked",
    "redpanda_tpu_torch/csrc/predicate.cu",
    "redpanda_tpu/coproc/column_plan.py:268",
    "rp_predicate_blocks",
    _PREDICATE_ARGS,
    lib="predicate",
)

VOTE_TALLY = Kernel(
    "vote_tally",
    "redpanda_tpu_torch/csrc/vote_tally.cu",
    "redpanda_tpu/parallel/collectives.py:39",
    "rp_vote_tally_blocks",
    # blocks (host array of device pointers), nblocks, rows, g, dtype (0 u8,
    # 1 i32), out, stream
    [_P, _I, _I, _I, _I, _P, _P],
)

LZ4_BLOCK = Kernel(
    "lz4_block",
    "redpanda_tpu_torch/csrc/lz4_block.cu",
    "redpanda_tpu/ops/lz4_device.py:52",
    "rp_lz4_block_decode",
    # comp, comp_len, n, max_in, out, out_len, ok, max_out, stream
    [_P, _P, _I, _I, _P, _P, _P, _I, _P],
)

# K10: the batch validator, the payload transform and the vote tally of a
# card's mesh shards in one launch
COPROC_STEP = Kernel(
    "coproc_step",
    "redpanda_tpu_torch/csrc/coproc_step.cu",
    "redpanda_tpu/parallel/collectives.py:71",
    "rp_coproc_step",
    # table (host array of 6 * n_blocks device pointers), n_blocks, rows_b,
    # r_batch, crc tables, ok, rows_r, r_rec, out, out_len, keep, r_out,
    # desc, n_filters, mapper, n_fields, patterns, vote_rows, g, tally, stream
    [_P, _I, _I, _I, _P, _P, _I, _I, _P, _P, _P, _I, _P, _I, _I, _I, _P, _I, _I, _P, _P],
)

KERNELS = (
    PREDICATE, PAYLOAD_TRANSFORM, PAYLOAD_RECORD, CRC32C, CRC32C_VALIDATE, LZ4_BLOCK,
    PREDICATE_STACKED, VOTE_TALLY, CRC32C_VOTE, CRC32C_SHARDED, COPROC_STEP,
)


def build_all() -> dict[str, float]:
    """Build every kernel at once (one nvcc per source, all started
    together; rows that share a library wait for its one build); returns
    the wall seconds each build took."""

    def one(k: Kernel) -> float:
        t0 = time.perf_counter()
        k.fn()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(len(KERNELS)) as pool:
        secs = list(pool.map(one, KERNELS))
    return {k.name: s for k, s in zip(KERNELS, secs)}


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


def stream_handle(device) -> int:
    """The current CUDA stream of ``device`` as an integer handle."""
    import torch

    return torch.cuda.current_stream(device).cuda_stream
