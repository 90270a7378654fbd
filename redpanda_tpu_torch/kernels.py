"""Build and load the port's hand-written CUDA kernels.

Each kernel is one CUDA C++ source under ``csrc/`` with a plain C entry
point. It is compiled with ``nvcc`` for ``sm_90a`` into a shared library in
the port's build directory at first use (or all at once, in parallel, with
``build_all``) and loaded with ctypes: pointers and the stream travel as
``c_void_p``, and the C function returns ``cudaGetLastError()`` so that a
refused launch raises here instead of passing silently.

Every ``Kernel`` keeps a plain integer count of its launches; the wrappers
add one where they launch, and nowhere else.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from redpanda_tpu_torch.build import cached_build

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
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


class Kernel:
    """One CUDA source, its C entry point's signature and its launch count."""

    def __init__(self, name: str, source: str, replaces: str, entry: str, argtypes):
        self.name = name
        self.source = source  # repo-relative path
        self.replaces = replaces  # file:line of the JAX program it replaces
        self.entry = entry
        self.argtypes = argtypes
        self.launches = 0
        self.path: str | None = None
        self._fn = None
        self._lock = threading.Lock()

    def fn(self):
        """The bound C entry point, building the library on first use."""
        with self._lock:
            if self._fn is None:
                src = os.path.join(CSRC, os.path.basename(self.source))
                exe = nvcc()
                self.path = cached_build(
                    self.name, [src], lambda out: [exe, *NVCC_FLAGS, "-o", out, src]
                )
                fn = getattr(ctypes.CDLL(self.path), self.entry)
                fn.restype = ctypes.c_int
                fn.argtypes = self.argtypes
                self._fn = fn
            return self._fn

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
        self.launches += 1


_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

PREDICATE = Kernel(
    "predicate",
    "redpanda_tpu_torch/csrc/predicate.cu",
    "redpanda_tpu/coproc/column_plan.py:213",
    "rp_predicate",
    # cols (host array of device pointers), n_cols, code, n_ops, needles,
    # n_pad, scratch, out, stream
    [_P, _I, _P, _I, _P, _I, _P, _P, _P],
)

PAYLOAD_TRANSFORM = Kernel(
    "payload_transform",
    "redpanda_tpu_torch/csrc/payload_transform.cu",
    "redpanda_tpu/ops/pipeline.py:73",
    "rp_payload_transform",
    # in, in_stride, lens, n, r_in, out, out_stride, out_len, keep, r_out,
    # mask_len, desc, n_filters, mapper, n_fields, patterns, stream
    [_P, _L, _P, _I, _I, _P, _L, _P, _P, _I, _I, _P, _I, _I, _I, _P, _P],
)

KERNELS = (PREDICATE, PAYLOAD_TRANSFORM)


def build_all() -> dict[str, float]:
    """Build every kernel at once (one nvcc per source, all started
    together); returns the wall seconds each build took."""

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
