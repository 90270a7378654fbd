"""The port's zstd codec under concurrent use, against the JAX package's.

A zstandard context may not be used by two threads at once, so the port
keeps one compressor and one decompressor per thread. Eight threads
compress and decompress at once; every output must equal the
single-threaded result and ``redpanda_tpu.compression``'s.
"""

from __future__ import annotations

import sys
import threading

import numpy as np

from redpanda_tpu import compression as ref_compression
from redpanda_tpu.models.record import Compression as RCompression
from redpanda_tpu_torch.compression import codecs

THREADS, ROUNDS = 8, 40


def _payloads():
    rng = np.random.default_rng(3)
    out = []
    for k in range(16):
        text = b"".join(b'{"level":"error","code":%d,"msg":"%s"}' % (int(c), b"m" * int(c % 50))
                        for c in rng.integers(0, 10_000, 40 + 37 * k))
        out.append(text + rng.bytes(int(rng.integers(0, 300))))
    return out


def test_zstd_contexts_are_per_thread_and_match_reference():
    payloads = _payloads()
    single = [codecs.zstd_compress(p) for p in payloads]
    for p, c in zip(payloads, single):
        assert c == ref_compression.compress(p, RCompression.zstd)
        assert codecs.zstd_uncompress(c) == p
        assert ref_compression.uncompress(c, RCompression.zstd) == p
    start = threading.Barrier(THREADS)
    errors, contexts = [], []  # the contexts are held, so no id is reused

    def work(t: int) -> None:
        try:
            start.wait()
            for r in range(ROUNDS):
                k = (t + r) % len(payloads)
                if codecs.zstd_compress(payloads[k]) != single[k]:
                    errors.append(("compress", t, r))
                if codecs.zstd_uncompress(single[k]) != payloads[k]:
                    errors.append(("uncompress", t, r))
            if codecs.zstandard is not None:
                contexts.append(codecs._zstd_ctx()[0])
        except Exception as exc:  # noqa: BLE001 -- reported below with its thread
            errors.append((repr(exc), t))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(THREADS)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # switch threads often: interleave the codec calls
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads)
    assert errors == []
    if codecs.zstandard is not None:
        assert len({id(c) for c in contexts}) == THREADS  # one compressor per thread
