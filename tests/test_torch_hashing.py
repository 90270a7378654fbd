"""xxHash in the PyTorch port against the ``xxhash`` package and the JAX package.

The port's ``hashing/xx.py`` is plain Python (the machine with the card has
no ``xxhash`` package), with XXH64 over longer inputs in a small C helper
(native/xxhash64.cc); both must give the package's 64- and 32-bit digests
for every length class of the algorithm (empty, under one stripe, whole
stripes and tails, a long input) and for seeds at both ends of the range.
The engine's script checksum is that xxHash64 of the spec JSON, as the
reference engine stores it.
"""

from __future__ import annotations

import numpy as np
import pytest
import xxhash

from redpanda_tpu.coproc.engine import TpuEngine
from redpanda_tpu.ops.exprs import field
from redpanda_tpu.ops.transforms import Int, Str, filter_field_eq, map_project, where
from redpanda_tpu_torch.coproc.engine import TorchEngine
from redpanda_tpu_torch.hashing import xx

LENGTHS = [*range(65), 100, 1 << 20]


@pytest.mark.parametrize("seed", [0, 1, 2**64 - 1])
@pytest.mark.parametrize("bits", [64, 32])
def test_xxhash_matches_the_xxhash_package(bits, seed):
    ours = xx.xxhash64 if bits == 64 else xx.xxhash32
    theirs = xxhash.xxh64_intdigest if bits == 64 else xxhash.xxh32_intdigest
    rng = np.random.default_rng(bits + seed % 1000)
    for n in LENGTHS:
        data = rng.bytes(n)
        assert ours(data, seed) == theirs(data, seed), (bits, seed, n)
        assert ours(bytearray(data), seed) == theirs(data, seed)
    assert ours("héllo, spec", seed) == theirs("héllo, spec".encode(), seed)
    assert ours(b"abc") == theirs(b"abc")  # the default seed is 0


@pytest.mark.parametrize("path", ["native", "plain"])
def test_xxhash64_native_helper_and_plain_python_agree(path):
    fn = xx._native_xxh64()
    assert fn, "the C helper did not build"
    ours = (lambda b, s: fn(b, len(b), s)) if path == "native" else (
        lambda b, s: xx._xxhash64_py(b, len(b), s))
    rng = np.random.default_rng(64)
    for n in [0, 1, 7, 31, 32, 33, 255, 256, 257, 4099, 65537, 1 << 18]:
        data = rng.bytes(n)
        for seed in (0, 1, 2**64 - 1, 0x0123456789ABCDEF):
            assert ours(data, seed) == xxhash.xxh64_intdigest(data, seed), (path, n, seed)


SPECS = {
    "columnar": where(field("level") == "error") | map_project(Int("code"), Str("msg", 32)),
    "payload": filter_field_eq("level", "error") | map_project(Int("code"), Str("msg", 32)),
}


def test_script_checksums_match_reference():
    ref = TpuEngine(row_stride=256, host_workers=0, host_pool_probe=False)
    eng = TorchEngine(device="cpu", row_stride=256)
    try:
        scripts = [(sid, spec.to_json(), ("t",)) for sid, spec in enumerate(SPECS.values(), 1)]
        scripts.append((3, SPECS["payload"].to_json().encode(), ("t",)))  # spec JSON as bytes
        assert ref.enable_coprocessors(scripts) == [0, 0, 0]
        assert eng.enable_coprocessors(scripts) == [0, 0, 0]
        want, got = ref.scripts, eng.scripts
        assert sorted(got) == sorted(want) == [1, 2, 3]
        for sid, spec_json, _ in scripts:
            assert got[sid].checksum == want[sid].checksum == xxhash.xxh64_intdigest(
                spec_json.encode() if isinstance(spec_json, str) else spec_json)
            assert got[sid].input_topics == want[sid].input_topics
        got.clear()  # a copy: the engine's table is untouched
        assert sorted(eng.scripts) == [1, 2, 3]
        eng.disable_coprocessors([2])
        assert sorted(eng.scripts) == [1, 3]
    finally:
        ref.shutdown()


@pytest.mark.parametrize("buckets", [1, 2, 3, 7, 16, 64, 1000, 2**31 - 1])
def test_jump_consistent_hash_matches_reference(buckets):
    from redpanda_tpu.hashing.jump import jump_consistent_hash as ref_jump
    from redpanda_tpu_torch.hashing import jump_consistent_hash

    rng = np.random.default_rng(buckets)
    keys = [0, 1, 2**63, 2**64 - 1, -1, -(2**63)] + [int(k) for k in rng.integers(0, 2**63, 200)]
    for key in keys:
        got = jump_consistent_hash(key, buckets)
        assert got == ref_jump(key, buckets), (key, buckets)
        assert 0 <= got < buckets
    for bad in (0, -3):
        with pytest.raises(ValueError):
            jump_consistent_hash(1, bad)
