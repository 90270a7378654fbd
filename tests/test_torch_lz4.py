"""LZ4 block decode (K11) of the PyTorch port against the JAX package.

The same streams, made from a seed with numpy, go through the JAX
package's ``make_block_decoder`` and the port's on the CPU (the kernel's
plain PyTorch version). All three outputs (out, out_len, ok) must be
bit-identical on every stream, rejected ones included: valid, overflowing,
truncated, bad-offset, zero-length, over-long and random-garbage streams.
The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch
from lz4_block_encoder import lz4_block_encode

from redpanda_tpu.ops import lz4_device as R
from redpanda_tpu_torch.ops import lz4_device as L

CASES = [  # tests/test_lz4_device.py
    b"hello world hello world hello world",  # overlapping matches
    b"a" * 200,  # RLE: offset 1 match copies
    bytes(range(256)),  # incompressible literals-only
    b"ab" * 100 + b"tail",
    b"x",
    b"the quick brown fox " * 10 + b"jumps",
]


def _rows(streams, max_in=None, lens=None):
    max_in = max_in or max(len(c) for c in streams) + 8
    rows = np.zeros((len(streams), max_in), np.uint8)
    for i, c in enumerate(streams):
        c = c[:max_in]
        rows[i, : len(c)] = np.frombuffer(c, np.uint8)
    if lens is None:
        lens = [len(c) for c in streams]
    return rows, np.array(lens, np.int32)


def _both(rows, lens, max_out):
    want = [np.asarray(x) for x in R.make_block_decoder(rows.shape[1], max_out)(rows, lens)]
    got = L.make_block_decoder(rows.shape[1], max_out, "cpu")(rows, lens)
    for g, w, name in zip(got, want, ("out", "out_len", "ok")):
        assert g.dtype == w.dtype, name
        np.testing.assert_array_equal(g, w, err_msg=name)
    return got


def test_valid_streams_match_jax_and_liblz4():
    comp = [L.lz4_block_compress(p) for p in CASES]
    assert comp == [R.lz4_block_compress(p) for p in CASES]
    out, out_len, ok = _both(*_rows(comp), 512)
    assert ok.all()
    for i, p in enumerate(CASES):
        assert out_len[i] == len(p) and out[i, : len(p)].tobytes() == p
        assert L.lz4_block_decompress(comp[i], 512) == p


def test_random_payloads_match_jax():
    rng = np.random.default_rng(11)  # tests/test_lz4_device.py
    payloads = []
    for _ in range(16):
        n_words = int(rng.integers(4, 60))
        words = [bytes(rng.choice([65, 66, 67, 32], rng.integers(1, 20))) for _ in range(n_words)]
        payloads.append(b"".join(words)[:400])
    out, out_len, ok = _both(*_rows([L.lz4_block_compress(p) for p in payloads]), 512)
    assert ok.all()
    for i, p in enumerate(payloads):
        assert out[i, : out_len[i]].tobytes() == p


def test_overflow_rejected_like_jax():
    comp = [L.lz4_block_compress(b"z" * 300), L.lz4_block_compress(bytes(range(100)))]
    out, out_len, ok = _both(*_rows(comp), 64)
    assert not ok.any()
    assert out_len[1] == 65  # the failing write is counted, at op == max_out


def test_truncated_streams_rejected_like_jax():
    comp = L.lz4_block_compress(b"hello world hello world")
    cuts = [comp[: len(comp) // 2], comp[:1], comp[:-1], comp[:-3]]
    out, out_len, ok = _both(*_rows(cuts, max_in=64), 128)
    assert not ok.any()


def test_bad_offsets_and_match_endings_like_jax():
    streams = [
        bytes([0x14, ord("a"), 0, 0, 0, 0]),  # offset 0
        bytes([0x10, ord("a"), 0x02, 0x00, 0x00]),  # offset 2 > op 1
        bytes([0x10, ord("a"), 0x01, 0x00]),  # ends after a match: no final literals
        bytes([0x1F, ord("a"), 0x01, 0x00, 0x05, 0x10, ord("b")]),  # match-length extension
        bytes([0xF0, 0xFF, 0xFF, 0x03]) + b"q" * 20,  # literal run longer than its input
    ]
    out, out_len, ok = _both(*_rows(streams), 96)
    assert not ok[:3].any() and ok[3] and not ok[4]
    assert out_len[3] == 26 and out[3, :26].tobytes() == b"a" * 25 + b"b"


def test_zero_negative_and_overlong_lengths_like_jax():
    comp = L.lz4_block_compress(b"hello world hello world")
    streams = [comp, comp, comp, comp, b""]
    rows, lens = _rows(streams, max_in=len(comp) + 4, lens=[0, -5, len(comp) + 40, len(comp), 0])
    out, out_len, ok = _both(rows, lens, 64)
    assert ok[0] and out_len[0] == 0 and ok[1] and out_len[1] == 0
    assert ok[3] and ok[4] and out_len[4] == 0
    assert not out[0].any()


def test_random_garbage_streams_like_jax():
    rng = np.random.default_rng(21)
    n, max_in = 96, 48
    rows = rng.integers(0, 256, size=(n, max_in), dtype=np.uint8)
    lens = rng.integers(-2, max_in + 6, n).astype(np.int32)
    for max_out in (64, 17):
        _both(rows, lens, max_out)


def test_block_encoder_helper_streams_decode():
    """The tests' small block encoder writes streams liblz4 and the decoder
    both read (chip_smoke.py uses it where liblz4 cannot be loaded)."""
    recs = L.text_records(12, 300) + [b"", b"k", b"abcabcabcabcabcabcabcabcabcabc" * 3]
    comp = [lz4_block_encode(p) for p in recs]
    out, out_len, ok = _both(*_rows(comp), 512)
    assert ok.all()
    for i, p in enumerate(recs):
        assert out[i, : out_len[i]].tobytes() == p
        assert L.lz4_block_decompress(comp[i], max(len(p), 1)) == p


def test_decode_rows_checks_and_cpu_wrapper():
    rows, lens = _rows([L.lz4_block_compress(p) for p in CASES])
    c, cl = torch.from_numpy(rows), torch.from_numpy(lens)
    for a, b in zip(L.decode_rows(c, cl, 512), L.decode_plain(c, cl, 512)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        L.decode_rows(c[:, ::2], cl, 512)
    with pytest.raises(ValueError):
        L.decode_rows(c, cl.long(), 512)
    with pytest.raises(ValueError):
        L.decode_rows(c, cl, 0)


def test_measure_probe_on_cpu():
    res = L.measure_probe(n_records=8, record_size=128, reps=1, device="cpu")
    assert res["device"] == "cpu" and res["device_mb_s"] > 0 and res["kernel_mb_s"] > 0
    assert res["host_mb_s"] > 0 and res["decision"] in ("host", "device")
    enc = L.measure_probe(n_records=4, record_size=64, reps=1, device="cpu", compress=lz4_block_encode)
    assert enc["records"] == 4


@pytest.mark.parametrize("record_size", [512, 1024])
def test_probe_records_are_the_reference_probes(monkeypatch, record_size):
    """measure_probe's records, caught where the reference hands them to
    liblz4, equal the port's at the default seed."""
    seen = []

    class Caught(Exception):
        pass

    def catch(o):
        seen.append(o)
        if len(seen) == 6:
            raise Caught
        return b""

    monkeypatch.setattr(R, "lz4_block_compress", catch)
    with pytest.raises(Caught):
        R.measure_probe(n_records=6, record_size=record_size)
    assert seen == L.text_records(6, record_size)


@pytest.mark.parametrize("max_out", [128, 77])
def test_edge_streams_match_jax(max_out):
    """The decoder's edges (ops/lz4_device.py edge_streams, the card tests'
    data too): every match offset 1..40 at lengths 4..80, runs ending at
    max_out and one past it, op == offset, extensions, comp_len past
    max_in and garbage."""
    rows, lens = L.edge_streams(max_out, seed=max_out)
    out, out_len, ok = _both(rows, lens, max_out)
    off, mlen = np.meshgrid(np.arange(1, 41), np.arange(4, 81), indexing="ij")
    want_len = (off + mlen + 1 + (off + mlen) % 3).ravel()  # prefix, match, 1-3 final literals
    pairs = want_len.size
    np.testing.assert_array_equal(ok[:pairs], want_len <= max_out)
    np.testing.assert_array_equal(out_len[:pairs][ok[:pairs]], want_len[want_len <= max_out])
    assert ok[pairs] and out_len[pairs] == max_out  # literals ending at max_out
    assert not ok[pairs + 1] and out_len[pairs + 1] == max_out + 1  # one byte past
    assert not ok[-64:].all()  # garbage rows


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.make_block_decoder(64, 64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        L.measure_probe(n_records=2, record_size=32, reps=1)
