"""The payload transform (K3) and its pipelines (K4) of the PyTorch port
against the JAX package.

Same rows, made from a seed with numpy, go through the JAX package's
``compile_transform`` / ``make_packed_pipeline`` / ``make_record_pipeline``
and the port's wrappers on CPU tensors (their plain PyTorch versions).
``keep`` and ``out_len`` must be identical on every row and the output
bytes on every kept row (dropped rows' bytes are undefined on both sides).
The kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from redpanda_tpu.ops import pipeline as RP
from redpanda_tpu.ops import transforms as RT
from redpanda_tpu_torch.ops import pipeline as P
from redpanda_tpu_torch.ops import transforms as T

JSON_RECORDS = [  # tests/test_ops.py
    b'{"level":"error","code":42,"msg":"disk failed"}',
    b'{"level":"info","code":7,"msg":"ok"}',
    b'{"level":"error","code":-13,"msg":"net down"}',
    b'{"code":1}',
    b'{"level":"error","code":9000000,"msg":""}',
]

SPECS = {
    "filter_eq": RT.filter_field_eq("level", "error"),
    "filter_chain": RT.filter_field_eq("level", "error") | RT.filter_contains(b"disk", negate=True),
    "project": RT.filter_field_eq("level", "error") | RT.map_project(RT.Int("code"), RT.Str("msg", 16)),
    "project_only": RT.map_project(RT.Int("code"), RT.Str("msg", 8)),
    "numeric_eq": RT.filter_field_eq("code", 42),
    "int_only": RT.map_project(RT.Int("ts")),
    "uppercase": RT.map_uppercase(),
    "filter_uppercase": RT.filter_contains(b"warn") | RT.map_uppercase(),
    "bool_eq": RT.filter_field_eq("ok", True) | RT.map_project(RT.Str("msg", 4), RT.Int("code")),
}

EXTRA_ROWS = [  # tests/test_ops.py numeric and overflow cases
    b'{"code":42,"x":1}', b'{"code":420}', b'{"code":42}', b'{"code":42.5}', b'{"code":4}',
    b'{"ts":1722268800000000}', b'{"ts":999999999}', b'{"ts":1000000000}',
    b"Hello, World-123!",
]


def _pack(vals, r, rng=None):
    """Rows of width r; with rng the bytes past each row's length are random
    (the transform reads past the length as far as r)."""
    n = len(vals)
    data = np.zeros((n, r), np.uint8)
    if rng is not None:
        data[:] = rng.integers(0, 256, size=(n, r), dtype=np.uint8)
    lens = np.zeros(n, np.int32)
    for i, v in enumerate(vals):
        m = min(len(v), r)
        data[i, :m] = np.frombuffer(v[:m], np.uint8)
        lens[i] = m
    return data, lens


def _random_rows(rng, n):
    keys = ["level", "code", "msg", "ts", "ok"]
    out = []
    for _ in range(n):
        parts = []
        for k in rng.permutation(keys)[: int(rng.integers(0, 5))]:
            kind = int(rng.integers(0, 6))
            if kind == 0:
                v = '"%s"' % ["error", "info", "warn", "errors"][int(rng.integers(0, 4))]
            elif kind == 1:
                v = str(int(rng.integers(-10**11, 10**11)) // 10 ** int(rng.integers(0, 11)))
            elif kind == 2:
                v = '"%s"' % ("m" * int(rng.integers(0, 20)))
            elif kind == 3:
                v = '"unterminated' + "z" * int(rng.integers(0, 12))
            elif kind == 4:
                v = ["true", "false", "42", "42.5", "-0"][int(rng.integers(0, 5))]
            else:
                v = "%d" % int(rng.integers(0, 100)) + ["", "e", ".", "x"][int(rng.integers(0, 4))]
            parts.append('"%s":%s' % (k, v))
        row = "{" + ",".join(parts) + ("}" if rng.random() < 0.9 else "")
        out.append(row.encode())
    return out


def _check(name, vals, r, rng=None):
    spec = SPECS[name]
    data, lens = _pack(vals, r, rng)
    want_out, want_len, want_keep = map(np.asarray, RT.compile_transform(spec, r)(data, lens))
    prog = T.compile_transform(T.TransformSpec.from_json(spec.to_json()), r)
    out, out_len, keep = T.transform(prog, torch.from_numpy(data), torch.from_numpy(lens))
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(out_len.numpy(), want_len)
    np.testing.assert_array_equal(out.numpy()[want_keep], want_out[want_keep])
    return want_keep


@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_matches_jax_on_ops_cases(name):
    _check(name, JSON_RECORDS + EXTRA_ROWS, 128)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_plain_matches_jax_on_random_rows(name):
    rng = np.random.default_rng(100 + sorted(SPECS).index(name))
    vals = _random_rows(rng, 600)
    _check(name, vals, 48, rng)  # narrow rows: windows run past r


@pytest.mark.parametrize("name", ["project", "filter_uppercase", "numeric_eq"])
def test_pipelines_match_jax(name):
    spec = SPECS[name]
    r = 64
    rng = np.random.default_rng(11)
    data, lens = _pack(_random_rows(rng, 300) + JSON_RECORDS, r, rng)
    lens[::7] = 0  # zero-length rows never keep
    staged = np.zeros((len(lens), r + RP.IN_META), np.uint8)
    staged[:, :r] = data
    staged[:, r : r + 4] = lens.astype("<i4").view(np.uint8).reshape(-1, 4)
    pspec = T.TransformSpec.from_json(spec.to_json())

    ref_run, ref_r_out = RP.make_packed_pipeline(spec, r)
    want = np.asarray(ref_run(staged))
    run, r_out = P.make_packed_pipeline(pspec, r)
    got = run(torch.from_numpy(staged)).numpy()
    assert r_out == ref_r_out and got.shape == want.shape
    keep = want[:, r_out + 4].astype(bool)
    np.testing.assert_array_equal(got[:, r_out:], want[:, r_out:])
    np.testing.assert_array_equal(got[keep, :r_out], want[keep, :r_out])
    w_out, w_len, w_keep = P.unpack_result(want, r_out)
    g_out, g_len, g_keep = P.unpack_result(got, r_out)
    np.testing.assert_array_equal(g_len, w_len)
    np.testing.assert_array_equal(g_keep, w_keep)

    ref_rec, _ = RP.make_record_pipeline(spec, r)
    want_out, want_len, want_keep = map(np.asarray, ref_rec(data, lens))
    rec, _ = P.make_record_pipeline(pspec, r)
    out, out_len, keep = rec(torch.from_numpy(data), torch.from_numpy(lens))
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    np.testing.assert_array_equal(out_len.numpy(), want_len)
    np.testing.assert_array_equal(out.numpy()[want_keep], want_out[want_keep])


def test_program_descriptor_and_validation():
    spec = T.filter_field_eq("level", "error") | T.map_project(T.Int("code"), T.Str("msg", 16))
    prog = T.compile_transform(spec, 128)
    assert (prog.n_filters, prog.n_fields, prog.mapper, prog.r_out) == (1, 2, T.MAPPER_PROJECT, 22)
    pats = prog.patterns.tobytes()
    rows = prog.desc.tolist()
    assert pats[rows[0][0] : rows[0][0] + rows[0][1]] == b'"level":"error"'
    assert rows[1][0] == 0 and pats[rows[1][1] : rows[1][1] + rows[1][2]] == b'"code":'
    assert rows[2][0] == 1 and rows[2][3] == 16
    assert T.compile_transform(T.map_uppercase(), 32).mapper == T.MAPPER_UPPERCASE
    with pytest.raises(ValueError):
        T.compile_transform(T.map_project(T.Float("x")), 64)
    with pytest.raises(ValueError):
        T.compile_transform(T.map_project(T.Str("x", 100)), 64)
    with pytest.raises(ValueError):
        T.transform(prog, torch.zeros((4, 64), dtype=torch.uint8), torch.zeros(4, dtype=torch.int32))


def test_spec_json_is_the_same_bytes():
    for spec in SPECS.values():
        assert T.TransformSpec.from_json(spec.to_json()).to_json() == spec.to_json()

