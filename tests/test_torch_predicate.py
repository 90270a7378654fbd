"""The columnar predicate (K1) of the PyTorch port against the JAX package.

Same inputs, made from a seed with numpy, go through the JAX package's
``ColumnarPlan.compile_device`` program and the port's predicate wrapper on
CPU tensors (its plain PyTorch version); the packed keep bits must be
identical. The postfix program the CUDA kernel interprets is checked here
too, through a Python interpreter of its instruction set. The kernel itself
is held to the plain version on the card (tests/test_torch_cuda.py).
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from redpanda_tpu.coproc.column_plan import plan_spec as ref_plan_spec
from redpanda_tpu.ops import exprs as RE
from redpanda_tpu.ops.transforms import where as ref_where
from redpanda_tpu_torch.coproc import column_plan as CP
from redpanda_tpu_torch.ops import exprs as E
from redpanda_tpu_torch.ops.transforms import TransformSpec

DOCS = [
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
    {"level": "error", "code": 2**31},  # int32 overflow -> f32 lattice
    {"level": "error", "code": 499.5},
    {"level": "error", "code": "500"},  # string-typed number
    {"meta": {"retriable": False}},
    {"meta": "flat"},
    {"msg": "needle in a haystack", "code": 1},
    {"msg": "no ndl here", "code": 2},
    {"deep": {"a": {"b": 9}}},
    {},
]


def _exprs(field):
    """The EXPRS table of tests/test_exprs.py, built with ``field`` of
    either package."""
    return [
        field("level") == "error",
        field("level") != "error",
        field("code") == 500,
        field("code") != 500,
        field("code") < 100,
        field("code") <= 42,
        field("code") > 499,
        field("code") >= 500,
        field("code") >= 499.6,
        field("level") == True,  # noqa: E712 -- DSL overload
        field("level") == None,  # noqa: E711
        field("level") != None,  # noqa: E711
        field("level").exists(),
        ~field("level").exists(),
        field("meta.retriable") == True,  # noqa: E712
        field("meta.n") >= 3,
        field("deep.a.b") == 9,
        field("msg").contains(b"needle"),
        field("msg").contains(b"ndl", window=6),
        (field("level") == "error") & (field("code") >= 100),
        (field("level") == "error") | (field("code") < 2),
        ~((field("level") == "error") & (field("code") >= 100)),
        (field("level") == "error") & ((field("code") >= 500) | ~field("msg").exists()),
        # a merged str column wider than this predicate's window
        field("msg").contains(b"hay", window=8) | field("msg").contains(b"x", window=64),
    ]


REF_EXPRS = _exprs(RE.field)


def _records(vals):
    joined = b"".join(vals)
    offsets = np.cumsum([0] + [len(v) for v in vals[:-1]]).astype(np.int64)
    sizes = np.array([len(v) for v in vals], np.int32)
    return joined, offsets, sizes


def _both(ref_expr, vals, n_pad):
    """(JAX bits, port bits, port plan, port columns) for one expression."""
    joined, offsets, sizes = _records(vals)
    ref = ref_plan_spec(ref_where(ref_expr))
    ref_cols = ref.extract_device_inputs(joined, offsets, sizes, n_pad)
    want = np.asarray(ref.compile_device()(*ref_cols))
    plan = CP.plan_spec(TransformSpec.from_json(ref_where(ref_expr).to_json()))
    cols = plan.extract_device_inputs(joined, offsets, sizes, n_pad)
    for a, b in zip(ref_cols, cols):
        np.testing.assert_array_equal(a, b)
    got = plan.predicate([torch.from_numpy(c) for c in cols]).numpy()
    return want, got, plan, cols


def _interpret(plan, cols) -> np.ndarray:
    """Python interpreter of the predicate kernel's instruction set over
    the same columns -> packed bits (the kernel's semantics, op by op)."""
    prog = plan.program
    n_pad = len(cols[0])
    keep = np.zeros(n_pad, bool)
    nd = prog.needles.tobytes()
    for row in range(n_pad):
        st = []
        for ins in prog.code.tolist():
            op = ins[0]
            if op in (CP.OP_AND, CP.OP_OR):
                b, a = st.pop(), st.pop()
                st.append(a and b if op == CP.OP_AND else a or b)
                continue
            if op == CP.OP_NOT:
                st.append(not st.pop())
                continue
            if op == CP.OP_EXISTS:
                st.append(bool(cols[ins[1]][row]))
            elif op in (CP.OP_STR_EQ, CP.OP_CONTAINS):
                v = int(cols[ins[2]][row])
                raw = cols[ins[1]][row].tobytes()
                needle = nd[ins[4] : ins[4] + ins[5]]
                if op == CP.OP_STR_EQ:
                    eq = v >= 0 and v == len(needle) and raw[: len(needle)] == needle
                    st.append((v >= 0 and not eq) if ins[6] else eq)
                else:
                    weff = min(ins[6], ins[3])
                    st.append(v >= 0 and needle in raw[: min(v, weff)])
            elif op == CP.OP_BOOL:
                fl = int(cols[ins[2]][row])
                eq = bool(fl & E.F_BOOL) and int(cols[ins[1]][row]) == ins[3]
                st.append((bool(fl & E.F_BOOL) and not eq) if ins[6] else eq)
            elif op == CP.OP_NULL:
                fl = int(cols[ins[1]][row])
                isnull = bool(fl & E.F_NULL)
                st.append((bool(fl & E.F_PRESENT) and not isnull) if ins[6] else isnull)
            else:
                fl = int(cols[ins[3]][row])
                ops = ["eq", "ne", "lt", "le", "gt", "ge"]
                if not fl & E.F_NUMBER:
                    st.append(False)
                elif ins[6] and fl & E.F_INT_EXACT:
                    st.append(bool(E._cmp_num(ops[ins[4]], int(cols[ins[2]][row]), ins[7])))
                else:
                    c = np.int32(ins[5]).view(np.float32)
                    st.append(bool(E._cmp_num(ops[ins[4]], np.float32(cols[ins[1]][row]), c)))
        assert len(st) == 1
        keep[row] = st[0]
    return np.packbits(keep)


def _docs_vals():
    return [json.dumps(d, separators=(",", ":")).encode() for d in DOCS]


@pytest.mark.parametrize("idx", range(len(REF_EXPRS)))
def test_plain_matches_jax_on_docs(idx):
    vals = _docs_vals()
    n_pad = 24  # a multiple of 8, not of 32
    want, got, plan, cols = _both(REF_EXPRS[idx], vals, n_pad)
    np.testing.assert_array_equal(got, want)
    oracle = [RE.host_eval(REF_EXPRS[idx], v) for v in vals]
    np.testing.assert_array_equal(np.unpackbits(got)[: len(vals)].astype(bool), oracle)
    np.testing.assert_array_equal(_interpret(plan, cols), want)


def _random_docs(rng, n):
    levels = ["error", "info", "warn", "errorx", "", "err"]
    out = []
    for _ in range(n):
        d = {}
        r = rng.random()
        if r < 0.8:
            d["level"] = levels[int(rng.integers(0, len(levels)))]
        elif r < 0.9:
            d["level"] = [None, True, False, 7][int(rng.integers(0, 4))]
        kind = int(rng.integers(0, 8))
        if kind < 4:
            d["code"] = int(rng.integers(-1000, 1000))
        elif kind == 4:
            d["code"] = float(rng.integers(-2000, 2000)) / 4
        elif kind == 5:
            d["code"] = int(rng.integers(2**31 - 3, 2**31 + 3))
        elif kind == 6:
            d["code"] = str(int(rng.integers(0, 600)))
        if rng.random() < 0.85:
            body = "".join(rng.choice(list("abcdefghij n"), size=int(rng.integers(0, 80))))
            if rng.random() < 0.3:
                pos = int(rng.integers(0, len(body) + 1))
                body = body[:pos] + "needle" + body[pos:]
            d["msg"] = body
        if rng.random() < 0.3:
            d["meta"] = {"n": int(rng.integers(0, 6)), "retriable": bool(rng.random() < 0.5)}
        out.append(json.dumps(d, separators=(",", ":")).encode())
    return out


RANDOM_EXPRS = [
    lambda f: (f("level") == "error") & (f("code") >= 100),
    lambda f: (f("level") != "info") | ~f("msg").exists(),
    lambda f: f("msg").contains(b"needle", window=40) & (f("code") < 500.25),
    lambda f: (f("code") == 2**31 - 1) | (f("code") > 2147483648.0) | (f("meta.n") <= 2),
    lambda f: (f("level") == None) | (f("level") == True) | (f("meta.retriable") == False),  # noqa: E711,E712
    lambda f: ~((f("code") != 42) & f("level").exists()) | (f("level") == ""),
]


@pytest.mark.parametrize("idx", range(len(RANDOM_EXPRS)))
def test_plain_matches_jax_on_random_records(idx):
    rng = np.random.default_rng(1000 + idx)
    vals = _random_docs(rng, 2003)
    n_pad = 2008  # a multiple of 8, not of 32
    want, got, _, _ = _both(RANDOM_EXPRS[idx](RE.field), vals, n_pad)
    np.testing.assert_array_equal(got, want)


def test_deep_tree_program():
    """A right-deep tree needs a stack deeper than one 64-bit word: the
    host compiler reports the depth the kernel's spill scratch is sized by,
    and the plain version still matches the JAX program."""
    leaves = [RE.field("code") >= k for k in range(-60, 90)]
    expr = leaves[-1]
    for i, leaf in enumerate(reversed(leaves[:-1])):
        expr = RE.Or(leaf, expr) if i % 2 else RE.And(leaf, expr)
    rng = np.random.default_rng(5)
    vals = _random_docs(rng, 200)
    want, got, plan, cols = _both(expr, vals, 200)
    np.testing.assert_array_equal(got, want)
    assert plan.program.depth == len(leaves) > 64
    np.testing.assert_array_equal(_interpret(plan, cols), want)


def test_wrapper_checks_its_inputs():
    plan = CP.plan_spec(TransformSpec.from_json(ref_where(REF_EXPRS[0]).to_json()))
    good = [torch.zeros((16, 5), dtype=torch.uint8), torch.full((16,), -1, dtype=torch.int32)]
    assert plan.predicate(good).shape == (2,)
    with pytest.raises(ValueError):
        plan.predicate([good[0], good[1].to(torch.int64)])
    with pytest.raises(ValueError):
        plan.predicate([torch.zeros((12, 5), dtype=torch.uint8), torch.zeros(12, dtype=torch.int32)])
    with pytest.raises(ValueError):
        plan.predicate(good[:1])

