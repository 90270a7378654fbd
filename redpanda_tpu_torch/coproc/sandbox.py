"""Wire-deployable sandboxed Python transforms (the JAX package's
coproc/sandbox.py, unchanged in behaviour).

The declarative DSL (ops/exprs.py) covers predicates and projections; this
is the escape hatch for arbitrary per-record logic. ``compile_transform``
turns a source string into a per-record callable that
``TorchEngine.enable_py_sandboxed`` registers as a host plan. It runs on
the host on every device: a python plan has no device stage.

Containment (validated when the script is enabled, before it is
registered):

- the source must define exactly ``def transform(value): ...``
  (bytes in -> bytes | str | None out; None drops the record);
- AST whitelist: literals, arithmetic/bool/compare, locals, if/for/while,
  comprehensions, subscripts, calls to whitelisted builtins only;
- NO import, NO attribute access except a whitelisted set of safe
  str/bytes/dict/list methods (never underscore names: the
  ``().__class__.__mro__`` escape runs through dunder attributes);
- NO global/nonlocal, no lambda/def nesting, no decorators, no yield;
- executed with empty ``__builtins__`` and a curated safe-globals table.

What bounds a record's run time, and what does not. This is a bound made
of Python tracing, so it is NOT preemptive: CPython cannot interrupt a
thread inside one opcode or one C call (``10**10**8`` holds the GIL for
minutes, and no trace event, signal or async exception lands until it
returns). Three layers kill what they can:

  1. the line tracer checks a wall-clock deadline (EXEC_WALL_DEADLINE_S)
     on every traced line, so any LOOP dies at the deadline; a line-event
     budget (EXEC_LINE_BUDGET) also caps the tracer's own work;
  2. operand guards, injected at compile time around ``**``, ``<<``,
     ``*`` and ``range(...)``, refuse BEFORE the opcode starts an
     operation whose operands guarantee an overrun (result size bounds
     under which every permitted op ends far inside the deadline);
  3. an elapsed check after the call fails the record when a residual
     single call (a large allocation, a big join) slipped past both.

A single C call that the guards do not refuse therefore runs to its end:
layer 3 fails the record only after it has returned, and the host thread
(with the launch it serves) is held until then. Neither the deadline nor
the line budget is a hard preemptive bound.

Runtime failures surface through the engine's error policy like any
script failure: skip_on_failure drops the record, deregister unloads the
script. A watchdog kill also journals one entry into the governor TREND
domain, once per compiled transform.
"""

from __future__ import annotations

import ast
import json
import sys
import time

EXEC_LINE_BUDGET = 100_000  # traced line events per record (tracer-work cap)
EXEC_WALL_DEADLINE_S = 1.0  # per-record wall-clock deadline (not preemptive: module docstring)
MAX_SOURCE_BYTES = 64 * 1024
# operand-guard bounds: sized so any permitted single op completes orders
# of magnitude inside EXEC_WALL_DEADLINE_S on commodity hardware — a 2M-bit
# int multiply is ~ms; 10**10**8 (a 332M-bit result) is refused outright
MAX_INT_BITS = 1 << 21  # ~2M bits (~256 KiB integer)
MAX_SEQ_ELEMS = 1 << 24  # 16M elements for seq*int / range(...)


class SandboxViolation(Exception):
    """Source failed deploy-time validation."""


class SandboxBudgetExceeded(BaseException):
    """A record's execution exceeded the line budget.

    BaseException on purpose: user code may catch Exception (json error
    handling is legitimate), and the budget kill must NOT be swallowable —
    CPython also unsets the trace function when the tracer raises, so a
    caught budget exception would leave the rest of the transform running
    untraced and unbounded. Validation separately forbids bare except /
    except BaseException and `finally` (which would run untraced too).
    The run() wrapper converts it to SandboxRuntimeError (a plain
    Exception) once it has escaped every user frame, so the engine's
    ErrorPolicy machinery handles it like any script failure."""


class SandboxDeadlineExceeded(BaseException):
    """The wall-clock watchdog killed a record (deadline passed, or an
    operand guard refused an op that guarantees an uninterruptible
    overrun). BaseException for the same reason as SandboxBudgetExceeded:
    user code must not be able to catch the kill."""

    layer = "guard"  # overridden to "deadline" by the tracer's raise


class SandboxRuntimeError(Exception):
    """A record's execution was killed (line-budget overrun or watchdog
    deadline), reported at the sandbox boundary for the engine's
    ErrorPolicy to handle."""


_ALLOWED_NODES = (
    ast.Module, ast.FunctionDef, ast.arguments, ast.arg, ast.Return,
    ast.Expr, ast.Assign, ast.AugAssign, ast.AnnAssign,
    ast.Name, ast.Load, ast.Store, ast.Del, ast.Delete, ast.Constant,
    ast.Tuple, ast.List, ast.Dict, ast.Set,
    ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare, ast.IfExp,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.FloorDiv, ast.Mod, ast.Pow,
    ast.LShift, ast.RShift, ast.BitOr, ast.BitXor, ast.BitAnd,
    ast.UAdd, ast.USub, ast.Not, ast.Invert,
    ast.And, ast.Or,
    ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
    ast.Is, ast.IsNot, ast.In, ast.NotIn,
    ast.If, ast.For, ast.While, ast.Break, ast.Continue, ast.Pass,
    ast.Call, ast.keyword, ast.Starred,
    ast.Subscript, ast.Slice,
    ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp,
    ast.comprehension,
    ast.Attribute,  # gated further by _SAFE_METHODS below
    ast.JoinedStr, ast.FormattedValue,  # f-strings (no .format with its
    # attribute-walking format-spec machinery — only plain interpolation)
    ast.Try, ast.ExceptHandler, ast.Raise,
)

# methods callable on values the sandbox can construct; NEVER underscore
# names, NEVER `format` (its format-spec minilanguage walks attributes)
_SAFE_METHODS = frozenset({
    # str/bytes
    "upper", "lower", "strip", "lstrip", "rstrip", "split", "rsplit",
    "splitlines", "join", "replace", "startswith", "endswith", "find",
    "rfind", "index", "count", "encode", "decode", "title", "capitalize",
    "casefold", "zfill", "ljust", "rjust", "isdigit", "isalpha",
    "isalnum", "isspace", "islower", "isupper", "hex", "removeprefix",
    "removesuffix", "partition", "rpartition",
    # dict
    "get", "keys", "values", "items", "setdefault", "pop", "update",
    # list/set
    "append", "extend", "insert", "remove", "clear", "sort", "reverse",
    "copy", "add", "discard", "union", "intersection", "difference",
})

# ---- watchdog operand guards -------------------------------------------
# CPython cannot preempt mid-opcode: once `10**10**8` starts, the GIL is
# held and NO trace event, async exception, or signal lands until the
# (minutes-long) opcode completes. The only sound kill for these burns is
# refusing the operation before it starts. compile_transform rewrites the
# (already validated) AST so `**`, `<<`, `*` route through these guards,
# and the `range` builtin is bounded at creation (a >16M-element range is
# only dangerous when materialized — sorted/list/sum of it is another
# uninterruptible C loop; a for-loop that large dies at the line budget
# long before, so legitimate transforms lose nothing).


def _guard_pow(a, b):
    if isinstance(a, int) and isinstance(b, int) and b > 0:
        if b * max(a.bit_length(), 1) > MAX_INT_BITS:
            raise SandboxDeadlineExceeded(
                f"watchdog: ** operands guarantee a deadline overrun "
                f"(result would exceed {MAX_INT_BITS} bits)"
            )
    return a ** b


def _guard_lshift(a, b):
    if isinstance(a, int) and isinstance(b, int) and b > 0:
        if b + a.bit_length() > MAX_INT_BITS:
            raise SandboxDeadlineExceeded(
                f"watchdog: << operands guarantee a deadline overrun "
                f"(result would exceed {MAX_INT_BITS} bits)"
            )
    return a << b


def _guard_mult(a, b):
    if isinstance(a, int) and isinstance(b, int):
        if a.bit_length() + b.bit_length() > MAX_INT_BITS:
            raise SandboxDeadlineExceeded(
                f"watchdog: * operands guarantee a deadline overrun "
                f"(result would exceed {MAX_INT_BITS} bits)"
            )
    else:
        seq, n = (a, b) if isinstance(b, int) else (b, a)
        if (
            isinstance(n, int)
            and isinstance(seq, (str, bytes, bytearray, list, tuple))
            and n > 0
            and len(seq) * n > MAX_SEQ_ELEMS
        ):
            raise SandboxDeadlineExceeded(
                f"watchdog: sequence * {n} would exceed "
                f"{MAX_SEQ_ELEMS} elements"
            )
    return a * b


def _guard_range(*args):
    r = range(*args)
    if len(r) > MAX_SEQ_ELEMS:
        raise SandboxDeadlineExceeded(
            f"watchdog: range of {len(r)} elements exceeds "
            f"{MAX_SEQ_ELEMS} (materializing it is an uninterruptible burn)"
        )
    return r


# injected under dunder-reserved names: validation rejects any dunder Name
# in USER source, so a transform can neither call nor rebind the guards —
# only compile_transform's post-validation rewrite references them
_GUARD_GLOBALS = {
    "__sbx_pow__": _guard_pow,
    "__sbx_lshift__": _guard_lshift,
    "__sbx_mult__": _guard_mult,
}


class _GuardInjector(ast.NodeTransformer):
    """Post-validation rewrite: `a ** b` -> `__sbx_pow__(a, b)` (likewise
    `<<`, `*`, and the augmented forms). Runs on the validated tree only —
    user source never names the guards (dunder names are rejected)."""

    _OPS = {
        ast.Pow: "__sbx_pow__",
        ast.LShift: "__sbx_lshift__",
        ast.Mult: "__sbx_mult__",
    }

    def _call(self, name: str, left, right, at):
        return ast.copy_location(
            ast.Call(
                func=ast.Name(id=name, ctx=ast.Load()),
                args=[left, right], keywords=[],
            ),
            at,
        )

    def visit_BinOp(self, node):
        self.generic_visit(node)
        name = self._OPS.get(type(node.op))
        if name is None:
            return node
        return self._call(name, node.left, node.right, node)

    def visit_AugAssign(self, node):
        self.generic_visit(node)
        name = self._OPS.get(type(node.op))
        if name is None:
            return node
        # `x **= y` -> `x = __sbx_pow__(x, y)`; a Subscript target's key
        # evaluates twice, acceptable in a side-effect-light sandbox
        import copy as _copy

        load_target = _copy.deepcopy(node.target)
        load_target.ctx = ast.Load()
        return ast.copy_location(
            ast.Assign(
                targets=[node.target],
                value=self._call(name, load_target, node.value, node),
            ),
            node,
        )


_SAFE_BUILTINS = {
    "len": len, "int": int, "float": float, "str": str, "bytes": bytes,
    "bool": bool, "dict": dict, "list": list, "tuple": tuple, "set": set,
    "min": min, "max": max, "sum": sum, "abs": abs, "round": round,
    "sorted": sorted, "reversed": reversed, "range": _guard_range,
    "enumerate": enumerate, "zip": zip, "map": map, "filter": filter,
    "any": any, "all": all, "ord": ord, "chr": chr, "repr": repr,
    "isinstance": isinstance, "divmod": divmod, "hash": hash,
    "ValueError": ValueError, "TypeError": TypeError, "KeyError": KeyError,
    "Exception": Exception, "StopIteration": StopIteration,
    # json travels as plain names (no attribute access on modules)
    "json_loads": json.loads,
    "json_dumps": lambda obj: json.dumps(obj, separators=(",", ":")),
}


# names refused at validation even though empty __builtins__ would already
# NameError them at runtime — deploy-time rejection with a clear reason is
# the contract (and defense in depth if the globals table ever grows)
_DENIED_NAMES = frozenset({
    "getattr", "setattr", "delattr", "hasattr", "eval", "exec", "compile",
    "open", "input", "breakpoint", "globals", "locals", "vars", "dir",
    "type", "object", "super", "memoryview", "classmethod", "staticmethod",
    "property", "callable", "id", "help", "exit", "quit", "license",
    "copyright", "credits", "import",
})


def validate_source(source: str) -> ast.Module:
    """Parse + whitelist-check; raises SandboxViolation with a reason."""
    if len(source.encode()) > MAX_SOURCE_BYTES:
        raise SandboxViolation(f"source exceeds {MAX_SOURCE_BYTES} bytes")
    try:
        tree = ast.parse(source)
    except (SyntaxError, ValueError, MemoryError, RecursionError) as e:
        # pathological sources under the byte cap can blow the parser
        # itself (MemoryError on long operator chains) — every parse
        # failure is a validation failure, never an engine fault
        raise SandboxViolation(f"unparseable source: {type(e).__name__}: {e}") from e
    if (
        len(tree.body) != 1
        or not isinstance(tree.body[0], ast.FunctionDef)
        or tree.body[0].name != "transform"
    ):
        raise SandboxViolation("source must define exactly one function: def transform(value)")
    fn = tree.body[0]
    if fn.decorator_list:
        raise SandboxViolation("decorators are not allowed")
    a = fn.args
    if (
        len(a.args) != 1 or a.vararg or a.kwarg or a.kwonlyargs
        or a.posonlyargs or a.defaults
    ):
        raise SandboxViolation("transform must take exactly one positional argument")
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise SandboxViolation(f"disallowed syntax: {type(node).__name__}")
        if isinstance(node, ast.FunctionDef) and node is not fn:
            raise SandboxViolation("nested function definitions are not allowed")
        if isinstance(node, ast.Attribute):
            if node.attr.startswith("_"):
                raise SandboxViolation(f"underscore attribute access: {node.attr}")
            if node.attr not in _SAFE_METHODS:
                raise SandboxViolation(f"attribute not in safe set: {node.attr}")
            if not isinstance(node.ctx, ast.Load):
                raise SandboxViolation("attribute assignment is not allowed")
        if isinstance(node, ast.Name):
            if node.id.startswith("__"):
                raise SandboxViolation(f"dunder name: {node.id}")
            if node.id in _DENIED_NAMES:
                raise SandboxViolation(f"denied name: {node.id}")
        if isinstance(node, ast.Try):
            if node.finalbody:
                # a finally block runs AFTER a budget kill with tracing
                # already unset — an unbounded escape hatch
                raise SandboxViolation("finally blocks are not allowed")
        if isinstance(node, ast.ExceptHandler):
            # the budget kill is a BaseException; handlers must not be able
            # to catch it
            names = []
            if node.type is None:
                raise SandboxViolation("bare except is not allowed")
            for t in ast.walk(node.type):
                if isinstance(t, ast.Name):
                    names.append(t.id)
            if "BaseException" in names:
                raise SandboxViolation("except BaseException is not allowed")
        if isinstance(node, ast.FormattedValue) and node.format_spec is not None:
            # format specs run the attribute-walking format machinery
            for sub in ast.walk(node.format_spec):
                if isinstance(sub, ast.FormattedValue):
                    raise SandboxViolation("nested format specs are not allowed")
    return tree


def _journal_watchdog_kill(script_id, layer: str, elapsed_s: float, reason: str):
    """One governor TREND entry per incident (the caller dedupes): a
    deployed transform hitting its wall-clock deadline is an operational
    trend event, not per-record noise."""
    try:
        from redpanda_tpu_torch.coproc.governor import TREND, journal_record

        journal_record(
            TREND,
            "watchdog_kill",
            f"sandbox watchdog killed script "
            f"{script_id if script_id is not None else '?'} ({layer}): {reason}",
            inputs={
                "script_id": script_id,
                "layer": layer,
                "elapsed_s": round(elapsed_s, 6),
            },
            config={
                "deadline_s": EXEC_WALL_DEADLINE_S,
                "line_budget": EXEC_LINE_BUDGET,
                "max_int_bits": MAX_INT_BITS,
            },
        )
    except Exception:
        # journaling is best-effort; a kill must surface through
        # ErrorPolicy even if the governor import is unavailable
        # mid-shutdown
        pass


def compile_transform(source: str, script_id: int | None = None):
    """validate + guard-inject + compile -> callable(value) -> bytes | None.

    Each call runs under the three-layer watchdog (module docstring): a
    line tracer that enforces both EXEC_LINE_BUDGET and the wall-clock
    deadline, operand guards compiled around `**`/`<<`/`*`/`range`, and a
    post-completion elapsed check. Kills surface as SandboxRuntimeError
    for the engine's ErrorPolicy; watchdog kills additionally journal one
    governor TREND entry per incident."""
    from redpanda_tpu_torch.coproc import faults

    # fault domain: a poisoned compile must refuse registration, not take
    # the engine down -- the fault tests drive this via the armed probe
    faults.inject(faults.SANDBOX_COMPILE)
    tree = validate_source(source)
    # post-validation rewrite: user source can neither name nor shadow the
    # dunder guard bindings (validation rejects dunder names)
    tree = _GuardInjector().visit(tree)
    ast.fix_missing_locations(tree)
    code = compile(tree, "<coproc-sandbox>", "exec")
    glb: dict = {"__builtins__": {}}
    glb.update(_SAFE_BUILTINS)
    glb.update(_GUARD_GLOBALS)
    exec(code, glb)  # defines transform in glb; body is whitelisted
    fn = glb["transform"]
    incident_journaled = False  # once per compiled transform, not per record

    def _kill(layer: str, elapsed_s: float, reason: str):
        nonlocal incident_journaled
        if not incident_journaled:
            incident_journaled = True
            _journal_watchdog_kill(script_id, layer, elapsed_s, reason)
        raise SandboxRuntimeError(reason) from None

    def run(value: bytes):
        budget = EXEC_LINE_BUDGET
        t0 = time.monotonic()
        deadline = t0 + EXEC_WALL_DEADLINE_S

        def tracer(frame, event, arg):
            nonlocal budget
            if event == "line":
                budget -= 1
                if budget <= 0:
                    raise SandboxBudgetExceeded(
                        f"transform exceeded {EXEC_LINE_BUDGET} lines"
                    )
                if time.monotonic() > deadline:
                    exc = SandboxDeadlineExceeded(
                        f"watchdog: record exceeded the "
                        f"{EXEC_WALL_DEADLINE_S}s wall-clock deadline"
                    )
                    exc.layer = "deadline"
                    raise exc
            return tracer

        old = sys.gettrace()
        sys.settrace(tracer)
        try:
            out = fn(value)
        except SandboxBudgetExceeded as e:
            # escaped every user frame (validation forbids catching it);
            # convert to a plain Exception for the ErrorPolicy machinery
            raise SandboxRuntimeError(str(e)) from None
        except SandboxDeadlineExceeded as e:
            _kill(e.layer, time.monotonic() - t0, str(e))
        finally:
            sys.settrace(old)
        elapsed = time.monotonic() - t0
        if elapsed > EXEC_WALL_DEADLINE_S:
            # layer 3: a residual single call (large allocation, big join)
            # slipped past tracer and guards — the record still fails
            _kill(
                "post_hoc", elapsed,
                f"watchdog: record took {elapsed:.3f}s "
                f"(> {EXEC_WALL_DEADLINE_S}s deadline)",
            )
        if out is None:
            return None
        if isinstance(out, str):
            return out.encode()
        if isinstance(out, (bytes, bytearray)):
            return bytes(out)
        raise TypeError(f"transform must return bytes|str|None, got {type(out).__name__}")

    run.__name__ = "sandboxed_transform"
    return run
