"""The port's boundary: redpanda_tpu_torch and chip_smoke.py import neither
JAX nor the JAX package, and the smoke script refuses to run without a
CUDA device."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "redpanda_tpu_torch")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "redpanda_tpu")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            if _forbidden(node.module):
                bad.append(node.module)
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant) and _forbidden(str(arg.value)):
                bad.append(arg.value)
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_port_imports_with_jax_blocked():
    mods = []
    for p in _sources():
        if p.startswith(PKG + os.sep):
            parts = os.path.relpath(p, ROOT)[:-3].split(os.sep)
            mods.append(".".join(parts[:-1] if parts[-1] == "__init__" else parts))
    code = (
        "import sys\n"
        "for m in ('jax', 'jaxlib', 'redpanda_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        f"for m in {sorted(mods)!r}:\n"
        "    importlib.import_module(m)\n"
        "assert not any(k == 'jax' or k.startswith(('jax.', 'redpanda_tpu.'))\n"
        "               for k, v in sys.modules.items() if v is not None)\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": ROOT},
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_chip_smoke_fails_without_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs for real here")
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py")],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
