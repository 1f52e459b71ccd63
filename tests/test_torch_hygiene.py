"""The port stands alone: it imports neither JAX nor the JAX package, and
its sources, its examples (``examples_torch/``) and chip_smoke.py say
so. Its kernels layer, at the bottom, imports none of the layers above
it."""
import ast
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
EXAMPLES = ROOT / "examples_torch"
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)


def _modules():
    out = []
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        out.append(".".join(parts))
    return out


def test_importing_every_module_pulls_in_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + sorted(
    EXAMPLES.glob("*.py")) + [ROOT / "chip_smoke.py"],
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_or_reference(path):
    assert path.exists(), path
    bad = FORBIDDEN.findall(path.read_text())
    assert not bad, f"{path}: {bad}"


def test_forbidden_pattern_catches_reference_imports():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.core import cox", "import repro.kernels",
                 "  from repro import serving"):
        assert FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.core import cox",
                 "from .core import cox", "# jax is the reference"):
        assert not FORBIDDEN.search(line), line


@pytest.mark.parametrize("rel", ["serving/service.py", "serving/registry.py",
                                 "serving/chaos.py", "obs/profile.py"])
def test_serving_front_end_imports_no_jax_or_reference(rel):
    """The serving front end's modules, each imported alone, pull in
    neither JAX nor the JAX package."""
    path = PKG / rel
    assert path.is_file() and not FORBIDDEN.findall(path.read_text())
    module = "repro_torch." + rel[:-3].replace("/", ".")
    code = (f"import importlib, json, sys\n"
            f"importlib.import_module({module!r})\n"
            "print(json.dumps(sorted(m for m in sys.modules\n"
            "    if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


def test_importing_every_example_pulls_in_no_jax():
    """Each example twin, imported alone (its ``main`` not run), pulls in
    neither JAX nor the JAX package."""
    names = sorted(p.stem for p in EXAMPLES.glob("*.py"))
    assert names == ["quickstart", "serve_batched", "serve_risk_api",
                     "sparse_selection", "train_survival_lm"]
    code = (
        "import importlib.util, json, sys\n"
        f"for n in {names!r}:\n"
        f"    spec = importlib.util.spec_from_file_location(\n"
        f"        n, {str(EXAMPLES)!r} + '/' + n + '.py')\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m in ('jax', 'repro') or m.startswith(('jax.', 'repro.')))))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == []


# the layers above the kernels, which ``kernels/`` must not import
ABOVE_KERNELS = ("models", "core", "survival", "serving")


def _imported(tree: ast.AST, package: str) -> list:
    """Every module an ``import`` or ``from ... import`` anywhere in
    ``tree`` names (inside functions too), relative ones resolved against
    ``package``; a ``from`` import also names each ``base.name``."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            parts = package.split(".")
            if node.level:
                parts = parts[:len(parts) - node.level + 1]
            base = ".".join(parts + ([node.module] if node.module else [])
                            if node.level else [node.module])
            out += [base] + [f"{base}.{a.name}" for a in node.names]
    return out


def test_kernels_import_no_layer_above_them():
    """No source under ``kernels/`` imports ``repro_torch.models``,
    ``core``, ``survival`` or ``serving``, at module level or inside a
    function: every plain version and route lives beside its kernel."""
    above = tuple(f"repro_torch.{m}" for m in ABOVE_KERNELS)

    def upward(tree):
        return sorted({m for m in _imported(tree, "repro_torch.kernels")
                       if m in above or m.startswith(tuple(
                           a + "." for a in above))})

    # the check sees the forms an upward import takes
    probe = ast.parse("import repro_torch.core.cox\n"
                      "def f():\n    from ..models import ssm\n"
                      "from .. import survival\n"
                      "from . import ref\n")
    assert upward(probe) == ["repro_torch.core.cox", "repro_torch.models",
                             "repro_torch.models.ssm",
                             "repro_torch.survival"]
    sources = sorted((PKG / "kernels").rglob("*.py"))
    assert PKG / "kernels" / "ssd_scan.py" in sources
    bad = {str(p.relative_to(ROOT)): upward(ast.parse(p.read_text()))
           for p in sources}
    bad = {k: v for k, v in bad.items() if v}
    assert not bad, bad
