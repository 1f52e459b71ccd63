"""The port stands alone: it imports neither JAX nor the JAX package, and
its sources and chip_smoke.py say so."""
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


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [
    ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
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
