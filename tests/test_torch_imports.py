"""The port stands alone: importing every module of `repro_torch`, and what
`chip_smoke.py` imports, pulls in neither `jax` nor the JAX package, and
needs neither `triton`, `nvcc` nor a CUDA device."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

PROBE = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names + sys.argv[2:]:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro", "triton"))
assert not bad, bad
print(len(names))
"""


def chip_smoke_imports():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    return sorted(mods)


def test_every_module_imports_without_jax():
    mods = chip_smoke_imports()
    assert any(m.startswith("repro_torch") for m in mods)
    assert not [m for m in mods if m.split(".")[0] in ("jax", "repro")]
    out = subprocess.run(
        [sys.executable, "-c", PROBE, str(ROOT / "src")] + mods,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 25


def test_no_source_line_imports_jax_or_the_jax_package():
    files = list((ROOT / "src" / "repro_torch").rglob("*.py")) \
        + [ROOT / "chip_smoke.py"]
    assert len(files) > 25
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "repro"), (f, n)


def test_chip_smoke_fails_without_a_card():
    import torch
    if torch.cuda.is_available():
        import pytest
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert "ok" not in out.stdout
