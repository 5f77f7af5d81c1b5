"""Nothing under perfbench/ imports JAX or the JAX package (`repro`),
compared as whole top-level names; the reference imports nothing of the
program (`repro_torch`)."""
import ast
from pathlib import Path

import pytest

PERFBENCH = Path(__file__).resolve().parents[1]
FILES = sorted(PERFBENCH.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") \
                == "import_module" and node.args \
                and isinstance(node.args[0], ast.Constant):
            out.add(str(node.args[0].value).split(".")[0])
    return out


def test_the_check_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.serve\nfrom repro.kernels import x\n")
    assert top_level_imports(f) == {"repro_torch", "repro"}


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    PERFBENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


def test_reference_imports_nothing_of_the_program():
    files = sorted((PERFBENCH / "reference").rglob("*.py"))
    assert files
    for path in files:
        assert "repro_torch" not in top_level_imports(path), path
