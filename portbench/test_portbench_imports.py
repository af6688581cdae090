"""What the benchmark imports: never JAX or the JAX package, and in the
references nothing of the program either.  Top-level names are compared
whole: ``repro_torch`` is not ``repro``."""
from __future__ import annotations

import ast
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parent
JAX = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports, wherever it does."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            out.add(str(node.args[0].value).split(".")[0])
    return out


SOURCES = sorted(PB.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & JAX


@pytest.mark.parametrize("path", sorted((PB / "references").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert "repro_torch" not in _imports(path)
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module:
            assert not node.module.startswith("portbench.kinds")


def test_the_scan_reads_whole_top_level_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro_torch.mpc\nfrom repro.mpc import x\n"
                 "import jaxlib as j\n")
    assert _imports(f) == {"repro_torch", "repro", "jaxlib"}


def test_the_runs_own_look_at_loaded_modules():
    import portbench.run as run

    assert run.forbidden_modules(["repro_torch.mpc", "torch", "jaxtyping"]) == []
    assert run.forbidden_modules(["repro.mpc", "jax._src", "flax"]) == [
        "flax", "jax", "repro"]
    assert "sys" in sys.modules and "sys" not in run.FORBIDDEN
