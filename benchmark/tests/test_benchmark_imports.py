"""Nothing under benchmark/ imports the JAX stack, the JAX package, the
repository's old bench and smoke scripts or their tools; the reference
imports nothing of the program.  Top-level module names are compared
whole: `zkvm_tpu_torch` begins with `zkvm_tpu` and is allowed."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "zkvm_tpu", "chip_smoke", "bench",
             "tools"}
FILES = sorted(BENCH_DIR.rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_no_file_imports_the_jax_stack(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    allowed = {"__future__", "dataclasses", "hashlib", "random", "numpy"}
    assert top_level_imports(path) <= allowed


def test_the_comparison_is_by_whole_names(tmp_path):
    from benchmark.harness.core import FORBIDDEN as RUN_FORBIDDEN

    assert "zkvm_tpu" in RUN_FORBIDDEN
    assert "zkvm_tpu_torch" not in RUN_FORBIDDEN
    probe = tmp_path / "probe.py"
    probe.write_text("import zkvm_tpu_torch.ops\nfrom zkvm_tpu.plonk import x\n")
    assert top_level_imports(probe) == {"zkvm_tpu_torch", "zkvm_tpu"}


def test_a_run_names_what_it_finds(monkeypatch):
    import sys
    import types

    from benchmark.harness import core

    monkeypatch.setitem(sys.modules, "jaxlib.probe", types.ModuleType("x"))
    assert core.forbidden_modules() == ["jaxlib.probe"]
