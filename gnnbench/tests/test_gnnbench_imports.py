"""Nothing in gnnbench/ imports JAX or the JAX package; the references
import nothing of the port; a run fails where a card is missing or JAX
was loaded."""

import ast
import sys
import types
from pathlib import Path

import pytest

import gnnbench_cells  # noqa: F401  (puts the repository on sys.path)

FOLDER = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dgnn_tpu"}


def _imports(path: Path):
    """Top-level names of every module ``path`` imports (relative imports
    named by the package they lie in)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, a.name.partition(".")[0]
        elif isinstance(node, ast.ImportFrom):
            mod = "gnnbench" if node.level else node.module
            yield mod, mod.partition(".")[0]


SOURCES = sorted(FOLDER.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(
    p.relative_to(FOLDER)))
def test_no_jax(path):
    tops = {top for _, top in _imports(path)}
    assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


@pytest.mark.parametrize("path", sorted((FOLDER / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    for mod, top in _imports(path):
        assert top != "dgnn_tpu_torch", (path, mod)
        if top == "gnnbench":
            assert mod.startswith("gnnbench.reference") or mod == "gnnbench"


def test_whole_word_top_level_names(monkeypatch):
    sys.path.insert(0, str(FOLDER))
    import run

    monkeypatch.setitem(sys.modules, "dgnn_tpu_torch_fake",
                        types.ModuleType("dgnn_tpu_torch_fake"))
    before = run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dgnn_tpu.ops",
                        types.ModuleType("dgnn_tpu.ops"))
    assert run.forbidden_modules() == sorted(set(before) | {"dgnn_tpu"})
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert "jax" in run.forbidden_modules()


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    sys.path.insert(0, str(FOLDER))
    import run

    assert run.main(["--workload", "gat.pubmed.train", "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
