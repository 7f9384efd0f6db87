"""Nothing under benchmark/ imports JAX or the JAX package, and the
reference imports nothing of the program.  Modules are compared by their
top-level name whole: the port's name begins with the JAX package's."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
JAX_NAMES = {"jax", "jaxlib", "flax", "rdfind_tpu"}


def imported_top_names(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", None)) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def modules(under: Path):
    return sorted(p for p in under.rglob("*.py") if "__pycache__" not in p.parts)


def test_no_module_imports_jax_or_the_jax_package():
    found = {str(p.relative_to(HERE)): imported_top_names(p) & JAX_NAMES
             for p in modules(HERE)}
    assert not {k: v for k, v in found.items() if v}


def test_reference_imports_nothing_of_the_program():
    found = {str(p.relative_to(HERE)): imported_top_names(p)
             & (JAX_NAMES | {"rdfind_tpu_torch"})
             for p in modules(HERE / "reference")}
    assert not {k: v for k, v in found.items() if v}


def test_the_walk_sees_the_modules_and_their_imports():
    """An over-narrow walk would pass while reading nothing."""
    mods = {str(p.relative_to(HERE)) for p in modules(HERE)}
    assert {"run.py", "reference/cinds.py", "entries/discover.py"} <= mods
    assert "rdfind_tpu_torch" in imported_top_names(HERE / "entries" /
                                                    "discover.py")
    probe = HERE / "tests" / "test_benchmark_isolation.py"
    assert "ast" in imported_top_names(probe)


def test_top_level_names_compare_whole(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import rdfind_tpu_torch.ops\nfrom rdfind_tpu import x\n")
    names = imported_top_names(src)
    assert "rdfind_tpu_torch" in names and "rdfind_tpu" in names
    src.write_text("import rdfind_tpu_torch\n")
    assert not imported_top_names(src) & JAX_NAMES
