"""Import hygiene of the port: no file of quadruped_tpu_torch/, nor
chip_smoke.py, imports JAX or the JAX package (the port keeps its own copy
of what it needs; only the tests import both). Each file is parsed with
`ast`, so an import anywhere in it counts, inside a function too. And
every test module that holds a card case (it imports tests/card_device.py
or carries the `cuda` mark) imports neither at module level, nor through a
helper of tests/ it imports there: the card's machine has no JAX, and
collects those modules."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
TESTS = ROOT / "tests"
FILES = sorted((ROOT / "quadruped_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "flax", "quadruped_tpu")
CARD_MODULES = sorted(p for p in TESTS.glob("test_torch_*.py")
                      if "card_device" in p.read_text()
                      or "mark.cuda" in p.read_text())


def _imported(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", "")
              == "__import__" and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(node.args[0].value)
    return names


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in BANNED


def _module_level(tree) -> list:
    """The nodes Python runs when it imports the module: not the bodies of
    functions, nor the `if __name__ == "__main__":` block."""
    out, todo = [], list(tree.body)
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
                and getattr(node.test.left, "id", "") == "__name__"):
            continue
        out.append(node)
        todo.extend(ast.iter_child_nodes(node))
    return out


def _imported_at_import(path: Path, seen=None) -> set:
    """The modules `path` imports at module level, and those the helpers
    of tests/ it imports there import at theirs."""
    seen = set() if seen is None else seen
    seen.add(path)
    names = set()
    for node in _module_level(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
    for name in list(names):
        helper = TESTS / f"{name.split('.')[0]}.py"
        if helper.is_file() and helper not in seen:
            names |= _imported_at_import(helper, seen)
    return names


def test_no_jax_import():
    assert len(FILES) > 90
    bad = {str(p.relative_to(ROOT)): sorted(n for n in _imported(p)
                                            if _banned(n)) for p in FILES}
    assert not {k: v for k, v in bad.items() if v}


def test_the_check_sees_jax_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\n\ndef f():\n    from quadruped_tpu.core "
                   "import se3\n    import jax.numpy as jnp\n")
    assert {n for n in _imported(src) if _banned(n)} == {
        "quadruped_tpu.core", "jax.numpy"}
    assert not _banned("quadruped_tpu_torch.core")


@pytest.mark.parametrize("path", CARD_MODULES, ids=lambda p: p.name)
def test_card_modules_import_no_jax_at_module_level(path):
    assert len(CARD_MODULES) > 15
    assert not sorted(n for n in _imported_at_import(path) if _banned(n))


def test_the_card_check_sees_module_level_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import os\nimport jax\nfrom card_device import on\n\n"
                   "def f():\n    import flax\n\nif __name__ == "
                   "'__main__':\n    import jaxlib\n")
    assert {n for n in _imported_at_import(src) if _banned(n)} == {"jax"}
