"""Import hygiene of the port: no file of quadruped_tpu_torch/, and not
chip_smoke.py, imports JAX or the JAX package (the port keeps its own copy
of what it needs; only the tests import both). Each file is parsed with
`ast`, so an import anywhere in it counts, inside a function too."""

import ast
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "quadruped_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "flax", "quadruped_tpu")


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
