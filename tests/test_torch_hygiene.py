"""Import hygiene of the port: nothing under src/repro_torch/, and not
chip_smoke.py, imports JAX or the JAX package ``repro`` (imports of
``repro_torch`` itself are fine).  The tests, which import both, are not
scanned."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
BANNED = ("jax", "jaxlib", "repro")


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", getattr(node.func, "attr", "")) in (
                    "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value)


def test_port_files_exist():
    assert len(PORT_FILES) > 20
    assert all(p.exists() for p in PORT_FILES)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in BANNED]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_catches_banned_imports(tmp_path):
    src = tmp_path / "m.py"
    src.write_text("import jax.numpy as jnp\nfrom repro.core import spec\n"
                   "from repro_torch import bridge\nfrom . import x\n"
                   "importlib.import_module('repro.models')\n")
    found = [m for m in _imported_modules(src) if m.split(".")[0] in BANNED]
    assert found == ["jax.numpy", "repro.core", "repro.models"]
