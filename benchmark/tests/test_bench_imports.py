"""Nothing under benchmark/ imports jax, jaxlib, flax or the JAX package
(top-level names compared whole: groove_tpu_torch is not groove_tpu),
and the reference imports nothing of the program."""

import ast
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "groove_tpu"}


def imported(path: Path) -> set:
    """Top-level names of every module the file imports (absolute)."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_nor_jax_package_anywhere():
    bad = {str(p.relative_to(HERE)): imported(p) & FORBIDDEN
           for p in HERE.rglob("*.py") if imported(p) & FORBIDDEN}
    assert not bad


def test_names_are_compared_whole(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import groove_tpu_torch.engine\n"
                     "from groove_tpu_torch import x\n")
    assert imported(probe) == {"groove_tpu_torch"}
    assert not imported(probe) & FORBIDDEN
    probe.write_text("import groove_tpu.engine\n")
    assert imported(probe) & FORBIDDEN


def test_reference_imports_nothing_of_the_program():
    ref = HERE / "reference"
    bad = {str(p.relative_to(HERE)): imported(p)
           for p in ref.rglob("*.py") if "groove_tpu_torch" in imported(p)}
    assert not bad
    text = "\n".join(p.read_text() for p in ref.rglob("*.py"))
    assert "import groove_tpu_torch" not in text
    assert "from groove_tpu_torch" not in text
