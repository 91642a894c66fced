"""Nothing under benchmark/ imports jax, jaxlib, flax or the JAX package
(top-level names compared whole: groove_tpu_torch is not groove_tpu),
and the reference imports nothing of the program: a file under
reference/, the shared one or a configuration's own, imports only the
standard library, numpy, scipy and benchmark.reference."""

import ast
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "groove_tpu"}
# what a reference may import; no loader by name, which could reach the
# program past this list
REFERENCE_MAY = (set(sys.stdlib_module_names) - {"importlib", "pkgutil",
                                                  "runpy", "zipimport"}
                 | {"numpy", "scipy"})


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


def imported_whole(path: Path, package: str) -> set:
    """Whole names of what the file imports, a `from` import as
    module.name, relative ones resolved against `package`."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = package.split(".")
                up = parts[:len(parts) - node.level + 1]
                base = ".".join(up + ([base] if base else []))
            names |= {f"{base}.{a.name}" for a in node.names}
    return names


def outside_reference(names: set) -> set:
    return {n for n in names
            if n.split(".")[0] not in REFERENCE_MAY
            and n != "benchmark.reference"
            and not n.startswith("benchmark.reference.")}


def test_reference_imports_only_what_it_may():
    bad = {str(p.relative_to(HERE)):
           outside_reference(imported_whole(p, "benchmark.reference"))
           for p in (HERE / "reference").rglob("*.py")}
    assert not {k: v for k, v in bad.items() if v}
    text = "\n".join(p.read_text()
                     for p in (HERE / "reference").rglob("*.py"))
    assert "__import__" not in text


def test_the_allow_list_refuses_the_rest_of_the_benchmark(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("from __future__ import annotations\n"
                     "import math, numpy as np\n"
                     "from scipy.signal import lfilter\n"
                     "from benchmark.reference import render as shared\n"
                     "from benchmark.reference.song import Song\n"
                     "from . import song\n")
    assert not outside_reference(imported_whole(probe,
                                                "benchmark.reference"))
    for line in ("from benchmark import work", "import benchmark.entries",
                 "from benchmark.entries.offline import Entry",
                 "from .. import check", "from ..kit import write_kit",
                 "import importlib", "import torch",
                 "from groove_tpu_torch import engine"):
        probe.write_text(line + "\n")
        assert outside_reference(imported_whole(
            probe, "benchmark.reference")), line
