"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference imports nothing of the program. Module names are compared by
the whole top-level name (the part before the first dot): the port's name
begins with the JAX package's."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import common

ROOT = common.ROOT
#: what no file of the benchmark may import, beside JAX and its package
NOT_IMPORTED = set(common.FORBIDDEN_MODULES) | {"bench", "chip_smoke"}
#: what the reference may import
REFERENCE_OK = {"__future__", "math", "torch", "numpy"}


def _imports(path: Path):
    """Top-level names of the absolute imports of one source file."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


SOURCES = sorted(p for p in ROOT.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & NOT_IMPORTED


def test_the_reference_imports_nothing_of_the_program():
    for path in sorted((ROOT / "reference").glob("*.py")):
        names = set(_imports(path))
        assert names <= REFERENCE_OK, (path, names)
        tree = ast.parse(path.read_text())
        rel = [n for n in ast.walk(tree)
               if isinstance(n, ast.ImportFrom) and n.level > 0]
        assert not rel, path  # nothing from outside the reference


def _run(code: str) -> list:
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=common.CHECKOUT, check=True,
        capture_output=True, text=True, timeout=600).stdout
    return json.loads(out.strip().splitlines()[-1])


def test_a_run_loads_no_jax():
    """A whole tiny run, every reader included, in a fresh process."""
    loaded = _run(
        "import json, sys\n"
        "sys.path.insert(0, '.')\n"
        "from portbench import common, calibrate, harness\n"
        "from portbench.tests import tiny\n"
        "for name in sorted(tiny.OVERRIDES):\n"
        "    tiny.run(name, trace=True)\n"
        "print(json.dumps(common.forbidden_loaded()))\n")
    assert loaded == []


def test_the_reference_loads_nothing_of_the_program():
    loaded = _run(
        "import json, sys\n"
        "sys.path.insert(0, '.')\n"
        "import portbench.reference.gp_ref\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "    if m.split('.')[0] in ('egobox_torch', 'egobox_tpu', 'jax'))))\n")
    assert loaded == []


def test_names_are_compared_whole():
    mods = {"jax.numpy": 1, "jaxtyping": 1, "egobox_torch.gp": 1,
            "egobox_tpu": 1, "flax.linen": 1, "jaxlib": 1, "torch": 1}
    assert common.forbidden_loaded(mods) == ["egobox_tpu", "flax.linen",
                                             "jax.numpy", "jaxlib"]
