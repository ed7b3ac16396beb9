"""Nothing the benchmark runs loads JAX or the JAX package; the reference
loads nothing of the port. Modules are compared by their whole top-level
name: `neurad_tpu_torch` is the port, `neurad_tpu` the JAX package."""

from __future__ import annotations

import ast
import json
import subprocess
import sys

import pytest

from portbench.harness import spec as S

JAX_NAMES = {"jax", "jaxlib", "flax", "neurad_tpu"}
# The CPU witness that holds the reference against the JAX package imports it; no run imports it.
WITNESS = S.PKG / "tests" / "test_portbench_witness.py"


def _top_level_imports(path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".", 1)[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", sorted(str(p.relative_to(S.ROOT)) for p in S.PKG.rglob("*.py") if p != WITNESS))
def test_no_source_imports_jax(path):
    assert not _top_level_imports(S.ROOT / path) & JAX_NAMES


@pytest.mark.parametrize("path", sorted(str(p.relative_to(S.ROOT)) for p in (S.PKG / "reference").rglob("*.py")))
def test_reference_imports_nothing_of_the_port(path):
    assert "neurad_tpu_torch" not in _top_level_imports(S.ROOT / path)


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.', 1)[0] for m in sys.modules})))"],
                         cwd=S.ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    """A whole run of a tiny cell on the CPU, in a process of its own."""
    loaded = _loaded(
        "import time\n"
        "from portbench.tests import tiny\n"
        "from portbench.harness import cell as C\n"
        "C.run_cell(tiny.cell('neurad.sim-camera'), seed=5, seconds=0.5, trace=False, device='cpu',"
        " started=time.perf_counter())\n"
    )
    assert "neurad_tpu_torch" in loaded
    assert not loaded & JAX_NAMES


def test_the_reference_loads_nothing_of_the_port():
    loaded = _loaded("import portbench.reference.neurad_serve, portbench.reference.splatad_serve")
    assert not loaded & (JAX_NAMES | {"neurad_tpu_torch"})
