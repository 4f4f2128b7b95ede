"""The import check: by whole top-level names, so that the port
(``repro_torch``) passes and JAX or the JAX package (``repro``) does not;
and the reference and the harness import neither, nor the reference the
port."""

from __future__ import annotations

import ast
import subprocess
import sys

import pytest

from portbench.tests._tiny import ROOT


def test_forbidden_by_whole_top_level_name():
    from portbench.core import bench

    ok = ["repro_torch", "repro_torch.fl.engine", "reproduce", "jaxtyping",
          "torch"]
    bad = ["repro", "repro.core.transport", "jax", "jaxlib", "flax.linen"]
    assert bench.forbidden_modules(ok) == []
    assert bench.forbidden_modules(ok + bad) == sorted(bad)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted((ROOT / "portbench").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    tops = {m.split(".")[0] for m in _imports(path)}
    assert not tops & {"jax", "jaxlib", "flax", "repro"}
    if "reference" in path.parts or "traffic" in path.parts:
        assert "repro_torch" not in tops


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path[:0] = [%r]\n"
            "import portbench.reference.cnn, portbench.reference.qwen2\n"
            "import portbench.reference.phy_layered, portbench.traffic.tokens\n"
            "import portbench.traffic.partition, portbench.traffic.synth_mnist\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('repro', 'repro_torch', 'jax', 'jaxlib', 'flax'))\n"
            "print(bad); sys.exit(1 if bad else 0)\n") % str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
