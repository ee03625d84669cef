"""No module under portbench/ imports JAX or the JAX package, and the
reference imports nothing of the port; top-level names compared whole
(`jolt_tpu_torch` begins with `jolt_tpu`)."""

import ast
import os
import subprocess
import sys

import pytest

from portbench.spec import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "jolt_tpu"}


def _modules():
    for dp, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dp, f)


def _imported_top_names(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(_modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax_import(path):
    assert not set(_imported_top_names(path)) & FORBIDDEN


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(HERE, "reference")
    for dp, _, files in os.walk(ref):
        for f in files:
            if f.endswith(".py"):
                names = set(_imported_top_names(os.path.join(dp, f)))
                assert "jolt_tpu_torch" not in names, f


def test_reference_loads_no_port_module():
    code = ("import sys, portbench.reference.check, "
            "portbench.reference.lower_precision; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jolt_tpu_torch', 'jolt_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
