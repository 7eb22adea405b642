"""The import rule: nothing under benchmark/ imports JAX or the JAX package,
and the reference imports nothing of the program either. Top-level names
(the part before the first dot) are compared whole: the port's package name
begins with the JAX package's."""

from __future__ import annotations

import ast
import os

import pytest

from benchmark import run, spec

JAX_SIDE = {"jax", "jaxlib", "flax", "vit_ocm_wmsegmentation_tpu"}
PORT = "vit_ocm_wmsegmentation_tpu_torch"


def _sources(sub=""):
    base = os.path.join(spec.HERE, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def top_level_imports(path):
    """Top-level names of every module ``path`` imports (absolute imports)."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(_sources()), ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_jax_imports(path):
    assert not top_level_imports(path) & JAX_SIDE


@pytest.mark.parametrize("path", sorted(_sources("reference")),
                         ids=lambda p: os.path.relpath(p, spec.HERE))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (JAX_SIDE | {PORT, "benchmark"}), names


def test_the_scan_compares_whole_names(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import vit_ocm_wmsegmentation_tpu_torch.ops\nfrom jaxlib import x\n"
                 "import jaxtyping\nfrom vit_ocm_wmsegmentation_tpu_torch import pipeline\n")
    assert top_level_imports(str(f)) & JAX_SIDE == {"jaxlib"}


@pytest.mark.parametrize("modules, found", [
    ({"vit_ocm_wmsegmentation_tpu_torch": 1, "vit_ocm_wmsegmentation_tpu_torch.ops": 1}, []),
    ({"vit_ocm_wmsegmentation_tpu.ops": 1}, ["vit_ocm_wmsegmentation_tpu.ops"]),
    ({"jax": 1, "jaxtyping": 1, "flax.linen": 1}, ["flax.linen", "jax"]),
])
def test_loaded_module_check(modules, found):
    assert run.banned_modules(modules) == found
