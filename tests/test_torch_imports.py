"""The port stands alone: no module of ``devqa_tpu_torch`` and not
``chip_smoke.py`` imports ``jax``, JAX's ``optax`` or ``orbax``, or the JAX
package ``devqa_tpu`` (as opposed to ``devqa_tpu_torch``). Only the tests
import both."""
import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "devqa_tpu_torch")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files.extend(os.path.join(root, n) for n in sorted(names)
                     if n.endswith(".py"))
    return sorted(os.path.relpath(f, REPO) for f in files)


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "optax", "orbax", "devqa_tpu")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")):
            yield node.lineno, node.args[0].value


@pytest.mark.parametrize("relpath", _port_files())
def test_no_jax_or_jax_package_import(relpath):
    with open(os.path.join(REPO, relpath)) as f:
        tree = ast.parse(f.read(), filename=relpath)
    bad = [(line, mod) for line, mod in _imported_modules(tree)
           if _forbidden(mod)]
    assert not bad, "%s imports %s" % (relpath, bad)


def test_scan_sees_every_port_module():
    files = _port_files()
    assert "chip_smoke.py" in files
    for mod in (("ops", "attention.py"), ("train", "loop.py"),
                ("data", "prefetch.py"), ("editors", "liveedit.py")):
        assert os.path.join("devqa_tpu_torch", *mod) in files
    assert len(files) >= 25


def test_scan_flags_jax_package_but_not_the_port():
    src = ("import jax.numpy as jnp\nfrom devqa_tpu.core import vit\n"
           "from devqa_tpu_torch.core import vit as tv\nimport devqa_tpu_torch\n"
           "importlib.import_module('jax')\nimport optax\n"
           "import orbax.checkpoint as ocp\n")
    mods = [m for _, m in _imported_modules(ast.parse(src)) if _forbidden(m)]
    assert sorted(mods) == ["devqa_tpu.core", "jax", "jax.numpy", "optax",
                            "orbax.checkpoint"]
