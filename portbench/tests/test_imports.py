"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program either. Top-level module names
are compared whole: ``frizbee_tpu_torch`` starts with ``frizbee_tpu``."""

import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = {"jax", "jaxlib", "flax", "frizbee_tpu"}
BANNED_IN_REFERENCE = BANNED | {"frizbee_tpu_torch"}


def modules():
    for dirpath, _dirs, files in os.walk(HERE):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def imported_tops(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", list(modules()),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    banned = BANNED
    if os.sep + "reference" + os.sep in path:
        banned = BANNED_IN_REFERENCE
    assert not set(imported_tops(path)) & banned


def test_names_compared_whole():
    assert "frizbee_tpu_torch" not in BANNED
    assert "frizbee_tpu_torch".split(".")[0] != "frizbee_tpu"
